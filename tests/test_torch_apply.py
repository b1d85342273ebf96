"""The port's stencil application and transfers
(evostencils_tpu_torch/ops/apply.py) against the JAX package's
(evostencils_tpu/ops/apply.py) on the same random fields in float64.

Each package builds its own grids and stencils (the port keeps its own
copies of ``grids`` and ``stencils``).  Both sum the same terms in the
same order, so they agree to float64 rounding: tolerance 1e-12 relative
to the largest value.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from evostencils_tpu import grids as jgrids
from evostencils_tpu.ops import apply as jops
from evostencils_tpu.stencils import constant as jconstant
from evostencils_tpu.stencils import gallery as jgallery
from evostencils_tpu.stencils import periodic as jperiodic
from evostencils_tpu_torch import grids as tgrids
from evostencils_tpu_torch.ops import apply as tops
from evostencils_tpu_torch.stencils import constant as tconstant
from evostencils_tpu_torch.stencils import gallery as tgallery
from evostencils_tpu_torch.stencils import periodic as tperiodic

#: the layers each package builds its own objects from
JAX = SimpleNamespace(grids=jgrids, gallery=jgallery, periodic=jperiodic,
                      constant=jconstant)
PORT = SimpleNamespace(grids=tgrids, gallery=tgallery, periodic=tperiodic,
                       constant=tconstant)

LEVELS = [6, 7, 8]     # 63^2, 127^2, 255^2
LEVELS_3D = [3, 4, 5]  # 7^3, 15^3, 31^3


def _field(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def _close(out, ref):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-12 * scale)


def _grid(pkg, dim, level):
    return pkg.grids.unit_interval_grid(dim, level)


def _poisson(pkg, dim, level):
    """(grid, Poisson stencil) built from one package's own layers."""
    grid = _grid(pkg, dim, level)
    gen = pkg.gallery.Poisson2D() if dim == 2 else pkg.gallery.Poisson3D()
    return grid, gen.generate_stencil(grid)


def _check_apply_constant(dim, level):
    grid, jst = _poisson(JAX, dim, level)
    _, tst = _poisson(PORT, dim, level)
    assert tst.entries == jst.entries
    u = _field(grid.size, level)
    _close(tops.apply_constant(tst, torch.tensor(u)),
           jops.apply_constant(jst, jnp.asarray(u)))


def _diagonal_inverse(pkg, dim, level):
    _, st = _poisson(pkg, dim, level)
    per = pkg.periodic
    return per.inverse(per.diagonal(per.as_periodic(st)))


def _check_diagonal_inverse(dim, level):
    grid = _grid(JAX, dim, level)
    u = _field(grid.size, level + 10)
    _close(tops.apply_stencil(_diagonal_inverse(PORT, dim, level),
                              torch.tensor(u)),
           jops.apply_stencil(_diagonal_inverse(JAX, dim, level),
                              jnp.asarray(u)))


def _restriction(pkg, dim, level):
    grid = _grid(pkg, dim, level)
    return pkg.gallery.FullWeightingRestrictionGenerator((2,) * dim) \
        .generate_stencil(grid)


def _interpolation(pkg, dim, level):
    grid = _grid(pkg, dim, level)
    return pkg.gallery.MultilinearInterpolationGenerator((2,) * dim) \
        .generate_stencil(grid)


def _check_restrict(dim, level):
    grid = _grid(JAX, dim, level)
    u = _field(grid.size, level + 20)
    out = tops.restrict(_restriction(PORT, dim, level), torch.tensor(u))
    assert tuple(out.shape) == tuple((n - 1) // 2 for n in grid.size)
    _close(out, jops.restrict(_restriction(JAX, dim, level), jnp.asarray(u)))


def _check_prolong(dim, level):
    grid = _grid(JAX, dim, level)
    coarse = tuple((n - 1) // 2 for n in grid.size)
    e = _field(coarse, level + 30)
    out = tops.prolong(_interpolation(PORT, dim, level), torch.tensor(e),
                       grid.size)
    assert tuple(out.shape) == tuple(grid.size)
    _close(out, jops.prolong(_interpolation(JAX, dim, level), jnp.asarray(e),
                             grid.size))


@pytest.mark.parametrize("level", LEVELS)
def test_apply_constant_poisson(level):
    _check_apply_constant(2, level)


@pytest.mark.parametrize("level", LEVELS_3D)
def test_apply_constant_poisson_3d(level):
    _check_apply_constant(3, level)


@pytest.mark.parametrize("level", LEVELS)
def test_apply_diagonal_inverse(level):
    _check_diagonal_inverse(2, level)


@pytest.mark.parametrize("level", LEVELS_3D)
def test_apply_diagonal_inverse_3d(level):
    _check_diagonal_inverse(3, level)


@pytest.mark.parametrize("level", LEVELS)
def test_restrict_full_weighting(level):
    _check_restrict(2, level)


@pytest.mark.parametrize("level", LEVELS_3D)
def test_restrict_full_weighting_3d(level):
    _check_restrict(3, level)


@pytest.mark.parametrize("level", LEVELS)
def test_prolong_bilinear(level):
    _check_prolong(2, level)


@pytest.mark.parametrize("level", LEVELS_3D)
def test_prolong_trilinear_3d(level):
    _check_prolong(3, level)


@pytest.mark.parametrize("level", [3, 4, 5])
def test_dense_matrix(level):
    jgrid, jst = _poisson(JAX, 2, level)
    tgrid, tst = _poisson(PORT, 2, level)
    np.testing.assert_array_equal(tops.dense_matrix(tst, tgrid),
                                  jops.dense_matrix(jst, jgrid))


@pytest.mark.parametrize("level", [2, 3])
def test_dense_matrix_3d(level):
    jgrid, jst = _poisson(JAX, 3, level)
    tgrid, tst = _poisson(PORT, 3, level)
    np.testing.assert_array_equal(tops.dense_matrix(tst, tgrid),
                                  jops.dense_matrix(jst, jgrid))


def _five_point_weighting(pkg):
    return pkg.constant.Stencil(
        [((0, 0), 0.5), ((-1, 0), 0.125), ((1, 0), 0.125),
         ((0, -1), 0.125), ((0, 1), 0.125)])


@pytest.mark.parametrize("kind", ["injection", "non_separable"])
def test_transfer_fallbacks(kind):
    """Transfers that are not separable 3-tap stencils: injection, and a
    5-point weighting applied then subsampled / scattered then applied."""
    grid = _grid(JAX, 2, 6)
    jst, tst = (None, None) if kind == "injection" else \
        (_five_point_weighting(JAX), _five_point_weighting(PORT))
    u = _field(grid.size, 40)
    _close(tops.restrict(tst, torch.tensor(u)),
           jops.restrict(jst, jnp.asarray(u)))
    coarse = tuple((n - 1) // 2 for n in grid.size)
    e = _field(coarse, 41)
    _close(tops.prolong(tst, torch.tensor(e), grid.size),
           jops.prolong(jst, jnp.asarray(e), grid.size))


def _check_separable_factors(dim):
    for make in (_restriction, _interpolation):
        (tv, tr), (jv, jr) = tops.separable_factors(make(PORT, dim, 5)), \
            jops.separable_factors(make(JAX, dim, 5))
        assert tr == jr
        for a, b in zip(tv, jv):
            np.testing.assert_array_equal(a, b)
    assert tops.separable_factors(_poisson(PORT, dim, 5)[1]) is None


def test_separable_factors_match():
    _check_separable_factors(2)


def test_separable_factors_match_3d():
    _check_separable_factors(3)


def test_red_black_masks_parity():
    """Red is an even node-index sum; interior (0, 0) is node (1, 1)."""
    red, black = tops.red_black_masks((5, 7), device="cpu",
                                      dtype=torch.float64)
    i, j = np.meshgrid(np.arange(5), np.arange(7), indexing="ij")
    np.testing.assert_array_equal(red.numpy(), ((i + j) % 2 == 0) * 1.0)
    np.testing.assert_array_equal(black.numpy(), 1.0 - red.numpy())


def test_red_black_masks_parity_3d():
    """In 3D interior (0, 0, 0) is node (1, 1, 1), an odd node sum, so red
    is an ODD interior-index sum, the opposite of 2D
    (evostencils_tpu/ops/pallas/wavefront3d.py:98)."""
    red, black = tops.red_black_masks((5, 7, 3), device="cpu",
                                      dtype=torch.float64)
    i, j, k = np.meshgrid(np.arange(5), np.arange(7), np.arange(3),
                          indexing="ij")
    np.testing.assert_array_equal(red.numpy(), ((i + j + k) % 2 == 1) * 1.0)
    np.testing.assert_array_equal(black.numpy(), 1.0 - red.numpy())


# ---------------------------------------------------------------------------
# block solves of collective block Jacobi (ops/local_solve.py)
# ---------------------------------------------------------------------------

from evostencils_tpu.ops import local_solve as jlocal
from evostencils_tpu_torch.ops import local_solve as tlocal


def _block_plan(pkg, local, block_size):
    """The block-solve plan of the 31^2 Poisson operator's block diagonal,
    as lower.py:1547-1551 builds it, from one package's own layers."""
    grid, st = _poisson(pkg, 2, 5)
    per = pkg.periodic
    ps = per.block_diagonal(per.as_periodic(st), block_size)
    return local.get_block_solve_plan([[ps]], block_size, tuple(grid.size))


@pytest.mark.parametrize("block_size", [(2, 2), (1, 3), (2, 4)])
def test_block_solve_matches_jax(block_size):
    """Same numpy setup (the inverses are equal bitwise), and apply on a
    31^2 field agrees to atol 1e-12."""
    pj = _block_plan(JAX, jlocal, block_size)
    pt = _block_plan(PORT, tlocal, block_size)
    np.testing.assert_array_equal(pt.inverse, pj.inverse)
    u = _field((31, 31), 40 + sum(block_size))
    (out,) = pt.apply((torch.tensor(u),))
    (ref,) = pj.apply((jnp.asarray(u),))
    assert out.dtype == torch.float64 and tuple(out.shape) == (31, 31)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)
    # the blocks really couple: the solve is not the point-Jacobi one
    (point,) = tlocal.get_block_solve_plan(
        [[tperiodic.block_diagonal(
            tperiodic.as_periodic(_poisson(PORT, 2, 5)[1]), (1, 1))]],
        (1, 1), (31, 31)).apply((torch.tensor(u),))
    assert float((out - point).abs().max()) > 0.1 * float(out.abs().max())
