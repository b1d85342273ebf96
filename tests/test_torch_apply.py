"""The port's stencil application and transfers
(evostencils_tpu_torch/ops/apply.py) against the JAX package's
(evostencils_tpu/ops/apply.py) on the same random fields in float64.

Both sum the same terms in the same order, so they agree to float64
rounding: tolerance 1e-12 relative to the largest value.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from evostencils_tpu.grids import unit_interval_grid
from evostencils_tpu.ops import apply as jops
from evostencils_tpu.stencils import gallery, periodic
from evostencils_tpu_torch.ops import apply as tops

LEVELS = [6, 7, 8]     # 63^2, 127^2, 255^2


def _field(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def _close(out, ref):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-12 * scale)


@pytest.mark.parametrize("level", LEVELS)
def test_apply_constant_poisson(level):
    grid = unit_interval_grid(2, level)
    st = gallery.Poisson2D().generate_stencil(grid)
    u = _field(grid.size, level)
    _close(tops.apply_constant(st, torch.tensor(u)),
           jops.apply_constant(st, jnp.asarray(u)))


@pytest.mark.parametrize("level", LEVELS)
def test_apply_diagonal_inverse(level):
    grid = unit_interval_grid(2, level)
    st = gallery.Poisson2D().generate_stencil(grid)
    inv = periodic.inverse(periodic.diagonal(periodic.as_periodic(st)))
    u = _field(grid.size, level + 10)
    _close(tops.apply_stencil(inv, torch.tensor(u)),
           jops.apply_stencil(inv, jnp.asarray(u)))


@pytest.mark.parametrize("level", LEVELS)
def test_restrict_full_weighting(level):
    grid = unit_interval_grid(2, level)
    st = gallery.FullWeightingRestrictionGenerator((2, 2)) \
        .generate_stencil(grid)
    u = _field(grid.size, level + 20)
    out = tops.restrict(st, torch.tensor(u))
    assert tuple(out.shape) == tuple((n - 1) // 2 for n in grid.size)
    _close(out, jops.restrict(st, jnp.asarray(u)))


@pytest.mark.parametrize("level", LEVELS)
def test_prolong_bilinear(level):
    grid = unit_interval_grid(2, level)
    st = gallery.MultilinearInterpolationGenerator((2, 2)) \
        .generate_stencil(grid)
    coarse = tuple((n - 1) // 2 for n in grid.size)
    e = _field(coarse, level + 30)
    out = tops.prolong(st, torch.tensor(e), grid.size)
    assert tuple(out.shape) == tuple(grid.size)
    _close(out, jops.prolong(st, jnp.asarray(e), grid.size))


@pytest.mark.parametrize("level", [3, 4, 5])
def test_dense_matrix(level):
    grid = unit_interval_grid(2, level)
    st = gallery.Poisson2D().generate_stencil(grid)
    np.testing.assert_array_equal(tops.dense_matrix(st, grid),
                                  jops.dense_matrix(st, grid))


@pytest.mark.parametrize("kind", ["injection", "non_separable"])
def test_transfer_fallbacks(kind):
    """Transfers that are not separable 3-tap stencils: injection, and a
    5-point weighting applied then subsampled / scattered then applied."""
    from evostencils_tpu.stencils.constant import Stencil
    grid = unit_interval_grid(2, 6)
    st = None if kind == "injection" else Stencil(
        [((0, 0), 0.5), ((-1, 0), 0.125), ((1, 0), 0.125),
         ((0, -1), 0.125), ((0, 1), 0.125)])
    u = _field(grid.size, 40)
    _close(tops.restrict(st, torch.tensor(u)),
           jops.restrict(st, jnp.asarray(u)))
    coarse = tuple((n - 1) // 2 for n in grid.size)
    e = _field(coarse, 41)
    _close(tops.prolong(st, torch.tensor(e), grid.size),
           jops.prolong(st, jnp.asarray(e), grid.size))


def test_separable_factors_match():
    grid = unit_interval_grid(2, 5)
    for gen in (gallery.FullWeightingRestrictionGenerator((2, 2)),
                gallery.MultilinearInterpolationGenerator((2, 2))):
        st = gen.generate_stencil(grid)
        (tv, tr), (jv, jr) = tops.separable_factors(st), \
            jops.separable_factors(st)
        assert tr == jr
        for a, b in zip(tv, jv):
            np.testing.assert_array_equal(a, b)
    assert tops.separable_factors(
        gallery.Poisson2D().generate_stencil(grid)) is None


def test_red_black_masks_parity():
    """Red is an even node-index sum; interior (0, 0) is node (1, 1)."""
    red, black = tops.red_black_masks((5, 7), device="cpu",
                                      dtype=torch.float64)
    i, j = np.meshgrid(np.arange(5), np.arange(7), indexing="ij")
    np.testing.assert_array_equal(red.numpy(), ((i + j) % 2 == 0) * 1.0)
    np.testing.assert_array_equal(black.numpy(), 1.0 - red.numpy())
