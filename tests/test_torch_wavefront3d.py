"""The plain PyTorch versions of the two 3D leg kernels
(evostencils_tpu_torch/ops/kernels/wavefront3d.py) against the Pallas
kernels they port, run in interpret mode on the CPU as
tests/test_wavefront3d.py runs them.

float32, the shapes of tests/test_wavefront3d.py:17-61 and :113-131, and
its tolerance: atol 2e-5 on the fine grid and on the restricted residual.
The two relaxation factors differ, so their order is checked.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from evostencils_tpu.ops.pallas import wavefront3d as pw
from evostencils_tpu_torch.ops.apply import red_black_masks
from evostencils_tpu_torch.ops.kernels import wavefront3d as tw

STENCIL = (6.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0)   # 7-point Laplacian
DINV = 1.0 / 6.0
R_TAPS = ((0.25, 0.5, 0.25),) * 3
P_TAPS = ((0.5, 1.0, 0.5),) * 3
SHAPES = [(31, 31, 31), (33, 31, 35)]
#: relaxation factors: the coarse-grid-correction factor, then the sweeps'
OMEGAS = (0.9, 1.15, 0.8)
ATOL = 2e-5


def _data(shape, seed):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    e = rng.standard_normal(tuple((n - 1) // 2 for n in shape)) \
        .astype(np.float32)
    return u, b, e


def _omegas():
    return torch.tensor(OMEGAS, dtype=torch.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_downleg_plain_matches_pallas(shape):
    u, b, _ = _data(shape, 5)
    us0, rc0 = pw.downleg_wavefront_3d(
        jnp.asarray(u), jnp.asarray(b), (OMEGAS[1], OMEGAS[2]), STENCIL,
        DINV, R_TAPS, interpret=True)
    tw.reset_launches()
    us1, rc1 = tw.downleg_wavefront_3d(torch.tensor(u), torch.tensor(b),
                                       _omegas(), [1, 2], STENCIL, R_TAPS)
    assert tw.launches["downleg_wavefront_3d"] == 0
    assert tuple(rc1.shape) == tuple((n - 1) // 2 for n in shape)
    np.testing.assert_allclose(us1.numpy(), np.asarray(us0), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(rc1.numpy(), np.asarray(rc0), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_upleg_plain_matches_pallas(shape):
    u, b, e = _data(shape, 9)
    o0 = pw.upleg_wavefront_3d(
        jnp.asarray(u), jnp.asarray(e), jnp.asarray(b), OMEGAS[0],
        OMEGAS[1], STENCIL, DINV, P_TAPS, interpret=True)
    tw.reset_launches()
    o1 = tw.upleg_wavefront_3d(torch.tensor(u), torch.tensor(e),
                               torch.tensor(b), _omegas(), [0, 1], STENCIL,
                               P_TAPS)
    assert tw.launches["upleg_wavefront_3d"] == 0
    np.testing.assert_allclose(o1.numpy(), np.asarray(o0), rtol=0,
                               atol=ATOL)


def test_omega_order_matters():
    """Swapping the two sweep factors changes the result, so the down-leg
    test above does check their order."""
    u, b, _ = _data((31, 31, 31), 5)
    args = (torch.tensor(u), torch.tensor(b), _omegas())
    fwd, _ = tw.downleg_wavefront_3d(*args, [1, 2], STENCIL, R_TAPS)
    rev, _ = tw.downleg_wavefront_3d(*args, [2, 1], STENCIL, R_TAPS)
    assert float((fwd - rev).abs().max()) > 1e-3


def test_red_is_odd_interior_sum():
    """One red half-sweep from u = 0 with b = 1 moves exactly the cells of
    odd interior-index sum (even node sum), as the TPU kernel's checker
    (wavefront3d.py:98)."""
    shape = (5, 7, 9)
    u = torch.zeros(shape, dtype=torch.float64)
    red, _ = red_black_masks(shape, device="cpu", dtype=torch.bool)
    out = tw._half_sweep(u, torch.ones(shape, dtype=torch.float64),
                         torch.tensor(1.0, dtype=torch.float64), red, STENCIL)
    i, j, k = np.meshgrid(*(np.arange(n) for n in shape), indexing="ij")
    np.testing.assert_array_equal(out.numpy() != 0, (i + j + k) % 2 == 1)


def test_gate_matches_jax_at_255():
    """The port admits the levels of a 255^3 hierarchy that the JAX gate
    (wavefront3d.py:210-217) admits: 255^3, 127^3 and 63^3."""
    sizes = [2 ** k - 1 for k in range(8, 1, -1)]      # 255 .. 3
    for n in sizes:
        t = torch.empty((n, n, n), device="meta")
        jax_admits = pw.supports(jax.ShapeDtypeStruct((n, n, n),
                                                      jnp.float32))
        assert tw.supports(t) == jax_admits, n
        assert tw.supports(t) == (n >= 63), n
    z = torch.zeros
    assert tw.supports(z(9, 31, 63, dtype=torch.float64))  # CPU: any float
    assert not tw.supports(z(255, 255, device="meta"))       # not 3D
    assert not tw.supports(z(256, 255, 255, device="meta"))  # even
    assert not tw.supports(z(7, 63, 63, device="meta"))      # too few planes
    assert not tw.supports(z(63, 63, 61, device="meta"))     # too few lanes
    assert not tw.supports(z(63, 513, 511, device="meta"))   # plane too big


@pytest.mark.parametrize("case", ["omega_count", "omega_id", "coarse_shape",
                                  "even", "device"])
def test_leg_arguments_rejected(case):
    u, b, e = (torch.tensor(a) for a in _data((31, 31, 31), 1))
    om = _omegas()
    if case == "omega_count":
        with pytest.raises(ValueError):
            tw.downleg_wavefront_3d(u, b, om, [1, 2, 1], STENCIL, R_TAPS)
    elif case == "omega_id":
        with pytest.raises(IndexError):
            tw.upleg_wavefront_3d(u, e, b, om, [0, 3], STENCIL, P_TAPS)
    elif case == "coarse_shape":
        with pytest.raises(ValueError):
            tw.upleg_wavefront_3d(u, e[:-1], b, om, [0, 1], STENCIL, P_TAPS)
    elif case == "even":
        with pytest.raises(ValueError):
            tw.downleg_wavefront_3d(u[:-1], b[:-1], om, [1, 2], STENCIL,
                                    R_TAPS)
    else:
        with pytest.raises(ValueError):
            tw.downleg_wavefront_3d(u.to("meta"), b.to("meta"),
                                    om.to("meta"), [1, 2], STENCIL, R_TAPS)
