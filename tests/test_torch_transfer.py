"""The plain PyTorch versions of the two leg kernels
(evostencils_tpu_torch/ops/kernels/transfer.py) against the Pallas kernels
they port, run in interpret mode on the CPU as tests/test_fused_columns.py
runs them.

float32, distinct relaxation factors per sweep so that their order is
checked.  Tolerances are the reassociation slack that
tests/test_fused_columns.py grants the Pallas kernels in float32: 1e-5 on
the fine grid and 1e-4 on the restricted residual.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from evostencils_tpu.ops.pallas import transfer as pt
from evostencils_tpu_torch.ops.kernels import transfer as tt

VALS = (4.0, -1.0, -1.0, -1.0, -1.0)
R_TAPS = ((0.25, 0.5, 0.25), (0.25, 0.5, 0.25))
P_TAPS = ((0.5, 1.0, 0.5), (0.5, 1.0, 0.5))
SHAPES = [(131, 131), (259, 515)]
#: relaxation factors: a coarse-grid-correction factor, then one per sweep
OMEGAS = (0.9, 1.15, 0.8, 1.3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the eager ops on these grids run as fast on
    one, and the test run's parallel workers would otherwise oversubscribe
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(n, m, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, m)).astype(np.float32)
    b = rng.standard_normal((n, m)).astype(np.float32)
    e = rng.standard_normal(((n - 1) // 2, (m - 1) // 2)).astype(np.float32)
    return u, b, e


def _omegas():
    return torch.tensor(OMEGAS, dtype=torch.float32)


@pytest.mark.parametrize("sweeps", [1, 2, 3])
@pytest.mark.parametrize("shape", SHAPES)
def test_presmooth_residual_restrict_plain(shape, sweeps):
    u, b, _ = _data(*shape)
    ids = [1, 2, 3][:sweeps]
    us0, rc0 = pt.presmooth_residual_restrict(
        jnp.asarray(u), jnp.asarray(b), [OMEGAS[i] for i in ids], VALS,
        R_TAPS, interpret=True)
    tt.reset_launches()
    us1, rc1 = tt.presmooth_residual_restrict(
        torch.tensor(u), torch.tensor(b), _omegas(), ids, VALS, R_TAPS)
    assert tt.launches["presmooth_residual_restrict"] == 0
    np.testing.assert_allclose(us1.numpy(), np.asarray(us0), atol=1e-5)
    np.testing.assert_allclose(rc1.numpy(), np.asarray(rc0), atol=1e-4)


@pytest.mark.parametrize("sweeps", [1, 2, 3])
@pytest.mark.parametrize("shape", SHAPES)
def test_prolong_correct_postsmooth_col_plain(shape, sweeps):
    u, b, e = _data(*shape, seed=1)
    ids = [0, 1, 2, 3][:sweeps + 1]
    o0 = pt.prolong_correct_postsmooth_col(
        jnp.asarray(u), jnp.asarray(e), jnp.asarray(b),
        [OMEGAS[i] for i in ids], VALS, P_TAPS, interpret=True)
    tt.reset_launches()
    o1 = tt.prolong_correct_postsmooth_col(
        torch.tensor(u), torch.tensor(e), torch.tensor(b), _omegas(), ids,
        VALS, P_TAPS)
    assert tt.launches["prolong_correct_postsmooth_col"] == 0
    np.testing.assert_allclose(o1.numpy(), np.asarray(o0), atol=1e-5)


def test_omega_order_matters():
    """Reversing the sweep factors changes the result, so the tests above
    do check their order."""
    u, b, _ = _data(131, 131)
    args = (torch.tensor(u), torch.tensor(b), _omegas())
    fwd, _ = tt.presmooth_residual_restrict(*args, [1, 2, 3], VALS, R_TAPS)
    rev, _ = tt.presmooth_residual_restrict(*args, [3, 2, 1], VALS, R_TAPS)
    assert float((fwd - rev).abs().max()) > 1e-3


def test_gate():
    z = torch.zeros
    assert tt.supports(z(255, 255))
    assert tt.supports(z(129, 129, dtype=torch.float64))   # CPU: any float
    assert not tt.supports(z(127, 127))                    # too few rows
    assert not tt.supports(z(255, 127))                    # too few columns
    assert not tt.supports(z(256, 255))                    # even rows
    assert not tt.supports(z(3, 255, 255))                 # not 2D


@pytest.mark.parametrize("case", ["sweeps", "omega_id", "coarse_shape",
                                  "even", "device"])
def test_leg_arguments_rejected(case):
    u, b, e = (torch.tensor(a) for a in _data(131, 131))
    om = _omegas()
    if case == "sweeps":
        with pytest.raises(ValueError):
            tt.presmooth_residual_restrict(u, b, om, [1, 1, 1, 1], VALS,
                                           R_TAPS)
    elif case == "omega_id":
        with pytest.raises(IndexError):
            tt.prolong_correct_postsmooth_col(u, e, b, om, [0, 4], VALS,
                                              P_TAPS)
    elif case == "coarse_shape":
        with pytest.raises(ValueError):
            tt.prolong_correct_postsmooth_col(u, e[:-1], b, om, [0, 1], VALS,
                                              P_TAPS)
    elif case == "even":
        with pytest.raises(ValueError):
            tt.presmooth_residual_restrict(u[:-1], b[:-1], om, [1], VALS,
                                           R_TAPS)
    else:
        with pytest.raises(ValueError):
            tt.presmooth_residual_restrict(u.to("meta"), b.to("meta"),
                                           om.to("meta"), [1], VALS, R_TAPS)


# ---------------------------------------------------------------------------
# the standalone transfers: residual + full restriction, prolongation +
# correction (counterparts of residual_rowrestrict and prolong_row_correct
# with the column halves that compiler/lower.py runs in XLA)
# ---------------------------------------------------------------------------

import jax

from evostencils_tpu.compiler import lower as jlower

#: an anisotropic stencil and asymmetric taps, so that a swapped axis or
#: direction shows; atol 2e-5 in float32 for the reassociated sums
ANISO = (5.0, -1.5, -0.5, -1.25, -0.75)
R_TAPS_ASYM = ((0.2, 0.5, 0.3), (0.1, 0.6, 0.3))
P_TAPS_ASYM = ((0.4, 1.0, 0.6), (0.3, 0.9, 0.5))
SHAPES_RR = [(257, 255), (129, 131), (255, 255)]


@pytest.mark.parametrize("vals,taps", [(VALS, R_TAPS),
                                       (ANISO, R_TAPS_ASYM)])
@pytest.mark.parametrize("shape", SHAPES_RR)
def test_residual_restrict_plain(shape, vals, taps):
    """Against lower.py:1338-1340: the Pallas row half in interpret mode,
    then XLA's column half."""
    u, b, _ = _data(*shape, seed=2)
    rr = pt.residual_rowrestrict(jnp.asarray(u), jnp.asarray(b), vals,
                                 taps[0], interpret=True)
    want = jlower._col_restrict(rr, taps[1], shape[1])
    tt.reset_launches()
    got = tt.residual_restrict(torch.tensor(u), torch.tensor(b), vals, taps)
    assert tt.launches["residual_restrict"] == 0
    assert tuple(got.shape) == ((shape[0] - 1) // 2, (shape[1] - 1) // 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("taps", [P_TAPS, P_TAPS_ASYM])
@pytest.mark.parametrize("shape", SHAPES_RR)
def test_prolong_correct_plain(shape, taps):
    """Against lower.py:1373-1376: XLA's column prolongation, then the
    Pallas row prolongation and correction in interpret mode; the factor
    is omegas[2]."""
    u, _, e = _data(*shape, seed=3)
    c_half = jlower._col_prolong(jnp.asarray(e), taps[1], shape[1])
    want = pt.prolong_row_correct(jnp.asarray(u), c_half,
                                  jnp.asarray(OMEGAS[2], jnp.float32),
                                  taps[0], interpret=True)
    tt.reset_launches()
    got = tt.prolong_correct(torch.tensor(u), torch.tensor(e), _omegas(), 2,
                             taps)
    assert tt.launches["prolong_correct"] == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("shape", [(4095, 4095), (1023, 1023), (257, 255),
                                   (255, 255), (129, 131), (129, 129),
                                   (127, 127), (255, 127), (256, 255),
                                   (3, 255, 255)])
def test_gate_matches_jax(shape):
    """On a device other than the CPU (``meta`` stands in for the card)
    and in float32, the port's gate admits the shapes the JAX gate admits.
    Both take odd row counts only; the port also needs an odd column count
    (the hierarchy's grids are 2^l - 1 on both axes)."""
    want = pt.supports(jax.ShapeDtypeStruct(shape, jnp.float32))
    assert tt.supports(torch.empty(shape, device="meta")) == want
    assert not tt.supports(torch.empty(shape, device="meta",
                                       dtype=torch.float64))


@pytest.mark.parametrize("case", ["coarse_shape", "even", "omega_id",
                                  "rhs_shape", "device"])
def test_transfer_arguments_rejected(case):
    u, b, e = (torch.tensor(a) for a in _data(131, 131))
    om = _omegas()
    if case == "coarse_shape":
        with pytest.raises(ValueError):
            tt.prolong_correct(u, e[:, :-1], om, 0, P_TAPS)
    elif case == "even":
        with pytest.raises(ValueError):
            tt.residual_restrict(u[:, :-1], b[:, :-1], VALS, R_TAPS)
    elif case == "omega_id":
        with pytest.raises(IndexError):
            tt.prolong_correct(u, e, om, len(OMEGAS), P_TAPS)
    elif case == "rhs_shape":
        with pytest.raises(ValueError):
            tt.residual_restrict(u, b[:-2], VALS, R_TAPS)
    else:
        with pytest.raises(ValueError):
            tt.residual_restrict(u.to("meta"), b.to("meta"), VALS, R_TAPS)
