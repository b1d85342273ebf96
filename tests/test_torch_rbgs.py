"""The plain PyTorch versions of the standalone sweep kernels
(evostencils_tpu_torch/ops/kernels/rbgs.py) against the Pallas kernels
they port (evostencils_tpu/ops/pallas/rbgs.py), run in interpret mode on
the CPU as tests/test_pallas_kernels.py runs them.

float32 at the JAX tests' shapes, atol = rtol = 2e-6 as
tests/test_pallas_kernels.py:31-60 grants the Pallas kernels against
their reference.  Besides the normalized Laplacian, an anisotropic
5-point stencil whose four neighbour coefficients all differ, so that an
axis or a direction swapped in the port shows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from evostencils_tpu.ops.pallas import rbgs as pr
from evostencils_tpu_torch.ops.kernels import rbgs as tr
from evostencils_tpu_torch.stencils.constant import Stencil

SHAPES = [(257, 255), (256, 128), (300, 200), (129, 130), (96, 140)]
STENCILS = {"laplace": (4.0, -1.0, -1.0, -1.0, -1.0),
            "aniso": (5.0, -1.5, -0.5, -1.25, -0.75)}
#: the sweep reads omegas[OMEGA_ID]; the other entries must not matter
OMEGAS = (0.6, 1.15, 0.8)
OMEGA_ID = 1
SWEEPS = {"fused_rbgs_sweep": (pr.fused_rbgs_sweep, tr.fused_rbgs_sweep),
          "jacobi_sweep": (pr.jacobi_sweep, tr.jacobi_sweep),
          "rbgs_sweep": (pr.rbgs_sweep, tr.rbgs_sweep)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the eager ops on these grids run as fast on
    one, and the test run's parallel workers would otherwise oversubscribe
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(n, m, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, m)).astype(np.float32),
            rng.standard_normal((n, m)).astype(np.float32))


@pytest.mark.parametrize("stencil", sorted(STENCILS))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sweep", sorted(SWEEPS))
def test_sweep_plain_matches_pallas(sweep, shape, stencil):
    vals = STENCILS[stencil]
    u, b = _data(*shape, seed=len(sweep) + shape[0])
    jax_fn, port_fn = SWEEPS[sweep]
    want = jax_fn(jnp.asarray(u), jnp.asarray(b),
                  jnp.asarray(OMEGAS[OMEGA_ID], jnp.float32), vals,
                  1.0 / vals[0], interpret=True)
    tr.reset_launches()
    got = port_fn(torch.tensor(u), torch.tensor(b),
                  torch.tensor(OMEGAS, dtype=torch.float32), OMEGA_ID, vals)
    assert tr.launches == {"fused_rbgs_sweep": 0, "jacobi_sweep": 0}
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=2e-6)


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("shape", [(257, 255), (96, 140)])
def test_single_colour_pass_matches_pallas(shape, parity):
    """The sweep kernel's single-colour modes, each on its own, against
    ``_sweep_call`` (rbgs.py:89) with the same parity."""
    vals = STENCILS["aniso"]
    u, b = _data(*shape, seed=7 + parity)
    want = pr._sweep_call(jnp.asarray(u), jnp.asarray(b),
                          jnp.asarray(OMEGAS[OMEGA_ID], jnp.float32),
                          stencil_vals=vals, dinv=1.0 / vals[0],
                          parity=parity, interpret=True)
    got = tr.sweep(torch.tensor(u), torch.tensor(b),
                   torch.tensor(OMEGAS, dtype=torch.float32), OMEGA_ID, vals,
                   parity)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=2e-6)
    # the other colour is left as it was
    red = (np.add.outer(np.arange(shape[0]), np.arange(shape[1])) % 2) == 0
    kept = ~red if parity == 0 else red
    np.testing.assert_array_equal(got.numpy()[kept], u[kept])


def test_sweeps_differ():
    """A Jacobi and a red-black sweep, the two stencils and two relaxation
    factors give distinct results, so the comparisons above tell them
    apart (the fused and the two-pass red-black sweeps are the same
    update, see below)."""
    u, b = (torch.tensor(a) for a in _data(129, 130, seed=0))
    om = torch.tensor(OMEGAS, dtype=torch.float32)
    outs = [fn(u, b, om, OMEGA_ID, STENCILS["aniso"])
            for fn in (tr.jacobi_sweep, tr.fused_rbgs_sweep)]
    outs.append(tr.fused_rbgs_sweep(u, b, om, OMEGA_ID, STENCILS["laplace"]))
    outs.append(tr.fused_rbgs_sweep(u, b, om, 0, STENCILS["aniso"]))
    for i in range(len(outs)):
        for j in range(i):
            assert float((outs[i] - outs[j]).abs().max()) > 1e-3


def test_fused_equals_two_half_sweeps_f64():
    """In float64 the fused sweep and the two single-colour passes agree
    to rounding: the same red-then-black update, summed in two orders."""
    rng = np.random.default_rng(4)
    u = torch.tensor(rng.standard_normal((300, 200)))
    b = torch.tensor(rng.standard_normal((300, 200)))
    om = torch.tensor(OMEGAS, dtype=torch.float64)
    vals = STENCILS["aniso"]
    fused = tr.fused_rbgs_sweep(u, b, om, OMEGA_ID, vals)
    assert fused.dtype == torch.float64
    two = tr.rbgs_sweep(u, b, om, OMEGA_ID, vals)
    np.testing.assert_allclose(fused.numpy(), two.numpy(), rtol=0,
                               atol=1e-13)


def test_five_point_values_matches_jax():
    cases = [Stencil([((0, 0), 4.0), ((-1, 0), -1.0), ((1, 0), -2.0),
                      ((0, -1), -3.0), ((0, 1), -0.5)]),
             Stencil([((0, 0), 2.0), ((0, 1), -1.0)]),
             Stencil([((0, 0), 4.0), ((1, 1), -1.0)]),
             Stencil([((0, 0), 4.0 + 1.0j), ((1, 0), -1.0)])]
    for st in cases:
        assert tr.five_point_values(st) == pr.five_point_values(st)


SHAPES_GATE = [(4095, 4095), (1023, 1023), (255, 255), (127, 127),
               (8, 128), (7, 128), (8, 127), (300, 200), (96, 140),
               (3, 255, 255)]


@pytest.mark.parametrize("shape", SHAPES_GATE)
def test_gate_matches_jax(shape):
    """The port's gate admits the shapes the JAX gate admits, for float32
    on a device other than the CPU (a ``meta`` tensor stands in for the
    card)."""
    vals = STENCILS["laplace"]
    want = pr.supports(jax.ShapeDtypeStruct(shape, jnp.float32), vals)
    assert tr.supports(torch.empty(shape, device="meta"), vals) == want
    assert not tr.supports(torch.empty(shape, device="meta"), None)
    # off the CPU the kernels take float32 only
    assert not tr.supports(
        torch.empty(shape, device="meta", dtype=torch.float64), vals)


@pytest.mark.parametrize("case", ["omega_id", "shape", "center", "device",
                                  "mixed_devices", "parity"])
def test_sweep_arguments_rejected(case):
    u, b = (torch.tensor(a) for a in _data(129, 130, seed=5))
    om = torch.tensor(OMEGAS, dtype=torch.float32)
    vals = STENCILS["laplace"]
    if case == "omega_id":
        with pytest.raises(IndexError):
            tr.jacobi_sweep(u, b, om, len(OMEGAS), vals)
    elif case == "shape":
        with pytest.raises(ValueError):
            tr.fused_rbgs_sweep(u, b[:-1], om, 0, vals)
    elif case == "center":
        with pytest.raises(ValueError):
            tr.rbgs_sweep(u, b, om, 0, (0.0, -1.0, -1.0, -1.0, -1.0))
    elif case == "device":
        with pytest.raises(ValueError):
            tr.fused_rbgs_sweep(u.to("meta"), b.to("meta"), om.to("meta"),
                                0, vals)
    elif case == "parity":
        with pytest.raises(ValueError):
            tr.sweep(u, b, om, 0, vals, 2)
    else:
        with pytest.raises(ValueError):
            tr.jacobi_sweep(u, b.to("meta"), om, 0, vals)
