"""The port's 3D standalone kernels (evostencils_tpu_torch/ops/kernels/
rbgs3d.py and leg3d.py) against the Pallas kernels they port
(evostencils_tpu/ops/pallas/rbgs3d.py and leg3d.py), run in interpret mode
on the CPU as tests/test_pallas_3d.py and tests/test_leg3d.py run them;
their gates against the JAX gates; and which kernels one cycle step
reaches in each package.

float32 at the JAX tests' shapes: atol 2e-6 for the sweeps
(tests/test_pallas_3d.py:35-76), 2e-5 for the transfers
(tests/test_leg3d.py:53-92).  Besides the normalized Laplacian, an
anisotropic 7-point stencil whose six neighbour coefficients all differ,
and transfer taps that differ on every axis and are asymmetric, so that an
axis or a direction swapped in the port shows.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from evostencils_tpu.compiler import lower as jlower
from evostencils_tpu.config import config
from evostencils_tpu.ops.pallas import leg3d as pleg
from evostencils_tpu.ops.pallas import rbgs3d as prb
from evostencils_tpu.ops.pallas import wavefront3d as pwave
from evostencils_tpu_torch.compiler import lower as tlower
from evostencils_tpu_torch.convert import state_from_numpy
from evostencils_tpu_torch.ops.kernels import leg3d as tleg
from evostencils_tpu_torch.ops.kernels import rbgs3d as trb
from evostencils_tpu_torch.ops.kernels import wavefront3d as twave
from evostencils_tpu_torch.stencils.constant import Stencil

from tests.test_torch_slice3d import JAX, PORT

STENCILS = {"laplace": (6.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0),
            "aniso": (7.0, -1.5, -0.5, -1.25, -0.75, -2.0, -1.0)}
R_TAPS = ((0.2, 0.5, 0.3), (0.1, 0.6, 0.3), (0.3, 0.45, 0.25))
P_TAPS = ((0.4, 1.0, 0.6), (0.3, 0.9, 0.5), (0.7, 1.1, 0.2))
#: the sweeps read omegas[OMEGA_ID]; the other entries must not matter
OMEGAS = (0.6, 1.15, 0.8)
OMEGA_ID = 1
RBGS3D_SHAPES = [(10, 16, 128), (12, 40, 200), (16, 33, 130)]
LEG3D_SHAPES = [(31, 31, 63), (23, 39, 63)]
#: (JAX entry point, port wrapper) by name
SWEEPS = {"fused_rbgs_sweep_3d": (prb.fused_rbgs_sweep_3d,
                                  trb.fused_rbgs_sweep_3d),
          "jacobi_sweep_3d": (prb.jacobi_sweep_3d, trb.jacobi_sweep_3d),
          "fused_rbgs_sweep_3d2": (pleg.fused_rbgs_sweep_3d2,
                                   tleg.fused_rbgs_sweep_3d2),
          "jacobi_sweep_3d2": (pleg.jacobi_sweep_3d2,
                               tleg.jacobi_sweep_3d2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the eager ops on these grids run as fast on
    one, and the test run's parallel workers would otherwise oversubscribe
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _omegas():
    return torch.tensor(OMEGAS, dtype=torch.float32)


def _no_launches():
    return set(trb.launches.values()) | set(tleg.launches.values()) == {0}


@pytest.mark.parametrize("stencil", sorted(STENCILS))
@pytest.mark.parametrize("shape,sweep", [
    (shape, sweep) for sweep in sorted(SWEEPS)
    for shape in (RBGS3D_SHAPES if sweep.endswith("_3d") else LEG3D_SHAPES)])
def test_sweep_plain_matches_pallas(sweep, shape, stencil):
    vals = STENCILS[stencil]
    u, b = _normal(shape, 1), _normal(shape, 2)
    jax_fn, port_fn = SWEEPS[sweep]
    want = jax_fn(jnp.asarray(u), jnp.asarray(b),
                  jnp.asarray(OMEGAS[OMEGA_ID], jnp.float32), vals,
                  1.0 / vals[0], interpret=True)
    trb.reset_launches()
    tleg.reset_launches()
    got = port_fn(torch.tensor(u), torch.tensor(b), _omegas(), OMEGA_ID,
                  vals)
    assert _no_launches()
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6)


@pytest.mark.parametrize("stencil", sorted(STENCILS))
@pytest.mark.parametrize("shape", LEG3D_SHAPES)
def test_residual_restrict_plain_matches_pallas(shape, stencil):
    vals = STENCILS[stencil]
    u, b = _normal(shape, 3), _normal(shape, 4)
    want = pleg.residual_restrict_3d(jnp.asarray(u), jnp.asarray(b), vals,
                                     R_TAPS, interpret=True)
    tleg.reset_launches()
    got = tleg.residual_restrict_3d(torch.tensor(u), torch.tensor(b), vals,
                                    R_TAPS)
    assert _no_launches()
    assert tuple(got.shape) == tuple((n - 1) // 2 for n in shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("shape", LEG3D_SHAPES)
def test_prolong_correct_plain_matches_pallas(shape):
    u = _normal(shape, 5)
    e = _normal(tuple((n - 1) // 2 for n in shape), 6)
    want = pleg.prolong_correct_3d(jnp.asarray(u), jnp.asarray(e),
                                   jnp.float32(OMEGAS[OMEGA_ID]), P_TAPS,
                                   interpret=True)
    tleg.reset_launches()
    got = tleg.prolong_correct_3d(torch.tensor(u), torch.tensor(e),
                                  _omegas(), OMEGA_ID, P_TAPS)
    assert _no_launches()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


def test_kernels_differ():
    """The two modes, the two stencils, two relaxation factors and
    transposed taps give distinct results, so the comparisons above tell
    them apart; the rbgs3d and leg3d sweeps are one function."""
    u, b = (torch.tensor(_normal((31, 31, 63), s)) for s in (7, 8))
    om = _omegas()
    outs = [fn(u, b, om, OMEGA_ID, STENCILS["aniso"])
            for fn in (trb.jacobi_sweep_3d, trb.fused_rbgs_sweep_3d)]
    outs.append(trb.fused_rbgs_sweep_3d(u, b, om, OMEGA_ID,
                                        STENCILS["laplace"]))
    outs.append(trb.fused_rbgs_sweep_3d(u, b, om, 0, STENCILS["aniso"]))
    for i in range(len(outs)):
        for j in range(i):
            assert float((outs[i] - outs[j]).abs().max()) > 1e-3
    assert torch.equal(
        tleg.fused_rbgs_sweep_3d2(u, b, om, OMEGA_ID, STENCILS["aniso"]),
        outs[1])
    rr = tleg.residual_restrict_3d(u, b, STENCILS["aniso"], R_TAPS)
    assert float((rr - tleg.residual_restrict_3d(
        u, b, STENCILS["aniso"], R_TAPS[::-1])).abs().max()) > 1e-3


def test_seven_taps_matches_jax():
    """Per-axis taps of separable 3D factorizations, and None for a radius
    other than 1 or a 2D one."""
    fac3 = ([np.array(t) for t in R_TAPS], (1, 1, 1))
    fac2 = ([np.array(t) for t in R_TAPS[:2]], (1, 1))
    wide = ([np.array((0.1,) * 5)] * 3, (2, 2, 2))
    for r_fac, p_fac in ((fac3, fac3), (fac3, fac2), (wide, fac3)):
        assert tleg.seven_taps(r_fac, p_fac) == pleg.seven_taps(r_fac, p_fac)
    assert tleg.seven_taps(fac3, fac3) == (R_TAPS, R_TAPS)


def test_seven_point_values_matches_jax():
    cases = [Stencil(list(zip(trb.SEVEN_OFFSETS, STENCILS["aniso"]))),
             Stencil([((0, 0, 0), 2.0), ((0, 0, 1), -1.0)]),
             Stencil([((0, 0, 0), 6.0), ((1, 1, 0), -1.0)]),
             Stencil([((0, 0), 4.0), ((1, 0), -1.0)]),
             Stencil([((0, 0, 0), 6.0 + 1.0j), ((1, 0, 0), -1.0)])]
    assert trb.SEVEN_OFFSETS == prb.SEVEN_OFFSETS
    for st in cases:
        assert trb.seven_point_values(st) == prb.seven_point_values(st)


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------

HIERARCHY = [(2 ** k - 1,) * 3 for k in range(9, 1, -1)]     # 511^3 .. 3^3
RAGGED = RBGS3D_SHAPES + LEG3D_SHAPES + [(65, 127, 255), (17, 33, 63),
                                         (31, 63, 127)]


@pytest.mark.parametrize("shape", HIERARCHY + RAGGED)
def test_gates_match_jax(shape):
    """On float32 off the CPU (a ``meta`` tensor stands in for the card)
    the port's gates admit what the JAX gates admit.  The wavefront gate
    of the port also asks for odd axes, which its kernels need; every
    level of a hierarchy is odd."""
    spec = jax.ShapeDtypeStruct(shape, jnp.float32)
    t = torch.empty(shape, dtype=torch.float32, device="meta")
    vals = STENCILS["laplace"]
    assert trb.supports(t, vals) == prb.supports(spec, vals)
    assert tleg.supports(t) == pleg.supports(spec)
    odd = all(n % 2 for n in shape)
    assert twave.supports(t) == (odd and pwave.supports(spec))
    # off the CPU the kernels take float32 only
    t64 = torch.empty(shape, dtype=torch.float64, device="meta")
    assert not (trb.supports(t64, vals) or tleg.supports(t64)
                or twave.supports(t64))


def test_gate_levels():
    """The JAX gates' level sets on the 255^3 and 511^3 hierarchies:
    rbgs3d takes 127^3 and 63^3, leg3d 63^3 and up, the wavefront legs
    63^3 to 255^3."""
    def levels(gate):
        return [s[0] for s in HIERARCHY
                if gate(torch.empty(s, device="meta"))]
    assert levels(lambda t: trb.supports(t, STENCILS["laplace"])) == [127, 63]
    assert levels(tleg.supports) == [511, 255, 127, 63]
    assert levels(twave.supports) == [255, 127, 63]


@pytest.mark.parametrize("n", [127, 63, 31])
def test_cpu_f64_takes_the_f32_levels(n):
    """The CPU's float64 runs take the levels the card's float32 runs take:
    the rbgs3d gate reckons 4 bytes a value whatever the dtype."""
    u64 = torch.empty((n, n, n), dtype=torch.float64)
    u32 = torch.empty((n, n, n), dtype=torch.float32, device="meta")
    vals = STENCILS["laplace"]
    assert trb.supports(u64, vals) == trb.supports(u32, vals)
    assert tleg.supports(u64) == tleg.supports(u32)
    assert twave.supports(u64) == twave.supports(u32)


# ---------------------------------------------------------------------------
# dispatch: which kernels one cycle step reaches
# ---------------------------------------------------------------------------

#: the JAX entry points that the 3D lowering reaches, by module
ENTRY_POINTS = [(prb, trb, "fused_rbgs_sweep_3d"),
                (prb, trb, "jacobi_sweep_3d"),
                (pleg, tleg, "fused_rbgs_sweep_3d2"),
                (pleg, tleg, "jacobi_sweep_3d2"),
                (pleg, tleg, "residual_restrict_3d"),
                (pleg, tleg, "prolong_correct_3d"),
                (pwave, twave, "downleg_wavefront_3d"),
                (pwave, twave, "upleg_wavefront_3d")]
#: hand-built cycles: (pre-sweeps, post-sweeps, partitioning, omega)
CYCLES = {"rb_v21": (2, 1, "RedBlack", 1.15),
          "rb_v11": (1, 1, "RedBlack", 1.15),
          "jacobi_v21": (2, 1, "Single", 0.8)}
#: what one step at 63^3 (levels 6 -> 2) launches: only 63^3 passes the
#: gates; with the rbgs3d budget starved, its sweeps go to leg3d
EXPECTED = {
    ("rb_v21", False): {"downleg_wavefront_3d": 1, "upleg_wavefront_3d": 1},
    ("rb_v11", False): {"fused_rbgs_sweep_3d": 1, "residual_restrict_3d": 1,
                        "upleg_wavefront_3d": 1},
    ("jacobi_v21", False): {"jacobi_sweep_3d": 3, "residual_restrict_3d": 1,
                            "prolong_correct_3d": 1},
    ("rb_v11", True): {"fused_rbgs_sweep_3d2": 1, "residual_restrict_3d": 1,
                       "upleg_wavefront_3d": 1},
    ("jacobi_v21", True): {"jacobi_sweep_3d2": 3, "residual_restrict_3d": 1,
                           "prolong_correct_3d": 1},
}


def _cycle(pkg, key):
    pre, post, partitioning, omega = CYCLES[key]
    problem = pkg.problems.poisson_3d(max_level=6, min_level=2)
    problem.dtype = np.float32
    cycle = pkg.cycles.v_cycle(
        problem.level_contexts, problem.rhs_entity, pre_smoothing=pre,
        post_smoothing=post, omega=omega,
        partitioning=getattr(pkg.part, partitioning),
        coarse_operator=problem.coarsest_operator)
    return problem, cycle


def _count(monkeypatch, calls, module, name):
    """Count the calls of ``module.name`` that no other counted call
    makes: the JAX ``jacobi_sweep_3d2`` runs ``fused_rbgs_sweep_3d2``
    (leg3d.py:209-211)."""
    fn = getattr(module, name)

    def counted(*a, **k):
        if calls["_active"]:
            return fn(*a, **k)
        calls[name.replace("_plain", "")] += 1
        calls["_active"] = 1
        try:
            return fn(*a, **k)
        finally:
            calls["_active"] = 0
    monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("key,starved", sorted(EXPECTED))
def test_step_dispatch_matches_jax(monkeypatch, key, starved):
    """One step of each hand-built cycle at 63^3 in float32 reaches the
    same kernels in both packages: the Pallas entry points (interpret mode)
    in the JAX lowering, the plain versions in the port.  The steps agree
    to 2e-5.  ``starved`` sets both packages' rbgs3d budget to 1 byte, as
    tests/test_leg3d.py does, so that the leg3d sweeps take the level."""
    if starved:
        monkeypatch.setattr(prb, "_VMEM_BUDGET", 1)
        monkeypatch.setattr(trb, "_VMEM_BUDGET", 1)
    jax_calls, port_calls = collections.Counter(), collections.Counter()
    for pmod, tmod, name in ENTRY_POINTS:
        _count(monkeypatch, jax_calls, pmod, name)
        _count(monkeypatch, port_calls, tmod, name + "_plain")
    monkeypatch.setattr(config, "use_pallas_kernels", True)

    pj, cj = _cycle(JAX, key)
    pt, ct = _cycle(PORT, key)
    lj = jlower.lower_cycle(cj, pj.approximation, pj.rhs_entity)
    lt = tlower.lower_cycle(ct, pt.approximation, pt.rhs_entity)
    np.testing.assert_array_equal(lt.default_omegas, lj.default_omegas)
    b = [np.asarray(x) for x in pj.build_rhs()]
    u0 = [_normal(x.shape, 9) for x in b]
    ref = lj.step(tuple(jnp.asarray(x) for x in u0),
                  tuple(jnp.asarray(x) for x in b),
                  jnp.asarray(lj.default_omegas, jnp.float32))
    u, bt, om = state_from_numpy(u0, b, lt.default_omegas, device="cpu",
                                 dtype=torch.float32)
    out = lt.step(u, bt, om)

    for calls in (jax_calls, port_calls):
        del calls["_active"]
    assert dict(jax_calls) == EXPECTED[(key, starved)]
    assert port_calls == jax_calls
    assert out[0].dtype == torch.float32
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("case", ["omega_id", "shape", "center", "device",
                                  "mixed_devices", "even", "coarse_shape"])
def test_arguments_rejected(case):
    u, b = (torch.tensor(_normal((17, 17, 63), s)) for s in (1, 2))
    e = torch.tensor(_normal((8, 8, 31), 3))
    om = _omegas()
    vals = STENCILS["laplace"]
    if case == "omega_id":
        with pytest.raises(IndexError):
            trb.jacobi_sweep_3d(u, b, om, len(OMEGAS), vals)
        with pytest.raises(IndexError):
            tleg.prolong_correct_3d(u, e, om, len(OMEGAS), P_TAPS)
    elif case == "shape":
        with pytest.raises(ValueError):
            tleg.fused_rbgs_sweep_3d2(u, b[:-1], om, 0, vals)
    elif case == "center":
        with pytest.raises(ValueError):
            trb.fused_rbgs_sweep_3d(u, b, om, 0, (0.0,) + vals[1:])
    elif case == "device":
        with pytest.raises(ValueError):
            tleg.residual_restrict_3d(u.to("meta"), b.to("meta"), vals,
                                      R_TAPS)
    elif case == "mixed_devices":
        with pytest.raises(ValueError):
            trb.jacobi_sweep_3d(u, b.to("meta"), om, 0, vals)
    elif case == "even":
        with pytest.raises(ValueError):
            tleg.residual_restrict_3d(u[:-1], b[:-1], vals, R_TAPS)
    else:
        with pytest.raises(ValueError):
            tleg.prolong_correct_3d(u, e[:-1], om, 0, P_TAPS)
