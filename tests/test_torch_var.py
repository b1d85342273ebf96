"""The port's variable-coefficient operator (evostencils_tpu_torch/ops/
apply.py ``StencilField``) and kernels (ops/kernels/rbgs_var.py) against
the JAX package: the coefficient fields and stacks, the field's apply,
diagonal and dense matrix, the plain versions of the four kernels against
the Pallas kernels they port (evostencils_tpu/ops/pallas/rbgs_var.py, run
in interpret mode on the CPU as tests/test_pallas_var.py runs them), their
gates against the JAX gates, and which kernels one cycle step reaches in
each package.

float32 results are held to 2e-6 times their largest magnitude: the
plain versions repeat each Pallas body's order of operations, and the two
agree to about 1e-6 of it.  The inputs are seeded numpy arrays, a
diagonally dominant random stack and the problem's own stack, at 255^2
and ragged shapes (259 x 131 for the legs, odd on both axes; 65 x 130 for
the sweeps).
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from evostencils_tpu.compiler import lower as jlower
from evostencils_tpu.config import config
from evostencils_tpu.ops import apply as japply
from evostencils_tpu.ops.pallas import rbgs_var as prv
from evostencils_tpu.ops.pallas import transfer as ptransfer
from evostencils_tpu.problems import poisson as jpoisson
from evostencils_tpu_torch.compiler import lower as tlower
from evostencils_tpu_torch.convert import (stack_from_numpy,
                                           state_from_numpy,
                                           stencil_field_from_numpy)
from evostencils_tpu_torch.ops import apply as tapply
from evostencils_tpu_torch.ops.kernels import rbgs_var as trv
from evostencils_tpu_torch.ops.kernels import transfer as ttransfer
from evostencils_tpu_torch.problems import poisson as tpoisson

from tests.test_torch_slice3d import JAX, PORT

#: relative tolerance: max |port - JAX| <= RTOL * max |JAX|
RTOL = 2e-6
#: the legs read omegas[1:1 + S] (down) and omegas[0:1 + S] (up)
OMEGAS = (0.9, 1.15, 0.8, 1.3)
R_TAPS = ((0.2, 0.5, 0.3), (0.1, 0.6, 0.3))
P_TAPS = ((0.4, 1.0, 0.6), (0.3, 0.9, 0.5))
#: (shape, stack, sweeps, red-black) of the leg checks: every sweep count
#: and partitioning once, on the problem's stack at 255^2 and on a random
#: one at 259 x 131
LEG_CASES = [((255, 255), "problem", 1, True),
             ((255, 255), "problem", 2, False),
             ((255, 255), "problem", 3, True),
             ((259, 131), "random", 1, False),
             ((259, 131), "random", 2, True),
             ((259, 131), "random", 3, False)]
SWEEP_CASES = [((255, 255), "problem"), ((65, 130), "random")]


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


def _random_stack(shape, seed):
    """A diagonally dominant variable-coefficient 5-point stack
    (tests/test_pallas_var.py:18-25)."""
    rng = np.random.default_rng(seed)
    return np.stack([4.0 + rng.uniform(0.0, 2.0, shape)]
                    + [-1.0 + rng.uniform(-0.2, 0.2, shape)
                       for _ in range(4)])


def _field(pkg, n):
    """The finest StencilField of ``poisson_2d_variable`` at n^2."""
    level = (n + 1).bit_length() - 1
    problem = pkg.problems.poisson_2d_variable(max_level=level,
                                               min_level=level - 1)
    op = problem.level_contexts[0].operator.entries[0][0]
    return op.stencil_generator.generate_stencil_field(op.grid)


def _stack(kind, shape, seed):
    if kind == "random":
        return _random_stack(shape, seed)
    return np.asarray(prv.five_point_stack(_field(JAX, shape[0]),
                                           jnp.float64))


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    err = np.abs(got - want).max()
    assert err <= RTOL * np.abs(want).max(), (err, np.abs(want).max())


def _omegas():
    return torch.tensor(OMEGAS, dtype=torch.float32)


# ---------------------------------------------------------------------------
# the field
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [63, 255])
def test_fields_and_stack_bitwise(n):
    """The generator's fields and the (5, n, m) stack equal the JAX
    package's bit for bit in float64."""
    sj, st = _field(JAX, n), _field(PORT, n)
    assert st.offsets == sj.offsets
    for a, b in zip(st.fields, sj.fields):
        assert a.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    stack = trv.five_point_stack(st, device="cpu", dtype=torch.float64)
    np.testing.assert_array_equal(
        stack.numpy(), np.asarray(prv.five_point_stack(sj, jnp.float64)))
    assert trv.FIVE_POINT_OFFSETS == prv.FIVE_POINT_OFFSETS
    # built once per field object, device and dtype
    assert trv.five_point_stack(st, device="cpu",
                                dtype=torch.float64) is stack


def _fields_of_every_kind(n):
    """(offsets, fields): the problem's genuinely varying fields plus a
    uniform one and one that differs on two rows, so that every branch of
    almost_uniform_desc is applied."""
    sf = _field(JAX, n)
    offsets = list(sf.offsets) + [(1, 1), (-1, 1)]
    rows = np.full((n, n), -0.5)
    rows[0] += 0.25
    rows[n - 1] -= 0.125
    return offsets, list(sf.fields) + [np.full((n, n), 0.75), rows]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_apply_matches_jax(dtype):
    offsets, fields = _fields_of_every_kind(63)
    sj = japply.StencilField(offsets, fields)
    st = stencil_field_from_numpy(offsets, fields, device="cpu", dtype=dtype)
    descs = [d[0] if d else None for d in st._uniform_values()]
    assert descs[-2:] == ["const", "rows"] and None in descs
    u = np.random.default_rng(1).standard_normal((63, 63))
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    want = np.asarray(sj.apply(jnp.asarray(u, jdtype)))
    got = st.apply(torch.tensor(u, dtype=dtype)).numpy()
    assert got.dtype == want.dtype
    scale = np.abs(want).max()
    tol = 1e-15 if dtype == torch.float64 else RTOL
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def test_diagonal_and_dense_matrix_match_jax():
    offsets, fields = _fields_of_every_kind(15)
    sj = japply.StencilField(offsets, fields)
    st = stencil_field_from_numpy(offsets, fields, device="cpu",
                                  dtype=torch.float64)
    np.testing.assert_array_equal(st.diagonal_field(), sj.diagonal_field())
    np.testing.assert_array_equal(
        st.diagonal_tensor("cpu", torch.float64).numpy(), sj.diagonal_field())
    np.testing.assert_array_equal(st.dense_matrix(), sj.dense_matrix())
    # the dense matrix is the field's apply
    u = np.random.default_rng(2).standard_normal((15, 15))
    np.testing.assert_allclose(
        (st.dense_matrix() @ u.ravel()).reshape(15, 15),
        st.apply(torch.tensor(u)).numpy(), rtol=1e-13, atol=1e-12)
    const = tapply.constant_stencil_field(
        tpoisson.gallery.Poisson2D().generate_stencil(
            tpoisson.unit_interval_grid(2, 4)), (15, 15))
    assert [d[0] for d in const._uniform_values()] == ["const"] * 5


def test_five_point_stack_rejects_other_shapes():
    """As tests/test_pallas_var.py:67-80: other offsets and complex
    coefficients give None, missing offsets are zero."""
    sf9 = tapply.StencilField([(0, 0), (1, 1)],
                              [np.ones((8, 8)), np.ones((8, 8))])
    assert trv.five_point_stack(sf9, device="cpu",
                                dtype=torch.float32) is None
    sfc = tapply.StencilField([(0, 0)], [np.ones((8, 8), complex)])
    assert trv.five_point_stack(sfc, device="cpu",
                                dtype=torch.float32) is None
    sf3 = tapply.StencilField([(0, 0), (-1, 0)],
                              [4 * np.ones((8, 8)), -np.ones((8, 8))])
    stack = trv.five_point_stack(sf3, device="cpu", dtype=torch.float32)
    assert tuple(stack.shape) == (5, 8, 8)
    np.testing.assert_array_equal(
        stack.numpy(),
        np.asarray(prv.five_point_stack(japply.StencilField(
            sf3.offsets, sf3.fields), jnp.float32)))
    np.testing.assert_array_equal(stack[2].numpy(), 0.0)


# ---------------------------------------------------------------------------
# the plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("red_black", [True, False])
@pytest.mark.parametrize("shape,stack", SWEEP_CASES)
def test_sweep_plain_matches_pallas(shape, stack, red_black):
    u, b = _normal(shape, 3), _normal(shape, 4)
    c = _stack(stack, shape, 5)
    jax_fn = prv.fused_rbgs_sweep_var if red_black else prv.jacobi_sweep_var
    port_fn = trv.fused_rbgs_sweep_var if red_black else trv.jacobi_sweep_var
    want = jax_fn(jnp.asarray(u), jnp.asarray(b), jnp.float32(OMEGAS[1]),
                  jnp.asarray(c, jnp.float32), interpret=True)
    trv.reset_launches()
    got = port_fn(torch.tensor(u), torch.tensor(b), _omegas(), 1,
                  stack_from_numpy(c, device="cpu", dtype=torch.float32))
    assert set(trv.launches.values()) == {0}
    _close(got.numpy(), want)


@pytest.mark.parametrize("shape,stack,sweeps,red_black", LEG_CASES)
def test_downleg_plain_matches_pallas(shape, stack, sweeps, red_black):
    u, b = _normal(shape, 6), _normal(shape, 7)
    c = _stack(stack, shape, 8)
    ids = list(range(1, 1 + sweeps))
    us_j, rc_j = prv.presmooth_residual_restrict_var(
        jnp.asarray(u), jnp.asarray(b), jnp.asarray(c, jnp.float32),
        [OMEGAS[i] for i in ids], R_TAPS, red_black=red_black,
        interpret=True)
    trv.reset_launches()
    us_t, rc_t = trv.presmooth_residual_restrict_var(
        torch.tensor(u), torch.tensor(b), _omegas(), ids,
        stack_from_numpy(c, device="cpu", dtype=torch.float32), R_TAPS,
        red_black=red_black)
    assert set(trv.launches.values()) == {0}
    _close(us_t.numpy(), us_j)
    _close(rc_t.numpy(), rc_j)


@pytest.mark.parametrize("shape,stack,sweeps,red_black", LEG_CASES)
def test_upleg_plain_matches_pallas(shape, stack, sweeps, red_black):
    n, m = shape
    u, b = _normal(shape, 9), _normal(shape, 10)
    e = _normal(((n - 1) // 2, (m - 1) // 2), 11)
    c = _stack(stack, shape, 12)
    ids = list(range(0, 1 + sweeps))
    want = prv.prolong_correct_postsmooth_var(
        jnp.asarray(u), jnp.asarray(e), jnp.asarray(b),
        jnp.asarray(c, jnp.float32), [OMEGAS[i] for i in ids], P_TAPS,
        red_black=red_black, interpret=True)
    trv.reset_launches()
    got = trv.prolong_correct_postsmooth_var(
        torch.tensor(u), torch.tensor(e), torch.tensor(b), _omegas(), ids,
        stack_from_numpy(c, device="cpu", dtype=torch.float32), P_TAPS,
        red_black=red_black)
    assert set(trv.launches.values()) == {0}
    _close(got.numpy(), want)


def test_kernels_differ():
    """The partitionings, two relaxation factors and transposed taps give
    distinct results, so the comparisons above tell them apart; a down-leg
    of one sweep smooths as the standalone sweep does, to rounding (the
    two take omega / cc and omega * (1 / cc))."""
    shape = (131, 131)
    u, b = (torch.tensor(_normal(shape, s)) for s in (13, 14))
    c = stack_from_numpy(_random_stack(shape, 15), device="cpu",
                         dtype=torch.float32)
    om = _omegas()
    outs = [trv.fused_rbgs_sweep_var(u, b, om, 1, c),
            trv.jacobi_sweep_var(u, b, om, 1, c),
            trv.fused_rbgs_sweep_var(u, b, om, 2, c)]
    for i in range(len(outs)):
        for j in range(i):
            assert float((outs[i] - outs[j]).abs().max()) > 1e-3
    for red_black, sweep in ((True, outs[0]), (False, outs[1])):
        _close(trv.presmooth_residual_restrict_var(
            u, b, om, [1], c, R_TAPS, red_black=red_black)[0].numpy(),
            sweep.numpy())
    rc = trv.presmooth_residual_restrict_var(u, b, om, [1], c, R_TAPS)[1]
    rc_t = trv.presmooth_residual_restrict_var(u, b, om, [1], c,
                                               R_TAPS[::-1])[1]
    assert float((rc - rc_t).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------

HIERARCHY = [(2 ** k - 1,) * 2 for k in range(12, 2, -1)]   # 4095^2 .. 7^2
RAGGED = [(33, 128), (32, 128), (40, 127), (65, 130), (129, 129),
          (129, 128), (259, 131), (127, 255)]


@pytest.mark.parametrize("shape", HIERARCHY + RAGGED)
def test_gates_match_jax(shape):
    """On float32 off the CPU (a ``meta`` tensor stands in for the card)
    the port's sweep gate admits what the JAX gate admits, and the legs'
    gate what the JAX transfer gate admits on odd grids (the port's
    transfer gate also asks for odd columns, which its kernels need);
    float64 off the CPU is refused."""
    spec = jax.ShapeDtypeStruct(shape, jnp.float32)
    t = torch.empty(shape, dtype=torch.float32, device="meta")
    stack = torch.empty((5,) + shape, device="meta")
    assert trv.supports(t, stack) == prv.supports(spec, stack)
    assert not trv.supports(t, None)
    odd = all(n % 2 for n in shape)
    assert ttransfer.supports(t) == (odd and ptransfer.supports(spec))
    t64 = torch.empty(shape, dtype=torch.float64, device="meta")
    assert not (trv.supports(t64, stack) or ttransfer.supports(t64))


def test_gate_levels():
    """The level sets on the 2047^2 hierarchy: the legs take 2047^2 ..
    255^2, the sweeps 2047^2 .. 255^2 as well (127^2 has 127 columns)."""
    def levels(gate):
        return [s[0] for s in HIERARCHY
                if gate(torch.empty(s, device="meta"))]
    assert levels(ttransfer.supports) == [4095, 2047, 1023, 511, 255]
    assert levels(lambda t: trv.supports(t, t)) == [4095, 2047, 1023, 511,
                                                    255]


# ---------------------------------------------------------------------------
# dispatch: which kernels one cycle step reaches
# ---------------------------------------------------------------------------

NAMES = ("fused_rbgs_sweep_var", "jacobi_sweep_var",
         "presmooth_residual_restrict_var", "prolong_correct_postsmooth_var")
#: hand-built cycles: (pre-sweeps, post-sweeps, partitioning, omega)
CYCLES = {"rb_v21": (2, 1, "RedBlack", 1.15),
          "jacobi_v21": (2, 1, "Single", 0.8),
          "rb_v44": (4, 4, "RedBlack", 1.15),
          "jacobi_v44": (4, 4, "Single", 0.8)}
#: what one step at 255^2 (levels 8 -> 5) launches: only 255^2 passes the
#: gates; a V(4,4) leaves one pre- and one post-sweep to the standalone
#: sweep beside legs of 3 sweeps
EXPECTED = {
    "rb_v21": {"presmooth_residual_restrict_var": 1,
               "prolong_correct_postsmooth_var": 1},
    "jacobi_v21": {"presmooth_residual_restrict_var": 1,
                   "prolong_correct_postsmooth_var": 1},
    "rb_v44": {"presmooth_residual_restrict_var": 1,
               "prolong_correct_postsmooth_var": 1,
               "fused_rbgs_sweep_var": 2},
    "jacobi_v44": {"presmooth_residual_restrict_var": 1,
                   "prolong_correct_postsmooth_var": 1,
                   "jacobi_sweep_var": 2},
}


def _cycle(pkg, key):
    pre, post, partitioning, omega = CYCLES[key]
    problem = pkg.problems.poisson_2d_variable(max_level=8, min_level=5)
    problem.dtype = np.float32
    cycle = pkg.cycles.v_cycle(
        problem.level_contexts, problem.rhs_entity, pre_smoothing=pre,
        post_smoothing=post, omega=omega,
        partitioning=getattr(pkg.part, partitioning),
        coarse_operator=problem.coarsest_operator)
    return problem, cycle


def _count(monkeypatch, calls, module, name):
    fn = getattr(module, name)

    def counted(*a, **k):
        calls[name.replace("_plain", "")] += 1
        return fn(*a, **k)
    monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("key", sorted(EXPECTED))
def test_step_dispatch_matches_jax(monkeypatch, key):
    """One step of each hand-built cycle at 255^2 in float32 reaches the
    same variable-coefficient kernels in both packages: the Pallas entry
    points (interpret mode) in the JAX lowering, the plain versions in the
    port; no constant-coefficient kernel runs in the port.  The steps
    agree to 2e-6 of their largest value."""
    jax_calls, port_calls = collections.Counter(), collections.Counter()
    for name in NAMES:
        _count(monkeypatch, jax_calls, prv, name)
        _count(monkeypatch, port_calls, trv, name + "_plain")
    monkeypatch.setattr(config, "use_pallas_kernels", True)
    constant = collections.Counter()
    from evostencils_tpu_torch.ops.kernels import rbgs as trbgs
    for mod, names in ((trbgs, ("fused_rbgs_sweep_plain", "sweep_plain")),
                       (ttransfer, ("presmooth_residual_restrict_plain",
                                    "prolong_correct_postsmooth_col_plain",
                                    "residual_restrict_plain",
                                    "prolong_correct_plain"))):
        for name in names:
            _count(monkeypatch, constant, mod, name)

    pj, cj = _cycle(JAX, key)
    pt, ct = _cycle(PORT, key)
    lj = jlower.lower_cycle(cj, pj.approximation, pj.rhs_entity)
    lt = tlower.lower_cycle(ct, pt.approximation, pt.rhs_entity)
    np.testing.assert_array_equal(lt.default_omegas, lj.default_omegas)
    b = [np.asarray(x) for x in pj.build_rhs()]
    u0 = [_normal(x.shape, 16) for x in b]
    ref = lj.step(tuple(jnp.asarray(x) for x in u0),
                  tuple(jnp.asarray(x) for x in b),
                  jnp.asarray(lj.default_omegas, jnp.float32))
    u, bt, om = state_from_numpy(u0, b, lt.default_omegas, device="cpu",
                                 dtype=torch.float32)
    out = lt.step(u, bt, om)

    assert dict(jax_calls) == EXPECTED[key]
    assert port_calls == jax_calls
    assert not constant
    _close(out[0].numpy(), ref[0])


@pytest.mark.parametrize("case", ["omega_id", "stack_shape", "device",
                                  "mixed_devices", "even", "coarse_shape",
                                  "sweeps"])
def test_arguments_rejected(case):
    u, b = (torch.tensor(_normal((17, 129), s)) for s in (1, 2))
    c = stack_from_numpy(_random_stack((17, 129), 3), device="cpu",
                         dtype=torch.float32)
    e = torch.tensor(_normal((8, 64), 4))
    om = _omegas()
    if case == "omega_id":
        with pytest.raises(IndexError):
            trv.jacobi_sweep_var(u, b, om, len(OMEGAS), c)
        with pytest.raises(IndexError):
            trv.presmooth_residual_restrict_var(u, b, om, [len(OMEGAS)], c,
                                                R_TAPS)
    elif case == "stack_shape":
        with pytest.raises(ValueError):
            trv.fused_rbgs_sweep_var(u, b, om, 0, c[:4])
        with pytest.raises(ValueError):
            trv.prolong_correct_postsmooth_var(u, e, b, om, [0, 1],
                                               c[:, :-2], P_TAPS)
    elif case == "device":
        with pytest.raises(ValueError):
            trv.jacobi_sweep_var(u.to("meta"), b.to("meta"), om.to("meta"),
                                 0, c.to("meta"))
    elif case == "mixed_devices":
        with pytest.raises(ValueError):
            trv.fused_rbgs_sweep_var(u, b, om, 0, c.to("meta"))
    elif case == "even":
        with pytest.raises(ValueError):
            trv.presmooth_residual_restrict_var(u[:-1], b[:-1], om, [0],
                                                c[:, :-1], R_TAPS)
    elif case == "coarse_shape":
        with pytest.raises(ValueError):
            trv.prolong_correct_postsmooth_var(u, e[:-1], b, om, [0, 1], c,
                                               P_TAPS)
    else:
        with pytest.raises(ValueError):
            trv.presmooth_residual_restrict_var(u, b, om, [0, 1, 2, 3], c,
                                                R_TAPS)
