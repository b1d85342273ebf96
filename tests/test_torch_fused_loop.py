"""The fused cycle loop and the row-only legs of the port
(evostencils_tpu_torch: ``ops/kernels/transfer.py``'s ``upleg_downleg_col``,
``presmooth_residual_rowrestrict``, ``prolong_correct_postsmooth`` and
``upleg_downleg_fused``; ``compiler/lower.py``'s ``extract_fine_leg_plan``
and row-only legs; ``compiler/solve.make_cycle_loop`` with
``config.loop_fusion``) against the JAX package on the CPU.

The Pallas kernels run in interpret mode, as tests/test_fused_columns.py
and tests/test_fused_loop.py run them; the port runs the kernels' plain
PyTorch versions.  Tolerances are the JAX tests' own float32 slack:
tests/test_fused_columns.py:52-53 (1e-6 on u, 1e-5 on the restricted
residual), :64 (1e-5) and :81-82 (1e-5, 1e-4); tests/test_fused_loop.py:48-51
(3e-5 of max|u| after K fused cycles).
"""

import collections
import random
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from evostencils_tpu import config as jconfig
from evostencils_tpu.compiler import cycles as jcycles
from evostencils_tpu.compiler import lower as jlower
from evostencils_tpu.compiler import solve as jsolve
from evostencils_tpu.grammar import gp as jgp
from evostencils_tpu.grammar import multigrid as jmg
from evostencils_tpu.ir import partitioning as jpart
from evostencils_tpu.ir import transformations as jtrans
from evostencils_tpu.ops.pallas import rbgs_sys as prs
from evostencils_tpu.ops.pallas import rbgs_var as prv
from evostencils_tpu.ops.pallas import transfer as pt
from evostencils_tpu.problems import elasticity as jelasticity
from evostencils_tpu.problems import poisson as jpoisson
from evostencils_tpu_torch import config as tconfig
from evostencils_tpu_torch.compiler import cycles as tcycles
from evostencils_tpu_torch.compiler import lower as tlower
from evostencils_tpu_torch.compiler import solve as tsolve
from evostencils_tpu_torch.grammar import gp as tgp
from evostencils_tpu_torch.grammar import multigrid as tmg
from evostencils_tpu_torch.ir import partitioning as tpart
from evostencils_tpu_torch.ir import transformations as ttrans
from evostencils_tpu_torch.ops.kernels import rbgs_sys as trs
from evostencils_tpu_torch.ops.kernels import rbgs_var as trv
from evostencils_tpu_torch.ops.kernels import transfer as tt
from evostencils_tpu_torch.problems import elasticity as telasticity
from evostencils_tpu_torch.problems import poisson as tpoisson
from evostencils_tpu_torch.problems.poisson import build_rhs

JAX = SimpleNamespace(poisson=jpoisson, elasticity=jelasticity,
                      cycles=jcycles, part=jpart, lower=jlower)
PORT = SimpleNamespace(poisson=tpoisson, elasticity=telasticity,
                       cycles=tcycles, part=tpart, lower=tlower)

#: an anisotropic stencil and asymmetric taps, so that a swapped axis or
#: a mirrored tap shows; a different relaxation factor for every sweep
VALS = (5.0, -1.5, -0.5, -1.25, -0.75)
R_TAPS = ((0.2, 0.5, 0.3), (0.1, 0.6, 0.3))
P_TAPS = ((0.4, 1.0, 0.6), (0.3, 0.9, 0.5))
OMEGAS = (0.9, 1.15, 0.8, 1.3, 0.7, 1.05, 0.95)
#: the shapes of tests/test_fused_columns.py:22, each with a sweep count
#: of the single legs and a (post, pre) pair of the fused passes
LEG_CASES = [((131, 131), 1), ((259, 515), 2), ((131, 259), 3)]
PASS_CASES = [((131, 131), (1, 1)), ((259, 515), (1, 3)),
              ((131, 259), (3, 2))]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the eager ops on these grids run as fast on
    one, and the test run's parallel workers would otherwise oversubscribe
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _switches():
    """Restore both packages' switches after each test."""
    jc, tc = jconfig.config, tconfig.config
    saved = (jc.use_pallas_kernels, jc.loop_fusion,
             jc.fused_column_transfers, tc.loop_fusion,
             tc.fused_column_transfers)
    yield
    (jc.use_pallas_kernels, jc.loop_fusion, jc.fused_column_transfers,
     tc.loop_fusion, tc.fused_column_transfers) = saved


def _data(n, m, seed):
    rng = np.random.default_rng(seed)
    normal = (lambda *s: rng.standard_normal(s).astype(np.float32))
    return (normal(n, m), normal(n, m), normal((n - 1) // 2, (m - 1) // 2),
            normal((n - 1) // 2, m))


def _omegas():
    return torch.tensor(OMEGAS, dtype=torch.float32)


# ---------------------------------------------------------------------------
# (a) the plain versions against the Pallas entries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,sweeps", LEG_CASES)
def test_presmooth_residual_rowrestrict_plain(shape, sweeps):
    u, b, _, _ = _data(*shape, seed=0)
    ids = [1, 2, 3][:sweeps]
    us0, rr0 = pt.presmooth_residual_rowrestrict(
        jnp.asarray(u), jnp.asarray(b), [OMEGAS[i] for i in ids], VALS,
        R_TAPS[0], interpret=True)
    tt.reset_launches()
    us1, rr1 = tt.presmooth_residual_rowrestrict(
        torch.tensor(u), torch.tensor(b), _omegas(), ids, VALS, R_TAPS[0])
    assert not any(tt.launches.values())
    assert tuple(rr1.shape) == ((shape[0] - 1) // 2, shape[1])
    np.testing.assert_allclose(us1.numpy(), np.asarray(us0), atol=1e-6)
    np.testing.assert_allclose(rr1.numpy(), np.asarray(rr0), atol=1e-5)


@pytest.mark.parametrize("shape,sweeps", LEG_CASES)
def test_prolong_correct_postsmooth_plain(shape, sweeps):
    u, b, _, c_half = _data(*shape, seed=1)
    ids = [0, 1, 2, 3][:sweeps + 1]
    o0 = pt.prolong_correct_postsmooth(
        jnp.asarray(u), jnp.asarray(c_half), jnp.asarray(b),
        [OMEGAS[i] for i in ids], VALS, P_TAPS[0], interpret=True)
    tt.reset_launches()
    o1 = tt.prolong_correct_postsmooth(
        torch.tensor(u), torch.tensor(c_half), torch.tensor(b), _omegas(),
        ids, VALS, P_TAPS[0])
    assert not any(tt.launches.values())
    np.testing.assert_allclose(o1.numpy(), np.asarray(o0), atol=1e-5)


def _pass_ids(post, pre):
    """The fused pass's factor ids: the correction's, then the post- and
    the pre-sweeps', each different."""
    return list(range(1 + post + pre))


@pytest.mark.parametrize("shape,pair", PASS_CASES)
def test_upleg_downleg_col_plain(shape, pair):
    u, b, e, _ = _data(*shape, seed=2)
    ids = _pass_ids(*pair)
    v0, rc0 = pt.upleg_downleg_col(
        jnp.asarray(u), jnp.asarray(e), jnp.asarray(b),
        [OMEGAS[i] for i in ids], VALS, P_TAPS, R_TAPS, interpret=True)
    tt.reset_launches()
    v1, rc1 = tt.upleg_downleg_col(
        torch.tensor(u), torch.tensor(e), torch.tensor(b), _omegas(), ids,
        VALS, P_TAPS, R_TAPS)
    assert not any(tt.launches.values())
    np.testing.assert_allclose(v1.numpy(), np.asarray(v0), atol=1e-5)
    np.testing.assert_allclose(rc1.numpy(), np.asarray(rc0), atol=1e-4)


@pytest.mark.parametrize("shape,pair", PASS_CASES)
def test_upleg_downleg_fused_plain(shape, pair):
    u, b, _, c_half = _data(*shape, seed=3)
    ids = _pass_ids(*pair)
    v0, rr0 = pt.upleg_downleg_fused(
        jnp.asarray(u), jnp.asarray(c_half), jnp.asarray(b),
        [OMEGAS[i] for i in ids], VALS, P_TAPS[0], R_TAPS[0],
        interpret=True)
    tt.reset_launches()
    v1, rr1 = tt.upleg_downleg_fused(
        torch.tensor(u), torch.tensor(c_half), torch.tensor(b), _omegas(),
        ids, VALS, P_TAPS[0], R_TAPS[0])
    assert not any(tt.launches.values())
    np.testing.assert_allclose(v1.numpy(), np.asarray(v0), atol=1e-5)
    np.testing.assert_allclose(rr1.numpy(), np.asarray(rr0), atol=1e-4)


@pytest.mark.parametrize("case", ["sweeps", "coarse_shape", "device"])
def test_arguments_rejected(case):
    u, b, e, c_half = (torch.tensor(x) for x in _data(131, 131, seed=4))
    om = _omegas()
    if case == "sweeps":
        with pytest.raises(ValueError):       # 7 sweeps in one pass
            tt.upleg_downleg_col(u, e, b, om, [0] * 8, VALS, P_TAPS, R_TAPS)
        with pytest.raises(ValueError):       # 4 sweeps in one leg
            tt.presmooth_residual_rowrestrict(u, b, om, [0] * 4, VALS,
                                              R_TAPS[0])
    elif case == "coarse_shape":
        with pytest.raises(ValueError):       # e where c_half belongs
            tt.upleg_downleg_fused(u, e, b, om, [0, 1], VALS, P_TAPS[0],
                                   R_TAPS[0])
        with pytest.raises(ValueError):       # c_half where e belongs
            tt.upleg_downleg_col(u, c_half, b, om, [0, 1], VALS, P_TAPS,
                                 R_TAPS)
    else:
        with pytest.raises(ValueError):
            tt.prolong_correct_postsmooth(u.to("meta"), c_half.to("meta"),
                                          b.to("meta"), om.to("meta"),
                                          [0, 1], VALS, P_TAPS[0])


# ---------------------------------------------------------------------------
# (b) the fine-leg plan
# ---------------------------------------------------------------------------

def _hand(pkg, key):
    """A hand-built cycle of one package and its problem."""
    family, pre, post, partitioning, omega = HAND[key]
    if family == "elasticity":
        problem = pkg.elasticity.linear_elasticity_2d(max_level=6,
                                                      min_level=3)
    elif family == "3d":
        problem = pkg.poisson.poisson_3d(max_level=5, min_level=2)
    elif family == "var":
        problem = pkg.poisson.poisson_2d_variable(max_level=6, min_level=3)
    else:
        problem = pkg.poisson.poisson_2d(max_level=6, min_level=3)
    cycle = pkg.cycles.v_cycle(
        problem.level_contexts, problem.rhs_entity, pre_smoothing=pre,
        post_smoothing=post, omega=omega,
        partitioning=getattr(pkg.part, partitioning),
        coarse_operator=problem.coarsest_operator)
    return problem, cycle


#: (family, pre-sweeps, post-sweeps, partitioning, omega)
HAND = {"rb_v21": ("2d", 2, 1, "RedBlack", 1.15),
        "rb_v11": ("2d", 1, 1, "RedBlack", 1.15),
        "rb_v33": ("2d", 3, 3, "RedBlack", 1.15),
        "jacobi_v21": ("2d", 2, 1, "Single", 0.8),
        "3d_v21": ("3d", 2, 1, "RedBlack", 1.15),
        "var_v21": ("var", 2, 1, "RedBlack", 1.15),
        "elasticity_v21": ("elasticity", 2, 1, "RedBlack", 1.25)}
#: the hand-built cycles with a fine-leg plan in the JAX package
PLANNED = {"rb_v21", "rb_v11", "rb_v33"}


def _plan_fields(plan):
    if plan is None:
        return None
    return (tuple(plan.vals), plan.p_taps, plan.r_taps,
            list(plan.om_pre_ids), list(plan.om_post_ids), plan.om_cgc_id)


def _assert_same_plan(expr_j, expr_t):
    jtrans.assign_cycle_ids(expr_j)
    ttrans.assign_cycle_ids(expr_t)
    fj = _plan_fields(jlower.extract_fine_leg_plan(expr_j))
    ft = _plan_fields(tlower.extract_fine_leg_plan(expr_t))
    assert ft == fj
    return fj


@pytest.mark.parametrize("key", sorted(HAND))
def test_fine_leg_plan_hand_built(key):
    """The hand-built cycles: a plan in both packages exactly for the
    red-black 2D Poisson V-cycles, with the same stencil, taps and factor
    ids; the pre-sweeps' ids run innermost first."""
    _, cj = _hand(JAX, key)
    _, ct = _hand(PORT, key)
    fields = _assert_same_plan(cj, ct)
    assert (fields is not None) == (key in PLANNED)
    if fields is not None:
        _, pre, post, _, _ = HAND[key]
        assert (len(fields[3]), len(fields[4])) == (pre, post)


@pytest.mark.parametrize("seed", range(40))
def test_fine_leg_plan_seeded(seed):
    """Seeds 0-39 of genGrow(pset, 2, 40) on poisson_2d(8, 4): the same
    individual in both packages, and the same plan or none."""
    pj = jpoisson.poisson_2d(max_level=8, min_level=4)
    pt_ = tpoisson.poisson_2d(max_level=8, min_level=4)
    psj = jmg.generate_primitive_set(pj.approximation, pj.rhs_entity,
                                     pj.level_contexts,
                                     pj.coarsest_operator)[0]
    pst = tmg.generate_primitive_set(pt_.approximation, pt_.rhs_entity,
                                     pt_.level_contexts,
                                     pt_.coarsest_operator)[0]
    ij = jgp.genGrow(psj, 2, 40, rng=random.Random(seed))
    it = tgp.genGrow(pst, 2, 40, rng=random.Random(seed))
    assert str(it) == str(ij)
    _assert_same_plan(jgp.compile_tree(ij, psj)[0],
                      tgp.compile_tree(it, pst)[0])


# ---------------------------------------------------------------------------
# (c), (d) the fused cycle loop
# ---------------------------------------------------------------------------

def _poisson(pkg, dtype, max_level=8, min_level=5):
    problem = pkg.poisson.poisson_2d(max_level=max_level,
                                     min_level=min_level)
    problem.dtype = dtype
    cycle = pkg.cycles.v_cycle(
        problem.level_contexts, problem.rhs_entity, pre_smoothing=2,
        post_smoothing=1, omega=1.15, partitioning=pkg.part.RedBlack,
        coarse_operator=problem.coarsest_operator)
    return problem, pkg.lower.lower_cycle(cycle, problem.approximation,
                                          problem.rhs_entity)


@pytest.mark.parametrize("fused_cols", [True, False])
@pytest.mark.parametrize("K", [1, 2, 3])
def test_fused_loop_matches_jax(K, fused_cols):
    """K fused cycles at poisson_2d(8, 5) (255^2, float32): the port's
    loop (plain versions) against the JAX package's (Pallas kernels in
    interpret mode), both with loop fusion on, within 3e-5 of max|u|."""
    pj, lj = _poisson(JAX, np.float32)
    _, lt = _poisson(PORT, np.float32)
    b = [np.asarray(x) for x in pj.build_rhs()]
    jc = jconfig.config
    jc.use_pallas_kernels, jc.loop_fusion = True, True
    jc.fused_column_transfers = fused_cols
    ref = jsolve.make_cycle_loop(lj, K)(
        tuple(jnp.zeros_like(x) for x in b), tuple(map(jnp.asarray, b)),
        jnp.asarray(lj.default_omegas, jnp.float32))
    ref = np.asarray(ref[0])
    tconfig.config.loop_fusion = True
    tconfig.config.fused_column_transfers = fused_cols
    bt = tuple(torch.tensor(x) for x in b)
    out = tsolve.make_cycle_loop(lt, K)(
        tuple(torch.zeros_like(x) for x in bt), bt,
        torch.tensor(lt.default_omegas, dtype=torch.float32))
    scale = float(np.abs(ref).max())
    assert scale > 0
    np.testing.assert_allclose(out[0].numpy(), ref, rtol=0,
                               atol=3e-5 * scale)


def _count(monkeypatch, calls, module, names):
    for name in names:
        def counted(*a, _fn=getattr(module, name), _name=name, **k):
            calls[_name.replace("_plain", "")] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(module, name, counted)


LEG_PLAIN = ("presmooth_residual_restrict_plain",
             "prolong_correct_postsmooth_col_plain",
             "upleg_downleg_col_plain",
             "presmooth_residual_rowrestrict_plain",
             "prolong_correct_postsmooth_plain",
             "upleg_downleg_fused_plain")


@pytest.mark.parametrize("fused_cols", [True, False])
def test_fused_loop_matches_step_iteration(monkeypatch, fused_cols):
    """The port's fused loop against its own step iteration in float64 at
    255^2 (the only level the gate admits), K = 1..4, within 1e-10
    relative: one down-leg, K - 1 fused passes and one up-leg."""
    problem, lowered = _poisson(PORT, np.float64)
    b = build_rhs(problem, dtype=torch.float64, device="cpu")
    om = torch.tensor(lowered.default_omegas)
    u0 = tuple(torch.zeros_like(x) for x in b)
    calls = collections.Counter()
    _count(monkeypatch, calls, tt, LEG_PLAIN)
    tconfig.config.fused_column_transfers = fused_cols
    names = (("presmooth_residual_restrict", "upleg_downleg_col",
              "prolong_correct_postsmooth_col") if fused_cols else
             ("presmooth_residual_rowrestrict", "upleg_downleg_fused",
              "prolong_correct_postsmooth"))
    for K in range(1, 5):
        ref = u0
        for _ in range(K):
            ref = lowered.step(ref, b, om)
        calls.clear()
        tconfig.config.loop_fusion = True
        out = tsolve.make_cycle_loop(lowered, K)(u0, b, om)
        tconfig.config.loop_fusion = False
        # each plain fused pass composes the plain up-leg and down-leg
        want = {names[0]: K, names[2]: K}
        if K > 1:
            want[names[1]] = K - 1
        assert dict(calls) == want
        scale = float(ref[0].abs().max())
        assert float((out[0] - ref[0]).abs().max()) <= 1e-10 * scale


@pytest.mark.parametrize("family", ["3d", "var"])
def test_fused_loop_falls_back(monkeypatch, family):
    """A 3D and a variable-coefficient V(2,1) have no fine-leg plan: with
    loop fusion on, the loop is exactly the step iteration."""
    problem, cycle = _hand(PORT, f"{family}_v21")
    problem.dtype = np.float64
    lowered = tlower.lower_cycle(cycle, problem.approximation,
                                 problem.rhs_entity)
    assert tlower.extract_fine_leg_plan(lowered.expression) is None
    b = build_rhs(problem, dtype=torch.float64, device="cpu")
    om = torch.tensor(lowered.default_omegas)
    u0 = tuple(torch.zeros_like(x) for x in b)
    ref = u0
    for _ in range(2):
        ref = lowered.step(ref, b, om)
    tconfig.config.loop_fusion = True
    out = tsolve.make_cycle_loop(lowered, 2)(u0, b, om)
    assert torch.equal(out[0], ref[0])


# ---------------------------------------------------------------------------
# (e) lowered.step without fused column transfers
# ---------------------------------------------------------------------------

#: per family: the problem's module and constructor, its levels and the
#: omega of its red-black V(2,1)
STEP_CASES = {
    "poisson": ("poisson", "poisson_2d", 8, 5, 1.15),
    "var": ("poisson", "poisson_2d_variable", 8, 5, 1.15),
    "elasticity": ("elasticity", "linear_elasticity_2d", 8, 4, 1.25)}
#: the leg entries of each package whose calls are counted
JAX_LEGS = ((pt, ("presmooth_residual_restrict",
                  "prolong_correct_postsmooth_col",
                  "presmooth_residual_rowrestrict",
                  "prolong_correct_postsmooth")),
            (prv, ("presmooth_residual_restrict_var",
                   "prolong_correct_postsmooth_var")),
            (prs, ("presmooth_residual_restrict_sys",
                   "prolong_correct_postsmooth_sys")))
PORT_LEGS = ((tt, LEG_PLAIN[:2] + LEG_PLAIN[3:5]),
             (trv, ("presmooth_residual_restrict_var_plain",
                    "prolong_correct_postsmooth_var_plain")),
             (trs, ("presmooth_residual_restrict_sys_plain",
                    "prolong_correct_postsmooth_sys_plain")))
#: what one step reaches at the first level of each family (the only one
#: the gates admit) without fused column transfers
ROW_ONLY_CALLS = {"poisson": {"presmooth_residual_rowrestrict": 1,
                              "prolong_correct_postsmooth": 1},
                  "var": {}, "elasticity": {}}


def _step_problem(pkg, key):
    module, make, max_level, min_level, omega = STEP_CASES[key]
    problem = getattr(getattr(pkg, module), make)(max_level=max_level,
                                                  min_level=min_level)
    problem.dtype = np.float32
    cycle = pkg.cycles.v_cycle(
        problem.level_contexts, problem.rhs_entity, pre_smoothing=2,
        post_smoothing=1, omega=omega, partitioning=pkg.part.RedBlack,
        coarse_operator=problem.coarsest_operator)
    return problem, pkg.lower.lower_cycle(cycle, problem.approximation,
                                          problem.rhs_entity)


@pytest.mark.parametrize("key", sorted(STEP_CASES))
def test_row_only_step_matches_jax(monkeypatch, key):
    """One float32 step at the family's 255^2 hierarchy with
    ``fused_column_transfers = False`` in both packages: the Poisson legs
    take the row-only entries, the variable-coefficient and system legs
    are refused (their level runs the generic lowering), the same in both
    packages; the steps agree to 1e-5 of the random start's largest value
    (the slack of tests/test_fused_columns.py:119 for a start of size 1:
    float32 rounds quantities of the start's size, and the elasticity
    step shrinks it tenfold).  The port reaches the refused legs with the
    default switch, so the refusal is the switch's doing."""
    jcalls, tcalls = collections.Counter(), collections.Counter()
    for module, names in JAX_LEGS:
        _count(monkeypatch, jcalls, module, names)
    for module, names in PORT_LEGS:
        _count(monkeypatch, tcalls, module, names)
    pj, lj = _step_problem(JAX, key)
    _, lt = _step_problem(PORT, key)
    b = [np.asarray(x) for x in pj.build_rhs()]
    rng = np.random.default_rng(5)
    u0 = [rng.standard_normal(x.shape).astype(np.float32) for x in b]
    bt = tuple(torch.tensor(x) for x in b)
    ut = tuple(torch.tensor(x) for x in u0)
    om = torch.tensor(lt.default_omegas, dtype=torch.float32)

    lt.step(ut, bt, om)
    assert sum(tcalls.values()) == 2     # the default: fused legs
    tcalls.clear()

    jconfig.config.use_pallas_kernels = True
    jconfig.config.fused_column_transfers = False
    ref = lj.step(tuple(map(jnp.asarray, u0)), tuple(map(jnp.asarray, b)),
                  jnp.asarray(lj.default_omegas, jnp.float32))
    tconfig.config.fused_column_transfers = False
    out = lt.step(ut, bt, om)
    assert dict(jcalls) == ROW_ONLY_CALLS[key]
    assert tcalls == jcalls
    scale = max(float(np.abs(x).max()) for x in u0)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-5 * scale)


# ---------------------------------------------------------------------------
# (f) the switches
# ---------------------------------------------------------------------------

def test_config_defaults_match_jax():
    """The port's two switches, their defaults and the default of
    fused_cols_enabled() are the JAX package's."""
    fresh_j, fresh_t = jconfig.Config(), tconfig.Config()
    for name in ("loop_fusion", "fused_column_transfers"):
        assert getattr(fresh_t, name) == getattr(fresh_j, name)
        assert getattr(tconfig.config, name) == getattr(fresh_t, name)
    assert tconfig.fused_cols_enabled() is jconfig.fused_cols_enabled()
    tconfig.config.fused_column_transfers = False
    assert tconfig.fused_cols_enabled() is False
