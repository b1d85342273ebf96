"""The port's FAS path against the JAX package on the CPU: the nonlinear
callables of ``FASOperatorGenerator``, the ``fas_2d_basic`` problem, one
step of ``fas_v_cycle`` (Newton and Picard smoothing, Jacobi and
red-black), the coarsest level's Newton-Jacobi sweeps from the restricted
solution, a solve's iterations, "JAX lowers => the port lowers" on the
stored ``fas2d_1023sq_newton_gen25`` champions and on seeded FAS grammar
individuals, and the ``fas2d`` CLI.

Everything runs in float64.  ``jax_fas_iterations`` gives the JAX
package's own iteration count of a float32 or float64 solve, which
``chip_smoke.py`` holds the port's on the card to:

    JAX_PLATFORMS=cpu python -c 'from tests.test_torch_fas import
    jax_fas_iterations as f; print(f(10, 6, "float32", 1e-2),
    f(10, 6, "float64", 1e-5))'
"""

import json
import pathlib
import random
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from evostencils_tpu.compiler import cycles as jcycles
from evostencils_tpu.compiler import lower as jlower
from evostencils_tpu.compiler import solve as jsolve
from evostencils_tpu.grammar import gp as jgp
from evostencils_tpu.grammar import multigrid as jmg
from evostencils_tpu.ir import base as jbase
from evostencils_tpu.ir import partitioning as jpart
from evostencils_tpu.ir import smoother as jsmoother
from evostencils_tpu.ir import system as jsystem
from evostencils_tpu.ir import transformations as jtrans
from evostencils_tpu.problems import fas as jfas
from evostencils_tpu_torch import optimize as toptimize
from evostencils_tpu_torch.compiler import cycles as tcycles
from evostencils_tpu_torch.compiler import lower as tlower
from evostencils_tpu_torch.compiler import solve as tsolve
from evostencils_tpu_torch.evaluation import evaluator as tev
from evostencils_tpu_torch.grammar import gp as tgp
from evostencils_tpu_torch.grammar import multigrid as tmg
from evostencils_tpu_torch.ir import base as tbase
from evostencils_tpu_torch.ir import partitioning as tpart
from evostencils_tpu_torch.ir import smoother as tsmoother
from evostencils_tpu_torch.ir import system as tsystem
from evostencils_tpu_torch.ir import transformations as ttrans
from evostencils_tpu_torch.problems import fas as tfas
from evostencils_tpu_torch.problems.poisson import build_rhs

from tests.test_torch_slice3d import _describe

JAX = SimpleNamespace(problems=jfas, cycles=jcycles, part=jpart,
                      smoother=jsmoother, base=jbase, system=jsystem,
                      trans=jtrans, lower=jlower)
PORT = SimpleNamespace(problems=tfas, cycles=tcycles, part=tpart,
                       smoother=tsmoother, base=tbase, system=tsystem,
                       trans=ttrans, lower=tlower)

#: the two hierarchies of the parity tests: 63^2 (levels 6 -> 3) and
#: 255^2 (8 -> 4)
LEVELS = {63: (6, 3), 255: (8, 4)}
#: the stored champions' own hierarchy (1023^2): their grammar strings
#: name level-bound terminals (P_10, R_7, ...), so they parse there only
CHAMPION_LEVELS = (10, 6)
#: one lowered step, port against JAX, relative to max|JAX|
STEP_RTOL = 1e-12
PROBE_SEEDS = range(40)
CHAMPIONS = pathlib.Path(__file__).resolve().parents[1] / "results" / \
    "evolved_champions.json"
CHAMPION_KEY = "fas2d_1023sq_newton_gen25"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test run's parallel workers would
    otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cycle(pkg, problem, mode="newton", partitioning="Single"):
    """fas_v_cycle with the Newton (one step) or Picard Jacobi smoother."""
    if mode == "newton":
        def factory(op):
            return pkg.smoother.generate_jacobi_newton(op, 1)
    else:
        factory = pkg.smoother.generate_jacobi_picard
    return pkg.cycles.fas_v_cycle(
        problem.level_contexts, problem.rhs_entity,
        coarse_operator=problem.coarsest_operator,
        partitioning=getattr(pkg.part, partitioning),
        smoother_factory=factory)


def _pset(mg, problem):
    """The FAS primitive set the optimizer builds (program.py:518-524)."""
    return mg.generate_primitive_set(
        problem.approximation, problem.rhs_entity, problem.level_contexts,
        problem.coarsest_operator, FAS=True)[0]


def jax_fas_iterations(max_level, min_level, dtype, target,
                       max_iterations=100):
    """The JAX package's iterations of fas_v_cycle on
    fas_2d_basic(max_level, min_level) from zero to ``target`` times the
    initial nonlinear residual, in ``dtype`` ("float32" or "float64"), by
    its own make_solver on the CPU."""
    with jax.enable_x64(dtype == "float64"):
        problem = jfas.fas_2d_basic(max_level, min_level)
        problem.dtype = np.dtype(dtype).type
        cycle = jcycles.fas_v_cycle(problem.level_contexts,
                                    problem.rhs_entity,
                                    coarse_operator=problem.coarsest_operator)
        lowered = jlower.lower_cycle(cycle, problem.approximation,
                                     problem.rhs_entity)
        b = problem.build_rhs()
        _, k, _ = jsolve.make_solver(lowered, max_iterations, target)(
            tuple(jnp.zeros_like(x) for x in b), b,
            jnp.asarray(lowered.default_omegas, b[0].dtype))
        return int(k)


# ---------------------------------------------------------------------------
# (a) the problem and its nonlinear callables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", list(LEVELS))
def test_nonlinear_callables_match_jax(n):
    """nonlinear_term, _coefficient and _derivative on a random field of
    u's range and beyond, float64, within 1e-14 relative."""
    u = np.random.default_rng(n).uniform(-2.0, 2.0, (n, n))
    gj, gt = jfas.FASOperatorGenerator(), tfas.FASOperatorGenerator()
    for name in ("nonlinear_term", "nonlinear_coefficient",
                 "nonlinear_derivative"):
        got = getattr(gt, name)(torch.from_numpy(u))
        want = np.asarray(getattr(gj, name)(jnp.asarray(u)))
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=0)


@pytest.mark.parametrize("n", list(LEVELS))
def test_problem_matches_jax(n):
    """The same settings, the same fas_v_cycle IR node for node, the
    right-hand side and the exact solution bit for bit, the same linear
    stencil on every level."""
    pj, pt = jfas.fas_2d_basic(*LEVELS[n]), tfas.fas_2d_basic(*LEVELS[n])
    assert (pt.name, pt.fields, pt.max_level, pt.min_level,
            pt.target_reduction, pt.max_iterations) == \
        (pj.name, pj.fields, pj.max_level, pj.min_level,
         pj.target_reduction, pj.max_iterations)
    assert pt.nonlinear_term is not None and \
        pt.nonlinear_derivative is not None
    for mode in ("newton", "picard"):
        dj, dt = _describe(JAX, _cycle(JAX, pj, mode)), \
            _describe(PORT, _cycle(PORT, pt, mode))
        assert dt == dj and len(dt) > 40
    b = build_rhs(pt, dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(b[0].numpy(),
                                  np.asarray(pj.rhs_builder(jnp.float64)[0]))
    np.testing.assert_array_equal(pt.exact_solution()[0],
                                  pj.exact_solution()[0])
    for cj, ct in zip(pj.level_contexts, pt.level_contexts):
        ej, et = cj.operator.entries[0][0], ct.operator.entries[0][0]
        assert et.generate_stencil().entries == \
            ej.generate_stencil().entries


# ---------------------------------------------------------------------------
# (b) one step, the coarse solve and a solve
# ---------------------------------------------------------------------------

_SETUP = {}


def _setup(n):
    """Both packages' problem of LEVELS[n] (or of the levels ``n``) and
    its right-hand side, once."""
    levels = LEVELS.get(n, n)
    if levels not in _SETUP:
        pj, pt = jfas.fas_2d_basic(*levels), tfas.fas_2d_basic(*levels)
        _SETUP[levels] = SimpleNamespace(
            pj=pj, pt=pt, bj=pj.rhs_builder(jnp.float64),
            bt=build_rhs(pt, dtype=torch.float64, device="cpu"))
    return _SETUP[levels]


def _steps(s, mode, partitioning, u0=None):
    """One step in each package from ``u0`` (zero by default)."""
    lj = jlower.lower_cycle(_cycle(JAX, s.pj, mode, partitioning),
                            s.pj.approximation, s.pj.rhs_entity)
    lt = tlower.lower_cycle(_cycle(PORT, s.pt, mode, partitioning),
                            s.pt.approximation, s.pt.rhs_entity)
    u0 = np.zeros(s.bt[0].shape) if u0 is None else u0
    uj = lj.step((jnp.asarray(u0),), s.bj, jnp.asarray(lj.default_omegas))
    ut = lt.step((torch.from_numpy(u0),), s.bt,
                 torch.tensor(lt.default_omegas))
    return np.asarray(uj[0]), ut[0]


@pytest.mark.parametrize("n", list(LEVELS))
@pytest.mark.parametrize("partitioning", ["Single", "RedBlack"])
@pytest.mark.parametrize("mode", ["newton", "picard"])
def test_step_matches_jax(n, mode, partitioning):
    """One fas_v_cycle step from a smooth nonzero start in float64 within
    STEP_RTOL of max|JAX|."""
    s = _setup(n)
    u0 = 0.5 * s.pt.exact_solution()[0]
    want, got = _steps(s, mode, partitioning, u0)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=STEP_RTOL * np.abs(want).max())


def _coarse_solvers(pkg, root):
    return [c for c in pkg.trans.find_nodes(root, pkg.base.CoarseGridSolver)]


def test_coarse_solve_starts_from_restricted_solution():
    """The coarsest level's 200 Newton-Jacobi sweeps start from the node's
    initial guess, the restricted solution (BASELINE.md:972-977): on
    fas_2d_basic(6, 5), whose 31^2 coarsest level 200 damped sweeps leave
    far from converged, the port's step matches the JAX package's to
    STEP_RTOL with the guess, and again with the guess dropped from both
    IR trees, while the two steps differ by far more than that."""
    pj, pt = jfas.fas_2d_basic(6, 5), tfas.fas_2d_basic(6, 5)
    s = SimpleNamespace(pj=pj, pt=pt, bj=pj.rhs_builder(jnp.float64),
                        bt=build_rhs(pt, dtype=torch.float64, device="cpu"))
    cycles = {}
    for pkg, problem in ((JAX, s.pj), (PORT, s.pt)):
        root = _cycle(pkg, problem)
        (cgs,) = _coarse_solvers(pkg, root)
        assert cgs.initial_guess is not None
        cycles[pkg is JAX] = (root, cgs)
    u0 = 0.5 * s.pt.exact_solution()[0]
    out = {}
    for seeded in (True, False):
        for is_jax, (root, cgs) in cycles.items():
            if not seeded:
                cgs.initial_guess = None
            problem = s.pj if is_jax else s.pt
            pkg = JAX if is_jax else PORT
            low = pkg.lower.lower_cycle(root, problem.approximation,
                                        problem.rhs_entity)
            if is_jax:
                u = low.step((jnp.asarray(u0),), s.bj,
                             jnp.asarray(low.default_omegas))[0]
            else:
                u = low.step((torch.from_numpy(u0),), s.bt,
                             torch.tensor(low.default_omegas))[0].numpy()
            out[(seeded, is_jax)] = np.asarray(u)
    scale = np.abs(out[(True, True)]).max()
    for seeded in (True, False):
        np.testing.assert_allclose(out[(seeded, False)], out[(seeded, True)],
                                   rtol=0, atol=STEP_RTOL * scale)
    assert np.abs(out[(True, False)] - out[(False, False)]).max() > \
        1e-4 * scale


def test_solve_iterations_match_jax():
    """make_solver to 1e-8 at 63^2 in float64: the same iterations as the
    JAX package's, histories within 1e-9 relative above 1e-14 ||r0|| (the
    last entries carry the roundoff of b - A(u), a few 1e-16 ||r0||, which
    the two packages sum in different orders)."""
    s = _setup(63)
    lj = jlower.lower_cycle(_cycle(JAX, s.pj), s.pj.approximation,
                            s.pj.rhs_entity)
    lt = tlower.lower_cycle(_cycle(PORT, s.pt), s.pt.approximation,
                            s.pt.rhs_entity)
    _, kj, hj = jsolve.make_solver(lj, 40, 1e-8)(
        (jnp.zeros_like(s.bj[0]),), s.bj, jnp.asarray(lj.default_omegas))
    ut, kt, ht = tsolve.make_solver(lt, 40, 1e-8)(
        (torch.zeros_like(s.bt[0]),), s.bt, torch.tensor(lt.default_omegas))
    kj = int(kj)
    assert kt == kj and 5 < kt < 40
    hj = np.asarray(hj)[:kj + 1]
    np.testing.assert_allclose(ht[:kt + 1].numpy(), hj, rtol=1e-9,
                               atol=1e-14 * hj[0])
    err = np.abs(ut[0].numpy() - s.pt.exact_solution()[0]).max()
    assert err < 5e-3


def test_kernels_reached_match_jax():
    """At fas_2d_basic(9, 6) in float32 both packages reach their
    prolongation-correction entry once per cycle on 511^2 and 255^2 (the
    FAS correction ``u + P (u_c - R u)``) and no other kernel entry; the
    JAX step is traced with jax.eval_shape."""
    import collections
    from evostencils_tpu import config as jconfig
    from evostencils_tpu.ops.pallas import (rbgs as jrbgs,
                                            transfer as jtransfer)
    from evostencils_tpu_torch.ops.kernels import (rbgs as trbgs,
                                                   transfer as ttransfer)
    entries = {ttransfer: ("presmooth_residual_restrict",
                           "prolong_correct_postsmooth_col",
                           "residual_restrict", "prolong_correct"),
               trbgs: ("fused_rbgs_sweep", "jacobi_sweep"),
               jtransfer: ("presmooth_residual_restrict",
                           "prolong_correct_postsmooth_col",
                           "residual_rowrestrict", "prolong_row_correct"),
               jrbgs: ("fused_rbgs_sweep", "jacobi_sweep")}
    pj, pt = jfas.fas_2d_basic(9, 6), tfas.fas_2d_basic(9, 6)
    counts = {True: collections.Counter(), False: collections.Counter()}
    with pytest.MonkeyPatch.context() as mp:
        for mod, names in entries.items():
            cnt = counts[mod in (jtransfer, jrbgs)]
            for name in names:
                def counted(*a, _f=getattr(mod, name), _n=name, _c=cnt,
                            **kw):
                    _c[(_n, a[0].shape[0])] += 1
                    return _f(*a, **kw)
                mp.setattr(mod, name, counted)
        mp.setattr(jconfig.config, "use_pallas_kernels", True)
        lt = tlower.lower_cycle(_cycle(PORT, pt), pt.approximation,
                                pt.rhs_entity)
        b = build_rhs(pt, dtype=torch.float32, device="cpu")
        lt.step((torch.zeros_like(b[0]),), b,
                torch.tensor(lt.default_omegas, dtype=torch.float32))
        lj = jlower.lower_cycle(_cycle(JAX, pj), pj.approximation,
                                pj.rhs_entity)
        spec = (jax.ShapeDtypeStruct((511, 511), jnp.float32),)
        jax.eval_shape(lj.step, spec, spec, jax.ShapeDtypeStruct(
            lj.default_omegas.shape, jnp.float32))
    assert dict(counts[False]) == {("prolong_correct", 511): 1,
                                   ("prolong_correct", 255): 1}
    assert dict(counts[True]) == {("prolong_row_correct", 511): 1,
                                  ("prolong_row_correct", 255): 1}


# ---------------------------------------------------------------------------
# (c) JAX lowers => the port lowers
# ---------------------------------------------------------------------------

_PROBE = {}


def _probe_setup(n):
    if n not in _PROBE:
        s = _setup(n)
        _PROBE[n] = SimpleNamespace(s=s, psj=_pset(jmg, s.pj),
                                    pst=_pset(tmg, s.pt))
    return _PROBE[n]


def _champions():
    return [e["grammar"] for e in
            json.loads(CHAMPIONS.read_text())[CHAMPION_KEY]]


@pytest.mark.parametrize("case", [f"seed{s}" for s in PROBE_SEEDS]
                         + [f"champion{i}" for i in range(6)])
def test_jax_lowers_implies_port_lowers(case):
    """genGrow(pset, 2, 40) seeds 0-39 of the FAS grammar on
    fas_2d_basic(6, 3), and the 6 stored fas2d_1023sq_newton_gen25
    champions at their own levels 10 -> 6 (1023^2): where the JAX package
    lowers an individual and traces a float64 step (jax.eval_shape), the
    port lowers it and takes one float64 step of the same shape."""
    if case.startswith("seed"):
        p = _probe_setup(63)
        seed = int(case[4:])
        ij = jgp.genGrow(p.psj, 2, 40, rng=random.Random(seed))
        it = tgp.genGrow(p.pst, 2, 40, rng=random.Random(seed))
    else:
        p = _probe_setup(CHAMPION_LEVELS)
        grammar = _champions()[int(case[8:])]
        ij, it = jgp.parse_tree(grammar, p.psj), tgp.parse_tree(grammar,
                                                                 p.pst)
    assert str(it) == str(ij)
    n = p.s.pt.finest_grid[0].size[0]
    try:
        lj = jlower.lower_cycle(jgp.compile_tree(ij, p.psj)[0],
                                p.s.pj.approximation, p.s.pj.rhs_entity)
        spec = (jax.ShapeDtypeStruct((n, n), jnp.float64),)
        jax.eval_shape(lj.step, spec, spec, jax.ShapeDtypeStruct(
            lj.default_omegas.shape, jnp.float64))
    except NotImplementedError:
        pytest.fail(f"the JAX package does not lower {case}; the probe "
                    "expects every one of its individuals to lower")
    lt = tlower.lower_cycle(tgp.compile_tree(it, p.pst)[0],
                            p.s.pt.approximation, p.s.pt.rhs_entity)
    out = lt.step((torch.zeros_like(p.s.bt[0]),), p.s.bt,
                  torch.tensor(lt.default_omegas))
    assert [tuple(o.shape) for o in out] == [(n, n)]
    assert out[0].dtype == torch.float64


# ---------------------------------------------------------------------------
# (d) the CLI
# ---------------------------------------------------------------------------

def test_cli_fas2d(tmp_path, capsys, monkeypatch):
    """``python -m evostencils_tpu_torch.optimize fas2d --cpu`` at levels
    6 -> 3 (63^2) runs one generation and writes its best individual,
    which re-parses and evaluates to a finite convergence factor.  The
    problem's budget is cut from 300 cycles to 15, so that a candidate
    that does not converge costs about a second (wall-time measurement
    off); fas2d's default levels are scripts/optimize.py's, 10 -> 6."""
    monkeypatch.setattr(tev.CycleEvaluator, "timing_enabled", False)
    factory = tfas.fas_2d_basic

    def cut(*a, **kw):
        problem = factory(*a, **kw)
        problem.max_iterations = 15
        return problem
    monkeypatch.setattr(tfas, "fas_2d_basic", cut)
    result = toptimize.main(["fas2d", "--cpu", "--max-level", "6",
                             "--min-level", "3", "--mu", "2", "--lambda",
                             "2", "--generations", "1", "--seed", "0",
                             "--output", str(tmp_path)])
    best = (tmp_path / "best_grammar.txt").read_text().strip()
    assert best == result["grammar_string"]
    assert "Best individual:" in capsys.readouterr().out
    problem = cut(6, 3)
    pset = _pset(tmg, problem)
    res = tev.CycleEvaluator(problem, device="cpu").evaluate_expression(
        tgp.compile_tree(tgp.parse_tree(best, pset), pset)[0])
    assert np.isfinite(res.convergence_factor) and res.convergence_factor > 0
    default = toptimize.get_problem("fas2d")
    assert (default.max_level, default.min_level) == (10, 6)
    assert default.finest_grid[0].size == (1023, 1023)
