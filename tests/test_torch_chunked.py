"""The port's level-chunked evolution against the JAX package on the CPU:
the composed lowering (``lower_composed``, ``make_chain_applier``,
``cgs_override``) for linear Poisson and for FAS
(tests/test_chunked_fas.py:37-103), the chunk grammars' IR trees and
"JAX lowers => the port lowers" on seeded chunk individuals, the
evaluator with ``chain=``, chunked runs end to end (tests/test_robustness.py:
52-80, tests/test_generalization_resume.py:120-190), the fused cycle loop
on a composed cycle, and the ``evaluate_evolved_solver`` and
``evaluate_reference_solver`` twins.

Everything runs in float64 with the kernels' plain versions.  A composed
step is held to the JAX package's to STEP_RTOL of max|JAX|; the composed
program to the whole cycle it splits.  Histories are compared above
1e-14 of their start, where the dense coarse matvec's summation order
(numpy against XLA) leaves its roundoff.
"""

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
from evostencils_tpu.evaluation import evaluator as jev
from evostencils_tpu.grammar import gp as jgp
from evostencils_tpu.grammar import multigrid as jmg
from evostencils_tpu.ir import base as jbase
from evostencils_tpu.ir import partitioning as jpart
from evostencils_tpu.ir import system as jsystem
from evostencils_tpu.ir import transformations as jtrans
from evostencils_tpu.optimization import program as jprogram
from evostencils_tpu.problems import fas as jfas
from evostencils_tpu.problems import poisson as jpoisson
from evostencils_tpu_torch import evaluate_evolved_solver as tevolved
from evostencils_tpu_torch import evaluate_reference_solver as treference
from evostencils_tpu_torch import optimize as toptimize
from evostencils_tpu_torch.compiler import cycles as tcycles
from evostencils_tpu_torch.compiler import lower as tlower
from evostencils_tpu_torch.compiler import solve as tsolve
from evostencils_tpu_torch.config import config as tconfig
from evostencils_tpu_torch.evaluation import evaluator as tev
from evostencils_tpu_torch.grammar import gp as tgp
from evostencils_tpu_torch.grammar import multigrid as tmg
from evostencils_tpu_torch.ir import base as tbase
from evostencils_tpu_torch.ir import partitioning as tpart
from evostencils_tpu_torch.ir import system as tsystem
from evostencils_tpu_torch.ir import transformations as ttrans
from evostencils_tpu_torch.optimization import program as tprogram
from evostencils_tpu_torch.optimization.program import (
    Optimizer, load_checkpoint_from_file)
from evostencils_tpu_torch.problems import fas as tfas
from evostencils_tpu_torch.problems import poisson as tpoisson
from evostencils_tpu_torch.problems.poisson import build_rhs

from tests.test_torch_slice3d import _describe

JAX = SimpleNamespace(cycles=jcycles, lower=jlower, solve=jsolve,
                      part=jpart, base=jbase, system=jsystem, trans=jtrans,
                      program=jprogram, mg=jmg, gp=jgp, poisson=jpoisson,
                      fas=jfas)
PORT = SimpleNamespace(cycles=tcycles, lower=tlower, solve=tsolve,
                       part=tpart, base=tbase, system=tsystem, trans=ttrans,
                       program=tprogram, mg=tmg, gp=tgp, poisson=tpoisson,
                       fas=tfas)

#: one composed step, port against JAX, relative to max|JAX|
STEP_RTOL = 1e-12
#: the chunk grammars' probe: poisson_2d(6, 2) in chunks of 2 levels
#: (63^2 and 31^2 over a 15^2 solve, then 15^2 and 7^2 over 3^2)
PROBE_LEVELS = (6, 2)
PROBE_SEEDS = range(40)
#: the chunked runs' problem, as tests/test_generalization_resume.py's
RUN_LEVELS = (4, 1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test run's parallel workers would
    otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def _timing_off():
    """Wall-time measurement off in every evaluator the optimizer builds
    (each later chunk's is new): the fitness's time is then the iteration
    count, deterministic, and eager solves on the CPU cost a tenth."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tev.CycleEvaluator, "timing_enabled", False)
        yield


def _fresh_rhs(pkg, grids):
    return pkg.system.RightHandSide(
        "b_c", [pkg.base.RightHandSide("b_c", g) for g in grids])


def _v21(pkg, levels, rhs, coarse_operator):
    return pkg.cycles.v_cycle(levels, rhs, pre_smoothing=2,
                              post_smoothing=1, omega=1.15,
                              partitioning=pkg.part.RedBlack,
                              coarse_operator=coarse_operator)


def _fas(pkg, levels, rhs, coarse_operator):
    return pkg.cycles.fas_v_cycle(levels, rhs,
                                  coarse_operator=coarse_operator)


def _split(pkg, problem, build, split_at=2):
    """(whole, composed) lowered cycles of ``build`` on ``problem``: the
    whole hierarchy, and the same cycle split after ``split_at`` levels,
    the finer part over the coarser one's fresh entities
    (tests/test_chunked_fas.py:37-73)."""
    ctx = problem.level_contexts
    whole = pkg.lower.lower_cycle(
        build(pkg, ctx, problem.rhs_entity, problem.coarsest_operator),
        problem.approximation, problem.rhs_entity)
    fine = build(pkg, ctx[:split_at], problem.rhs_entity,
                 ctx[split_at].operator)
    rhs2 = _fresh_rhs(pkg, ctx[split_at].grid)
    coarse = build(pkg, ctx[split_at:], rhs2, problem.coarsest_operator)
    composed = pkg.lower.lower_composed(
        [pkg.lower.ChainLink(fine, problem.approximation,
                             problem.rhs_entity)],
        coarse, ctx[split_at].approximation, rhs2)
    return whole, composed


def _steps(lj, lt, bj, bt, u0):
    uj = lj.step((jnp.asarray(u0),), bj, jnp.asarray(lj.default_omegas))
    ut = lt.step((torch.from_numpy(u0),), bt,
                 torch.tensor(lt.default_omegas))
    return np.asarray(uj[0]), ut[0].numpy()


def _port_solve(low, b, max_iterations=40, target=1e-8):
    u, k, h = tsolve.make_solver(low, max_iterations, target)(
        (torch.zeros_like(b[0]),), b, torch.tensor(low.default_omegas))
    return u[0].numpy(), k, h[:k + 1].numpy()


# ---------------------------------------------------------------------------
# (a) the composed lowering
# ---------------------------------------------------------------------------

_FAMILIES = {}


def _family(kind):
    """Both packages' problem, right-hand side and (whole, composed)
    cycles: "poisson" poisson_2d(7, 3) with the RB V(2,1), "fas"
    fas_2d_basic(6, 3) with fas_v_cycle, once."""
    if kind not in _FAMILIES:
        if kind == "poisson":
            pj, pt = jpoisson.poisson_2d(7, 3), tpoisson.poisson_2d(7, 3)
            build = _v21
        else:
            pj, pt = jfas.fas_2d_basic(6, 3), tfas.fas_2d_basic(6, 3)
            build = _fas
        pj.dtype = np.float64
        _FAMILIES[kind] = SimpleNamespace(
            pj=pj, pt=pt, bj=pj.build_rhs(),
            bt=build_rhs(pt, dtype=torch.float64, device="cpu"),
            j=_split(JAX, pj, build), t=_split(PORT, pt, build))
    return _FAMILIES[kind]


@pytest.mark.parametrize("kind", ["poisson", "fas"])
def test_composed_step_matches_jax(kind):
    """One composed step from a random start (poisson) or half the exact
    solution (fas) within STEP_RTOL of the JAX package's composed step;
    the same omegas, in lower_composed's order, chain first."""
    f = _family(kind)
    (_, cj), (_, ct) = f.j, f.t
    np.testing.assert_array_equal(ct.default_omegas, cj.default_omegas)
    assert ct.n_omegas == cj.n_omegas
    if kind == "fas":
        u0 = 0.5 * f.pt.exact_solution()[0]
    else:
        u0 = np.random.default_rng(3).standard_normal(f.bt[0].shape)
    want, got = _steps(cj, ct, f.bj, f.bt, u0)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=STEP_RTOL * np.abs(want).max())


@pytest.mark.parametrize("kind", ["poisson", "fas"])
def test_composed_equals_whole_cycle(kind):
    """The composed program is the whole cycle's arithmetic
    (tests/test_chunked_fas.py:37-73): a solve to 1e-8 takes as many
    cycles, its history within 1e-9 relative above 1e-14 of its start and
    its solution within 1e-7; on the JAX side too."""
    f = _family(kind)
    (wt, ct) = f.t
    uw, kw, hw = _port_solve(wt, f.bt)
    uc, kc, hc = _port_solve(ct, f.bt)
    assert kc == kw and 3 < kc < 40 and hc[kc] <= 1e-8 * hc[0]
    np.testing.assert_allclose(hc, hw, rtol=1e-9, atol=1e-14 * hw[0])
    np.testing.assert_allclose(uc, uw, rtol=1e-7, atol=1e-12)
    _, kj, hj = jsolve.make_solver(f.j[1], 40, 1e-8)(
        (jnp.zeros_like(f.bj[0]),), f.bj, jnp.asarray(f.j[1].default_omegas))
    assert int(kj) == kc
    np.testing.assert_allclose(hc, np.asarray(hj)[:kc + 1], rtol=1e-9,
                               atol=1e-14 * hc[0])


def test_fas_initial_guess_reaches_spliced_chunk():
    """tests/test_chunked_fas.py:75-93 in both packages: a chain applier
    of fas_2d_basic(5, 3)'s cycle seeded at the exact solution keeps the
    nonlinear residual below 1e-3 of the zero start's, and equals the JAX
    applier's to STEP_RTOL, seeded and from zero.  The composed FAS step
    hands the spliced chunk the restricted solution, not zero: its
    override sees an initial guess."""
    out = {}
    exact = tfas.fas_2d_basic(5, 3).exact_solution()
    for pkg, prob in ((JAX, jfas.fas_2d_basic(5, 3)),
                      (PORT, tfas.fas_2d_basic(5, 3))):
        prob.dtype = np.float64
        cycle = _fas(pkg, prob.level_contexts, prob.rhs_entity,
                     prob.coarsest_operator)
        pkg.trans.assign_cycle_ids(cycle)
        om = [float(c.relaxation_factor)
              for c in pkg.trans.find_nodes(cycle, pkg.base.Cycle)]
        applier = pkg.lower.make_chain_applier(cycle, prob.approximation,
                                               prob.rhs_entity)
        if pkg is JAX:
            b = prob.build_rhs()
            seeded = applier(b, jnp.asarray(om), initial_guess=tuple(
                jnp.asarray(x) for x in exact))
            zero = applier(b, jnp.asarray(om))
        else:
            b = build_rhs(prob, dtype=torch.float64, device="cpu")
            seeded = applier(b, torch.tensor(om, dtype=torch.float64), initial_guess=tuple(
                torch.from_numpy(x) for x in exact))
            zero = applier(b, torch.tensor(om, dtype=torch.float64))
            mv = tlower.operator_applier(prob.level_contexts[0].operator)
            r_seeded = (b[0] - mv(seeded)[0]).abs().max()
            assert r_seeded < 1e-3 * b[0].abs().max()
        out[pkg is JAX] = [np.asarray(x[0]) for x in (seeded, zero)]
    for got, want in zip(out[False], out[True]):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=STEP_RTOL * np.abs(want).max())
    f = _family("fas")
    seen = []
    make = tlower.make_chain_applier

    def spying(*a, **kw):
        applier = make(*a, **kw)

        def spy(fields, omegas, initial_guess=None):
            seen.append((tuple(fields[0].shape), initial_guess))
            return applier(fields, omegas, initial_guess)
        spy.wants_omegas = True
        return spy
    ct = f.t[1]
    ctx = f.pt.level_contexts
    rhs2 = _fresh_rhs(PORT, ctx[2].grid)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlower, "make_chain_applier", spying)
        low = tlower.lower_composed(
            [tlower.ChainLink(ct.expression, ct.approximation, ct.rhs)],
            _fas(PORT, ctx[2:], rhs2, f.pt.coarsest_operator),
            ctx[2].approximation, rhs2)
    u0 = 0.5 * f.pt.exact_solution()[0]
    low.step((torch.from_numpy(u0),), f.bt, torch.tensor(low.default_omegas))
    # the finest chunk's applier takes the state, the spliced one the
    # restricted solution on its own grid
    coarse = [guess for shape, guess in seen
              if shape == tuple(ctx[2].grid[0].size)]
    assert len(seen) == 2 and len(coarse) == 1 and len(coarse[0]) == 1
    assert tuple(coarse[0][0].shape) == tuple(ctx[2].grid[0].size)
    assert coarse[0][0].abs().max() > 0.1 * np.abs(u0).max()


def test_every_chunk_takes_use_kernels():
    """``use_kernels=False`` reaches every chunk of a composed program,
    and each chunk's plans and constants are built once: two steps build
    no new plan."""
    f = _family("poisson")
    ctx = f.pt.level_contexts
    fine = _v21(PORT, ctx[:2], f.pt.rhs_entity, ctx[2].operator)
    rhs2 = _fresh_rhs(PORT, ctx[2].grid)
    coarse = _v21(PORT, ctx[2:], rhs2, f.pt.coarsest_operator)
    seen = []
    plans = []
    with pytest.MonkeyPatch.context() as mp:
        init = tlower._Lowering.__init__

        def spy(self, *a, use_kernels=True, **kw):
            seen.append(use_kernels)
            init(self, *a, use_kernels=use_kernels, **kw)
        plan_of = tlower._plans_of
        mp.setattr(tlower._Lowering, "__init__", spy)
        mp.setattr(tlower, "_plans_of",
                   lambda root: plans.append(root) or plan_of(root))
        low = tlower.lower_composed(
            [tlower.ChainLink(fine, f.pt.approximation, f.pt.rhs_entity)],
            coarse, ctx[2].approximation, rhs2, use_kernels=False)
        assert len(plans) == 2
        for _ in range(2):
            low.step((torch.zeros_like(f.bt[0]),), f.bt,
                     torch.tensor(low.default_omegas))
    assert len(plans) == 2 and len(seen) == 4 and not any(seen)
    assert not low.use_kernels and not low.syncs_host


def test_fused_loop_on_composed_cycle_is_stepped():
    """With ``config.loop_fusion`` on, ``make_cycle_loop`` of the composed
    RB V(2,1) of poisson_2d(8, 4) (255^2 and 127^2 over 63^2 and 31^2),
    whose finest level the fused loop's plan matches, equals that many
    steps bitwise: the composed cycle takes the stepped form, so its chunk
    boundary runs the spliced chunk."""
    pt = tpoisson.poisson_2d(8, 4)
    _, ct = _split(PORT, pt, _v21)
    assert tlower.extract_fine_leg_plan(ct.expression) is not None
    b = build_rhs(pt, dtype=torch.float64, device="cpu")
    om = torch.tensor(ct.default_omegas)
    u0 = (torch.zeros_like(b[0]),)
    stepped = u0
    for _ in range(3):
        stepped = ct.step(stepped, b, om)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tconfig, "loop_fusion", True)
        fused = tsolve.make_cycle_loop(ct, 3)(u0, b, om)
    assert torch.equal(fused[0], stepped[0])


# ---------------------------------------------------------------------------
# (b) the chunk grammars
# ---------------------------------------------------------------------------

_CHUNKS = {}


def _chunk(pkg, ci, levels=PROBE_LEVELS, levels_per_run=2):
    """Chunk ``ci`` of a chunked run on poisson_2d(*levels), as both
    optimizers build it: (problem, entities, pset); with the reference RB
    V(2,1) of every finer chunk as its chain."""
    key = (pkg is JAX, ci, levels, levels_per_run)
    if key not in _CHUNKS:
        problem = pkg.poisson.poisson_2d(*levels)
        problem.dtype = np.float64
        contexts = problem.level_contexts
        chain = []
        for cj in range(ci + 1):
            i = cj * levels_per_run
            ctxs = contexts[i:i + levels_per_run]
            approx, rhs = pkg.program._chunk_entities(problem, ctxs,
                                                      cj == 0)
            coarsest = pkg.program._chunk_coarsest(problem, contexts, i,
                                                   levels_per_run)
            if cj < ci:
                root = pkg.cycles.v_cycle(
                    ctxs, rhs, pre_smoothing=2, post_smoothing=1,
                    omega=1.15, partitioning=pkg.part.RedBlack,
                    coarse_operator=coarsest)
                chain.append(pkg.lower.ChainLink(root, approx, rhs))
        pset = pkg.mg.generate_primitive_set(approx, rhs, ctxs, coarsest)[0]
        _CHUNKS[key] = SimpleNamespace(problem=problem, chain=chain,
                                       entities=(approx, rhs), pset=pset,
                                       ctxs=ctxs)
    return _CHUNKS[key]


def test_chunk_entities_match_jax():
    """Both optimizers' chunk entities bind the same levels: the first
    chunk the problem's own, a later one a zero approximation and a fresh
    rhs on its finest grid; the chunk's coarse-solve operator is the one
    below it, the problem's coarsest for the last chunk."""
    for ci in (0, 1):
        cj, ct = _chunk(JAX, ci), _chunk(PORT, ci)
        for ej, et in zip(cj.entities, ct.entities):
            assert type(et).__name__ == type(ej).__name__
            assert [tuple(g.size) for g in et.grid] == \
                [tuple(g.size) for g in ej.grid]
        assert [tuple(c.grid[0].size) for c in ct.ctxs] == \
            [tuple(c.grid[0].size) for c in cj.ctxs]
    assert isinstance(_chunk(PORT, 1).entities[0], tsystem.ZeroApproximation)


def _probe_pair(ci, seed):
    cj, ct = _chunk(JAX, ci), _chunk(PORT, ci)
    ij = jgp.genGrow(cj.pset, 2, 40, rng=random.Random(seed))
    it = tgp.genGrow(ct.pset, 2, 40, rng=random.Random(seed))
    return cj, ct, ij, it


def _lower_chunk(pkg, c, individual):
    root = pkg.gp.compile_tree(individual, c.pset)[0]
    return pkg.lower.lower_composed(list(c.chain), root, *c.entities)


@pytest.mark.parametrize("seed", PROBE_SEEDS)
@pytest.mark.parametrize("ci", [0, 1])
def test_chunk_individuals_jax_lowers_implies_port_lowers(ci, seed):
    """genGrow(pset, 2, 40) seeds 0-39 of each chunk grammar: the same
    string and the same IR tree node for node in both packages; where the
    JAX package lowers the candidate's chunk and traces it
    (jax.eval_shape), the port lowers the composed program and takes one
    step of the finest grid's shape; seeds 0-2 of each chunk within
    STEP_RTOL of the JAX package's composed step."""
    cj, ct, ij, it = _probe_pair(ci, seed)
    assert str(it) == str(ij)
    assert _describe(PORT, tgp.compile_tree(it, ct.pset)[0]) == \
        _describe(JAX, jgp.compile_tree(ij, cj.pset)[0])
    n = ct.problem.finest_grid[0].size[0]
    try:
        # the candidate's own chunk: the chain is the reference V(2,1),
        # which lowers in both packages
        root = jgp.compile_tree(ij, cj.pset)[0]
        jtrans.assign_cycle_ids(root)
        m = cj.ctxs[0].grid[0].size[0]
        spec = (jax.ShapeDtypeStruct((m, m), jnp.float64),)
        jax.eval_shape(jlower.make_chain_applier(root, *cj.entities), spec,
                       jax.ShapeDtypeStruct((len(jtrans.find_nodes(
                           root, jbase.Cycle)),), jnp.float64))
    except NotImplementedError:
        pytest.fail(f"the JAX package does not lower chunk {ci} seed "
                    f"{seed}; the probe expects every individual to lower")
    lt = _lower_chunk(PORT, ct, it)
    rng = np.random.default_rng(seed)
    u0, b = rng.standard_normal((n, n)), rng.standard_normal((n, n))
    if seed < 3:
        want, got = _steps(_lower_chunk(JAX, cj, ij), lt, (jnp.asarray(b),),
                           (torch.from_numpy(b),), u0)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=STEP_RTOL * np.abs(want).max())
    else:
        out = lt.step((torch.from_numpy(u0),), (torch.from_numpy(b),),
                      torch.tensor(lt.default_omegas))
        assert [tuple(o.shape) for o in out] == [(n, n)]


# ---------------------------------------------------------------------------
# (c) the evaluator and the optimizer
# ---------------------------------------------------------------------------

#: chunk-1 individuals (genGrow seeds of the probe grammar) whose composed
#: programs converge in both packages
EVAL_SEEDS = (0, 5, 11)


def test_evaluator_with_chain_matches_jax():
    """``CycleEvaluator(chain=, cand_entities=)`` on chunk-1 candidates over
    the chunk-0 RB V(2,1), timing off: the same iterations as the JAX
    evaluator's and the same convergence factor, held to rtol 1e-6 above
    the share of its last entry that the roundoff floor of b - A u
    (1e-15 h_0) takes, as tests/test_torch_evaluator.py holds it; a
    missing ``cand_entities`` raises the JAX package's ValueError."""
    cj, ct = _chunk(JAX, 1), _chunk(PORT, 1)
    with pytest.raises(ValueError):
        tev.CycleEvaluator(ct.problem, device="cpu", chain=ct.chain)
    evj = jev.CycleEvaluator(cj.problem, chain=cj.chain,
                             cand_entities=cj.entities)
    evt = tev.CycleEvaluator(ct.problem, device="cpu", chain=ct.chain,
                             cand_entities=ct.entities)
    np.testing.assert_array_equal(evt._omega_prefix, evj._omega_prefix)
    indj = [jgp.genGrow(cj.pset, 2, 40, rng=random.Random(s))
            for s in EVAL_SEEDS]
    indt = [tgp.genGrow(ct.pset, 2, 40, rng=random.Random(s))
            for s in EVAL_SEEDS]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jev.CycleEvaluator, "timing_enabled", False)
        mp.setattr(tev.CycleEvaluator, "timing_enabled", False)
        rj = evj.evaluate_population(indj, cj.pset)
        rt = evt.evaluate_population(indt, ct.pset)
    for a, b in zip(rt, rj):
        assert a.iterations == b.iterations < 1e99
        rho, k = b.convergence_factor, b.iterations
        tol = 1e-6 + 1e-15 / rho ** k / k
        assert abs(a.convergence_factor - rho) <= tol * rho


#: the runs' cut iteration budgets: a candidate that does not converge
#: then costs 30 cycles (Poisson; a good one needs about 20 to 1e-12) or 5
#: (FAS, whose run checks the plumbing only, as the JAX test's does), not
#: 100 or 300
RUN_MAX_ITERATIONS = {"poisson": 30, "fas": 5}


def _run_problem(kind):
    problem = tfas.fas_2d_basic(5, 2) if kind == "fas" \
        else tpoisson.poisson_2d(*RUN_LEVELS)
    problem.max_iterations = RUN_MAX_ITERATIONS[kind]
    problem.dtype = np.float64
    return problem


def _optimizer(path, kind="poisson", seed=7, **kw):
    problem = _run_problem(kind)
    return Optimizer(problem,
                     evaluator=tev.CycleEvaluator(problem, device="cpu"),
                     rng=random.Random(seed),
                     checkpoint_directory_path=str(path), **kw)


RUN_KWARGS = dict(mu_=2, lambda_=2, population_initialization_factor=2,
                  generations=4, levels_per_run=2, verbose=False)


@pytest.fixture(scope="module")
def chunked_run(tmp_path_factory):
    """One chunked poisson_2d(4, 1) run (3 levels in chunks of 2,
    tests/test_generalization_resume.py:120-127), timing off."""
    path = tmp_path_factory.mktemp("chunked")
    opt = _optimizer(path)
    return SimpleNamespace(opt=opt, path=path,
                           result=opt.evolutionary_optimization(**RUN_KWARGS))


def test_chunked_run_builds_chain(chunked_run):
    """Two chunks, one finished link, a finite best individual, and the
    stored chunk strings rebuild the same composed program: its
    re-evaluation gives the run's convergence factor
    (tests/test_generalization_resume.py:129-135, :174-183)."""
    result = chunked_run.result
    assert len(result["chunk_grammar_strings"]) == 2
    assert len(result["chain"]) == 1
    vals = result["best_individual"].fitness.values
    assert all(v < Optimizer.infinity for v in vals)
    expr, res = chunked_run.opt.evaluate_chunked_program(
        result["chunk_grammar_strings"], levels_per_run=2)
    assert res.convergence_factor == pytest.approx(vals[0], rel=1e-12)


def test_chunked_program_wrong_levels_per_run_raises(chunked_run):
    """A levels_per_run that splits the levels into another number of
    chunks than the strings raises the JAX package's ValueError, and so
    does one that does not parse against the chunk grammar."""
    strings = chunked_run.result["chunk_grammar_strings"]
    with pytest.raises(ValueError, match="levels_per_run=1 splits"):
        chunked_run.opt.evaluate_chunked_program(strings, levels_per_run=1)
    with pytest.raises(ValueError):
        chunked_run.opt.evaluate_chunked_program(strings[::-1],
                                                 levels_per_run=2)


def test_chunked_fas_run(tmp_path):
    """A chunked fas_2d_basic(5, 2) run builds its chain and re-evaluates
    from its strings (tests/test_chunked_fas.py:96-114), cut to μ = λ = 2,
    two initial candidates and one generation."""
    opt = _optimizer(tmp_path, "fas", seed=11)
    result = opt.evolutionary_optimization(
        **dict(RUN_KWARGS, population_initialization_factor=1,
               generations=1))
    assert len(result["chunk_grammar_strings"]) == 2
    assert len(result["chain"]) == 1
    _, res = opt.evaluate_chunked_program(
        result["chunk_grammar_strings"], levels_per_run=2)
    assert res is not None


def test_chunked_run_keeps_robustness_variants(tmp_path):
    """tests/test_robustness.py:52-80: every chunk's evaluations meet the
    variant evaluator, and the variant's chain grows with the base's."""
    opt = _optimizer(tmp_path, seed=13,
                     robustness_problems=[_run_problem("poisson")])
    seen = []
    orig = Optimizer._apply_robustness

    def spy(self, individuals, values_list):
        out = orig(self, individuals, values_list)
        seen.append(len(self._robustness))
        return out
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Optimizer, "_apply_robustness", spy)
        r = opt.evolutionary_optimization(
            **dict(RUN_KWARGS, generations=1))
    assert all(np.isfinite(x) for x in r["best_individual"].fitness.values)
    assert seen and all(n == 1 for n in seen)
    assert len(r["chain"]) == 1
    assert opt._robustness[0][0].chain and \
        opt._robustness[0][0].chain[0].root is not r["chain"][0].root


def test_resume_mid_chunk_reproduces_uninterrupted(chunked_run, tmp_path):
    """tests/test_generalization_resume.py:137-172 with timing off (a
    deterministic fitness, as the model-based one there): a run killed
    after chunk 2's first checkpoint and resumed reproduces the
    uninterrupted run's best individual, fitness and chunk strings."""
    kwargs = RUN_KWARGS
    full = chunked_run.result          # the same problem, seed and options
    opt2 = _optimizer(tmp_path / "b")
    calls = {"n": 0}
    orig = opt2._save_checkpoint

    def save_then_die(*a, **k):
        orig(*a, **k)
        calls["n"] += 1
        if calls["n"] == 3:
            raise KeyboardInterrupt
    opt2._save_checkpoint = save_then_die
    with pytest.raises(KeyboardInterrupt):
        opt2.evolutionary_optimization(**kwargs)
    cp = load_checkpoint_from_file(str(tmp_path / "b" / "checkpoint.p"))
    assert len(cp.finished_chunks) == 1 and cp.generation == 2
    resumed = _optimizer(tmp_path / "b").evolutionary_optimization(
        continue_from_checkpoint=True, **kwargs)
    assert str(resumed["best_individual"]) == str(full["best_individual"])
    assert resumed["best_individual"].fitness.values == \
        full["best_individual"].fitness.values
    assert resumed["chunk_grammar_strings"] == full["chunk_grammar_strings"]


def test_chunked_run_warns_off_stepwise_generalization(tmp_path, capsys):
    """A chunked run with a generalization interval below its generations
    prints the JAX package's warning and runs without generalizing."""
    opt = _optimizer(tmp_path)
    r = opt.evolutionary_optimization(
        **dict(RUN_KWARGS, generations=1, generalization_interval=0))
    assert "stepwise generalization only supported" in capsys.readouterr().out
    assert len(r["chunk_grammar_strings"]) == 2


# ---------------------------------------------------------------------------
# (d) the evaluate twins
# ---------------------------------------------------------------------------

def test_evaluate_evolved_solver_twin(chunked_run, capsys):
    """``python -m evostencils_tpu_torch.evaluate_evolved_solver --cpu`` on
    a two-line best_grammar.txt measures the composed program (the
    convergence factor and iterations of evaluate_chunked_program) and on
    a one-line file the single cycle, each printing the JAX script's three
    lines."""
    strings = chunked_run.result["chunk_grammar_strings"]
    grammar = chunked_run.path / "best_grammar.txt"
    grammar.write_text("\n".join(strings) + "\n")
    argv = [str(grammar), "poisson2d", "--cpu", "--max-level",
            str(RUN_LEVELS[0]), "--min-level", str(RUN_LEVELS[1])]
    res = tevolved.main(argv + ["--levels-per-run", "2"])
    _, want = chunked_run.opt.evaluate_chunked_program(strings,
                                                       levels_per_run=2)
    assert res.iterations == want.iterations
    assert res.convergence_factor == pytest.approx(want.convergence_factor,
                                                   rel=1e-12)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        "Time to convergence", "Convergence factor", "Number of iterations"]
    problem = toptimize.get_problem("poisson2d", *RUN_LEVELS)
    problem.dtype = np.float64
    opt = Optimizer(problem,
                    evaluator=tev.CycleEvaluator(problem, device="cpu"))
    pset = tmg.generate_primitive_set(
        problem.approximation, problem.rhs_entity, problem.level_contexts,
        problem.coarsest_operator)[0]
    whole = str(tgp.genGrow(pset, 2, 40, rng=random.Random(1)))
    single = chunked_run.path / "single.txt"
    single.write_text(whole + "\n")
    res = tevolved.main([str(single)] + argv[1:])
    _, want = opt.generate_and_evaluate_program_from_grammar_representation(
        whole)
    assert (res.iterations, res.convergence_factor) == \
        (want.iterations, want.convergence_factor)


def test_evaluate_reference_solver_twin(capsys):
    """``python -m evostencils_tpu_torch.evaluate_reference_solver --cpu``
    at poisson_2d(8, 7), where the coarse 127^2 is a CG solve: the
    iterations and convergence factor of the JAX package's measure_solve of
    the same V(2,1) in float64, and the JAX script's three lines."""
    for levels in ((8, 7),):
        res = treference.main(["poisson2d", "--cpu", "--max-level",
                               str(levels[0]), "--min-level", str(levels[1]),
                               "--samples", "1"])
        pj = jpoisson.poisson_2d(*levels)
        pj.dtype = np.float64
        lj = jlower.lower_cycle(_v21(JAX, pj.level_contexts, pj.rhs_entity,
                                     pj.coarsest_operator),
                                pj.approximation, pj.rhs_entity)
        want = jsolve.measure_solve(lj, pj.build_rhs(),
                                    max_iterations=pj.max_iterations,
                                    target_reduction=pj.target_reduction,
                                    samples=1)
        assert res.iterations == want.iterations and res.converged
        # rtol 1e-6 above the roundoff floor's share of the last entry, as
        # test_evaluator_with_chain_matches_jax
        rho, k = want.convergence_factor, want.iterations
        tol = 1e-6 + 1e-15 / rho ** k / k
        assert abs(res.convergence_factor - rho) <= tol * rho
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines[:3]] == [
        "Average solving time", "Average number of iterations",
        "Convergence factor"]


def jax_fused_loop_residuals(cycles=3):
    """The JAX package's own fused cycle loop on a composed cycle, which
    this module's fused-loop test holds the port against (not a test: the
    Pallas kernels run in interpret mode, about 40 s):

        JAX_PLATFORMS=cpu python -c 'from tests.test_torch_chunked import
        jax_fused_loop_residuals as f; print(f())'

    The RB V(2,1) of poisson_2d(8, 4) in float32, split after 255^2 and
    127^2; ``cycles`` chained cycles with the Pallas kernels on.  Returns
    the residual norms of the composed cycle stepped and fused, of the
    whole cycle stepped and fused, and of chunk 0 alone over the dense
    63^2 solve.  JAX's fused loop builds its coarse tail without the chunk
    splice (lower.py:1978-1988), so the composed cycle fused gives chunk
    0's residual, not its stepped one's."""
    from evostencils_tpu import config as jconfig
    with jax.enable_x64(False):
        pj = jpoisson.poisson_2d(8, 4)
        pj.dtype = np.float32
        whole, composed = _split(JAX, pj, _v21)
        ctx = pj.level_contexts
        alone = jlower.lower_cycle(
            _v21(JAX, ctx[:2], pj.rhs_entity, ctx[2].operator),
            pj.approximation, pj.rhs_entity)
        b = pj.build_rhs()
        res_norm = jsolve.residual_norm_fn(composed.operator)
        out = {}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jconfig.config, "use_pallas_kernels", True)
            for name, low in (("composed", composed), ("whole", whole),
                              ("chunk 0 alone", alone)):
                om = jnp.asarray(low.default_omegas, jnp.float32)
                u = (jnp.zeros_like(b[0]),)
                for _ in range(cycles):
                    u = low.step(u, b, om)
                out[name + " stepped"] = float(res_norm(u, b))
                if name == "chunk 0 alone":
                    continue
                mp.setattr(jconfig.config, "loop_fusion", True)
                u = jsolve.make_cycle_loop(low, cycles)(
                    (jnp.zeros_like(b[0]),), b, om)
                mp.setattr(jconfig.config, "loop_fusion", False)
                out[name + " fused"] = float(res_norm(u, b))
    return out
