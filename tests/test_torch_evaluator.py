"""The port's evolution path (evostencils_tpu_torch/evaluation,
optimization and optimize.py) against the JAX package on the CPU.

Both packages build their own ``poisson_2d(8, 5)`` problem and primitive
set, grow the same seeded individuals and evaluate them in float64 with
wall-time measurement off.  At 255^2 the finest level admits all four
standalone kernels (the sweep gate needs 128 columns, the transfer gate
129 rows), so the port runs their plain versions there; the JAX package
runs XLA, because its Pallas gates take float32 only.

Histories agree entry by entry to about 1e-17 * ||b||, the roundoff floor
of b - A u.  The last entry of a solve to 1e-12 sits near that floor, so
rho = (h_k / h_0)^(1/k) is held to rtol 1e-6 above the floor's share
1e-15 * h_0 / h_k / k, as tests/test_torch_slice3d.py holds it.
"""

import collections
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from evostencils_tpu.compiler import cycles as jcycles
from evostencils_tpu.evaluation import evaluator as jev
from evostencils_tpu.grammar import gp as jgp
from evostencils_tpu.grammar import multigrid as jmg
from evostencils_tpu.ir import partitioning as jpart
from evostencils_tpu.problems import poisson as jpoisson
from evostencils_tpu_torch import optimize as toptimize
from evostencils_tpu_torch.compiler import cycles as tcycles
from evostencils_tpu_torch.compiler.lower import ChainLink
from evostencils_tpu_torch.evaluation import evaluator as tev
from evostencils_tpu_torch.grammar import gp as tgp
from evostencils_tpu_torch.grammar import multigrid as tmg
from evostencils_tpu_torch.ir import partitioning as tpart
from evostencils_tpu_torch.ir import transformations as ttrans
from evostencils_tpu_torch.ops.kernels import rbgs as trbgs
from evostencils_tpu_torch.ops.kernels import transfer as ttransfer
from evostencils_tpu_torch.optimization.program import Optimizer
from evostencils_tpu_torch.problems import poisson as tpoisson

#: genGrow seeds: four that converge (all with collective block Jacobi)
#: and two that do not, chosen among cheap ones
SEEDS = (1, 4, 9, 17, 21, 36)
#: hand-built V(2,1) cycles: (partitioning name, omega)
HAND = {"rb": ("RedBlack", 1.15), "jacobi": ("Single", 0.8)}
#: the plain versions of the standalone kernels, by module
PLAIN = [(trbgs, "fused_rbgs_sweep_plain"), (trbgs, "sweep_plain"),
         (ttransfer, "residual_restrict_plain"),
         (ttransfer, "prolong_correct_plain")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the eager ops on these grids run as fast on
    one, and the test run's parallel workers would otherwise oversubscribe
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pset(mg, problem):
    return mg.generate_primitive_set(problem.approximation,
                                     problem.rhs_entity,
                                     problem.level_contexts,
                                     problem.coarsest_operator)[0]


def _v21(problem, cycles, part, partitioning, omega):
    """A hand-built V(2,1) cycle on ``problem``'s own entities."""
    return cycles.v_cycle(problem.level_contexts, problem.rhs_entity,
                           pre_smoothing=2, post_smoothing=1, omega=omega,
                           partitioning=getattr(part, partitioning),
                           coarse_operator=problem.coarsest_operator)


@pytest.fixture(scope="module")
def runs():
    """Both evaluators over the seeded individuals and the hand-built
    cycles; the port's run counts its calls of each kernel's plain
    version."""
    pj = jpoisson.poisson_2d(max_level=8, min_level=5)
    pt = tpoisson.poisson_2d(max_level=8, min_level=5)
    pj.dtype = pt.dtype = np.float64
    psj, pst = _pset(jmg, pj), _pset(tmg, pt)
    ej = jev.CycleEvaluator(pj)
    et = tev.CycleEvaluator(pt, device="cpu")
    ej.timing_enabled = et.timing_enabled = False
    indj = [jgp.genGrow(psj, 2, 40, rng=random.Random(s)) for s in SEEDS]
    indt = [tgp.genGrow(pst, 2, 40, rng=random.Random(s)) for s in SEEDS]
    assert [str(i) for i in indt] == [str(i) for i in indj]

    calls = collections.Counter()
    trbgs.reset_launches()
    ttransfer.reset_launches()
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in PLAIN:
            def counted(*a, _fn=getattr(mod, name), _name=name, **k):
                calls[_name] += 1
                return _fn(*a, **k)
            mp.setattr(mod, name, counted)
        port = et.evaluate_population(indt, pst)
        port_hand = {k: et.evaluate_expression(
            _v21(pt, tcycles, tpart, *v)) for k, v in HAND.items()}
    jax = ej.evaluate_population(indj, psj)
    jax_hand = {k: ej.evaluate_expression(_v21(pj, jcycles, jpart, *v))
                for k, v in HAND.items()}
    return {"strings": [str(i) for i in indt],
            "port": port + [port_hand[k] for k in HAND],
            "jax": jax + [jax_hand[k] for k in HAND],
            "calls": calls, "evaluator": et, "pset": pst,
            "individuals": indt,
            "launches": dict(trbgs.launches, **ttransfer.launches)}


def test_block_jacobi_individual_among_them(runs):
    assert any("collective_block_jacobi" in s for s in runs["strings"])


def test_same_lowerable_set(runs):
    """Every individual the JAX package lowers and solves (finite rho)
    the port lowers and solves too; here that is all of them."""
    inf = 1e100
    lowered_j = [r.convergence_factor < inf for r in runs["jax"]]
    lowered_t = [r.convergence_factor < inf for r in runs["port"]]
    assert all(lowered_j)
    assert lowered_t == lowered_j


def test_same_finite_verdicts(runs):
    finite_j = [r.time_to_convergence_ms < 1e100 for r in runs["jax"]]
    finite_t = [r.time_to_convergence_ms < 1e100 for r in runs["port"]]
    assert finite_t == finite_j
    assert 0 < sum(finite_j) < len(finite_j)       # both verdicts occur


def test_equal_iterations(runs):
    assert [r.iterations for r in runs["port"]] == \
        [r.iterations for r in runs["jax"]]


def test_rho_matches(runs):
    for rt, rj in zip(runs["port"], runs["jax"]):
        rho_j, rho_t = rj.convergence_factor, rt.convergence_factor
        tol = 1e-6
        if np.isfinite(rj.iterations) and 0 < rho_j < 1:
            k = rj.iterations
            tol += 1e-15 / rho_j ** k / k      # floor share of the last entry
        assert abs(rho_t - rho_j) <= tol * rho_j, (rho_t, rho_j)


def test_kernel_plain_versions_reached(runs):
    """The evolved and hand-built cycles go through all four standalone
    kernels' dispatch; on the CPU that runs the plain versions and launches
    nothing."""
    for _, name in PLAIN:
        assert runs["calls"][name] > 0, (name, runs["calls"])
    assert set(runs["launches"].values()) == {0}


def test_population_equals_expression(runs):
    """evaluate_population's grouped runs give each member what
    evaluate_expression gives it alone."""
    et, pst = runs["evaluator"], runs["pset"]
    for ind, pop in zip(runs["individuals"], runs["port"]):
        expr = tgp.compile_tree(ind, pst)[0]
        ttrans.assign_cycle_ids(expr)
        one = et.evaluate_expression(expr)
        assert one.iterations == pop.iterations
        assert one.convergence_factor == pop.convergence_factor
        assert one.time_to_convergence_ms == pop.time_to_convergence_ms


def test_group_members_keep_their_omegas():
    """Two members of one structure group run with their own relaxation
    factors: the same tree with other factors converges differently."""
    problem = tpoisson.poisson_2d(max_level=5, min_level=2)
    problem.dtype = np.float64
    pset = _pset(tmg, problem)
    ev = tev.CycleEvaluator(problem, device="cpu")
    ev.timing_enabled = False
    a = tgp.genGrow(pset, 2, 10, rng=random.Random(21))
    s = str(a)
    rfs = sorted(set(tok for tok in s.replace("(", ",").replace(")", ",")
                     .split(",") if tok.startswith("rf_")))
    other = "rf_30" if rfs[0] != "rf_30" else "rf_31"
    b = tgp.parse_tree(s.replace(rfs[0] + ",", other + ","), pset)
    assert tev.structure_key(a) == tev.structure_key(b) and str(a) != str(b)
    ra, rb = ev.evaluate_population([a, b], pset)
    assert ev.compilations == 1
    assert ra.convergence_factor != rb.convergence_factor
    assert ev.evaluate_population([b], pset)[0] == rb


def _small_problem():
    problem = tpoisson.poisson_2d(max_level=4, min_level=2)
    problem.dtype = np.float64
    return problem


def test_evolution_end_to_end(tmp_path):
    """mu = lambda = 4, two generations (tests/test_grammar_evolution.py:
    200-211): the best individual is finite and its grammar string
    re-evaluates.  Wall-time measurement is off (the fitness's time is
    then the iteration count): eager solves on the CPU make it the bulk of
    the run, and test_measure_interleaved_reports_each_structure covers
    it."""
    problem = _small_problem()
    evaluator = tev.CycleEvaluator(problem, device="cpu")
    evaluator.timing_enabled = False
    opt = Optimizer(problem, evaluator=evaluator,
                    rng=random.Random(2),
                    checkpoint_directory_path=str(tmp_path))
    result = opt.evolutionary_optimization(
        mu_=4, lambda_=4, population_initialization_factor=2,
        generations=2, verbose=False)
    expr, res = opt.generate_and_evaluate_program_from_grammar_representation(
        result["grammar_string"])
    assert res.convergence_factor < opt.infinity
    assert res.time_to_convergence_ms < opt.infinity


@pytest.mark.parametrize("case", ["canonicalize"])
def test_unported_options_raise(case, tmp_path):
    """What the port does not have yet raises NotImplementedError; it
    never runs silently."""
    problem = _small_problem()
    with pytest.raises(NotImplementedError):
        ev = tev.CycleEvaluator(problem, device="cpu")
        ev.canonicalize = True
        ev.evaluate_population([], _pset(tmg, problem))


def test_chain_without_cand_entities_raises():
    """A chain with no candidate entities raises the JAX package's
    ValueError (evaluator.py:67-68)."""
    problem = _small_problem()
    with pytest.raises(ValueError, match="requires cand_entities"):
        tev.CycleEvaluator(problem, device="cpu",
                           chain=[ChainLink(None, None, None)])
    with pytest.raises(ValueError, match="requires cand_entities"):
        jev.CycleEvaluator(jpoisson.poisson_2d(max_level=4, min_level=2),
                           chain=[object()])


def test_f32_measurement_window():
    """float32 measures convergence to 1e-5 and extrapolates the iteration
    count to the problem's target (evaluator.py:79-85, :385-394)."""
    problem = _small_problem()
    ev = tev.CycleEvaluator(problem, dtype=np.float32, device="cpu")
    ev.timing_enabled = False
    assert ev.measurement_reduction == 1e-5 and ev.target_reduction < 1e-5
    assert ev._b[0].dtype == torch.float32
    cycle = tcycles.v_cycle(problem.level_contexts, problem.rhs_entity,
                            pre_smoothing=2, post_smoothing=1, omega=1.15,
                            partitioning=tpart.RedBlack,
                            coarse_operator=problem.coarsest_operator)
    res = ev.evaluate_expression(cycle)
    rho = res.convergence_factor
    assert 0 < rho < 0.2
    assert res.iterations == np.ceil(np.log(ev.target_reduction) / np.log(rho))


def test_measure_interleaved_reports_each_structure():
    problem = _small_problem()
    ev = tev.CycleEvaluator(problem, device="cpu")
    ev.timing_window_sizes = (1, 2)
    cycles = [("rb", tcycles.v_cycle(
                  problem.level_contexts, problem.rhs_entity, pre_smoothing=2,
                  post_smoothing=1, omega=1.15, partitioning=tpart.RedBlack,
                  coarse_operator=problem.coarsest_operator)),
              ("jacobi", tcycles.v_cycle(
                  problem.level_contexts, problem.rhs_entity, pre_smoothing=2,
                  post_smoothing=1, omega=0.8, partitioning=tpart.Single,
                  coarse_operator=problem.coarsest_operator))]
    out = ev.measure_interleaved(cycles, reps=2)
    assert [r["key"] for r in out] == ["rb", "jacobi"]
    for r in out:
        lo, hi = r["ms_per_iter_spread"]
        assert 0 < lo <= r["ms_per_iter"] <= hi
        assert 0 < r["convergence_factor"] < 1
        # float64 measures to the target itself: no extrapolation
        assert r["time_to_convergence_ms"] == pytest.approx(
            r["ms_per_iter"] * r["iterations"], rel=1e-12)
    assert out[0]["convergence_factor"] < out[1]["convergence_factor"]


def test_cli_writes_results(tmp_path, capsys, monkeypatch):
    """``python -m evostencils_tpu_torch.optimize poisson2d --cpu`` on a
    small hierarchy writes best_grammar.txt and result.p, as
    scripts/optimize.py does (wall-time measurement off, as above)."""
    monkeypatch.setattr(tev.CycleEvaluator, "timing_enabled", False)
    result = toptimize.main(["poisson2d", "NSGAII", "--cpu", "--max-level",
                             "4", "--min-level", "2", "--mu", "4",
                             "--lambda", "4", "--generations", "1",
                             "--seed", "0", "--output", str(tmp_path)])
    best = (tmp_path / "best_grammar.txt").read_text().strip()
    assert best == result["grammar_string"]
    assert (tmp_path / "result.p").stat().st_size > 0
    assert "Best individual:" in capsys.readouterr().out


def test_cli_names_the_slice_of_unported_problems():
    """Every problem of scripts/optimize.py:27-57 is ported, so none names
    a later slice; an unknown one lists them all."""
    for name in ("poisson2d", "poisson3d", "poisson2d_var", "elasticity2d",
                 "helmholtz2d", "helmholtz2d_split", "fas2d"):
        assert toptimize.get_problem(name, 4, 3).max_level == 4
    with pytest.raises(SystemExit, match="unknown problem.*fas2d.*"
                       "helmholtz2d_split"):
        toptimize.get_problem("nonsense")
