"""The port's linear elasticity evolution path against the JAX package on
the CPU: the problem and its right-hand side, the grammar on
``linear_elasticity_2d``, the CycleEvaluator over coupled (u, v) cycles,
the stored champions, and the ``elasticity2d`` CLI.

Both packages build their own ``linear_elasticity_2d(8, 4)`` problem
(255^2, levels 8 -> 4) and primitive set, grow the same seeded individuals
and evaluate them in float64 with wall-time measurement off.  At 255^2 the
port runs the plain versions of the system kernels its gates admit; the
JAX package runs XLA, because its Pallas gates take float32 only.  rho is
held to rtol 1e-6 above the share of the roundoff floor of 1e-15 * ||b||
in its last entry, as tests/test_torch_evaluator.py holds it.

Every individual the JAX package can lower, the port must lower and step:
an individual the port cannot lower would score infinity without a word
and evolution would part from the reference.  "The JAX package lowers" is
decided by tracing its step with ``jax.eval_shape``, which compiles
nothing.
"""

import collections
import json
import pathlib
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from evostencils_tpu.compiler import lower as jlower
from evostencils_tpu.evaluation import evaluator as jev
from evostencils_tpu.grammar import gp as jgp
from evostencils_tpu.grammar import multigrid as jmg
from evostencils_tpu_torch import optimize as toptimize
from evostencils_tpu_torch.compiler import lower as tlower
from evostencils_tpu_torch.evaluation import evaluator as tev
from evostencils_tpu_torch.grammar import gp as tgp
from evostencils_tpu_torch.grammar import multigrid as tmg
from evostencils_tpu_torch.ops.kernels import rbgs_sys as trs
from evostencils_tpu_torch.optimization.program import Optimizer
from evostencils_tpu_torch.problems.poisson import build_rhs

from tests.test_torch_slice3d import _describe
from tests.test_torch_sys import JAX, PORT, CHAMPION_KEY, CHAMPIONS

#: genGrow seeds at 255^2, chosen among cheap ones: two that converge and
#: one that does not reach the target in 100 cycles
SEEDS = (12, 23, 17)
#: hand-built V(2,1) cycles: (partitioning, omega)
HAND = {"rb_v21": ("RedBlack", 1.25), "jacobi_v21": ("Single", 0.8)}
PLAIN = ("fused_rbgs_sweep_sys_plain", "jacobi_sweep_sys_plain",
         "presmooth_residual_restrict_sys_plain",
         "prolong_correct_postsmooth_sys_plain")
#: the "JAX lowers => the port lowers" probe: genGrow seeds on
#: linear_elasticity_2d(5, 3), and the stored champions at their levels
PROBE_SEEDS = range(40)
PROBE_LEVELS = (5, 3)
CHAMPION_LEVELS = (8, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the eager ops on these grids run as fast on
    one, and the test run's parallel workers would otherwise oversubscribe
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _problem(pkg, max_level=8, min_level=4):
    problem = pkg.problems.linear_elasticity_2d(max_level=max_level,
                                                min_level=min_level)
    problem.dtype = np.float64
    return problem


def _pset(mg, problem):
    return mg.generate_primitive_set(problem.approximation,
                                     problem.rhs_entity,
                                     problem.level_contexts,
                                     problem.coarsest_operator)[0]


def _hand(pkg, problem, key):
    partitioning, omega = HAND[key]
    return pkg.cycles.v_cycle(
        problem.level_contexts, problem.rhs_entity, pre_smoothing=2,
        post_smoothing=1, omega=omega,
        partitioning=getattr(pkg.part, partitioning),
        coarse_operator=problem.coarsest_operator)


def _champions():
    return [e["grammar"] for e in json.loads(CHAMPIONS.read_text())
            [CHAMPION_KEY]]


def test_problem_and_rhs_match_jax():
    """The copied problem: the same names, fields and levels, and a
    right-hand side equal bit for bit in float64 (b_u folds the v boundary
    data through block (0, 1), b_v through block (1, 1))."""
    pj, pt = _problem(JAX, 6, 3), _problem(PORT, 6, 3)
    assert (pt.name, pt.fields, pt.max_level, pt.min_level,
            pt.target_reduction, pt.max_iterations) == \
        (pj.name, pj.fields, pj.max_level, pj.min_level,
         pj.target_reduction, pj.max_iterations)
    b = build_rhs(pt, dtype=torch.float64, device="cpu")
    want = pj.rhs_builder(jnp.float64)
    assert len(b) == len(want) == 2
    for x, y in zip(b, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert float(b[1].abs().max()) > 0.0
    assert (PORT.problems.LAMBDA, PORT.problems.MU) == \
        (JAX.problems.LAMBDA, JAX.problems.MU)


@pytest.fixture(scope="module")
def runs():
    """Both evaluators over the seeded individuals and the hand-built
    cycles; the port's run counts its calls of the plain versions."""
    pj, pt = _problem(JAX), _problem(PORT)
    psj, pst = _pset(jmg, pj), _pset(tmg, pt)
    ej = jev.CycleEvaluator(pj)
    et = tev.CycleEvaluator(pt, device="cpu")
    ej.timing_enabled = et.timing_enabled = False
    indj = [jgp.genGrow(psj, 2, 40, rng=random.Random(s)) for s in SEEDS]
    indt = [tgp.genGrow(pst, 2, 40, rng=random.Random(s)) for s in SEEDS]
    assert [str(i) for i in indt] == [str(i) for i in indj]

    calls = collections.Counter()
    trs.reset_launches()
    with pytest.MonkeyPatch.context() as mp:
        for name in PLAIN:
            def counted(*a, _fn=getattr(trs, name), _name=name, **k):
                calls[_name] += 1
                return _fn(*a, **k)
            mp.setattr(trs, name, counted)
        port = et.evaluate_population(indt, pst)
        port += [et.evaluate_expression(_hand(PORT, pt, k)) for k in HAND]
    jax_ = ej.evaluate_population(indj, psj)
    jax_ += [ej.evaluate_expression(_hand(JAX, pj, k)) for k in HAND]
    return {"port": port, "jax": jax_, "calls": calls,
            "launches": dict(trs.launches)}


def test_same_verdicts(runs):
    finite_j = [r.time_to_convergence_ms < 1e100 for r in runs["jax"]]
    finite_t = [r.time_to_convergence_ms < 1e100 for r in runs["port"]]
    assert finite_t == finite_j
    assert finite_j == [True, True, False] + [True] * len(HAND)


def test_equal_iterations(runs):
    assert [r.iterations for r in runs["port"]] == \
        [r.iterations for r in runs["jax"]]


def test_rho_matches(runs):
    for rt, rj in zip(runs["port"], runs["jax"]):
        rho_j, rho_t = rj.convergence_factor, rt.convergence_factor
        tol = 1e-6
        if rj.time_to_convergence_ms < 1e100 and 0 < rho_j < 1:
            k = rj.iterations
            tol += 1e-15 / rho_j ** k / k      # floor share of the last entry
        assert abs(rho_t - rho_j) <= tol * rho_j, (rho_t, rho_j)


def test_kernel_plain_versions_reached(runs):
    """The evaluated cycles go through both system legs and a standalone
    system sweep; on the CPU that runs the plain versions and launches
    nothing."""
    for name in PLAIN[2:]:
        assert runs["calls"][name] > 0, (name, runs["calls"])
    assert runs["calls"][PLAIN[0]] + runs["calls"][PLAIN[1]] > 0
    assert set(runs["launches"].values()) == {0}


@pytest.mark.parametrize("index", range(8))
def test_champion_compiles_to_the_same_ir(index):
    """Each stored elasticity champion parses in both packages and
    compiles to the same cycle IR, node for node."""
    grammar = _champions()[index]
    psj = _pset(jmg, _problem(JAX, *CHAMPION_LEVELS))
    pst = _pset(tmg, _problem(PORT, *CHAMPION_LEVELS))
    ij, it = jgp.parse_tree(grammar, psj), tgp.parse_tree(grammar, pst)
    assert str(it) == str(ij) == grammar
    dj = _describe(JAX, jgp.compile_tree(ij, psj)[0])
    dt = _describe(PORT, tgp.compile_tree(it, pst)[0])
    assert len(dt) == len(dj) > 50
    assert dt == dj


_PROBE = {}


def _probe_setup(levels):
    """Both packages' problem and primitive set, and the port's b, once
    per level pair."""
    if levels not in _PROBE:
        pj, pt = _problem(JAX, *levels), _problem(PORT, *levels)
        _PROBE[levels] = (pj, pt, _pset(jmg, pj), _pset(tmg, pt),
                          build_rhs(pt, dtype=torch.float64, device="cpu"))
    return _PROBE[levels]


def _jax_lowers(problem, expr) -> bool:
    """Whether the JAX package lowers ``expr`` and traces one step."""
    try:
        lowered = jlower.lower_cycle(expr, problem.approximation,
                                     problem.rhs_entity)
        spec = tuple(jax.ShapeDtypeStruct(tuple(g.size), jnp.float64)
                     for g in problem.level_contexts[0].grid)
        jax.eval_shape(lowered.step, spec, spec, jax.ShapeDtypeStruct(
            lowered.default_omegas.shape, jnp.float64))
    except NotImplementedError:
        return False
    return True


@pytest.mark.parametrize("case", [f"seed{s}" for s in PROBE_SEEDS]
                         + [f"champion{i}" for i in range(8)])
def test_jax_lowers_implies_port_lowers(case):
    """Seeds 0-39 of genGrow(pset, 2, 40) on linear_elasticity_2d(5, 3),
    and the 8 stored champions at 255^2: where the JAX package lowers an
    individual, the port lowers it and takes one float64 step, which
    keeps the fields' shapes."""
    if case.startswith("seed"):
        pj, pt, psj, pst, b = _probe_setup(PROBE_LEVELS)
        rng = int(case[4:])
        ij = jgp.genGrow(psj, 2, 40, rng=random.Random(rng))
        it = tgp.genGrow(pst, 2, 40, rng=random.Random(rng))
    else:
        pj, pt, psj, pst, b = _probe_setup(CHAMPION_LEVELS)
        grammar = _champions()[int(case[8:])]
        ij, it = jgp.parse_tree(grammar, psj), tgp.parse_tree(grammar, pst)
    assert str(it) == str(ij)
    if not _jax_lowers(pj, jgp.compile_tree(ij, psj)[0]):
        pytest.fail(f"the JAX package does not lower {case}; the probe "
                    "expects every one of its individuals to lower")
    lowered = tlower.lower_cycle(tgp.compile_tree(it, pst)[0],
                                 pt.approximation, pt.rhs_entity)
    out = lowered.step(tuple(torch.zeros_like(x) for x in b), b,
                       torch.tensor(lowered.default_omegas))
    assert [tuple(o.shape) for o in out] == [tuple(x.shape) for x in b]
    assert all(o.dtype == torch.float64 for o in out)


def test_cli_elasticity2d(tmp_path, capsys, monkeypatch):
    """``python -m evostencils_tpu_torch.optimize elasticity2d --cpu`` on
    levels 6 -> 3 writes a best individual that re-evaluates to a finite
    fitness (wall-time measurement off)."""
    monkeypatch.setattr(tev.CycleEvaluator, "timing_enabled", False)
    result = toptimize.main(["elasticity2d", "NSGAII", "--cpu",
                             "--max-level", "6", "--min-level", "3", "--mu",
                             "4", "--lambda", "4", "--generations", "1",
                             "--seed", "3", "--output", str(tmp_path)])
    best = (tmp_path / "best_grammar.txt").read_text().strip()
    assert best == result["grammar_string"]
    assert "Best individual:" in capsys.readouterr().out
    problem = toptimize.get_problem("elasticity2d", 6, 3)
    assert problem.name == "LinearElasticity2D"
    problem.dtype = np.float64
    opt = Optimizer(problem,
                    evaluator=tev.CycleEvaluator(problem, device="cpu"),
                    rng=random.Random(0),
                    checkpoint_directory_path=str(tmp_path / "check"))
    _, res = opt.generate_and_evaluate_program_from_grammar_representation(
        best)
    assert 0 < res.convergence_factor < 1
    assert res.time_to_convergence_ms < opt.infinity


def test_cli_elasticity2d_defaults():
    """elasticity2d's default levels are scripts/optimize.py's: 8 -> 4; the
    problem no longer waits for a later slice."""
    assert not hasattr(toptimize, "LATER_SLICES")
    problem = toptimize.get_problem("elasticity2d")
    assert (problem.max_level, problem.min_level) == (8, 4)
    assert [tuple(g.size) for g in problem.level_contexts[0].grid] == \
        [(255, 255)] * 2
