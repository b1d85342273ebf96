"""The port's 3D evolution path against the JAX package on the CPU: the
grammar on a 3D Poisson problem, the CycleEvaluator over 3D cycles and the
``poisson3d`` CLI.

Both packages build their own ``poisson_3d(6, 2)`` problem (63^3, levels
6 -> 2) and primitive set, grow the same seeded individuals and evaluate
them in float64 with wall-time measurement off.  At 63^3 the port runs
the plain versions of the 3D kernels that the JAX gates send the level
to; the JAX package runs XLA, because its Pallas gates take float32 only.
rho is held to rtol 1e-6 above the share of the roundoff floor of
1e-15 * ||b|| in its last entry, as tests/test_torch_evaluator.py holds it.
"""

import collections
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from evostencils_tpu.evaluation import evaluator as jev
from evostencils_tpu.grammar import gp as jgp
from evostencils_tpu.grammar import multigrid as jmg
from evostencils_tpu_torch import optimize as toptimize
from evostencils_tpu_torch.evaluation import evaluator as tev
from evostencils_tpu_torch.grammar import gp as tgp
from evostencils_tpu_torch.grammar import multigrid as tmg
from evostencils_tpu_torch.ops.kernels import leg3d as tleg
from evostencils_tpu_torch.ops.kernels import rbgs3d as trb
from evostencils_tpu_torch.optimization.program import Optimizer

from tests.test_torch_slice3d import JAX, PORT, _describe

#: genGrow seeds at 63^3: two that converge and one that does not, all
#: reaching the 3D kernels' plain versions, chosen among cheap ones
SEEDS = (6, 10, 13)
#: hand-built cycles: (pre-sweeps, post-sweeps, partitioning, omega)
HAND = {"rb_v21": (2, 1, "RedBlack", 1.15),
        "rb_v11": (1, 1, "RedBlack", 1.15),
        "jacobi_v21": (2, 1, "Single", 0.8)}
#: the plain versions that the cycles above reach at 63^3, by module (the
#: leg3d sweeps take 255^3 and up)
PLAIN = [(trb, "fused_rbgs_sweep_3d_plain"), (trb, "jacobi_sweep_3d_plain"),
         (tleg, "residual_restrict_3d_plain"),
         (tleg, "prolong_correct_3d_plain")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the eager ops on these grids run as fast on
    one, and the test run's parallel workers would otherwise oversubscribe
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _problem(pkg, max_level=6, min_level=2):
    problem = pkg.problems.poisson_3d(max_level=max_level,
                                      min_level=min_level)
    problem.dtype = np.float64
    return problem


def _pset(mg, problem):
    return mg.generate_primitive_set(problem.approximation,
                                     problem.rhs_entity,
                                     problem.level_contexts,
                                     problem.coarsest_operator)[0]


def _hand(pkg, problem, key):
    pre, post, partitioning, omega = HAND[key]
    return pkg.cycles.v_cycle(
        problem.level_contexts, problem.rhs_entity, pre_smoothing=pre,
        post_smoothing=post, omega=omega,
        partitioning=getattr(pkg.part, partitioning),
        coarse_operator=problem.coarsest_operator)


@pytest.fixture(scope="module")
def psets():
    return _pset(jmg, _problem(JAX)), _pset(tmg, _problem(PORT))


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
    trb.reset_launches()
    tleg.reset_launches()
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in PLAIN:
            def counted(*a, _fn=getattr(mod, name), _name=name, **k):
                calls[_name] += 1
                return _fn(*a, **k)
            mp.setattr(mod, name, counted)
        port = et.evaluate_population(indt, pst)
        port += [et.evaluate_expression(_hand(PORT, pt, k)) for k in HAND]
    jax = ej.evaluate_population(indj, psj)
    jax += [ej.evaluate_expression(_hand(JAX, pj, k)) for k in HAND]
    return {"port": port, "jax": jax, "calls": calls,
            "launches": dict(trb.launches, **tleg.launches)}


def test_same_verdicts(runs):
    finite_j = [r.time_to_convergence_ms < 1e100 for r in runs["jax"]]
    finite_t = [r.time_to_convergence_ms < 1e100 for r in runs["port"]]
    assert finite_t == finite_j
    # two seeded individuals and the three hand-built cycles converge
    assert sum(finite_j) == 5


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
    """The evolved and hand-built 3D cycles go through the 3D kernels'
    dispatch; on the CPU that runs the plain versions and launches
    nothing."""
    for _, name in PLAIN:
        assert runs["calls"][name] > 0, (name, runs["calls"])
    assert set(runs["launches"].values()) == {0}


@pytest.mark.parametrize("seed", range(8))
def test_seeded_tree_compiles_to_the_same_ir(psets, seed):
    """A seeded 3D individual is the same string in both packages and
    compiles to the same cycle IR node for node."""
    psj, pst = psets
    ij = jgp.genGrow(psj, 2, 40, rng=random.Random(seed))
    it = tgp.genGrow(pst, 2, 40, rng=random.Random(seed))
    assert str(it) == str(ij)
    dj = _describe(JAX, jgp.compile_tree(ij, psj)[0])
    dt = _describe(PORT, tgp.compile_tree(it, pst)[0])
    assert len(dt) == len(dj) > 20
    assert dt == dj


def test_cli_poisson3d(tmp_path, capsys, monkeypatch):
    """``python -m evostencils_tpu_torch.optimize poisson3d --cpu`` on
    levels 5 -> 2 ends with a best individual that re-evaluates to a finite
    fitness (wall-time measurement off)."""
    monkeypatch.setattr(tev.CycleEvaluator, "timing_enabled", False)
    result = toptimize.main(["poisson3d", "NSGAII", "--cpu", "--max-level",
                             "5", "--min-level", "2", "--mu", "4",
                             "--lambda", "4", "--generations", "1",
                             "--seed", "5", "--output", str(tmp_path)])
    best = (tmp_path / "best_grammar.txt").read_text().strip()
    assert best == result["grammar_string"]
    assert "Best individual:" in capsys.readouterr().out
    problem = toptimize.get_problem("poisson3d", 5, 2)
    assert problem.dimension == 3
    problem.dtype = np.float64
    opt = Optimizer(problem,
                    evaluator=tev.CycleEvaluator(problem, device="cpu"),
                    rng=random.Random(0),
                    checkpoint_directory_path=str(tmp_path / "check"))
    _, res = opt.generate_and_evaluate_program_from_grammar_representation(
        best)
    assert 0 < res.convergence_factor < 1
    assert res.time_to_convergence_ms < opt.infinity


def test_cli_poisson3d_defaults():
    """poisson3d's default levels are scripts/optimize.py's: 6 -> 2."""
    problem = toptimize.get_problem("poisson3d")
    assert (problem.max_level, problem.min_level) == (6, 2)
    assert tuple(problem.level_contexts[0].grid[0].size) == (63, 63, 63)
