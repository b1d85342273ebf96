"""The port's variable-coefficient 2D Poisson evolution path against the
JAX package on the CPU: the grammar on ``poisson_2d_variable``, the
CycleEvaluator over variable-coefficient cycles, the lowering's
StencilField cache and the ``poisson2d_var`` CLI.

Both packages build their own ``poisson_2d_variable(8, 5)`` problem
(255^2, levels 8 -> 5) and primitive set, grow the same seeded individuals
and evaluate them in float64 with wall-time measurement off.  At 255^2 the
port runs the plain versions of the variable-coefficient kernels its gates
admit; the JAX package runs XLA, because its Pallas gates take float32
only.  rho is held to rtol 1e-6 above the share of the roundoff floor of
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
from evostencils_tpu_torch.compiler import lower as tlower
from evostencils_tpu_torch.evaluation import evaluator as tev
from evostencils_tpu_torch.grammar import gp as tgp
from evostencils_tpu_torch.grammar import multigrid as tmg
from evostencils_tpu_torch.ops.kernels import rbgs_var as trv
from evostencils_tpu_torch.optimization.program import Optimizer
from evostencils_tpu_torch.stencils import gallery as tgallery

from tests.test_torch_slice3d import JAX, PORT, _describe

#: genGrow seeds at 255^2, chosen among cheap ones: two that converge
#: (through the up-leg, and through both legs) and one that diverges
#: through the down-leg
SEEDS = (21, 35, 20)
#: hand-built cycles: (pre-sweeps, post-sweeps, partitioning, omega)
HAND = {"rb_v21": (2, 1, "RedBlack", 1.15),
        "jacobi_v21": (2, 1, "Single", 0.8),
        "rb_v44": (4, 4, "RedBlack", 1.15),
        "jacobi_v44": (4, 4, "Single", 0.8)}
PLAIN = ("fused_rbgs_sweep_var_plain", "jacobi_sweep_var_plain",
         "presmooth_residual_restrict_var_plain",
         "prolong_correct_postsmooth_var_plain")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the eager ops on these grids run as fast on
    one, and the test run's parallel workers would otherwise oversubscribe
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _problem(pkg, max_level=8, min_level=5):
    problem = pkg.problems.poisson_2d_variable(max_level=max_level,
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
    trv.reset_launches()
    with pytest.MonkeyPatch.context() as mp:
        for name in PLAIN:
            def counted(*a, _fn=getattr(trv, name), _name=name, **k):
                calls[_name] += 1
                return _fn(*a, **k)
            mp.setattr(trv, name, counted)
        port = et.evaluate_population(indt, pst)
        port += [et.evaluate_expression(_hand(PORT, pt, k)) for k in HAND]
    jax = ej.evaluate_population(indj, psj)
    jax += [ej.evaluate_expression(_hand(JAX, pj, k)) for k in HAND]
    return {"port": port, "jax": jax, "calls": calls,
            "launches": dict(trv.launches)}


def test_same_verdicts(runs):
    finite_j = [r.time_to_convergence_ms < 1e100 for r in runs["jax"]]
    finite_t = [r.time_to_convergence_ms < 1e100 for r in runs["port"]]
    assert finite_t == finite_j
    # two seeded individuals and the four hand-built cycles converge
    assert finite_j == [True, True, False] + [True] * len(HAND)


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
    """The evolved and hand-built cycles go through all four
    variable-coefficient kernels' dispatch; on the CPU that runs the plain
    versions and launches nothing."""
    for name in PLAIN:
        assert runs["calls"][name] > 0, (name, runs["calls"])
    assert set(runs["launches"].values()) == {0}


@pytest.mark.parametrize("seed", range(6))
def test_seeded_tree_compiles_to_the_same_ir(seed):
    """A seeded individual of the variable-coefficient problem is the same
    string in both packages and compiles to the same cycle IR node for
    node."""
    psj = _pset(jmg, _problem(JAX, 6, 3))
    pst = _pset(tmg, _problem(PORT, 6, 3))
    ij = jgp.genGrow(psj, 2, 40, rng=random.Random(seed))
    it = tgp.genGrow(pst, 2, 40, rng=random.Random(seed))
    assert str(it) == str(ij)
    dj = _describe(JAX, jgp.compile_tree(ij, psj)[0])
    dt = _describe(PORT, tgp.compile_tree(it, pst)[0])
    assert len(dt) == len(dj) > 20
    assert dt == dj


def test_stencil_field_cache_identity():
    """One generator and grid give back the same StencilField object,
    which the planner compares by identity; a new generator gets its own
    field even when it reuses a dead generator's id."""
    problem = _problem(PORT, 6, 3)
    op = problem.level_contexts[0].operator.entries[0][0]
    sf = tlower._stencil_field_of(op)
    assert tlower._stencil_field_of(op) is sf
    assert tlower._smoother_sig(problem.level_contexts[0].operator) == \
        ("var5", sf)
    other = tgallery.Poisson2DVariableCoefficients(
        coefficient=lambda x, y: 1.0 + 0.0 * x * y)
    key = (id(other), tuple(op.grid.size))
    # the cache holds a dead generator's entry under the new one's id
    tlower._STENCIL_FIELD_CACHE[key] = (op.stencil_generator, sf)
    try:
        fresh = tlower._stencil_field_of(
            type(op)("A", op.grid, other))
        assert fresh is not sf
        np.testing.assert_array_equal(
            fresh.fields[0],
            np.full(tuple(op.grid.size), 4.0 * 2 ** 12))
    finally:
        tlower._STENCIL_FIELD_CACHE.pop(key, None)


def test_cycle_plans_legs():
    """The planner finds the var5 legs of both partitionings: one down-leg
    and one up-leg per level of a V(2,1) (lower.py:469-510, :432-466)."""
    problem = _problem(PORT, 7, 5)
    for key in ("rb_v21", "jacobi_v21"):
        cycle = _hand(PORT, problem, key)
        _, by_mult = tlower._plan_super_fusions(cycle)
        posts = tlower._plan_post_fusions(cycle)
        assert len(by_mult) == len(posts) == 2
        for plan in list(by_mult.values()) + list(posts.values()):
            assert plan["kind"] == "var5"
            assert plan["red_black"] == (key == "rb_v21")


def test_cli_poisson2d_var(tmp_path, capsys, monkeypatch):
    """``python -m evostencils_tpu_torch.optimize poisson2d_var --cpu`` on
    levels 6 -> 3 writes a best individual that re-evaluates to a finite
    fitness (wall-time measurement off)."""
    monkeypatch.setattr(tev.CycleEvaluator, "timing_enabled", False)
    result = toptimize.main(["poisson2d_var", "NSGAII", "--cpu",
                             "--max-level", "6", "--min-level", "3", "--mu",
                             "4", "--lambda", "4", "--generations", "1",
                             "--seed", "3", "--output", str(tmp_path)])
    best = (tmp_path / "best_grammar.txt").read_text().strip()
    assert best == result["grammar_string"]
    assert "Best individual:" in capsys.readouterr().out
    problem = toptimize.get_problem("poisson2d_var", 6, 3)
    assert problem.name == "Poisson2DVar"
    problem.dtype = np.float64
    opt = Optimizer(problem,
                    evaluator=tev.CycleEvaluator(problem, device="cpu"),
                    rng=random.Random(0),
                    checkpoint_directory_path=str(tmp_path / "check"))
    _, res = opt.generate_and_evaluate_program_from_grammar_representation(
        best)
    assert 0 < res.convergence_factor < 1
    assert res.time_to_convergence_ms < opt.infinity


def test_cli_poisson2d_var_defaults():
    """poisson2d_var's default levels are scripts/optimize.py's: 9 -> 5;
    the problem no longer waits for a later slice."""
    assert not hasattr(toptimize, "LATER_SLICES")
    problem = toptimize.get_problem("poisson2d_var")
    assert (problem.max_level, problem.min_level) == (9, 5)
    assert tuple(problem.level_contexts[0].grid[0].size) == (511, 511)
