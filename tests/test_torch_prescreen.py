"""The port's small-grid prescreen (evostencils_tpu_torch/optimization/
prescreen.py) against the JAX package's on the CPU, on the cases of
tests/test_prescreen.py:27-107.

Both screens measure the transferred trees on their own small problem in
float64 with wall-time measurement off.  A verdict is None (the candidate
survives) or the small-grid rho it was rejected at; the verdicts must
agree in kind, and a rejected rho to the evaluators' own agreement on
measured rho (tests/test_torch_evaluator.py): rtol 1e-6, plus the
roundoff floor's share 1e-15 / rho^k / k where a solve of k iterations
reached its target.
"""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from evostencils_tpu.compiler import cycles as jcycles
from evostencils_tpu.grammar import gp as jgp
from evostencils_tpu.grammar import multigrid as jmg
from evostencils_tpu.ir import partitioning as jpart
from evostencils_tpu.ir import transformations as jtrans
from evostencils_tpu.optimization.prescreen import \
    SmallGridPrescreen as JPrescreen
from evostencils_tpu.problems import poisson as jpoisson
from evostencils_tpu_torch.compiler import cycles as tcycles
from evostencils_tpu_torch.evaluation import evaluator as tev
from evostencils_tpu_torch.grammar import gp as tgp
from evostencils_tpu_torch.grammar import multigrid as tmg
from evostencils_tpu_torch.ir import partitioning as tpart
from evostencils_tpu_torch.ir import transformations as ttrans
from evostencils_tpu_torch.optimization.prescreen import SmallGridPrescreen
from evostencils_tpu_torch.optimization.program import Optimizer
from evostencils_tpu_torch.problems import poisson as tpoisson

#: rtol of a measured small-grid rho between the packages, above the
#: roundoff floor's share
RHO_RTOL = 1e-6


def _rho_tolerance(rho, iterations):
    """RHO_RTOL, plus the floor's share of the last history entry of a
    converged solve of ``iterations`` cycles (test_torch_evaluator.py)."""
    tol = RHO_RTOL
    if np.isfinite(iterations) and iterations < 1e99 and 0 < rho < 1:
        tol += 1e-15 / rho ** iterations / iterations
    return tol


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the small grids run as fast on one, and the
    test run's parallel workers would otherwise oversubscribe the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _poisson(package, hi, lo):
    mod = jpoisson if package == "jax" else tpoisson
    problem = mod.poisson_2d(max_level=hi, min_level=lo)
    problem.dtype = np.float64
    return problem


def _pset(mg, problem):
    return mg.generate_primitive_set(
        problem.approximation, problem.rhs_entity, problem.level_contexts,
        problem.coarsest_operator)[0]


def _screens(full, small, rho_cap=0.9):
    """Each package's prescreen of ``small`` attached to its pset of
    ``full``: ((jax screen, jax pset), (port screen, port pset))."""
    out = []
    for package, mg, make in (("jax", jmg, JPrescreen),
                              ("torch", tmg, SmallGridPrescreen)):
        kw = {} if package == "jax" else {"device": "cpu"}
        pre = make(_poisson(package, *small), rho_cap=rho_cap, **kw)
        pset = _pset(mg, _poisson(package, *full))
        out.append((pre, pset))
    return out


def _verdicts_agree(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None), (i, g, w)
        if w is not None:
            np.testing.assert_allclose(g, w, rtol=RHO_RTOL,
                                       err_msg=f"individual {i}")


def test_verdicts_match_jax():
    """tests/test_prescreen.py:27-52: 12 seeded individuals of the
    poisson_2d(7, 3) grammar screened at poisson_2d(5, 1)."""
    (jpre, jpset), (tpre, tpset) = _screens((7, 3), (5, 1))
    assert jpre.attach(jpset) and tpre.attach(tpset)
    jrng, trng = random.Random(7), random.Random(7)
    jinds = [jgp.genGrow(jpset, 0, 50, rng=jrng) for _ in range(12)]
    tinds = [tgp.genGrow(tpset, 0, 50, rng=trng) for _ in range(12)]
    assert [str(i) for i in tinds] == [str(i) for i in jinds]
    want = jpre.screen(jinds, jpset)
    got = tpre.screen(tinds, tpset)
    _verdicts_agree(got, want)
    assert tpre.screened == jpre.screened == 12
    assert tpre.rejected == jpre.rejected < 12


def _v21(problem, cycles, part, partitioning, omega, pre=2, post=1):
    return cycles.v_cycle(problem.level_contexts, problem.rhs_entity,
                          pre_smoothing=pre, post_smoothing=post,
                          omega=omega,
                          partitioning=getattr(part, partitioning),
                          coarse_operator=problem.coarsest_operator)


@pytest.mark.parametrize("which", ["reference", "divergent"])
def test_reference_cycle_and_divergent_smoother(which):
    """tests/test_prescreen.py:55-78: the RB V(2,1) (omega 1.15) passes
    the small grid's measurement, an over-relaxed Jacobi V(1,0) (omega
    1.99) is hopeless; the port's measured rho agrees with the JAX
    package's."""
    args = {"reference": ("RedBlack", 1.15, 2, 1),
            "divergent": ("Single", 1.99, 1, 0)}[which]
    results = []
    for package, cycles, part, trans, make in (
            ("jax", jcycles, jpart, jtrans, JPrescreen),
            ("torch", tcycles, tpart, ttrans, SmallGridPrescreen)):
        small = _poisson(package, 5, 1)
        kw = {} if package == "jax" else {"device": "cpu"}
        ev = make(small, rho_cap=0.9, **kw).evaluator
        cycle = _v21(small, cycles, part, *args)
        trans.assign_cycle_ids(cycle)
        results.append((ev, ev.evaluate_expression(cycle, key=which)))
    (jev_, jres), (tev_, tres) = results
    hopeless = [res.iterations >= ev.infinity
                or res.convergence_factor > 0.9 for ev, res in results]
    assert hopeless[0] == hopeless[1] == (which == "divergent")
    if which == "reference":
        assert tres.convergence_factor < 0.2
        np.testing.assert_allclose(
            tres.convergence_factor, jres.convergence_factor,
            rtol=_rho_tolerance(jres.convergence_factor, jres.iterations))


def test_detaches_on_incompatible_pset():
    """tests/test_prescreen.py:81-90: a small problem of fewer levels
    gives another grammar shape; the screen passes everyone through."""
    (jpre, jpset), (tpre, tpset) = _screens((7, 3), (4, 1))
    assert not tpre.attach(tpset) and not jpre.attach(jpset)
    rng = random.Random(3)
    inds = [tgp.genGrow(tpset, 0, 50, rng=rng) for _ in range(3)]
    assert tpre.screen(inds, tpset) == [None, None, None]
    assert tpre.screened == 0


def test_default_device_is_the_card(monkeypatch):
    """The screen measures where the real evaluator does: the card unless
    the caller asks for the CPU."""
    devices = []

    class Recorder:
        def __init__(self, problem, *, max_iterations=None, device):
            devices.append(device)
    monkeypatch.setattr(tev, "CycleEvaluator", Recorder)
    small = _poisson("torch", 4, 1)
    SmallGridPrescreen(small)
    SmallGridPrescreen(small, device="cpu")
    assert devices == ["cuda", "cpu"]


def test_optimizer_with_prescreen(tmp_path):
    """tests/test_prescreen.py:93-107 on the port: an evolution whose
    offspring pass the screen first; rejects never reach the full-size
    evaluator, and the best individual is finite."""
    full = _poisson("torch", 6, 2)
    pre = SmallGridPrescreen(_poisson("torch", 5, 1), rho_cap=0.9,
                             device="cpu")
    evaluator = tev.CycleEvaluator(full, device="cpu")
    evaluator.timing_enabled = False
    measured = []
    population = evaluator.evaluate_population

    def counted(individuals, pset):
        measured.extend(individuals)
        return population(individuals, pset)
    evaluator.evaluate_population = counted
    opt = Optimizer(full, evaluator=evaluator, rng=random.Random(11),
                    prescreen=pre,
                    checkpoint_directory_path=str(tmp_path))
    result = opt.evolutionary_optimization(
        mu_=4, lambda_=4, population_initialization_factor=2,
        generations=2, verbose=False)
    assert pre.screened == opt.total_evaluations > 0
    assert len(measured) == opt.total_evaluations - pre.rejected
    vals = result["best_individual"].fitness.values
    assert all(np.isfinite(v) and v < 1e50 for v in vals)


def test_failed_screen_measures_everything(tmp_path, capsys):
    """A screen that raises never stops the real evaluation
    (program.py's copied guard): every candidate is measured."""
    full = _poisson("torch", 5, 2)

    class Broken:
        def screen(self, individuals, pset):
            raise RuntimeError("screen broke")
    evaluator = tev.CycleEvaluator(full, device="cpu")
    evaluator.timing_enabled = False
    opt = Optimizer(full, evaluator=evaluator, rng=random.Random(0),
                    prescreen=Broken(),
                    checkpoint_directory_path=str(tmp_path))
    result = opt.evolutionary_optimization(
        mu_=2, lambda_=2, population_initialization_factor=1,
        generations=1, verbose=False)
    assert "prescreen failed (screen broke)" in capsys.readouterr().out
    assert result["best_individual"] is not None
