"""The port's model-based evaluation (evostencils_tpu_torch/prediction and
the Optimizer's estimate path) against the JAX package on the CPU.

Both packages build their own problems and cycles; the port's LFA runs as
batched complex128 tensor programs on the CPU, the JAX package's on numpy
(``backend="numpy"``) or its C++ engine (``backend="native"``).
Tolerances, all in float64 / complex128:

* symbols: 1e-12 absolute (the same matrix algebra in another order);
* exact rho: rtol 1e-10 of numpy's eigenvalues (LAPACK zgeev both sides);
* the power method: rtol 1e-8 of the native engine's power method (the
  same squarings and iterations from the same start vector), and 1e-3 of
  the exact rho, the accuracy the engine claims for it;
* the Optimizer's estimates: rho to rtol 1e-10, the roofline runtime
  exactly (the same host arithmetic on the same IR walk), infinities
  where the JAX package has them.
"""

import dataclasses
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from evostencils_tpu.compiler import cycles as jcycles
from evostencils_tpu.evaluation import evaluator as jev
from evostencils_tpu.grammar import gp as jgp
from evostencils_tpu.grammar import multigrid as jmg
from evostencils_tpu.ir import partitioning as jpart
from evostencils_tpu.optimization.program import Optimizer as JOptimizer
from evostencils_tpu.prediction import convergence as jconv
from evostencils_tpu.prediction import performance as jperf
from evostencils_tpu.problems import elasticity as jelast
from evostencils_tpu.problems import poisson as jpoisson
from evostencils_tpu_torch import optimize as toptimize
from evostencils_tpu_torch.compiler import cycles as tcycles
from evostencils_tpu_torch.evaluation import evaluator as tev
from evostencils_tpu_torch.grammar import gp as tgp
from evostencils_tpu_torch.grammar import multigrid as tmg
from evostencils_tpu_torch.ir import partitioning as tpart
from evostencils_tpu_torch.ir import smoother as tsmoother
from evostencils_tpu_torch.optimization.program import Optimizer
from evostencils_tpu_torch.prediction import convergence as tconv
from evostencils_tpu_torch.prediction import lfa_backend as tlfa
from evostencils_tpu_torch.prediction import performance as tperf
from evostencils_tpu_torch.problems import elasticity as telast
from evostencils_tpu_torch.problems import poisson as tpoisson

#: the cases of tests/test_lfa.py:36-110 and the elasticity block system of
#: tests/test_native_lfa.py:41: name -> (problem, levels, partitioning,
#: omega, (pre, post), samples per axis)
CASES = {
    "jacobi-v11-2grid": ("poisson2d", (6, 5), "Single", 0.8, (1, 1), 16),
    "rb-v21-2grid": ("poisson2d", (6, 5), "RedBlack", 1.0, (2, 1), 16),
    "jacobi-v11-w0.5": ("poisson2d", (6, 5), "Single", 0.5, (1, 1), 12),
    "jacobi-v11-w1.4": ("poisson2d", (6, 5), "Single", 1.4, (1, 1), 12),
    "rb-v21-3grid": ("poisson2d", (7, 5), "RedBlack", 1.15, (2, 1), 8),
    "rb-v21-3d": ("poisson3d", (4, 3), "RedBlack", 1.15, (2, 1), 8),
    "elasticity-rb": ("elasticity2d", (6, 5), "RedBlack", 1.0, (2, 1), 8),
}
#: the power method's cases, at symbol order >= 64
POWER_CASES = {
    "rb-v21-8to5": ("poisson2d", (8, 5), "RedBlack", 1.15, (2, 1), 8),
    "jacobi-v21-8to5": ("poisson2d", (8, 5), "Single", 0.8, (2, 1), 8),
    "elasticity-rb-7to5": ("elasticity2d", (7, 5), "RedBlack", 1.0, (2, 1),
                           8),
}
#: the Optimizer's estimate path: genGrow(pset, 2, 40) seeds at
#: poisson_2d(5, 3)
ESTIMATE_SEEDS = range(40)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the symbols here are small, and the test
    run's parallel workers would otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _problem(package, name, levels):
    hi, lo = levels
    if name == "elasticity2d":
        mod = jelast if package == "jax" else telast
        return mod.linear_elasticity_2d(max_level=hi, min_level=lo)
    mod = jpoisson if package == "jax" else tpoisson
    fn = mod.poisson_3d if name == "poisson3d" else mod.poisson_2d
    return fn(max_level=hi, min_level=lo)


def _cycles(case):
    """The case's V-cycle in each package: (jax cycle, port cycle)."""
    name, levels, partitioning, omega, (pre, post), _ = case
    out = []
    for package, cycles, part in (("jax", jcycles, jpart),
                                  ("torch", tcycles, tpart)):
        problem = _problem(package, name, levels)
        out.append(cycles.v_cycle(
            problem.level_contexts, problem.rhs_entity, pre_smoothing=pre,
            post_smoothing=post, omega=omega,
            partitioning=getattr(part, partitioning),
            coarse_operator=problem.coarsest_operator))
    return out


def _dim(case):
    return 3 if case[0] == "poisson3d" else 2


@pytest.mark.parametrize("name", sorted(CASES))
def test_symbol_matches_jax(name):
    case = CASES[name]
    jc, tc = _cycles(case)
    d, s = _dim(case), case[-1]
    want = jconv.ConvergenceEvaluator(d, samples_per_axis=s,
                                      backend="numpy").symbol(jc)
    got = tconv.ConvergenceEvaluator(d, samples_per_axis=s,
                                     device="cpu").symbol(tc)
    assert got.dtype == torch.complex128 and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", sorted(CASES))
def test_exact_rho_matches_jax(name):
    case = CASES[name]
    jc, tc = _cycles(case)
    d, s = _dim(case), case[-1]
    want = jconv.ConvergenceEvaluator(
        d, samples_per_axis=s, backend="numpy").compute_spectral_radius(jc)
    got = tconv.ConvergenceEvaluator(
        d, samples_per_axis=s, device="cpu",
        rho_method="exact").compute_spectral_radius(tc)
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_smoother_symbol_matches_analytic():
    """tests/test_lfa.py:36-57 on the port: the Jacobi smoother's scalar
    symbol 1 - omega (4 - 2 cos tx - 2 cos ty) / 4."""
    problem = tpoisson.poisson_2d(max_level=5, min_level=4)
    omega = 0.8
    state = tcycles.smooth((problem.approximation, problem.rhs_entity),
                           problem.level_contexts[0], omega, tpart.Single)
    E = tconv.ConvergenceEvaluator(2, samples_per_axis=16,
                                   device="cpu").symbol(state[0]).numpy()
    assert E.shape[1:] == (1, 1)
    ctx = tconv._LfaContext(2, 5, 5, 16, lambda thetas: None)
    analytic = 1 - omega * (4 - 2 * np.cos(ctx.thetas[:, 0])
                            - 2 * np.cos(ctx.thetas[:, 1])) / 4
    np.testing.assert_allclose(E[:, 0, 0].real, analytic, rtol=1e-12)
    np.testing.assert_allclose(E[:, 0, 0].imag, 0, atol=1e-12)


def _native_power(dim, samples):
    """The JAX package's C++ engine with its power method forced."""
    from evostencils_tpu.native import lfa_engine_available
    if not lfa_engine_available():
        pytest.skip("the JAX package's native LFA engine is not built")
    from functools import partial
    from evostencils_tpu.prediction.native_lfa import NativeLfaBackend
    ev = jconv.ConvergenceEvaluator(dim, samples_per_axis=samples,
                                    backend="native")
    ev._backend_factory = partial(NativeLfaBackend, rho_method="power")
    return ev


@pytest.mark.parametrize("name", sorted(POWER_CASES))
def test_power_matches_native_engine(name):
    case = POWER_CASES[name]
    jc, tc = _cycles(case)
    d, s = _dim(case), case[-1]
    want = _native_power(d, s).compute_spectral_radius(jc)
    port = tconv.ConvergenceEvaluator(d, samples_per_axis=s, device="cpu",
                                      rho_method="power")
    got = port.compute_spectral_radius(tc)
    exact = tconv.ConvergenceEvaluator(
        d, samples_per_axis=s, device="cpu",
        rho_method="exact").compute_spectral_radius(tc)
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-8)
    np.testing.assert_allclose(got, exact, rtol=1e-3)


def test_power_rule():
    """"auto" takes the power method from order 128, "power" from 16
    (below, exact eigenvalues), as the native engine does."""
    thetas = np.zeros((1, 2))
    auto = tlfa.TorchLfaBackend(thetas, device="cpu")
    power = tlfa.TorchLfaBackend(thetas, device="cpu", rho_method="power")
    exact = tlfa.TorchLfaBackend(thetas, device="cpu", rho_method="exact")
    assert [auto.uses_power(n) for n in (64, 127, 128, 256)] == \
        [False, False, True, True]
    assert [power.uses_power(n) for n in (4, 15, 16, 64)] == \
        [False, False, True, True]
    assert not any(exact.uses_power(n) for n in (16, 128, 4096))
    with pytest.raises(ValueError):
        tlfa.TorchLfaBackend(thetas, device="cpu", rho_method="eig")


def test_engine_start_vector():
    """The start vector of lfa_engine.cpp:276-281, first entries worked
    by hand from seed 12345."""
    seed, want = 12345, []
    for _ in range(3):
        seed = (seed * 1664525 + 1013904223) % 2 ** 32
        want.append((seed // 256) / 2 ** 24 - 0.5)
    np.testing.assert_array_equal(tlfa.engine_start_vector(3), want)
    assert np.all(np.abs(tlfa.engine_start_vector(256)) <= 0.5)


@pytest.mark.parametrize("method", ["exact", "power"])
def test_chunked_frequencies_match_whole(method, monkeypatch):
    """A budget below one symbol's peak splits the frequencies into
    chunks; rho and the symbol do not change."""
    case = POWER_CASES["rb-v21-8to5"]
    _, tc = _cycles(case)
    whole = tconv.ConvergenceEvaluator(2, device="cpu", rho_method=method)
    rho = whole.compute_spectral_radius(tc)
    assert whole.last_backend.last_chunks == 1
    symbol = whole.symbol(tc).numpy()
    monkeypatch.setattr(tlfa, "MEMORY_BUDGET", 6 << 20)
    chunked = tconv.ConvergenceEvaluator(2, device="cpu", rho_method=method)
    np.testing.assert_allclose(chunked.compute_spectral_radius(tc), rho,
                               rtol=1e-13)
    assert chunked.last_backend.last_chunks > 1
    np.testing.assert_allclose(chunked.symbol(tc).numpy(), symbol, rtol=0,
                               atol=1e-15)


def test_peak_estimate_counts_live_values():
    """The chunk planner's peak: a product's inputs stay live while its
    output is made, an inverse counts its factorisation, and a value dies
    after its last reader."""
    be = tlfa.TorchLfaBackend(np.zeros((4, 2)), device="cpu")
    a = be.circulant(([0], [0], [[0.0, 0.0]], [1.0]), 0, 4)
    b = be.inv(a)
    c = be.matmul(a, b)
    order, last_use = be._schedule(c.ref)
    m = 4 * 4 * 16
    # a, then inv(a) and its factorisation beside a, then a @ inv(a) with
    # both inputs live, then the root and ``tail`` copies of it
    assert be._peak_per_theta(order, last_use, 0) == 3 * m
    assert be._peak_per_theta(order, last_use, 3) == 4 * m


def test_one_upload_per_run():
    """The frequencies, every leaf's tables and the power method's start
    vector reach the device as views of one buffer: one copy a run."""
    _, tc = _cycles(POWER_CASES["rb-v21-8to5"])
    ev = tconv.ConvergenceEvaluator(2, device="cpu", rho_method="power")
    ctx, h = ev._symbol_handle(tc)
    order, _ = ctx.backend._schedule(h.ref)
    start = ctx.backend._upload(order, tlfa.engine_start_vector(h.rows))
    leaves = [node for node in order if node.op in tlfa._TABLE_OPS]
    views = [t for node in leaves for t in node.tables]
    assert {"circulant", "transfer", "diag"} <= {n.op for n in leaves}
    storage = {v.untyped_storage().data_ptr()
               for v in views + [ctx.backend.thetas, start]}
    assert len(storage) == 1
    np.testing.assert_array_equal(start.numpy(),
                                  tlfa.engine_start_vector(h.rows))
    np.testing.assert_array_equal(ctx.backend.thetas.numpy(),
                                  ctx.backend.thetas_np)
    assert ctx.backend._upload(order) is None      # nothing left to send


def _singular_backend():
    return tlfa.TorchLfaBackend(np.full((2, 2), 0.3), device="cpu",
                                rho_method="exact")


def test_singular_inverse_raises_like_numpy():
    """inv_ex's info is read with rho: a singular symbol raises
    LinAlgError as numpy's inv does in the JAX package."""
    from evostencils_tpu.prediction.lfa_backend import NumpyLfaBackend
    for backend, error in ((_singular_backend(), torch.linalg.LinAlgError),
                           (NumpyLfaBackend(np.full((2, 2), 0.3)),
                            np.linalg.LinAlgError)):
        z = backend.zero(4, 4)
        with pytest.raises(error):
            backend.spectral_radius(backend.add(backend.identity(4),
                                                backend.inv(z)))


def test_non_finite_symbol_raises():
    be = _singular_backend()
    h = be.scale(float("inf"), be.identity(4))
    with pytest.raises(torch.linalg.LinAlgError):
        be.spectral_radius(h)


def test_shape_errors_raise_when_recorded():
    """Shapes are checked as the calls are recorded, raising what numpy
    raises for them (ValueError) or LinAlgError for a non-square
    inverse."""
    be = _singular_backend()
    a, b = be.zero(4, 2), be.zero(4, 4)
    with pytest.raises(ValueError):
        be.matmul(a, b)
    with pytest.raises(ValueError):
        be.add(a, b)
    with pytest.raises(torch.linalg.LinAlgError):
        be.inv(a)
    with pytest.raises(torch.linalg.LinAlgError):
        be.spectral_radius(a)


def test_backend_names():
    assert tconv.ConvergenceEvaluator(2, device="cpu").backend_name == \
        "torch"
    assert tconv.ConvergenceEvaluator(2, device="cpu", backend="torch") \
        .backend_name == "torch"
    with pytest.raises(NotImplementedError, match="native"):
        tconv.ConvergenceEvaluator(2, device="cpu", backend="native")
    with pytest.raises(ValueError):
        tconv.ConvergenceEvaluator(2, device="cpu", backend="numpy")


def test_device_errors_are_not_scored(monkeypatch):
    """An out-of-memory error (a RuntimeError) raises out of
    compute_spectral_radius; a LinAlgError scores 0.0."""
    _, tc = _cycles(CASES["rb-v21-2grid"])
    ev = tconv.ConvergenceEvaluator(2, device="cpu")

    def oom(self, h):
        raise torch.OutOfMemoryError("CUDA out of memory")
    monkeypatch.setattr(tlfa.TorchLfaBackend, "spectral_radius", oom)
    with pytest.raises(torch.OutOfMemoryError):
        ev.compute_spectral_radius(tc)

    def singular(self, h):
        raise torch.linalg.LinAlgError("singular")
    monkeypatch.setattr(tlfa.TorchLfaBackend, "spectral_radius", singular)
    assert ev.compute_spectral_radius(tc) == 0.0


def test_eigenvalues_match_jax():
    case = CASES["rb-v21-3grid"]
    jc, tc = _cycles(case)
    want = jconv.ConvergenceEvaluator(2, backend="numpy") \
        .compute_eigenvalues(jc)
    got = tconv.ConvergenceEvaluator(2, device="cpu") \
        .compute_eigenvalues(tc).numpy()
    np.testing.assert_allclose(np.sort(np.abs(got)), np.sort(np.abs(want)),
                               rtol=0, atol=1e-12)


# -- the roofline model ------------------------------------------------------

def test_machine_models():
    assert dataclasses.astuple(tperf.REFERENCE_CPU) == \
        dataclasses.astuple(jperf.REFERENCE_CPU)
    assert (tperf.H100.peak_flops, tperf.H100.bandwidth,
            tperf.H100.bytes_per_word) == (67e12, 3.35e12, 4)
    assert tperf.PerformanceEvaluator().machine is tperf.H100
    assert not hasattr(tperf, "TPU_V5E") and not hasattr(tperf, "TPU_V5P")


@pytest.mark.parametrize("name", ["jacobi-v11-2grid", "rb-v21-3grid",
                                  "rb-v21-3d", "elasticity-rb"])
def test_runtime_model_matches_jax(name):
    jc, tc = _cycles(CASES[name])
    want = jperf.PerformanceEvaluator(jperf.REFERENCE_CPU) \
        .estimate_runtime(jc)
    got = tperf.PerformanceEvaluator(tperf.REFERENCE_CPU) \
        .estimate_runtime(tc)
    assert got == want > 0


def test_h100_faster_than_reference_cpu():
    problem = tpoisson.poisson_2d(max_level=7, min_level=3)
    cycle = tcycles.v_cycle(problem.level_contexts, problem.rhs_entity,
                            omega=0.8, partitioning=tpart.Single,
                            smoother_factory=tsmoother
                            .generate_collective_jacobi,
                            coarse_operator=problem.coarsest_operator)
    t_cpu = tperf.PerformanceEvaluator(tperf.REFERENCE_CPU) \
        .estimate_runtime(cycle)
    t_card = tperf.PerformanceEvaluator(tperf.H100).estimate_runtime(cycle)
    assert 0 < t_card < t_cpu / 10


# -- the Optimizer's estimate path -------------------------------------------

def _small(package):
    mod = jpoisson if package == "jax" else tpoisson
    problem = mod.poisson_2d(max_level=5, min_level=3)
    problem.dtype = np.float64
    return problem


def _optimizers(tmp_path, rng_seed=0):
    """A model-based Optimizer of each package at poisson_2d(5, 3), both
    given PerformanceEvaluator(REFERENCE_CPU); the JAX one's LFA on
    numpy."""
    jp, tp = _small("jax"), _small("torch")
    jopt = JOptimizer(
        jp, evaluator=jev.CycleEvaluator(jp), model_based_estimation=True,
        convergence_evaluator=jconv.ConvergenceEvaluator(
            2, samples_per_axis=8, backend="numpy"),
        performance_evaluator=jperf.PerformanceEvaluator(
            jperf.REFERENCE_CPU),
        rng=random.Random(rng_seed),
        checkpoint_directory_path=str(tmp_path / "jax"))
    topt = Optimizer(
        tp, evaluator=tev.CycleEvaluator(tp, device="cpu"),
        model_based_estimation=True,
        performance_evaluator=tperf.PerformanceEvaluator(
            tperf.REFERENCE_CPU),
        rng=random.Random(rng_seed),
        checkpoint_directory_path=str(tmp_path / "torch"))
    return jopt, topt


def test_default_estimators(tmp_path):
    """model_based_estimation builds the LFA on the evaluator's device
    and prices cycles on the H100."""
    tp = _small("torch")
    opt = Optimizer(tp, evaluator=tev.CycleEvaluator(tp, device="cpu"),
                    model_based_estimation=True,
                    checkpoint_directory_path=str(tmp_path))
    assert opt.convergence_evaluator.device == torch.device("cpu")
    assert opt.convergence_evaluator.samples_per_axis == 8
    assert opt.performance_evaluator.machine is tperf.H100


def test_estimate_objectives_match_jax(tmp_path):
    jopt, topt = _optimizers(tmp_path)
    jpset, tpset = (mg.generate_primitive_set(
        p.approximation, p.rhs_entity, p.level_contexts,
        p.coarsest_operator)[0] for mg, p in ((jmg, jopt.problem),
                                              (tmg, topt.problem)))
    jopt._pset, topt._pset = jpset, tpset
    n_finite = 0
    for seed in ESTIMATE_SEEDS:
        ji = jgp.genGrow(jpset, 2, 40, rng=random.Random(seed))
        ti = tgp.genGrow(tpset, 2, 40, rng=random.Random(seed))
        assert str(ti) == str(ji)
        want = jopt._estimate_objectives(ji)
        got = topt._estimate_objectives(ti)
        if want[0] >= jopt.infinity:
            assert got == want, seed
            continue
        n_finite += 1
        np.testing.assert_allclose(got[0], want[0], rtol=1e-10,
                                   err_msg=f"seed {seed}")
        assert got[1] == want[1], seed
    assert n_finite >= 10


def test_model_based_evolution_matches_jax(tmp_path):
    """A model-based NSGA-II (mu = lambda = 4, 2 generations, seed 0) ends
    with the JAX package's best individual."""
    results = [opt.evolutionary_optimization(
        mu_=4, lambda_=4, generations=2, verbose=False)
        for opt in _optimizers(tmp_path)]
    jres, tres = results
    assert tres["grammar_string"] == jres["grammar_string"]
    assert tres["best_individual"].fitness.values[0] < 1


def test_cli_model_based_on_the_cpu(tmp_path):
    """``optimize poisson2d --model-based --cpu`` runs and writes its best
    individual, whose estimate the LFA reproduces."""
    out = tmp_path / "evo"
    result = toptimize.main(
        ["poisson2d", "--cpu", "--model-based", "--max-level", "5",
         "--min-level", "3", "--mu", "2", "--lambda", "2",
         "--generations", "1", "--seed", "0", "--output", str(out)])
    best = (out / "best_grammar.txt").read_text().strip()
    assert best == result["grammar_string"]
    rho, runtime = result["best_individual"].fitness.values
    assert 0 < rho < 1e50 and 0 < runtime < 1e50
