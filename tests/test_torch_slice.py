"""The port's main path, the 2D Poisson V(2,1) cycle
(evostencils_tpu_torch/compiler), against the JAX package on the CPU.

Levels of at least 129 rows run the fused legs: the Pallas kernels in
interpret mode on the JAX side, their plain PyTorch versions in the port.
"""

import os
import pathlib
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from evostencils_tpu.compiler import cycles as jcycles
from evostencils_tpu.compiler import lower as jlower
from evostencils_tpu.compiler import solve as jsolve
from evostencils_tpu.config import config
from evostencils_tpu.ir import partitioning as jpart
from evostencils_tpu.problems import poisson as jpoisson
from evostencils_tpu_torch.compiler import cycles as tcycles
from evostencils_tpu_torch.compiler import lower as tlower
from evostencils_tpu_torch.compiler import solve as tsolve
from evostencils_tpu_torch.convert import state_from_numpy
from evostencils_tpu_torch.ir import partitioning as tpart
from evostencils_tpu_torch.ops.kernels import transfer as ttransfer
from evostencils_tpu_torch.problems import poisson as tpoisson
from evostencils_tpu_torch.problems.poisson import build_rhs

#: the layers each package builds its own problem and cycle IR from
JAX = SimpleNamespace(problems=jpoisson, cycles=jcycles, part=jpart)
PORT = SimpleNamespace(problems=tpoisson, cycles=tcycles, part=tpart)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the eager ops on these grids run as fast on
    one, and the test run's parallel workers would otherwise oversubscribe
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _v21(pkg, max_level, min_level, dtype, **cycle_kw):
    """A fresh problem and its V(2,1) cycle, as bench.py:48-58 builds
    them, from the layers of one package (each package builds and lowers
    its own IR)."""
    problem = pkg.problems.poisson_2d(max_level=max_level,
                                      min_level=min_level)
    problem.dtype = dtype
    cycle = pkg.cycles.v_cycle(
        problem.level_contexts, problem.rhs_entity, pre_smoothing=2,
        post_smoothing=1, omega=1.15, partitioning=pkg.part.RedBlack,
        coarse_operator=problem.coarsest_operator, **cycle_kw)
    return problem, cycle


def _lower_both(max_level, min_level, dtype):
    pj, cj = _v21(JAX, max_level, min_level, dtype)
    pt, ct = _v21(PORT, max_level, min_level, dtype)
    lj = jlower.lower_cycle(cj, pj.approximation, pj.rhs_entity)
    lt = tlower.lower_cycle(ct, pt.approximation, pt.rhs_entity)
    np.testing.assert_array_equal(lt.default_omegas, lj.default_omegas)
    return pj, lj, pt, lt


def test_step_matches_pallas_interpret_f32(monkeypatch):
    """(a) one V(2,1) step at 255^2 in float32 against the JAX fused path
    (Pallas kernels in interpret mode); atol 1e-5 as
    tests/test_fused_columns.py grants that path."""
    pj, lj, pt, lt = _lower_both(8, 5, np.float32)
    b = pj.build_rhs()
    u0 = tuple(jnp.zeros_like(x) for x in b)
    old = config.use_pallas_kernels
    config.use_pallas_kernels = True
    try:
        ref = lj.step(u0, b, jnp.asarray(lj.default_omegas, jnp.float32))
    finally:
        config.use_pallas_kernels = old

    calls = {"down": 0, "up": 0}
    down, up = (ttransfer.presmooth_residual_restrict_plain,
                ttransfer.prolong_correct_postsmooth_col_plain)

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(ttransfer, "presmooth_residual_restrict_plain",
                        count("down", down))
    monkeypatch.setattr(ttransfer, "prolong_correct_postsmooth_col_plain",
                        count("up", up))
    u, bt, om = state_from_numpy([np.asarray(x) for x in u0],
                                 [np.asarray(x) for x in b],
                                 lj.default_omegas, device="cpu",
                                 dtype=torch.float32)
    out = lt.step(u, bt, om)
    assert calls == {"down": 1, "up": 1}     # the 255^2 level's two legs
    assert out[0].dtype == torch.float32
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), atol=1e-5)
    assert float(out[0].abs().max()) > 0


@pytest.mark.parametrize("max_level", [7, 8])
def test_solve_matches_xla_f64(max_level):
    """(b) solve to 1e-10 in float64 against the JAX XLA path (unfused
    half-sweeps): equal iteration counts, histories and rho to 1e-6.

    At 127^2 every node of the two cycles is bitwise equal except the
    dense coarse matvec, which BLAS and XLA sum in different orders.  That
    leaves each history entry about 3e-17 * ||b|| apart, the roundoff floor
    of b - Au, and the last entry (2.9e-11 * ||b||) 1.1e-6 of its value
    apart.  So the histories must agree to rtol 1e-6 above an absolute
    floor of 1e-15 * ||b|| (= history[0])."""
    pj, lj, pt, lt = _lower_both(max_level, 5, np.float64)
    b = pj.build_rhs()
    u0 = tuple(jnp.zeros_like(x) for x in b)
    old = config.use_pallas_kernels
    config.use_pallas_kernels = False
    try:
        _, kj, hj = jsolve.make_solver(lj, 40, 1e-10)(
            u0, b, jnp.asarray(lj.default_omegas))
        kj, hj = int(kj), np.asarray(hj)
    finally:
        config.use_pallas_kernels = old

    bt = build_rhs(pt, dtype=torch.float64, device="cpu")
    ut = tuple(torch.zeros_like(x) for x in bt)
    om = torch.tensor(lt.default_omegas, dtype=torch.float64)
    _, kt, ht = tsolve.make_solver(lt, 40, 1e-10)(ut, bt, om)
    ht = ht.numpy()
    assert kt == kj and 0 < kt < 40
    np.testing.assert_allclose(ht, hj, rtol=1e-6, atol=1e-15 * hj[0])
    rho_t = (ht[kt] / ht[0]) ** (1 / kt)
    rho_j = (hj[kj] / hj[0]) ** (1 / kj)
    assert abs(rho_t - rho_j) <= 1e-6 * rho_j


def test_build_rhs_bitwise_f64():
    """(c) the port's right-hand side equals problem.build_rhs() bitwise."""
    ref = np.asarray(jpoisson.poisson_2d(max_level=7, min_level=5)
                     .build_rhs()[0])
    problem = tpoisson.poisson_2d(max_level=7, min_level=5)
    out = build_rhs(problem, dtype=torch.float64, device="cpu")[0].numpy()
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)


def test_cycle_loop_equals_steps():
    """(d) make_cycle_loop(K=4) is four steps."""
    problem, cycle = _v21(PORT, 8, 5, np.float32)
    lowered = tlower.lower_cycle(cycle, problem.approximation,
                                 problem.rhs_entity)
    b = build_rhs(problem, dtype=torch.float32, device="cpu")
    om = torch.tensor(lowered.default_omegas, dtype=torch.float32)
    u = tuple(torch.zeros_like(x) for x in b)
    looped = tsolve.make_cycle_loop(lowered, 4)(u, b, om)
    for _ in range(4):
        u = lowered.step(u, b, om)
    assert torch.equal(looped[0], u[0])


def test_measure_solve_reports_convergence():
    problem, cycle = _v21(PORT, 7, 5, np.float64)
    lowered = tlower.lower_cycle(cycle, problem.approximation,
                                 problem.rhs_entity)
    b = build_rhs(problem, dtype=torch.float64, device="cpu")
    res = tsolve.measure_solve(lowered, b, max_iterations=30,
                               target_reduction=1e-8, samples=1)
    assert res.converged and 0 < res.iterations < 30
    assert len(res.residuals) == res.iterations + 1
    assert 0 < res.convergence_factor < 0.2
    assert res.solve_time_ms > 0


def test_unported_node_raises():
    """Nodes outside the slice raise NotImplementedError naming the node,
    never a silent approximation: a smoother that inverts the whole
    operator (the JAX lowering's dense fallback, lower.py:1563, which the
    grammar never builds)."""
    problem, cycle = _v21(PORT, 6, 5, np.float64,
                          smoother_factory=lambda op: op.entries[0][0])
    lowered = tlower.lower_cycle(cycle, problem.approximation,
                                 problem.rhs_entity)
    b = build_rhs(problem, dtype=torch.float64, device="cpu")
    om = torch.tensor(lowered.default_omegas, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="inverse of Operator"):
        lowered.step(tuple(torch.zeros_like(x) for x in b), b, om)


_NO_JAX = textwrap.dedent("""
    import importlib.abc, sys

    # jax and the JAX package, by exact name or dotted prefix: a bare
    # prefix test would also block evostencils_tpu_torch
    BLOCKED = ("jax", "jaxlib", "evostencils_tpu")

    def blocked(name):
        return any(name == b or name.startswith(b + ".") for b in BLOCKED)

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if blocked(name):
                raise ImportError(f"import of {name} blocked")

    sys.meta_path.insert(0, Block())
    for name in [m for m in sys.modules if blocked(m)]:
        del sys.modules[name]

    import torch
    from evostencils_tpu_torch.compiler.cycles import v_cycle
    from evostencils_tpu_torch.compiler.lower import lower_cycle
    from evostencils_tpu_torch.compiler.solve import make_cycle_loop
    from evostencils_tpu_torch.ir import partitioning as part
    from evostencils_tpu_torch.ops.kernels import transfer, wavefront3d
    from evostencils_tpu_torch.problems.poisson import (build_rhs,
                                                        poisson_2d,
                                                        poisson_3d)

    calls = []
    for mod, name in [(transfer, "presmooth_residual_restrict_plain"),
                      (transfer, "prolong_correct_postsmooth_col_plain"),
                      (wavefront3d, "downleg_wavefront_3d_plain"),
                      (wavefront3d, "upleg_wavefront_3d_plain")]:
        def counted(*a, _fn=getattr(mod, name), _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)
        setattr(mod, name, counted)

    # the 2D slice at 255^2 and the 3D slice at 63^3: one fused level each
    for problem in (poisson_2d(max_level=8, min_level=5),
                    poisson_3d(max_level=6, min_level=2)):
        cycle = v_cycle(problem.level_contexts, problem.rhs_entity,
                        pre_smoothing=2, post_smoothing=1, omega=1.15,
                        partitioning=part.RedBlack,
                        coarse_operator=problem.coarsest_operator)
        lowered = lower_cycle(cycle, problem.approximation,
                              problem.rhs_entity)
        b = build_rhs(problem, dtype=torch.float32, device="cpu")
        om = torch.tensor(lowered.default_omegas, dtype=torch.float32)
        u = make_cycle_loop(lowered, 1)(
            tuple(torch.zeros_like(x) for x in b), b, om)
        assert bool(torch.isfinite(u[0]).all())
        assert float(u[0].abs().max()) > 0
    assert sorted(calls) == sorted(
        ["presmooth_residual_restrict_plain",
         "prolong_correct_postsmooth_col_plain",
         "downleg_wavefront_3d_plain", "upleg_wavefront_3d_plain"]), calls

    # the evolution path: grammar, evaluator and optimizer, and one seeded
    # individual evaluated at 255^2 (float64, no wall-time measurement)
    import random
    import numpy as np
    from evostencils_tpu_torch import optimize
    from evostencils_tpu_torch.evaluation.evaluator import CycleEvaluator
    from evostencils_tpu_torch.grammar import gp
    from evostencils_tpu_torch.grammar.multigrid import generate_primitive_set
    from evostencils_tpu_torch.optimization.program import Optimizer

    problem = poisson_2d(max_level=8, min_level=5)
    problem.dtype = np.float64
    pset = generate_primitive_set(problem.approximation, problem.rhs_entity,
                                  problem.level_contexts,
                                  problem.coarsest_operator)[0]
    evaluator = CycleEvaluator(problem, device="cpu")
    evaluator.timing_enabled = False
    individual = gp.genGrow(pset, 2, 40, rng=random.Random(21))
    (result,) = evaluator.evaluate_population([individual], pset)
    assert 0 < result.convergence_factor < 1, result
    assert 0 < result.iterations < 100, result
    Optimizer(problem, evaluator=evaluator, rng=random.Random(0))
    assert optimize.get_problem("poisson2d").max_level == 9

    # the 3D evolution path: a seeded individual at 63^3 that reaches the
    # 3D kernels' plain versions, and the poisson3d CLI on levels 5 -> 2
    import tempfile
    problem = poisson_3d(max_level=6, min_level=2)
    problem.dtype = np.float64
    pset = generate_primitive_set(problem.approximation, problem.rhs_entity,
                                  problem.level_contexts,
                                  problem.coarsest_operator)[0]
    evaluator = CycleEvaluator(problem, device="cpu")
    evaluator.timing_enabled = False
    individual = gp.genGrow(pset, 2, 40, rng=random.Random(6))
    (result,) = evaluator.evaluate_population([individual], pset)
    assert 0 < result.convergence_factor < 1, result
    CycleEvaluator.timing_enabled = False
    with tempfile.TemporaryDirectory() as out:
        best = optimize.main(["poisson3d", "--cpu", "--max-level", "5",
                              "--min-level", "2", "--mu", "4", "--lambda",
                              "4", "--generations", "1", "--seed", "5",
                              "--output", out])["grammar_string"]
    problem = optimize.get_problem("poisson3d", 5, 2)
    pset = generate_primitive_set(problem.approximation, problem.rhs_entity,
                                  problem.level_contexts,
                                  problem.coarsest_operator)[0]
    assert str(gp.parse_tree(best, pset)) == best
    assert not any(blocked(m) for m in sys.modules)
    print("ok")
""")


def test_port_runs_with_jax_blocked():
    """(e) the 2D and 3D slices and the evolution path (grammar, evaluator,
    optimizer, in 2D and in 3D, and the poisson3d CLI) run in a process
    where importing jax or any module of the JAX package fails."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
