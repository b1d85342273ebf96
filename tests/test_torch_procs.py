"""The port's process tier (evostencils_tpu_torch/parallel/comm.py:
``TorchProcessCommunicator``, ``initialize_multihost``,
``default_communicator``) and thread islands on the CPU.

Two ranks run as two fresh interpreters over a gloo process group on
localhost (this module is also the rank body: ``python -m
tests.test_torch_procs <out.json> <host:port> <rank>``), or under the
``torchrun`` launcher driving the CLI.  The contract is
tests/test_multihost.py's: the collectives round-trip, and a 2-rank
model-based NSGA-II equals the single-process run of both packages in
population strings, best individual, fitness and ``total_evaluations``;
the thread islands (tests/test_comm.py:75-111) meet the same contract.
Every child has its own timeout, and all children are killed when one
fails or runs over.
"""

import json
import os
import pathlib
import random
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from evostencils_tpu_torch import optimize as toptimize
from evostencils_tpu_torch.config import setup_device
from evostencils_tpu_torch.evaluation import evaluator as tev
from evostencils_tpu_torch.grammar import multigrid as tmg
from evostencils_tpu_torch.optimization.program import Optimizer
from evostencils_tpu_torch.parallel import comm as comms
from evostencils_tpu_torch.prediction import performance as tperf
from evostencils_tpu_torch.problems import poisson as tpoisson

REPO = pathlib.Path(__file__).resolve().parents[1]
#: seconds a child may take; the group forms within the first few
CHILD_TIMEOUT_S = 240
#: seconds a rank waits for a missing peer in the no-fallback test
MISSING_PEER_TIMEOUT_S = 2.0
#: model-based fitness, port against the JAX package (tests/
#: test_torch_prediction.py's rtol); the port's own runs agree exactly
JAX_FITNESS_RTOL = 1e-10
#: the CLI run under torchrun, and in one process
CLI_ARGS = ["poisson2d", "--cpu", "--model-based", "--max-level", "5",
            "--min-level", "3", "--mu", "2", "--lambda", "2",
            "--generations", "1", "--seed", "0"]


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _clean_env():
    """This process's environment without a process group's variables,
    one OpenMP thread."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    return env


def _dist_env(rank, size, port):
    """The environment ``torchrun`` gives rank ``rank`` of ``size`` with
    its store at localhost:``port``."""
    env = _clean_env()
    env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(size),
               MASTER_ADDR="localhost", MASTER_PORT=str(port))
    return env


def _run_children(commands, timeout=CHILD_TIMEOUT_S):
    """Start every ``(argv, env)`` at once; wait for each within
    ``timeout`` seconds of the start.  On a timeout or a failure every
    child (and its process group) is killed and the test fails.
    Returns each child's (returncode, stdout, stderr)."""
    procs = [subprocess.Popen(argv, cwd=str(REPO), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, start_new_session=True)
             for argv, env in commands]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        pytest.fail(f"a child ran over {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    return outs


def _problem():
    problem = tpoisson.poisson_2d(max_level=3, min_level=2)
    problem.dtype = np.float64
    return problem


def evolve(comm, checkpoints):
    """The model-based NSGA-II of tests/multihost_worker.py:40-53 on the
    port: poisson_2d(3, 2), Random(123), 8 initial individuals, 2
    generations, mu = lambda = 4, the LFA on the CPU and runtimes on the
    REFERENCE_CPU model (the JAX side takes the same model)."""
    problem = _problem()
    pset, _ = tmg.generate_primitive_set(
        problem.approximation, problem.rhs_entity, problem.level_contexts,
        problem.coarsest_operator)
    opt = Optimizer(problem, evaluator=tev.CycleEvaluator(problem,
                                                          device="cpu"),
                    model_based_estimation=True,
                    performance_evaluator=tperf.PerformanceEvaluator(
                        tperf.REFERENCE_CPU),
                    rng=random.Random(123), comm=comm,
                    checkpoint_directory_path=str(checkpoints))
    return _nsga_ii(opt, pset)


def _nsga_ii(opt, pset):
    """Run ``opt``'s NSGA-II (8 initial, 2 generations, mu = lambda = 4)
    and describe its result, with the estimates this process made in
    the order it made them."""
    estimates = []
    estimate = opt._estimate_objectives

    def recorded(individual):
        values = estimate(individual)
        estimates.append([str(individual), list(values)])
        return values
    opt._estimate_objectives = recorded
    pop, log, hof, _, _ = opt.NSGAII(
        pset=pset, initial_population_size=8, generations=2, mu_=4,
        lambda_=4, min_level=2, max_level=3, verbose=False)
    best = min(hof, key=lambda i: i.fitness.values)
    return {"best": str(best), "best_fitness": list(best.fitness.values),
            "population": sorted(str(i) for i in pop),
            "fitness": sorted(list(i.fitness.values) for i in pop),
            "log": [[r["gen"], r["nevals"]] for r in log],
            "total_evaluations": opt.total_evaluations,
            "estimates": estimates}


def worker(out_path, address, rank):
    """Rank ``rank`` of 2 at ``address`` (``host:port``, the JAX worker's
    explicit arguments, tests/multihost_worker.py:30): every collective,
    then the 2-rank evolution; writes its results as JSON to
    ``out_path``."""
    torch.set_num_threads(1)
    comm = comms.initialize_multihost(address, 2, rank)
    assert isinstance(comm, comms.TorchProcessCommunicator)
    assert comms.default_communicator().size == 2
    gathered = comm.allgather_object({"rank": comm.rank,
                                      "blob": "x" * (100 * (comm.rank + 1))})
    reduced = comm.allreduce_sum(comm.rank + 1.5)
    bcast = comm.broadcast_object(f"from-{comm.rank}", root=1)
    reassembled = comm.allgather_shards(comm.shard(list(range(7))))
    comm.barrier()
    result = evolve(comm, out_path + f".ckpt{comm.rank}")
    result.update(rank=comm.rank, size=comm.size, gathered=gathered,
                  reduced=reduced, bcast=bcast, reassembled=reassembled)
    comm.close()
    with open(out_path, "w") as f:
        json.dump(result, f)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as in the ranks: the LFA's products then sum
    in the same order in every process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("procs")
    port = _free_port()
    outs = [tmp / f"rank{r}.json" for r in range(2)]
    children = _run_children([
        ([sys.executable, "-m", "tests.test_torch_procs", str(out),
          f"localhost:{port}", str(r)], _clean_env())
        for r, out in enumerate(outs)])
    for rc, _, err in children:
        assert rc == 0, f"rank failed:\n{err[-3000:]}"
    return [json.loads(out.read_text()) for out in outs]


@pytest.fixture(scope="module")
def solo(tmp_path_factory):
    return evolve(comms.NullCommunicator(),
                  tmp_path_factory.mktemp("solo") / "ckpt")


def test_collectives_roundtrip(rank_results):
    """tests/test_multihost.py:60-72: unequal payloads gathered in rank
    order, the sum, rank 1's broadcast and the sharded list."""
    for r in rank_results:
        assert r["size"] == 2
        assert [g["rank"] for g in r["gathered"]] == [0, 1]
        assert [len(g["blob"]) for g in r["gathered"]] == [100, 200]
        assert r["reduced"] == 1.5 + 2.5
        assert r["bcast"] == "from-1"
        assert r["reassembled"] == list(range(7))
    assert [r["rank"] for r in rank_results] == [0, 1]


def _same_run(got, want):
    for key in ("best", "best_fitness", "population", "fitness", "log",
                "total_evaluations"):
        assert got[key] == want[key], key


def test_two_ranks_equal_one_process(rank_results, solo):
    """Both ranks end with the single-process run's population, best
    individual, fitness and evaluation count."""
    r0, r1 = rank_results
    _same_run(r0, r1)
    _same_run(r0, solo)
    assert solo["total_evaluations"] > 8


def _jax_run(tmp_path, fitness_of=None):
    """The JAX package's single-process run of tests/test_multihost.py:
    75-100 with the same machine model as the port's and numpy's LFA;
    with ``fitness_of`` (tree string -> objectives) its estimates are
    replaced by those values."""
    from evostencils_tpu.grammar.multigrid import generate_primitive_set
    from evostencils_tpu.optimization.program import Optimizer as JOptimizer
    from evostencils_tpu.prediction import convergence as jconv
    from evostencils_tpu.prediction import performance as jperf
    from evostencils_tpu.problems.poisson import poisson_2d

    problem = poisson_2d(max_level=3, min_level=2)
    pset, _ = generate_primitive_set(
        problem.approximation, problem.rhs_entity, problem.level_contexts,
        problem.coarsest_operator)
    opt = JOptimizer(problem, rng=random.Random(123),
                     model_based_estimation=True,
                     convergence_evaluator=jconv.ConvergenceEvaluator(
                         2, samples_per_axis=8, backend="numpy"),
                     performance_evaluator=jperf.PerformanceEvaluator(
                         jperf.REFERENCE_CPU),
                     checkpoint_directory_path=str(tmp_path))
    if fitness_of is not None:
        opt._estimate_objectives = lambda ind: tuple(fitness_of[str(ind)])
    return _nsga_ii(opt, pset)


def test_one_process_estimates_equal_jax(solo, tmp_path):
    """The JAX package's own run estimates the same individuals in the
    same order, each within JAX_FITNESS_RTOL, and ends with the same best
    individual and evaluation count."""
    jax_run = _jax_run(tmp_path)
    assert [s for s, _ in solo["estimates"]] == \
        [s for s, _ in jax_run["estimates"]]
    np.testing.assert_allclose([v for _, v in solo["estimates"]],
                               [v for _, v in jax_run["estimates"]],
                               rtol=JAX_FITNESS_RTOL)
    for key in ("best", "log", "total_evaluations"):
        assert solo[key] == jax_run[key], key
    np.testing.assert_allclose(solo["best_fitness"], jax_run["best_fitness"],
                               rtol=JAX_FITNESS_RTOL)


def test_one_process_selection_equals_jax(solo, tmp_path):
    """Given the port's estimates, the JAX package's run ends with the
    port's population, best individual, fitness and evaluation count.
    (With its own estimates the final population may differ: three
    candidates of this run have rho = 1 in exact arithmetic and equal
    runtimes, and rounding in the last place decides which dominate.)"""
    jax_run = _jax_run(tmp_path, dict(solo["estimates"]))
    for key in ("best", "best_fitness", "population", "fitness", "log",
                "total_evaluations", "estimates"):
        assert solo[key] == jax_run[key], key


def test_thread_islands_equal_one_process(solo, tmp_path):
    """Two thread islands (tests/test_comm.py:75-111) meet the same
    contract."""
    r0, r1 = comms.run_island_threads(
        [lambda c: evolve(c, tmp_path / f"r{c.rank}")] * 2)
    _same_run(r0, r1)
    _same_run(r0, solo)


def test_missing_peer_raises_within_timeout():
    """WORLD_SIZE=2 with no second rank: default_communicator raises
    after its timeout instead of running alone on the no-op."""
    code = ("from evostencils_tpu_torch.parallel import comm\n"
            f"comm.INIT_TIMEOUT_S = {MISSING_PEER_TIMEOUT_S}\n"
            "comm.default_communicator()\n"
            "print('formed')\n")
    t0 = time.monotonic()
    [(rc, out, err)] = _run_children(
        [([sys.executable, "-c", code], _dist_env(0, 2, _free_port()))],
        timeout=60)
    assert rc != 0 and "formed" not in out
    assert "Timed out" in err or "timed out" in err
    assert time.monotonic() - t0 < 40


def test_default_communicator_single_process(monkeypatch):
    """Without WORLD_SIZE (or with 1) the no-op; the process
    communicator needs a group."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert isinstance(comms.default_communicator(), comms.NullCommunicator)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert isinstance(comms.default_communicator(), comms.NullCommunicator)
    with pytest.raises(RuntimeError, match="process group"):
        comms.TorchProcessCommunicator()


@pytest.mark.parametrize("local_rank,count,index", [(None, 1, 0), (1, 1, 0),
                                                    (3, 2, 1), (2, 4, 2)])
def test_setup_device_picks_the_rank_card(monkeypatch, local_rank, count,
                                          index):
    """"cuda" becomes cuda:{LOCAL_RANK % device_count()} and the current
    device; an explicit index stays."""
    chosen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", str(local_rank))
    assert setup_device("cuda") == torch.device("cuda", index)
    assert setup_device("cuda:0") == torch.device("cuda", 0)
    assert chosen == [torch.device("cuda", index), torch.device("cuda", 0)]
    assert setup_device("cpu") == torch.device("cpu")


def test_cli_under_torchrun(tmp_path):
    """``torchrun --standalone --nproc-per-node 2 -m
    evostencils_tpu_torch.optimize ... --cpu --model-based``: rank 0
    alone writes the result files, and its best individual is the
    one-process CLI run's."""
    out2, out1 = tmp_path / "two", tmp_path / "one"
    [(rc, out, err)] = _run_children([(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "evostencils_tpu_torch.optimize"]
        + CLI_ARGS + ["--output", str(out2)], _clean_env())])
    assert rc == 0, err[-3000:]
    assert out.count("Results written to") == 1
    result = toptimize.main(CLI_ARGS + ["--output", str(out1)])
    best = (out2 / "best_grammar.txt").read_text()
    assert best == (out1 / "best_grammar.txt").read_text()
    assert best.strip() == result["grammar_string"]
    assert (out2 / "result.p").exists()


if __name__ == "__main__":
    worker(sys.argv[1], sys.argv[2], int(sys.argv[3]))
