"""Evolve multigrid cycles for a problem on the port (the port's twin of
scripts/optimize.py, with its options and defaults).

Usage:
    python -m evostencils_tpu_torch.optimize <problem> [method] [options]

    problem: poisson2d (levels 9 -> 5) | poisson3d (levels 6 -> 2)
             | poisson2d_var (levels 9 -> 5) | elasticity2d (levels 8 -> 4)
             | helmholtz2d (levels 7 -> 3) | helmholtz2d_split (7 -> 3)
             | fas2d (levels 10 -> 6)
    method:  NSGAII (default) | NSGAIII | SOGP | RandomSearch

Options:
    --mu N --lambda N --generations N --levels-per-run N
    --max-level N --min-level N
    --output DIR   (default ./evo_output)
    --cpu          run on the CPU (float64 unless --f32)
    --f32          evaluate in float32 (always so on the card)
    --seed N --resume --islands N --generalization-interval N
    --no-robustness --model-based

On the card every evaluation runs in float32, as on the TPU: the evaluator
measures convergence to 1e-5 and extrapolates the iteration count to the
problem's target (scripts/optimize.py:92-105); helmholtz2d then runs in
complex64, helmholtz2d_split on (re, im) float32 pairs.  Each helmholtz2d
or helmholtz2d_split candidate that solves the problem must also solve it
at 2k and 4k (the robustness variants, built by the problem's own
factory, scripts/optimize.py:124-142), unless ``--no-robustness``.
``--model-based`` scores each candidate without solving it: its
convergence factor by Local Fourier Analysis (``prediction/convergence``,
batched complex128 tensor programs on the card, or on the CPU with
``--cpu``) and its time per cycle by the H100 roofline model
(``prediction/performance``).  It writes ``best_grammar.txt`` and
``result.p`` to ``--output``.

One evolution in N processes (the reference's MPI tier, reference
optimization/program.py:285-310), on one card or several::

    torchrun --standalone --nproc-per-node N -m evostencils_tpu_torch.optimize ...

(``python -m torch.distributed.run`` is the same launcher.)  The ranks
form a gloo process group (``parallel/comm.default_communicator``), each
takes the card ``LOCAL_RANK % device_count()`` (``config.setup_device``),
all run the same generation and selection stream from one seed (rank 0's
random seed is broadcast when ``--seed`` is not given), each evaluates
its share ``pending[rank::size]`` of every generation's new individuals,
and the fitness values are allgathered.  Rank 0 alone writes the result
files and the checkpoints.  ``--islands N`` instead runs N ranks as
threads in one process.
"""

from __future__ import annotations

import argparse
import os
import pickle
import random
import sys

import numpy as np


def get_problem(name, max_level=None, min_level=None):
    """The problems of scripts/optimize.py:27-57 at their default levels."""
    from .problems import elasticity, fas, helmholtz, poisson
    factories = {"poisson2d": (poisson.poisson_2d, 9, 5),
                 "poisson3d": (poisson.poisson_3d, 6, 2),
                 "poisson2d_var": (poisson.poisson_2d_variable, 9, 5),
                 "elasticity2d": (elasticity.linear_elasticity_2d, 8, 4),
                 "helmholtz2d": (helmholtz.helmholtz_2d, 7, 3),
                 "helmholtz2d_split": (helmholtz.helmholtz_2d_split, 7, 3),
                 "fas2d": (fas.fas_2d_basic, 10, 6)}
    if name not in factories:
        raise SystemExit(f"unknown problem {name!r}; "
                         f"available: {sorted(factories)}")
    fn, default_max, default_min = factories[name]
    return fn(max_level=max_level or default_max,
              min_level=min_level or default_min)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m evostencils_tpu_torch.optimize")
    parser.add_argument("problem")
    parser.add_argument("method", nargs="?", default="NSGAII")
    parser.add_argument("--mu", type=int, default=8)
    parser.add_argument("--lambda", dest="lambda_", type=int, default=8)
    parser.add_argument("--generations", type=int, default=50)
    parser.add_argument("--levels-per-run", type=int, default=None)
    parser.add_argument("--max-level", type=int, default=None)
    parser.add_argument("--min-level", type=int, default=None)
    parser.add_argument("--output", default="./evo_output")
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--f32", action="store_true")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--no-robustness", action="store_true",
                        help="skip the Helmholtz 2k/4k robustness variants")
    parser.add_argument("--model-based", action="store_true",
                        help="LFA + roofline fitness instead of measured "
                             "solves (reference model_based_estimation)")
    parser.add_argument("--resume", action="store_true",
                        help="continue from the checkpoint in --output")
    parser.add_argument("--islands", type=int, default=1,
                        help="population-parallel island ranks (threads "
                             "in one process; for processes run the CLI "
                             "under torchrun)")
    parser.add_argument("--generalization-interval", type=int,
                        default=10 ** 9,
                        help="generations between problem-size growth")
    return parser.parse_args(argv)


def robustness_factories(args):
    """The helmholtz2d or helmholtz2d_split robustness variants'
    factories, ``(min_level, max_level) -> problem`` at 2k and 4k, each
    built by the problem's own factory, or None (scripts/optimize.py:
    124-142)."""
    if args.problem not in ("helmholtz2d", "helmholtz2d_split") \
            or args.no_robustness:
        return None
    from .problems.helmholtz import (K_DEFAULT, helmholtz_2d,
                                     helmholtz_2d_split)
    factory = helmholtz_2d_split if args.problem == "helmholtz2d_split" \
        else helmholtz_2d
    return [lambda lo, hi, kk=f * K_DEFAULT, fac=factory: fac(
        max_level=hi, min_level=lo, k=kk) for f in (2, 4)]


def main(argv=None):
    """Run one evolution; returns the optimizer's result dictionary."""
    args = parse_args(argv)
    from .config import setup_device
    from .evaluation.evaluator import CycleEvaluator
    from .optimization.program import Optimizer
    from .parallel import comm as comms

    # the card runs float32, as the TPU does; the CPU float64 unless --f32
    device = setup_device("cpu" if args.cpu else "cuda")
    if device.type == "cuda":
        args.f32 = True
    dtype = np.float32 if args.f32 else np.float64
    os.makedirs(args.output, exist_ok=True)

    def run_rank(comm):
        """One island rank; identical seeds keep populations replicated
        while evaluation is partitioned (parallel/comm.py)."""
        problem = get_problem(args.problem, args.max_level, args.min_level)
        problem.dtype = dtype
        evaluator = CycleEvaluator(problem, device=device)
        # Helmholtz: every candidate must also solve at 2k and 4k, the
        # reference's wavenumber-doubling robustness schedule
        factories = robustness_factories(args)
        robustness = [f(args.min_level or 3, args.max_level or 7)
                      for f in factories or ()]
        optimizer = Optimizer(
            problem, evaluator=evaluator, robustness_problems=robustness,
            robustness_factories=factories,
            checkpoint_directory_path=os.path.join(args.output,
                                                   "checkpoints"),
            model_based_estimation=args.model_based,
            problem_factory=lambda lo, hi: get_problem(args.problem, hi, lo),
            rng=random.Random(args.seed), comm=comm)
        method = {"NSGAII": optimizer.NSGAII, "NSGAIII": optimizer.NSGAIII,
                  "SOGP": optimizer.SOGP}.get(args.method)
        use_random_search = args.method == "RandomSearch"
        return optimizer.evolutionary_optimization(
            mu_=args.mu, lambda_=args.lambda_, generations=args.generations,
            levels_per_run=args.levels_per_run,
            generalization_interval=args.generalization_interval,
            optimization_method=method if not use_random_search else None,
            continue_from_checkpoint=args.resume,
            use_random_search=use_random_search)

    if args.islands > 1:
        # island ranks MUST share one seed: populations stay replicated
        # and only evaluation is partitioned (parallel/comm.py contract)
        if args.seed is None:
            args.seed = random.randrange(2 ** 63)
            print(f"[islands] generated shared seed {args.seed}")
        result = comms.run_island_threads([run_rank] * args.islands)[0]
        rank = 0
    else:
        comm = comms.default_communicator()
        rank = comm.rank
        if comm.size > 1 and args.seed is None:
            # process ranks MUST share one seed as well: rank 0's
            args.seed = comm.broadcast_object(random.randrange(2 ** 63))
            if rank == 0:
                print(f"[processes] generated shared seed {args.seed}")
        try:
            result = run_rank(comm)
        finally:
            if isinstance(comm, comms.TorchProcessCommunicator):
                comm.close()
    if rank != 0:           # rank-0-only I/O (reference program.py:278-279)
        return result

    print("\nBest individual:")
    print(result["grammar_string"])
    # one line per level chunk (finest first)
    chunks = result.get("chunk_grammar_strings") or [result["grammar_string"]]
    with open(os.path.join(args.output, "best_grammar.txt"), "w") as f:
        f.write("\n".join(chunks) + "\n")
    with open(os.path.join(args.output, "result.p"), "wb") as f:
        pickle.dump({"grammar_string": result["grammar_string"],
                     "chunk_grammar_strings": chunks,
                     "populations": result["populations"],
                     "logbooks": result["logbooks"]}, f)
    print(f"Results written to {args.output}")
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
