"""Re-measure a stored evolved solver from its grammar file on the port
(the port's twin of scripts/evaluate_evolved_solver.py, with its
arguments; reference scripts/evaluate_evolved_solver.py:6-53).

Usage:
    python -m evostencils_tpu_torch.evaluate_evolved_solver GRAMMAR_FILE
        [problem] [--max-level N] [--min-level N] [--samples N]
        [--levels-per-run N] [--cpu] [--f32]

``GRAMMAR_FILE`` is the ``best_grammar.txt`` that ``optimize`` wrote: one
grammar string, or one a level chunk (finest first) for a level-chunked
run, whose composed program is then measured on the finest grid
(``Optimizer.evaluate_chunked_program``; ``--levels-per-run`` is the run's
chunk size, inferred from the line count when omitted).  It runs on the
card unless ``--cpu`` is given, and fails without one; float64 unless
``--f32``.  ``--samples`` is accepted and unused, as in the JAX script.
It prints the time to convergence, the convergence factor and the
iterations, one a line, as the JAX script does.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m evostencils_tpu_torch.evaluate_evolved_solver")
    parser.add_argument("grammar_file",
                        help="path to best_grammar.txt from optimize")
    parser.add_argument("problem", nargs="?", default="poisson2d")
    parser.add_argument("--max-level", type=int, default=None)
    parser.add_argument("--min-level", type=int, default=None)
    parser.add_argument("--samples", type=int, default=20)
    parser.add_argument("--levels-per-run", type=int, default=None,
                        help="chunk size of a multi-line (level-chunked) "
                             "grammar file; inferred from the line count "
                             "when omitted")
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--f32", action="store_true")
    args = parser.parse_args(argv)

    import numpy as np

    from .config import setup_device
    from .evaluation.evaluator import CycleEvaluator
    from .optimization.program import Optimizer
    from .optimize import get_problem

    device = setup_device("cpu" if args.cpu else "cuda")
    with open(args.grammar_file) as f:
        lines = [ln.strip() for ln in f if ln.strip()]

    problem = get_problem(args.problem, args.max_level, args.min_level)
    problem.dtype = np.float32 if args.f32 else np.float64
    optimizer = Optimizer(problem,
                          evaluator=CycleEvaluator(problem, device=device))
    if len(lines) > 1:
        # a level-chunked solver: one grammar string a chunk, finest
        # first; the composed program is measured on the finest grid
        _, result = optimizer.evaluate_chunked_program(
            lines, levels_per_run=args.levels_per_run)
    else:
        _, result = optimizer \
            .generate_and_evaluate_program_from_grammar_representation(
                lines[0])
    print(f"Time to convergence: {result.time_to_convergence_ms} ms")
    print(f"Convergence factor: {result.convergence_factor}")
    print(f"Number of iterations: {result.iterations}")
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
