"""Measure the default (reference-configuration) solver on the port (the
port's twin of scripts/evaluate_reference_solver.py, with its arguments;
reference scripts/evaluate_reference_solver.py:15-47: 20 runs, the average
solving time and iteration count).

Usage:
    python -m evostencils_tpu_torch.evaluate_reference_solver [problem]
        [--max-level N] [--min-level N] [--samples N] [--cpu] [--f32]

The solver is the V-cycle with red-black Gauss-Seidel at omega 1.15, 2 pre-
and 1 post-smoothing steps, and the coarse solve the lowering picks (dense
up to ``config.DIRECT_SOLVE_MAX`` unknowns, CG above), run to the
problem's target reduction (``compiler.solve.measure_solve``).  It runs on
the card unless ``--cpu`` is given, and fails without one; float64 unless
``--f32``.  It prints the average solving time, the iterations and the
convergence factor, one a line, as the JAX script does.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m evostencils_tpu_torch.evaluate_reference_solver")
    parser.add_argument("problem", nargs="?", default="poisson2d")
    parser.add_argument("--max-level", type=int, default=None)
    parser.add_argument("--min-level", type=int, default=None)
    parser.add_argument("--samples", type=int, default=20)
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--f32", action="store_true")
    args = parser.parse_args(argv)

    import torch

    from .compiler.cycles import v_cycle
    from .compiler.lower import lower_cycle
    from .compiler.solve import measure_solve
    from .config import setup_device
    from .ir import partitioning as part
    from .optimize import get_problem
    from .problems.poisson import build_rhs

    device = setup_device("cpu" if args.cpu else "cuda")
    problem = get_problem(args.problem, args.max_level, args.min_level)
    # the reference default: V-cycle, RB-GS omega=1.15, 2 pre / 1 post
    cycle = v_cycle(problem.level_contexts, problem.rhs_entity,
                    pre_smoothing=2, post_smoothing=1, omega=1.15,
                    partitioning=part.RedBlack,
                    coarse_operator=problem.coarsest_operator)
    lowered = lower_cycle(cycle, problem.approximation, problem.rhs_entity)
    b = build_rhs(problem, device=device,
                  dtype=torch.float32 if args.f32 else torch.float64)
    result = measure_solve(lowered, b,
                           max_iterations=problem.max_iterations,
                           target_reduction=problem.target_reduction,
                           samples=args.samples)
    print(f"Average solving time: {result.solve_time_ms} ms")
    print(f"Average number of iterations: {result.iterations}")
    print(f"Convergence factor: {result.convergence_factor}")
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
