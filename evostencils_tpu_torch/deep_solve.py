"""Deep-convergence solves on the port: iterative refinement with a float64
residual around the float32 cycles (the port's twin of
scripts/deep_solve.py, with its options and its three solves).

Usage:
    python -m evostencils_tpu_torch.deep_solve [--max-level N]
        [--fas-max-level N] [--cpu]

- 2D Poisson to 1e-12 relative residual (reference
  scripts/evaluate_reference_solver.py float64 protocol): the red-black
  V(2,1) at omega 1.15, 8 float32 cycles an outer step;
- the same with bfloat16 inner cycles (3 an outer step, at most 16 outer
  steps): on the card the 2D legs store bf16 and compute in float32;
- FAS_2D_Basic to 1e-10 relative residual (reference FAS knowledge file):
  Newton steps by 3 Richardson iterations preconditioned by 3 cycles of
  the shifted linear operator L + 20 I;

each with float32 (or bf16) cycles and the residual measured in float64
(compiler/refine).  It runs on the card unless ``--cpu`` is given, and
fails without one.  Progress goes to stderr; the last line of stdout is
one JSON object of the three solves' convergence, as the JAX script
prints it.
"""

from __future__ import annotations

import argparse
import sys
import time


def poisson_lowered(max_level, use_kernels=True):
    """``(problem, lowered)``: poisson_2d(max_level, max(max_level - 6, 2))
    and its red-black V(2,1) at omega 1.15 (scripts/deep_solve.py:51-60)."""
    from .compiler.cycles import v_cycle
    from .compiler.lower import lower_cycle
    from .ir import partitioning as part
    from .problems.poisson import poisson_2d

    problem = poisson_2d(max_level=max_level,
                         min_level=max(max_level - 6, 2))
    cycle = v_cycle(problem.level_contexts, problem.rhs_entity,
                    pre_smoothing=2, post_smoothing=1, omega=1.15,
                    partitioning=part.RedBlack,
                    coarse_operator=problem.coarsest_operator)
    return problem, lower_cycle(cycle, problem.approximation,
                                problem.rhs_entity, use_kernels=use_kernels)


def fas_lowered(max_level, min_level, use_kernels=True):
    """``(problem, fas cycle, correction cycle)``: fas_2d_basic's FAS
    V-cycle, and the red-black V(2,1) at omega 1 of the shifted linear
    operator L + 20 I on the same hierarchy, the Newton correction's
    preconditioner (scripts/deep_solve.py:95-110)."""
    from .compiler.cycles import fas_v_cycle, v_cycle
    from .compiler.lower import lower_cycle
    from .ir import base, system
    from .ir import partitioning as part
    from .problems.api import scalar_hierarchy
    from .problems.fas import fas_2d_basic
    from .stencils import gallery

    fas = fas_2d_basic(max_level=max_level, min_level=min_level)
    fcycle = fas_v_cycle(fas.level_contexts, fas.rhs_entity,
                         coarse_operator=fas.coarsest_operator)
    flow = lower_cycle(fcycle, fas.approximation, fas.rhs_entity,
                       use_kernels=use_kernels)
    gen = gallery.ShiftedOperatorGenerator(gallery.Poisson2D(), 20.0)
    ctxs, coarsest = scalar_hierarchy("Ashift", 2, max_level, min_level, gen)
    rhs_e = system.RightHandSide("f",
                                 [base.RightHandSide("f", ctxs[0].grid[0])])
    lin_cycle = v_cycle(ctxs, rhs_e, pre_smoothing=2, post_smoothing=1,
                        omega=1.0, partitioning=part.RedBlack,
                        coarse_operator=coarsest)
    corr = lower_cycle(lin_cycle, ctxs[0].approximation, rhs_e,
                       use_kernels=use_kernels)
    return fas, flow, corr


def _log(msg):
    print(f"[deep] {msg}", file=sys.stderr, flush=True)


def _relative(res):
    return [r / res.residuals[0] for r in res.residuals]


def _timed(device, solve, b):
    import torch
    t0 = time.perf_counter()
    res = solve(b)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return res, time.perf_counter() - t0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m evostencils_tpu_torch.deep_solve")
    parser.add_argument("--max-level", type=int, default=10)
    parser.add_argument("--fas-max-level", type=int, default=8)
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args(argv)

    import torch

    from .compiler.refine import make_refined_solver
    from .config import setup_device
    from .problems.poisson import build_rhs

    device = setup_device("cpu" if args.cpu else "cuda")
    _log("device: " + (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"))

    # ---- 2D Poisson to 1e-12 ----------------------------------------------
    ml = args.max_level
    problem, lowered = poisson_lowered(ml)
    solve = make_refined_solver(lowered, inner_cycles=8,
                                target_reduction=1e-12)
    b = build_rhs(problem, dtype=torch.float32, device=device)[0]
    res, t = _timed(device, solve, b)
    rels = _relative(res)
    _log(f"poisson2d {2**ml - 1}^2: converged={res.converged} "
         f"outer={res.outer_iterations} time={t:.2f}s")
    _log("  rel residuals: " + "  ".join(f"{r:.3e}" for r in rels))
    # extrapolation cross-check: total fine cycles vs log(eps)/log(rho)
    inner_total = 8 * (res.outer_iterations - 1)
    rho_implied = rels[-1] ** (1.0 / max(inner_total, 1))
    _log(f"  {inner_total} f32 V-cycles to 1e-12 => implied rho "
         f"{rho_implied:.4f}")

    # ---- the same solve with bf16 inner cycles ----------------------------
    bf_solve = make_refined_solver(lowered, inner_cycles=3, max_outer=16,
                                   target_reduction=1e-12,
                                   inner_dtype=torch.bfloat16)
    bres, tb = _timed(device, bf_solve, b)
    _log(f"poisson2d bf16-inner: converged={bres.converged} "
         f"outer={bres.outer_iterations} time={tb:.2f}s "
         f"({3 * (bres.outer_iterations - 1)} bf16 V-cycles)")
    _log("  rel residuals: " + "  ".join(f"{r:.3e}" for r in _relative(bres)))

    # ---- FAS to 1e-10 ------------------------------------------------------
    fml = args.fas_max_level
    fas, flow, corr = fas_lowered(fml, max(fml - 4, 2))
    fsolve = make_refined_solver(flow, inner_cycles=3, max_outer=10,
                                 target_reduction=1e-10,
                                 richardson_iterations=3,
                                 nonlinear=fas.level_contexts[0].operator,
                                 correction_lowered=corr)
    fb = build_rhs(fas, dtype=torch.float32, device=device)[0]
    fres, t = _timed(device, fsolve, fb)
    _log(f"fas2d {2**fml - 1}^2: converged={fres.converged} "
         f"outer={fres.outer_iterations} time={t:.2f}s")
    _log("  rel residuals: " + "  ".join(f"{r:.3e}" for r in _relative(fres)))

    ok = res.converged and fres.converged and bres.converged
    print(f'{{"poisson_1e12": {str(res.converged).lower()}, '
          f'"poisson_1e12_bf16_inner": {str(bres.converged).lower()}, '
          f'"fas_1e10": {str(fres.converged).lower()}}}')
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
