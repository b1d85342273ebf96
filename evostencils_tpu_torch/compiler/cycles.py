"""Copy of evostencils_tpu/compiler/cycles.py, kept in the port so that it imports
nothing of the JAX package.

Hand-constructed cycle builders: textbook V/W/F-cycles over the IR.

These play the role of the reference's default generated solver
(``generate solver`` blocks, e.g. V-cycle with RB-GS omega=1.15, 2 pre /
1 post smoothing and a CG coarse solve —
example_problems/Poisson/2D_FD_Poisson_fromL2.exa3:1-14) and of the
executable documentation in reference ir/reference_cycles.py.  The grammar
produces equivalent trees; these builders give known-good baselines.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

from ..grids import Grid
from ..ir import base, system, smoother
from ..ir import partitioning as part


@dataclass
class LevelContext:
    """Per-level operator bundle (analogue of grammar.multigrid.Terminals)."""
    operator: system.Operator
    restriction: system.Restriction        # this level -> coarser
    prolongation: system.Prolongation      # coarser -> this level
    approximation: system.Approximation
    grid: List[Grid]


def smooth(state, level: LevelContext, omega: float, partitioning,
           smoother_factory: Callable = smoother.generate_collective_jacobi):
    """One smoothing step: u <- u + omega * P(L)^{-1} (b - A u)."""
    u, f = state
    residual = base.Residual(level.operator, u, f)
    L = smoother_factory(level.operator)
    correction = base.Multiplication(base.Inverse(L), residual)
    cycle = base.Cycle(u, f, correction, partitioning=partitioning,
                       relaxation_factor=omega,
                       predecessor=getattr(u, "predecessor", None))
    return cycle, f


def v_cycle(levels: Sequence[LevelContext], rhs, *,
            pre_smoothing: int = 2, post_smoothing: int = 1,
            omega: float = 1.15, partitioning=part.RedBlack,
            smoother_factory: Callable = smoother.generate_collective_jacobi,
            coarse_solver_expression=None,
            coarse_operator: Optional[system.Operator] = None,
            coarse_krylov: Optional[str] = None,
            coarse_krylov_iterations: int = 64,
            gamma: int = 1) -> base.Cycle:
    """Build a V-cycle (gamma=1) or W-cycle (gamma=2) expression tree.

    ``levels[0]`` is the finest level; ``coarse_operator`` is the operator on
    the grid below ``levels[-1]`` (the coarsest-grid solve target).

    ``coarse_krylov`` selects an iterative Krylov coarse solve instead of
    the CoarseGridSolver node: one of "CG" | "BiCGStab" | "MinRes" |
    "ConjugateResidual", lowered to a fixed-iteration jitted body
    (ops/solvers.FIXED_KRYLOV) — the native counterpart of the reference
    default solver's `cgs cg` block
    (example_problems/Poisson/2D_FD_Poisson_fromL2.exa3:5-9).
    """

    def build(level_idx: int, u, f, predecessor=None):
        level = levels[level_idx]
        state = (u, f)
        for _ in range(pre_smoothing):
            state = smooth(state, level, omega, partitioning, smoother_factory)
            state[0].predecessor = predecessor
        u_s, _ = state
        residual = base.Residual(level.operator, u_s, f)
        f_c = base.Multiplication(level.restriction, residual)
        if level_idx + 1 < len(levels):
            coarse_level = levels[level_idx + 1]
            u_c = system.ZeroApproximation(coarse_level.grid)
            correction_c = u_c
            for _ in range(gamma):
                correction_c = build(level_idx + 1, correction_c, f_c,
                                     predecessor)
            correction = base.Multiplication(level.prolongation, correction_c)
        else:
            op_c = coarse_operator
            if op_c is None:
                raise ValueError("coarsest-level operator required")
            if coarse_krylov is not None:
                from ..ir.krylov import KrylovSubspaceMethod
                cgs = KrylovSubspaceMethod(coarse_krylov, op_c,
                                           coarse_krylov_iterations)
            else:
                cgs = base.CoarseGridSolver(op_c, coarse_solver_expression)
            correction_c = base.Multiplication(cgs, f_c)
            correction = base.Multiplication(level.prolongation, correction_c)
        cycle = base.Cycle(u_s, f, correction, relaxation_factor=1.0,
                           predecessor=predecessor)
        state = (cycle, f)
        for _ in range(post_smoothing):
            state = smooth(state, level, omega, partitioning, smoother_factory)
            state[0].predecessor = predecessor
        return state[0]

    u0 = levels[0].approximation
    return build(0, u0, rhs)


def f_cycle(levels: Sequence[LevelContext], rhs, *,
            pre_smoothing: int = 2, post_smoothing: int = 1,
            omega: float = 1.15, partitioning=part.RedBlack,
            smoother_factory: Callable = smoother.generate_collective_jacobi,
            coarse_solver_expression=None,
            coarse_operator: Optional[system.Operator] = None) -> base.Cycle:
    """Build an F-cycle expression tree: each coarse-grid problem is
    solved by an F-cycle followed by a V-cycle on the same level (the
    classic F-recursion; BASELINE.json north star lists evolved V/F
    cycles on Helmholtz)."""

    def build(level_idx: int, u, f, shape: str, predecessor=None):
        level = levels[level_idx]
        state = (u, f)
        for _ in range(pre_smoothing):
            state = smooth(state, level, omega, partitioning,
                           smoother_factory)
            state[0].predecessor = predecessor
        u_s, _ = state
        residual = base.Residual(level.operator, u_s, f)
        f_c = base.Multiplication(level.restriction, residual)
        if level_idx + 1 < len(levels):
            u_c = system.ZeroApproximation(levels[level_idx + 1].grid)
            if shape == "F":
                correction_c = build(level_idx + 1, u_c, f_c, "F",
                                     predecessor)
                correction_c = build(level_idx + 1, correction_c, f_c, "V",
                                     predecessor)
            else:
                correction_c = build(level_idx + 1, u_c, f_c, "V",
                                     predecessor)
            correction = base.Multiplication(level.prolongation, correction_c)
        else:
            if coarse_operator is None:
                raise ValueError("coarsest-level operator required")
            cgs = base.CoarseGridSolver(coarse_operator,
                                        coarse_solver_expression)
            correction = base.Multiplication(
                level.prolongation, base.Multiplication(cgs, f_c))
        cycle = base.Cycle(u_s, f, correction, relaxation_factor=1.0,
                           predecessor=predecessor)
        state = (cycle, f)
        for _ in range(post_smoothing):
            state = smooth(state, level, omega, partitioning,
                           smoother_factory)
            state[0].predecessor = predecessor
        return state[0]

    return build(0, levels[0].approximation, rhs, "F")


def fas_v_cycle(levels: Sequence[LevelContext], rhs, *,
                coarse_operator: system.Operator,
                pre_smoothing: int = 2, post_smoothing: int = 2,
                omega: float = 0.8, partitioning=part.Single,
                smoother_factory: Optional[Callable] = None,
                newton_steps: int = 1) -> base.Cycle:
    """Build a nonlinear FAS V-cycle expression tree.

    Tau-corrected coarse right-hand side ``f_c = R r + A_c (R u)`` with the
    coarse solve seeded by the restricted solution and the coarse-grid
    correction ``P (u_c - R u)`` (reference ir/reference_cycles.py:131-177,
    exastencils_FAS.py:121-147).  The default smoother is the damped
    Newton-Jacobi of the reference FAS template
    (FAS_2D_Basic_template.exa4 Smoother, omega=0.8).
    """
    if smoother_factory is None:
        def smoother_factory(op):
            return smoother.generate_jacobi_newton(op, newton_steps)

    def smooth_step(u, f, level, predecessor):
        residual = base.Residual(level.operator, u, f)
        corr = base.Multiplication(base.Inverse(smoother_factory(level.operator)),
                                   residual)
        return base.Cycle(u, f, corr, partitioning=partitioning,
                          relaxation_factor=omega, predecessor=predecessor)

    def seed_with_restricted_solution(u_c0, Ru, f_c):
        # coarse initial guess = R u: cycle value = 0 + 1.0 * Ru
        return base.Cycle(u_c0, f_c, Ru, relaxation_factor=1.0)

    def build(idx, u, f, predecessor=None):
        level = levels[idx]
        for _ in range(pre_smoothing):
            u = smooth_step(u, f, level, predecessor)
        R, P = level.restriction, level.prolongation
        residual = base.Residual(level.operator, u, f)
        op_c = (levels[idx + 1].operator if idx + 1 < len(levels)
                else coarse_operator)
        Ru = base.Multiplication(R, u)
        f_c = base.Addition(base.Multiplication(R, residual),
                            base.Multiplication(op_c, Ru))
        if idx + 1 < len(levels):
            u_c0 = system.ZeroApproximation(levels[idx + 1].grid)
            u_c = build(idx + 1, seed_with_restricted_solution(u_c0, Ru, f_c),
                        f_c, predecessor)
        else:
            cgs = base.CoarseGridSolver(op_c, initial_guess=Ru)
            u_c = base.Multiplication(cgs, f_c)
        correction = base.Multiplication(P, base.Subtraction(u_c, Ru))
        u = base.Cycle(u, f, correction, relaxation_factor=1.0,
                       predecessor=predecessor)
        for _ in range(post_smoothing):
            u = smooth_step(u, f, level, predecessor)
        return u

    return build(0, levels[0].approximation, rhs)
