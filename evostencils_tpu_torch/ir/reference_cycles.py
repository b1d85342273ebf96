"""Copy of evostencils_tpu/ir/reference_cycles.py, kept in the port so that
it imports nothing of the JAX package.

Hand-constructed reference cycles — executable documentation of IR
assembly (reference ir/reference_cycles.py:5-277).

Each function builds a fixed V(2,2) cycle expression node-by-node, without
the convenience builders in compiler/cycles.py, so the exact IR shapes the
grammar must produce stay visible: smoothing = ``Cycle(u, f, Inverse(L)·r)``,
coarse-grid correction = ``Cycle(u, f, P · solve(A_c, R·r))``, and the FAS
variants carry the tau-corrected right-hand side
``f_c = R r + A_c (R u)`` plus the ``u_c - R u`` error subtraction
(reference MARKed blocks at ir/reference_cycles.py:154-166, :204-262).

They double as known-good fixtures: tests check their measured convergence
factors against textbook values.
"""

from __future__ import annotations

from . import base, system, smoother
from . import partitioning as part


def _smooth(u, f, A, L, omega, partitioning, predecessor=None):
    residual = base.Residual(A, u, f)
    correction = base.Multiplication(base.Inverse(L), residual)
    return base.Cycle(u, f, correction, partitioning=partitioning,
                      relaxation_factor=omega, predecessor=predecessor)


def generate_v_22_cycle_two_grid(fine_level, coarse_operator,
                                 rhs: system.RightHandSide, *,
                                 omega: float = 1.0,
                                 partitioning=part.RedBlack) -> base.Cycle:
    """Two-grid V(2,2): 2 pre-smooth, exact coarse solve, 2 post-smooth
    (reference ir/reference_cycles.py:88-127).

    ``fine_level`` is a compiler.cycles.LevelContext; ``coarse_operator``
    the operator on the grid below it.
    """
    u, f = fine_level.approximation, rhs
    A = fine_level.operator
    L = smoother.generate_collective_jacobi(A)

    u = _smooth(u, f, A, L, omega, partitioning)       # pre-smoothing 1
    u = _smooth(u, f, A, L, omega, partitioning)       # pre-smoothing 2

    residual = base.Residual(A, u, f)
    f_c = base.Multiplication(fine_level.restriction, residual)
    correction_c = base.Multiplication(base.CoarseGridSolver(coarse_operator),
                                       f_c)
    correction = base.Multiplication(fine_level.prolongation, correction_c)
    u = base.Cycle(u, f, correction, relaxation_factor=omega)  # CGC

    u = _smooth(u, f, A, L, omega, partitioning)       # post-smoothing 1
    u = _smooth(u, f, A, L, omega, partitioning)       # post-smoothing 2
    return u


def generate_v_22_cycle_three_grid(fine_level, coarse_level, coarse_operator,
                                   rhs: system.RightHandSide, *,
                                   omega: float = 1.0,
                                   partitioning=part.RedBlack) -> base.Cycle:
    """Three-grid V(2,2) with the middle level solved by a nested V(2,2)
    (reference ir/reference_cycles.py:5-85).  ``predecessor`` back-pointers
    link the coarse cycles to the fine cycle they correct."""
    u, f = fine_level.approximation, rhs
    A = fine_level.operator
    L = smoother.generate_collective_jacobi(A)

    u = _smooth(u, f, A, L, omega, partitioning)
    u = _smooth(u, f, A, L, omega, partitioning)
    fine_cycle = u

    residual = base.Residual(A, u, f)
    f_c = base.Multiplication(fine_level.restriction, residual)

    A_c = coarse_level.operator
    L_c = smoother.generate_collective_jacobi(A_c)
    u_c = system.ZeroApproximation(coarse_level.grid)
    u_c = _smooth(u_c, f_c, A_c, L_c, omega, partitioning,
                  predecessor=fine_cycle)
    u_c = _smooth(u_c, f_c, A_c, L_c, omega, partitioning,
                  predecessor=fine_cycle)

    residual_c = base.Residual(A_c, u_c, f_c)
    f_cc = base.Multiplication(coarse_level.restriction, residual_c)
    correction_cc = base.Multiplication(
        base.CoarseGridSolver(coarse_operator), f_cc)
    correction_c = base.Multiplication(coarse_level.prolongation,
                                       correction_cc)
    u_c = base.Cycle(u_c, f_c, correction_c, relaxation_factor=omega,
                     predecessor=fine_cycle)

    u_c = _smooth(u_c, f_c, A_c, L_c, omega, partitioning,
                  predecessor=fine_cycle)
    u_c = _smooth(u_c, f_c, A_c, L_c, omega, partitioning,
                  predecessor=fine_cycle)

    correction = base.Multiplication(fine_level.prolongation, u_c)
    u = base.Cycle(u, f, correction, relaxation_factor=omega)

    u = _smooth(u, f, A, L, omega, partitioning)
    u = _smooth(u, f, A, L, omega, partitioning)
    return u


def generate_fas_v_22_cycle_two_grid(fine_level, coarse_operator,
                                     rhs: system.RightHandSide, *,
                                     omega: float = 0.8,
                                     newton_steps: int = 1) -> base.Cycle:
    """Nonlinear two-grid FAS V(2,2) with Newton-Jacobi smoothing
    (reference ir/reference_cycles.py:131-177)."""
    u, f = fine_level.approximation, rhs
    A = fine_level.operator
    L = smoother.generate_jacobi_newton(A, newton_steps)

    u = _smooth(u, f, A, L, omega, part.Single)
    u = _smooth(u, f, A, L, omega, part.Single)

    residual = base.Residual(A, u, f)
    Ru = base.Multiplication(fine_level.restriction, u)
    # FAS tau-corrected coarse rhs: f_c = R r + A_c (R u)
    f_c = base.Addition(
        base.Multiplication(fine_level.restriction, residual),
        base.Multiplication(coarse_operator, Ru))
    cgs = base.CoarseGridSolver(coarse_operator, initial_guess=Ru)
    u_c = base.Multiplication(cgs, f_c)
    # FAS error: e_c = u_c - R u, prolongated to the fine grid
    correction = base.Multiplication(fine_level.prolongation,
                                     base.Subtraction(u_c, Ru))
    u = base.Cycle(u, f, correction, relaxation_factor=1.0)

    u = _smooth(u, f, A, L, omega, part.Single)
    u = _smooth(u, f, A, L, omega, part.Single)
    return u


def generate_fas_v_22_cycle_three_grid(fine_level, coarse_level,
                                       coarse_operator,
                                       rhs: system.RightHandSide, *,
                                       omega: float = 0.8,
                                       newton_steps: int = 1) -> base.Cycle:
    """Nonlinear three-grid FAS V(2,2)
    (reference ir/reference_cycles.py:179-277)."""
    u, f = fine_level.approximation, rhs
    A = fine_level.operator
    L = smoother.generate_jacobi_newton(A, newton_steps)

    u = _smooth(u, f, A, L, omega, part.Single)
    u = _smooth(u, f, A, L, omega, part.Single)
    fine_cycle = u

    residual = base.Residual(A, u, f)
    Ru = base.Multiplication(fine_level.restriction, u)
    A_c = coarse_level.operator
    f_c = base.Addition(
        base.Multiplication(fine_level.restriction, residual),
        base.Multiplication(A_c, Ru))

    # seed the middle level with the restricted solution
    u_c0 = system.ZeroApproximation(coarse_level.grid)
    u_c = base.Cycle(u_c0, f_c, Ru, relaxation_factor=1.0,
                     predecessor=fine_cycle)
    L_c = smoother.generate_jacobi_newton(A_c, newton_steps)
    u_c = _smooth(u_c, f_c, A_c, L_c, omega, part.Single,
                  predecessor=fine_cycle)
    u_c = _smooth(u_c, f_c, A_c, L_c, omega, part.Single,
                  predecessor=fine_cycle)

    residual_c = base.Residual(A_c, u_c, f_c)
    Ru_c = base.Multiplication(coarse_level.restriction, u_c)
    f_cc = base.Addition(
        base.Multiplication(coarse_level.restriction, residual_c),
        base.Multiplication(coarse_operator, Ru_c))
    cgs = base.CoarseGridSolver(coarse_operator, initial_guess=Ru_c)
    u_cc = base.Multiplication(cgs, f_cc)
    correction_c = base.Multiplication(coarse_level.prolongation,
                                       base.Subtraction(u_cc, Ru_c))
    u_c = base.Cycle(u_c, f_c, correction_c, relaxation_factor=1.0,
                     predecessor=fine_cycle)

    u_c = _smooth(u_c, f_c, A_c, L_c, omega, part.Single,
                  predecessor=fine_cycle)
    u_c = _smooth(u_c, f_c, A_c, L_c, omega, part.Single,
                  predecessor=fine_cycle)

    correction = base.Multiplication(fine_level.prolongation,
                                     base.Subtraction(u_c, Ru))
    u = base.Cycle(u, f, correction, relaxation_factor=1.0)

    u = _smooth(u, f, A, L, omega, part.Single)
    u = _smooth(u, f, A, L, omega, part.Single)
    return u
