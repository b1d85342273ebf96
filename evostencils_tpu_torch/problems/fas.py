"""Copy of evostencils_tpu/problems/fas.py, kept in the port so that it
imports nothing of the JAX package.  ``FASOperatorGenerator``'s nonlinear
callables take and return torch tensors (the JAX module's take
``jax.numpy`` arrays, fas.py:39-51), and the ``rhs_builder`` closure
returns the numpy float64 right-hand side, where the JAX package's returns
a ``jax.numpy`` array in the asked dtype (fas.py:86-89);
``problems.poisson.build_rhs`` moves it to a device in the asked dtype.

The JAX module's docstring:

FAS_2D_Basic: nonlinear full-approximation-scheme model problem.

Reference example_problems/FAS_2D_Basic/FAS_2D_Basic_template.exa4:
    -Lap u + gam * exp(u) * u = f,   gam = 20, levels 6->10,
    exact solution u = (x^2 - x^3) sin(3 pi y)  (zero Dirichlet boundary),
    damped Newton-Jacobi smoother omega=0.8:
        u <- u + w (f - A(u)) / (diag(Lap) + gam (1 + u) e^u),
    coarsest-grid solver = 200 smoother sweeps, target residual 1e-10,
    at most 300 cycles.
"""

from __future__ import annotations

import numpy as np
import torch

from ..grids import Grid, unit_interval_grid
from ..ir import base, system
from ..stencils import gallery
from ..compiler.cycles import LevelContext
from .api import Problem, node_positions

GAMMA = 20.0


class FASOperatorGenerator:
    """Nonlinear operator A(u) = Laplace u + gam * exp(u) * u.

    ``generate_stencil`` returns the linear part; the nonlinear callables
    are consumed by the cycle compiler (compiler/lower nonlinear paths).
    """

    def __init__(self, gamma: float = GAMMA):
        self.gamma = gamma

    def generate_stencil(self, grid: Grid):
        return gallery.Poisson2D().generate_stencil(grid)

    # -- nonlinear protocol ---------------------------------------------------
    def nonlinear_term(self, u: torch.Tensor) -> torch.Tensor:
        return self.gamma * torch.exp(u) * u

    def nonlinear_coefficient(self, u: torch.Tensor) -> torch.Tensor:
        """Picard freeze: A(u) ~ (L + c(u) I) u with c(u) = gam e^u."""
        return self.gamma * torch.exp(u)

    def nonlinear_derivative(self, u: torch.Tensor) -> torch.Tensor:
        """d/du [gam e^u u] = gam (1 + u) e^u (Newton denominator)."""
        return self.gamma * (1.0 + u) * torch.exp(u)


def _u_exact(x, y):
    return (x ** 2 - x ** 3) * np.sin(3 * np.pi * y)


def _rhs(x, y, gamma=GAMMA):
    return ((9.0 * np.pi ** 2 + gamma * np.exp(_u_exact(x, y)))
            * (x ** 2 - x ** 3) + 6.0 * x - 2.0) * np.sin(3 * np.pi * y)


def fas_2d_basic(max_level: int = 10, min_level: int = 6,
                 gamma: float = GAMMA) -> Problem:
    cf = (2, 2)
    rgen = gallery.FullWeightingRestrictionGenerator(cf)
    pgen = gallery.MultilinearInterpolationGenerator(cf)
    gen = FASOperatorGenerator(gamma)
    contexts = []
    for level in range(max_level, min_level, -1):
        g = unit_interval_grid(2, level)
        gc = unit_interval_grid(2, level - 1)
        op = system.Operator(f"A_{level}", [[base.Operator("A", g, gen)]])
        restriction = system.Restriction(
            f"R_{level}", [base.Restriction("R", g, gc, rgen)])
        prolongation = system.Prolongation(
            f"P_{level}", [base.Prolongation("P", g, gc, pgen)])
        approx = system.Approximation("u", [base.Approximation("u", g)])
        contexts.append(LevelContext(operator=op, restriction=restriction,
                                     prolongation=prolongation,
                                     approximation=approx, grid=[g]))
    g_min = unit_interval_grid(2, min_level)
    coarsest = system.Operator(f"A_{min_level}",
                               [[base.Operator("A", g_min, gen)]])
    grid = contexts[0].grid[0]
    rhs_entity = system.RightHandSide("f", [base.RightHandSide("f", grid)])

    def rhs_builder(dtype=np.float64):
        # numpy float64 in every precision; build_rhs casts
        X, Y = node_positions(grid)
        return (_rhs(X, Y, gamma),)

    def exact_solution():
        X, Y = node_positions(grid)
        return (_u_exact(X, Y),)

    return Problem(name="FAS_2D_Basic", dimension=2, min_level=min_level,
                   max_level=max_level, fields=["u"],
                   level_contexts=contexts, coarsest_operator=coarsest,
                   rhs_entity=rhs_entity, rhs_builder=rhs_builder,
                   target_reduction=1e-10, max_iterations=300,
                   nonlinear_term=gen.nonlinear_term,
                   nonlinear_derivative=gen.nonlinear_derivative,
                   exact_solution=exact_solution)
