"""Right-hand sides of the Poisson model problems for the port.

The problem itself (grids, operators, transfers) comes from
``evostencils_tpu.problems.poisson``; only its ``rhs_builder``, which goes
through ``jax.numpy``, is replaced.
"""

from __future__ import annotations

import torch

from evostencils_tpu.problems.api import Problem, fold_dirichlet, node_positions
from evostencils_tpu.problems.poisson import _f_2d, _u_exact_2d


def build_rhs(problem: Problem, *, dtype, device) -> tuple:
    """The fields of ``b`` for ``poisson_2d``: the right-hand side with the
    Dirichlet data folded in, built in numpy float64 exactly as
    evostencils_tpu/problems/poisson.py:43-47 builds it, then moved to
    ``device`` in ``dtype``."""
    if problem.name != "Poisson2D":
        raise NotImplementedError(
            f"right-hand side of {problem.name} is not ported yet")
    grid = problem.finest_grid[0]
    stencil = problem.level_contexts[0].operator.entries[0][0] \
        .generate_stencil()
    X, Y = node_positions(grid)
    b = fold_dirichlet(stencil, grid, _u_exact_2d, _f_2d(X, Y))
    return (torch.tensor(b, dtype=dtype, device=device),)
