"""Copy of evostencils_tpu/problems/elasticity.py (lines 1-129: ``LAMBDA``,
``MU``, the block stencils, ``_EntryGenerator``, ``_v_boundary`` and
``linear_elasticity_2d``), kept in the port so that it imports nothing of
the JAX package.  The ``rhs_builder`` closure returns numpy arrays in the
asked dtype, where the JAX package's returns ``jax.numpy`` arrays
(elasticity.py:116-122); ``problems.poisson.build_rhs`` moves them to a
device.

The JAX module's docstring:

2D linear elasticity: coupled (u, v) block system.

Reference example_problems/LinearElasticity/2D_FD_LinearElasticity_fromL2:
    uEq: (lambda+mu)*(dxx*u + dxy*v) + lambda*Laplace*u == 0
    vEq: (lambda+mu)*(dxy*u + dyy*v) + lambda*Laplace*v == 0
with lambda=195, mu=130, Dirichlet data u=0 and
v = 0.4 sin(pi x)(1-x) x y on the boundary, levels 4->8, target 1e-12,
reference solver: coupled RB-GS omega=1.25 V(2,1), CG coarse
(.exa2:1-53, .exa3:2-16).

Note the ExaSlang stencils define the *negative* Laplacian-style operators
(dxx has -2/h^2 on the diagonal); the system is kept sign-faithful.
"""

from __future__ import annotations

import numpy as np

from ..grids import unit_interval_grid
from ..ir import base, system
from ..stencils import constant, gallery
from ..stencils.constant import Stencil
from ..compiler.cycles import LevelContext
from .api import Problem, fold_dirichlet

LAMBDA = 195.0
MU = 130.0


def _dxx(grid) -> Stencil:
    hx, _ = grid.spacing
    return Stencil([((0, 0), -2 / hx ** 2), ((-1, 0), 1 / hx ** 2),
                    ((1, 0), 1 / hx ** 2)])


def _dyy(grid) -> Stencil:
    _, hy = grid.spacing
    return Stencil([((0, 0), -2 / hy ** 2), ((0, -1), 1 / hy ** 2),
                    ((0, 1), 1 / hy ** 2)])


def _laplace(grid) -> Stencil:
    hx, hy = grid.spacing
    return Stencil([((0, 0), -2 / hx ** 2 - 2 / hy ** 2),
                    ((-1, 0), 1 / hx ** 2), ((1, 0), 1 / hx ** 2),
                    ((0, -1), 1 / hy ** 2), ((0, 1), 1 / hy ** 2)])


def _dxy(grid) -> Stencil:
    hx, hy = grid.spacing
    c = 1.0 / (4 * hx * hy)
    return Stencil([((-1, 1), -c), ((1, 1), c), ((-1, -1), c), ((1, -1), -c)])


def _block_entry(grid, field_index):
    """Block (i, j) stencil of the elasticity operator."""
    lam_mu = LAMBDA + MU
    i, j = field_index
    if i == 0 and j == 0:
        return constant.add(constant.scale(lam_mu, _dxx(grid)),
                            constant.scale(LAMBDA, _laplace(grid)))
    if i == 1 and j == 1:
        return constant.add(constant.scale(lam_mu, _dyy(grid)),
                            constant.scale(LAMBDA, _laplace(grid)))
    return constant.scale(lam_mu, _dxy(grid))


class _EntryGenerator:
    def __init__(self, field_index):
        self.field_index = field_index

    def generate_stencil(self, grid):
        return _block_entry(grid, self.field_index)


def _v_boundary(x, y):
    return 0.4 * np.sin(np.pi * x) * (1.0 - x) * x * y


def _block_operator(name, grid):
    return system.Operator(name, [
        [base.Operator("A00", grid, _EntryGenerator((0, 0))),
         base.Operator("A01", grid, _EntryGenerator((0, 1)))],
        [base.Operator("A10", grid, _EntryGenerator((1, 0))),
         base.Operator("A11", grid, _EntryGenerator((1, 1)))],
    ])


def linear_elasticity_2d(max_level: int = 8, min_level: int = 4) -> Problem:
    cf = (2, 2)
    rgen = gallery.FullWeightingRestrictionGenerator(cf)
    pgen = gallery.MultilinearInterpolationGenerator(cf)
    contexts = []
    for level in range(max_level, min_level, -1):
        g = unit_interval_grid(2, level)
        gc = unit_interval_grid(2, level - 1)
        op = _block_operator(f"A_{level}", g)
        restriction = system.Restriction(f"R_{level}", [
            base.Restriction("R_u", g, gc, rgen),
            base.Restriction("R_v", g, gc, rgen)])
        prolongation = system.Prolongation(f"P_{level}", [
            base.Prolongation("P_u", g, gc, pgen),
            base.Prolongation("P_v", g, gc, pgen)])
        approx = system.Approximation("x", [base.Approximation("u", g),
                                            base.Approximation("v", g)])
        contexts.append(LevelContext(operator=op, restriction=restriction,
                                     prolongation=prolongation,
                                     approximation=approx, grid=[g, g]))
    coarsest = _block_operator(f"A_{min_level}",
                               unit_interval_grid(2, min_level))
    grid = contexts[0].grid[0]
    rhs_entity = system.RightHandSide(
        "b", [base.RightHandSide("f_u", grid), base.RightHandSide("f_v", grid)])

    def rhs_builder(dtype):
        # fold the inhomogeneous Dirichlet data of v into both equations:
        # b_u through block (0, 1), b_v through block (1, 1), as the JAX
        # package folds them
        b_u = fold_dirichlet(_block_entry(grid, (0, 1)), grid, _v_boundary)
        b_v = fold_dirichlet(_block_entry(grid, (1, 1)), grid, _v_boundary)
        return (np.asarray(b_u, dtype=dtype), np.asarray(b_v, dtype=dtype))

    return Problem(name="LinearElasticity2D", dimension=2,
                   min_level=min_level, max_level=max_level,
                   fields=["u", "v"], level_contexts=contexts,
                   coarsest_operator=coarsest, rhs_entity=rhs_entity,
                   rhs_builder=rhs_builder, target_reduction=1e-12,
                   max_iterations=100)
