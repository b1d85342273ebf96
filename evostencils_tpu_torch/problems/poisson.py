"""Poisson model problems for the port: a copy of the Poisson part of
evostencils_tpu/problems/poisson.py (``poisson_2d``, ``poisson_3d``,
``poisson_2d_variable`` and their data), kept in the port so that it imports nothing of the JAX
package.  The ``rhs_builder`` closures return numpy arrays here, where the
JAX package's return ``jax.numpy`` arrays; :func:`build_rhs` moves them to
a device.

The JAX module's docstring:

2D (levels 5->9): -Lap u = pi^2 cos(pi x) - 4 pi^2 sin(2 pi y) with exact
Dirichlet data u = cos(pi x) - sin(2 pi y)
(2D_FD_Poisson_fromL2.exa2:1-12).
3D (levels 2->6): Laplace equation with harmonic boundary data
u = x^2 - y^2/2 - z^2/2, RHS = 0 (3D_FD_Poisson_fromL2.exa2:1-10).
Reference solver config: V-cycle, RB-GS omega=1.15, 2 pre / 1 post,
CG coarse solve, residual reduction 1e-12
(2D_FD_Poisson_fromL2.exa3 `generate solver` block).
"""

from __future__ import annotations

import numpy as np
import torch

from ..grids import unit_interval_grid
from ..ir import base, system
from ..ops.apply import complex_dtype
from ..stencils import gallery
from .api import Problem, scalar_hierarchy, node_positions, fold_dirichlet


def _u_exact_2d(x, y):
    return np.cos(np.pi * x) - np.sin(2.0 * np.pi * y)


def _f_2d(x, y):
    return np.pi ** 2 * np.cos(np.pi * x) - 4.0 * np.pi ** 2 * np.sin(2.0 * np.pi * y)


def _u_exact_3d(x, y, z):
    return x * x - 0.5 * y * y - 0.5 * z * z


def poisson_2d(max_level: int = 9, min_level: int = 5) -> Problem:
    contexts, coarsest = scalar_hierarchy(
        "Poisson2D", 2, max_level, min_level, gallery.Poisson2D())
    rhs_entity = system.RightHandSide(
        "f", [base.RightHandSide("f", contexts[0].grid[0])])
    grid = contexts[0].grid[0]
    stencil = gallery.Poisson2D().generate_stencil(grid)

    def rhs_builder(dtype):
        X, Y = node_positions(grid)
        b = fold_dirichlet(stencil, grid, _u_exact_2d, _f_2d(X, Y))
        return (np.asarray(b, dtype=dtype),)

    def exact_solution():
        X, Y = node_positions(grid)
        return (_u_exact_2d(X, Y),)

    return Problem(name="Poisson2D", dimension=2, min_level=min_level,
                   max_level=max_level, fields=["u"],
                   level_contexts=contexts, coarsest_operator=coarsest,
                   rhs_entity=rhs_entity, rhs_builder=rhs_builder,
                   target_reduction=1e-12, max_iterations=100,
                   exact_solution=exact_solution)


def poisson_3d(max_level: int = 6, min_level: int = 2) -> Problem:
    contexts, coarsest = scalar_hierarchy(
        "Poisson3D", 3, max_level, min_level, gallery.Poisson3D())
    rhs_entity = system.RightHandSide(
        "f", [base.RightHandSide("f", contexts[0].grid[0])])
    grid = contexts[0].grid[0]
    stencil = gallery.Poisson3D().generate_stencil(grid)

    def rhs_builder(dtype):
        b = fold_dirichlet(stencil, grid, _u_exact_3d)   # RHS_u = 0
        return (np.asarray(b, dtype=dtype),)

    def exact_solution():
        X, Y, Z = node_positions(grid)
        return (_u_exact_3d(X, Y, Z),)

    return Problem(name="Poisson3D", dimension=3, min_level=min_level,
                   max_level=max_level, fields=["u"],
                   level_contexts=contexts, coarsest_operator=coarsest,
                   rhs_entity=rhs_entity, rhs_builder=rhs_builder,
                   target_reduction=1e-12, max_iterations=100,
                   exact_solution=exact_solution)


def poisson_2d_variable(max_level: int = 9, min_level: int = 5) -> Problem:
    """Variable-coefficient 2D Poisson -div(a grad u), a = exp(10 (x-x²)(y-y²))
    (poisson.py:86-111; reference gallery.py:93-136).

    The executable operator is the full per-node coefficient field
    (gallery.Poisson2DVariableCoefficients.generate_stencil_field); the
    position-frozen constant stencil is kept for Fourier-mode analysis,
    and the Dirichlet data is folded into b with it, as the JAX package
    folds it (poisson.py:100-105).
    """
    contexts, coarsest = scalar_hierarchy(
        "Poisson2DVar", 2, max_level, min_level,
        gallery.Poisson2DVariableCoefficients())
    rhs_entity = system.RightHandSide(
        "f", [base.RightHandSide("f", contexts[0].grid[0])])
    grid = contexts[0].grid[0]
    stencil = gallery.Poisson2DVariableCoefficients().generate_stencil(grid)

    def rhs_builder(dtype):
        X, Y = node_positions(grid)
        b = fold_dirichlet(stencil, grid, _u_exact_2d, _f_2d(X, Y))
        return (np.asarray(b, dtype=dtype),)

    return Problem(name="Poisson2DVar", dimension=2, min_level=min_level,
                   max_level=max_level, fields=["u"],
                   level_contexts=contexts, coarsest_operator=coarsest,
                   rhs_entity=rhs_entity, rhs_builder=rhs_builder)


#: problems whose right-hand side the port builds (their ``name``)
PORTED_RHS = ("Poisson2D", "Poisson3D", "Poisson2DVar", "LinearElasticity2D",
              "Helmholtz2D", "Helmholtz2DSplit", "FAS_2D_Basic")


def build_rhs(problem: Problem, *, dtype, device="cuda") -> tuple:
    """The fields of ``b`` for ``poisson_2d``, ``poisson_3d``,
    ``poisson_2d_variable``, ``elasticity.linear_elasticity_2d`` (two
    fields, u and v), ``helmholtz.helmholtz_2d``,
    ``helmholtz.helmholtz_2d_split`` (two real fields, re and im) or
    ``fas.fas_2d_basic``: the right-hand side with the Dirichlet data
    folded in, built in numpy float64 as
    evostencils_tpu/problems/poisson.py:43-47, :69-72, :100-105,
    elasticity.py:116-122 and fas.py:86-89 build it (RHS_u = 0 in 3D), or
    in complex128 as helmholtz.py:81-88 does (the split form its real and
    imaginary parts, helmholtz.py:239-244), then moved to ``device`` in
    ``dtype``; a
    complex right-hand side in the complex dtype of ``dtype``'s
    precision, complex64 for float32 and complex128 for float64
    (helmholtz.py:132-136)."""
    if problem.name not in PORTED_RHS:
        raise NotImplementedError(
            f"right-hand side of {problem.name} is not ported yet")
    return tuple(torch.tensor(b, device=device, dtype=complex_dtype(dtype)
                              if np.iscomplexobj(b) else dtype)
                 for b in problem.rhs_builder(np.float64))
