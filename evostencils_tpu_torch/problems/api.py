"""Copy of evostencils_tpu/problems/api.py, kept in the port so that it imports
nothing of the JAX package.

Problem definitions: native Python replacement of ExaSlang problem files.

The reference defines each problem as ExaSlang `.exa2/.exa3/.knowledge`
files parsed back into Python (reference code_generation/parser.py:25-142,
example_problems/*).  Here a :class:`Problem` carries the same information
directly: per-level system operators, transfers, field layout, boundary
handling, convergence targets — everything the grammar, the compiler and the
benchmarks need.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..grids import Grid, unit_interval_grid, coarsen
from ..ir import base, system
from ..stencils import gallery
from ..compiler.cycles import LevelContext


@dataclass
class Problem:
    """A PDE problem over a grid hierarchy.

    ``level_contexts[k]`` is the bundle for level ``max_level - k`` (finest
    first); ``coarsest_operator`` lives one level below the last context.
    """
    name: str
    dimension: int
    min_level: int
    max_level: int
    fields: List[str]
    level_contexts: List[LevelContext]
    coarsest_operator: system.Operator
    rhs_entity: system.RightHandSide
    target_reduction: float = 1e-12
    max_iterations: int = 100
    rhs_builder: Optional[Callable] = None   # (dtype) -> tuple of arrays
    dtype: object = np.float64
    # nonlinear extension (FAS): callable term and its derivative, see
    # problems/fas.py
    nonlinear_term: Optional[Callable] = None
    nonlinear_derivative: Optional[Callable] = None
    # analytic solution at interior nodes for discretization-error checks
    exact_solution: Optional[Callable] = None
    # outer Krylov wrapper (e.g. Helmholtz preconditioned BiCGStab); the
    # evolved cycle then acts as the preconditioner, see problems/helmholtz.py
    outer_solver: Optional[object] = None
    # the fields are components of ONE logical (complex) field — e.g. the
    # split-complex Helmholtz (re, im) pair.  The grammar then makes
    # "decoupled" smoothers collective so the search space matches the
    # complex formulation's (per-field diagonal smoothing of a split pair
    # ignores the re/im coupling — a choice the reference's complex search
    # space cannot express and which diverges on indefinite operators).
    coupled_fields: bool = False

    @property
    def finest_grid(self) -> List[Grid]:
        return self.level_contexts[0].grid

    @property
    def approximation(self) -> system.Approximation:
        return self.level_contexts[0].approximation

    def build_rhs(self):
        if self.rhs_builder is None:
            raise ValueError(f"problem {self.name} has no rhs builder")
        return self.rhs_builder(self.dtype)

    @property
    def levels_total(self) -> int:
        return self.max_level - self.min_level + 1


def node_positions(grid: Grid):
    """Interior node coordinate arrays (meshgrid, ij indexing)."""
    axes = [np.arange(1, n + 1) * h for n, h in zip(grid.size, grid.spacing)]
    return np.meshgrid(*axes, indexing="ij")


def boundary_ring(grid: Grid, fn) -> np.ndarray:
    """Full node array (n+2 per axis) with ``fn`` evaluated on the boundary
    ring and zeros in the interior."""
    nodes = tuple(n + 2 for n in grid.size)
    axes = [np.arange(0, n + 2) * h for n, h in zip(grid.size, grid.spacing)]
    mesh = np.meshgrid(*axes, indexing="ij")
    values = np.asarray(fn(*mesh), dtype=np.result_type(fn(*[m[:1] for m in mesh]),
                                                        np.float64))
    interior = tuple(slice(1, 1 + n) for n in grid.size)
    ring = values.copy()
    ring[interior] = 0
    return ring


def fold_dirichlet(stencil, grid: Grid, boundary_fn, f_interior=None) -> np.ndarray:
    """RHS for the interior system with inhomogeneous Dirichlet data folded
    in: b = f - A|_boundary g  (the reference delegates this to ExaStencils'
    generated boundary handling; see 2D_FD_Poisson_fromL2.exa2 boundary
    clause)."""
    ring = boundary_ring(grid, boundary_fn)
    contrib = np.zeros(tuple(grid.size), dtype=ring.dtype)
    for offset, value in stencil.entries:
        sl = tuple(slice(1 + o, 1 + o + n) for o, n in zip(offset, grid.size))
        contrib = contrib + value * ring[sl]
    b = -contrib
    if f_interior is not None:
        b = b + f_interior
    return b


def scalar_hierarchy(name: str, dimension: int, max_level: int, min_level: int,
                     operator_generator, *,
                     restriction_generator=None, prolongation_generator=None,
                     field_name: str = "u") -> Tuple[List[LevelContext],
                                                     system.Operator]:
    """Build per-level contexts for a scalar PDE on the unit box."""
    cf = (2,) * dimension
    if restriction_generator is None:
        restriction_generator = gallery.FullWeightingRestrictionGenerator(cf)
    if prolongation_generator is None:
        prolongation_generator = gallery.MultilinearInterpolationGenerator(cf)
    contexts = []
    for level in range(max_level, min_level, -1):
        g = unit_interval_grid(dimension, level)
        gc = unit_interval_grid(dimension, level - 1)
        op = system.Operator(
            f"A_{level}", [[base.Operator("A", g, operator_generator)]])
        restriction = system.Restriction(
            f"R_{level}", [base.Restriction("R", g, gc, restriction_generator)])
        prolongation = system.Prolongation(
            f"P_{level}", [base.Prolongation("P", g, gc, prolongation_generator)])
        approx = system.Approximation(
            field_name, [base.Approximation(field_name, g)])
        contexts.append(LevelContext(operator=op, restriction=restriction,
                                     prolongation=prolongation,
                                     approximation=approx, grid=[g]))
    g_min = unit_interval_grid(dimension, min_level)
    coarsest = system.Operator(
        f"A_{min_level}", [[base.Operator("A", g_min, operator_generator)]])
    return contexts, coarsest
