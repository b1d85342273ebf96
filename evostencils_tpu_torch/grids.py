"""Copy of evostencils_tpu/grids.py, kept in the port so that it imports
nothing of the JAX package.

Structured grid hierarchy.

A :class:`Grid` describes the set of *interior* unknowns of a uniform
tensor-product grid on the unit box with homogeneous Dirichlet boundary:
level ``l`` has ``2**l - 1`` interior nodes per axis with spacing
``1 / 2**l``.  Arrays representing fields on a grid have exactly shape
``grid.size``; the Dirichlet boundary ring is implicit (value 0) and is
materialized only inside the stencil-application kernels via padding.

Reference parity: evostencils/ir/base.py:168-196 (Grid) and :700-716
(coarsening helpers).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import reduce
from operator import mul as _mul
from typing import Tuple


@dataclass(frozen=True)
class Grid:
    size: Tuple[int, ...]      # number of interior unknowns per axis
    spacing: Tuple[float, ...]  # mesh width per axis
    level: int                 # discretization level (finer = larger)

    def __post_init__(self):
        if len(self.size) != len(self.spacing):
            raise ValueError("size and spacing must have the same rank")

    @property
    def dimension(self) -> int:
        return len(self.size)

    @property
    def number_of_unknowns(self) -> int:
        return reduce(_mul, self.size, 1)

    def __repr__(self):
        return f"Grid(size={self.size}, spacing={self.spacing}, level={self.level})"


def unit_interval_grid(dimension: int, level: int) -> Grid:
    """Level-``level`` grid on the unit box: 2**level - 1 interior nodes/axis."""
    n = 2 ** level - 1
    h = 1.0 / 2 ** level
    return Grid((n,) * dimension, (h,) * dimension, level)


def coarsen(grid: Grid, coarsening_factor: Tuple[int, ...] | None = None) -> Grid:
    """Standard coarsening: interior nodes (n-1)/2 per axis for factor 2.

    For the unit-box Dirichlet convention ``n = 2**l - 1`` the coarse grid is
    exactly ``unit_interval_grid(d, l-1)``.
    """
    if coarsening_factor is None:
        coarsening_factor = (2,) * grid.dimension
    size = tuple((n + 1) // f - 1 if (n + 1) % f == 0 else n // f
                 for n, f in zip(grid.size, coarsening_factor))
    spacing = tuple(h * f for h, f in zip(grid.spacing, coarsening_factor))
    return Grid(size, spacing, grid.level - 1)


def hierarchy(dimension: int, max_level: int, min_level: int) -> Tuple[Grid, ...]:
    """Grids from finest (max_level) down to coarsest (min_level), inclusive."""
    if min_level < 1 or max_level < min_level:
        raise ValueError("need 1 <= min_level <= max_level")
    return tuple(unit_interval_grid(dimension, l)
                 for l in range(max_level, min_level - 1, -1))
