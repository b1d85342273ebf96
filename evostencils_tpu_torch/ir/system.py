"""Copy of evostencils_tpu/ir/system.py, kept in the port so that it imports
nothing of the JAX package.

Block-system lift of the IR for vector-valued PDEs.

A ``system.Operator`` is a matrix of base operators acting on a list of grid
functions (one per field); transfers embed diagonally.  Smoother markers
``Diagonal`` (decoupled), ``ElementwiseDiagonal`` (collective point) and
``Jacobian`` (FAS Newton) tell the compiler *which* local system to invert.

Reference parity: evostencils/ir/system.py:5-158.
"""

from __future__ import annotations

from typing import List, Tuple

from . import base


class System(base.Expression):
    def __init__(self, name, entries, shape):
        self._name = name
        self._entries = entries
        self._shape = shape

    @property
    def name(self):
        return self._name

    @property
    def entries(self):
        return self._entries

    @property
    def shape(self):
        return self._shape

    def __str__(self):
        return self._name


class Operator(System):
    """Matrix of base operators: entries[i][j] maps field j to equation i."""

    def __init__(self, name, entries):
        rows = sum(row[0].shape[0] for row in entries)
        cols = sum(e.shape[1] for e in entries[0])
        super().__init__(name, entries, (rows, cols))

    @property
    def grid(self):
        return [e.grid for e in self.entries[0]]

    @property
    def number_of_fields(self):
        return len(self.entries)


class ZeroOperator(Operator):
    def __init__(self, grid: List[base.Grid], name="0"):
        entries = [[base.ZeroOperator(g) for g in grid] for _ in grid]
        super().__init__(name, entries)


class Identity(Operator):
    def __init__(self, grid: List[base.Grid], name="I"):
        entries = [[base.Identity(g) if i == j else base.ZeroOperator(g)
                    for j, g in enumerate(grid)] for i in range(len(grid))]
        super().__init__(name, entries)


class Approximation(System):
    """Stacked grid functions, one entry per field."""

    def __init__(self, name, entries):
        if len(entries) == 1:
            shape = entries[0].shape
        else:
            shape = (sum(e.shape[0] for e in entries), entries[0].shape[1])
        super().__init__(name, entries, shape)

    @property
    def grid(self):
        return [e.grid for e in self.entries]

    @property
    def predecessor(self):
        return None


class RightHandSide(Approximation):
    pass


class ZeroApproximation(Approximation):
    def __init__(self, grid: List[base.Grid], name="0"):
        super().__init__(name, [base.ZeroApproximation(g) for g in grid])


class InterGridOperator(Operator):
    """Diagonal embedding of per-field intergrid operators."""

    def __init__(self, name, ops, zero_type):
        entries = [[op if i == j else zero_type(op.fine_grid, op.coarse_grid)
                    for j in range(len(ops))] for i, op in enumerate(ops)]
        super().__init__(name, entries)


class Restriction(InterGridOperator):
    def __init__(self, name, ops):
        super().__init__(name, ops, base.ZeroRestriction)


class Prolongation(InterGridOperator):
    def __init__(self, name, ops):
        super().__init__(name, ops, base.ZeroProlongation)


class Diagonal(base.UnaryExpression):
    """Decoupled point smoother: diagonal stencil entry of the diagonal
    blocks only (fields smoothed independently)."""

    def __str__(self):
        return f"{self.operand}.field_diag"


class ElementwiseDiagonal(base.UnaryExpression):
    """Collective point smoother: at each grid point, the full
    m x m system of central stencil entries over all fields."""

    def __str__(self):
        return "D"


class Jacobian(base.UnaryExpression):
    """FAS marker: add the Jacobian of the nonlinear term, with
    ``n_newton_steps`` inner Newton iterations."""

    def __init__(self, operand, n_newton_steps: int):
        super().__init__(operand)
        self.n_newton_steps = n_newton_steps

    def __str__(self):
        return f"J[{self.n_newton_steps}]"


def get_coarse_grid(grid: List[base.Grid], coarsening_factors):
    return [base.get_coarse_grid(g, cf) for g, cf in zip(grid, coarsening_factors)]


def get_coarse_approximation(approximation: Approximation, coarsening_factors):
    return Approximation(approximation.name,
                         [base.Approximation(f"{e.name}_c",
                                             base.get_coarse_grid(e.grid, cf))
                          for e, cf in zip(approximation.entries, coarsening_factors)])


def get_coarse_rhs(rhs: RightHandSide, coarsening_factors):
    return RightHandSide(rhs.name,
                         [base.RightHandSide(f"{e.name}_c",
                                             base.get_coarse_grid(e.grid, cf))
                          for e, cf in zip(rhs.entries, coarsening_factors)])


def get_coarse_operator(operator: Operator, coarse_grid):
    entries = [[base.Operator(e.name, coarse_grid[i], e.stencil_generator)
                for e in row] for i, row in enumerate(operator.entries)]
    return Operator(operator.name, entries)
