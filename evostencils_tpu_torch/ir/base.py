"""Copy of evostencils_tpu/ir/base.py, kept in the port so that it imports
nothing of the JAX package.

Multigrid expression IR.

One evolved multigrid cycle is a tree of these nodes.  The grammar (L2)
produces them, the cycle compiler (compiler/lower.py) lowers them to jitted
JAX programs, and the Fourier-mode analysis (prediction/convergence.py) maps
them to frequency symbols.  Node semantics mirror the reference IR
(evostencils/ir/base.py:9-724) with two structural changes:

* evaluation caches (lfa_symbol/valid/runtime) live *outside* the nodes in
  id-keyed memo tables owned by each consumer, keeping nodes lean, and
* every node exposes ``children`` for uniform traversal.

Only :class:`Cycle` is mutable (correction/relaxation_factor/partitioning/
predecessor) because the grammar's state-transition productions build cycles
incrementally (reference grammar/multigrid.py:238-385).
"""

from __future__ import annotations

from functools import reduce
from operator import mul as _mul
from typing import Optional, Tuple

from ..grids import Grid, coarsen
from ..stencils import constant, periodic, gallery
from . import partitioning as part


class Expression:
    """Base class for all IR nodes."""

    @property
    def shape(self) -> Tuple[int, int]:
        raise NotImplementedError

    @property
    def grid(self):
        raise NotImplementedError

    @property
    def children(self) -> tuple:
        return ()

    def generate_stencil(self):
        """Periodic/constant stencil of this operator expression, or None."""
        return None

    def __str__(self):
        return type(self).__name__


def _unknowns(grid: Grid) -> int:
    return reduce(_mul, grid.size, 1)


# ---------------------------------------------------------------------------
# Entities
# ---------------------------------------------------------------------------

class Entity(Expression):
    def __init__(self, name: str, grid, shape):
        self._name = name
        self._grid = grid
        self._shape = shape

    @property
    def name(self):
        return self._name

    @property
    def grid(self):
        return self._grid

    @property
    def shape(self):
        return self._shape

    def __str__(self):
        return self._name


class Operator(Entity):
    """Square operator on a grid backed by a stencil generator
    (reference ir/base.py:122-145)."""

    def __init__(self, name, grid, stencil_generator=None):
        n = _unknowns(grid)
        super().__init__(name, grid, (n, n))
        self._stencil_generator = stencil_generator

    @property
    def stencil_generator(self):
        return self._stencil_generator

    def generate_stencil(self):
        if self._stencil_generator is None:
            return None
        return self._stencil_generator.generate_stencil(self.grid)


class Identity(Operator):
    def __init__(self, grid, name="I"):
        super().__init__(name, grid, gallery.IdentityGenerator(grid.dimension))


class ZeroOperator(Operator):
    def __init__(self, grid, shape=None, name="0"):
        super().__init__(name, grid, gallery.ZeroGenerator(grid.dimension))
        if shape is not None:
            self._shape = shape


class Approximation(Entity):
    """A grid function (the current iterate)."""

    def __init__(self, name, grid):
        super().__init__(name, grid, (_unknowns(grid), 1))

    @property
    def predecessor(self):
        return None

    def generate_stencil(self):
        return constant.unit(self.grid.dimension)


class RightHandSide(Approximation):
    def generate_stencil(self):
        return constant.null(self.grid.dimension)


class ZeroApproximation(Approximation):
    def __init__(self, grid, name="0"):
        super().__init__(name, grid)

    def generate_stencil(self):
        return constant.null(self.grid.dimension)


# ---------------------------------------------------------------------------
# Unary expressions
# ---------------------------------------------------------------------------

class UnaryExpression(Expression):
    def __init__(self, operand):
        self._operand = operand

    @property
    def operand(self):
        return self._operand

    @property
    def shape(self):
        return self._operand.shape

    @property
    def grid(self):
        return self._operand.grid

    @property
    def children(self):
        return (self._operand,)


class Diagonal(UnaryExpression):
    def generate_stencil(self):
        return periodic.diagonal(periodic.as_periodic(self.operand.generate_stencil()))

    def __str__(self):
        return f"{self.operand}.diag"


class LowerTriangle(UnaryExpression):
    def generate_stencil(self):
        return periodic.lower(periodic.as_periodic(self.operand.generate_stencil()))

    def __str__(self):
        return f"{self.operand}.lower"


class UpperTriangle(UnaryExpression):
    def generate_stencil(self):
        return periodic.upper(periodic.as_periodic(self.operand.generate_stencil()))

    def __str__(self):
        return f"{self.operand}.upper"


class BlockDiagonal(UnaryExpression):
    def __init__(self, operand, block_size):
        super().__init__(operand)
        self._block_size = tuple(block_size)

    @property
    def block_size(self):
        return self._block_size

    def generate_stencil(self):
        return periodic.block_diagonal(
            periodic.as_periodic(self.operand.generate_stencil()), self._block_size)

    def __str__(self):
        return f"{self.operand}.block_diag{self._block_size}"


class Inverse(UnaryExpression):
    """Exact inverse of the operand operator.  The cycle compiler
    special-cases diagonal / pointwise / block-diagonal operands; anything
    else falls back to a small dense solve."""

    def generate_stencil(self):
        return periodic.inverse(periodic.as_periodic(self.operand.generate_stencil()))

    def __str__(self):
        return f"{self.operand}.I"


class Transpose(UnaryExpression):
    def __init__(self, operand):
        super().__init__(operand)
        self._shape = (operand.shape[1], operand.shape[0])

    @property
    def shape(self):
        return self._shape

    def generate_stencil(self):
        return periodic.transpose(periodic.as_periodic(self.operand.generate_stencil()))

    def __str__(self):
        return f"{self.operand}.T"


# ---------------------------------------------------------------------------
# Binary expressions
# ---------------------------------------------------------------------------

class BinaryExpression(Expression):
    def __init__(self, operand1, operand2):
        self._operand1 = operand1
        self._operand2 = operand2

    @property
    def operand1(self):
        return self._operand1

    @property
    def operand2(self):
        return self._operand2

    @property
    def grid(self):
        return self._operand1.grid

    @property
    def children(self):
        return (self._operand1, self._operand2)


class Addition(BinaryExpression):
    @property
    def shape(self):
        return self._operand1.shape

    def generate_stencil(self):
        return periodic.add(periodic.as_periodic(self._operand1.generate_stencil()),
                            periodic.as_periodic(self._operand2.generate_stencil()))

    def __str__(self):
        return f"({self._operand1} + {self._operand2})"


class Subtraction(BinaryExpression):
    @property
    def shape(self):
        return self._operand1.shape

    def generate_stencil(self):
        return periodic.sub(periodic.as_periodic(self._operand1.generate_stencil()),
                            periodic.as_periodic(self._operand2.generate_stencil()))

    def __str__(self):
        return f"({self._operand1} - {self._operand2})"


class Multiplication(BinaryExpression):
    def __init__(self, operand1, operand2):
        if operand1.shape[1] != operand2.shape[0]:
            raise ValueError(
                f"operand shapes not aligned: {operand1.shape} x {operand2.shape}")
        super().__init__(operand1, operand2)

    @property
    def shape(self):
        return (self._operand1.shape[0], self._operand2.shape[1])

    def generate_stencil(self):
        return periodic.mul(periodic.as_periodic(self._operand1.generate_stencil()),
                            periodic.as_periodic(self._operand2.generate_stencil()))

    def __str__(self):
        return f"({self._operand1} * {self._operand2})"


class Scaling(Expression):
    def __init__(self, factor, operand):
        self._factor = factor
        self._operand = operand

    @property
    def factor(self):
        return self._factor

    @property
    def operand(self):
        return self._operand

    @property
    def shape(self):
        return self._operand.shape

    @property
    def grid(self):
        return self._operand.grid

    @property
    def children(self):
        return (self._operand,)

    def generate_stencil(self):
        return periodic.scale(self._factor,
                              periodic.as_periodic(self._operand.generate_stencil()))

    def __str__(self):
        return f"{self._factor} * {self._operand}"


# ---------------------------------------------------------------------------
# Intergrid operators
# ---------------------------------------------------------------------------

class InterGridOperator(Operator):
    def __init__(self, name, grid, fine_grid, coarse_grid, stencil_generator):
        self._fine_grid = fine_grid
        self._coarse_grid = coarse_grid
        super().__init__(name, grid, stencil_generator)

    @property
    def fine_grid(self):
        return self._fine_grid

    @property
    def coarse_grid(self):
        return self._coarse_grid


class Restriction(InterGridOperator):
    """Maps fine-grid functions to the coarse grid (shape nc x nf)."""

    def __init__(self, name, fine_grid, coarse_grid, stencil_generator=None):
        super().__init__(name, coarse_grid, fine_grid, coarse_grid, stencil_generator)
        self._shape = (_unknowns(coarse_grid), _unknowns(fine_grid))

    def generate_stencil(self):
        if self.stencil_generator is None:
            return None
        return self.stencil_generator.generate_stencil(self.fine_grid)


class ZeroRestriction(Restriction):
    def __init__(self, fine_grid, coarse_grid, name="0"):
        super().__init__(name, fine_grid, coarse_grid,
                         gallery.ZeroGenerator(fine_grid.dimension))


class Prolongation(InterGridOperator):
    """Maps coarse-grid functions to the fine grid (shape nf x nc)."""

    def __init__(self, name, fine_grid, coarse_grid, stencil_generator=None):
        super().__init__(name, fine_grid, fine_grid, coarse_grid, stencil_generator)
        self._shape = (_unknowns(fine_grid), _unknowns(coarse_grid))

    def generate_stencil(self):
        if self.stencil_generator is None:
            return None
        return self.stencil_generator.generate_stencil(self.fine_grid)


class ZeroProlongation(Prolongation):
    def __init__(self, fine_grid, coarse_grid, name="0"):
        super().__init__(name, fine_grid, coarse_grid,
                         gallery.ZeroGenerator(fine_grid.dimension))


class CoarseGridSolver(Entity):
    """Exact (or delegated) solve with the coarse operator.

    ``expression`` optionally holds an evolved cycle used as the coarse
    solver (reference ir/base.py:572-595); otherwise the compiler picks a
    direct factorization or a Krylov solve.
    """

    def __init__(self, operator, expression=None, name="CGS",
                 initial_guess=None):
        self._operator = operator
        self._expression = expression
        # nonlinear (FAS) solves iterate from the restricted solution; the
        # reference restricts Solution into the coarse field before CGS
        # (FAS_2D_Basic_template.exa4 CGS@coarsest smooths in place)
        self.initial_guess = initial_guess
        super().__init__(name, operator.grid, operator.shape)

    @property
    def operator(self):
        return self._operator

    @property
    def expression(self):
        return self._expression

    @property
    def children(self):
        return (self._operator,)


# ---------------------------------------------------------------------------
# Residual and Cycle
# ---------------------------------------------------------------------------

class Residual(Expression):
    """b - A x (reference ir/base.py:598-648)."""

    def __init__(self, operator, approximation, rhs):
        self._operator = operator
        self._approximation = approximation
        self._rhs = rhs

    @property
    def operator(self):
        return self._operator

    @property
    def approximation(self):
        return self._approximation

    @property
    def rhs(self):
        return self._rhs

    @property
    def shape(self):
        return self._rhs.shape

    @property
    def grid(self):
        return self._rhs.grid

    @property
    def children(self):
        return (self._operator, self._approximation, self._rhs)

    def __str__(self):
        return f"({self._rhs} - {self._operator} * {self._approximation})"


class Cycle(Expression):
    """x_new = x + omega * correction, optionally color-partitioned.

    ``predecessor`` links a coarse-level cycle back to the fine-level cycle
    it will eventually correct (reference ir/base.py:651-697).
    """

    def __init__(self, approximation, rhs, correction=None,
                 partitioning=part.Single, relaxation_factor=1.0,
                 predecessor: Optional["Cycle"] = None):
        self.approximation = approximation
        self.rhs = rhs
        self.correction = correction
        self.partitioning = partitioning
        self.relaxation_factor = relaxation_factor
        self.predecessor = predecessor
        self.global_id: Optional[int] = None  # set by weight-tuning passes

    @property
    def shape(self):
        return self.approximation.shape

    @property
    def grid(self):
        return self.approximation.grid

    @property
    def children(self):
        return tuple(c for c in (self.approximation, self.rhs, self.correction)
                     if c is not None)

    def __str__(self):
        return f"({self.approximation} + {self.relaxation_factor} * {self.correction})"


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def get_coarse_grid(grid, coarsening_factor):
    return coarsen(grid, coarsening_factor)


def get_coarse_approximation(approximation: Approximation, coarsening_factor):
    return Approximation(f"{approximation.name}_c",
                         coarsen(approximation.grid, coarsening_factor))


def get_coarse_rhs(rhs: RightHandSide, coarsening_factor):
    return RightHandSide(f"{rhs.name}_c", coarsen(rhs.grid, coarsening_factor))


def get_coarse_operator(operator, coarse_grid):
    return Operator(operator.name, coarse_grid, operator.stencil_generator)


class ConstantStencilGenerator:
    """Wrap a fixed stencil as a generator (reference ir/base.py:719-724)."""

    def __init__(self, stencil):
        self._stencil = stencil

    def generate_stencil(self, _grid):
        return self._stencil


# Wrapper functions (reference ir/base.py:452-479)

def diag(operand):
    return Diagonal(operand)


def inv(operand):
    return Inverse(operand)


def add(a, b):
    return Addition(a, b)


def sub(a, b):
    return Subtraction(a, b)


def mul(a, b):
    return Multiplication(a, b)


def scale(factor, operand):
    return Scaling(factor, operand)


def minus(operand):
    return Scaling(-1, operand)


def is_quadratic(expression: Expression) -> bool:
    return expression.shape[0] == expression.shape[1]
