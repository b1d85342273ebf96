"""Copy of evostencils_tpu/ir/krylov.py, kept in the port so that it imports
nothing of the JAX package.

Krylov-subspace method IR node (reference ir/krylov_subspace.py).

A Krylov method used as a smoother/solver inside a cycle: the compiler lowers
it to a fixed-iteration-count jitted loop (lax.fori_loop), replacing the
reference's extraction of ExaStencils-generated solver bodies
(reference code_generation/exastencils.py:1025-1101)."""

from . import base


class KrylovSubspaceMethod(base.Entity):
    def __init__(self, name, operator, iterations: int):
        self._operator = operator
        self._iterations = iterations
        super().__init__(name, operator.grid, operator.shape)

    @property
    def operator(self):
        return self._operator

    @property
    def iterations(self):
        return self._iterations

    @property
    def children(self):
        return (self._operator,)

    def __str__(self):
        return f"{self.name}[{self.iterations}]"


def generate_conjugate_gradient(operator, iterations):
    return KrylovSubspaceMethod("CG", operator, iterations)


def generate_bicgstab(operator, iterations):
    return KrylovSubspaceMethod("BiCGStab", operator, iterations)


def generate_minres(operator, iterations):
    return KrylovSubspaceMethod("MinRes", operator, iterations)


def generate_conjugate_residual(operator, iterations):
    return KrylovSubspaceMethod("ConjugateResidual", operator, iterations)
