"""Copy of evostencils_tpu/ir/smoother.py, kept in the port so that it imports
nothing of the JAX package.

Smoother factories over system operators (reference ir/smoother.py)."""

from . import base, system
from ..stencils import periodic


def generate_decoupled_jacobi(operator: system.Operator):
    return system.Diagonal(operator)


def generate_collective_jacobi(operator: system.Operator):
    return system.ElementwiseDiagonal(operator)


def generate_collective_block_jacobi(operator: system.Operator, block_sizes):
    """Block-diagonal restriction of every block entry; the compiler inverts
    the per-block local systems collectively (reference ir/smoother.py:13-22)."""
    entries = []
    for i, row in enumerate(operator.entries):
        entries.append([])
        for j, entry in enumerate(row):
            stencil = periodic.as_periodic(entry.generate_stencil())
            bd = periodic.block_diagonal(stencil, tuple(block_sizes[i]))
            entries[-1].append(base.Operator(
                f"{operator.name}_{i}{j}_bd", entry.grid,
                base.ConstantStencilGenerator(bd)))
    return system.Operator(f"{operator.name}_block_diag", entries)


def generate_decoupled_block_jacobi(operator: system.Operator, block_sizes):
    entries = []
    for i, row in enumerate(operator.entries):
        entries.append([])
        for j, entry in enumerate(row):
            if i == j:
                stencil = periodic.as_periodic(entry.generate_stencil())
                bd = periodic.block_diagonal(stencil, tuple(block_sizes))
                entries[-1].append(base.Operator(
                    f"{operator.name}_{i}{j}_bd", entry.grid,
                    base.ConstantStencilGenerator(bd)))
            else:
                entries[-1].append(base.ZeroOperator(entry.grid))
    return system.Operator(f"{operator.name}_block_diag", entries)


def generate_jacobi_picard(operator: system.Operator):
    """Nonlinear Picard smoother: freeze the nonlinearity, collective point
    Jacobi on the linear part (reference ir/smoother.py:41-42)."""
    return system.ElementwiseDiagonal(operator)


def generate_jacobi_newton(operator: system.Operator, n_newton_steps: int):
    """Newton point smoother: linear point diagonal + nonlinear-term Jacobian
    (reference ir/smoother.py:45-46)."""
    return base.Addition(system.ElementwiseDiagonal(operator),
                         system.Jacobian(operator, n_newton_steps))
