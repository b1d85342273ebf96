"""Copy of evostencils_tpu/prediction/performance.py, kept in the port so
that it imports nothing of the JAX package.  What differs from the copied
file: the machine models are ``REFERENCE_CPU`` and :data:`H100`, the
port's card, which is also ``PerformanceEvaluator``'s default; the copied
file's accelerator models are not carried.

The copied file's docstring:

Roofline performance model for multigrid cycle expressions.

Walks a cycle IR and accumulates per-operation FLOP and memory-byte counts;
runtime is the sum over operations of max(flops/peak, bytes/bandwidth).
Mirrors the reference's model-based runtime estimate
(model_based_prediction/performance.py:36-148) including per-application
Gaussian-elimination costs for collective/block smoothers (:240-248), but
parameterized by a machine model so the same cycle can be priced for the
reference's 6-core AVX2 CPU (scripts/optimize.py:79-84) or an accelerator.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import reduce
from operator import mul as _mul
from typing import List, Tuple

import numpy as np

from ..ir import base, system
from ..ir import partitioning as part
from ..ir.krylov import KrylovSubspaceMethod
from ..stencils import periodic


@dataclass(frozen=True)
class MachineModel:
    name: str
    peak_flops: float         # FLOP/s
    bandwidth: float          # bytes/s
    bytes_per_word: int

    def runtime(self, flops: float, words: float) -> float:
        return max(flops / self.peak_flops,
                   words * self.bytes_per_word / self.bandwidth)


#: The reference's roofline machine (scripts/optimize.py:79-84):
#: 16 FLOP/cycle * 6 cores * 2.6 GHz, 45.8 GB/s DRAM, 8-byte words.
REFERENCE_CPU = MachineModel("reference-cpu-avx2", 16 * 6 * 2.6e9, 45.8e9, 8)

#: One NVIDIA H100 (NVIDIA H100 80GB HBM3, 700.00 W power limit): 67e12
#: float32 FLOP/s outside the tensor cores and 3.35e12 B/s of HBM, the
#: data sheet's SXM rates and the constants of the bound column of the
#: port's kernel table; 4-byte words, as the card evaluates in float32.
H100 = MachineModel("nvidia-h100", 67e12, 3.35e12, 4)


def _points(grid) -> int:
    return reduce(_mul, grid.size, 1)


def _grid_list(expr):
    g = expr.grid
    return g if isinstance(g, list) else [g]


def _stencil_entries(op) -> float:
    """Mean number of stencil entries per application point."""
    st = op.generate_stencil()
    if st is None:
        return 0.0
    ps = periodic.as_periodic(st)
    counts = [s.number_of_entries for s in ps.stencils.reshape(-1)
              if s is not None]
    return float(np.mean(counts)) if counts else 0.0


class PerformanceEvaluator:
    """Estimate one cycle application's runtime on a machine model."""

    def __init__(self, machine: MachineModel = H100):
        self.machine = machine

    def estimate_runtime(self, expr: base.Expression) -> float:
        ops: List[Tuple[float, float]] = []
        memo = {}
        self._visit(expr, ops, memo)
        return sum(self.machine.runtime(f, w) for f, w in ops)

    # each _visit returns nothing; it appends (flops, words) work items.
    def _visit(self, expr, ops, memo):
        if id(expr) in memo:
            return
        memo[id(expr)] = True
        if isinstance(expr, base.Cycle):
            self._visit(expr.approximation, ops, memo)
            n = sum(_points(g) for g in _grid_list(expr))
            sweeps = 2 if expr.partitioning is part.RedBlack else 1
            if sweeps == 2 and self._is_smoother(expr.correction):
                # two masked half-sweeps, each with a fresh residual
                corr = expr.correction
                for _ in range(2):
                    self._count_residual(corr.operand2, ops)
                    self._count_inverse_apply(corr.operand1.operand, ops)
                    ops.append((2.0 * n, 3.0 * n))   # masked update
                self._visit(corr.operand2.rhs, ops, memo)
                self._visit(corr.operand2.approximation, ops, memo)
            else:
                self._visit(expr.correction, ops, memo)
                ops.append((2.0 * n, 3.0 * n))       # x + omega*c
            return
        if isinstance(expr, base.Residual):
            self._visit(expr.rhs, ops, memo)
            self._visit(expr.approximation, ops, memo)
            self._count_residual(expr, ops)
            return
        if isinstance(expr, base.Multiplication):
            operand = expr.operand2
            if operand.shape[1] == 1:
                self._visit(operand, ops, memo)
                self._count_apply(expr.operand1, ops)
            else:
                self._visit(expr.operand1, ops, memo)
                self._visit(expr.operand2, ops, memo)
            return
        if isinstance(expr, (base.Addition, base.Subtraction)):
            if expr.shape[1] == 1:
                self._visit(expr.operand1, ops, memo)
                self._visit(expr.operand2, ops, memo)
                n = sum(_points(g) for g in _grid_list(expr))
                ops.append((n, 3.0 * n))
            return
        if isinstance(expr, base.Scaling):
            self._visit(expr.operand, ops, memo)
            if expr.shape[1] == 1:
                n = sum(_points(g) for g in _grid_list(expr))
                ops.append((n, 2.0 * n))
            return
        # entities / leaves: free
        return

    @staticmethod
    def _is_smoother(corr):
        return (isinstance(corr, base.Multiplication)
                and isinstance(corr.operand1, base.Inverse)
                and isinstance(corr.operand2, base.Residual))

    def _count_residual(self, res: base.Residual, ops):
        self._count_apply(res.operator, ops)
        n = sum(_points(g) for g in _grid_list(res))
        ops.append((n, 3.0 * n))

    def _count_apply(self, op, ops):
        """Cost of applying an operator expression to a grid function."""
        if isinstance(op, base.Inverse):
            self._count_inverse_apply(op.operand, ops)
            return
        if isinstance(op, base.CoarseGridSolver):
            grids = _grid_list(op.operator)
            n = sum(_points(g) for g in grids)
            # dense back-substitution cost (factorization amortized)
            ops.append((2.0 * n * n, float(n * n)))
            return
        if isinstance(op, KrylovSubspaceMethod):
            for _ in range(op.iterations):
                self._count_apply(op.operator, ops)
                grids = _grid_list(op.operator)
                n = sum(_points(g) for g in grids)
                ops.append((10.0 * n, 10.0 * n))  # dots + axpys per iteration
            return
        if isinstance(op, system.Restriction) or isinstance(op, base.Restriction):
            entries = op.entries if isinstance(op, system.Restriction) else [[op]]
            for i, row in enumerate(entries):
                sub_op = row[i] if isinstance(op, system.Restriction) else op
                k = _stencil_entries(sub_op)
                nf, nc = _points(sub_op.fine_grid), _points(sub_op.coarse_grid)
                ops.append((2.0 * k * nc, float(nf + nc)))
            return
        if isinstance(op, system.Prolongation) or isinstance(op, base.Prolongation):
            entries = op.entries if isinstance(op, system.Prolongation) else [[op]]
            for i, row in enumerate(entries):
                sub_op = row[i] if isinstance(op, system.Prolongation) else op
                k = _stencil_entries(sub_op)
                nf, nc = _points(sub_op.fine_grid), _points(sub_op.coarse_grid)
                ops.append((2.0 * k * nf, float(nf + nc)))
            return
        if isinstance(op, system.Operator):
            for row in op.entries:
                for entry in row:
                    if isinstance(entry, base.ZeroOperator):
                        continue
                    k = _stencil_entries(entry)
                    n = _points(entry.grid)
                    ops.append((2.0 * k * n, 2.0 * n))
            return
        if isinstance(op, base.Operator):
            k = _stencil_entries(op)
            n = _points(op.grid)
            ops.append((2.0 * k * n, 2.0 * n))
            return
        if isinstance(op, (base.Multiplication,)):
            self._count_apply(op.operand2, ops)
            self._count_apply(op.operand1, ops)
            return
        if isinstance(op, (base.Addition, base.Subtraction)):
            self._count_apply(op.operand1, ops)
            self._count_apply(op.operand2, ops)
            n = sum(_points(g) for g in _grid_list(op))
            ops.append((float(n), 3.0 * n))
            return
        if isinstance(op, base.Scaling):
            self._count_apply(op.operand, ops)
            return
        if isinstance(op, (system.Diagonal, system.ElementwiseDiagonal,
                           base.Diagonal, base.BlockDiagonal,
                           base.LowerTriangle, base.UpperTriangle)):
            # applying the restricted operator itself
            grids = _grid_list(op)
            n = sum(_points(g) for g in grids)
            ops.append((2.0 * n, 2.0 * n))
            return
        return

    def _count_inverse_apply(self, L, ops):
        """Cost of one application of L^{-1} (the reference prices collective
        smoothers with per-point Gaussian elimination,
        performance.py:240-248)."""
        if isinstance(L, system.Diagonal):
            grids = _grid_list(L)
            n = sum(_points(g) for g in grids)
            ops.append((float(n), 2.0 * n))
            return
        if isinstance(L, system.ElementwiseDiagonal):
            grids = _grid_list(L)
            m = len(grids)
            n = _points(grids[0])
            ge = m ** 3 / 3.0 + 2.0 * m * m
            ops.append((ge * n, 2.0 * m * n))
            return
        if isinstance(L, base.Diagonal):
            n = sum(_points(g) for g in _grid_list(L))
            ops.append((float(n), 2.0 * n))
            return
        if isinstance(L, base.BlockDiagonal):
            n = _points(L.grid)
            B = reduce(_mul, L.block_size, 1)
            ge = B ** 3 / 3.0 + 2.0 * B * B
            ops.append((ge * n / B, 2.0 * n))
            return
        if isinstance(L, system.Operator):
            grids = _grid_list(L)
            m = len(grids)
            n = _points(grids[0])
            # detect block size from entry stencil periods
            Bs = []
            for row in L.entries:
                for e in row:
                    st = e.generate_stencil()
                    if st is not None:
                        ps = periodic.as_periodic(st)
                        Bs.append(reduce(_mul, ps.period, 1))
            B = max(Bs) * m if Bs else m
            ge = B ** 3 / 3.0 + 2.0 * B * B
            ops.append((ge * n * m / max(B, 1), 2.0 * m * n))
            return
        if isinstance(L, base.Addition):  # FAS Newton smoother
            self._count_inverse_apply(L.operand1, ops)
            return
        grids = _grid_list(L)
        n = sum(_points(g) for g in grids)
        ops.append((2.0 * n, 2.0 * n))
