"""Copy of evostencils_tpu/prediction/convergence.py, kept in the port so
that it imports nothing of the JAX package.  What differs from the copied
file:

* the matrix work runs on :class:`~.lfa_backend.TorchLfaBackend`, batched
  complex128 tensor programs on the evaluator's ``device`` (the card by
  default); ``backend="auto"`` and ``"torch"`` both mean it, and
  ``"native"`` (the JAX package's C++ engine) raises
  ``NotImplementedError``: that engine is not ported (ROADMAP Queue 1);
* ``rho_method`` ("exact", "power" or "auto") picks the spectral radius,
  as the native engine's option does;
* ``compute_spectral_radius`` scores 0.0 what raises
  ``torch.linalg.LinAlgError`` (a singular inverse, a non-finite symbol)
  and the JAX list's other types, but not a ``RuntimeError``: an
  out-of-memory error or a failed launch of the card raises, and never
  scores as a fitness;
* ``symbol`` and ``compute_eigenvalues`` return torch tensors on the
  device;
* ``_circulant`` forms a circulant's entries with numpy over the lattice
  points of each period class and hands the backend arrays, not a list
  of tuples built point by point.

The copied file's docstring:

Local Fourier Analysis of multigrid cycle expressions (native LFA).

Replaces the external C++ LFA Lab library the reference drives through SWIG
(reference model_based_prediction/convergence.py:1-209) — including its
crash-isolation child process, which is unnecessary here.

Formulation ("operational LFA" on a modulated lattice): for a cycle
spanning levels L_min..L_max, coarsening 2 per axis, harmonics couple with
period m = 2^(L_max - L_min) per axis.  For each sampled base frequency
theta, every grid function space at level l is represented on a periodic
lattice of m_l = m / 2^(L_max - l) points per axis, holding the envelope w
of u(x) = e^{i theta_l . x} w(x) with theta_l = 2^(L_max - l) * theta, and
every IR operator becomes an explicit (m_l^d x m_l^d) matrix:

* a stencil becomes a circulant with modulated coefficients
  c_o * e^{i theta_l . o} (periodic coefficients multiply positionally);
* restriction = odd-site selection (phase e^{i theta_l} per axis) after the
  weighting circulant; prolongation = the adjoint embedding (phase
  e^{-i theta_l} per axis) before the interpolation circulant;
* Inverse / CoarseGridSolver = batched matrix inverses;
* the red-black cycle symbol mirrors the executor exactly:
  E = (I - w M_b B^-1 A)(I - w M_r B^-1 A).

rho = max over theta samples of the spectral radius of the cycle's error
propagator.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..ir import base, system
from ..ir import partitioning as part
from ..ir.krylov import KrylovSubspaceMethod
from ..ops.apply import LATTICE_ORIGIN
from ..stencils import periodic
from ..stencils.periodic import PeriodicStencil
from .lfa_backend import Handle, TorchLfaBackend


class _LfaContext:
    """Per-analysis bookkeeping: sampled frequencies, lattice geometry and
    the active matrix backend."""

    def __init__(self, dimension: int, max_level: int, min_level: int,
                 samples_per_axis: int, backend_factory):
        self.dimension = dimension
        self.max_level = max_level
        self.min_level = min_level
        self.m = 2 ** (max_level - min_level)          # harmonic period
        s = samples_per_axis
        # offset sampling of the base cell (0, 2*pi/m)^d avoids the singular
        # zero frequency (the reference's LFA Lab does the same implicitly)
        axes = [(np.arange(s) + 0.5) * (2 * np.pi / self.m) / s
                for _ in range(dimension)]
        mesh = np.meshgrid(*axes, indexing="ij")
        self.thetas = np.stack([a.reshape(-1) for a in mesh], axis=-1)
        self.n_theta = self.thetas.shape[0]
        self.backend = backend_factory(self.thetas)

    def rel(self, level: int) -> int:
        return self.max_level - level

    def lattice_size(self, level: int) -> int:
        ml = self.m // (2 ** self.rel(level))
        if ml < 1:
            raise ValueError(f"level {level} below analysis range")
        return ml

    def lattice_points(self, level: int) -> np.ndarray:
        ml = self.lattice_size(level)
        pts = np.array(list(np.ndindex(*((ml,) * self.dimension))))
        return pts  # (ml^d, d)


def _grid_level(grid) -> int:
    return grid[0].level if isinstance(grid, list) else grid.level


def _grids(expr) -> List:
    g = expr.grid
    return g if isinstance(g, list) else [g]


def _resolve_backend(name: str):
    """The backend's name: 'torch' for 'torch' or 'auto'; 'native'
    raises."""
    if name in ("torch", "auto"):
        return "torch"
    if name == "native":
        raise NotImplementedError(
            "backend='native': the C++ LFA engine is not ported "
            "(ROADMAP Queue 1, the native LFA engine)")
    raise ValueError(f"unknown LFA backend {name!r}")


class ConvergenceEvaluator:
    """Spectral radius of a cycle's error propagator via LFA on the
    device (reference model_based_prediction/convergence.py:29-196)."""

    def __init__(self, dimension: int, coarsening_factors=None,
                 finest_grid=None, samples_per_axis: int = 8,
                 backend: str = "auto", device="cuda",
                 rho_method: str = "auto"):
        self.dimension = dimension
        self.samples_per_axis = samples_per_axis
        self.backend_name = _resolve_backend(backend)
        self.device = torch.device(device)
        self._backend_factory = partial(
            TorchLfaBackend, device=self.device, rho_method=rho_method)
        if coarsening_factors is not None:
            cf = coarsening_factors[0] if isinstance(coarsening_factors[0],
                                                     (tuple, list)) \
                else coarsening_factors
            if any(f != 2 for f in cf):
                raise NotImplementedError("only coarsening factor 2 supported")

    # -- public API ----------------------------------------------------------

    def compute_spectral_radius(self, expression: base.Cycle) -> float:
        try:
            ctx, h = self._symbol_handle(expression)
            return ctx.backend.spectral_radius(h)
        except (torch.linalg.LinAlgError, np.linalg.LinAlgError, ValueError,
                NotImplementedError, ZeroDivisionError, KeyError,
                RecursionError):
            return 0.0

    def compute_eigenvalues(self, expression: base.Cycle) -> torch.Tensor:
        ctx, h = self._symbol_handle(expression)
        return ctx.backend.eigenvalues(h)

    def symbol(self, expression: base.Cycle) -> torch.Tensor:
        """Error-propagator symbol, shape (n_theta, N, N) complex128 on the
        device, with N the fine lattice space size (fields x m^d)."""
        ctx, h = self._symbol_handle(expression)
        return ctx.backend.materialize(h)

    def _symbol_handle(self, expression: base.Cycle):
        max_level = _grid_level(expression.grid)
        min_level = self._min_operator_level(expression)
        ctx = _LfaContext(self.dimension, max_level, min_level,
                          self.samples_per_axis, self._backend_factory)
        ctx.root_dim = len(_grids(expression)) * \
            ctx.lattice_size(max_level) ** ctx.dimension
        #: the last walk's backend, which keeps its frequency chunks
        self.last_backend = ctx.backend
        memo: Dict[int, Handle] = {}
        return ctx, self._transform(expression, ctx, memo)

    @staticmethod
    def _min_operator_level(expression) -> int:
        levels = []

        def visit(e, seen):
            if id(e) in seen:
                return
            seen.add(id(e))
            g = getattr(e, "grid", None)
            if g is not None:
                try:
                    levels.append(_grid_level(g))
                except (AttributeError, IndexError):
                    pass
            for c in e.children:
                visit(c, seen)
            if isinstance(e, base.CoarseGridSolver):
                visit(e.operator, seen)

        visit(expression, set())
        return min(levels)

    # -- matrix builders -------------------------------------------------------

    def _circulant(self, ps: PeriodicStencil, level: int,
                   ctx: _LfaContext) -> Handle:
        """Modulated circulant of a (periodic) stencil at a level: the
        copied file's entries, formed by numpy over the lattice points of
        each period class rather than point by point."""
        ml = ctx.lattice_size(level)
        d = ctx.dimension
        n = ml ** d
        pts = ctx.lattice_points(level)
        lat = (pts + LATTICE_ORIGIN) % np.asarray(ps.period)
        xs, ys, offsets, values = [], [], [], []
        for key in np.ndindex(*ps.period):
            s = ps.stencils[key]
            if s is None:
                continue
            x_idx = np.flatnonzero((lat == key).all(axis=1))
            for offset, value in s.entries:
                y = (pts[x_idx] + np.asarray(offset)) % ml
                xs.append(x_idx)
                ys.append(np.ravel_multi_index(tuple(y.T), (ml,) * d))
                offsets.append(np.broadcast_to(np.asarray(offset, float),
                                               (len(x_idx), d)))
                values.append(np.full(len(x_idx), complex(value)))
        entries = (np.concatenate(xs), np.concatenate(ys),
                   np.concatenate(offsets), np.concatenate(values)) if xs \
            else (np.zeros(0, np.int64), np.zeros(0, np.int64),
                  np.zeros((0, d)), np.zeros(0, np.complex128))
        return ctx.backend.circulant(entries, ctx.rel(level), n)

    def _system_matrix(self, op, level: int, ctx: _LfaContext,
                       entry_transform=None) -> Handle:
        """Block matrix over fields of per-entry circulants."""
        entries = op.entries if isinstance(op, system.Operator) else [[op]]
        mfield = len(entries)
        n = ctx.lattice_size(level) ** ctx.dimension
        blocks = {}
        for i, row in enumerate(entries):
            for j, entry in enumerate(row):
                st = entry.generate_stencil()
                if st is None:
                    continue
                ps = periodic.as_periodic(st)
                if entry_transform is not None:
                    ps = entry_transform(ps, i, j)
                    if ps is None:
                        continue
                blocks[(i, j)] = self._circulant(ps, level, ctx)
        if mfield == 1:
            return blocks.get((0, 0), ctx.backend.zero(n, n))
        return ctx.backend.block(mfield, n, blocks)

    def _transfer_pairs(self, fine_level: int, ctx: _LfaContext):
        mlf = ctx.lattice_size(fine_level)
        mlc = ctx.lattice_size(fine_level - 1)
        d = ctx.dimension
        pairs = []
        for c_idx, c in enumerate(ctx.lattice_points(fine_level - 1)):
            f = tuple((2 * ci + 1) % mlf for ci in c)
            f_idx = int(np.ravel_multi_index(f, (mlf,) * d))
            pairs.append((c_idx, f_idx))
        return pairs, mlc ** d, mlf ** d

    def _selection(self, fine_level: int, ctx: _LfaContext,
                   n_fields: int) -> Handle:
        """Odd-site injection (coarse x fine) with per-axis phase
        e^{i theta_l}."""
        pairs, nc, nf = self._transfer_pairs(fine_level, ctx)
        sel = ctx.backend.selection(pairs, ctx.rel(fine_level), nc, nf)
        if n_fields > 1:
            sel = ctx.backend.kron_eye(n_fields, sel)
        return sel

    def _embedding(self, fine_level: int, ctx: _LfaContext,
                   n_fields: int) -> Handle:
        """Odd-site embedding (fine x coarse) with phase e^{-i theta_l};
        the transpose pattern of the selection."""
        pairs, nc, nf = self._transfer_pairs(fine_level, ctx)
        emb = ctx.backend.embedding(pairs, ctx.rel(fine_level), nc, nf)
        if n_fields > 1:
            emb = ctx.backend.kron_eye(n_fields, emb)
        return emb

    def _rb_masks(self, level: int, ctx: _LfaContext,
                  n_fields: int) -> Tuple[Handle, Handle]:
        pts = ctx.lattice_points(level)
        parity = (pts.sum(axis=1) + ctx.dimension * LATTICE_ORIGIN) % 2
        red = ctx.backend.diag((parity == 0).astype(float))
        black = ctx.backend.diag((parity == 1).astype(float))
        if n_fields > 1:
            red = ctx.backend.kron_eye(n_fields, red)
            black = ctx.backend.kron_eye(n_fields, black)
        return red, black

    # -- IR recursion ----------------------------------------------------------

    def _transform(self, expr, ctx: _LfaContext, memo) -> Handle:
        key = id(expr)
        if key in memo:
            return memo[key]
        result = self._transform_impl(expr, ctx, memo)
        memo[key] = result
        return result

    def _op_identity(self, level: int, ctx: _LfaContext, n_fields: int):
        n = n_fields * ctx.lattice_size(level) ** ctx.dimension
        return ctx.backend.identity(n)

    def _fn_identity(self, level: int, ctx: _LfaContext, n_fields: int):
        # only the root approximation is a non-zero entity; its symbol is
        # the identity on the root space
        n = n_fields * ctx.lattice_size(level) ** ctx.dimension
        if n != ctx.root_dim:
            raise NotImplementedError(
                "non-root approximation entity in expression")
        return self._op_identity(level, ctx, n_fields)

    def _fn_zero(self, level: int, ctx: _LfaContext, n_fields: int):
        # function symbols map from the ROOT fine space (rectangular)
        n = n_fields * ctx.lattice_size(level) ** ctx.dimension
        return ctx.backend.zero(n, ctx.root_dim)

    def _transform_impl(self, expr, ctx: _LfaContext, memo) -> Handle:
        if isinstance(expr, base.Cycle):
            return self._transform_cycle(expr, ctx, memo)
        if isinstance(expr, base.Residual):
            level = _grid_level(expr.grid)
            nf = len(_grids(expr))
            rhs = self._function_symbol(expr.rhs, ctx, memo, level, nf)
            approx = self._function_symbol(expr.approximation, ctx, memo,
                                           level, nf)
            A = self._operator_symbol(expr.operator, ctx, memo)
            return ctx.backend.sub(rhs, ctx.backend.matmul(A, approx))
        raise NotImplementedError(f"cannot transform {type(expr).__name__}")

    def _function_symbol(self, expr, ctx, memo, level, n_fields) -> Handle:
        """Symbol of a grid-function expression as an operator on the
        initial error (reference convergence.py:113-125 semantics)."""
        be = ctx.backend
        if isinstance(expr, (system.RightHandSide, base.RightHandSide)):
            return self._fn_zero(level, ctx, n_fields)
        if isinstance(expr, (system.ZeroApproximation, base.ZeroApproximation)):
            return self._fn_zero(level, ctx, n_fields)
        if isinstance(expr, (system.Approximation, base.Approximation)):
            return self._fn_identity(level, ctx, n_fields)
        if isinstance(expr, base.Cycle):
            return self._transform(expr, ctx, memo)
        if isinstance(expr, base.Residual):
            return self._transform(expr, ctx, memo)
        if isinstance(expr, base.Multiplication):
            op = self._operator_symbol(expr.operand1, ctx, memo)
            inner_level = _grid_level(expr.operand2.grid)
            inner_nf = len(_grids(expr.operand2))
            x = self._function_symbol(expr.operand2, ctx, memo, inner_level,
                                      inner_nf)
            return be.matmul(op, x)
        if isinstance(expr, base.Addition):
            return be.add(
                self._function_symbol(expr.operand1, ctx, memo, level,
                                      n_fields),
                self._function_symbol(expr.operand2, ctx, memo, level,
                                      n_fields))
        if isinstance(expr, base.Subtraction):
            return be.sub(
                self._function_symbol(expr.operand1, ctx, memo, level,
                                      n_fields),
                self._function_symbol(expr.operand2, ctx, memo, level,
                                      n_fields))
        if isinstance(expr, base.Scaling):
            return be.scale(expr.factor, self._function_symbol(
                expr.operand, ctx, memo, level, n_fields))
        raise NotImplementedError(
            f"cannot take function symbol of {type(expr).__name__}")

    def _transform_cycle(self, cycle: base.Cycle, ctx, memo) -> Handle:
        be = ctx.backend
        level = _grid_level(cycle.grid)
        nf = len(_grids(cycle))
        approx = self._function_symbol(cycle.approximation, ctx, memo, level,
                                       nf)
        omega = float(cycle.relaxation_factor)
        corr = cycle.correction
        is_smoother = (isinstance(corr, base.Multiplication)
                       and isinstance(corr.operand1, base.Inverse)
                       and isinstance(corr.operand2, base.Residual))
        if cycle.partitioning is part.RedBlack and is_smoother:
            # mirror the executor: red half-sweep first, then black.  The
            # rhs symbol is nonzero on coarse levels (restricted residual),
            # so each half-sweep is u <- u + w*M*Binv*(b - A u) in full.
            Binv = self._operator_symbol(corr.operand1, ctx, memo)
            A = self._operator_symbol(corr.operand2.operator, ctx, memo)
            b_sym = self._function_symbol(corr.operand2.rhs, ctx, memo,
                                          level, nf)
            red, black = self._rb_masks(level, ctx, nf)
            u = approx
            for mask in (red, black):
                resid = be.sub(b_sym, be.matmul(A, u))
                upd = be.matmul(mask, be.matmul(Binv, resid))
                u = be.add(u, be.scale(omega, upd))
            return u
        c = self._function_symbol(corr, ctx, memo, level, nf)
        return be.add(approx, be.scale(omega, c))

    def _operator_symbol(self, op, ctx, memo) -> Handle:
        key = ("op", id(op))
        if key in memo:
            return memo[key]
        result = self._operator_symbol_impl(op, ctx, memo)
        memo[key] = result
        return result

    def _operator_symbol_impl(self, op, ctx, memo) -> Handle:
        be = ctx.backend
        if isinstance(op, base.Inverse):
            return be.inv(self._operator_symbol(op.operand, ctx, memo))
        if isinstance(op, base.CoarseGridSolver):
            return be.inv(self._operator_symbol(op.operator, ctx, memo))
        if isinstance(op, KrylovSubspaceMethod):
            # model a k-iteration Krylov solve as the exact inverse (the
            # reference maps CGS-like nodes to .inverse() as well)
            return be.inv(self._operator_symbol(op.operator, ctx, memo))
        if isinstance(op, (system.Restriction,)) or (
                isinstance(op, base.Restriction)
                and not isinstance(op, base.ZeroRestriction)):
            entries = op.entries if isinstance(op, system.Restriction) else None
            ops_list = [row[i] for i, row in enumerate(entries)] if entries \
                else [op]
            fine_level = ops_list[0].fine_grid.level
            nf = len(ops_list)
            sel = self._selection(fine_level, ctx, nf)
            weight = self._per_field_circulant(ops_list, fine_level, ctx)
            return be.matmul(sel, weight)
        if isinstance(op, (system.Prolongation,)) or (
                isinstance(op, base.Prolongation)
                and not isinstance(op, base.ZeroProlongation)):
            entries = op.entries if isinstance(op, system.Prolongation) else None
            ops_list = [row[i] for i, row in enumerate(entries)] if entries \
                else [op]
            fine_level = ops_list[0].fine_grid.level
            nf = len(ops_list)
            emb = self._embedding(fine_level, ctx, nf)
            weight = self._per_field_circulant(ops_list, fine_level, ctx)
            return be.matmul(weight, emb)
        if isinstance(op, system.Diagonal):
            inner = self._unwrap_system(op.operand)
            level = _grid_level(inner.grid)

            def keep_diag_blocks(ps, i, j):
                return periodic.diagonal(ps) if i == j else None
            return self._system_matrix(inner, level, ctx, keep_diag_blocks)
        if isinstance(op, system.ElementwiseDiagonal):
            inner = self._unwrap_system(op.operand)
            level = _grid_level(inner.grid)

            def keep_central(ps, i, j):
                return periodic.diagonal(ps)
            return self._system_matrix(inner, level, ctx, keep_central)
        if isinstance(op, system.Operator):
            level = _grid_level(op.grid)
            return self._system_matrix(op, level, ctx)
        if isinstance(op, (base.Diagonal, base.LowerTriangle,
                           base.UpperTriangle, base.BlockDiagonal,
                           base.Transpose)):
            st = op.generate_stencil()
            level = _grid_level(op.grid)
            return self._circulant(periodic.as_periodic(st), level, ctx)
        if isinstance(op, base.ZeroOperator):
            level = _grid_level(op.grid)
            n = ctx.lattice_size(level) ** ctx.dimension
            return be.zero(n, n)
        if isinstance(op, base.Identity):
            level = _grid_level(op.grid)
            return self._op_identity(level, ctx, 1)
        if isinstance(op, base.Operator):
            st = op.generate_stencil()
            level = _grid_level(op.grid)
            if st is None:
                raise NotImplementedError(f"operator {op} has no stencil")
            return self._circulant(periodic.as_periodic(st), level, ctx)
        if isinstance(op, base.Multiplication):
            return be.matmul(self._operator_symbol(op.operand1, ctx, memo),
                             self._operator_symbol(op.operand2, ctx, memo))
        if isinstance(op, base.Addition):
            return be.add(self._operator_symbol(op.operand1, ctx, memo),
                          self._operator_symbol(op.operand2, ctx, memo))
        if isinstance(op, base.Subtraction):
            return be.sub(self._operator_symbol(op.operand1, ctx, memo),
                          self._operator_symbol(op.operand2, ctx, memo))
        if isinstance(op, base.Scaling):
            return be.scale(op.factor,
                            self._operator_symbol(op.operand, ctx, memo))
        raise NotImplementedError(
            f"cannot take operator symbol of {type(op).__name__}")

    def _per_field_circulant(self, ops_list, level, ctx) -> Handle:
        mats = []
        for sub in ops_list:
            st = sub.generate_stencil()
            if st is None:
                mats.append(self._op_identity(level, ctx, 1))
            else:
                mats.append(self._circulant(periodic.as_periodic(st), level,
                                            ctx))
        if len(mats) == 1:
            return mats[0]
        n = mats[0].rows
        return ctx.backend.block(len(mats), n,
                                 {(i, i): m for i, m in enumerate(mats)})

    @staticmethod
    def _unwrap_system(expr):
        while not isinstance(expr, system.Operator):
            if isinstance(expr, base.UnaryExpression):
                expr = expr.operand
            else:
                raise NotImplementedError(
                    f"cannot locate system operator under {type(expr).__name__}")
        return expr
