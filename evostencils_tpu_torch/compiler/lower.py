"""Cycle compiler: multigrid expression IR -> eager PyTorch programs
(counterpart of evostencils_tpu/compiler/lower.py, the part that the 2D and
3D Poisson V-cycles and the evolved 2D and 3D Poisson, variable-
coefficient 2D Poisson, 2D linear elasticity, complex and split-complex
2D Helmholtz and nonlinear FAS cycles reach, and ``operator_applier`` for
the outer Krylov solve).

* Grid functions are tuples of per-field tensors (interior points only).
* Relaxation factors are a 1-D tensor indexed by cycle id, so one lowered
  cycle serves every relaxation-factor assignment (lower.py:12-15); the
  fused legs read them on the device by index.
* Red-black smoothing is two masked half-sweeps with a fresh residual in
  between (lower.py:16-19).
* The fusion plans are structural: they are found once per lowered cycle.
  A planned pre-smoothing leg (smoothers + residual + restriction) or
  up-leg (prolongation + correction + post-smoothers) runs as one call to
  ``ops.kernels.transfer`` (constant 5-point 2D operators),
  ``ops.kernels.rbgs_var`` (variable-coefficient 5-point 2D operators,
  red-black or Jacobi sweeps, lower.py:1005-1015, :1231-1239),
  ``ops.kernels.rbgs_sys`` (F x F systems of 9-point 2D blocks, red-black
  or Jacobi sweeps, lower.py:1143-1216) or
  ``ops.kernels.wavefront3d`` (constant 7-point 3D operators, exactly two
  pre-sweeps and one post-sweep, lower.py:1029-1090) on every level its
  gate admits; the other levels run the generic lowering below.
* With ``config.fused_column_transfers`` off, read when a step runs, a
  constant 5-point 2D leg runs its row-only form with the column half in
  plain torch (``axis_restrict_3tap`` after the down-leg,
  ``axis_prolong_3tap`` before the up-leg: the JAX package's ``banded``
  column transfers), and a var5 or sys9 leg is refused, so that its level
  runs the generic lowering (lower.py:1007-1025, :1150, :1191,
  :1233-1247).
* ``extract_fine_leg_plan`` and ``make_coarse_tail`` serve the fused cycle
  loop of ``compiler/solve.make_cycle_loop`` (lower.py:1925-1989).
* Outside a planned leg, a 2D smoother cycle of a constant 5-point operator
  runs one call to ``ops.kernels.rbgs`` (a fused red-black sweep or a
  Jacobi sweep), a residual restricted by a separable 3-tap transfer one
  call to ``transfer.residual_restrict``, and a coarse-grid correction
  ``u + omega * P e`` one call to ``transfer.prolong_correct``, on the
  levels the kernels' gates admit (lower.py:799-917, :1311-1376); a
  smoother cycle of a variable-coefficient operator one call to
  ``ops.kernels.rbgs_var`` (lower.py:845-855), of a system of 9-point
  blocks one call to ``ops.kernels.rbgs_sys`` (lower.py:866-874).  In 3D,
  with a constant 7-point operator, a smoother cycle runs one call to
  ``ops.kernels.rbgs3d`` on the levels its gate admits, else to the
  ``leg3d`` sweep on the levels that gate admits (lower.py:894-910); the
  transfers run ``leg3d.residual_restrict_3d`` and
  ``leg3d.prolong_correct_3d`` (lower.py:1291-1309, :1378-1395).
* A smoother cycle of a constant complex 5-point 2D operator (the
  shifted Laplacian of Helmholtz with Dirichlet boundaries) runs one call
  to ``ops.kernels.rbgs_cx`` on the levels its gate admits
  (lower.py:734-759, :855-866).  Complex stencils match no leg and no
  other kernel, so everything else of a complex cycle runs the generic
  lowering, in the fields' complex dtype (lower.py:1526-1531, :1728-1731).
* Block smoothers (collective block Jacobi) solve their blocks through
  ``ops.local_solve`` (lower.py:1546-1553, :1686-1706); the collective
  point smoother of a system with constant central coefficients applies
  one F x F inverse (lower.py:1575-1624), and one whose central
  coefficients vary (the split-complex Helmholtz Robin rows) solves the
  F x F system at every point (lower.py:1626-1684).
* A nonlinear (FAS) operator applies ``L u + N(u)``; its smoothers run
  damped Newton- or Picard-Jacobi sweeps and its coarsest level 200
  Newton-Jacobi sweeps from the node's initial guess (lower.py:919-965,
  :1444-1449, :1759-1792).  Nonlinear operators match no kernel; a FAS
  correction ``u + P (u_c - R u)`` is operator-free and runs
  ``transfer.prolong_correct`` where its gate admits the level, as the
  JAX lowering runs its Pallas ``prolong_row_correct`` there.
* A variable-coefficient operator runs as its ``StencilField``
  (lower.py:105-124), one object per generator and grid, so that the
  planner can compare two smoothers' operators by identity.
* Device constants (dense coarse inverses, red-black masks) are built once
  per lowered cycle, device and dtype, and cached; so are the operators'
  stencils and the sys9 tables and point solves, which depend on the IR
  alone.

* The coarse-grid solve of a linear operator above ``DIRECT_SOLVE_MAX``
  unknowns is ``ops.solvers.cg`` to 1e-12 in at most 1000 iterations
  (lower.py:1765-1769), and a ``KrylovSubspaceMethod`` node runs its
  fixed-iteration executor (``ops.solvers.FIXED_KRYLOV``,
  lower.py:1428-1430).
* Level-chunked programs (``lower_composed``, lower.py:1834-1900): each
  finished chunk's cycle runs with the next coarser chunk spliced into its
  unsolved ``CoarseGridSolver`` nodes (``cgs_override``), the candidate
  innermost.  Unlike the JAX package, which builds a fresh lowering on
  every trace, each chunk's plans, device constants and kernels-or-plain
  choice are built once, in ``lower_composed``, and serve every step.

An IR node outside this subset raises ``NotImplementedError`` naming it:
the collective point smoother of a periodic stencil and inverses of other
operator expressions.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import reduce
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import DIRECT_SOLVE_MAX, fused_cols_enabled
from ..grids import Grid
from ..ir import base, system
from ..ir import partitioning as part
from ..ir import transformations
from ..ir.krylov import KrylovSubspaceMethod
from ..ops import apply as ops
from ..ops import solvers
from ..ops.apply import red_black_masks
from ..ops.kernels import (leg3d, rbgs, rbgs3d, rbgs_cx, rbgs_sys,
                           rbgs_var, transfer, wavefront3d)
from ..ops.local_solve import get_block_solve_plan
from ..stencils import constant, periodic


def field_grids(expr) -> List[Grid]:
    g = expr.grid
    return g if isinstance(g, list) else [g]


def _generator(op):
    return getattr(op, "stencil_generator", None)


def _nonlinear_of(op):
    """``(generator, entry)`` when an operator (or a 1x1 system of one)
    carries a nonlinear term (FAS problems,
    problems/fas.FASOperatorGenerator), else None (lower.py:127-138)."""
    entry = op
    if isinstance(op, system.Operator):
        if len(op.entries) != 1:
            return None
        entry = op.entries[0][0]
    gen = _generator(entry)
    if gen is not None and hasattr(gen, "nonlinear_term"):
        return gen, entry
    return None


def _is_nonlinear(op) -> bool:
    return _nonlinear_of(op) is not None


_STENCIL_FIELD_CACHE: dict = {}


def _stencil_field_of(op):
    """The ``StencilField`` of an operator whose generator has a field
    form, else None (lower.py:105-124): one object per generator and grid
    size.  The cache entry holds the generator itself and a hit must be
    that object, because a dead generator's id can be reused by a new
    one."""
    gen = _generator(op)
    if gen is None or not hasattr(gen, "generate_stencil_field"):
        return None
    key = (id(gen), tuple(op.grid.size))
    hit = _STENCIL_FIELD_CACHE.get(key)
    if hit is not None and hit[0] is gen:
        return hit[1]
    sf = gen.generate_stencil_field(op.grid)
    _STENCIL_FIELD_CACHE[key] = (gen, sf)
    return sf


# ---------------------------------------------------------------------------
# Dense coarse-grid factorization
# ---------------------------------------------------------------------------

def dense_inverse(op) -> np.ndarray:
    """Dense inverse of a small system operator with constant, periodic or
    variable-coefficient entries, complex128 if an entry is complex
    (lower.py:180-224)."""
    entries = op.entries if isinstance(op, system.Operator) else [[op]]
    grids = [row[0].grid for row in entries]
    sizes = [int(np.prod(g.size)) for g in grids]
    n = sum(sizes)
    blocks = {}
    for i, row in enumerate(entries):
        for j, entry in enumerate(row):
            sf = _stencil_field_of(entry)
            if sf is not None:
                blocks[(i, j)] = sf.dense_matrix()
                continue
            ps = periodic.as_periodic(entry.generate_stencil())
            if ps is not None and ps.constant_entries():
                blocks[(i, j)] = ops.dense_matrix(ps, grids[j])
    any_complex = any(np.iscomplexobj(b) for b in blocks.values())
    K = np.zeros((n, n), dtype=np.complex128 if any_complex else np.float64)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    for (i, j), block in blocks.items():
        K[offsets[i]:offsets[i + 1], offsets[j]:offsets[j + 1]] = block
    return np.linalg.inv(K)


# ---------------------------------------------------------------------------
# Fusion planning (structural, IR only)
# ---------------------------------------------------------------------------

def _scalar_constant_stencil(A):
    """The constant stencil of a scalar system/base operator with no
    variable coefficients or nonlinear term, else None
    (lower.py:248-264, :1250-1266)."""
    entry = A
    if isinstance(A, system.Operator):
        if len(A.entries) != 1:
            return None
        entry = A.entries[0][0]
    if type(entry) is not base.Operator:
        return None
    if _is_nonlinear(entry) or _stencil_field_of(entry) is not None:
        return None
    st = entry.generate_stencil()
    if not isinstance(st, constant.Stencil):
        return None
    return st


def _sys_entry_nine(e):
    """One block-system entry for the sys9 kernels: ``(nine_coeffs,
    {row: center_delta})`` or None (lower.py:267-311).  Constant stencils
    inside the 3x3 box classify with no exceptions; a StencilField entry
    classifies when every off-center coefficient field is uniform and the
    center field is uniform up to constant deltas on a few axis-0 rows."""
    if isinstance(e, base.ZeroOperator):
        return (0.0,) * 9, {}
    if type(e) is not base.Operator or _is_nonlinear(e):
        return None
    sf = _stencil_field_of(e)
    if sf is None:
        st = e.generate_stencil()
        if not isinstance(st, constant.Stencil):
            return None
        c = rbgs_sys.nine_point_coeffs(st)
        return None if c is None else (c, {})
    if set(sf.offsets) - set(rbgs_sys.NINE_OFFSETS):
        return None
    if len(set(sf.offsets)) != len(sf.offsets):
        return None     # a duplicate offset would silently overwrite
    nine = [0.0] * 9
    exc = {}
    for off, f in zip(sf.offsets, sf.fields):
        f = np.asarray(f)
        if np.iscomplexobj(f):
            return None
        desc = ops.almost_uniform_desc(f)
        if desc is None:
            return None
        k = rbgs_sys.NINE_OFFSETS.index(off)
        nine[k] = float(desc[1])
        if desc[0] == "rows":
            if off != (0, 0):
                return None        # only center exceptions are supported
            for i, row in desc[2]:
                row = np.asarray(row)
                if row.size == 0 or np.ptp(row) != 0.0:
                    return None    # the delta must be constant along the row
                exc[int(i)] = float(row.flat[0])
    return tuple(nine), exc


def _sys_nine_table(A):
    """``(coeffs, exc_t)`` of an F x F block system, or None when an entry
    is outside the 3x3 box or not constant beyond row exceptions
    (lower.py:314-340): the per-entry 9-point tables and the sorted
    ``(row, F x F center-delta matrix)`` pairs.  The one construction site
    of both the fusion signature and the runtime kernel parts, so the two
    cannot disagree."""
    F = len(A.entries)
    coeffs = []
    exc_rows: Dict[int, np.ndarray] = {}
    for fi, row in enumerate(A.entries):
        crow = []
        for fj, e in enumerate(row):
            ce = _sys_entry_nine(e)
            if ce is None:
                return None
            c, exc = ce
            crow.append(c)
            for i, d in exc.items():
                exc_rows.setdefault(i, np.zeros((F, F)))[fi, fj] = d
        coeffs.append(tuple(crow))
    exc_t = tuple(sorted(
        (i, tuple(tuple(float(v) for v in r) for r in dm))
        for i, dm in exc_rows.items()))
    return tuple(coeffs), exc_t


def _smoother_sig(A, L=None):
    """Fusion signature of a smoothable operator (lower.py:343-393):
    ("const5", vals) for a scalar constant 5-point 2D stencil, ("const7",
    vals) for a scalar constant 7-point 3D stencil, ("var5", StencilField)
    for a scalar variable-coefficient 2D operator, ("sys9", (coeffs, kind,
    exc)) for an F x F system of 9-point 2D blocks smoothed by a
    ``system.ElementwiseDiagonal`` (kind "elem") or ``system.Diagonal``
    ("diag") ``L``, else None.  ``L`` only matters for systems: it selects
    the point-solve matrix."""
    if isinstance(A, system.Operator) and len(A.entries) >= 2:
        F = len(A.entries)
        if any(len(r) != F for r in A.entries):
            return None
        if isinstance(L, system.ElementwiseDiagonal):
            kind = "elem"
        elif isinstance(L, system.Diagonal):
            kind = "diag"
        else:
            return None
        if A.entries[0][0].grid.dimension != 2:
            return None
        ct = _sys_nine_table(A)
        if ct is None:
            return None
        coeffs, exc_t = ct
        return ("sys9", (coeffs, kind, exc_t))
    st = _scalar_constant_stencil(A)
    if st is None:
        entry = A.entries[0][0] if isinstance(A, system.Operator) \
            and len(A.entries) == 1 else A
        if type(entry) is not base.Operator or _is_nonlinear(entry) or \
                entry.grid.dimension != 2:
            return None
        sf = _stencil_field_of(entry)
        return None if sf is None else ("var5", sf)
    vals = rbgs.five_point_values(st)
    if vals is not None and vals[0] != 0.0:
        return ("const5", vals)
    vals = rbgs3d.seven_point_values(st)
    if st.dimension == 3 and vals is not None and vals[0] != 0.0:
        return ("const7", vals)
    return None


def _same_sig(a, b) -> bool:
    """Whether two smoothers' signatures match: the var5 field by identity
    (the same generator and grid give the same object), the constant
    stencils and the sys9 tables by value, the sys9 kind included, so a
    chain that mixes collective and decoupled smoothers stops there even
    where the two point solves coincide (lower.py:418-425)."""
    if a is None or b is None or a[0] != b[0]:
        return False
    return a[1] is b[1] if a[0] == "var5" else a[1] == b[1]


def _peel_smoother_chain(cur, rhs, sig, max_sweeps=3):
    """Peel up to ``max_sweeps`` diagonal smoother cycles with the same
    partitioning over an operator of signature ``sig`` and right-hand side
    ``rhs`` (lower.py:396-429).  Returns (sweeps outermost-first,
    innermost expr, partitioning)."""
    sweeps = []
    partitioning = None
    while len(sweeps) < max_sweeps and isinstance(cur, base.Cycle) \
            and cur.partitioning in (part.RedBlack, part.Single) \
            and (partitioning is None or cur.partitioning is partitioning):
        corr = cur.correction
        if not _is_smoother(corr):
            break
        L = corr.operand1.operand
        if not isinstance(L, (system.Diagonal, system.ElementwiseDiagonal,
                              base.Diagonal)):
            break
        r2 = corr.operand2
        if r2.approximation is not cur.approximation or r2.rhs is not rhs:
            break
        if not _same_sig(_smoother_sig(r2.operator, L), sig):
            break
        partitioning = cur.partitioning
        sweeps.append(cur)
        cur = cur.approximation
    return sweeps, cur, partitioning


def axis_taps_3d(op):
    """Per-axis (w-1, w0, w+1) triples of a scalar separable radius-1 3D
    transfer operator, else None (lower.py:1268-1289)."""
    entries = getattr(op, "entries", None)
    if entries is not None:
        if len(entries) != 1:
            return None
        op = entries[0][0]
    st = op.generate_stencil()
    if not isinstance(st, constant.Stencil):
        return None
    fac = ops.separable_factors(st)
    if fac is None:
        return None
    vectors, radii = fac
    if len(vectors) != 3 or any(r != 1 for r in radii):
        return None
    if any(len(v) != 3 or any(isinstance(x, complex) for x in v)
           for v in vectors):
        return None
    return tuple(tuple(float(x) for x in v) for v in vectors)


def _transfer_taps(kind, op):
    """Transfer taps in the form the leg kernels of signature ``kind``
    take, else None."""
    return axis_taps_3d(op) if kind == "const7" else transfer_three_tap(op)


def transfer_three_tap(op):
    """Per-axis (w[-1], w[0], w[+1]) taps of a scalar separable 2D
    transfer operator; multi-field systems must use the same taps for
    every field; else None (lower.py:513-538)."""
    entries = getattr(op, "entries", None)
    field_ops = [row[i] for i, row in enumerate(entries)] \
        if entries is not None else [op]
    taps0 = None
    for fop in field_ops:
        st = fop.generate_stencil()
        if not isinstance(st, constant.Stencil):
            return None
        fac = ops.separable_factors(st)
        if fac is None:
            return None
        taps = transfer.three_tap(*fac)
        if taps is None or len(taps) != 2:
            return None
        if taps0 is None:
            taps0 = taps
        elif taps != taps0:
            return None
    return taps0


def _leg_partitioning(sig, partitioning) -> bool:
    """Whether the legs of signature ``sig`` take a chain of this
    partitioning: the var5 and sys9 legs take red-black and Jacobi sweeps,
    the constant ones red-black only (lower.py:453-454, :502-503,
    :1036-1038, :1068-1070)."""
    return partitioning is part.RedBlack or (
        sig[0] in ("var5", "sys9") and partitioning is part.Single)


def _plan_post_fusions(root) -> Dict[int, dict]:
    """Up-legs: smoother chains whose innermost approximation is a
    coarse-grid-correction cycle ``u + w * P e``, red-black for the
    constant kernels, red-black or Jacobi for the var5 ones
    (lower.py:432-466).  Keyed by id of the outermost post-smoother."""
    by_smoother: Dict[int, dict] = {}
    for cyc in transformations.find_nodes(root, base.Cycle):
        corr = cyc.correction
        if not _is_smoother(corr):
            continue
        sig = _smoother_sig(corr.operand2.operator, corr.operand1.operand)
        if sig is None:
            continue
        rhs = corr.operand2.rhs
        sweeps, cur, partitioning = _peel_smoother_chain(cyc, rhs, sig)
        if not sweeps or not isinstance(cur, base.Cycle) \
                or not _leg_partitioning(sig, partitioning):
            continue
        ccorr = cur.correction
        if not isinstance(ccorr, base.Multiplication):
            continue
        P = ccorr.operand1
        if not isinstance(P, (system.Prolongation, base.Prolongation)) or \
                isinstance(P, base.ZeroProlongation):
            continue
        by_smoother[id(sweeps[0])] = {
            "sweeps": sweeps, "cgc": cur, "kind": sig[0], "vals": sig[1],
            "rhs": rhs, "taps": _transfer_taps(sig[0], P),
            "red_black": partitioning is part.RedBlack}
    return by_smoother


def _plan_super_fusions(root) -> Tuple[Dict[int, dict], Dict[int, dict]]:
    """Down-legs: ``Multiplication(Restriction, Residual)`` sites whose
    approximation is a chain of diagonal smoothers over the same operator
    and rhs, red-black for the constant kernels, red-black or Jacobi for
    the var5 ones (lower.py:469-510).  Returns (plans by id of the
    outermost pre-smoother, plans by id of the Multiplication), both
    mapping to one shared plan, so the smoothed state and the restricted
    residual come from one leg call."""
    by_smoother: Dict[int, dict] = {}
    by_mult: Dict[int, dict] = {}
    for mult in transformations.find_nodes(root, base.Multiplication):
        res, R = mult.operand2, mult.operand1
        if not isinstance(res, base.Residual):
            continue
        if not isinstance(R, (system.Restriction, base.Restriction)) or \
                isinstance(R, base.ZeroRestriction):
            continue
        # the head pre-smoother's inverse selects a system's point solve
        # (lower.py:488-494)
        L0 = None
        head = res.approximation
        if isinstance(head, base.Cycle) and \
                isinstance(head.correction, base.Multiplication) and \
                isinstance(head.correction.operand1, base.Inverse):
            L0 = head.correction.operand1.operand
        sig = _smoother_sig(res.operator, L0)
        if sig is None:
            continue
        sweeps, cur, partitioning = _peel_smoother_chain(res.approximation,
                                                         res.rhs, sig)
        if not sweeps or not _leg_partitioning(sig, partitioning):
            continue
        plan = {"mult": mult, "res": res, "kind": sig[0], "vals": sig[1],
                "sweeps": sweeps, "base": cur,
                "taps": _transfer_taps(sig[0], R),
                "red_black": partitioning is part.RedBlack}
        by_smoother[id(sweeps[0])] = plan
        by_mult[id(mult)] = plan
    return by_smoother, by_mult


@dataclass
class ChainLink:
    """One finished chunk of a level-chunked run: its best cycle expression
    and the grid-function entities it binds (lower.py:1823-1831; the
    reference appends each chunk's best cycle function to the solver
    program and the next run's coarse-grid calls resolve to it,
    optimization/program.py:890-898)."""
    root: base.Cycle
    approximation: object
    rhs: object


@dataclass
class _Plans:
    super_by_smoother: Dict[int, dict]
    super_by_mult: Dict[int, dict]
    post_by_smoother: Dict[int, dict]


#: the rows of the row-only 2D legs and of the variable-coefficient legs,
#: which their gates' refusal of bfloat16 names
ROW_LEG_ROWS = ("rows 6-7 (presmooth_residual_rowrestrict, "
                "prolong_correct_postsmooth)")
VAR_LEG_ROWS = ("rows 12-13 (presmooth_residual_restrict_var, "
                "prolong_correct_postsmooth_var)")
#: the legs' gates by scalar signature, taking the level and whether the
#: leg runs row-only: the legs with both transfer axes (rows 1-2) take
#: bfloat16 storage, their row-only forms do not
_LEG_GATES = {
    "const5": lambda u, row_only: transfer.supports(
        u, ROW_LEG_ROWS if row_only else transfer.LEG_ROWS),
    "var5": lambda u, row_only: transfer.supports(u, VAR_LEG_ROWS),
    "const7": lambda u, row_only: wavefront3d.supports(u)}


def _damped(omega, c):
    """``omega * c`` as the JAX lowering computes it: there ``omega`` is an
    element of the float32 omegas array, which promotes a bfloat16 field
    to float32, so that a level the bf16 legs do not take computes in
    float32 from the storage's values; a 0-d torch tensor does not
    promote."""
    if c.dtype == torch.bfloat16 and torch.is_tensor(omega):
        c = c.to(torch.promote_types(c.dtype, omega.dtype))
    return omega * c


def _is_smoother(corr) -> bool:
    return (isinstance(corr, base.Multiplication)
            and isinstance(corr.operand1, base.Inverse)
            and isinstance(corr.operand2, base.Residual))


# ---------------------------------------------------------------------------
# Lowering
# ---------------------------------------------------------------------------

@dataclass
class LoweredCycle:
    """A lowered multigrid cycle step (lower.py:231-245).

    ``step(u_fields, b_fields, omegas) -> u_fields_new``; ``omegas`` is a
    1-D relaxation-factor tensor indexed by cycle id, on the fields'
    device.
    """
    step: Callable
    n_omegas: int
    default_omegas: np.ndarray
    grids: List[Grid]
    operator: object  # the finest-level system operator (for residuals)
    expression: object = None
    approximation: object = None
    rhs: object = None
    # what every _Lowering of this cycle is built with: the fusion plans,
    # the device-constant cache and the kernels-or-plain choice
    plans: Optional[_Plans] = None
    constants: dict = field(default_factory=dict)
    use_kernels: bool = True
    # a composed program's coarser chunks, spliced into the finest chunk's
    # unsolved coarse-grid solves (make_chain_applier)
    cgs_override: Optional[Callable] = None
    # whether a step reads a value back to the host: a coarse solve by
    # solvers.cg, which tests its tolerance there
    syncs_host: bool = False


class _Lowering:
    """One evaluation of a cycle expression on bound fields.

    ``constants`` is the per-lowered-cycle cache of device tensors; it
    outlives the evaluation.  ``use_kernels=False`` runs the kernels' plain
    versions even on a CUDA device (a comparison run only)."""

    def __init__(self, approximation, rhs, omegas, *, plans=None,
                 constants=None, use_kernels=True, cgs_override=None):
        self.omegas = omegas
        #: ``(fields, omegas, initial_guess) -> fields`` for the
        #: CoarseGridSolver nodes that hold no expression: how a coarser
        #: chunk's cycle is spliced in under a finished finer chunk
        #: (lower.py:541-551) without touching the grammar's shared node
        self.cgs_override = cgs_override
        self.approximation = approximation
        self.rhs = rhs
        self.plans = plans or _Plans({}, {}, {})
        self.constants = {} if constants is None else constants
        self.env: Dict[int, tuple] = {}
        self.memo: Dict[int, tuple] = {}
        self._super_results: Dict[int, object] = {}
        # the standalone kernels: the sweeps by dimension, gate and
        # red-black-ness, the transfers by dimension; per scalar signature
        # the legs: (down-leg, up-leg, pre-sweeps, post-sweeps), None
        # sweeps taking any count the leg accepts (their gates in
        # _LEG_GATES); the row-only const5 legs
        # (down-leg, up-leg); and the system legs (down-leg, up-leg)
        if use_kernels:
            self._sweeps = {True: rbgs.fused_rbgs_sweep,
                            False: rbgs.jacobi_sweep}
            self._sweeps_var = {True: rbgs_var.fused_rbgs_sweep_var,
                                False: rbgs_var.jacobi_sweep_var}
            self._sweeps_sys = {True: rbgs_sys.fused_rbgs_sweep_sys,
                                False: rbgs_sys.jacobi_sweep_sys}
            self._sweeps_cx = {True: rbgs_cx.fused_rbgs_sweep_cx,
                               False: rbgs_cx.jacobi_sweep_cx}
            self._legs_sys = (rbgs_sys.presmooth_residual_restrict_sys,
                              rbgs_sys.prolong_correct_postsmooth_sys)
            self._sweeps3d = {
                "rbgs3d": {True: rbgs3d.fused_rbgs_sweep_3d,
                           False: rbgs3d.jacobi_sweep_3d},
                "leg3d": {True: leg3d.fused_rbgs_sweep_3d2,
                          False: leg3d.jacobi_sweep_3d2}}
            self._residual_restrict = transfer.residual_restrict
            self._prolong_correct = transfer.prolong_correct
            self._residual_restrict_3d = leg3d.residual_restrict_3d
            self._prolong_correct_3d = leg3d.prolong_correct_3d
            self._row_legs = (transfer.presmooth_residual_rowrestrict,
                              transfer.prolong_correct_postsmooth)
            self._legs = {
                "const5": (transfer.presmooth_residual_restrict,
                           transfer.prolong_correct_postsmooth_col,
                           None, None),
                "var5": (rbgs_var.presmooth_residual_restrict_var,
                         rbgs_var.prolong_correct_postsmooth_var,
                         None, None),
                "const7": (wavefront3d.downleg_wavefront_3d,
                           wavefront3d.upleg_wavefront_3d, 2, 1)}
        else:
            self._sweeps = {True: rbgs.fused_rbgs_sweep_plain,
                            False: rbgs.jacobi_sweep_plain}
            self._sweeps_var = {True: rbgs_var.fused_rbgs_sweep_var_plain,
                                False: rbgs_var.jacobi_sweep_var_plain}
            self._sweeps_sys = {True: rbgs_sys.fused_rbgs_sweep_sys_plain,
                                False: rbgs_sys.jacobi_sweep_sys_plain}
            self._sweeps_cx = {True: rbgs_cx.fused_rbgs_sweep_cx_plain,
                               False: rbgs_cx.jacobi_sweep_cx_plain}
            self._legs_sys = (rbgs_sys.presmooth_residual_restrict_sys_plain,
                              rbgs_sys.prolong_correct_postsmooth_sys_plain)
            self._sweeps3d = {
                "rbgs3d": {True: rbgs3d.fused_rbgs_sweep_3d_plain,
                           False: rbgs3d.jacobi_sweep_3d_plain},
                "leg3d": {True: leg3d.fused_rbgs_sweep_3d2_plain,
                          False: leg3d.jacobi_sweep_3d2_plain}}
            self._residual_restrict = transfer.residual_restrict_plain
            self._prolong_correct = transfer.prolong_correct_plain
            self._residual_restrict_3d = leg3d.residual_restrict_3d_plain
            self._prolong_correct_3d = leg3d.prolong_correct_3d_plain
            self._row_legs = (
                transfer.presmooth_residual_rowrestrict_plain,
                transfer.prolong_correct_postsmooth_plain)
            self._legs = {
                "const5": (transfer.presmooth_residual_restrict_plain,
                           transfer.prolong_correct_postsmooth_col_plain,
                           None, None),
                "var5": (rbgs_var.presmooth_residual_restrict_var_plain,
                         rbgs_var.prolong_correct_postsmooth_var_plain,
                         None, None),
                "const7": (wavefront3d.downleg_wavefront_3d_plain,
                           wavefront3d.upleg_wavefront_3d_plain, 2, 1)}

    def bind(self, u_fields, b_fields):
        self.env[id(self.approximation)] = tuple(u_fields)
        self.env[id(self.rhs)] = tuple(b_fields)
        if isinstance(self.approximation, system.Approximation):
            for e, u in zip(self.approximation.entries, u_fields):
                self.env[id(e)] = (u,)
        if isinstance(self.rhs, system.RightHandSide):
            for e, b in zip(self.rhs.entries, b_fields):
                self.env[id(e)] = (b,)
        self.set_like(u_fields[0])

    def set_like(self, u):
        self.dtype = u.dtype
        self.device = u.device

    def _of_node(self, kind, node, build):
        """``build()`` for an IR node, once per lowered cycle: the stencil
        generators are pure, and deriving stencils and tables again on
        every step is most of an eager step's host work on small grids.
        The entry holds ``node``, so a hit is that object."""
        hit = self.constants.get((kind, id(node)))
        if hit is None or hit[0] is not node:
            hit = (node, build())
            self.constants[(kind, id(node))] = hit
        return hit[1]

    def _stencil(self, op):
        return self._of_node("stencil", op, op.generate_stencil)

    def _constant(self, key, build):
        key = key + (str(self.device), self.dtype)
        if key not in self.constants:
            self.constants[key] = build()
        return self.constants[key]

    # -- grid functions ----------------------------------------------------

    def eval_function(self, expr):
        key = id(expr)
        if key not in self.memo:
            self.memo[key] = self._eval_function(expr)
        return self.memo[key]

    def _eval_function(self, expr):
        if id(expr) in self.env:
            return self.env[id(expr)]
        if isinstance(expr, (system.ZeroApproximation,
                             base.ZeroApproximation)):
            return tuple(torch.zeros(tuple(g.size), dtype=self.dtype,
                                     device=self.device)
                         for g in field_grids(expr))
        if isinstance(expr, base.Cycle):
            plan = self.plans.super_by_smoother.get(id(expr))
            if plan is not None:
                out = self._run_super_fusion(plan)
                if out is not None:
                    return out[0]
            plan = self.plans.post_by_smoother.get(id(expr))
            if plan is not None:
                out = self._run_post_fusion(plan)
                if out is not None:
                    return out
            return self.eval_cycle(expr)
        if isinstance(expr, base.Residual):
            b = self.eval_function(expr.rhs)
            x = self.eval_function(expr.approximation)
            ax = self.apply_operator(expr.operator, x)
            return tuple(bi - axi for bi, axi in zip(b, ax))
        if isinstance(expr, base.Multiplication):
            plan = self.plans.super_by_mult.get(id(expr))
            if plan is not None:
                out = self._run_super_fusion(plan)
                if out is not None:
                    return out[1]
            fused = self._try_fused_residual_restrict(expr)
            if fused is not None:
                return fused
            x = self.eval_function(expr.operand2)
            return self.apply_operator(expr.operand1, x)
        if isinstance(expr, base.Addition):
            a = self.eval_function(expr.operand1)
            b = self.eval_function(expr.operand2)
            return tuple(ai + bi for ai, bi in zip(a, b))
        if isinstance(expr, base.Subtraction):
            a = self.eval_function(expr.operand1)
            b = self.eval_function(expr.operand2)
            return tuple(ai - bi for ai, bi in zip(a, b))
        if isinstance(expr, base.Scaling):
            x = self.eval_function(expr.operand)
            return tuple(expr.factor * xi for xi in x)
        if isinstance(expr, (system.Approximation, base.Approximation)):
            raise KeyError(f"unbound grid function {expr}")
        raise NotImplementedError(
            f"cannot evaluate {type(expr).__name__} as a function")

    # -- cycles ------------------------------------------------------------

    def eval_cycle(self, cycle: base.Cycle):
        """``x + omega * correction`` (lower.py:638-654)."""
        omega = self.omegas[cycle.global_id]
        x = self.eval_function(cycle.approximation)
        if _is_smoother(cycle.correction):
            nl = self._nonlinear_smoother_parts(cycle.correction)
            if nl is not None:
                return self._nonlinear_smooth(cycle, x, omega, nl)
            fused = self._try_fused_smoother(cycle, x)
            if fused is not None:
                return fused
            if cycle.partitioning is part.RedBlack:
                return self._red_black_sweep(cycle, x, omega)
        fused = self._try_fused_prolong_correct(cycle, x)
        if fused is not None:
            return fused
        c = self.eval_function(cycle.correction)
        return tuple(xi + _damped(omega, ci) for xi, ci in zip(x, c))

    def _red_black_sweep(self, cycle: base.Cycle, x, omega):
        """Red half-sweep, then black with refreshed red values
        (lower.py:1403-1419)."""
        corr = cycle.correction
        inverse_op = corr.operand1
        residual = corr.operand2
        b = self.eval_function(residual.rhs)
        A = residual.operator
        masks = [self._masks(g) for g in field_grids(cycle)]

        def half(u, color):
            r = tuple(bi - ai for bi, ai in zip(b, self.apply_operator(A, u)))
            c = self.apply_operator(inverse_op, r)
            return tuple(ui + _damped(omega, m[color] * ci)
                         for ui, ci, m in zip(u, c, masks))

        return half(half(x, 0), 1)

    def _masks(self, grid):
        """The red-black masks of a grid, once per lowered cycle, device
        and dtype."""
        return self._constant(("rb", tuple(grid.size)),
                              lambda: red_black_masks(
                                  tuple(grid.size), device=self.device,
                                  dtype=self.dtype))

    # -- nonlinear smoothing (FAS) -------------------------------------------

    @staticmethod
    def _nonlinear_smoother_parts(corr):
        """``(generator, entry, mode, n_steps)`` for a nonlinear smoother
        correction, else None (lower.py:919-932).  mode: "picard" (frozen
        coefficient) or "newton" (Jacobian denominator, the inverse of an
        ``Addition`` whose second operand is a ``system.Jacobian``)."""
        nl = _nonlinear_of(corr.operand2.operator)
        if nl is None:
            return None
        L = corr.operand1.operand
        if isinstance(L, base.Addition) and \
                isinstance(L.operand2, system.Jacobian):
            return nl + ("newton", L.operand2.n_newton_steps)
        return nl + ("picard", 1)

    @staticmethod
    def _nonlinear_denominator(gen, st, mode):
        """``denom(u)``: the diagonal of the linear part plus the nonlinear
        term's derivative (Newton) or coefficient (Picard)
        (lower.py:946-959)."""
        diag_lin = periodic.diagonal(st)
        diag_val = ops.scalar(diag_lin.to_constant().value_at(
            (0,) * st.dimension)) if diag_lin.is_constant else None
        d_nl_of = gen.nonlinear_derivative if mode == "newton" \
            else gen.nonlinear_coefficient

        def denom(u):
            if diag_val is not None:
                return diag_val + d_nl_of(u)
            return ops.apply_stencil(diag_lin, torch.ones_like(u)) + \
                d_nl_of(u)
        return denom

    def _nonlinear_smooth(self, cycle, x, omega, nl):
        """Damped Newton- or Picard-Jacobi sweeps,
        ``u <- u + w * mask * (b - A(u)) / (diag(L) + d(u))``, ``n_steps``
        times, red-black as two masked half-sweeps with the masks of global
        parity (lower.py:934-965; reference FAS_2D_Basic_template.exa4
        Smoother).  A Jacobi sweep's mask is all ones and is left out:
        the product is the same."""
        gen, entry, mode, n_steps = nl
        b = self.eval_function(cycle.correction.operand2.rhs)[0]
        st = periodic.as_periodic(self._stencil(entry))
        denom = self._nonlinear_denominator(gen, st, mode)
        masks = self._masks(entry.grid) \
            if cycle.partitioning is part.RedBlack else (None,)
        u = x[0]
        for _ in range(max(int(n_steps), 1)):
            for mask in masks:
                r = b - (ops.apply_stencil(st, u) + gen.nonlinear_term(u))
                step = r / denom(u)
                u = u + _damped(omega, step if mask is None
                                else mask * step)
        return (u,)

    # -- standalone kernels (ops/kernels/rbgs.py, transfer.py) ---------------

    @staticmethod
    def _pointwise_smoother_entry(cycle):
        """(scalar operator entry, residual) when the cycle is a
        pointwise-diagonal smoother u + w*D^-1*(b - A u) of a scalar
        (1x1-system) operator, else None (lower.py:656-678)."""
        corr = cycle.correction
        L = corr.operand1.operand
        residual = corr.operand2
        if residual.approximation is not cycle.approximation:
            return None
        if not isinstance(L, (system.Diagonal, system.ElementwiseDiagonal,
                              base.Diagonal)):
            return None
        entry = residual.operator
        if isinstance(entry, system.Operator):
            if len(entry.entries) != 1:
                return None
            entry = entry.entries[0][0]
        if not isinstance(entry, base.Operator):
            return None
        return entry, residual

    def _star_smoother_parts(self, cycle, x):
        """(stencil values, b) when the cycle is a pointwise-diagonal
        smoother of a scalar constant star operator, 5-point in 2D and
        7-point in 3D, else None (lower.py:680-707)."""
        found = self._pointwise_smoother_entry(cycle)
        if found is None:
            return None
        entry, residual = found
        if _is_nonlinear(entry) or _stencil_field_of(entry) is not None:
            return None
        st = entry.generate_stencil()
        if not isinstance(st, constant.Stencil):
            return None
        if x[0].ndim == 2:
            vals = rbgs.five_point_values(st)
        elif x[0].ndim == 3:
            vals = rbgs3d.seven_point_values(st)
        else:
            return None
        if vals is None or vals[0] == 0.0:
            return None
        return vals, self.eval_function(residual.rhs)[0]

    def _var_smoother_parts(self, cycle, x):
        """(coefficient stack, b) when the cycle is a pointwise-diagonal
        smoother of a scalar variable-coefficient 5-point 2D operator, else
        None (lower.py:709-732)."""
        found = self._pointwise_smoother_entry(cycle)
        if found is None:
            return None
        entry, residual = found
        if _is_nonlinear(entry):
            return None
        sf = _stencil_field_of(entry)
        if sf is None or x[0].ndim != 2:
            return None
        stack = self._var_stack(sf)
        if stack is None:
            return None
        return stack, self.eval_function(residual.rhs)[0]

    def _cx_smoother_parts(self, cycle, x):
        """(complex stencil values, b) when the cycle is a
        pointwise-diagonal smoother of a scalar constant complex 5-point
        2D operator, else None (lower.py:734-759).  An operator with a
        field form is refused even where its stencil is constant: the
        Robin-folded Helmholtz operator differs from its stencil on the
        boundary rows, which the kernel would smooth with the interior
        stencil.  Real fields return at once: the kernel takes only
        complex ones."""
        if not x[0].is_complex():
            return None
        found = self._pointwise_smoother_entry(cycle)
        if found is None:
            return None
        entry, residual = found
        if _is_nonlinear(entry) or x[0].ndim != 2:
            return None
        if _stencil_field_of(entry) is not None:
            return None
        st = self._stencil(entry)
        if not isinstance(st, constant.Stencil):
            return None
        vals = rbgs_cx.complex_five_point_values(st)
        if vals is None or vals[0] == 0:
            return None
        return vals, self.eval_function(residual.rhs)[0]

    def _var_stack(self, sf):
        """The (5, n, m) coefficient stack of a StencilField on the
        lowering's device and dtype, or None (lower.py:1092-1098)."""
        return rbgs_var.five_point_stack(sf, device=self.device,
                                         dtype=self.dtype)

    @staticmethod
    def _sys_minv(coeffs, kind):
        """The constant F x F point-solve matrix of a sys9 signature, in
        numpy float64: the inverse of the center-coefficient matrix
        ("elem") or of its diagonal ("diag"), or None when it is singular
        (lower.py:1100-1115)."""
        F = len(coeffs)
        centers = np.array([[coeffs[i][j][0] for j in range(F)]
                            for i in range(F)])
        if kind == "diag":
            d = np.diag(centers)
            if np.any(d == 0.0):
                return None
            minv = np.diag(1.0 / d)
        else:
            if abs(np.linalg.det(centers)) < 1e-30:
                return None
            minv = np.linalg.inv(centers)
        return tuple(tuple(float(v) for v in r) for r in minv)

    @staticmethod
    def _sys_minv_exc(coeffs, kind, exc, minv):
        """The point-solve deltas of the rows of ``exc``: ``(row, F x F
        inv(C + D_row) - minv)`` pairs, or None when one is singular
        (lower.py:1117-1141)."""
        if not exc:
            return ()
        F = len(coeffs)
        centers = np.array([[coeffs[i][j][0] for j in range(F)]
                            for i in range(F)])
        out = []
        for row, dmat in exc:
            cm = centers + np.asarray(dmat)
            if kind == "diag":
                d = np.diag(cm)
                if np.any(d == 0.0):
                    return None
                mi = np.diag(1.0 / d)
            else:
                if abs(np.linalg.det(cm)) < 1e-30:
                    return None
                mi = np.linalg.inv(cm)
            dm = mi - np.asarray(minv)
            out.append((row, tuple(tuple(float(v) for v in r) for r in dm)))
        return tuple(out)

    def _sys_point_solve(self, coeffs, kind, exc):
        """``(minv, exc_minv)`` of a sys9 operator, or None; once per
        lowered cycle and table."""
        key = ("point solve", coeffs, kind, exc)
        if key not in self.constants:
            minv = self._sys_minv(coeffs, kind)
            exc_minv = None if minv is None else \
                self._sys_minv_exc(coeffs, kind, exc, minv)
            self.constants[key] = None if minv is None or (
                exc and exc_minv is None) else (minv, exc_minv)
        return self.constants[key]

    def _sys_smoother_parts(self, cycle, x):
        """``(coeffs, minv, b, exc, exc_minv)`` when the cycle is a
        pointwise smoother of an F x F system of 9-point 2D blocks, else
        None (lower.py:761-797); the table comes from ``_sys_nine_table``,
        as the signature's does."""
        corr = cycle.correction
        L = corr.operand1.operand
        residual = corr.operand2
        if residual.approximation is not cycle.approximation:
            return None
        if not isinstance(L, (system.Diagonal, system.ElementwiseDiagonal)):
            return None
        A = residual.operator
        if not isinstance(A, system.Operator):
            return None
        F = len(A.entries)
        if F < 2 or len(x) != F or any(len(r) != F for r in A.entries):
            return None
        if x[0].ndim != 2:
            return None
        ct = self._of_node("nine table", A, lambda: _sys_nine_table(A))
        if ct is None:
            return None
        coeffs, exc = ct
        solve = self._sys_point_solve(
            coeffs, "diag" if isinstance(L, system.Diagonal) else "elem", exc)
        if solve is None:
            return None
        b = self.eval_function(residual.rhs)
        if len(b) != F:
            return None
        return coeffs, solve[0], b, exc, solve[1]

    def _try_fused_smoother(self, cycle, x):
        """One sweep kernel for a red-black or single (Jacobi) smoother
        cycle on a level a sweep gate admits, else None for the generic
        path (lower.py:799-917): a variable-coefficient 2D operator under
        the ``rbgs_var`` gate; a system of 9-point 2D blocks under the
        ``rbgs_sys`` gate; a constant complex 5-point 2D operator under
        the ``rbgs_cx`` gate; a constant star operator in 2D under the
        ``rbgs`` gate, in 3D under the ``rbgs3d`` gate first, then the
        ``leg3d`` one.  Each signature refuses the others' operators, so
        the order of the tests does not change what runs."""
        red_black = cycle.partitioning is part.RedBlack
        if not red_black and cycle.partitioning is not part.Single:
            return None
        sys_parts = self._sys_smoother_parts(cycle, x)
        if sys_parts is not None:
            coeffs, minv, b, exc, exc_minv = sys_parts
            if not rbgs_sys.supports(x, coeffs, exc, exc_minv):
                return None
            return self._sweeps_sys[red_black](
                tuple(f.contiguous() for f in x),
                tuple(f.contiguous() for f in b), self.omegas,
                cycle.global_id, coeffs, minv, exc, exc_minv)
        u = x[0]
        var_parts = self._var_smoother_parts(cycle, x)
        if var_parts is not None:
            stack, b = var_parts
            if not rbgs_var.supports(u, stack):
                return None
            return (self._sweeps_var[red_black](
                u.contiguous(), b.contiguous(), self.omegas,
                cycle.global_id, stack),)
        cx_parts = self._cx_smoother_parts(cycle, x)
        if cx_parts is not None:
            vals, b = cx_parts
            if not rbgs_cx.supports(u, vals):
                return None
            return (self._sweeps_cx[red_black](
                u.contiguous(), b.contiguous(), self.omegas,
                cycle.global_id, vals),)
        parts = self._star_smoother_parts(cycle, x)
        if parts is None:
            return None
        vals, b = parts
        if u.ndim == 2 and rbgs.supports(u, vals):
            sweeps = self._sweeps
        elif u.ndim == 3 and rbgs3d.supports(u, vals):
            sweeps = self._sweeps3d["rbgs3d"]
        elif u.ndim == 3 and leg3d.supports(u):
            sweeps = self._sweeps3d["leg3d"]
        else:
            return None
        return (sweeps[red_black](u.contiguous(), b.contiguous(),
                                  self.omegas, cycle.global_id, vals),)

    def _try_fused_residual_restrict(self, expr):
        """``Multiplication(Restriction, Residual)`` of a scalar constant
        5-point 2D operator as one kernel, on a level the transfer gate
        admits, else the 3D form, else None (lower.py:1311-1340)."""
        R, res = expr.operand1, expr.operand2
        if not isinstance(res, base.Residual):
            return None
        if not isinstance(R, (system.Restriction, base.Restriction)) or \
                isinstance(R, base.ZeroRestriction):
            return None
        st = _scalar_constant_stencil(res.operator)
        if st is None:
            return None
        vals = rbgs.five_point_values(st)
        if vals is None:
            return self._try_fused_residual_restrict_3d(R, res, st)
        taps = transfer_three_tap(R)
        if taps is None:
            return None
        x = self.eval_function(res.approximation)
        if len(x) != 1 or not transfer.supports(x[0],
                                                "row 4 (residual_restrict)"):
            return None
        b = self.eval_function(res.rhs)
        return (self._residual_restrict(x[0].contiguous(), b[0].contiguous(),
                                        vals, taps),)

    def _try_fused_residual_restrict_3d(self, R, res, st):
        """The residual of a scalar constant 7-point 3D operator and its
        full restriction as one kernel, on a level the ``leg3d`` gate
        admits, else None (lower.py:1291-1309)."""
        vals = rbgs3d.seven_point_values(st)
        if vals is None or vals[0] == 0.0:
            return None
        taps = axis_taps_3d(R)
        if taps is None:
            return None
        x = self.eval_function(res.approximation)
        if len(x) != 1 or not leg3d.supports(x[0]):
            return None
        b = self.eval_function(res.rhs)
        return (self._residual_restrict_3d(x[0].contiguous(),
                                           b[0].contiguous(), vals, taps),)

    def _try_fused_prolong_correct(self, cycle, x):
        """Cycle tail ``u + omega * Multiplication(Prolongation, e)`` as one
        kernel on a level the transfer gate admits (2D) or the ``leg3d``
        gate admits (3D), else None (lower.py:1342-1395)."""
        corr = cycle.correction
        if not isinstance(corr, base.Multiplication):
            return None
        P = corr.operand1
        if not isinstance(P, (system.Prolongation, base.Prolongation)) or \
                isinstance(P, base.ZeroProlongation):
            return None
        if len(x) == 1 and x[0].ndim == 3:
            return self._try_fused_prolong_correct_3d(cycle, x[0], P, corr)
        if len(x) != 1 or not transfer.supports(x[0],
                                                "row 5 (prolong_correct)"):
            return None
        taps = transfer_three_tap(P)
        if taps is None:
            return None
        e = self.eval_function(corr.operand2)
        if len(e) != 1:
            return None
        u = x[0]
        n, m = u.shape
        if e[0].dtype != u.dtype or \
                tuple(e[0].shape) != ((n - 1) // 2, (m - 1) // 2):
            return None
        return (self._prolong_correct(u.contiguous(), e[0].contiguous(),
                                      self.omegas, cycle.global_id, taps),)

    def _try_fused_prolong_correct_3d(self, cycle, u, P, corr):
        """The 3D cycle tail ``u + omega * P e`` as one kernel on a level
        the ``leg3d`` gate admits, else None (lower.py:1378-1395)."""
        if not leg3d.supports(u):
            return None
        taps = axis_taps_3d(P)
        if taps is None:
            return None
        e = self.eval_function(corr.operand2)
        if len(e) != 1 or \
                tuple(e[0].shape) != tuple((s - 1) // 2 for s in u.shape):
            return None
        return (self._prolong_correct_3d(
            u.contiguous(), e[0].to(u.dtype).contiguous(), self.omegas,
            cycle.global_id, taps),)

    # -- fused legs (ops/kernels/transfer.py, wavefront3d.py) ----------------

    def _run_super_fusion(self, plan):
        """Planned down-leg: ``((u_smoothed,), (coarse_residual,))``, or
        None when the gate rejects the level (lower.py:972-1061)."""
        key = id(plan["mult"])
        if key in self._super_results:
            return self._super_results[key]
        if plan["kind"] == "sys9":
            result = self._run_super_fusion_sys(plan)
            self._super_results[key] = result
            return result
        result = None
        supports = _LEG_GATES[plan["kind"]]
        down, _, n_pre, _ = self._legs[plan["kind"]]
        row_only = self._row_only(plan)
        if plan["taps"] is not None and row_only is not None and \
                n_pre in (None, len(plan["sweeps"])):
            x = self.eval_function(plan["base"])
            operator, kw = self._leg_operator(plan)
            if len(x) == 1 and supports(x[0], row_only) and \
                    operator is not None:
                b = self.eval_function(plan["res"].rhs)
                ids = [c.global_id for c in reversed(plan["sweeps"])]
                if row_only:
                    row_taps, col_taps = plan["taps"]
                    u_s, rr = self._row_legs[0](x[0], b[0], self.omegas,
                                                ids, operator, row_taps)
                    rc = ops.axis_restrict_3tap(rr, 1, col_taps)
                else:
                    u_s, rc = down(x[0], b[0], self.omegas, ids, operator,
                                   plan["taps"], **kw)
                result = ((u_s,), (rc,))
        self._super_results[key] = result
        return result

    @staticmethod
    def _row_only(plan):
        """Whether a planned const5 or var5 leg runs in its row-only form,
        read from ``config.fused_column_transfers`` now: False with fused
        column transfers or for a const7 leg, True for a const5 leg
        without, None (refused) for a var5 one (lower.py:1007-1009)."""
        if plan["kind"] == "const7" or fused_cols_enabled():
            return False
        return True if plan["kind"] == "const5" else None

    def _leg_operator(self, plan):
        """(operator argument, keyword arguments) of a planned leg's call:
        the stencil values of a constant operator; the coefficient stack
        (None when the field has no 5-point stack) and the partitioning of
        a var5 one."""
        if plan["kind"] != "var5":
            return plan["vals"], {}
        return self._var_stack(plan["vals"]), {"red_black": plan["red_black"]}

    def _sys_leg_parts(self, plan, x, rhs):
        """``(coeffs, minv, b, exc, exc_minv)`` of a planned sys9 leg on
        the fields ``x`` with right-hand side ``rhs``, or None when its
        gate rejects the level or the point solve is singular
        (lower.py:1143-1164, :1188-1206)."""
        coeffs, kind, exc = plan["vals"]
        solve = self._sys_point_solve(coeffs, kind, exc)
        if solve is None or len(x) != len(coeffs) or \
                not rbgs_sys.leg_supports(x, exc, solve[1]):
            return None
        b = self.eval_function(rhs)
        if len(b) != len(coeffs):
            return None
        return coeffs, solve[0], tuple(f.contiguous() for f in b), exc, \
            solve[1]

    def _run_super_fusion_sys(self, plan):
        """Planned sys9 down-leg: ``(u_smoothed, coarse_residuals)``, each
        F fields, or None, as without fused column transfers
        (lower.py:1143-1171)."""
        if plan["taps"] is None or not fused_cols_enabled():
            return None
        x = self.eval_function(plan["base"])
        parts = self._sys_leg_parts(plan, x, plan["res"].rhs)
        if parts is None:
            return None
        coeffs, minv, b, exc, exc_minv = parts
        ids = [c.global_id for c in reversed(plan["sweeps"])]
        return self._legs_sys[0](
            tuple(f.contiguous() for f in x), b, self.omegas, ids, coeffs,
            minv, plan["taps"], red_black=plan["red_black"], exc=exc,
            exc_minv=exc_minv)

    def _run_post_fusion_sys(self, plan):
        """Planned sys9 up-leg: the F fields of the outermost
        post-smoother, or None, as without fused column transfers
        (lower.py:1188-1216)."""
        if plan["taps"] is None or not fused_cols_enabled():
            return None
        cgc = plan["cgc"]
        x = self.eval_function(cgc.approximation)
        parts = self._sys_leg_parts(plan, x, plan["rhs"])
        if parts is None:
            return None
        coeffs, minv, b, exc, exc_minv = parts
        n, m = x[0].shape
        e = self.eval_function(cgc.correction.operand2)
        if len(e) != len(x) or any(
                tuple(ei.shape) != ((n - 1) // 2, (m - 1) // 2) for ei in e):
            return None
        ids = [cgc.global_id] + \
            [c.global_id for c in reversed(plan["sweeps"])]
        return self._legs_sys[1](
            tuple(f.contiguous() for f in x),
            tuple(ei.contiguous() for ei in e), b, self.omegas, ids, coeffs,
            minv, plan["taps"], red_black=plan["red_black"], exc=exc,
            exc_minv=exc_minv)

    def _run_post_fusion(self, plan):
        """Planned up-leg: the value of the outermost post-smoother, or
        None when the gate rejects the level (lower.py:1063-1090,
        :1173-1247)."""
        if plan["kind"] == "sys9":
            return self._run_post_fusion_sys(plan)
        supports = _LEG_GATES[plan["kind"]]
        _, up, _, n_post = self._legs[plan["kind"]]
        row_only = self._row_only(plan)
        if plan["taps"] is None or row_only is None or \
                n_post not in (None, len(plan["sweeps"])):
            return None
        cgc = plan["cgc"]
        x = self.eval_function(cgc.approximation)
        operator, kw = self._leg_operator(plan)
        if len(x) != 1 or not supports(x[0], row_only) or operator is None:
            return None
        e = self.eval_function(cgc.correction.operand2)
        if len(e) != 1 or tuple(e[0].shape) != \
                tuple((n - 1) // 2 for n in x[0].shape):
            return None
        # the coarse levels compute a bf16 cycle's correction in float32
        # (_damped); the leg takes it in its storage (lower.py:1224-1242)
        e = (e[0].to(x[0].dtype),)
        b = self.eval_function(plan["rhs"])
        ids = [cgc.global_id] + \
            [c.global_id for c in reversed(plan["sweeps"])]
        if row_only:
            row_taps, col_taps = plan["taps"]
            c_half = ops.axis_prolong_3tap(e[0], 1, col_taps, x[0].shape[1])
            return (self._row_legs[1](x[0], c_half, b[0], self.omegas, ids,
                                      operator, row_taps),)
        return (up(x[0], e[0], b[0], self.omegas, ids, operator,
                   plan["taps"], **kw),)

    # -- operators ----------------------------------------------------------

    def apply_operator(self, expr, fields: Tuple):
        """Operator application (lower.py:1423-1515, the node types the
        V-cycle reaches)."""
        if isinstance(expr, base.Inverse):
            return self.apply_inverse(expr.operand, fields)
        if isinstance(expr, base.CoarseGridSolver):
            return self.apply_coarse_solver(expr, fields)
        if isinstance(expr, KrylovSubspaceMethod):
            # a fixed-iteration Krylov solve (lower.py:1428-1430)
            return solvers.FIXED_KRYLOV[expr.name](
                lambda v: self.apply_operator(expr.operator, v), fields,
                expr.iterations)
        if isinstance(expr, system.Restriction) or (
                isinstance(expr, base.Restriction)
                and not isinstance(expr, base.ZeroRestriction)):
            return self._apply_restriction(expr, fields)
        if isinstance(expr, system.Prolongation) or (
                isinstance(expr, base.Prolongation)
                and not isinstance(expr, base.ZeroProlongation)):
            return self._apply_prolongation(expr, fields)
        if isinstance(expr, system.Operator):
            return self._apply_system(expr, fields)
        if isinstance(expr, base.ZeroOperator):
            return tuple(torch.zeros_like(f) for f in fields)
        if isinstance(expr, base.Identity):
            return fields
        if type(expr) is base.Operator:
            nl = _nonlinear_of(expr)
            if nl is not None:
                # A(u) = L u + N(u) (lower.py:1444-1449)
                lin = ops.apply_stencil(
                    periodic.as_periodic(self._stencil(expr)), fields[0])
                return (lin + nl[0].nonlinear_term(fields[0]),)
            sf = _stencil_field_of(expr)
            if sf is not None:
                return (sf.apply(fields[0]),)
            st = self._stencil(expr)
            return (ops.apply_stencil(periodic.as_periodic(st), fields[0]),)
        raise NotImplementedError(f"cannot apply {type(expr).__name__}")

    def _apply_system(self, op: system.Operator, fields):
        out = []
        for row in op.entries:
            acc = None
            for entry, x in zip(row, fields):
                if isinstance(entry, base.ZeroOperator):
                    continue
                (y,) = self.apply_operator(entry, (x,))
                acc = y if acc is None else acc + y
            out.append(acc if acc is not None else torch.zeros(
                tuple(row[0].grid.size), dtype=self.dtype,
                device=self.device))
        return tuple(out)

    def _apply_restriction(self, expr, fields):
        entries = expr.entries if isinstance(expr, system.Restriction) \
            else None
        ops_list = [row[i] for i, row in enumerate(entries)] if entries \
            else [expr]
        return tuple(ops.restrict(self._stencil(op), x)
                     for op, x in zip(ops_list, fields))

    def _apply_prolongation(self, expr, fields):
        entries = expr.entries if isinstance(expr, system.Prolongation) \
            else None
        ops_list = [row[i] for i, row in enumerate(entries)] if entries \
            else [expr]
        return tuple(ops.prolong(self._stencil(op), x,
                                 tuple(op.fine_grid.size))
                     for op, x in zip(ops_list, fields))

    # -- inverses (smoother solves) -----------------------------------------

    @staticmethod
    def _unwrap_operator(expr):
        while not isinstance(expr, system.Operator):
            if isinstance(expr, base.UnaryExpression):
                expr = expr.operand
            else:
                raise NotImplementedError(
                    f"cannot locate system operator under "
                    f"{type(expr).__name__}")
        return expr

    def _diagonal_inverse(self, entry, x):
        """``D^-1 x`` of one operator entry: a division by the diagonal
        field of a variable-coefficient entry, in the complex dtype of
        ``x``'s precision if the field is complex (lower.py:1526-1532,
        :1579-1585), else the inverse of the diagonal stencil."""
        sf = _stencil_field_of(entry)
        if sf is not None:
            if np.iscomplexobj(np.asarray(sf.diagonal_field())):
                x = x.to(ops.complex_dtype(x.dtype))
            return x / sf.diagonal_tensor(x.device, x.dtype)
        ps = periodic.as_periodic(self._stencil(entry))
        return ops.apply_stencil(periodic.inverse(periodic.diagonal(ps)), x)

    def apply_inverse(self, L, fields):
        """Point-Jacobi inverses (lower.py:1519-1545), the collective point
        inverse (lower.py:1575-1624) and block inverses
        (lower.py:1546-1553)."""
        if isinstance(L, system.Diagonal):
            op = self._unwrap_operator(L.operand)
            return tuple(self._diagonal_inverse(op.entries[i][i], x)
                         for i, x in enumerate(fields))
        if isinstance(L, system.ElementwiseDiagonal):
            op = self._unwrap_operator(L.operand)
            return self._pointwise_collective_inverse(op, fields)
        if isinstance(L, base.Diagonal):
            inv = periodic.inverse(periodic.as_periodic(L.generate_stencil()))
            return tuple(ops.apply_stencil(inv, f) for f in fields)
        if isinstance(L, base.BlockDiagonal):
            ps = periodic.as_periodic(L.generate_stencil())
            plan = get_block_solve_plan([[ps]], L.block_size,
                                        tuple(L.grid.size))
            return plan.apply(fields)
        if isinstance(L, system.Operator):
            return self._system_local_inverse(L, fields)
        raise NotImplementedError(
            f"inverse of {type(L).__name__} is not ported yet")

    def _pointwise_collective_inverse(self, op: system.Operator, fields):
        """Collective point Jacobi: the m x m system of central coefficients
        solved at every point (lower.py:1575-1624).  A scalar operator
        divides by its diagonal; constant central coefficients give one
        m x m inverse, computed in numpy (complex128 if a coefficient is
        complex), whose nonzero entries, cast to each field's kind, scale
        the fields, summed in j order."""
        m = len(op.entries)
        if m == 1:
            return (self._diagonal_inverse(op.entries[0][0], fields[0]),)
        # pointwise-varying central coefficients (boundary-folded
        # operators, e.g. the split-complex Helmholtz Robin rows): the m x m
        # system solved per grid point with the local diagonal
        # (lower.py:1590-1596)
        if any(_stencil_field_of(e) is not None
               for row in op.entries for e in row):
            return self._pointwise_varying_inverse(op, fields)
        D = np.zeros((m, m), dtype=np.complex128)
        is_complex = False
        for i in range(m):
            for j in range(m):
                ps = periodic.as_periodic(op.entries[i][j].generate_stencil())
                if ps is None:
                    continue
                if not ps.is_constant:
                    raise NotImplementedError(
                        "periodic collective point smoother not supported")
                v = ps.to_constant().value_at((0,) * ps.dimension, 0)
                is_complex = is_complex or isinstance(v, complex)
                D[i, j] = v
        Dinv = np.linalg.inv(D if is_complex else D.real)
        out = []
        for i in range(m):
            acc = None
            for j in range(m):
                if Dinv[i, j] == 0:
                    continue
                # jnp.asarray(Dinv[i, j], fields[j].dtype): a real field
                # keeps the real part
                v = Dinv[i, j]
                term = (complex(v) if fields[j].is_complex()
                        else float(np.real(v))) * fields[j]
                acc = term if acc is None else acc + term
            out.append(acc if acc is not None
                       else torch.zeros_like(fields[i]))
        return tuple(out)

    def _pointwise_varying_inverse(self, op: system.Operator, fields):
        """Collective point solve with position-dependent central
        coefficients, ``D(x) y(x) = r(x)`` at every point, D built from the
        entries' diagonal fields (the coefficient at offset 0; constant
        entries broadcast), complex if one is (lower.py:1626-1684).  For
        m = 2 the closed-form inverse's four entries are formed in numpy
        and applied as scalars with a few row fixups where they are
        almost uniform (``ops.almost_uniform_desc``); otherwise a batched
        ``torch.linalg.solve``.  The device terms are built once per
        lowered cycle, device and dtype."""
        m = len(op.entries)
        shape = tuple(fields[0].shape)

        def diagonals():
            d = [[None] * m for _ in range(m)]
            for i in range(m):
                for j in range(m):
                    entry = op.entries[i][j]
                    sf = _stencil_field_of(entry)
                    if sf is not None:
                        d[i][j] = np.asarray(sf.diagonal_field())
                        continue
                    ps = periodic.as_periodic(entry.generate_stencil())
                    if ps is None:
                        d[i][j] = np.zeros(shape)
                    elif not ps.is_constant:
                        raise NotImplementedError(
                            "periodic collective point smoother not "
                            "supported")
                    else:
                        d[i][j] = np.full(shape, ps.to_constant().value_at(
                            (0,) * ps.dimension, 0))
            return d

        def build():
            d = diagonals()
            dtype = fields[0].dtype
            if any(np.iscomplexobj(a) for row in d for a in row):
                dtype = ops.complex_dtype(dtype)
            if m != 2:
                D = np.stack([np.stack(row, axis=-1) for row in d], axis=-2)
                return dtype, torch.as_tensor(D, dtype=dtype,
                                              device=self.device)
            det = d[0][0] * d[1][1] - d[0][1] * d[1][0]
            minv = [[d[1][1] / det, -d[0][1] / det],
                    [-d[1][0] / det, d[0][0] / det]]
            terms = []
            for row in minv:
                terms.append([])
                for a in row:
                    desc = ops.almost_uniform_desc(a)
                    if desc is None:
                        terms[-1].append((torch.as_tensor(
                            a, dtype=dtype, device=self.device), []))
                        continue
                    rows = [(i, torch.as_tensor(r, dtype=dtype,
                                                device=self.device))
                            for i, r in desc[2]] if desc[0] == "rows" else []
                    terms[-1].append((ops.scalar(desc[1]), rows))
            return dtype, terms

        dtype, built = self._constant(
            ("varying inverse", id(op), fields[0].dtype), build)
        f = [x.to(dtype) for x in fields]
        if m != 2:
            y = torch.linalg.solve(built, torch.stack(f, dim=-1)[..., None])
            return tuple(y[..., i, 0] for i in range(m))
        out = []
        for row in built:
            acc = None
            fixups = []
            for term, x in zip(row, f):
                bulk, fixes = ops.almost_uniform_mul(term, x)
                fixups.extend(fixes)
                acc = bulk if acc is None else acc + bulk
            for i, add in fixups:
                acc[i] = acc[i] + add
            out.append(acc)
        return tuple(out)

    def _system_local_inverse(self, op: system.Operator, fields):
        """Invert a system operator whose entries are block-diagonal
        periodic stencils (collective block Jacobi) or pointwise-diagonal
        ones (lower.py:1686-1706)."""
        stencils = [[periodic.as_periodic(e.generate_stencil()) for e in row]
                    for row in op.entries]
        periods = [ps.period for row in stencils for ps in row
                   if ps is not None]
        # the block lattice must tile every entry's period exactly: the
        # per-axis lcm (lower.py:1693-1699)
        lcm_period = tuple(reduce(math.lcm, (p[k] for p in periods), 1)
                           for k in range(len(periods[0])))
        all_diagonal = all(ps is None or periodic.is_diagonal(ps)
                           for row in stencils for ps in row)
        if all_diagonal and lcm_period == (1,) * len(lcm_period):
            return self._pointwise_collective_inverse(op, fields)
        shape = tuple(op.entries[0][0].grid.size)
        return get_block_solve_plan(stencils, lcm_period, shape).apply(fields)

    # -- coarse-grid solver ---------------------------------------------------

    def apply_coarse_solver(self, cgs: base.CoarseGridSolver, fields):
        """The coarsest grid's solve (lower.py:1743-1769): the node's
        evolved cycle, else the spliced coarser chunk, else a nonlinear
        operator's fixed Newton-Jacobi sweeps from the node's initial
        guess, else the dense inverse's matvec up to ``DIRECT_SOLVE_MAX``
        unknowns and CG above."""
        if cgs.expression is not None:
            # an evolved coarse solver: one application of its cycle
            if getattr(cgs.expression, "wants_omegas", False):
                return cgs.expression(fields, self.omegas)
            return cgs.expression(fields)
        if self.cgs_override is not None:
            # a chunk boundary: at a FAS one the coarser chunk starts from
            # the node's initial guess, the restricted solution, whole
            # (lower.py:1748-1757)
            u0 = None
            if getattr(cgs, "initial_guess", None) is not None:
                u0 = self.eval_function(cgs.initial_guess)
            return self.cgs_override(fields, self.omegas, u0)
        op = cgs.operator
        nl = _nonlinear_of(op)
        if nl is not None:
            # FAS: the coarse solve starts from the restricted solution
            # when the node carries it (lower.py:1759-1764)
            u0 = None
            if getattr(cgs, "initial_guess", None) is not None:
                u0 = self.eval_function(cgs.initial_guess)[0]
            return self._nonlinear_coarse_solve(nl, fields, u0)
        if _coarse_unknowns(op) > DIRECT_SOLVE_MAX:
            return solvers.cg(lambda v: self.apply_operator(op, v), fields,
                              tol=CG_TOLERANCE, maxiter=CG_MAXITER)

        # the fields' dtype, complex if the inverse is (lower.py:1725-1731)
        inv = self._of_node("dense", op, lambda: dense_inverse(op))
        flat = torch.cat([f.reshape(-1) for f in fields])
        dtype = ops.complex_dtype(flat.dtype) if np.iscomplexobj(inv) \
            else flat.dtype
        inv = self._constant(("dense", id(op), dtype), lambda: torch.as_tensor(
            inv, dtype=dtype, device=self.device))
        flat = flat.to(dtype)
        y = inv @ flat
        out, o = [], 0
        for f in fields:
            k = f.numel()
            out.append(y[o:o + k].reshape(f.shape))
            o += k
        return tuple(out)

    def _nonlinear_coarse_solve(self, nl, fields, u0=None):
        """Coarsest nonlinear solve: NONLINEAR_CGS_SWEEPS damped
        Newton-Jacobi sweeps at NONLINEAR_CGS_OMEGA, from ``u0`` or zero
        (lower.py:1771-1792; reference FAS_2D_Basic_template.exa4
        CGS@coarsest)."""
        gen, entry = nl
        st = periodic.as_periodic(self._stencil(entry))
        denom = self._nonlinear_denominator(gen, st, "newton")
        b = fields[0]
        u = torch.zeros_like(b) if u0 is None else u0
        for _ in range(NONLINEAR_CGS_SWEEPS):
            r = b - (ops.apply_stencil(st, u) + gen.nonlinear_term(u))
            u = u + NONLINEAR_CGS_OMEGA * (r / denom(u))
        return (u,)


#: reference FAS CGS@coarsest: 200 damped smoother sweeps (lower.py:1791-1792)
NONLINEAR_CGS_SWEEPS = 200
NONLINEAR_CGS_OMEGA = 0.8
#: the CG coarse solve above DIRECT_SOLVE_MAX unknowns (lower.py:1769; the
#: reference's ``cgs cg`` with 1e-12 / 1000)
CG_TOLERANCE = 1e-12
CG_MAXITER = 1000


def _coarse_unknowns(op) -> int:
    return sum(int(np.prod(g.size)) for g in field_grids(op))


def _runs_cg(root) -> bool:
    """Whether a step of ``root``, with no chunk spliced in, reaches a
    linear coarse solve by ``solvers.cg``."""
    return any(cgs.expression is None and not _is_nonlinear(cgs.operator)
               and _coarse_unknowns(cgs.operator) > DIRECT_SOLVE_MAX
               for cgs in transformations.find_nodes(
                   root, base.CoarseGridSolver))


def _find_fine_operator(root):
    """Locate the finest-level operator for residuals (lower.py:1795-1803)."""
    fine_grids = field_grids(root)
    for r in transformations.find_nodes(root, base.Residual):
        if field_grids(r) == fine_grids or \
                [g.size for g in field_grids(r)] == \
                [g.size for g in fine_grids]:
            return r.operator
    return None


def lower_cycle(root: base.Cycle, approximation, rhs, *,
                use_kernels: bool = True) -> LoweredCycle:
    """Lower a cycle expression to a step function (lower.py:1806-1820).

    ``use_kernels=False`` makes the kernels run their plain PyTorch
    versions on every device; it exists only for comparing the kernels
    with them on the card."""
    n = transformations.assign_cycle_ids(root)
    cycles = transformations.find_nodes(root, base.Cycle)
    default_omegas = np.array([float(c.relaxation_factor) for c in cycles])
    plans = _plans_of(root)
    constants: dict = {}

    def step(u_fields, b_fields, omegas):
        lowering = _Lowering(approximation, rhs, omegas, plans=plans,
                             constants=constants, use_kernels=use_kernels)
        lowering.bind(u_fields, b_fields)
        return lowering.eval_function(root)

    return LoweredCycle(step=step, n_omegas=n, default_omegas=default_omegas,
                        grids=field_grids(root),
                        operator=_find_fine_operator(root), expression=root,
                        approximation=approximation, rhs=rhs, plans=plans,
                        constants=constants, use_kernels=use_kernels,
                        syncs_host=_runs_cg(root))


def _plans_of(root) -> _Plans:
    super_by_smoother, super_by_mult = _plan_super_fusions(root)
    return _Plans(super_by_smoother, super_by_mult, _plan_post_fusions(root))


def make_chain_applier(root, approximation, rhs, inner=None, *,
                       use_kernels: bool = True) -> Callable:
    """``fn(fields, omegas, initial_guess=None) -> fields``: one application
    of a chunk's cycle to the rhs ``fields`` from a zero initial guess, or
    from ``initial_guess`` (the restricted solution a FAS chunk boundary
    hands down), with ``inner`` (the same signature, or None) spliced into
    its unsolved CoarseGridSolver nodes (lower.py:1834-1852).  ``omegas``
    is the composed program's whole relaxation-factor vector, indexed by
    the ids ``lower_composed`` assigned across the chunks.  The chunk's
    plans and device constants are built once, here and at its first
    application, and serve every later one."""
    plans = _plans_of(root)
    constants: dict = {}

    def applier(fields, omegas, initial_guess=None):
        lowering = _Lowering(approximation, rhs, omegas, plans=plans,
                             constants=constants, use_kernels=use_kernels,
                             cgs_override=inner)
        u0 = (tuple(initial_guess) if initial_guess is not None
              else tuple(torch.zeros_like(f) for f in fields))
        lowering.bind(u0, tuple(fields))
        return lowering.eval_function(root)

    applier.wants_omegas = True
    return applier


def lower_composed(chain: List[ChainLink], cand_root: base.Cycle,
                   cand_approximation, cand_rhs, *,
                   use_kernels: bool = True) -> LoweredCycle:
    """Lower the whole program of a level-chunked run (lower.py:1855-1900):
    the finished chunks' best cycles (``chain``, finest first), each
    chunk's unsolved coarse-grid solves dispatching to the next, with the
    candidate cycle innermost: the counterpart of the reference's
    solver-program splicing (optimization/program.py:810-899,
    exastencils.py:485-537).  Cycle ids are assigned chain first, candidate
    last, so one omegas vector drives the whole program.

    Each chunk's applier (``make_chain_applier``) gets its plans, its
    device-constant cache and ``use_kernels`` once, here, so that a step
    re-plans nothing; a step applies the finest chunk's from the state.
    Whether a step syncs the host is the candidate's: the chain's unsolved
    coarse solves are all spliced."""
    if not chain:
        return lower_cycle(cand_root, cand_approximation, cand_rhs,
                           use_kernels=use_kernels)
    offset = 0
    for link in chain:
        offset = transformations.assign_cycle_ids(link.root, start=offset)
    n = transformations.assign_cycle_ids(cand_root, start=offset)
    all_cycles = [c for link in chain
                  for c in transformations.find_nodes(link.root, base.Cycle)]
    all_cycles += transformations.find_nodes(cand_root, base.Cycle)
    default_omegas = np.array([float(c.relaxation_factor)
                               for c in all_cycles])

    # innermost first: each chunk's applier splices in the one below it
    appliers = [None]
    for link in reversed(chain + [ChainLink(cand_root, cand_approximation,
                                            cand_rhs)]):
        appliers.append(make_chain_applier(
            link.root, link.approximation, link.rhs, appliers[-1],
            use_kernels=use_kernels))
    head, spliced = chain[0], appliers[-2]

    def step(u_fields, b_fields, omegas):
        return appliers[-1](b_fields, omegas, initial_guess=u_fields)

    return LoweredCycle(step=step, n_omegas=n, default_omegas=default_omegas,
                        grids=field_grids(head.root),
                        operator=_find_fine_operator(head.root),
                        expression=head.root,
                        approximation=head.approximation, rhs=head.rhs,
                        use_kernels=use_kernels, cgs_override=spliced,
                        syncs_host=_runs_cg(cand_root))


def operator_applier(op) -> Callable:
    """``apply(fields) -> fields``: the operator ``op`` on a tuple of
    fields by the generic lowering, in the fields' dtype (complex if the
    operator is); the outer Krylov solve's matrix-vector product
    (lower.py:1991-1996)."""
    lowering = _Lowering(None, None, None)

    def apply(fields):
        lowering.set_like(fields[0])
        return lowering.apply_operator(op, tuple(fields))
    return apply


@dataclass
class FineLegPlan:
    """The finest level's legs for the fused cycle loop: the up-leg of
    cycle k and the down-leg of cycle k+1 run as one pass
    (``ops/kernels/transfer.upleg_downleg_col``; lower.py:1925-1936)."""
    vals: Tuple[float, ...]          # 5-point stencil values
    p_taps: Tuple                    # (row, col) prolongation taps
    r_taps: Tuple                    # (row, col) restriction taps
    om_pre_ids: List[int]            # pre-sweep omega indices, in order
    om_post_ids: List[int]           # post-sweep omega indices, in order
    om_cgc_id: int                   # coarse-grid-correction omega index
    mult_node: object                # Multiplication(R, Residual), finest
    e_expr: object                   # the coarse solution expression


def extract_fine_leg_plan(root) -> Optional[FineLegPlan]:
    """The canonical fused V at the finest level: a red-black const5
    post-smoothing chain over a coarse-grid correction whose coarse rhs is
    a pre-smoothing chain's restricted residual, over the same stencil,
    starting from the cycle's bound approximation; else None
    (lower.py:1939-1976)."""
    plan_post = _plan_post_fusions(root).get(id(root))
    if plan_post is None or plan_post["kind"] != "const5":
        return None
    cgc = plan_post["cgc"]
    plan_super = _plan_super_fusions(root)[0].get(id(cgc.approximation))
    if plan_super is None or plan_super["vals"] != plan_post["vals"]:
        return None
    # the pre-chain starts from the bound approximation, so that the loop
    # can feed one pass's output to the next
    base_expr = plan_super["base"]
    if not isinstance(base_expr, (system.Approximation, base.Approximation)) \
            or isinstance(base_expr, (system.ZeroApproximation,
                                      base.ZeroApproximation)):
        return None
    if plan_post["taps"] is None or plan_super["taps"] is None:
        return None
    return FineLegPlan(
        vals=plan_post["vals"], p_taps=plan_post["taps"],
        r_taps=plan_super["taps"],
        om_pre_ids=[c.global_id for c in reversed(plan_super["sweeps"])],
        om_post_ids=[c.global_id for c in reversed(plan_post["sweeps"])],
        om_cgc_id=cgc.global_id, mult_node=plan_super["mult"],
        e_expr=cgc.correction.operand2)


def make_coarse_tail(lowered: LoweredCycle, plan: FineLegPlan) -> Callable:
    """``tail(rc, u_fields, b_fields, omegas) -> e``: the coarse part of
    the cycle given the restricted fine residual ``rc``, the value of the
    plan's ``Multiplication(R, Residual)`` node (lower.py:1979-1989).  It
    runs with the lowered cycle's own plans, device constants and
    kernels-or-plain choice."""
    def tail(rc, u_fields, b_fields, omegas):
        lowering = _Lowering(lowered.approximation, lowered.rhs, omegas,
                             plans=lowered.plans,
                             constants=lowered.constants,
                             use_kernels=lowered.use_kernels)
        lowering.bind(u_fields, b_fields)
        lowering.env[id(plan.mult_node)] = (rc,)
        return lowering.eval_function(plan.e_expr)[0]
    return tail
