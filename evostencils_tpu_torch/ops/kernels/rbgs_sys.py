"""Smoother kernels of an F x F coupled system of 9-point blocks
(counterpart of evostencils_tpu/ops/pallas/rbgs_sys.py
``fused_rbgs_sweep_sys``, ``jacobi_sweep_sys``,
``presmooth_residual_restrict_sys`` and ``prolong_correct_postsmooth_sys``).

The operator is a coefficient table ``coeffs[i][j][k]``: block (i, j)'s
coefficient at ``NINE_OFFSETS[k]``.  The point solve is the constant F x F
matrix ``minv``: the inverse of the center-coefficient matrix (collective
smoothing) or of its diagonal (decoupled smoothing).  ``exc`` and
``exc_minv`` are row fixups: ``(row, F x F deltas)`` pairs added to the
center coefficients and to ``minv`` on listed axis-0 rows
(rbgs_sys.py:73-93).  Linear elasticity passes none.

Each half-sweep forms every field's residual from the state before it,
``r_i = b_i - sum_j sum_k c[i][j][k] u_j(x + o_k)``, then updates
``u_i += omega * sum_j minv[i][j] r_j`` on the points of its colour: the
red half updates every field before the black half of any field starts.

Each entry point has, in this module, as in ``rbgs_var.py``:

* its wrapper: CUDA tensors launch the hand-written kernel from
  ``csrc/rbgs_sys.cu`` (float32, contiguous) or raise; CPU tensors take the
  plain version; any other device raises;
* its plain PyTorch version (``*_plain``), which repeats the TPU body's
  arithmetic in its order (the terms summed over fj, then k, zero
  coefficients skipped; the residual masked before the restriction; omega
  times the summed update);
* its count in ``launches``, which only a kernel launch increments.

The fields, right-hand sides and corrections are tuples of F tensors, as
the JAX entry points take them.  Relaxation factors stay on the device: a
sweep reads ``omegas[omega_id]``, a leg the factors ``omegas[omega_ids]``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..apply import axis_prolong_3tap, axis_restrict_3tap, red_black_masks
from . import _build
from . import transfer

#: offset order of the per-block coefficient vectors (rbgs_sys.py:46-47)
NINE_OFFSETS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1),
                (-1, -1), (-1, 1), (1, -1), (1, 1))
#: sweep gate: the JAX gate's level set (rbgs_sys.py:49, :63-70)
BLOCK_ROWS = 32
MIN_ROWS = 8
MIN_COLS = 128
#: field counts the CUDA kernels are instantiated for, and the most row
#: fixups of each kind they take; a level outside these is refused by the
#: gates on the card and runs the generic lowering
KERNEL_FIELDS = (2,)
MAX_EXC = 4
#: the leg kernels' fine tile edge: each block owns a LEG_TILE x LEG_TILE
#: tile and recomputes a halo of leg_halo() cells around it
LEG_TILE = 64
#: The block schedule of the red-black sweep kernel, csrc/rbgs_sys.cu
#: ``rbgs_sys_kernel`` (``SweepWin`` states the same window, and
#: es_sweep_sys_info reports it from the card).  A block of SWEEP_THREADS
#: threads stages u and b of every field over a window of SWEEP_WINDOW =
#: (rows, columns) cells and owns its centre, the tile: the window less
#: SWEEP_HALO cells on every side.  The red half-sweep updates the window
#: cells at a distance >= 1 from the window edge, the black one those at
#: >= 2.  At least SWEEP_BLOCKS_PER_SM blocks are resident on an SM.
SWEEP_WINDOW = (16, 64)
SWEEP_THREADS = 256
SWEEP_HALO = 2
SWEEP_BLOCKS_PER_SM = 4

#: kernel launches per kernel since the last reset_launches()
launches = {"fused_rbgs_sweep_sys": 0, "jacobi_sweep_sys": 0,
            "presmooth_residual_restrict_sys": 0,
            "prolong_correct_postsmooth_sys": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def leg_halo(leg: str, sweeps: int, red_black: bool) -> int:
    """The halo of a leg kernel's window: P = 2 * sweeps half-sweeps
    (red-black) or P = sweeps sweeps (Jacobi); pass p updates the cells at
    Chebyshev distance >= p from the window edge, so after P passes the
    cells at distance >= P are right.  The up-leg ("up") needs P, its
    prolongation being pointwise; the down-leg ("down") P + 2, its residual
    and the restriction's extra row reading one cell past the tile."""
    if leg not in ("down", "up"):
        raise ValueError(f"leg {leg!r} is neither 'down' nor 'up'")
    passes = 2 * sweeps if red_black else sweeps
    return passes + 2 if leg == "down" else passes


def sweep_tile() -> Tuple[int, int]:
    """(rows, columns) of the tile a block of the red-black sweep kernel
    owns: the window less the halo on every side."""
    rows, cols = SWEEP_WINDOW
    return rows - 2 * SWEEP_HALO, cols - 2 * SWEEP_HALO


def sweep_info(fixups: bool = False) -> dict:
    """What the card makes of the red-black sweep kernel, with row fixups
    or without: ``_build.info``'s tile, halo, threads, occupancy, spills
    and shared memory.  Needs the card."""
    return _build.info("es_sweep_sys_info", "red-black sys sweep",
                       int(fixups))


def leg_info(leg: str, sweeps: int, red_black: bool,
             fixups: bool = False) -> dict:
    """What the card makes of a leg kernel's instantiation: its halo,
    resident blocks per SM, registers and local memory (spills) per
    thread, and dynamic shared memory per block.  Needs the card."""
    info = (ctypes.c_int * 5)()
    err = _build.load_library().es_leg_sys_info(
        int(leg == "down"), int(sweeps), int(red_black), int(fixups), info)
    if err != 0:
        raise RuntimeError(f"no {leg}-leg instantiation for S = {sweeps}, "
                           f"red-black {red_black}: CUDA error {err}")
    return dict(zip(("halo", "blocks_per_sm", "registers", "local_bytes",
                     "smem_bytes"), info))


def nine_point_coeffs(stencil) -> Optional[Tuple[float, ...]]:
    """Coefficients of a constant 2D stencil in NINE_OFFSETS order, or
    None if it reaches outside the 3x3 box or is complex
    (rbgs_sys.py:52-60)."""
    entries = dict(stencil.entries)
    if set(entries) - set(NINE_OFFSETS):
        return None
    if any(isinstance(v, complex) for v in entries.values()):
        return None
    return tuple(float(entries.get(o, 0.0)) for o in NINE_OFFSETS)


def _card_takes(u, n_fields, exc, exc_minv) -> bool:
    """The CPU's plain versions take any float type, field count and
    number of fixups; the kernels float32, KERNEL_FIELDS and MAX_EXC."""
    return u.device.type == "cpu" or (
        u.dtype == torch.float32 and n_fields in KERNEL_FIELDS
        and len(exc) <= MAX_EXC and len(exc_minv) <= MAX_EXC)


def _same_fields(fields) -> bool:
    u = fields[0]
    return len(fields) >= 2 and all(
        f.shape == u.shape and f.dtype == u.dtype for f in fields)


def supports(fields, coeffs, exc=(), exc_minv=()) -> bool:
    """Whether a level runs the sweep kernels: F >= 2 equal 2D fields of
    more than 32 rows and at least 128 columns with a coefficient table
    (rbgs_sys.py:63-70); on a CUDA device float32, an F of KERNEL_FIELDS
    and at most MAX_EXC fixups of each kind."""
    u = fields[0]
    if not (coeffs is not None and _same_fields(fields) and u.ndim == 2
            and u.shape[0] >= MIN_ROWS and u.shape[1] >= MIN_COLS
            and u.shape[0] > BLOCK_ROWS):
        return False
    _build.refuse_bf16(u, "row 14 (fused_rbgs_sweep_sys, jacobi_sweep_sys)",
                       "rbgs_sys.py:68")
    return _card_takes(u, len(fields), exc, exc_minv)


def leg_supports(fields, exc=(), exc_minv=()) -> bool:
    """Whether a level runs the leg kernels: the level set of
    ``transfer.supports`` on the first field (lower.py:1149-1152,
    :1190-1193) and F >= 2 fields of one shape and dtype; on a CUDA device
    as :func:`supports`."""
    u = fields[0]
    return (_same_fields(fields) and transfer.supports(
        u, "rows 15-16 (presmooth_residual_restrict_sys, "
           "prolong_correct_postsmooth_sys)")
        and _card_takes(u, len(fields), exc, exc_minv))


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _shifts(u):
    """u(x + o) for o in NINE_OFFSETS, zero outside the grid."""
    n, m = u.shape
    p = F.pad(u, (1, 1, 1, 1))
    return [p[1 + dr:1 + dr + n, 1 + dc:1 + dc + m]
            for dr, dc in NINE_OFFSETS]


def _row_terms(acc, fi, vs, fixups):
    """Add row ``fi`` of each fixup's F x F deltas times ``vs`` on its
    axis-0 row (rbgs_sys.py:73-93)."""
    for row, dmat in fixups:
        on_row = (torch.arange(vs[0].shape[0], device=vs[0].device)
                  == row)[:, None]
        for fj, v in enumerate(vs):
            d = dmat[fi][fj]
            if d != 0.0:
                term = torch.where(on_row, d * v, 0.0)
                acc = term if acc is None else acc + term
    return acc


def _residuals(us, bs, coeffs, exc):
    """``b_i - A_i u`` of every field (rbgs_sys.py:279-299)."""
    sh = [_shifts(u) for u in us]
    rs = []
    for fi in range(len(us)):
        au = None
        for fj in range(len(us)):
            for k in range(9):
                c = coeffs[fi][fj][k]
                if c == 0.0:
                    continue
                term = c * sh[fj][k]
                au = term if au is None else au + term
        au = _row_terms(au, fi, us, exc)
        rs.append(bs[fi] - (au if au is not None else 0.0))
    return rs


def _half_sweep(us, bs, omega, coeffs, minv, mask, exc, exc_minv):
    """``u_i + omega * sum_j minv[i][j] r_j`` on ``mask`` (every point when
    None) (rbgs_sys.py:302-323)."""
    rs = _residuals(us, bs, coeffs, exc)
    out = []
    for fi in range(len(us)):
        upd = None
        for fj in range(len(us)):
            if minv[fi][fj] == 0.0:
                continue
            term = minv[fi][fj] * rs[fj]
            upd = term if upd is None else upd + term
        upd = _row_terms(upd, fi, rs, exc_minv)
        upd = omega * upd if upd is not None else torch.zeros_like(us[fi])
        out.append(us[fi] + (upd if mask is None
                             else torch.where(mask, upd, 0.0)))
    return out


def _sweeps(us, bs, omegas, omega_ids, coeffs, minv, red_black, exc,
            exc_minv):
    masks = red_black_masks(tuple(us[0].shape), device=us[0].device,
                            dtype=torch.bool) if red_black else (None,)
    us = list(us)
    for i in omega_ids:
        for mask in masks:
            us = _half_sweep(us, bs, omegas[i], coeffs, minv, mask, exc,
                             exc_minv)
    return us


def fused_rbgs_sweep_sys_plain(fields, b_fields, omegas, omega_id, coeffs,
                               minv, exc=(), exc_minv=()):
    """Plain version of :func:`fused_rbgs_sweep_sys` (_fused_sys_kernel,
    rbgs_sys.py:96-177, two half-sweeps)."""
    return tuple(_sweeps(fields, b_fields, omegas, (omega_id,), coeffs,
                         minv, True, exc, exc_minv))


def jacobi_sweep_sys_plain(fields, b_fields, omegas, omega_id, coeffs, minv,
                           exc=(), exc_minv=()):
    """Plain version of :func:`jacobi_sweep_sys` (one half-sweep on every
    point)."""
    return tuple(_sweeps(fields, b_fields, omegas, (omega_id,), coeffs,
                         minv, False, exc, exc_minv))


def presmooth_residual_restrict_sys_plain(fields, b_fields, omegas,
                                          omega_ids, coeffs, minv, taps,
                                          red_black=True, exc=(),
                                          exc_minv=()):
    """Plain version of :func:`presmooth_residual_restrict_sys`: the
    sweeps, the residuals, and each residual's row taps then column taps
    (rbgs_sys.py:326-354)."""
    us = _sweeps(fields, b_fields, omegas, omega_ids, coeffs, minv,
                 red_black, exc, exc_minv)
    rs = _residuals(us, b_fields, coeffs, exc)
    return tuple(us), tuple(
        axis_restrict_3tap(axis_restrict_3tap(r, 0, taps[0]), 1, taps[1])
        for r in rs)


def prolong_correct_postsmooth_sys_plain(fields, e_fields, b_fields, omegas,
                                         omega_ids, coeffs, minv, taps,
                                         red_black=True, exc=(),
                                         exc_minv=()):
    """Plain version of :func:`prolong_correct_postsmooth_sys`: each e cast
    to u's dtype, its column expansion, then its row expansion and the
    correction, then the sweeps (rbgs_sys.py:414-456, :508)."""
    n, m = fields[0].shape
    om0 = omegas[omega_ids[0]]
    us = [u + om0 * axis_prolong_3tap(axis_prolong_3tap(
              e.to(u.dtype), 1, taps[1], m), 0, taps[0], n)
          for u, e in zip(fields, e_fields)]
    return tuple(_sweeps(us, b_fields, omegas, omega_ids[1:], coeffs, minv,
                         red_black, exc, exc_minv))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_table(n_fields, coeffs, minv, exc, exc_minv):
    if len(coeffs) != n_fields or any(
            len(row) != n_fields or any(len(c) != 9 for c in row)
            for row in coeffs):
        raise ValueError(f"coefficient table is not {n_fields}x{n_fields}x9")
    for mat in [minv] + [d for _, d in tuple(exc) + tuple(exc_minv)]:
        if len(mat) != n_fields or any(len(r) != n_fields for r in mat):
            raise ValueError(f"point-solve matrix or fixup is not "
                             f"{n_fields}x{n_fields}")


def _check_fields(fields, b_fields, others):
    fields, b_fields = tuple(fields), tuple(b_fields)
    if len(fields) < 2 or len(b_fields) != len(fields):
        raise ValueError(f"{len(fields)} fields and {len(b_fields)} "
                         "right-hand sides; a system takes F >= 2 of each")
    u = fields[0]
    if any(t.device != u.device for t in fields + b_fields + tuple(others)):
        raise ValueError("system tensors lie on different devices")
    if u.ndim != 2 or any(t.shape != u.shape for t in fields + b_fields):
        raise ValueError("the fields and right-hand sides must be equal "
                         "2D shapes")
    return fields, b_fields


def _table(coeffs, minv):
    vals = [float(c) for row in coeffs for entry in row for c in entry] + \
        [float(v) for row in minv for v in row]
    return (ctypes.c_double * len(vals))(*vals)


def _fixups(exc, exc_minv):
    """(row array, delta array) of the center fixups, then the point-solve
    fixups."""
    pairs = tuple(exc) + tuple(exc_minv)
    rows = [int(r) for r, _ in pairs]
    vals = [float(v) for _, d in pairs for row in d for v in row]
    return ((ctypes.c_int * max(len(rows), 1))(*rows),
            (ctypes.c_double * max(len(vals), 1))(*vals))


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _system_args(fields, coeffs, minv, exc, exc_minv):
    """The arguments every entry point takes after its tensors: F, the
    table, the fixup counts and arrays."""
    rows, vals = _fixups(exc, exc_minv)
    return (len(fields), _table(coeffs, minv), len(exc), len(exc_minv), rows,
            vals)


def _sweep(name, fields, b_fields, omegas, omega_id, coeffs, minv, exc,
           exc_minv, red_black):
    fields, b_fields = _check_fields(fields, b_fields, (omegas,))
    _check_table(len(fields), coeffs, minv, exc, exc_minv)
    if omegas.ndim != 1:
        raise ValueError("omegas must be a 1-D relaxation-factor vector")
    if not 0 <= int(omega_id) < omegas.shape[0]:
        raise IndexError(f"omega id {omega_id} outside a vector of "
                         f"{omegas.shape[0]}")
    if not _build.on_card(fields[0]):
        plain = fused_rbgs_sweep_sys_plain if red_black \
            else jacobi_sweep_sys_plain
        return plain(fields, b_fields, omegas, int(omega_id), coeffs, minv,
                     exc, exc_minv)
    _build.check_card_tensors(*fields, *b_fields, omegas)
    out = tuple(torch.empty_like(u) for u in fields)
    n, m = fields[0].shape
    _build.launch(launches, name, "es_sweep_sys", fields[0].device,
                  _ptrs(fields), _ptrs(b_fields), _ptrs(out),
                  *_system_args(fields, coeffs, minv, exc, exc_minv),
                  omegas.data_ptr(), int(omega_id), int(red_black), n, m)
    return out


def fused_rbgs_sweep_sys(fields, b_fields, omegas: torch.Tensor,
                         omega_id: int, coeffs, minv, exc=(), exc_minv=()):
    """One coupled red-black sweep in one pass: the red half-sweep of every
    field, then the black one with the new red values."""
    return _sweep("fused_rbgs_sweep_sys", fields, b_fields, omegas,
                  omega_id, coeffs, minv, exc, exc_minv, True)


def jacobi_sweep_sys(fields, b_fields, omegas: torch.Tensor, omega_id: int,
                     coeffs, minv, exc=(), exc_minv=()):
    """One coupled damped Jacobi sweep: every point of every field from the
    old values."""
    return _sweep("jacobi_sweep_sys", fields, b_fields, omegas, omega_id,
                  coeffs, minv, exc, exc_minv, False)


def _check_leg(fields, b_fields, omegas, omega_ids, n_sweeps, coeffs, minv,
               exc, exc_minv, extra=()):
    fields, b_fields = _check_fields(fields, b_fields, extra)
    _check_table(len(fields), coeffs, minv, exc, exc_minv)
    ids = transfer._check_leg(fields[0], b_fields[0], omegas, omega_ids,
                              n_sweeps)
    return fields, b_fields, ids


def _taps(taps):
    vals = [float(t) for axis in taps for t in axis]
    if len(vals) != 6:
        raise ValueError("need 3 taps per axis")
    return (ctypes.c_double * 6)(*vals)


def presmooth_residual_restrict_sys(fields, b_fields, omegas: torch.Tensor,
                                    omega_ids: Sequence[int], coeffs, minv,
                                    taps, red_black: bool = True, exc=(),
                                    exc_minv=()):
    """Down-leg: ``len(omega_ids)`` coupled red-black (or, with
    ``red_black`` False, Jacobi) sweeps with factors ``omegas[omega_ids[k]]``
    in the order the sweeps run; then every field's residual and its full
    restriction with the (row, column) 3-tap pair ``taps``.  Returns
    ``(F smoothed fields (n, m), F coarse residuals ((n-1)/2, (m-1)/2))``."""
    fields, b_fields, ids = _check_leg(fields, b_fields, omegas, omega_ids,
                                       len(omega_ids), coeffs, minv, exc,
                                       exc_minv)
    if not _build.on_card(fields[0]):
        return presmooth_residual_restrict_sys_plain(
            fields, b_fields, omegas, ids, coeffs, minv, taps, red_black,
            exc, exc_minv)
    _build.check_card_tensors(*fields, *b_fields, omegas)
    n, m = fields[0].shape
    u_out = tuple(torch.empty_like(u) for u in fields)
    rc = tuple(u.new_empty(((n - 1) // 2, (m - 1) // 2)) for u in fields)
    _build.launch(launches, "presmooth_residual_restrict_sys",
                  "es_presmooth_residual_restrict_sys", fields[0].device,
                  _ptrs(fields), _ptrs(b_fields), _ptrs(u_out), _ptrs(rc),
                  *_system_args(fields, coeffs, minv, exc, exc_minv),
                  omegas.data_ptr(), (ctypes.c_int * len(ids))(*ids),
                  len(ids), int(red_black), _taps(taps),
                  leg_halo("down", len(ids), red_black), n, m)
    return u_out, rc


def prolong_correct_postsmooth_sys(fields, e_fields, b_fields,
                                   omegas: torch.Tensor,
                                   omega_ids: Sequence[int], coeffs, minv,
                                   taps, red_black: bool = True, exc=(),
                                   exc_minv=()):
    """Up-leg: ``u_i + omegas[omega_ids[0]] * P(e_i)`` with the full 1:2
    prolongation of each coarse correction ((n-1)/2, (m-1)/2), cast to u's
    dtype, by the (row, column) 3-tap pair ``taps``; then
    ``len(omega_ids) - 1`` coupled red-black (or Jacobi) sweeps with
    factors ``omegas[omega_ids[1:]]``."""
    e_fields = tuple(e_fields)
    fields, b_fields, ids = _check_leg(fields, b_fields, omegas, omega_ids,
                                       len(omega_ids) - 1, coeffs, minv, exc,
                                       exc_minv, e_fields)
    n, m = fields[0].shape
    if len(e_fields) != len(fields) or any(
            tuple(e.shape) != ((n - 1) // 2, (m - 1) // 2) for e in e_fields):
        raise ValueError(f"coarse corrections {[tuple(e.shape) for e in e_fields]}"
                         f" do not match {len(fields)} fields of {n}x{m}")
    if not _build.on_card(fields[0]):
        return prolong_correct_postsmooth_sys_plain(
            fields, e_fields, b_fields, omegas, ids, coeffs, minv, taps,
            red_black, exc, exc_minv)
    e_fields = tuple(e.to(fields[0].dtype).contiguous() for e in e_fields)
    _build.check_card_tensors(*fields, *e_fields, *b_fields, omegas)
    u_out = tuple(torch.empty_like(u) for u in fields)
    _build.launch(launches, "prolong_correct_postsmooth_sys",
                  "es_prolong_correct_postsmooth_sys", fields[0].device,
                  _ptrs(fields), _ptrs(e_fields), _ptrs(b_fields),
                  _ptrs(u_out),
                  *_system_args(fields, coeffs, minv, exc, exc_minv),
                  omegas.data_ptr(), (ctypes.c_int * len(ids))(*ids),
                  len(ids) - 1, int(red_black), _taps(taps),
                  leg_halo("up", len(ids) - 1, red_black), n, m)
    return u_out
