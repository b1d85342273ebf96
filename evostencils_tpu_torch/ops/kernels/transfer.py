"""The V-cycle's fused leg kernels and the two standalone transfer
kernels (counterpart of evostencils_tpu/ops/pallas/transfer.py
``presmooth_residual_restrict``, ``prolong_correct_postsmooth_col``,
``upleg_downleg_col``, their row-only forms
``presmooth_residual_rowrestrict``, ``prolong_correct_postsmooth`` and
``upleg_downleg_fused``, and ``residual_rowrestrict`` and
``prolong_row_correct``).

The legs carry both transfer axes.  Their row-only forms restrict the
residual along rows only, to ``rr ((n-1)/2, m)``, or take a correction
prolonged along columns already, ``c_half ((n-1)/2, m)``; the lowering
runs the column half in plain torch (``config.fused_column_transfers``
off).  The fused passes ``upleg_downleg_col`` and ``upleg_downleg_fused``
run the up-leg of cycle k and the down-leg of cycle k+1 in one pass over
u and b (``compiler/solve.make_cycle_loop`` with ``config.loop_fusion``).

The TPU splits the standalone transfers into a row half (Pallas) and a
column half (XLA, ``lower._col_restrict`` / ``_col_prolong``), because
Mosaic cannot stride the lane axis.  Here each is one kernel over both
axes: ``residual_restrict`` is r = b - A u with its full restriction (the
down-leg's windowed kernel with no sweep), and ``prolong_correct`` is
u + omega * P(e) with the full prolongation (the up-leg's windowed kernel
with no sweep).

Each kernel has, in this module:

* its wrapper: a CUDA tensor launches the hand-written kernel from
  ``csrc/transfer.cu`` (float32, contiguous) or raises; a CPU tensor takes
  the plain version; any other device raises;
* bfloat16 storage: the legs with both transfer axes
  (``presmooth_residual_restrict``, ``prolong_correct_postsmooth_col``)
  take bf16 u, b and e with float32 ``omegas`` on both devices and compute
  in float32, rounding each output once, as the TPU kernels do
  (transfer.py:774-779, :876-879); their launches count under the name
  with ``_bf16``.  Every other kernel here has no bf16 form, and
  :func:`supports` raises for a bf16 field at its gate;
* its plain PyTorch version (``*_plain``), built from ``ops.apply``: two
  masked half-sweeps per sweep, the residual, the 3-tap transfers.  The CPU
  tests use it, and ``chip_smoke.py`` compares the kernel with it;
* its entry in ``launches``, which only a kernel launch increments.

Relaxation factors stay on the device: a leg takes the whole
relaxation-factor vector ``omegas`` and the indices ``omega_ids`` of the
factors it applies, so one launch serves every factor assignment and never
waits on the host.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from ...stencils.constant import Stencil
import torch.nn.functional as F

from ..apply import (apply_constant, axis_prolong_3tap, axis_restrict_3tap,
                     red_black_masks)
from . import _build

MAX_SWEEPS = 3
#: sweeps of a fused pass: the post-sweeps of one cycle and the pre-sweeps
#: of the next
MAX_FUSED_SWEEPS = 2 * MAX_SWEEPS
#: kernel gate: the JAX gate's level set (transfer.py:590-595)
MIN_ROWS = 129
MIN_COLS = 128

#: The block schedule of the windowed kernels, csrc/transfer.cu
#: ``col_leg_kernel<F, S, K>`` in six forms: the legs with both transfer
#: axes (``presmooth_residual_restrict``, ``prolong_correct_postsmooth_col``),
#: the row-only legs (``presmooth_residual_rowrestrict``,
#: ``prolong_correct_postsmooth``) and the fused passes
#: (``upleg_downleg_col``, ``upleg_downleg_fused``); the standalone
#: ``residual_restrict`` is the down-leg with S = 0 and the standalone
#: ``prolong_correct`` the up-leg with S = 0; ``LegWindow<K>``
#: states the same classes, and es_transfer_leg_info reports them from the
#: card.  A block stages u and b over a window of WINDOWS[k] = (rows,
#: columns, threads) cells and owns its centre, the tile: the window less
#: leg_halo() cells on every side.  Pass p (of 2S half-sweeps) updates the
#: window cells at a distance >= p from the window edge.  At least
#: LEG_BLOCKS_PER_SM[k] blocks of a class are resident on an SM: its
#: __launch_bounds__ ask for them, and at the registers they allow its
#: shared memory (class 0) or registers (class 1) allow no more; the
#: row-only up-leg and pass, which stage c_half's rows as well, fit
#: ROWPASS_BLOCKS_PER_SM[k] (leg_blocks).  A class is built for a leg only
#: where its tile keeps at least the halo's depth of rows (leg_windows).  A
#: level takes the first built class whose tiles fill one wave of those on
#: the card's SMs, else the last built one.  The legs and passes have the
#: classes of LEG_WINDOWS; WINDOWS adds the standalone
#: prolongation-correction's own.
LEG_WINDOWS = ((64, 64, 256), (32, 64, 256))
WINDOWS = LEG_WINDOWS + ((16, 64, 256),)
#: the one class of the standalone residual restriction, the down-leg of
#: no sweep (``RR_WINDOW`` in csrc/transfer.cu): with halo 2 and no pass,
#: 32 x 64 beats 64 x 64 at every level from 4095^2 down on an H100
RR_WINDOW = 1
#: the one class of the standalone prolongation-correction, the up-leg of
#: no sweep (``PC_WINDOW`` in csrc/transfer.cu), which nothing else takes:
#: halo 0, so its tile is the 16 x 64 window, and it stages u's window and
#: e's coarse window, no b; on an H100 it beats 32 x 64 at 511^2 and 255^2,
#: where few blocks run and each one's latency sets the time
PC_WINDOW = 2
LEG_BLOCKS_PER_SM = (5, 6, 8)
ROWPASS_BLOCKS_PER_SM = (4, 6)
#: the windowed kernels, numbered as es_transfer_leg_info takes them: the
#: legs, the fused pass with both transfer axes and the row-only one, the
#: row-only legs
_FORMS = {"up": 0, "down": 1, "pass": 2, "rowpass": 3, "rowdown": 4,
          "rowup": 5}
#: the forms that stage c_half's rows, and the up-legs (halo P)
_STAGES_HALF = ("rowpass", "rowup")
_UP_LEGS = ("up", "rowup")

#: kernel launches per kernel since the last reset_launches()
launches = {"presmooth_residual_restrict": 0,
            "prolong_correct_postsmooth_col": 0,
            "upleg_downleg_col": 0,
            "presmooth_residual_rowrestrict": 0,
            "prolong_correct_postsmooth": 0,
            "upleg_downleg_fused": 0,
            "residual_restrict": 0, "prolong_correct": 0,
            "presmooth_residual_restrict_bf16": 0,
            "prolong_correct_postsmooth_col_bf16": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def leg_halo(leg: str, sweeps: int) -> int:
    """The halo of a windowed kernel's window (``leg`` "down", "up",
    their row-only forms "rowdown", "rowup", or "pass" or "rowpass", the
    fused pass in its two forms): P = 2 * sweeps half-sweeps, pass p
    updating the cells at a distance >= p from the window edge, so after P
    passes the cells at distance >= P are right.  The up-legs need P, their
    prolongation being pointwise; the down-legs and the passes P + 2, their
    residual and the restriction's extra row reading one cell past the
    tile.  The standalone residual restriction is "down" with no sweep:
    halo 2; the standalone prolongation-correction "up" with no sweep:
    halo 0."""
    if leg not in _FORMS:
        raise ValueError(f"leg {leg!r} is none of {sorted(_FORMS)}")
    return 2 * sweeps + (0 if leg in _UP_LEGS else 2)


def leg_tile(leg: str, sweeps: int, window: int) -> Tuple[int, int]:
    """(rows, columns) of the tile a block of window class ``window``
    owns: the window less the leg's halo on every side."""
    rows, cols, _ = WINDOWS[window]
    halo = leg_halo(leg, sweeps)
    return rows - 2 * halo, cols - 2 * halo


def leg_windows(leg: str, sweeps: int) -> Tuple[int, ...]:
    """The window classes built for a leg of ``sweeps`` sweeps: those whose
    tile keeps at least the halo's depth of rows, so that no block
    recomputes more than twice the rows it owns.  Every class serves the
    legs; the 32 x 64 class serves passes of up to 4 sweeps.  The down-leg
    of no sweep, the standalone residual restriction, has RR_WINDOW
    alone, and the up-leg of no sweep, the standalone
    prolongation-correction, PC_WINDOW alone."""
    if not sweeps:
        return {"down": (RR_WINDOW,), "up": (PC_WINDOW,)}.get(leg, ())
    return tuple(k for k in range(len(LEG_WINDOWS))
                 if leg_tile(leg, sweeps, k)[0] >= leg_halo(leg, sweeps))


def leg_blocks(leg: str, window: int) -> int:
    """Resident blocks per SM of a leg's instantiation in class
    ``window``: fewer where it stages c_half's rows as well."""
    table = ROWPASS_BLOCKS_PER_SM if leg in _STAGES_HALF else \
        LEG_BLOCKS_PER_SM
    return table[window]


@functools.cache
def leg_window(leg: str, sweeps: int, n: int, m: int, sms: int) -> int:
    """The window class of a leg or pass on an (n, m) grid, on a card of
    ``sms`` streaming multiprocessors: the first built class whose tiles
    fill one wave of resident blocks (sms * leg_blocks(leg, k)), else the
    last built one.  On the H100's 132, 4095^2 and 2047^2 take class 0,
    the levels from 1023^2 down class 1 (a pass of 5 or 6 sweeps, class 0
    everywhere)."""
    built = leg_windows(leg, sweeps)
    for window in built:
        tr, tc = leg_tile(leg, sweeps, window)
        if -(-n // tr) * -(-m // tc) >= sms * leg_blocks(leg, window):
            return window
    return built[-1]


def leg_info(leg: str, sweeps: int, window: int,
             dtype: torch.dtype = torch.float32) -> dict:
    """What the card makes of a windowed kernel's instantiation (``leg``
    one of ``_FORMS``, ``sweeps``, window class ``window``, storage
    ``dtype``: float32, or bfloat16 for "down" and "up"):
    ``_build.info``'s tile, halo, threads, occupancy, spills and shared
    memory.  Needs the card."""
    entry = "es_transfer_leg_info" + (
        "_bf16" if dtype == torch.bfloat16 else "")
    return _build.info(entry, f"{leg} for S = {sweeps}, window {window}, "
                       f"{dtype}", _FORMS[leg], int(sweeps), int(window))


def three_tap(vectors, radii) -> Optional[Tuple[Tuple[float, ...], ...]]:
    """Per-axis (w[-1], w[0], w[+1]) taps of a separable transfer stencil
    with radius 1 per axis, else None (transfer.py:43-53)."""
    taps = []
    for v, r in zip(vectors, radii):
        if r != 1 or len(v) != 3:
            return None
        if any(isinstance(x, complex) for x in v):
            return None
        taps.append(tuple(float(x) for x in v))
    return tuple(taps)


#: The rows of the port's kernel table that take bfloat16 storage: the
#: legs with both transfer axes.  The other kernels behind
#: :func:`supports` name their rows to it.
LEG_ROWS = ("rows 1-2 (presmooth_residual_restrict, "
            "prolong_correct_postsmooth_col)")


def supports(u: torch.Tensor,
             rows: str = "a windowed 2D kernel with no bf16 form") -> bool:
    """Whether a level runs a windowed 2D kernel: a 2D grid with at least
    129 rows and 128 columns, odd on both axes, and float32 when it lies on
    a CUDA device (the plain versions on the CPU take any float type).  A
    complex field takes the generic lowering on every device, as under the
    JAX gate (transfer.py:590-595).  bfloat16, which the JAX gate admits
    for every kernel, runs the kernel of ``rows`` only where that is
    LEG_ROWS, on every device; at any other kernel (by default) it raises
    NotImplementedError naming ``rows``."""
    if u.ndim != 2 or u.is_complex():
        return False
    n, m = u.shape
    if n < MIN_ROWS or m < MIN_COLS or n % 2 == 0 or m % 2 == 0:
        return False
    if rows != LEG_ROWS:
        _build.refuse_bf16(u, rows, "transfer.py:590")
    return u.device.type == "cpu" or u.dtype in (torch.float32,
                                                  torch.bfloat16)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _five_point(stencil_vals) -> Stencil:
    c, up, dn, lf, rt = (float(v) for v in stencil_vals)
    return Stencil([((0, 0), c), ((-1, 0), up), ((1, 0), dn),
                    ((0, -1), lf), ((0, 1), rt)])


def _rb_sweeps_plain(u, b, omegas, omega_ids, A, dinv):
    """Red-black sweeps as two masked half-sweeps each, with a fresh
    residual per half (compiler/lower.py:1403-1419)."""
    red, black = red_black_masks(tuple(u.shape), device=u.device,
                                 dtype=u.dtype)
    for i in omega_ids:
        om = omegas[i]
        for mask in (red, black):
            r = b - apply_constant(A, u)
            u = u + om * mask * (dinv * r)
    return u


def _widened(*tensors):
    """The operands of a leg in its compute type: bfloat16 storage widened
    to float32, as the TPU kernels compute (transfer.py:774-779,
    :876-879: storage loads ``.astype(jnp.float32)``, float32 scalars);
    any other dtype as it is."""
    return tuple(t.float() if t.dtype == torch.bfloat16 else t
                 for t in tensors)


def presmooth_residual_restrict_plain(u, b, omegas, omega_ids, stencil_vals,
                                      taps):
    """Plain version of :func:`presmooth_residual_restrict`; bf16 storage
    computes in float32 and rounds each output once."""
    store = u.dtype
    u, b, omegas = _widened(u, b, omegas)
    A = _five_point(stencil_vals)
    u = _rb_sweeps_plain(u, b, omegas, omega_ids, A, 1.0 / stencil_vals[0])
    r = b - apply_constant(A, u)
    rc = axis_restrict_3tap(axis_restrict_3tap(r, 0, taps[0]), 1, taps[1])
    return u.to(store), rc.to(store)


def prolong_correct_postsmooth_col_plain(u, e, b, omegas, omega_ids,
                                         stencil_vals, taps):
    """Plain version of :func:`prolong_correct_postsmooth_col`; bf16
    storage computes in float32 and rounds the output once."""
    store = u.dtype
    u, e, b, omegas = _widened(u, e, b, omegas)
    n, m = u.shape
    p = axis_prolong_3tap(axis_prolong_3tap(e, 0, taps[0], n), 1, taps[1], m)
    u = u + omegas[omega_ids[0]] * p
    return _rb_sweeps_plain(u, b, omegas, omega_ids[1:],
                            _five_point(stencil_vals),
                            1.0 / stencil_vals[0]).to(store)


def upleg_downleg_col_plain(u, e, b, omegas, omega_ids, stencil_vals,
                            p_taps, r_taps):
    """Plain version of :func:`upleg_downleg_col`: the up-leg with every
    sweep, then the down-leg's residual and restriction."""
    u = prolong_correct_postsmooth_col_plain(u, e, b, omegas, omega_ids,
                                             stencil_vals, p_taps)
    return presmooth_residual_restrict_plain(u, b, omegas, (), stencil_vals,
                                             r_taps)


def presmooth_residual_rowrestrict_plain(u, b, omegas, omega_ids,
                                         stencil_vals, row_taps):
    """Plain version of :func:`presmooth_residual_rowrestrict`."""
    A = _five_point(stencil_vals)
    u = _rb_sweeps_plain(u, b, omegas, omega_ids, A, 1.0 / stencil_vals[0])
    return u, axis_restrict_3tap(b - apply_constant(A, u), 0, row_taps)


def prolong_correct_postsmooth_plain(u, c_half, b, omegas, omega_ids,
                                     stencil_vals, row_taps):
    """Plain version of :func:`prolong_correct_postsmooth`."""
    p = axis_prolong_3tap(c_half, 0, row_taps, u.shape[0])
    u = u + omegas[omega_ids[0]] * p
    return _rb_sweeps_plain(u, b, omegas, omega_ids[1:],
                            _five_point(stencil_vals), 1.0 / stencil_vals[0])


def upleg_downleg_fused_plain(u, c_half, b, omegas, omega_ids, stencil_vals,
                              p_row_taps, r_row_taps):
    """Plain version of :func:`upleg_downleg_fused`."""
    u = prolong_correct_postsmooth_plain(u, c_half, b, omegas, omega_ids,
                                         stencil_vals, p_row_taps)
    return presmooth_residual_rowrestrict_plain(u, b, omegas, (),
                                                stencil_vals, r_row_taps)


def residual_restrict_plain(u, b, stencil_vals, taps):
    """Plain version of :func:`residual_restrict`: the residual summed in
    the order of ``_rr_kernel`` (transfer.py:86-88), then the row taps and
    the column taps, as lower.py:1338-1340 composes them."""
    c, up, dn, lf, rt = (float(v) for v in stencil_vals)
    p = F.pad(u, (1, 1, 1, 1))
    au = (c * u + up * p[:-2, 1:-1] + dn * p[2:, 1:-1] + lf * p[1:-1, :-2]
          + rt * p[1:-1, 2:])
    return axis_restrict_3tap(axis_restrict_3tap(b - au, 0, taps[0]), 1,
                              taps[1])


def prolong_correct_plain(u, e, omegas, omega_id, taps):
    """Plain version of :func:`prolong_correct`: the column prolongation,
    then the row prolongation and the correction, as lower.py:1373-1376
    composes them."""
    n, m = u.shape
    p = axis_prolong_3tap(axis_prolong_3tap(e, 1, taps[1], m), 0, taps[0], n)
    return u + omegas[omega_id] * p


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _window_args(leg, sweeps, u):
    """(halo, window class, n, m): the last arguments before the stream of
    a windowed kernel's entry, for ``leg`` of ``sweeps`` sweeps over
    ``u``."""
    n, m = u.shape
    return (leg_halo(leg, sweeps),
            leg_window(leg, sweeps, n, m, _build.sms(u.device)), n, m)


def _check_leg(u, b, omegas, omega_ids, n_sweeps, extra=(),
               max_sweeps=MAX_SWEEPS):
    """Shape and index checks shared by both devices; returns the ids."""
    tensors = (u, b, omegas) + tuple(extra)
    if any(t.device != u.device for t in tensors):
        raise ValueError("leg tensors lie on different devices")
    if u.ndim != 2 or b.shape != u.shape:
        raise ValueError(f"u {tuple(u.shape)} and b {tuple(b.shape)} must be "
                         "equal 2D shapes")
    n, m = u.shape
    if n < 3 or m < 3 or n % 2 == 0 or m % 2 == 0:
        raise ValueError(f"grid {n}x{m} must be odd on both axes")
    if not 1 <= n_sweeps <= max_sweeps:
        raise ValueError(f"{n_sweeps} sweeps; this leg takes 1..{max_sweeps}")
    if omegas.ndim != 1:
        raise ValueError("omegas must be a 1-D relaxation-factor vector")
    ids = tuple(int(i) for i in omega_ids)
    if any(not 0 <= i < omegas.shape[0] for i in ids):
        raise IndexError(f"omega ids {ids} outside a vector of "
                         f"{omegas.shape[0]}")
    return ids


#: the column taps a row-only kernel is given and does not read
_NO_TAPS = (0.0, 0.0, 0.0)


def _coefficients(stencil_vals, *tap_pairs):
    """5 stencil values, then each (row, column) 3-tap pair."""
    vals = [float(v) for v in stencil_vals] + \
        [float(t) for taps in tap_pairs for axis in taps for t in axis]
    if len(vals) != 5 + 6 * len(tap_pairs) or \
            any(len(taps) != 2 for taps in tap_pairs):
        raise ValueError("need 5 stencil values and 3 taps per axis")
    return (ctypes.c_double * len(vals))(*vals)


def _check_coarse(u, c, rows_only):
    """The coarse operand's shape: ((n-1)/2, m) for a row-only leg, else
    ((n-1)/2, (m-1)/2)."""
    n, m = u.shape
    want = ((n - 1) // 2, m if rows_only else (m - 1) // 2)
    if tuple(c.shape) != want:
        raise ValueError(f"coarse operand {tuple(c.shape)} does not match "
                         f"the grid {n}x{m}; expected {want}")


def _leg_storage(u, *fields):
    """Check the card tensors of a leg with both transfer axes: ``u`` and
    ``fields`` contiguous, all float32 or all bfloat16.  Returns the C
    entry's suffix of that storage type ("" or "_bf16")."""
    bf16 = u.dtype == torch.bfloat16
    _build.check_card_tensors(u, *fields,
                              dtype=torch.bfloat16 if bf16 else torch.float32)
    return "_bf16" if bf16 else ""


def presmooth_residual_restrict(u: torch.Tensor, b: torch.Tensor,
                                omegas: torch.Tensor,
                                omega_ids: Sequence[int], stencil_vals,
                                taps):
    """Down-leg: ``len(omega_ids)`` damped red-black sweeps of the constant
    5-point operator ``stencil_vals`` = (center, up, down, left, right),
    with factors ``omegas[omega_ids[k]]`` in the order the sweeps run; then
    ``r = b - A u`` and its full restriction with the (row, column) 3-tap
    pair ``taps``.  Returns ``(u_s (n, m), rc ((n-1)/2, (m-1)/2))``."""
    ids = _check_leg(u, b, omegas, omega_ids, len(omega_ids))
    if not _build.on_card(u):
        return presmooth_residual_restrict_plain(u, b, omegas, ids,
                                                 stencil_vals, taps)
    suffix = _leg_storage(u, b)
    _build.check_card_tensors(omegas)
    n, m = u.shape
    u_out = torch.empty_like(u)
    rc = u.new_empty(((n - 1) // 2, (m - 1) // 2))
    # the float32 entry also serves the row-only form (cols 0)
    cols = () if suffix else (1,)
    _build.launch(launches, "presmooth_residual_restrict" + suffix,
                  "es_presmooth_residual_restrict" + suffix, u.device,
                  u.data_ptr(), b.data_ptr(), omegas.data_ptr(),
                  (ctypes.c_int * len(ids))(*ids), len(ids),
                  _coefficients(stencil_vals, taps), u_out.data_ptr(),
                  rc.data_ptr(), *cols, *_window_args("down", len(ids), u))
    return u_out, rc


def prolong_correct_postsmooth_col(u: torch.Tensor, e: torch.Tensor,
                                   b: torch.Tensor, omegas: torch.Tensor,
                                   omega_ids: Sequence[int], stencil_vals,
                                   taps):
    """Up-leg: ``u + omegas[omega_ids[0]] * P(e)`` with the full 1:2
    prolongation of the coarse correction ``e`` ((n-1)/2, (m-1)/2) by the
    (row, column) 3-tap pair ``taps``, then ``len(omega_ids) - 1``
    red-black sweeps with factors ``omegas[omega_ids[1:]]``."""
    ids = _check_leg(u, b, omegas, omega_ids, len(omega_ids) - 1, (e,))
    _check_coarse(u, e, rows_only=False)
    if not _build.on_card(u):
        return prolong_correct_postsmooth_col_plain(u, e, b, omegas, ids,
                                                    stencil_vals, taps)
    suffix = _leg_storage(u, e, b)
    _build.check_card_tensors(omegas)
    u_out = torch.empty_like(u)
    sweeps = len(ids) - 1
    cols = () if suffix else (1,)
    _build.launch(launches, "prolong_correct_postsmooth_col" + suffix,
                  "es_prolong_correct_postsmooth" + suffix, u.device,
                  u.data_ptr(), e.data_ptr(), b.data_ptr(),
                  omegas.data_ptr(), (ctypes.c_int * len(ids))(*ids), sweeps,
                  _coefficients(stencil_vals, taps), u_out.data_ptr(), *cols,
                  *_window_args("up", sweeps, u))
    return u_out


def upleg_downleg_col(u: torch.Tensor, e: torch.Tensor, b: torch.Tensor,
                      omegas: torch.Tensor, omega_ids: Sequence[int],
                      stencil_vals, p_taps, r_taps):
    """The up-leg of one cycle and the down-leg of the next in one pass:
    ``u + omegas[omega_ids[0]] * P(e)`` with the full prolongation of ``e``
    ((n-1)/2, (m-1)/2) by the (row, column) taps ``p_taps``, then
    ``len(omega_ids) - 1`` (1..6) red-black sweeps with factors
    ``omegas[omega_ids[1:]]`` in the order they run (the post-sweeps, then
    the next cycle's pre-sweeps), then ``r = b - A u`` and its full
    restriction by ``r_taps``.  Returns ``(u_next (n, m), rc ((n-1)/2,
    (m-1)/2))``."""
    ids = _check_leg(u, b, omegas, omega_ids, len(omega_ids) - 1, (e,),
                     MAX_FUSED_SWEEPS)
    _check_coarse(u, e, rows_only=False)
    if not _build.on_card(u):
        return upleg_downleg_col_plain(u, e, b, omegas, ids, stencil_vals,
                                       p_taps, r_taps)
    _build.check_card_tensors(u, e, b, omegas)
    n, m = u.shape
    u_out = torch.empty_like(u)
    rc = u.new_empty(((n - 1) // 2, (m - 1) // 2))
    _build.launch(launches, "upleg_downleg_col", "es_upleg_downleg",
                  u.device, u.data_ptr(), e.data_ptr(), b.data_ptr(),
                  omegas.data_ptr(), (ctypes.c_int * len(ids))(*ids),
                  len(ids) - 1, _coefficients(stencil_vals, r_taps, p_taps),
                  u_out.data_ptr(), rc.data_ptr(), 1,
                  *_window_args("pass", len(ids) - 1, u))
    return u_out, rc


def presmooth_residual_rowrestrict(u: torch.Tensor, b: torch.Tensor,
                                   omegas: torch.Tensor,
                                   omega_ids: Sequence[int], stencil_vals,
                                   row_taps):
    """Row-only down-leg: the sweeps and residual of
    :func:`presmooth_residual_restrict`, restricted along rows only by the
    3-tap ``row_taps``: ``rr[i, j] = w[0] r[2i, j] + w[1] r[2i+1, j] +
    w[2] r[2i+2, j]``.  Returns ``(u_s (n, m), rr ((n-1)/2, m))``."""
    ids = _check_leg(u, b, omegas, omega_ids, len(omega_ids))
    if not _build.on_card(u):
        return presmooth_residual_rowrestrict_plain(u, b, omegas, ids,
                                                    stencil_vals, row_taps)
    _build.check_card_tensors(u, b, omegas)
    n, m = u.shape
    u_out = torch.empty_like(u)
    rr = u.new_empty(((n - 1) // 2, m))
    _build.launch(launches, "presmooth_residual_rowrestrict",
                  "es_presmooth_residual_restrict", u.device,
                  u.data_ptr(), b.data_ptr(), omegas.data_ptr(),
                  (ctypes.c_int * len(ids))(*ids), len(ids),
                  _coefficients(stencil_vals, (row_taps, _NO_TAPS)),
                  u_out.data_ptr(), rr.data_ptr(), 0,
                  *_window_args("rowdown", len(ids), u))
    return u_out, rr


def prolong_correct_postsmooth(u: torch.Tensor, c_half: torch.Tensor,
                               b: torch.Tensor, omegas: torch.Tensor,
                               omega_ids: Sequence[int], stencil_vals,
                               row_taps):
    """Row-only up-leg: ``u + omegas[omega_ids[0]] * P_row(c_half)``, where
    ``c_half`` ((n-1)/2, m) is the coarse correction prolonged along
    columns already and ``P_row`` gives fine row 2i+1 ``w[1] c[i]`` and
    fine row 2i ``w[2] c[i-1] + w[0] c[i]`` for the 3-tap ``row_taps``;
    then ``len(omega_ids) - 1`` red-black sweeps with factors
    ``omegas[omega_ids[1:]]``."""
    ids = _check_leg(u, b, omegas, omega_ids, len(omega_ids) - 1,
                     (c_half,))
    _check_coarse(u, c_half, rows_only=True)
    if not _build.on_card(u):
        return prolong_correct_postsmooth_plain(u, c_half, b, omegas, ids,
                                                stencil_vals, row_taps)
    _build.check_card_tensors(u, c_half, b, omegas)
    u_out = torch.empty_like(u)
    sweeps = len(ids) - 1
    _build.launch(launches, "prolong_correct_postsmooth",
                  "es_prolong_correct_postsmooth", u.device,
                  u.data_ptr(), c_half.data_ptr(), b.data_ptr(),
                  omegas.data_ptr(), (ctypes.c_int * len(ids))(*ids),
                  sweeps,
                  _coefficients(stencil_vals, (row_taps, _NO_TAPS)),
                  u_out.data_ptr(), 0, *_window_args("rowup", sweeps, u))
    return u_out


def upleg_downleg_fused(u: torch.Tensor, c_half: torch.Tensor,
                        b: torch.Tensor, omegas: torch.Tensor,
                        omega_ids: Sequence[int], stencil_vals, p_row_taps,
                        r_row_taps):
    """:func:`upleg_downleg_col` with row-only transfers: takes ``c_half``
    ((n-1)/2, m) as :func:`prolong_correct_postsmooth` does and returns
    ``(u_next (n, m), rr ((n-1)/2, m))`` as
    :func:`presmooth_residual_rowrestrict` does."""
    ids = _check_leg(u, b, omegas, omega_ids, len(omega_ids) - 1,
                     (c_half,), MAX_FUSED_SWEEPS)
    _check_coarse(u, c_half, rows_only=True)
    if not _build.on_card(u):
        return upleg_downleg_fused_plain(u, c_half, b, omegas, ids,
                                         stencil_vals, p_row_taps,
                                         r_row_taps)
    _build.check_card_tensors(u, c_half, b, omegas)
    n, m = u.shape
    u_out = torch.empty_like(u)
    rr = u.new_empty(((n - 1) // 2, m))
    _build.launch(launches, "upleg_downleg_fused", "es_upleg_downleg",
                  u.device, u.data_ptr(), c_half.data_ptr(), b.data_ptr(),
                  omegas.data_ptr(), (ctypes.c_int * len(ids))(*ids),
                  len(ids) - 1,
                  _coefficients(stencil_vals, (r_row_taps, _NO_TAPS),
                                (p_row_taps, _NO_TAPS)),
                  u_out.data_ptr(), rr.data_ptr(), 0,
                  *_window_args("rowpass", len(ids) - 1, u))
    return u_out, rr


def _check_transfer(u, others, omegas=None, omega_id=0):
    """Shape and index checks of the standalone transfers."""
    if any(t.device != u.device for t in others):
        raise ValueError("transfer tensors lie on different devices")
    if u.ndim != 2:
        raise ValueError(f"u {tuple(u.shape)} must be 2D")
    n, m = u.shape
    if n < 3 or m < 3 or n % 2 == 0 or m % 2 == 0:
        raise ValueError(f"grid {n}x{m} must be odd on both axes")
    if omegas is not None:
        if omegas.ndim != 1:
            raise ValueError("omegas must be a 1-D relaxation-factor vector")
        if not 0 <= int(omega_id) < omegas.shape[0]:
            raise IndexError(f"omega id {omega_id} outside a vector of "
                             f"{omegas.shape[0]}")


def residual_restrict(u: torch.Tensor, b: torch.Tensor, stencil_vals, taps):
    """``R (b - A u)``: the residual of the constant 5-point operator
    ``stencil_vals`` = (center, up, down, left, right) and its full
    restriction with the (row, column) 3-tap pair ``taps``; returns
    ``rc ((n-1)/2, (m-1)/2)``."""
    _check_transfer(u, (b,))
    if b.shape != u.shape:
        raise ValueError(f"u {tuple(u.shape)} and b {tuple(b.shape)} differ")
    if not _build.on_card(u):
        return residual_restrict_plain(u, b, stencil_vals, taps)
    _build.check_card_tensors(u, b)
    n, m = u.shape
    rc = u.new_empty(((n - 1) // 2, (m - 1) // 2))
    # the down-leg's window with no sweep (halo 2)
    _build.launch(launches, "residual_restrict", "es_residual_restrict",
                  u.device, u.data_ptr(), b.data_ptr(),
                  _coefficients(stencil_vals, taps), rc.data_ptr(),
                  *_window_args("down", 0, u))
    return rc


def prolong_correct(u: torch.Tensor, e: torch.Tensor, omegas: torch.Tensor,
                    omega_id: int, taps):
    """``u + omegas[omega_id] * P(e)`` with the full 1:2 prolongation of the
    coarse correction ``e`` ((n-1)/2, (m-1)/2) by the (row, column) 3-tap
    pair ``taps``."""
    _check_transfer(u, (e, omegas), omegas, omega_id)
    _check_coarse(u, e, rows_only=False)
    if not _build.on_card(u):
        return prolong_correct_plain(u, e, omegas, int(omega_id), taps)
    _build.check_card_tensors(u, e, omegas)
    u_out = torch.empty_like(u)
    # the up-leg's window with no sweep (halo 0); the kernel reads only the
    # taps of the coefficient block
    _build.launch(launches, "prolong_correct", "es_prolong_correct",
                  u.device, u.data_ptr(), e.data_ptr(), omegas.data_ptr(),
                  int(omega_id), _coefficients((1.0, 0, 0, 0, 0), taps),
                  u_out.data_ptr(), *_window_args("up", 0, u))
    return u_out
