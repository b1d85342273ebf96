"""Smoother kernels of a variable-coefficient 5-point operator
(counterpart of evostencils_tpu/ops/pallas/rbgs_var.py
``fused_rbgs_sweep_var``, ``jacobi_sweep_var``,
``presmooth_residual_restrict_var`` and
``prolong_correct_postsmooth_var``).

The operator is a coefficient stack ``c_stack`` (5, n, m): plane k holds
the coefficient of ``FIVE_POINT_OFFSETS[k]`` at each point
(:func:`five_point_stack`).  The legs serve the variable-coefficient
V-cycle's pre- and post-smoothing legs on the levels the transfer gate
admits; the sweeps serve the smoother cycles that no leg takes
(compiler/lower.py).  Each entry point has, in this module, as in
``transfer.py``:

* its wrapper: a CUDA tensor launches the hand-written kernel from
  ``csrc/rbgs_var.cu`` (float32, contiguous) or raises; a CPU tensor takes
  the plain version; any other device raises;
* its plain PyTorch version (``*_plain``), which repeats the TPU body's
  arithmetic in its order, the stack cast to u's dtype first;
* its count in ``launches``, which only a kernel launch increments.

The arguments come in the order of the constant-coefficient siblings,
the coefficient stack where those take the stencil values.  Relaxation
factors stay on the device: a sweep reads ``omegas[omega_id]``, a leg the
factors ``omegas[omega_ids]``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..apply import axis_prolong_3tap, axis_restrict_3tap, red_black_masks
from . import _build
from . import transfer
#: the halo of a leg kernel's window: the system legs' rule (P + 2 down, P
#: up; P = 2S red-black, S Jacobi), the windows being swept the same way
from .rbgs_sys import leg_halo

#: offset order of the stacked coefficient planes: center, north (row-1),
#: south (row+1), west (col-1), east (col+1) (rbgs_var.py:30-32)
FIVE_POINT_OFFSETS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
#: sweep gate: the JAX gate's level set (rbgs_var.py:36, :56-60)
BLOCK_ROWS = 32
MIN_ROWS = 8
MIN_COLS = 128

#: The block schedule of the leg kernels (csrc/rbgs_var.cu states the same
#: window, and es_var_leg_info reports it from the card).  A block of
#: LEG_THREADS threads stages u, b and the four neighbour coefficient planes
#: over a window of LEG_WINDOW = (rows, columns) cells, reads the centre
#: coefficients of its cells into registers, and owns the window's centre,
#: the tile: the window less leg_halo() cells on every side.  Pass p updates
#: the window cells at a distance >= p from the window edge.
#: LEG_BLOCKS_PER_SM blocks are resident on an SM.
LEG_WINDOW = (32, 64)
LEG_THREADS = 256
LEG_BLOCKS_PER_SM = 4
#: The block schedule of the standalone red-black sweep, a form of the
#: same kernel (``rbgs_var_kernel``; es_sweep_var_info reports it from the
#: card): SWEEP_THREADS threads over a window of SWEEP_WINDOW = (rows,
#: columns) cells with a halo of SWEEP_HALO (one red-black sweep: pass p
#: on the cells at a distance >= p), at least SWEEP_BLOCKS_PER_SM blocks
#: resident on an SM.
SWEEP_WINDOW = (16, 64)
SWEEP_THREADS = 256
SWEEP_HALO = 2
SWEEP_BLOCKS_PER_SM = 8

#: kernel launches per kernel since the last reset_launches()
launches = {"fused_rbgs_sweep_var": 0, "jacobi_sweep_var": 0,
            "presmooth_residual_restrict_var": 0,
            "prolong_correct_postsmooth_var": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def leg_tile(leg: str, sweeps: int, red_black: bool) -> Tuple[int, int]:
    """(rows, columns) of the tile a block owns: the window less the leg's
    halo on every side."""
    halo = leg_halo(leg, sweeps, red_black)
    return LEG_WINDOW[0] - 2 * halo, LEG_WINDOW[1] - 2 * halo


def leg_info(leg: str, sweeps: int, red_black: bool) -> dict:
    """What the card makes of a leg kernel's instantiation (``leg`` "down"
    or "up", ``sweeps``, red-black or Jacobi): ``_build.info``'s tile,
    halo, threads, occupancy, spills and shared memory.  Needs the card."""
    return _build.info("es_var_leg_info",
                       f"{leg}-leg for S = {sweeps}, red-black {red_black}",
                       int(leg == "down"), int(sweeps), int(red_black))


def sweep_tile() -> Tuple[int, int]:
    """(rows, columns) of the tile a block of the red-black sweep owns: the
    window less the halo on every side."""
    rows, cols = SWEEP_WINDOW
    return rows - 2 * SWEEP_HALO, cols - 2 * SWEEP_HALO


def sweep_info() -> dict:
    """What the card makes of the red-black sweep: ``_build.info``'s tile,
    halo, threads, occupancy, spills and shared memory.  Needs the card."""
    return _build.info("es_sweep_var_info", "red-black var sweep")


def five_point_stack(sf, *, device, dtype) -> Optional[torch.Tensor]:
    """A 2D 5-point ``StencilField`` as a (5, n, m) ``dtype`` tensor on
    ``device`` in FIVE_POINT_OFFSETS order, missing offsets zero, or None
    if the field has any other shape (other offsets, complex coefficients,
    not 2D, no center) (rbgs_var.py:39-53).  Built once per field object,
    device and dtype."""
    offsets = tuple(sf.offsets)
    if set(offsets) - set(FIVE_POINT_OFFSETS) or len(offsets[0]) != 2:
        return None
    by_offset = {tuple(o): np.asarray(f)
                 for o, f in zip(sf.offsets, sf.fields)}
    if any(np.iscomplexobj(f) for f in by_offset.values()):
        return None
    if (0, 0) not in by_offset:
        return None
    shape = by_offset[(0, 0)].shape

    def build():
        planes = [by_offset.get(o, np.zeros(shape))
                  for o in FIVE_POINT_OFFSETS]
        return torch.as_tensor(np.stack(planes), dtype=dtype, device=device)
    return sf.cached("five_point_stack", device, dtype, build)


def supports(u: torch.Tensor, c_stack) -> bool:
    """Whether a level runs the sweep kernels: a 2D grid of more than 32
    rows and at least 128 columns with a coefficient stack, float32 when it
    lies on a CUDA device (the plain versions on the CPU take any float
    type); bfloat16, which the JAX gate admits, raises
    NotImplementedError.  The legs take the level set of
    ``transfer.supports``."""
    if not (c_stack is not None and u.ndim == 2
            and u.shape[0] >= MIN_ROWS and u.shape[1] >= MIN_COLS
            and u.shape[0] > BLOCK_ROWS):
        return False
    _build.refuse_bf16(u, "row 11 (fused_rbgs_sweep_var, jacobi_sweep_var)",
                       "rbgs_var.py:58")
    return u.device.type == "cpu" or u.dtype == torch.float32


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _apply(c, u):
    """``cc*u + cn*up + cs*dn + cw*left + ce*right``, zero outside the grid
    (rbgs_var.py:108-112)."""
    cc, cn, cs, cw, ce = c
    p = F.pad(u, (1, 1, 1, 1))
    return (cc * u + cn * p[:-2, 1:-1] + cs * p[2:, 1:-1]
            + cw * p[1:-1, :-2] + ce * p[1:-1, 2:])


def _masks(u, red_black):
    if not red_black:
        return (None,)
    red, black = red_black_masks(tuple(u.shape), device=u.device,
                                 dtype=torch.bool)
    return red, black


def _sweep_plain(u, b, omegas, omega_id, c_stack, red_black):
    """``_fused_var_kernel`` (rbgs_var.py:96-119): ``u + (omega / cc) *
    (b - A u)`` on the red and then the black points, or on every point
    from the old u."""
    c = c_stack.to(u.dtype)
    dinv = omegas[omega_id] / c[0]
    for mask in _masks(u, red_black):
        upd = dinv * (b - _apply(c, u))
        u = u + (upd if mask is None else torch.where(mask, upd, 0.0))
    return u


def fused_rbgs_sweep_var_plain(u, b, omegas, omega_id, c_stack):
    """Plain version of :func:`fused_rbgs_sweep_var`."""
    return _sweep_plain(u, b, omegas, omega_id, c_stack, True)


def jacobi_sweep_var_plain(u, b, omegas, omega_id, c_stack):
    """Plain version of :func:`jacobi_sweep_var`."""
    return _sweep_plain(u, b, omegas, omega_id, c_stack, False)


def _leg_sweeps_plain(u, b, c, omegas, omega_ids, red_black):
    """``_var_halfsweeps`` (rbgs_var.py:208-225): ``u + (omega * (1 / cc))
    * (b - A u)`` per half-sweep."""
    dinv = 1.0 / c[0]
    masks = _masks(u, red_black)
    for i in omega_ids:
        om = omegas[i]
        for mask in masks:
            upd = om * dinv * (b - _apply(c, u))
            u = u + (upd if mask is None else torch.where(mask, upd, 0.0))
    return u


def presmooth_residual_restrict_var_plain(u, b, omegas, omega_ids, c_stack,
                                          taps, red_black=True):
    """Plain version of :func:`presmooth_residual_restrict_var`: the
    sweeps, the residual, the row taps and then the column taps
    (rbgs_var.py:257-266)."""
    c = c_stack.to(u.dtype)
    u = _leg_sweeps_plain(u, b, c, omegas, omega_ids, red_black)
    r = b - _apply(c, u)
    return u, axis_restrict_3tap(axis_restrict_3tap(r, 0, taps[0]), 1,
                                 taps[1])


def prolong_correct_postsmooth_var_plain(u, e, b, omegas, omega_ids,
                                         c_stack, taps, red_black=True):
    """Plain version of :func:`prolong_correct_postsmooth_var`: the column
    expansion of e, then the row expansion, the correction and the sweeps
    (rbgs_var.py:348-363)."""
    n, m = u.shape
    c = c_stack.to(u.dtype)
    p = axis_prolong_3tap(axis_prolong_3tap(e, 1, taps[1], m), 0, taps[0], n)
    u = u + omegas[omega_ids[0]] * p
    return _leg_sweeps_plain(u, b, c, omegas, omega_ids[1:], red_black)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_stack(u, b, c_stack):
    if u.ndim != 2 or b.shape != u.shape:
        raise ValueError(f"u {tuple(u.shape)} and b {tuple(b.shape)} must be "
                         "equal 2D shapes")
    if tuple(c_stack.shape) != (5,) + tuple(u.shape):
        raise ValueError(f"coefficient stack {tuple(c_stack.shape)} is not "
                         f"(5, {u.shape[0]}, {u.shape[1]})")


def _check_sweep(u, b, omegas, omega_id, c_stack):
    if any(t.device != u.device for t in (b, omegas, c_stack)):
        raise ValueError("sweep tensors lie on different devices")
    _check_stack(u, b, c_stack)
    if omegas.ndim != 1:
        raise ValueError("omegas must be a 1-D relaxation-factor vector")
    if not 0 <= int(omega_id) < omegas.shape[0]:
        raise IndexError(f"omega id {omega_id} outside a vector of "
                         f"{omegas.shape[0]}")
    return int(omega_id)


def _sweep(name, u, b, omegas, omega_id, c_stack, red_black):
    """Launch es_sweep_var on a CUDA tensor; a CPU tensor takes the plain
    version."""
    omega_id = _check_sweep(u, b, omegas, omega_id, c_stack)
    if not _build.on_card(u):
        plain = fused_rbgs_sweep_var_plain if red_black \
            else jacobi_sweep_var_plain
        return plain(u, b, omegas, omega_id, c_stack)
    _build.check_card_tensors(u, b, omegas, c_stack)
    out = torch.empty_like(u)
    n, m = u.shape
    _build.launch(launches, name, "es_sweep_var", u.device, u.data_ptr(),
                  b.data_ptr(), c_stack.data_ptr(), omegas.data_ptr(),
                  omega_id, int(red_black), out.data_ptr(), n, m)
    return out


def fused_rbgs_sweep_var(u: torch.Tensor, b: torch.Tensor,
                         omegas: torch.Tensor, omega_id: int,
                         c_stack: torch.Tensor):
    """One red-black sweep of the operator ``c_stack`` in one pass: the red
    half-sweep, then the black one with the new red values, each
    ``u + (omega / cc) * (b - A u)``."""
    return _sweep("fused_rbgs_sweep_var", u, b, omegas, omega_id, c_stack,
                  True)


def jacobi_sweep_var(u: torch.Tensor, b: torch.Tensor, omegas: torch.Tensor,
                     omega_id: int, c_stack: torch.Tensor):
    """One damped Jacobi sweep of the operator ``c_stack``."""
    return _sweep("jacobi_sweep_var", u, b, omegas, omega_id, c_stack, False)


def _check_leg(u, b, c_stack, omegas, omega_ids, n_sweeps, extra=()):
    ids = transfer._check_leg(u, b, omegas, omega_ids, n_sweeps,
                              (c_stack,) + tuple(extra))
    _check_stack(u, b, c_stack)
    return ids


def _taps(taps):
    vals = [float(t) for axis in taps for t in axis]
    if len(vals) != 6:
        raise ValueError("need 3 taps per axis")
    return (ctypes.c_double * 6)(*vals)


def presmooth_residual_restrict_var(u: torch.Tensor, b: torch.Tensor,
                                    omegas: torch.Tensor,
                                    omega_ids: Sequence[int],
                                    c_stack: torch.Tensor, taps,
                                    red_black: bool = True):
    """Down-leg: ``len(omega_ids)`` damped red-black (or, with
    ``red_black`` False, Jacobi) sweeps of the operator ``c_stack`` with
    factors ``omegas[omega_ids[k]]`` in the order the sweeps run; then
    ``r = b - A u`` and its full restriction with the (row, column) 3-tap
    pair ``taps``.  Returns ``(u_s (n, m), rc ((n-1)/2, (m-1)/2))``."""
    ids = _check_leg(u, b, c_stack, omegas, omega_ids, len(omega_ids))
    if not _build.on_card(u):
        return presmooth_residual_restrict_var_plain(
            u, b, omegas, ids, c_stack, taps, red_black)
    _build.check_card_tensors(u, b, c_stack, omegas)
    n, m = u.shape
    sweeps = len(ids)
    u_out = torch.empty_like(u)
    rc = u.new_empty(((n - 1) // 2, (m - 1) // 2))
    _build.launch(launches, "presmooth_residual_restrict_var",
                  "es_presmooth_residual_restrict_var", u.device,
                  u.data_ptr(), b.data_ptr(), c_stack.data_ptr(),
                  omegas.data_ptr(), (ctypes.c_int * len(ids))(*ids),
                  sweeps, int(red_black), _taps(taps), u_out.data_ptr(),
                  rc.data_ptr(), leg_halo("down", sweeps, red_black), n, m)
    return u_out, rc


def prolong_correct_postsmooth_var(u: torch.Tensor, e: torch.Tensor,
                                   b: torch.Tensor, omegas: torch.Tensor,
                                   omega_ids: Sequence[int],
                                   c_stack: torch.Tensor, taps,
                                   red_black: bool = True):
    """Up-leg: ``u + omegas[omega_ids[0]] * P(e)`` with the full 1:2
    prolongation of the coarse correction ``e`` ((n-1)/2, (m-1)/2) by the
    (row, column) 3-tap pair ``taps``, then ``len(omega_ids) - 1``
    red-black (or Jacobi) sweeps of the operator ``c_stack`` with factors
    ``omegas[omega_ids[1:]]``."""
    ids = _check_leg(u, b, c_stack, omegas, omega_ids, len(omega_ids) - 1,
                     (e,))
    n, m = u.shape
    if tuple(e.shape) != ((n - 1) // 2, (m - 1) // 2):
        raise ValueError(f"coarse correction {tuple(e.shape)} does not "
                         f"match the grid {n}x{m}")
    if not _build.on_card(u):
        return prolong_correct_postsmooth_var_plain(
            u, e, b, omegas, ids, c_stack, taps, red_black)
    _build.check_card_tensors(u, e, b, c_stack, omegas)
    sweeps = len(ids) - 1
    u_out = torch.empty_like(u)
    _build.launch(launches, "prolong_correct_postsmooth_var",
                  "es_prolong_correct_postsmooth_var", u.device,
                  u.data_ptr(), e.data_ptr(), b.data_ptr(), c_stack.data_ptr(),
                  omegas.data_ptr(), (ctypes.c_int * len(ids))(*ids),
                  sweeps, int(red_black), _taps(taps), u_out.data_ptr(),
                  leg_halo("up", sweeps, red_black), n, m)
    return u_out
