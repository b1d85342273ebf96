"""Smoother sweeps of a constant complex 5-point operator (counterpart of
evostencils_tpu/ops/pallas/rbgs_cx.py ``fused_rbgs_sweep_cx`` and
``jacobi_sweep_cx``).

They serve the smoother cycles of the shifted-Laplace Helmholtz
preconditioner M = -Lap - k^2 (1 + 0.5i) with Dirichlet boundaries: a
constant complex stencil (compiler/lower.py ``_try_fused_smoother``).
Each sweep has, in this module, as in ``rbgs.py``:

* its wrapper: a CUDA tensor launches the hand-written kernel from
  ``csrc/rbgs_cx.cu`` (complex64, contiguous, read as interleaved
  (re, im) pairs with no copy) or raises; a CPU tensor takes the plain
  version; any other device raises;
* its plain PyTorch version (``*_plain``) in torch complex arithmetic:
  ``u + omega * (d * (b - A u))`` with ``d = 1 / center`` computed in
  Python complex, as the TPU body's update (rbgs_cx.py:93-104, :116-118);
* its count in ``launches``, which only a kernel launch increments.

The relaxation factor is ``omegas[omega_id]``, read on the device from a
real vector, as the TPU kernel takes ``omega.real`` (rbgs_cx.py:149).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..apply import red_black_masks
from . import _build

#: kernel gate: the JAX gate's level set (rbgs_cx.py:30, :45-49); its
#: test of at least 8 rows is implied by more than BLOCK_ROWS
BLOCK_ROWS = 64
MIN_COLS = 128

#: The block schedule of the red-black kernel, csrc/rbgs_cx.cu
#: ``fused_rbgs_cx_kernel`` (``CxShape`` states the same window, and
#: es_fused_rbgs_sweep_cx_info reports it from the card).  A block of
#: SWEEP_THREADS threads stages u and b over a window of SWEEP_WINDOW =
#: (rows, columns) cells and owns its centre, the tile: the window less
#: SWEEP_HALO cells on every side.  The red half-sweep updates the window
#: cells at a distance >= 1 from the window edge, the black one those at
#: >= 2.  At least SWEEP_BLOCKS_PER_SM blocks are resident on an SM.
SWEEP_WINDOW = (16, 64)
SWEEP_THREADS = 256
SWEEP_HALO = 2
SWEEP_BLOCKS_PER_SM = 8

#: kernel launches per kernel since the last reset_launches()
launches = {"fused_rbgs_sweep_cx": 0, "jacobi_sweep_cx": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def sweep_tile() -> Tuple[int, int]:
    """(rows, columns) of the tile a block of the red-black kernel owns:
    the window less the halo on every side."""
    rows, cols = SWEEP_WINDOW
    return rows - 2 * SWEEP_HALO, cols - 2 * SWEEP_HALO


def sweep_info() -> dict:
    """What the card makes of the red-black kernel: ``_build.info``'s
    tile, halo, threads, occupancy, spills and shared memory.  Needs the
    card."""
    return _build.info("es_fused_rbgs_sweep_cx_info", "red-black cx sweep")


def complex_five_point_values(stencil) -> Optional[Tuple[complex, ...]]:
    """(center, north, south, west, east) of a constant 5-point 2D stencil
    with at least one complex entry, as Python complex; None otherwise
    (rbgs_cx.py:33-42)."""
    entries = dict(stencil.entries)
    wanted = [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)]
    if set(entries) - set(wanted):
        return None
    if not any(isinstance(v, complex) for v in entries.values()):
        return None
    return tuple(complex(entries.get(o, 0.0)) for o in wanted)


def supports(u: torch.Tensor, vals) -> bool:
    """Whether a level runs the sweep kernels: a 2D grid of more than 64
    rows and at least 128 columns with complex stencil values, complex64
    (the plain versions on the CPU also take complex128).  A complex128
    tensor on the card takes the generic lowering; it is never cast.  A
    bfloat16 field raises NotImplementedError, as at every kernel gate but
    the 2D legs'."""
    if not (vals is not None and u.ndim == 2
            and u.shape[0] > BLOCK_ROWS and u.shape[1] >= MIN_COLS):
        return False
    _build.refuse_bf16(u, "row 17 (fused_rbgs_sweep_cx, jacobi_sweep_cx)",
                       "rbgs_cx.py:45")
    return (u.dtype == torch.complex64
            or (u.device.type == "cpu" and u.dtype == torch.complex128))


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _update(u, b, omegas, omega_id, vals):
    """``omega * (d * (b - A u))`` at every point: A u summed center, up,
    down, left, right, as the TPU body sums it (rbgs_cx.py:93-101)."""
    c, cn, cs, cw, ce = (complex(v) for v in vals)
    p = F.pad(u, (1, 1, 1, 1))
    au = (c * u + cn * p[:-2, 1:-1] + cs * p[2:, 1:-1] + cw * p[1:-1, :-2]
          + ce * p[1:-1, 2:])
    return omegas[omega_id] * ((1.0 / c) * (b - au))


def jacobi_sweep_cx_plain(u, b, omegas, omega_id, vals):
    """Plain version of :func:`jacobi_sweep_cx`."""
    return u + _update(u, b, omegas, omega_id, vals)


def fused_rbgs_sweep_cx_plain(u, b, omegas, omega_id, vals):
    """Plain version of :func:`fused_rbgs_sweep_cx`: the red half-sweep,
    then the black one with the new red values (rbgs_cx.py:78-82,
    :106-107)."""
    red = red_black_masks(tuple(u.shape), device=u.device,
                          dtype=torch.bool)[0]
    for mask in (red, ~red):
        u = u + torch.where(mask, _update(u, b, omegas, omega_id, vals), 0)
    return u


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_sweep(u, b, omegas, omega_id, vals):
    if any(t.device != u.device for t in (b, omegas)):
        raise ValueError("sweep tensors lie on different devices")
    if u.ndim != 2 or b.shape != u.shape:
        raise ValueError(f"u {tuple(u.shape)} and b {tuple(b.shape)} must be "
                         "equal 2D shapes")
    if len(vals) != 5 or complex(vals[0]) == 0:
        raise ValueError("need 5 stencil values with a nonzero center")
    if omegas.ndim != 1 or omegas.is_complex():
        raise ValueError("omegas must be a real 1-D relaxation-factor vector")
    if not 0 <= int(omega_id) < omegas.shape[0]:
        raise IndexError(f"omega id {omega_id} outside a vector of "
                         f"{omegas.shape[0]}")
    return int(omega_id)


def _values(vals):
    """The 5 stencil values and d = 1 / center, as (re, im) doubles; d is
    computed in Python complex, as the TPU wrapper does."""
    vals = [complex(v) for v in vals]
    parts = []
    for v in vals + [1.0 / vals[0]]:
        parts += [v.real, v.imag]
    return (ctypes.c_double * 12)(*parts)


def _sweep(name, entry, plain, u, b, omegas, omega_id, vals):
    """Launch ``entry`` on a CUDA tensor; a CPU tensor takes ``plain``."""
    omega_id = _check_sweep(u, b, omegas, omega_id, vals)
    if not _build.on_card(u):
        return plain(u, b, omegas, omega_id, vals)
    _build.check_card_tensors(u, b, dtype=torch.complex64)
    _build.check_card_tensors(omegas)
    out = torch.empty_like(u)
    n, m = u.shape
    _build.launch(launches, name, entry, u.device, u.data_ptr(),
                  b.data_ptr(), omegas.data_ptr(), omega_id, _values(vals),
                  out.data_ptr(), n, m)
    return out


def fused_rbgs_sweep_cx(u: torch.Tensor, b: torch.Tensor,
                        omegas: torch.Tensor, omega_id: int, vals):
    """One red-black sweep of the complex 5-point operator ``vals`` =
    (center, up, down, left, right) in one pass over u and b: the red
    half-sweep, then the black one with the new red values."""
    return _sweep("fused_rbgs_sweep_cx", "es_fused_rbgs_sweep_cx",
                  fused_rbgs_sweep_cx_plain, u, b, omegas, omega_id, vals)


def jacobi_sweep_cx(u: torch.Tensor, b: torch.Tensor, omegas: torch.Tensor,
                    omega_id: int, vals):
    """One damped Jacobi sweep of the complex 5-point operator ``vals``:
    every point from the old u."""
    return _sweep("jacobi_sweep_cx", "es_sweep_cx", jacobi_sweep_cx_plain,
                  u, b, omegas, omega_id, vals)
