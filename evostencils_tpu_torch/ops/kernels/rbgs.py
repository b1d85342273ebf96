"""Standalone smoother sweeps of a constant 5-point operator (counterpart
of evostencils_tpu/ops/pallas/rbgs.py ``fused_rbgs_sweep``,
``jacobi_sweep`` and ``rbgs_sweep``).

They serve the smoother cycles of evolved 2D cycles that no fused leg
takes (compiler/lower.py ``_try_fused_smoother``).  Each sweep has, in this
module, as in ``transfer.py``:

* its wrapper: a CUDA tensor launches the hand-written kernel from
  ``csrc/rbgs.cu`` (float32, contiguous) or raises; a CPU tensor takes the
  plain version; any other device raises;
* its plain PyTorch version (``*_plain``), which repeats the TPU kernel's
  arithmetic in the TPU kernel's sum order;
* its count in ``launches``, which only a kernel launch increments.
  ``jacobi_sweep`` counts the launches of the single-pass sweep kernel
  (:func:`sweep`) in every parity mode: ``jacobi_sweep`` adds one,
  ``rbgs_sweep`` two.

The relaxation factor is ``omegas[omega_id]``, read on the device.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..apply import red_black_masks
from . import _build

#: kernel gate: the JAX gate's level set (rbgs.py:139-142)
MIN_ROWS = 8
MIN_COLS = 128

#: The schedule of the single-pass sweep kernel, csrc/rbgs.cu
#: ``sweep_kernel`` (``STRIP``, ``SWEEP_BX`` and ``SWEEP_BY`` there, and
#: es_sweep_info reports them from the card).  Each thread owns a strip of
#: SWEEP_STRIP rows of one column, in blocks of SWEEP_BLOCK = (columns,
#: strips) threads: u on the strip and one row beyond each end rolls
#: through its registers, and the columns beside it come from the lanes
#: beside it, or at a warp's edges from a load.  At least
#: SWEEP_BLOCKS_PER_SM blocks (1024 threads) are resident on an SM.
SWEEP_STRIP = 4
SWEEP_BLOCK = (128, 2)
SWEEP_BLOCKS_PER_SM = 4

#: The block schedule of the red-black kernel, csrc/rbgs.cu
#: ``fused_rbgs_kernel`` (``FusedShape`` states the same window, and
#: es_fused_rbgs_sweep_info reports it from the card).  A block of
#: FUSED_THREADS threads stages u and b over a window of FUSED_WINDOW =
#: (rows, columns) cells and owns its centre, the tile: the window less
#: FUSED_HALO cells on every side.  The red half-sweep updates the window
#: cells at a distance >= 1 from the window edge, the black one those at
#: >= 2.  At least FUSED_BLOCKS_PER_SM blocks are resident on an SM.
FUSED_WINDOW = (24, 64)
FUSED_THREADS = 256
FUSED_HALO = 2
FUSED_BLOCKS_PER_SM = 8

#: kernel launches per kernel since the last reset_launches()
launches = {"fused_rbgs_sweep": 0, "jacobi_sweep": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def sweep_info(one_colour: bool = False) -> dict:
    """What the card makes of the single-pass sweep kernel for a pass of
    one colour (parity 0 or 1) or of every point (-1): the rows of a
    thread's strip, the block's columns and strips, threads per block,
    resident blocks per SM, registers and local memory (spills) per
    thread, and shared memory per block.  Needs the card."""
    out = (ctypes.c_int * 8)()
    err = _build.load_library().es_sweep_info(int(one_colour), out)
    if err != 0:
        raise RuntimeError(f"no sweep instantiation: CUDA error {err}")
    return dict(zip(("strip", "block_cols", "block_strips", "threads",
                     "blocks_per_sm", "registers", "local_bytes",
                     "smem_bytes"), out))


def fused_tile() -> Tuple[int, int]:
    """(rows, columns) of the tile a block of the red-black kernel owns:
    the window less the halo on every side."""
    rows, cols = FUSED_WINDOW
    return rows - 2 * FUSED_HALO, cols - 2 * FUSED_HALO


def fused_sweep_info() -> dict:
    """What the card makes of the red-black kernel: ``_build.info``'s
    tile, halo, threads, occupancy, spills and shared memory.  Needs the
    card."""
    return _build.info("es_fused_rbgs_sweep_info", "red-black sweep")


def five_point_values(stencil) -> Optional[Tuple[float, ...]]:
    """(center, up, down, left, right) = the values at (0,0), (-1,0),
    (1,0), (0,-1), (0,1) of a constant 5-point 2D stencil, else None
    (rbgs.py:127-136)."""
    entries = dict(stencil.entries)
    wanted = [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)]
    if set(entries) - set(wanted):
        return None
    if any(isinstance(v, complex) for v in entries.values()):
        return None
    return tuple(float(entries.get(o, 0.0)) for o in wanted)


def supports(u: torch.Tensor, stencil_vals) -> bool:
    """Whether a level runs the sweep kernels: a 2D grid of at least 8 rows
    and 128 columns with a 5-point stencil, float32 when it lies on a CUDA
    device (the plain versions on the CPU take any float type); raises
    NotImplementedError for bfloat16, which the JAX gate admits."""
    if not (u.ndim == 2 and stencil_vals is not None
            and u.shape[0] >= MIN_ROWS and u.shape[1] >= MIN_COLS):
        return False
    _build.refuse_bf16(u, "rows 9-10 (fused_rbgs_sweep, jacobi_sweep)",
                       "rbgs.py:140")
    return u.device.type == "cpu" or u.dtype == torch.float32


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _neighbours(u):
    """(up, down, left, right): u at (-1,0), (1,0), (0,-1), (0,1), zero
    outside the grid."""
    p = F.pad(u, (1, 1, 1, 1))
    return p[:-2, 1:-1], p[2:, 1:-1], p[1:-1, :-2], p[1:-1, 2:]


def _red(u):
    return red_black_masks(tuple(u.shape), device=u.device,
                           dtype=torch.bool)[0]


def sweep_plain(u, b, omegas, omega_id, stencil_vals, parity):
    """Plain version of :func:`sweep`: one pass of ``_sweep_kernel``
    (rbgs.py:37-86)."""
    c, cw, ce, cn, cs = (float(v) for v in stencil_vals)
    up, dn, lf, rt = _neighbours(u)
    au = c * u + cw * up + ce * dn + cn * lf + cs * rt
    update = omegas[omega_id] * (1.0 / c) * (b - au)
    if parity >= 0:
        red = _red(u)
        update = torch.where(red if parity == 0 else ~red, update, 0.0)
    return u + update


def jacobi_sweep_plain(u, b, omegas, omega_id, stencil_vals):
    """Plain version of :func:`jacobi_sweep`."""
    return sweep_plain(u, b, omegas, omega_id, stencil_vals, -1)


def rbgs_sweep_plain(u, b, omegas, omega_id, stencil_vals):
    """Plain version of :func:`rbgs_sweep`."""
    u = sweep_plain(u, b, omegas, omega_id, stencil_vals, 0)
    return sweep_plain(u, b, omegas, omega_id, stencil_vals, 1)


def fused_rbgs_sweep_plain(u, b, omegas, omega_id, stencil_vals):
    """Plain version of :func:`fused_rbgs_sweep`: the two masked half-sweeps
    of ``_fused_rb_kernel`` (rbgs.py:198-209), which sum the neighbours
    apart from the center term (transfer.py:621-626)."""
    c, cw, ce, cn, cs = (float(v) for v in stencil_vals)
    om_dinv = omegas[omega_id] * (1.0 / c)
    red = _red(u)
    for mask in (red, ~red):
        up, dn, lf, rt = _neighbours(u)
        au = c * u + (cw * up + ce * dn + cn * lf + cs * rt)
        u = u + torch.where(mask, om_dinv * (b - au), 0.0)
    return u


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_sweep(u, b, omegas, omega_id, stencil_vals):
    if any(t.device != u.device for t in (b, omegas)):
        raise ValueError("sweep tensors lie on different devices")
    if u.ndim != 2 or b.shape != u.shape:
        raise ValueError(f"u {tuple(u.shape)} and b {tuple(b.shape)} must be "
                         "equal 2D shapes")
    if len(stencil_vals) != 5 or float(stencil_vals[0]) == 0.0:
        raise ValueError("need 5 stencil values with a nonzero center")
    if omegas.ndim != 1:
        raise ValueError("omegas must be a 1-D relaxation-factor vector")
    if not 0 <= int(omega_id) < omegas.shape[0]:
        raise IndexError(f"omega id {omega_id} outside a vector of "
                         f"{omegas.shape[0]}")
    return int(omega_id)


def _values(stencil_vals):
    return (ctypes.c_double * 5)(*(float(v) for v in stencil_vals))


def sweep(u: torch.Tensor, b: torch.Tensor, omegas: torch.Tensor,
          omega_id: int, stencil_vals, parity: int):
    """One pass of the sweep kernel: ``u + omega / c * (b - A u)`` of the
    constant 5-point operator ``stencil_vals`` = (center, up, down, left,
    right) at every point from the old u (``parity`` -1, a damped Jacobi
    sweep), or at the red (0) or black (1) points only."""
    omega_id = _check_sweep(u, b, omegas, omega_id, stencil_vals)
    if parity not in (-1, 0, 1):
        raise ValueError(f"parity {parity} is not -1, 0 or 1")
    if not _build.on_card(u):
        return sweep_plain(u, b, omegas, omega_id, stencil_vals, parity)
    _build.check_card_tensors(u, b, omegas)
    out = torch.empty_like(u)
    n, m = u.shape
    _build.launch(launches, "jacobi_sweep", "es_sweep", u.device,
                  u.data_ptr(), b.data_ptr(), omegas.data_ptr(), omega_id,
                  parity, _values(stencil_vals), out.data_ptr(), n, m)
    return out


def jacobi_sweep(u: torch.Tensor, b: torch.Tensor, omegas: torch.Tensor,
                 omega_id: int, stencil_vals):
    """One damped Jacobi sweep: :func:`sweep` with parity -1."""
    return sweep(u, b, omegas, omega_id, stencil_vals, -1)


def rbgs_sweep(u: torch.Tensor, b: torch.Tensor, omegas: torch.Tensor,
               omega_id: int, stencil_vals):
    """One red-black sweep as two single-colour passes of the sweep
    kernel: red, then black with the new red values."""
    u = sweep(u, b, omegas, omega_id, stencil_vals, 0)
    return sweep(u, b, omegas, omega_id, stencil_vals, 1)


def fused_rbgs_sweep(u: torch.Tensor, b: torch.Tensor, omegas: torch.Tensor,
                     omega_id: int, stencil_vals):
    """One red-black sweep in one pass over u and b: the red half-sweep,
    then the black one with the new red values."""
    omega_id = _check_sweep(u, b, omegas, omega_id, stencil_vals)
    if not _build.on_card(u):
        return fused_rbgs_sweep_plain(u, b, omegas, omega_id, stencil_vals)
    _build.check_card_tensors(u, b, omegas)
    out = torch.empty_like(u)
    n, m = u.shape
    _build.launch(launches, "fused_rbgs_sweep", "es_fused_rbgs_sweep",
                  u.device, u.data_ptr(), b.data_ptr(), omegas.data_ptr(),
                  omega_id, _values(stencil_vals), out.data_ptr(), n, m)
    return out
