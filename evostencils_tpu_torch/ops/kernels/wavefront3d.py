"""The 3D V(2,1) cycle's two fused leg kernels (counterpart of
evostencils_tpu/ops/pallas/wavefront3d.py ``downleg_wavefront_3d`` and
``upleg_wavefront_3d``).

Each leg has, in this module:

* its wrapper: a CUDA tensor launches the hand-written kernel from
  ``csrc/wavefront3d.cu`` (float32, contiguous) or raises; a CPU tensor
  takes the plain version; any other device raises;
* its plain PyTorch version (``*_plain``): masked half-sweeps in the
  premultiplied update form of the TPU kernel
  (``u + w * (dinv * b - u - sum_k (c_k * dinv) * u_k)``,
  wavefront3d.py:75-76, :119-129), the residual and the separable 3-tap
  transfers, axis 0 first.  The CPU tests use it, and ``chip_smoke.py``
  compares the kernel with it;
* its entry in ``launches``, which only a kernel launch increments.

The 7-point operator is given as ``stencil_vals`` = (center, -x, +x, -y,
+y, -z, +z), the order of ``rbgs3d.SEVEN_OFFSETS``; the transfers
as one (w[-1], w[0], w[+1]) triple per axis.  Red is an even node-index
sum; interior index i is node i+1 on every axis, so in 3D red is an ODD
interior-index sum (wavefront3d.py:98), the opposite of 2D.

Relaxation factors stay on the device: a leg takes the whole vector
``omegas`` and the indices ``omega_ids`` of the two factors it applies.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from ..apply import (axis_prolong_3tap, axis_restrict_3tap,
                     red_black_masks)
from . import _build

#: kernel gate: the JAX gate's level set (wavefront3d.py:210-217)
MIN_PLANES = 8
MIN_LANES = 63
MAX_PLANE = 131_072

#: The kernels' block schedule (csrc/wavefront3d.cu states the same
#: constants; es_wavefront_3d_info reports them from the card, and
#: tests/test_torch_wavefront_tiles.py emulates the schedule with them).
#: A block owns a TILE x TILE tile of the (axis-1, axis-2) plane and a
#: window HALO = (before, after) cells wider on both in-plane axes, and
#: walks a chunk of axis 0 with WARMUP planes loaded before its first plane
#: and after its last needed one; the planes beyond read as zero.  At step
#: s plane s arrives and half-sweep k (1-based) runs on plane
#: s - 1 - LAG * (k - 1), on the window cells at a distance >= k from the
#: window edge.
TILE = 32
LAG = 2
HALO = {"down": (5, 6), "up": (2, 3)}
#: the halo the schedule needs; the up-leg's window has one cell more after
#: the tile, so that its rows are odd (the kernel's colour rule)
HALO_NEEDED = {"down": (5, 6), "up": (2, 2)}
WARMUP = {"down": 5, "up": 2}
BLOCKS_PER_SM = {"down": 1, "up": 1}
THREADS = {"down": 925, "up": 685}
MIN_CHUNK = 8

#: kernel launches per leg since the last reset_launches()
launches = {"downleg_wavefront_3d": 0, "upleg_wavefront_3d": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def supports(u: torch.Tensor) -> bool:
    """Whether a level runs the 3D legs: a 3D grid, odd on every axis,
    with at least 8 planes on axis 0, at least 63 points on axis 2 and at
    most 131,072 points per (axis-1, axis-2) plane, and float32 when it
    lies on a CUDA device (the plain versions on the CPU take any float
    type); bfloat16, which the JAX gate admits, raises
    NotImplementedError.  At 255^3 that admits 255^3, 127^3 and 63^3."""
    if u.ndim != 3:
        return False
    n0, n1, n2 = u.shape
    if any(n % 2 == 0 for n in u.shape):
        return False
    if n0 < MIN_PLANES or n2 < MIN_LANES or n1 * n2 > MAX_PLANE:
        return False
    _build.refuse_bf16(u, "rows 22-23 (downleg_wavefront_3d, "
                       "upleg_wavefront_3d)", "wavefront3d.py:215")
    return u.device.type == "cpu" or u.dtype == torch.float32


def chunk_rule(n0: int, n1: int, n2: int, tile: int, per_sm: int,
               min_chunk: int, sms: int) -> int:
    """Axis-0 planes per block of a plane-pipeline kernel with ``tile`` x
    ``tile`` tiles on an (n0, n1, n2) grid and a card of ``sms`` SMs
    (csrc/pipeline3d.cuh ``pipeline_blocks``): as many even-sized chunks
    as fill about one wave of ``per_sm`` resident blocks on every SM, but
    no chunk under ``min_chunk`` planes."""
    tiles = -(-n1 // tile) * -(-n2 // tile)
    chunks = max(1, sms * per_sm // tiles)
    chunks = min(chunks, -(-n0 // min_chunk))
    chunk = -(-n0 // chunks)
    return chunk + (chunk & 1)


def chunk_planes(n0: int, n1: int, n2: int, leg: str, sms: int) -> int:
    """Axis-0 planes per block of ``leg`` (:func:`chunk_rule` with TILE,
    BLOCKS_PER_SM[leg] and MIN_CHUNK)."""
    return chunk_rule(n0, n1, n2, TILE, BLOCKS_PER_SM[leg], MIN_CHUNK, sms)


#: the 11 values a plane-pipeline kernel's info entry reports
#: (csrc/pipeline3d.cuh ``pipeline_info``)
INFO_KEYS = ("tile", "halo_before", "halo_after", "warmup", "lag",
             "min_chunk", "threads", "blocks_per_sm", "registers",
             "local_bytes", "smem_bytes")


def pipeline_info(entry: str, what: str, *args) -> dict:
    """What the card makes of a plane-pipeline kernel: the INFO_KEYS values
    that the C entry ``entry`` reports for ``args``; ``what`` names the
    kernel in the error.  Needs the card."""
    info = (ctypes.c_int * len(INFO_KEYS))()
    err = getattr(_build.load_library(), entry)(*args, info)
    if err != 0:
        raise RuntimeError(f"{what} info: CUDA error {err}")
    return dict(zip(INFO_KEYS, info))


def leg_info(leg: str) -> dict:
    """What the card makes of a leg kernel (``leg`` "down" or "up"): its
    tile, halo before and after the tile, warm-up, lag, fewest planes a
    chunk holds, threads per block, resident blocks per SM, registers and
    local memory (spills) per thread, and dynamic shared memory per
    block.  Needs the card."""
    if leg not in HALO:
        raise ValueError(f"no 3D leg {leg!r}")
    return pipeline_info("es_wavefront_3d_info", f"3D {leg}-leg",
                         int(leg == "down"))


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _neighbours(u):
    """The six zero-edge neighbour views of ``u`` in stencil order
    (-x, +x, -y, +y, -z, +z)."""
    p = F.pad(u, (1, 1, 1, 1, 1, 1))
    n0, n1, n2 = u.shape
    i, j, k = slice(1, n0 + 1), slice(1, n1 + 1), slice(1, n2 + 1)
    return (p[:-2, j, k], p[2:, j, k], p[i, :-2, k], p[i, 2:, k],
            p[i, j, :-2], p[i, j, 2:])


def _half_sweep(u, b, om, mask, stencil_vals):
    """One masked half-sweep in the TPU kernel's premultiplied form (every
    point from the old u when ``mask`` is None); the off-diagonal sum is
    accumulated in stencil order."""
    dinv = 1.0 / stencil_vals[0]
    off = None
    for c, v in zip(stencil_vals[1:], _neighbours(u)):
        term = (c * dinv) * v
        off = term if off is None else off + term
    out = u + om * (dinv * b - u - off)
    return out if mask is None else torch.where(mask, out, u)


def _rb_sweep(u, b, om, stencil_vals):
    red, black = red_black_masks(tuple(u.shape), device=u.device,
                                 dtype=torch.bool)
    for mask in (red, black):
        u = _half_sweep(u, b, om, mask, stencil_vals)
    return u


def _residual(u, b, stencil_vals):
    au = stencil_vals[0] * u
    for c, v in zip(stencil_vals[1:], _neighbours(u)):
        au = au + c * v
    return b - au


def downleg_wavefront_3d_plain(u, b, omegas, omega_ids, stencil_vals, taps):
    """Plain version of :func:`downleg_wavefront_3d`."""
    for i in omega_ids:
        u = _rb_sweep(u, b, omegas[i], stencil_vals)
    rc = _residual(u, b, stencil_vals)
    for axis in range(3):
        rc = axis_restrict_3tap(rc, axis, taps[axis])
    return u, rc


def upleg_wavefront_3d_plain(u, e, b, omegas, omega_ids, stencil_vals,
                             taps):
    """Plain version of :func:`upleg_wavefront_3d`."""
    corr = e
    for axis in range(3):
        corr = axis_prolong_3tap(corr, axis, taps[axis], u.shape[axis])
    u = u + omegas[omega_ids[0]] * corr
    return _rb_sweep(u, b, omegas[omega_ids[1]], stencil_vals)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_leg(u, b, omegas, omega_ids, extra=()):
    """Shape and index checks shared by both devices; returns the ids."""
    tensors = (u, b, omegas) + tuple(extra)
    if any(t.device != u.device for t in tensors):
        raise ValueError("leg tensors lie on different devices")
    if u.ndim != 3 or b.shape != u.shape:
        raise ValueError(f"u {tuple(u.shape)} and b {tuple(b.shape)} must be "
                         "equal 3D shapes")
    if any(n < 3 or n % 2 == 0 for n in u.shape):
        raise ValueError(f"grid {tuple(u.shape)} must be odd on every axis")
    if omegas.ndim != 1:
        raise ValueError("omegas must be a 1-D relaxation-factor vector")
    ids = tuple(int(i) for i in omega_ids)
    if len(ids) != 2:
        raise ValueError(f"the 3D legs take 2 omega ids, got {len(ids)}")
    if any(not 0 <= i < omegas.shape[0] for i in ids):
        raise IndexError(f"omega ids {ids} outside a vector of "
                         f"{omegas.shape[0]}")
    return ids


def _coefficients(stencil_vals, taps):
    vals = [float(v) for v in stencil_vals] + \
        [float(t) for axis in taps for t in axis]
    if len(vals) != 16:
        raise ValueError("need 7 stencil values and 3 taps per axis")
    return (ctypes.c_double * 16)(*vals)


def downleg_wavefront_3d(u: torch.Tensor, b: torch.Tensor,
                         omegas: torch.Tensor, omega_ids: Sequence[int],
                         stencil_vals, taps):
    """Down-leg: two damped red-black sweeps of the constant 7-point
    operator ``stencil_vals`` with factors ``omegas[omega_ids[0]]`` (the
    first sweep applied) and ``omegas[omega_ids[1]]``; then ``r = b - A u``
    and its full 3D restriction with the per-axis 3-tap triples ``taps``.
    Returns ``(u_s (n0, n1, n2), rc ((n0-1)/2, (n1-1)/2, (n2-1)/2))``."""
    ids = _check_leg(u, b, omegas, omega_ids)
    if not _build.on_card(u):
        return downleg_wavefront_3d_plain(u, b, omegas, ids, stencil_vals,
                                          taps)
    _build.check_card_tensors(u, b, omegas)
    n0, n1, n2 = u.shape
    u_out = torch.empty_like(u)
    rc = u.new_empty(((n0 - 1) // 2, (n1 - 1) // 2, (n2 - 1) // 2))
    _build.launch(launches, "downleg_wavefront_3d", "es_downleg_wavefront_3d",
                  u.device, u.data_ptr(), b.data_ptr(), omegas.data_ptr(),
                  (ctypes.c_int * 2)(*ids), _coefficients(stencil_vals, taps),
                  u_out.data_ptr(), rc.data_ptr(), n0, n1, n2)
    return u_out, rc


def upleg_wavefront_3d(u: torch.Tensor, e: torch.Tensor, b: torch.Tensor,
                       omegas: torch.Tensor, omega_ids: Sequence[int],
                       stencil_vals, taps):
    """Up-leg: ``u + omegas[omega_ids[0]] * P(e)`` with the full 1:2
    trilinear-type prolongation of the coarse correction ``e`` by the
    per-axis 3-tap triples ``taps``, then one red-black sweep with factor
    ``omegas[omega_ids[1]]``."""
    ids = _check_leg(u, b, omegas, omega_ids, (e,))
    if tuple(e.shape) != tuple((n - 1) // 2 for n in u.shape):
        raise ValueError(f"coarse correction {tuple(e.shape)} does not "
                         f"match the grid {tuple(u.shape)}")
    if not _build.on_card(u):
        return upleg_wavefront_3d_plain(u, e, b, omegas, ids, stencil_vals,
                                        taps)
    _build.check_card_tensors(u, e, b, omegas)
    n0, n1, n2 = u.shape
    u_out = torch.empty_like(u)
    _build.launch(launches, "upleg_wavefront_3d", "es_upleg_wavefront_3d",
                  u.device, u.data_ptr(), e.data_ptr(), b.data_ptr(),
                  omegas.data_ptr(), (ctypes.c_int * 2)(*ids),
                  _coefficients(stencil_vals, taps), u_out.data_ptr(), n0,
                  n1, n2)
    return u_out
