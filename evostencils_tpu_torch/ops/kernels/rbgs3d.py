"""Standalone smoother sweeps of a constant 7-point 3D operator
(counterpart of evostencils_tpu/ops/pallas/rbgs3d.py ``fused_rbgs_sweep_3d``
and ``jacobi_sweep_3d``).

They serve the smoother cycles of 3D cycles that no fused wavefront leg
takes (compiler/lower.py ``_try_fused_smoother``), on the levels of the
JAX gate: 127^3 and 63^3 of a 255^3 hierarchy; ``leg3d`` takes 255^3 and
up.  Each sweep has, in this module, as in ``rbgs.py``:

* its wrapper: a CUDA tensor launches ``es_sweep3d`` from
  ``csrc/sweep3d.cu`` (float32, contiguous) or raises; a CPU tensor takes
  the plain version; any other device raises;
* its plain PyTorch version (``*_plain``), which repeats
  ``_fused_rb3d_kernel``'s arithmetic in its order (rbgs3d.py:113-138):
  ``u + where(mask, omega * (dinv * b - u - off), 0)`` with
  ``off = ((((dxm*xm + dxp*xp) + dym*ym) + dyp*yp) + dzm*zm) + dzp*zp`` and
  ``d_k = c_k * dinv`` folded on the host in double;
* its count in ``launches``, which only a kernel launch increments.

The 7-point operator is ``stencil_vals`` = (center, -x, +x, -y, +y, -z,
+z), the order of :data:`SEVEN_OFFSETS`.  Red is an ODD sum of interior
indices in 3D (rbgs3d.py:106-107).  The relaxation factor is
``omegas[omega_id]``, read on the device.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .wavefront3d import _half_sweep, _rb_sweep, chunk_rule, pipeline_info

#: offsets of a 7-point star, in the value order of seven_point_values
#: (rbgs3d.py:30-31)
SEVEN_OFFSETS = [(0, 0, 0), (-1, 0, 0), (1, 0, 0),
                 (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1)]

#: the JAX gate's scoped-VMEM budget model (rbgs3d.py:33-44): the level set
#: it admits is this kernel's, though Hopper has no such budget
_VMEM_BUDGET = 15 * 2 ** 20
_LIVE_WINDOWS = 8
_BLOCK_COPIES = 6
#: the gate reckons a plane at 4 bytes a value whatever the dtype, so the
#: CPU's float64 runs take the levels the card's float32 runs take
_GATE_ITEMSIZE = 4

#: The red-black kernel's block schedule (csrc/sweep3d.cu
#: ``rb_sweep3d_kernel``, which ``leg3d``'s red-black sweep launches too;
#: es_sweep3d_info reports it from the card, and
#: tests/test_torch_wavefront_tiles.py emulates it): the plane pipeline of
#: ``wavefront3d`` with one sweep.  A block owns an RB_TILE x RB_TILE tile
#: and a window RB_HALO = (before, after) cells wider (RB_HALO_NEEDED is
#: what the schedule needs; the window has one cell more after the tile,
#: for odd rows), and walks a chunk of axis 0 (``rb_chunk_planes``) with
#: RB_WARMUP planes loaded past each end; at step s red runs on plane s - 1
#: on the cells at distance >= 1 from the window edge, black on plane
#: s - 1 - LAG on those at distance >= 2.
RB_TILE = 32
RB_HALO = (2, 3)
RB_HALO_NEEDED = (2, 2)
RB_WARMUP = 2
RB_MIN_CHUNK = 2
RB_BLOCKS_PER_SM = 2
RB_THREADS = 685

#: kernel launches per kernel since the last reset_launches()
launches = {"fused_rbgs_sweep_3d": 0, "jacobi_sweep_3d": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def seven_point_values(stencil) -> Optional[Tuple[float, ...]]:
    """(center, -x, +x, -y, +y, -z, +z) of a constant 7-point 3D stencil,
    or None for any other shape (rbgs3d.py:47-55)."""
    entries = dict(stencil.entries)
    if set(entries) - set(SEVEN_OFFSETS):
        return None
    if any(isinstance(v, complex) for v in entries.values()):
        return None
    return tuple(float(entries.get(o, 0.0)) for o in SEVEN_OFFSETS)


def rb_chunk_planes(n0: int, n1: int, n2: int, sms: int) -> int:
    """Axis-0 planes per block of the red-black kernel on an (n0, n1, n2)
    grid and a card of ``sms`` SMs (``wavefront3d.chunk_rule``)."""
    return chunk_rule(n0, n1, n2, RB_TILE, RB_BLOCKS_PER_SM, RB_MIN_CHUNK,
                      sms)


def sweep_info() -> dict:
    """What the card makes of the red-black kernel: the 11 values of
    ``wavefront3d.INFO_KEYS``.  Needs the card."""
    return pipeline_info("es_sweep3d_info", "3D red-black sweep")


def _max_block_planes(plane_bytes: int) -> int:
    b = (_VMEM_BUDGET // max(plane_bytes, 1) - 4 * _LIVE_WINDOWS) \
        // (_LIVE_WINDOWS + _BLOCK_COPIES)
    return b - (b % 2)


def supports(u: torch.Tensor, stencil_vals) -> bool:
    """Whether a level runs these sweeps: the JAX gate's shape test
    (rbgs3d.py:58-70), at least 4 planes, 8 rows and 63 lanes and room for
    4 planes of the (8, 128)-padded plane in the budget, for a 7-point
    stencil; and float32 when u lies on a CUDA device (the plain versions
    on the CPU take any float type); bfloat16, which the JAX gate admits,
    raises NotImplementedError.  At 255^3 that admits 127^3 and 63^3, not
    255^3."""
    if u.ndim != 3 or stencil_vals is None:
        return False
    n0, n1, n2 = u.shape
    plane_bytes = (-(-n1 // 8) * 8) * (-(-n2 // 128) * 128) * _GATE_ITEMSIZE
    if not (n0 >= 4 and n1 >= 8 and n2 >= 63
            and _max_block_planes(plane_bytes) >= 4):
        return False
    _build.refuse_bf16(u, "row 18 (fused_rbgs_sweep_3d, jacobi_sweep_3d)",
                       "rbgs3d.py:67")
    return u.device.type == "cpu" or u.dtype == torch.float32


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def fused_rbgs_sweep_3d_plain(u, b, omegas, omega_id, stencil_vals):
    """Plain version of :func:`fused_rbgs_sweep_3d`: the red half-sweep,
    then the black one with the new red values."""
    return _rb_sweep(u, b, omegas[omega_id], stencil_vals)


def jacobi_sweep_3d_plain(u, b, omegas, omega_id, stencil_vals):
    """Plain version of :func:`jacobi_sweep_3d`: every point from the old
    u."""
    return _half_sweep(u, b, omegas[omega_id], None, stencil_vals)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_sweep(u, b, omegas, omega_id, stencil_vals):
    if any(t.device != u.device for t in (b, omegas)):
        raise ValueError("sweep tensors lie on different devices")
    if u.ndim != 3 or b.shape != u.shape:
        raise ValueError(f"u {tuple(u.shape)} and b {tuple(b.shape)} must be "
                         "equal 3D shapes")
    if len(stencil_vals) != 7 or float(stencil_vals[0]) == 0.0:
        raise ValueError("need 7 stencil values with a nonzero center")
    if omegas.ndim != 1:
        raise ValueError("omegas must be a 1-D relaxation-factor vector")
    if not 0 <= int(omega_id) < omegas.shape[0]:
        raise IndexError(f"omega id {omega_id} outside a vector of "
                         f"{omegas.shape[0]}")
    return int(omega_id)


def sweep3d(counts, name, plain, u, b, omegas, omega_id, stencil_vals,
            red_black: bool):
    """One sweep of ``es_sweep3d``, counted as ``counts[name]``: a
    red-black sweep (red, then black with the new red values) or a damped
    Jacobi sweep, ``u + omega * (dinv * b - u - sum_k (c_k * dinv) u_k)``
    at the updated points; ``plain`` on the CPU.  ``leg3d`` launches the
    same kernel under its own names."""
    omega_id = _check_sweep(u, b, omegas, omega_id, stencil_vals)
    if not _build.on_card(u):
        return plain(u, b, omegas, omega_id, stencil_vals)
    _build.check_card_tensors(u, b, omegas)
    out = torch.empty_like(u)
    n0, n1, n2 = u.shape
    _build.launch(counts, name, "es_sweep3d", u.device, u.data_ptr(),
                  b.data_ptr(), omegas.data_ptr(), omega_id, int(red_black),
                  (ctypes.c_double * 7)(*(float(v) for v in stencil_vals)),
                  out.data_ptr(), n0, n1, n2)
    return out


def fused_rbgs_sweep_3d(u: torch.Tensor, b: torch.Tensor,
                        omegas: torch.Tensor, omega_id: int, stencil_vals):
    """One red-black sweep of the constant 7-point operator in one pass
    over u and b."""
    return sweep3d(launches, "fused_rbgs_sweep_3d", fused_rbgs_sweep_3d_plain,
                   u, b, omegas, omega_id, stencil_vals, True)


def jacobi_sweep_3d(u: torch.Tensor, b: torch.Tensor, omegas: torch.Tensor,
                    omega_id: int, stencil_vals):
    """One damped Jacobi sweep of the constant 7-point operator."""
    return sweep3d(launches, "jacobi_sweep_3d", jacobi_sweep_3d_plain, u, b,
                   omegas, omega_id, stencil_vals, False)
