"""The 3D sweeps of the large levels and the standalone 3D transfers
(counterpart of evostencils_tpu/ops/pallas/leg3d.py
``fused_rbgs_sweep_3d2``, ``jacobi_sweep_3d2``, ``residual_restrict_3d``
and ``prolong_correct_3d``).

The TPU has two sweep kernels because whole planes of 255^3 and up do not
fit the plane-blocked kernel's VMEM budget (``rbgs3d``); the two-axis
blocked one here computes the same function in the same order
(leg3d.py:156-165).  On the card both launch ``es_sweep3d`` from
``csrc/sweep3d.cu``; the sweeps of this module count under their own
names, so a run shows which JAX gate's levels it went through.  The
transfers launch ``es_residual_restrict_3d`` and ``es_prolong_correct_3d``
from ``csrc/leg3d.cu``, one kernel over all three axes each: the plane
pipeline of the 3D legs (``csrc/pipeline3d.cuh``), the down-leg's tail with
no sweep and the up-leg's prolongation with no sweep.

Each kernel has its wrapper (a CUDA tensor launches it or raises, a CPU
tensor takes the plain version, any other device raises), its plain
PyTorch version (``*_plain``) and its count in ``launches``, which only a
kernel launch increments.  The plain transfers follow the TPU kernels'
axis order:

* the residual summed left to right, ``cc*u + cxm*xm + ... + czp*zp``
  (leg3d.py:125-131), then the restriction on axis 0, then axis 1, then
  axis 2 (leg3d.py:237-260);
* the prolongation on axis 0, then axis 1, then axis 2, then
  ``u + omega * corr`` (leg3d.py:313-340).

The axis-2 matrices of the TPU kernels (``restrict_lane_matrix``,
``prolong_lane_matrices``) are a layout device of the TPU's matrix unit and
have no counterpart here.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..apply import axis_prolong_3tap, axis_restrict_3tap
from . import _build
from . import rbgs3d
from .wavefront3d import _residual, chunk_rule, pipeline_info

#: kernel gate: the JAX gate's level set (leg3d.py:396-399): 2 * 8 + 1
#: planes, 2 * 8 + 1 rows, 63 lanes, odd on every axis
MIN_PLANES = 17
MIN_ROWS = 17
MIN_LANES = 63

#: The residual restriction's block schedule (csrc/leg3d.cu
#: ``residual_restrict3d_kernel``; es_residual_restrict_3d_info reports it
#: from the card, and tests/test_torch_wavefront_tiles.py emulates it): the
#: plane pipeline of ``wavefront3d``'s down-leg with no sweep.  A block owns
#: an RR_TILE x RR_TILE tile of fine points (even starts, so that every
#: coarse point's window lies in one block) and a window RR_HALO =
#: (before, after) cells wider: the residual is formed on the tile and one
#: more row and column, and needs u one cell further out.  It walks a chunk
#: of axis 0 (``rr_chunk_planes``) with RR_WARMUP planes loaded past each
#: end; at step s the residual of plane s - 1 joins the restriction.
RR_TILE = 32
RR_HALO = (1, 2)
RR_WARMUP = 1
RR_MIN_CHUNK = 2
RR_BLOCKS_PER_SM = 2
RR_THREADS = 613

#: The prolongation-correction's block schedule (csrc/leg3d.cu
#: ``prolong_correct3d_kernel``; es_prolong_correct_3d_info reports it,
#: and tests/test_torch_wavefront_tiles.py emulates it): the plane pipeline
#: of ``wavefront3d``'s up-leg with no sweep.  A block owns a PC_TILE x
#: PC_TILE tile of fine points (even starts) and, the prolongation being
#: pointwise, no halo and no warm-up (PC_HALO, PC_WARMUP); it stages e's
#: coarse window of PC_TILE / 2 + 1 cells a side from coarse index y0/2 - 1
#: on, a coarse plane at a time, and walks a chunk of axis 0
#: (``pc_chunk_planes``), forming the axis-0 pass of fine plane s + 1 at
#: step s.  PC_THREADS threads, each owning PC_TILE^2 / PC_THREADS cells of
#: one column; PC_BLOCKS_PER_SM are resident, and the chunks fill a wave of
#: PC_WAVE blocks an SM (longer chunks than a wave of 3 would give, faster
#: at 127^3).
PC_TILE = 32
PC_HALO = (0, 0)
PC_WARMUP = 0
PC_MIN_CHUNK = 2
PC_BLOCKS_PER_SM = 3
PC_WAVE = 2
PC_THREADS = 512

#: kernel launches per kernel since the last reset_launches()
launches = {"fused_rbgs_sweep_3d2": 0, "jacobi_sweep_3d2": 0,
            "residual_restrict_3d": 0, "prolong_correct_3d": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def rr_chunk_planes(n0: int, n1: int, n2: int, sms: int) -> int:
    """Fine axis-0 planes per block of the residual restriction on an (n0,
    n1, n2) grid and a card of ``sms`` SMs (``wavefront3d.chunk_rule``)."""
    return chunk_rule(n0, n1, n2, RR_TILE, RR_BLOCKS_PER_SM, RR_MIN_CHUNK,
                      sms)


def restrict_info() -> dict:
    """What the card makes of the residual restriction's kernel: the 11
    values of ``wavefront3d.INFO_KEYS``.  Needs the card."""
    return pipeline_info("es_residual_restrict_3d_info",
                         "3D residual restriction")


def pc_chunk_planes(n0: int, n1: int, n2: int, sms: int) -> int:
    """Fine axis-0 planes per block of the prolongation-correction
    (``wavefront3d.chunk_rule``)."""
    return chunk_rule(n0, n1, n2, PC_TILE, PC_WAVE, PC_MIN_CHUNK, sms)


def prolong_info() -> dict:
    """What the card makes of the prolongation-correction's kernel, as
    :func:`restrict_info`.  Needs the card."""
    return pipeline_info("es_prolong_correct_3d_info",
                         "3D prolongation-correction")


def seven_taps(r_fac, p_fac) -> Optional[Tuple]:
    """Per-axis 3-tap triples of separable 3D transfer factorizations
    (``ops.apply.separable_factors`` output), else None (leg3d.py:380-393)."""
    out = []
    for vectors, radii in (r_fac, p_fac):
        if len(vectors) != 3 or any(r != 1 for r in radii):
            return None
        triple = []
        for v in vectors:
            if len(v) != 3 or any(isinstance(x, complex) for x in v):
                return None
            triple.append(tuple(float(x) for x in v))
        out.append(tuple(triple))
    return tuple(out)


def supports(u: torch.Tensor) -> bool:
    """Whether a level runs these kernels: a 3D grid, odd on every axis,
    with at least 17 planes, 17 rows and 63 lanes, and float32 when it
    lies on a CUDA device (the plain versions on the CPU take any float
    type); bfloat16, which the JAX gate admits, raises
    NotImplementedError.  At 255^3 that admits 255^3, 127^3 and 63^3."""
    if u.ndim != 3:
        return False
    n0, n1, n2 = u.shape
    if not (n0 >= MIN_PLANES and n1 >= MIN_ROWS and n2 >= MIN_LANES
            and all(n % 2 == 1 for n in u.shape)):
        return False
    _build.refuse_bf16(u, "rows 19-21 (fused_rbgs_sweep_3d2, "
                       "jacobi_sweep_3d2, residual_restrict_3d, "
                       "prolong_correct_3d)", "leg3d.py:397")
    return u.device.type == "cpu" or u.dtype == torch.float32


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def fused_rbgs_sweep_3d2_plain(u, b, omegas, omega_id, stencil_vals):
    """Plain version of :func:`fused_rbgs_sweep_3d2`."""
    return rbgs3d.fused_rbgs_sweep_3d_plain(u, b, omegas, omega_id,
                                            stencil_vals)


def jacobi_sweep_3d2_plain(u, b, omegas, omega_id, stencil_vals):
    """Plain version of :func:`jacobi_sweep_3d2`."""
    return rbgs3d.jacobi_sweep_3d_plain(u, b, omegas, omega_id, stencil_vals)


def residual_restrict_3d_plain(u, b, stencil_vals, taps):
    """Plain version of :func:`residual_restrict_3d`."""
    r = _residual(u, b, stencil_vals)
    for axis in range(3):
        r = axis_restrict_3tap(r, axis, taps[axis])
    return r


def prolong_correct_3d_plain(u, e, omegas, omega_id, taps):
    """Plain version of :func:`prolong_correct_3d`."""
    corr = e
    for axis in range(3):
        corr = axis_prolong_3tap(corr, axis, taps[axis], u.shape[axis])
    return u + omegas[omega_id] * corr


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def fused_rbgs_sweep_3d2(u: torch.Tensor, b: torch.Tensor,
                         omegas: torch.Tensor, omega_id: int, stencil_vals):
    """One red-black sweep of the constant 7-point operator, as
    ``rbgs3d.fused_rbgs_sweep_3d`` computes it."""
    return rbgs3d.sweep3d(launches, "fused_rbgs_sweep_3d2",
                          fused_rbgs_sweep_3d2_plain, u, b, omegas, omega_id,
                          stencil_vals, True)


def jacobi_sweep_3d2(u: torch.Tensor, b: torch.Tensor, omegas: torch.Tensor,
                     omega_id: int, stencil_vals):
    """One damped Jacobi sweep, as ``rbgs3d.jacobi_sweep_3d`` computes
    it."""
    return rbgs3d.sweep3d(launches, "jacobi_sweep_3d2", jacobi_sweep_3d2_plain,
                          u, b, omegas, omega_id, stencil_vals, False)


def _check_transfer(u, others, coarse):
    if any(t.device != u.device for t in others):
        raise ValueError("transfer tensors lie on different devices")
    if u.ndim != 3 or any(n < 3 or n % 2 == 0 for n in u.shape):
        raise ValueError(f"grid {tuple(u.shape)} must be 3D and odd on every "
                         "axis")
    if coarse is not None and \
            tuple(coarse.shape) != tuple((n - 1) // 2 for n in u.shape):
        raise ValueError(f"coarse correction {tuple(coarse.shape)} does not "
                         f"match the grid {tuple(u.shape)}")


def _coefficients(stencil_vals, taps):
    vals = [float(v) for v in stencil_vals] + \
        [float(t) for axis in taps for t in axis]
    if len(vals) != 16:
        raise ValueError("need 7 stencil values and 3 taps per axis")
    return (ctypes.c_double * 16)(*vals)


def residual_restrict_3d(u: torch.Tensor, b: torch.Tensor, stencil_vals,
                         taps):
    """``R (b - A u)``: the residual of the constant 7-point operator
    ``stencil_vals`` and its full 2:1 restriction with the per-axis 3-tap
    triples ``taps``; returns ``rc ((n0-1)/2, (n1-1)/2, (n2-1)/2)``."""
    _check_transfer(u, (b,), None)
    if b.shape != u.shape:
        raise ValueError(f"u {tuple(u.shape)} and b {tuple(b.shape)} differ")
    if not _build.on_card(u):
        return residual_restrict_3d_plain(u, b, stencil_vals, taps)
    _build.check_card_tensors(u, b)
    n0, n1, n2 = u.shape
    rc = u.new_empty(((n0 - 1) // 2, (n1 - 1) // 2, (n2 - 1) // 2))
    _build.launch(launches, "residual_restrict_3d", "es_residual_restrict_3d",
                  u.device, u.data_ptr(), b.data_ptr(),
                  _coefficients(stencil_vals, taps), rc.data_ptr(), n0, n1,
                  n2)
    return rc


def prolong_correct_3d(u: torch.Tensor, e: torch.Tensor,
                       omegas: torch.Tensor, omega_id: int, taps):
    """``u + omegas[omega_id] * P(e)`` with the full 1:2 prolongation of the
    coarse correction ``e`` ((n0-1)/2, (n1-1)/2, (n2-1)/2) by the per-axis
    3-tap triples ``taps``."""
    _check_transfer(u, (e, omegas), e)
    if omegas.ndim != 1:
        raise ValueError("omegas must be a 1-D relaxation-factor vector")
    if not 0 <= int(omega_id) < omegas.shape[0]:
        raise IndexError(f"omega id {omega_id} outside a vector of "
                         f"{omegas.shape[0]}")
    if not _build.on_card(u):
        return prolong_correct_3d_plain(u, e, omegas, int(omega_id), taps)
    _build.check_card_tensors(u, e, omegas)
    u_out = torch.empty_like(u)
    n0, n1, n2 = u.shape
    # the kernel reads only the taps of the coefficient block
    _build.launch(launches, "prolong_correct_3d", "es_prolong_correct_3d",
                  u.device, u.data_ptr(), e.data_ptr(), omegas.data_ptr(),
                  int(omega_id), _coefficients((1.0,) + (0.0,) * 6, taps),
                  u_out.data_ptr(), n0, n1, n2)
    return u_out
