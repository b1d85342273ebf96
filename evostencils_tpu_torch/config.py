"""Configuration of the port (counterpart of evostencils_tpu/config.py:32-127).

What the ported path reads:

* ``DIRECT_SOLVE_MAX`` is ``Config.direct_solve_max``.
* ``config.loop_fusion`` (default off): ``compiler/solve.make_cycle_loop``
  fuses the finest level's up-leg of cycle k with the down-leg of cycle
  k+1 into one pass (``ops/kernels/transfer.upleg_downleg_col`` or, with
  row-only legs, ``upleg_downleg_fused``).
* ``config.fused_column_transfers`` (default None, which is on; see
  :func:`fused_cols_enabled`): off, the constant 5-point legs run their
  row-only forms with the column transfers in plain torch, and the
  variable-coefficient and system legs are refused, so their levels run
  the generic lowering.
* The kernel gate's grid sizes live beside the kernels
  (``ops/kernels/transfer.supports``).

Both switches are read when a step or a cycle loop runs, not when the
cycle is lowered.

Not carried over:

* ``use_pallas_kernels``: a leg runs its CUDA kernel when its tensors lie
  on a CUDA device and its plain PyTorch version when they lie on the CPU.
* ``shard_map_mesh``, ``shard_min_local_size``: distribution comes later.
* ``nonlinear_cgs_sweeps``, ``nonlinear_cgs_omega``: the JAX lowering
  reads its own constants instead (lower.py:1791-1792), and so does the
  port's (``compiler.lower.NONLINEAR_CGS_SWEEPS``, ``_OMEGA``).
* ``column_transfers``, ``banded_transfers``, ``combined_rb``,
  ``wavefront_downleg_block``: TPU layout workarounds and TPU A/B knobs.
  The row-only legs' column halves are the ``banded`` form, which is what
  the JAX package runs off the TPU.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch

#: maximum unknowns of the dense coarsest-grid inverse
DIRECT_SOLVE_MAX = 4096


@dataclass
class Config:
    #: fuse column (axis-1) transfers into the 2D leg kernels; None = on
    fused_column_transfers: Optional[bool] = None
    #: fuse the finest-level up-leg of cycle k with the down-leg of cycle
    #: k+1 inside make_cycle_loop
    loop_fusion: bool = False


config = Config()


def fused_cols_enabled() -> bool:
    if config.fused_column_transfers is not None:
        return config.fused_column_transfers
    return True


def setup_device(device="cuda") -> torch.device:
    """Return ``torch.device(device)`` after fixing the float32 numerics
    the port relies on: TF32 off for matrix products and for cuDNN, so the
    dense coarse solve and any convolution run in full float32.

    ``"cuda"`` with no index picks this process's card,
    ``cuda:{LOCAL_RANK % device_count()}`` (``LOCAL_RANK`` as ``torchrun``
    sets it, 0 without), and makes it the current device: the ranks of a
    multi-process run spread over the cards, and on a one-card machine
    they all share ``cuda:0``."""
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was requested but CUDA is not "
                           "available")
    if device.type == "cuda" and device.index is None:
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
        device = torch.device("cuda",
                              local_rank % torch.cuda.device_count())
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device
