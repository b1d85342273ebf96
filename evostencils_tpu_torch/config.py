"""Configuration of the port (counterpart of evostencils_tpu/config.py:32-127).

Only what the ported path reads is kept, as constants:

* ``DIRECT_SOLVE_MAX`` is ``Config.direct_solve_max``.
* The kernel gate's grid sizes live beside the kernels
  (``ops/kernels/transfer.supports``).

Not carried over:

* ``use_pallas_kernels``: a leg runs its CUDA kernel when its tensors lie
  on a CUDA device and its plain PyTorch version when they lie on the CPU.
* ``fused_column_transfers``: the legs always carry both transfer axes.
* ``loop_fusion``: the fused cycle loop waits for ``upleg_downleg_col``.
* ``shard_map_mesh``, ``shard_min_local_size``: distribution comes later.
* ``nonlinear_cgs_sweeps``, ``nonlinear_cgs_omega``: FAS comes later.
* ``column_transfers``, ``banded_transfers``, ``combined_rb``,
  ``wavefront_downleg_block``: TPU layout workarounds and TPU A/B knobs.
"""

from __future__ import annotations

import torch

#: maximum unknowns of the dense coarsest-grid inverse
DIRECT_SOLVE_MAX = 4096


def setup_device(device="cuda") -> torch.device:
    """Return ``torch.device(device)`` after fixing the float32 numerics
    the port relies on: TF32 off for matrix products and for cuDNN, so the
    dense coarse solve and any convolution run in full float32."""
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was requested but CUDA is not "
                           "available")
    return device
