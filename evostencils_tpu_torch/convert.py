"""Solver state carried across from the JAX package.

The JAX package's grid functions (tuples of arrays, one per field) and its
relaxation-factor vector (``LoweredCycle.default_omegas``) play the role
that weights play for a model: the tests hand the same numpy arrays to
both packages through this module.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def _tensor(a, device, dtype) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def state_from_numpy(u_fields: Sequence, b_fields: Sequence, omegas, *,
                     device, dtype) -> Tuple[tuple, tuple, torch.Tensor]:
    """``(u_fields, b_fields, omegas)`` as tensors on ``device`` in
    ``dtype``; every array is copied."""
    return (tuple(_tensor(u, device, dtype) for u in u_fields),
            tuple(_tensor(b, device, dtype) for b in b_fields),
            _tensor(omegas, device, dtype))
