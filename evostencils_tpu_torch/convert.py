"""Solver state carried across from the JAX package.

The JAX package's grid functions (tuples of arrays, one per field) and its
relaxation-factor vector (``LoweredCycle.default_omegas``) play the role
that weights play for a model, as do the coefficient fields of a
variable-coefficient operator: the tests hand the same numpy arrays to
both packages through this module.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .ops.apply import StencilField


def _tensor(a, device, dtype) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def state_from_numpy(u_fields: Sequence, b_fields: Sequence, omegas, *,
                     device, dtype) -> Tuple[tuple, tuple, torch.Tensor]:
    """``(u_fields, b_fields, omegas)`` as tensors on ``device`` in
    ``dtype``; every array is copied."""
    return (tuple(_tensor(u, device, dtype) for u in u_fields),
            tuple(_tensor(b, device, dtype) for b in b_fields),
            _tensor(omegas, device, dtype))


def stencil_field_from_numpy(offsets, fields, *, device,
                             dtype) -> StencilField:
    """The port's ``StencilField`` of the JAX package's one (its
    ``offsets`` and numpy ``fields``, copied), with its device terms built
    on ``device`` in ``dtype``."""
    sf = StencilField(offsets, [np.array(f) for f in fields])
    sf.device_terms(torch.device(device), dtype)
    return sf


def stack_from_numpy(stack, *, device, dtype) -> torch.Tensor:
    """A (5, n, m) coefficient stack (``rbgs_var.five_point_stack`` of the
    JAX package, as numpy) as a tensor on ``device`` in ``dtype``."""
    stack = np.asarray(stack)
    if stack.ndim != 3 or stack.shape[0] != 5:
        raise ValueError(f"coefficient stack {stack.shape} is not (5, n, m)")
    return _tensor(stack, device, dtype)
