"""Intergrid transfer operators with weights given as tensors (counterpart
of evostencils_tpu/ops/transfer_weights.py:36-66).

The reference tunes restriction/prolongation stencil weights with CMA-ES by
rewriting ``Global_initGlobals.cpp`` and recompiling the generated C++ for
every candidate (reference optimization/intergrid_transfer.py:114-121).
Here the weights are tensors with a leading batch axis, one member per CMA
candidate: a whole CMA generation is one grouped convolution
(``conv2d``/``conv3d`` with ``groups`` = the batch), as the JAX package
computes each member with an XLA convolution under ``vmap``.

Conventions match ops/apply.py: coarse node ``i_c`` sits at fine node
``2*i_c + 1`` (vertex-centered interior grids of size 2^l - 1), restriction
is stencil-correlation followed by injection at odd fine nodes, prolongation
is scatter-to-odd-nodes followed by stencil application.  Out-of-range fine
nodes are Dirichlet zeros.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _grouped_conv(u, weights, stride, padding):
    """Member ``k`` of ``u`` (B, *shape) correlated with member ``k`` of
    ``weights`` (B, *kernel): one grouped convolution, batch as channels."""
    batch = u.shape[0]
    out = _CONV[u.ndim - 1](u.unsqueeze(0), weights.unsqueeze(1),
                            stride=stride, padding=padding, groups=batch)
    return out[0]


def _radius(weights):
    r = tuple((s - 1) // 2 for s in weights.shape[1:])
    if any(rk < 1 for rk in r):
        raise ValueError("weight kernel must have radius >= 1")
    return r


def restrict_weighted(u_fine: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """Restriction with a ``(B, *(2r+1,)*d)`` batch of weight kernels of
    a ``(B, *fine_shape)`` batch of fields.

    ``out[k, i] = sum_o weights[k, o + r] * u_fine[k, 2 i + 1 + o]`` — the
    weighted average of the fine neighborhood centered on the coarse
    node's fine position, zero outside the grid.
    """
    # correlation: out[i] = sum_j W[j] u[2i + j - lo]; want
    # u[2i + 1 + (j - r)] => lo = r - 1 per axis
    padding = tuple(rk - 1 for rk in _radius(weights))
    return _grouped_conv(u_fine, weights.to(u_fine.dtype), 2, padding)


def prolong_weighted(u_coarse: torch.Tensor, weights: torch.Tensor,
                     fine_shape: Tuple[int, ...]) -> torch.Tensor:
    """Prolongation with a ``(B, *(2r+1,)*d)`` batch of weight kernels of
    a ``(B, *coarse_shape)`` batch of fields.

    Coarse values are scattered onto odd fine nodes and each member's
    kernel applied on the fine grid (transpose pairing of
    :func:`restrict_weighted` up to kernel reflection).
    """
    r = _radius(weights)
    dtype = torch.promote_types(u_coarse.dtype, weights.dtype)
    embedded = u_coarse.new_zeros((u_coarse.shape[0],) + tuple(fine_shape),
                                  dtype=dtype)
    index = (slice(None),) + (slice(1, None, 2),) * (u_coarse.ndim - 1)
    embedded[index] = u_coarse.to(dtype)
    return _grouped_conv(embedded, weights.to(dtype), 1, r)
