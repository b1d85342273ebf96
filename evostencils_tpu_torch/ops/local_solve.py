"""Batched local (block) solves for collective block smoothers
(counterpart of evostencils_tpu/ops/local_solve.py).

The block structure is set up in numpy exactly as there
(``BlockSolvePlan.__init__`` and ``get_block_solve_plan`` are copies of
local_solve.py:36-119 and :162-173): one inverse per block, with phantom
unknowns outside the interior.  ``apply`` is plain PyTorch on the fields'
device and dtype (complex if the block inverses are: complex Helmholtz
block smoothers): zero padding into node space, a reshape into blocks and
one batched ``einsum``.  The JAX package leaves this to XLA, so it has no
kernel of its own.

Block convention: blocks tile the *node* index space ``[0, n+1]`` per axis
in chunks of the block size; interior point ``i`` is node ``i+1``
(ops.apply.LATTICE_ORIGIN).  Nodes outside the interior are phantom unknowns
with identity equations and zero coupling (Dirichlet).
"""

from __future__ import annotations

from functools import reduce
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..stencils.periodic import PeriodicStencil
from .apply import complex_dtype

_PLAN_CACHE: dict = {}


def _prod(xs):
    return reduce(lambda a, b: a * b, xs, 1)


class BlockSolvePlan:
    """Precomputed batched inverse for a block-diagonal system operator.

    ``entries[i][j]`` is the (already block-filtered) periodic stencil
    coupling field j into equation i; all fields share ``shape`` and
    ``block_size``.
    """

    def __init__(self, entries: List[List[PeriodicStencil]],
                 block_size: Tuple[int, ...], shape: Tuple[int, ...]):
        self.block_size = tuple(block_size)
        self.shape = tuple(shape)
        self.m = len(entries)
        bs = self.block_size
        n_local = self.m * _prod(bs)

        # padded node-space geometry
        nodes = tuple(n + 2 for n in shape)
        nblocks = tuple(-(-nn // b) for nn, b in zip(nodes, bs))
        padded = tuple(nb * b for nb, b in zip(nblocks, bs))
        self.nblocks = nblocks
        self.padded = padded
        NB = _prod(nblocks)

        # anchor node index per block per axis
        anchors = np.meshgrid(*[np.arange(nb) * b for nb, b in zip(nblocks, bs)],
                              indexing="ij")
        anchors = np.stack([a.reshape(-1) for a in anchors], axis=-1)  # (NB, d)

        local_coords = np.array(list(np.ndindex(*bs)))  # (B, d)

        def node_of(q):  # block anchor + local coord -> node index per axis
            return anchors[:, None, :] + q[None, :, :]

        node_idx = node_of(local_coords)  # (NB, B, d)
        interior = np.all((node_idx >= 1) & (node_idx <= np.array(shape)), axis=-1)
        # valid[NB, B] -> expand over fields
        self.valid = interior

        any_complex = any(
            isinstance(v, complex) or np.iscomplexobj(np.asarray(v))
            for row in entries for ps in row if ps is not None
            for s in ps.constant_entries() for _, v in s.entries)
        dtype = np.complex128 if any_complex else np.float64

        M = np.zeros((NB, n_local, n_local), dtype=dtype)
        for i in range(self.m):
            for j in range(self.m):
                ps = entries[i][j]
                if ps is None:
                    continue
                per = ps.period
                for qi, q in enumerate(local_coords):
                    # lattice coordinate of node (anchor + q):
                    # interior index = node - 1; lattice = (interior + ORIGIN) % per
                    lat = (node_idx[:, qi, :]) % np.array(per)  # (NB, d)
                    # gather stencil per block (may vary when per > bs)
                    flat_lat = np.ravel_multi_index(lat.T, per)
                    stencils_flat = ps.stencils.reshape(-1)
                    row_a = i * len(local_coords) + qi
                    for s_id in np.unique(flat_lat):
                        s = stencils_flat[s_id]
                        if s is None:
                            continue
                        sel = flat_lat == s_id
                        for offset, value in s.entries:
                            tgt = q + np.array(offset)
                            if np.any(tgt < 0) or np.any(tgt >= np.array(bs)):
                                continue  # block-external coupling is dropped
                            col_a = j * len(local_coords) + int(
                                np.ravel_multi_index(tuple(tgt), bs))
                            M[sel, row_a, col_a] += value

        # phantom unknowns: identity rows, zero columns
        valid_local = np.concatenate([interior] * self.m, axis=-1)  # (NB, m*B)
        for a in range(n_local):
            inval = ~valid_local[:, a]
            if inval.any():
                M[inval, a, :] = 0.0
                M[inval, :, a] = 0.0
                M[inval, a, a] = 1.0
        self.inverse = np.linalg.inv(M).reshape(*nblocks, n_local, n_local)
        self._on_device = {}

    def _inverse_on(self, device, dtype) -> torch.Tensor:
        """The block inverses as a ``dtype`` tensor on ``device``, kept per
        device and dtype so that each moves to the device once."""
        key = (str(device), dtype)
        if key not in self._on_device:
            self._on_device[key] = torch.as_tensor(self.inverse, dtype=dtype,
                                                   device=device)
        return self._on_device[key]

    def apply(self, fields: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """Solve the block systems: returns a tuple of field tensors
        (local_solve.py:121-159)."""
        bs, shape = self.block_size, self.shape
        dim = len(shape)
        B = _prod(bs)
        blocks = []
        for x in fields:
            # pad to node space then to block multiples (F.pad lists the
            # last axis first)
            pads = []
            for n, p in reversed(list(zip(shape, self.padded))):
                pads += [1, p - n - 1]
            xp = F.pad(x, pads)
            # reshape into (nb0, b0, nb1, b1, ...) -> (nb..., b...)
            new_shape = []
            for nb, b in zip(self.nblocks, bs):
                new_shape.extend([nb, b])
            xp = xp.reshape(new_shape)
            perm = list(range(0, 2 * dim, 2)) + list(range(1, 2 * dim, 2))
            blocks.append(xp.permute(perm).reshape(*self.nblocks, B))
        xb = torch.cat(blocks, dim=-1)  # (*nblocks, m*B)
        # the fields' dtype; complex inverses take the complex dtype of its
        # precision, complex64 for float32 fields (local_solve.py:140-145)
        if np.iscomplexobj(self.inverse):
            xb = xb.to(complex_dtype(xb.dtype))
        inv = self._inverse_on(xb.device, xb.dtype)
        yb = torch.einsum("...ab,...b->...a", inv, xb)
        outs = []
        for i in range(self.m):
            y = yb[..., i * B:(i + 1) * B]
            y = y.reshape(*self.nblocks, *bs)
            # inverse transpose back to interleaved layout
            perm = []
            for k in range(dim):
                perm.extend([k, dim + k])
            y = y.permute(perm).reshape(self.padded)
            index = tuple(slice(1, 1 + n) for n in shape)
            outs.append(y[index])
        return tuple(outs)


def get_block_solve_plan(entries, block_size, shape) -> BlockSolvePlan:
    key = (tuple(tuple(row) for row in entries), tuple(block_size), tuple(shape))
    try:
        plan = _PLAN_CACHE.get(key)
    except TypeError:
        plan = None
        key = None
    if plan is None:
        plan = BlockSolvePlan(entries, block_size, shape)
        if key is not None:
            _PLAN_CACHE[key] = plan
    return plan
