"""Copy of evostencils_tpu/stencils/periodic.py, kept in the port so that it imports
nothing of the JAX package.

Periodic (block-varying) stencil algebra.

A periodic stencil assigns a constant stencil to each point of a d-dimensional
period lattice; the operator coefficients repeat with the period over the
grid.  This models red-black partition filters (period 2), block smoothers
(period = block shape) and periodically varying coefficients.

Reference parity: evostencils/stencils/multiple.py, with two deliberate
upgrades:
  * storage is a numpy object array indexed by the period lattice (instead of
    nested tuples), and
  * composition ``mul`` is position-exact: coefficients of the right factor
    are sampled at the shifted lattice point ``(x + offset) mod period``
    rather than pointwise (multiple.py:183-184 approximates this).
"""

from __future__ import annotations

from functools import reduce
from math import lcm
from typing import Callable, Tuple

import numpy as np

from . import constant
from .constant import Stencil as ConstantStencil


class PeriodicStencil:
    """d-dimensional periodic array of constant stencils.

    ``stencils`` is a numpy object ndarray whose shape is the period; each
    element is a :class:`constant.Stencil` (or None for "no entry").
    """

    __slots__ = ("_stencils", "_dimension")

    def __init__(self, stencils, dimension: int | None = None):
        arr = np.empty(np.shape(stencils), dtype=object) if not isinstance(stencils, np.ndarray) else stencils
        if not isinstance(stencils, np.ndarray):
            flat_src = np.array(stencils, dtype=object).reshape(-1)
            arr = arr.reshape(-1)
            arr[:] = flat_src
            arr = arr.reshape(np.shape(stencils))
        if dimension is None:
            dimension = arr.ndim
        if arr.ndim != dimension:
            raise ValueError(f"period array rank {arr.ndim} != dimension {dimension}")
        self._stencils = arr
        self._dimension = dimension

    @property
    def stencils(self) -> np.ndarray:
        return self._stencils

    @property
    def period(self) -> Tuple[int, ...]:
        return self._stencils.shape

    @property
    def dimension(self) -> int:
        return self._dimension

    def __getitem__(self, index):
        return self._stencils[index]

    def constant_entries(self):
        """All non-None constant stencils in lattice order."""
        return [s for s in self._stencils.reshape(-1) if s is not None]

    @property
    def is_constant(self) -> bool:
        return self.period == (1,) * self.dimension

    def to_constant(self) -> ConstantStencil:
        if not self.is_constant:
            raise ValueError(f"period {self.period} stencil is not constant")
        s = self._stencils.reshape(-1)[0]
        return s if s is not None else constant.null(self.dimension)

    @property
    def max_offsets(self) -> Tuple[int, ...]:
        radii = (0,) * self.dimension
        for s in self.constant_entries():
            radii = tuple(max(a, b) for a, b in zip(radii, s.max_offsets))
        return radii

    def __eq__(self, other):
        return (isinstance(other, PeriodicStencil)
                and self.period == other.period
                and all(a == b for a, b in zip(self._stencils.reshape(-1),
                                               other._stencils.reshape(-1))))

    def __hash__(self):
        return hash((self.period, tuple(self._stencils.reshape(-1))))

    def __repr__(self):
        return f"PeriodicStencil(period={self.period}, dim={self.dimension})"


def from_constant(stencil: ConstantStencil) -> PeriodicStencil:
    arr = np.empty((1,) * stencil.dimension, dtype=object)
    arr.reshape(-1)[0] = stencil
    return PeriodicStencil(arr, stencil.dimension)


def as_periodic(stencil) -> PeriodicStencil:
    if stencil is None:
        return None
    if isinstance(stencil, ConstantStencil):
        return from_constant(stencil)
    return stencil


def _expand(ps: PeriodicStencil, period: Tuple[int, ...]) -> np.ndarray:
    """Tile the stencil array out to ``period`` (must be a multiple per axis)."""
    reps = tuple(p // q for p, q in zip(period, ps.period))
    return np.tile(ps.stencils, reps)


def _common_period(a: PeriodicStencil, b: PeriodicStencil) -> Tuple[int, ...]:
    return tuple(lcm(p, q) for p, q in zip(a.period, b.period))


def indexed_map(ps: PeriodicStencil, f: Callable) -> PeriodicStencil:
    """Apply ``f(stencil, lattice_index) -> stencil`` at every lattice point."""
    ps = as_periodic(ps)
    if ps is None:
        return None
    out = np.empty(ps.period, dtype=object)
    for idx in np.ndindex(*ps.period):
        out[idx] = f(ps.stencils[idx], idx)
    return PeriodicStencil(out, ps.dimension)


def map_stencil(ps: PeriodicStencil, f: Callable) -> PeriodicStencil:
    return indexed_map(ps, lambda s, _: None if s is None else f(s))


def combine(a, b, f: Callable) -> PeriodicStencil:
    """Lattice-pointwise combination over the LCM period."""
    a, b = as_periodic(a), as_periodic(b)
    if a is None or b is None:
        return None
    if a.dimension != b.dimension:
        raise ValueError("dimension mismatch")
    period = _common_period(a, b)
    ea, eb = _expand(a, period), _expand(b, period)
    out = np.empty(period, dtype=object)
    for idx in np.ndindex(*period):
        out[idx] = f(ea[idx], eb[idx])
    return PeriodicStencil(out, a.dimension)


def add(a, b) -> PeriodicStencil:
    return combine(a, b, constant.add)


def sub(a, b) -> PeriodicStencil:
    return combine(a, b, constant.sub)


def scale(factor, ps) -> PeriodicStencil:
    return map_stencil(as_periodic(ps), lambda s: constant.scale(factor, s))


def mul(a, b) -> PeriodicStencil:
    """Position-exact operator composition (A∘B).

    ((A∘B) u)(x) = sum_i a_i(x) * (B u)(x + i)
                 = sum_i sum_j a_i(x) * b_j((x + i) mod period) * u(x + i + j)
    """
    a, b = as_periodic(a), as_periodic(b)
    if a is None or b is None:
        return None
    period = _common_period(a, b)
    ea, eb = _expand(a, period), _expand(b, period)
    out = np.empty(period, dtype=object)
    dim = a.dimension
    for idx in np.ndindex(*period):
        sa = ea[idx]
        if sa is None:
            out[idx] = None
            continue
        acc = constant.null(dim)
        for off_a, val_a in sa.entries:
            shifted = tuple((i + o) % p for i, o, p in zip(idx, off_a, period))
            sb = eb[shifted]
            if sb is None:
                continue
            contrib = [(tuple(p + q for p, q in zip(off_a, off_b)), val_a * val_b)
                       for off_b, val_b in sb.entries]
            acc = constant.add(acc, ConstantStencil(contrib, dim))
        out[idx] = acc
    return PeriodicStencil(out, dim)


def diagonal(ps) -> PeriodicStencil:
    return map_stencil(as_periodic(ps), constant.diagonal)


def lower(ps) -> PeriodicStencil:
    return map_stencil(as_periodic(ps), constant.lower)


def upper(ps) -> PeriodicStencil:
    return map_stencil(as_periodic(ps), constant.upper)


def transpose(ps) -> PeriodicStencil:
    return map_stencil(as_periodic(ps), constant.transpose)


def inverse(ps) -> PeriodicStencil:
    return map_stencil(as_periodic(ps), constant.inverse)


def count_number_of_entries(ps) -> Tuple[int, ...]:
    ps = as_periodic(ps)
    return tuple(s.number_of_entries for s in ps.constant_entries())


def block_diagonal(ps, block_size: Tuple[int, ...]) -> PeriodicStencil:
    """Keep only couplings that stay inside aligned blocks of ``block_size``.

    The entry at lattice point ``idx`` keeps offset ``o`` iff ``idx + o`` lies
    inside the same block, i.e. ``0 <= idx[k] + o[k] < block_size[k]``
    (reference multiple.py:204-217).
    """
    ps = as_periodic(ps)
    if len(block_size) != ps.dimension:
        raise ValueError("block size rank must equal stencil dimension")
    period = tuple(lcm(p, b) for p, b in zip(ps.period, block_size))
    tiled = _expand(ps, period)
    out = np.empty(period, dtype=object)
    for idx in np.ndindex(*period):
        s = tiled[idx]
        if s is None:
            out[idx] = None
            continue
        pos = tuple(i % b for i, b in zip(idx, block_size))

        def keep(offset, _v, pos=pos):
            return all(0 <= p + o < b for p, o, b in zip(pos, offset, block_size))

        out[idx] = constant.filter_stencil(s, keep)
    return PeriodicStencil(out, ps.dimension)


def red_black_partitioning(ps, grid):
    """Red/black filter pair for the given stencil.

    The colors live on a period of twice the stencil period per axis; a point
    is red when the parity of its block index is even (multiple.py:220-240).
    Returns ``(red_filter, black_filter)`` as periodic stencils whose entries
    are unit (keep) or null (drop) stencils.
    """
    ps = as_periodic(ps)
    if ps is None:
        return None
    base = ps.period
    shape = tuple(2 * n for n in base)
    dim = ps.dimension
    red_arr = np.empty(shape, dtype=object)
    black_arr = np.empty(shape, dtype=object)
    for idx in np.ndindex(*shape):
        parity = sum(i // j for i, j in zip(idx, base)) % 2
        if parity == 0:
            red_arr[idx] = constant.unit(dim)
            black_arr[idx] = constant.null(dim)
        else:
            red_arr[idx] = constant.null(dim)
            black_arr[idx] = constant.unit(dim)
    return PeriodicStencil(red_arr, dim), PeriodicStencil(black_arr, dim)


def is_diagonal(ps) -> bool:
    ps = as_periodic(ps)
    return all(all(all(i == 0 for i in o) for o, _ in s.entries)
               for s in ps.constant_entries())
