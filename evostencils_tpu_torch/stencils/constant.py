"""Copy of evostencils_tpu/stencils/constant.py, kept in the port so that it imports
nothing of the JAX package.

Constant (translation-invariant) stencil algebra.

A constant stencil is a finite set of (offset, value) pairs describing a
translation-invariant linear operator on a structured grid:

    (S u)(x) = sum_k  value_k * u(x + offset_k)

This module provides the closed algebra over such stencils — addition,
scaling, composition, transposition, triangular/diagonal splits — that the
multigrid IR uses to derive smoothers and Galerkin-style operator products
symbolically before anything is lowered to TPU kernels.

Reference parity: evostencils/stencils/constant.py (semantics only; this
implementation is dict-normalized, hashable and supports complex values).
"""

from __future__ import annotations

import numbers
from typing import Callable, Dict, Iterable, Mapping, Tuple, Union

Offset = Tuple[int, ...]
Entry = Tuple[Offset, complex]


def _normalize(entries: Iterable[Entry]) -> Tuple[Entry, ...]:
    """Merge duplicate offsets and impose a canonical (lexicographic) order."""
    merged: Dict[Offset, complex] = {}
    for offset, value in entries:
        offset = tuple(int(o) for o in offset)
        merged[offset] = merged.get(offset, 0) + value
    return tuple(sorted(merged.items(), key=lambda e: e[0]))


class Stencil:
    """Immutable constant stencil.

    ``entries`` is a canonically ordered tuple of ``(offset, value)`` pairs
    with unique offsets. ``dimension`` must be given explicitly for the empty
    (null) stencil.
    """

    __slots__ = ("_entries", "_dimension")

    def __init__(self, entries: Iterable[Entry], dimension: int | None = None):
        self._entries = _normalize(entries)
        if dimension is None:
            if not self._entries:
                raise ValueError("dimension required for an empty stencil")
            dimension = len(self._entries[0][0])
        for offset, _ in self._entries:
            if len(offset) != dimension:
                raise ValueError(f"offset {offset} does not have dimension {dimension}")
        self._dimension = int(dimension)

    @property
    def entries(self) -> Tuple[Entry, ...]:
        return self._entries

    @property
    def dimension(self) -> int:
        return self._dimension

    @property
    def number_of_entries(self) -> int:
        return len(self._entries)

    @property
    def is_null(self) -> bool:
        return all(v == 0 for _, v in self._entries)

    def as_dict(self) -> Dict[Offset, complex]:
        return dict(self._entries)

    def value_at(self, offset: Offset, default=0):
        for o, v in self._entries:
            if o == offset:
                return v
        return default

    @property
    def max_offsets(self) -> Tuple[int, ...]:
        """Per-axis maximum of |offset| over all entries (0 for empty)."""
        radii = [0] * self._dimension
        for offset, _ in self._entries:
            for i, o in enumerate(offset):
                radii[i] = max(radii[i], abs(o))
        return tuple(radii)

    def __iter__(self):
        return iter(self._entries)

    def __eq__(self, other):
        return isinstance(other, Stencil) and self._entries == other._entries \
            and self._dimension == other._dimension

    def __hash__(self):
        return hash((self._entries, self._dimension))

    def __repr__(self):
        return f"Stencil({self._entries!r}, dimension={self._dimension})"


# ---------------------------------------------------------------------------
# Functional algebra
# ---------------------------------------------------------------------------

def map_stencil(stencil: Stencil, f: Callable[[Offset, complex], Entry]) -> Stencil:
    if stencil is None:
        return None
    return Stencil([f(o, v) for o, v in stencil.entries], stencil.dimension)


def filter_stencil(stencil: Stencil, predicate: Callable[[Offset, complex], bool]) -> Stencil:
    if stencil is None:
        return None
    return Stencil([(o, v) for o, v in stencil.entries if predicate(o, v)],
                   stencil.dimension)


def combine(a: Stencil, b: Stencil, f: Callable[[complex, complex], complex]) -> Stencil:
    """Offset-wise combination; missing offsets are treated as value 0."""
    if a is None or b is None:
        return None
    da, db = a.as_dict(), b.as_dict()
    offsets = set(da) | set(db)
    return Stencil([(o, f(da.get(o, 0), db.get(o, 0))) for o in offsets],
                   a.dimension)


def add(a: Stencil, b: Stencil) -> Stencil:
    return combine(a, b, lambda x, y: x + y)


def sub(a: Stencil, b: Stencil) -> Stencil:
    return combine(a, b, lambda x, y: x - y)


def scale(factor, stencil: Stencil) -> Stencil:
    return map_stencil(stencil, lambda o, v: (o, factor * v))


def mul(a: Stencil, b: Stencil) -> Stencil:
    """Operator composition A∘B: ((A∘B) u)(x) = (A (B u))(x).

    For constant stencils the composed entries live at summed offsets with
    multiplied values (reference constant.py:120-137).
    """
    if a is None or b is None:
        return None
    entries = []
    for oa, va in a.entries:
        for ob, vb in b.entries:
            entries.append((tuple(p + q for p, q in zip(oa, ob)), va * vb))
    return Stencil(entries, a.dimension)


def _lex_less(a: Offset, b: Offset) -> bool:
    return a < b  # tuple comparison is lexicographic


def diagonal(stencil: Stencil) -> Stencil:
    return filter_stencil(stencil, lambda o, v: all(i == 0 for i in o))


def lower(stencil: Stencil) -> Stencil:
    zero = (0,) * stencil.dimension if stencil is not None else ()
    return filter_stencil(stencil, lambda o, v: _lex_less(o, zero))


def upper(stencil: Stencil) -> Stencil:
    zero = (0,) * stencil.dimension if stencil is not None else ()
    return filter_stencil(stencil, lambda o, v: _lex_less(zero, o))


def transpose(stencil: Stencil) -> Stencil:
    """Adjoint of the (real) stencil operator: offsets negated."""
    return map_stencil(stencil, lambda o, v: (tuple(-i for i in o), v))


def inverse(stencil: Stencil) -> Stencil:
    """Exact inverse of a *diagonal* stencil only (reference constant.py:97-105)."""
    def reciprocal(offset: Offset, value):
        if any(i != 0 for i in offset):
            raise ValueError("cannot invert a non-diagonal stencil exactly")
        if abs(value) < 1e-300:
            raise ZeroDivisionError("stencil diagonal is (numerically) zero")
        return offset, 1.0 / value
    return map_stencil(stencil, reciprocal)


def unit(dimension: int) -> Stencil:
    return Stencil([((0,) * dimension, 1.0)], dimension)


def null(dimension: int) -> Stencil:
    return Stencil([], dimension)


def get_unit_stencil(grid) -> Stencil:
    return unit(grid.dimension)


def get_null_stencil(grid) -> Stencil:
    return null(grid.dimension)


def tensor_product(a: Stencil, b: Stencil) -> Stencil:
    """Tensor (outer) product of two stencils; dimensions concatenate."""
    entries = []
    for oa, va in a.entries:
        for ob, vb in b.entries:
            entries.append((oa + ob, va * vb))
    return Stencil(entries, a.dimension + b.dimension)
