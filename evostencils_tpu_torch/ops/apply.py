"""Stencil application and intergrid transfers in plain PyTorch
(counterpart of evostencils_tpu/ops/apply.py, the part the Poisson
V-cycles reach, and the variable-coefficient ``StencilField``).

Fields live on the interior of the grid (shape == grid.size); the implicit
Dirichlet-0 boundary ring is materialized by zero padding.  Terms are
summed in the same order as the JAX functions, so in float64 the two
packages agree to rounding.  Stencil values and coefficient fields may be
complex (Helmholtz): applied to a real field they give a complex result,
complex64 for float32 and complex128 for float64 (apply.py:37-43,
:120-130, :242); the grid's precision governs.  Transfer taps stay real,
as in the JAX lowering (lower.py:1286).

Not ported: the dense per-axis transfer contractions and their
optimization barrier (``_axis_contract``), which exist for the TPU's
matrix unit; separable transfers go through the 3-tap forms below.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..stencils import periodic
from ..stencils.constant import Stencil
from ..stencils.periodic import PeriodicStencil

#: Lattice origin: interior index 0 is global node index 1 on every axis
#: (evostencils_tpu/ops/apply.py:35-36).
LATTICE_ORIGIN = 1


def _real_values(values):
    values = list(values)
    if any(isinstance(v, complex) or np.iscomplexobj(v) for v in values):
        raise NotImplementedError("complex transfer taps are not supported")
    return values


def scalar(value):
    """A stencil value as a Python complex if it is complex, else as a
    Python float."""
    if isinstance(value, complex) or np.iscomplexobj(value):
        return complex(value)
    return float(value)


def complex_dtype(dtype: torch.dtype) -> torch.dtype:
    """The complex dtype of ``dtype``'s precision: complex64 for float32
    and complex64, complex128 for float64 and complex128
    (``jnp.promote_types(dtype, complex64)``)."""
    return torch.promote_types(dtype, torch.complex64)


def _shifted(u_padded, offset, radius, shape):
    """Slice of the padded array holding u(x + offset)."""
    return u_padded[tuple(slice(r + o, r + o + n)
                          for r, o, n in zip(radius, offset, shape))]


def _pad(u, radius):
    """Zero-pad every axis of ``u`` by its radius (F.pad lists the last
    axis first)."""
    pads = []
    for r in reversed(radius):
        pads += [r, r]
    return F.pad(u, pads)


def red_black_masks(shape: Tuple[int, ...], *, device, dtype):
    """Node-parity masks ``(red, black)`` as ``dtype`` tensors: red is an
    even node-index sum, interior index i being node i+1 on every axis
    (evostencils_tpu/compiler/lower.py:155-167)."""
    idx = sum(torch.arange(n, device=device).reshape(
        [n if k == axis else 1 for k in range(len(shape))])
        for axis, n in enumerate(shape))
    red = (idx + len(shape) * LATTICE_ORIGIN) % 2 == 0
    return red.to(dtype), (~red).to(dtype)


def apply_constant(stencil: Stencil, u: torch.Tensor) -> torch.Tensor:
    """(S u)(x) = sum_k v_k * u(x + o_k), zero outside the grid
    (apply.py:53-76, Dirichlet branch)."""
    if stencil.number_of_entries == 0:
        return torch.zeros_like(u)
    radius = stencil.max_offsets
    up = _pad(u, radius)
    acc = None
    for offset, value in stencil.entries:
        term = scalar(value) * _shifted(up, offset, radius, u.shape)
        acc = term if acc is None else acc + term
    return acc


def apply_periodic(ps: PeriodicStencil, u: torch.Tensor) -> torch.Tensor:
    """Apply a periodic stencil of period 1 (apply.py:118-158): the
    diagonal-inverse stencils that smoother inverses build."""
    if not ps.is_constant:
        raise NotImplementedError(
            f"periodic stencil with period {ps.period} is not ported yet")
    return apply_constant(ps.to_constant(), u)


def apply_stencil(stencil, u: torch.Tensor) -> torch.Tensor:
    """Dispatch on constant vs periodic stencil (apply.py:151-157)."""
    if isinstance(stencil, Stencil):
        return apply_constant(stencil, u)
    if isinstance(stencil, PeriodicStencil):
        return apply_periodic(stencil, u)
    raise TypeError(f"not a stencil: {type(stencil)}")


# ---------------------------------------------------------------------------
# Variable coefficients (a copy of apply.py:160-293)
# ---------------------------------------------------------------------------

def almost_uniform_desc(f, max_rows: int = 4):
    """Structure descriptor of a numpy coefficient array (apply.py:160-190):

    * ``("const", c)``: the array is the constant ``c``;
    * ``("rows", c, [(i, row - c), ...])``: constant except on at most
      ``max_rows`` axis-0 rows;
    * ``None``: genuinely varying."""
    if not (isinstance(f, np.ndarray) and f.size and f.ndim >= 1):
        return None
    c = f.flat[0]
    # probe the middle row too: for a boundary fold f.flat[0] sits on an
    # exceptional row
    mid = np.atleast_1d(f[tuple([f.shape[0] // 2]
                               + [slice(None)] * (f.ndim - 1))])
    if mid.size and np.all(mid == mid.flat[0]):
        c = mid.flat[0]
    neq = f != c
    if not neq.any():
        return ("const", np.asarray(c).item())
    exc = np.unique(np.nonzero(neq)[0])
    if len(exc) <= max_rows:
        return ("rows", np.asarray(c).item(),
                [(int(i), np.asarray(f[int(i)] - c)) for i in exc])
    return None


def almost_uniform_mul(term, x):
    """``coefficient * x`` for one offset's device term (see
    :meth:`StencilField.device_terms`): ``(bulk, [(row, row_term)])``,
    where the row terms are added at their rows after every bulk term is
    summed (apply.py:193-204)."""
    coeff, rows = term
    return coeff * x, [(i, row * x[i]) for i, row in rows]


class StencilField:
    """Variable-coefficient stencil: one coefficient field per offset
    (apply.py:207-286).

    ``fields[k]`` is a numpy array of the grid's interior shape holding the
    coefficient of ``offsets[k]`` at each point.  Device copies, cast to
    the grid dtype, are built once per field object, device and dtype and
    kept on the object (:meth:`cached`)."""

    __slots__ = ("offsets", "fields", "_uniform", "_cache")

    def __init__(self, offsets, fields):
        self.offsets = tuple(tuple(o) for o in offsets)
        self.fields = list(fields)
        self._uniform = None
        self._cache = {}

    def _uniform_values(self):
        """Per-offset :func:`almost_uniform_desc`, computed once."""
        if self._uniform is None:
            self._uniform = [almost_uniform_desc(f) for f in self.fields]
        return self._uniform

    @property
    def dimension(self):
        return len(self.offsets[0])

    def cached(self, key, device, dtype, build):
        """``build()`` once per ``key``, device and dtype."""
        key = (key, str(torch.device(device)), dtype)
        if key not in self._cache:
            self._cache[key] = build()
        return self._cache[key]

    @property
    def is_complex(self) -> bool:
        return any(np.iscomplexobj(np.asarray(f)) for f in self.fields)

    def device_terms(self, device, dtype):
        """Per offset ``(coefficient, [(row, row_delta)])``: a Python
        scalar for a uniform or almost uniform field, else the field as a
        ``dtype`` tensor on ``device``; the row deltas of an almost
        uniform field as tensors (apply.py:193-204)."""
        def build():
            terms = []
            for f, desc in zip(self.fields, self._uniform_values()):
                if desc is None:
                    terms.append((torch.as_tensor(np.asarray(f), dtype=dtype,
                                                  device=device), []))
                    continue
                rows = [(i, torch.as_tensor(row, dtype=dtype, device=device))
                        for i, row in desc[2]] if desc[0] == "rows" else []
                terms.append((scalar(desc[1]), rows))
            return terms
        return self.cached("terms", device, dtype, build)

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """(S u)(x) = sum_k c_k(x) * u(x + o_k), zero outside the grid, in
        the grid's precision, complex if a coefficient field is
        (apply.py:235-262, Dirichlet branch)."""
        radius = tuple(max(abs(o[k]) for o in self.offsets)
                       for k in range(u.ndim))
        if self.is_complex:
            u = u.to(complex_dtype(u.dtype))
        up = _pad(u, radius)
        acc = None
        row_fixups = []
        for offset, term in zip(self.offsets,
                                self.device_terms(u.device, u.dtype)):
            bulk, fixes = almost_uniform_mul(
                term, _shifted(up, offset, radius, u.shape))
            row_fixups.extend(fixes)
            acc = bulk if acc is None else acc + bulk
        for i, add in row_fixups:
            acc[i] = acc[i] + add
        return acc

    def diagonal_field(self):
        zero = (0,) * self.dimension
        for o, f in zip(self.offsets, self.fields):
            if o == zero:
                return f
        raise ValueError("stencil field has no diagonal entry")

    def diagonal_tensor(self, device, dtype) -> torch.Tensor:
        """:meth:`diagonal_field` as a ``dtype`` tensor on ``device``."""
        return self.cached("diagonal", device, dtype, lambda: torch.as_tensor(
            np.asarray(self.diagonal_field()), dtype=dtype, device=device))

    def dense_matrix(self) -> np.ndarray:
        """Dense matrix (Dirichlet-0 outside the grid) for tests and small
        direct solves (apply.py:271-286)."""
        shape = np.asarray(self.fields[0]).shape
        n = int(np.prod(shape))
        dtype = np.result_type(*[np.asarray(f).dtype for f in self.fields])
        mat = np.zeros((n, n),
                       dtype=dtype if dtype.kind == "c" else np.float64)
        for offset, coeff in zip(self.offsets, self.fields):
            coeff = np.asarray(coeff)
            for row_idx in np.ndindex(*shape):
                col_idx = tuple(i + o for i, o in zip(row_idx, offset))
                if all(0 <= c < m for c, m in zip(col_idx, shape)):
                    mat[np.ravel_multi_index(row_idx, shape),
                        np.ravel_multi_index(col_idx, shape)] += coeff[row_idx]
        return mat


def constant_stencil_field(stencil: Stencil, shape) -> StencilField:
    """Broadcast a constant stencil into field form (apply.py:289-293)."""
    offsets = [o for o, _ in stencil.entries]
    fields = [np.full(shape, v) for _, v in stencil.entries]
    return StencilField(offsets, fields)


# ---------------------------------------------------------------------------
# Intergrid transfers (coarsening factor 2, vertex-centered)
# ---------------------------------------------------------------------------
# Coarse interior point i_c sits at fine interior index 2*i_c + 1.

def separable_factors(stencil: Stencil):
    """Factor a stencil into per-axis 1D weight vectors, or None
    (a numpy-only copy of apply.py:307-342).

    Returns ``(vectors, radii)`` with ``stencil[o] = prod_k v_k[o_k + r_k]``.
    """
    if stencil is None or stencil.number_of_entries == 0:
        return None
    d = stencil.dimension
    radii = stencil.max_offsets
    box = np.zeros(tuple(2 * r + 1 for r in radii), dtype=np.complex128)
    for offset, value in stencil.entries:
        box[tuple(o + r for o, r in zip(offset, radii))] = value
    center = tuple(radii)
    c = box[center]
    if c == 0:
        return None
    vectors = []
    for k in range(d):
        index = list(center)
        index[k] = slice(None)
        vectors.append(box[tuple(index)].copy())
    scale = c ** (1.0 / d)
    for k in range(d):
        vk = vectors[k]
        if vk[radii[k]] == 0:
            return None
        vectors[k] = vk * (scale / vk[radii[k]])
    recon = vectors[0]
    for vk in vectors[1:]:
        recon = np.multiply.outer(recon, vk)
    if not np.allclose(recon, box, rtol=1e-12, atol=1e-300):
        return None
    if np.allclose(box.imag, 0):
        vectors = [v.real for v in vectors]
    return vectors, radii


def _axis_slice(u, axis, start, stop, step=1):
    index = [slice(None)] * u.ndim
    index[axis] = slice(start, stop, step)
    return u[tuple(index)]


def axis_restrict_3tap(u: torch.Tensor, axis: int, weights) -> torch.Tensor:
    """2:1 restriction along one axis, radius-1 three-tap form
    (apply.py:414-440): ``out[i] = w[0]*u[2i] + w[1]*u[2i+1] + w[2]*u[2i+2]``."""
    weights = _real_values(weights)
    nc = (u.shape[axis] - 1) // 2
    out = None
    for k, w in enumerate(weights):
        if w == 0:
            continue
        term = float(w) * _axis_slice(u, axis, k, k + 2 * (nc - 1) + 1, 2)
        out = term if out is None else out + term
    if out is None:
        shape = list(u.shape)
        shape[axis] = nc
        return u.new_zeros(shape)
    return out


def axis_prolong_3tap(u: torch.Tensor, axis: int, weights,
                      n_fine: int) -> torch.Tensor:
    """1:2 prolongation along one axis, radius-1 three-tap form
    (apply.py:443-464): fine odd ``2i+1 <- w[1]*u[i]``, fine even
    ``2i <- w[0]*u[i] + w[2]*u[i-1]``, fine ``2nc <- w[2]*u[nc-1]``."""
    w0, w1, w2 = (float(w) for w in _real_values(weights))
    nc = u.shape[axis]
    if n_fine != 2 * nc + 1:
        raise ValueError(f"fine size {n_fine} is not 2*{nc}+1")
    odd = w1 * u
    u_prev = torch.cat([torch.zeros_like(_axis_slice(u, axis, 0, 1)),
                        _axis_slice(u, axis, 0, nc - 1)], dim=axis)
    evn = w0 * u + w2 * u_prev
    last = w2 * _axis_slice(u, axis, nc - 1, nc)
    shape = list(u.shape)
    shape[axis] = 2 * nc
    inter = torch.stack([evn, odd], dim=axis + 1).reshape(shape)
    return torch.cat([inter, last], dim=axis)


def _three_tap_vectors(stencil):
    """Per-axis weight vectors of a separable radius-1 stencil, or None."""
    fac = separable_factors(stencil)
    if fac is None:
        return None
    vectors, radii = fac
    if any(r != 1 for r in radii):
        raise NotImplementedError(
            f"separable transfer of radius {radii} is not ported yet")
    return vectors


def inject(u_fine: torch.Tensor) -> torch.Tensor:
    """Injection at odd fine nodes (apply.py:498-500)."""
    return u_fine[tuple(slice(1, None, 2) for _ in range(u_fine.ndim))]


def restrict(stencil: Stencil, u_fine: torch.Tensor) -> torch.Tensor:
    """Full restriction: weighting stencil followed by injection at odd
    fine nodes (apply.py:467-495)."""
    if stencil is None:
        return inject(u_fine)
    vectors = _three_tap_vectors(stencil)
    if vectors is not None:
        out = u_fine
        for k, v in enumerate(vectors):
            out = axis_restrict_3tap(out, k, tuple(v))
        return out
    return inject(apply_constant(stencil, u_fine))


def prolong(stencil: Stencil, u_coarse: torch.Tensor,
            fine_shape: Tuple[int, ...]) -> torch.Tensor:
    """Interpolation: coarse values onto odd fine nodes, then the fine-grid
    interpolation stencil (apply.py:503-529)."""
    if stencil is not None:
        vectors = _three_tap_vectors(stencil)
        if vectors is not None:
            out = u_coarse
            for k, v in enumerate(vectors):
                out = axis_prolong_3tap(out, k, tuple(v), fine_shape[k])
            return out
    embedded = u_coarse.new_zeros(tuple(fine_shape))
    embedded[tuple(slice(1, None, 2) for _ in range(u_coarse.ndim))] = u_coarse
    if stencil is None:
        return embedded
    return apply_constant(stencil, embedded)


# ---------------------------------------------------------------------------
# Dense materialization (tests + small direct solves)
# ---------------------------------------------------------------------------

def dense_matrix(stencil, grid) -> np.ndarray:
    """Dense matrix of the stencil operator on the interior grid,
    Dirichlet-0, C order (a numpy-only copy of apply.py:536-564)."""
    shape = tuple(grid.size)
    n = int(np.prod(shape))
    ps = periodic.from_constant(stencil) if isinstance(stencil, Stencil) \
        else stencil
    any_complex = any(isinstance(v, complex) or np.iscomplexobj(np.asarray(v))
                      for s in ps.constant_entries() for _, v in s.entries)
    mat = np.zeros((n, n), dtype=np.complex128 if any_complex else np.float64)
    period = ps.period
    for row_idx in np.ndindex(*shape):
        lattice = tuple((i + LATTICE_ORIGIN) % p
                        for i, p in zip(row_idx, period))
        s = ps.stencils[lattice]
        if s is None:
            continue
        row = np.ravel_multi_index(row_idx, shape)
        for offset, value in s.entries:
            col_idx = tuple(i + o for i, o in zip(row_idx, offset))
            if all(0 <= c < m for c, m in zip(col_idx, shape)):
                mat[row, np.ravel_multi_index(col_idx, shape)] += value
    return mat
