"""Copy of evostencils_tpu/stencils/gallery.py, kept in the port so that it imports
nothing of the JAX package.

Built-in stencil generators: discretized PDE operators and transfers.

Each generator produces a constant stencil for a given grid (finite-difference
discretizations scaled by the grid spacing).  Intergrid transfer stencils are
generated natively (tensor products), replacing the reference's use of the
external LFA Lab gallery (reference stencils/gallery.py:188-219).

Reference parity: evostencils/stencils/gallery.py.
"""

from __future__ import annotations

import math
from functools import reduce
from typing import Callable, Sequence, Tuple

import numpy as np

from . import constant
from .constant import Stencil


class StencilGenerator:
    """Protocol: generate_stencil(grid) -> Stencil."""

    def generate_stencil(self, grid) -> Stencil:
        raise NotImplementedError


class ShiftedOperatorGenerator(StencilGenerator):
    """``inner + shift * I``: constant diagonal shift of another generator.

    Used for Newton/Picard preconditioners of nonlinear problems (the
    linearized operator L + g'(u*) I around a reference state) and for
    shifted-Laplace-style preconditioning of indefinite problems."""

    def __init__(self, inner: StencilGenerator, shift: float):
        self.inner = inner
        self.shift = shift

    def generate_stencil(self, grid) -> Stencil:
        st = self.inner.generate_stencil(grid)
        d = dict(st.entries)
        center = (0,) * st.dimension
        d[center] = d.get(center, 0.0) + self.shift
        return Stencil(sorted(d.items()), st.dimension)


class Poisson1D(StencilGenerator):
    def generate_stencil(self, grid) -> Stencil:
        (h,) = grid.spacing
        return Stencil([((-1,), -1 / h ** 2), ((0,), 2 / h ** 2), ((1,), -1 / h ** 2)])


class Poisson2D(StencilGenerator):
    """5-point FD Laplacian (reference gallery.py:32-44)."""

    def __init__(self, epsilon: float = 1.0):
        self.epsilon = epsilon  # anisotropy in x

    def generate_stencil(self, grid) -> Stencil:
        hx, hy = grid.spacing
        ex = self.epsilon
        return Stencil([
            ((0, -1), -1 / hy ** 2),
            ((-1, 0), -ex / hx ** 2),
            ((0, 0), 2 * ex / hx ** 2 + 2 / hy ** 2),
            ((1, 0), -ex / hx ** 2),
            ((0, 1), -1 / hy ** 2),
        ])


class Poisson3D(StencilGenerator):
    """7-point FD Laplacian (reference gallery.py:58-71)."""

    def generate_stencil(self, grid) -> Stencil:
        h0, h1, h2 = grid.spacing
        return Stencil([
            ((0, 0, 0), 2 / h0 ** 2 + 2 / h1 ** 2 + 2 / h2 ** 2),
            ((-1, 0, 0), -1 / h0 ** 2), ((1, 0, 0), -1 / h0 ** 2),
            ((0, -1, 0), -1 / h1 ** 2), ((0, 1, 0), -1 / h1 ** 2),
            ((0, 0, -1), -1 / h2 ** 2), ((0, 0, 1), -1 / h2 ** 2),
        ])


class Helmholtz2D(StencilGenerator):
    """Indefinite Helmholtz operator  -Δ - (k² + shift)  on a 2D grid.

    With a complex ``shift`` this is the shifted-Laplace preconditioner
    operator of the Helmholtz example problem (reference
    example_problems/Helmholtz/2D_FD_Helmholtz_fromL3.exa3:55-77).
    """

    def __init__(self, k: float, shift: complex = 0.0):
        self.k = k
        self.shift = shift

    def generate_stencil(self, grid) -> Stencil:
        hx, hy = grid.spacing
        kk = self.k ** 2 * (1.0 + self.shift) if isinstance(self.shift, complex) \
            else self.k ** 2 + self.shift
        return Stencil([
            ((0, -1), -1 / hy ** 2),
            ((-1, 0), -1 / hx ** 2),
            ((0, 0), 2 / hx ** 2 + 2 / hy ** 2 - kk),
            ((1, 0), -1 / hx ** 2),
            ((0, 1), -1 / hy ** 2),
        ])


def default_coefficient_2d(x, y):
    """exp(kappa * (x - x²)(y - y²)), kappa = 10 (reference gallery.py:87-90).
    np-vectorized so coefficient fields assemble in one shot."""
    return np.exp(10.0 * (x - x * x) * (y - y * y))


def default_coefficient_3d(x, y, z):
    return np.exp(10.0 * (x - x * x) * (y - y * y) * (z - z * z))


class Poisson2DVariableCoefficients(StencilGenerator):
    """-div(a grad u) with cell-face coefficient sampling at one position.

    The constant stencil is the operator frozen at ``position`` (used by the
    Fourier-mode analysis); the executable variable-coefficient operator is
    assembled fieldwise in ops.apply (reference gallery.py:93-117).
    """

    def __init__(self, coefficient: Callable[[float, float], float] = default_coefficient_2d,
                 position: Tuple[float, float] = (0.5, 0.5)):
        self.coefficient = coefficient
        self.position = position

    def generate_stencil(self, grid) -> Stencil:
        x, y = self.position
        hx, hy = grid.spacing
        a = self.coefficient
        ae, aw = a(x + 0.5 * hx, y), a(x - 0.5 * hx, y)
        an, as_ = a(x, y + 0.5 * hy), a(x, y - 0.5 * hy)
        return Stencil([
            ((0, 0), (ae + aw) / hx ** 2 + (an + as_) / hy ** 2),
            ((1, 0), -ae / hx ** 2), ((-1, 0), -aw / hx ** 2),
            ((0, 1), -an / hy ** 2), ((0, -1), -as_ / hy ** 2),
        ])

    def generate_stencil_field(self, grid):
        """Executable variable-coefficient form: cell-face coefficients
        sampled over the whole interior grid (one field per offset)."""
        from ..ops.apply import StencilField
        hx, hy = grid.spacing
        axes = [np.arange(1, n + 1) * h
                for n, h in zip(grid.size, grid.spacing)]
        X, Y = np.meshgrid(*axes, indexing="ij")
        a = self.coefficient
        ae, aw = a(X + 0.5 * hx, Y), a(X - 0.5 * hx, Y)
        an, as_ = a(X, Y + 0.5 * hy), a(X, Y - 0.5 * hy)
        return StencilField(
            [(0, 0), (1, 0), (-1, 0), (0, 1), (0, -1)],
            [(ae + aw) / hx ** 2 + (an + as_) / hy ** 2,
             -ae / hx ** 2, -aw / hx ** 2, -an / hy ** 2, -as_ / hy ** 2])


class Poisson3DVariableCoefficients(StencilGenerator):
    def __init__(self, coefficient: Callable[[float, float, float], float] = default_coefficient_3d,
                 position: Tuple[float, float, float] = (0.5, 0.5, 0.5)):
        self.coefficient = coefficient
        self.position = position

    def generate_stencil(self, grid) -> Stencil:
        x, y, z = self.position
        hx, hy, hz = grid.spacing
        a = self.coefficient
        ae, aw = a(x + 0.5 * hx, y, z), a(x - 0.5 * hx, y, z)
        an, as_ = a(x, y + 0.5 * hy, z), a(x, y - 0.5 * hy, z)
        at, ab = a(x, y, z + 0.5 * hz), a(x, y, z - 0.5 * hz)
        return Stencil([
            ((0, 0, 0), (ae + aw) / hx ** 2 + (an + as_) / hy ** 2 + (at + ab) / hz ** 2),
            ((1, 0, 0), -ae / hx ** 2), ((-1, 0, 0), -aw / hx ** 2),
            ((0, 1, 0), -an / hy ** 2), ((0, -1, 0), -as_ / hy ** 2),
            ((0, 0, 1), -at / hz ** 2), ((0, 0, -1), -ab / hz ** 2),
        ])

    def generate_stencil_field(self, grid):
        from ..ops.apply import StencilField
        hx, hy, hz = grid.spacing
        axes = [np.arange(1, n + 1) * h
                for n, h in zip(grid.size, grid.spacing)]
        X, Y, Z = np.meshgrid(*axes, indexing="ij")
        a = self.coefficient
        ae, aw = a(X + 0.5 * hx, Y, Z), a(X - 0.5 * hx, Y, Z)
        an, as_ = a(X, Y + 0.5 * hy, Z), a(X, Y - 0.5 * hy, Z)
        at, ab = a(X, Y, Z + 0.5 * hz), a(X, Y, Z - 0.5 * hz)
        return StencilField(
            [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
             (0, 0, 1), (0, 0, -1)],
            [(ae + aw) / hx ** 2 + (an + as_) / hy ** 2 + (at + ab) / hz ** 2,
             -ae / hx ** 2, -aw / hx ** 2, -an / hy ** 2, -as_ / hy ** 2,
             -at / hz ** 2, -ab / hz ** 2])


def _tensor(weights_1d: Sequence[float], dimension: int) -> Stencil:
    """d-fold tensor product of a centered 1D weight list (odd length)."""
    radius = len(weights_1d) // 2
    s1 = Stencil([((i - radius,), w) for i, w in enumerate(weights_1d)], 1)
    out = s1
    for _ in range(dimension - 1):
        out = constant.tensor_product(out, s1)
    return out


class MultilinearInterpolationGenerator(StencilGenerator):
    """Bilinear/trilinear prolongation, expressed as a fine-grid stencil that
    is applied after injecting coarse values onto even fine nodes:
    weights (1/2, 1, 1/2) per axis (replaces LFA Lab ml_interpolation)."""

    def __init__(self, coarsening_factor: Tuple[int, ...]):
        self.coarsening_factor = tuple(coarsening_factor)

    def generate_stencil(self, grid) -> Stencil:
        if any(f != 2 for f in self.coarsening_factor):
            raise NotImplementedError("only coarsening factor 2 is supported")
        return _tensor((0.5, 1.0, 0.5), len(self.coarsening_factor))


class FullWeightingRestrictionGenerator(StencilGenerator):
    """Full-weighting restriction: fine-grid stencil (1/4, 1/2, 1/4) per axis
    followed by injection to the coarse grid (replaces LFA Lab
    fw_restriction)."""

    def __init__(self, coarsening_factor: Tuple[int, ...]):
        self.coarsening_factor = tuple(coarsening_factor)

    def generate_stencil(self, grid) -> Stencil:
        if any(f != 2 for f in self.coarsening_factor):
            raise NotImplementedError("only coarsening factor 2 is supported")
        return _tensor((0.25, 0.5, 0.25), len(self.coarsening_factor))


class InjectionRestrictionGenerator(StencilGenerator):
    def __init__(self, coarsening_factor: Tuple[int, ...]):
        self.coarsening_factor = tuple(coarsening_factor)

    def generate_stencil(self, grid) -> Stencil:
        return constant.unit(len(self.coarsening_factor))


class IdentityGenerator(StencilGenerator):
    def __init__(self, dimension: int):
        self.dimension = dimension

    def generate_stencil(self, grid) -> Stencil:
        return constant.unit(self.dimension)


class ZeroGenerator(StencilGenerator):
    def __init__(self, dimension: int):
        self.dimension = dimension

    def generate_stencil(self, grid) -> Stencil:
        return constant.null(self.dimension)
