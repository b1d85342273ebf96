"""Copy of evostencils_tpu/problems/helmholtz.py (``K_DEFAULT``, ``SHIFT``,
``_helmholtz_stencil``, ``HelmholtzOperatorGenerator``,
``_dirac_bspline_rhs``, ``OuterSolverSpec``, ``helmholtz_2d`` and the
split-complex formulation: ``SplitPartOperatorGenerator``,
``_split_operator`` and ``helmholtz_2d_split``), kept in the port so that
it imports nothing of the JAX package.  The ``rhs_builder`` closures
return numpy arrays: ``helmholtz_2d``'s the complex128 right-hand side,
``helmholtz_2d_split``'s its real and imaginary parts in float64, where
the JAX package's return ``jax.numpy`` arrays in the asked precision
(helmholtz.py:132-136, :239-244); ``problems.poisson.build_rhs`` moves
them to a device in the asked dtype, complex for ``helmholtz_2d``.

The JAX module's docstring:

2D Helmholtz: indefinite complex problem with an evolved MG
preconditioner inside BiCGStab.

Reference example_problems/Helmholtz/2D_FD_Helmholtz_fromL3.*:
* A = -Lap - k^2 (indefinite), M = -Lap - k^2 * (1 + 0.5i) (shifted
  Laplacian preconditioner target, PrecEq M*u == f), k = 80, levels 3->7;
* Dirichlet BC top/bottom, Sommerfeld-like Robin BC left/right:
  u_boundary = u_neighbor / (1 - i k h) (.exa4:24-40) — folded into the
  operator as a boundary-column diagonal modification;
* RHS: B-spline approximation of a centered Dirac pulse (.exa3:22-23);
* outer solver: PreconditionedBiCGStab to 1e-7, max 10000, one evolved
  gen_mgCycle() per preconditioner application (.exa3:144-201);
* grammar evolves the cycle for M; RB-GS pre-smoother omega=0.6 is the
  hand-written baseline (.exa3:203-212).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from ..grids import Grid, unit_interval_grid
from ..ir import base, system
from ..stencils import gallery
from ..stencils.constant import Stencil
from ..ops.apply import StencilField
from ..compiler.cycles import LevelContext
from .api import Problem

K_DEFAULT = 80.0
SHIFT = 0.5j  # M diagonal uses k^2 * (1 + 0.5i)


def _helmholtz_stencil(grid: Grid, k: float, shift: complex) -> Stencil:
    hx, hy = grid.spacing
    kk = k * k * (1.0 + shift)
    return Stencil([
        ((0, -1), -1 / hy ** 2), ((-1, 0), -1 / hx ** 2),
        ((0, 0), 2 / hx ** 2 + 2 / hy ** 2 - kk),
        ((1, 0), -1 / hx ** 2), ((0, 1), -1 / hy ** 2),
    ])


class HelmholtzOperatorGenerator:
    """Helmholtz stencil with the Robin boundary columns folded in.

    The Robin ghost relation u_b = u_1 / (1 - i k h) on the x-min/x-max
    boundaries turns the west/east couplings of the first/last interior
    columns into diagonal contributions; generate_stencil_field() carries
    that position dependence, generate_stencil() returns the interior
    stencil (used by LFA and the grammar).
    """

    def __init__(self, k: float, shift: complex = 0.0):
        self.k = k
        self.shift = shift

    def generate_stencil(self, grid: Grid) -> Stencil:
        return _helmholtz_stencil(grid, self.k, self.shift)

    def generate_stencil_field(self, grid: Grid) -> StencilField:
        st = self.generate_stencil(grid)
        shape = tuple(grid.size)
        hx = grid.spacing[0]
        alpha = 1.0 / (1.0 - 1j * self.k * hx)
        offsets = [o for o, _ in st.entries]
        fields = [np.full(shape, v, dtype=np.complex128)
                  for _, v in st.entries]
        diag_idx = offsets.index((0, 0))
        west = st.value_at((-1, 0))
        east = st.value_at((1, 0))
        # interior point (0, j) couples west to the boundary node whose value
        # is alpha * u(0, j); same on the east side
        fields[diag_idx][0, :] += west * alpha
        fields[diag_idx][-1, :] += east * alpha
        return StencilField(offsets, fields)


def _dirac_bspline_rhs(grid: Grid) -> np.ndarray:
    """B-spline approximation of a Dirac pulse at the domain center."""
    hx, hy = grid.spacing
    x = np.arange(1, grid.size[0] + 1) * hx
    y = np.arange(1, grid.size[1] + 1) * hy
    fx = np.maximum(0.0, -(np.abs(x - 0.5) - hx) / hx ** 2)
    fy = np.maximum(0.0, -(np.abs(y - 0.5) - hy) / hy ** 2)
    return np.outer(fx, fy).astype(np.complex128)


@dataclass
class OuterSolverSpec:
    """Outer Krylov wrapper around the evolved preconditioner cycle."""
    name: str
    operator: system.Operator          # the true (unshifted) operator
    tolerance: float
    max_iterations: int
    rhs_builder: Callable
    #: split-complex mode: fields are (re, im) real pairs and the outer
    #: BiCGStab carries complex scalars as (re, im) pairs — every tensor of
    #: the solve is real (ops/solvers.preconditioned_bicgstab_split)
    split: bool = False


def helmholtz_2d(max_level: int = 7, min_level: int = 3,
                 k: float = K_DEFAULT, shift: complex = SHIFT) -> Problem:
    cf = (2, 2)
    rgen = gallery.FullWeightingRestrictionGenerator(cf)
    pgen = gallery.MultilinearInterpolationGenerator(cf)
    contexts = []
    for level in range(max_level, min_level, -1):
        g = unit_interval_grid(2, level)
        gc = unit_interval_grid(2, level - 1)
        m_op = system.Operator(f"M_{level}", [[base.Operator(
            "M", g, HelmholtzOperatorGenerator(k, shift))]])
        restriction = system.Restriction(
            f"R_{level}", [base.Restriction("R", g, gc, rgen)])
        prolongation = system.Prolongation(
            f"P_{level}", [base.Prolongation("P", g, gc, pgen)])
        approx = system.Approximation("u", [base.Approximation("u", g)])
        contexts.append(LevelContext(operator=m_op, restriction=restriction,
                                     prolongation=prolongation,
                                     approximation=approx, grid=[g]))
    g_min = unit_interval_grid(2, min_level)
    coarsest = system.Operator(f"M_{min_level}", [[base.Operator(
        "M", g_min, HelmholtzOperatorGenerator(k, shift))]])

    grid = contexts[0].grid[0]
    rhs_entity = system.RightHandSide(
        "f", [base.RightHandSide("f", grid)])

    def rhs_builder(dtype=np.complex128):
        # numpy complex128 in every precision; build_rhs casts
        return (_dirac_bspline_rhs(grid),)

    a_op = system.Operator(f"A_{max_level}", [[base.Operator(
        "A", grid, HelmholtzOperatorGenerator(k, 0.0))]])

    problem = Problem(name="Helmholtz2D", dimension=2, min_level=min_level,
                      max_level=max_level, fields=["u"],
                      level_contexts=contexts, coarsest_operator=coarsest,
                      rhs_entity=rhs_entity, rhs_builder=rhs_builder,
                      target_reduction=1e-7, max_iterations=10000,
                      dtype=np.complex128)
    problem.outer_solver = OuterSolverSpec(
        name="PreconditionedBiCGStab", operator=a_op, tolerance=1e-7,
        max_iterations=10000, rhs_builder=rhs_builder)
    return problem


# ---------------------------------------------------------------------------
# Split-complex formulation: every tensor stays real (helmholtz.py:153-264)
# ---------------------------------------------------------------------------
# A complex system A z = b with z = x + i y is algebraically the 2x2 real
# block system [[Ar, -Ai], [Ai, Ar]] (x, y) = (br, bi).  Lowered this way,
# the collective point smoother (ElementwiseDiagonal over the 2x2 system)
# is the complex point smoother (the 2x2 center matrix [[dr, -di], [di,
# dr]] is complex multiplication by the center), the transfers are
# per-field real, and the dense coarse inverse of the block system is the
# complex inverse.  The real block system runs the coupled-system kernels
# (ops/kernels/rbgs_sys.py), with the Robin fold as their row fixups.

class SplitPartOperatorGenerator:
    """Real or imaginary part (optionally negated) of a complex operator
    generator, preserving the Robin boundary fold via field form."""

    def __init__(self, gen, part: str, sign: float = 1.0):
        self.gen = gen
        self.part = part
        self.sign = sign

    def generate_stencil(self, grid: Grid) -> Stencil:
        st = self.gen.generate_stencil(grid)
        take = ((lambda v: complex(v).real) if self.part == "re"
                else (lambda v: complex(v).imag))
        return Stencil([(o, self.sign * take(v)) for o, v in st.entries])

    def generate_stencil_field(self, grid: Grid) -> StencilField:
        sf = self.gen.generate_stencil_field(grid)
        take = np.real if self.part == "re" else np.imag
        return StencilField(
            sf.offsets,
            [self.sign * take(np.asarray(f)) for f in sf.fields])


def _split_operator(name: str, grid: Grid, gen) -> system.Operator:
    return system.Operator(name, [
        [base.Operator(f"{name}_rr", grid,
                       SplitPartOperatorGenerator(gen, "re")),
         base.Operator(f"{name}_ri", grid,
                       SplitPartOperatorGenerator(gen, "im", -1.0))],
        [base.Operator(f"{name}_ir", grid,
                       SplitPartOperatorGenerator(gen, "im")),
         base.Operator(f"{name}_ii", grid,
                       SplitPartOperatorGenerator(gen, "re"))],
    ])


def helmholtz_2d_split(max_level: int = 7, min_level: int = 3,
                       k: float = K_DEFAULT,
                       shift: complex = SHIFT) -> Problem:
    """Split-complex Helmholtz: the physics of :func:`helmholtz_2d`,
    lowered as a 2-field real system, so that no tensor of the solve is
    complex."""
    cf = (2, 2)
    rgen = gallery.FullWeightingRestrictionGenerator(cf)
    pgen = gallery.MultilinearInterpolationGenerator(cf)
    contexts = []
    for level in range(max_level, min_level, -1):
        g = unit_interval_grid(2, level)
        gc = unit_interval_grid(2, level - 1)
        m_op = _split_operator(f"M_{level}", g,
                               HelmholtzOperatorGenerator(k, shift))
        restriction = system.Restriction(f"R_{level}", [
            base.Restriction("R_re", g, gc, rgen),
            base.Restriction("R_im", g, gc, rgen)])
        prolongation = system.Prolongation(f"P_{level}", [
            base.Prolongation("P_re", g, gc, pgen),
            base.Prolongation("P_im", g, gc, pgen)])
        approx = system.Approximation("z", [base.Approximation("u_re", g),
                                            base.Approximation("u_im", g)])
        contexts.append(LevelContext(operator=m_op, restriction=restriction,
                                     prolongation=prolongation,
                                     approximation=approx, grid=[g, g]))
    g_min = unit_interval_grid(2, min_level)
    coarsest = _split_operator(f"M_{min_level}", g_min,
                               HelmholtzOperatorGenerator(k, shift))

    grid = contexts[0].grid[0]
    rhs_entity = system.RightHandSide(
        "f", [base.RightHandSide("f_re", grid),
              base.RightHandSide("f_im", grid)])

    def rhs_builder(dtype=np.float32):
        # numpy float64 (re, im) in every precision; build_rhs casts
        f = _dirac_bspline_rhs(grid)
        return (np.ascontiguousarray(f.real), np.ascontiguousarray(f.imag))

    a_op = _split_operator(f"A_{max_level}", grid,
                           HelmholtzOperatorGenerator(k, 0.0))

    problem = Problem(name="Helmholtz2DSplit", dimension=2,
                      min_level=min_level, max_level=max_level,
                      fields=["u_re", "u_im"],
                      level_contexts=contexts, coarsest_operator=coarsest,
                      rhs_entity=rhs_entity, rhs_builder=rhs_builder,
                      target_reduction=1e-7, max_iterations=10000,
                      dtype=np.float32,
                      # (re, im) are ONE logical complex field: keep the
                      # grammar's smoother choices identical to the
                      # complex formulation's (decoupled == complex point
                      # division, not per-part diagonal)
                      coupled_fields=True)
    problem.outer_solver = OuterSolverSpec(
        name="PreconditionedBiCGStab", operator=a_op, tolerance=1e-7,
        max_iterations=10000, rhs_builder=rhs_builder, split=True)
    return problem


def dirichlet_helmholtz(max_level: int, min_level: int):
    """helmholtz_2d with every level operator and the coarsest replaced by
    a generator with only ``generate_stencil``: the shifted Laplacian with
    plain Dirichlet boundaries (k = 80, shift 0.5i), no Robin fold and no
    field form, built from the public IR as tests/test_pallas_cx.py:110-141
    builds it (the ``[main-cx]`` cell of chip_smoke.py)."""

    class ConstGen:
        def __init__(self, k, shift=0.0):
            self.k = k
            self.shift = shift

        def generate_stencil(self, grid):
            return _helmholtz_stencil(grid, self.k, self.shift)

    p = helmholtz_2d(max_level=max_level, min_level=min_level)
    contexts = []
    for ctx in p.level_contexts:
        op = system.Operator(ctx.operator.name, [[base.Operator(
            "M", ctx.grid[0], ConstGen(K_DEFAULT, SHIFT))]])
        contexts.append(LevelContext(
            operator=op, restriction=ctx.restriction,
            prolongation=ctx.prolongation,
            approximation=ctx.approximation, grid=ctx.grid))
    g_min = p.coarsest_operator.entries[0][0].grid
    p.coarsest_operator = system.Operator(
        p.coarsest_operator.name, [[base.Operator(
            "M", g_min, ConstGen(K_DEFAULT, SHIFT))]])
    p.level_contexts = contexts
    return p
