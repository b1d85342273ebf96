"""Deep-convergence solves: iterative refinement with a float64 residual
around the native float32 (or bfloat16) multigrid cycle (counterpart of
evostencils_tpu/compiler/refine.py).

The reference validates solvers to 1e-12 (linear) / 1e-10 (FAS) relative
residual (reference scripts/evaluate_reference_solver.py:15-47, the
FAS_2D_Basic knowledge file).  A float32 V-cycle stalls near 1e-6 / 1e-7
relative, and a float32 FAS solve near 1e-3 of its start at 1023^2.  The
JAX package closes the gap on the TPU, which has no float64, by carrying
the solution as a double-float pair of float32 words and measuring the
residual in compensated df64 arithmetic (refine.py:1-23, ops/df64.py).
The H100 has native float64, so this module runs the same algorithm,
mixed-precision iterative refinement, in the card's own idiom:

* the solution ``u`` is a float64 tensor;
* each outer step measures the true residual ``r = b - A u`` (for FAS
  ``b - L u - gamma e^u u``) in float64 on the device, and its norm there:
  two scalars cross to the host, no grid;
* the correction equation ``A e = r`` is solved by a few cycles in the
  cycle's own precision (``r`` rounded to it, from a zero start), or for
  FAS by a Newton step, preconditioned Richardson on ``(L + g'(u)) e = r``;
* ``u += e`` in float64.

The float64 residual floors far below the df64 one (near 1e-13 to 1e-14
relative), so histories agree with the JAX package's only above that.
``RefineResult`` still splits the solution into a float32 pair
(``solution_hi`` + ``solution_lo``), the JAX result's fields.

Supports the scalar constant-stencil problems (Poisson-like) and the FAS
nonlinear operator A(u) = L u + gamma * exp(u) * u.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from ..ir import base, system
from ..ops.apply import apply_constant
from ..stencils.constant import Stencil
from .lower import LoweredCycle, _nonlinear_of


def _constant_scalar_stencil(lowered: LoweredCycle) -> Stencil:
    op = lowered.operator
    entries = op.entries if isinstance(op, system.Operator) else [[op]]
    if len(entries) != 1 or len(entries[0]) != 1:
        raise NotImplementedError(
            "refinement supports single-field problems")
    st = entries[0][0].generate_stencil()
    if st is None or not hasattr(st, "entries"):
        raise NotImplementedError("operator has no constant stencil")
    return st


def scalar_residual_f64_fn(stencil: Stencil, nl=None) -> Callable:
    """``residual(u, b) -> r``: the TRUE residual ``b - A u`` of a scalar
    constant-stencil operator, plus for FAS the nonlinearity of the
    generator ``nl`` (``nonlinear_term``, gamma e^u u), in float64: ``u``
    and ``b`` are widened to float64 first.  Replaces the JAX package's
    ``scalar_residual_df_fn`` (refine.py:89-115), whose df64 words and
    df64 exp stand in for the float64 the TPU lacks."""
    def residual(u, b):
        u = u.double()
        au = apply_constant(stencil, u)
        if nl is not None:
            au = au + nl.nonlinear_term(u)
        return b.double() - au
    return residual


def scaled_norm(fields):
    """The 2-norm of float64 ``fields`` on the device as ``(s, n2)``
    0-d tensors, the norm being ``s * sqrt(n2)``: each field is scaled by
    its max abs ``s`` (1 where it is 0) before squaring, as the JAX
    package's ``outer_step`` scales its df64 words (refine.py:249-267), so
    that the histories stay comparable.  With several fields, ``s`` is 1
    and ``n2`` sums each field's ``s_f^2 n2_f``."""
    parts = []
    for f in fields:
        s = f.abs().max()
        s = torch.where(s > 0, s, torch.ones_like(s))
        parts.append((s, torch.sum((f / s) ** 2)))
    if len(parts) == 1:
        return parts[0]
    return (torch.ones_like(parts[0][0]),
            sum(s * s * n2 for s, n2 in parts))


def read_norm(fields) -> float:
    """:func:`scaled_norm` read to the host: one transfer of two
    scalars."""
    s, n2 = torch.stack(scaled_norm(fields)).tolist()
    return s * float(np.sqrt(n2))


@dataclass
class RefineResult:
    solution_hi: object           # float32 words: solution_hi + solution_lo
    solution_lo: object           # is the float64 solution to ~1e-14
    residuals: List[float]        # f64 residual 2-norms per outer step
    outer_iterations: int
    converged: bool
    solution: object = None       # the float64 solution


def make_refined_solver(lowered: LoweredCycle, *,
                        inner_cycles: int = 10,
                        max_outer: int = 8,
                        target_reduction: float = 1e-12,
                        nonlinear: Optional[base.Operator] = None,
                        correction_lowered: Optional[LoweredCycle] = None,
                        richardson_iterations: int = 4,
                        omegas=None,
                        inner_dtype=None) -> Callable:
    """Build ``solve(b, u0=None) -> RefineResult`` reaching
    ``target_reduction`` relative residual, measured in float64 on the
    device (the JAX ``make_refined_solver``, refine.py:127-295).

    ``b`` is one field; its dtype is the cycles' precision (float32 in the
    deep solves) unless ``inner_dtype`` (e.g. ``torch.bfloat16``) asks for
    a lower one: the correction equation tolerates low precision, since
    refinement needs only a constant reduction per outer step.  The 2D
    legs keep bfloat16 in storage and compute in float32, as the TPU
    kernels do; pair it with a small ``inner_cycles`` (2-3).

    ``nonlinear``: the FAS problem's operator carrying ``nonlinear_term``.
    Then the residual is ``b - L u - g(u)`` in float64, and each outer
    step is a Newton step: ``(L + g'(u)) e = r`` solved by preconditioned
    Richardson iteration with ``correction_lowered`` (required) as the
    preconditioner, a cycle for the SHIFTED linear operator
    ``L + g'(u*) I`` (e.g. ``gallery.ShiftedOperatorGenerator(linear_gen,
    gamma)`` on the same hierarchy); the variable diagonal ``g'(u)`` is
    applied exactly in the Richardson matvec, in the cycles' precision.

    ``omegas``: the relaxation factors of ``lowered`` (default its own),
    float32 on ``b``'s device; the correction cycle takes its own
    defaults."""
    st = _constant_scalar_stencil(lowered)

    nl = None
    if nonlinear is not None:
        found = _nonlinear_of(nonlinear)
        if found is None:
            raise ValueError(
                f"{nonlinear} carries no nonlinear protocol "
                "(nonlinear_term/nonlinear_derivative on its generator)")
        nl = found[0]   # the generator carrying the nonlinear callables
        if correction_lowered is None:
            raise ValueError(
                "nonlinear refinement requires correction_lowered (a cycle "
                "for the SHIFTED linear part, see docstring)")
    residual_f64 = scalar_residual_f64_fn(st, nl)

    def relaxation(cycle, given, device):
        vals = cycle.default_omegas if given is None else given
        return torch.as_tensor(vals, dtype=torch.float32, device=device)

    def cycles(cycle, om, v):
        """``inner_cycles`` cycles on ``cycle e = v`` from zero, in
        ``inner_dtype`` if given, else in ``v``'s dtype; the carry is cast
        back to that dtype after each step (the coarse levels may promote),
        so that the fine-level kernels stay in it."""
        v_in = v if inner_dtype is None else v.to(inner_dtype)
        e = (torch.zeros_like(v_in),)
        for _ in range(inner_cycles):
            e = tuple(x.to(v_in.dtype) for x in cycle.step(e, (v_in,), om))
        return e[0].to(v.dtype)

    if nl is None:
        def correct(u, rh, om):
            """``inner_cycles`` cycles on ``A e = r`` from a zero start,
            ``u += e`` in float64."""
            return u + cycles(lowered, om, rh).double()
    else:
        dg = nl.nonlinear_derivative

        def correct(u, rh, om):
            """Newton step: preconditioned Richardson on
            ``(L + g'(u)) e = r``, ``u += e`` in float64."""
            c_om = relaxation(correction_lowered, None, rh.device)
            c = dg(u.to(rh.dtype))

            def B(v):
                return apply_constant(st, v) + c * v

            def M(v):
                return cycles(correction_lowered, c_om, v)

            x = M(rh)
            for _ in range(richardson_iterations - 1):
                x = x + M(rh - B(x))
            return u + x.double()

    def outer_step(u, b):
        """The float64 residual and its norm: the norm is read to the host
        (two scalars), the residual, rounded to ``b``'s dtype, returned
        for the correction."""
        r = residual_f64(u, b)
        return r.to(b.dtype), read_norm((r,))

    def solve(b, u0=None) -> RefineResult:
        om = relaxation(lowered, omegas, b.device)
        u = torch.zeros_like(b, dtype=torch.float64) if u0 is None \
            else torch.as_tensor(u0, device=b.device).double()
        hist: List[float] = []
        bnorm = float(torch.linalg.vector_norm(b.double()))
        converged = False
        outer = 0
        for outer in range(1, max_outer + 1):
            rh, rnorm = outer_step(u, b)
            hist.append(rnorm)
            if rnorm <= target_reduction * bnorm:
                converged = True
                break
            u = correct(u, rh, om)
        else:
            # max_outer corrections applied; measure the last one's
            # residual so a solve that reaches the target on the final
            # correction reports converged=True
            _, rnorm = outer_step(u, b)
            hist.append(rnorm)
            converged = rnorm <= target_reduction * bnorm
        hi = u.float()
        return RefineResult(hi, (u - hi.double()).float(), hist, outer,
                            converged, u)

    return solve
