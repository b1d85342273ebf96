"""Split-complex outer Krylov solves to a TRUE residual, with a float64
residual and solution around the float32 recurrence (counterpart of
evostencils_tpu/compiler/refine_split.py).

The reference's Helmholtz protocol runs PreconditionedBiCGStab to 1e-7
relative residual in float64 C++ (reference
example_problems/Helmholtz/2D_FD_Helmholtz_fromL3.exa3:144-201, target
:192).  A float32 BiCGStab's recurrence residual drifts from the true
residual on this indefinite operator (the complex64 solve at k = 80 ends
with a true residual near 2e-5 against the recurrence's 1e-7), so one
float32 solve cannot certify 1e-7.  The JAX package measures the true
residual in compensated df64 arithmetic and accumulates the solution as a
double-float pair, because the TPU has no float64; here both are float64
tensors, and the recurrence, the matvec and the V-cycle preconditioner
stay float32:

* :func:`reliable_bicgstab_split`: one continuous BiCGStab process whose
  recurrence residual is replaced by the true float64 residual every
  ``segment`` iterations (van der Vorst & Ye reliable updates);
* :func:`refined_bicgstab_split`: iterative refinement, restarting a
  float32 BiCGStab on the residual equation;
* :func:`f64_basis_bicgstab_split` (the JAX ``df64_basis_bicgstab_split``):
  the whole recurrence in float64 (vectors, dots, scalars, the matvec of
  :func:`split_system_matvec_f64`), only the preconditioner float32,
  called through a cast in and out.

The JAX module's double-float helpers (``_df_div``, ``_cdf``,
``_cdf_mul``, ``_cdf_div``, ``_cdf_neg``, ``_vdf_zero``, ``_vdf_from``,
``_vdf_halves``, ``_vdf_join``, ``_df_dot_field``, ``_cdot_df``,
``_caxpy_df``, ``_vdf_norm2``; refine_split.py:353-456) have no
counterpart: float64 tensors and the split helpers of ``ops/solvers``
(dtype-generic) take their place.

The operator class supported is what the split-complex Helmholtz
produces: an FxF block system whose entries are constant stencils plus
constant-per-row center deltas (the Robin boundary fold,
problems/helmholtz.py HelmholtzOperatorGenerator).
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

from ..ir import system
from ..ops.apply import apply_constant
from ..ops.solvers import (_caxpy_split, _cdiv_s, _cdot_split, _cmul_s,
                           _cneg_s, _zeros_like, norm)
from ..stencils.constant import Stencil
from .lower import _stencil_field_of
from .refine import read_norm


def _entry_parts(entry):
    """Decompose one block entry into (stencil, row_fixups): the constant
    interior stencil's nonzero float64 coefficients as a ``Stencil``
    (None when every one is 0), plus per-row center-delta fixups
    [(row, delta)] (the JAX ``_entry_df_parts``, refine_split.py:39-79).
    Raises when the entry is outside the constant+row-delta class."""
    st = entry.generate_stencil()
    sf = _stencil_field_of(entry)
    nonzero = [(tuple(offset), float(value)) for offset, value in st.entries
               if float(value) != 0.0]
    stencil = Stencil(nonzero, st.dimension) if nonzero else None
    fixups: List[Tuple[int, float]] = []
    if sf is not None:
        base_vals = {tuple(o): float(v) for o, v in st.entries}
        for off, f in zip(sf.offsets, sf.fields):
            f = np.asarray(f, dtype=np.float64)
            delta = f - base_vals.get(tuple(off), 0.0)
            rows = np.nonzero(np.any(delta != 0.0, axis=tuple(
                range(1, delta.ndim))))[0]
            if rows.size == 0:
                continue
            if tuple(off) != (0,) * delta.ndim:
                raise NotImplementedError(
                    "df64 split residual: only center-offset row deltas "
                    f"supported (got delta at offset {off})")
            for r in rows:
                row = delta[int(r)]
                if np.ptp(row) != 0.0:
                    raise NotImplementedError(
                        "df64 split residual: per-row delta must be "
                        "constant along the row")
                fixups.append((int(r), float(row.flat[0])))
    return stencil, fixups


def split_system_matvec_f64(op: system.Operator) -> Callable:
    """``matvec(u) -> A u`` over float64 field tuples for an FxF block
    system of constant+row-delta entries (the JAX
    ``split_system_matvec_df``, refine_split.py:458-488): each field is
    widened to float64 first."""
    parts = [[_entry_parts(e) for e in row] for row in op.entries]

    def matvec(u):
        u = tuple(f.double() for f in u)
        out = []
        for row in parts:
            acc = torch.zeros_like(u[0])
            for (stencil, fixups), uj in zip(row, u):
                if stencil is not None:
                    acc = acc + apply_constant(stencil, uj)
                for r, delta in fixups:
                    acc[r] = acc[r] + delta * uj[r]
            out.append(acc)
        return tuple(out)

    return matvec


def split_system_residual_f64(op: system.Operator) -> Callable:
    """``residual(u, b) -> b - A u`` over field tuples, in float64, for
    the system class of :func:`split_system_matvec_f64` (the JAX
    ``split_system_residual_df``, refine_split.py:82-111, with its per-row
    center fixups of the Robin fold)."""
    matvec = split_system_matvec_f64(op)

    def residual(u, b):
        return tuple(bi.double() - ai for bi, ai in zip(b, matvec(u)))

    return residual


def reliable_bicgstab_split(matvec: Callable, precond: Callable,
                            residual_f64: Callable, b, *,
                            tol: float = 1e-7, maxiter: int = 10000,
                            segment: int = 40, verbose: bool = False):
    """Right-preconditioned split-complex BiCGStab with the solution
    accumulated in float64 and periodic RESIDUAL REPLACEMENT (van der Vorst
    & Ye reliable updates; the JAX ``reliable_bicgstab_split``,
    refine_split.py:127-283): one continuous Krylov process, unlike
    iterative-refinement restarts, which repeat the indefinite-Helmholtz
    plateau phase on every restart.

    ``matvec`` and ``precond`` work in ``b``'s dtype (float32), as the
    recurrence does.  Every ``segment`` iterations the recurrence residual
    r is replaced by the TRUE float64 residual ``b - A x`` rounded to that
    dtype; r_hat, p and the recurrence scalars carry over, and the next
    iteration recomputes ``rho = <r_hat, r>`` from the replaced r.  A
    segment also ends when the recurrence residual falls under its limit
    (one norm read per iteration).

    Returns ``(x, total_iterations, outer_history)``: ``x`` the float64
    solution fields, ``outer_history`` the TRUE relative residual at each
    replacement point."""
    b = tuple(b)
    dtype = b[0].dtype
    zero_b = _zeros_like(b)
    one = torch.ones((), dtype=dtype, device=b[0].device)
    cone = (one, torch.zeros_like(one))

    def measure(x):
        """The TRUE float64 residual, rounded to the recurrence's dtype,
        and its norm (two scalars to the host)."""
        r = residual_f64(x, b)
        return tuple(f.to(dtype) for f in r), read_norm(r)

    bnorm = measure(tuple(f.double() for f in zero_b))[1]

    def run_segment(x, r, r_hat, v, p, rho, alpha, omega, limit_res):
        """Up to ``segment`` BiCGStab iterations; stops early when the
        recurrence residual falls under ``limit_res``."""
        k_in, res = 0, norm(r)
        while k_in < segment and bool(res > limit_res):
            rho_new = _cdot_split(r_hat, r)
            beta = _cmul_s(_cdiv_s(rho_new, rho), _cdiv_s(alpha, omega))
            p = _caxpy_split(beta, _caxpy_split(_cneg_s(omega), v, p), r)
            y = precond(p)
            v = matvec(y)
            alpha = _cdiv_s(rho_new, _cdot_split(r_hat, v))
            s = _caxpy_split(_cneg_s(alpha), v, r)
            z = precond(s)
            t = matvec(z)
            tt = _cdot_split(t, t)
            omega = _cdiv_s(_cdot_split(t, s), tt)
            # solution increment alpha*y + omega*z, accumulated in float64
            inc = _caxpy_split(omega, z, _caxpy_split(alpha, y, zero_b))
            x = tuple(xi + ii.double() for xi, ii in zip(x, inc))
            r = _caxpy_split(_cneg_s(omega), t, s)
            res = norm(r)
            rho = rho_new
            k_in += 1
        return x, r, v, p, rho, alpha, omega, k_in, res

    x = tuple(f.double() for f in zero_b)
    r = b
    r_hat = b
    v = zero_b
    p = zero_b
    rho = alpha = omega = cone
    limit = tol * bnorm
    total_k = 0
    history = []
    rel = 1.0
    #: long float32 runs (thousands of iterations at high k) degrade the
    #: Krylov BASIS itself; residual replacement cannot fix that.  On
    #: stall/divergence, roll back to the best float64 iterate and RESTART
    #: the Krylov process from its true residual: the accumulated solution
    #: is kept, only the Krylov state is rebuilt.
    best = (x, b, 1.0)
    stall = 0
    restarts = 0
    max_restarts = 40
    while total_k < maxiter:
        (x, r, v, p, rho, alpha, omega, k_in, res) = run_segment(
            x, r, r_hat, v, p, rho, alpha, omega, limit)
        total_k += k_in
        r_true, rnorm = measure(x)
        rel = rnorm / bnorm
        history.append(rel)
        if verbose:
            print(f"[reliable-bicgstab] k={total_k} true rel={rel:.3e} "
                  f"recurrence={float(res) / bnorm:.3e}", flush=True)
        if rel <= tol:
            break
        # "stall" = NO improvement at all across several replacements:
        # slow geometric convergence (rho^segment close to 1 at doubled k)
        # must NOT trigger restarts, or the Krylov space never builds
        if np.isfinite(rel) and rel < 0.995 * best[2]:
            best = (x, r_true, rel)
            stall = 0
        else:
            stall += 1
        # restart ONLY in the small-residual regime (the float32 wall) or
        # on breakdown: indefinite-Helmholtz BiCGStab has long NATURAL
        # plateaus early on that a restart would reset forever
        if not np.isfinite(rel) or rel > 50 * best[2] or \
                (stall >= 5 and best[2] < 1e-3):
            if restarts >= max_restarts:
                break
            restarts += 1
            x, r_true, _ = best
            r = r_true
            r_hat = r_true               # fresh shadow residual
            v = zero_b
            p = zero_b
            rho = alpha = omega = cone
            stall = 0
            if verbose:
                print(f"[reliable-bicgstab] restart {restarts} from "
                      f"rel={best[2]:.3e}", flush=True)
            continue
        r = r_true                       # residual replacement
        if k_in < segment:
            # the recurrence claimed convergence below ``limit`` but the
            # true residual disagrees: tighten the recurrence target
            limit = limit * 0.25
    return x, total_k, history


def refined_bicgstab_split(matvec: Callable, precond: Callable,
                           residual_f64: Callable, b, *,
                           tol: float = 1e-7, maxiter: int = 10000,
                           inner_tol: float = 1e-4, max_outer: int = 8,
                           verbose: bool = False):
    """Right-preconditioned split-complex BiCGStab to TRUE relative
    residual ``tol`` by iterative refinement (the JAX
    ``refined_bicgstab_split``, refine_split.py:286-350): each outer step
    runs a float32 BiCGStab on the residual equation ``A e = r`` and adds
    ``e`` to the float64 solution.

    Returns ``(x, total_iterations, outer_history)``: ``x`` the float64
    solution fields, ``outer_history`` the float64 true relative residual
    after each inner solve, ``total_iterations`` the INNER BiCGStab
    iterations of every restart, the number comparable to the reference's
    iteration count."""
    from ..ops.solvers import preconditioned_bicgstab_split

    b = tuple(b)
    dtype = b[0].dtype
    x = tuple(torch.zeros_like(f, dtype=torch.float64) for f in b)
    bnorm = read_norm(tuple(f.double() for f in b))
    rel = 1.0
    r_cur = b
    total_k = 0
    history = []
    for outer in range(max_outer):
        if rel <= tol or total_k >= maxiter:
            break
        # aim the inner solve at the remaining reduction, floored by what
        # float32 can certify; x0.1 safety so one restart is usually enough
        itol = max(0.1 * tol / rel, inner_tol * 0.1)
        itol = min(itol, inner_tol)
        e, k, _ = preconditioned_bicgstab_split(
            matvec, precond, r_cur, tol=itol, maxiter=maxiter,
            history_size=0)
        total_k += k
        x = tuple(xi + ei.double() for xi, ei in zip(x, e))
        r = residual_f64(x, b)
        rel = read_norm(r) / bnorm
        history.append(rel)
        if verbose:
            print(f"[refined-bicgstab] outer {outer + 1}: inner {k} "
                  f"iterations, true rel residual {rel:.3e} "
                  f"(total {total_k})", flush=True)
        r_cur = tuple(f.to(dtype) for f in r)
    return x, total_k, history


def f64_basis_bicgstab_split(matvec_f64: Callable, precond: Callable,
                             residual_f64: Callable, b, *,
                             tol: float = 1e-7, maxiter: int = 10000,
                             segment: int = 100, verbose: bool = False):
    """Right-preconditioned split-complex BiCGStab with the ENTIRE Krylov
    recurrence in float64 (vectors, dots, scalars and ``matvec_f64``,
    e.g. :func:`split_system_matvec_f64`); only the V-cycle preconditioner
    runs in ``b``'s dtype (float32), called through a cast in and out (the
    JAX ``df64_basis_bicgstab_split``, refine_split.py:491-595, with
    float64 in place of its df64 words).  Residual replacement every
    ``segment`` iterations and restarts on breakdown as there.

    Returns ``(x, total_iterations, history)``: ``x`` the float64
    solution fields, ``history`` the true relative residual at each
    replacement point."""
    b = tuple(b)
    dtype = b[0].dtype
    b64 = tuple(f.double() for f in b)
    one = torch.ones((), dtype=torch.float64, device=b[0].device)
    cone = (one, torch.zeros_like(one))

    def precond64(fields):
        return tuple(f.double()
                     for f in precond(tuple(g.to(dtype) for g in fields)))

    def measure(x):
        r = residual_f64(x, b)
        return r, read_norm(r)

    zero = _zeros_like(b64)
    bnorm = measure(zero)[1]

    def run_segment(x, r, v, p, rho, alpha, omega, r_hat, limit_res):
        k_in, res = 0, norm(r)
        while k_in < segment and bool(res > limit_res):
            rho_new = _cdot_split(r_hat, r)
            beta = _cmul_s(_cdiv_s(rho_new, rho), _cdiv_s(alpha, omega))
            p = _caxpy_split(beta, _caxpy_split(_cneg_s(omega), v, p), r)
            y = precond64(p)
            v = matvec_f64(y)
            alpha = _cdiv_s(rho_new, _cdot_split(r_hat, v))
            s = _caxpy_split(_cneg_s(alpha), v, r)
            z = precond64(s)
            t = matvec_f64(z)
            omega = _cdiv_s(_cdot_split(t, s), _cdot_split(t, t))
            x = _caxpy_split(omega, z, _caxpy_split(alpha, y, x))
            r = _caxpy_split(_cneg_s(omega), t, s)
            res = norm(r)
            rho = rho_new
            k_in += 1
        return x, r, v, p, rho, alpha, omega, k_in, res

    limit = tol * bnorm
    x = zero
    r = b64
    r_hat = b64
    v = zero
    p = zero
    rho = alpha = omega = cone
    total_k = 0
    history = []
    rel = 1.0
    # reliable updates ON TOP of the float64 basis: the recurrence still
    # accumulates x-r drift proportional to its epsilon times the
    # indefinite-Helmholtz intermediate spikes; replacing r with the true
    # residual every segment resets the drift
    best = (x, b64, 1.0)
    restarts = 0
    while total_k < maxiter:
        (x, r, v, p, rho, alpha, omega, k_in, res) = run_segment(
            x, r, v, p, rho, alpha, omega, r_hat, limit)
        total_k += k_in
        r_true, rnorm = measure(x)
        rel = rnorm / bnorm
        history.append(rel)
        if verbose:
            print(f"[f64-bicgstab] k={total_k} true rel={rel:.3e} "
                  f"recurrence={float(res) / bnorm:.3e}", flush=True)
        if rel <= tol:
            break
        if np.isfinite(rel) and rel < best[2]:
            best = (x, r_true, rel)
        if not np.isfinite(rel) or rel > 50 * best[2]:
            # Krylov breakdown: roll back to the best iterate and rebuild
            # the process from its true residual (the accumulated solution
            # survives; only the Krylov state is reset)
            if restarts >= 40:
                break
            restarts += 1
            x, r, _ = best
            r_hat = r
            v = zero
            p = zero
            rho = alpha = omega = cone
            if verbose:
                print(f"[f64-bicgstab] restart {restarts} from "
                      f"rel={best[2]:.3e}", flush=True)
            continue
        r = r_true                       # residual replacement
        if k_in < segment and float(res) <= limit:
            # recurrence under target but true residual above: tighten
            limit = limit * 0.25
    return x, total_k, history
