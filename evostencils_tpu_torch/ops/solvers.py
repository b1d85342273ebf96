"""Matrix-free Krylov solvers over tuples of field tensors (counterpart of
evostencils_tpu/ops/solvers.py: the pytree helpers of :23-51, ``cg`` of
:54-81, the fixed-iteration executors of :84-214 and ``FIXED_KRYLOV`` of
:270, ``preconditioned_bicgstab`` of :215-267 and the split-complex
``preconditioned_bicgstab_split`` with its helpers, :280-380, which here
share one loop).

Every scalar of a recurrence stays a 0-d tensor on the fields' device.
Python loops take the place of ``lax.fori_loop`` and ``lax.while_loop``:

* the fixed-iteration executors (``*_fixed``) have no early exit and read
  nothing back to the host;
* ``cg`` reads its stopping test back once every ``CG_CHECK_EVERY``
  iterations and freezes its state on the device from the iteration at
  which the JAX loop's condition fails, so that it returns that
  iteration's ``x``;
* the outer BiCGStab reads one residual norm per iteration back, as
  ``compiler.solve.make_solver`` does.
"""

from __future__ import annotations

from typing import Callable

import torch


def _dot(a, b):
    """Inner product <a, b> over tuples of fields; conjugates ``a`` for
    complex dtypes (``jnp.vdot``)."""
    return sum(torch.vdot(x.reshape(-1), y.reshape(-1)) for x, y in zip(a, b))


def _axpy(alpha, x, y):
    return tuple(alpha * xi + yi for xi, yi in zip(x, y))


def _scale(alpha, x):
    return tuple(alpha * xi for xi in x)


def _sub(x, y):
    return tuple(a - b for a, b in zip(x, y))


def _zeros_like(x):
    return tuple(torch.zeros_like(xi) for xi in x)


def norm(x):
    return torch.sqrt(torch.real(_dot(x, x)))


def _guarded(den, q):
    """``jnp.where(den == 0, 0.0, q)``: the executors' guard against a zero
    denominator, which keeps a breakdown from carrying NaN."""
    return torch.where(den == 0, torch.zeros_like(q), q)


#: iterations of ``cg`` between two reads of its stopping test on the host
CG_CHECK_EVERY = 16

#: what ``cg`` has done since the counts were last set to 0: solves, host
#: syncs and iterations (a 0-d tensor on the device once a solve ran, so
#: that counting reads nothing back; the caller reads it)
cg_counts = {"solves": 0, "syncs": 0, "iterations": 0}


def reset_cg_counts():
    cg_counts.update(solves=0, syncs=0, iterations=0)


def cg(matvec: Callable, b, x0=None, *, tol: float = 1e-12,
       maxiter: int = 1000):
    """Conjugate gradients to relative tolerance ``tol`` (solvers.py:54-81;
    the reference solver config ``generate solver ... cgs cg`` with
    1e-12/1000, example_problems/Poisson/2D_FD_Poisson_fromL2.exa3:1-14):
    iterate while the recurrence residual's ``<r, r>`` exceeds
    ``tol**2 * <b, b>`` and fewer than ``maxiter`` iterations ran.

    The test is read on the host once every ``CG_CHECK_EVERY`` iterations.
    Between two reads each iteration computes its update and keeps it only
    while the condition held before it (``torch.where`` on a device
    flag), so the returned ``x`` is that of the JAX loop's last iteration
    whichever iteration that is; the iterations past it until the next read
    compute and discard."""
    b = tuple(b)
    x = _zeros_like(b) if x0 is None else tuple(x0)
    r = _sub(b, matvec(x)) if x0 is not None else b
    p = r
    rs = _dot(r, r)
    threshold = tol * tol * torch.real(_dot(b, b))
    live = torch.real(rs) > threshold
    done = torch.zeros((), dtype=torch.int64, device=b[0].device)
    k = 0
    while k < maxiter:
        if k % CG_CHECK_EVERY == 0:
            cg_counts["syncs"] += 1
            if not bool(live):
                break
        ap = matvec(p)
        alpha = rs / _dot(p, ap)
        x_new = _axpy(alpha, p, x)
        r_new = _axpy(-alpha, ap, r)
        rs_new = _dot(r_new, r_new)
        p_new = _axpy(rs_new / rs, p, r_new)
        x = tuple(torch.where(live, a, c) for a, c in zip(x_new, x))
        r = tuple(torch.where(live, a, c) for a, c in zip(r_new, r))
        p = tuple(torch.where(live, a, c) for a, c in zip(p_new, p))
        rs = torch.where(live, rs_new, rs)
        done = done + live.to(done.dtype)
        live = live & (torch.real(rs) > threshold)
        k += 1
    cg_counts["solves"] += 1
    cg_counts["iterations"] = cg_counts["iterations"] + done
    return x


def cg_fixed(matvec: Callable, b, iterations: int, x0=None):
    """CG with a fixed iteration count (solvers.py:84-104; a Krylov
    smoother or coarse solve inside a cycle)."""
    b = tuple(b)
    x = _zeros_like(b) if x0 is None else tuple(x0)
    r = b if x0 is None else _sub(b, matvec(x))
    p = r
    rs = _dot(r, r)
    for _ in range(iterations):
        ap = matvec(p)
        denom = _dot(p, ap)
        alpha = _guarded(denom, rs / denom)
        x = _axpy(alpha, p, x)
        r = _axpy(-alpha, ap, r)
        rs_new = _dot(r, r)
        beta = _guarded(rs, rs_new / rs)
        p = _axpy(beta, p, r)
        rs = rs_new
    return x


def bicgstab_fixed(matvec: Callable, b, iterations: int, x0=None):
    """BiCGStab with a fixed iteration count (solvers.py:107-132;
    non-symmetric and complex operators)."""
    b = tuple(b)
    x = _zeros_like(b) if x0 is None else tuple(x0)
    r = b if x0 is None else _sub(b, matvec(x))
    r_hat = r
    p = r
    rho = _dot(r_hat, r)
    for _ in range(iterations):
        v = matvec(p)
        denom = _dot(r_hat, v)
        alpha = _guarded(denom, rho / denom)
        s = _axpy(-alpha, v, r)
        t = matvec(s)
        tt = _dot(t, t)
        omega = _guarded(tt, _dot(t, s) / tt)
        x = _axpy(alpha, p, _axpy(omega, s, x))
        r = _axpy(-omega, t, s)
        rho_new = _dot(r_hat, r)
        beta = _guarded(rho * omega, (rho_new / rho) * (alpha / omega))
        p = _axpy(beta, _axpy(-omega, v, p), r)
        rho = rho_new
    return x


def conjugate_residual_fixed(matvec: Callable, b, iterations: int, x0=None):
    """Conjugate Residual method with a fixed iteration count
    (solvers.py:135-158; symmetric indefinite operators)."""
    b = tuple(b)
    x = _zeros_like(b) if x0 is None else tuple(x0)
    r = b if x0 is None else _sub(b, matvec(x))
    p = r
    ar = matvec(r)
    ap = ar
    for _ in range(iterations):
        rar = _dot(r, ar)
        denom = _dot(ap, ap)
        alpha = _guarded(denom, rar / denom)
        x = _axpy(alpha, p, x)
        r = _axpy(-alpha, ap, r)
        ar_new = matvec(r)
        beta = _guarded(rar, _dot(r, ar_new) / rar)
        p = _axpy(beta, p, r)
        ap = _axpy(beta, ap, ar_new)
        ar = ar_new
    return x


def minres_fixed(matvec: Callable, b, iterations: int, x0=None):
    """MINRES (Paige and Saunders: Lanczos tridiagonalization and Givens
    QR) with a fixed iteration count (solvers.py:161-212).  The rotation
    scalars are real (a Hermitian operator has real Lanczos alpha and
    beta); a breakdown (``rho1 == 0``, the solution reached) freezes the
    iteration."""
    b = tuple(b)
    x = _zeros_like(b) if x0 is None else tuple(x0)
    r = b if x0 is None else _sub(b, matvec(x))
    beta1 = norm(r)
    v = _scale(1.0 / torch.where(beta1 == 0, torch.ones_like(beta1), beta1),
               r)
    v_old = _zeros_like(b)
    w0 = _zeros_like(b)
    w1 = _zeros_like(b)
    eta = beta1
    one = torch.ones_like(beta1)
    zero = torch.zeros_like(beta1)
    gamma0 = gamma1 = one
    sigma0 = sigma1 = zero
    beta = zero
    for _ in range(iterations):
        av = matvec(v)
        alpha = torch.real(_dot(v, av))        # Hermitian => real
        w = _axpy(-alpha, v, av)
        w = _axpy(-beta, v_old, w)
        beta_new = norm(w)
        # Givens QR of the tridiagonal column
        delta = gamma1 * alpha - gamma0 * sigma1 * beta
        rho1 = torch.sqrt(delta * delta + beta_new * beta_new)
        rho2 = sigma1 * alpha + gamma0 * gamma1 * beta
        rho3 = sigma0 * beta
        live = rho1 > 0                       # breakdown: solution reached
        rho1_s = torch.where(live, rho1, one)
        gamma_new = torch.where(live, delta / rho1_s, one)
        sigma_new = torch.where(live, beta_new / rho1_s, zero)
        w_new = _axpy(-rho3, w0, _axpy(-rho2, w1, v))
        w_new = _scale(torch.where(live, 1.0 / rho1_s, zero), w_new)
        x = _axpy(gamma_new * eta, w_new, x)
        eta = -sigma_new * eta
        beta_s = torch.where(beta_new == 0, one, beta_new)
        v_next = _scale(1.0 / beta_s, w)
        v, v_old, w0, w1 = v_next, v, w1, w_new
        gamma0, gamma1, sigma0, sigma1 = gamma1, gamma_new, sigma1, sigma_new
        beta = beta_new
    return x


#: the fixed executors by ``KrylovSubspaceMethod`` name (solvers.py:270)
FIXED_KRYLOV = {
    "CG": cg_fixed,
    "BiCGStab": bicgstab_fixed,
    "MinRes": minres_fixed,
    "ConjugateResidual": conjugate_residual_fixed,
}


# The split-complex form (solvers.py:280-380) carries F complex vectors as
# 2F real tensors [re_0..re_{F-1}, im_0..im_{F-1}] and complex scalars as
# (re, im) pairs of real 0-d tensors, so every tensor of the solve is real;
# algebraically the same as the complex form, its rounding that of the JAX
# package's split solve.

def _csplit(fields):
    h = len(fields) // 2
    return fields[:h], fields[h:]


def _cdot_split(a, b):
    """Complex <a, b> (conjugating a) on split fields; returns (re, im)."""
    ar, ai = _csplit(a)
    br, bi = _csplit(b)
    re = _dot(ar, br) + _dot(ai, bi)
    im = _dot(ar, bi) - _dot(ai, br)
    return re, im


def _cmul_s(a, b):
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def _cdiv_s(a, b):
    """a / b, and 0 where b is 0: the split form carries no NaN out of a
    breakdown."""
    d = b[0] * b[0] + b[1] * b[1]
    d = torch.where(d == 0, torch.ones_like(d), d)
    return ((a[0] * b[0] + a[1] * b[1]) / d,
            (a[1] * b[0] - a[0] * b[1]) / d)


def _cneg_s(a):
    return -a[0], -a[1]


def _caxpy_split(alpha, x, y):
    """y + alpha * x with complex scalar pair ``alpha`` on split fields."""
    xr, xi = _csplit(x)
    yr, yi = _csplit(y)
    ar, ai = alpha
    re = tuple(r + ar * vr - ai * vi for r, vr, vi in zip(yr, xr, xi))
    im = tuple(r + ar * vi + ai * vr for r, vr, vi in zip(yi, xr, xi))
    return tuple(re) + tuple(im)


def preconditioned_bicgstab(matvec: Callable, precond: Callable, b,
                            *, tol: float = 1e-7, maxiter: int = 10000,
                            history_size: int = 0, split: bool = False):
    """Right-preconditioned BiCGStab (reference Helmholtz solver:
    example_problems/Helmholtz/2D_FD_Helmholtz_fromL3.exa3:144-201, with
    ``gen_mgCycle()`` from a zero initial guess as the preconditioner).
    With ``split`` the fields are split-complex (see the note above).

    Returns ``(x, iterations, residual_history)``: the history has
    ``max(history_size, 1) + 1`` slots on the fields' device, entry k the
    residual norm after k iterations and the slots past the last
    iteration 0."""
    b = tuple(b)
    one = torch.ones((), dtype=b[0].dtype, device=b[0].device)
    if split:
        dot, axpy, div, mul, neg = (_cdot_split, _caxpy_split, _cdiv_s,
                                    _cmul_s, _cneg_s)
        one = (one, torch.zeros_like(one))
    else:
        dot, axpy, div, mul, neg = (_dot, _axpy, torch.div, torch.mul,
                                    torch.neg)
    x = _zeros_like(b)
    r = b
    r_hat = r
    rho = alpha = omega = one
    v = _zeros_like(b)
    p = _zeros_like(b)
    r0_norm = norm(r)
    hsize = max(history_size, 1)
    hist = torch.zeros(hsize + 1, dtype=r0_norm.dtype, device=r0_norm.device)
    hist[0] = r0_norm
    k, res = 0, r0_norm
    while k < maxiter and bool(res > tol * r0_norm):
        rho_new = dot(r_hat, r)
        beta = mul(div(rho_new, rho), div(alpha, omega))
        p = axpy(beta, axpy(neg(omega), v, p), r)
        y = precond(p)
        v = matvec(y)
        alpha = div(rho_new, dot(r_hat, v))
        h = axpy(alpha, y, x)
        s = axpy(neg(alpha), v, r)
        z = precond(s)
        t = matvec(z)
        omega = div(dot(t, s), dot(t, t))
        x = axpy(omega, z, h)
        r = axpy(neg(omega), t, s)
        res = norm(r)
        if k + 1 <= hsize:
            hist[k + 1] = res
        k += 1
        rho = rho_new
    return x, k, hist


def preconditioned_bicgstab_split(matvec: Callable, precond: Callable, b,
                                  **options):
    """:func:`preconditioned_bicgstab` on split-complex fields: ``b``,
    ``matvec``'s and ``precond``'s fields and ``x`` are real."""
    return preconditioned_bicgstab(matvec, precond, b, split=True,
                                   **options)
