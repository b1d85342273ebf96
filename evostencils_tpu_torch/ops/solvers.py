"""The outer Krylov solves of the Helmholtz problems (counterpart of
evostencils_tpu/ops/solvers.py: the pytree helpers of :23-51 that they
use, ``preconditioned_bicgstab`` of :215-267 and the split-complex
``preconditioned_bicgstab_split`` with its helpers, :280-380, which here
share one loop).

Operands are tuples of field tensors.  A Python loop takes the place of
``lax.while_loop``: the stopping test reads one residual norm per
iteration back to the host, as ``compiler.solve.make_solver`` does; every
other scalar of the recurrence stays a 0-d tensor on the fields' device.
Not ported: the fixed-iteration solvers (``*_fixed``) and ``cg``.
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


def _zeros_like(x):
    return tuple(torch.zeros_like(xi) for xi in x)


def norm(x):
    return torch.sqrt(torch.real(_dot(x, x)))


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
