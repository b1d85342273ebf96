"""The outer Krylov solve of the Helmholtz problem (counterpart of
evostencils_tpu/ops/solvers.py: the pytree helpers of :23-51 that it
uses and ``preconditioned_bicgstab`` of :215-267).

Operands are tuples of field tensors.  A Python loop takes the place of
``lax.while_loop``: the stopping test reads one residual norm per
iteration back to the host, as ``compiler.solve.make_solver`` does; every
other scalar of the recurrence stays a 0-d tensor on the fields' device.
Not ported: the fixed-iteration solvers (``*_fixed``), ``cg`` and the
split-complex BiCGStab.
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


def preconditioned_bicgstab(matvec: Callable, precond: Callable, b,
                            *, tol: float = 1e-7, maxiter: int = 10000,
                            history_size: int = 0):
    """Right-preconditioned BiCGStab (reference Helmholtz solver:
    example_problems/Helmholtz/2D_FD_Helmholtz_fromL3.exa3:144-201, with
    ``gen_mgCycle()`` from a zero initial guess as the preconditioner).

    Returns ``(x, iterations, residual_history)``: the history has
    ``max(history_size, 1) + 1`` slots on the fields' device, entry k the
    residual norm after k iterations and the slots past the last
    iteration 0."""
    b = tuple(b)
    x = _zeros_like(b)
    r = b
    r_hat = r
    one = torch.ones((), dtype=b[0].dtype, device=b[0].device)
    rho = alpha = omega = one
    v = _zeros_like(b)
    p = _zeros_like(b)
    r0_norm = norm(r)
    hsize = max(history_size, 1)
    hist = torch.zeros(hsize + 1, dtype=r0_norm.dtype, device=r0_norm.device)
    hist[0] = r0_norm
    k, res = 0, r0_norm
    while k < maxiter and bool(res > tol * r0_norm):
        rho_new = _dot(r_hat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = _axpy(beta, _axpy(-omega, v, p), r)
        y = precond(p)
        v = matvec(y)
        alpha = rho_new / _dot(r_hat, v)
        h = _axpy(alpha, y, x)
        s = _axpy(-alpha, v, r)
        z = precond(s)
        t = matvec(z)
        omega = _dot(t, s) / _dot(t, t)
        x = _axpy(omega, z, h)
        r = _axpy(-omega, t, s)
        res = norm(r)
        if k + 1 <= hsize:
            hist[k + 1] = res
        k += 1
        rho = rho_new
    return x, k, hist
