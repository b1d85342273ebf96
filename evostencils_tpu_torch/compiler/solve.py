"""Iterative solver loops and measurement protocol (counterpart of
evostencils_tpu/compiler/solve.py:32-221).

Python loops take the place of ``lax.while_loop`` and ``lax.scan``.  The
solver's stopping test reads one residual norm per iteration back to the
host; the cycle loop reads nothing back.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .lower import LoweredCycle, _Lowering


def residual_norm_fn(operator):
    """``res_norm(u_fields, b_fields) -> ||b - A u||_2`` as a 0-d tensor,
    computed by the generic (unfused) operator application."""
    def res_norm(u_fields, b_fields):
        low = _Lowering(None, None, None)
        low.set_like(u_fields[0])
        ax = low.apply_operator(operator, tuple(u_fields))
        return torch.sqrt(sum(torch.sum(torch.abs(b - a) ** 2)
                              for b, a in zip(b_fields, ax)))
    return res_norm


def make_solver(lowered: LoweredCycle, max_iterations: int = 100,
                target_reduction: float = 1e-12):
    """``run(u0, b, omegas) -> (u, iterations, residual_history)``: cycle
    until the residual drops below ``target_reduction`` times the initial
    one or ``max_iterations`` cycles ran.

    ``residual_history`` has ``max_iterations + 1`` entries on the fields'
    device: entry k is the residual norm after k cycles (entry 0 the
    initial residual) and entries past the last cycle are 0, as in the JAX
    solver.  The stopping test is evaluated on the device in the fields'
    dtype, as there."""
    res_norm = residual_norm_fn(lowered.operator)

    def run(u_fields, b_fields, omegas):
        r0 = res_norm(u_fields, b_fields)
        history = torch.zeros(max_iterations + 1, dtype=r0.dtype,
                              device=r0.device)
        history[0] = r0
        u, k, r = tuple(u_fields), 0, r0
        while k < max_iterations and bool(r > target_reduction * r0):
            u = lowered.step(u, b_fields, omegas)
            r = res_norm(u, b_fields)
            k += 1
            history[k] = r
        return u, k, history

    return run


def make_cycle_loop(lowered: LoweredCycle, n_cycles: int):
    """``run(u0, b, omegas) -> u`` applying ``n_cycles`` full cycles with no
    convergence checks (solve.py:76-114, the ``run_generic`` form; the
    fused form waits for the ``upleg_downleg_col`` kernel)."""
    def run(u_fields, b_fields, omegas):
        u = tuple(u_fields)
        for _ in range(n_cycles):
            out = lowered.step(u, b_fields, omegas)
            # keep the carry in the caller's dtype (solve.py:100-104)
            u = tuple(o.to(f.dtype) for o, f in zip(out, u_fields))
        return u
    return run


@dataclass
class SolveResult:
    solve_time_ms: float        # mean wall time over samples
    convergence_factor: float   # geometric mean residual ratio
    iterations: int
    converged: bool
    residuals: np.ndarray       # residual history [0..iterations]
    solution: tuple


def _timed(fn, device):
    """``(result, milliseconds)``: CUDA events on a CUDA device, the host
    clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def measure_solve(lowered: LoweredCycle, b_fields, u0_fields=None,
                  omegas=None, *, max_iterations: int = 100,
                  target_reduction: float = 1e-12,
                  samples: int = 3) -> SolveResult:
    """Run the solver ``samples`` times after one warm-up run and report
    the reference metrics (solve.py:185-221)."""
    b0 = b_fields[0]
    if u0_fields is None:
        u0_fields = tuple(torch.zeros_like(b) for b in b_fields)
    if omegas is None:
        omegas = torch.as_tensor(lowered.default_omegas, dtype=b0.dtype,
                                 device=b0.device)
    run = make_solver(lowered, max_iterations, target_reduction)
    run(u0_fields, b_fields, omegas)
    times = []
    for _ in range(samples):
        (u, k, hist), ms = _timed(lambda: run(u0_fields, b_fields, omegas),
                                  b0.device)
        times.append(ms)
    hist = hist.cpu().numpy()
    converged = k < max_iterations or (
        k == max_iterations and hist[k] <= target_reduction * hist[0])
    if k > 0 and hist[0] > 0 and hist[k] > 0:
        rho = float((hist[k] / hist[0]) ** (1.0 / k))
    else:
        rho = 0.0 if k == 0 else float("inf")
    return SolveResult(solve_time_ms=float(np.mean(times)),
                       convergence_factor=rho, iterations=k,
                       converged=bool(converged), residuals=hist[:k + 1],
                       solution=u)
