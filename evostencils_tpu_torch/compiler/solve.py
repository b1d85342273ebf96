"""Iterative solver loops and measurement protocol (counterpart of
evostencils_tpu/compiler/solve.py:32-221).

Python loops take the place of ``lax.while_loop`` and ``lax.scan``.  The
solver's stopping test reads one residual norm per iteration back to the
host; the cycle loop reads nothing back.  ``make_cycle_loop`` has both of
the JAX package's forms: step iteration, and with ``config.loop_fusion``
the fused form, whose finest level shares one pass between consecutive
cycles.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..config import config, fused_cols_enabled
from ..ops.apply import axis_prolong_3tap, axis_restrict_3tap
from ..ops.kernels import transfer
from .lower import (LoweredCycle, _Lowering, extract_fine_leg_plan,
                    make_coarse_tail)


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


def make_preconditioner(lowered: LoweredCycle, omegas, like,
                        graph: bool = True):
    """``precond(fields) -> fields``: one application of the cycle from a
    zero initial guess, the outer Krylov solve's preconditioner
    (evaluator.py:122-152), for fields shaped and typed like ``like``.

    On a CUDA device the step is captured into one CUDA graph and
    replayed: eagerly it enqueues a thousand or more small operations
    (about 1,270 for the red-black V(2,1) of helmholtz_2d(7, 3)), whose
    host cost, not the card, would set the time of an outer iteration, as
    ``jax.jit`` spares the JAX package.  One eager step on a side stream
    first builds the lowering's device constants, so the capture holds
    device work only.  Each call copies its fields into the graph's input
    buffers, replays the graph and returns copies of its outputs.  A
    kernel wrapper counts its launch at the capture only.  On the CPU, or
    with ``graph=False``, the step runs eagerly, and so it does for a
    cycle whose step reads a value back to the host
    (``lowered.syncs_host``: a coarse solve by ``ops.solvers.cg``, which
    tests its tolerance there and so cannot be captured).  A capture that
    fails raises."""
    def eager(fields):
        zero = tuple(torch.zeros_like(f) for f in fields)
        return lowered.step(zero, tuple(fields), omegas)

    device = like[0].device
    if not graph or device.type != "cuda" or lowered.syncs_host:
        return eager
    inputs = tuple(torch.zeros_like(f) for f in like)
    side = torch.cuda.Stream(device=device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        eager(inputs)
    torch.cuda.current_stream(device).wait_stream(side)
    cuda_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(cuda_graph):
        outputs = eager(inputs)

    def replay(fields):
        for buffer, f in zip(inputs, fields):
            buffer.copy_(f)
        cuda_graph.replay()
        return tuple(o.clone() for o in outputs)
    return replay


def make_cycle_loop(lowered: LoweredCycle, n_cycles: int):
    """``run(u0, b, omegas) -> u`` applying ``n_cycles`` full cycles with no
    convergence checks (solve.py:76-172).

    With ``config.loop_fusion`` on when ``run`` is called, and a cycle of
    the canonical fused-V structure at the finest level
    (``lower.extract_fine_leg_plan``: one field, a grid the leg gate
    admits, 1..3 pre- and 1..3 post-sweeps), consecutive cycles share one
    pass at the finest level: the up-leg of cycle k and the down-leg of
    cycle k+1 run as ``transfer.upleg_downleg_col`` (or, with
    ``config.fused_column_transfers`` off, as ``upleg_downleg_fused`` with
    the column transfers in plain torch), and the coarse levels run
    through ``lower.make_coarse_tail``.  The result equals ``n_cycles``
    applications of ``lowered.step`` up to float32 reassociation.  Any
    other structure runs ``lowered.step`` in a loop, and so does a
    composed level-chunked program (``lowered.cgs_override``): the coarse
    tail would solve its chunk boundary instead of splicing in the coarser
    chunks (the fallback of solve.py:86-87).  The kernels run on a
    CUDA device unless the cycle was lowered with ``use_kernels=False``;
    on the CPU their plain versions run."""
    plan = extract_fine_leg_plan(lowered.expression) \
        if lowered.cgs_override is None else None
    tail = make_coarse_tail(lowered, plan) if plan is not None else None

    def run_generic(u_fields, b_fields, omegas):
        u = tuple(u_fields)
        for _ in range(n_cycles):
            out = lowered.step(u, b_fields, omegas)
            # keep the carry in the caller's dtype (solve.py:100-104)
            u = tuple(o.to(f.dtype) for o, f in zip(out, u_fields))
        return u

    def leg(name):
        return getattr(transfer, name if lowered.use_kernels
                       else name + "_plain")

    def run(u_fields, b_fields, omegas):
        u = u_fields[0]
        if (not config.loop_fusion or plan is None or n_cycles < 1
                or len(u_fields) != 1 or not transfer.supports(
                    u, "rows 3 and 8 (upleg_downleg_col, upleg_downleg_fused)")
                or not 1 <= len(plan.om_pre_ids) <= transfer.MAX_SWEEPS
                or not 1 <= len(plan.om_post_ids) <= transfer.MAX_SWEEPS):
            return run_generic(u_fields, b_fields, omegas)
        u, b = u.contiguous(), b_fields[0].contiguous()
        m = u.shape[1]
        pre, post = plan.om_pre_ids, plan.om_post_ids

        def coarse(rc):
            # the tail's dtype may differ from the state's (solve.py:127)
            return tail(rc, u_fields, b_fields, omegas).to(u.dtype)

        if fused_cols_enabled():
            down, fused, up = map(leg, ("presmooth_residual_restrict",
                                        "upleg_downleg_col",
                                        "prolong_correct_postsmooth_col"))
            p_taps, r_taps, through_coarse = plan.p_taps, plan.r_taps, coarse
        else:
            # row-only legs, the column halves in plain torch
            # (solve.py:141-170)
            down, fused, up = map(leg, ("presmooth_residual_rowrestrict",
                                        "upleg_downleg_fused",
                                        "prolong_correct_postsmooth"))
            p_taps, r_taps = plan.p_taps[0], plan.r_taps[0]

            def through_coarse(rr):
                rc = axis_restrict_3tap(rr, 1, plan.r_taps[1])
                return axis_prolong_3tap(coarse(rc), 1, plan.p_taps[1], m)

        u_k, r = down(u, b, omegas, pre, plan.vals, r_taps)
        e = through_coarse(r)
        for _ in range(n_cycles - 1):
            u_k, r = fused(u_k, e, b, omegas, [plan.om_cgc_id] + post + pre,
                           plan.vals, p_taps, r_taps)
            e = through_coarse(r)
        return (up(u_k, e, b, omegas, [plan.om_cgc_id] + post, plan.vals,
                   p_taps),)

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
        # relaxation factors are real in the fields' precision
        # (solve.py:195)
        omegas = torch.as_tensor(lowered.default_omegas,
                                 dtype=b0.real.dtype, device=b0.device)
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
