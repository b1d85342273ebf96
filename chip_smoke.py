"""Smoke run of the PyTorch port (evostencils_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the repository root

Phases:
0. require a CUDA card; print its name and power limit;
1. build the port's CUDA kernels from the sources in this checkout;
2. compare each kernel with its plain PyTorch version on the card, at the
   main path's 4095^2 grid and a ragged 1023x2047 one, for 1..3 sweeps,
   and time both at 4095^2;
3. drive the main path, the 2D Poisson V(2,1) cycle on 4095^2 (levels
   12->5, float32, as bench.py builds it), through make_cycle_loop; check
   the relative residual, the analytic solution and that every fused leg
   ran through its kernel;
4. solve to a 1e-5 residual reduction with the kernels and with the plain
   versions; the iteration counts must be equal and the residual histories
   agree to 1e-3 above the float32 residual floor.

Any failed check raises, and the script exits non-zero without printing
its result line.  The last line of standard output is
{"ok": true, "device": {...}}; the line before it lists each kernel with
its launches on the main path, its largest deviation from the plain
version, and both times.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np

K_CYCLES = 200            # chained cycles per batch (bench.py:72)
BATCHES = 4               # the first one warms up
WARMUP = 3
TIMED_REPS = 15
#: normalized 5-point Laplacian and the main path's transfer taps
VALS = (4.0, -1.0, -1.0, -1.0, -1.0)
R_TAPS = ((0.25, 0.5, 0.25), (0.25, 0.5, 0.25))
P_TAPS = ((0.5, 1.0, 0.5), (0.5, 1.0, 0.5))
#: float32 reassociation slack (tests/test_fused_columns.py:52-53, :81)
TOL_U, TOL_RC = 1e-5, 1e-4
KERNELS = {
    "presmooth_residual_restrict":
        "evostencils_tpu/ops/pallas/transfer.py:810",
    "prolong_correct_postsmooth_col":
        "evostencils_tpu/ops/pallas/transfer.py:917",
}
SOURCE = "evostencils_tpu_torch/csrc/transfer.cu"


def log(msg):
    print(msg, flush=True)


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def time_ms(torch, fn):
    """Median milliseconds of one call, by CUDA events, after warm-up."""
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(TIMED_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_kernels(torch, transfer, device):
    """Each kernel against its plain version; returns per-kernel stats."""
    stats = {name: {"max_abs_err": 0.0} for name in KERNELS}
    omegas = torch.tensor([0.9, 1.15, 0.8, 1.3], dtype=torch.float32,
                          device=device)
    rng = np.random.default_rng(0)
    for n, m in [(4095, 4095), (1023, 2047)]:
        def normal(*shape):
            return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                                device=device)
        u, b, e = normal(n, m), normal(n, m), normal((n - 1) // 2,
                                                     (m - 1) // 2)
        for sweeps in (1, 2, 3):
            ids = [1, 2, 3][:sweeps]
            us_k, rc_k = transfer.presmooth_residual_restrict(
                u, b, omegas, ids, VALS, R_TAPS)
            us_p, rc_p = transfer.presmooth_residual_restrict_plain(
                u, b, omegas, ids, VALS, R_TAPS)
            err_u = float((us_k - us_p).abs().max())
            err_rc = float((rc_k - rc_p).abs().max())
            log(f"[kernels] down-leg {n}x{m} S={sweeps}: max|du| {err_u:.3e}"
                f" (tol {TOL_U}), max|drc| {err_rc:.3e} (tol {TOL_RC})")
            check(err_u <= TOL_U and err_rc <= TOL_RC,
                  f"down-leg {n}x{m} S={sweeps}")
            stats["presmooth_residual_restrict"]["max_abs_err"] = max(
                stats["presmooth_residual_restrict"]["max_abs_err"], err_u,
                err_rc)

            ids = [0, 1, 2, 3][:sweeps + 1]
            o_k = transfer.prolong_correct_postsmooth_col(
                u, e, b, omegas, ids, VALS, P_TAPS)
            o_p = transfer.prolong_correct_postsmooth_col_plain(
                u, e, b, omegas, ids, VALS, P_TAPS)
            err = float((o_k - o_p).abs().max())
            log(f"[kernels] up-leg {n}x{m} S={sweeps}: max|du| {err:.3e} "
                f"(tol {TOL_U})")
            check(err <= TOL_U, f"up-leg {n}x{m} S={sweeps}")
            stats["prolong_correct_postsmooth_col"]["max_abs_err"] = max(
                stats["prolong_correct_postsmooth_col"]["max_abs_err"], err)
        if (n, m) == (4095, 4095):
            # the main path's sweeps: V(2,1) -> 2 pre, 1 post
            timed = {
                "presmooth_residual_restrict": (
                    lambda: transfer.presmooth_residual_restrict(
                        u, b, omegas, [1, 2], VALS, R_TAPS),
                    lambda: transfer.presmooth_residual_restrict_plain(
                        u, b, omegas, [1, 2], VALS, R_TAPS)),
                "prolong_correct_postsmooth_col": (
                    lambda: transfer.prolong_correct_postsmooth_col(
                        u, e, b, omegas, [0, 1], VALS, P_TAPS),
                    lambda: transfer.prolong_correct_postsmooth_col_plain(
                        u, e, b, omegas, [0, 1], VALS, P_TAPS)),
            }
            for name, (kern, plain) in timed.items():
                # plain, kernel, kernel, plain: both sides see the same card
                p1, k1, k2, p2 = (time_ms(torch, f)
                                  for f in (plain, kern, kern, plain))
                stats[name]["ms"] = statistics.median([k1, k2])
                stats[name]["plain_ms"] = statistics.median([p1, p2])
                log(f"[kernels] {name} 4095^2: kernel {k1:.4f}/{k2:.4f} ms, "
                    f"plain {p1:.4f}/{p2:.4f} ms")
    return stats


def v21(max_level, min_level):
    from evostencils_tpu.compiler.cycles import v_cycle
    from evostencils_tpu.ir import partitioning as part
    from evostencils_tpu.problems.poisson import poisson_2d
    problem = poisson_2d(max_level=max_level, min_level=min_level)
    cycle = v_cycle(problem.level_contexts, problem.rhs_entity,
                    pre_smoothing=2, post_smoothing=1, omega=1.15,
                    partitioning=part.RedBlack,
                    coarse_operator=problem.coarsest_operator)
    return problem, cycle


def phase_main_path(torch, transfer, device, card):
    from evostencils_tpu_torch.compiler.lower import lower_cycle
    from evostencils_tpu_torch.compiler.solve import (make_cycle_loop,
                                                      residual_norm_fn)
    from evostencils_tpu_torch.problems.poisson import build_rhs

    problem, cycle = v21(12, 5)
    lowered = lower_cycle(cycle, problem.approximation, problem.rhs_entity)
    b = build_rhs(problem, dtype=torch.float32, device=device)
    omegas = torch.tensor(lowered.default_omegas, dtype=torch.float32,
                          device=device)
    u = tuple(torch.zeros_like(x) for x in b)
    loop = make_cycle_loop(lowered, K_CYCLES)
    n_dof = int(np.prod(problem.finest_grid[0].size))

    transfer.reset_launches()
    batch_ms = []
    for _ in range(BATCHES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        u = loop(u, b, omegas)          # chained: batch j feeds batch j+1
        end.record()
        end.synchronize()
        batch_ms.append(start.elapsed_time(end))
    launches = dict(transfer.launches)
    cycles = K_CYCLES * BATCHES
    # every level the gate admits runs each leg once per cycle: 4095^2
    # down to 255^2, five levels
    fused = sum(1 for ctx in problem.level_contexts
                if transfer.supports(torch.empty(ctx.grid[0].size,
                                                 device="meta")))
    log(f"[main] launches {launches} over {cycles} cycles, {fused} fused "
        "levels")
    for name, count in launches.items():
        check(count == fused * cycles, f"{name} launched {count} times, "
              f"expected {fused} per cycle ({fused * cycles})")

    steady = batch_ms[1:]
    ms_cycle = statistics.median(steady) / K_CYCLES
    log(f"[main] batches of {K_CYCLES} cycles: "
        + ", ".join(f"{t:.1f}" for t in batch_ms) + " ms (first warms up)")
    log(f"[main] {n_dof} DoF: {ms_cycle:.4f} ms/cycle (median), "
        f"{min(steady) / K_CYCLES:.4f} (best), "
        f"{n_dof / (ms_cycle * 1e-3):.4e} DoF/s on {card}")

    u0 = u[0]
    check(tuple(u0.shape) == tuple(problem.finest_grid[0].size)
          and u0.dtype == torch.float32, "solution shape/dtype")
    res = float(residual_norm_fn(lowered.operator)(u, b))
    rel = res / float(torch.linalg.vector_norm(b[0].double()))
    log(f"[main] relative residual after {cycles} cycles: {rel:.3e} "
        "(gate 1e-4, bench.py:195)")
    check(np.isfinite(rel) and rel <= 1e-4, "relative residual")
    exact = problem.exact_solution()[0]
    sol_err = float(np.abs(u0.double().cpu().numpy() - exact).max()
                    / np.abs(exact).max())
    log(f"[main] max error against the analytic solution: {sol_err:.3e} "
        "(relative; gross gate 1e-2)")
    check(np.isfinite(sol_err) and sol_err <= 1e-2, "analytic solution")
    return launches, ms_cycle


def phase_solve(torch, device):
    """make_solver to 1e-5 with the kernels and with the plain versions."""
    from evostencils_tpu_torch.compiler.lower import lower_cycle
    from evostencils_tpu_torch.compiler.solve import make_solver
    from evostencils_tpu_torch.problems.poisson import build_rhs

    problem, cycle = v21(12, 5)
    b = build_rhs(problem, dtype=torch.float32, device=device)
    runs = {}
    for use_kernels in (True, False):
        lowered = lower_cycle(cycle, problem.approximation,
                              problem.rhs_entity, use_kernels=use_kernels)
        omegas = torch.tensor(lowered.default_omegas, dtype=torch.float32,
                              device=device)
        u0 = tuple(torch.zeros_like(x) for x in b)
        _, k, hist = make_solver(lowered, 20, 1e-5)(u0, b, omegas)
        hist = hist[:k + 1].double().cpu().numpy()
        runs[use_kernels] = (k, hist)
        rho = (hist[k] / hist[0]) ** (1.0 / k) if k else 0.0
        kf = min(k, 4)
        rho4 = (hist[kf] / hist[0]) ** (1.0 / kf) if kf else 0.0
        log(f"[solve] {'kernels' if use_kernels else 'plain  '}: {k} "
            f"iterations to 1e-5, rho {rho:.4f}, rho(first {kf}) {rho4:.4f},"
            f" history {np.array2string(hist / hist[0], precision=4)}")
    (k1, h1), (k0, h0) = runs[True], runs[False]
    check(k1 == k0 and 0 < k1 < 20, f"iterations {k1} vs {k0}")
    # A float32 state on 4095^2 cannot hold a residual much below
    # 1e-5 * ||b||: the rounding of u alone leaves |A du| of that order
    # (phase 3 reads about 6e-6 after 800 cycles).  The last entry of a
    # solve to 1e-5 sits on that floor, where the kernels' and the plain
    # versions' rounding differ by a sizeable fraction of it; above it the
    # histories must agree to 1e-3.
    floor = 1e-5 * h0[0]
    rel = np.abs(h1 - h0) / h0
    above = h0 > 10 * floor
    log(f"[solve] residual histories agree to {rel[above].max():.3e} "
        f"relative above 10x the float32 floor (1e-5 ||b||), "
        f"{rel.max():.3e} overall")
    check(np.all(np.abs(h1 - h0) <= 1e-3 * h0 + floor),
          "residual histories (rtol 1e-3 above 1e-5 ||b||)")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from evostencils_tpu_torch.config import setup_device
    from evostencils_tpu_torch.ops.kernels import _build, transfer

    device = setup_device("cuda")
    name = torch.cuda.get_device_name(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(f"[device] {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; count {torch.cuda.device_count()}")
    log(f"[device] {card}")

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    log(f"[build] {lib_path.name} in {time.perf_counter() - t0:.1f} s")

    stats = phase_kernels(torch, transfer, device)
    launches, _ = phase_main_path(torch, transfer, device, card)
    phase_solve(torch, device)
    check("jax" not in sys.modules, "the port imported jax")

    kernels = [{"name": k, "route": "cuda", "source": SOURCE,
                "replaces": KERNELS[k], "launches": launches[k],
                "max_abs_err": stats[k]["max_abs_err"], "ms": stats[k]["ms"],
                "plain_ms": stats[k]["plain_ms"]} for k in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
