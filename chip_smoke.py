"""Smoke run of the PyTorch port (evostencils_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the repository root

Phases:
0. require a CUDA card; print its name and power limit;
1. build the port's CUDA kernels from the sources in this checkout;
2. compare each 2D leg kernel with its plain PyTorch version on the card,
   at the 2D path's 4095^2 grid and a ragged 1023x2047 one, for 1..3
   sweeps, and time both at 4095^2;
3. compare each 3D leg kernel with its plain version at 255^3, at the
   ragged 65x127x255 and at the 127^3 and 63^3 levels of the 3D path, with
   relaxation factors that differ; time both at every level;
4. drive the 2D path, the Poisson V(2,1) cycle on 4095^2 (levels 12->5,
   float32, as bench.py builds it), through make_cycle_loop; check the
   relative residual, the analytic solution and that every fused leg ran
   through its kernel;
5. solve the 2D problem to a 1e-5 residual reduction with the kernels and
   with the plain versions; the iteration counts must be equal and the
   residual histories agree to 1e-3 above the float32 residual floor;
6. drive the 3D path, the Poisson V(2,1) cycle on 255^3 (levels 8->2,
   float32, as scripts/bench_suite.py builds its poisson3d_255cube row),
   as phase 4 drives the 2D one: each 3D leg must run through its kernel
   three times per cycle (255^3, 127^3 and 63^3);
7. the 3D solve to 1e-5, as phase 5;
8. check that neither jax nor the JAX package was imported.

The launch counts are set to 0 just before each path is driven (phases 4
and 6) and read just after.  Any failed check raises, and the script exits
non-zero without printing its result line.  The last line of standard
output is {"ok": true, "device": {...}}; the line before it lists each
kernel with its launches on its path, its largest deviation from the
plain version, its time and the plain version's, and the least time the
card could take for the same work (bytes over 3.35 TB/s or float32
operations over 67 TFLOP/s, the larger).
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
#: H100 SXM published peaks: HBM bytes/s and float32 (non-tensor) flop/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
#: normalized 5-point and 7-point Laplacians and the paths' transfer taps
VALS = (4.0, -1.0, -1.0, -1.0, -1.0)
R_TAPS = ((0.25, 0.5, 0.25), (0.25, 0.5, 0.25))
P_TAPS = ((0.5, 1.0, 0.5), (0.5, 1.0, 0.5))
VALS7 = (6.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0)
R_TAPS3 = ((0.25, 0.5, 0.25),) * 3
P_TAPS3 = ((0.5, 1.0, 0.5),) * 3
#: float32 reassociation slack: 2D (tests/test_fused_columns.py:52-53,
#: :81); 3D u (tests/test_wavefront3d.py:57-61) and rc
TOL_U, TOL_RC = 1e-5, 1e-4
TOL_U3, TOL_RC3 = 2e-5, 1e-4
KERNELS = {
    "presmooth_residual_restrict": (
        "evostencils_tpu/ops/pallas/transfer.py:810",
        "evostencils_tpu_torch/csrc/transfer.cu"),
    "prolong_correct_postsmooth_col": (
        "evostencils_tpu/ops/pallas/transfer.py:917",
        "evostencils_tpu_torch/csrc/transfer.cu"),
    "downleg_wavefront_3d": (
        "evostencils_tpu/ops/pallas/wavefront3d.py:220",
        "evostencils_tpu_torch/csrc/wavefront3d.cu"),
    "upleg_wavefront_3d": (
        "evostencils_tpu/ops/pallas/wavefront3d.py:391",
        "evostencils_tpu_torch/csrc/wavefront3d.cu"),
}


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


def time_pair(torch, kern, plain):
    """(kernel ms, plain ms, the four turns): plain, kernel, kernel, plain,
    so that both sides see the same card."""
    p1, k1, k2, p2 = (time_ms(torch, f) for f in (plain, kern, kern, plain))
    return statistics.median([k1, k2]), statistics.median([p1, p2]), \
        (p1, k1, k2, p2)


#: float32 operations per fine point of a leg besides its sweeps, in d
#: dimensions: the down-leg's residual (2d + 2) and separable restriction
#: (5 per output point of each axis pass: 5/2 + 5/4 (+ 5/8) per fine
#: point); the up-leg's separable prolongation (2 per point of each axis
#: pass: 2/4 + 2/2 + 2 in 3D, 2/2 + 2 in 2D) and correction (2)
LEG_FLOPS = {("down", 2): 6 + 3.75, ("up", 2): 3.0 + 2,
             ("down", 3): 8 + 4.375, ("up", 3): 3.5 + 2}


def leg_bound(shape, sweeps, leg):
    """(bound ms, "bytes" or "operations") of a leg on a fine grid of
    ``shape``: it must read u and b and write u once (float32), and move
    the coarse array (rc written or e read) once; it does ``sweeps``
    red-black sweeps (each point updated once per sweep: the off-diagonal
    products and sums and the premultiplied update, 2d + 6 flops in d
    dimensions) and the work of LEG_FLOPS."""
    d = len(shape)
    fine = int(np.prod(shape))
    coarse = int(np.prod([(n - 1) // 2 for n in shape]))
    nbytes = 4 * (3 * fine + coarse)
    flops = fine * (sweeps * (2 * d + 6) + LEG_FLOPS[(leg, d)])
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch, transfer, device):
    """Each 2D kernel against its plain version; returns per-kernel stats."""
    names = ("presmooth_residual_restrict", "prolong_correct_postsmooth_col")
    stats = {name: {"max_abs_err": 0.0} for name in names}
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
                        u, b, omegas, [1, 2], VALS, R_TAPS), 2, "down"),
                "prolong_correct_postsmooth_col": (
                    lambda: transfer.prolong_correct_postsmooth_col(
                        u, e, b, omegas, [0, 1], VALS, P_TAPS),
                    lambda: transfer.prolong_correct_postsmooth_col_plain(
                        u, e, b, omegas, [0, 1], VALS, P_TAPS), 1, "up"),
            }
            for name, (kern, plain, sweeps, leg) in timed.items():
                k, p, turns = time_pair(torch, kern, plain)
                stats[name]["ms"], stats[name]["plain_ms"] = k, p
                stats[name]["bound_ms"], stats[name]["bound_by"] = \
                    leg_bound((n, m), sweeps, leg)
                log(f"[kernels] {name} 4095^2: kernel {turns[1]:.4f}/"
                    f"{turns[2]:.4f} ms, plain {turns[0]:.4f}/{turns[3]:.4f}"
                    f" ms, bound {stats[name]['bound_ms']:.4f} ms "
                    f"({stats[name]['bound_by']})")
    return stats


def phase_kernels_3d(torch, wavefront3d, device):
    """Each 3D kernel against its plain version at the 3D path's levels
    and a ragged shape; both timed at every level of the path."""
    names = ("downleg_wavefront_3d", "upleg_wavefront_3d")
    stats = {name: {"max_abs_err": 0.0} for name in names}
    # ids [1, 2] -> (1.15, 0.8) for the down-leg's two sweeps; [0, 1] ->
    # (0.9, 1.15) for the up-leg's correction and sweep
    omegas = torch.tensor([0.9, 1.15, 0.8], dtype=torch.float32,
                          device=device)
    rng = np.random.default_rng(1)
    for shape in [(255, 255, 255), (65, 127, 255), (127, 127, 127),
                  (63, 63, 63)]:
        def normal(*s):
            return torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                                device=device)
        cshape = tuple((n - 1) // 2 for n in shape)
        u, b, e = normal(*shape), normal(*shape), normal(*cshape)
        tag = "x".join(map(str, shape))
        down = (lambda: wavefront3d.downleg_wavefront_3d(
                    u, b, omegas, [1, 2], VALS7, R_TAPS3),
                lambda: wavefront3d.downleg_wavefront_3d_plain(
                    u, b, omegas, [1, 2], VALS7, R_TAPS3))
        up = (lambda: wavefront3d.upleg_wavefront_3d(
                  u, e, b, omegas, [0, 1], VALS7, P_TAPS3),
              lambda: wavefront3d.upleg_wavefront_3d_plain(
                  u, e, b, omegas, [0, 1], VALS7, P_TAPS3))
        (us_k, rc_k), (us_p, rc_p) = down[0](), down[1]()
        torch.cuda.synchronize()
        err_u = float((us_k - us_p).abs().max())
        err_rc = float((rc_k - rc_p).abs().max())
        log(f"[kernels3d] down-leg {tag}: max|du| {err_u:.3e} (tol "
            f"{TOL_U3}), max|drc| {err_rc:.3e} (tol {TOL_RC3})")
        check(err_u <= TOL_U3 and err_rc <= TOL_RC3, f"3D down-leg {tag}")
        o_k, o_p = up[0](), up[1]()
        err = float((o_k - o_p).abs().max())
        log(f"[kernels3d] up-leg {tag}: max|du| {err:.3e} (tol {TOL_U3})")
        check(err <= TOL_U3, f"3D up-leg {tag}")
        for name, dev in zip(names, (max(err_u, err_rc), err)):
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], dev)
        if shape[0] != shape[1]:
            continue
        # the path's levels: time kernel and plain in turns
        for name, (kern, plain), sweeps, leg in (
                (names[0], down, 2, "down"), (names[1], up, 1, "up")):
            k, p, turns = time_pair(torch, kern, plain)
            bound, by = leg_bound(shape, sweeps, leg)
            log(f"[kernels3d] {name} {tag}: kernel {turns[1]:.4f}/"
                f"{turns[2]:.4f} ms, plain {turns[0]:.4f}/{turns[3]:.4f} ms,"
                f" bound {bound:.4f} ms ({by})")
            if shape == (255, 255, 255):
                stats[name].update(ms=k, plain_ms=p, bound_ms=bound,
                                   bound_by=by)
    return stats


def v21(dim, max_level, min_level):
    from evostencils_tpu_torch.compiler.cycles import v_cycle
    from evostencils_tpu_torch.ir import partitioning as part
    from evostencils_tpu_torch.problems.poisson import poisson_2d, poisson_3d
    build = poisson_2d if dim == 2 else poisson_3d
    problem = build(max_level=max_level, min_level=min_level)
    cycle = v_cycle(problem.level_contexts, problem.rhs_entity,
                    pre_smoothing=2, post_smoothing=1, omega=1.15,
                    partitioning=part.RedBlack,
                    coarse_operator=problem.coarsest_operator)
    return problem, cycle


#: the two paths: (label, dimension, max level, min level, kernel module)
PATHS = {2: ("main", 2, 12, 5, "transfer"),
         3: ("main3d", 3, 8, 2, "wavefront3d")}


def phase_main_path(torch, kernels, device, card, dim):
    """Chained V(2,1) cycles of the ``dim``-D path; returns its launches."""
    from evostencils_tpu_torch.compiler.lower import lower_cycle
    from evostencils_tpu_torch.compiler.solve import (make_cycle_loop,
                                                      residual_norm_fn)
    from evostencils_tpu_torch.problems.poisson import build_rhs

    label, _, max_level, min_level, module = PATHS[dim]
    path_kernels = kernels[module]
    problem, cycle = v21(dim, max_level, min_level)
    lowered = lower_cycle(cycle, problem.approximation, problem.rhs_entity)
    b = build_rhs(problem, dtype=torch.float32, device=device)
    omegas = torch.tensor(lowered.default_omegas, dtype=torch.float32,
                          device=device)
    u = tuple(torch.zeros_like(x) for x in b)
    loop = make_cycle_loop(lowered, K_CYCLES)
    n_dof = int(np.prod(problem.finest_grid[0].size))

    for mod in kernels.values():
        mod.reset_launches()
    batch_ms = []
    for _ in range(BATCHES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        u = loop(u, b, omegas)          # chained: batch j feeds batch j+1
        end.record()
        end.synchronize()
        batch_ms.append(start.elapsed_time(end))
    counts = {name: n for mod in kernels.values()
              for name, n in mod.launches.items()}
    cycles = K_CYCLES * BATCHES
    # every level the gate admits runs each leg once per cycle
    fused = sum(1 for ctx in problem.level_contexts
                if path_kernels.supports(torch.empty(ctx.grid[0].size,
                                                     device="meta")))
    log(f"[{label}] launches {counts} over {cycles} cycles, {fused} fused "
        "levels")
    for name, count in counts.items():
        want = fused * cycles if name in path_kernels.launches else 0
        check(count == want, f"{name} launched {count} times on the "
              f"{dim}D path, expected {want}")

    steady = batch_ms[1:]
    ms_cycle = statistics.median(steady) / K_CYCLES
    log(f"[{label}] batches of {K_CYCLES} cycles: "
        + ", ".join(f"{t:.1f}" for t in batch_ms) + " ms (first warms up)")
    log(f"[{label}] {n_dof} DoF: {ms_cycle:.4f} ms/cycle (median), "
        f"{min(steady) / K_CYCLES:.4f} (best), "
        f"{n_dof / (ms_cycle * 1e-3):.4e} DoF/s on {card}")

    u0 = u[0]
    check(tuple(u0.shape) == tuple(problem.finest_grid[0].size)
          and u0.dtype == torch.float32, "solution shape/dtype")
    res = float(residual_norm_fn(lowered.operator)(u, b))
    rel = res / float(torch.linalg.vector_norm(b[0].double()))
    log(f"[{label}] relative residual after {cycles} cycles: {rel:.3e} "
        "(gate 1e-4, bench.py:195)")
    check(np.isfinite(rel) and rel <= 1e-4, "relative residual")
    exact = problem.exact_solution()[0]
    sol_err = float(np.abs(u0.double().cpu().numpy() - exact).max()
                    / np.abs(exact).max())
    log(f"[{label}] max error against the analytic solution: {sol_err:.3e} "
        "(relative; gross gate 1e-2)")
    check(np.isfinite(sol_err) and sol_err <= 1e-2, "analytic solution")
    return {name: counts[name] for name in path_kernels.launches}


def phase_solve(torch, device, dim):
    """make_solver to 1e-5 with the kernels and with the plain versions."""
    from evostencils_tpu_torch.compiler.lower import lower_cycle
    from evostencils_tpu_torch.compiler.solve import make_solver
    from evostencils_tpu_torch.problems.poisson import build_rhs

    label, _, max_level, min_level, _ = PATHS[dim]
    problem, cycle = v21(dim, max_level, min_level)
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
        log(f"[{label} solve] {'kernels' if use_kernels else 'plain  '}: {k}"
            f" iterations to 1e-5, rho {rho:.4f}, rho(first {kf}) "
            f"{rho4:.4f}, history "
            f"{np.array2string(hist / hist[0], precision=4)}")
    (k1, h1), (k0, h0) = runs[True], runs[False]
    check(k1 == k0 and 0 < k1 < 20, f"{dim}D iterations {k1} vs {k0}")
    # A float32 state cannot hold a residual much below 1e-5 * ||b||: the
    # rounding of u alone leaves |A du| of that order.  The last entry of
    # a solve to 1e-5 sits on that floor, where the kernels' and the plain
    # versions' rounding differ by a sizeable fraction of it; above it the
    # histories must agree to 1e-3.
    floor = 1e-5 * h0[0]
    rel = np.abs(h1 - h0) / h0
    above = h0 > 10 * floor
    log(f"[{label} solve] residual histories agree to "
        f"{rel[above].max():.3e} relative above 10x the float32 floor "
        f"(1e-5 ||b||), {rel.max():.3e} overall")
    check(np.all(np.abs(h1 - h0) <= 1e-3 * h0 + floor),
          f"{dim}D residual histories (rtol 1e-3 above 1e-5 ||b||)")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from evostencils_tpu_torch.config import setup_device
    from evostencils_tpu_torch.ops.kernels import _build, transfer, wavefront3d

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

    kernels = {"transfer": transfer, "wavefront3d": wavefront3d}
    stats = phase_kernels(torch, transfer, device)
    stats.update(phase_kernels_3d(torch, wavefront3d, device))
    launches = phase_main_path(torch, kernels, device, card, 2)
    phase_solve(torch, device, 2)
    launches.update(phase_main_path(torch, kernels, device, card, 3))
    phase_solve(torch, device, 3)
    for banned in ("jax", "evostencils_tpu"):
        check(banned not in sys.modules, f"the port imported {banned}")

    rows = []
    for k, (replaces, source) in KERNELS.items():
        s = stats[k]
        rows.append({"name": k, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[k],
                     "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                     "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                     "bound_by": s["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
