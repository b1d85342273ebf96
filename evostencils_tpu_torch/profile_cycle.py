"""Where the time of a chained multigrid cycle goes on one CUDA card.

    python3 -m evostencils_tpu_torch.profile_cycle --dim 3 [--cycles 20]
    python3 -m evostencils_tpu_torch.profile_cycle --dim 3 \
        --partitioning RedBlack|Jacobi --smoothing PRE,POST
    python3 -m evostencils_tpu_torch.profile_cycle \
        --champion poisson2d_1023sq_seeded_gen75:0
    python3 -m evostencils_tpu_torch.profile_cycle --dim 2 \
        --partitioning Jacobi --levels 10,5
    python3 -m evostencils_tpu_torch.profile_cycle --elasticity \
        [--partitioning RedBlack|Jacobi] [--smoothing 4,4] [--levels 8,4]
    python3 -m evostencils_tpu_torch.profile_cycle --var \
        [--partitioning RedBlack|Jacobi]
    python3 -m evostencils_tpu_torch.profile_cycle --cx \
        [--partitioning RedBlack|Jacobi]
    python3 -m evostencils_tpu_torch.profile_cycle --dim 2 --loop a

Builds a path that ``chip_smoke.py`` drives (2D: Poisson 4095^2, levels
12->5; 3D: Poisson 255^3, levels 8->2; float32, V(2,1), RB-GS omega=1.15;
on the Poisson paths ``--partitioning Jacobi`` takes the weighted-Jacobi
smoother at omega 0.8 and ``--smoothing PRE,POST`` other sweep counts,
which with ``--smoothing 1,1`` and with ``--partitioning Jacobi`` give the
``[evaluator3d]`` RB V(1,1) and Jacobi V(2,1), and with ``--dim 2
--partitioning Jacobi --levels 10,5`` the ``[evaluator]`` Jacobi V(2,1)
at 1023^2), or, with ``--elasticity``, its ``[main-elast]`` red-black
cell (2D linear elasticity 2047^2, ``linear_elasticity_2d(11, 4)``, the
collective red-black V(2,1) at omega 1.25, float32; ``--partitioning
Jacobi`` the collective Jacobi smoother at omega 0.8, and with
``--smoothing 4,4 --levels 8,4`` the ``[evaluator-elast]`` RB V(4,4) at
255^2), or, with ``--var``, its
``[main-var]`` cell (variable-coefficient 2D Poisson 2047^2,
``poisson_2d_variable(11, 5)``, float32) with the red-black V(2,1) at
omega 1.15 or, with ``--partitioning Jacobi``, the weighted-Jacobi V(2,1)
at omega 0.8, or, with ``--cx``, its ``[main-cx]`` cell (the Dirichlet
shifted Laplacian -Lap - k^2 (1 + 0.5i), k = 80, at 2047^2, levels 11->3,
complex64; ``problems.helmholtz.dirichlet_helmholtz``) with the red-black V(2,1) or, with
``--partitioning Jacobi``, its Jacobi twin, both at omega 0.6, or, with
``--champion
KEY:INDEX``, the stored evolved cycle
``results/evolved_champions.json[KEY][INDEX]`` on its 2D Poisson 1023^2
hierarchy (levels 10->5, float32).  ``--levels MAX,MIN`` sets another
hierarchy of the path (not a champion's).  ``--loop`` runs it in one of the
``[main-fused]`` configurations of ``chip_smoke.py`` (LOOPS: (a) loop
fusion with column transfers, (b) loop fusion with row-only legs, (c)
row-only legs, (d) neither, the defaults), and restores the switches
afterwards.  After three warm-up cycles it

1. runs three batches of ``--cycles`` chained cycles and reads the host
   clock before and after ``torch.cuda.synchronize()``: the host's enqueue
   time and the wall time per cycle;
2. runs one more batch under ``torch.profiler`` and sums the device time
   of every kernel (self device time of CUDA events): device busy time per
   cycle, the device's idle share against the wall time of step 1, the
   kernel launches per cycle, and the kernels that take the most time.

Prints one line per measurement and a JSON object as its last line.
Needs a CUDA card; it fails on a machine without one.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time
from typing import Optional, Tuple

import numpy as np
import torch

PATHS = {2: (12, 5), 3: (8, 2)}
#: the [main-elast] cell: levels, and each partitioning's IR name and
#: omega (the collective smoother; [evaluator-elast]'s at 255^2)
ELASTICITY = (11, 4)
ELASTICITY_PARTITIONINGS = {"RedBlack": ("RedBlack", 1.25),
                            "Jacobi": ("Single", 0.8)}
#: the [main-var] cell: levels, and each partitioning's IR name and omega
VAR = (11, 5)
VAR_PARTITIONINGS = {"RedBlack": ("RedBlack", 1.15), "Jacobi": ("Single", 0.8)}
#: the [main-cx] cell: levels, and each partitioning's IR name and omega
CX = (11, 3)
CX_PARTITIONINGS = {"RedBlack": ("RedBlack", 0.6), "Jacobi": ("Single", 0.6)}
#: the Poisson paths' partitionings: IR name and omega (the [evaluator3d]
#: structures' at 255^3)
POISSON_PARTITIONINGS = {"RedBlack": ("RedBlack", 1.15),
                         "Jacobi": ("Single", 0.8)}
#: the [main-fused] configurations: (config.loop_fusion,
#: config.fused_column_transfers)
LOOPS = {"a": (True, True), "b": (True, False), "c": (False, False),
         "d": (False, True)}
#: the hierarchy of the stored 2D Poisson champions (1023^2)
CHAMPION_LEVELS = (10, 5)
CHAMPIONS = (pathlib.Path(__file__).resolve().parents[1] / "results"
             / "evolved_champions.json")


def build_path(dim: int, elasticity: bool = False,
               var_partitioning: Optional[str] = None,
               cx_partitioning: Optional[str] = None,
               partitioning: str = "RedBlack",
               smoothing: Tuple[int, int] = (2, 1),
               levels: Optional[Tuple[int, int]] = None):
    """(lowered cycle, b, omegas, u0) of the ``dim``-D Poisson path or of
    the elasticity cell with ``partitioning`` (a key of
    POISSON_PARTITIONINGS or ELASTICITY_PARTITIONINGS), or of the var-coef
    or complex cell with ``var_partitioning`` or ``cx_partitioning`` (a
    key of VAR_PARTITIONINGS or CX_PARTITIONINGS), on the card; a V-cycle
    of ``smoothing`` (pre, post) sweeps on the path's levels or on
    ``levels`` (max, min)."""
    from .compiler.cycles import v_cycle
    from .compiler.lower import lower_cycle
    from .ir import partitioning as part
    from .problems.elasticity import linear_elasticity_2d
    from .problems.helmholtz import dirichlet_helmholtz
    from .problems.poisson import (build_rhs, poisson_2d, poisson_2d_variable,
                                   poisson_3d)

    if elasticity:
        path_levels, build = ELASTICITY, linear_elasticity_2d
        name, omega = ELASTICITY_PARTITIONINGS[partitioning]
    elif var_partitioning:
        path_levels, build = VAR, poisson_2d_variable
        name, omega = VAR_PARTITIONINGS[var_partitioning]
    elif cx_partitioning:
        path_levels, build = CX, dirichlet_helmholtz
        name, omega = CX_PARTITIONINGS[cx_partitioning]
    else:
        path_levels = PATHS[dim]
        name, omega = POISSON_PARTITIONINGS[partitioning]
        build = poisson_2d if dim == 2 else poisson_3d
    max_level, min_level = levels or path_levels
    problem = build(max_level, min_level)
    cycle = v_cycle(problem.level_contexts, problem.rhs_entity,
                    pre_smoothing=smoothing[0],
                    post_smoothing=smoothing[1], omega=omega,
                    partitioning=getattr(part, name),
                    coarse_operator=problem.coarsest_operator)
    lowered = lower_cycle(cycle, problem.approximation, problem.rhs_entity)
    b = build_rhs(problem, dtype=torch.float32, device="cuda")
    omegas = torch.tensor(lowered.default_omegas, dtype=torch.float32,
                          device="cuda")
    return lowered, b, omegas, tuple(torch.zeros_like(x) for x in b)


def build_champion(spec: str):
    """(lowered cycle, b, omegas, u0) of a stored 2D Poisson champion,
    ``KEY:INDEX`` in results/evolved_champions.json, on the card."""
    from .compiler.lower import lower_cycle
    from .grammar import gp
    from .grammar.multigrid import generate_primitive_set
    from .ir import transformations
    from .problems.poisson import build_rhs, poisson_2d

    key, index = spec.rsplit(":", 1)
    grammar = json.loads(CHAMPIONS.read_text())[key][int(index)]["grammar"]
    problem = poisson_2d(max_level=CHAMPION_LEVELS[0],
                         min_level=CHAMPION_LEVELS[1])
    pset = generate_primitive_set(problem.approximation, problem.rhs_entity,
                                  problem.level_contexts,
                                  problem.coarsest_operator)[0]
    cycle = gp.compile_tree(gp.parse_tree(grammar, pset), pset)[0]
    transformations.assign_cycle_ids(cycle)
    lowered = lower_cycle(cycle, problem.approximation, problem.rhs_entity)
    b = build_rhs(problem, dtype=torch.float32, device="cuda")
    omegas = torch.tensor(lowered.default_omegas, dtype=torch.float32,
                          device="cuda")
    return lowered, b, omegas, tuple(torch.zeros_like(x) for x in b)


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(evt, attr, None)
        if value is not None:
            return float(value)
    return 0.0


def _pair(ap, option, text, form, least):
    """``text`` "A,B" as two ints >= ``least``; None when not given."""
    if not text:
        return None
    try:
        pair = tuple(int(k) for k in text.split(","))
    except ValueError:
        pair = ()
    if len(pair) != 2 or min(pair) < least:
        ap.error(f"{option} takes {form}: two counts >= {least}")
    return pair


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    what = ap.add_mutually_exclusive_group(required=True)
    what.add_argument("--dim", type=int, choices=(2, 3))
    what.add_argument("--champion", metavar="KEY:INDEX")
    what.add_argument("--elasticity", action="store_true")
    what.add_argument("--var", action="store_true")
    what.add_argument("--cx", action="store_true")
    ap.add_argument("--partitioning", choices=sorted(VAR_PARTITIONINGS),
                    help="the smoother of any path but --champion "
                    "(default RedBlack)")
    ap.add_argument("--smoothing", metavar="PRE,POST",
                    help="the --dim or --elasticity V-cycle's pre- and "
                    "post-sweeps (default 2,1)")
    ap.add_argument("--levels", metavar="MAX,MIN",
                    help="the hierarchy of any path but --champion "
                    "(default the path's own)")
    ap.add_argument("--loop", choices=sorted(LOOPS),
                    help="the [main-fused] configuration (default: the "
                    "switches as they are)")
    ap.add_argument("--cycles", type=int, default=20)
    args = ap.parse_args(argv)
    if args.champion and (args.partitioning or args.levels):
        ap.error("--partitioning and --levels take a path, not --champion")
    if args.smoothing and not (args.dim or args.elasticity):
        ap.error("--smoothing takes --dim or --elasticity")
    args.smoothing = _pair(ap, "--smoothing", args.smoothing, "PRE,POST", 0)
    args.levels = _pair(ap, "--levels", args.levels, "MAX,MIN", 1)
    if args.levels and args.levels[0] <= args.levels[1]:
        ap.error("--levels takes MAX,MIN with MAX > MIN")
    partitioning = args.partitioning or "RedBlack"
    var_partitioning = partitioning if args.var else None
    cx_partitioning = partitioning if args.cx else None
    if not torch.cuda.is_available():
        print("profile_cycle: no CUDA card", file=sys.stderr)
        return 1
    from .config import config

    saved = (config.loop_fusion, config.fused_column_transfers)
    if args.loop:
        config.loop_fusion, config.fused_column_transfers = LOOPS[args.loop]
    try:
        return _profile(args, var_partitioning, cx_partitioning)
    finally:
        config.loop_fusion, config.fused_column_transfers = saved


def _profile(args, var_partitioning, cx_partitioning) -> int:
    """Steps 1 and 2 of the module docstring on the path ``args`` names."""
    from .compiler.solve import make_cycle_loop
    from .config import setup_device

    setup_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    smoothing = args.smoothing or (2, 1)
    partitioning = args.partitioning or "RedBlack"
    lowered, b, omegas, u = (
        build_champion(args.champion) if args.champion
        else build_path(args.dim, args.elasticity, var_partitioning,
                        cx_partitioning, partitioning, smoothing,
                        args.levels))
    size = f"{2 ** args.levels[0] - 1}^2" if args.levels else "2047^2"
    cycle = f"V({smoothing[0]},{smoothing[1]})"
    if args.champion:
        label = args.champion
    elif args.elasticity:
        mode = "RB" if partitioning == "RedBlack" else partitioning
        label = f"elasticity {size} {mode} {cycle}"
    elif var_partitioning:
        label = f"var-coef {size} {var_partitioning} {cycle}"
    elif cx_partitioning:
        label = f"shifted Laplacian {size} {cx_partitioning} {cycle}"
    elif args.partitioning or args.smoothing or args.levels:
        label = f"{args.dim}D {partitioning} {cycle}"
        if args.levels:
            label += f" at levels {args.levels[0]}->{args.levels[1]}"
    else:
        label = f"{args.dim}D"
    if args.loop:
        label += f", loop configuration ({args.loop})"
    n = args.cycles
    u = make_cycle_loop(lowered, 3)(u, b, omegas)
    torch.cuda.synchronize()

    loop = make_cycle_loop(lowered, n)
    host, wall = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        u = loop(u, b, omegas)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append((t1 - t0) * 1e3 / n)
        wall.append((t2 - t0) * 1e3 / n)
    print(f"[time] {card}, {label}, {n} cycles per batch: wall "
          + " / ".join(f"{w:.4f}" for w in wall) + " ms/cycle, host enqueue "
          + " / ".join(f"{h:.4f}" for h in host) + " ms/cycle", flush=True)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        u = loop(u, b, omegas)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType
    kernels, launches = {}, 0
    for evt in prof.key_averages():
        if evt.key in ("cudaLaunchKernel", "cuLaunchKernel",
                       "cudaLaunchKernelExC"):
            launches += evt.count
        # device-side events only: a CPU op's device time repeats its
        # kernels'
        if evt.device_type == DeviceType.CUDA and _device_us(evt) > 0:
            kernels[evt.key] = (_device_us(evt), evt.count)
    busy = sum(us for us, _ in kernels.values()) / 1e3 / n
    idle = 1.0 - busy / statistics.median(wall)
    print(f"[profile] device busy {busy:.4f} ms/cycle, idle share "
          f"{idle:.4f} of the median wall time, {launches / n:.1f} kernel "
          "launches per cycle", flush=True)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (us, count) in top:
        print(f"[profile] {us / 1e3 / n:9.4f} ms/cycle  {count / n:6.1f}/cycle"
              f"  {name[:90]}")
    print(json.dumps({
        "card": card, "path": label, "cycles": n,
        "wall_ms_per_cycle": wall, "host_ms_per_cycle": host,
        "device_busy_ms_per_cycle": busy, "idle_share": idle,
        "launches_per_cycle": launches / n,
        "top_kernels": [{"name": k, "ms_per_cycle": us / 1e3 / n,
                         "per_cycle": c / n} for k, (us, c) in top]}))
    check = float(u[0].abs().max())
    return 0 if np.isfinite(check) else 1


if __name__ == "__main__":
    sys.exit(main())
