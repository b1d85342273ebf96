"""Time the schedules of the standalone sweep and transfer kernels on one
CUDA card.

    python3 kernel_variants.py variants [--only 0,9]   # from the repository root
    python3 kernel_variants.py ab --parent DIR

Both modes build ``csrc/rbgs.cu`` (``sweep_kernel``, the 5-point
single-pass sweep, and ``fused_rbgs_kernel``, the 5-point red-black
sweep), ``csrc/rbgs_sys.cu`` (``rbgs_sys_kernel``, the coupled-system
red-black sweep, and the system legs) and ``csrc/transfer.cu`` (the 2D
legs and standalone transfers, among them the prolongation-correction,
``col_leg_kernel<kUp, 0, PC_WINDOW>``) into one library per variant, all
``nvcc`` processes started together.  The sweeps and the
prolongation-correction are called at their C entries through ``ctypes``
with the wrappers' own argument helpers, the other transfer kernels
through their wrappers with the library swapped in.  Each library takes
the argument types of its own tree's ``_build.SIGNATURES``, and the
prolongation-correction its halo and window class where its entry takes
them.
Each result is first held against the plain PyTorch version, then timed
as the kernel's device time alone (``chip_smoke.time_ms_queued``: CUDA
events around one call queued behind a spin of the card, median of 15).

``variants`` copies this checkout's ``csrc/`` once per entry of VARIANTS,
rewrites the schedule's constants in the copy (the sweep's strip, block
and least resident blocks; the system sweep's window rows, threads, least
resident blocks and whether b is staged in shared memory or read through
the read-only cache; the red-black sweep's window rows; the
prolongation-correction's window rows and least resident blocks), builds
each copy, and times each at every level its kernel runs at, in two turns
(the list, then the list reversed); ``--only 0,9`` takes those entries of
VARIANTS alone.  A rewrite that does not find the text it replaces stops
the script, so a variant builds what its name says or nothing.

``ab`` builds the sources of the parent tree DIR (a ``git archive`` of
the parent commit) and of this checkout as they are, and times those
kernels and the other kernels of the three sources (the system Jacobi
sweep, the system legs red-black and Jacobi with the V(2,1)'s sweep
counts, the 2D legs with both transfer axes and row-only, the fused
passes and the residual restriction) at every level in the turns parent,
change, change, parent.

Prints one line per timing, with the card's name and power limit, and a
JSON object as its last line.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile
from typing import NamedTuple

import numpy as np

import chip_smoke as cs

ROOT = pathlib.Path(__file__).resolve().parent
CSRC = ROOT / "evostencils_tpu_torch" / "csrc"
SOURCES = ("rbgs.cu", "rbgs_sys.cu", "transfer.cu")
BUILD_PY = ROOT / "evostencils_tpu_torch" / "ops" / "kernels" / "_build.py"


class Variant(NamedTuple):
    """One schedule of the four kernels, every value named."""
    strip: int          # sweep_kernel: rows of a thread's strip
    bx: int             # block columns
    by: int             # block strips
    min_blocks: int     # least resident blocks an SM (__launch_bounds__)
    rows: int           # rbgs_sys_kernel: window rows (64 columns)
    threads: int        # threads a block
    blocks: int         # least resident blocks an SM
    stage_b: bool       # b staged beside u, else read through the cache
    rb_rows: int        # fused_rbgs_kernel: window rows (64 columns)
    pc_rows: int        # prolongation-correction: window rows (64 columns)
    pc_blocks: int      # least resident blocks an SM

    @property
    def name(self) -> str:
        return (f"s{self.strip} {self.bx}x{self.by}/{self.min_blocks} | "
                f"w{self.rows}x64 {self.threads}t/{self.blocks} "
                f"b {'staged' if self.stage_b else 'cache'} | "
                f"rb w{self.rb_rows}x64 | pc w{self.pc_rows}x64 "
                f"/{self.pc_blocks}")


#: The first is the sources' own schedule; each other changes one or two
#: values of each kernel.
VARIANTS = (
    Variant(4, 128, 2, 4, 16, 256, 4, True, 24, 16, 8),
    Variant(2, 128, 2, 4, 16, 128, 8, True, 24, 16, 8),
    Variant(4, 256, 1, 4, 16, 512, 2, True, 24, 16, 8),
    Variant(4, 32, 4, 8, 32, 256, 4, True, 24, 16, 8),
    Variant(4, 64, 4, 6, 16, 256, 6, True, 24, 16, 8),
    Variant(4, 128, 2, 8, 16, 256, 4, False, 24, 16, 8),
    Variant(6, 128, 2, 4, 8, 256, 4, True, 24, 16, 8),
    Variant(8, 128, 2, 4, 64, 512, 2, False, 24, 16, 8),
    Variant(16, 128, 2, 4, 16, 256, 4, True, 24, 16, 8),
    Variant(4, 128, 2, 4, 16, 256, 4, True, 32, 32, 6),
    Variant(4, 128, 2, 4, 16, 256, 4, True, 16, 8, 8),
    Variant(4, 128, 2, 4, 16, 256, 4, True, 8, 16, 6),
)
SWEEP_LEVELS = (4095, 1023, 511, 255)
SYS_LEVELS = (2047, 255)
#: the 2D legs' levels (the [main] path's), where ab times them
LEG_LEVELS = (4095, 2047, 1023, 511, 255)


def rewrites(v: Variant):
    """(source, text, replacement, times it must occur) that turn the
    sources' schedule into v's."""
    out = [
        ("rbgs.cu", "constexpr int STRIP = 4;",
         f"constexpr int STRIP = {v.strip};", 1),
        ("rbgs.cu", "constexpr int SWEEP_BX = 128, SWEEP_BY = 2;",
         f"constexpr int SWEEP_BX = {v.bx}, SWEEP_BY = {v.by};", 1),
        ("rbgs.cu",
         "constexpr int SWEEP_MIN_BLOCKS = 1024 / (SWEEP_BX * SWEEP_BY);",
         f"constexpr int SWEEP_MIN_BLOCKS = {v.min_blocks};", 1),
        ("rbgs_sys.cu", "static constexpr int WR = 16, WC = 64;",
         f"static constexpr int WR = {v.rows}, WC = 64;", 1),
        ("rbgs_sys.cu", "static constexpr int NT = 256;",
         f"static constexpr int NT = {v.threads};", 1),
        ("rbgs_sys.cu", "static constexpr int BLOCKS = 1024 / NT;",
         f"static constexpr int BLOCKS = {v.blocks};", 1),
        ("rbgs.cu", "static constexpr int WR = 24, SL = 32, NY = 8;",
         f"static constexpr int WR = {v.rb_rows}, SL = 32, NY = 8;", 1),
        ("transfer.cu",
         "static constexpr int ROWS = 16, SLOTS = 32, NY = 8, BLOCKS = 8;",
         f"static constexpr int ROWS = {v.pc_rows}, SLOTS = 32, NY = 8, "
         f"BLOCKS = {v.pc_blocks};", 1),
    ]
    if not v.stage_b:
        out += [
            ("rbgs_sys.cu",
             "      copy_async(dst + (NF + f) * L::FIELD, t.b[f] + g, in);\n",
             "", 1),
            ("rbgs_sys.cu", "      2 * NF * FIELD * static_cast<int>",
             "      NF * FIELD * static_cast<int>", 1),
            ("rbgs_sys.cu", "L::NT, true>(", "L::NT, false>(", 2),
        ]
    return out


def patched_csrc(v: Variant, out_dir: pathlib.Path) -> pathlib.Path:
    """A copy of this checkout's csrc/ with v's schedule."""
    shutil.copytree(CSRC, out_dir)
    for src, old, new, times in rewrites(v):
        path = out_dir / src
        text = path.read_text()
        if text.count(old) != times:
            raise RuntimeError(f"{src}: {old!r} found {text.count(old)} "
                               f"times, not {times}")
        path.write_text(text.replace(old, new))
    return out_dir


def signatures(build_py: pathlib.Path) -> dict:
    """``SIGNATURES`` of the ``_build.py`` at ``build_py``: the argument
    types of that tree's entries."""
    spec = importlib.util.spec_from_file_location(
        f"_build_of_{abs(hash(str(build_py)))}", build_py)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.SIGNATURES


def pc_window_args(lib) -> tuple:
    """(halo, window class) that ``lib``'s es_prolong_correct takes, as
    this checkout's wrapper passes them, or () where its tree declares the
    entry without them (from before it was a windowed kernel)."""
    from evostencils_tpu_torch.ops.kernels import _build, transfer
    if (tuple(lib.es_prolong_correct.argtypes)
            != _build.SIGNATURES["es_prolong_correct"]):
        return ()
    return transfer.leg_halo("up", 0), transfer.PC_WINDOW


def build(tag: str, csrc: pathlib.Path, out_dir: pathlib.Path):
    """Start the nvcc processes of one variant; (library path, objects,
    processes)."""
    from evostencils_tpu_torch.ops.kernels import _build
    nvcc = _build.nvcc_path()
    objs, procs = [], []
    for src in SOURCES:
        obj = out_dir / f"{tag}.{src}.o"
        objs.append(obj)
        procs.append(_build._start([nvcc, *_build.NVCC_FLAGS, "-c", "-o",
                                    str(obj), str(csrc / src)]))
    return out_dir / f"lib{tag}.so", objs, procs


def build_all(variants, out_dir):
    """{tag: ctypes library} of (tag, csrc dir, _build.py of its tree)
    triples, each library with its tree's argument types."""
    from evostencils_tpu_torch.ops.kernels import _build
    started = [(tag, csrc, build_py, *build(tag, csrc, out_dir))
               for tag, csrc, build_py in variants]
    _build._run([p for *_, procs in started for p in procs])
    _build._run([_build._start([_build.nvcc_path(), *_build.ARCH_FLAGS,
                                "-shared", "-o", str(lib), *map(str, objs)])
                 for *_, lib, objs, _ in started])
    libs = {}
    for tag, _, build_py, lib, _, _ in started:
        cdll = ctypes.CDLL(str(lib))
        for name, argtypes in signatures(build_py).items():
            fn = getattr(cdll, name, None)
            if fn is not None:
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[tag] = cdll
    return libs


def call(torch, lib, entry, *args):
    err = getattr(lib, entry)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}")


def through(lib, fn):
    """Run ``fn``, a wrapper call, with ``lib`` as the wrappers' library."""
    from evostencils_tpu_torch.ops.kernels import _build
    saved = _build.load_library
    _build.load_library = lambda: lib
    try:
        fn()
    finally:
        _build.load_library = saved


class Cases:
    """The inputs and entry calls of each timed kernel at each level."""

    def __init__(self, torch, device):
        from evostencils_tpu_torch.ops.kernels import (rbgs, rbgs_sys,
                                                       transfer)
        self.torch, self.rbgs, self.rs = torch, rbgs, rbgs_sys
        self.tt = transfer
        self.rng = np.random.default_rng(3)
        self.device = device
        self.omegas = torch.tensor([0.9, 1.15, 0.8, 1.3], dtype=torch.float32,
                                   device=device)

    def normal(self, *shape):
        return self.torch.tensor(self.rng.standard_normal(shape),
                                 dtype=self.torch.float32, device=self.device)

    def sweep(self, n, parity):
        """(name, bound, run(lib), plain result, result of run)."""
        u, b, out = self.normal(n, n), self.normal(n, n), self.normal(n, n)
        vals = self.rbgs._values(cs.VALS)

        def run(lib):
            call(self.torch, lib, "es_sweep", u.data_ptr(), b.data_ptr(),
                 self.omegas.data_ptr(), 2, parity, vals, out.data_ptr(), n,
                 n)
        plain = self.rbgs.sweep_plain(u, b, self.omegas, 2, cs.VALS, parity)
        return (f"sweep_kernel parity {parity} {n}^2",
                cs.sweep_bound((n, n))[0], run, (plain,), (out,))

    def fused_sweep(self, n):
        """es_fused_rbgs_sweep (row 10), which shares rbgs.cu."""
        u, b, out = self.normal(n, n), self.normal(n, n), self.normal(n, n)
        vals = self.rbgs._values(cs.VALS)

        def run(lib):
            call(self.torch, lib, "es_fused_rbgs_sweep", u.data_ptr(),
                 b.data_ptr(), self.omegas.data_ptr(), 1, vals,
                 out.data_ptr(), n, n)
        plain = self.rbgs.fused_rbgs_sweep_plain(u, b, self.omegas, 1,
                                                 cs.VALS)
        return (f"fused_rbgs_kernel {n}^2", cs.sweep_bound((n, n))[0], run,
                (plain,), (out,))

    def prolong_correct(self, n):
        """es_prolong_correct (row 5), with halo and window class where
        the library's entry takes them (pc_window_args)."""
        nc = (n - 1) // 2
        u, e, out = self.normal(n, n), self.normal(nc, nc), self.normal(n, n)
        coeffs = self.tt._coefficients((1.0, 0, 0, 0, 0), cs.P_TAPS)

        def run(lib):
            call(self.torch, lib, "es_prolong_correct", u.data_ptr(),
                 e.data_ptr(), self.omegas.data_ptr(), 1, coeffs,
                 out.data_ptr(), *pc_window_args(lib), n, n)
        plain = self.tt.prolong_correct_plain(u, e, self.omegas, 1,
                                              cs.P_TAPS)
        return (f"prolong_correct {n}^2", cs.transfer_bound((n, n))[0], run,
                (plain,), (out,))

    def transfer_wrapper(self, name, n, sweeps=None):
        """A kernel of transfer.cu other than row 5 through its wrapper,
        the library swapped in (``through``): the legs with the V(2,1)'s
        sweeps, a fused pass of (post, pre) ``sweeps``, the residual
        restriction."""
        nc = (n - 1) // 2
        u, b, e, ch = (self.normal(n, n), self.normal(n, n),
                       self.normal(nc, nc), self.normal(nc, n))
        tt = self.tt
        if name == "residual_restrict":
            args = (u, b, cs.VALS, cs.R_TAPS)
            bound = cs.transfer_bound((n, n))
            label = f"{name} {n}^2"
        elif name in cs.LOOP_KERNELS:
            kern, plain = cs.loop_calls(tt, self.omegas, name, u, b, e, ch,
                                        sweeps, cs.VALS, cs.R_TAPS,
                                        cs.P_TAPS)
            total = sum(sweeps) if isinstance(sweeps, tuple) else sweeps
            bound = cs.bytes_bound(*cs.loop_work(name, (n, n), total))
            label = f"{name} {n}^2 S={total}"
        else:
            down = name == "presmooth_residual_restrict"
            args = ((u, b, self.omegas, [1, 2], cs.VALS, cs.R_TAPS) if down
                    else (u, e, b, self.omegas, [0, 1], cs.VALS, cs.P_TAPS))
            bound = cs.leg_bound((n, n), 2 if down else 1,
                                 "down" if down else "up")
            label = f"{name} {n}^2"
        if name not in cs.LOOP_KERNELS:
            def kern():
                return getattr(tt, name)(*args)

            def plain():
                return getattr(tt, name + "_plain")(*args)
        got = []

        def run(lib):
            def keep():
                out = kern()
                got[:] = out if isinstance(out, tuple) else (out,)
            through(lib, keep)
        want = plain()
        want = want if isinstance(want, tuple) else (want,)
        return label, bound[0], run, want, got

    def sys_sweep(self, n, table="elasticity", red_black=True):
        if table == "elasticity":
            (coeffs, minv), exc, exc_minv = cs.elasticity_table(n), (), ()
        else:
            coeffs, minv, exc, exc_minv = cs.random_sys_table(self.rng)
        u, b = (self.normal(n, n), self.normal(n, n)), \
            (self.normal(n, n), self.normal(n, n))
        out = (self.normal(n, n), self.normal(n, n))
        rs = self.rs
        args = (rs._ptrs(u), rs._ptrs(b), rs._ptrs(out),
                *rs._system_args(u, coeffs, minv, exc, exc_minv),
                self.omegas.data_ptr(), 1, int(red_black), n, n)

        def run(lib, _live=(u, b, out)):   # the tensors args points to
            call(self.torch, lib, "es_sweep_sys", *args)
        plain = (rs.fused_rbgs_sweep_sys_plain if red_black
                 else rs.jacobi_sweep_sys_plain)(u, b, self.omegas, 1,
                                                 coeffs, minv, exc, exc_minv)
        kernel = "rbgs_sys_kernel" if red_black else "jacobi_sys_kernel"
        return (f"{kernel} {table} {n}^2",
                cs.sys_sweep_bound((n, n), coeffs, minv)[0], run, plain, out)

    def sys_leg(self, n, leg, red_black):
        """The V(2,1)'s leg: 2 sweeps down, 1 up, elasticity's table."""
        rs, (coeffs, minv) = self.rs, cs.elasticity_table(n)
        nc = (n - 1) // 2
        u, b = (self.normal(n, n), self.normal(n, n)), \
            (self.normal(n, n), self.normal(n, n))
        e = (self.normal(nc, nc), self.normal(nc, nc))
        out = (self.normal(n, n), self.normal(n, n))
        rc = (self.normal(nc, nc), self.normal(nc, nc))
        op = rs._system_args(u, coeffs, minv, (), ())
        mode = "RB" if red_black else "Jacobi"
        if leg == "down":
            ids = (ctypes.c_int * 2)(1, 2)
            args = (rs._ptrs(u), rs._ptrs(b), rs._ptrs(out), rs._ptrs(rc),
                    *op, self.omegas.data_ptr(), ids, 2, int(red_black),
                    rs._taps(cs.R_TAPS), rs.leg_halo("down", 2, red_black),
                    n, n)
            entry = "es_presmooth_residual_restrict_sys"
            plain = sum(rs.presmooth_residual_restrict_sys_plain(
                u, b, self.omegas, [1, 2], coeffs, minv, cs.R_TAPS,
                red_black), ())
            got = out + rc
        else:
            ids = (ctypes.c_int * 2)(0, 1)
            args = (rs._ptrs(u), rs._ptrs(e), rs._ptrs(b), rs._ptrs(out),
                    *op, self.omegas.data_ptr(), ids, 1, int(red_black),
                    rs._taps(cs.P_TAPS), rs.leg_halo("up", 1, red_black),
                    n, n)
            entry = "es_prolong_correct_postsmooth_sys"
            plain = rs.prolong_correct_postsmooth_sys_plain(
                u, e, b, self.omegas, [0, 1], coeffs, minv, cs.P_TAPS,
                red_black)
            got = out
        bound = cs.sys_leg_bound((n, n), 2 if leg == "down" else 1, leg,
                                 coeffs, minv)[0]

        def run(lib, _live=(u, b, e, out, rc)):
            call(self.torch, lib, entry, *args)
        return (f"{leg}leg_sys_kernel {mode} {n}^2", bound, run, plain, got)


def log_info(libs, names, card):
    """Each library's sweep kernels and prolongation-correction as the
    card makes them (the entries a parent tree lacks are skipped):
    threads, blocks per SM, registers, local bytes (spills), shared
    bytes."""
    for tag, lib in libs.items():
        queries = [("es_sweep_info", (0,)), ("es_sweep_info", (1,)),
                   ("es_sweep_sys_info", (0,)), ("es_sweep_sys_info", (1,)),
                   ("es_fused_rbgs_sweep_info", ())]
        window = pc_window_args(lib)
        if window:
            queries.append(("es_transfer_leg_info", (0, 0, window[1])))
        for entry, args in queries:
            if not hasattr(lib, entry):
                continue
            out = (ctypes.c_int * 8)()
            if getattr(lib, entry)(*args, out) == 0:
                cs.log(f"[{card}] {names[tag]} {entry}{args}: {out[3]} "
                       f"threads, {out[4]} blocks/SM, {out[5]} registers, "
                       f"{out[6]} B local, {out[7]} B shared")


def error(torch, got, want):
    """max |got - want| / max |want| over the arrays."""
    torch.cuda.synchronize()
    return max(float((g - w).abs().max() / w.abs().max())
               for g, w in zip(got, want))


def measure(torch, libs, turns, cases, card):
    """Time every case with every library in the order ``turns`` (library
    tags); returns {case: {"bound": ms, tag: [ms per turn], "error": ..}}."""
    results = {}
    for name, bound, run, plain, got in cases:
        row = {"bound": bound, "error": {}}
        for tag in dict.fromkeys(turns):
            run(libs[tag])
            row["error"][tag] = error(torch, got, plain)
        for tag in turns:
            row.setdefault(tag, []).append(
                cs.time_ms_queued(torch, lambda: run(libs[tag])))
        results[name] = row
        cells = ", ".join(
            f"{tag} {' / '.join(f'{t:.4f}' for t in row[tag])} ms "
            f"(err {row['error'][tag]:.1e})" for tag in dict.fromkeys(turns))
        cs.log(f"[{card}] {name}: bound {bound:.4f} ms; {cells}")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("variants", "ab"))
    ap.add_argument("--parent", type=pathlib.Path,
                    help="the parent tree (ab): its csrc/ is built")
    ap.add_argument("--only", help="variants: the indices into VARIANTS "
                    "to build, comma-separated (default all)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        if args.mode == "variants":
            picked = (range(len(VARIANTS)) if args.only is None
                      else [int(i) for i in args.only.split(",")])
            names = {f"v{i}": VARIANTS[i].name for i in picked}
            specs = [(f"v{i}", patched_csrc(VARIANTS[i], tmp / f"v{i}"),
                      BUILD_PY) for i in picked]
            turns = [tag for tag, *_ in specs]
            turns += turns[::-1]
        else:
            if args.parent is None:
                ap.error("ab takes --parent DIR")
            names = {"parent": "parent", "change": "change"}
            package = args.parent / "evostencils_tpu_torch"
            specs = [("parent", package / "csrc",
                      package / "ops" / "kernels" / "_build.py"),
                     ("change", CSRC, BUILD_PY)]
            turns = ["parent", "change", "change", "parent"]
        libs = build_all(specs, tmp)
        cs.log(f"[build] {', '.join(f'{t}: {n}' for t, n in names.items())}")
        log_info(libs, names, card)
        c = Cases(torch, "cuda")
        cases = [c.sweep(n, -1) for n in SWEEP_LEVELS]
        cases += [c.sweep(n, 0) for n in (1023, 255)]
        cases += [c.sys_sweep(n) for n in SYS_LEVELS]
        cases += [c.sys_sweep(2047, "random")]
        cases += [c.fused_sweep(n) for n in SWEEP_LEVELS]
        cases += [c.prolong_correct(n) for n in SWEEP_LEVELS]
        if args.mode == "ab":
            # the kernels that share the three sources, unchanged or not
            cases += [c.sys_sweep(n, red_black=False) for n in SYS_LEVELS]
            cases += [c.sys_leg(n, leg, rb) for n in SYS_LEVELS
                      for leg in ("down", "up") for rb in (True, False)]
            cases += [c.transfer_wrapper(name, n) for n in LEG_LEVELS
                      for name in ("presmooth_residual_restrict",
                                   "prolong_correct_postsmooth_col")]
            cases += [c.transfer_wrapper(name, n, sweeps)
                      for n in LEG_LEVELS
                      for name, sweeps in (
                          ("presmooth_residual_rowrestrict", 2),
                          ("prolong_correct_postsmooth", 1))]
            cases += [c.transfer_wrapper(name, n, (1, 2)) for n in (4095, 2047)
                      for name in ("upleg_downleg_col",
                                   "upleg_downleg_fused")]
            cases += [c.transfer_wrapper("residual_restrict", n)
                      for n in SWEEP_LEVELS]
        results = measure(torch, libs, turns, cases, card)
    print(json.dumps({"card": card, "mode": args.mode, "variants": names,
                      "turns": turns, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
