"""Build, load and launch the port's CUDA kernels.

The sources under ``evostencils_tpu_torch/csrc/`` are compiled at first use
with ``nvcc`` for ``sm_90a``, one ``nvcc`` process per source, all started
together, and linked into a shared library with a plain C interface, which
is loaded with ``ctypes``.  The library lands in
``evostencils_tpu_torch/_build/`` (git-ignored), named by a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
reused.  Nothing here runs at import time.

The helpers at the end are shared by the kernel wrappers: the device
dispatch (a CUDA tensor launches the kernel, a CPU tensor takes the plain
version, any other device raises), the dtype (float32 unless a kernel
takes complex64 or bfloat16) and contiguity checks, the gates' refusal of
bfloat16 where a kernel has no bf16 form, and the launch itself, which
raises on a refused launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

_PACKAGE = pathlib.Path(__file__).resolve().parents[2]
SOURCES = (_PACKAGE / "csrc" / "transfer.cu",
           _PACKAGE / "csrc" / "wavefront3d.cu",
           _PACKAGE / "csrc" / "rbgs.cu",
           _PACKAGE / "csrc" / "sweep3d.cu",
           _PACKAGE / "csrc" / "leg3d.cu",
           _PACKAGE / "csrc" / "rbgs_var.cu",
           _PACKAGE / "csrc" / "rbgs_sys.cu",
           _PACKAGE / "csrc" / "rbgs_cx.cu")
#: headers the sources include; part of the library's hash
HEADERS = (_PACKAGE / "csrc" / "cp_async.cuh",
           _PACKAGE / "csrc" / "pipeline3d.cuh")
BUILD_DIR = _PACKAGE / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_INT = ctypes.c_int
_INTS = ctypes.POINTER(ctypes.c_int)
_DOUBLES = ctypes.POINTER(ctypes.c_double)
_PTRS = ctypes.POINTER(ctypes.c_void_p)
#: the operator arguments of the system kernels: F, the coefficient table
#: and point-solve matrix, the fixup counts (center, point-solve), their
#: rows and their deltas
_SYS = (_INT, _DOUBLES, _INT, _INT, _INTS, _DOUBLES)

#: C entry points: name -> argument types (all return a cudaError_t as int)
SIGNATURES = {
    # u, b, omegas, omega ids, sweeps, coefficients, u_out, rc or rr,
    # column transfers, halo, window class, n, m, stream
    "es_presmooth_residual_restrict":
        (_P, _P, _P, _INTS, _INT, _DOUBLES, _P, _P, _INT, _INT, _INT, _INT,
         _INT, _P),
    # u, e or c_half, b, omegas, omega ids, sweeps, coefficients, u_out,
    # column transfers, halo, window class, n, m, stream
    "es_prolong_correct_postsmooth":
        (_P, _P, _P, _P, _INTS, _INT, _DOUBLES, _P, _INT, _INT, _INT, _INT,
         _INT, _P),
    # form (0 up, 1 down, 2 pass, 3 row-only pass, 4 row-only down, 5
    # row-only up), sweeps, window class, info (8 ints out); no stream
    "es_transfer_leg_info": (_INT, _INT, _INT, _INTS),
    # the legs with both transfer axes in bf16 storage: as the float32
    # entries without the column-transfers flag
    "es_presmooth_residual_restrict_bf16":
        (_P, _P, _P, _INTS, _INT, _DOUBLES, _P, _P, _INT, _INT, _INT, _INT,
         _P),
    "es_prolong_correct_postsmooth_bf16":
        (_P, _P, _P, _P, _INTS, _INT, _DOUBLES, _P, _INT, _INT, _INT, _INT,
         _P),
    # form (0 up, 1 down), sweeps, window class, info (8 ints out)
    "es_transfer_leg_info_bf16": (_INT, _INT, _INT, _INTS),
    # u, e or c_half, b, omegas, omega ids, sweeps, coefficients, u_out,
    # rc or rr, column transfers, halo, window class, n, m, stream
    "es_upleg_downleg":
        (_P, _P, _P, _P, _INTS, _INT, _DOUBLES, _P, _P, _INT, _INT, _INT,
         _INT, _INT, _P),
    # u, b, coefficients, rc, halo, window class, n, m, stream
    "es_residual_restrict":
        (_P, _P, _DOUBLES, _P, _INT, _INT, _INT, _INT, _P),
    # u, e, omegas, omega id, coefficients, u_out, halo, window class, n,
    # m, stream
    "es_prolong_correct":
        (_P, _P, _P, _INT, _DOUBLES, _P, _INT, _INT, _INT, _INT, _P),
    # u, b, omegas, omega id, parity, stencil values, out, n, m, stream
    "es_sweep": (_P, _P, _P, _INT, _INT, _DOUBLES, _P, _INT, _INT, _P),
    # one colour, info (8 ints out); no stream
    "es_sweep_info": (_INT, _INTS),
    # u, b, omegas, omega id, stencil values, out, n, m, stream
    "es_fused_rbgs_sweep":
        (_P, _P, _P, _INT, _DOUBLES, _P, _INT, _INT, _P),
    # info (8 ints out); no stream
    "es_fused_rbgs_sweep_info": (_INTS,),
    # u, b, omegas, omega ids, coefficients, u_out, rc, n0, n1, n2, stream
    "es_downleg_wavefront_3d":
        (_P, _P, _P, _INTS, _DOUBLES, _P, _P, _INT, _INT, _INT, _P),
    # u, e, b, omegas, omega ids, coefficients, u_out, n0, n1, n2, stream
    "es_upleg_wavefront_3d":
        (_P, _P, _P, _P, _INTS, _DOUBLES, _P, _INT, _INT, _INT, _P),
    # down, info (11 ints out); no stream
    "es_wavefront_3d_info": (_INT, _INTS),
    # u, b, omegas, omega id, red-black, stencil values, out, n0, n1, n2,
    # stream
    "es_sweep3d":
        (_P, _P, _P, _INT, _INT, _DOUBLES, _P, _INT, _INT, _INT, _P),
    # info (11 ints out, the red-black kernel's); no stream
    "es_sweep3d_info": (_INTS,),
    # u, b, coefficients, rc, n0, n1, n2, stream
    "es_residual_restrict_3d":
        (_P, _P, _DOUBLES, _P, _INT, _INT, _INT, _P),
    # info (11 ints out); no stream
    "es_residual_restrict_3d_info": (_INTS,),
    # u, e, omegas, omega id, coefficients, u_out, n0, n1, n2, stream
    "es_prolong_correct_3d":
        (_P, _P, _P, _INT, _DOUBLES, _P, _INT, _INT, _INT, _P),
    # info (11 ints out); no stream
    "es_prolong_correct_3d_info": (_INTS,),
    # u, b, coefficient stack, omegas, omega id, red-black, out, n, m, stream
    "es_sweep_var": (_P, _P, _P, _P, _INT, _INT, _P, _INT, _INT, _P),
    # info (8 ints out); no stream
    "es_sweep_var_info": (_INTS,),
    # u, b, coefficient stack, omegas, omega ids, sweeps, red-black, taps,
    # u_out, rc, halo, n, m, stream
    "es_presmooth_residual_restrict_var":
        (_P, _P, _P, _P, _INTS, _INT, _INT, _DOUBLES, _P, _P, _INT, _INT,
         _INT, _P),
    # u, e, b, coefficient stack, omegas, omega ids, sweeps, red-black,
    # taps, u_out, halo, n, m, stream
    "es_prolong_correct_postsmooth_var":
        (_P, _P, _P, _P, _P, _INTS, _INT, _INT, _DOUBLES, _P, _INT, _INT,
         _INT, _P),
    # down, sweeps, red-black, info (8 ints out); no stream
    "es_var_leg_info": (_INT, _INT, _INT, _INTS),
    # u, b, out (F pointers each), the operator, omegas, omega id,
    # red-black, n, m, stream
    "es_sweep_sys": (_PTRS, _PTRS, _PTRS) + _SYS
                    + (_P, _INT, _INT, _INT, _INT, _P),
    # fixups, info (8 ints out, the red-black kernel's); no stream
    "es_sweep_sys_info": (_INT, _INTS),
    # u, b, u_out, rc (F pointers each), the operator, omegas, omega ids,
    # sweeps, red-black, taps, halo, n, m, stream
    "es_presmooth_residual_restrict_sys":
        (_PTRS, _PTRS, _PTRS, _PTRS) + _SYS
        + (_P, _INTS, _INT, _INT, _DOUBLES, _INT, _INT, _INT, _P),
    # u, e, b, u_out (F pointers each), the operator, omegas, omega ids,
    # sweeps, red-black, taps, halo, n, m, stream
    "es_prolong_correct_postsmooth_sys":
        (_PTRS, _PTRS, _PTRS, _PTRS) + _SYS
        + (_P, _INTS, _INT, _INT, _DOUBLES, _INT, _INT, _INT, _P),
    # down, sweeps, red-black, fixups, info (5 ints out); no stream
    "es_leg_sys_info": (_INT, _INT, _INT, _INT, _INTS),
    # u, b (complex64), omegas, omega id, the 5 stencil values and 1/center
    # as (re, im) doubles, out, n, m, stream
    "es_sweep_cx": (_P, _P, _P, _INT, _DOUBLES, _P, _INT, _INT, _P),
    "es_fused_rbgs_sweep_cx": (_P, _P, _P, _INT, _DOUBLES, _P, _INT, _INT,
                               _P),
    # info (8 ints out); no stream
    "es_fused_rbgs_sweep_cx_info": (_INTS,),
}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    PATH, else the toolkit's default location."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libevostencils_kernels_{digest.hexdigest()[:16]}.so"


def _run(procs) -> None:
    """Wait for every (process, command) pair; raise on the first failure."""
    failed = []
    for proc, cmd in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{stdout}{stderr}")
    if failed:
        raise RuntimeError("\n".join(failed))


def _start(cmd):
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), cmd


def build() -> pathlib.Path:
    """Compile the sources unless the library for their hash exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in SOURCES]
    nvcc = nvcc_path()
    _run([_start([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)])
          for src, obj in zip(SOURCES, objs)])
    tmp = out.with_name(f"{tag}.so.tmp")
    _run([_start([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                  *map(str, objs)])])
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)     # atomic: a concurrent process never loads half a file
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's types."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.es_error_string.argtypes = (ctypes.c_int,)
    lib.es_error_string.restype = ctypes.c_char_p
    return lib


def on_card(u) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if u.device.type == "cuda":
        return True
    if u.device.type == "cpu":
        return False
    raise ValueError(f"no kernel implementation for device {u.device}")


def sms(device: torch.device) -> int:
    """The streaming multiprocessors of the card ``device`` is on."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def info(entry: str, what: str, *args) -> dict:
    """What the card makes of a windowed kernel's instantiation: the eight
    ints the C entry ``entry`` reports for ``args`` (its tile, halo,
    threads per block, resident blocks per SM, registers and local memory
    (spills) per thread, dynamic shared memory per block).  ``what`` names
    the instantiation in the error.  Needs the card."""
    out = (ctypes.c_int * 8)()
    err = getattr(load_library(), entry)(*args, out)
    if err != 0:
        raise RuntimeError(f"no instantiation {what}: CUDA error {err}")
    return dict(zip(("tile_rows", "tile_cols", "halo", "threads",
                     "blocks_per_sm", "registers", "local_bytes",
                     "smem_bytes"), out))


def refuse_bf16(u, kernel: str, jax_gate: str) -> None:
    """A kernel gate's refusal of bfloat16 storage: raise
    NotImplementedError for a bf16 ``u`` at a kernel with no bf16 form,
    named by ``kernel`` (its rows of the port's kernel table), where the
    JAX gate ``jax_gate`` (under evostencils_tpu/ops/pallas/) admits bf16
    storage with float32 compute.  Taking the plain version instead would
    compute in bf16 arithmetic, which no TPU kernel does."""
    if u.dtype == torch.bfloat16:
        raise NotImplementedError(
            f"kernel {kernel} has no bfloat16-storage form; the JAX gate "
            f"evostencils_tpu/ops/pallas/{jax_gate} admits bf16")


def check_card_tensors(*tensors, dtype=torch.float32) -> None:
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"the CUDA kernel takes {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")


def launch(counts, name, entry, device, *args) -> None:
    """Call the C entry point ``entry`` on ``device``'s current stream;
    raise if it reports a CUDA error (a refused launch never runs), else
    add one to ``counts[name]``."""
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({lib.es_error_string(err).decode()})")
    counts[name] += 1
