"""Build and load the port's CUDA kernels.

The sources under ``evostencils_tpu_torch/csrc/`` are compiled at first use
with ``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
which is loaded with ``ctypes``.  The library lands in
``evostencils_tpu_torch/_build/`` (git-ignored), named by a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
reused.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

_PACKAGE = pathlib.Path(__file__).resolve().parents[2]
SOURCES = (_PACKAGE / "csrc" / "transfer.cu",)
BUILD_DIR = _PACKAGE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_INT = ctypes.c_int
_INTS = ctypes.POINTER(ctypes.c_int)
_DOUBLES = ctypes.POINTER(ctypes.c_double)

#: C entry points: name -> argument types (all return a cudaError_t as int)
SIGNATURES = {
    # u, b, omegas, omega ids, sweeps, coefficients, u_out, rc, n, m, stream
    "es_presmooth_residual_restrict":
        (_P, _P, _P, _INTS, _INT, _DOUBLES, _P, _P, _INT, _INT, _P),
    # u, e, b, omegas, omega ids, sweeps, coefficients, u_out, n, m, stream
    "es_prolong_correct_postsmooth":
        (_P, _P, _P, _P, _INTS, _INT, _DOUBLES, _P, _INT, _INT, _P),
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
    for src in SOURCES:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libevostencils_kernels_{digest.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the sources unless the library for their hash exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
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
