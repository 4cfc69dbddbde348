"""Build and load the hand-written CUDA kernels (csrc/*.cu).

nvcc compiles the sources into a shared library with a plain C interface,
loaded with ctypes (no PyTorch headers: the build takes seconds, not
minutes).  The library is built at first use, keyed on a hash of the
sources, into `build/kernels/` beside the package (listed in .gitignore).
A missing nvcc or a failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = (CSRC / "block_sweeps.cu",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_BOX = [ctypes.c_double] * 3   # periodic lengths (0: no wrap)
ARGTYPES = {
    "density_sweep_launch": [_I, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I,
                             _F, _F, *_BOX, _P, _P],
    "ac1_sweep_launch": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P,
                         _P, _I, _I, _F, _F, _F, *_BOX, _P, _P],
    "ac2_sweep_launch": [_I, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P,
                         _I, _I, _F, _F, _F, _F, *_BOX, _P, _P],
    "visc_tvc_sweep_launch": [_I, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P,
                              _I, _I, _F, _F, _F, *_BOX, _P, _P],
}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(CUDA toolkit missing from PATH and /usr/local/cuda)")
    return nvcc


def source_digest() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> tuple[Path, str, float]:
    """Compile the sources if their library is not built yet.
    Returns (library path, compiler log, build seconds; 0 when cached)."""
    nvcc = find_nvcc()
    so = BUILD_DIR / f"sphinxsys_kernels_{source_digest()}.so"
    if so.exists():
        return so, "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, so)
    return so, log, secs


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    so, _, _ = build()
    lib = ctypes.CDLL(str(so))
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
