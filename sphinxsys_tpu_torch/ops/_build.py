"""Build and load the hand-written CUDA kernels (csrc/*.cu).

nvcc compiles each source into its own shared library with a plain C
interface, all sources at once in parallel, and each library is loaded
with ctypes (no PyTorch headers: the build takes seconds, not minutes).
A library is built at first use, keyed on a hash of its source, the
shared headers (csrc/*.cuh) and the flags, into `build/kernels/` beside
the package (listed in .gitignore).
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
import types
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = (CSRC / "block_sweeps.cu", CSRC / "packed_sweeps.cu",
           CSRC / "layout_sweeps.cu", CSRC / "lattice_sweeps.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_BOX = [ctypes.c_double] * 3   # periodic lengths (0: no wrap)
ARGTYPES = {
    # block_sweeps.cu
    "density_sweep_launch": [_I, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I,
                             _F, _F, *_BOX, _P, _P],
    "ac1_sweep_launch": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P,
                         _P, _I, _I, _F, _F, _F, *_BOX, _P, _P],
    "ac2_sweep_launch": [_I, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P,
                         _I, _I, _F, _F, _F, _F, *_BOX, _P, _P],
    "visc_tvc_sweep_launch": [_I, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P,
                              _I, _I, _F, _F, _F, *_BOX, _P, _P],
    # packed_sweeps.cu
    "ac1_inner_launch": [_P, _P, _I, _F, _F, _F, _P, _P],
    "ac2_inner_launch": [_P, _P, _I, _F, _F, _F, _F, _P, _P],
    "ac1_wall_launch": [_P, _P, _P, _I, _I, _F, _F, _F, _P, _P],
    "ac2_wall_launch": [_P, _P, _P, _I, _I, _F, _F, _F, _F, _P, _P],
    # layout_sweeps.cu
    "ac1_flat_launch": [_P, _P, _I, _F, _F, _F, _P, _P],
    "ac1_t_launch": [_P, _P, _I, _F, _F, _F, _P, _P],
    # lattice_sweeps.cu
    "lattice_force_launch": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _P, _P],
    "lattice_dfdt_launch": [_P, _P, _I, _I, _I, _P, _P, _I, _P, _P],
    "lattice_occupancy": [_I, _P],
}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(CUDA toolkit missing from PATH and /usr/local/cuda)")
    return nvcc


def library_path(src: Path) -> Path:
    """Where `src`'s library goes, keyed on the source, the headers beside
    it (a source may include any of them) and the flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}_{h.hexdigest()[:16]}.so"


def build() -> tuple[list[Path], str, float]:
    """Compile the sources whose library is not built yet, one nvcc per
    source, all started together.  Returns (library paths, compiler log,
    build seconds; 0 when all are cached)."""
    nvcc = find_nvcc()
    libs = [library_path(src) for src in SOURCES]
    todo = [(src, so) for src, so in zip(SOURCES, libs) if not so.exists()]
    if not todo:
        return libs, "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    for src, so in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)]
        jobs.append((cmd, tmp, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for cmd, tmp, so, proc in jobs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
        else:
            os.replace(tmp, so)
    secs = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs, "".join(logs), secs


@functools.cache
def library() -> types.SimpleNamespace:
    """The launchers of every kernel library (built on first call), as
    attributes named after their C functions."""
    libs, _, _ = build()
    found = {}
    for so in libs:
        lib = ctypes.CDLL(str(so))
        for name, argtypes in ARGTYPES.items():
            fn = getattr(lib, name, None)
            if fn is None:
                continue
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            found[name] = fn
    missing = sorted(set(ARGTYPES) - set(found))
    if missing:
        raise RuntimeError(f"kernel libraries lack {missing}")
    return types.SimpleNamespace(**found)
