"""VTP (VTK PolyData XML) body-state writer (counterpart of
sphinxsys_tpu/io/vtk.py; reference io_system/io_vtk.h
BodyStatesRecordingToVtp): particle clouds as VTP point sets with selected
point-data arrays, viewable in ParaView.  The bytes equal the JAX
package's for the same values.

A state's tensors may lie on any device: each array written is copied to
the host once a frame, its real rows only.  The "%.7g" text is made by the
native formatter, `csrc/fastio.cpp`, which g++ builds at first use into
`build/host/` beside the package (git-ignored), keyed on a hash of its
source and flags; a failed build raises.  `native=False` takes the Python
formatter instead, on the caller's request only.  Arrays of other dtypes
than float32 / float64 go through the Python formatter either way, as in
the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Iterable

import numpy as np
import torch

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "fastio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
N_THREADS = max(1, min(8, os.cpu_count() or 1))


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"fastio_{h.hexdigest()[:16]}.so"


@functools.cache
def fastio() -> ctypes.CDLL:
    """The native formatter's library, built by g++ on first call."""
    so = library_path()
    if not so.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the native VTP formatter "
                               "cannot be built (pass native=False for the "
                               "Python formatter)")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [gxx, *GXX_FLAGS, "-o", tmp, str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.format_rows_bound.argtypes = [ctypes.c_int64, ctypes.c_int64]
    lib.format_rows_bound.restype = ctypes.c_int64
    lib.format_rows.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.format_rows.restype = ctypes.c_int64
    return lib


def _format_rows(arr: np.ndarray, native: bool) -> str:
    """ASCII rows of a 2D array ('%.7g', space-separated)."""
    arr = np.ascontiguousarray(arr)
    if native and arr.dtype in (np.float32, np.float64):
        lib = fastio()
        rows, cols = arr.shape
        out = np.empty(max(1, lib.format_rows_bound(rows, cols)), np.uint8)
        n = lib.format_rows(arr.ctypes.data, rows, cols,
                            int(arr.dtype == np.float64), N_THREADS,
                            out.ctypes.data)
        return out[:n].tobytes().decode()
    return "\n".join(" ".join(f"{x:.7g}" for x in row) for row in arr) + "\n"


def _as3d(pos: np.ndarray) -> np.ndarray:
    if pos.shape[1] == 3:
        return pos
    out = np.zeros((pos.shape[0], 3), dtype=pos.dtype)
    out[:, : pos.shape[1]] = pos
    return out


def host_rows(value, n: int) -> np.ndarray:
    """The first n rows of a tensor (any device) or array, on the host."""
    if torch.is_tensor(value):
        return value[:n].detach().cpu().numpy()
    return np.asarray(value)[:n]


def write_vtp(path: str, state: dict, variables: Iterable[str] = (),
              native: bool = True) -> None:
    """Write the real particles of `state` with the named variables as
    point data (scalars or vectors; vectors padded to 3 components)."""
    n = int(state["NReal"])
    pos = _as3d(host_rows(state["Position"], n))
    lines = [
        '<?xml version="1.0"?>',
        '<VTKFile type="PolyData" version="1.0" byte_order="LittleEndian">',
        "  <PolyData>",
        f'    <Piece NumberOfPoints="{n}" NumberOfVerts="0" NumberOfLines="0" '
        'NumberOfStrips="0" NumberOfPolys="0">',
        "      <Points>",
        '        <DataArray type="Float32" NumberOfComponents="3" format="ascii">',
        _format_rows(pos, native).rstrip("\n"),
        "        </DataArray>",
        "      </Points>",
        "      <PointData>",
    ]
    for name in variables:
        arr = host_rows(state[name], n)
        if arr.ndim == 1:
            lines.append(f'        <DataArray type="Float32" Name="{name}" format="ascii">')
            lines.append(_format_rows(arr[:, None], native).replace("\n", " ").rstrip())
        else:
            lines.append(f'        <DataArray type="Float32" Name="{name}" '
                         'NumberOfComponents="3" format="ascii">')
            lines.append(_format_rows(_as3d(arr), native).rstrip("\n"))
        lines.append("        </DataArray>")
    lines += [
        "      </PointData>",
        "    </Piece>",
        "  </PolyData>",
        "</VTKFile>",
        "",
    ]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines))


class BodyStatesRecording:
    """Numbered VTP series per body (BodyStatesRecordingToVtp)."""

    def __init__(self, output_dir: str):
        self.output_dir = output_dir
        self.counter = 0
        self._selections: dict[str, list[str]] = {}

    def add_to_write(self, body_name: str, *variables: str) -> None:
        self._selections.setdefault(body_name, []).extend(variables)

    def write(self, bodies: dict[str, dict]) -> None:
        for name, state in bodies.items():
            variables = self._selections.get(name, [])
            path = os.path.join(self.output_dir, f"{name}_{self.counter:07d}.vtp")
            write_vtp(path, state, variables)
        self.counter += 1
