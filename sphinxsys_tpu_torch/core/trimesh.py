"""Triangle-mesh 3D geometry (counterpart of sphinxsys_tpu/core/trimesh.py;
reference for_3D_build/geometries/triangle_mesh_shape.{h,cpp},
stl_reader.h, TriangleMeshDistance.h): the shape of the 3D level set.

The signed distance is the dense (N points, T triangles) form of the JAX
package, in torch ops: the closest point on every triangle by Ericson's
region tests, the smallest distance, and the sign from the generalised
winding number (the van Oosterom-Strackee solid angle of each triangle,
summing to ~1 inside a watertight mesh).  `TriangleMesh` is a Shape
(signed_distance / contains / find_normal_direction / bounds), so the
lattice generators, the level set and the relaxation take it as they take
the analytic shapes.  The STL reader and the brick and icosphere builders
are numpy.
"""

from __future__ import annotations

import dataclasses
import math
import struct
from typing import Tuple

import numpy as np
import torch

from sphinxsys_tpu_torch.core.geometry import Shape

TINY = 1.0e-15


# ---------------------------------------------------------------------------
# STL parsing (stl_reader.h counterpart; binary and ascii, numpy only)
# ---------------------------------------------------------------------------

def load_stl(path: str, scale: float = 1.0, offset=(0.0, 0.0, 0.0)):
    """Return (V, F): vertices (M, 3) float64 and faces (T, 3) int32."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:5] == b"solid" and b"facet" in data[:500]:
        tris = _parse_ascii_stl(data.decode("ascii", errors="ignore"))
    else:
        tris = _parse_binary_stl(data)
    tris = tris * scale + np.asarray(offset)
    verts, inv = np.unique(tris.reshape(-1, 3).round(12), axis=0,
                           return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)
    return verts, faces


def _parse_binary_stl(data: bytes) -> np.ndarray:
    n = struct.unpack_from("<I", data, 80)[0]
    rec = np.frombuffer(data, dtype=np.uint8, count=n * 50, offset=84)
    tri = rec.reshape(n, 50)[:, 12:48].copy().view("<f4").reshape(n, 3, 3)
    return tri.astype(np.float64)


def _parse_ascii_stl(text: str) -> np.ndarray:
    pts = [[float(v) for v in line.split()[1:4]]
           for line in map(str.strip, text.splitlines())
           if line.startswith("vertex")]
    return np.asarray(pts, np.float64).reshape(-1, 3, 3)


# ---------------------------------------------------------------------------
# Dense point-to-mesh signed distance
# ---------------------------------------------------------------------------

def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _closest_point_on_triangles(p, a, b, c):
    """Ericson's closest point on each triangle: p (..., 1, 3) against
    triangles a / b / c (T, 3).  Returns the squared distances (..., T)."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1, d2 = _dot(ab, ap), _dot(ac, ap)
    bp = p - b
    d3, d4 = _dot(ab, bp), _dot(ac, bp)
    cp = p - c
    d5, d6 = _dot(ab, cp), _dot(ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = va + vb + vc

    # barycentric candidates, clamped per Ericson's region tests
    def unit(x):
        return torch.clamp(x, 0.0, 1.0)

    v_ab = unit(d1 / (d1 - d3 + TINY))
    w_ac = unit(d2 / (d2 - d6 + TINY))
    w_bc = unit((d4 - d3) / ((d4 - d3) + (d5 - d6) + TINY))
    v_in = vb / (denom + TINY)
    w_in = vc / (denom + TINY)

    in_vert_a = (d1 <= 0) & (d2 <= 0)
    in_vert_b = (d3 >= 0) & (d4 <= d3)
    in_vert_c = (d6 >= 0) & (d5 <= d6)
    in_edge_ab = ~in_vert_a & ~in_vert_b & (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    in_edge_ac = ~in_vert_a & ~in_vert_c & (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    in_edge_bc = ~in_vert_b & ~in_vert_c & (va <= 0) & ((d4 - d3) >= 0) \
        & ((d5 - d6) >= 0)

    def sel(m, x, q):
        return torch.where(m[..., None], x, q)

    q = a + v_in[..., None] * ab + w_in[..., None] * ac
    q = sel(in_edge_bc, b + w_bc[..., None] * (c - b), q)
    q = sel(in_edge_ac, a + w_ac[..., None] * ac, q)
    q = sel(in_edge_ab, a + v_ab[..., None] * ab, q)
    q = sel(in_vert_c, c.expand_as(q), q)
    q = sel(in_vert_b, b.expand_as(q), q)
    q = sel(in_vert_a, a.expand_as(q), q)
    d = p - q
    return _dot(d, d)


def _winding_number(p, a, b, c):
    """Generalised winding number by the van Oosterom-Strackee solid angle
    of each triangle."""
    ra, rb, rc = a - p, b - p, c - p
    la = torch.sqrt(_dot(ra, ra))
    lb = torch.sqrt(_dot(rb, rb))
    lc = torch.sqrt(_dot(rc, rc))
    num = _dot(ra, torch.linalg.cross(rb, rc, dim=-1))
    den = (la * lb * lc + _dot(ra, rb) * lc + _dot(rb, rc) * la
           + _dot(rc, ra) * lb)
    omega = 2.0 * torch.atan2(num, den)
    return torch.sum(omega, dim=-1) / (4.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class TriangleMesh(Shape):
    """Watertight triangle-mesh shape (TriangleMeshShapeSTL)."""

    vertices: Tuple[Tuple[float, float, float], ...]
    faces: Tuple[Tuple[int, int, int], ...]
    name: str = "TriangleMesh"

    @staticmethod
    def from_arrays(verts, faces, name: str = "TriangleMesh"):
        return TriangleMesh(vertices=tuple(map(tuple, np.asarray(verts))),
                            faces=tuple(map(tuple, np.asarray(faces))),
                            name=name)

    @staticmethod
    def from_stl(path: str, scale: float = 1.0, offset=(0.0, 0.0, 0.0)):
        v, f = load_stl(path, scale, offset)
        return TriangleMesh.from_arrays(v, f, name=path)

    def _tris(self, like):
        v = torch.as_tensor(self.vertices, dtype=like.dtype,
                            device=like.device)
        f = torch.as_tensor(self.faces, dtype=torch.int64, device=like.device)
        return v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]

    def signed_distance(self, pos):
        squeeze = pos.dim() == 1
        p = torch.atleast_2d(pos)[:, None, :]          # (N, 1, 3)
        a, b, c = self._tris(pos)
        d2 = _closest_point_on_triangles(p, a, b, c)   # (N, T)
        dist = torch.sqrt(torch.amin(d2, dim=-1) + TINY)
        wn = _winding_number(p, a, b, c)               # (N,)
        sd = torch.where(wn > 0.5, -dist, dist)
        return sd[0] if squeeze else sd

    def bounds(self):
        v = np.asarray(self.vertices)
        return v.min(0), v.max(0)


def box_mesh(halfsize=(0.5, 0.5, 0.5), center=(0.0, 0.0, 0.0)):
    """12-triangle brick (TriangleMeshShapeBrick)."""
    hx, hy, hz = halfsize
    cx, cy, cz = center
    v = np.asarray([[sx * hx + cx, sy * hy + cy, sz * hz + cz]
                    for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
    # outward faces of the cube (vertex index = 4 sx + 2 sy + sz bits)
    f = np.asarray([
        [0, 1, 3], [0, 3, 2],   # -x
        [4, 6, 7], [4, 7, 5],   # +x
        [0, 4, 5], [0, 5, 1],   # -y
        [2, 3, 7], [2, 7, 6],   # +y
        [0, 2, 6], [0, 6, 4],   # -z
        [1, 5, 7], [1, 7, 3],   # +z
    ], np.int32)
    return TriangleMesh.from_arrays(v, f, name="Brick")


def icosphere_mesh(radius: float = 0.5, center=(0.0, 0.0, 0.0),
                   subdivisions: int = 2):
    """Subdivided icosahedron (TriangleMeshShapeSphere), the JAX
    package's vertex and face order."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.asarray([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
         (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
         (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
         (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    for _ in range(subdivisions):
        verts = list(map(tuple, v))
        index = {w: i for i, w in enumerate(verts)}
        new_f = []

        def mid(i, j):
            m = tuple((v[i] + v[j]) / np.linalg.norm(v[i] + v[j]))
            if m not in index:
                index[m] = len(verts)
                verts.append(m)
            return index[m]

        for (i, j, k) in f:
            ij, jk, ki = mid(i, j), mid(j, k), mid(k, i)
            new_f += [(i, ij, ki), (j, jk, ij), (k, ki, jk), (ij, jk, ki)]
            v = np.asarray(verts)
        f = new_f
    v = v * radius + np.asarray(center)
    return TriangleMesh.from_arrays(v, np.asarray(f, np.int32), name="Sphere")
