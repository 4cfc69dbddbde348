"""Geometry: shapes as signed-distance functions with CSG composition
(counterpart of sphinxsys_tpu/core/geometry.py; what the dambreak and
fsi2 scenes need: `Transform`, `Box`, `Ball`, `ComplexShape`,
`make_complex`; the fish and the T-pipe need `Polygon` and
`make_multi_polygon`; the granular pile needs `Cylinder`; the heart's
ventricle and the Purkinje tree need `Ellipsoid` and `HalfSpace`; the
multi-resolution cylinder's relaxation needs `InverseShape`).

Positions are (..., dim) tensors.  `signed_distance` is negative inside.
`find_normal_direction` is the unit gradient of the SDF, taken with
torch.autograd where the JAX package uses jax.grad.  Every max/min is
`torch.amax` / `torch.maximum` / `torch.minimum`: they split the gradient
evenly between tied operands exactly as JAX does, which decides the
normals at the tank corners (`max(dim)` and `clamp` would not).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Transform:
    """x_global = x_local + t (the dambreak shapes are unrotated)."""

    translation: Tuple[float, ...]

    def to_local(self, pos):
        return pos - torch.as_tensor(self.translation, dtype=pos.dtype,
                                     device=pos.device)


class Shape:
    def signed_distance(self, pos):
        raise NotImplementedError

    def contains(self, pos):
        return self.signed_distance(pos) < 0.0

    def find_normal_direction(self, pos):
        """Unit gradient of the signed distance (outward where the SDF is
        exact); the reference's findNormalDirection convention."""
        with torch.enable_grad():
            p = pos.detach().clone().requires_grad_(True)
            (g,) = torch.autograd.grad(self.signed_distance(p).sum(), p)
        return g / (torch.linalg.vector_norm(g, dim=-1, keepdim=True) + 1e-30)


@dataclasses.dataclass(frozen=True)
class Box(Shape):
    """Axis-aligned (optionally transformed) box given by halfsize."""

    transform: Transform
    halfsize: Tuple[float, ...]

    def signed_distance(self, pos):
        x = self.transform.to_local(pos)
        hs = torch.as_tensor(self.halfsize, dtype=pos.dtype, device=pos.device)
        d = torch.abs(x) - hs
        d_pos = torch.maximum(d, torch.zeros_like(d))
        sq = torch.sum(d_pos * d_pos, dim=-1)
        # safe norm: keeps the gradient finite at interior points (sq == 0)
        pos_sq = sq > 0
        outside = torch.where(
            pos_sq, torch.sqrt(torch.where(pos_sq, sq, torch.ones_like(sq))),
            torch.zeros_like(sq))
        dmax = torch.amax(d, dim=-1)
        inside = torch.minimum(dmax, torch.zeros_like(dmax))
        return outside + inside

    def bounds(self):
        hs = np.asarray(self.halfsize, dtype=np.float64)
        t = np.asarray(self.transform.translation, dtype=np.float64)
        return t - hs, t + hs


@dataclasses.dataclass(frozen=True)
class Ball(Shape):
    """Sphere / circle (GeometricShapeBall)."""

    center: Tuple[float, ...]
    radius: float

    def signed_distance(self, pos):
        c = torch.as_tensor(self.center, dtype=pos.dtype, device=pos.device)
        d = pos - c
        sq = torch.sum(d * d, dim=-1)
        # safe sqrt: both wheres, or the gradient at the exact centre is
        # 0 * inf = NaN (autograd differentiates the untaken branch too)
        pos_sq = sq > 0
        r = torch.where(pos_sq,
                        torch.sqrt(torch.where(pos_sq, sq, torch.ones_like(sq))),
                        torch.zeros_like(sq))
        return r - self.radius

    def bounds(self):
        c = np.asarray(self.center, dtype=np.float64)
        return c - self.radius, c + self.radius


@dataclasses.dataclass(frozen=True)
class Cylinder(Shape):
    """Finite circular cylinder (TriangleMeshShapeCylinder): `axis` the
    symmetry direction (normalised here), `halflength` the half-height.
    The SDF is the 2D box distance in (radial, axial); the radius is
    sqrt(|rad|^2 + 1e-30), as JAX's.  Outside, the normal is JAX's;
    inside, where jax.grad gives NaN (the outside term's sqrt(0)
    differentiated, times 0), autograd gives the nearer face's direction:
    radial, or along the axis."""

    center: Tuple[float, ...]
    axis: Tuple[float, ...]
    radius: float
    halflength: float

    def signed_distance(self, pos):
        c = torch.as_tensor(self.center, dtype=pos.dtype, device=pos.device)
        a = np.asarray(self.axis, dtype=np.float64)
        a = torch.as_tensor(a / np.linalg.norm(a), dtype=pos.dtype,
                            device=pos.device)
        p = pos - c
        ax = torch.sum(p * a, dim=-1)
        rad_vec = p - ax[..., None] * a
        rad = torch.sqrt(torch.sum(rad_vec * rad_vec, dim=-1) + 1e-30)
        dr = rad - self.radius
        dz = torch.abs(ax) - self.halflength
        zero = torch.zeros_like(dr)
        outside = torch.sqrt(torch.maximum(dr, zero) ** 2
                             + torch.maximum(dz, zero) ** 2)
        inside = torch.minimum(torch.maximum(dr, dz), zero)
        return outside + inside


@dataclasses.dataclass(frozen=True)
class Ellipsoid(Shape):
    """Axis-aligned ellipsoid (the procedural stand-in for the STL organ
    geometries): the first-order SDF sd = k0 (k0 - 1) / k1 with
    k0 = |p / r|, k1 = |p / r^2| (each root of its sum + 1e-30, as JAX's)
    -- the exact sign everywhere, the distance accurate near the surface,
    where the generators and the network growth use it."""

    center: Tuple[float, ...]
    semi_axes: Tuple[float, ...]

    def signed_distance(self, pos):
        c = torch.as_tensor(self.center, dtype=pos.dtype, device=pos.device)
        r = torch.as_tensor(self.semi_axes, dtype=pos.dtype,
                            device=pos.device)
        p = pos - c
        k0 = torch.sqrt(torch.sum((p / r) ** 2, dim=-1) + 1e-30)
        k1 = torch.sqrt(torch.sum((p / (r * r)) ** 2, dim=-1) + 1e-30)
        return k0 * (k0 - 1.0) / k1

    def bounds(self):
        c = np.asarray(self.center, dtype=np.float64)
        r = np.asarray(self.semi_axes, dtype=np.float64)
        return c - r, c + r


@dataclasses.dataclass(frozen=True)
class HalfSpace(Shape):
    """The half space {x : (x - point) . n < 0}, n the normalised
    `outward_normal` (open walls; the ventricle's base cut)."""

    point: Tuple[float, ...]
    outward_normal: Tuple[float, ...]

    def signed_distance(self, pos):
        p = torch.as_tensor(self.point, dtype=pos.dtype, device=pos.device)
        n = torch.as_tensor(self.outward_normal, dtype=pos.dtype,
                            device=pos.device)
        n = n / torch.sqrt(torch.sum(n * n))
        return torch.sum((pos - p) * n, dim=-1)

    def bounds(self):
        big = 1e30
        d = len(self.point)
        return -big * np.ones(d), big * np.ones(d)


@dataclasses.dataclass(frozen=True)
class InverseShape(Shape):
    """Inside and outside swapped (InverseShape<>, base_geometry.h): a
    fluid confined outside an obstacle (static_confinement.cpp:147)."""

    base: Shape

    def signed_distance(self, pos):
        return -self.base.signed_distance(pos)

    def contains(self, pos):
        return ~self.base.contains(pos)

    def bounds(self):
        return self.base.bounds()


@dataclasses.dataclass(frozen=True)
class ComplexShape(Shape):
    """CSG add/subtract composition, applied left to right.  Containment is
    the exact sequential fold; the SDF is the max/min approximation."""

    shapes: Tuple[Shape, ...]
    ops: Tuple[int, ...]

    def contains(self, pos):
        inside = torch.zeros(pos.shape[:-1], dtype=torch.bool, device=pos.device)
        for s, op in zip(self.shapes, self.ops):
            si = s.contains(pos)
            inside = inside | si if op > 0 else inside & ~si
        return inside

    def signed_distance(self, pos):
        sd = torch.full(pos.shape[:-1], 1e30, dtype=pos.dtype, device=pos.device)
        for s, op in zip(self.shapes, self.ops):
            si = s.signed_distance(pos)
            sd = torch.minimum(sd, si) if op > 0 else torch.maximum(sd, -si)
        return sd


@dataclasses.dataclass(frozen=True)
class Polygon(Shape):
    """2D simple polygon by its vertex list (MultiPolygonShape,
    for_2D_build/geometries/multi_polygon_shape.h): the distance to the
    nearest edge, negative where the crossing number is odd.

    Ties decide the normals: a lattice point nearest a vertex is equally
    near two edges, and one that projects onto an edge's end clips t at
    0 or 1.  `torch.amin` and `torch.maximum` / `torch.minimum` split the
    gradient evenly among tied operands, as `jnp.min` and `jnp.clip` do
    (`torch.min(dim=)` and `torch.clamp` would not).  The edge distance is
    sqrt(sum d^2), whose gradient at d = 0 is NaN, as `jnp.linalg.norm`'s
    is."""

    vertices: Tuple[Tuple[float, float], ...]

    def signed_distance(self, pos):
        v = torch.as_tensor(self.vertices, dtype=pos.dtype, device=pos.device)
        w = torch.roll(v, -1, dims=0)                  # the next vertex
        p = pos[..., None, :]                          # (..., 1, 2)
        e = w - v                                      # (M, 2)
        t = torch.sum((p - v) * e, dim=-1) / (torch.sum(e * e, dim=-1) + 1e-30)
        t = torch.minimum(torch.maximum(t, torch.zeros_like(t)),
                          torch.ones_like(t))
        q = p - (v + t[..., None] * e)
        d = torch.amin(torch.sqrt(torch.sum(q * q, dim=-1)), dim=-1)
        # crossing-number parity
        x, y = pos[..., 0:1], pos[..., 1:2]
        cond = (v[:, 1] <= y) != (w[:, 1] <= y)
        ey = torch.where(e[:, 1] == 0, torch.full_like(e[:, 1], 1e-30), e[:, 1])
        xcross = v[:, 0] + (y - v[:, 1]) * e[:, 0] / ey
        inside = torch.sum(cond & (x < xcross), dim=-1) % 2 == 1
        return torch.where(inside, -d, d)

    def bounds(self):
        v = np.asarray(self.vertices, dtype=np.float64)
        return v.min(0), v.max(0)


def make_complex(*parts: Tuple[str, Shape]) -> ComplexShape:
    """ComplexShape from ("add"|"sub", shape) pairs."""
    return ComplexShape(tuple(s for _, s in parts),
                        tuple(+1 if op == "add" else -1 for op, _ in parts))


def make_multi_polygon(*parts) -> ComplexShape:
    """MultiPolygonShape: a CSG chain of polygons from ("add"|"sub",
    vertex list) pairs (the reference's addAPolygon sequence)."""
    return make_complex(*[(op, Polygon(vertices=tuple(map(tuple, v))))
                          for op, v in parts])


def normals_and_distance(shape: Shape, pos: np.ndarray, dtype):
    """(normals, signed distances) of `shape` at host positions, evaluated
    on the CPU in `dtype` (setup-time precompute)."""
    p = torch.as_tensor(np.asarray(pos), dtype=dtype)
    n = shape.find_normal_direction(p)
    with torch.no_grad():
        phi = shape.signed_distance(p)
    return n.detach(), phi
