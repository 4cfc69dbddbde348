"""Geometry: shapes as signed-distance functions with CSG composition
(counterpart of sphinxsys_tpu/core/geometry.py; what the dambreak and
fsi2 scenes need: `Transform`, `Box`, `Ball`, `ComplexShape`,
`make_complex`).

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


def make_complex(*parts: Tuple[str, Shape]) -> ComplexShape:
    """ComplexShape from ("add"|"sub", shape) pairs."""
    return ComplexShape(tuple(s for _, s in parts),
                        tuple(+1 if op == "add" else -1 for op, _ in parts))


def normals_and_distance(shape: Shape, pos: np.ndarray, dtype):
    """(normals, signed distances) of `shape` at host positions, evaluated
    on the CPU in `dtype` (setup-time precompute)."""
    p = torch.as_tensor(np.asarray(pos), dtype=dtype)
    n = shape.find_normal_direction(p)
    with torch.no_grad():
        phi = shape.signed_distance(p)
    return n.detach(), phi
