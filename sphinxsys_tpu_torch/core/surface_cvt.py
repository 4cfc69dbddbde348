"""Shell particles on a parametric surface, relaxed by a tangential CVT
(counterpart of sphinxsys_tpu/core/surface_cvt.py; the reference reads
offline CVT-relaxed vertex files, test_3d_shell_stability_half_sphere's
input/shell_sphere_half_*.txt):

  1. quasi-uniform seeds: the Fibonacci spiral on a (hemi)sphere;
  2. the tangential Lloyd / CVT relaxation: a Wendland C2 kernel-gradient
     pair repulsion over every pair (dense N x N), each sweep's step
     projected on the local tangent plane and limited to step_factor dp,
     the point projected back onto the surface;
  3. the boundary by the projector's clamp (the hemisphere's equator).

The output feeds shell.make_shell_state: positions, outward normals, and
per-particle area total_area / n
(test_3d_shell_stability_half_sphere.cpp:132).  The dtype and the device
are arguments, not global flags.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from sphinxsys_tpu_torch.device import resolve_device, resolve_dtype


def fibonacci_sphere(n: int, radius: float = 1.0,
                     hemisphere: bool = False) -> np.ndarray:
    """Fibonacci-spiral points on the (hemi)sphere, (n, 3) float64."""
    ga = math.pi * (3.0 - math.sqrt(5.0))
    i = np.arange(n, dtype=np.float64)
    if hemisphere:
        z = (i + 0.5) / n                # z in (0, 1): the upper half
    else:
        z = 1.0 - 2.0 * (i + 0.5) / n    # z in (-1, 1)
    r_xy = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    th = ga * i
    return radius * np.stack([r_xy * np.cos(th), r_xy * np.sin(th), z], -1)


def sphere_projector(radius: float, hemisphere: bool = False,
                     min_z: float = 0.0):
    """(pos) -> (projected pos, outward normal) for a (hemi)sphere centred
    at the origin; on a hemisphere, points below `min_z` clamp to it."""

    def project(p):
        if hemisphere:
            p = torch.cat([p[:, :2], torch.clamp(p[:, 2:], min=min_z)], dim=1)
        r = torch.linalg.vector_norm(p, dim=-1, keepdim=True)
        n = p / torch.clamp(r, min=1e-30)
        return radius * n, n

    return project


def cylinder_projector(r_mid: float, axis: int = 1):
    """(pos) -> (projected pos, outward normal) for a cylindrical
    mid-surface of radius r_mid about `axis`."""

    def project(p):
        mask = torch.ones(3, dtype=p.dtype, device=p.device)
        mask[axis] = 0.0
        radial = p * mask
        rn = torch.linalg.vector_norm(radial, dim=-1, keepdim=True)
        n = radial / torch.clamp(rn, min=1e-30)
        return p * (1.0 - mask) + r_mid * n, n

    return project


def cvt_relax_on_surface(pos0, project: Callable, dp: float,
                         n_iter: int = 200, step_factor: float = 0.2,
                         kernel_h_ratio: float = 1.3,
                         dtype=torch.float64, device="cuda"):
    """The tangential CVT relaxation of the seeds pos0 (N, 3) on the
    surface of `project` (point -> (surface point, outward unit normal)),
    target spacing dp, in `dtype` on `device`.  Each sweep moves a point
    by step_factor dp f / |f| min(|f|, 1), f the tangential part of the
    kernel-gradient repulsion sum_j (q - 2)^3 q / r (x_i - x_j),
    q = min(r / h, 2), h = kernel_h_ratio dp.  Returns (pos, normal) as
    numpy arrays."""
    dtype = resolve_dtype(dtype)
    device = resolve_device(device)
    h = kernel_h_ratio * dp
    p = torch.as_tensor(np.asarray(pos0), dtype=dtype, device=device)
    off_diag = 1.0 - torch.eye(p.shape[0], dtype=dtype, device=device)

    def pair_force(p):
        d = p[:, None, :] - p[None, :, :]                 # (N, N, 3)
        r = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-30)
        q = torch.clamp(r / h, max=2.0)
        w = -((q - 2.0) ** 3) * q / r * off_diag
        return torch.sum(w[..., None] * d, dim=1)

    for _ in range(n_iter):
        f = pair_force(p)
        _, n = project(p)
        f = f - torch.sum(f * n, dim=-1, keepdim=True) * n   # tangential
        norm = torch.linalg.vector_norm(f, dim=-1, keepdim=True)
        step = (step_factor * dp) * f / torch.clamp(norm, min=1e-30) \
            * torch.clamp(norm, max=1.0)
        p, _ = project(p + step)
    p, n = project(p)
    return p.cpu().numpy(), n.cpu().numpy()


def min_pair_distance(pos) -> float:
    p = np.asarray(pos)
    d = np.linalg.norm(p[:, None, :] - p[None, :, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    return float(d.min())
