"""Smoothing kernels (counterpart of sphinxsys_tpu/core/kernels.py).

Only Wendland C2 — the reference default and the one the dambreak uses.
``W(r)`` has units 1/len^dim, ``dW(r)`` = dW/dr (negative); the support
radius is 2h (src/shared/kernels/kernel_wendland_c2.cpp).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class WendlandC2:
    h: float
    kernel_size: float = 2.0  # support = kernel_size * h

    @property
    def cutoff(self) -> float:
        return self.kernel_size * self.h

    @staticmethod
    def _w(q):
        return (1.0 - 0.5 * q) ** 4 * (1.0 + 2.0 * q)

    @staticmethod
    def _dw(q):
        return 0.625 * (q - 2.0) ** 3 * q

    def _factor_w(self, dim: int) -> float:
        h = self.h
        if dim == 1:
            return 3.0 / (4.0 * h)
        if dim == 2:
            return 7.0 / (4.0 * math.pi * h * h)
        if dim == 3:
            return 21.0 / (16.0 * math.pi * h * h * h)
        raise ValueError(f"dim must be 1/2/3, got {dim}")

    def w0(self, dim: int) -> float:
        """W at r = 0 (a Python float)."""
        return self._factor_w(dim) * float(self._w(0.0))

    def W(self, r: torch.Tensor, dim: int) -> torch.Tensor:
        """Kernel value; zero outside support."""
        q = r / self.h
        inside = q < self.kernel_size
        val = self._factor_w(dim) * self._w(torch.clamp(q, max=self.kernel_size))
        return torch.where(inside, val, torch.zeros_like(val))

    def dW(self, r: torch.Tensor, dim: int) -> torch.Tensor:
        """Radial derivative dW/dr; zero outside support."""
        q = r / self.h
        inside = q < self.kernel_size
        factor = self._factor_w(dim) / self.h
        val = factor * self._dw(torch.clamp(q, max=self.kernel_size))
        return torch.where(inside, val, torch.zeros_like(val))


def lattice_number_density(kernel: WendlandC2, spacing: float, dim: int) -> float:
    """Reference number density sigma0 = sum of W over a regular lattice
    within the cutoff (src/shared/adaptations/adaptation.cpp:26-60),
    evaluated in float64 on the host."""
    cutoff = kernel.cutoff
    depth = int(cutoff / spacing) + 1
    rng = np.arange(-depth, depth + 1)
    grids = np.meshgrid(*([rng] * dim), indexing="ij")
    pts = np.stack([g.ravel() for g in grids], axis=-1) * spacing
    dist = np.linalg.norm(pts, axis=-1)
    inside = dist < cutoff
    w = kernel.W(torch.as_tensor(dist[inside], dtype=torch.float64), dim)
    return float(w.sum())
