"""Smoothing kernels (counterpart of sphinxsys_tpu/core/kernels.py).

Wendland C2 — the reference default and the one the dambreak uses —
the anisotropic kernel over it, the Laguerre-Gauss kernel of the
Eulerian Taylor-Green vortex, the cubic B-spline, quadratic and
hyperbolic kernels, and the tabulated form of any of them;
`W_adaptive` / `dW_adaptive` (also as the module functions `_adaptive_W`
/ `_adaptive_dW`, the JAX package's names) evaluate them at per-particle
smoothing lengths.  ``W(r)`` has units 1/len^dim, ``dW(r)`` = dW/dr
(negative), ``d2W(r)`` its derivative (not the Laguerre-Gauss kernel's);
the support radius is 2h (src/shared/kernels/kernel_wendland_c2.cpp).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SmoothingKernel:
    """A radial kernel from its shape w(q) / w'(q) of q = r / h and its
    normalisation; subclasses give `_w`, `_dw` and `_factor_w`."""

    h: float
    kernel_size: float = 2.0  # support = kernel_size * h

    @property
    def cutoff(self) -> float:
        return self.kernel_size * self.h

    def w0(self, dim: int) -> float:
        """W at r = 0 (a Python float)."""
        return self._factor_w(dim) * float(
            self._w(torch.zeros((), dtype=torch.float64)))

    def W(self, r: torch.Tensor, dim: int) -> torch.Tensor:
        """Kernel value; zero outside support."""
        return self._W_at(r / self.h, 1.0, dim)

    def dW(self, r: torch.Tensor, dim: int) -> torch.Tensor:
        """Radial derivative dW/dr; zero outside support."""
        return self._dW_at(r / self.h, 1.0, dim)

    def d2W(self, r: torch.Tensor, dim: int) -> torch.Tensor:
        """Second radial derivative d2W/dr2; zero outside support (the
        level-set second-gradient integral and the implicit relaxation)."""
        q = r / self.h
        val = (self._factor_w(dim) / (self.h * self.h)) * self._d2w(
            torch.clamp(q, max=self.kernel_size))
        return torch.where(q < self.kernel_size, val, torch.zeros_like(val))

    def _d2w(self, q):
        raise NotImplementedError(f"{type(self).__name__} has no d2W")

    # Variable smoothing length (adaptive-h bodies): Kernel::W(h_ratio, r)
    # = factor_W W(q h_ratio) h_ratio^d and dW(h_ratio, ...) h_ratio^(d+1)
    # (base_kernel.cpp:98-140), h_ratio = h_ref / h_particle >= 1 for a
    # refined particle.  The JAX package patches these onto its class at
    # import; here they are methods.  W and dW are the h_ratio = 1 case
    # (the Python float 1.0 scales exactly, so the values are the same bits).

    def W_adaptive(self, r: torch.Tensor, h_ratio, dim: int) -> torch.Tensor:
        return self._W_at(r / self.h * h_ratio, h_ratio, dim)

    def dW_adaptive(self, r: torch.Tensor, h_ratio, dim: int) -> torch.Tensor:
        return self._dW_at(r / self.h * h_ratio, h_ratio, dim)

    def _W_at(self, q: torch.Tensor, h_ratio, dim: int) -> torch.Tensor:
        inside = q < self.kernel_size
        val = self._factor_w(dim) * (h_ratio ** dim) * self._w(
            torch.clamp(q, max=self.kernel_size))
        return torch.where(inside, val, torch.zeros_like(val))

    def _dW_at(self, q: torch.Tensor, h_ratio, dim: int) -> torch.Tensor:
        inside = q < self.kernel_size
        val = (self._factor_w(dim) / self.h) * (h_ratio ** (dim + 1)) * \
            self._dw(torch.clamp(q, max=self.kernel_size))
        return torch.where(inside, val, torch.zeros_like(val))

    def w0_adaptive(self, h_ratio, dim: int) -> torch.Tensor:
        """W(0) at each particle's own h: factor_W h_ratio^d w(0)."""
        return self._factor_w(dim) * (h_ratio ** dim) * self._w(
            torch.zeros((), dtype=h_ratio.dtype, device=h_ratio.device))


@dataclasses.dataclass(frozen=True)
class WendlandC2(SmoothingKernel):
    @staticmethod
    def _w(q):
        return (1.0 - 0.5 * q) ** 4 * (1.0 + 2.0 * q)

    @staticmethod
    def _dw(q):
        return 0.625 * (q - 2.0) ** 3 * q

    @staticmethod
    def _d2w(q):
        return 1.25 * (q - 2.0) ** 2 * (2.0 * q - 1.0)

    def _factor_w(self, dim: int) -> float:
        h = self.h
        if dim == 1:
            return 3.0 / (4.0 * h)
        if dim == 2:
            return 7.0 / (4.0 * math.pi * h * h)
        if dim == 3:
            return 21.0 / (16.0 * math.pi * h * h * h)
        raise ValueError(f"dim must be 1/2/3, got {dim}")


@dataclasses.dataclass(frozen=True)
class CubicBSpline(SmoothingKernel):
    """Cubic B-spline kernel (src/shared/kernels/kernel_cubic_B_spline.cpp)."""

    @staticmethod
    def _w(q):
        return torch.where(q < 1.0, 1.0 - 1.5 * q * q * (1.0 - 0.5 * q),
                           (2.0 - q) ** 3 / 4.0)

    @staticmethod
    def _dw(q):
        return torch.where(q < 1.0, 2.25 * q * q - 3.0 * q,
                           -0.75 * (2.0 - q) ** 2)

    @staticmethod
    def _d2w(q):
        return torch.where(q < 1.0, 4.5 * q - 3.0, 1.5 * (2.0 - q))

    def _factor_w(self, dim: int) -> float:
        h = self.h
        if dim == 1:
            return 2.0 / (3.0 * h)
        if dim == 2:
            return 10.0 / (7.0 * math.pi * h * h)
        if dim == 3:
            return 1.0 / (math.pi * h * h * h)
        raise ValueError(f"dim must be 1/2/3, got {dim}")


@dataclasses.dataclass(frozen=True)
class Quadratic(SmoothingKernel):
    """Quadratic kernel (src/shared/kernels/kernel_quadratic.cpp), with the
    JAX package's analytic derivative dw/dq = 15 (q - 2) / 32 in every
    dimension and the reference's factors, which normalise the kernel in
    3D only."""

    @staticmethod
    def _w(q):
        return 5.0 * (3.0 * q * q - 12.0 * q + 12.0) / 64.0

    @staticmethod
    def _dw(q):
        return 15.0 * (q - 2.0) / 32.0

    @staticmethod
    def _d2w(q):
        return 15.0 / 32.0 * torch.ones_like(q)

    def _factor_w(self, dim: int) -> float:
        h = self.h
        if dim == 1:
            return 1.0 / (7.0 * h)
        if dim == 2:
            return 1.0 / (3.0 * math.pi * h * h)
        if dim == 3:
            return 1.0 / (math.pi * h * h * h)
        raise ValueError(f"dim must be 1/2/3, got {dim}")


@dataclasses.dataclass(frozen=True)
class Hyperbolic(SmoothingKernel):
    """Hyperbolic-shaped kernel (kernel_hyperbolic.cpp): 6 - 6q + q^3 for
    q < 1 and (2 - q)^3 for 1 <= q < 2."""

    @staticmethod
    def _w(q):
        return torch.where(q < 1.0, 6.0 - 6.0 * q + q ** 3, (2.0 - q) ** 3)

    @staticmethod
    def _dw(q):
        return torch.where(q < 1.0, -6.0 + 3.0 * q * q, -3.0 * (2.0 - q) ** 2)

    @staticmethod
    def _d2w(q):
        return torch.where(q < 1.0, 6.0 * q, 6.0 * (2.0 - q))

    def _factor_w(self, dim: int) -> float:
        inv_h = 1.0 / self.h
        if dim == 1:
            return inv_h / 7.0
        if dim == 2:
            return inv_h ** 2 / (3.0 * math.pi)
        if dim == 3:
            return inv_h ** 3 * 15.0 / (62.0 * math.pi)
        raise ValueError(f"dim must be 1/2/3, got {dim}")


@dataclasses.dataclass(frozen=True)
class TabulatedKernel:
    """KernelTabulated<KernelType> (kernel_tabulated.h): W, dW and d2W read
    from a table of the base kernel by four-point Lagrange interpolation
    (kernel_tabulated.h:49-62).  The table spans q = -dq .. (R + 2) dq,
    dq = kernel_size / R; the pad point at q = -dq evaluates the base's
    shape polynomial at negative q, as the reference's table does.  It is
    formed in float64 and cast to the query's dtype."""

    base: SmoothingKernel
    resolution: int = 20

    @property
    def h(self) -> float:
        return self.base.h

    @property
    def kernel_size(self) -> float:
        return self.base.kernel_size

    @property
    def cutoff(self) -> float:
        return self.base.cutoff

    def w0(self, dim: int) -> float:
        return self.base.w0(dim)

    def _dq(self) -> float:
        return self.base.kernel_size / self.resolution

    def _table(self, fn, dim: int, like: torch.Tensor) -> torch.Tensor:
        qs = torch.arange(-1.0, self.resolution + 3.0, dtype=torch.float64) \
            * self._dq() * self.h
        return fn(qs, dim).to(dtype=like.dtype, device=like.device)

    def _interp(self, table: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        dq = self._dq()
        loc = torch.clamp(torch.floor(q / dq).long(), 0, self.resolution - 1)
        f1 = q - loc.to(q.dtype) * dq
        f0, f2, f3 = f1 + dq, f1 - dq, f1 - 2 * dq
        d0 = (-dq) * (-2 * dq) * (-3 * dq)
        d1 = dq * (-dq) * (-2 * dq)
        d2 = (2 * dq) * dq * (-dq)
        d3 = (3 * dq) * (2 * dq) * dq
        i = loc + 1
        return (f1 * f2 * f3 / d0 * table[i - 1] + f0 * f2 * f3 / d1 * table[i]
                + f0 * f1 * f3 / d2 * table[i + 1]
                + f0 * f1 * f2 / d3 * table[i + 2])

    def _read(self, fn, r: torch.Tensor, dim: int) -> torch.Tensor:
        val = self._interp(self._table(fn, dim, r), r / self.h)
        return torch.where(r < self.cutoff, val, torch.zeros_like(val))

    def W(self, r: torch.Tensor, dim: int) -> torch.Tensor:
        return self._read(self.base.W, r, dim)

    def dW(self, r: torch.Tensor, dim: int) -> torch.Tensor:
        return self._read(self.base.dW, r, dim)

    def d2W(self, r: torch.Tensor, dim: int) -> torch.Tensor:
        return self._read(self.base.d2W, r, dim)


@dataclasses.dataclass(frozen=True)
class LaguerreGauss(SmoothingKernel):
    """Laguerre-Gauss kernel (kernel_laguerre_gauss.cpp): a truncated
    Gaussian times a Laguerre polynomial, the same shape in every
    dimension, cut at 2h as the JAX package cuts it."""

    @staticmethod
    def _w(q):
        return (1.0 - q * q + q ** 4 / 6.0) * torch.exp(-q * q)

    @staticmethod
    def _dw(q):
        return (-(q ** 5) / 3.0 + 8.0 * q ** 3 / 3.0 - 4.0 * q) \
            * torch.exp(-q * q)

    def _factor_w(self, dim: int) -> float:
        inv_h = 1.0 / self.h
        if dim == 1:
            return inv_h * 8.0 / (5.0 * math.sqrt(math.pi))
        if dim == 2:
            return inv_h ** 2 * 3.0 / math.pi
        if dim == 3:
            return inv_h ** 3 * 8.0 / math.pi ** 1.5
        raise ValueError(f"dim must be 1/2/3, got {dim}")


@dataclasses.dataclass(frozen=True)
class AnisotropicKernel:
    """AnisotropicKernel<KernelType> (anisotropic_kernel.{h,hpp}): a
    displacement d is mapped to an isotropic space by G = diag(1 / (h k_i))
    (the per-axis stretch k_i), q = |G d|, and the value is scaled by
    det(G), so the kernel integrates to one over the stretched support.

    The API takes the displacement vector (x_i - x_j), not a radius: an
    anisotropic support has none.  grad_W is the whole gradient
    factor w'(q) G^T G d / q, which is dW(r) e_ij at k = (1, ..., 1).
    (physics/pair.py's `pair_geometry` stays radial: the cases that use
    this kernel freeze its pairs themselves.)"""

    base: SmoothingKernel
    kernel_vector: tuple

    @property
    def h(self) -> float:
        return self.base.h

    @property
    def kernel_size(self) -> float:
        return self.base.kernel_size

    def _G_diag(self, like: torch.Tensor) -> torch.Tensor:
        kv = torch.as_tensor(self.kernel_vector, dtype=like.dtype,
                             device=like.device)
        return 1.0 / (self.base.h * kv)

    def _det_G(self) -> float:
        out = 1.0
        for k in self.kernel_vector:
            out *= 1.0 / (self.base.h * k)
        return out

    def _factor(self, dim: int) -> float:
        """The reference's getFactors(): the isotropic factor (which
        carries 1/h^dim) times h^dim det(G)."""
        return self.base._factor_w(dim) * self.base.h ** dim * self._det_G()

    def transformed_q(self, displacement: torch.Tensor) -> torch.Tensor:
        gd = self._G_diag(displacement) * displacement
        return torch.sqrt(torch.sum(gd * gd, dim=-1))

    def within_cutoff(self, displacement: torch.Tensor) -> torch.Tensor:
        return self.transformed_q(displacement) < self.kernel_size

    def W_disp(self, displacement: torch.Tensor, dim: int) -> torch.Tensor:
        q = self.transformed_q(displacement)
        val = self._factor(dim) * self.base._w(
            torch.clamp(q, max=self.kernel_size))
        return torch.where(q < self.kernel_size, val, torch.zeros_like(val))

    def grad_W(self, displacement: torch.Tensor, dim: int) -> torch.Tensor:
        g = self._G_diag(displacement)
        gd = g * displacement
        q = torch.sqrt(torch.sum(gd * gd, dim=-1))
        dwdq = self._factor(dim) * self.base._dw(
            torch.clamp(q, max=self.kernel_size))
        coeff = torch.where(q < self.kernel_size,
                            dwdq / torch.clamp(q, min=1e-15),
                            torch.zeros_like(dwdq))
        return coeff[..., None] * (g * gd)


def lattice_number_density(kernel: SmoothingKernel, spacing: float, dim: int) -> float:
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


def _adaptive_W(kernel: SmoothingKernel, r, h_ratio, dim: int):
    """W at per-particle smoothing lengths (the JAX package's helper name
    for `SmoothingKernel.W_adaptive`)."""
    return kernel.W_adaptive(r, h_ratio, dim)


def _adaptive_dW(kernel: SmoothingKernel, r, h_ratio, dim: int):
    """dW/dr at per-particle smoothing lengths (`SmoothingKernel.dW_adaptive`)."""
    return kernel.dW_adaptive(r, h_ratio, dim)
