"""Narrow-band packaged level set (counterpart of
sphinxsys_tpu/meshes/levelset.py; reference LevelSet on
SparseMeshField<4>, level_set.{h,hpp}, level_set_correction,
level_set_transformation, and LevelSetShape, level_set_shape.{h,cpp}).

The field is stored as the JAX package stores it: the packages of a
coarse grid that lie near the interface are the rows of ONE dense
(P,) + (4,)*d array, followed by two constant far-field rows (P: +far,
P+1: -far); `coarse_map` sends every coarse cell to its row or to a
sentinel, `pkg_nbr` (P,) + (3,)*d holds each package's 3^d neighbours.
The integer tables are built on the host in numpy and equal the JAX
package's.  The SDF is evaluated in float64 on CPU tensors.

The mesh dynamics (gradient, reinitialisation sweeps, kernel integrals)
run on a (P,) + (12,)*d halo view, as the JAX package's do.  A probe does
not build the halo: each of its 2^d corners is gathered straight from the
packaged array through `pkg_nbr` (extended by the two far rows, which
stand for themselves), with the JAX package's clamp, weights and corner
order, so each corner reads the value the halo would hold.

Conventions (the reference's): phi < 0 inside the shape; the kernel
integrals integrate W (and its gradients) over the positive-phi region
with the cut-cell fraction sum_i g_i^2/|g|^2 H(phi/|g_i|, dx/2)
(level_set_transformation.hpp:65); reinitialisation is the Godunov
upwind phi -= sign (|grad phi| - 1) dx / d (level_set_correction.hpp:43).
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Any

import numpy as np
import torch

from sphinxsys_tpu_torch.device import PRODUCTION_DTYPE, resolve_device

PKG = 4          # cells per package side (SparseMeshField<4>)
FAR = 1.0e3      # far-field sentinel magnitude, in spacings
TINY = 1.0e-15


def _center_slices(dim, off):
    """Halo slices selecting the centre package shifted by `off`."""
    return tuple(slice(PKG + o, 2 * PKG + o) for o in off)


@dataclasses.dataclass(frozen=True)
class LevelSet:
    """Packaged level-set field: phi (P+2,) + (PKG,)*dim, the last two rows
    the far-field packages; pkg_nbr (P,) + (3,)*dim the package rows of
    each package's coarse neighbourhood (pointing into phi's rows)."""

    spacing: float
    lower: Any               # (dim,) fine-grid origin, phi's dtype
    n_pkg: tuple             # coarse grid dims
    coarse_map: Any          # (prod n_pkg,) int64: package row or sentinel
    pkg_coord: Any           # (P, dim) int64 coarse coordinates
    pkg_nbr: Any             # (P,) + (3,)*dim int64
    phi: Any                 # (P+2,) + (PKG,)*dim
    kernel_w: Any | None = None
    kernel_gw: Any | None = None
    kernel_g2w: Any | None = None

    @property
    def dim(self) -> int:
        return len(self.n_pkg)

    @property
    def n_inner(self) -> int:
        return self.phi.shape[0] - 2

    # ------------------------------------------------------------------
    def halo(self, field=None):
        """(P+2,) + (3*PKG,)*dim [+ extra] view: each inner package tiled
        with its 3^dim neighbourhood, the two far rows tiled constants."""
        dim = self.dim
        f = self.phi if field is None else field
        g = f[self.pkg_nbr]             # (P,) + (3,)*d + (PKG,)*d + extra
        perm = [0]
        for k in range(dim):
            perm += [1 + k, 1 + dim + k]
        perm += list(range(1 + 2 * dim, g.dim()))
        g = g.permute(perm)
        extra = tuple(f.shape[1 + dim:])
        inner = g.reshape((g.shape[0],) + (3 * PKG,) * dim + extra)
        reps = (3,) * dim + (1,) * len(extra)
        far = torch.stack([f[-2].repeat(reps), f[-1].repeat(reps)])
        return torch.cat([inner, far], dim=0)

    @functools.cached_property
    def _nbr_ext(self):
        """pkg_nbr with the two far rows appended, each its own neighbour
        in every direction: (P+2,) + (3,)*dim."""
        P = self.n_inner
        far = torch.arange(P, P + 2, dtype=self.pkg_nbr.dtype,
                           device=self.pkg_nbr.device)
        far = far.view((2,) + (1,) * self.dim).expand(
            (2,) + (3,) * self.dim)
        return torch.cat([self.pkg_nbr, far], dim=0)

    # -- probes ---------------------------------------------------------
    def _locate(self, pts):
        """Query points -> (package row, in-package cell float coords)."""
        dim = self.dim
        rel = (pts - self.lower) / self.spacing
        cell = torch.floor(rel).to(torch.int64)
        n_pkg = torch.as_tensor(self.n_pkg, dtype=torch.int64,
                                device=pts.device)
        pkg = torch.minimum(torch.clamp(
            torch.div(cell, PKG, rounding_mode="floor"), min=0), n_pkg - 1)
        flat = pkg[..., 0]
        for k in range(1, dim):
            flat = flat * self.n_pkg[k] + pkg[..., k]
        row = self.coarse_map[flat]
        local = rel - pkg * PKG
        return row, local

    def _multilinear(self, field, pts):
        """dim-linear interpolation of a packaged field: the halo
        coordinates x0 (clamped to 0 … 3 PKG - 2) of the JAX package's
        probe, each corner read from its package through `_nbr_ext`."""
        dim = self.dim
        row, local = self._locate(pts)
        extra = field.dim() - 1 - dim
        x = [local[..., k] + PKG - 0.5 for k in range(dim)]
        x0 = [torch.clamp(torch.floor(c).to(torch.int64), 0, 3 * PKG - 2)
              for c in x]
        fr = [torch.clamp(c - c0, 0.0, 1.0) for c, c0 in zip(x, x0)]
        if extra:
            fr = [f[..., None] for f in fr]
        nbr = self._nbr_ext
        out = 0.0
        for corner in itertools.product((0, 1), repeat=dim):
            idx = [c0 + o for c0, o in zip(x0, corner)]
            pkg = nbr[(row,) + tuple(torch.div(i, PKG, rounding_mode="floor")
                                     for i in idx)]
            v = field[(pkg,) + tuple(i % PKG for i in idx)]
            w = 1.0
            for f, o in zip(fr, corner):
                w = w * (f if o else (1.0 - f))
            out = out + w * v
        return out

    def probe_signed_distance(self, pts):
        """probeSignedDistance (level_set.h:64)."""
        return self._multilinear(self.phi, pts)

    def probe_normal_direction(self, pts):
        """probeNormalDirection: the normalised interpolated gradient."""
        gv = self._multilinear(self.gradient(), pts)
        return gv / (torch.sqrt(torch.sum(gv * gv, dim=-1, keepdim=True))
                     + TINY)

    def probe_kernel_integral(self, pts):
        return self._multilinear(self.kernel_w, pts)

    def probe_kernel_gradient_integral(self, pts):
        return self._multilinear(self.kernel_gw, pts)

    def probe_kernel_second_gradient_integral(self, pts):
        """(…, dim, dim) integral of d2W(r) e e^T over the positive-phi
        region (level_set_transformation.hpp:128-138)."""
        dim = self.dim
        g2 = self.kernel_g2w.reshape(tuple(self.kernel_g2w.shape[:1 + dim])
                                     + (dim * dim,))
        out = self._multilinear(g2, pts)
        return out.reshape(tuple(out.shape[:-1]) + (dim, dim))

    # -- mesh dynamics --------------------------------------------------
    def _shift(self, h, axis, off):
        """Centre package of the halo shifted by `off` cells along `axis`."""
        sl = [slice(None)]
        for k in range(self.dim):
            o = off if k == axis else 0
            sl.append(slice(PKG + o, 2 * PKG + o))
        return h[tuple(sl)]

    def gradient(self):
        """Central-difference phi gradient per cell, (P+2,) + (PKG,)*d +
        (d,), the far rows zero.  Computed once for a field and kept."""
        return self._gradient

    @functools.cached_property
    def _gradient(self):
        h = self.halo()[:self.n_inner]
        comps = [(self._shift(h, k, 1) - self._shift(h, k, -1))
                 / (2.0 * self.spacing) for k in range(self.dim)]
        g = torch.stack(comps, dim=-1)
        pad = torch.zeros((2,) + tuple(g.shape[1:]), dtype=g.dtype,
                          device=g.device)
        return torch.cat([g, pad], dim=0)

    def reinitialize(self, iterations: int = 30) -> "LevelSet":
        """ReinitializeLevelSet (level_set_correction.hpp:20-68): Godunov
        upwind sweeps toward |grad phi| = 1, the interface anchored by the
        smoothed sign.  A loop of torch ops with no host read."""
        dx = self.spacing
        dim = self.dim

        def upwind(sign, dp, dm):
            # upwindDifference (level_set_correction.hpp:20-38)
            both_p = (sign * dp >= 0.0) & (sign * dm >= 0.0)
            both_m = (sign * dp <= 0.0) & (sign * dm <= 0.0)
            mixed_out = (sign * dp > 0.0) & (sign * dm < 0.0)
            den = torch.where(torch.abs(dp - dm) > TINY, dp - dm,
                              torch.full_like(dp, TINY))
            ss = sign * (torch.abs(dp) - torch.abs(dm)) / den
            inward = torch.where(ss > 0.0, dm, dp)
            return torch.where(both_p, dm, torch.where(
                both_m, dp, torch.where(mixed_out, torch.zeros_like(dp),
                                        inward)))

        phi = self.phi
        for _ in range(iterations):
            h = dataclasses.replace(self, phi=phi).halo()[:self.n_inner]
            p0 = self._shift(h, 0, 0)
            sign = p0 / torch.sqrt(p0 * p0 + dx * dx)
            norm2 = TINY
            for k in range(dim):
                dp = (self._shift(h, k, 1) - p0) / dx
                dm = (p0 - self._shift(h, k, -1)) / dx
                gk = upwind(sign, dp, dm)
                norm2 = norm2 + gk * gk
            norm = torch.sqrt(norm2)
            upd = p0 - sign * (norm * dx - dx) / float(dim)
            phi = torch.cat([upd, phi[-2:]], dim=0)
        return dataclasses.replace(self, phi=phi)

    def update_kernel_integrals(self, kernel, dim: int | None = None
                                ) -> "LevelSet":
        """UpdateKernelIntegrals (level_set_transformation.hpp:50-130): per
        cell, the integrals of W, grad W and d2W e e^T over the positive-phi
        region within the kernel cutoff, with cut-cell volume fractions.
        The stencil weights are Python floats formed in float64."""
        dim = dim or self.dim
        dx = self.spacing
        cutoff = float(kernel.cutoff) / dx       # support radius in cells
        m = int(np.ceil(cutoff))
        assert m <= PKG, "kernel support exceeds one package halo"
        h = self.halo()[:self.n_inner]
        grad = self.halo(self.gradient())[:self.n_inner]
        dtype = self.phi.dtype
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype

        def kf(fn, r):
            return float(fn(torch.tensor(r, dtype=torch.float64), dim))

        phi_c = h[(slice(None),) + _center_slices(dim, (0,) * dim)]
        wsum = torch.zeros_like(phi_c)
        gsum = phi_c.new_zeros(tuple(phi_c.shape) + (dim,))
        g2sum = phi_c.new_zeros(tuple(phi_c.shape) + (dim, dim))
        offs = [o for o in itertools.product(range(-m, m + 1), repeat=dim)
                if sum(c * c for c in o) <= (cutoff + 1e-9) ** 2]
        for off in offs:
            sl = (slice(None),) + _center_slices(dim, off)
            pn = h[sl]
            gn = grad[sl]
            g2 = torch.sum(gn * gn, dim=-1) + TINY
            frac = torch.zeros_like(pn)
            for ax in range(dim):
                hv = torch.clamp(0.5 + 0.5 * (pn / (torch.abs(gn[..., ax])
                                                    + TINY)) / (0.5 * dx),
                                 0.0, 1.0)
                frac = frac + gn[..., ax] ** 2 / g2 * hv
            frac = torch.where(pn > -dx, frac, torch.zeros_like(frac))
            r = float(np.linalg.norm(off)) * dx
            wsum = wsum + kf(kernel.W, r) * frac
            if r > TINY:
                e = (np.asarray([-c * dx for c in off]) / r).astype(np_dtype)
                e_t = torch.as_tensor(e, dtype=dtype, device=pn.device)
                gsum = gsum + (kf(kernel.dW, r) * frac)[..., None] * e_t
                ee = torch.as_tensor(np.outer(e, e), dtype=dtype,
                                     device=pn.device)
                g2sum = g2sum + (kf(kernel.d2W, r) * frac)[..., None, None] \
                    * ee
        scale = dx ** dim
        deep = phi_c > cutoff * dx
        kw = torch.where(deep, torch.ones_like(wsum), wsum * scale)
        kg = torch.where(deep[..., None], torch.zeros_like(gsum),
                         gsum * scale)
        kg2 = torch.where(deep[..., None, None], torch.zeros_like(g2sum),
                          g2sum * scale)

        def with_far(a, positive):
            pad = a.new_zeros((2,) + tuple(a.shape[1:]))
            if positive:        # the far-positive package: full support
                pad[0] = 1.0
            return torch.cat([a, pad], dim=0)

        return dataclasses.replace(self, kernel_w=with_far(kw, True),
                                   kernel_gw=with_far(kg, False),
                                   kernel_g2w=with_far(kg2, False))

    def clean_interface(self, repeat: int = 2) -> "LevelSet":
        """cleanInterface (level_set.h:62): re-distance around the
        interface by 10 * repeat reinitialisation sweeps, as the JAX
        package does."""
        return self.reinitialize(iterations=10 * repeat)


def build_levelset(shape, lower, upper, spacing: float,
                   band_width: float | None = None,
                   dtype=PRODUCTION_DTYPE, device="cuda") -> LevelSet:
    """The packaged field of a Shape (LevelSetShape ctor +
    FinishDataPackages): packages whose centre lies within `band_width`
    (default 6 spacings + a package) of the interface hold data, every
    other coarse cell maps to the +/- far sentinel.  The dimension is
    len(lower).  The SDF is evaluated in float64 on the CPU, the field
    then cast to `dtype` on `device`."""
    dev = resolve_device(device)
    lo = np.asarray(lower, np.float64)
    hi = np.asarray(upper, np.float64)
    dim = len(lo)
    n_cells = np.ceil((hi - lo) / spacing).astype(int)
    n_pkg = -(-n_cells // PKG)          # ceil division
    band = band_width or (6.0 + PKG) * spacing

    def sdf(pts):
        with torch.no_grad():
            return shape.signed_distance(
                torch.as_tensor(pts, dtype=torch.float64)).numpy()

    grids = np.meshgrid(*[np.arange(n) for n in n_pkg], indexing="ij")
    coords = np.stack(grids, -1).reshape(-1, dim)
    sd_c = sdf(lo + (coords + 0.5) * (PKG * spacing))
    pkg_rows = np.nonzero(np.abs(sd_c) < band)[0]
    P = len(pkg_rows)

    coarse_map = np.where(sd_c >= 0, P, P + 1).astype(np.int64)  # far +/-
    coarse_map[pkg_rows] = np.arange(P)
    pkg_coord = coords[pkg_rows]
    strides = np.array([int(np.prod(n_pkg[k + 1:])) for k in range(dim)])

    # neighbour package table (clamped at the domain edge)
    nbr = np.empty((P,) + (3,) * dim, np.int64)
    for off in itertools.product((-1, 0, 1), repeat=dim):
        c = [np.clip(pkg_coord[:, k] + off[k], 0, n_pkg[k] - 1)
             for k in range(dim)]
        flat = sum(c[k] * strides[k] for k in range(dim))
        nbr[(slice(None),) + tuple(o + 1 for o in off)] = coarse_map[flat]

    cell = np.meshgrid(*[np.arange(PKG)] * dim, indexing="ij")
    pts = np.stack([
        lo[k] + (pkg_coord[:, k][(slice(None),) + (None,) * dim] * PKG
                 + cell[k][None] + 0.5) * spacing
        for k in range(dim)], axis=-1).reshape(-1, dim)
    phi = np.empty((P + 2,) + (PKG,) * dim)
    phi[:P] = sdf(pts).reshape((P,) + (PKG,) * dim)
    phi[P] = FAR * spacing
    phi[P + 1] = -FAR * spacing

    def t(a, dt=torch.int64):
        return torch.as_tensor(a, dtype=dt, device=dev)

    return LevelSet(spacing=float(spacing), lower=t(lo, dtype),
                    n_pkg=tuple(int(x) for x in n_pkg),
                    coarse_map=t(coarse_map), pkg_coord=t(pkg_coord),
                    pkg_nbr=t(nbr), phi=t(phi, dtype))


@dataclasses.dataclass(frozen=True)
class LevelSetShape:
    """LevelSetShape (geometries/level_set_shape.h): a shape answered by
    the packaged level set's probes (contains, signed distance, normals,
    kernel integrals), which physics/relax.py's `surface_bounding` and
    the fluid's `levelsets=` terms consume."""

    levelset: LevelSet
    name: str = "LevelSetShape"

    def signed_distance(self, pos):
        return self.levelset.probe_signed_distance(pos)

    def contains(self, pos):
        return self.signed_distance(pos) < 0.0

    def find_normal_direction(self, pos):
        return self.levelset.probe_normal_direction(pos)

    def compute_kernel_integral(self, pos):
        return self.levelset.probe_kernel_integral(pos)

    def compute_kernel_gradient_integral(self, pos):
        return self.levelset.probe_kernel_gradient_integral(pos)

    def bounds(self):
        ls = self.levelset
        lo = ls.lower.double().cpu().numpy()
        return lo, lo + np.asarray(ls.n_pkg) * PKG * ls.spacing
