"""Lattice-stencil total-Lagrangian solid dynamics (counterpart of
sphinxsys_tpu/physics/solid_lattice.py).

A total-Lagrangian solid freezes its pair topology on the initial
configuration.  When that configuration is a regular dx lattice (possibly
shape-masked by `LatticeValid`), the frozen pair data (e0, dW0, r0, W0) is
the same for every site at a given offset o, so the pair sweep is an
~80-tap stencil: the j side of a pair is the site at i + o.

Per-site fields are stored flat (N, ...) in C order of the lattice shape
(nx, ny, nz), so the state dict of physics/solid.py works unchanged.  The
per-site prelude and epilogue of each half step are torch ops; the two tap
sums are ops/lattice_sweeps.py's L1 and L2 (CUDA kernels on the card,
JAX's tap loop in torch ops on the CPU, or anywhere with
`use_kernels=False`).

The per-site prelude (`decomposed_stress`) and the 3x3 algebra are
physics/solid.py's, shared with the gather engine: closed-form cofactor
determinants and inverses (torch.linalg.inv on the card checks for
singular input and waits for the host, and the step allows one host
sync) and products as a broadcast product and a sum (as a batched
matmul, cuBLAS splits a million-site batch into ~18 launches of ~0.12 ms
each: one H100, the plain path's profile).

Ported: the decomposed first half and the second half, which the
twisting column runs.  `integration_1st_half_pk2_lattice` waits (no caller
on that path).  3D only, as the kernels are.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sphinxsys_tpu_torch.ops import lattice_sweeps as ls
from sphinxsys_tpu_torch.physics.solid import (
    CORRECTION_FACTOR, TINY, cofactors, decomposed_stress, det, mm,
)


def lattice_offsets(kernel, dx: float, dim: int):
    """All nonzero integer offsets o with |o| dx < cutoff (the frozen
    neighbour set of an interior lattice site), with their constant pair
    data: a list of (offset, r0, e0, W0, dW0), e0 = o dx / r0 (a tuple),
    W0 and dW0 evaluated in float64."""
    cutoff = kernel.cutoff
    m = int(np.floor(cutoff / dx - 1e-9))
    rng = range(-m, m + 1)
    out = []
    for ox in rng:
        for oy in rng:
            for oz in (rng if dim == 3 else (0,)):
                if ox == 0 and oy == 0 and oz == 0:
                    continue
                r = dx * float(np.sqrt(ox * ox + oy * oy + oz * oz))
                if r >= cutoff - 1e-12 * dx:
                    continue
                o = (ox, oy, oz)[:dim]
                e = tuple(float(c) for c in np.asarray(o, np.float64) * dx / r)
                rt = torch.tensor(r, dtype=torch.float64)
                out.append((o, r, e, float(kernel.W(rt, dim)),
                            float(kernel.dW(rt, dim))))
    return out


@dataclasses.dataclass(frozen=True)
class LatticeSolid:
    """Static description of a lattice-embedded TL solid body: the lattice
    extent, spacing, dimension, tap table and kernel W(0)."""

    shape: tuple          # (nx, ny, nz)
    dx: float
    dim: int
    taps: tuple           # ((offset, r0, e0, W0, dW0), ...)
    w0: float

    @property
    def n(self) -> int:
        return int(np.prod(self.shape))


def make_lattice(kernel, dx: float, shape, dim: int | None = None) -> LatticeSolid:
    dim = dim or len(shape)
    if dim != 3 or len(shape) != 3:
        raise ValueError(f"lattice {tuple(shape)}, dim {dim}: the port's "
                         "lattice solid is 3D")
    taps = tuple(lattice_offsets(kernel, dx, dim))
    return LatticeSolid(shape=tuple(int(s) for s in shape), dx=dx, dim=dim,
                        taps=taps, w0=kernel.w0(dim))


def decomposed_integration_1st_half_lattice(
        solid: dict, lat: LatticeSolid, material, dt, smoothing_length: float,
        correction_factor: float = CORRECTION_FACTOR,
        use_kernels: bool = True) -> dict:
    """Stencil twin of the decomposed first half (reference
    DecomposedIntegration1stHalf, elastic_dynamics.cpp:162-184): the
    prelude (`decomposed_stress`), the L1 force and the velocity update."""
    out = dict(solid)
    rho0 = material.rho0
    pos_f, F_f, J, Jm2d_f, S_f = decomposed_stress(
        solid, material, dt, smoothing_length, correction_factor)

    valid = solid["LatticeValid"]
    sweep = ls.lattice_force if use_kernels else ls.lattice_force_plain
    force = sweep(pos_f, S_f, Jm2d_f, valid, lat.shape, lat.taps,
                  lat.dx ** lat.dim, correction_factor * material.shear_modulus)

    force_f = (force * (solid["Mass"] / rho0)[:, None]
               * valid.to(pos_f.dtype)[:, None])
    vel_new = solid["Velocity"] + torch.where(
        valid[:, None],
        (solid["ForcePrior"] + force_f)
        / torch.clamp(solid["Mass"], min=TINY)[:, None] * dt,
        0.0)
    out.update({"Position": pos_f, "DeformationGradient": F_f,
                "Density": rho0 / J, "Force": force_f, "Velocity": vel_new})
    return out


def integration_2nd_half_lattice(solid: dict, lat: LatticeSolid, dt,
                                 use_kernels: bool = True) -> dict:
    """Stencil twin of the second half (reference Integration2ndHalf):
    dF/dt_i = -[sum_o (v_i - v_j) outer dW0 V0 e0] B_i (L2), then F to the
    full step."""
    out = dict(solid)
    pos_f = solid["Position"] + solid["Velocity"] * (0.5 * dt)
    sweep = ls.lattice_dfdt if use_kernels else ls.lattice_dfdt_plain
    dFdt = sweep(solid["Velocity"], solid["LatticeValid"], lat.shape, lat.taps,
                 lat.dx ** lat.dim)
    dFdt_f = mm(dFdt, solid["LinearGradientCorrectionMatrix"])
    F_new = solid["DeformationGradient"] + dFdt_f * (0.5 * dt)
    out.update({"Position": pos_f, "DeformationRate": dFdt_f,
                "DeformationGradient": F_new})
    return out


def lattice_correction_matrix(lat: LatticeSolid, valid: torch.Tensor,
                              dtype: torch.dtype, alpha: float = 0.0,
                              eps: float = 1.0e-8) -> torch.Tensor:
    """B matrices via the stencil (twin of
    solid.linear_gradient_correction_matrix): A_i = -sum_o r0 e0 outer
    (dW0 V0 e0) w_j; Tikhonov-regularized inverse with determinant
    weighting.  A site with no valid neighbour gets 0/0 = NaN, as in JAX;
    the sweeps never read an invalid site's values."""
    dim = lat.dim
    vol0 = lat.dx ** dim
    dev = valid.device
    vmask = valid.to(dtype).reshape(lat.shape)
    m = max(abs(c) for o, *_ in lat.taps for c in o)
    mP = ls._pad(vmask, m)
    A = torch.zeros(lat.shape + (dim, dim), dtype=dtype, device=dev)
    for o, r0, e0, W0, dW0 in lat.taps:
        wj = ls._tap(mP, o, m, lat.shape)
        e = -np.asarray(e0)
        outer = torch.as_tensor(-np.outer(r0 * e, dW0 * vol0 * e), dtype=dtype,
                                device=dev)
        A = A + wj[..., None, None] * outer
    A = A.reshape(-1, dim, dim)
    det_a = det(A)
    eye = torch.eye(dim, dtype=dtype, device=dev)
    At = A.transpose(-1, -2)
    M = mm(At, A) + eps * eye
    CM = cofactors(M)
    inv = mm(CM.transpose(-1, -2) / det(M, CM)[:, None, None], At)
    det_sqr = torch.clamp(alpha - det_a, min=0.0)
    w1 = det_a / (det_a + det_sqr)
    w2 = det_sqr / (det_a + det_sqr)
    return w1[..., None, None] * inv + w2[..., None, None] * eye
