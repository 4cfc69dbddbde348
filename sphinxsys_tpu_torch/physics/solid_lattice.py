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

Determinants and inverses of the 3x3 deformation gradients are closed-form
cofactor expansions: torch.linalg.inv on the card checks for singular
input and waits for the host, and the step allows one host sync.  At
F ~ I they agree with JAX's LU forms to float64 roundoff.  Products of
per-site 3x3 matrices are a broadcast product and a sum (`_mm`): as a
batched matmul, cuBLAS splits a million-site batch into ~18 launches of
~0.12 ms each (one H100, the plain path's profile).

Ported: the decomposed first half and the second half, which the
twisting column runs.  `integration_1st_half_pk2_lattice` waits (no caller
on that path).  3D only, as the kernels are.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sphinxsys_tpu_torch.ops import lattice_sweeps as ls

TINY = 1.0e-15
# the decomposed integration's shear correction (reference
# DecomposedIntegration1stHalf, elastic_dynamics.cpp)
CORRECTION_FACTOR = 1.07


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


def _cofactors(M):
    """Cofactor matrices of (..., 3, 3): inv(M) = C^T / det(M)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return torch.stack([
        torch.stack([e * i - f * h, f * g - d * i, d * h - e * g], dim=-1),
        torch.stack([c * h - b * i, a * i - c * g, b * g - a * h], dim=-1),
        torch.stack([b * f - c * e, c * d - a * f, a * e - b * d], dim=-1),
    ], dim=-2)


def _mm(A, B):
    """Per-site matrix products of (..., 3, 3) stacks."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(dim=-2)


def _det(M, C):
    """det(M) from its cofactors (expansion along the first row)."""
    return (M[..., 0, 0] * C[..., 0, 0] + M[..., 0, 1] * C[..., 0, 1]
            + M[..., 0, 2] * C[..., 0, 2])


def decomposed_stress(solid: dict, material, dt, smoothing_length: float,
                      correction_factor: float = CORRECTION_FACTOR):
    """The first half's per-site prelude (reference
    DecomposedIntegration1stHalf initialization): position and F to the
    half step, J, J^(-2/dim) and the Kirchhoff-decomposed stress with its
    numerical damping.  Returns (pos_f, F_f, J, Jm2d_f, S_f): pos_f, S_f
    and Jm2d_f are L1's inputs."""
    dim = solid["Position"].shape[1]
    rho0 = material.rho0
    G = material.shear_modulus

    pos_f = solid["Position"] + solid["Velocity"] * (0.5 * dt)
    F_f = solid["DeformationGradient"] + solid["DeformationRate"] * (0.5 * dt)
    dF = solid["DeformationRate"]
    C = _cofactors(F_f)
    J = _det(F_f, C)
    Jm2d_f = (1.0 / (J * J)) ** (1.0 / dim)
    invFT = C / J[:, None, None]
    trFFT = (F_f * F_f).sum(dim=(-2, -1))
    scalar = (material.volumetric_kirchhoff(J)
              - correction_factor * G * Jm2d_f * trFFT / dim)
    sr = 0.5 * (_mm(dF, F_f.transpose(-1, -2))
                + _mm(F_f, dF.transpose(-1, -2)))
    diag = torch.eye(dim, dtype=F_f.dtype, device=F_f.device) * sr
    damp = 0.5 * rho0 * (material.shear_wave_speed * (sr - diag)
                         + material.sound_speed * diag) * smoothing_length
    S_f = scalar[:, None, None] * invFT + _mm(damp, invFT)
    return pos_f, F_f, J, Jm2d_f, S_f


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
    dFdt_f = _mm(dFdt, solid["LinearGradientCorrectionMatrix"])
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
    det = _det(A, _cofactors(A))
    eye = torch.eye(dim, dtype=dtype, device=dev)
    At = A.transpose(-1, -2)
    M = _mm(At, A) + eps * eye
    CM = _cofactors(M)
    inv = _mm(CM.transpose(-1, -2) / _det(M, CM)[:, None, None], At)
    det_sqr = torch.clamp(alpha - det, min=0.0)
    w1 = det / (det + det_sqr)
    w2 = det_sqr / (det + det_sqr)
    return w1[..., None, None] * inv + w2[..., None, None] * eye
