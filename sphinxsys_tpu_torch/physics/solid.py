"""Total-Lagrangian elastic solid dynamics (counterpart of
sphinxsys_tpu/physics/solid.py; reference elastic_dynamics.{h,cpp},
kernel_correction.cpp and general_constraint.h).

The pair topology lives on the initial configuration: the inner relation
is built once on the undeformed positions and never rebuilt, and
`ReferencePairs` freezes its dW, e, r and W.  The pair sweeps of the
lattice engine, whose frozen pairs are a stencil, live in
physics/solid_lattice.py; the gather engine's sums over (N, K) frozen
lists are here.

Verlet scheme (elastic_dynamics.cpp):
  1st half: x += v dt/2; F += dF/dt dt/2; rho = rho0/det(F); the stress;
            force_i = m_i/rho0 sum_j (pair stress) e_ij dW_ij V_j;
            v += (F + F_prior)/m dt
  2nd half: x += v dt/2; dF/dt_i = -[sum_j (v_i - v_j) outer dW_ij V_j
            e_ij] B_i; F += dF/dt dt/2

Determinants and inverses of the 2x2 / 3x3 per-particle matrices are
closed-form cofactor expansions and their products broadcast sums (`mm`):
torch.linalg.inv on the card checks for singular input and waits for the
host, and cuBLAS splits million-particle batches of tiny products into
many launches.  At F ~ I they agree with JAX's LU forms to float64
roundoff.  The same goes for the pair contractions, which are broadcast
products and sums rather than einsums.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sphinxsys_tpu_torch.core.state import State, make_base_state, valid_mask
from sphinxsys_tpu_torch.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_tpu_torch.physics.pair import pair_geometry

TINY = 1.0e-15
# the decomposed integration's shear correction (reference
# DecomposedIntegration1stHalf, elastic_dynamics.cpp)
CORRECTION_FACTOR = 1.07


# ---------------------------------------------------------------------------
# per-particle 2x2 / 3x3 algebra
# ---------------------------------------------------------------------------

def cofactors(M: torch.Tensor) -> torch.Tensor:
    """Cofactor matrices of (..., d, d), d = 2 or 3: inv(M) = C^T / det(M)."""
    if M.shape[-1] == 2:
        a, b, c, d = M[..., 0, 0], M[..., 0, 1], M[..., 1, 0], M[..., 1, 1]
        return torch.stack([torch.stack([d, -c], dim=-1),
                            torch.stack([-b, a], dim=-1)], dim=-2)
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return torch.stack([
        torch.stack([e * i - f * h, f * g - d * i, d * h - e * g], dim=-1),
        torch.stack([c * h - b * i, a * i - c * g, b * g - a * h], dim=-1),
        torch.stack([b * f - c * e, c * d - a * f, a * e - b * d], dim=-1),
    ], dim=-2)


def det(M: torch.Tensor, C: torch.Tensor | None = None) -> torch.Tensor:
    """det(M) from its cofactors (expansion along the first row)."""
    C = cofactors(M) if C is None else C
    out = M[..., 0, 0] * C[..., 0, 0]
    for k in range(1, M.shape[-1]):
        out = out + M[..., 0, k] * C[..., 0, k]
    return out


def inv(M: torch.Tensor) -> torch.Tensor:
    C = cofactors(M)
    return C.transpose(-1, -2) / det(M, C)[..., None, None]


def mm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Per-particle matrix products of (..., d, d) stacks."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(dim=-2)


def mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., d, d) @ (..., d) -> (..., d)."""
    return (A * v[..., None, :]).sum(dim=-1)


def outer_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_k a_k outer b_k over the slot axis: (N, K, d) x (N, K, d) ->
    (N, d, d) (JAX's einsum "nki,nkj->nij")."""
    return (a[..., :, None] * b[..., None, :]).sum(dim=1)


# ---------------------------------------------------------------------------
# frozen reference pairs
# ---------------------------------------------------------------------------

class ReferencePairs(NamedTuple):
    """Frozen initial-configuration pair data for total-Lagrangian ops."""

    idx: torch.Tensor    # (N, K) neighbour indices (sentinel N)
    W: torch.Tensor      # (N, K)
    dW: torch.Tensor     # (N, K)
    r: torch.Tensor      # (N, K)
    e: torch.Tensor      # (N, K, dim)  unit j -> i
    mask: torch.Tensor   # (N, K)


def freeze_reference_pairs(pos0, nl: NeighborList, kernel,
                           dim: int) -> ReferencePairs:
    pg = pair_geometry(pos0, pos0, nl, kernel, dim)
    return ReferencePairs(idx=nl.idx, W=pg.W, dW=pg.dW, r=pg.r, e=pg.e,
                          mask=pg.mask)


def linear_gradient_correction_matrix(rp: ReferencePairs, vol,
                                      alpha: float = 0.0,
                                      eps: float = 1.0e-8) -> torch.Tensor:
    """B matrix (kernel_correction.cpp LinearGradientCorrectionMatrix):
    A_i = -sum_j r_ji outer gradW_ij V_j with r_ji = r_ij e_ij;
    B_i = w1 tikhonov_inverse(A_i) + w2 I with determinant weighting."""
    vol_j, _ = gather(vol, rp.idx)
    grad = (rp.dW * vol_j)[..., None] * rp.e
    A = -outer_sum(rp.r[..., None] * rp.e, grad)
    d = A.shape[-1]
    detA = det(A)
    eye = torch.eye(d, dtype=A.dtype, device=A.device)
    At = A.transpose(-1, -2)
    tik = mm(inv(mm(At, A) + eps * eye), At)
    det_sqr = torch.clamp(alpha - detA, min=0.0)
    w1 = detA / (detA + det_sqr)
    w2 = det_sqr / (detA + det_sqr)
    return w1[..., None, None] * tik + w2[..., None, None] * eye


# ---------------------------------------------------------------------------
# integration
# ---------------------------------------------------------------------------

def integration_1st_half_pk2(solid: State, rp: ReferencePairs, material,
                             dt, smoothing_length: float, w0: float,
                             numerical_dissipation_factor: float = 0.25,
                             active_stress_fn=None, pk1_fn=None) -> State:
    """Integration1stHalfPK2 (elastic_dynamics.cpp): the PK2 stress of the
    material, corrected by B, plus the pair numerical damping
    0.5 rho0 c0 h (dim/r)^2 (x_i - x_j).(v_i - v_j) weighted by W/w0.
    The active-stress and PK1 hooks of the JAX package (muscle and fish
    cases) are not ported: passing one raises."""
    if active_stress_fn is not None or pk1_fn is not None:
        raise NotImplementedError(
            "active_stress_fn / pk1_fn (active muscle and composite solids) "
            "are not ported")
    out = dict(solid)
    dim = solid["Position"].shape[1]
    rho0 = material.rho0
    c0 = material.sound_speed

    pos = solid["Position"] + solid["Velocity"] * (0.5 * dt)
    F = solid["DeformationGradient"] + solid["DeformationRate"] * (0.5 * dt)
    rho = rho0 / det(F)
    B = solid["LinearGradientCorrectionMatrix"]
    S = mm(mm(F, material.stress_PK2(F)), B.transpose(-1, -2))

    vel = solid["Velocity"]
    vol_j, _ = gather(solid["VolumetricMeasure"], rp.idx)
    S_j, _ = gather(S, rp.idx)
    F_j, _ = gather(F, rp.idx)
    pos_j, _ = gather(pos, rp.idx)
    vel_j, _ = gather(vel, rp.idx)

    dim_over_r = dim / (rp.r + TINY)
    strain_rate = dim_over_r * dim_over_r * torch.sum(
        (pos[:, None, :] - pos_j) * (vel[:, None, :] - vel_j), dim=-1)
    pair_damping = 0.5 * rho0 * c0 * strain_rate * smoothing_length
    weight = rp.W / w0
    stress_ij = (S[:, None, :, :] + S_j
                 + (numerical_dissipation_factor * weight
                    * pair_damping)[..., None, None]
                 * 0.5 * (F[:, None, :, :] + F_j))
    coeff = (rp.dW * vol_j * rp.mask)[..., None]
    force = (solid["Mass"] / rho0)[:, None] * torch.sum(
        mv(stress_ij, rp.e) * coeff, dim=1)

    vel = vel + (solid["ForcePrior"] + force) / solid["Mass"][:, None] * dt
    out.update({"Position": pos, "DeformationGradient": F, "Density": rho,
                "StressPK1OnParticle": S, "Force": force, "Velocity": vel})
    return out


def decomposed_stress(solid: State, material, dt, smoothing_length: float,
                      correction_factor: float = CORRECTION_FACTOR):
    """The decomposed first half's per-particle prelude (reference
    DecomposedIntegration1stHalf initialization): position and F to the
    half step, J, J^(-2/dim) and the Kirchhoff-decomposed stress with its
    numerical damping,
      S = F^-T [VolK(J) - cf G J^(-2/d) tr(F F^T)/d]
          + NumericalDampingLeftCauchy(F, dF/dt, h) F^-T.
    Returns (pos, F, J, Jm2d, S)."""
    dim = solid["Position"].shape[1]
    rho0 = material.rho0
    G = material.shear_modulus

    pos = solid["Position"] + solid["Velocity"] * (0.5 * dt)
    F = solid["DeformationGradient"] + solid["DeformationRate"] * (0.5 * dt)
    dF = solid["DeformationRate"]
    C = cofactors(F)
    J = det(F, C)
    Jm2d = (1.0 / (J * J)) ** (1.0 / dim)
    invFT = C / J[:, None, None]
    trFFT = (F * F).sum(dim=(-2, -1))
    scalar = (material.volumetric_kirchhoff(J)
              - correction_factor * G * Jm2d * trFFT / dim)
    sr = 0.5 * (mm(dF, F.transpose(-1, -2)) + mm(F, dF.transpose(-1, -2)))
    diag = torch.eye(dim, dtype=F.dtype, device=F.device) * sr
    damp = 0.5 * rho0 * (material.shear_wave_speed * (sr - diag)
                         + material.sound_speed * diag) * smoothing_length
    S = scalar[:, None, None] * invFT + mm(damp, invFT)
    return pos, F, J, Jm2d, S


def decomposed_integration_1st_half(solid: State, rp: ReferencePairs,
                                    material, dt, smoothing_length: float,
                                    correction_factor: float = CORRECTION_FACTOR
                                    ) -> State:
    """DecomposedIntegration1stHalf (elastic_dynamics.cpp:162-184): the
    volumetric stress rides the stress-pair sum and the deviatoric part is
    a pairwise central force along the current pair direction,
      shear_ij = cf G (J_i^(-2/d) + J_j^(-2/d)) (x_i - x_j)/r0_ij,
      F_i = m_i/rho0 sum_j [(S_i + S_j) e0_ij + shear_ij] dW0 V_j."""
    out = dict(solid)
    rho0 = material.rho0
    G = material.shear_modulus
    pos, F, J, Jm2d, S = decomposed_stress(solid, material, dt,
                                           smoothing_length, correction_factor)

    vol_j, _ = gather(solid["VolumetricMeasure"], rp.idx)
    S_j, _ = gather(S, rp.idx)
    Jm2d_j, _ = gather(Jm2d, rp.idx)
    pos_j, _ = gather(pos, rp.idx)
    shear = (correction_factor * G * (Jm2d[:, None] + Jm2d_j)
             / (rp.r + TINY))[..., None] * (pos[:, None, :] - pos_j)
    pair = mv(S[:, None] + S_j, rp.e) + shear
    coeff = (rp.dW * vol_j * rp.mask)[..., None]
    force = (solid["Mass"] / rho0)[:, None] * torch.sum(pair * coeff, dim=1)

    vel = solid["Velocity"] + (solid["ForcePrior"] + force) \
        / solid["Mass"][:, None] * dt
    out.update({"Position": pos, "DeformationGradient": F,
                "Density": rho0 / J, "Force": force, "Velocity": vel})
    return out


def integration_2nd_half(solid: State, rp: ReferencePairs, dt) -> State:
    """Integration2ndHalf: x to the full step, dF/dt from the velocity
    differences, F to the full step."""
    out = dict(solid)
    pos = solid["Position"] + solid["Velocity"] * (0.5 * dt)
    vel = solid["Velocity"]
    vol_j, _ = gather(solid["VolumetricMeasure"], rp.idx)
    vel_j, _ = gather(vel, rp.idx)
    grad = (rp.dW * vol_j * rp.mask)[..., None] * rp.e
    dF_dt = mm(-outer_sum(vel[:, None, :] - vel_j, grad),
               solid["LinearGradientCorrectionMatrix"])
    F = solid["DeformationGradient"] + dF_dt * (0.5 * dt)
    out.update({"Position": pos, "DeformationRate": dF_dt,
                "DeformationGradient": F})
    return out


# ---------------------------------------------------------------------------
# time step, constraint, state
# ---------------------------------------------------------------------------

def solid_acoustic_time_step(solid: State, c0: float, h_min: float,
                             cfl: float = 0.6) -> torch.Tensor:
    """AcousticTimeStep (elastic_dynamics.cpp): per-particle
    CFL * min(sqrt(h/|a|), h/(c0 + |v|)), reduced by min over the real
    particles.  A 0-d tensor on the state's device (no host sync)."""
    accel = torch.linalg.vector_norm(
        (solid["Force"] + solid["ForcePrior"]) / solid["Mass"][:, None], dim=-1)
    v = torch.linalg.vector_norm(solid["Velocity"], dim=-1)
    per = torch.minimum(torch.sqrt(h_min / (accel + TINY)), h_min / (c0 + v))
    per = torch.where(valid_mask(solid), per, torch.full_like(per, torch.inf))
    return cfl * torch.min(per)


def fix_constraint(solid: State, part_mask: torch.Tensor) -> State:
    """FixBodyPartConstraint (general_constraint.h FixConstraint):
    pos = pos0, vel = 0 on the constrained part."""
    out = dict(solid)
    m = part_mask[:, None]
    out["Position"] = torch.where(m, solid["InitialPosition"], solid["Position"])
    out["Velocity"] = torch.where(m, torch.zeros_like(solid["Velocity"]),
                                  solid["Velocity"])
    return out


def make_elastic_solid_state(pos: np.ndarray, volume, material,
                             dtype: torch.dtype, device) -> State:
    """Solid body state with the elastic-dynamics variables
    (elastic_dynamics.cpp:60-95 registrations)."""
    state = make_base_state(pos, volume, material.rho0, dtype, device)
    n, dim = state["Position"].shape
    eye = torch.eye(dim, dtype=dtype, device=device).expand(n, dim, dim)

    def zeros(*shape):
        return torch.zeros((n, *shape), dtype=dtype, device=device)

    state.update({
        "InitialPosition": state["Position"].clone(),
        "Velocity": zeros(dim),
        "Force": zeros(dim),
        "ForcePrior": zeros(dim),
        "DeformationGradient": eye.contiguous(),
        "DeformationRate": zeros(dim, dim),
        "StressPK1OnParticle": zeros(dim, dim),
        "LinearGradientCorrectionMatrix": eye.contiguous(),
    })
    return state
