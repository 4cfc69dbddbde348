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

Determinants, inverses and products of the 2x2 / 3x3 per-particle
matrices are the closed forms of core/linalg.py.  The pair contractions
are broadcast products and sums rather than einsums, for the same
reason: no host read and few launches.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sphinxsys_tpu_torch.core.linalg import (
    cholesky, cofactors, det, inv, mm, mv, outer_sum)
from sphinxsys_tpu_torch.core.state import State, make_base_state, nreal_mask
from sphinxsys_tpu_torch.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_tpu_torch.physics.pair import pair_geometry

TINY = 1.0e-15
# the decomposed integration's shear correction (reference
# DecomposedIntegration1stHalf, elastic_dynamics.cpp)
CORRECTION_FACTOR = 1.07


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


def freeze_adaptive_reference_pairs(pos0, h_ratio, nl: NeighborList, kernel,
                                    dim: int) -> ReferencePairs:
    """The adaptive-h freeze_reference_pairs of a multi-resolution solid
    (ParticleWithLocalRefinement / AdaptiveWithinShape,
    test_2d_mr_cantilever_beam.cpp:190): each pair at the pair smoothing
    length max(h_i, h_j) (the smaller ratio), and W divided by that
    pair's W(0), so integration_1st_half_pk2's damping weight runs with
    w0 = 1."""
    pos_j, mask = gather(pos0, nl.idx)
    hr_j, _ = gather(h_ratio, nl.idx)
    hr_pair = torch.minimum(h_ratio[:, None], hr_j)
    disp = pos0[:, None, :] - pos_j
    r = torch.sqrt(torch.sum(disp * disp, dim=-1) + TINY)
    e = disp / (r[..., None] + TINY)
    fmask = mask.to(pos0.dtype)
    W = kernel.W_adaptive(r, hr_pair, dim) * fmask
    dW = kernel.dW_adaptive(r, hr_pair, dim) * fmask
    return ReferencePairs(idx=nl.idx, W=W / kernel.w0_adaptive(hr_pair, dim),
                          dW=dW, r=r, e=e, mask=mask)

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
    `active_stress_fn(solid, F) -> PK2` is added to the material's PK2
    before F S (ActiveMuscle / ActiveContractionForce, complex_solid.h:
    the muscle's `active_fiber_stress`).  `pk1_fn(solid, F) -> PK1`
    replaces the material's stress (a composite body's per-particle law,
    the fish's `active_model_pk1`; the Cauchy integrator's
    `cauchy_pk1_fn`)."""
    out = dict(solid)
    dim = solid["Position"].shape[1]
    rho0 = material.rho0
    c0 = material.sound_speed

    pos = solid["Position"] + solid["Velocity"] * (0.5 * dt)
    F = solid["DeformationGradient"] + solid["DeformationRate"] * (0.5 * dt)
    rho = rho0 / det(F)
    B = solid["LinearGradientCorrectionMatrix"]
    if pk1_fn is not None:
        P = pk1_fn(solid, F)
    else:
        S2 = material.stress_PK2(F)
        if active_stress_fn is not None:
            S2 = S2 + active_stress_fn(solid, F)
        P = mm(F, S2)
    S = mm(P, B.transpose(-1, -2))

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


def cauchy_pk1_fn(material):
    """The PK1 hook of Integration1stHalfCauchy (elastic_dynamics.cpp:
    148-160): PK1 from the Cauchy stress of the Almansi strain,
    P = J sigma((I - (F F^T)^-1) / 2) F^-T; pass it as `pk1_fn` to
    integration_1st_half_pk2."""
    def pk1(solid, F):
        eye = torch.eye(F.shape[-1], dtype=F.dtype, device=F.device)
        almansi = 0.5 * (eye - inv(mm(F, F.transpose(-1, -2))))
        sigma = material.stress_cauchy(almansi)
        return mm(det(F)[..., None, None] * sigma, inv(F).transpose(-1, -2))
    return pk1


def active_fiber_stress(solid: State, F) -> torch.Tensor:
    """The ActiveMuscle active stress S_active = Ta f outer f (complex_solid.h
    ActiveMuscle), Ta and f read from the state's ActiveContractionStress
    and Fiber: an `active_stress_fn`."""
    f = solid["Fiber"]
    return solid["ActiveContractionStress"][..., None, None] \
        * (f[..., :, None] * f[..., None, :])


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


def decomposed_plastic_integration_1st_half(solid: State, rp: ReferencePairs,
                                            material, dt,
                                            smoothing_length: float) -> State:
    """DecomposedPlasticIntegration1stHalf (inelastic_dynamics.cpp:16-33):
    the volumetric-deviatoric decomposition of a J2-plastic solid.  The
    radial return updates each particle's InversePlasticStrain and
    HardeningParameter and gives the normalised elastic left Cauchy-Green
    tensor be; then
      scaling_i = be_i F_i^-T,
      S_i       = F_i^-T [VolK(J) - G tr(be)/d] + 0.125 damping F_i^-T,
      e_diff    = 0.5 (F_i^-1 + F_j^-1) (x_i - x_j)/r0_ij - e0_ij,
      limiter   = min(10 max(|e_diff| - 0.05, 0), 1),
      shear_ij  = G (scaling_i + scaling_j) (e0_ij + limiter e_diff),
      F_i       = m_i/rho0 sum_j [(S_i + S_j) e0_ij + shear_ij] dW0 V_j."""
    out = dict(solid)
    dim = solid["Position"].shape[1]
    rho0 = material.rho0
    G = material.shear_modulus

    pos = solid["Position"] + solid["Velocity"] * (0.5 * dt)
    F = solid["DeformationGradient"] + solid["DeformationRate"] * (0.5 * dt)
    dF = solid["DeformationRate"]
    J = det(F)
    nbe, inv_ps, kappa = material.elastic_left_cauchy(
        F, solid["InversePlasticStrain"], solid["HardeningParameter"])
    invF = inv(F)
    invFT = invF.transpose(-1, -2)
    scaling = mm(nbe, invFT)
    iso = G * torch.diagonal(nbe, dim1=-2, dim2=-1).sum(-1) / dim
    sr = 0.5 * (mm(dF, F.transpose(-1, -2)) + mm(F, dF.transpose(-1, -2)))
    diag = torch.eye(dim, dtype=F.dtype, device=F.device) * sr
    damp = 0.5 * rho0 * (material.shear_wave_speed * (sr - diag)
                         + material.sound_speed * diag) * smoothing_length
    S = ((material.volumetric_kirchhoff(J) - iso)[:, None, None] * invFT
         + mm(0.125 * damp, invFT))

    vol_j, _ = gather(solid["VolumetricMeasure"], rp.idx)
    S_j, _ = gather(S, rp.idx)
    scal_j, _ = gather(scaling, rp.idx)
    invF_j, _ = gather(invF, rp.idx)
    pos_j, _ = gather(pos, rp.idx)
    pair_invF = 0.5 * (invF[:, None] + invF_j)
    e_diff = mv(pair_invF, pos[:, None, :] - pos_j) \
        / (rp.r + TINY)[..., None] - rp.e
    e_norm = torch.linalg.vector_norm(e_diff, dim=-1)
    limiter = torch.clamp(10.0 * torch.clamp(e_norm - 0.05, min=0.0),
                          max=1.0)
    shear = G * mv(scaling[:, None] + scal_j,
                   rp.e + limiter[..., None] * e_diff)
    pair = mv(S[:, None] + S_j, rp.e) + shear
    coeff = (rp.dW * vol_j * rp.mask)[..., None]
    force = (solid["Mass"] / rho0)[:, None] * torch.sum(pair * coeff, dim=1)

    vel = solid["Velocity"] + (solid["ForcePrior"] + force) \
        / solid["Mass"][:, None] * dt
    out.update({"Position": pos, "DeformationGradient": F,
                "Density": rho0 / J, "Force": force, "Velocity": vel,
                "InversePlasticStrain": inv_ps, "HardeningParameter": kappa})
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


def deformation_gradient_by_summation(solid: State,
                                      rp: ReferencePairs) -> State:
    """F_i = [-sum_j (x_i - x_j) outer gradW_ij V_j] B_i
    (elastic_dynamics.h:107-122)."""
    out = dict(solid)
    pos = solid["Position"]
    vol_j, _ = gather(solid["VolumetricMeasure"], rp.idx)
    pos_j, _ = gather(pos, rp.idx)
    grad = (rp.dW * vol_j * rp.mask)[..., None] * rp.e
    out["DeformationGradient"] = mm(-outer_sum(pos[:, None, :] - pos_j, grad),
                                    solid["LinearGradientCorrectionMatrix"])
    return out


def _von_mises(M, factor: float):
    """sqrt(factor |dev M|^2) of (..., d, d) stacks."""
    dim = M.shape[-1]
    eye = torch.eye(dim, dtype=M.dtype, device=M.device)
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1) / dim
    dev = M - tr[..., None, None] * eye
    return torch.sqrt(factor * torch.sum(dev * dev, dim=(-2, -1)))


def von_mises_stress(solid: State, material) -> torch.Tensor:
    """The von Mises equivalent of the Cauchy stress F S F^T / J
    (solid_dynamics_variable)."""
    F = solid["DeformationGradient"]
    sigma = mm(mm(F, material.stress_PK2(F)), F.transpose(-1, -2)) \
        / det(F)[..., None, None]
    return _von_mises(sigma, 1.5)


def von_mises_strain(solid: State) -> torch.Tensor:
    """The von Mises equivalent of the Green-Lagrange strain."""
    F = solid["DeformationGradient"]
    eye = torch.eye(F.shape[-1], dtype=F.dtype, device=F.device)
    return _von_mises(0.5 * (mm(F.transpose(-1, -2), F) - eye), 2.0 / 3.0)


# ---------------------------------------------------------------------------
# time step, constraint, state
# ---------------------------------------------------------------------------

def active_model_pk1(F, active_strain, lambda0, G0) -> torch.Tensor:
    """ActiveModelSolid::StressPK1 (the fish's active-strain law,
    test_2d_flow_stream_around_fish/active_model.cpp:21-34): F = F_e F0
    with F0 = chol(2 E_a + I); the StVK stress of the elastic strain
    E_e = E - E_a, pushed forward by F0* = det(F0) F0^-T:
        P = F F0^-1 (lambda0 tr(E_e) I + 2 G0 E_e) F0*.
    lambda0 / G0: numbers or (N,) per-particle tensors."""
    d = F.shape[-1]
    eye = torch.eye(d, dtype=F.dtype, device=F.device)
    F0 = cholesky(2.0 * active_strain + eye)
    F0_inv = inv(F0)
    F0_star = det(F0)[..., None, None] * F0_inv.transpose(-1, -2)
    E_e = 0.5 * (mm(F.transpose(-1, -2), F) - eye) - active_strain
    lam = torch.as_tensor(lambda0, dtype=F.dtype, device=F.device)
    G = torch.as_tensor(G0, dtype=F.dtype, device=F.device)
    if lam.dim() == 1:
        lam = lam[:, None, None]
    if G.dim() == 1:
        G = G[:, None, None]
    tr = torch.diagonal(E_e, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    passive = lam * tr * eye + 2.0 * G * E_e
    return mm(mm(mm(F, F0_inv), passive), F0_star)


def solid_acoustic_time_step(solid: State, c0: float, h_min: float,
                             cfl: float = 0.6) -> torch.Tensor:
    """AcousticTimeStep (elastic_dynamics.cpp): per-particle
    CFL * min(sqrt(h/|a|), h/(c0 + |v|)), reduced by min over the rows
    below NReal (as the JAX package's).  A 0-d tensor on the state's device (no host sync)."""
    accel = torch.linalg.vector_norm(
        (solid["Force"] + solid["ForcePrior"]) / solid["Mass"][:, None], dim=-1)
    v = torch.linalg.vector_norm(solid["Velocity"], dim=-1)
    per = torch.minimum(torch.sqrt(h_min / (accel + TINY)), h_min / (c0 + v))
    per = torch.where(nreal_mask(solid), per, torch.full_like(per, torch.inf))
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
