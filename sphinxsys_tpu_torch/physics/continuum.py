"""Granular and updated-Lagrangian continuum dynamics (counterpart of
sphinxsys_tpu/physics/continuum.py; reference continuum_dynamics/
continuum_integration.{h,hpp,cpp} and materials/general_continuum.{h,cpp}).

  * PlasticContinuum: Drucker-Prager yield with non-associated flow, the
    Jaumann stress rate and the return mapping,
        alpha_phi = tan(phi) / sqrt(9 + 12 tan^2 phi)
        k_c       = 3 c / sqrt(9 + 12 tan^2 phi);
  * the plastic integration halves: the dual half-step WCSPH scheme with
    the pressure replaced by the full stress tensor (plane strain in 2D:
    3 x 3 stresses beside d x d velocity gradients, `_degrade` /
    `_upgrade`); the second half's velocity gradient feeds the
    constitutive update and the return mapping;
  * stress_diffusion: the regularisation of the stress field;
  * the updated-Lagrangian solid with hourglass control: the correction
    matrix on the current configuration, the Jaumann shear-stress half
    (elastic, or J2-plastic with hardening) and the shear acceleration
    with the co-rotated zero-energy-mode penalty.  Its pressure and
    density halves are the fluid's acoustic halves, the shear force
    passed as `extra_force=ul_shear_force(state)`.

Every function is a pure function of tensors over the (N, K) lists of
neighbors/neighbor_list.py.  The per-particle and per-pair (d, d)
products are the broadcast sums of core/linalg.py (no einsum, no
torch.linalg), and every `where` guards its untaken branch with JAX's
TINY terms, so that no NaN is computed there.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from sphinxsys_tpu_torch.core.linalg import det, inv, mm, mv, outer_sum
from sphinxsys_tpu_torch.core.state import State, make_fluid_state
from sphinxsys_tpu_torch.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_tpu_torch.physics.pair import pair_geometry

TINY = 1.0e-15


def _eye(d, like):
    return torch.eye(d, dtype=like.dtype, device=like.device)


def _tr(M):
    return torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)


def _T(M):
    return M.transpose(-1, -2)


@dataclasses.dataclass(frozen=True)
class GeneralContinuum:
    """Elastic continuum with an artificial sound speed
    (general_continuum.h:36): the volumetric part is the WCSPH equation of
    state, c = c0."""

    rho0: float = 1.0
    c0: float = 1.0
    youngs_modulus: float = 1.0
    poisson_ratio: float = 0.3

    @property
    def shear_modulus(self) -> float:
        return 0.5 * self.youngs_modulus / (1.0 + self.poisson_ratio)

    @property
    def bulk_modulus(self) -> float:
        return self.youngs_modulus / (3.0 * (1.0 - 2.0 * self.poisson_ratio))

    def sound_speed(self, p=None, rho=None):
        return self.c0


@dataclasses.dataclass(frozen=True)
class PlasticContinuum(GeneralContinuum):
    """Drucker-Prager plasticity (general_continuum.cpp:38-90)."""

    friction_angle: float = 0.4  # radians
    cohesion: float = 0.0
    dilatancy: float = 0.0

    @property
    def alpha_phi(self) -> float:
        t = math.tan(self.friction_angle)
        return t / math.sqrt(9.0 + 12.0 * t * t)

    @property
    def k_c(self) -> float:
        t = math.tan(self.friction_angle)
        return 3.0 * self.cohesion / math.sqrt(9.0 + 12.0 * t * t)

    @property
    def alpha_psi(self) -> float:
        t = math.tan(self.dilatancy)
        return t / math.sqrt(9.0 + 12.0 * t * t)

    def constitutive_relation(self, velocity_gradient, stress_tensor):
        """The Jaumann elastic rate minus the non-associated plastic
        corrector where f >= TINY (ConstitutiveRelation); (..., 3, 3)."""
        G, K = self.shear_modulus, self.bulk_modulus
        L = velocity_gradient
        eye = _eye(3, L)
        strain_rate = 0.5 * (L + _T(L))
        spin_rate = 0.5 * (L - _T(L))
        tr_e = _tr(strain_rate)
        dev_e = strain_rate - (tr_e / 3.0)[..., None, None] * eye
        elastic = (2.0 * G * dev_e + K * tr_e[..., None, None] * eye
                   + mm(stress_tensor, _T(spin_rate))
                   + mm(spin_rate, stress_tensor))
        tr_s = _tr(stress_tensor)
        dev_s = stress_tensor - (tr_s / 3.0)[..., None, None] * eye
        J2 = 0.5 * torch.sum(dev_s * dev_s, dim=(-2, -1))
        sqrtJ2 = torch.sqrt(J2 + TINY)
        f = sqrtJ2 + self.alpha_phi * tr_s - self.k_c
        ds_e = torch.sum(dev_s * strain_rate, dim=(-2, -1))
        lam = (3.0 * self.alpha_phi * K * tr_e + (G / sqrtJ2) * ds_e) / \
            (9.0 * self.alpha_phi * K * self.alpha_psi + G)
        g = lam[..., None, None] * (3.0 * K * self.alpha_psi * eye
                                    + (G / sqrtJ2)[..., None, None] * dev_s)
        plastic = torch.where((f >= TINY)[..., None, None], g,
                              torch.zeros_like(g))
        return elastic - plastic

    def return_mapping(self, stress_tensor):
        """The tension cut-off, then the projection back onto the cone
        (ReturnMapping)."""
        eye = _eye(3, stress_tensor)
        I1 = _tr(stress_tensor)
        over = -self.alpha_phi * I1 + self.k_c < 0
        corr = ((I1 - self.k_c / max(self.alpha_phi, TINY)) / 3.0
                )[..., None, None] * eye
        s = torch.where(over[..., None, None], stress_tensor - corr,
                        stress_tensor)
        I1 = _tr(s)
        dev = s - (I1 / 3.0)[..., None, None] * eye
        J2 = 0.5 * torch.sum(dev * dev, dim=(-2, -1))
        sqrtJ2 = torch.sqrt(J2 + TINY)
        yielding = -self.alpha_phi * I1 + self.k_c < sqrtJ2
        r = (-self.alpha_phi * I1 + self.k_c) / (sqrtJ2 + TINY)
        scaled = r[..., None, None] * dev + (I1 / 3.0)[..., None, None] * eye
        return torch.where(yielding[..., None, None], scaled, s)


@dataclasses.dataclass(frozen=True)
class J2Plasticity(GeneralContinuum):
    """Von Mises (J2) plasticity with linear isotropic hardening on the
    deviatoric shear stress (general_continuum.h:126, .cpp:103-154), for
    the updated-Lagrangian hourglass-controlled integrator."""

    yield_stress: float = 1.0
    hardening_modulus: float = 0.0

    _SQRT23 = math.sqrt(2.0 / 3.0)

    def _yield_f(self, shear_stress, hardening_factor):
        J2 = 0.5 * torch.sum(shear_stress * _T(shear_stress), dim=(-2, -1))
        k = self.hardening_modulus * hardening_factor + self.yield_stress
        return torch.sqrt(2.0 * J2) - self._SQRT23 * k, J2, k

    def shear_rate_with_hardening(self, velocity_gradient, shear_stress,
                                  hardening_factor):
        """ConstitutiveRelationShearStressWithHardening (cpp:113-130): the
        Jaumann deviatoric rate minus the plastic corrector where f > TINY."""
        G = self.shear_modulus
        L = velocity_gradient
        dim = L.shape[-1]
        eye = _eye(dim, L)
        strain_rate = 0.5 * (L + _T(L))
        spin = 0.5 * (L - _T(L))
        dev_e = strain_rate - (_tr(strain_rate) / dim)[..., None, None] * eye
        elastic = (2.0 * G * dev_e + mm(shear_stress, _T(spin))
                   + mm(spin, shear_stress))
        f, J2, _ = self._yield_f(shear_stress, hardening_factor)
        s_dot_e = torch.sum(shear_stress * strain_rate, dim=(-2, -1))
        lam = s_dot_e / (torch.sqrt(2.0 * J2 + TINY)
                         * (1.0 + self.hardening_modulus / (3.0 * G)))
        g = (lam / torch.sqrt(J2 + TINY))[..., None, None] * (
            math.sqrt(2.0) * G * shear_stress)
        return elastic - torch.where((f > TINY)[..., None, None], g,
                                     torch.zeros_like(g))

    def hardening_factor_rate(self, shear_stress, hardening_factor):
        """HardeningFactorRate (cpp:149-154)."""
        f, _, _ = self._yield_f(shear_stress, hardening_factor)
        rate = 0.5 * f / (self.shear_modulus + self.hardening_modulus / 3.0)
        return torch.where(f > TINY, rate, torch.zeros_like(rate))

    def scale_penalty_force(self, shear_stress, hardening_factor):
        """ScalePenaltyForce (cpp:142-147): the radial-return ratio r <= 1
        where yielding, else 1."""
        f, J2, k = self._yield_f(shear_stress, hardening_factor)
        r = self._SQRT23 * k / (torch.sqrt(2.0 * J2) + TINY)
        return torch.where(f > TINY, r, torch.ones_like(r))

    def return_mapping_shear_stress(self, shear_stress, hardening_factor):
        """ReturnMappingShearStress (cpp:132-140)."""
        return self.scale_penalty_force(
            shear_stress, hardening_factor)[..., None, None] * shear_stress


def _degrade(s3, dim):
    return s3[..., :dim, :dim]


def _upgrade(m):
    """(..., d, d) -> (..., 3, 3), zero-padded (exact)."""
    d = m.shape[-1]
    return F.pad(m, (0, 3 - d, 0, 3 - d))


def make_continuum_state(pos, volume, material, dtype, device) -> State:
    """A fluid state plus the 3 x 3 stress, stress rate, strain and
    velocity gradient of the plastic continuum."""
    state = make_fluid_state(pos, volume, material.rho0, dtype, device)
    n = state["Position"].shape[0]
    for k in ("StressTensor3D", "StressRate3D", "StrainTensor3D",
              "VelocityGradient3D"):
        state[k] = torch.zeros((n, 3, 3), dtype=dtype, device=device)
    return state


def plastic_integration_1st_half(soil: State, nl: NeighborList, kernel,
                                 dim: int, material, riemann, dt,
                                 wall: State | None = None,
                                 nl_wall: NeighborList | None = None) -> State:
    """PlasticIntegration1stHalf (continuum_integration.hpp, inner and
    wall): the stress force m_i sum_j rho_j (sig_i + sig_j) / (rho_i
    rho_j) . grad W_ij V_j, the density dissipation of the pressure jump,
    and against the wall the non-conservative force with the pressure
    reconstructed in the wall (hpp:56-69)."""
    out = dict(soil)
    mass = soil["Mass"]
    rho = soil["Density"] + soil["DensityChangeRate"] * (0.5 * dt)
    sigma3 = soil["StressTensor3D"]
    p = -_tr(sigma3) / 3.0
    pos = soil["Position"] + soil["Velocity"] * (0.5 * dt)
    vol = soil["VolumetricMeasure"]

    pg = pair_geometry(pos, pos, nl, kernel, dim, need_W=False)
    sig = _degrade(sigma3, dim)
    sig_j, _ = gather(sig, nl.idx)
    rho_j, _ = gather(rho, nl.idx)
    p_j, _ = gather(p, nl.idx)
    vol_j, _ = gather(vol, nl.idx)
    grad = (pg.dW * vol_j)[..., None] * pg.e
    pair_sig = (sig[:, None] + sig_j) / (rho[:, None, None, None]
                                         * rho_j[..., None, None])
    force = mass[:, None] * torch.sum(rho_j[..., None] * mv(pair_sig, grad),
                                      dim=1)
    rho_diss = torch.sum(riemann.dissipative_u_jump(p[:, None] - p_j)
                         * pg.dW * vol_j, dim=1)
    force_total = soil["Force"] + force
    drho_dt = rho_diss * rho

    if wall is not None:
        ncf = soil["ForcePrior"] * rho[:, None] + mass[:, None] * torch.sum(
            ((p[:, None] - p_j) * pg.dW * vol_j)[..., None] * pg.e, dim=1)
        ncf = ncf / rho[:, None]
        pgw = pair_geometry(pos, wall["Position"], nl_wall, kernel, dim,
                            need_W=False)
        wall_vol, _ = gather(wall["VolumetricMeasure"], nl_wall.idx)
        wall_acc, _ = gather(wall["AverageAcceleration"], nl_wall.idx)
        dWV_w = pgw.dW * wall_vol
        acc_i = ncf / mass[:, None]
        face_acc = torch.sum((acc_i[:, None, :] - wall_acc) * (-pgw.e),
                             dim=-1)
        p_in_wall = p[:, None] + rho[:, None] * pgw.r * torch.clamp(
            face_acc, min=0.0)
        fw = ncf + 2.0 * mass[:, None] * mv(
            sig, torch.sum(dWV_w[..., None] * pgw.e, dim=1))
        rho_diss_w = torch.sum(riemann.dissipative_u_jump(
            p[:, None] - p_in_wall) * dWV_w, dim=1)
        force_total = force_total + fw / rho[:, None]
        drho_dt = drho_dt + rho_diss_w * rho

    vel = soil["Velocity"] + (soil["ForcePrior"] + force_total) \
        / mass[:, None] * dt
    out.update({"Density": rho, "Pressure": p, "Position": pos,
                "Force": force_total, "DensityChangeRate": drho_dt,
                "Velocity": vel})
    return out


def plastic_integration_2nd_half(soil: State, nl: NeighborList, kernel,
                                 dim: int, material, riemann, dt,
                                 wall: State | None = None,
                                 nl_wall: NeighborList | None = None) -> State:
    """PlasticIntegration2ndHalf (continuum_integration.hpp, inner and
    wall): the density rate, the momentum dissipation and the velocity
    gradient (against the wall's mirrored velocity), then the
    constitutive update and the return mapping of the 3 x 3 stress."""
    out = dict(soil)
    pos = soil["Position"] + soil["Velocity"] * (0.5 * dt)
    vel = soil["Velocity"]
    rho = soil["Density"]
    mass = soil["Mass"]

    pg = pair_geometry(pos, pos, nl, kernel, dim, need_W=False)
    vel_j, _ = gather(vel, nl.idx)
    vol_j, _ = gather(soil["VolumetricMeasure"], nl.idx)
    dWV = pg.dW * vol_j
    u_jump = torch.sum((vel[:, None, :] - vel_j) * pg.e, dim=-1)
    dcr = torch.sum(u_jump * dWV, dim=1)
    p_diss = mass[:, None] * torch.sum(
        (riemann.dissipative_p_jump(u_jump) * dWV)[..., None] * pg.e, dim=1)
    dvel = vel[:, None, :] - vel_j
    vgrad = -outer_sum(dvel, dWV[..., None] * pg.e)

    drho_dt = soil["DensityChangeRate"] + dcr * rho
    force = p_diss / rho[:, None]

    if wall is not None:
        pgw = pair_geometry(pos, wall["Position"], nl_wall, kernel, dim,
                            need_W=False)
        wall_vol, _ = gather(wall["VolumetricMeasure"], nl_wall.idx)
        vel_ave, _ = gather(wall["AverageVelocity"], nl_wall.idx)
        n_k, _ = gather(wall["NormalDirection"], nl_wall.idx)
        dWV_w = pgw.dW * wall_vol
        vel_in_wall = 2.0 * vel_ave - vel[:, None, :]
        dcr_w = torch.sum(torch.sum((vel[:, None, :] - vel_in_wall) * pgw.e,
                                    dim=-1) * dWV_w, dim=1)
        u_jump_w = 2.0 * torch.sum((vel[:, None, :] - vel_ave) * n_k, dim=-1)
        p_diss_w = mass[:, None] * torch.sum(
            (riemann.dissipative_p_jump(u_jump_w) * dWV_w)[..., None] * n_k,
            dim=1)
        dvel_w = vel[:, None, :] - vel_in_wall
        vgrad = vgrad - outer_sum(dvel_w, dWV_w[..., None] * pgw.e)
        drho_dt = drho_dt + dcr_w * rho
        force = force + p_diss_w / rho[:, None]

    rho_new = rho + drho_dt * (0.5 * dt)
    vg3 = _upgrade(vgrad)
    stress_rate = soil["StressRate3D"] + material.constitutive_relation(
        vg3, soil["StressTensor3D"])
    sigma3 = material.return_mapping(soil["StressTensor3D"]
                                     + stress_rate * dt)
    strain3 = soil["StrainTensor3D"] + 0.5 * (vg3 + _T(vg3)) * dt

    out.update({"Position": pos, "DensityChangeRate": drho_dt,
                "Force": force, "Density": rho_new,
                "VolumetricMeasure": mass / rho_new,
                "StressTensor3D": sigma3, "StrainTensor3D": strain3,
                "StressRate3D": torch.zeros_like(stress_rate),
                "VelocityGradient3D": vg3})
    return out


def stress_diffusion(soil: State, nl: NeighborList, kernel, dim: int,
                     material, smoothing_length: float,
                     zeta: float = 0.1) -> State:
    """StressDiffusion (continuum_integration.cpp:41-63): StressRate3D
    set to the diffusive regularisation of the stress jump less its
    geostatic part (read by the next second half).  The denominator
    r^2 + 0.01 h (not 0.01 h^2) is the reference's."""
    out = dict(soil)
    pos = soil["Position"]
    acc_prior = soil["ForcePrior"] / soil["Mass"][:, None]
    gravity = torch.abs(acc_prior[:, 1])
    lateral = 1 - math.sin(material.friction_angle)

    pg = pair_geometry(pos, pos, nl, kernel, dim, need_W=False)
    vol_j, _ = gather(soil["VolumetricMeasure"], nl.idx)
    sig3_j, _ = gather(soil["StressTensor3D"], nl.idx)
    pos_j, _ = gather(pos, nl.idx)
    y_ij = pos[:, None, 1] - pos_j[..., 1]
    hydro = material.rho0 * gravity[:, None] * y_ij
    diag = torch.stack([-lateral * hydro, -hydro, -lateral * hydro], dim=-1)
    ds = soil["StressTensor3D"][:, None] - sig3_j + torch.diag_embed(diag)
    coeff = 2.0 * zeta * smoothing_length * material.c0 * pg.r * pg.dW \
        * vol_j / (pg.r ** 2 + 0.01 * smoothing_length)
    out["StressRate3D"] = torch.sum(coeff[..., None, None] * ds, dim=1)
    return out


# ---------------------------------------------------------------------------
# The updated-Lagrangian elastic solid with generalized hourglass control
# (continuum_integration.{h,cpp}: ShearStressRelaxationHourglassControl
# 1st / 2nd half).  The pressure and density halves are the fluid's
# acoustic halves (continuum_integration.hpp:19-22), composed through
# fluid.acoustic_step_1st_half(..., extra_force=ul_shear_force(state)).
# ---------------------------------------------------------------------------


def make_ul_solid_state(pos, volume, material, dtype, device) -> State:
    """A fluid state plus the shear stress, strain, velocity gradient,
    the hourglass and shear accelerations and B = I."""
    state = make_fluid_state(pos, volume, material.rho0, dtype, device)
    n, d = state["Position"].shape
    for k in ("ShearStress", "StrainTensor", "VelocityGradient"):
        state[k] = torch.zeros((n, d, d), dtype=dtype, device=device)
    for k in ("AccHourglass", "AccShear"):
        state[k] = torch.zeros((n, d), dtype=dtype, device=device)
    state["LinearGradientCorrectionMatrix"] = torch.eye(
        d, dtype=dtype, device=device).repeat(n, 1, 1)
    return state


def correction_matrix_current(state: State, nl: NeighborList, kernel,
                              dim: int, alpha: float = 0.0,
                              eps: float = 1.0e-8) -> State:
    """LinearGradientCorrectionMatrixInner on the current configuration
    (kernel_correction.cpp), refreshed every advection step: A = -sum_j
    r_ji outer grad W_ij V_j, B = w1 inv(A^T A + eps I) A^T + w2 I with
    the determinant weights of fluid.kernel_correction_matrix."""
    out = dict(state)
    pos = state["Position"]
    pg = pair_geometry(pos, pos, nl, kernel, dim, need_W=False)
    vol_j, _ = gather(state["VolumetricMeasure"], nl.idx)
    grad = (pg.dW * vol_j)[..., None] * pg.e
    A = -outer_sum(pg.r[..., None] * pg.e, grad)
    det_a = det(A)
    eye = _eye(dim, A)
    At = _T(A)
    pinv = mm(inv(mm(At, A) + eps * eye), At)
    det_sqr = torch.clamp(alpha - det_a, min=0.0)
    w1 = det_a / (det_a + det_sqr + TINY)
    w2 = det_sqr / (det_a + det_sqr + TINY)
    out["LinearGradientCorrectionMatrix"] = (
        w1[..., None, None] * pinv + w2[..., None, None] * eye)
    return out


def shear_stress_hourglass_1st_half(state: State, nl: NeighborList, kernel,
                                    dim: int, material, dt,
                                    plasticity=None, xi: float = 2.0) -> State:
    """ShearStressRelaxationHourglassControl1stHalf (continuum_integration
    .cpp:81-104): the B-corrected velocity gradient g = -sum_j v_ij outer
    B_i e_ij dW_ij V_j, the Jaumann shear-stress rate 2G dev(eps_dot) +
    sig Omega^T + Omega sig, the strain.  `plasticity` (a J2Plasticity)
    takes the J2 variant (cpp:159-179): the rate with its plastic
    corrector, the hardening increment, the xi-scaled penalty factor and
    the radial return."""
    out = dict(state)
    pos, vel = state["Position"], state["Velocity"]
    pg = pair_geometry(pos, pos, nl, kernel, dim, need_W=False)
    vel_j, _ = gather(vel, nl.idx)
    vol_j, _ = gather(state["VolumetricMeasure"], nl.idx)
    B = state["LinearGradientCorrectionMatrix"]
    grad = mv(B[:, None], (pg.dW * vol_j)[..., None] * pg.e)
    g = -outer_sum(vel[:, None, :] - vel_j, grad)
    out["VelocityGradient"] = g

    gT = _T(g)
    strain_rate = 0.5 * (g + gT)
    spin = 0.5 * (g - gT)
    eye = _eye(dim, g)
    dev = strain_rate - (_tr(strain_rate) / dim)[..., None, None] * eye
    G = material.shear_modulus
    sig = state["ShearStress"]
    if plasticity is None:
        rate = 2.0 * G * dev + mm(sig, _T(spin)) + mm(spin, sig)
        out["ShearStress"] = sig + rate * dt
    else:
        k = state["HardeningFactor"]
        rate = plasticity.shear_rate_with_hardening(g, sig, k)
        sig_try = sig + rate * dt
        k_new = k + J2Plasticity._SQRT23 * plasticity.hardening_factor_rate(
            sig_try, k)
        out["HardeningFactor"] = k_new
        out["ScalePenaltyForce"] = xi * plasticity.scale_penalty_force(
            sig_try, k_new)
        out["ShearStress"] = plasticity.return_mapping_shear_stress(
            sig_try, k_new)
    out["StrainTensor"] = state["StrainTensor"] + strain_rate * dt
    return out


def _rodrigues(spin, dt):
    """The rotation exp(spin dt) in the reference's trace form
    (continuum_integration.cpp:121-133), 2D or 3D; the identity where
    theta <= 1e-12 (s_hat divides by max(omega, TINY) there)."""
    dim = spin.shape[-1]
    tr = _tr(mm(spin, spin))
    omega = torch.sqrt(torch.clamp(-0.5 * tr, min=0.0))
    theta = omega * dt
    eye = _eye(dim, spin)
    s_hat = spin / torch.clamp(omega, min=TINY)[..., None, None]
    R = (eye + torch.sin(theta)[..., None, None] * s_hat
         + (1.0 - torch.cos(theta))[..., None, None] * mm(s_hat, s_hat))
    return torch.where((theta > 1.0e-12)[..., None, None], R,
                       eye.expand_as(R))


def shear_acceleration_hourglass_2nd_half(state: State, nl: NeighborList,
                                          kernel, dim: int, material, dt,
                                          xi: float = 2.0) -> State:
    """ShearStressRelaxationHourglassControl2ndHalf (cpp:134-157): the
    shear acceleration sum_j (sig_i + sig_j) / rho_i . grad W_ij V_j plus
    the zero-energy-mode penalty on the part of v_ij the mean gradient
    does not predict.  The penalty's accumulator AccHourglass is rotated
    by exp(Omega dt) each step, so that it turns with the material;
    ScalePenaltyForce, where the state has it, replaces xi by the pair
    mean of the J2 half's factor."""
    out = dict(state)
    pos, vel = state["Position"], state["Velocity"]
    rho = state["Density"]
    sig = state["ShearStress"]
    g = state["VelocityGradient"]

    pg = pair_geometry(pos, pos, nl, kernel, dim, need_W=False)
    vol_j, _ = gather(state["VolumetricMeasure"], nl.idx)
    vel_j, _ = gather(vel, nl.idx)
    sig_j, _ = gather(sig, nl.idx)
    g_j, _ = gather(g, nl.idx)
    scale = state.get("ScalePenaltyForce")
    dWV = pg.dW * vol_j

    acc = torch.sum(mv((sig[:, None] + sig_j) / rho[:, None, None, None],
                       dWV[..., None] * pg.e), dim=1)

    v_ij = vel[:, None, :] - vel_j
    v_pred = mv(0.5 * (g[:, None] + g_j), pg.r[..., None] * pg.e)
    v_corr = v_ij - v_pred
    if scale is None:
        penalty = xi
    else:
        scale_j, _ = gather(scale, nl.idx)
        penalty = 0.5 * (scale[:, None] + scale_j)
    G = material.shear_modulus
    coeff = penalty * G * torch.sum(v_corr * pg.e, dim=-1) * dWV * dt / (
        rho[:, None] * torch.clamp(pg.r, min=TINY))
    acc_hg_inc = torch.sum(coeff[..., None] * pg.e, dim=1)

    R = _rodrigues(0.5 * (g - _T(g)), dt)
    acc_hg = mv(R, state["AccHourglass"]) + acc_hg_inc
    out["AccHourglass"] = acc_hg
    out["AccShear"] = acc + acc_hg
    return out


def ul_shear_force(state: State):
    """AccShear as a force, folded into the acoustic first half's velocity
    update (BaseIntegration1stHalf::update, continuum_integration.hpp:19-22)."""
    return state["AccShear"] * state["Mass"][:, None]


def volume_update(state: State) -> State:
    """ContinuumVolumeUpdate: Vol = m / rho."""
    out = dict(state)
    out["VolumetricMeasure"] = state["Mass"] / state["Density"]
    return out
