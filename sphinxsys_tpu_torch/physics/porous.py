"""Saturated porous-media solid dynamics, a multi-species continuum
(counterpart of sphinxsys_tpu/physics/porous.py; reference
extra_src/shared/porous_media_{solid,dynamics}.{h,cpp}, namespace
multi_species_continuum): a linear-elastic skeleton carrying a diffusing
pore fluid.  The momentum unknown is the total (solid + fluid) momentum;
the fluid moves relative to the skeleton by a saturation-driven Darcy
flux, and the pore pressure k_w s swells the skeleton:

  stress half:   Stress = (cauchy(almansi) - k_w s I) F^-T
                 dM/dt_i = sum_j (Stress_i + Stress_j + damping
                     - outer_i - outer_j) e_ij dW_ij V_j
  momentum half: v = (M - q) V_up / m_total,  v_f = v - q / (rho_f s)
  saturation:    q = -D rho_f s grad s,
                 dm_f/dt = D V_up rho_f div(s grad s)   (pairwise form)

The saturation relaxes on the advection time scale, the stress halves on
the acoustic one (2d_membrane.cpp).  The per-particle 2 x 2 / 3 x 3
algebra is core/linalg.py's closed forms."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sphinxsys_tpu_torch.core.linalg import det, inv, mm, mv, outer_sum
from sphinxsys_tpu_torch.core.materials import LinearElasticSolid
from sphinxsys_tpu_torch.core.state import State
from sphinxsys_tpu_torch.neighbors.neighbor_list import gather
from sphinxsys_tpu_torch.physics.solid import (
    ReferencePairs, make_elastic_solid_state)

TINY = 1.0e-15


@dataclasses.dataclass(frozen=True)
class PorousMediaSolid(LinearElasticSolid):
    """A linear-elastic skeleton with the pore-fluid parameters
    (porous_media_solid.h): the diffusivity D, the fluid's initial density
    rho_f and the water-pressure constant k_w."""

    diffusivity_constant: float = 1.0
    fluid_initial_density: float = 1.0
    water_pressure_constant: float = 0.0


def make_porous_state(pos: np.ndarray, volume, material: PorousMediaSolid,
                      dtype: torch.dtype, device) -> State:
    """The elastic solid state with the porous fields, all zero but the
    update volume (V) and the total mass (m)."""
    state = dict(make_elastic_solid_state(pos, volume, material, dtype, device))
    n, dim = state["Position"].shape

    def zeros(*shape):
        return torch.zeros((n, *shape), dtype=dtype, device=device)

    state.update({
        "UpdateVolume": state["VolumetricMeasure"],
        "FluidSaturation": zeros(),
        "FluidMass": zeros(),
        "FluidMassIncrement": zeros(),
        "TotalMass": state["Mass"],
        "TotalMomentum": zeros(dim),
        "FluidVelocity": zeros(dim),
        "RelativeFluidFlux": zeros(dim),
        "OuterFluidVelocityRelativeFluidFlux": zeros(dim, dim),
        "Stress": zeros(dim, dim),
    })
    return state


def set_initial_saturation(porous: State, mask, saturation: float,
                           material: PorousMediaSolid) -> State:
    """PorousMediaSaturationDynamicsInitialCondition: saturate a body part
    and update the total (solid + fluid) mass."""
    out = dict(porous)
    vol = porous["VolumetricMeasure"]
    sat = torch.where(mask, torch.full_like(vol, saturation),
                      porous["FluidSaturation"])
    fluid_mass = sat * material.fluid_initial_density * vol
    out["FluidSaturation"] = sat
    out["FluidMass"] = fluid_mass
    out["TotalMass"] = material.rho0 * vol + fluid_mass
    return out


def porous_stress_relaxation_1st_half(porous: State, rp: ReferencePairs,
                                      material: PorousMediaSolid, dt,
                                      smoothing_length: float, w0: float,
                                      numerical_dissipation_factor: float = 0.25
                                      ) -> State:
    """PorousMediaStressRelaxationFirstHalf: the stress with the pore
    pressure, the pair force with the numerical damping and the fluid's
    momentum flux, and the total momentum."""
    out = dict(porous)
    dim = porous["Position"].shape[1]
    rho0 = material.rho0
    c0 = material.sound_speed

    pos = porous["Position"] + porous["Velocity"] * (0.5 * dt)
    F = porous["DeformationGradient"] + porous["DeformationRate"] * (0.5 * dt)
    J = det(F)
    inv_F_T = inv(F).transpose(-1, -2)
    eye = torch.eye(dim, dtype=F.dtype, device=F.device)
    almansi = 0.5 * (eye - inv(mm(F, F.transpose(-1, -2))))
    vol_update = porous["VolumetricMeasure"] * J

    sat = porous["FluidSaturation"]
    tr = torch.diagonal(almansi, dim1=-2, dim2=-1).sum(-1)
    cauchy = material.lambda0 * tr[..., None, None] * eye \
        + 2.0 * material.shear_modulus * almansi
    stress = mm(cauchy - (material.water_pressure_constant
                          * sat)[..., None, None] * eye, inv_F_T)
    outer = mm(porous["FluidVelocity"][:, :, None]
               * porous["RelativeFluidFlux"][:, None, :], inv_F_T)

    vel = porous["Velocity"]
    vol_j, _ = gather(porous["VolumetricMeasure"], rp.idx)
    stress_j, _ = gather(stress, rp.idx)
    outer_j, _ = gather(outer, rp.idx)
    F_j, _ = gather(F, rp.idx)
    pos_j, _ = gather(pos, rp.idx)
    vel_j, _ = gather(vel, rp.idx)

    dim_over_r = dim / (rp.r + TINY)
    strain_rate = dim_over_r * dim_over_r * torch.sum(
        (pos[:, None, :] - pos_j) * (vel[:, None, :] - vel_j), dim=-1)
    pair_damping = 0.5 * rho0 * c0 * strain_rate * smoothing_length
    weight = rp.W / w0
    stress_ij = (stress[:, None] + stress_j
                 + (numerical_dissipation_factor * weight
                    * pair_damping)[..., None, None]
                 * 0.5 * (F[:, None] + F_j)
                 - outer[:, None] - outer_j)
    coeff = (rp.dW * vol_j * rp.mask)[..., None]
    force = torch.sum(mv(stress_ij, rp.e) * coeff, dim=1)

    momentum = porous["TotalMomentum"] + (porous["ForcePrior"] + force) * dt
    out.update({
        "Position": pos, "DeformationGradient": F, "UpdateVolume": vol_update,
        "Stress": stress, "OuterFluidVelocityRelativeFluidFlux": outer,
        "Force": force, "TotalMomentum": momentum,
    })
    return out


def porous_stress_relaxation_2nd_half(porous: State, rp: ReferencePairs,
                                      material: PorousMediaSolid, dt) -> State:
    """PorousMediaStressRelaxationSecondHalf: the velocities from the total
    momentum, then the deformation rate."""
    out = dict(porous)
    vel = ((porous["TotalMomentum"] - porous["RelativeFluidFlux"])
           * porous["UpdateVolume"][:, None]
           / torch.clamp(porous["TotalMass"], min=TINY)[:, None])
    fluid_vel = vel - porous["RelativeFluidFlux"] / (
        material.fluid_initial_density
        * (porous["FluidSaturation"] + TINY))[:, None]
    pos = porous["Position"] + vel * (0.5 * dt)

    vol_j, _ = gather(porous["VolumetricMeasure"], rp.idx)
    vel_j, _ = gather(vel, rp.idx)
    grad = (rp.dW * vol_j * rp.mask)[..., None] * rp.e
    dF_dt = -outer_sum(vel[:, None] - vel_j, grad)
    dF_dt = mm(dF_dt, porous["LinearGradientCorrectionMatrix"])

    out.update({
        "Velocity": vel, "FluidVelocity": fluid_vel, "Position": pos,
        "DeformationRate": dF_dt,
        "DeformationGradient": porous["DeformationGradient"] + dF_dt * (0.5 * dt),
    })
    return out


def saturation_relaxation(porous: State, rp: ReferencePairs,
                          material: PorousMediaSolid, Dt) -> State:
    """SaturationRelaxationInPorousMedia: the Darcy flux from the
    saturation gradient, and the fluid mass from the pairwise divergence
    of s grad s."""
    out = dict(porous)
    D = material.diffusivity_constant
    rho_f = material.fluid_initial_density
    sat = porous["FluidSaturation"]
    vol_j, _ = gather(porous["VolumetricMeasure"], rp.idx)
    sat_j, _ = gather(sat, rp.idx)
    dwV = rp.dW * vol_j * rp.mask
    grad_s = -torch.sum(((sat[:, None] - sat_j) * dwV)[..., None] * rp.e, dim=1)
    div_flux = torch.sum(0.5 * (sat[:, None] ** 2 - sat_j ** 2)
                         / (rp.r + TINY) * dwV, dim=1)

    flux = -D * rho_f * sat[:, None] * grad_s
    dm_dt = D * porous["UpdateVolume"] * rho_f * div_flux

    fluid_mass = porous["FluidMass"] + dm_dt * Dt
    total_mass = material.rho0 * porous["VolumetricMeasure"] + fluid_mass
    saturation = fluid_mass / (rho_f * torch.clamp(porous["UpdateVolume"],
                                                   min=TINY))
    out.update({
        "RelativeFluidFlux": flux, "FluidMassIncrement": dm_dt,
        "FluidMass": fluid_mass, "TotalMass": total_mass,
        "FluidSaturation": saturation,
    })
    return out


def saturation_time_step(material: PorousMediaSolid, smoothing_length: float,
                         dim: int) -> float:
    """GetSaturationTimeStepSize: 0.5 h^2 / D / dim."""
    return 0.5 * smoothing_length ** 2 / material.diffusivity_constant / dim


def porous_momentum_constraint(porous: State, mask) -> State:
    """MomentumConstraint: zero the total momentum on a body part."""
    out = dict(porous)
    out["TotalMomentum"] = torch.where(mask[:, None],
                                       torch.zeros_like(porous["TotalMomentum"]),
                                       porous["TotalMomentum"])
    return out
