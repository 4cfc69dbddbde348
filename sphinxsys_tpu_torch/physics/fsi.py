"""Fluid-structure interaction bookkeeping (counterpart of
sphinxsys_tpu/physics/fsi.py; reference solid_dynamics/
fluid_structure_interaction.{h,cpp,hpp} and general_dynamics/
force_prior.hpp): the ForcePrior accumulation, the solid's time-averaged
kinematics that the fluid's wall boundary reads, and the normal update.

The forces on the solid from the fluid come in two forms: over the
solid's (N_s, K) neighbour list of fluid particles here
(`viscous_force_from_fluid`, `pressure_force_from_fluid`, the gather
route), and over its fluid cell windows in physics/fsi_blocks.py (the
block route).
"""

from __future__ import annotations

import torch

from sphinxsys_tpu_torch.core.state import State
from sphinxsys_tpu_torch.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_tpu_torch.physics.pair import pair_geometry

TINY = 1.0e-15


def force_prior_update(state: State, force_name: str,
                       current_force: torch.Tensor) -> State:
    """ForcePrior += F_new - F_prev; store F_new (force_prior.hpp:22-26)."""
    out = dict(state)
    prev_key = "Previous" + force_name
    prev = state.get(prev_key, torch.zeros_like(current_force))
    out["ForcePrior"] = state["ForcePrior"] + current_force - prev
    out[force_name] = current_force
    out[prev_key] = current_force
    return out


def viscous_force_from_fluid(solid: State, fluid: State, nl_sf: NeighborList,
                             kernel, dim: int, mu: float,
                             smoothing_length: float, box=None) -> State:
    """ViscousForceFromFluid (fluid_structure_interaction.cpp):
    F_i = V_i sum_j 2 mu 2 (v_ave_i - v_j) / (r_ij + 0.01 h) dW_ij V_j,
    into ForcePrior."""
    pg = pair_geometry(solid["Position"], fluid["Position"], nl_sf, kernel,
                       dim, need_W=False, box=box)
    vel_j, _ = gather(fluid["Velocity"], nl_sf.idx)
    vol_j, _ = gather(fluid["VolumetricMeasure"], nl_sf.idx)
    vderiv = 2.0 * (solid["AverageVelocity"][:, None, :] - vel_j) \
        / (pg.r + 0.01 * smoothing_length)[..., None]
    force = 2.0 * mu * torch.sum(vderiv * (pg.dW * vol_j)[..., None], dim=1)
    force = force * solid["VolumetricMeasure"][:, None]
    return force_prior_update(solid, "ViscousForceFromFluid", force)


def pressure_force_from_fluid(solid: State, fluid: State, nl_sf: NeighborList,
                              kernel, dim: int, riemann, box=None) -> State:
    """PressureForceFromFluid (fluid_structure_interaction.hpp:31-60): the
    fluid's wall-contact pressure and dissipation terms mirrored onto the
    solid; e_ij points from the fluid particle j to the solid particle i.
    torch.sign, like jnp.sign, is 0 at 0."""
    pg = pair_geometry(solid["Position"], fluid["Position"], nl_sf, kernel,
                       dim, need_W=False, box=box)
    p_j, _ = gather(fluid["Pressure"], nl_sf.idx)
    rho_j, _ = gather(fluid["Density"], nl_sf.idx)
    mass_j, _ = gather(fluid["Mass"], nl_sf.idx)
    vel_j, _ = gather(fluid["Velocity"], nl_sf.idx)
    vol_j, _ = gather(fluid["VolumetricMeasure"], nl_sf.idx)
    fp_j, _ = gather(fluid["ForcePrior"], nl_sf.idx)
    acc_ave = solid["AverageAcceleration"]
    vel_ave = solid["AverageVelocity"]
    n_i = solid["NormalDirection"]

    face_acc = torch.sum((fp_j / torch.clamp(mass_j, min=TINY)[..., None]
                          - acc_ave[:, None, :]) * pg.e, dim=-1)
    p_in_wall = p_j + rho_j * pg.r * torch.clamp(face_acc, min=0.0)
    e_dot_n = torch.sum(pg.e * n_i[:, None, :], dim=-1)
    face_to_fluid_n = -torch.sign(e_dot_n)[..., None] * n_i[:, None, :]
    u_jump = 2.0 * torch.sum((vel_j - vel_ave[:, None, :]) * face_to_fluid_n,
                             dim=-1)
    term = (riemann.dissipative_p_jump(u_jump)[..., None] * face_to_fluid_n
            + (p_in_wall + p_j)[..., None] * pg.e)
    force = -torch.sum(term * (pg.dW * vol_j)[..., None], dim=1)
    force = force * solid["VolumetricMeasure"][:, None]
    return force_prior_update(solid, "PressureForceFromFluid", force)


def initialize_displacement(solid: State) -> State:
    """InitializeDisplacement: the positions before the solid sub-cycling."""
    out = dict(solid)
    out["TemporaryPosition"] = solid["Position"]
    return out


def update_average_velocity_acceleration(solid: State, dt) -> State:
    """UpdateAverageVelocityAndAcceleration: the solid's kinematics averaged
    over the fluid's acoustic step, fed to the fluid's wall boundary."""
    out = dict(solid)
    vel_ave = (solid["Position"] - solid["TemporaryPosition"]) / (dt + TINY)
    out["AverageAcceleration"] = (vel_ave - solid["AverageVelocity"]) \
        / (dt + TINY)
    out["AverageVelocity"] = vel_ave
    return out


def polar_rotation(F: torch.Tensor) -> torch.Tensor:
    """The rotation R of the polar decomposition F = R U of 2 x 2 F (JAX:
    U V^T of the SVD), in closed form: with p = F00 + F11 and
    q = F10 - F01, R = [[p, -q], [q, p]] / sqrt(p^2 + q^2), the SVD's for
    det F > 0, with no solver launch.  fsi2, the only caller, is 2D."""
    if F.shape[-1] != 2:
        raise NotImplementedError("the polar rotation is ported for 2D only")
    p = F[..., 0, 0] + F[..., 1, 1]
    q = F[..., 1, 0] - F[..., 0, 1]
    n = torch.sqrt(p * p + q * q)
    c, s = p / n, q / n
    return torch.stack([torch.stack([c, -s], dim=-1),
                        torch.stack([s, c], dim=-1)], dim=-2)


def update_elastic_normal_direction(solid: State) -> State:
    """UpdateElasticNormalDirection (elastic_dynamics.cpp): the initial
    normal rotated by the polar rotation of F."""
    R = polar_rotation(solid["DeformationGradient"])
    out = dict(solid)
    out["NormalDirection"] = (R * solid["InitialNormalDirection"][..., None, :]
                              ).sum(dim=-1)
    return out
