"""Fluid-structure interaction bookkeeping (counterpart of
sphinxsys_tpu/physics/fsi.py; reference solid_dynamics/
fluid_structure_interaction.{h,cpp,hpp} and general_dynamics/
force_prior.hpp): the ForcePrior accumulation, the solid's time-averaged
kinematics that the fluid's wall boundary reads, and the normal update.

The forces on the solid from a block-layout fluid are
physics/fsi_blocks.py's.  The neighbour-list couplings of the JAX package
(`viscous_force_from_fluid`, `pressure_force_from_fluid`) are not ported:
they need its gather-path fluid (physics/fluid.py).
"""

from __future__ import annotations

import torch

from sphinxsys_tpu_torch.core.state import State

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
