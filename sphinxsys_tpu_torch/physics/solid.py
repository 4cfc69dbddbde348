"""Total-Lagrangian elastic solid: state, time step and constraint
(counterpart of sphinxsys_tpu/physics/solid.py:374-418; reference
elastic_dynamics.cpp and general_constraint.h).  The pair sweeps of the
lattice engine live in physics/solid_lattice.py."""

from __future__ import annotations

import numpy as np
import torch

from sphinxsys_tpu_torch.core.state import State, make_base_state, valid_mask

TINY = 1.0e-15


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
