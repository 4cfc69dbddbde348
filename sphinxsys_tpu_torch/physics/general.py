"""General dynamics (counterpart of sphinxsys_tpu/physics/general.py):
gravity, the energy and speed reductions and wall normals from a shape."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from sphinxsys_tpu_torch.core.geometry import normals_and_distance
from sphinxsys_tpu_torch.core.state import State, valid_mask


@dataclasses.dataclass(frozen=True)
class Gravity:
    """Constant gravity field (external_force.h class Gravity)."""

    acceleration: Tuple[float, ...]

    def potential(self, pos):
        g = torch.as_tensor(self.acceleration, dtype=pos.dtype, device=pos.device)
        return (-pos) @ g


def gravity_force(state: State, gravity: Gravity) -> State:
    """ForcePrior = m g — the overwrite form, correct where gravity is the
    only prior-force producer (the dambreak)."""
    out = dict(state)
    g = torch.as_tensor(gravity.acceleration, dtype=state["Position"].dtype,
                        device=state["Position"].device)
    out["ForcePrior"] = state["Mass"][:, None] * g[None, :]
    return out


def total_kinetic_energy(state: State) -> torch.Tensor:
    """Sum over real particles of 0.5 m v^2 (general_reduce.cpp:54-64)."""
    ke = 0.5 * state["Mass"] * torch.sum(state["Velocity"] ** 2, dim=-1)
    return torch.sum(torch.where(valid_mask(state), ke, torch.zeros_like(ke)))


def maximum_speed(state: State) -> torch.Tensor:
    """Largest |v| over real particles (ReduceDynamics<MaximumSpeed>)."""
    v = torch.linalg.vector_norm(state["Velocity"], dim=-1)
    return torch.max(torch.where(valid_mask(state), v, torch.zeros_like(v)))


def total_mechanical_energy(state: State, gravity: Gravity) -> torch.Tensor:
    """Sum over real particles of 0.5 m v^2 + m * potential(pos)
    (general_reduce.cpp:67-78)."""
    ke = 0.5 * state["Mass"] * torch.sum(state["Velocity"] ** 2, dim=-1)
    pe = state["Mass"] * gravity.potential(state["Position"])
    e = ke + pe
    return torch.sum(torch.where(valid_mask(state), e, torch.zeros_like(e)))


def normal_direction_from_shape(state: State, shape) -> State:
    """Store the shape normal and signed distance at each particle
    (general_geometric.cpp:18-26); evaluated on the host in the state's
    dtype, then placed on the state's device."""
    out = dict(state)
    pos = state["Position"]
    n, phi = normals_and_distance(shape, pos.cpu().numpy(), pos.dtype)
    n, phi = n.to(pos.device), phi.to(pos.device)
    out["NormalDirection"] = n
    out["InitialNormalDirection"] = n
    out["SignedDistance"] = phi
    out["InitialSignedDistance"] = phi
    return out
