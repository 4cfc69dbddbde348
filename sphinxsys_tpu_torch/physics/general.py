"""General dynamics (counterpart of sphinxsys_tpu/physics/general.py):
gravity, the energy, speed and quantity reductions, the velocity bound
check, the velocity gradient and vorticity, and wall normals from a
shape."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from sphinxsys_tpu_torch.core.geometry import normals_and_distance
from sphinxsys_tpu_torch.core.linalg import outer_sum
from sphinxsys_tpu_torch.core.state import State, valid_mask
from sphinxsys_tpu_torch.neighbors.neighbor_list import gather
from sphinxsys_tpu_torch.physics.pair import pair_geometry


@dataclasses.dataclass(frozen=True)
class Gravity:
    """Constant gravity field (external_force.h class Gravity)."""

    acceleration: Tuple[float, ...]

    def potential(self, pos):
        g = torch.as_tensor(self.acceleration, dtype=pos.dtype, device=pos.device)
        return (-pos) @ g


def gravity_force(state: State, gravity: Gravity) -> State:
    """GravityForce, a BaseForcePrior (force_prior.hpp): a state that
    carries "GravityForcePrev" takes the delta form ForcePrior += m g -
    prev, so that gravity coexists with the other prior forces; one
    without it the overwrite form ForcePrior = m g, correct where gravity
    is the only prior-force producer (the dambreak)."""
    out = dict(state)
    g = torch.as_tensor(gravity.acceleration, dtype=state["Position"].dtype,
                        device=state["Position"].device)
    force = state["Mass"][:, None] * g[None, :]
    prev = state.get("GravityForcePrev")
    if prev is None:
        out["ForcePrior"] = force
    else:
        out["ForcePrior"] = state["ForcePrior"] + force - prev
        out["GravityForcePrev"] = force
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


def velocity_bound_check(state: State, velocity_bound: float) -> torch.Tensor:
    """A 0-d bool: some real particle moves faster than `velocity_bound`
    (ReduceOR VelocityBoundCheck, general_reduce.h:64)."""
    v2 = torch.sum(state["Velocity"] ** 2, dim=-1)
    return torch.any(valid_mask(state) & (v2 > velocity_bound ** 2))


def quantity_summation(state: State, name: str) -> torch.Tensor:
    """The total of a variable over the real particles
    (ReduceDynamics<QuantitySummation<T>>): a 0-d tensor of a scalar
    field, a (k,) one of an (N, k) field."""
    arr = state[name]
    mask = valid_mask(state)
    if arr.dim() == 2:
        mask = mask[:, None]
    return torch.sum(torch.where(mask, arr, torch.zeros_like(arr)), dim=0)


def velocity_gradient(state: State, nl, kernel, dim: int, box=None,
                      walls=(), distance_from_wall=None) -> torch.Tensor:
    """grad v_i = -sum_j (v_i - v_j) outer dW_ij V_j e_ij, (N, dim, dim).

    `walls`: (wall state, list) pairs add the wall term
    (velocity_gradient.cpp:12-33) against the wall's AverageVelocity.
    `distance_from_wall` (N, dim), the vector from the nearest wall
    surface point to the particle, scales each wall pair's velocity jump
    by 1 - d_w.(d_w - r e) / |d_w|^2, the no-slip condition extrapolated
    from the wall surface to the dummy particle.  The slot sums are
    broadcast sums (`linalg.outer_sum`), not einsum, which the card runs
    as a batched gemm."""
    pos, vel = state["Position"], state["Velocity"]
    pg = pair_geometry(pos, pos, nl, kernel, dim, need_W=False, box=box)
    vel_j, _ = gather(vel, nl.idx)
    vol_j, _ = gather(state["VolumetricMeasure"], nl.idx)
    grad = (pg.dW * vol_j)[..., None] * pg.e
    g = -outer_sum(vel[:, None, :] - vel_j, grad)

    for wstate, wnl in walls:
        pgw = pair_geometry(pos, wstate["Position"], wnl, kernel, dim,
                            need_W=False, box=box)
        wvol, _ = gather(wstate["VolumetricMeasure"], wnl.idx)
        wvel, _ = gather(wstate["AverageVelocity"], wnl.idx)
        gradw = (pgw.dW * wvol)[..., None] * pgw.e
        dvel = vel[:, None, :] - wvel
        if distance_from_wall is not None:
            dw = distance_from_wall
            ddiff = dw[:, None, :] - pgw.r[..., None] * pgw.e
            dw2 = torch.sum(dw * dw, dim=-1) + 1.0e-15
            factor = 1.0 - torch.sum(dw[:, None, :] * ddiff,
                                     dim=-1) / dw2[:, None]
            dvel = factor[..., None] * dvel
        g = g - outer_sum(dvel, gradw)
    return g


def vorticity(state: State, nl, kernel, dim: int, box=None) -> torch.Tensor:
    """The curl of the velocity from `velocity_gradient`
    (InteractionDynamics<VorticityInner>): (N,) in 2D, (N, 3) in 3D."""
    g = velocity_gradient(state, nl, kernel, dim, box)
    if dim == 2:
        return g[:, 1, 0] - g[:, 0, 1]
    return torch.stack([g[:, 2, 1] - g[:, 1, 2],
                        g[:, 0, 2] - g[:, 2, 0],
                        g[:, 1, 0] - g[:, 0, 1]], dim=-1)


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
