"""Dynamic solid-solid contact, penalty repulsion (counterpart of
sphinxsys_tpu/physics/contact.py; reference solid_dynamics/
contact_dynamics/ repulsion_factor_summation.cpp, contact_repulsion.cpp,
contact_friction.h):

  * the repulsion factor, a density-like penetration measure
      contact: sigma_i = sum_k W_ik V_k           (the other body)
      self:    sigma_i = sum_j max(W_ij - W(dp), 0) V_j
      shell:   the self form against a surface body, Gauss-calibrated;
  * the repulsion force (pressure-like penalty, stiffness rho0 c0^2):
      contact: F_i = -V_i k_ave sum_j 2 * 0.5(sigma_i + sigma_j) dW e_ij V_j
      wall:    this body's factor only, the wall's volume;
  * PairwiseFrictionFromWall, pairwise tangential damping against wall
    particles, applied to the velocity.

Torch ops over (N, K) neighbour lists, the sums over the slot axis in slot
order, as the JAX package's XLA-fused jnp (no Pallas kernel there).  The
forces accumulate into ForcePrior through fsi.force_prior_update.
"""

from __future__ import annotations

import functools
import math

import torch

from sphinxsys_tpu_torch.core.state import State
from sphinxsys_tpu_torch.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_tpu_torch.physics.fsi import force_prior_update
from sphinxsys_tpu_torch.physics.pair import pair_geometry

TINY = 1.0e-15


def contact_stiffness(material) -> float:
    """rho0 c0^2 (base_material.h:117); for elastic solids c0 = sqrt(K/rho0)
    so this equals the bulk modulus."""
    c0 = getattr(material, "sound_speed", None)
    if c0 is None:
        raise ValueError("material needs a sound_speed")
    c0 = float(c0)
    return material.rho0 * c0 * c0


def repulsion_factor_contact(solid: State, other: State, nl: NeighborList,
                             kernel, dim: int) -> torch.Tensor:
    """sigma_i = sum_j W_ij V_j over the other body's particles."""
    pg = pair_geometry(solid["Position"], other["Position"], nl, kernel, dim,
                       need_dW=False)
    vol_j, _ = gather(other["VolumetricMeasure"], nl.idx)
    return torch.sum(pg.W * vol_j, dim=1)


def repulsion_factor_self(solid: State, nl_inner: NeighborList, kernel,
                          dim: int, spacing: float) -> torch.Tensor:
    """Self-contact factor with the W(dp) offset so the resting lattice
    reads zero (repulsion_factor_summation.cpp:8-18)."""
    pg = pair_geometry(solid["Position"], solid["Position"], nl_inner, kernel,
                       dim, need_dW=False)
    vol_j, _ = gather(solid["VolumetricMeasure"], nl_inner.idx)
    offset = kernel.W(torch.as_tensor(spacing, dtype=pg.W.dtype), dim).item()
    w_corr = torch.clamp(pg.W - offset, min=0.0) * pg.mask
    return torch.sum(w_corr * vol_j, dim=1)


def repulsion_force_contact(solid: State, other: State, nl: NeighborList,
                            kernel, dim: int, factor_self, factor_other,
                            stiffness_ave: float,
                            force_name: str = "RepulsionForce") -> State:
    """Cross-body penalty force (contact_repulsion.cpp:52-75)."""
    pg = pair_geometry(solid["Position"], other["Position"], nl, kernel, dim,
                       need_W=False)
    vol_j, _ = gather(other["VolumetricMeasure"], nl.idx)
    sig_j, _ = gather(factor_other, nl.idx)
    sigma_star = 0.5 * (factor_self[:, None] + sig_j)
    force = -torch.sum((2.0 * sigma_star * pg.dW * vol_j)[..., None] * pg.e,
                       dim=1)
    force = stiffness_ave * force * solid["VolumetricMeasure"][:, None]
    return force_prior_update(solid, force_name, force)


def repulsion_force_wall(solid: State, wall: State, nl: NeighborList, kernel,
                         dim: int, factor_self, stiffness: float,
                         impedance: float = 0.0,
                         force_name: str = "RepulsionForce") -> State:
    """Penalty force against a rigid wall (contact_repulsion.cpp, the Wall
    variant): p_i = sigma_i * stiffness; an optional acoustic impedance
    damping rho0 c0 du (the self-contact variant's)."""
    pg = pair_geometry(solid["Position"], wall["Position"], nl, kernel, dim,
                       need_W=False)
    vol_j, _ = gather(wall["VolumetricMeasure"], nl.idx)
    p_i = factor_self * stiffness
    term = 2.0 * p_i[:, None]
    if impedance > 0.0:
        vel_j, _ = gather(wall["Velocity"], nl.idx)
        du = torch.sum((solid["Velocity"][:, None, :] - vel_j) * (-pg.e),
                       dim=-1)
        term = term + 2.0 * 0.5 * impedance * du
    force = -torch.sum((term * pg.dW * vol_j)[..., None] * pg.e, dim=1)
    force = force * solid["VolumetricMeasure"][:, None]
    return force_prior_update(solid, force_name, force)


def dynamic_contact_force_with_wall(solid: State, wall: State,
                                    nl: NeighborList, kernel, dim: int,
                                    material, spacing_solid: float,
                                    spacing_wall: float,
                                    penalty_strength: float = 1.0) -> State:
    """DynamicContactForceWithWall (high-velocity impact contact, the
    case-local class of test_3d_taylor_bar_UL/taylor_bar_UL.h:69-135): an
    acoustic-impedance term 0.5 rho0 c0 (v_i - v_j).(-n_j) plus a quadratic
    penetration penalty once the particle comes within half a wall spacing
    of a wall particle along its normal.

    As in the reference, the force is added to ForcePrior as it is, every
    call, with no previous-force subtraction: the caller passes the
    persistent ForcePrior through the acoustic loop.  The stiffness,
    impedance and reference pressure are the reference case's:
    rho0 c0^2, rho0 sqrt(stiffness) and rho0 stiffness."""
    stiffness = material.rho0 * material.c0 ** 2
    impedance = material.rho0 * math.sqrt(stiffness)
    reference_pressure = material.rho0 * stiffness
    ratio2 = 0.1 * (spacing_wall / spacing_solid) ** 2

    pg = pair_geometry(solid["Position"], wall["Position"], nl, kernel, dim,
                       need_W=False)
    vol_j, _ = gather(wall["VolumetricMeasure"], nl.idx)
    vel_j, _ = gather(wall["Velocity"], nl.idx)
    n_j, _ = gather(wall["NormalDirection"], nl.idx)
    v_rel = solid["Velocity"][:, None, :] - vel_j
    impedance_p = 0.5 * impedance * torch.sum(v_rel * (-n_j), dim=-1)
    e_dot_n = torch.sum(pg.e * n_j, dim=-1)
    overlap = pg.r * e_dot_n
    delta = 2.0 * overlap / spacing_wall
    beta = torch.where(delta < 1.0, (1.0 - delta) ** 2 * ratio2,
                       torch.zeros_like(delta))
    penalty_p = penalty_strength * beta * torch.abs(overlap) * reference_pressure
    force = -torch.sum((2.0 * (impedance_p + penalty_p) * e_dot_n
                        * pg.dW * vol_j)[..., None] * n_j, dim=1)
    out = dict(solid)
    out["ForcePrior"] = solid["ForcePrior"] + \
        force * solid["VolumetricMeasure"][:, None]
    return out


def filter_self_contact_pairs(nl: NeighborList, pos0, cutoff: float
                              ) -> NeighborList:
    """NeighborBuilderSelfContact (neighborhood.cpp:128-141): keep only
    pairs whose INITIAL separation exceeds the kernel cutoff — material
    neighbours never register as self contact, whatever the deformation.
    Filtered slots get the sentinel index."""
    n = pos0.shape[0]
    p0_j, mask = gather(pos0, nl.idx)
    d0 = torch.linalg.vector_norm(pos0[:, None, :] - p0_j, dim=-1)
    keep = mask & (d0 > cutoff)
    idx = torch.where(keep, nl.idx, torch.full_like(nl.idx, n))
    return NeighborList(idx=idx, count=torch.sum(keep, dim=1).to(nl.count.dtype),
                        overflow=nl.overflow)


def repulsion_force_self(solid: State, nl_self: NeighborList, kernel,
                         dim: int, factor, rho0: float, stiffness: float,
                         force_name: str = "RepulsionForce") -> State:
    """SelfContactForce = RepulsionForce<Contact<Inner<>>>
    (contact_repulsion.cpp:17-32): a symmetric pressure-like penalty over
    the self-contact pairs plus acoustic impedance damping
    Z = sqrt(rho0 * ContactStiffness) on the pair-normal velocity jump."""
    pg = pair_geometry(solid["Position"], solid["Position"], nl_self, kernel,
                       dim, need_W=False)
    vol_j, _ = gather(solid["VolumetricMeasure"], nl_self.idx)
    sig_j, _ = gather(factor, nl_self.idx)
    vel_j, _ = gather(solid["Velocity"], nl_self.idx)
    p_star = 0.5 * (factor[:, None] + sig_j) * stiffness
    z = math.sqrt(rho0 * stiffness)
    du = torch.sum((solid["Velocity"][:, None, :] - vel_j) * (-pg.e), dim=-1)
    term = p_star + 0.5 * z * du
    force = -torch.sum((2.0 * term * pg.dW * vol_j)[..., None] * pg.e, dim=1)
    force = force * solid["VolumetricMeasure"][:, None]
    return force_prior_update(solid, force_name, force)


def pairwise_friction_from_wall(solid: State, wall: State, nl: NeighborList,
                                kernel, dim: int, eta: float, dt) -> State:
    """PairwiseFrictionFromWall (contact_friction.h:49): pairwise
    tangential damping against wall particles, applied to the velocity in
    an implicit (saturating) Jacobi form, v' = (v + sum c w) / (1 + sum c),
    so that eta -> inf removes at most the whole pairwise tangential jump
    (the reference gets the same boundedness from its pair-by-pair
    sweep).  `dt` may be a 0-d tensor."""
    pg = pair_geometry(solid["Position"], wall["Position"], nl, kernel, dim,
                       need_W=False)
    vol_j, _ = gather(wall["VolumetricMeasure"], nl.idx)
    vel_j, _ = gather(wall["Velocity"], nl.idx)
    dvel = solid["Velocity"][:, None, :] - vel_j
    # the tangential part of the jump, relative to the pair direction
    normal_part = torch.sum(dvel * pg.e, dim=-1)[..., None] * pg.e
    tangential = dvel - normal_part
    coeff = -2.0 * eta * pg.dW * vol_j * dt / torch.clamp(
        solid["Mass"], min=TINY)[:, None]
    coeff = torch.clamp(coeff, min=0.0) * pg.mask
    denom = 1.0 + torch.sum(coeff, dim=1)
    dv = -torch.sum(coeff[..., None] * tangential, dim=1) / denom[:, None]
    out = dict(solid)
    out["Velocity"] = solid["Velocity"] + dv
    return out


GAUSS_3_POINTS = (0.0, 0.7745966692414834, -0.7745966692414834)
GAUSS_3_WEIGHTS = (0.8888888888888889, 0.5555555555555556, 0.5555555555555556)


@functools.cache
def shell_calibration(kernel, dim: int, dp_avg: float, dtype):
    """(offset W(dp_avg), calibration 1 / contact_max) of the shell
    contact factor, formed on the host in the state's dtype, as the JAX
    package forms them at compile time: contact_max is the
    Gauss-integrated kernel sum a flat, fully resolved shell gives at zero
    separation.  Returns Python floats holding the dtype's values (cached:
    a case calls it every step with the same arguments)."""
    def w(x):
        return kernel.W(torch.as_tensor(x, dtype=dtype), dim)

    offset = w(dp_avg)
    contact_max = torch.zeros((), dtype=dtype)
    for gp, gw in zip(GAUSS_3_POINTS, GAUSS_3_WEIGHTS):
        t = gp * dp_avg * 0.5 + dp_avg * 0.5
        c = 2.0 * (w(t) - offset) * dp_avg * 0.5 * gw
        contact_max = contact_max + (c if dim == 2 else c * math.pi * t)
    calibration = 1.0 / (contact_max + TINY)
    return offset.item(), calibration.item()


def shell_contact_factor(solid: State, shell: State, nl: NeighborList,
                         kernel, dim: int, spacing: float,
                         shell_spacing: float | None = None,
                         heuristic_limiter: float = 0.1) -> torch.Tensor:
    """ShellContactFactor (repulsion_factor_summation.cpp:52-104): the
    penetration measure against a surface (shell) body.  The kernel sum is
    offset by W(dp_avg) and rescaled by the calibration 1 / contact_max,
    so the factor is ~1 at touch, then damped by the heuristic limiter 0.1
    (a largest contact pressure of 0.1 K)."""
    dp_shell = spacing if shell_spacing is None else shell_spacing
    dp_avg = 0.5 * (spacing + dp_shell)
    offset, calibration = shell_calibration(kernel, dim, dp_avg,
                                            solid["Position"].dtype)
    pg = pair_geometry(solid["Position"], shell["Position"], nl, kernel, dim,
                       need_dW=False)
    vol_j, _ = gather(shell["VolumetricMeasure"], nl.idx)
    sigma = torch.sum(torch.clamp(pg.W - offset, min=0.0) * vol_j * pg.mask,
                      dim=1)
    return heuristic_limiter * sigma * calibration
