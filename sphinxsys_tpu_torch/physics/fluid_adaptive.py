"""Adaptive-smoothing-length WCSPH fluid ops for multi-resolution fluids
(counterpart of sphinxsys_tpu/physics/fluid_adaptive.py; reference
*Adaptive dynamics with ParticleWithLocalRefinement, as in
test_2d_free_stream_around_cylinder_mr): the neighbour-list ops of
physics/fluid.py for per-particle smoothing lengths
h_i = h_ref / SmoothingLengthRatio_i.

Kernel conventions (those of neighbors/multilevel.py and of the adaptive
frozen solid pairs):
  * density summation evaluates W at the particle's own h (the physical
    interpolation, DensitySummationAdaptive);
  * every pair force or gradient evaluates dW at the pair smoothing length
    max(h_i, h_j) (the smaller ratio): symmetric, so the pairwise momentum
    exchange cancels exactly.

The sums run over the (N, K) list's slots in order, holes included (a
hole adds an exact zero), as the JAX package's.
"""

from __future__ import annotations

import torch

from sphinxsys_tpu_torch.core.state import State
from sphinxsys_tpu_torch.neighbors.cell_list import min_image
from sphinxsys_tpu_torch.neighbors.neighbor_list import NeighborList, gather

TINY = 1.0e-15


def _displacement(pos, pos_j, box):
    disp = pos[:, None, :] - pos_j
    if box is not None and any(b > 0 for b in box):
        disp = min_image(disp, box)
    return disp


def _pair(pos, hr, src: State, nl: NeighborList, kernel, dim: int, box):
    """(r, e, dW at the pair h, the pair's h ratio, V_j, mask) of `pos`
    against the source body `src`; r = sqrt(|d|^2 + TINY)."""
    pos_j, mask = gather(src["Position"], nl.idx)
    hr_j, _ = gather(src["SmoothingLengthRatio"], nl.idx)
    vol_j, _ = gather(src["VolumetricMeasure"], nl.idx)
    disp = _displacement(pos, pos_j, box)
    r = torch.sqrt(torch.sum(disp * disp, dim=-1) + TINY)
    e = disp / (r[..., None] + TINY)
    hr_pair = torch.minimum(hr[:, None], hr_j)     # pair h = max(h_i, h_j)
    dW = kernel.dW_adaptive(r, hr_pair, dim) * mask
    return r, e, dW, hr_pair, vol_j, mask


def adaptive_pair(fluid: State, nl: NeighborList, kernel, dim: int,
                  box=None):
    """The shared pair quantities of an inner list: (r, e, dW_pair,
    hr_pair, vol_j, mask)."""
    return _pair(fluid["Position"], fluid["SmoothingLengthRatio"], fluid, nl,
                 kernel, dim, box)


def _own_kernel_sum(pos, hr, src_pos, weight, nl, kernel, dim, box):
    """sum_j weight_j W(r_ij; h_i), r = |d| (no TINY)."""
    pos_j, mask = gather(src_pos, nl.idx)
    w_j, _ = gather(weight, nl.idx)
    disp = _displacement(pos, pos_j, box)
    r = torch.sqrt(torch.sum(disp * disp, dim=-1))
    W = kernel.W_adaptive(r, hr[:, None], dim) * mask
    return torch.sum(w_j * W, dim=1)


def density_summation_adaptive(fluid: State, nl: NeighborList, kernel,
                               dim: int, rho0: float, box=None,
                               wall: State | None = None,
                               nl_wall: NeighborList | None = None,
                               free_surface: bool = False) -> State:
    """rho_i = m_i W(0; h_i) + sum m_j W(r; h_i) (+ rho0 sum_wall W V);
    Vol = m / rho.  `free_surface` clamps rho >= rho0 (a truncated support
    at a surface would read a negative pressure)."""
    pos = fluid["Position"]
    hr = fluid["SmoothingLengthRatio"]
    mass = fluid["Mass"]
    rho = mass * kernel.w0_adaptive(hr, dim) + _own_kernel_sum(
        pos, hr, pos, mass, nl, kernel, dim, box)
    if wall is not None:
        rho = rho + rho0 * density_wall_adaptive(fluid, wall, nl_wall,
                                                 kernel, dim, box)
    if free_surface:
        rho = torch.clamp(rho, min=rho0)
    out = dict(fluid)
    out["Density"] = rho
    out["VolumetricMeasure"] = mass / torch.clamp(rho, min=TINY)
    return out


def acoustic_step_1st_half_adaptive(fluid: State, nl: NeighborList, kernel,
                                    dim: int, eos, riemann, dt, box=None,
                                    wall: State | None = None,
                                    nl_wall: NeighborList | None = None
                                    ) -> State:
    """Integration1stHalf with pair-h kernels: the half-step density and
    position, the pressure force and the Riemann density dissipation, and
    the velocity update."""
    out = dict(fluid)
    rho = fluid["Density"] + fluid["DensityChangeRate"] * (0.5 * dt)
    p = eos.pressure(rho)
    pos = fluid["Position"] + fluid["Velocity"] * (0.5 * dt)
    vol = fluid["VolumetricMeasure"]

    r, e, dW, _, vol_j, mask = _pair(pos, fluid["SmoothingLengthRatio"],
                                     dict(fluid, Position=pos), nl, kernel,
                                     dim, box)
    p_j, _ = gather(p, nl.idx)
    dWV = dW * vol_j
    force = -torch.sum((p[:, None] + p_j)[..., None] * dWV[..., None] * e,
                       dim=1)
    rho_diss = torch.sum(riemann.dissipative_u_jump(p[:, None] - p_j) * dWV,
                         dim=1)
    drho = rho_diss * rho
    if wall is not None:
        fw, dw = acoustic_1st_half_wall_adaptive(fluid, p, rho, pos, wall,
                                                 nl_wall, kernel, dim,
                                                 riemann, box)
        force = force + fw
        drho = drho + dw
    force_total = fluid["Force"] + force * vol[:, None]
    vel = fluid["Velocity"] + (fluid["ForcePrior"] + force_total) \
        / fluid["Mass"][:, None] * dt
    out.update({"Density": rho, "Pressure": p, "Position": pos,
                "Force": force_total, "DensityChangeRate": drho,
                "Velocity": vel})
    return out


def acoustic_step_2nd_half_adaptive(fluid: State, nl: NeighborList, kernel,
                                    dim: int, riemann, dt, box=None,
                                    wall: State | None = None,
                                    nl_wall: NeighborList | None = None
                                    ) -> State:
    """Integration2ndHalf with pair-h kernels: the advective density rate
    added to the 1st half's dissipation, and the velocity-jump dissipation
    force assigned (the next 1st half consumes it,
    fluid_integration.hpp:195)."""
    out = dict(fluid)
    pos = fluid["Position"] + fluid["Velocity"] * (0.5 * dt)
    vel = fluid["Velocity"]
    rho = fluid["Density"]
    vol = fluid["VolumetricMeasure"]

    r, e, dW, _, vol_j, mask = _pair(pos, fluid["SmoothingLengthRatio"],
                                     dict(fluid, Position=pos), nl, kernel,
                                     dim, box)
    vel_j, _ = gather(vel, nl.idx)
    dWV = dW * vol_j
    u_jump = torch.sum((vel[:, None, :] - vel_j) * e, dim=-1)
    drho_dt = fluid["DensityChangeRate"] + rho * torch.sum(u_jump * dWV,
                                                           dim=1)
    p_diss = riemann.dissipative_p_jump(u_jump) * dWV
    force = torch.sum(p_diss[..., None] * e, dim=1)
    if wall is not None:
        fw, dw = acoustic_2nd_half_wall_adaptive(fluid, vel, rho, pos, wall,
                                                 nl_wall, kernel, dim,
                                                 riemann, box)
        force = force + fw
        drho_dt = drho_dt + dw
    force = vol[:, None] * force
    rho_new = rho + drho_dt * (0.5 * dt)
    out.update({"Position": pos, "Density": rho_new,
                "DensityChangeRate": drho_dt, "Force": force})
    return out


def viscous_force_adaptive(fluid: State, nl: NeighborList, kernel, dim: int,
                           mu: float, h_ref: float, box=None,
                           wall: State | None = None,
                           nl_wall: NeighborList | None = None) -> State:
    """The viscous force with the pair h in the regularisation
    r + 0.01 h_pair; folded into ForcePrior by its change since the last
    step (ViscousForcePrev)."""
    r, e, dW, hr_pair, vol_j, mask = adaptive_pair(fluid, nl, kernel, dim,
                                                   box)
    vel_j, _ = gather(fluid["Velocity"], nl.idx)
    h_pair = h_ref / torch.clamp(hr_pair, min=TINY)
    vderiv = (fluid["Velocity"][:, None, :] - vel_j) \
        / (r + 0.01 * h_pair)[..., None]
    force = 2.0 * mu * torch.sum(vderiv * (dW * vol_j)[..., None], dim=1)
    if wall is not None:
        force = force + viscous_wall_adaptive(fluid, wall, nl_wall, kernel,
                                              dim, mu, h_ref, box)
    out = dict(fluid)
    vf = force * fluid["VolumetricMeasure"][:, None]
    prev = fluid.get("ViscousForcePrev")
    out["ViscousForce"] = vf
    out["ForcePrior"] = fluid["ForcePrior"] + vf - (
        torch.zeros_like(vf) if prev is None else prev)
    out["ViscousForcePrev"] = vf
    return out


def transport_velocity_correction_adaptive(fluid: State, nl: NeighborList,
                                           kernel, dim: int, h_ref: float,
                                           coefficient: float = 0.2,
                                           limiter_slope: float = 100.0,
                                           box=None, walls=(),
                                           scope_mask=None) -> State:
    """The shift at the particle's own h^2 scale (the adaptive TVC uses the
    local resolution).  `walls`: (state, list) wall contacts
    (TransportVelocityCorrectionComplexAdaptive); `scope_mask` limits the
    shift (the BulkParticles scope: Indicator == 0)."""
    r, e, dW, _, vol_j, mask = adaptive_pair(fluid, nl, kernel, dim, box)
    inconsistency = -torch.sum((2.0 * dW * vol_j)[..., None] * e, dim=1)
    pos = fluid["Position"]
    hr = fluid["SmoothingLengthRatio"]
    for wstate, nl_w in walls:
        _, ew, dWw, _, volw, _ = _pair(pos, hr, wstate, nl_w, kernel, dim,
                                       box)
        inconsistency = inconsistency - torch.sum(
            (2.0 * dWw * volw)[..., None] * ew, dim=1)
    h_own = h_ref / torch.clamp(hr, min=TINY)
    h2 = h_own * h_own
    sq = torch.sum(inconsistency ** 2, dim=-1)
    lim = torch.clamp(limiter_slope * h2 * sq, max=1.0)
    shift = (coefficient * h2 * lim)[:, None] * inconsistency
    if scope_mask is not None:
        shift = torch.where(scope_mask[:, None], shift,
                            torch.zeros_like(shift))
    out = dict(fluid)
    out["Position"] = pos + shift
    return out


def free_surface_indication_adaptive(fluid: State, nl: NeighborList, kernel,
                                     dim: int, walls=(),
                                     spatial_temporal: bool = False,
                                     box=None) -> State:
    """SpatialTemporalFreeSurfaceIndicationComplex over an adaptive inner
    relation: the position divergence with pair-h kernels, the one-layer
    smear within the particle's own h."""
    pos = fluid["Position"]
    hr = fluid["SmoothingLengthRatio"]
    threshold = 0.75 * dim
    r, e, dW, _, vol_j, mask = adaptive_pair(fluid, nl, kernel, dim, box)
    pos_div = -torch.sum(dW * vol_j * r, dim=1)
    for wstate, nl_w in walls:
        rw, _, dWw, _, volw, _ = _pair(pos, hr, wstate, nl_w, kernel, dim,
                                       box)
        pos_div = pos_div - torch.sum(dWw * volw * rw, dim=1)

    out = dict(fluid)
    if spatial_temporal and "PreviousSurfaceIndicator" in fluid:
        prev = fluid["PreviousSurfaceIndicator"]
        prev_j, mj = gather(prev, nl.idx)
        near_prev = torch.any((prev_j == 1) & mj, dim=1)
        suppress = (pos_div < threshold) & (prev != 1) & ~near_prev
        pos_div = torch.where(suppress, 2.0 * threshold, pos_div)

    is_surface = pos_div < threshold
    surf_j, mj = gather(is_surface, nl.idx)
    h_own = (kernel.h / torch.clamp(hr, min=TINY))[:, None]
    near_surface = torch.any(surf_j & mj & (r < h_own), dim=1)
    indicator = (is_surface | near_surface).to(torch.int32)
    out["Indicator"] = indicator
    out["PositionDivergence"] = pos_div
    out["PreviousSurfaceIndicator"] = indicator
    return out


def density_summation_freestream_adaptive(fluid: State, nl: NeighborList,
                                          kernel, dim: int, rho0: float,
                                          box=None,
                                          wall: State | None = None,
                                          nl_wall: NeighborList | None = None
                                          ) -> State:
    """DensitySummationFreeStreamComplexAdaptive: the adaptive summation,
    then the NearFreeStream blend rho_sum + (rho - rho_sum) rho0 / rho for
    a particle with a surface-indicated neighbour (density_summation.h:
    141-147)."""
    rho_old = fluid["Density"]
    out = density_summation_adaptive(fluid, nl, kernel, dim, rho0, box=box,
                                     wall=wall, nl_wall=nl_wall,
                                     free_surface=False)
    rho_sum = out["Density"]
    ind_j, mj = gather(fluid["Indicator"], nl.idx)
    near_surface = torch.any((ind_j == 1) & mj, dim=1)
    blended = torch.where(rho_sum < rho_old,
                          rho_sum + (rho_old - rho_sum) * rho0 / rho_old,
                          rho_sum)
    rho = torch.where(near_surface, blended, rho_sum)
    out["Density"] = rho
    out["DensitySummation"] = rho_sum   # the free-stream correction weight
    out["VolumetricMeasure"] = fluid["Mass"] / torch.clamp(rho, min=TINY)
    return out


# ---------------------------------------------------------------------------
# Wall contact terms (the adaptive variants of fluid.py's wall sections)
# ---------------------------------------------------------------------------

def _wall_pair(pos, hr, wall: State, nl_w: NeighborList, kernel, dim: int,
               box):
    """(r, e, dW, hr_pair, vol_j, mask) against a wall body."""
    return _pair(pos, hr, wall, nl_w, kernel, dim, box)


def density_wall_adaptive(fluid: State, wall: State, nl_w: NeighborList,
                          kernel, dim: int, box=None):
    """The wall's share of the adaptive density summation: sum W V of the
    wall's dummy particles at the fluid particle's own h."""
    return _own_kernel_sum(fluid["Position"], fluid["SmoothingLengthRatio"],
                           wall["Position"], wall["VolumetricMeasure"], nl_w,
                           kernel, dim, box)


def acoustic_1st_half_wall_adaptive(fluid: State, p, rho, pos, wall: State,
                                    nl_w: NeighborList, kernel, dim: int,
                                    riemann, box=None):
    """(force, drho_dt) wall terms of the adaptive 1st half
    (fluid_integration.hpp:89-113 with the pair kernel)."""
    r, e, dW, _, vol_j, mask = _wall_pair(
        pos, fluid["SmoothingLengthRatio"], wall, nl_w, kernel, dim, box)
    acc_prior = fluid["ForcePrior"] \
        / torch.clamp(fluid["Mass"], min=TINY)[:, None]
    wall_acc, _ = gather(wall["AverageAcceleration"], nl_w.idx)
    dWV = dW * vol_j
    face_acc = torch.sum((acc_prior[:, None, :] - wall_acc) * (-e), dim=-1)
    p_in_wall = p[:, None] + rho[:, None] * r * torch.clamp(face_acc,
                                                            min=0.0)
    force = -torch.sum((p[:, None] + p_in_wall)[..., None]
                       * dWV[..., None] * e, dim=1)
    drho = torch.sum(riemann.dissipative_u_jump(p[:, None] - p_in_wall)
                     * dWV, dim=1) * rho
    return force, drho


def acoustic_2nd_half_wall_adaptive(fluid: State, vel, rho, pos, wall: State,
                                    nl_w: NeighborList, kernel, dim: int,
                                    riemann, box=None):
    """(force, drho_dt) wall terms of the adaptive 2nd half
    (fluid_integration.hpp:205-231)."""
    r, e, dW, _, vol_j, mask = _wall_pair(
        pos, fluid["SmoothingLengthRatio"], wall, nl_w, kernel, dim, box)
    vel_ave, _ = gather(wall["AverageVelocity"], nl_w.idx)
    n_k, _ = gather(wall["NormalDirection"], nl_w.idx)
    dWV = dW * vol_j
    e_dot_n = torch.sum(e * n_k, dim=-1)
    face_n = torch.sign(e_dot_n)[..., None] * n_k
    vel_in_wall = 2.0 * vel_ave - vel[:, None, :]
    dcr = torch.sum(torch.sum((vel[:, None, :] - vel_in_wall) * e, dim=-1)
                    * dWV, dim=1) * rho
    u_jump = 2.0 * torch.sum((vel[:, None, :] - vel_ave) * face_n, dim=-1)
    force = torch.sum((riemann.dissipative_p_jump(u_jump) * dWV)[..., None]
                      * face_n, dim=1)
    return force, dcr


def viscous_wall_adaptive(fluid: State, wall: State, nl_w: NeighborList,
                          kernel, dim: int, mu: float, h_ref: float,
                          box=None):
    """The wall shear of the adaptive viscous force (the doubled jump
    against the wall's averaged velocity)."""
    r, e, dW, hr_pair, vol_j, mask = _wall_pair(
        fluid["Position"], fluid["SmoothingLengthRatio"], wall, nl_w, kernel,
        dim, box)
    vel_ave, _ = gather(wall["AverageVelocity"], nl_w.idx)
    h_pair = h_ref / torch.clamp(hr_pair, min=TINY)
    vderiv = 2.0 * (fluid["Velocity"][:, None, :] - vel_ave) \
        / (r + 0.01 * h_pair)[..., None]
    return 2.0 * mu * torch.sum(vderiv * (dW * vol_j)[..., None], dim=1)
