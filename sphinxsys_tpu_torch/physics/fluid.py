"""Weakly-compressible SPH fluid dynamics on neighbour lists (counterpart
of sphinxsys_tpu/physics/fluid.py; reference fluid_dynamics/
fluid_integration.hpp, density_summation.cpp, fluid_time_step.cpp,
viscous_dynamics.hpp, transport_velocity_correction.hpp).

Every op is a pure function (states, neighbour lists, dt) -> new state:
the pair terms are torch ops over the (N, K) lists of
neighbors/neighbor_list.py, each pair sum a sum over axis 1 in slot
order, so that with the JAX package's lists the sums run in its order.

Scheme (dual half-step pressure / density relaxation,
fluid_integration.hpp):

  1st half, dt = acoustic dt:
    init:     rho += drho_dt dt/2 ; p = EoS(rho) ; x += v dt/2
    interact: F_i = -V_i sum_j (p_i + p_j) dW_ij V_j e_ij
              drho_dt_i = rho_i sum_j UJump(p_i - p_j) dW_ij V_j
              (+ wall terms with p reconstructed in the wall,
               fluid_integration.hpp:89-113)
    update:   v += (F + F_prior) / m dt

  2nd half:
    init:     x += v dt/2
    interact: drho_dt_i += rho_i sum_j (v_i - v_j).e_ij dW_ij V_j
              F_i = V_i sum_j PJump(u_jump) dW_ij V_j e_ij
              (+ wall terms with the mirrored wall velocity,
               fluid_integration.hpp:205-231)
    update:   rho += drho_dt dt/2

A wall is a (state, neighbour list) pair whose state carries Position,
VolumetricMeasure, Mass, NormalDirection, AverageVelocity and
AverageAcceleration (a static wall's are zero).  The arguments the JAX
package takes for cases not ported yet raise NotImplementedError naming
what they need.
"""

from __future__ import annotations

from typing import Sequence

import torch

from sphinxsys_tpu_torch.core.state import State, valid_mask
from sphinxsys_tpu_torch.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_tpu_torch.physics.pair import pair_geometry

TINY = 1.0e-15

# the first module or case of the JAX package that needs each argument
_NEEDS = {
    "shell_contacts": "physics/shell_fluid.py",
    "shell_walls": "physics/shell_fluid.py",
    "levelsets": "meshes/levelset.py",
    "contacts": "the multi-phase cases (the fluid-fluid contact terms)",
    "correction": "the kernel-corrected cases (kernel_correction_matrix)",
    "extra_force": "physics/oldroyd.py",
    "scope_mask": "the free-surface TVC cases (free_surface_indication)",
    "surface_projection": "the cohesive-soil cases",
}


def _unported(**args):
    for name, value in args.items():
        if value:
            raise NotImplementedError(
                f"`{name}` is not ported: it needs {_NEEDS[name]}")


def _walls(wall, nl_wall, walls):
    out = list(walls)
    if wall is not None:
        out.append((wall, nl_wall))
    return out


# ---------------------------------------------------------------------------
# Density by summation (density_summation.cpp)
# ---------------------------------------------------------------------------

def density_summation(fluid: State, nl_inner: NeighborList, kernel, dim: int,
                      rho0: float, sigma0: float,
                      contacts: Sequence[tuple] = (),
                      free_surface: bool = True, box=None,
                      shell_contacts: Sequence[tuple] = (),
                      levelsets: Sequence = ()) -> State:
    """DensitySummationComplex(FreeSurface).  `contacts`: (state, list,
    rho0 of that body) of the wall or solid bodies seen as contact.

    inner:   sigma = W0 + sum W_ij ;  rho_sum = sigma rho0 / sigma0
    contact: rho_sum += [sum W_ik m_k / rho0_k] rho0^2 / sigma0 / m_i
    update:  free surface: rho = max(rho_sum, rho0) (density_summation.hpp:29-32)
             otherwise:    rho = rho_sum ; Vol = m / rho"""
    _unported(shell_contacts=shell_contacts, levelsets=levelsets)
    pos = fluid["Position"]
    pg = pair_geometry(pos, pos, nl_inner, kernel, dim, need_dW=False, box=box)
    sigma = kernel.w0(dim) + torch.sum(pg.W, dim=1)
    rho_sum = sigma * rho0 / sigma0
    for c_state, nl_c, c_rho0 in contacts:
        pgc = pair_geometry(pos, c_state["Position"], nl_c, kernel, dim,
                            need_dW=False, box=box)
        mass_k, _ = gather(c_state["Mass"], nl_c.idx)
        sigma_c = torch.sum(pgc.W * mass_k / c_rho0, dim=1)
        rho_sum = rho_sum + sigma_c * rho0 * rho0 / sigma0 / fluid["Mass"]
    out = dict(fluid)
    out["DensitySummation"] = rho_sum
    if free_surface:
        out["Density"] = torch.clamp(rho_sum, min=rho0)
    else:
        out["Density"] = rho_sum
        out["VolumetricMeasure"] = fluid["Mass"] / rho_sum
    return out


# ---------------------------------------------------------------------------
# Acoustic step, 1st half: pressure relaxation (fluid_integration.hpp:50-113)
# ---------------------------------------------------------------------------

def acoustic_step_1st_half(fluid: State, nl_inner: NeighborList, kernel,
                           dim: int, eos, riemann, dt,
                           wall: State | None = None,
                           nl_wall: NeighborList | None = None,
                           wall_riemann=None, box=None,
                           walls: Sequence[tuple] = (),
                           contacts: Sequence[tuple] = (),
                           correction: bool = False,
                           shell_walls: Sequence[tuple] = (),
                           levelsets: Sequence = (),
                           extra_force=None) -> State:
    """`walls`: wall-type contacts as (state, list) pairs (fsi2: the
    static strips and the elastic insert); `wall` / `nl_wall` is one more,
    kept for the JAX signature (the port's cases pass `walls`).
    `wall_riemann` (default `riemann`) dissipates against the walls."""
    _unported(contacts=contacts, correction=correction,
              shell_walls=shell_walls, levelsets=levelsets,
              extra_force=extra_force is not None)
    # --- initialization -----------------------------------------------
    rho = fluid["Density"] + fluid["DensityChangeRate"] * (0.5 * dt)
    p = eos.pressure(rho)
    pos = fluid["Position"] + fluid["Velocity"] * (0.5 * dt)
    vol = fluid["VolumetricMeasure"]

    # --- interaction: inner ---------------------------------------------
    pg = pair_geometry(pos, pos, nl_inner, kernel, dim, need_W=False, box=box)
    p_j, _ = gather(p, nl_inner.idx)
    vol_j, _ = gather(vol, nl_inner.idx)
    dWV = pg.dW * vol_j
    force = -torch.sum(((p[:, None] + p_j) * dWV)[..., None] * pg.e, dim=1)
    rho_dissipation = torch.sum(
        riemann.dissipative_u_jump(p[:, None] - p_j) * dWV, dim=1)
    drho_dt = rho_dissipation * rho
    force_total = fluid["Force"] + force * vol[:, None]

    # --- interaction: wall contacts (hpp:89-113) --------------------------
    wr = wall_riemann or riemann
    acc_prior = fluid["ForcePrior"] / fluid["Mass"][:, None]
    for wstate, wnl in _walls(wall, nl_wall, walls):
        pgw = pair_geometry(pos, wstate["Position"], wnl, kernel, dim,
                            need_W=False, box=box)
        wall_vol, _ = gather(wstate["VolumetricMeasure"], wnl.idx)
        wall_acc_ave, _ = gather(wstate["AverageAcceleration"], wnl.idx)
        dWV_w = pgw.dW * wall_vol
        # the pressure reconstructed in the wall (hydrostatic projection)
        face_acc = torch.sum((acc_prior[:, None, :] - wall_acc_ave) * (-pgw.e),
                             dim=-1)
        p_in_wall = p[:, None] + rho[:, None] * pgw.r * torch.clamp(face_acc,
                                                                     min=0.0)
        force_w = -torch.sum(((p[:, None] + p_in_wall) * dWV_w)[..., None]
                             * pgw.e, dim=1)
        rho_diss_w = torch.sum(
            wr.dissipative_u_jump(p[:, None] - p_in_wall) * dWV_w, dim=1)
        force_total = force_total + force_w * vol[:, None]
        drho_dt = drho_dt + rho_diss_w * rho

    # --- update -----------------------------------------------------------
    vel = fluid["Velocity"] + (fluid["ForcePrior"] + force_total) \
        / fluid["Mass"][:, None] * dt
    out = dict(fluid)
    out.update({"Density": rho, "Pressure": p, "Position": pos,
                "Force": force_total, "DensityChangeRate": drho_dt,
                "Velocity": vel})
    return out


# ---------------------------------------------------------------------------
# Acoustic step, 2nd half: density relaxation (fluid_integration.hpp:159-231)
# ---------------------------------------------------------------------------

def acoustic_step_2nd_half(fluid: State, nl_inner: NeighborList, kernel,
                           dim: int, riemann, dt,
                           wall: State | None = None,
                           nl_wall: NeighborList | None = None,
                           wall_riemann=None, box=None,
                           walls: Sequence[tuple] = (),
                           contacts: Sequence[tuple] = (),
                           shell_walls: Sequence[tuple] = (),
                           levelsets: Sequence = ()) -> State:
    _unported(contacts=contacts, shell_walls=shell_walls, levelsets=levelsets)
    # --- initialization ---------------------------------------------------
    pos = fluid["Position"] + fluid["Velocity"] * (0.5 * dt)
    vel = fluid["Velocity"]
    rho = fluid["Density"]
    vol = fluid["VolumetricMeasure"]

    # --- interaction: inner -------------------------------------------------
    pg = pair_geometry(pos, pos, nl_inner, kernel, dim, need_W=False, box=box)
    vel_j, _ = gather(vel, nl_inner.idx)
    vol_j, _ = gather(vol, nl_inner.idx)
    dWV = pg.dW * vol_j
    u_jump = torch.sum((vel[:, None, :] - vel_j) * pg.e, dim=-1)
    density_change_rate = torch.sum(u_jump * dWV, dim=1)
    p_dissipation = torch.sum(
        (riemann.dissipative_p_jump(u_jump) * dWV)[..., None] * pg.e, dim=1)
    drho_dt = fluid["DensityChangeRate"] + density_change_rate * rho
    force = p_dissipation * vol[:, None]   # assignment, not += (hpp:195)

    # --- interaction: wall contacts (hpp:205-231) ----------------------------
    wr = wall_riemann or riemann
    for wstate, wnl in _walls(wall, nl_wall, walls):
        pgw = pair_geometry(pos, wstate["Position"], wnl, kernel, dim,
                            need_W=False, box=box)
        wall_vol, _ = gather(wstate["VolumetricMeasure"], wnl.idx)
        vel_ave_k, _ = gather(wstate["AverageVelocity"], wnl.idx)
        n_k, _ = gather(wstate["NormalDirection"], wnl.idx)
        dWV_w = pgw.dW * wall_vol
        e_dot_n = torch.sum(pgw.e * n_k, dim=-1)
        face_to_fluid_n = torch.sign(e_dot_n)[..., None] * n_k
        vel_in_wall = 2.0 * vel_ave_k - vel[:, None, :]
        dcr_w = torch.sum(torch.sum((vel[:, None, :] - vel_in_wall) * pgw.e,
                                    dim=-1) * dWV_w, dim=1)
        u_jump_w = 2.0 * torch.sum((vel[:, None, :] - vel_ave_k)
                                   * face_to_fluid_n, dim=-1)
        p_diss_w = torch.sum((wr.dissipative_p_jump(u_jump_w) * dWV_w)[..., None]
                             * face_to_fluid_n, dim=1)
        drho_dt = drho_dt + dcr_w * rho
        force = force + p_diss_w * vol[:, None]

    # --- update --------------------------------------------------------------
    out = dict(fluid)
    out.update({"Position": pos, "DensityChangeRate": drho_dt, "Force": force,
                "Density": rho + drho_dt * (0.5 * dt)})
    return out


# ---------------------------------------------------------------------------
# Time-step criteria (fluid_time_step.cpp)
# ---------------------------------------------------------------------------

def acoustic_time_step(fluid: State, eos, h_min: float, cfl: float = 0.6):
    """dt = CFL h / max(c + |v|) over the real particles
    (fluid_time_step.cpp:21-32), a 0-d tensor."""
    c = eos.sound_speed(fluid["Pressure"], fluid["Density"])
    speed = torch.linalg.vector_norm(fluid["Velocity"], dim=-1)
    v = c + speed
    reduced = torch.max(torch.where(valid_mask(fluid), v, torch.zeros_like(v)))
    return cfl * h_min / (reduced + TINY)


def advection_time_step(fluid: State, h_min: float, speed_ref: float,
                        cfl: float = 0.25):
    """dt = CFL h / max(speed_max, U_ref), the acceleration scale folded
    into speed_max (fluid_time_step.cpp:44-66)."""
    accel_scale = 4.0 * h_min * torch.linalg.vector_norm(
        fluid["Force"] + fluid["ForcePrior"], dim=-1) / fluid["Mass"]
    v2 = torch.sum(fluid["Velocity"] ** 2, dim=-1)
    v = torch.maximum(v2, accel_scale)
    reduced = torch.max(torch.where(valid_mask(fluid), v, torch.zeros_like(v)))
    speed_max = torch.sqrt(reduced)
    return cfl * h_min / (torch.clamp(speed_max, min=speed_ref) + TINY)


def advection_viscous_time_step(fluid: State, h_min: float, speed_ref: float,
                                rho0: float, mu: float, cfl: float = 0.25):
    """AdvectionViscousTimeStep: the viscous diffusion speed folded into
    U_ref."""
    viscous_speed = mu / rho0 / h_min
    return advection_time_step(fluid, h_min, max(viscous_speed, speed_ref),
                               cfl)


# ---------------------------------------------------------------------------
# Viscous force (viscous_dynamics.hpp, Newtonian inner + wall)
# ---------------------------------------------------------------------------

def viscous_force(fluid: State, nl_inner: NeighborList, kernel, dim: int,
                  mu: float, smoothing_length: float,
                  wall: State | None = None,
                  nl_wall: NeighborList | None = None, box=None,
                  walls: Sequence[tuple] = (),
                  contacts: Sequence[tuple] = (),
                  shell_walls: Sequence[tuple] = ()) -> State:
    """F_i = 2 mu V_i sum_j (v_i - v_j) / (r_ij + 0.01 h) dW_ij V_j (the
    wall terms double the jump against the averaged wall velocity), into
    ForcePrior by the ForcePrior bookkeeping: ForcePrior += F - F_prev,
    F_prev = ViscousForcePrev (zero where the state has none)."""
    _unported(contacts=contacts, shell_walls=shell_walls)
    pos, vel, vol = fluid["Position"], fluid["Velocity"], \
        fluid["VolumetricMeasure"]
    eps_r = 0.01 * smoothing_length

    pg = pair_geometry(pos, pos, nl_inner, kernel, dim, need_W=False, box=box)
    vel_j, _ = gather(vel, nl_inner.idx)
    vol_j, _ = gather(vol, nl_inner.idx)
    vderiv = (vel[:, None, :] - vel_j) / (pg.r + eps_r)[..., None]
    force = 2.0 * mu * torch.sum(vderiv * (pg.dW * vol_j)[..., None], dim=1)

    for wstate, wnl in _walls(wall, nl_wall, walls):
        pgw = pair_geometry(pos, wstate["Position"], wnl, kernel, dim,
                            need_W=False, box=box)
        wall_vol, _ = gather(wstate["VolumetricMeasure"], wnl.idx)
        vel_ave_k, _ = gather(wstate["AverageVelocity"], wnl.idx)
        vderiv_w = 2.0 * (vel[:, None, :] - vel_ave_k) \
            / (pgw.r + eps_r)[..., None]
        force = force + 2.0 * mu * torch.sum(
            vderiv_w * (pgw.dW * wall_vol)[..., None], dim=1)

    out = dict(fluid)
    out["ViscousForce"] = force * vol[:, None]
    prev = fluid.get("ViscousForcePrev")
    if prev is None:
        prev = torch.zeros_like(force)
    out["ForcePrior"] = fluid["ForcePrior"] + out["ViscousForce"] - prev
    out["ViscousForcePrev"] = out["ViscousForce"]
    return out


# ---------------------------------------------------------------------------
# Transport-velocity correction (transport_velocity_correction.hpp:37-67)
# ---------------------------------------------------------------------------

def transport_velocity_correction(fluid: State, nl_inner: NeighborList,
                                  kernel, dim: int, h_ref: float,
                                  coefficient: float = 0.2,
                                  limiter_slope: float | None = None,
                                  wall: State | None = None,
                                  nl_wall: NeighborList | None = None,
                                  box=None, walls: Sequence[tuple] = (),
                                  shell_walls: Sequence[tuple] = (),
                                  scope_mask=None,
                                  surface_projection: bool = False) -> State:
    """Shift positions down the kernel-gradient-integral inconsistency:
        I_i  = -sum_j 2 dW_ij V_j e_ij      (+ the wall terms)
        x_i += coef h^2 limiter(h^2 |I|^2) I_i
    limiter: min(slope x, 1) (TruncatedLinear), or 1 when `limiter_slope`
    is None (NoLimiter)."""
    _unported(shell_walls=shell_walls, scope_mask=scope_mask is not None,
              surface_projection=surface_projection)
    pos, vol = fluid["Position"], fluid["VolumetricMeasure"]
    pg = pair_geometry(pos, pos, nl_inner, kernel, dim, need_W=False, box=box)
    vol_j, _ = gather(vol, nl_inner.idx)
    inconsistency = -torch.sum((2.0 * pg.dW * vol_j)[..., None] * pg.e, dim=1)
    for wstate, wnl in _walls(wall, nl_wall, walls):
        pgw = pair_geometry(pos, wstate["Position"], wnl, kernel, dim,
                            need_W=False, box=box)
        wall_vol, _ = gather(wstate["VolumetricMeasure"], wnl.idx)
        inconsistency = inconsistency - torch.sum(
            (2.0 * pgw.dW * wall_vol)[..., None] * pgw.e, dim=1)
    h2 = h_ref * h_ref
    shift = coefficient * h2 * inconsistency
    if limiter_slope is not None:
        sq = torch.sum(inconsistency ** 2, dim=-1)
        lim = torch.clamp(limiter_slope * h2 * sq, max=1.0)
        shift = coefficient * h2 * lim[..., None] * inconsistency
    out = dict(fluid)
    out["Position"] = pos + shift
    return out


# ---------------------------------------------------------------------------
# Functions with no caller on the ported routes
# ---------------------------------------------------------------------------

def _not_ported(name: str, case: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(f"{name} is not ported: its first caller "
                                  f"is {case}")
    fn.__name__ = name
    fn.__doc__ = f"Not ported (first needed by {case})."
    return fn


kernel_correction_matrix = _not_ported(
    "kernel_correction_matrix", "the kernel-corrected fluid cases")
free_surface_indication = _not_ported(
    "free_surface_indication", "the free-stream and free-surface TVC cases")
density_summation_freestream = _not_ported(
    "density_summation_freestream", "the free-stream cases")
free_stream_velocity_correction = _not_ported(
    "free_stream_velocity_correction", "the free-stream cases")
