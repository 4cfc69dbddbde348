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
AverageAcceleration (a static wall's are zero).  Another fluid phase is a
`contacts` entry.  A shell seen as a wall is a `shell_walls` entry
(state, list, shell_fluid.ShellContactPairs) or, in the density
summation, a `shell_contacts` entry (state, list, pairs, the shell's
rho0): the curvature-corrected pairs of physics/shell_fluid.py, built
once an advection step.  A static confinement is a `levelsets` entry: a
meshes/levelset.py LevelSetShape whose kernel integrals stand in for
the missing wall particles (shape_confinement.cpp).
"""

from __future__ import annotations

from typing import Sequence

import torch

from sphinxsys_tpu_torch.core.linalg import det, inv, mv, outer_sum
from sphinxsys_tpu_torch.core.state import State, nreal_mask
from sphinxsys_tpu_torch.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_tpu_torch.physics.pair import pair_geometry
from sphinxsys_tpu_torch.physics.shell_fluid import (
    acoustic_1st_half_shell_term, acoustic_2nd_half_shell_term,
    density_summation_shell_term)

TINY = 1.0e-15

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
             otherwise:    rho = rho_sum ; Vol = m / rho
    `levelsets`: rho_sum += KI(pos) rho0^2 / sigma0 / m_i, the wall
    region's kernel integral (StaticConfinementDensity,
    shape_confinement.cpp:20-25)."""
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
    for s_state, nl_s, s_pairs, s_rho0 in shell_contacts:
        rho_sum = rho_sum + density_summation_shell_term(
            fluid, s_state, s_pairs, nl_s, rho0, sigma0, s_rho0)
    for ls in levelsets:
        ki = ls.compute_kernel_integral(pos)
        rho_sum = rho_sum + ki * rho0 * rho0 / sigma0 / fluid["Mass"]
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
    `wall_riemann` (default `riemann`) dissipates against the walls.
    `correction`: the reverse-kernel-gradient-corrected pressure force
    -(p_i B_j + p_j B_i) e_ij dW_ij V_j, and -(p_i + p_w) B_i e_iw dW V_w
    against a wall (fluid_integration.hpp:75, LinearGradientCorrection),
    B read from fluid["LinearGradientCorrectionMatrix"].
    `contacts`: other fluid phases as (state, list, solver) triples, the
    solver built as (this phase, that phase); the pair takes the
    impedance-weighted pressure average_p(p_i, p_k) and dissipates
    through the solver's u-jump, p_k the other phase's stored Pressure
    (fluid_integration.hpp:132-157, MultiPhase).
    `extra_force`: an (N, d) force added to this half's Force before the
    velocity update (the updated-Lagrangian solid's shear force,
    continuum.ul_shear_force).
    `levelsets`: F -= 2 V_i p_i KGI(pos), the confinement's pressure
    force (StaticConfinementIntegration1stHalf, shape_confinement.cpp:
    39-43)."""
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
    B = fluid["LinearGradientCorrectionMatrix"] if correction else None
    if correction:
        B_j, _ = gather(B, nl_inner.idx)
        Be_i = mv(B[:, None], pg.e)
        Be_j = mv(B_j, pg.e)
        force = -torch.sum((p[:, None, None] * Be_j + p_j[..., None] * Be_i)
                           * dWV[..., None], dim=1)
    else:
        force = -torch.sum(((p[:, None] + p_j) * dWV)[..., None] * pg.e,
                           dim=1)
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
        e_w = mv(B[:, None], pgw.e) if correction else pgw.e
        force_w = -torch.sum(((p[:, None] + p_in_wall) * dWV_w)[..., None]
                             * e_w, dim=1)
        rho_diss_w = torch.sum(
            wr.dissipative_u_jump(p[:, None] - p_in_wall) * dWV_w, dim=1)
        force_total = force_total + force_w * vol[:, None]
        drho_dt = drho_dt + rho_diss_w * rho
    for sstate, snl, spairs in shell_walls:
        force_s, rho_diss_s = acoustic_1st_half_shell_term(
            p, rho, fluid, sstate, spairs, snl, wr)
        force_total = force_total + force_s * vol[:, None]
        drho_dt = drho_dt + rho_diss_s * rho
    for ls in levelsets:
        kgi = ls.compute_kernel_gradient_integral(pos)
        force_total = force_total - 2.0 * (p * vol)[:, None] * kgi

    # --- interaction: fluid-fluid contacts (hpp:132-157) -------------------
    # the other phase's stored Pressure: its own last first half wrote it
    for cstate, cnl, crs in contacts:
        pgc = pair_geometry(pos, cstate["Position"], cnl, kernel, dim,
                            need_W=False, box=box)
        vol_k, _ = gather(cstate["VolumetricMeasure"], cnl.idx)
        p_k, _ = gather(cstate["Pressure"], cnl.idx)
        dWV_c = pgc.dW * vol_k
        p_star = crs.average_p(p[:, None], p_k)
        force_c = -torch.sum((2.0 * p_star * dWV_c)[..., None] * pgc.e, dim=1)
        rho_diss_c = torch.sum(
            crs.dissipative_u_jump(p[:, None] - p_k) * dWV_c, dim=1)
        force_total = force_total + force_c * vol[:, None]
        drho_dt = drho_dt + rho_diss_c * rho

    # --- update -----------------------------------------------------------
    if extra_force is not None:
        force_total = force_total + extra_force
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
    """`contacts`: other fluid phases as (state, list, solver) triples:
    the density change against the impedance-averaged velocity
    average_v(v_i, v_k) and the p-jump of the plain velocity jump
    (fluid_integration.hpp:248-272).
    `levelsets`: drho/dt += 2 rho v_i . KGI(pos), the wall's mirror
    velocity -v_i (StaticConfinementIntegration2ndHalf,
    shape_confinement.cpp:57-62)."""
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
    for sstate, snl, spairs in shell_walls:
        p_diss_s, dcr_s = acoustic_2nd_half_shell_term(
            vel, fluid, sstate, spairs, snl, wr)
        drho_dt = drho_dt + dcr_s * rho
        force = force + p_diss_s * vol[:, None]
    for ls in levelsets:
        kgi = ls.compute_kernel_gradient_integral(pos)
        drho_dt = drho_dt + 2.0 * rho * torch.sum(vel * kgi, dim=-1)

    # --- interaction: fluid-fluid contacts (hpp:248-272) ---------------------
    for cstate, cnl, crs in contacts:
        pgc = pair_geometry(pos, cstate["Position"], cnl, kernel, dim,
                            need_W=False, box=box)
        vol_k, _ = gather(cstate["VolumetricMeasure"], cnl.idx)
        vel_k, _ = gather(cstate["Velocity"], cnl.idx)
        dWV_c = pgc.dW * vol_k
        vel_ave = crs.average_v(vel[:, None, :], vel_k)
        dcr_c = torch.sum(2.0 * torch.sum((vel[:, None, :] - vel_ave) * pgc.e,
                                          dim=-1) * dWV_c, dim=1)
        u_jump_c = torch.sum((vel[:, None, :] - vel_k) * pgc.e, dim=-1)
        p_diss_c = torch.sum((crs.dissipative_p_jump(u_jump_c)
                              * dWV_c)[..., None] * pgc.e, dim=1)
        drho_dt = drho_dt + dcr_c * rho
        force = force + p_diss_c * vol[:, None]

    # --- update --------------------------------------------------------------
    out = dict(fluid)
    out.update({"Position": pos, "DensityChangeRate": drho_dt, "Force": force,
                "Density": rho + drho_dt * (0.5 * dt)})
    return out


# ---------------------------------------------------------------------------
# Time-step criteria (fluid_time_step.cpp)
# ---------------------------------------------------------------------------

def acoustic_time_step(fluid: State, eos, h_min: float, cfl: float = 0.6):
    """dt = CFL h / max(c + |v|) over the rows below NReal
    (fluid_time_step.cpp:21-32), a 0-d tensor.  Like the JAX package's,
    it masks by NReal even where the state carries Alive: dead slots below
    NReal keep their last velocity and still count, clones above it do
    not."""
    c = eos.sound_speed(fluid["Pressure"], fluid["Density"])
    speed = torch.linalg.vector_norm(fluid["Velocity"], dim=-1)
    v = c + speed
    reduced = torch.max(torch.where(nreal_mask(fluid), v, torch.zeros_like(v)))
    return cfl * h_min / (reduced + TINY)


def advection_time_step(fluid: State, h_min: float, speed_ref: float,
                        cfl: float = 0.25):
    """dt = CFL h / max(speed_max, U_ref), the acceleration scale folded
    into speed_max (fluid_time_step.cpp:44-66); over the rows below NReal,
    as `acoustic_time_step`."""
    accel_scale = 4.0 * h_min * torch.linalg.vector_norm(
        fluid["Force"] + fluid["ForcePrior"], dim=-1) / fluid["Mass"]
    v2 = torch.sum(fluid["Velocity"] ** 2, dim=-1)
    v = torch.maximum(v2, accel_scale)
    reduced = torch.max(torch.where(nreal_mask(fluid), v, torch.zeros_like(v)))
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
    F_prev = ViscousForcePrev (zero where the state has none).
    `contacts`: other fluid phases as (state, list, mu_pair) triples, the
    inner form against the phase's own velocity with the pair-harmonic
    viscosity mu_pair = 2 mu_1 mu_2 / (mu_1 + mu_2)
    (viscous_dynamics.hpp:151-190)."""
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

    for cstate, cnl, mu_pair in contacts:
        pgc = pair_geometry(pos, cstate["Position"], cnl, kernel, dim,
                            need_W=False, box=box)
        c_vol, _ = gather(cstate["VolumetricMeasure"], cnl.idx)
        c_vel, _ = gather(cstate["Velocity"], cnl.idx)
        vderiv_c = (vel[:, None, :] - c_vel) / (pgc.r + eps_r)[..., None]
        force = force + 2.0 * mu_pair * torch.sum(
            vderiv_c * (pgc.dW * c_vol)[..., None], dim=1)

    # a shell wall through its corrected pairs (ViscousForce<Contact<Wall>>
    # over ContactRelationFromShellToFluid)
    for sstate, snl, spairs in shell_walls:
        area_k, _ = gather(sstate["VolumetricMeasure"], snl.idx)
        vel_ave_k, _ = gather(sstate["AverageVelocity"], snl.idx)
        vderiv_s = 2.0 * (vel[:, None, :] - vel_ave_k) \
            / (spairs.r + eps_r)[..., None]
        force = force + 2.0 * mu * torch.sum(
            vderiv_s * (spairs.dWV * area_k
                        * spairs.mask.to(force.dtype))[..., None], dim=1)

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
    is None (NoLimiter).  `scope_mask`: only these rows shift (the
    free-stream cases' bulk particles, Indicator == 0).
    `surface_projection` (the cohesive soil's unified correction,
    cohesive_soil_failure.h:128-143): a surface-indicated row shifts only
    tangentially to I / |I| (at a free surface the inward normal), and not
    at all where its PositionDivergence is below 0.6 dim."""
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
    for sstate, snl, spairs in shell_walls:
        area_k, _ = gather(sstate["VolumetricMeasure"], snl.idx)
        inconsistency = inconsistency - torch.sum(
            (2.0 * spairs.dWV * area_k
             * spairs.mask.to(pos.dtype))[..., None] * spairs.e, dim=1)
    h2 = h_ref * h_ref
    shift = coefficient * h2 * inconsistency
    if limiter_slope is not None:
        sq = torch.sum(inconsistency ** 2, dim=-1)
        lim = torch.clamp(limiter_slope * h2 * sq, max=1.0)
        shift = coefficient * h2 * lim[..., None] * inconsistency
    if scope_mask is not None:
        shift = torch.where(scope_mask[:, None], shift, torch.zeros_like(shift))
    if surface_projection:
        nrm = inconsistency / (torch.linalg.vector_norm(
            inconsistency, dim=-1, keepdim=True) + TINY)
        tangential = shift - torch.sum(shift * nrm, dim=-1,
                                       keepdim=True) * nrm
        at_surface = fluid["Indicator"] == 1
        shift = torch.where(at_surface[:, None], tangential, shift)
        deficient = fluid["PositionDivergence"] < 0.6 * dim
        shift = torch.where((at_surface & deficient)[:, None],
                            torch.zeros_like(shift), shift)
    out = dict(fluid)
    out["Position"] = pos + shift
    return out


# ---------------------------------------------------------------------------
# Kernel correction (kernel_correction.h, general_gradient.*)
# ---------------------------------------------------------------------------

def kernel_correction_matrix(fluid: State, nl_inner: NeighborList, kernel,
                             dim: int, wall: State | None = None,
                             nl_wall: NeighborList | None = None,
                             alpha: float = 0.0, box=None) -> State:
    """LinearGradientCorrectionMatrix[Complex]: the local configuration
    A = -sum_j r_ji outer (dW_ij V_j e_ij) over the inner (and the wall's)
    neighbours, regularised by 1e-6 I, then the determinant-weighted
    blend B = w1 inv(A) + w2 I, w1 = det / (det + det_sqr), w2 = det_sqr /
    (det + det_sqr), det_sqr = max(alpha - det, 0): B falls back to the
    identity where the support is deficient (A ~ 1e-6 I) or det <= 0.
    det and inv are the closed forms of core/linalg.py."""
    pos, vol = fluid["Position"], fluid["VolumetricMeasure"]
    pg = pair_geometry(pos, pos, nl_inner, kernel, dim, need_W=False, box=box)
    vol_j, _ = gather(vol, nl_inner.idx)
    gradw = (pg.dW * vol_j)[..., None] * pg.e
    A = -outer_sum(pg.r[..., None] * pg.e, gradw)
    if wall is not None:
        pgw = pair_geometry(pos, wall["Position"], nl_wall, kernel, dim,
                            need_W=False, box=box)
        wvol_j, _ = gather(wall["VolumetricMeasure"], nl_wall.idx)
        gradww = (pgw.dW * wvol_j)[..., None] * pgw.e
        A = A - outer_sum(pgw.r[..., None] * pgw.e, gradww)
    eye = torch.eye(dim, dtype=pos.dtype, device=pos.device)
    A = A + 1.0e-6 * eye
    det_a = det(A)
    det_sqr = torch.clamp(alpha - det_a, min=0.0)
    w1 = det_a / (det_a + det_sqr + TINY)
    w2 = det_sqr / (det_a + det_sqr + TINY)
    out = dict(fluid)
    out["LinearGradientCorrectionMatrix"] = w1[:, None, None] * inv(A) + w2[:, None, None] * eye
    return out


# ---------------------------------------------------------------------------
# Free-surface indication and the free stream (surface_indication.cpp,
# fluid_boundary.h:123-166, density_summation.h:141-183)
# ---------------------------------------------------------------------------

def free_surface_indication(fluid: State, nl_inner: NeighborList, kernel,
                            dim: int, contacts: Sequence[tuple] = (),
                            spatial_temporal: bool = False, box=None,
                            shell_walls: Sequence[tuple] = ()) -> State:
    """FreeSurfaceIndication(SpatialTemporal): Indicator = 1 where the
    position divergence -sum_j dW_ij V_j r_ij (inner and `contacts`,
    (state, list, unused) triples) falls below 0.75 dim, and where a
    neighbour within h is such a particle.  The SpatialTemporal variant
    keeps a would-be surface particle in the bulk when it was bulk last
    step and no neighbour was surface then (surface_indication.cpp:57-90).
    Writes Indicator (int32), PositionDivergence and
    PreviousSurfaceIndicator."""
    pos = fluid["Position"]
    threshold = 0.75 * dim
    pg = pair_geometry(pos, pos, nl_inner, kernel, dim, need_W=False, box=box)
    vol_j, _ = gather(fluid["VolumetricMeasure"], nl_inner.idx)
    pos_div = -torch.sum(pg.dW * vol_j * pg.r, dim=1)
    for c_state, nl_c, _rho0 in contacts:
        pgc = pair_geometry(pos, c_state["Position"], nl_c, kernel, dim,
                            need_W=False, box=box)
        vol_k, _ = gather(c_state["VolumetricMeasure"], nl_c.idx)
        pos_div = pos_div - torch.sum(pgc.dW * vol_k * pgc.r, dim=1)
    for sstate, snl, spairs in shell_walls:
        area_k, _ = gather(sstate["VolumetricMeasure"], snl.idx)
        pos_div = pos_div - torch.sum(spairs.dWV * area_k
                                      * spairs.mask.to(pos_div.dtype)
                                      * spairs.r, dim=1)

    if spatial_temporal and "PreviousSurfaceIndicator" in fluid:
        prev = fluid["PreviousSurfaceIndicator"]
        prev_j, mj = gather(prev, nl_inner.idx)
        near_prev_surface = torch.any((prev_j == 1) & mj, dim=1)
        suppress = (pos_div < threshold) & (prev != 1) & ~near_prev_surface
        pos_div = torch.where(suppress, torch.full_like(pos_div, 2 * threshold),
                              pos_div)

    is_surface = pos_div < threshold
    surf_j, mj = gather(is_surface, nl_inner.idx)
    near_surface = torch.any(surf_j & mj & (pg.r < kernel.h), dim=1)
    indicator = (is_surface | near_surface).to(torch.int32)
    out = dict(fluid)
    out["Indicator"] = indicator
    out["PositionDivergence"] = pos_div
    out["PreviousSurfaceIndicator"] = indicator
    return out


def density_summation_freestream(fluid: State, nl_inner: NeighborList, kernel,
                                 dim: int, rho0: float, sigma0: float,
                                 contacts: Sequence[tuple] = (), box=None,
                                 shell_contacts: Sequence[tuple] = ()) -> State:
    """DensitySummationFreeStreamComplex: the plain summation for the bulk;
    a particle with a surface-indicated neighbour takes the NearFreeStream
    blend rho_sum + (rho - rho_sum) rho0 / rho where rho_sum < rho
    (density_summation.h:141-147); Vol = m / rho."""
    out = density_summation(fluid, nl_inner, kernel, dim, rho0, sigma0,
                            contacts=contacts, free_surface=False, box=box,
                            shell_contacts=shell_contacts)
    rho_sum = out["DensitySummation"]
    rho_old = fluid["Density"]
    ind_j, mj = gather(fluid["Indicator"], nl_inner.idx)
    near_surface = torch.any((ind_j == 1) & mj, dim=1)
    blended = torch.where(rho_sum < rho_old,
                          rho_sum + (rho_old - rho_sum) * rho0 / rho_old,
                          rho_sum)
    rho = torch.where(near_surface, blended, rho_sum)
    out["Density"] = rho
    out["VolumetricMeasure"] = fluid["Mass"] / torch.clamp(rho, min=TINY)
    return out


def free_stream_velocity_correction(fluid: State, u_target, t,
                                    rho0: float) -> State:
    """FreeStreamVelocityCorrection (fluid_boundary.h:129-166): a
    surface-indicated particle blends its streamwise velocity toward the
    target u_target(pos, vel, t), weighted by min(rho_sum, rho0) / rho0."""
    vel = fluid["Velocity"]
    u_free = u_target(fluid["Position"], vel, t)
    w = torch.clamp(fluid["DensitySummation"], max=rho0) / rho0
    vx = u_free + (vel[:, 0] - u_free) * w
    vx = torch.where(fluid["Indicator"] == 1, vx, vel[:, 0])
    return dict(fluid, Velocity=torch.cat([vx[:, None], vel[:, 1:]], dim=-1))
