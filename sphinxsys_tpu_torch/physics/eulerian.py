"""Eulerian (mesh-free finite-volume) SPH (counterpart of
sphinxsys_tpu/physics/eulerian.py; reference fluid_dynamics/
eulerian_fluid_dynamics/eulerian_fluid_integration.{h,hpp},
eulerian_compressible_fluid_integration.{h,hpp} and
eulerian_riemann_solver.cpp).

The particles are static control volumes; the flux between two of them
takes a Riemann interface state.  The weakly-compressible scheme uses the
acoustic interface state (riemann_solver.h:102-116):

  1st half:  dmom/dt_i = -2 V_i sum_j (rho* v* v*^T + p* I) e_ij dW_ij V_j
             mom += (dmom/dt + F_prior) dt;  v = mom / mass
  2nd half:  dmass/dt_i = -2 V_i sum_j (rho* v*) . e_ij dW_ij V_j
             mass += dmass/dt dt;  rho = mass / V;  p = EoS(rho)

with a wall mirrored as vel_in_wall = 2 v_ave - v_i, the interface taken
along the wall's normal.  The compressible scheme carries the total
energy too and takes the HLLC star state of an ideal gas.

Every select of the JAX package is a `torch.where` here, both branches
evaluated, so each denominator is guarded as there (NaN * 0 is NaN).
"""

from __future__ import annotations

import torch

from sphinxsys_tpu_torch.core.state import (State, make_base_state,
                                            nreal_mask, valid_mask)
from sphinxsys_tpu_torch.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_tpu_torch.physics.pair import pair_geometry

TINY = 1.0e-15


def interface_state(riemann, rho_i, vel_i, p_i, rho_j, vel_j, p_j, e_ij):
    """AcousticRiemannSolver::InterfaceState (riemann_solver.h:102-116)
    over (..., K) pair slots; e_ij points j -> i."""
    rc_i, rc_j = riemann.rho0c0_i, riemann.rho0c0_j
    inv_sum = riemann.inv_rho0c0_sum
    rho_star = (rho_i * rc_i + rho_j * rc_j) * inv_sum
    p_avg = (p_i * rc_j + p_j * rc_i) * inv_sum
    v_avg = (vel_i * rc_i + vel_j * rc_j) * inv_sum
    ul = -torch.sum(e_ij * vel_i, dim=-1)
    ur = -torch.sum(e_ij * vel_j, dim=-1)
    u_jump = ul - ur
    if hasattr(riemann, "_limiter"):
        lim = riemann._limiter(riemann.inv_c0_ave
                               * torch.clamp(u_jump, min=0.0))
    else:
        lim = torch.zeros_like(u_jump)
    p_star = p_avg + 0.5 * riemann.rho0c0_geo_ave * u_jump * lim
    u_diss = 0.5 * (p_i - p_j) * riemann.inv_rho0c0_ave * lim * lim
    v_star = v_avg - e_ij * u_diss[..., None]
    return rho_star, v_star, p_star


def make_eulerian_state(pos, volume, material, dtype, device) -> State:
    """Static control volumes at rest: the base state and Velocity,
    Momentum, Pressure and ForcePrior at zero."""
    state = make_base_state(pos, volume, material.rho0, dtype, device)
    n, dim = state["Position"].shape
    for k in ("Velocity", "Momentum", "ForcePrior"):
        state[k] = torch.zeros((n, dim), dtype=dtype, device=device)
    state["Pressure"] = torch.zeros((n,), dtype=dtype, device=device)
    return state


def _pair_states(state, nl, kernel, dim, box):
    pg = pair_geometry(state["Position"], state["Position"], nl, kernel, dim,
                       need_W=False, box=box)
    rho_j, _ = gather(state["Density"], nl.idx)
    vel_j, _ = gather(state["Velocity"], nl.idx)
    p_j, _ = gather(state["Pressure"], nl.idx)
    vol_j, _ = gather(state["VolumetricMeasure"], nl.idx)
    return pg, rho_j, vel_j, p_j, vol_j


def _own(state):
    return (state["Density"][:, None], state["Pressure"][:, None],
            state["Velocity"][:, None, :], state["VolumetricMeasure"])


def _wall_interface(state, wall, nl_wall, kernel, dim, riemann, box):
    """The wall pairs' geometry, dW V_j and mirrored interface state."""
    rho_i, p_i, vel_i, _ = _own(state)
    pgw = pair_geometry(state["Position"], wall["Position"], nl_wall,
                        kernel, dim, need_W=False, box=box)
    wall_vol, _ = gather(wall["VolumetricMeasure"], nl_wall.idx)
    vel_ave, _ = gather(wall["AverageVelocity"], nl_wall.idx)
    n_k, _ = gather(wall["NormalDirection"], nl_wall.idx)
    vel_in_wall = 2.0 * vel_ave - vel_i
    star = interface_state(riemann, rho_i, vel_i, p_i, rho_i, vel_in_wall,
                           p_i, n_k)
    return pgw, pgw.dW * wall_vol, star


def eulerian_integration_1st_half(state: State, nl: NeighborList, kernel,
                                  dim: int, riemann, dt,
                                  wall: State | None = None,
                                  nl_wall: NeighborList | None = None,
                                  box=None) -> State:
    out = dict(state)
    pg, rho_j, vel_j, p_j, vol_j = _pair_states(state, nl, kernel, dim, box)
    rho_i, p_i, vel_i, vol_i = _own(state)

    rho_s, v_s, p_s = interface_state(riemann, rho_i, vel_i, p_i,
                                      rho_j, vel_j, p_j, pg.e)
    dWV = pg.dW * vol_j
    # (rho* v* v*^T + p* I) e = rho* v* (v*.e) + p* e
    flux = (rho_s * torch.sum(v_s * pg.e, dim=-1))[..., None] * v_s \
        + p_s[..., None] * pg.e
    dmom_dt = -2.0 * vol_i[:, None] * torch.sum(flux * dWV[..., None], dim=1)

    if wall is not None:
        pgw, dWV_w, (rho_s, v_s, p_s) = _wall_interface(
            state, wall, nl_wall, kernel, dim, riemann, box)
        flux = (rho_s * torch.sum(v_s * pgw.e, dim=-1))[..., None] * v_s \
            + p_s[..., None] * pgw.e
        dmom_dt = dmom_dt - 2.0 * vol_i[:, None] * torch.sum(
            flux * dWV_w[..., None], dim=1)

    mom = state["Momentum"] + (dmom_dt + state["ForcePrior"]) * dt
    out["Momentum"] = mom
    out["Velocity"] = mom / state["Mass"][:, None]
    return out


def eulerian_integration_2nd_half(state: State, nl: NeighborList, kernel,
                                  dim: int, riemann, eos, dt,
                                  wall: State | None = None,
                                  nl_wall: NeighborList | None = None,
                                  box=None) -> State:
    out = dict(state)
    pg, rho_j, vel_j, p_j, vol_j = _pair_states(state, nl, kernel, dim, box)
    rho_i, p_i, vel_i, vol_i = _own(state)

    rho_s, v_s, p_s = interface_state(riemann, rho_i, vel_i, p_i,
                                      rho_j, vel_j, p_j, pg.e)
    dWV = pg.dW * vol_j
    dmass_dt = -2.0 * vol_i * torch.sum(
        rho_s * torch.sum(v_s * pg.e, dim=-1) * dWV, dim=1)

    if wall is not None:
        pgw, dWV_w, (rho_s, v_s, p_s) = _wall_interface(
            state, wall, nl_wall, kernel, dim, riemann, box)
        dmass_dt = dmass_dt - 2.0 * vol_i * torch.sum(
            rho_s * torch.sum(v_s * pgw.e, dim=-1) * dWV_w, dim=1)

    mass = state["Mass"] + dmass_dt * dt
    out["Mass"] = mass
    out["Density"] = mass / vol_i
    out["Pressure"] = eos.pressure(out["Density"])
    return out


def eulerian_time_step(state: State, eos, h_min: float, cfl: float = 0.6):
    """cfl h / max(c + |v|) over the valid rows, a 0-d tensor (no host
    read)."""
    c = eos.sound_speed(state["Pressure"], state["Density"])
    speed = torch.linalg.vector_norm(state["Velocity"], dim=-1)
    per = c + speed
    reduced = torch.max(torch.where(valid_mask(state), per,
                                    torch.zeros_like(per)))
    return cfl * h_min / (reduced + TINY)


# ---------------------------------------------------------------------------
# Compressible Eulerian SPH with HLLC Riemann fluxes
# (eulerian_compressible_fluid_integration.{h,hpp}, eulerian_riemann_solver
# .cpp HLLCRiemannSolver)
# ---------------------------------------------------------------------------

def _safe(x):
    """x, kept at least 1e-12 from zero with its sign (0 -> +1e-12)."""
    small = torch.where(x < 0, torch.full_like(x, -1e-12),
                        torch.full_like(x, 1e-12))
    return torch.where(torch.abs(x) < 1e-12, small, x)


def hllc_interface_state(gas, rho_i, vel_i, p_i, E_i, rho_j, vel_j, p_j, E_j,
                         e_ij, limiter: float | None = None):
    """HLLCRiemannSolver::getInterfaceState (eulerian_riemann_solver.cpp:
    26-90): the three-wave HLLC star state of an ideal gas, E the energy
    per volume, e_ij pointing j -> i.

    `limiter` (HLLCWithLimiterRiemannSolver, eulerian_riemann_solver.cpp:
    89-170): the pressure-difference terms of the contact speed and of
    the star pressure are scaled by lim = min(limiter max((ul - ur) /
    c_lr, 0), 1) (lim^2 in s*), which switches the pressure-jump
    dissipation off in smooth low-Mach flow.  The wave speeds are Davis's
    (ul - c_l, ur + c_r), as the JAX package's, not the reference's Roe
    averages."""
    ul = -torch.sum(e_ij * vel_i, dim=-1)
    ur = -torch.sum(e_ij * vel_j, dim=-1)
    c_l = gas.sound_speed(p_i, rho_i)
    c_r = gas.sound_speed(p_j, rho_j)
    s_l = ul - c_l
    s_r = ur + c_r
    denom = rho_j * (s_r - ur) + rho_i * (ul - s_l)
    if limiter is not None:
        clr = (rho_i * c_l + rho_j * c_r) / (rho_i + rho_j)
        lim = torch.clamp(limiter * torch.clamp((ul - ur) / clr, min=0.0),
                          max=1.0)
        dp_scale = lim * lim
    else:
        lim = None
        dp_scale = 1.0
    degenerate = torch.abs(denom) < 1e-14
    s_star_raw = (rho_j * ur * (s_r - ur) + rho_i * ul * (ul - s_l)
                  + (p_i - p_j) * dp_scale) / torch.where(
                      degenerate, torch.ones_like(denom), denom)
    s_avg = 0.5 * (ul + ur)
    s_star = torch.where(degenerate | (s_star_raw < s_l - 1000.0)
                         | (s_star_raw > s_r + 1000.0), s_avg, s_star_raw)

    if limiter is not None:
        # the limited star pressure (eulerian_riemann_solver.cpp:140-143)
        p_star_mid = 0.5 * (p_i + p_j) + 0.5 * lim * (
            rho_i * (s_l - ul) * (s_star - ul)
            + rho_j * (s_r - ur) * (s_star - ur))
        v_star_l = vel_i - e_ij * (s_star - ul)[..., None]
        rho_star_l = rho_i * (s_l - ul) / _safe(s_l - s_star)
        E_star_l = ((s_l - ul) * E_i - p_i * ul
                    + p_star_mid * s_star) / _safe(s_l - s_star)
        v_star_r = vel_j - e_ij * (s_star - ur)[..., None]
        rho_star_r = rho_j * (s_r - ur) / _safe(s_r - s_star)
        E_star_r = ((s_r - ur) * E_j - p_j * ur
                    + p_star_mid * s_star) / _safe(s_r - s_star)
    else:
        p_star_mid = p_i + rho_i * (s_l - ul) * (s_star - ul)
        v_star_l = vel_i - e_ij * (s_star - ul)[..., None]
        rho_star_l = rho_i * (s_l - ul) / _safe(s_l - s_star)
        E_star_l = rho_star_l * (E_i / _safe(rho_i) + (s_star - ul) *
                                 (s_star + p_i / _safe(rho_i * (s_l - ul))))
        v_star_r = vel_j - e_ij * (s_star - ur)[..., None]
        rho_star_r = rho_j * (s_r - ur) / _safe(s_r - s_star)
        E_star_r = rho_star_r * (E_j / _safe(rho_j) + (s_star - ur) *
                                 (s_star + p_j / _safe(rho_j * (s_r - ur))))

    left = 0.0 < s_l
    midl = (s_l <= 0.0) & (0.0 <= s_star)
    midr = (s_star <= 0.0) & (0.0 <= s_r)
    right = s_r < 0.0

    def pick(sl, ml, mr, sr):
        """The region's value, later regions overriding earlier ones (as
        the JAX package's chain of wheres); 0 where none holds."""
        def m(c, x):
            return c[..., None] if x.dim() > c.dim() else c
        out = torch.where(m(left, sl), sl, 0.0 * sl)
        out = torch.where(m(midl, ml), ml, out)
        out = torch.where(m(midr, mr), mr, out)
        return torch.where(m(right, sr), sr, out)

    p_star = pick(p_i, p_star_mid, p_star_mid, p_j)
    v_star = pick(vel_i, v_star_l, v_star_r, vel_j)
    rho_star = pick(rho_i, rho_star_l, rho_star_r, rho_j)
    E_star = pick(E_i, E_star_l, E_star_r, E_j)
    return rho_star, v_star, p_star, E_star


def make_compressible_eulerian_state(pos, volume, gas, rho0, p0, dtype,
                                     device, vel0=None) -> State:
    """Static control volumes carrying mass, momentum and the total
    energy (extensive: E / V enters the Riemann state)."""
    state = make_base_state(pos, volume, 1.0, dtype, device)
    n, dim = state["Position"].shape

    def full(x):
        return torch.as_tensor(x, dtype=dtype, device=device).expand(
            n).clone()

    rho0, p0 = full(rho0), full(p0)
    vel = torch.zeros((n, dim), dtype=dtype, device=device) if vel0 is None \
        else torch.as_tensor(vel0, dtype=dtype, device=device)
    vol = state["VolumetricMeasure"]
    state["Density"] = rho0
    state["Pressure"] = p0
    state["Velocity"] = vel
    state["Mass"] = rho0 * vol
    state["Momentum"] = state["Mass"][:, None] * vel
    e_int = gas.internal_energy(p0, rho0)          # per unit mass
    state["TotalEnergy"] = (rho0 * e_int
                            + 0.5 * rho0 * torch.sum(vel ** 2, -1)) * vol
    state["ForcePrior"] = torch.zeros((n, dim), dtype=dtype, device=device)
    return state


def _hllc_pairs(state, nl, kernel, dim, gas, box, limiter):
    """The inner pairs' HLLC star states, their e and dW V_j."""
    pg, rho_j, vel_j, p_j, vol_j = _pair_states(state, nl, kernel, dim, box)
    rho_i, p_i, vel_i, vol_i = _own(state)
    E_vol = state["TotalEnergy"] / vol_i
    E_j, _ = gather(E_vol, nl.idx)
    star = hllc_interface_state(gas, rho_i, vel_i, p_i, E_vol[:, None],
                                rho_j, vel_j, p_j, E_j, pg.e,
                                limiter=limiter)
    return star, pg.e, pg.dW * vol_j * pg.mask.to(vol_j.dtype)


def compressible_integration_1st_half(state: State, nl: NeighborList, kernel,
                                      dim: int, gas, dt, box=None,
                                      limiter: float | None = None) -> State:
    """EulerianCompressibleIntegration1stHalf with the HLLC flux:
    dmom/dt_i = F_prior - 2 V_i sum_j (rho* v* v*^T + p* I) e dW V_j."""
    out = dict(state)
    (rho_s, v_s, p_s, _), e, dWV = _hllc_pairs(state, nl, kernel, dim, gas,
                                               box, limiter)
    vol_i = state["VolumetricMeasure"]
    flux = (rho_s * torch.sum(v_s * e, dim=-1))[..., None] * v_s \
        + p_s[..., None] * e
    dmom_dt = state["ForcePrior"] - 2.0 * vol_i[:, None] * torch.sum(
        flux * dWV[..., None], dim=1)
    mom = state["Momentum"] + dmom_dt * dt
    out["Momentum"] = mom
    out["Velocity"] = mom / state["Mass"][:, None]
    return out


def compressible_integration_2nd_half(state: State, nl: NeighborList, kernel,
                                      dim: int, gas, dt, box=None,
                                      limiter: float | None = None) -> State:
    """EulerianCompressibleIntegration2ndHalf: the mass and energy fluxes,
    then rho = mass / V and p = (gamma - 1)(E / V - rho |v|^2 / 2)."""
    out = dict(state)
    (rho_s, v_s, p_s, E_s), e, dWV = _hllc_pairs(state, nl, kernel, dim,
                                                 gas, box, limiter)
    vol_i = state["VolumetricMeasure"]
    u_n = torch.sum(v_s * e, dim=-1)
    dmass_dt = -2.0 * vol_i * torch.sum(rho_s * u_n * dWV, dim=1)
    dE_dt = torch.sum(state["ForcePrior"] * state["Velocity"], dim=-1) \
        - 2.0 * vol_i * torch.sum((E_s + p_s) * u_n * dWV, dim=1)

    mass = state["Mass"] + dmass_dt * dt
    E = state["TotalEnergy"] + dE_dt * dt
    rho = mass / vol_i
    vel = state["Momentum"] / mass[:, None]
    rho_e = E / vol_i - 0.5 * torch.sum(vel ** 2, dim=-1) * rho
    out.update({"Mass": mass, "TotalEnergy": E, "Density": rho,
                "Pressure": gas.pressure(rho, rho_e
                                         / torch.clamp(rho, min=TINY))})
    return out


def compressible_time_step(state: State, gas, h_min: float, cfl: float = 0.6,
                           dim: int = 2):
    """EulerianCompressibleAcousticTimeStepSize (eulerian_compressible_
    fluid_integration.cpp:332-340): cfl / dim h / max(c + |v|) over the
    rows below NReal, a 0-d tensor (no host read)."""
    c = gas.sound_speed(state["Pressure"], state["Density"])
    per = c + torch.linalg.vector_norm(state["Velocity"], dim=-1)
    top = torch.max(torch.where(nreal_mask(state), per,
                                torch.zeros_like(per)))
    return (cfl / dim) * h_min / (top + TINY)
