"""Pulsatile (Womersley) Poiseuille flow driven by pressure boundaries
(counterpart of sphinxsys_tpu/cases/pulsatile_poiseuille_2d.py; reference
tests/extra_source_and_tests/2d_examples/
test_2d_pulsatile_poiseuille_flow/pulsatile_poiseuille_flow.cpp): a 4:1
channel whose flow is driven only by the pressure conditions of two
bidirectional buffers, p = P cos(omega t) at the inlet and p = 0 at the
outlet.  The flow accelerates, stalls and reverses every half period;
the buffers (physics/boundary.bidirectional_buffer_exchange) delete and
clone particles for either direction.

The oracle is the exact start-from-rest solution of the oscillating
pressure gradient between the plates (`womersley_startup_velocity`), and
its late-time limit, the Womersley profile (`womersley_velocity`).

    case, fluid = build_case(n_across=8, device="cpu")
    sim = make_run_chunk(case)(init_sim(case, fluid), 1e-3)
    print(centerline_velocity(case, sim), n_alive(sim))
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.materials import WeaklyCompressibleFluid
from sphinxsys_tpu_torch.core.state import make_fluid_state, make_solid_state
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.neighbors.cell_list import (CellGrid, CellTable,
                                                    build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list)
from sphinxsys_tpu_torch.physics import boundary as bdy
from sphinxsys_tpu_torch.physics import fluid as fd
from sphinxsys_tpu_torch.physics import riemann as rs
from sphinxsys_tpu_torch.physics import windkessel as wk
from sphinxsys_tpu_torch.solver import chunk_runner


@dataclasses.dataclass
class SimState:
    fluid: dict
    nl_inner: NeighborList
    nl_wall: NeighborList
    time: torch.Tensor
    n_adv: int
    n_ac: int
    overflow: torch.Tensor


@dataclasses.dataclass(frozen=True)
class PulsatileCase:
    dx: float
    dl: float
    dh: float
    rho0: float
    mu: float
    omega: float
    p_amp: float
    u_ref: float
    adaptation: SPHAdaptation
    grid: CellGrid
    eos: WeaklyCompressibleFluid
    riemann: rs.AcousticRiemannSolver
    no_riemann: rs.NoRiemannSolver
    wall: dict
    wall_table: CellTable
    buf_l: bdy.AlignedBoxRegion
    buf_r: bdy.AlignedBoxRegion
    n_fluid: int
    cell_cap: int
    k_inner: int
    k_wall: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dl: float = 0.004, dh: float = 0.001, rho0: float = 1000.0,
               p_amp: float = 0.1, re: float = 50.0, omega: float = 1.0,
               n_across: int = 20, dtype=PRODUCTION_DTYPE, cell_cap: int = 24,
               k_inner: int = 40, k_wall: int = 24,
               reserve_factor: float = 1.6, device="cuda"):
    """The fluid at rest in the channel with reserve_factor times its
    particles in rows and its Alive mask; the walls; the 5 dx buffers just
    inside each end (cpp:40-42).  mu comes from the steady-Poiseuille Re
    (cpp:34).  Returns (case, fluid)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    dx = dh / n_across
    mu = float(np.sqrt(rho0 * (0.5 * dh) ** 3 * p_amp / (re * dl)))
    u_ref = (0.5 * dh) ** 2 * p_amp / (2.0 * mu * dl)
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    xs = np.arange(dx / 2, dl, dx)
    ys = np.arange(dx / 2, dh, dx)
    pos = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    cap = int(reserve_factor * len(pos))
    fluid = make_fluid_state(pos, dx * dx, rho0, dtype, device, capacity=cap)
    fluid = bdy.ensure_alive_mask(fluid)
    fluid["_InjectionOverflow"] = torch.zeros((), dtype=torch.bool,
                                              device=device)
    fluid["ViscousForce"] = torch.zeros_like(fluid["Velocity"])
    fluid["ViscousForcePrev"] = torch.zeros_like(fluid["Velocity"])

    bw = 4 * dx
    wx = np.arange(-bw + dx / 2, dl + bw, dx)
    wy = np.arange(dx / 2, bw, dx)
    bot = np.stack(np.meshgrid(wx, -wy, indexing="ij"), -1).reshape(-1, 2)
    top = np.stack(np.meshgrid(wx, dh + wy, indexing="ij"), -1).reshape(-1, 2)
    wall = make_solid_state(np.concatenate([bot, top]), dx * dx, rho0, dtype,
                            device)
    normals = np.concatenate([np.tile([0.0, 1.0], (len(bot), 1)),
                              np.tile([0.0, -1.0], (len(top), 1))])
    wall["NormalDirection"] = torch.as_tensor(normals, dtype=dtype,
                                              device=device)
    grid = grid_from_bounds((-bw - dx, -(bw + dx)),
                            (dl + bw + dx, dh + bw + dx), adaptation.cutoff)
    eos = WeaklyCompressibleFluid(rho0=rho0, c0=10.0 * u_ref)
    case = PulsatileCase(
        dx=dx, dl=dl, dh=dh, rho0=rho0, mu=mu, omega=omega, p_amp=p_amp,
        u_ref=u_ref, adaptation=adaptation, grid=grid, eos=eos,
        riemann=rs.acoustic_riemann(eos), no_riemann=rs.no_riemann(eos),
        wall=wall, wall_table=build_cell_table(wall["Position"],
                                               wall["NReal"], grid, cell_cap),
        buf_l=bdy.AlignedBoxRegion(lower=(0.0, 0.0), upper=(5 * dx, dh)),
        buf_r=bdy.AlignedBoxRegion(lower=(dl - 5 * dx, 0.0), upper=(dl, dh)),
        n_fluid=cap, cell_cap=cell_cap, k_inner=k_inner, k_wall=k_wall)
    return case, fluid


def rebuild_lists(case: PulsatileCase, fluid: dict):
    """The live rows' (inner, wall) lists."""
    pos, alive = fluid["Position"], fluid["Alive"]
    cutoff = case.adaptation.cutoff
    table = build_cell_table(pos, alive, case.grid, case.cell_cap)
    nl = build_neighbor_list(pos, alive, pos, alive, table, case.grid,
                             cutoff, k_max=case.k_inner, include_self=False)
    nlw = build_neighbor_list(pos, alive, case.wall["Position"],
                              case.wall["NReal"], case.wall_table, case.grid,
                              cutoff, k_max=case.k_wall, include_self=False)
    return nl, nlw


def init_sim(case: PulsatileCase, fluid: dict) -> SimState:
    nl, nlw = rebuild_lists(case, fluid)
    pos = fluid["Position"]
    return SimState(fluid=dict(fluid), nl_inner=nl, nl_wall=nlw,
                    time=torch.zeros((), dtype=pos.dtype, device=pos.device),
                    n_adv=0, n_ac=0,
                    overflow=torch.zeros((), dtype=torch.bool,
                                         device=pos.device))


def inlet_pressure(case: PulsatileCase, t):
    """LeftInflowPressure (cpp:52-58): p = P cos(omega t)."""
    return case.p_amp * torch.cos(case.omega * t)


def advection_prep(case: PulsatileCase, s: SimState) -> dict:
    """The clamped density summation and its pressure, the viscous force
    and the limited transport correction of the bulk between the
    buffers."""
    kernel, h, wall = case.kernel, case.adaptation.h, case.wall
    fluid = fd.density_summation(s.fluid, s.nl_inner, kernel, 2, case.rho0,
                                 case.adaptation.sigma0,
                                 contacts=[(wall, s.nl_wall, case.rho0)],
                                 free_surface=True)
    fluid["Pressure"] = case.eos.pressure(fluid["Density"])
    fluid = fd.viscous_force(fluid, s.nl_inner, kernel, 2, case.mu, h,
                             wall=wall, nl_wall=s.nl_wall)
    x = fluid["Position"][:, 0]
    bulk = (x > 5 * case.dx) & (x < case.dl - 5 * case.dx)
    return fd.transport_velocity_correction(
        fluid, s.nl_inner, kernel, 2, h, limiter_slope=100.0, wall=wall,
        nl_wall=s.nl_wall, scope_mask=bulk)


def pressure_conditions(case: PulsatileCase, s: SimState, f: dict, t_now,
                        dt) -> dict:
    """Both buffers' PressureCondition velocity (pressure_boundary.h:
    61-72): the cut-support compensation of p(t_now) at the inlet and of
    0 at the outlet, and the flow-axis alignment."""
    ksum = wk.kernel_gradient_sum(f, s.nl_inner, case.kernel, 2,
                                  contacts=[(case.wall, s.nl_wall)])
    f = wk.pressure_condition_velocity(f, case.buf_l,
                                       inlet_pressure(case, t_now), dt, ksum)
    return wk.pressure_condition_velocity(f, case.buf_r, 0.0, dt, ksum)


def acoustic_substep(case: PulsatileCase, s: SimState, f: dict, dt_adv,
                     t_now):
    """The first half, the pressure conditions at t_now, the second half.
    Returns (fluid, dt)."""
    kernel, h, wall = case.kernel, case.adaptation.h, case.wall
    dt = torch.minimum(fd.acoustic_time_step(f, case.eos, h), dt_adv)
    f = fd.acoustic_step_1st_half(f, s.nl_inner, kernel, 2, case.eos,
                                  case.riemann, dt, wall=wall,
                                  nl_wall=s.nl_wall)
    f = pressure_conditions(case, s, f, t_now, dt)
    f = fd.acoustic_step_2nd_half(f, s.nl_inner, kernel, 2, case.riemann, dt,
                                  wall=wall, nl_wall=s.nl_wall)
    return f, dt


def buffer_exchange(case: PulsatileCase, fluid: dict, pos_prev) -> dict:
    """Both bidirectional buffers, crossings from pos_prev."""
    fluid = bdy.bidirectional_buffer_exchange(fluid, case.buf_l, inward=+1,
                                              prev_pos=pos_prev)
    return bdy.bidirectional_buffer_exchange(fluid, case.buf_r, inward=-1,
                                             prev_pos=pos_prev)


def _advection_step(case: PulsatileCase, s: SimState) -> SimState:
    pos_prev = s.fluid["Position"]
    dt_adv = fd.advection_viscous_time_step(s.fluid, case.adaptation.h,
                                            2.0 * case.u_ref, case.rho0,
                                            case.mu)
    fluid = advection_prep(case, s)
    relax_t = torch.zeros_like(dt_adv)
    n_ac = 0
    while bool(relax_t < dt_adv):          # one host read per sub-step
        fluid, dt = acoustic_substep(case, s, fluid, dt_adv, s.time + relax_t)
        relax_t = relax_t + dt
        n_ac += 1
    fluid = buffer_exchange(case, fluid, pos_prev)
    nl, nlw = rebuild_lists(case, fluid)
    return SimState(fluid=fluid, nl_inner=nl, nl_wall=nlw,
                    time=s.time + relax_t, n_adv=s.n_adv + 1,
                    n_ac=s.n_ac + n_ac,
                    overflow=s.overflow | nl.overflow | nlw.overflow
                    | fluid["_InjectionOverflow"])


def make_advection_step(case: PulsatileCase):
    return lambda s: _advection_step(case, s)


def make_run_chunk(case: PulsatileCase):
    """run_chunk(sim, t_target): advection steps until sim.time >=
    t_target."""
    return chunk_runner(lambda s: _advection_step(case, s))


def womersley_velocity(case: PulsatileCase, y, t):
    """The oscillatory-channel solution for dp/dx = -G cos(omega t),
    G = p_amp / dl, y from the centreline."""
    nu = case.mu / case.rho0
    R = 0.5 * case.dh
    G = case.p_amp / case.dl
    beta = np.sqrt(1j * case.omega / nu)
    u_hat = (G / (1j * case.rho0 * case.omega)) * \
        (1.0 - np.cosh(beta * np.asarray(y)) / np.cosh(beta * R))
    return np.real(u_hat * np.exp(1j * case.omega * np.asarray(t)))


def womersley_startup_velocity(case: PulsatileCase, y, t, n_modes=80):
    """The exact start-from-rest solution of du/dt = (G / rho)
    cos(omega t) + nu u_yy, u(+-R) = 0: the series over
    lambda_k = (2k + 1) pi / (2R) of a_k(t) cos(lambda_k y)."""
    nu = case.mu / case.rho0
    R = 0.5 * case.dh
    G = case.p_amp / case.dl
    w = case.omega
    y = np.asarray(y)
    u = np.zeros_like(y, dtype=float)
    for k in range(n_modes):
        lam = (2 * k + 1) * np.pi / (2.0 * R)
        c_k = 4.0 * (-1.0) ** k / ((2 * k + 1) * np.pi)
        kap = nu * lam * lam
        a_k = (G * c_k / case.rho0) * (
            kap * np.cos(w * t) + w * np.sin(w * t)
            - kap * np.exp(-kap * t)) / (kap * kap + w * w)
        u = u + a_k * np.cos(lam * y)
    return u


def centerline_velocity(case: PulsatileCase, s: SimState) -> float:
    """The mean streamwise velocity of the live particles within dx of the
    centreline and 0.2 dl of the middle (on the host)."""
    pos = s.fluid["Position"].double().cpu().numpy()
    vel = s.fluid["Velocity"].double().cpu().numpy()
    alive = s.fluid["Alive"].cpu().numpy()
    mid = alive & (np.abs(pos[:, 1] - 0.5 * case.dh) < case.dx) \
        & (np.abs(pos[:, 0] - 0.5 * case.dl) < 0.2 * case.dl)
    return float(vel[mid, 0].mean())


def n_alive(s: SimState) -> int:
    return int(torch.sum(s.fluid["Alive"]))
