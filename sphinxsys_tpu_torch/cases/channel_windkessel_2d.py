"""Pulsatile channel flow with a three-element Windkessel outlet
(counterpart of sphinxsys_tpu/cases/channel_windkessel_2d.py; reference
tests/extra_source_and_tests/2d_examples/
test_2d_channel_windkessel_rigid_shell/channel_windkessel_rigid_shell.cpp):
a channel DH = 6.35 mm, DL = 5 DH of inviscid fluid (rho = 1000, c = 10);
the physiological 8-harmonic inflow imposed in the left buffer
(cpp:96-123); the RCR outlet (Rp = 1.52e6, C = 1.96e-7, Rd = 6.85e6,
baseline 80 mmHg, updated every 0.02 s) imposed in the right buffer; the
open ends recycled by the emitter and the disposer.  As in the JAX
package, a rigid dummy wall bank stands in for the reference's rigid
shell.

The Windkessel state is 0-d tensors on the card.  At each sub-step the
flow through the outlet buffer is accumulated, and the update runs where
the sub-step's end reaches the next update time: both the updated and the
kept state are formed and one is chosen by a device mask, so the
decision reads nothing back and falls on JAX's sub-steps.

    case, fluid = build_case(dx=DH / 6, device="cpu")
    sim = make_run_chunk(case)(init_sim(case, fluid), 0.01)
    print(outlet_pressure_mmhg(sim))
"""

from __future__ import annotations

import dataclasses
import math

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

SCALE = 0.001
DH = 6.35 * SCALE
DL = 5.0 * DH
RHO0_F = 1000.0
U_MAX = 1.0
C_F = 10.0 * U_MAX
RP, CAP_C, RD = 1.52e6, 1.96e-7, 6.85e6      # cpp:275
P_BASE = 80.0 * 133.32
WK_DT = 0.02                                  # cpp:259
WAVE_A = (-0.0176, -0.0657, -0.0280, 0.0068, 0.0075, 0.0115, 0.0040, 0.0035)
WAVE_B = (0.1205, 0.0171, -0.0384, -0.0152, -0.0122, 0.0002, 0.0033, 0.0060)
U_AVE0 = 0.2339


def inflow_velocity(t):
    """InflowVelocity::operator() (cpp:104-123): the mean plus the eight
    harmonics of the 1 s cycle, clamped at zero after each term; a 0-d
    tensor in t's dtype."""
    t = torch.as_tensor(t)
    u = torch.full_like(t, U_AVE0)
    w = 2.0 * math.pi / 1.0
    for i in range(8):
        theta = w * (i + 1) * t
        u = torch.clamp(u + WAVE_A[i] * torch.cos(theta)
                        + WAVE_B[i] * torch.sin(theta), min=0.0)
    return u


@dataclasses.dataclass
class SimState:
    fluid: dict
    nl_inner: NeighborList
    nl_wall: NeighborList
    wkstate: wk.WindkesselState
    next_update: torch.Tensor
    time: torch.Tensor
    n_adv: int
    n_ac: int
    overflow: torch.Tensor


@dataclasses.dataclass(frozen=True)
class WindkesselCase:
    dx: float
    adaptation: SPHAdaptation
    grid: CellGrid
    eos: WeaklyCompressibleFluid
    riemann: rs.AcousticRiemannSolver
    wall: dict
    wall_table: CellTable
    emitter: bdy.AlignedBoxRegion
    inlet: bdy.AlignedBoxRegion
    outlet: bdy.AlignedBoxRegion
    disposer: bdy.AlignedBoxRegion
    n_fluid: int
    cell_cap: int
    k_inner: int
    k_wall: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = DH / 15.0, dtype=PRODUCTION_DTYPE,
               cell_cap: int = 24, k_inner: int = 40, k_wall: int = 24,
               reserve_factor: float = 1.5, device="cuda"):
    """The fluid at rest from the sponge to DL, with reserve_factor times
    its particles in rows (the dead ones parked) and its Alive mask; the
    walls above and below the whole span; the buffers.  Returns (case,
    fluid)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    sponge = 4.0 * dx
    xs = np.arange(-sponge + dx / 2, DL, dx)
    ys = np.arange(dx / 2, DH, dx)
    pos = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    cap = int(reserve_factor * len(pos))
    fluid = make_fluid_state(pos, dx * dx, RHO0_F, dtype, device,
                             capacity=cap)
    fluid = bdy.ensure_alive_mask(fluid)
    fluid["_InjectionOverflow"] = torch.zeros((), dtype=torch.bool,
                                              device=device)

    wx = np.arange(-sponge - 4 * dx + dx / 2, DL + 4 * dx, dx)
    wy = np.arange(dx / 2, 4 * dx, dx)
    bot = np.stack(np.meshgrid(wx, -wy, indexing="ij"), -1).reshape(-1, 2)
    top = np.stack(np.meshgrid(wx, DH + wy, indexing="ij"), -1).reshape(-1, 2)
    wall = make_solid_state(np.concatenate([bot, top]), dx * dx, RHO0_F,
                            dtype, device)
    normals = np.concatenate([np.tile([0.0, 1.0], (len(bot), 1)),
                              np.tile([0.0, -1.0], (len(top), 1))])
    wall["NormalDirection"] = torch.as_tensor(normals, dtype=dtype,
                                              device=device)

    grid = grid_from_bounds((-sponge - 5 * dx, -(4.5 * dx)),
                            (DL + 5 * dx, DH + 4.5 * dx), adaptation.cutoff)
    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    case = WindkesselCase(
        dx=dx, adaptation=adaptation, grid=grid, eos=eos,
        riemann=rs.acoustic_riemann(eos), wall=wall,
        wall_table=build_cell_table(wall["Position"], wall["NReal"], grid,
                                    cell_cap),
        emitter=bdy.AlignedBoxRegion(lower=(-sponge, 0.0), upper=(0.0, DH)),
        inlet=bdy.AlignedBoxRegion(lower=(-sponge, 0.0), upper=(0.0, DH)),
        outlet=bdy.AlignedBoxRegion(lower=(DL - 4 * dx, 0.0), upper=(DL, DH)),
        disposer=bdy.AlignedBoxRegion(lower=(DL, -dx),
                                      upper=(DL + 6 * dx, DH + dx)),
        n_fluid=cap, cell_cap=cell_cap, k_inner=k_inner, k_wall=k_wall)
    return case, fluid


def rebuild_lists(case: WindkesselCase, fluid: dict):
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


def init_sim(case: WindkesselCase, fluid: dict) -> SimState:
    nl, nlw = rebuild_lists(case, fluid)
    pos = fluid["Position"]
    dtype, device = pos.dtype, pos.device
    return SimState(fluid=dict(fluid), nl_inner=nl, nl_wall=nlw,
                    wkstate=wk.init_windkessel(P_BASE, dtype, device),
                    next_update=torch.full((), WK_DT, dtype=dtype,
                                           device=device),
                    time=torch.zeros((), dtype=dtype, device=device),
                    n_adv=0, n_ac=0,
                    overflow=torch.zeros((), dtype=torch.bool,
                                         device=device))


def advection_prep(case: WindkesselCase, s: SimState) -> dict:
    """The clamped (free-surface) density summation against the wall and
    its pressure, then the limited transport correction of the bulk away
    from the open ends (cpp:207, 218)."""
    kernel, h, wall = case.kernel, case.adaptation.h, case.wall
    fluid = fd.density_summation(s.fluid, s.nl_inner, kernel, 2, RHO0_F,
                                 case.adaptation.sigma0,
                                 contacts=[(wall, s.nl_wall, RHO0_F)],
                                 free_surface=True)
    fluid["Pressure"] = case.eos.pressure(fluid["Density"])
    x = fluid["Position"][:, 0]
    bulk = (x > 2 * case.dx) & (x < DL - 6 * case.dx)
    return fd.transport_velocity_correction(
        fluid, s.nl_inner, kernel, 2, h, limiter_slope=100.0, wall=wall,
        nl_wall=s.nl_wall, scope_mask=bulk)


def buffer_conditions(case: WindkesselCase, f: dict, t_now, wkst) -> dict:
    """The inflow in the left buffer at t_now (the reference state of its
    density, pressure and rate), the Windkessel pressure in the right
    one (cpp:219-220)."""
    u_in = inflow_velocity(t_now)
    in_l = case.inlet.contains(f["Position"]) & f["Alive"]
    vel = f["Velocity"]
    target = torch.stack([u_in.expand_as(vel[:, 0]),
                          torch.zeros_like(vel[:, 1])], dim=-1)
    zero = torch.zeros_like(f["Density"])
    f = dict(f, Velocity=torch.where(in_l[:, None], target, vel),
             Density=torch.where(in_l, zero + RHO0_F, f["Density"]),
             Pressure=torch.where(in_l, zero, f["Pressure"]),
             DensityChangeRate=torch.where(in_l, zero,
                                           f["DensityChangeRate"]))
    return wk.impose_pressure_condition(f, case.outlet, wkst.p - P_BASE,
                                        case.eos)


def windkessel_step(wkst: wk.WindkesselState, nxt, t_end):
    """The RCR update where t_end reaches the next update time, chosen by
    a device mask.  Returns (Windkessel state, next update time)."""
    do_update = t_end >= nxt
    new = wk.windkessel_update(wkst, torch.full_like(nxt, WK_DT), RP, CAP_C,
                               RD)
    wkst = wk.WindkesselState(*(torch.where(do_update, b, a)
                                for a, b in zip(wkst, new)))
    return wkst, torch.where(do_update, nxt + WK_DT, nxt)


def acoustic_substep(case: WindkesselCase, s: SimState, f: dict, dt_adv,
                     t_now, wkst, nxt):
    """One sub-step from t_now: the first half, the buffers' conditions,
    the second half, the outlet flow and the Windkessel update.  Returns
    (fluid, dt, Windkessel state, next update time)."""
    kernel, h, wall = case.kernel, case.adaptation.h, case.wall
    dt = torch.minimum(fd.acoustic_time_step(f, case.eos, h), dt_adv)
    f = fd.acoustic_step_1st_half(f, s.nl_inner, kernel, 2, case.eos,
                                  case.riemann, dt, wall=wall,
                                  nl_wall=s.nl_wall)
    f = buffer_conditions(case, f, t_now, wkst)
    f = fd.acoustic_step_2nd_half(f, s.nl_inner, kernel, 2, case.riemann, dt,
                                  wall=wall, nl_wall=s.nl_wall)
    wkst = wk.accumulate_flow(wkst, f, case.outlet, 0, dt)
    wkst, nxt = windkessel_step(wkst, nxt, t_now + dt)
    return f, dt, wkst, nxt


def open_boundaries(case: WindkesselCase, fluid: dict, pos_prev) -> dict:
    """The disposer past DL, then the emitter (crossing from pos_prev)."""
    fluid = bdy.disposer_outflow_deletion(fluid, case.disposer)
    return bdy.emitter_inflow_injection(fluid, case.emitter,
                                        prev_pos=pos_prev)


def _advection_step(case: WindkesselCase, s: SimState) -> SimState:
    pos_prev = s.fluid["Position"]
    dt_adv = fd.advection_time_step(s.fluid, case.adaptation.h, U_MAX)
    fluid = advection_prep(case, s)
    wkst, nxt = s.wkstate, s.next_update
    relax_t = torch.zeros_like(dt_adv)
    n_ac = 0
    while bool(relax_t < dt_adv):          # one host read per sub-step
        fluid, dt, wkst, nxt = acoustic_substep(case, s, fluid, dt_adv,
                                                s.time + relax_t, wkst, nxt)
        relax_t = relax_t + dt
        n_ac += 1
    fluid = open_boundaries(case, fluid, pos_prev)
    nl, nlw = rebuild_lists(case, fluid)
    return SimState(fluid=fluid, nl_inner=nl, nl_wall=nlw, wkstate=wkst,
                    next_update=nxt, time=s.time + relax_t,
                    n_adv=s.n_adv + 1, n_ac=s.n_ac + n_ac,
                    overflow=s.overflow | nl.overflow | nlw.overflow)


def make_advection_step(case: WindkesselCase):
    return lambda s: _advection_step(case, s)


def make_run_chunk(case: WindkesselCase):
    """run_chunk(sim, t_target): advection steps until sim.time >=
    t_target."""
    return chunk_runner(lambda s: _advection_step(case, s))


def outlet_pressure_mmhg(s: SimState) -> float:
    return float(s.wkstate.p) / 133.32


def n_alive(s: SimState) -> int:
    return int(torch.sum(s.fluid["Alive"]))
