"""Thermal channel flow (counterpart of sphinxsys_tpu/cases/
heat_transfer_2d.py; reference tests/2d_examples/test_2d_heat_transfer/
heat_transfer.cpp): an x-periodic channel (DL = 2, DH = 0.4, dx = DH / 25)
with a 20 dx inflow sponge imposing a ramped parabolic velocity, a hot
lower wall (Phi = 40) and a cold upper one (Phi = 20); the fluid
(Phi = 20 at first) carries and diffuses heat (D = 1e-3) with Dirichlet
contact to the walls (ThermalRelaxationComplex, heat_transfer.cpp:150-151).
The observer reads Phi at (0, DH / 2).

Each advection step (heat_transfer.cpp:300-345): the density summation,
the viscous force and the transport-velocity correction; then acoustic
sub-steps of min(thermal dt, acoustic dt, advection dt), each the
pressure relaxation (Riemann), the density relaxation (no Riemann), the
RK2 thermal relaxation and the inflow reset.

    case, fluid = build_case(dx=0.04, device="cpu")
    sim = make_run_chunk(case)(init_sim(case, fluid), 0.05)
    print(observe_phi(case, sim))
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
from sphinxsys_tpu_torch.io.observation import observe_quantity
from sphinxsys_tpu_torch.neighbors.cell_list import (CellGrid, CellTable,
                                                    build_cell_table,
                                                    grid_from_bounds,
                                                    wrap_positions)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list)
from sphinxsys_tpu_torch.physics import diffusion as dfn
from sphinxsys_tpu_torch.physics import fluid as fd
from sphinxsys_tpu_torch.physics import riemann as rs
from sphinxsys_tpu_torch.solver import chunk_runner

DL = 2.0
DH = 0.4
DX = DH / 25.0
DL_SPONGE = DX * 20.0
N_WALL_LAYERS = 4
RHO0_F = 1.0
U_F = 1.0
C_F = 10.0 * U_F
RE = 100.0
MU_F = RHO0_F * U_F * DH / RE
DIFFUSION_COEFF = 1.0e-3
PHI_UPPER_WALL = 20.0
PHI_LOWER_WALL = 40.0
PHI_FLUID_INITIAL = 20.0
T_RAMP = 2.0
OBS_POINT = (0.0, 0.5 * DH)


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
class HeatTransferCase:
    dx: float
    adaptation: SPHAdaptation
    grid: CellGrid
    eos: WeaklyCompressibleFluid
    riemann: rs.AcousticRiemannSolver
    no_riemann: rs.NoRiemannSolver
    wall: dict
    wall_table: CellTable
    diffusion: dfn.IsotropicDiffusion
    n_fluid: int
    cell_cap: int
    k_inner: int
    k_wall: int

    @property
    def kernel(self):
        return self.adaptation.kernel

    @property
    def box(self):
        return self.grid.periodic_lengths


def _make_walls(dx: float, dtype, device) -> dict:
    """Four layers below y = 0 and above y = DH over the whole span, the
    normals into the channel and the walls' fixed temperatures
    (heat_transfer.cpp:100-122)."""
    xs = np.arange(-DL_SPONGE + dx / 2, DL, dx)
    ys = np.arange(dx / 2, N_WALL_LAYERS * dx, dx)
    bot = np.stack(np.meshgrid(xs, -ys, indexing="ij"), -1).reshape(-1, 2)
    top = np.stack(np.meshgrid(xs, DH + ys, indexing="ij"), -1).reshape(-1, 2)
    wall = make_solid_state(np.concatenate([bot, top]), dx * dx, RHO0_F,
                            dtype, device)
    normals = np.concatenate([np.tile([0.0, 1.0], (len(bot), 1)),
                              np.tile([0.0, -1.0], (len(top), 1))])
    phi = np.concatenate([np.full(len(bot), PHI_LOWER_WALL),
                          np.full(len(top), PHI_UPPER_WALL)])
    wall["NormalDirection"] = torch.as_tensor(normals, dtype=dtype,
                                              device=device)
    wall["Phi"] = torch.as_tensor(phi, dtype=dtype, device=device)
    return wall


def build_case(dx: float = DX, dtype=PRODUCTION_DTYPE, cell_cap: int = 24,
               k_inner: int = 40, k_wall: int = 24, device="cuda"):
    """The fluid at rest at Phi = 20 from the sponge to DL, the walls and
    the x-periodic grid.  Returns (case, fluid)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    xs = np.arange(-DL_SPONGE + dx / 2, DL, dx)
    ys = np.arange(dx / 2, DH, dx)
    pos = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    fluid = make_fluid_state(pos, dx * dx, RHO0_F, dtype, device)
    fluid["Phi"] = torch.full((len(pos),), PHI_FLUID_INITIAL, dtype=dtype,
                              device=device)
    fluid["ViscousForce"] = torch.zeros_like(fluid["Velocity"])
    fluid["ViscousForcePrev"] = torch.zeros_like(fluid["Velocity"])
    grid = grid_from_bounds((-DL_SPONGE, -(N_WALL_LAYERS + 0.5) * dx),
                            (DL, DH + (N_WALL_LAYERS + 0.5) * dx),
                            adaptation.cutoff, periodic=(True, False))
    wall = _make_walls(dx, dtype, device)
    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    case = HeatTransferCase(
        dx=dx, adaptation=adaptation, grid=grid, eos=eos,
        riemann=rs.acoustic_riemann(eos), no_riemann=rs.no_riemann(eos),
        wall=wall, wall_table=build_cell_table(wall["Position"],
                                               wall["NReal"], grid, cell_cap),
        diffusion=dfn.IsotropicDiffusion(d_coeff=DIFFUSION_COEFF),
        n_fluid=len(pos), cell_cap=cell_cap, k_inner=k_inner, k_wall=k_wall)
    return case, fluid


def inflow_velocity(fluid: dict, t) -> dict:
    """The ramped parabolic profile imposed in the sponge x < 0
    (InflowVelocity, heat_transfer.cpp:155-177)."""
    pos, vel = fluid["Position"], fluid["Velocity"]
    u_ave = torch.where(t < T_RAMP,
                        0.5 * U_F * (1.0 - torch.cos(math.pi * t / T_RAMP)),
                        torch.full_like(t, U_F)).to(pos.dtype)
    half = 0.5 * DH
    yc = (pos[:, 1] - half) / half
    target = 1.5 * u_ave * (1.0 - yc * yc)
    in_buffer = (pos[:, 0] < 0.0)[:, None]
    return dict(fluid, Velocity=torch.where(
        in_buffer, torch.stack([target, vel[:, 1]], dim=-1), vel))


def rebuild_lists(case: HeatTransferCase, fluid: dict):
    """Positions wrapped into the box, then the (inner, wall) lists.
    Returns (wrapped positions, nl_inner, nl_wall)."""
    pos = wrap_positions(fluid["Position"], case.grid)
    n = fluid["NReal"]
    cutoff = case.adaptation.cutoff
    table = build_cell_table(pos, n, case.grid, case.cell_cap)
    nl = build_neighbor_list(pos, n, pos, n, table, case.grid, cutoff,
                             k_max=case.k_inner, include_self=False)
    nlw = build_neighbor_list(pos, n, case.wall["Position"],
                              case.wall["NReal"], case.wall_table, case.grid,
                              cutoff, k_max=case.k_wall, include_self=False)
    return pos, nl, nlw


def init_sim(case: HeatTransferCase, fluid: dict) -> SimState:
    pos, nl, nlw = rebuild_lists(case, fluid)
    return SimState(fluid=dict(fluid, Position=pos), nl_inner=nl,
                    nl_wall=nlw,
                    time=torch.zeros((), dtype=pos.dtype, device=pos.device),
                    n_adv=0, n_ac=0,
                    overflow=torch.zeros((), dtype=torch.bool,
                                         device=pos.device))


def advection_prep(case: HeatTransferCase, s: SimState) -> dict:
    """The density summation, the viscous force and the transport
    correction, against the wall and through the box."""
    kernel, h, box, wall = case.kernel, case.adaptation.h, case.box, case.wall
    fluid = fd.density_summation(s.fluid, s.nl_inner, kernel, 2, RHO0_F,
                                 case.adaptation.sigma0,
                                 contacts=[(wall, s.nl_wall, RHO0_F)],
                                 free_surface=False, box=box)
    fluid = fd.viscous_force(fluid, s.nl_inner, kernel, 2, MU_F, h,
                             wall=wall, nl_wall=s.nl_wall, box=box)
    return fd.transport_velocity_correction(fluid, s.nl_inner, kernel, 2, h,
                                            wall=wall, nl_wall=s.nl_wall,
                                            box=box)


def thermal_relaxation(case: HeatTransferCase, s: SimState, f: dict,
                       dt) -> dict:
    """The RK2 diffusion of Phi with the walls' Dirichlet values."""
    return dfn.diffusion_step_rk2(f, "Phi", s.nl_inner, case.kernel, 2,
                                  case.diffusion, dt,
                                  dirichlet_contacts=[(case.wall, s.nl_wall)],
                                  box=case.box)


def acoustic_substep(case: HeatTransferCase, s: SimState, f: dict, dt_adv,
                     t_now):
    """One sub-step from t_now.  Returns (fluid, dt)."""
    kernel, h, box, wall = case.kernel, case.adaptation.h, case.box, case.wall
    dt_thermal = dfn.diffusion_time_step(h, case.diffusion, 2)
    dt = torch.minimum(torch.minimum(
        torch.full_like(dt_adv, dt_thermal),
        fd.acoustic_time_step(f, case.eos, h)), dt_adv)
    f = fd.acoustic_step_1st_half(f, s.nl_inner, kernel, 2, case.eos,
                                  case.riemann, dt, wall=wall,
                                  nl_wall=s.nl_wall, box=box)
    f = fd.acoustic_step_2nd_half(f, s.nl_inner, kernel, 2, case.no_riemann,
                                  dt, wall=wall, nl_wall=s.nl_wall, box=box)
    f = thermal_relaxation(case, s, f, dt)
    return inflow_velocity(f, t_now + dt), dt


def _advection_step(case: HeatTransferCase, s: SimState) -> SimState:
    dt_adv = fd.advection_viscous_time_step(s.fluid, case.adaptation.h, U_F,
                                            RHO0_F, MU_F)
    fluid = advection_prep(case, s)
    relax_t = torch.zeros_like(dt_adv)
    n_ac = 0
    while bool(relax_t < dt_adv):          # one host read per sub-step
        fluid, dt = acoustic_substep(case, s, fluid, dt_adv, s.time + relax_t)
        relax_t = relax_t + dt
        n_ac += 1
    pos, nl, nlw = rebuild_lists(case, fluid)
    return SimState(fluid=dict(fluid, Position=pos), nl_inner=nl,
                    nl_wall=nlw, time=s.time + relax_t, n_adv=s.n_adv + 1,
                    n_ac=s.n_ac + n_ac,
                    overflow=s.overflow | nl.overflow | nlw.overflow)


def make_advection_step(case: HeatTransferCase):
    return lambda s: _advection_step(case, s)


def make_run_chunk(case: HeatTransferCase):
    """run_chunk(sim, t_target): advection steps until sim.time >=
    t_target."""
    return chunk_runner(lambda s: _advection_step(case, s))


def observe_phi(case: HeatTransferCase, s: SimState) -> float:
    """Phi at (0, DH / 2), Shepard-interpolated (ObservedQuantityRecording
    'Phi', heat_transfer.cpp:253)."""
    pos = s.fluid["Position"]
    obs = torch.as_tensor([OBS_POINT], dtype=pos.dtype, device=pos.device)
    n = s.fluid["NReal"]
    table = build_cell_table(pos, n, case.grid, case.cell_cap)
    nl = build_neighbor_list(obs, 1, pos, n, table, case.grid,
                             case.adaptation.cutoff, k_max=case.k_inner,
                             include_self=False)
    return float(observe_quantity(obs, s.fluid, "Phi", nl, case.kernel,
                                  2)[0])


def phi_profile(case: HeatTransferCase, s: SimState, n_bins: int = 25):
    """The streamwise mean of Phi in n_bins bands of y (on the host)."""
    y = s.fluid["Position"][:, 1].double().cpu().numpy()
    phi = s.fluid["Phi"].double().cpu().numpy()
    edges = np.linspace(0.0, DH, n_bins + 1)
    idx = np.clip(np.digitize(y, edges) - 1, 0, n_bins - 1)
    prof = np.asarray([phi[idx == b].mean() for b in range(n_bins)])
    return 0.5 * (edges[:-1] + edges[1:]), prof
