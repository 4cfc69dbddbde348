"""2D turbulent channel flow with the standard k-epsilon model and wall
functions (counterpart of sphinxsys_tpu/cases/turbulent_channel_2d.py;
reference tests/extra_source_and_tests/2d_examples/
test_2d_turbulent_channel/test_2d_turbulent_channel.{h,cpp}): channel
height DH = 2, Re = 20000, 20 particles across, the near-wall particle
distance y_p = 0.05, and the RANS sequence of the reference's main loop
(test_2d_turbulent_channel.cpp:205-258):

  outer:  turbulent dt_adv | density | correction matrices | eddy
          viscosity | turbulent viscous force | transport correction
  inner:  TKE force | pressure relaxation | density relaxation |
          near-wall status | wall-function correction | velocity
          gradient | K equation | Epsilon equation

As in the JAX package, the channel is periodic along the flow and driven
by a constant body force g_x (at steady state the wall shear balances it,
u_tau = sqrt(g_x DH / 2)) instead of the reference's inflow/outflow
buffers.  The advection and acoustic loops are host loops, each condition
one host read, as the port's dambreak's.

    case, fluid = build_case(device="cpu")
    sim = make_run_chunk(case)(init_sim(case, fluid), 0.05)
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.materials import WeaklyCompressibleFluid
from sphinxsys_tpu_torch.core.state import make_fluid_state, make_solid_state
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.neighbors.cell_list import (CellGrid, CellTable,
                                                    build_cell_table,
                                                    grid_from_bounds,
                                                    wrap_positions)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list)
from sphinxsys_tpu_torch.physics import fluid as fd
from sphinxsys_tpu_torch.physics import riemann as rs
from sphinxsys_tpu_torch.physics import turbulence as tb
from sphinxsys_tpu_torch.solver import chunk_runner

DH = 2.0                      # channel height (test_2d_turbulent_channel.h:21)
N_CROSS = 20.0                # particles across the section (h:23)
Y_P = 0.05                    # wall-adjacent particle distance (h:33)
DX = (DH - 2.0 * Y_P) / (N_CROSS - 1.0)   # = 0.1 (h:34)
RHO0_F = 1.0
U_F = 1.0
U_MAX = 1.5 * U_F
C_F = 10.0 * U_MAX
RE = 20000.0
MU_F = RHO0_F * U_F * DH / RE
# the driving body force: u_tau^2 = G_X DH / 2 at steady state (the JAX
# package's value)
G_X = 2.7e-3
WEIGHT_VGRAD_SUB = 0.1        # weight_vel_grad_sub_nearwall (h:30)
INITIAL_TURBU = (1.80001e-4, 3.326679e-5, 1.0e-9)  # k, eps, mu_t (h:32)
N_WALL_LAYERS = 4


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
class ChannelCase:
    dx: float
    length: float
    adaptation: SPHAdaptation
    grid: CellGrid
    eos: WeaklyCompressibleFluid
    riemann: rs.AcousticRiemannSolver
    no_riemann: Any
    wall: dict
    wall_table: CellTable
    closure: tb.TurbuClosure
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


def _make_walls(length: float, dx: float, dtype, device):
    """Dummy wall layers below y = 0 and above y = DH with inward normals
    (wall_boundary, test_2d_turbulent_channel.h:88-108)."""
    xs = np.arange(dx / 2, length, dx)
    ys = np.arange(dx / 2, N_WALL_LAYERS * dx, dx)
    bot = np.stack(np.meshgrid(xs, -ys, indexing="ij"), -1).reshape(-1, 2)
    top = np.stack(np.meshgrid(xs, DH + ys, indexing="ij"), -1).reshape(-1, 2)
    normals = np.concatenate([np.tile([0.0, 1.0], (len(bot), 1)),
                              np.tile([0.0, -1.0], (len(top), 1))], axis=0)
    wall = make_solid_state(np.concatenate([bot, top], axis=0), dx * dx,
                            RHO0_F, dtype=dtype, device=device)
    wall["NormalDirection"] = torch.as_tensor(normals, dtype=dtype,
                                              device=device)
    return wall


def build_case(dx: float = DX, length: float | None = None,
               dtype=PRODUCTION_DTYPE, device="cuda", cell_cap: int = 24,
               k_inner: int = 40, k_wall: int = 24):
    """The periodic channel section (8 dx long unless `length` says), its
    fluid at the impulsive uniform start with the registered turbulence
    fields, and the walls.  Returns (case, fluid state)."""
    device, dtype = resolve_device(device), resolve_dtype(dtype)
    length = length or 8 * dx
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    # the first row of centres sits y_p from each wall surface
    xs = np.arange(dx / 2, length, dx)
    ys = np.arange(dx / 2, DH, dx)
    pos = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)

    fluid = make_fluid_state(pos, dx * dx, RHO0_F, dtype=dtype, device=device)
    vel = torch.zeros_like(fluid["Velocity"])
    vel[:, 0] = U_F               # the impulsive uniform start
    fluid["Velocity"] = vel
    fluid = tb.register_turbulence_fields(fluid, 2, *INITIAL_TURBU, Y_P)
    # the constant driving force; the TKE and viscous forces are folded in
    # with their previous values taken out
    g = torch.zeros_like(vel)
    g[:, 0] = G_X
    fluid["ForcePrior"] = g * fluid["Mass"][:, None]
    fluid["LinearGradientCorrectionMatrix"] = torch.eye(
        2, dtype=dtype, device=device).expand(len(pos), 2, 2).clone()

    grid = grid_from_bounds((0.0, -(N_WALL_LAYERS + 0.5) * dx),
                            (length, DH + (N_WALL_LAYERS + 0.5) * dx),
                            adaptation.cutoff, periodic=(True, False))
    wall = _make_walls(length, dx, dtype, device)
    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    case = ChannelCase(
        dx=dx, length=length, adaptation=adaptation, grid=grid, eos=eos,
        riemann=rs.acoustic_riemann(eos), no_riemann=rs.no_riemann(eos),
        wall=wall, wall_table=build_cell_table(wall["Position"],
                                               wall["NReal"], grid, cell_cap),
        closure=tb.TurbuClosure(), n_fluid=len(pos), cell_cap=cell_cap,
        k_inner=k_inner, k_wall=k_wall)
    return case, fluid


def rebuild_lists(case: ChannelCase, fluid: dict):
    """(wrapped positions, inner list, fluid -> wall list)."""
    pos = wrap_positions(fluid["Position"], case.grid)
    n = fluid["NReal"]
    table = build_cell_table(pos, n, case.grid, case.cell_cap)
    nl = build_neighbor_list(pos, n, pos, n, table, case.grid,
                             case.adaptation.cutoff, k_max=case.k_inner,
                             include_self=False)
    nlw = build_neighbor_list(pos, n, case.wall["Position"],
                              case.wall["NReal"], case.wall_table, case.grid,
                              case.adaptation.cutoff, k_max=case.k_wall,
                              include_self=False)
    return pos, nl, nlw


def init_sim(case: ChannelCase, fluid: dict) -> SimState:
    pos, nl, nlw = rebuild_lists(case, fluid)
    return SimState(fluid=dict(fluid, Position=pos), nl_inner=nl,
                    nl_wall=nlw,
                    time=torch.zeros((), dtype=pos.dtype, device=pos.device),
                    n_adv=0, n_ac=0,
                    overflow=torch.zeros((), dtype=torch.bool,
                                         device=pos.device))


def advection_prep(case: ChannelCase, s: SimState):
    """The outer half of an advection step: (dt_adv, fluid)."""
    kernel, h, box, cl = case.kernel, case.adaptation.h, case.box, \
        case.closure
    wall, fluid = case.wall, s.fluid
    dt_adv = tb.turbulent_advection_time_step(fluid, MU_F, RHO0_F, h, U_MAX)
    fluid = fd.density_summation(fluid, s.nl_inner, kernel, 2, RHO0_F,
                                 case.adaptation.sigma0,
                                 contacts=[(wall, s.nl_wall, RHO0_F)],
                                 free_surface=False, box=box)
    fluid["Pressure"] = case.eos.pressure(fluid["Density"])
    # LinearGradientCorrectionMatrixComplex for the corrected pressure
    # force (test_2d_turbulent_channel.cpp:112,115)
    fluid = fd.kernel_correction_matrix(fluid, s.nl_inner, kernel, 2,
                                        wall=wall, nl_wall=s.nl_wall, box=box)
    fluid = tb.turbulent_correction_matrix(fluid, s.nl_inner, kernel, 2)
    fluid = tb.eddy_viscosity_update(fluid, cl)
    # is_AMRD = 0 in the reference channel (test_2d_turbulent_channel.h:28)
    fluid = tb.turbulent_viscous_force(fluid, s.nl_inner, wall, s.nl_wall,
                                       kernel, 2, MU_F, h, C_F, s.time, cl,
                                       extra_dissipation=False)
    fluid = fd.transport_velocity_correction(
        fluid, s.nl_inner, kernel, 2, h, limiter_slope=100.0, wall=wall,
        nl_wall=s.nl_wall, box=box)
    return dt_adv, fluid


def acoustic_substep(case: ChannelCase, s: SimState, f: dict, dt_adv, time):
    """One acoustic sub-step at `time` (the step's start plus the
    sub-steps so far): (fluid, dt)."""
    kernel, h, box, cl = case.kernel, case.adaptation.h, case.box, \
        case.closure
    wall, nlw = case.wall, s.nl_wall
    dt = torch.minimum(fd.acoustic_time_step(f, case.eos, h), dt_adv)
    f = tb.tke_energy_force(f, s.nl_inner, wall, nlw, kernel, 2)
    f = fd.acoustic_step_1st_half(f, s.nl_inner, kernel, 2, case.eos,
                                  case.riemann, dt, wall=wall, nl_wall=nlw,
                                  box=box, correction=True)
    # is_constrain_normal_velocity_in_P_region = false (h:29); the 2nd
    # half is Integration2ndHalfWithWallNoRiemann (cpp:116)
    f = fd.acoustic_step_2nd_half(f, s.nl_inner, kernel, 2, case.no_riemann,
                                  dt, wall=wall, nl_wall=nlw, box=box)
    f = tb.judge_is_near_wall(f, wall, nlw, kernel, 2, case.dx, case.dx)
    f = tb.standard_wall_function_correction(f, wall, nlw, kernel, 2, MU_F,
                                             time, cl)
    f = tb.turbulent_velocity_gradient(f, s.nl_inner, wall, nlw, kernel, 2,
                                       WEIGHT_VGRAD_SUB)
    # is_source_term_linearisation = false (h:31): explicit updates, the
    # Epsilon equation reading the K equation's k
    f = tb.k_equation(f, s.nl_inner, kernel, 2, MU_F, h, dt, cl, stl=False)
    f = tb.epsilon_equation(f, s.nl_inner, kernel, 2, MU_F, h, dt, cl,
                            stl=False)
    return f, dt


def _advection_step(case: ChannelCase, s: SimState) -> SimState:
    dt_adv, fluid = advection_prep(case, s)
    relax_t = torch.zeros_like(dt_adv)
    n_ac = 0
    while bool(relax_t < dt_adv):          # one host sync per sub-step
        fluid, dt = acoustic_substep(case, s, fluid, dt_adv, s.time + relax_t)
        relax_t = relax_t + dt
        n_ac += 1
    pos, nl, nlw = rebuild_lists(case, fluid)
    return SimState(fluid=dict(fluid, Position=pos), nl_inner=nl,
                    nl_wall=nlw, time=s.time + relax_t, n_adv=s.n_adv + 1,
                    n_ac=s.n_ac + n_ac,
                    overflow=s.overflow | nl.overflow | nlw.overflow)


def make_advection_step(case: ChannelCase):
    return lambda s: _advection_step(case, s)


def make_run_chunk(case: ChannelCase):
    """run_chunk(sim, t_target): advection steps until sim.time >=
    t_target (compared in the time's dtype)."""
    return chunk_runner(make_advection_step(case))


def mean_profile(case: ChannelCase, s: SimState, n_bins: int | None = None):
    """The streamwise-averaged u(y) profile (n_bins defaults to the
    particle rows across the section)."""
    n_bins = n_bins or int(round(DH / case.dx))
    y = s.fluid["Position"][:, 1].double().cpu().numpy()
    u = s.fluid["Velocity"][:, 0].double().cpu().numpy()
    edges = np.linspace(0.0, DH, n_bins + 1)
    idx = np.clip(np.digitize(y, edges) - 1, 0, n_bins - 1)
    prof = np.array([u[idx == b].mean() if (idx == b).any() else 0.0
                     for b in range(n_bins)])
    return 0.5 * (edges[:-1] + edges[1:]), prof
