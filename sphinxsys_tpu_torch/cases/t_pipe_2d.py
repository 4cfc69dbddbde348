"""T-shaped pipe — one inlet, two outlets (counterpart of
sphinxsys_tpu/cases/t_pipe_2d.py; reference tests/2d_examples/
test_2d_T_shaped_pipe/T_shaped_pipe.cpp):
  * a main channel of height DH = 3 and length DL1 = 3.5 behind a
    DL_SPONGE = 3 inflow sponge tees into a branch of width 1.5 spanning
    y in [-DH, 2 DH];
  * water at Re = 100 enters with a ramped parabolic profile (t_ref = 2)
    imposed over the sponge at every acoustic sub-step, is recycled at
    the left edge by the emitter, and leaves through the two disposer
    strips at the branch ends;
  * the free-stream density summation and the spatial-temporal
    free-surface indication keep the outlet surfaces stable; the
    transport-velocity correction shifts the bulk (Indicator == 0) only.

The fluid has 50% more rows than particles (`RESERVE`): the dead slots
the emitter's clones fill.  Its NReal is that capacity, as in the JAX
package, so the time steps see every row, parked ones included.

    case, fluid = build_case(device="cpu")                # 1,460 fluid
    sim = make_run_chunk(case)(init_sim(case, fluid), 0.5)

The advection step and its acoustic loop are host loops, one host read of
each loop's condition, as in cases/fsi2.py; time and dt stay 0-d tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from sphinxsys_tpu_torch.core import geometry as G
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.generators import generate_lattice
from sphinxsys_tpu_torch.core.materials import WeaklyCompressibleFluid
from sphinxsys_tpu_torch.core.state import (FAR_AWAY, make_fluid_state,
                                            make_solid_state)
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.neighbors.cell_list import (CellGrid, CellTable,
                                                    build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list)
from sphinxsys_tpu_torch.physics import boundary as bd
from sphinxsys_tpu_torch.physics import fluid as fd
from sphinxsys_tpu_torch.physics import general as gd
from sphinxsys_tpu_torch.physics import riemann as rs
from sphinxsys_tpu_torch.solver import chunk_runner

DL = 5.0
DH = 3.0
DL1 = 0.7 * DL
DX = 0.15
BW = 4 * DX
DL_SPONGE = 20 * DX
RHO0_F = 1.0
U_F = 1.0
C_F = 10.0 * U_F * max(1.0, DH / (2.0 * (DL - DL1)))
RE = 100.0
MU_F = RHO0_F * U_F * DH / RE
T_REF = 2.0
RESERVE = 0.5


def water_shape():
    """The T polygon (T_shaped_pipe.cpp:23-25)."""
    return G.make_multi_polygon(("add", [
        (-DL_SPONGE, 0.0), (-DL_SPONGE, DH), (DL1, DH), (DL1, 2.0 * DH),
        (DL, 2.0 * DH), (DL, -DH), (DL1, -DH), (DL1, 0.0)]))


def wall_shape():
    return G.make_multi_polygon(
        ("add", [(-DL_SPONGE - BW, -BW), (-DL_SPONGE - BW, DH + BW),
                 (DL1 - BW, DH + BW), (DL1 - BW, 2.0 * DH + BW),
                 (DL + BW, 2.0 * DH + BW), (DL + BW, -DH - BW),
                 (DL1 - BW, -DH - BW), (DL1 - BW, -BW)]),
        ("sub", [(-DL_SPONGE - BW, 0.0), (-DL_SPONGE - BW, DH), (DL1, DH),
                 (DL1, 2.0 * DH + BW), (DL, 2.0 * DH + BW), (DL, -DH - BW),
                 (DL1, -DH - BW), (DL1, 0.0)]))


@dataclasses.dataclass
class TPipeSim:
    """The carry: the fluid, its two lists, the time (0-d tensor), the
    advection and acoustic step counts and the overflow flag (0-d bool
    tensor: a list, or the emitter, ran out of room)."""

    fluid: dict
    nl_inner: NeighborList
    nl_wall: NeighborList
    time: torch.Tensor
    n_adv: int
    n_ac: int
    overflow: torch.Tensor


@dataclasses.dataclass(frozen=True)
class TPipeCase:
    dx: float
    adaptation: SPHAdaptation
    grid: CellGrid
    eos: WeaklyCompressibleFluid
    riemann: rs.AcousticRiemannSolver
    no_riemann: rs.NoRiemannSolver
    wall: Any
    wall_table: CellTable
    emitter: bd.AlignedBoxRegion
    disposer_up: bd.AlignedBoxRegion
    disposer_down: bd.AlignedBoxRegion
    n_fluid: int          # the particles at the start (the rest: reserve)
    cell_cap: int
    k_inner: int
    k_wall: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = DX, dtype=PRODUCTION_DTYPE, cell_cap: int = 24,
               k_inner: int = 48, k_wall: int = 32, device="cuda"):
    """The scene: the fluid with its reserve and Alive mask, the wall with
    its shape normals and cell table, the emitter and the two disposers.
    Returns (case, fluid)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    bw = 4 * dx
    dom_lo = (-DL_SPONGE - bw - dx, -DH - bw - dx)
    dom_hi = (DL + bw + dx, 2.0 * DH + bw + dx)

    pos_f, vol = generate_lattice(water_shape(), dom_lo, dom_hi, dx)
    n0 = len(pos_f)
    cap = int(n0 * (1.0 + RESERVE))
    pos_full = np.full((cap, 2), float(FAR_AWAY))
    pos_full[:n0] = pos_f
    # every row, reserve included, a particle of this volume (NReal = cap)
    fluid = make_fluid_state(pos_full, vol, RHO0_F, dtype, device)
    fluid["Alive"] = torch.arange(cap, device=device) < n0
    fluid["Indicator"] = torch.zeros(cap, dtype=torch.int32, device=device)
    # 1 (surface_indication.cpp:52): the first indication runs unsuppressed
    fluid["PreviousSurfaceIndicator"] = torch.ones(cap, dtype=torch.int32,
                                                   device=device)
    fluid["PositionDivergence"] = torch.zeros(cap, dtype=dtype, device=device)
    fluid["ViscousForce"] = torch.zeros_like(fluid["Velocity"])
    fluid["ViscousForcePrev"] = torch.zeros_like(fluid["Velocity"])

    pos_w, _ = generate_lattice(wall_shape(), dom_lo, dom_hi, dx)
    wall = make_solid_state(pos_w, vol, RHO0_F, dtype, device)
    wall = gd.normal_direction_from_shape(wall, wall_shape())

    grid = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff)
    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    emitter = bd.AlignedBoxRegion(lower=(-DL_SPONGE, 0.0),
                                  upper=(-DL_SPONGE + bw, DH), axis=0)
    # the outlets delete only past their planes (checkUpperBound,
    # base_geometry.h:102-106): strictly outside the T
    disposer_up = bd.AlignedBoxRegion(lower=(DL1 - 0.1 * DH, 2.0 * DH),
                                      upper=(DL + 0.1 * DH, 2.0 * DH + 2 * bw),
                                      axis=1)
    disposer_down = bd.AlignedBoxRegion(lower=(DL1 - 0.1 * DH, -DH - 2 * bw),
                                        upper=(DL + 0.1 * DH, -DH), axis=1)
    case = TPipeCase(
        dx=dx, adaptation=adaptation, grid=grid, eos=eos,
        riemann=rs.acoustic_riemann(eos), no_riemann=rs.no_riemann(eos),
        wall=wall, wall_table=build_cell_table(wall["Position"], wall["NReal"],
                                               grid, cell_cap),
        emitter=emitter, disposer_up=disposer_up, disposer_down=disposer_down,
        n_fluid=n0, cell_cap=cell_cap, k_inner=k_inner, k_wall=k_wall)
    return case, fluid


def rebuild_relations(case: TPipeCase, fluid: dict):
    """The live rows' cell table and the (inner, wall) lists."""
    alive = fluid["Alive"]
    pos = fluid["Position"]
    cutoff = case.adaptation.cutoff
    table = build_cell_table(pos, alive, case.grid, case.cell_cap)
    nl_inner = build_neighbor_list(pos, alive, pos, alive, table, case.grid,
                                   cutoff, k_max=case.k_inner,
                                   include_self=False)
    nl_wall = build_neighbor_list(pos, alive, case.wall["Position"],
                                  case.wall["NReal"], case.wall_table,
                                  case.grid, cutoff, k_max=case.k_wall,
                                  include_self=True)
    return nl_inner, nl_wall


def init_sim(case: TPipeCase, fluid: dict) -> TPipeSim:
    nl_inner, nl_wall = rebuild_relations(case, fluid)
    pos = fluid["Position"]
    return TPipeSim(fluid=dict(fluid), nl_inner=nl_inner, nl_wall=nl_wall,
                    time=torch.zeros((), dtype=pos.dtype, device=pos.device),
                    n_adv=0, n_ac=0,
                    overflow=torch.zeros((), dtype=torch.bool,
                                         device=pos.device))


def inflow_condition(fluid: dict, t) -> dict:
    """InflowVelocityCondition over the sponge (T_shaped_pipe.cpp:54-72):
    the ramped parabolic x-velocity on the live particles there, the
    y-velocity left as it is."""
    pos, vel = fluid["Position"], fluid["Velocity"]
    in_sponge = (fluid["Alive"] & (pos[:, 0] < 0.0)
                 & (pos[:, 0] >= -DL_SPONGE)
                 & (pos[:, 1] >= 0.0) & (pos[:, 1] <= DH))
    u_ave = torch.where(t < T_REF,
                        0.5 * U_F * (1.0 - torch.cos(math.pi * t / T_REF)),
                        torch.full_like(t, U_F))
    yl = (pos[:, 1] - 0.5 * DH) / (0.5 * DH)
    u = 1.5 * u_ave * torch.clamp(1.0 - yl * yl, min=0.0)
    return dict(fluid, Velocity=torch.stack(
        [torch.where(in_sponge, u, vel[:, 0]), vel[:, 1]], dim=-1))


def advection_prep(case: TPipeCase, s: TPipeSim) -> dict:
    """The advection step's fluid prep: the surface indication and the
    free-stream density against the wall, the viscous force, and the
    transport-velocity correction of the live bulk."""
    kernel, h = case.kernel, case.adaptation.h
    walls = [(case.wall, s.nl_wall)]
    fluid = fd.free_surface_indication(
        s.fluid, s.nl_inner, kernel, 2,
        contacts=[(case.wall, s.nl_wall, None)], spatial_temporal=True)
    fluid = fd.density_summation_freestream(
        fluid, s.nl_inner, kernel, 2, RHO0_F, case.adaptation.sigma0,
        contacts=[(case.wall, s.nl_wall, RHO0_F)])
    fluid = fd.viscous_force(fluid, s.nl_inner, kernel, 2, MU_F, h,
                             walls=walls)
    return fd.transport_velocity_correction(
        fluid, s.nl_inner, kernel, 2, h, walls=walls,
        scope_mask=(fluid["Indicator"] == 0) & fluid["Alive"])


def acoustic_substep(case: TPipeCase, s: TPipeSim, fluid: dict, dt_adv,
                     t_now):
    """One acoustic sub-step from t_now: the 1st half, the inflow at t_now,
    the 2nd half (no Riemann dissipation).  Returns (fluid, dt)."""
    kernel, h = case.kernel, case.adaptation.h
    walls = [(case.wall, s.nl_wall)]
    dt = torch.minimum(fd.acoustic_time_step(fluid, case.eos, h), dt_adv)
    fluid = fd.acoustic_step_1st_half(fluid, s.nl_inner, kernel, 2, case.eos,
                                      case.riemann, dt, walls=walls)
    fluid = inflow_condition(fluid, t_now)
    fluid = fd.acoustic_step_2nd_half(fluid, s.nl_inner, kernel, 2,
                                      case.no_riemann, dt, walls=walls)
    return fluid, dt


def open_boundaries(case: TPipeCase, fluid: dict, pos_prev) -> dict:
    """Both disposers, then the emitter (crossing from `pos_prev`); the
    injection overflow flag left in the state."""
    fluid = bd.disposer_outflow_deletion(fluid, case.disposer_up)
    fluid = bd.disposer_outflow_deletion(fluid, case.disposer_down)
    return bd.emitter_inflow_injection(fluid, case.emitter, prev_pos=pos_prev)


def _advection_step(case: TPipeCase, s: TPipeSim) -> TPipeSim:
    pos_prev = s.fluid["Position"]
    dt_adv = fd.advection_viscous_time_step(s.fluid, case.adaptation.h, U_F,
                                            RHO0_F, MU_F)
    fluid = advection_prep(case, s)
    relax_t = torch.zeros_like(dt_adv)
    n_ac = 0
    while bool(relax_t < dt_adv):          # one host read per sub-step
        fluid, dt = acoustic_substep(case, s, fluid, dt_adv, s.time + relax_t)
        relax_t = relax_t + dt
        n_ac += 1
    fluid = open_boundaries(case, fluid, pos_prev)
    inj_ovf = fluid.pop("_InjectionOverflow")
    nl_inner, nl_wall = rebuild_relations(case, fluid)
    return TPipeSim(fluid=fluid, nl_inner=nl_inner, nl_wall=nl_wall,
                    time=s.time + relax_t, n_adv=s.n_adv + 1,
                    n_ac=s.n_ac + n_ac,
                    overflow=s.overflow | nl_inner.overflow
                    | nl_wall.overflow | inj_ovf)


def make_advection_step(case: TPipeCase):
    return lambda s: _advection_step(case, s)


def make_run_chunk(case: TPipeCase):
    """run_chunk(sim, t_target): advection steps until sim.time >=
    t_target."""
    return chunk_runner(lambda s: _advection_step(case, s))


def kinetic_energy(s: TPipeSim) -> float:
    """Sum of 0.5 m v^2 over the live particles."""
    return float(gd.total_kinetic_energy(s.fluid))


def n_alive(s: TPipeSim) -> int:
    return int(torch.sum(s.fluid["Alive"]))
