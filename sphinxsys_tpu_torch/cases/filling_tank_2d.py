"""Filling a plane tank from an inlet jet — the emitter injection benchmark
(counterpart of sphinxsys_tpu/cases/filling_tank_2d.py; reference
tests/2d_examples/test_2d_filling_tank/filling_tank.cpp): the 5.366^2
tank starts EMPTY but for the emitter box (8 dx x 0.125) in the left wall
at height 1; its particles are forced to v = (2, 0), rho = rho0, p =
p(rho0) after each acoustic half (EmitterInflowCondition,
fluid_boundary.cpp:50-59) and recycled through the inlet with a clone
made live per crossing (physics/boundary.py's emitter).  The jet falls
under gravity, pools and fills the tank to t = 30; the water's total
mechanical energy is the regression quantity.

The fluid has RESERVE times the seed's rows (ParticleBuffer<350>), all of
them particles of the seed's volume (NReal = capacity), Alive on the
seed.  As in the JAX package the inflow condition holds the live
particles inside the emitter box.  The box test compares with the box's
bounds as Python numbers, so that a sub-step makes no host-to-device
copy.

    case, fluid = build_case(device="cpu")          # 40 seed, 14,000 rows
    sim = make_run_chunk(case)(init_sim(case, fluid), 0.5)
    print(n_alive(sim), mechanical_energy(case, sim))
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

DL = 5.366
DH = 5.366
DX = 0.025
BW = 4 * DX
LL = 2.0 * BW            # inlet length (x)
LH = 0.125               # inlet height (y)
INLET_HEIGHT = 1.0
RHO0_F = 1.0
GRAVITY_G = 1.0
U_JET = 2.0
U_F = 2.0 * math.sqrt(GRAVITY_G * (INLET_HEIGHT + LH))
C_F = 10.0 * U_F
RESERVE = 350.0          # ParticleBuffer<ReserveSizeFactor>(350)


@dataclasses.dataclass
class SimState:
    """The carry: the fluid, its two lists, the time (0-d tensor), the
    advection and acoustic step counts and the overflow flag (a list, or
    the emitter, ran out of room)."""

    fluid: dict
    nl_inner: NeighborList
    nl_wall: NeighborList
    time: torch.Tensor
    n_adv: int
    n_ac: int
    overflow: torch.Tensor


@dataclasses.dataclass(frozen=True)
class FillingTankCase:
    dx: float
    adaptation: SPHAdaptation
    grid: CellGrid
    eos: WeaklyCompressibleFluid
    riemann: rs.AcousticRiemannSolver
    gravity: gd.Gravity
    wall: Any
    wall_table: CellTable
    emitter: bd.AlignedBoxRegion
    n_seed: int
    cell_cap: int
    k_inner: int
    k_wall: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = DX, dtype=PRODUCTION_DTYPE, cell_cap: int = 24,
               k_inner: int = 48, k_wall: int = 32, device="cuda"):
    """The seed in the emitter box at the jet's velocity, the reserve rows
    parked FAR_AWAY (each a particle of volume dx^2), gravity in
    ForcePrior, the notched tank wall.  Returns (case, fluid)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    bw = 4 * dx

    # the emitter box: x in [-BW, -BW + LL], y in [INLET_HEIGHT, + LH]
    # (inlet_translation / halfsize, filling_tank.cpp:11-13)
    emitter = bd.AlignedBoxRegion(lower=(-bw, INLET_HEIGHT),
                                  upper=(-bw + LL, INLET_HEIGHT + LH), axis=0)

    xs = np.arange(-bw + dx / 2, -bw + LL, dx)
    ys = np.arange(INLET_HEIGHT + dx / 2, INLET_HEIGHT + LH, dx)
    pos_seed = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    n_seed = len(pos_seed)
    cap = int(n_seed * RESERVE)
    pos_full = np.full((cap, 2), float(FAR_AWAY))
    pos_full[:n_seed] = pos_seed
    fluid = make_fluid_state(pos_full, dx * dx, RHO0_F, dtype, device)
    fluid["Alive"] = torch.arange(cap, device=device) < n_seed
    fluid["Velocity"] = torch.stack(
        [torch.full((cap,), U_JET, dtype=dtype, device=device),
         fluid["Velocity"][:, 1]], dim=-1)

    # the wall: the frame less the tank's inside less the inlet notch
    outer = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                  halfsize=(DL / 2 + bw, DH / 2 + bw))
    inner = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                  halfsize=(DL / 2, DH / 2))
    notch = G.Box(G.Transform(translation=(-bw + LL / 2,
                                           INLET_HEIGHT + LH / 2)),
                  halfsize=(LL / 2, LH / 2))
    wall_shape = G.make_complex(("add", outer), ("sub", inner),
                                ("sub", notch))
    pos_w, _ = generate_lattice(wall_shape, (-bw - dx, -bw - dx),
                                (DL + bw + dx, DH + bw + dx), dx)
    wall = make_solid_state(pos_w, dx * dx, RHO0_F, dtype, device)
    wall = gd.normal_direction_from_shape(wall, wall_shape)

    grid = grid_from_bounds((-bw - 2 * dx, -bw - 2 * dx),
                            (DL + bw + 2 * dx, DH + bw + 2 * dx),
                            adaptation.cutoff)
    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    gravity = gd.Gravity(acceleration=(0.0, -GRAVITY_G))
    fluid = gd.gravity_force(fluid, gravity)
    case = FillingTankCase(
        dx=dx, adaptation=adaptation, grid=grid, eos=eos,
        riemann=rs.acoustic_riemann(eos), gravity=gravity, wall=wall,
        wall_table=build_cell_table(wall["Position"], wall["NReal"], grid,
                                    cell_cap),
        emitter=emitter, n_seed=n_seed, cell_cap=cell_cap, k_inner=k_inner,
        k_wall=k_wall)
    return case, fluid


def rebuild_relations(case: FillingTankCase, fluid: dict):
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


def init_sim(case: FillingTankCase, fluid: dict) -> SimState:
    nl_inner, nl_wall = rebuild_relations(case, fluid)
    pos = fluid["Position"]
    return SimState(fluid=dict(fluid), nl_inner=nl_inner, nl_wall=nl_wall,
                    time=torch.zeros((), dtype=pos.dtype, device=pos.device),
                    n_adv=0, n_ac=0,
                    overflow=torch.zeros((), dtype=torch.bool,
                                         device=pos.device))


def _in_box(pos, region: bd.AlignedBoxRegion):
    """region.contains with its bounds as Python numbers (no copy to the
    device)."""
    inside = torch.ones(pos.shape[0], dtype=torch.bool, device=pos.device)
    for d, (lo, hi) in enumerate(zip(region.lower, region.upper)):
        inside = inside & (pos[:, d] >= lo) & (pos[:, d] <= hi)
    return inside


def inflow_condition(case: FillingTankCase, fluid: dict) -> dict:
    """EmitterInflowCondition (fluid_boundary.cpp:50-59): velocity,
    density and pressure forced on the live particles in the emitter
    box."""
    in_box = fluid["Alive"] & _in_box(fluid["Position"], case.emitter)
    vel = fluid["Velocity"]
    return dict(
        fluid,
        Velocity=torch.stack([torch.where(in_box, U_JET, vel[:, 0]),
                              torch.where(in_box, 0.0, vel[:, 1])], dim=-1),
        Density=torch.where(in_box, RHO0_F, fluid["Density"]),
        Pressure=torch.where(in_box, case.eos.pressure(RHO0_F),
                             fluid["Pressure"]))


def advection_prep(case: FillingTankCase, s: SimState) -> dict:
    """The free-surface density summation against the wall."""
    return fd.density_summation(
        s.fluid, s.nl_inner, case.kernel, 2, RHO0_F, case.adaptation.sigma0,
        contacts=[(case.wall, s.nl_wall, RHO0_F)], free_surface=True)


def acoustic_substep(case: FillingTankCase, s: SimState, fluid: dict, dt_adv):
    """Both acoustic halves against the wall, each followed by the inflow
    condition.  Returns (fluid, dt)."""
    kernel, h = case.kernel, case.adaptation.h
    dt = torch.minimum(fd.acoustic_time_step(fluid, case.eos, h), dt_adv)
    fluid = fd.acoustic_step_1st_half(fluid, s.nl_inner, kernel, 2, case.eos,
                                      case.riemann, dt, wall=case.wall,
                                      nl_wall=s.nl_wall)
    fluid = inflow_condition(case, fluid)
    fluid = fd.acoustic_step_2nd_half(fluid, s.nl_inner, kernel, 2,
                                      case.riemann, dt, wall=case.wall,
                                      nl_wall=s.nl_wall)
    return inflow_condition(case, fluid), dt


def _advection_step(case: FillingTankCase, s: SimState) -> SimState:
    pos_prev = s.fluid["Position"]
    dt_adv = fd.advection_time_step(s.fluid, case.adaptation.h, U_F)
    fluid = advection_prep(case, s)
    relax_t = torch.zeros_like(dt_adv)
    n_ac = 0
    while bool(relax_t < dt_adv):          # one host read per sub-step
        fluid, dt = acoustic_substep(case, s, fluid, dt_adv)
        relax_t = relax_t + dt
        n_ac += 1
    fluid = bd.emitter_inflow_injection(fluid, case.emitter,
                                        prev_pos=pos_prev)
    inj_ovf = fluid.pop("_InjectionOverflow")
    nl_inner, nl_wall = rebuild_relations(case, fluid)
    return SimState(fluid=fluid, nl_inner=nl_inner, nl_wall=nl_wall,
                    time=s.time + relax_t, n_adv=s.n_adv + 1,
                    n_ac=s.n_ac + n_ac,
                    overflow=s.overflow | nl_inner.overflow
                    | nl_wall.overflow | inj_ovf)


def make_advection_step(case: FillingTankCase):
    return lambda s: _advection_step(case, s)


def make_run_chunk(case: FillingTankCase):
    """run_chunk(sim, t_target): advection steps until sim.time >=
    t_target."""
    return chunk_runner(lambda s: _advection_step(case, s))


def n_alive(s: SimState) -> int:
    return int(torch.sum(s.fluid["Alive"]))


def mechanical_energy(case: FillingTankCase, s: SimState) -> float:
    return float(gd.total_mechanical_energy(s.fluid, case.gravity))
