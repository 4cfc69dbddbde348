"""2D lid-driven cavity of a shear-thinning fluid (counterpart of
sphinxsys_tpu/cases/lid_driven_cavity_2d.py; reference tests/2d_examples/
test_2d_lid_driven_cavity_non_newtonian/lid_driven_cavity.cpp): a unit
cavity of Herschel-Bulkley fluid (K = 1, n = 0.5, tau_y = 0) under a lid
moving at U = 1.  Each advection step: the density summation against the
wall, the velocity gradient and the shear-rate-dependent viscosity, the
non-Newtonian viscous force, the transport-velocity correction; then the
acoustic sub-steps.  The advection step is min(advection dt, SRD viscous
dt) (lid_driven_cavity.cpp:210-213).

    case, fluid = build_case(dx=0.05, device="cpu")     # 400 + 336 wall
    sim = make_run_chunk(case)(init_sim(case, fluid), 0.1)

The advection step and its acoustic loop are host loops, one host read of
each loop's condition.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from sphinxsys_tpu_torch.core import geometry as G
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.generators import generate_lattice
from sphinxsys_tpu_torch.core.materials import WeaklyCompressibleFluid
from sphinxsys_tpu_torch.core.state import make_fluid_state, make_solid_state
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.neighbors.cell_list import (CellGrid, CellTable,
                                                    build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list)
from sphinxsys_tpu_torch.physics import fluid as fd
from sphinxsys_tpu_torch.physics import general as gd
from sphinxsys_tpu_torch.physics import riemann as rs
from sphinxsys_tpu_torch.physics import viscosity as vc
from sphinxsys_tpu_torch.solver import chunk_runner

L = 1.0
RHO0 = 1000.0
U_LID = 1.0
C_F = 10.0 * U_LID


@dataclasses.dataclass
class SimState:
    fluid: dict
    nl_inner: NeighborList
    nl_fw: NeighborList
    time: torch.Tensor
    n_adv: int
    n_ac: int
    overflow: torch.Tensor


@dataclasses.dataclass(frozen=True)
class CavityCase:
    dx: float
    adaptation: SPHAdaptation
    grid: CellGrid
    eos: WeaklyCompressibleFluid
    riemann: rs.AcousticRiemannSolver
    model: Any
    wall: dict
    wall_table: CellTable
    n_fluid: int
    cell_cap: int
    k_inner: int
    k_contact: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = 0.02, model=None, dtype=PRODUCTION_DTYPE,
               cell_cap: int = 24, k_inner: int = 64, k_contact: int = 40,
               device="cuda"):
    """The fluid at rest in the cavity (its viscosity fields registered),
    the wall with its shape normals, the lid (every wall particle above
    the cavity) moving at U_LID.  Returns (case, fluid)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    if model is None:       # lid_driven_cavity.cpp:16-22
        model = vc.HerschelBulkleyViscosity(
            min_shear_rate=1e-2, max_shear_rate=1e3,
            consistency_index=1.0, power_index=0.5, yield_stress=0.0)
    bw = 4 * dx
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    water_shape = G.Box(G.Transform(translation=(L / 2, L / 2)),
                        halfsize=(L / 2, L / 2))
    outer = G.Box(G.Transform(translation=(L / 2, L / 2)),
                  halfsize=(L / 2 + bw, L / 2 + bw))
    wall_shape = G.make_complex(("add", outer), ("sub", water_shape))
    dom_lo, dom_hi = (-bw, -bw), (L + bw, L + bw)
    pos_f, vol = generate_lattice(water_shape, dom_lo, dom_hi, dx)
    pos_w, _ = generate_lattice(wall_shape, dom_lo, dom_hi, dx)

    fluid = make_fluid_state(pos_f, vol, RHO0, dtype, device)
    n = len(pos_f)
    fluid["VariableViscosity"] = torch.zeros(n, dtype=dtype, device=device)
    fluid["VelocityGradient"] = torch.zeros((n, 2, 2), dtype=dtype,
                                            device=device)
    fluid["ViscousForce"] = torch.zeros_like(fluid["Velocity"])
    fluid["ViscousForcePrev"] = torch.zeros_like(fluid["Velocity"])
    eos = WeaklyCompressibleFluid(rho0=RHO0, c0=C_F)

    wall = make_solid_state(pos_w, vol, RHO0, dtype, device)
    wall = gd.normal_direction_from_shape(wall, wall_shape)
    lid = (wall["Position"][:, 1] > L)[:, None]
    lid_vel = torch.where(lid, torch.tensor([U_LID, 0.0], dtype=dtype,
                                            device=device),
                          torch.zeros_like(wall["Velocity"]))
    wall["Velocity"] = lid_vel
    wall["AverageVelocity"] = lid_vel.clone()

    grid = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff)
    case = CavityCase(dx=dx, adaptation=adaptation, grid=grid, eos=eos,
                      riemann=rs.acoustic_riemann(eos), model=model,
                      wall=wall,
                      wall_table=build_cell_table(wall["Position"],
                                                  wall["NReal"], grid,
                                                  cell_cap),
                      n_fluid=n, cell_cap=cell_cap, k_inner=k_inner,
                      k_contact=k_contact)
    return case, fluid


def rebuild(case: CavityCase, fluid: dict):
    """The inner and fluid-wall lists and their overflow flag."""
    pos, n_f = fluid["Position"], fluid["NReal"]
    cutoff = case.adaptation.cutoff
    table = build_cell_table(pos, n_f, case.grid, case.cell_cap)
    nl_inner = build_neighbor_list(pos, n_f, pos, n_f, table, case.grid,
                                   cutoff, k_max=case.k_inner,
                                   include_self=False)
    nl_fw = build_neighbor_list(pos, n_f, case.wall["Position"],
                                case.wall["NReal"], case.wall_table,
                                case.grid, cutoff, k_max=case.k_contact,
                                include_self=True)
    return nl_inner, nl_fw, nl_inner.overflow | nl_fw.overflow


def init_sim(case: CavityCase, fluid: dict) -> SimState:
    nl_inner, nl_fw, ovf = rebuild(case, fluid)
    pos = fluid["Position"]
    return SimState(fluid=dict(fluid), nl_inner=nl_inner, nl_fw=nl_fw,
                    time=torch.zeros((), dtype=pos.dtype, device=pos.device),
                    n_adv=0, n_ac=0, overflow=ovf)


def advection_prep(case: CavityCase, s: SimState):
    """The density summation, the variable viscosity, the advection dt
    (capped by the SRD viscous dt), the non-Newtonian viscous force and
    the transport-velocity correction.  Returns (fluid, dt_adv)."""
    kernel, h = case.kernel, case.adaptation.h
    walls = [(case.wall, s.nl_fw)]
    fluid = fd.density_summation(s.fluid, s.nl_inner, kernel, 2, RHO0,
                                 case.adaptation.sigma0,
                                 contacts=[(case.wall, s.nl_fw, RHO0)],
                                 free_surface=False)
    fluid = vc.update_variable_viscosity(fluid, s.nl_inner, kernel, 2,
                                         case.model)
    dt_adv = torch.minimum(fd.advection_time_step(fluid, h, U_LID),
                           vc.srd_viscous_time_step(fluid, h))
    fluid = vc.viscous_force_variable(fluid, s.nl_inner, kernel, 2, h,
                                      walls=walls)
    fluid = fd.transport_velocity_correction(fluid, s.nl_inner, kernel, 2, h,
                                             walls=walls)
    return fluid, dt_adv


def acoustic_substep(case: CavityCase, s: SimState, fluid: dict, dt_adv):
    """Both acoustic halves against the wall.  Returns (fluid, dt)."""
    kernel, h = case.kernel, case.adaptation.h
    walls = [(case.wall, s.nl_fw)]
    dt = torch.minimum(fd.acoustic_time_step(fluid, case.eos, h), dt_adv)
    fluid = fd.acoustic_step_1st_half(fluid, s.nl_inner, kernel, 2, case.eos,
                                      case.riemann, dt, walls=walls)
    fluid = fd.acoustic_step_2nd_half(fluid, s.nl_inner, kernel, 2,
                                      case.riemann, dt, walls=walls)
    return fluid, dt


def _advection_step(case: CavityCase, s: SimState) -> SimState:
    fluid, dt_adv = advection_prep(case, s)
    relax_t = torch.zeros_like(dt_adv)
    n_ac = 0
    while bool(relax_t < dt_adv):          # one host read per sub-step
        fluid, dt = acoustic_substep(case, s, fluid, dt_adv)
        relax_t = relax_t + dt
        n_ac += 1
    nl_inner, nl_fw, ovf = rebuild(case, fluid)
    return SimState(fluid=fluid, nl_inner=nl_inner, nl_fw=nl_fw,
                    time=s.time + relax_t, n_adv=s.n_adv + 1,
                    n_ac=s.n_ac + n_ac, overflow=s.overflow | ovf)


def make_advection_step(case: CavityCase):
    return lambda s: _advection_step(case, s)


def make_run_chunk(case: CavityCase):
    """run_chunk(sim, t_target): advection steps until sim.time >=
    t_target."""
    return chunk_runner(lambda s: _advection_step(case, s))


def kinetic_energy(s: SimState) -> float:
    """TotalKineticEnergy of the fluid (the golden curve's quantity)."""
    return float(gd.total_kinetic_energy(s.fluid))
