"""Water entry (and exit) of a free rigid cylinder that the water wets
(counterpart of sphinxsys_tpu/cases/water_entry_exit_2d.py; reference
tests/2d_examples/test_2d_water_entry_exit/test_2d_water_entry_exit.cpp):
a light cylinder (rho = 0.5) falls from above a resting water column,
enters, submerges and rebounds, while a wetting species Phi diffuses from
the water (Phi = 1, a Dirichlet contact) into the dry cylinder (Phi = 0,
diffusivity 100 dx^2).  The reference's free planar Simbody mobilizer
under gravity is the planar rigid body of physics/rigid.py.

Each acoustic sub-step: the fluid's first half against the wall and the
cylinder, the cylinder's pressure force and rigid step, the rigid motion
imposed on its particles, the fluid's second half against the moved
cylinder, then the cylinder's RK2 wetting step.  The free-surface density
is the plain clamp (rho >= rho0), as the JAX package's.  Both loops are
host loops, one host read of each condition.

Observables: the cylinder's centre (CylinderObserver Position) and Phi
at its bottom particle (WettingObserver Phi).

    case, fluid = build_case(dx=2 * R_CYL / 10, device="cpu")
    sim = make_run_chunk(case)(init_sim(case, fluid), 0.01)
    print(center_position(sim), bottom_wetting(case, sim))
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from sphinxsys_tpu_torch.cases.floating_body_2d import (hydrostatic,
                                                        move_block,
                                                        rigid_block)
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
from sphinxsys_tpu_torch.physics import diffusion as df
from sphinxsys_tpu_torch.physics import fluid as fd
from sphinxsys_tpu_torch.physics import fsi
from sphinxsys_tpu_torch.physics import general as gd
from sphinxsys_tpu_torch.physics import rigid as rg
from sphinxsys_tpu_torch.physics import riemann as rs
from sphinxsys_tpu_torch.solver import chunk_runner

R_CYL = 0.055
DL = 8.0 * R_CYL
DH = 7.0 * R_CYL
LH = 3.0 * R_CYL                   # water depth
CYL_CY = LH + 0.15                 # the centre's initial height
RHO0_F = 1.0
RHO0_S = 0.5
GRAVITY_G = 9.81
U_MAX = 2.0 * math.sqrt(GRAVITY_G * LH)
C_F = 10.0 * U_MAX
MU_F = 8.9e-7


@dataclasses.dataclass
class SimState:
    """The fluid, the cylinder's particles and its rigid state, the five
    lists (fluid inner, fluid -> wall, fluid -> cylinder, cylinder ->
    fluid, cylinder inner), the time, the step counts, the overflow."""

    fluid: dict
    cyl: dict
    rb: rg.RigidBody2D
    nl_ff: NeighborList
    nl_fw: NeighborList
    nl_fc: NeighborList
    nl_cf: NeighborList
    nl_cc: NeighborList
    time: torch.Tensor
    n_adv: int
    n_ac: int
    overflow: torch.Tensor


@dataclasses.dataclass(frozen=True)
class EntryCase:
    dx: float
    adaptation: SPHAdaptation
    grid: CellGrid
    eos: WeaklyCompressibleFluid
    riemann: rs.AcousticRiemannSolver
    gravity: gd.Gravity
    g_vec: torch.Tensor
    wall: Any
    wall_table: CellTable
    block0: Any              # the cylinder at t = 0
    rb0: rg.RigidBody2D
    mask_b: torch.Tensor
    diffusion: df.IsotropicDiffusion
    bottom_idx: int          # the wetting observer: the bottom particle
    n_fluid: int
    n_wall: int
    n_cyl: int
    cell_cap: int
    k_inner: int
    k_contact: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = 2.0 * R_CYL / 40.0, dtype=PRODUCTION_DTYPE,
               cell_cap: int = 24, k_inner: int = 64, k_contact: int = 40,
               device="cuda"):
    """The water column at its hydrostatic pressure (Phi = 1), the tank
    wall, the dry cylinder above it.  Returns (case, fluid)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    bw = 4 * dx
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    water_shape = G.Box(G.Transform(translation=(DL / 2, LH / 2)),
                        halfsize=(DL / 2, LH / 2))
    outer = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                  halfsize=(DL / 2 + bw, DH / 2 + bw))
    inner = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                  halfsize=(DL / 2, DH / 2))
    wall_shape = G.make_complex(("add", outer), ("sub", inner))
    cyl_shape = G.Ball(center=(DL / 2, CYL_CY), radius=R_CYL)

    dom_lo, dom_hi = (-bw, -bw), (DL + bw, DH + bw)
    pos_f, vol = generate_lattice(water_shape, dom_lo, dom_hi, dx)
    pos_w, _ = generate_lattice(wall_shape, dom_lo, dom_hi, dx)
    pos_c, _ = generate_lattice(cyl_shape, dom_lo, dom_hi, dx)
    n_f, n_c = len(pos_f), len(pos_c)

    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    fluid = make_fluid_state(pos_f, vol, RHO0_F, dtype, device)
    fluid = hydrostatic(fluid, pos_f, eos, LH, GRAVITY_G, clamp=False)
    fluid["Phi"] = torch.ones(n_f, dtype=dtype, device=device)
    zeros_v = torch.zeros_like(fluid["Position"])
    # the viscous and gravity priors' bookkeeping (gd.gravity_force's
    # delta form beside the viscous force)
    for key in ("ViscousForce", "ViscousForcePrev", "GravityForcePrev"):
        fluid[key] = zeros_v.clone()
    fluid["Indicator"] = torch.zeros(n_f, dtype=torch.int32, device=device)
    fluid["PreviousSurfaceIndicator"] = torch.ones(n_f, dtype=torch.int32,
                                                   device=device)
    fluid["PositionDivergence"] = torch.zeros(n_f, dtype=dtype, device=device)

    wall = make_solid_state(pos_w, vol, RHO0_F, dtype, device)
    wall = gd.normal_direction_from_shape(wall, wall_shape)

    cyl = rigid_block(pos_c, vol, RHO0_S, cyl_shape, dtype, device,
                      keys=("PressureForceFromFluid", "ViscousForceFromFluid"))
    cyl["Phi"] = torch.zeros(n_c, dtype=dtype, device=device)
    mask_b = torch.ones(n_c, dtype=torch.bool, device=device)
    rb0 = rg.rigid_body_from_particles(cyl, mask_b)

    gravity = gd.Gravity(acceleration=(0.0, -GRAVITY_G))
    fluid = gd.gravity_force(fluid, gravity)
    grid = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff)
    case = EntryCase(
        dx=dx, adaptation=adaptation, grid=grid, eos=eos,
        riemann=rs.acoustic_riemann(eos), gravity=gravity,
        g_vec=torch.tensor(gravity.acceleration, dtype=dtype, device=device),
        wall=wall,
        wall_table=build_cell_table(wall["Position"], wall["NReal"], grid,
                                    cell_cap),
        block0=cyl, rb0=rb0, mask_b=mask_b,
        diffusion=df.IsotropicDiffusion(100.0 * dx * dx),
        bottom_idx=int(np.argmin(np.asarray(pos_c)[:, 1])), n_fluid=n_f,
        n_wall=len(pos_w), n_cyl=n_c, cell_cap=cell_cap, k_inner=k_inner,
        k_contact=k_contact)
    return case, fluid


def rebuild(case: EntryCase, fluid: dict, cyl: dict):
    """The fluid's and the cylinder's tables and the five lists.  Returns
    (fluid inner, fluid -> wall, fluid -> cylinder, cylinder -> fluid,
    cylinder inner, overflow)."""
    pos, n_f = fluid["Position"], fluid["NReal"]
    cpos, n_c = cyl["Position"], cyl["NReal"]
    cutoff, grid, cap = case.adaptation.cutoff, case.grid, case.cell_cap
    table_f = build_cell_table(pos, n_f, grid, cap)
    table_c = build_cell_table(cpos, n_c, grid, cap)
    nl_ff = build_neighbor_list(pos, n_f, pos, n_f, table_f, grid, cutoff,
                                k_max=case.k_inner, include_self=False)
    nl_fw = build_neighbor_list(pos, n_f, case.wall["Position"],
                                case.wall["NReal"], case.wall_table, grid,
                                cutoff, k_max=case.k_contact,
                                include_self=True)
    nl_fc = build_neighbor_list(pos, n_f, cpos, n_c, table_c, grid, cutoff,
                                k_max=case.k_contact, include_self=True)
    nl_cf = build_neighbor_list(cpos, n_c, pos, n_f, table_f, grid, cutoff,
                                k_max=case.k_contact, include_self=True)
    nl_cc = build_neighbor_list(cpos, n_c, cpos, n_c, table_c, grid, cutoff,
                                k_max=case.k_inner, include_self=False)
    ovf = (nl_ff.overflow | nl_fw.overflow | nl_fc.overflow
           | nl_cf.overflow | nl_cc.overflow)
    return nl_ff, nl_fw, nl_fc, nl_cf, nl_cc, ovf


def init_sim(case: EntryCase, fluid: dict) -> SimState:
    cyl = dict(case.block0)
    *nls, ovf = rebuild(case, fluid, cyl)
    pos = fluid["Position"]
    return SimState(fluid=dict(fluid), cyl=cyl, rb=case.rb0, nl_ff=nls[0],
                    nl_fw=nls[1], nl_fc=nls[2], nl_cf=nls[3], nl_cc=nls[4],
                    time=torch.zeros((), dtype=pos.dtype, device=pos.device),
                    n_adv=0, n_ac=0, overflow=ovf)


def advection_prep(case: EntryCase, s: SimState):
    """The free-surface indication, the density summation, the viscous
    force, the bulk-scoped transport shift and the cylinder's viscous
    force (test_2d_water_entry_exit.cpp:291-298).  Returns (fluid,
    cylinder)."""
    kernel, h = case.kernel, case.adaptation.h
    fluid, cyl = s.fluid, s.cyl
    contacts = [(case.wall, s.nl_fw, RHO0_F), (cyl, s.nl_fc, RHO0_S)]
    walls = [(case.wall, s.nl_fw), (cyl, s.nl_fc)]
    fluid = fd.free_surface_indication(fluid, s.nl_ff, kernel, 2,
                                       contacts=contacts,
                                       spatial_temporal=True)
    fluid = fd.density_summation(fluid, s.nl_ff, kernel, 2, RHO0_F,
                                 case.adaptation.sigma0, contacts=contacts,
                                 free_surface=True)
    fluid = fd.viscous_force(fluid, s.nl_ff, kernel, 2, MU_F, h, walls=walls)
    fluid = fd.transport_velocity_correction(
        fluid, s.nl_ff, kernel, 2, h, walls=walls,
        scope_mask=fluid["Indicator"] == 0)
    cyl = fsi.viscous_force_from_fluid(cyl, fluid, s.nl_cf, kernel, 2, MU_F,
                                       h)
    return fluid, cyl


def acoustic_substep(case: EntryCase, s: SimState, f: dict, c: dict,
                     r: rg.RigidBody2D, dt_adv):
    """One sub-step: the fluid's halves around the cylinder's pressure
    force and rigid step, then the cylinder's wetting (Phi diffusing in
    from the water through the Dirichlet contact).  Returns (fluid,
    cylinder, rigid state, dt)."""
    kernel, h = case.kernel, case.adaptation.h
    dt = torch.minimum(fd.acoustic_time_step(f, case.eos, h), dt_adv)
    f = fd.acoustic_step_1st_half(f, s.nl_ff, kernel, 2, case.eos,
                                  case.riemann, dt,
                                  walls=[(case.wall, s.nl_fw), (c, s.nl_fc)])
    c = fsi.pressure_force_from_fluid(c, f, s.nl_cf, kernel, 2, case.riemann)
    force, torque = rg.total_force_and_torque(c, case.mask_b, r,
                                              force_keys=("ForcePrior",))
    r_new = rg.rigid_step(r, force, torque, dt, gravity=case.g_vec)
    c = move_block(case, c, r, r_new, dt)
    c["AverageVelocity"] = r_new.vel.expand_as(c["Position"])
    f = fd.acoustic_step_2nd_half(f, s.nl_ff, kernel, 2, case.riemann, dt,
                                  walls=[(case.wall, s.nl_fw), (c, s.nl_fc)])
    c = df.diffusion_step_rk2(c, "Phi", s.nl_cc, kernel, 2, case.diffusion,
                              dt, dirichlet_contacts=[(f, s.nl_cf)])
    return f, c, r_new, dt


def _advection_step(case: EntryCase, s: SimState) -> SimState:
    dt_adv = fd.advection_time_step(s.fluid, case.adaptation.h, U_MAX)
    fluid, cyl = advection_prep(case, s)
    rb = s.rb
    relax_t = torch.zeros_like(dt_adv)
    n_ac = 0
    while bool(relax_t < dt_adv):          # one host read per sub-step
        fluid, cyl, rb, dt = acoustic_substep(case, s, fluid, cyl, rb,
                                              dt_adv)
        relax_t = relax_t + dt
        n_ac += 1
    *nls, ovf = rebuild(case, fluid, cyl)
    return SimState(fluid=fluid, cyl=cyl, rb=rb, nl_ff=nls[0], nl_fw=nls[1],
                    nl_fc=nls[2], nl_cf=nls[3], nl_cc=nls[4],
                    time=s.time + relax_t, n_adv=s.n_adv + 1,
                    n_ac=s.n_ac + n_ac, overflow=s.overflow | ovf)


def make_advection_step(case: EntryCase):
    return lambda s: _advection_step(case, s)


def make_run_chunk(case: EntryCase):
    """run_chunk(sim, t_target): advection steps until sim.time >=
    t_target."""
    return chunk_runner(make_advection_step(case))


def center_position(s: SimState):
    """CylinderObserver Position: the rigid centre, (2,) on the host."""
    return s.rb.com.double().cpu().numpy()


def bottom_wetting(case: EntryCase, s: SimState) -> float:
    """WettingObserver Phi at the cylinder's bottom particle."""
    return float(s.cyl["Phi"][case.bottom_idx])
