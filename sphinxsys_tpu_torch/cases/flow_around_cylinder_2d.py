"""2D flow around a cylinder at Re = 100 (counterpart of
sphinxsys_tpu/cases/flow_around_cylinder_2d.py; reference tests/
2d_examples/test_2d_flow_around_cylinder/2d_flow_around_cylinder.{h,cpp}):
a 15 x 10 free-stream domain, doubly periodic with sponge bands, the
cylinder r = 0.75 at (4, 5) on a 2x finer lattice relaxed to its shape
(`relax_cyl` iterations of physics/relax.py's `relax_shape`), the ramped
free stream U = 0.5 U_f (1 - cos(pi t / 2)) relaxed into the buffer
(left of x = 0 and the bands above and below the channel) after each
acoustic sub-step, viscous and transport-velocity-corrected WCSPH, and
the total viscous force on the cylinder as the regression quantity
(Cylinder_TotalViscousForceFromFluid).

The buffer is re-tagged from the current positions each sub-step; the
periodic wrap plays both PeriodicConditionUsingCellLinkedList axes.  The
relaxation's jitter is the port's seeded torch.Generator, not JAX's bits
(physics/relax.py): the parity tests carry the JAX package's relaxed
cylinder across (`relax_cyl=0` on this side).

    case, fluid, cyl = build_case(relax_cyl=0, device="cpu")   # 4,546 + 172
    sim = make_run_chunk(case)(init_sim(case, fluid, cyl), 0.5)
    print(total_viscous_force(sim))
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sphinxsys_tpu_torch.core import geometry as G
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.generators import generate_lattice
from sphinxsys_tpu_torch.core.materials import WeaklyCompressibleFluid
from sphinxsys_tpu_torch.core.state import make_fluid_state, make_solid_state
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.neighbors.cell_list import (CellGrid,
                                                    build_cell_table,
                                                    grid_from_bounds,
                                                    wrap_positions)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list)
from sphinxsys_tpu_torch.physics import fluid as fd
from sphinxsys_tpu_torch.physics import fsi
from sphinxsys_tpu_torch.physics import general as gd
from sphinxsys_tpu_torch.physics import riemann as rs
from sphinxsys_tpu_torch.physics.relax import relax_shape
from sphinxsys_tpu_torch.solver import chunk_runner

DL = 15.0
DH = 10.0
DX = 0.2
DL_SPONGE = DX * 10.0
DH_SPONGE = DX * 2.0
CX, CY = 4.0, 5.0
R_CYL = 0.75
RHO0_F = 1.0
U_F = 1.0
C_F = 10.0 * U_F
RE = 100.0
MU_F = RHO0_F * U_F * (2.0 * R_CYL) / RE
T_RAMP = 2.0


@dataclasses.dataclass
class SimState:
    """The carry: the fluid, the cylinder with its accumulated fluid
    forces, the three lists, the time (0-d tensor), the advection and
    acoustic step counts and the overflow flag."""

    fluid: dict
    cyl: dict
    nl_inner: NeighborList
    nl_fw: NeighborList      # fluid -> cylinder (the wall terms)
    nl_wf: NeighborList      # cylinder -> fluid (the force recorders)
    time: torch.Tensor
    n_adv: int
    n_ac: int
    overflow: torch.Tensor


@dataclasses.dataclass(frozen=True)
class CylinderCase:
    dx: float
    adaptation: SPHAdaptation
    grid: CellGrid
    eos: WeaklyCompressibleFluid
    riemann: rs.AcousticRiemannSolver
    no_riemann: rs.NoRiemannSolver
    n_fluid: int
    cell_cap: int
    k_inner: int
    k_contact: int

    @property
    def kernel(self):
        return self.adaptation.kernel

    @property
    def box(self):
        return self.grid.periodic_lengths


def build_case(dx: float = DX, dtype=PRODUCTION_DTYPE, cell_cap: int = 24,
               k_inner: int = 64, k_contact: int = 96, relax_cyl: int = 200,
               device="cuda"):
    """The water less the cylinder, the cylinder's 2x finer lattice relaxed
    to its shape (on `device`) with its shape normals and force
    recorders, the doubly periodic grid.  Returns (case, fluid, cyl)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    dom_lo = (-DL_SPONGE, -DH_SPONGE)
    dom_hi = (DL, DH + DH_SPONGE)

    cyl_shape = G.Ball(center=(CX, CY), radius=R_CYL)
    water_shape = G.make_complex(
        ("add", G.Box(G.Transform(translation=((DL - DL_SPONGE) / 2, DH / 2)),
                      halfsize=((DL + DL_SPONGE) / 2, DH / 2 + DH_SPONGE))),
        ("sub", cyl_shape))
    pos_f, vol = generate_lattice(water_shape, dom_lo, dom_hi, dx)
    # the cylinder 2x refined (defineAdaptationRatios(1.15, 2.0),
    # 2d_flow_around_cylinder.cpp:36): a finer surface quadrature for the
    # wall terms, whose pairs still take the fluid's kernel
    pos_c, vol_c = generate_lattice(cyl_shape, dom_lo, dom_hi, dx / 2.0)
    if relax_cyl > 0:
        # the body-fitted cylinder (defineBodyLevelSetShape +
        # RelaxationStepInner, 2d_flow_around_cylinder.cpp:37,63-99)
        adapt_c = SPHAdaptation(spacing=dx / 2.0, dim=2, h_spacing_ratio=1.15)
        grid_c = grid_from_bounds(dom_lo, dom_hi, adapt_c.cutoff)
        pos_c = relax_shape(
            cyl_shape, torch.as_tensor(pos_c, dtype=dtype, device=device),
            float(vol_c), adapt_c, grid_c, n_iterations=relax_cyl,
            cell_cap=32, k_max=48).cpu().numpy()

    fluid = make_fluid_state(pos_f, vol, RHO0_F, dtype, device)
    fluid["ViscousForce"] = torch.zeros_like(fluid["Velocity"])
    fluid["ViscousForcePrev"] = torch.zeros_like(fluid["Velocity"])

    cyl = make_solid_state(pos_c, vol_c, RHO0_F, dtype, device)
    cyl = gd.normal_direction_from_shape(cyl, cyl_shape)
    zeros = torch.zeros_like(cyl["Velocity"])
    for key in ("ForcePrior", "AverageVelocity", "AverageAcceleration",
                "ViscousForceFromFluid", "PressureForceFromFluid",
                "PreviousPressureForceFromFluid",
                "PreviousViscousForceFromFluid"):
        cyl[key] = zeros

    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    grid = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff,
                            periodic=(True, True))
    case = CylinderCase(dx=dx, adaptation=adaptation, grid=grid, eos=eos,
                        riemann=rs.acoustic_riemann(eos),
                        no_riemann=rs.no_riemann(eos), n_fluid=len(pos_f),
                        cell_cap=cell_cap, k_inner=k_inner,
                        k_contact=k_contact)
    return case, fluid, cyl


def rebuild_relations(case: CylinderCase, fluid: dict, cyl: dict):
    """The fluid's positions wrapped into the box, its cell table, the
    cylinder's (dx/2 particles: up to 27 a cell, twice the cap), and the
    three lists.  Returns (pos, nl_inner, nl_fw, nl_wf, overflow)."""
    pos = wrap_positions(fluid["Position"], case.grid)
    n_f = fluid["NReal"]
    cutoff = case.adaptation.cutoff
    table_f = build_cell_table(pos, n_f, case.grid, case.cell_cap)
    table_c = build_cell_table(cyl["Position"], cyl["NReal"], case.grid,
                               2 * case.cell_cap)
    nl_inner = build_neighbor_list(pos, n_f, pos, n_f, table_f, case.grid,
                                   cutoff, k_max=case.k_inner,
                                   include_self=False)
    nl_fw = build_neighbor_list(pos, n_f, cyl["Position"], cyl["NReal"],
                                table_c, case.grid, cutoff,
                                k_max=case.k_contact, include_self=True)
    nl_wf = build_neighbor_list(cyl["Position"], cyl["NReal"], pos, n_f,
                                table_f, case.grid, cutoff,
                                k_max=case.k_inner, include_self=True)
    ovf = nl_inner.overflow | nl_fw.overflow | nl_wf.overflow
    return pos, nl_inner, nl_fw, nl_wf, ovf


def init_sim(case: CylinderCase, fluid: dict, cyl: dict) -> SimState:
    pos, nl_inner, nl_fw, nl_wf, ovf = rebuild_relations(case, fluid, cyl)
    return SimState(fluid=dict(fluid, Position=pos), cyl=dict(cyl),
                    nl_inner=nl_inner, nl_fw=nl_fw, nl_wf=nl_wf,
                    time=torch.zeros((), dtype=pos.dtype, device=pos.device),
                    n_adv=0, n_ac=0, overflow=ovf)


def freestream_velocity(t):
    """The FreeStreamCondition ramp (2d_flow_around_cylinder.h:122-126) at
    the 0-d tensor t, in its dtype."""
    ramp = 0.5 * U_F * (1.0 - torch.cos(math.pi * t / T_RAMP))
    return torch.where(t < T_RAMP, ramp, torch.full_like(t, U_F))


def _buffer_mask(pos):
    """createBufferShape: the inlet sponge and the bands above and below
    the channel (2d_flow_around_cylinder.h:52-68), from the current
    positions."""
    x, y = pos[:, 0], pos[:, 1]
    return (x < 0.0) | (y < 0.0) | (y > DH)


def freestream_condition(fluid: dict, t) -> dict:
    """The buffer's velocity relaxed toward the ramped free stream at t
    (FlowVelocityBuffer, rate 0.3, fluid_boundary.cpp:18-21)."""
    vel = fluid["Velocity"]
    target = torch.stack([freestream_velocity(t).expand_as(vel[:, 0]),
                          torch.zeros_like(vel[:, 1])], dim=-1)
    return dict(fluid, Velocity=torch.where(
        _buffer_mask(fluid["Position"])[:, None],
        vel + 0.3 * (target - vel), vel))


def advection_prep(case: CylinderCase, s: SimState):
    """The density summation (no free surface), the viscous force, the
    viscous force on the cylinder (recorded once an advection step, as in
    the reference) and the transport-velocity correction.  Returns
    (fluid, cyl)."""
    kernel, h, box = case.kernel, case.adaptation.h, case.box
    walls = [(s.cyl, s.nl_fw)]
    fluid = fd.density_summation(s.fluid, s.nl_inner, kernel, 2, RHO0_F,
                                 case.adaptation.sigma0,
                                 contacts=[(s.cyl, s.nl_fw, RHO0_F)],
                                 free_surface=False, box=box)
    fluid = fd.viscous_force(fluid, s.nl_inner, kernel, 2, MU_F, h,
                             walls=walls, box=box)
    cyl = fsi.viscous_force_from_fluid(s.cyl, fluid, s.nl_wf, kernel, 2,
                                       MU_F, h, box=box)
    fluid = fd.transport_velocity_correction(fluid, s.nl_inner, kernel, 2, h,
                                             walls=walls, box=box)
    return fluid, cyl


def acoustic_substep(case: CylinderCase, s: SimState, fluid: dict,
                     cyl: dict, dt_adv, t_now):
    """One acoustic sub-step from t_now: the 1st half, the pressure force
    on the cylinder, the 2nd half (no Riemann dissipation), then the free
    stream at t_now + dt.  Returns (fluid, cyl, dt)."""
    kernel, h, box = case.kernel, case.adaptation.h, case.box
    walls = [(s.cyl, s.nl_fw)]
    dt = torch.minimum(fd.acoustic_time_step(fluid, case.eos, h), dt_adv)
    fluid = fd.acoustic_step_1st_half(fluid, s.nl_inner, kernel, 2, case.eos,
                                      case.riemann, dt, walls=walls, box=box)
    cyl = fsi.pressure_force_from_fluid(cyl, fluid, s.nl_wf, kernel, 2,
                                        case.riemann, box=box)
    fluid = fd.acoustic_step_2nd_half(fluid, s.nl_inner, kernel, 2,
                                      case.no_riemann, dt, walls=walls,
                                      box=box)
    return freestream_condition(fluid, t_now + dt), cyl, dt


def _advection_step(case: CylinderCase, s: SimState) -> SimState:
    dt_adv = fd.advection_viscous_time_step(s.fluid, case.adaptation.h, U_F,
                                            RHO0_F, MU_F)
    fluid, cyl = advection_prep(case, s)
    relax_t = torch.zeros_like(dt_adv)
    n_ac = 0
    while bool(relax_t < dt_adv):          # one host read per sub-step
        fluid, cyl, dt = acoustic_substep(case, s, fluid, cyl, dt_adv,
                                          s.time + relax_t)
        relax_t = relax_t + dt
        n_ac += 1
    pos, nl_inner, nl_fw, nl_wf, ovf = rebuild_relations(case, fluid, cyl)
    return SimState(fluid=dict(fluid, Position=pos), cyl=cyl,
                    nl_inner=nl_inner, nl_fw=nl_fw, nl_wf=nl_wf,
                    time=s.time + relax_t, n_adv=s.n_adv + 1,
                    n_ac=s.n_ac + n_ac, overflow=s.overflow | ovf)


def make_advection_step(case: CylinderCase):
    return lambda s: _advection_step(case, s)


def make_run_chunk(case: CylinderCase):
    """run_chunk(sim, t_target): advection steps until sim.time >=
    t_target."""
    return chunk_runner(lambda s: _advection_step(case, s))


def total_viscous_force(s: SimState) -> np.ndarray:
    """Cylinder_TotalViscousForceFromFluid (QuantitySummation)."""
    n = s.cyl["NReal"]
    return torch.sum(s.cyl["ViscousForceFromFluid"][:n], dim=0).cpu().numpy()
