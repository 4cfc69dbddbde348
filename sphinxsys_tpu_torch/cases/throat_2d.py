"""Oldroyd-B viscoelastic flow through a channel with a throat
(counterpart of sphinxsys_tpu/cases/throat_2d.py; reference tests/
2d_examples/test_2d_throat/throat.cpp): an x-periodic channel DL = 24,
DH = 4 necking down to DT = 1 over its middle third, filled with an
Oldroyd-B fluid (mu from Re = 0.001, mu_p = 0.6 mu, lambda = 10) and
driven by a body force g = 1 along x.  Each acoustic sub-step
(throat.cpp:244-256):

    the implicit viscous damping (inner and wall, eta = mu), by the
        Jacobi-preconditioned CG of physics/dissipation.py;
    the Oldroyd-B first half: the stress half-step, then the pressure
        relaxation with the polymeric force (physics/oldroyd.py) as its
        extra force;
    the velocity gradient, with the wall term scaled by the distance
        from the wall (the exact SDF of the wall shape);
    the Oldroyd-B second half: the density relaxation, the UCM stress
        rate and the trailing stress half-step.

Periodicity: min-image pair geometry and positions wrapped into the box
at each rebuild.

    case, fluid = build_case(dx=0.4, device="cpu")
    sim = make_run_chunk(case)(init_sim(case, fluid), 0.02)
    print(kinetic_energy(sim))

The advection step and its acoustic loop are host loops, one host read of
each loop's condition; the CG runs all its iterations under a device mask
(no read).
"""

from __future__ import annotations

import dataclasses
import math
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
                                                    grid_from_bounds,
                                                    wrap_positions)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list)
from sphinxsys_tpu_torch.physics import dissipation as dp
from sphinxsys_tpu_torch.physics import fluid as fd
from sphinxsys_tpu_torch.physics import general as gd
from sphinxsys_tpu_torch.physics import oldroyd as ob
from sphinxsys_tpu_torch.physics import riemann as rs
from sphinxsys_tpu_torch.physics import viscosity as vc
from sphinxsys_tpu_torch.solver import chunk_runner

# throat.cpp:20-41
DH = 4.0
DT = 1.0
DL = 24.0
DX = 0.1
BW = 4 * DX
RHO0_F = 1.0
GRAVITY_G = 1.0
RE = 0.001
MU_F = RHO0_F * math.sqrt(0.5 * RHO0_F * (0.5 * DH) ** 3 * GRAVITY_G / RE)
U_C = 0.5 * (0.5 * DH) ** 2 * GRAVITY_G * RHO0_F / MU_F
U_F = U_C * DH / DT
C_F = 10.0 * max(U_F, math.sqrt(MU_F / RHO0_F * U_F / DT))
MODEL = vc.OldroydBViscosity(mu=MU_F, relaxation_time=10.0, mu_p=0.6 * MU_F)


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
class ThroatCase:
    dx: float
    adaptation: SPHAdaptation
    grid: CellGrid
    eos: WeaklyCompressibleFluid
    riemann: rs.AcousticRiemannSolver
    wall: dict
    wall_table: CellTable
    wall_shape: Any
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


def _fluid_shape():
    """The wide left block, the throat band (overlapping the blocks by
    BW) and the wide right block (throat.cpp FluidBlock)."""
    return G.make_complex(
        ("add", G.Box(G.Transform(translation=(-DL / 3.0, 0.0)),
                      halfsize=(DL / 6.0, DH / 2.0))),
        ("add", G.Box(G.Transform(translation=(0.0, 0.0)),
                      halfsize=(DL / 6.0 + BW, DT / 2.0))),
        ("add", G.Box(G.Transform(translation=(DL / 3.0, 0.0)),
                      halfsize=(DL / 6.0, DH / 2.0))))


def _wall_shape():
    """The bounding box less the channel, its blocks extended past the
    periodic seam (throat.cpp WallBoundary)."""
    return G.make_complex(
        ("add", G.Box(G.Transform(translation=(0.0, 0.0)),
                      halfsize=(DL / 2.0 + BW, DH / 2.0 + BW))),
        ("sub", G.Box(G.Transform(translation=(-DL / 3.0 - BW, 0.0)),
                      halfsize=(DL / 6.0 + BW, DH / 2.0))),
        ("sub", G.Box(G.Transform(translation=(0.0, 0.0)),
                      halfsize=(DL / 6.0 + BW, DT / 2.0))),
        ("sub", G.Box(G.Transform(translation=(DL / 3.0 + BW, 0.0)),
                      halfsize=(DL / 6.0 + BW, DH / 2.0))))


def build_case(dx: float = DX, dtype=PRODUCTION_DTYPE, cell_cap: int = 24,
               k_inner: int = 40, k_wall: int = 24, device="cuda"):
    """The fluid at rest in the channel (x in [-DL/2, DL/2)), the driving
    body force in ForcePrior and the Oldroyd-B fields zero; the wall with
    its shape normals; the x-periodic grid.  Returns (case, fluid)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    dom_lo = (-DL / 2.0, -DH / 2.0 - BW)
    dom_hi = (DL / 2.0, DH / 2.0 + BW)

    pos_f, vol = generate_lattice(_fluid_shape(), dom_lo, dom_hi, dx)
    pos_f = pos_f[(pos_f[:, 0] >= -DL / 2.0) & (pos_f[:, 0] < DL / 2.0)]
    fluid = make_fluid_state(pos_f, vol, RHO0_F, dtype, device)
    g = torch.zeros_like(fluid["Velocity"])
    g[:, 0] = GRAVITY_G
    fluid["ForcePrior"] = g * fluid["Mass"][:, None]
    fluid = ob.register_variables(fluid, 2)

    wall_shape = _wall_shape()
    pos_w, _ = generate_lattice(wall_shape, (-DL / 2.0 - BW, dom_lo[1]),
                                (DL / 2.0 + BW, dom_hi[1]), dx)
    pos_w = pos_w[(pos_w[:, 0] >= -DL / 2.0) & (pos_w[:, 0] < DL / 2.0)]
    wall = make_solid_state(pos_w, vol, RHO0_F, dtype, device)
    wall = gd.normal_direction_from_shape(wall, wall_shape)

    grid = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff,
                            periodic=(True, False))
    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    case = ThroatCase(dx=dx, adaptation=adaptation, grid=grid, eos=eos,
                      riemann=rs.acoustic_riemann(eos), wall=wall,
                      wall_table=build_cell_table(wall["Position"],
                                                  wall["NReal"], grid,
                                                  cell_cap),
                      wall_shape=wall_shape, n_fluid=len(pos_f),
                      cell_cap=cell_cap, k_inner=k_inner, k_wall=k_wall)
    return case, fluid


def rebuild_lists(case: ThroatCase, fluid: dict):
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


def init_sim(case: ThroatCase, fluid: dict) -> SimState:
    pos, nl, nlw = rebuild_lists(case, fluid)
    return SimState(fluid=dict(fluid, Position=pos), nl_inner=nl,
                    nl_wall=nlw,
                    time=torch.zeros((), dtype=pos.dtype, device=pos.device),
                    n_adv=0, n_ac=0,
                    overflow=torch.zeros((), dtype=torch.bool,
                                         device=pos.device))


def distance_from_wall(case: ThroatCase, pos):
    """The vector from the nearest wall surface point to each particle,
    sd(x) n(x) from the wall shape's SDF and its autograd gradient."""
    with torch.no_grad():
        sd = case.wall_shape.signed_distance(pos)
    with torch.enable_grad():
        p = pos.detach().clone().requires_grad_(True)
        (n,) = torch.autograd.grad(case.wall_shape.signed_distance(p).sum(),
                                   p)
    n = n / (torch.linalg.vector_norm(n, dim=-1, keepdim=True) + 1e-12)
    return sd[:, None] * n


def advection_prep(case: ThroatCase, s: SimState):
    """The density summation against the wall and the limited transport
    correction, through the box.  Returns (fluid, dt_adv, the distance
    from the wall)."""
    kernel, h, box = case.kernel, case.adaptation.h, case.box
    dt_adv = fd.advection_time_step(s.fluid, h, U_F)
    fluid = fd.density_summation(s.fluid, s.nl_inner, kernel, 2, RHO0_F,
                                 case.adaptation.sigma0,
                                 contacts=[(case.wall, s.nl_wall, RHO0_F)],
                                 free_surface=False, box=box)
    fluid = fd.transport_velocity_correction(
        fluid, s.nl_inner, kernel, 2, h, limiter_slope=100.0,
        walls=[(case.wall, s.nl_wall)], box=box)
    return fluid, dt_adv, distance_from_wall(case, fluid["Position"])


def implicit_damping(case: ThroatCase, s: SimState, f: dict, dt) -> dict:
    """The implicit viscous damping of the velocity (inner and wall,
    eta = mu) by the CG (throat.cpp:248)."""
    return dp.damping_implicit_cg(f, "Velocity", s.nl_inner, case.kernel, 2,
                                  MU_F, dt,
                                  walls=[(case.wall, s.nl_wall, None)],
                                  box=case.box)


def oldroyd_first_half(case: ThroatCase, s: SimState, f: dict, dt) -> dict:
    """The stress half-step, then the pressure relaxation with the
    polymeric force taken at the half-advanced positions."""
    kernel, box, wall = case.kernel, case.box, case.wall
    f = ob.stress_half_step(f, dt)
    f_mid = dict(f, Position=f["Position"] + f["Velocity"] * (0.5 * dt))
    ef = ob.elastic_stress_force(f_mid, s.nl_inner, kernel, 2, wall=wall,
                                 nl_wall=s.nl_wall, box=box)
    return fd.acoustic_step_1st_half(f, s.nl_inner, kernel, 2, case.eos,
                                     case.riemann, dt, wall=wall,
                                     nl_wall=s.nl_wall, box=box,
                                     extra_force=ef)


def oldroyd_second_half(case: ThroatCase, s: SimState, f: dict, dt,
                        dfw) -> dict:
    """The velocity gradient (with the wall's distance factor), the
    density relaxation, the stress rate and the trailing stress
    half-step."""
    kernel, box, wall = case.kernel, case.box, case.wall
    f = dict(f, VelocityGradient=gd.velocity_gradient(
        f, s.nl_inner, kernel, 2, box=box, walls=[(wall, s.nl_wall)],
        distance_from_wall=dfw))
    f = fd.acoustic_step_2nd_half(f, s.nl_inner, kernel, 2, case.riemann,
                                  dt, wall=wall, nl_wall=s.nl_wall, box=box)
    f = ob.stress_rate(f, MODEL)
    return ob.stress_half_step(f, dt)


def acoustic_substep(case: ThroatCase, s: SimState, f: dict, dt_adv, dfw):
    """One sub-step (throat.cpp:244-256).  Returns (fluid, dt)."""
    dt = torch.minimum(fd.acoustic_time_step(f, case.eos, case.adaptation.h),
                       dt_adv)
    f = implicit_damping(case, s, f, dt)
    f = oldroyd_first_half(case, s, f, dt)
    return oldroyd_second_half(case, s, f, dt, dfw), dt


def _advection_step(case: ThroatCase, s: SimState) -> SimState:
    fluid, dt_adv, dfw = advection_prep(case, s)
    relax_t = torch.zeros_like(dt_adv)
    n_ac = 0
    while bool(relax_t < dt_adv):          # one host read per sub-step
        fluid, dt = acoustic_substep(case, s, fluid, dt_adv, dfw)
        relax_t = relax_t + dt
        n_ac += 1
    pos, nl, nlw = rebuild_lists(case, fluid)
    return SimState(fluid=dict(fluid, Position=pos), nl_inner=nl,
                    nl_wall=nlw, time=s.time + relax_t, n_adv=s.n_adv + 1,
                    n_ac=s.n_ac + n_ac,
                    overflow=s.overflow | nl.overflow | nlw.overflow)


def make_advection_step(case: ThroatCase):
    return lambda s: _advection_step(case, s)


def make_run_chunk(case: ThroatCase):
    """run_chunk(sim, t_target): advection steps until sim.time >=
    t_target."""
    return chunk_runner(lambda s: _advection_step(case, s))


def kinetic_energy(s: SimState) -> float:
    """TotalKineticEnergy (throat.cpp:205), summed in float64 on the
    host."""
    f = s.fluid
    v2 = torch.sum(f["Velocity"].double() ** 2, dim=-1)
    return float(0.5 * torch.sum(f["Mass"].double() * v2))
