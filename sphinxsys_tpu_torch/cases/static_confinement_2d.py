"""2D dambreak confined by level sets, with no wall particles (counterpart
of sphinxsys_tpu/cases/static_confinement_2d.py; reference
tests/2d_examples/test_2d_static_confinement/static_confinement.cpp): the
5.366 x 5.366 dambreak tank with a triangular ramp, every solid boundary
a packaged level set (NearShapeSurface + StaticConfinement,
shape_confinement.h):

  * density summation  += the wall region's kernel integral;
  * pressure relaxation += -2 V p KGI (the kernel-gradient integral);
  * density relaxation  += 2 rho v . KGI;
  * ShapeSurfaceBounding projects escapees back every acoustic sub-step.

The tank's level set is built from the tank interior (the fluid inside,
negative phi; the integrals measure the wall region, positive phi), the
triangle's from its InverseShape, so that its interior is the wall region
(static_confinement.cpp:147).  As in the JAX package, both confinements
enter all three stages (the reference wires the triangle's density
relaxation into the density summation's list, cpp:152).

The advection and acoustic loops are host loops, each condition one host
read, as the port's dambreak's; the Morton resort runs every
`sort_every` advection steps.

    case, fluid = build_case(dx=0.05, device="cpu")
    sim = make_run_chunk(case)(init_sim(case, fluid), 0.1)
"""

from __future__ import annotations

import dataclasses
import math

import torch

from sphinxsys_tpu_torch.core import geometry as G
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.generators import generate_lattice
from sphinxsys_tpu_torch.core.materials import WeaklyCompressibleFluid
from sphinxsys_tpu_torch.core.state import make_fluid_state
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.meshes.levelset import LevelSetShape, build_levelset
from sphinxsys_tpu_torch.neighbors.cell_list import (CellGrid,
                                                    build_cell_table,
                                                    grid_from_bounds,
                                                    morton_resort)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list)
from sphinxsys_tpu_torch.physics import fluid as fd
from sphinxsys_tpu_torch.physics import general as gd
from sphinxsys_tpu_torch.physics import riemann as rs
from sphinxsys_tpu_torch.physics.relax import surface_bounding
from sphinxsys_tpu_torch.solver import chunk_runner

# static_confinement.cpp:12-26
DL = 5.366
DH = 5.366
LL = 2.0
LH = 1.0
RHO0_F = 1.0
GRAVITY_G = 1.0
U_REF = 2.0 * math.sqrt(GRAVITY_G * LH)
C_F = 10.0 * U_REF


@dataclasses.dataclass
class SimState:
    fluid: dict
    nl_inner: NeighborList
    time: torch.Tensor
    n_adv: int
    n_ac: int
    overflow: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ConfinementCase:
    dx: float
    adaptation: SPHAdaptation
    grid: CellGrid
    eos: WeaklyCompressibleFluid
    riemann: rs.AcousticRiemannSolver
    gravity: gd.Gravity
    ls_wall: LevelSetShape
    ls_triangle: LevelSetShape
    n_fluid: int
    cell_cap: int
    k_inner: int
    sort_every: int = 100

    @property
    def kernel(self):
        return self.adaptation.kernel

    @property
    def levelsets(self):
        return (self.ls_wall, self.ls_triangle)


def triangle_shape() -> G.Shape:
    """createStructureShape (static_confinement.cpp:56-64)."""
    return G.Polygon(vertices=(
        (0.5 * DL, 0.05 * DH),
        (0.5 * DL + 0.5 * LL, 0.05 * DH + 0.5 * LH),
        (0.5 * DL + 0.5 * LL, 0.05 * DH),
    ))


def build_case(dx: float = 0.025, dtype=PRODUCTION_DTYPE, device="cuda",
               cell_cap: int = 24, k_inner: int = 64):
    """The water block less the ramp, and the two confinement level sets
    with their kernel integrals.  Returns (case, fluid state)."""
    device, dtype = resolve_device(device), resolve_dtype(dtype)
    bw = 4 * dx
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    water_shape = G.make_complex(
        ("add", G.Box(G.Transform(translation=(LL / 2, LH / 2)),
                      halfsize=(LL / 2, LH / 2))),
        ("sub", triangle_shape()))
    tank_shape = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                       halfsize=(DL / 2, DH / 2))

    dom_lo, dom_hi = (-bw, -bw), (DL + bw, DH + bw)
    pos_f, vol = generate_lattice(water_shape, dom_lo, dom_hi, dx)
    fluid = make_fluid_state(pos_f, vol, RHO0_F, dtype=dtype, device=device)

    def confinement(shape, name):
        ls = build_levelset(shape, dom_lo, dom_hi, dx, dtype=dtype,
                            device=device)
        return LevelSetShape(ls.update_kernel_integrals(adaptation.kernel, 2),
                             name=name)

    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    gravity = gd.Gravity(acceleration=(0.0, -GRAVITY_G))
    fluid = gd.gravity_force(fluid, gravity)
    case = ConfinementCase(
        dx=dx, adaptation=adaptation,
        grid=grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff), eos=eos,
        riemann=rs.acoustic_riemann(eos), gravity=gravity,
        ls_wall=confinement(tank_shape, "Wall"),
        ls_triangle=confinement(G.InverseShape(base=triangle_shape()),
                                "Triangle"),
        n_fluid=len(pos_f), cell_cap=cell_cap, k_inner=k_inner)
    return case, fluid


def rebuild_relations(case: ConfinementCase, fluid: dict) -> NeighborList:
    pos, n = fluid["Position"], fluid["NReal"]
    table = build_cell_table(pos, n, case.grid, case.cell_cap)
    return build_neighbor_list(pos, n, pos, n, table, case.grid,
                               case.adaptation.cutoff, k_max=case.k_inner,
                               include_self=False)


def init_sim(case: ConfinementCase, fluid: dict) -> SimState:
    nl = rebuild_relations(case, fluid)
    pos = fluid["Position"]
    return SimState(fluid=fluid, nl_inner=nl,
                    time=torch.zeros((), dtype=pos.dtype, device=pos.device),
                    n_adv=0, n_ac=0, overflow=nl.overflow)


def advection_prep(case: ConfinementCase, s: SimState):
    """The advection dt and the density summation with the confinements'
    kernel integrals: (dt_adv, fluid)."""
    dt_adv = fd.advection_time_step(s.fluid, case.adaptation.h, U_REF)
    fluid = fd.density_summation(s.fluid, s.nl_inner, case.kernel, 2, RHO0_F,
                                 case.adaptation.sigma0, free_surface=True,
                                 levelsets=case.levelsets)
    return dt_adv, fluid


def acoustic_substep(case: ConfinementCase, s: SimState, f: dict):
    """Both acoustic halves with the confinement terms, then the surface
    bounding against both level sets: (fluid, dt)."""
    kernel, h = case.kernel, case.adaptation.h
    dt = fd.acoustic_time_step(f, case.eos, h)
    f = fd.acoustic_step_1st_half(f, s.nl_inner, kernel, 2, case.eos,
                                  case.riemann, dt, levelsets=case.levelsets)
    f = fd.acoustic_step_2nd_half(f, s.nl_inner, kernel, 2, case.riemann, dt,
                                  levelsets=case.levelsets)
    pos = surface_bounding(f["Position"], case.ls_wall, case.dx)
    pos = surface_bounding(pos, case.ls_triangle, case.dx)
    return dict(f, Position=pos), dt


def _advection_step(case: ConfinementCase, s: SimState) -> SimState:
    dt_adv, fluid = advection_prep(case, s)
    relax_t = torch.zeros_like(dt_adv)
    n_ac = 0
    while bool(relax_t < dt_adv):          # one host sync per sub-step
        fluid, dt = acoustic_substep(case, s, fluid)
        relax_t = relax_t + dt
        n_ac += 1
    n_adv = s.n_adv + 1
    if case.sort_every and n_adv % case.sort_every == 0:
        fluid = morton_resort(fluid, case.grid)
    nl = rebuild_relations(case, fluid)
    return SimState(fluid=fluid, nl_inner=nl, time=s.time + relax_t,
                    n_adv=n_adv, n_ac=s.n_ac + n_ac,
                    overflow=s.overflow | nl.overflow)


def make_advection_step(case: ConfinementCase):
    return lambda s: _advection_step(case, s)


def make_run_chunk(case: ConfinementCase):
    """run_chunk(sim, t_target): advection steps until sim.time >=
    t_target (compared in the time's dtype)."""
    return chunk_runner(make_advection_step(case))


def mechanical_energy(case: ConfinementCase, s: SimState) -> float:
    return float(gd.total_mechanical_energy(s.fluid, case.gravity))
