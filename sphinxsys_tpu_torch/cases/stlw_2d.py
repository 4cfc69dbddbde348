"""2D still-water tank with a free-surface wave gauge (counterpart of
sphinxsys_tpu/cases/stlw_2d.py; reference tests/2d_examples/test_2d_stlw/
stlw.{h,cpp}): a 3 x 2 water block at rest in a 3 x 4 tank (rho0 = 1000,
g = 9.81, dx = 0.05, mu = 1e-3), pre-equilibrated to its hydrostatic
pressure; the gauge at x = DL/3 records FreeSurfaceHeight
(UpperFrontInAxisDirection over a thin column).  Still water stays
still: the reference DB's runs hover at ~-0.02, the half-spacing lattice
offset of the surface.

The tank is centred: x in [-DL/2, DL/2], water y in [-WH, 0], walls to
y = +DH/2.  Both loops are host loops, one host read of each condition,
as in cases/dambreak_2d.py.

    case, fluid = build_case(device="cpu")             # 2,400 particles
    sim = make_run_chunk(case)(init_sim(case, fluid), 0.1)
    print(float(free_surface_height(case, sim.fluid)))
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
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list)
from sphinxsys_tpu_torch.physics import fluid as fd
from sphinxsys_tpu_torch.physics import general as gd
from sphinxsys_tpu_torch.physics import riemann as rs
from sphinxsys_tpu_torch.solver import chunk_runner

# stlw.h:12-26
DL = 3.0
DH = 4.0
WH = 2.0
RHO0_F = 1000.0
GRAVITY_G = 9.81
U_F = 2.0 * math.sqrt(0.79 * GRAVITY_G)
C_F = 10.0 * U_F
MU_F = 1.0e-3
X_GAUGE = DL / 3.0          # stlw.h:52 gauge_translation


@dataclasses.dataclass
class SimState:
    """The carry: the fluid, its two lists, the time (0-d tensor), the
    advection and acoustic step counts and the overflow flag."""

    fluid: dict
    nl_inner: NeighborList
    nl_wall: NeighborList
    time: torch.Tensor
    n_adv: int
    n_ac: int
    overflow: torch.Tensor


@dataclasses.dataclass(frozen=True)
class StlwCase:
    dx: float
    adaptation: SPHAdaptation
    grid: CellGrid
    eos: WeaklyCompressibleFluid
    riemann: rs.AcousticRiemannSolver
    gravity: gd.Gravity
    wall: Any
    wall_table: CellTable
    n_fluid: int
    n_wall: int
    cell_cap: int
    k_inner: int
    k_wall: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = 0.05, dtype=PRODUCTION_DTYPE, cell_cap: int = 24,
               k_inner: int = 64, k_wall: int = 40, device="cuda"):
    """The water block at its hydrostatic pressure (density from the EoS's
    inverse, in the state's dtype), gravity in ForcePrior, the tank walls
    with their shape normals.  Returns (case, fluid)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    bw = 4 * dx
    adaptation = SPHAdaptation(spacing=dx, dim=2)

    water_shape = G.Box(G.Transform(translation=(0.0, -WH / 2)),
                        halfsize=(DL / 2, WH / 2))
    outer = G.Box(G.Transform(translation=(0.0, 0.0)),
                  halfsize=(DL / 2 + bw, DH / 2 + bw))
    inner = G.Box(G.Transform(translation=(0.0, 0.0)),
                  halfsize=(DL / 2, DH / 2))
    wall_shape = G.make_complex(("add", outer), ("sub", inner))

    dom_lo = (-DL / 2 - bw, -DH / 2 - bw)
    dom_hi = (DL / 2 + bw, DH / 2 + bw)
    pos_f, vol = generate_lattice(water_shape, dom_lo, dom_hi, dx)
    pos_w, _ = generate_lattice(wall_shape, dom_lo, dom_hi, dx)

    fluid = make_fluid_state(pos_f, vol, RHO0_F, dtype, device)
    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    # the hydrostatic pre-equilibration cuts the settling transient (the
    # reference discards its first 1 s instead)
    p_hydro = torch.as_tensor(RHO0_F * GRAVITY_G * (0.0 - pos_f[:, 1]),
                              dtype=dtype, device=device)
    fluid["Density"] = eos.density_from_pressure(p_hydro)
    fluid["Pressure"] = p_hydro

    wall = make_solid_state(pos_w, vol, RHO0_F, dtype, device)
    wall = gd.normal_direction_from_shape(wall, wall_shape)

    gravity = gd.Gravity(acceleration=(0.0, -GRAVITY_G))
    fluid = gd.gravity_force(fluid, gravity)
    fluid["ViscousForce"] = torch.zeros_like(fluid["Velocity"])
    fluid["ViscousForcePrev"] = torch.zeros_like(fluid["Velocity"])
    # gravity_force's BaseForcePrior delta form, beside the viscous prior
    fluid["GravityForcePrev"] = torch.zeros_like(fluid["Velocity"])

    grid = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff)
    case = StlwCase(dx=dx, adaptation=adaptation, grid=grid, eos=eos,
                    riemann=rs.acoustic_riemann(eos), gravity=gravity,
                    wall=wall,
                    wall_table=build_cell_table(wall["Position"],
                                                wall["NReal"], grid, cell_cap),
                    n_fluid=len(pos_f), n_wall=len(pos_w), cell_cap=cell_cap,
                    k_inner=k_inner, k_wall=k_wall)
    return case, fluid


def rebuild_relations(case: StlwCase, fluid: dict):
    """The fluid's cell table and its (inner, wall) lists."""
    pos = fluid["Position"]
    n = fluid["NReal"]
    cutoff = case.adaptation.cutoff
    table = build_cell_table(pos, n, case.grid, case.cell_cap)
    nl_inner = build_neighbor_list(pos, n, pos, n, table, case.grid, cutoff,
                                   k_max=case.k_inner, include_self=False)
    nl_wall = build_neighbor_list(pos, n, case.wall["Position"],
                                  case.wall["NReal"], case.wall_table,
                                  case.grid, cutoff, k_max=case.k_wall,
                                  include_self=True)
    return nl_inner, nl_wall


def init_sim(case: StlwCase, fluid: dict) -> SimState:
    nl_inner, nl_wall = rebuild_relations(case, fluid)
    pos = fluid["Position"]
    return SimState(fluid=dict(fluid), nl_inner=nl_inner, nl_wall=nl_wall,
                    time=torch.zeros((), dtype=pos.dtype, device=pos.device),
                    n_adv=0, n_ac=0,
                    overflow=nl_inner.overflow | nl_wall.overflow)


def advection_prep(case: StlwCase, s: SimState) -> dict:
    """The free-surface density summation and the viscous force."""
    kernel, h = case.kernel, case.adaptation.h
    fluid = fd.density_summation(s.fluid, s.nl_inner, kernel, 2, RHO0_F,
                                 case.adaptation.sigma0,
                                 contacts=[(case.wall, s.nl_wall, RHO0_F)],
                                 free_surface=True)
    return fd.viscous_force(fluid, s.nl_inner, kernel, 2, MU_F, h,
                            walls=[(case.wall, s.nl_wall)])


def acoustic_substep(case: StlwCase, s: SimState, fluid: dict, dt_adv):
    """Both acoustic halves against the wall, Riemann-dissipated.  Returns
    (fluid, dt)."""
    kernel, h = case.kernel, case.adaptation.h
    dt = torch.minimum(fd.acoustic_time_step(fluid, case.eos, h), dt_adv)
    fluid = fd.acoustic_step_1st_half(fluid, s.nl_inner, kernel, 2, case.eos,
                                      case.riemann, dt, wall=case.wall,
                                      nl_wall=s.nl_wall)
    fluid = fd.acoustic_step_2nd_half(fluid, s.nl_inner, kernel, 2,
                                      case.riemann, dt, wall=case.wall,
                                      nl_wall=s.nl_wall)
    return fluid, dt


def _advection_step(case: StlwCase, s: SimState) -> SimState:
    dt_adv = fd.advection_viscous_time_step(s.fluid, case.adaptation.h, U_F,
                                            RHO0_F, MU_F)
    fluid = advection_prep(case, s)
    relax_t = torch.zeros_like(dt_adv)
    n_ac = 0
    while bool(relax_t < dt_adv):          # one host read per sub-step
        fluid, dt = acoustic_substep(case, s, fluid, dt_adv)
        relax_t = relax_t + dt
        n_ac += 1
    nl_inner, nl_wall = rebuild_relations(case, fluid)
    return SimState(fluid=fluid, nl_inner=nl_inner, nl_wall=nl_wall,
                    time=s.time + relax_t, n_adv=s.n_adv + 1,
                    n_ac=s.n_ac + n_ac,
                    overflow=s.overflow | nl_inner.overflow | nl_wall.overflow)


def make_advection_step(case: StlwCase):
    return lambda s: _advection_step(case, s)


def make_run_chunk(case: StlwCase):
    """run_chunk(sim, t_target): advection steps until sim.time >=
    t_target."""
    return chunk_runner(lambda s: _advection_step(case, s))


def free_surface_height(case: StlwCase, fluid: dict, x_gauge: float = X_GAUGE):
    """The FreeSurfaceHeight gauge (UpperFrontInAxisDirection over the
    column |x - x_gauge| <= 1.3 dx, stlw.h:50-53), a 0-d tensor."""
    hw = 1.3 * case.dx
    pos = fluid["Position"]
    valid = torch.arange(pos.shape[0], device=pos.device) < fluid["NReal"]
    in_col = valid & (torch.abs(pos[:, 0] - x_gauge) <= hw)
    return torch.max(torch.where(in_col, pos[:, 1],
                                 torch.full_like(pos[:, 1], -math.inf)))
