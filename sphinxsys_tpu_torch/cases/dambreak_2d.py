"""2D dambreak — the canonical WCSPH free-surface case (counterpart of
sphinxsys_tpu/cases/dambreak_2d.py; reference
tests/2d_examples/test_2d_dambreak/Dambreak.cpp):
  * water column 2 x 1 in a 5.366 x 5.366 tank, wall 4*dx thick;
  * rho0 = 1, g = 1, U_ref = 2 sqrt(g LH), c = 10 U_ref;
  * dual-criteria stepping (Dambreak.cpp:166-220): an outer advection
    step (CFL 0.25) with density summation around an inner acoustic loop
    (CFL 0.6) of pressure and density relaxation with the wall contact.

Two routes run it:
  * the gather route, the JAX package's `init_sim` / `make_run_chunk`:
    (N, K) neighbour lists rebuilt every advection step, the pair sums of
    physics/fluid.py as torch ops, a Morton resort every `sort_every`
    advection steps;

        case, fluid = build_case(dx=0.1, device="cpu")
        sim = make_run_chunk(case)(init_sim(case, fluid), 0.3)

  * the cell-block engine (`build_block_case`, engine/scene.py), whose
    sweeps are the CUDA kernels B1-B3 on the card.

JAX runs both loops of the gather route on the device as
`lax.while_loop`s; here they are host loops, each condition read back
with one host sync, as engine/scene.py does.  time and dt stay 0-d
tensors in the state's dtype, so the step counts follow the JAX loops'
float arithmetic; `overflow` is a device bool.
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
from sphinxsys_tpu_torch.device import PRODUCTION_DTYPE, resolve_device
from sphinxsys_tpu_torch.neighbors.cell_list import (
    CellGrid, CellTable, build_cell_table, grid_from_bounds, morton_resort,
)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list)
from sphinxsys_tpu_torch.physics import fluid as fd
from sphinxsys_tpu_torch.physics import general as gd
from sphinxsys_tpu_torch.physics import riemann as rs
from sphinxsys_tpu_torch.solver import chunk_runner

DL = 5.366
DH = 5.366
LL = 2.0
LH = 1.0
RHO0_F = 1.0
GRAVITY_G = 1.0
U_REF = 2.0 * math.sqrt(GRAVITY_G * LH)
C_F = 10.0 * U_REF


@dataclasses.dataclass(frozen=True)
class DambreakCase:
    dx: float
    dim: int
    adaptation: SPHAdaptation
    grid: CellGrid
    eos: WeaklyCompressibleFluid
    riemann: rs.AcousticRiemannSolver
    gravity: gd.Gravity
    wall: Any
    n_fluid: int
    n_wall: int
    # the gather route: the wall's cell table (built once), the capacities
    # of the cell table and of the two lists, the resort period (0: never)
    wall_table: CellTable
    cell_cap: int
    k_inner: int
    k_wall: int
    sort_every: int = 100

    @property
    def kernel(self):
        return self.adaptation.kernel


@dataclasses.dataclass
class SimState:
    """The gather route's carry: the fluid, its two neighbour lists, the
    time (0-d tensor), the step counters and the overflow flag (0-d bool
    tensor: a list or the cell table overflowed)."""

    fluid: dict
    nl_inner: NeighborList
    nl_wall: NeighborList
    time: torch.Tensor
    n_adv: int
    n_ac: int
    overflow: torch.Tensor


def build_tank_case(dx: float, dim: int, tank, water, gravity, dtype, device,
                    cell_cap: int, k_inner: int, k_wall: int,
                    sort_every: int):
    """Scene of a water block in a walled tank (shared by the 2D and 3D
    dambreaks).  `tank` and `water` are the inner tank and water extents
    from the origin.  Returns (case, fluid state)."""
    bw = 4 * dx
    adaptation = SPHAdaptation(spacing=dx, dim=dim)
    half = lambda ext: tuple(e / 2 for e in ext)
    water_shape = G.Box(G.Transform(translation=half(water)), halfsize=half(water))
    outer = G.Box(G.Transform(translation=half(tank)),
                  halfsize=tuple(e / 2 + bw for e in tank))
    inner = G.Box(G.Transform(translation=half(tank)), halfsize=half(tank))
    wall_shape = G.make_complex(("add", outer), ("sub", inner))

    dom_lo = (-bw,) * dim
    dom_hi = tuple(e + bw for e in tank)
    pos_f, vol = generate_lattice(water_shape, dom_lo, dom_hi, dx)
    pos_w, _ = generate_lattice(wall_shape, dom_lo, dom_hi, dx)

    fluid = make_fluid_state(pos_f, vol, RHO0_F, dtype=dtype, device=device)
    wall = make_solid_state(pos_w, vol, RHO0_F, dtype=dtype, device=device)
    wall = gd.normal_direction_from_shape(wall, wall_shape)
    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    fluid = gd.gravity_force(fluid, gravity)
    grid = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff)
    case = DambreakCase(
        dx=dx, dim=dim, adaptation=adaptation, grid=grid, eos=eos,
        riemann=rs.acoustic_riemann(eos), gravity=gravity, wall=wall,
        n_fluid=len(pos_f), n_wall=len(pos_w),
        wall_table=build_cell_table(wall["Position"], wall["NReal"], grid,
                                    cell_cap),
        cell_cap=cell_cap, k_inner=k_inner, k_wall=k_wall,
        sort_every=sort_every)
    return case, fluid


def build_case(dx: float = 0.025, dtype=PRODUCTION_DTYPE, device="cuda",
               cell_cap: int = 24, k_inner: int = 64, k_wall: int = 40):
    """The scene and the wall's cell table.  Returns (case, fluid state)."""
    return build_tank_case(dx, 2, (DL, DH), (LL, LH),
                           gd.Gravity(acceleration=(0.0, -GRAVITY_G)), dtype,
                           resolve_device(device), cell_cap, k_inner, k_wall,
                           sort_every=100)


# ---------------------------------------------------------------------------
# The gather route (shared by the 2D and 3D dambreaks)
# ---------------------------------------------------------------------------

def rebuild_relations(case: DambreakCase, fluid: dict):
    """updateCellLinkedList + updateConfiguration (Dambreak.cpp:216-218):
    (inner list, fluid -> wall list)."""
    pos, n = fluid["Position"], fluid["NReal"]
    cutoff = case.adaptation.cutoff
    table = build_cell_table(pos, n, case.grid, case.cell_cap)
    nl_inner = build_neighbor_list(pos, n, pos, n, table, case.grid, cutoff,
                                   k_max=case.k_inner, include_self=False)
    nl_wall = build_neighbor_list(pos, n, case.wall["Position"],
                                  case.wall["NReal"], case.wall_table,
                                  case.grid, cutoff, k_max=case.k_wall,
                                  include_self=True)
    return nl_inner, nl_wall


def init_sim(case: DambreakCase, fluid: dict) -> SimState:
    nl_inner, nl_wall = rebuild_relations(case, fluid)
    pos = fluid["Position"]
    return SimState(fluid=fluid, nl_inner=nl_inner, nl_wall=nl_wall,
                    time=torch.zeros((), dtype=pos.dtype, device=pos.device),
                    n_adv=0, n_ac=0,
                    overflow=nl_inner.overflow | nl_wall.overflow)


def acoustic_substep(case: DambreakCase, s: SimState, fluid: dict) -> tuple:
    """One acoustic sub-step: (fluid, dt)."""
    kernel, dim, h = case.kernel, case.dim, case.adaptation.h
    dt = fd.acoustic_time_step(fluid, case.eos, h)
    walls = [(case.wall, s.nl_wall)]
    fluid = fd.acoustic_step_1st_half(fluid, s.nl_inner, kernel, dim,
                                      case.eos, case.riemann, dt, walls=walls)
    fluid = fd.acoustic_step_2nd_half(fluid, s.nl_inner, kernel, dim,
                                      case.riemann, dt, walls=walls)
    return fluid, dt


def _advection_step(case: DambreakCase, s: SimState) -> SimState:
    fluid = s.fluid
    dt_adv = fd.advection_time_step(fluid, case.adaptation.h, U_REF)
    fluid = fd.density_summation(
        fluid, s.nl_inner, case.kernel, case.dim, RHO0_F,
        case.adaptation.sigma0, contacts=[(case.wall, s.nl_wall, RHO0_F)],
        free_surface=True)
    relax_t = torch.zeros_like(dt_adv)
    n_ac = 0
    while bool(relax_t < dt_adv):          # one host sync per sub-step
        fluid, dt = acoustic_substep(case, s, fluid)
        relax_t = relax_t + dt
        n_ac += 1
    n_adv = s.n_adv + 1
    if case.sort_every and n_adv % case.sort_every == 0:
        fluid = morton_resort(fluid, case.grid)
    nl_inner, nl_wall = rebuild_relations(case, fluid)
    return SimState(fluid=fluid, nl_inner=nl_inner, nl_wall=nl_wall,
                    time=s.time + relax_t, n_adv=n_adv, n_ac=s.n_ac + n_ac,
                    overflow=s.overflow | nl_inner.overflow | nl_wall.overflow)


def make_run_chunk(case: DambreakCase):
    """run_chunk(sim, t_target): advance by advection steps until
    sim.time >= t_target (compared in the time's dtype)."""
    return chunk_runner(lambda s: _advection_step(case, s))


def make_advection_step(case: DambreakCase):
    return lambda s: _advection_step(case, s)


def build_block_case(dx: float = 0.025, dtype=PRODUCTION_DTYPE, device="cuda",
                     cap: int = 12, c_max: int | None = None,
                     use_kernels: bool = True):
    """The scene on the cell-block engine.  Returns (BlockScene, fluid)."""
    from sphinxsys_tpu_torch.engine import scene as sc

    base, fluid = build_case(dx=dx, dtype=dtype, device=device)
    scene = sc.standard_scene(
        base, rho0=RHO0_F, speed_ref=U_REF, device=device, dim=2,
        wall=base.wall, cap=cap, c_max=c_max,
        c_max_multiple=256, use_kernels=use_kernels)
    return scene, fluid
