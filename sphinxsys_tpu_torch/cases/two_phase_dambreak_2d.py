"""2D two-phase (air-water) dambreak (counterpart of
sphinxsys_tpu/cases/two_phase_dambreak_2d.py; reference tests/2d_examples/
test_2d_two_phase_dambreak/two_phase_dambreak.{h,cpp}): a 2 x 1 water
column (rho0 = 1) collapses under air 1000 times lighter that fills the
rest of a 5.3 x 2 tank; both phases weakly compressible with c = 20.

  * water: the free-surface density summation against the wall only;
    the multi-phase pressure and density relaxation with the air as a
    fluid-fluid contact;
  * air: the plain summation against the water and the wall, the
    multi-phase transport-velocity correction, the same relaxations;
  * both phases share the advection and acoustic steps (the smaller of
    the two criteria), as in the JAX package.

Within an acoustic sub-step the phases advance together: each first
half reads the other phase as it was before that sub-step (its stored
Pressure is the one its own last first half wrote, the build's on the
first sub-step), each second half reads the other's first-half state.
The contact solvers are oriented (this phase, that phase): `rs_wa` for
the water, `rs_aw` for the air.  The sub-step is shared with the
surface-tension cases (`acoustic_substep`).  Both loops are host loops,
one host read of each condition.

    case, water, air = build_case(dx=0.1, device="cpu")
    sim = make_run_chunk(case)(init_sim(case, water, air), 0.2)
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

# two_phase_dambreak.h:11-28
DL = 5.3
DH = 2.0
LL = 2.0
LH = 1.0
RHO0_F = 1.0
RHO0_A = 0.001
GRAVITY_G = 1.0
U_REF = 2.0 * math.sqrt(GRAVITY_G * LH)
C_F = 10.0 * U_REF


@dataclasses.dataclass
class SimState:
    """The carry of the two-phase cases: both phases, their six lists
    (water-water, water-air, water-wall, air-air, air-water, air-wall),
    the time (0-d tensor), the step counts and the overflow flag."""

    water: dict
    air: dict
    nl_ww: NeighborList
    nl_wa: NeighborList
    nl_wb: NeighborList
    nl_aa: NeighborList
    nl_aw: NeighborList
    nl_ab: NeighborList
    time: torch.Tensor
    n_adv: int
    n_ac: int
    overflow: torch.Tensor


@dataclasses.dataclass(frozen=True)
class TwoPhaseCase:
    dx: float
    adaptation: SPHAdaptation
    grid: CellGrid
    eos_w: WeaklyCompressibleFluid
    eos_a: WeaklyCompressibleFluid
    rs_w: rs.AcousticRiemannSolver      # water inner
    rs_a: rs.AcousticRiemannSolver      # air inner
    rs_wa: rs.AcousticRiemannSolver     # the water's contact: (water, air)
    rs_aw: rs.AcousticRiemannSolver     # the air's contact: (air, water)
    wall: Any
    wall_table: CellTable
    n_water: int
    n_air: int
    cell_cap: int
    k_inner: int
    k_contact: int

    @property
    def kernel(self):
        return self.adaptation.kernel

    @property
    def dim(self) -> int:
        return self.adaptation.dim


def phase_solvers(eos_w, eos_a) -> dict:
    """The inner and the two oriented contact solvers of a water-air
    pair."""
    return dict(eos_w=eos_w, eos_a=eos_a, rs_w=rs.acoustic_riemann(eos_w),
                rs_a=rs.acoustic_riemann(eos_a),
                rs_wa=rs.acoustic_riemann(eos_w, eos_a),
                rs_aw=rs.acoustic_riemann(eos_a, eos_w))


def build_case(dx: float = 0.05, dtype=PRODUCTION_DTYPE, cell_cap: int = 24,
               k_inner: int = 64, k_contact: int = 48, device="cuda"):
    """The water column, the air around it and the tank wall, gravity in
    both phases' ForcePrior.  Returns (case, water, air)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    bw = 4 * dx
    adaptation = SPHAdaptation(spacing=dx, dim=2)

    water_shape = G.Box(G.Transform(translation=(LL / 2, LH / 2)),
                        halfsize=(LL / 2, LH / 2))
    tank = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                 halfsize=(DL / 2, DH / 2))
    air_shape = G.make_complex(("add", tank), ("sub", water_shape))
    outer = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                  halfsize=(DL / 2 + bw, DH / 2 + bw))
    wall_shape = G.make_complex(("add", outer), ("sub", tank))

    dom_lo, dom_hi = (-bw, -bw), (DL + bw, DH + bw)
    pos_w, vol = generate_lattice(water_shape, dom_lo, dom_hi, dx)
    pos_a, _ = generate_lattice(air_shape, dom_lo, dom_hi, dx)
    pos_b, _ = generate_lattice(wall_shape, dom_lo, dom_hi, dx)

    water = make_fluid_state(pos_w, vol, RHO0_F, dtype, device)
    air = make_fluid_state(pos_a, vol, RHO0_A, dtype, device)
    wall = make_solid_state(pos_b, vol, RHO0_F, dtype, device)
    wall = gd.normal_direction_from_shape(wall, wall_shape)

    gravity = gd.Gravity(acceleration=(0.0, -GRAVITY_G))
    water = gd.gravity_force(water, gravity)
    air = gd.gravity_force(air, gravity)

    grid = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff)
    case = TwoPhaseCase(
        dx=dx, adaptation=adaptation, grid=grid,
        **phase_solvers(WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F),
                        WeaklyCompressibleFluid(rho0=RHO0_A, c0=C_F)),
        wall=wall,
        wall_table=build_cell_table(wall["Position"], wall["NReal"], grid,
                                    cell_cap),
        n_water=len(pos_w), n_air=len(pos_a), cell_cap=cell_cap,
        k_inner=k_inner, k_contact=k_contact)
    return case, water, air


def rebuild(case, water: dict, air: dict):
    """Both phases' cell tables and the six lists, and their overflow."""
    cutoff, grid = case.adaptation.cutoff, case.grid
    wall = case.wall

    def nl(a, b, table, k_max, include_self):
        return build_neighbor_list(a["Position"], a["NReal"], b["Position"],
                                   b["NReal"], table, grid, cutoff,
                                   k_max=k_max, include_self=include_self)

    tw = build_cell_table(water["Position"], water["NReal"], grid,
                          case.cell_cap)
    ta = build_cell_table(air["Position"], air["NReal"], grid, case.cell_cap)
    nls = (nl(water, water, tw, case.k_inner, False),
           nl(water, air, ta, case.k_contact, True),
           nl(water, wall, case.wall_table, case.k_contact, True),
           nl(air, air, ta, case.k_inner, False),
           nl(air, water, tw, case.k_contact, True),
           nl(air, wall, case.wall_table, case.k_contact, True))
    ovf = nls[0].overflow
    for x in nls[1:]:
        ovf = ovf | x.overflow
    return (*nls, ovf)


def init_sim(case, water: dict, air: dict) -> SimState:
    *nls, ovf = rebuild(case, water, air)
    pos = water["Position"]
    return SimState(dict(water), dict(air), *nls,
                    time=torch.zeros((), dtype=pos.dtype, device=pos.device),
                    n_adv=0, n_ac=0, overflow=ovf)


def acoustic_substep(case, s: SimState, w: dict, a: dict, dt):
    """Both acoustic halves of both phases, the phases together: the
    first halves read the other phase as it was before this sub-step,
    the second halves its first-half state.  Returns (water, air)."""
    kernel, dim = case.kernel, case.dim
    walls_w = [(case.wall, s.nl_wb)]
    walls_a = [(case.wall, s.nl_ab)]
    w1 = fd.acoustic_step_1st_half(w, s.nl_ww, kernel, dim, case.eos_w,
                                   case.rs_w, dt, walls=walls_w,
                                   contacts=[(a, s.nl_wa, case.rs_wa)])
    a1 = fd.acoustic_step_1st_half(a, s.nl_aa, kernel, dim, case.eos_a,
                                   case.rs_a, dt, walls=walls_a,
                                   contacts=[(w, s.nl_aw, case.rs_aw)])
    w2 = fd.acoustic_step_2nd_half(w1, s.nl_ww, kernel, dim, case.rs_w, dt,
                                   walls=walls_w,
                                   contacts=[(a1, s.nl_wa, case.rs_wa)])
    a2 = fd.acoustic_step_2nd_half(a1, s.nl_aa, kernel, dim, case.rs_a, dt,
                                   walls=walls_a,
                                   contacts=[(w1, s.nl_aw, case.rs_aw)])
    return w2, a2


def finish_step(case, s: SimState, water: dict, air: dict, relax_t,
                n_ac: int) -> SimState:
    """The lists rebuilt after an advection step, the counts advanced."""
    *nls, ovf = rebuild(case, water, air)
    return SimState(water, air, *nls, time=s.time + relax_t,
                    n_adv=s.n_adv + 1, n_ac=s.n_ac + n_ac,
                    overflow=s.overflow | ovf)


def advection_prep(case: TwoPhaseCase, s: SimState):
    """The water's free-surface summation against the wall, the air's
    plain summation against the water and the wall (a contact's rho0 is
    that body's: the wall was built at RHO0_F), and the air's multi-phase
    transport-velocity correction.  Returns (water, air)."""
    kernel, dim, sigma0 = case.kernel, 2, case.adaptation.sigma0
    water = fd.density_summation(
        s.water, s.nl_ww, kernel, dim, RHO0_F, sigma0,
        contacts=[(case.wall, s.nl_wb, RHO0_F)], free_surface=True)
    air = fd.density_summation(
        s.air, s.nl_aa, kernel, dim, RHO0_A, sigma0,
        contacts=[(water, s.nl_aw, RHO0_F), (case.wall, s.nl_ab, RHO0_F)],
        free_surface=False)
    air = fd.transport_velocity_correction(
        air, s.nl_aa, kernel, dim, case.adaptation.h,
        walls=[(water, s.nl_aw), (case.wall, s.nl_ab)])
    return water, air


def _advection_step(case: TwoPhaseCase, s: SimState) -> SimState:
    h = case.adaptation.h
    dt_adv = torch.minimum(fd.advection_time_step(s.water, h, U_REF),
                           fd.advection_time_step(s.air, h, U_REF))
    water, air = advection_prep(case, s)
    relax_t = torch.zeros_like(dt_adv)
    n_ac = 0
    while bool(relax_t < dt_adv):          # one host read per sub-step
        dt = torch.minimum(
            torch.minimum(fd.acoustic_time_step(water, case.eos_w, h),
                          fd.acoustic_time_step(air, case.eos_a, h)), dt_adv)
        water, air = acoustic_substep(case, s, water, air, dt)
        relax_t = relax_t + dt
        n_ac += 1
    return finish_step(case, s, water, air, relax_t, n_ac)


def make_advection_step(case: TwoPhaseCase):
    return lambda s: _advection_step(case, s)


def make_run_chunk(case: TwoPhaseCase):
    """run_chunk(sim, t_target): advection steps until sim.time >=
    t_target."""
    return chunk_runner(lambda s: _advection_step(case, s))


def water_front(s: SimState):
    """The surge front: the largest water x below NReal, a 0-d tensor."""
    x = s.water["Position"][:, 0]
    valid = torch.arange(x.shape[0], device=x.device) < s.water["NReal"]
    return torch.max(torch.where(valid, x, torch.full_like(x, -1.0)))
