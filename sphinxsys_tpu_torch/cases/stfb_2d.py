"""2D still floating body: a free rigid structure at its equilibrium draft
(counterpart of sphinxsys_tpu/cases/stfb_2d.py; reference
tests/2d_examples/test_2d_stfb/stfb.{h,cpp}): a 1 x 1 structure of mass
700 floats in the 3 x 2 still-water tank of cases/stlw_2d.py at its
Archimedes equilibrium (COM at (0, -0.2), draft 0.7).  The planar rigid
solver of physics/rigid.py plays the reference's Simbody Planar mobilizer
with its mass properties (mass 700, Iz = m (L^2 + L^2) / 12,
stfb.h:42-55).

Protocol (stfb.cpp:195-258): the structure is held for the first 1 s
(RELAX_TIME) while the fluid settles (`init_sim` runs that window, its
`settle_time`, and then sets the clock to 0); after its release it takes the
fluid's pressure and viscous forces and gravity through the rigid solver
(the sub-step of cases/floating_body_2d.py, the viscous force on the
structure taken once an advection step).  Observables: the structure's
COM (the observer at the initial COM of a rigid body) and the
free-surface gauge at x = DL / 3.

    case, fluid = build_case(dx=0.1, device="cpu")
    sim = init_sim(case, fluid, settle_time=0.05)
    sim = make_run_chunk(case)(sim, 0.05)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from sphinxsys_tpu_torch.cases.floating_body_2d import (
    SimState, acoustic_substep, hydrostatic, rebuild, rigid_block)
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
from sphinxsys_tpu_torch.physics import fluid as fd
from sphinxsys_tpu_torch.physics import fsi
from sphinxsys_tpu_torch.physics import general as gd
from sphinxsys_tpu_torch.physics import rigid as rg
from sphinxsys_tpu_torch.physics import riemann as rs
from sphinxsys_tpu_torch.solver import chunk_runner

# stfb.h:12-56
DL = 3.0
DH = 4.0
WH = 2.0
L = 1.0
RHO0_F = 1000.0
GRAVITY_G = 9.81
U_F = 2.0 * math.sqrt(0.79 * GRAVITY_G)
C_F = 10.0 * U_F
MU_F = 1.0e-3
STRUCTURE_MASS = 700.0
RHO_S = STRUCTURE_MASS / (L * L)
H_COM = -(RHO_S / RHO0_F * L - L / 2)       # -0.2: the equilibrium COM
IZ = STRUCTURE_MASS / 12.0 * (L * L + L * L)
X_GAUGE = DL / 3.0
RELAX_TIME = 1.0                            # the structure held till then


@dataclasses.dataclass(frozen=True)
class StfbCase:
    dx: float
    adaptation: SPHAdaptation
    grid: CellGrid
    eos: WeaklyCompressibleFluid
    riemann: rs.AcousticRiemannSolver
    gravity: gd.Gravity
    g_vec: torch.Tensor
    wall: Any
    wall_table: CellTable
    block0: Any
    rb0: rg.RigidBody2D
    mask_b: torch.Tensor
    n_fluid: int
    n_block: int
    cell_cap: int
    k_inner: int
    k_contact: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = L / 20.0, dtype=PRODUCTION_DTYPE,
               cell_cap: int = 24, k_inner: int = 64, k_contact: int = 40,
               device="cuda"):
    """The water around the structure at its hydrostatic pressure, the
    structure with the reference's mass and inertia, the tank wall.
    Returns (case, fluid)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    bw = 4 * dx
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    structure_shape = G.Box(G.Transform(translation=(0.0, H_COM)),
                            halfsize=(L / 2, L / 2))
    water_box = G.Box(G.Transform(translation=(0.0, -WH / 2)),
                      halfsize=(DL / 2, WH / 2))
    water_shape = G.make_complex(("add", water_box), ("sub", structure_shape))
    outer = G.Box(G.Transform(translation=(0.0, 0.0)),
                  halfsize=(DL / 2 + bw, DH / 2 + bw))
    inner = G.Box(G.Transform(translation=(0.0, 0.0)),
                  halfsize=(DL / 2, DH / 2))
    wall_shape = G.make_complex(("add", outer), ("sub", inner))

    dom_lo = (-DL / 2 - bw, -DH / 2 - bw)
    dom_hi = (DL / 2 + bw, DH / 2 + bw)
    pos_f, vol = generate_lattice(water_shape, dom_lo, dom_hi, dx)
    pos_w, _ = generate_lattice(wall_shape, dom_lo, dom_hi, dx)
    pos_b, _ = generate_lattice(structure_shape, dom_lo, dom_hi, dx)

    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    fluid = make_fluid_state(pos_f, vol, RHO0_F, dtype, device)
    fluid = hydrostatic(fluid, pos_f, eos, 0.0, GRAVITY_G, clamp=True)
    wall = make_solid_state(pos_w, vol, RHO0_F, dtype, device)
    wall = gd.normal_direction_from_shape(wall, wall_shape)
    block = rigid_block(pos_b, vol, RHO_S, structure_shape, dtype, device,
                        keys=("PressureForceFromFluid",
                              "ViscousForceFromFluid"))
    mask_b = torch.ones(len(pos_b), dtype=torch.bool, device=device)
    rb0 = rg.rigid_body_from_particles(block, mask_b)
    # the reference's Simbody mass properties (stfb.h:42-55)
    rb0 = rb0._replace(
        mass=torch.tensor(STRUCTURE_MASS, dtype=dtype, device=device),
        inertia=torch.tensor(IZ, dtype=dtype, device=device))

    gravity = gd.Gravity(acceleration=(0.0, -GRAVITY_G))
    fluid = gd.gravity_force(fluid, gravity)
    for key in ("ViscousForce", "ViscousForcePrev", "GravityForcePrev"):
        # GravityForcePrev: gravity_force's delta form, beside the viscous
        # prior force
        fluid[key] = torch.zeros_like(fluid["Position"])

    grid = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff)
    case = StfbCase(
        dx=dx, adaptation=adaptation, grid=grid, eos=eos,
        riemann=rs.acoustic_riemann(eos), gravity=gravity,
        g_vec=torch.tensor(gravity.acceleration, dtype=dtype, device=device),
        wall=wall,
        wall_table=build_cell_table(wall["Position"], wall["NReal"], grid,
                                    cell_cap),
        block0=block, rb0=rb0, mask_b=mask_b, n_fluid=len(pos_f),
        n_block=len(pos_b), cell_cap=cell_cap, k_inner=k_inner,
        k_contact=k_contact)
    return case, fluid


def init_sim(case: StfbCase, fluid: dict,
             settle_time: float = RELAX_TIME) -> SimState:
    """The lists, then the reference's settling window of `settle_time`
    with the structure held (stfb.cpp relax_time); the state at release,
    time 0."""
    block = dict(case.block0)
    *nls, ovf = rebuild(case, fluid, block)
    pos = fluid["Position"]
    s = SimState(fluid=dict(fluid), block=block, rb=case.rb0,
                 nl_inner=nls[0], nl_fw=nls[1], nl_fb=nls[2], nl_bf=nls[3],
                 time=torch.zeros((), dtype=pos.dtype, device=pos.device),
                 n_adv=0, n_ac=0, overflow=ovf)
    if settle_time > 0:
        s = settle(case, s, t_relax=settle_time)
    return s


def _advection_step(case: StfbCase, s: SimState, frozen: bool) -> SimState:
    """One dual-criteria step; `frozen` holds the structure (the settling
    window: stfb.cpp:246-252 runs the rigid update only once the time
    reaches relax_time)."""
    kernel, h = case.kernel, case.adaptation.h
    fluid, block, rb = s.fluid, s.block, s.rb
    dt_adv = fd.advection_viscous_time_step(fluid, h, U_F, RHO0_F, MU_F)
    fluid = fd.density_summation(
        fluid, s.nl_inner, kernel, 2, RHO0_F, case.adaptation.sigma0,
        contacts=[(case.wall, s.nl_fw, RHO0_F), (block, s.nl_fb, RHO0_F)],
        free_surface=True)
    fluid = fd.viscous_force(fluid, s.nl_inner, kernel, 2, MU_F, h,
                             walls=[(case.wall, s.nl_fw), (block, s.nl_fb)])
    block = fsi.viscous_force_from_fluid(block, fluid, s.nl_bf, kernel, 2,
                                         MU_F, h)
    relax_t = torch.zeros_like(dt_adv)
    n_ac = 0
    while bool(relax_t < dt_adv):          # one host read per sub-step
        fluid, block, rb, dt = acoustic_substep(case, s, fluid, block, rb,
                                                dt_adv, frozen)
        relax_t = relax_t + dt
        n_ac += 1
    *nls, ovf = rebuild(case, fluid, block)
    return SimState(fluid=fluid, block=block, rb=rb, nl_inner=nls[0],
                    nl_fw=nls[1], nl_fb=nls[2], nl_bf=nls[3],
                    time=s.time + relax_t, n_adv=s.n_adv + 1,
                    n_ac=s.n_ac + n_ac, overflow=s.overflow | ovf)


def make_advection_step(case: StfbCase, frozen: bool = False):
    return lambda s: _advection_step(case, s, frozen)


def make_run_chunk(case: StfbCase, frozen: bool = False):
    """run_chunk(sim, t_target): advection steps until sim.time >=
    t_target; `frozen` holds the structure."""
    return chunk_runner(lambda s: _advection_step(case, s, frozen))


def settle(case: StfbCase, s: SimState, t_relax: float) -> SimState:
    """The relaxation window: the fluid settles around the held
    structure; then the clock restarts at 0 (the physical time starts at
    release, stfb.cpp:219-224)."""
    s = make_run_chunk(case, frozen=True)(s, t_relax)
    return dataclasses.replace(s, time=torch.zeros_like(s.time))


def free_surface_height(case: StfbCase, fluid: dict,
                        x_gauge: float = X_GAUGE):
    """The FreeSurfaceGauge (stfb.h:99-103, UpperFrontInAxisDirection over
    |x - x_gauge| <= 1.3 dx), a 0-d tensor."""
    hw = 1.3 * case.dx
    pos = fluid["Position"]
    valid = torch.arange(pos.shape[0], device=pos.device) < fluid["NReal"]
    in_col = valid & (torch.abs(pos[:, 0] - x_gauge) <= hw)
    return torch.max(torch.where(in_col, pos[:, 1],
                                 torch.full_like(pos[:, 1], -math.inf)))
