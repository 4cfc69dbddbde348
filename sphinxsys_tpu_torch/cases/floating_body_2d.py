"""2D floating rigid block, the Archimedes check of the rigid coupling
(counterpart of sphinxsys_tpu/cases/floating_body_2d.py): a block of half
the water's density, dropped with its bottom at the surface of a 1 x 0.8
tank filled to 0.5, settles into a heave about the draft of half its
height.

The coupling in every acoustic sub-step (constraint_dynamics.h:156-184):
the fluid's first half sees the block as a moving wall; the block takes
PressureForceFromFluid; the planar rigid equations are stepped
(physics/rigid.py); the rigid motion is imposed back on the block's
particles, and its acceleration becomes their AverageAcceleration; the
fluid's second half sees the moved block.  The rigid update is a
handful of scalar ops a sub-step, all on the device: gravity, the mask
and the block's initial positions are tensors of the case.  Both loops
are host loops, one host read of each condition.

    case, fluid = build_case(dx=0.05, device="cpu")
    sim = make_run_chunk(case)(init_sim(case, fluid), 0.05)
    print(heave(sim))
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
from sphinxsys_tpu_torch.physics import fsi
from sphinxsys_tpu_torch.physics import general as gd
from sphinxsys_tpu_torch.physics import rigid as rg
from sphinxsys_tpu_torch.physics import riemann as rs
from sphinxsys_tpu_torch.solver import chunk_runner

DL = 1.0           # tank width
DH = 0.8           # tank height
WH = 0.5           # water depth
BL, BH = 0.2, 0.1  # block size
RHO0_F = 1.0
RHO_RATIO = 0.5    # block density / water density
GRAVITY_G = 9.81
U_REF = 2.0 * math.sqrt(GRAVITY_G * WH)
C_F = 10.0 * U_REF


@dataclasses.dataclass
class SimState:
    """The carry: the fluid, the block's particles and its rigid state,
    the four lists (fluid inner, fluid -> wall, fluid -> block, block ->
    fluid), the time, the step counts and the overflow flag."""

    fluid: dict
    block: dict
    rb: rg.RigidBody2D
    nl_inner: NeighborList
    nl_fw: NeighborList
    nl_fb: NeighborList
    nl_bf: NeighborList
    time: torch.Tensor
    n_adv: int
    n_ac: int
    overflow: torch.Tensor


@dataclasses.dataclass(frozen=True)
class FloatingCase:
    dx: float
    adaptation: SPHAdaptation
    grid: CellGrid
    eos: WeaklyCompressibleFluid
    riemann: rs.AcousticRiemannSolver
    gravity: gd.Gravity
    g_vec: torch.Tensor       # the rigid body's gravity, on the device
    wall: Any
    wall_table: CellTable
    block0: Any               # the block at t = 0
    rb0: rg.RigidBody2D
    mask_b: torch.Tensor      # every block row
    n_fluid: int
    n_block: int
    cell_cap: int
    k_inner: int
    k_contact: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def hydrostatic(fluid: dict, pos_f, eos, surface_y: float, g: float,
                clamp: bool) -> dict:
    """p = rho0 g (surface_y - y) of the lattice positions `pos_f`
    (floored at 0 where `clamp`), then p and rho from the EoS's inverse
    in the state's dtype."""
    p = eos.rho0 * g * (surface_y - pos_f[:, 1])
    if clamp:
        p = p.clip(min=0.0)
    pos = fluid["Position"]
    p = torch.as_tensor(p, dtype=pos.dtype, device=pos.device)
    return dict(fluid, Density=eos.density_from_pressure(p), Pressure=p)


def rigid_block(pos_b, vol, rho, shape, dtype, device,
                keys=("PressureForceFromFluid",)) -> dict:
    """A rigid body's particles: a solid state with its shape normals,
    InitialPosition, the fluid-force fields of `keys` (and their
    Previous), ForcePrior, Force and AverageAcceleration at zero."""
    block = make_solid_state(pos_b, vol, rho, dtype, device)
    block = gd.normal_direction_from_shape(block, shape)
    block["InitialPosition"] = block["Position"]
    zeros = torch.zeros_like(block["Position"])
    for key in keys:
        block[key] = zeros.clone()
        block["Previous" + key] = zeros.clone()
    for key in ("ForcePrior", "Force", "AverageAcceleration"):
        block[key] = zeros.clone()
    return block


def build_case(dx: float = 0.02, dtype=PRODUCTION_DTYPE, cell_cap: int = 24,
               k_inner: int = 64, k_contact: int = 40, device="cuda"):
    """The water at rest at its hydrostatic pressure, the block with its
    bottom at the surface (draft 0: it must sink to RHO_RATIO BH), the
    tank wall.  Returns (case, fluid)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    bw = 4 * dx
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    block_shape = G.Box(G.Transform(translation=(DL / 2, WH + BH / 2)),
                        halfsize=(BL / 2, BH / 2))
    water_shape = G.Box(G.Transform(translation=(DL / 2, WH / 2)),
                        halfsize=(DL / 2, WH / 2))
    outer = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                  halfsize=(DL / 2 + bw, DH / 2 + bw))
    inner = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                  halfsize=(DL / 2, DH / 2))
    wall_shape = G.make_complex(("add", outer), ("sub", inner))

    dom_lo, dom_hi = (-bw, -bw), (DL + bw, DH + bw)
    pos_f, vol = generate_lattice(water_shape, dom_lo, dom_hi, dx)
    pos_w, _ = generate_lattice(wall_shape, dom_lo, dom_hi, dx)
    pos_b, _ = generate_lattice(block_shape, dom_lo, dom_hi, dx)

    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    fluid = make_fluid_state(pos_f, vol, RHO0_F, dtype, device)
    fluid = hydrostatic(fluid, pos_f, eos, WH, GRAVITY_G, clamp=False)
    wall = make_solid_state(pos_w, vol, RHO0_F, dtype, device)
    wall = gd.normal_direction_from_shape(wall, wall_shape)
    block = rigid_block(pos_b, vol, RHO_RATIO * RHO0_F, block_shape, dtype,
                        device)
    mask_b = torch.ones(len(pos_b), dtype=torch.bool, device=device)
    rb0 = rg.rigid_body_from_particles(block, mask_b)

    gravity = gd.Gravity(acceleration=(0.0, -GRAVITY_G))
    fluid = gd.gravity_force(fluid, gravity)
    grid = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff)
    case = FloatingCase(
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


def rebuild(case, fluid: dict, block: dict, wall=None):
    """The fluid's and the block's cell tables and the four lists; a
    moving `wall` (the wave cases') gets its table rebuilt, the case's
    static one keeps its own.  Returns (inner, fluid -> wall, fluid ->
    block, block -> fluid, overflow)."""
    pos, n_f = fluid["Position"], fluid["NReal"]
    n_b = block["NReal"]
    cutoff, grid, cap = case.adaptation.cutoff, case.grid, case.cell_cap
    if wall is None:
        wall, wall_table = case.wall, case.wall_table
    else:
        wall_table = build_cell_table(wall["Position"], wall["NReal"], grid,
                                      cap)
    table_f = build_cell_table(pos, n_f, grid, cap)
    table_b = build_cell_table(block["Position"], n_b, grid, cap)
    nl_inner = build_neighbor_list(pos, n_f, pos, n_f, table_f, grid, cutoff,
                                   k_max=case.k_inner, include_self=False)
    nl_fw = build_neighbor_list(pos, n_f, wall["Position"], wall["NReal"],
                                wall_table, grid, cutoff,
                                k_max=case.k_contact, include_self=True)
    nl_fb = build_neighbor_list(pos, n_f, block["Position"], n_b, table_b,
                                grid, cutoff, k_max=case.k_contact,
                                include_self=True)
    nl_bf = build_neighbor_list(block["Position"], n_b, pos, n_f, table_f,
                                grid, cutoff, k_max=case.k_contact,
                                include_self=True)
    ovf = nl_inner.overflow | nl_fw.overflow | nl_fb.overflow | nl_bf.overflow
    return nl_inner, nl_fw, nl_fb, nl_bf, ovf


def init_sim(case: FloatingCase, fluid: dict) -> SimState:
    block = dict(case.block0)
    *nls, ovf = rebuild(case, fluid, block)
    pos = fluid["Position"]
    return SimState(fluid=dict(fluid), block=block, rb=case.rb0,
                    nl_inner=nls[0], nl_fw=nls[1], nl_fb=nls[2], nl_bf=nls[3],
                    time=torch.zeros((), dtype=pos.dtype, device=pos.device),
                    n_adv=0, n_ac=0, overflow=ovf)


def move_block(case, b: dict, r: rg.RigidBody2D, r_new: rg.RigidBody2D,
               dt) -> dict:
    """The rigid motion `r_new` imposed on the block's particles, the COM
    acceleration from `r` their AverageAcceleration."""
    b = rg.constrain_by_rigid_body(b, case.mask_b, r_new,
                                   case.block0["InitialPosition"],
                                   case.rb0.com)
    acc = (r_new.vel - r.vel) / (dt + 1e-15)
    b["AverageAcceleration"] = acc.expand_as(b["Position"])
    return b


def rigid_update(case, b: dict, r: rg.RigidBody2D, dt):
    """The block's ForcePrior onto the rigid body, one rigid step under
    gravity, the block moved (`move_block`).  Returns (block, new rigid
    state)."""
    force, torque = rg.total_force_and_torque(b, case.mask_b, r,
                                              force_keys=("ForcePrior",))
    r_new = rg.rigid_step(r, force, torque, dt, gravity=case.g_vec)
    return move_block(case, b, r, r_new, dt), r_new


def acoustic_substep(case, s: SimState, f: dict, b: dict,
                     r: rg.RigidBody2D, dt_adv, frozen: bool = False):
    """The fluid's first half against the wall and the block, the
    block's pressure force and rigid update (none where `frozen`: stfb's
    settling window), the second half against the moved block.  Returns
    (fluid, block, rigid state, dt)."""
    kernel, h = case.kernel, case.adaptation.h
    dt = torch.minimum(fd.acoustic_time_step(f, case.eos, h), dt_adv)
    f = fd.acoustic_step_1st_half(f, s.nl_inner, kernel, 2, case.eos,
                                  case.riemann, dt,
                                  walls=[(case.wall, s.nl_fw), (b, s.nl_fb)])
    b = fsi.pressure_force_from_fluid(b, f, s.nl_bf, kernel, 2, case.riemann)
    if not frozen:
        b, r = rigid_update(case, b, r, dt)
    f = fd.acoustic_step_2nd_half(f, s.nl_inner, kernel, 2, case.riemann, dt,
                                  walls=[(case.wall, s.nl_fw), (b, s.nl_fb)])
    return f, b, r, dt


def _advection_step(case: FloatingCase, s: SimState) -> SimState:
    h = case.adaptation.h
    fluid, block, rb = s.fluid, s.block, s.rb
    dt_adv = fd.advection_time_step(fluid, h, U_REF)
    fluid = fd.density_summation(
        fluid, s.nl_inner, case.kernel, 2, RHO0_F, case.adaptation.sigma0,
        contacts=[(case.wall, s.nl_fw, RHO0_F), (block, s.nl_fb, RHO0_F)],
        free_surface=True)
    relax_t = torch.zeros_like(dt_adv)
    n_ac = 0
    while bool(relax_t < dt_adv):          # one host read per sub-step
        fluid, block, rb, dt = acoustic_substep(case, s, fluid, block, rb,
                                                dt_adv)
        relax_t = relax_t + dt
        n_ac += 1
    *nls, ovf = rebuild(case, fluid, block)
    return SimState(fluid=fluid, block=block, rb=rb, nl_inner=nls[0],
                    nl_fw=nls[1], nl_fb=nls[2], nl_bf=nls[3],
                    time=s.time + relax_t, n_adv=s.n_adv + 1,
                    n_ac=s.n_ac + n_ac, overflow=s.overflow | ovf)


def make_advection_step(case: FloatingCase):
    return lambda s: _advection_step(case, s)


def make_run_chunk(case: FloatingCase):
    """run_chunk(sim, t_target): advection steps until sim.time >=
    t_target."""
    return chunk_runner(lambda s: _advection_step(case, s))


def heave(s: SimState) -> float:
    """The block's mass-weighted COM height (the golden curve's
    CenterOfMassY)."""
    m = s.block["Mass"]
    return float(torch.sum(m * s.block["Position"][:, 1]) / torch.sum(m))


def draft(s: SimState) -> float:
    """WH - (COM y - BH / 2): RHO_RATIO BH = 0.05 at equilibrium."""
    return WH - (float(s.rb.com[1]) - BH / 2)
