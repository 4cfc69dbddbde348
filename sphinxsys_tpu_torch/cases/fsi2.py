"""fsi2 — flow-induced vibration of an elastic beam behind a cylinder
(counterpart of sphinxsys_tpu/cases/fsi2.py; reference tests/2d_examples/test_2d_fsi2/fsi2.{h,cpp}):
  * a channel 11 x 4.1 with a 20 dx inflow sponge, periodic along x, the
    wall its top and bottom strips; a cylinder r = 0.5 at (2, 2) with a
    0.2 x 3.5 beam behind it (one elastic "insert" body, the cylinder and
    the beam's root held);
  * fluid rho0 = 1, U = 1, c = 10, Re = 100; solid rho0 = 10, E = 1.4e3,
    nu = 0.4 (St. Venant-Kirchhoff, total Lagrangian);
  * three rates: the advection step (density summation, viscous force,
    transport-velocity correction, the viscous force on the solid and its
    normals), the acoustic sub-step (pressure relaxation, the pressure
    force on the solid, density relaxation with no Riemann dissipation)
    and, inside each acoustic sub-step, the solid's own sub-steps, whose
    averaged velocity and acceleration the fluid's wall boundary reads;
  * a parabolic inflow in the sponge, ramped up over t_ref = 2.

Two routes run it.  The gather route (`init_sim`, `make_run_chunk`): four
neighbour lists rebuilt every advection step (fluid inner on the
x-periodic grid, fluid -> wall, fluid -> solid, solid -> fluid), the
fluid's pair sums of physics/fluid.py and the couplings of physics/fsi.py
as torch ops:

    case, fluid, solid = build_case(dx=0.1)               # 5,180 fluid
    sim = make_run_chunk(case)(init_sim(case, fluid, solid), 0.1)

and the cell-block engine:

    scene, fluid, solid = build_block_case(dx=0.1)
    sim = sc.make_run_chunk(scene)(init_block_sim(scene, fluid, solid), 0.1)

`relax_insert` > 0 relaxes the insert's particles first (the reference's
relaxed, body-fitted insert; physics/relax.py).

On the cell-block engine (engine/scene.py): one x-periodic grid; the wall
strips' x-overhangs are trimmed (the wrap supplies those images); wall and
solid merge into one wall-type contact body, re-slotted every advection
step and refreshed in its slots every acoustic sub-step, so the fluid's
sweeps (B1-B4 on the card) run their moving-wall, periodic variants.  The
solid keeps its frozen neighbour lists (physics/solid.py) on both routes;
on this one it is coupled to the fluid through its cell windows
(physics/fsi_blocks.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from sphinxsys_tpu_torch.core import geometry as G
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.generators import generate_lattice
from sphinxsys_tpu_torch.core.materials import (SaintVenantKirchhoffSolid,
                                                WeaklyCompressibleFluid)
from sphinxsys_tpu_torch.core.state import make_fluid_state, make_solid_state
from sphinxsys_tpu_torch.device import PRODUCTION_DTYPE, resolve_device
from sphinxsys_tpu_torch.neighbors.cell_list import (
    CellGrid, build_cell_table, grid_from_bounds, wrap_positions,
)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list)
from sphinxsys_tpu_torch.physics import fluid as fd
from sphinxsys_tpu_torch.physics import fsi, fsi_blocks as fsb
from sphinxsys_tpu_torch.physics import general as gd
from sphinxsys_tpu_torch.physics import relax as rx
from sphinxsys_tpu_torch.physics import riemann as rs
from sphinxsys_tpu_torch.physics import solid as sd
from sphinxsys_tpu_torch.solver import chunk_runner

# constants (fsi2.h:16-40)
DL = 11.0
DH = 4.1
CYL_CENTER = (2.0, 2.0)
CYL_R = 0.5
BH = 0.4 * CYL_R            # beam height
BL = 7.0 * CYL_R            # beam length
RHO0_F = 1.0
U_F = 1.0
C_F = 10.0 * U_F
RE = 100.0
MU_F = RHO0_F * U_F * (2.0 * CYL_R) / RE
RHO0_S = 10.0
POISSON = 0.4
YOUNGS = 1.4e3 * RHO0_F * U_F * U_F
T_REF = 2.0  # inflow ramp time
TIP = (CYL_CENTER[0] + CYL_R + BL, CYL_CENTER[1])   # the beam-tip observer


@dataclasses.dataclass(frozen=True)
class FSICase:
    dx: float
    adaptation: SPHAdaptation
    grid_f: CellGrid     # the fluid's x-periodic grid
    grid_s: CellGrid     # the wall's and the insert's grid (plain, covers
                         # the insert's motion)
    eos: WeaklyCompressibleFluid
    material_s: SaintVenantKirchhoffSolid
    riemann: rs.AcousticRiemannSolver
    no_riemann: rs.NoRiemannSolver
    wall: Any            # wall strips' state
    wall_table: Any      # the wall's cell table (built once)
    rp: sd.ReferencePairs
    base_mask: torch.Tensor   # the held solid particles
    n_fluid: int
    n_wall: int
    n_solid: int
    cell_cap: int
    k_inner: int
    k_contact: int
    dl_sponge: float

    @property
    def kernel(self):
        return self.adaptation.kernel

    @property
    def box(self):
        return self.grid_f.periodic_lengths


@dataclasses.dataclass
class FSISim:
    """The gather route's carry: both bodies, the four lists, the time
    (0-d tensor), the advection, acoustic and solid step counters and the
    overflow flag (0-d bool tensor)."""

    fluid: dict
    solid: dict
    nl_ff: NeighborList      # fluid inner
    nl_fw: NeighborList      # fluid -> wall
    nl_fs: NeighborList      # fluid -> insert
    nl_sf: NeighborList      # insert -> fluid
    time: torch.Tensor
    n_adv: int
    n_ac: int
    n_s: int
    overflow: torch.Tensor


def insert_parts():
    """The insert's cylinder and beam (fsi2.h:16-40, 134-141)."""
    cylinder = G.Ball(center=CYL_CENTER, radius=CYL_R)
    beam = G.Box(G.Transform(translation=(CYL_CENTER[0] + (CYL_R + BL) / 2,
                                          CYL_CENTER[1])),
                 halfsize=((CYL_R + BL) / 2, BH / 2))
    return cylinder, beam


def insert_shape():
    """The elastic insert: the cylinder and the beam."""
    return G.make_complex(*(("add", part) for part in insert_parts()))


def build_case(dx: float = 0.1, dtype=PRODUCTION_DTYPE, cell_cap: int = 24,
               k_inner: int = 64, k_contact: int = 40, relax_insert: int = 0,
               device="cuda"):
    """The scene: fluid, wall strips, the elastic insert with its frozen
    topology and B matrix.  Returns (case, fluid, solid).
    `relax_insert` > 0: that many iterations of particle relaxation of the
    insert (cylinder and beam) before its topology is frozen — the
    reference's RunParticleRelaxation / ReloadParticles branch
    (fsi2.cpp:52-99), whose default is 1000; run on `device` in `dtype`."""
    device = resolve_device(device)
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    dl_sponge = dx * 20.0
    bw = dx * 4.0

    channel = G.Box(G.Transform(translation=((DL - dl_sponge) / 2, DH / 2)),
                    halfsize=((DL + dl_sponge) / 2, DH / 2))
    cylinder, beam = insert_parts()
    water_shape = G.make_complex(("add", channel), ("sub", cylinder),
                                 ("sub", beam))
    outer = G.Box(G.Transform(translation=((DL - dl_sponge) / 2, DH / 2)),
                  halfsize=((DL + dl_sponge) / 2 + bw, DH / 2 + bw))
    inner = G.Box(G.Transform(translation=((DL - dl_sponge) / 2, DH / 2)),
                  halfsize=((DL + dl_sponge) / 2 + 2 * bw, DH / 2))
    wall_shape = G.make_complex(("add", outer), ("sub", inner))
    insert = insert_shape()

    dom_lo = (-dl_sponge - bw, -bw)
    dom_hi = (DL + bw, DH + bw)
    pos_f, vol = generate_lattice(water_shape, dom_lo, dom_hi, dx)
    pos_w, _ = generate_lattice(wall_shape, dom_lo, dom_hi, dx)
    pos_s, _ = generate_lattice(insert, dom_lo, dom_hi, dx)
    if relax_insert:
        pad = 6 * dx
        grid_rx = grid_from_bounds(
            (CYL_CENTER[0] - CYL_R - pad, CYL_CENTER[1] - CYL_R - pad),
            (CYL_CENTER[0] + CYL_R + BL + pad, CYL_CENTER[1] + CYL_R + pad),
            adaptation.cutoff)
        pos_s = rx.relax_shape(
            insert, torch.as_tensor(pos_s, dtype=dtype, device=device),
            vol, adaptation, grid_rx, n_iterations=relax_insert,
            cell_cap=cell_cap, k_max=k_inner).cpu().numpy()

    fluid = make_fluid_state(pos_f, vol, RHO0_F, dtype, device)
    fluid["ViscousForce"] = torch.zeros_like(fluid["Velocity"])
    fluid["ViscousForcePrev"] = torch.zeros_like(fluid["Velocity"])

    wall = make_solid_state(pos_w, vol, RHO0_F, dtype, device)
    wall = gd.normal_direction_from_shape(wall, wall_shape)

    material_s = SaintVenantKirchhoffSolid(rho0=RHO0_S, youngs_modulus=YOUNGS,
                                           poisson_ratio=POISSON)
    solid = sd.make_elastic_solid_state(pos_s, vol, material_s, dtype, device)
    solid = gd.normal_direction_from_shape(solid, insert)
    zeros = torch.zeros_like(solid["Position"])
    solid["AverageVelocity"] = zeros
    solid["AverageAcceleration"] = zeros
    solid["TemporaryPosition"] = solid["Position"]
    for key in ("ViscousForceFromFluid", "PressureForceFromFluid"):
        solid[key] = zeros
        solid["Previous" + key] = zeros

    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    # the fluid grid is periodic along x over the water body (fsi2.cpp:146-147)
    grid_f = grid_from_bounds((-dl_sponge, -bw), (DL, DH + bw),
                              adaptation.cutoff, periodic=(True, False))
    grid_s = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff)

    # the solid's frozen topology and B matrix
    n_s = len(pos_s)
    p0 = solid["Position"]
    table = build_cell_table(p0, n_s, grid_s, cell_cap)
    nl = build_neighbor_list(p0, n_s, p0, n_s, table, grid_s,
                             adaptation.cutoff, k_max=k_inner,
                             include_self=False)
    if bool(nl.overflow):
        raise ValueError(f"k_inner={k_inner} / cell_cap={cell_cap} overflow: "
                         "the frozen pairs must be exact")
    rp = sd.freeze_reference_pairs(p0, nl, adaptation.kernel, 2)
    solid["LinearGradientCorrectionMatrix"] = \
        sd.linear_gradient_correction_matrix(rp, solid["VolumetricMeasure"])

    # the held part: the cylinder less the beam (fsi2.h:134-141), on the host
    ps64 = torch.as_tensor(pos_s, dtype=torch.float64)
    base_mask = (cylinder.contains(ps64) & ~beam.contains(ps64)).to(device)

    case = FSICase(
        dx=dx, adaptation=adaptation, grid_f=grid_f, grid_s=grid_s, eos=eos, material_s=material_s,
        riemann=rs.acoustic_riemann(eos), no_riemann=rs.no_riemann(eos),
        wall=wall, wall_table=build_cell_table(wall["Position"], wall["NReal"],
                                               grid_s, cell_cap),
        rp=rp, base_mask=base_mask, n_fluid=len(pos_f), n_wall=len(pos_w),
        n_solid=n_s, cell_cap=cell_cap, k_inner=k_inner, k_contact=k_contact,
        dl_sponge=dl_sponge)
    return case, fluid, solid


# ---------------------------------------------------------------------------
# The gather route
# ---------------------------------------------------------------------------

def rebuild_relations(case: FSICase, fluid: dict, solid: dict):
    """Periodic bounding, the cell tables and the four lists
    (fsi2.cpp:265-276).  Returns (wrapped fluid positions, nl_ff, nl_fw,
    nl_fs, nl_sf, overflow)."""
    pos_f = wrap_positions(fluid["Position"], case.grid_f)
    pos_s = solid["Position"]
    n_f, n_s = fluid["NReal"], solid["NReal"]
    cutoff, cap, kc = case.adaptation.cutoff, case.cell_cap, case.k_contact
    table_f = build_cell_table(pos_f, n_f, case.grid_f, cap)
    table_s = build_cell_table(pos_s, n_s, case.grid_s, cap)
    nl_ff = build_neighbor_list(pos_f, n_f, pos_f, n_f, table_f, case.grid_f,
                                cutoff, k_max=case.k_inner,
                                include_self=False)
    nl_fw = build_neighbor_list(pos_f, n_f, case.wall["Position"],
                                case.wall["NReal"], case.wall_table,
                                case.grid_s, cutoff, k_max=kc,
                                include_self=True)
    nl_fs = build_neighbor_list(pos_f, n_f, pos_s, n_s, table_s, case.grid_s,
                                cutoff, k_max=kc, include_self=True)
    nl_sf = build_neighbor_list(pos_s, n_s, pos_f, n_f, table_f, case.grid_f,
                                cutoff, k_max=kc, include_self=True)
    overflow = nl_ff.overflow | nl_fw.overflow | nl_fs.overflow \
        | nl_sf.overflow
    return pos_f, nl_ff, nl_fw, nl_fs, nl_sf, overflow


def init_sim(case: FSICase, fluid: dict, solid: dict) -> FSISim:
    pos_f, nl_ff, nl_fw, nl_fs, nl_sf, ovf = rebuild_relations(case, fluid,
                                                               solid)
    return FSISim(fluid=dict(fluid, Position=pos_f), solid=dict(solid),
                  nl_ff=nl_ff, nl_fw=nl_fw, nl_fs=nl_fs, nl_sf=nl_sf,
                  time=torch.zeros((), dtype=pos_f.dtype,
                                   device=pos_f.device),
                  n_adv=0, n_ac=0, n_s=0, overflow=ovf)


def advection_prep(case: FSICase, s: FSISim):
    """The advection step's fluid prep (density summation against the wall
    and the insert, the viscous force and the transport-velocity
    correction with both as walls), then the viscous force on the insert
    and its normals (fsi2.cpp:216-219).  Returns (fluid, solid)."""
    kernel, h, box = case.kernel, case.adaptation.h, case.box
    fluid, solid = s.fluid, s.solid
    walls = [(case.wall, s.nl_fw), (solid, s.nl_fs)]
    fluid = fd.density_summation(fluid, s.nl_ff, kernel, 2, RHO0_F,
                                 case.adaptation.sigma0,
                                 contacts=[(case.wall, s.nl_fw, RHO0_F),
                                           (solid, s.nl_fs, RHO0_S)],
                                 free_surface=False, box=box)
    fluid = fd.viscous_force(fluid, s.nl_ff, kernel, 2, MU_F, h, box=box,
                             walls=walls)
    fluid = fd.transport_velocity_correction(fluid, s.nl_ff, kernel, 2, h,
                                             coefficient=0.25, box=box,
                                             walls=walls)
    solid = fsi.viscous_force_from_fluid(solid, fluid, s.nl_sf, kernel, 2,
                                         MU_F, h, box=box)
    return fluid, fsi.update_elastic_normal_direction(solid)


def solid_substeps(case: FSICase, solid: dict, dt) -> tuple:
    """The solid's own sub-steps over the acoustic dt (fsi2.cpp:233-246),
    one host sync each in the loop's test.  Returns (solid, count)."""
    h, w0 = case.adaptation.h, case.kernel.w0(2)
    c0s = case.material_s.sound_speed
    so = fsi.initialize_displacement(solid)
    ds_sum = torch.zeros_like(dt)
    k = 0
    while bool(ds_sum < dt):
        dt_s = torch.minimum(sd.solid_acoustic_time_step(so, c0s, h),
                             dt - ds_sum)
        so = sd.integration_1st_half_pk2(so, case.rp, case.material_s, dt_s,
                                         h, w0)
        so = sd.fix_constraint(so, case.base_mask)
        so = sd.integration_2nd_half(so, case.rp, dt_s)
        ds_sum = ds_sum + dt_s
        k += 1
    return fsi.update_average_velocity_acceleration(so, dt), k


def acoustic_substep(case: FSICase, s: FSISim, fluid: dict, solid: dict,
                     dt_adv, t_now):
    """One acoustic sub-step: the fluid's 1st half against the wall and the
    insert, the pressure force on the insert, the 2nd half (no Riemann
    dissipation), the solid's sub-steps, the inflow.  Returns (fluid,
    solid, dt, solid sub-steps)."""
    kernel, h, box = case.kernel, case.adaptation.h, case.box
    dt = torch.minimum(fd.acoustic_time_step(fluid, case.eos, h), dt_adv)
    walls = [(case.wall, s.nl_fw), (solid, s.nl_fs)]
    fluid = fd.acoustic_step_1st_half(fluid, s.nl_ff, kernel, 2, case.eos,
                                      case.riemann, dt, box=box, walls=walls)
    solid = fsi.pressure_force_from_fluid(solid, fluid, s.nl_sf, kernel, 2,
                                          case.riemann, box=box)
    fluid = fd.acoustic_step_2nd_half(fluid, s.nl_ff, kernel, 2,
                                      case.no_riemann, dt, box=box,
                                      walls=walls)
    solid, k = solid_substeps(case, solid, dt)
    fluid = inflow_velocity(fluid, t_now + dt, case.dl_sponge)
    return fluid, solid, dt, k


def _advection_step(case: FSICase, s: FSISim) -> FSISim:
    dt_adv = fd.advection_viscous_time_step(s.fluid, case.adaptation.h, U_F,
                                            RHO0_F, MU_F)
    fluid, solid = advection_prep(case, s)
    relax_t = torch.zeros_like(dt_adv)
    n_ac = n_s = 0
    while bool(relax_t < dt_adv):          # one host sync per sub-step
        fluid, solid, dt, k = acoustic_substep(case, s, fluid, solid, dt_adv,
                                               s.time + relax_t)
        relax_t = relax_t + dt
        n_ac += 1
        n_s += k
    pos_f, nl_ff, nl_fw, nl_fs, nl_sf, ovf = rebuild_relations(case, fluid,
                                                               solid)
    return FSISim(fluid=dict(fluid, Position=pos_f), solid=solid, nl_ff=nl_ff,
                  nl_fw=nl_fw, nl_fs=nl_fs, nl_sf=nl_sf,
                  time=s.time + relax_t, n_adv=s.n_adv + 1,
                  n_ac=s.n_ac + n_ac, n_s=s.n_s + n_s,
                  overflow=s.overflow | ovf)


def make_run_chunk(case: FSICase):
    """run_chunk(sim, t_target): advance by advection steps until
    sim.time >= t_target."""
    return chunk_runner(lambda s: _advection_step(case, s))


def make_advection_step(case: FSICase):
    return lambda s: _advection_step(case, s)


def beam_tip_displacement(case: FSICase, solid: dict):
    """(x, y) displacement of the solid particle nearest the beam tip
    (0.5 (BRT + BRB), fsi2.cpp:47)."""
    pos0 = solid["InitialPosition"][:case.n_solid].cpu().numpy()
    i = int(np.argmin(np.linalg.norm(pos0 - np.asarray(TIP), axis=1)))
    d = (solid["Position"][i] - solid["InitialPosition"][i]).cpu().numpy()
    return float(d[0]), float(d[1])


def tip_observer(case: FSICase, solid: dict):
    """The reference's beam-tip observer (fsi2.cpp:46-48, 103, 166): one
    point at (6, 2) whose contact relation to the insert is built once and
    never updated, so its weights W(r0) V are frozen at the initial
    configuration.  Returns (indices, normalised weights) on the solid's
    device."""
    dtype, dev = solid["Position"].dtype, solid["Position"].device
    pos0 = solid["InitialPosition"][:case.n_solid].cpu().numpy()
    r = np.linalg.norm(pos0 - np.asarray(TIP), axis=1)
    idx = np.nonzero(r < case.adaptation.cutoff)[0]
    w = np.asarray([float(case.kernel.W(torch.as_tensor(ri, dtype=dtype), 2))
                    for ri in r[idx]])
    w = w * solid["VolumetricMeasure"].cpu().numpy()[idx]
    return (torch.as_tensor(idx, device=dev),
            torch.as_tensor(w / (w.sum() + 1e-15), dtype=dtype, device=dev))


def observe_tip(solid: dict, idx, weights) -> torch.Tensor:
    """The tip's position through the frozen weights (general_interpolation.h
    BaseInterpolation, normalised), a (2,) tensor on the solid's device."""
    return torch.sum(solid["Position"][idx] * weights[:, None], dim=0)


def inflow_velocity(state: dict, t, dl_sponge: float, mask=None) -> dict:
    """InflowVelocityCondition: the parabolic inflow of fsi2.h:146-167,
    ramped over T_REF, imposed in the sponge x < 0 (where `mask` holds,
    if one is given)."""
    pos, vel = state["Position"], state["Velocity"]
    u_ave = torch.where(t < T_REF,
                        0.5 * U_F * (1.0 - torch.cos(math.pi * t / T_REF)),
                        torch.full_like(t, U_F))
    y_local = pos[..., 1] - DH / 2
    h = DH / 2
    vx = (1.5 * u_ave * (1.0 - y_local * y_local / (h * h))).to(vel.dtype)
    in_buffer = (pos[..., 0] < 0.0) & (pos[..., 0] >= -dl_sponge - 1e-9)
    if mask is not None:
        in_buffer = in_buffer & mask
    return dict(state, Velocity=torch.stack(
        [torch.where(in_buffer, vx, vel[..., 0]), vel[..., 1]], dim=-1))


def inflow_velocity_b(fb: dict, t, dl_sponge: float) -> dict:
    """The inflow on the real slots of a block layout (the block route)."""
    return inflow_velocity(fb, t, dl_sponge, fb["SlotMask"])


def build_block_case(dx: float = 0.1, dtype=PRODUCTION_DTYPE, cap: int = 12,
                     c_max: int | None = None, device="cuda",
                     use_kernels: bool = True):
    """fsi2 on the cell-block engine (engine/scene.py), the JAX package's
    `build_block_case`: free_surface off, mu = MU_F, transport-velocity
    correction 0.25, the acoustic dt capped by the advection dt, the 2nd
    half with no Riemann dissipation (B3 with rho0c0_geo = 0).  c_max
    defaults to every cell of the periodic grid, rounded to 256 as the
    port's other cases round it.  Returns (BlockScene, fluid, solid); start
    with `init_block_sim`."""
    from sphinxsys_tpu_torch.engine import block_fluid as eng_mod
    from sphinxsys_tpu_torch.engine import scene as sc
    from sphinxsys_tpu_torch.neighbors.cell_blocks import dense_cell_map

    device = resolve_device(device)
    base, fluid, solid = build_case(dx=dx, dtype=dtype, device=device)
    grid = base.grid_f
    eng = eng_mod.BlockEngine(
        grid=grid, kernel=base.kernel, eos=base.eos, riemann1=base.riemann,
        riemann2=base.no_riemann, rho0=RHO0_F, sigma0=base.adaptation.sigma0,
        h=base.adaptation.h, speed_ref=U_F, dim=2, mu=MU_F, tvc_coef=0.25,
        tvc_limiter=None, free_surface=False, cap=cap,
        c_max=eng_mod.round_to(c_max or grid.ncells, 256), cap_ac_dt=True,
        wall_static=False, use_kernels=use_kernels)

    # trim the wall strips' x-overhangs: the periodic wrap supplies them
    wall = base.wall
    wx = wall["Position"][:, 0]
    wall_valid = torch.cat([(wx >= -base.dl_sponge - 1e-9) & (wx < DL - 1e-9),
                            torch.ones(base.n_solid, dtype=torch.bool,
                                       device=device)])
    wall_pos = wrap_positions(wall["Position"], grid)
    wall_zeros = torch.zeros_like(wall_pos)

    kernel, dim, h = base.kernel, 2, base.adaptation.h

    def wall_state_fn(aux):
        so = aux["solid"]
        return {
            "Position": torch.cat([wall_pos, wrap_positions(so["Position"],
                                                            grid)]),
            "VolumetricMeasure": torch.cat([wall["VolumetricMeasure"],
                                            so["VolumetricMeasure"]]),
            "AverageVelocity": torch.cat([wall_zeros, so["AverageVelocity"]]),
            "AverageAcceleration": torch.cat([wall_zeros,
                                              so["AverageAcceleration"]]),
            "NormalDirection": torch.cat([wall["NormalDirection"],
                                          so["NormalDirection"]]),
        }

    def post_prep(fb, aux, t):
        # the viscous force on the insert, its normals (fsi2.cpp:216-219)
        so = fsb.viscous_force_from_fluid_b(aux["solid"], fb, aux["sol_win"],
                                            kernel, dim, MU_F, h, box=eng.box)
        return fb, dict(aux, solid=fsi.update_elastic_normal_direction(so))

    def after_first_half(f, aux, dt, t):
        so = fsb.pressure_force_from_fluid_b(aux["solid"], f, aux["sol_win"],
                                             kernel, dim, base.riemann,
                                             box=eng.box)
        return f, dict(aux, solid=so)

    def post_acoustic(f, aux, dt, t_next):
        so, k = solid_substeps(base, aux["solid"], dt)
        f = inflow_velocity_b(f, t_next, base.dl_sponge)
        return f, dict(aux, solid=so, n_s=aux["n_s"] + k)

    def rebuild_aux(bm_f, aux):
        dm_f = dense_cell_map(bm_f.occ_cells, grid.ncells, bm_f.c_max)
        return dict(aux, sol_win=fsb.solid_windows(aux["solid"]["Position"],
                                                   grid, bm_f, dm_f))

    scene = sc.moving_wall_scene(
        base, eng=eng, device=device, wall_state_fn=wall_state_fn,
        wall_valid=wall_valid, c_max_wall=eng_mod.round_to(grid.ncells, 32),
        hooks=sc.Hooks(post_prep=post_prep, after_first_half=after_first_half,
                       post_acoustic=post_acoustic, rebuild_aux=rebuild_aux),
        wrap=True)
    return scene, fluid, solid


def init_block_sim(scene, fluid: dict, solid: dict):
    """The initial BlockSim, the solid and its counter of sub-steps (`n_s`)
    in `sim.aux`."""
    from sphinxsys_tpu_torch.engine import scene as sc

    aux = {"solid": dict(solid), "sol_win": None, "n_s": 0}
    return sc.init_sim(scene, fluid, aux=aux)
