"""Tethered dead fish in flow — the multibody-in-flow composition
(counterpart of sphinxsys_tpu/cases/tethered_fish_2d.py; reference
tests/2d_examples/test_2d_tethered_dead_fish_in_flow/src/
tethered_dead_fish_in_flow.cpp):

  * a passive elastic fish (SVK, E = 200 rho U^2) of length 3.738, nose
    at (2, 4), in an 11 x 8 channel behind a 20 dx sponge whose inflow
    ramps to U = 1 over t_ref = 2; the emitter at the left, the disposer
    at the right, the top and bottom walls;
  * its HEAD (x < 3) is a rigid body on a Planar mobilizer (cpp:370:
    physics/articulated.py `planar_tree`, slider-x -> slider-y -> pin),
    tethered to the anchor (-1, 4) by a cable spring (cpp:378-379:
    stiffness 100, rest length 3, dissipation 10);
  * per solid sub-step the total force and torque on the head particles
    (cpp:402) and the cable's feed one RK4 step of the multibody, and the
    head particles are constrained to its rigid motion (cpp:404); the
    body aft of the head flaps passively in the wake.

The loops follow cases/fish_fsi_2d.py: host loops with `dt` a device
tensor and one host read per loop test (the solid sub-steps' `ds_sum <
dt` too), so that the step counts are the JAX package's.  The fish's
inside test runs on the host in float64 (the JAX package's host_eval).

    case, fluid, fish = build_case(dx=0.15, device="cpu")   # 5,597 rows + 68
    sim = make_run_chunk(case)(init_sim(case, fluid, fish), 0.1)
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from sphinxsys_tpu_torch.cases import fish_undulation_2d as fish_mod
from sphinxsys_tpu_torch.core import geometry as G
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.generators import generate_lattice
from sphinxsys_tpu_torch.core.materials import (SaintVenantKirchhoffSolid,
                                                WeaklyCompressibleFluid)
from sphinxsys_tpu_torch.core.state import (FAR_AWAY, make_fluid_state,
                                            make_solid_state)
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.neighbors.cell_list import (CellGrid, CellTable,
                                                    build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list)
from sphinxsys_tpu_torch.physics import articulated as ab
from sphinxsys_tpu_torch.physics import boundary as bd
from sphinxsys_tpu_torch.physics import fluid as fd
from sphinxsys_tpu_torch.physics import fsi
from sphinxsys_tpu_torch.physics import general as gd
from sphinxsys_tpu_torch.physics import riemann as rs
from sphinxsys_tpu_torch.physics import solid as sd
from sphinxsys_tpu_torch.solver import chunk_runner

# tethered_dead_fish_in_flow.cpp:18-44
DL = 11.0
DH = 8.0
CX, CY = 2.0, 4.0
FISH_L = 3.738
HEAD_SIZE = 1.0
ANCHOR = (-1.0, CY)
CABLE_K = 100.0
CABLE_L0 = 3.0
CABLE_C = 10.0
RHO0_F = 1.0
U_F = 1.0
C_F = 10.0 * U_F
RE = 5.0e3
MU_F = RHO0_F * U_F * FISH_L / RE
RHO0_S = 1.0
E_S = 2.0e2 * RHO0_F * U_F * U_F
POISSON = 0.3925
T_REF = 2.0


@dataclasses.dataclass
class TetherSim:
    """The carry: both bodies, the Planar mobilizer's (q, u), the four
    lists, the time (0-d tensor), the advection, acoustic and solid step
    counts and the overflow flag (0-d bool tensor)."""

    fluid: dict
    fish: dict
    q: torch.Tensor          # planar mobilizer coordinates (dx, dy, theta)
    u: torch.Tensor
    nl_ff: NeighborList
    nl_fs: NeighborList
    nl_sf: NeighborList
    nl_fw: NeighborList      # fluid -> wall
    time: torch.Tensor
    n_adv: int
    n_ac: int
    n_s: int
    overflow: torch.Tensor


@dataclasses.dataclass(frozen=True)
class TetherCase:
    dx: float
    adaptation: SPHAdaptation
    grid: CellGrid
    eos: WeaklyCompressibleFluid
    material_s: SaintVenantKirchhoffSolid
    riemann: rs.AcousticRiemannSolver
    no_riemann: rs.NoRiemannSolver
    rp: sd.ReferencePairs
    wall: dict
    wall_table: CellTable
    tree: ab.ArticulatedTree
    head_mask: torch.Tensor      # (n_fish,) the head particle set
    head_station: torch.Tensor   # (n_fish, 3) body-frame stations
    nose_station: torch.Tensor   # (3,) cable attachment in the head frame
    anchor: torch.Tensor         # (3,) the cable's fixed end
    emitter: bd.AlignedBoxRegion
    disposer: bd.AlignedBoxRegion
    n_fluid: int
    n_fish: int
    cell_cap: int
    k_inner: int
    k_contact: int
    dl_sponge: float

    @property
    def kernel(self):
        return self.adaptation.kernel


def _scaled_fish_polygon(dx: float) -> G.Polygon:
    scale = FISH_L / fish_mod.FISH_LENGTH
    poly = fish_mod.fish_polygon(0.5 * dx / scale)
    verts = np.asarray(poly.vertices) * scale
    return G.Polygon(vertices=tuple(map(tuple, verts)))


def build_case(dx: float = FISH_L / 100.0, dtype=PRODUCTION_DTYPE,
               cell_cap: int = 24, k_inner: int = 40, k_contact: int = 24,
               reserve: float = 0.15, device="cuda"):
    """The channel's water less the fish (capacity `reserve` above its
    particles, Alive on those), the walls, the passive fish with its
    frozen pairs, and the head's Planar tree.  Returns (case, fluid,
    fish)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    dl_sponge = 20.0 * dx
    bw = 4.0 * dx
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)

    fish_shape = _scaled_fish_polygon(dx)
    pos_s, vol_s = generate_lattice(
        fish_shape, (-0.1, -0.6), (FISH_L + 0.1, 0.6), dx)
    pos_s = pos_s + np.asarray([CX, CY])
    n_s = len(pos_s)

    water_shape = G.Box(
        G.Transform(translation=((DL - dl_sponge) / 2.0, DH / 2.0)),
        halfsize=((DL + dl_sponge) / 2.0, DH / 2.0))
    pos_all, vol = generate_lattice(water_shape, (-dl_sponge, 0.0), (DL, DH),
                                    dx)
    in_fish = fish_shape.contains(torch.as_tensor(
        pos_all - np.asarray([CX, CY]), dtype=torch.float64))
    pos_f = pos_all[~in_fish.numpy()]
    n_f = len(pos_f)
    cap_f = int(n_f * (1.0 + reserve))
    # every row a particle of this volume (NReal = capacity), as in JAX
    fluid = make_fluid_state(np.pad(pos_f, ((0, cap_f - n_f), (0, 0)),
                                    constant_values=FAR_AWAY),
                             vol, RHO0_F, dtype, device)
    fluid["Alive"] = torch.arange(cap_f, device=device) < n_f
    fluid["Indicator"] = torch.zeros(cap_f, dtype=torch.int32, device=device)
    fluid["PreviousSurfaceIndicator"] = torch.ones(cap_f, dtype=torch.int32,
                                                   device=device)
    fluid["PositionDivergence"] = torch.zeros(cap_f, dtype=dtype,
                                              device=device)
    fluid["ViscousForce"] = torch.zeros_like(fluid["Velocity"])
    fluid["ViscousForcePrev"] = torch.zeros_like(fluid["Velocity"])

    # the top and bottom channel walls
    wall_outer = G.Box(
        G.Transform(translation=((DL - dl_sponge) / 2.0, DH / 2.0)),
        halfsize=((DL + dl_sponge) / 2.0 + bw, DH / 2.0 + bw))
    wall_shape = G.make_complex(("add", wall_outer), ("sub", water_shape))
    pos_w, _ = generate_lattice(
        wall_shape, (-dl_sponge - bw - dx, -bw - dx),
        (DL + bw + dx, DH + bw + dx), dx)
    wall = make_solid_state(pos_w, vol, RHO0_F, dtype, device)
    wall = gd.normal_direction_from_shape(wall, wall_shape)

    material_s = SaintVenantKirchhoffSolid(rho0=RHO0_S, youngs_modulus=E_S,
                                           poisson_ratio=POISSON)
    fish = sd.make_elastic_solid_state(pos_s, vol_s, material_s, dtype,
                                       device)
    zeros = torch.zeros_like(fish["Position"])
    fish["AverageVelocity"] = zeros
    fish["AverageAcceleration"] = zeros
    fish["TemporaryPosition"] = fish["Position"]
    for key in ("ViscousForceFromFluid", "PressureForceFromFluid"):
        fish[key] = zeros
        fish["Previous" + key] = zeros

    grid = grid_from_bounds((-dl_sponge - 2 * bw, -2 * bw),
                            (DL + 2 * bw, DH + 2 * bw), adaptation.cutoff)
    rp = fish_mod.frozen_pairs(fish, grid, adaptation, k_inner, cell_cap)
    fish["LinearGradientCorrectionMatrix"] = \
        sd.linear_gradient_correction_matrix(rp, fish["VolumetricMeasure"])
    local = gd.normal_direction_from_shape(
        dict(fish, Position=fish["Position"] - t([CX, CY])), fish_shape)
    fish["NormalDirection"] = local["NormalDirection"]
    fish["InitialNormalDirection"] = local["NormalDirection"]

    # --- the head, a rigid body on the Planar mobilizer -------------------
    head_mask = pos_s[:, 0] < CX + HEAD_SIZE
    m_i = fish["Mass"].cpu().numpy()         # in the state's dtype, as JAX
    m_head = float(m_i[head_mask].sum())
    com0 = (m_i[head_mask, None] * pos_s[head_mask]).sum(0) / m_head
    r = pos_s[head_mask] - com0
    izz = float((m_i[head_mask] * (r ** 2).sum(1)).sum())
    tree = ab.planar_tree(m_head, izz, (com0[0], com0[1], 0.0), dtype=dtype,
                          device=device)
    stations = np.zeros((n_s, 3))
    stations[:, :2] = pos_s - com0

    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    case = TetherCase(
        dx=dx, adaptation=adaptation, grid=grid, eos=eos,
        material_s=material_s, riemann=rs.acoustic_riemann(eos),
        no_riemann=rs.no_riemann(eos), rp=rp, wall=wall,
        wall_table=build_cell_table(wall["Position"], wall["NReal"], grid,
                                    cell_cap),
        tree=tree, head_mask=torch.as_tensor(head_mask, device=device),
        head_station=t(stations),
        nose_station=t([CX - com0[0], CY - com0[1], 0.0]),
        anchor=t([ANCHOR[0], ANCHOR[1], 0.0]),
        emitter=bd.AlignedBoxRegion(lower=(-dl_sponge, 0.0),
                                    upper=(-dl_sponge + bw, DH), axis=0),
        disposer=bd.AlignedBoxRegion(lower=(DL - bw, -bw),
                                     upper=(DL + bw, DH + bw), axis=0),
        n_fluid=cap_f, n_fish=n_s, cell_cap=cell_cap, k_inner=k_inner,
        k_contact=k_contact, dl_sponge=dl_sponge)
    return case, fluid, fish


def rebuild_relations(case: TetherCase, fluid: dict, fish: dict):
    """The two cell tables and the four lists (fluid inner over the live
    rows, fluid -> fish, fish -> fluid, fluid -> wall).  Returns (nl_ff,
    nl_fs, nl_sf, nl_fw, overflow)."""
    alive = fluid["Alive"]
    n_s = fish["NReal"]
    cutoff, cap, kc = case.adaptation.cutoff, case.cell_cap, case.k_contact
    pos_f, pos_s = fluid["Position"], fish["Position"]
    table_f = build_cell_table(pos_f, alive, case.grid, cap)
    table_s = build_cell_table(pos_s, n_s, case.grid, cap)
    nl_ff = build_neighbor_list(pos_f, alive, pos_f, alive, table_f, case.grid,
                                cutoff, k_max=case.k_inner, include_self=False)
    nl_fs = build_neighbor_list(pos_f, alive, pos_s, n_s, table_s, case.grid,
                                cutoff, k_max=kc, include_self=True)
    nl_sf = build_neighbor_list(pos_s, n_s, pos_f, alive, table_f, case.grid,
                                cutoff, k_max=kc, include_self=True)
    nl_fw = build_neighbor_list(pos_f, alive, case.wall["Position"],
                                case.wall["NReal"], case.wall_table,
                                case.grid, cutoff, k_max=kc,
                                include_self=True)
    overflow = nl_ff.overflow | nl_fs.overflow | nl_sf.overflow \
        | nl_fw.overflow
    return nl_ff, nl_fs, nl_sf, nl_fw, overflow


def init_sim(case: TetherCase, fluid: dict, fish: dict) -> TetherSim:
    nl_ff, nl_fs, nl_sf, nl_fw, ovf = rebuild_relations(case, fluid, fish)
    pos = fluid["Position"]
    z3 = torch.zeros(3, dtype=pos.dtype, device=pos.device)
    return TetherSim(fluid=dict(fluid), fish=dict(fish), q=z3, u=z3,
                     nl_ff=nl_ff, nl_fs=nl_fs, nl_sf=nl_sf, nl_fw=nl_fw,
                     time=torch.zeros((), dtype=pos.dtype, device=pos.device),
                     n_adv=0, n_ac=0, n_s=0, overflow=ovf)


def inflow_condition(fluid: dict, t, dl_sponge: float) -> dict:
    """The ramped uniform inflow over the sponge (cpp:170-190)."""
    pos, vel = fluid["Position"], fluid["Velocity"]
    in_sponge = (fluid["Alive"] & (pos[:, 0] < 0.0)
                 & (pos[:, 0] >= -dl_sponge))
    u_ave = torch.where(t < T_REF,
                        0.5 * U_F * (1.0 - torch.cos(math.pi * t / T_REF)),
                        torch.full_like(t, U_F))
    return dict(fluid, Velocity=torch.stack(
        [torch.where(in_sponge, u_ave, vel[:, 0]), vel[:, 1]], dim=-1))


def cable_force(case: TetherCase, kin: ab.LinkKinematics):
    """CableSpring (cpp:378-379): a taut-only linear spring with
    dissipation along the anchor -> nose cable.  Returns (force, torque
    about the COM, tension)."""
    R, p = kin.R[2], kin.p[2]
    arm = R @ case.nose_station
    attach = p + arm
    v_attach = kin.v[2] + torch.linalg.cross(kin.w[2], arm, dim=-1)
    d = attach - case.anchor
    length = torch.linalg.norm(d) + 1e-12
    e = d / length
    stretch = length - CABLE_L0
    ldot = torch.dot(v_attach, e)
    tension = torch.where(stretch > 0.0, CABLE_K * stretch + CABLE_C * ldot,
                          torch.zeros_like(stretch))
    tension = torch.clamp(tension, min=0.0)
    f = -tension * e
    torque = torch.linalg.cross(arm, f, dim=-1)
    return f, torque, tension


def _head_force_torque(case: TetherCase, fish: dict, kin):
    """TotalForceOnBodyPartForSimBody (cpp:402): the sum of the particle
    forces on the head and their torque about the body origin (the
    COM)."""
    F2 = fish["Force"] + fish["ForcePrior"]
    m = case.head_mask
    zero = torch.zeros((), dtype=F2.dtype, device=F2.device)
    fx = torch.sum(torch.where(m, F2[:, 0], zero))
    fy = torch.sum(torch.where(m, F2[:, 1], zero))
    com = kin.c[2]
    rx = fish["Position"][:, 0] - com[0]
    ry = fish["Position"][:, 1] - com[1]
    tz = torch.sum(torch.where(m, rx * F2[:, 1] - ry * F2[:, 0], zero))
    return torch.stack([fx, fy, zero]), torch.stack([zero, zero, tz])


def advection_prep(case: TetherCase, s: TetherSim):
    """The advection step's fluid prep against the fish and the walls,
    then the viscous force on the fish and its normals.  Returns (fluid,
    fish)."""
    kernel, h = case.kernel, case.adaptation.h
    fish = s.fish
    walls = [(fish, s.nl_fs), (case.wall, s.nl_fw)]
    fluid = fd.free_surface_indication(
        s.fluid, s.nl_ff, kernel, 2,
        contacts=[(fish, s.nl_fs, None), (case.wall, s.nl_fw, None)],
        spatial_temporal=True)
    fluid = fd.density_summation_freestream(
        fluid, s.nl_ff, kernel, 2, RHO0_F, case.adaptation.sigma0,
        contacts=[(fish, s.nl_fs, RHO0_S), (case.wall, s.nl_fw, RHO0_F)])
    fluid = fd.viscous_force(fluid, s.nl_ff, kernel, 2, MU_F, h, walls=walls)
    fluid = fd.transport_velocity_correction(
        fluid, s.nl_ff, kernel, 2, h, coefficient=0.2, walls=walls,
        scope_mask=(fluid["Indicator"] == 0) & fluid["Alive"])
    fish = fsi.viscous_force_from_fluid(fish, fluid, s.nl_sf, kernel, 2,
                                        MU_F, h)
    return fluid, fsi.update_elastic_normal_direction(fish)


def articulated_step(case: TetherCase, fish: dict, q, u, dt_s, t):
    """The head's multibody step: the particle forces and the cable's
    mapped to joint torques, one RK4 step of (q, u).  Returns (q, u)."""
    kin = ab.forward_kinematics(case.tree, q, u)
    f_w, t_w = _head_force_torque(case, fish, kin)
    f_c, t_c, _ = cable_force(case, kin)
    z3 = torch.zeros_like(f_w)
    forces = torch.stack([z3, z3, f_w + f_c])
    torques = torch.stack([z3, z3, t_w + t_c])
    tau = ab.generalized_forces(case.tree, q, forces, torques)
    step = ab.make_articulated_step(case.tree, (0.0, 0.0, 0.0))
    return step(t, q, u, dt_s, tau)


def constrain_head(case: TetherCase, fish: dict, q, u) -> dict:
    """The head particles moved with the Planar body's rigid motion
    (ConstraintBodyPartBySimBody, cpp:404)."""
    kin = ab.forward_kinematics(case.tree, q, u)
    so3 = {"Position": F.pad(fish["Position"], (0, 1)),
           "Velocity": F.pad(fish["Velocity"], (0, 1))}
    so3 = ab.constrain_by_link(so3, case.head_mask, kin, 2,
                               case.head_station)
    mask = case.head_mask[:, None]
    return dict(fish,
                Position=torch.where(mask, so3["Position"][:, :2],
                                     fish["Position"]),
                Velocity=torch.where(mask, so3["Velocity"][:, :2],
                                     fish["Velocity"]))


def solid_substep(case: TetherCase, fish: dict, q, u, dt_s, t):
    """One of the fish's sub-steps: the 1st half, the head's multibody
    step and constraint, the 2nd half.  Returns (fish, q, u)."""
    h = case.adaptation.h
    fish = sd.integration_1st_half_pk2(fish, case.rp, case.material_s, dt_s,
                                       h, case.kernel.w0(2))
    q, u = articulated_step(case, fish, q, u, dt_s, t)
    fish = constrain_head(case, fish, q, u)
    return sd.integration_2nd_half(fish, case.rp, dt_s), q, u


def solid_substeps(case: TetherCase, fish: dict, q, u, dt, t_now):
    """The fish's sub-steps over the acoustic dt from t_now, one host read
    each in the loop's test.  Returns (fish, q, u, count)."""
    c0s = case.material_s.sound_speed
    so = fsi.initialize_displacement(fish)
    ds_sum = torch.zeros_like(dt)
    k = 0
    while bool(ds_sum < dt):
        dt_s = torch.minimum(
            sd.solid_acoustic_time_step(so, c0s, case.adaptation.h),
            dt - ds_sum)
        so, q, u = solid_substep(case, so, q, u, dt_s, t_now + ds_sum)
        ds_sum = ds_sum + dt_s
        k += 1
    return fsi.update_average_velocity_acceleration(so, dt), q, u, k


def acoustic_substep(case: TetherCase, s: TetherSim, fluid: dict,
                     fish: dict, q, u, dt_adv, t_now):
    """One acoustic sub-step from t_now: the 1st half against the fish and
    the walls, the inflow, the pressure force on the fish, the 2nd half
    (no Riemann dissipation), the fish's sub-steps.  Returns (fluid,
    fish, q, u, dt, solid sub-steps)."""
    kernel, h = case.kernel, case.adaptation.h
    dt = torch.minimum(fd.acoustic_time_step(fluid, case.eos, h), dt_adv)
    walls = [(fish, s.nl_fs), (case.wall, s.nl_fw)]
    fluid = fd.acoustic_step_1st_half(fluid, s.nl_ff, kernel, 2, case.eos,
                                      case.riemann, dt, walls=walls)
    fluid = inflow_condition(fluid, t_now, case.dl_sponge)
    fish = fsi.pressure_force_from_fluid(fish, fluid, s.nl_sf, kernel, 2,
                                         case.riemann)
    fluid = fd.acoustic_step_2nd_half(fluid, s.nl_ff, kernel, 2,
                                      case.no_riemann, dt, walls=walls)
    fish, q, u, k = solid_substeps(case, fish, q, u, dt, t_now)
    return fluid, fish, q, u, dt, k


def open_boundaries(case: TetherCase, fluid: dict, pos_prev) -> dict:
    """The disposer, then the emitter (crossing from `pos_prev`); the
    injection overflow flag left in the state."""
    fluid = bd.disposer_outflow_deletion(fluid, case.disposer)
    return bd.emitter_inflow_injection(fluid, case.emitter, prev_pos=pos_prev)


def _advection_step(case: TetherCase, s: TetherSim) -> TetherSim:
    pos_prev = s.fluid["Position"]
    dt_adv = fd.advection_viscous_time_step(s.fluid, case.adaptation.h, U_F,
                                            RHO0_F, MU_F)
    fluid, fish = advection_prep(case, s)
    q, u = s.q, s.u
    relax_t = torch.zeros_like(dt_adv)
    n_ac = n_s = 0
    while bool(relax_t < dt_adv):          # one host read per sub-step
        fluid, fish, q, u, dt, k = acoustic_substep(
            case, s, fluid, fish, q, u, dt_adv, s.time + relax_t)
        relax_t = relax_t + dt
        n_ac += 1
        n_s += k
    fluid = open_boundaries(case, fluid, pos_prev)
    inj_ovf = fluid.pop("_InjectionOverflow")
    nl_ff, nl_fs, nl_sf, nl_fw, ovf = rebuild_relations(case, fluid, fish)
    return TetherSim(fluid=fluid, fish=fish, q=q, u=u, nl_ff=nl_ff,
                     nl_fs=nl_fs, nl_sf=nl_sf, nl_fw=nl_fw,
                     time=s.time + relax_t, n_adv=s.n_adv + 1,
                     n_ac=s.n_ac + n_ac, n_s=s.n_s + n_s,
                     overflow=s.overflow | ovf | inj_ovf)


def make_advection_step(case: TetherCase):
    return lambda s: _advection_step(case, s)


def make_run_chunk(case: TetherCase):
    """run_chunk(sim, t_target): advection steps until sim.time >=
    t_target."""
    return chunk_runner(lambda s: _advection_step(case, s))


def head_com(case: TetherCase, s: TetherSim) -> np.ndarray:
    kin = ab.forward_kinematics(case.tree, s.q, s.u)
    return kin.c[2][:2].cpu().numpy()


def cable_tension(case: TetherCase, s: TetherSim) -> float:
    kin = ab.forward_kinematics(case.tree, s.q, s.u)
    return float(cable_force(case, kin)[2])
