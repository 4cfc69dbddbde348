"""Self-propelled fish in a channel — the fish's full FSI (counterpart of
sphinxsys_tpu/cases/fish_fsi_2d.py; reference tests/2d_examples/
test_2d_flow_stream_around_fish/2d_flow_stream_around_fish.cpp):

  * a 0.8 x 0.4 channel of water at rest behind a 20 dx sponge (the
    reference's FreeStreamVelocity has u_ref = 0: the far field stays at
    rest), open at both ends: the emitter at the left, the disposer at
    the right, and the free-stream velocity correction on the
    surface-indicated particles;
  * the fish (cases/fish_undulation_2d.py, nose at (0.24, 0.2)), a
    composite active-muscle / passive-body / stiff-spine total-Lagrangian
    solid driven by the travelling-wave active strain inside its own
    sub-steps;
  * three nested loops, as in fsi2: the advection step (the surface
    indication, the free-stream density, the viscous force, the
    transport-velocity correction of the live bulk, the viscous force on
    the fish and its normals), the acoustic sub-step (pressure
    relaxation against the fish as a moving wall, the free-stream
    correction, the pressure force on the fish, density relaxation) and,
    inside it, the fish's sub-steps (the active strain, then both halves
    of the total-Lagrangian step), whose averaged velocity and
    acceleration the fluid's wall terms read.

Single resolution (fish dx = fluid dx), as in the JAX package.  The fluid
has 10% more rows than particles (`reserve`), its NReal the particle
count: the emitter's clones past NReal are not seen by the time steps.

    case, fluid, fish = build_case(dx=0.01, device="cpu")   # 4,360 + 36 rows
    sim = make_run_chunk(case)(init_sim(case, fluid, fish), 0.02)

All three loops are host loops with one host read of each condition, as
in cases/fsi2.py, so that the counts follow JAX's float arithmetic.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sphinxsys_tpu_torch.cases import fish_undulation_2d as fish_mod
from sphinxsys_tpu_torch.core import geometry as G
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.generators import generate_lattice
from sphinxsys_tpu_torch.core.materials import (SaintVenantKirchhoffSolid,
                                                WeaklyCompressibleFluid)
from sphinxsys_tpu_torch.core.state import make_fluid_state
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.neighbors.cell_list import (CellGrid,
                                                    build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list)
from sphinxsys_tpu_torch.physics import boundary as bd
from sphinxsys_tpu_torch.physics import fluid as fd
from sphinxsys_tpu_torch.physics import fsi
from sphinxsys_tpu_torch.physics import general as gd
from sphinxsys_tpu_torch.physics import riemann as rs
from sphinxsys_tpu_torch.physics import solid as sd
from sphinxsys_tpu_torch.solver import chunk_runner

# 2d_flow_stream_around_fish.h:8-40
DL = 0.8
DH = 0.4
DX_REF = 0.0025
CX = 0.3 * DL               # the fish's nose
CY = DH / 2.0
RHO0_F = 1000.0
U_F = 1.0
C_F = 10.0 * U_F
RE = 30000.0
MU_F = RHO0_F * U_F * 0.3 / RE
T_REF = 2.0                 # the free-stream ramp (u_ref = 0: target 0)


@dataclasses.dataclass
class FishFSISim:
    """The carry: both bodies, the three lists, the time (0-d tensor), the
    advection, acoustic and solid step counts, the overflow flag (0-d
    bool tensor: a list, or the emitter, ran out of room)."""

    fluid: dict
    fish: dict
    nl_ff: NeighborList      # fluid inner
    nl_fs: NeighborList      # fluid -> fish
    nl_sf: NeighborList      # fish -> fluid
    time: torch.Tensor
    n_adv: int
    n_ac: int
    n_s: int
    overflow: torch.Tensor


@dataclasses.dataclass(frozen=True)
class FishFSICase:
    dx: float
    adaptation: SPHAdaptation
    grid: CellGrid               # one grid over the whole domain
    eos: WeaklyCompressibleFluid
    material_s: SaintVenantKirchhoffSolid
    riemann: rs.AcousticRiemannSolver
    no_riemann: rs.NoRiemannSolver
    rp: sd.ReferencePairs
    emitter: bd.AlignedBoxRegion
    disposer: bd.AlignedBoxRegion
    n_fluid: int                 # the fluid's rows (capacity)
    n_fish: int
    cell_cap: int
    k_inner: int
    k_contact: int
    dl_sponge: float

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = DX_REF, dtype=PRODUCTION_DTYPE, cell_cap: int = 24,
               k_inner: int = 40, k_contact: int = 24, reserve: float = 0.1,
               device="cuda"):
    """The channel's water less the fish (its capacity `reserve` above
    its particles, Alive on those), and the composite fish with its frozen
    pairs, B matrix and shape normals.  Returns (case, fluid, fish)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    dl_sponge = 20.0 * dx
    bw = 4.0 * dx
    origin = np.asarray([CX, CY])

    fish_shape = fish_mod.fish_polygon(dx * 0.5)
    pos_s, vol_s = generate_lattice(
        fish_shape, (-0.02, -0.05), (fish_mod.FISH_LENGTH + 0.02, 0.05), dx)
    pos_s = pos_s + origin

    water_shape = G.Box(
        G.Transform(translation=((DL - dl_sponge) / 2.0, DH / 2.0)),
        halfsize=((DL + dl_sponge) / 2.0, DH / 2.0))
    pos_all, vol = generate_lattice(water_shape, (-dl_sponge, 0.0), (DL, DH),
                                    dx)
    in_fish = fish_shape.contains(torch.as_tensor(pos_all - origin,
                                                  dtype=torch.float64))
    pos_f = pos_all[~in_fish.numpy()]

    n_f = len(pos_f)
    cap_f = int(n_f * (1.0 + reserve))
    fluid = make_fluid_state(pos_f, vol, RHO0_F, dtype, device,
                             capacity=cap_f)
    fluid["Alive"] = torch.arange(cap_f, device=device) < n_f
    fluid["ViscousForce"] = torch.zeros_like(fluid["Velocity"])
    fluid["ViscousForcePrev"] = torch.zeros_like(fluid["Velocity"])
    fluid["Indicator"] = torch.zeros(cap_f, dtype=torch.int32, device=device)
    fluid["PreviousSurfaceIndicator"] = torch.ones(cap_f, dtype=torch.int32,
                                                   device=device)
    fluid["PositionDivergence"] = torch.zeros(cap_f, dtype=dtype,
                                              device=device)
    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)

    stiff = fish_mod.stiffest_material()
    fish = sd.make_elastic_solid_state(pos_s, vol_s, stiff, dtype, device)
    fish.update(fish_mod.composite_fields(pos_s, (CX, CY), dtype, device))
    zeros = torch.zeros_like(fish["Position"])
    fish["AverageVelocity"] = zeros
    fish["AverageAcceleration"] = zeros
    fish["TemporaryPosition"] = fish["Position"]
    for key in ("ViscousForceFromFluid", "PressureForceFromFluid"):
        fish[key] = zeros
        fish["Previous" + key] = zeros

    grid = grid_from_bounds((-dl_sponge - bw, -bw), (DL + bw, DH + bw),
                            adaptation.cutoff)
    rp = fish_mod.frozen_pairs(fish, grid, adaptation, k_inner, cell_cap)
    fish["LinearGradientCorrectionMatrix"] = \
        sd.linear_gradient_correction_matrix(rp, fish["VolumetricMeasure"])
    # the normals of the fish shape (NormalDirectionFromBodyShape), probed
    # in the fish's own frame
    local = gd.normal_direction_from_shape(
        dict(fish, Position=fish["Position"]
             - torch.as_tensor([CX, CY], dtype=dtype, device=device)),
        fish_shape)
    fish["NormalDirection"] = local["NormalDirection"]
    fish["InitialNormalDirection"] = local["NormalDirection"]

    case = FishFSICase(
        dx=dx, adaptation=adaptation, grid=grid, eos=eos, material_s=stiff,
        riemann=rs.acoustic_riemann(eos), no_riemann=rs.no_riemann(eos),
        rp=rp,
        emitter=bd.AlignedBoxRegion(lower=(-dl_sponge, 0.0),
                                    upper=(-dl_sponge + bw, DH), axis=0),
        disposer=bd.AlignedBoxRegion(lower=(DL - bw, -bw),
                                     upper=(DL + bw, DH + bw), axis=0),
        n_fluid=cap_f, n_fish=len(pos_s), cell_cap=cell_cap,
        k_inner=k_inner, k_contact=k_contact, dl_sponge=dl_sponge)
    return case, fluid, fish


def rebuild_relations(case: FishFSICase, fluid: dict, fish: dict):
    """The two cell tables and the three lists (fluid inner over the live
    rows, fluid -> fish, fish -> fluid).  Returns (nl_ff, nl_fs, nl_sf,
    overflow)."""
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
    overflow = nl_ff.overflow | nl_fs.overflow | nl_sf.overflow
    return nl_ff, nl_fs, nl_sf, overflow


def init_sim(case: FishFSICase, fluid: dict, fish: dict) -> FishFSISim:
    nl_ff, nl_fs, nl_sf, ovf = rebuild_relations(case, fluid, fish)
    pos = fluid["Position"]
    return FishFSISim(fluid=dict(fluid), fish=dict(fish), nl_ff=nl_ff,
                      nl_fs=nl_fs, nl_sf=nl_sf,
                      time=torch.zeros((), dtype=pos.dtype,
                                       device=pos.device),
                      n_adv=0, n_ac=0, n_s=0, overflow=ovf)


def free_stream_target(pos, vel, t):
    """FreeStreamVelocity (2d_flow_stream_around_fish.h:90-107): u_ref = 0
    under a cosine ramp — the far field stays at rest."""
    u_ref = 0.0
    ramp = torch.where(t < T_REF,
                       0.5 * u_ref * (1.0 - torch.cos(math.pi * t / T_REF)),
                       torch.full_like(t, u_ref))
    return ramp.expand(pos.shape[:1])


def advection_prep(case: FishFSICase, s: FishFSISim):
    """The advection step's fluid prep against the fish, then the viscous
    force on the fish and its normals.  Returns (fluid, fish)."""
    kernel, h = case.kernel, case.adaptation.h
    fish = s.fish
    walls = [(fish, s.nl_fs)]
    fluid = fd.free_surface_indication(s.fluid, s.nl_ff, kernel, 2,
                                       contacts=[(fish, s.nl_fs, None)],
                                       spatial_temporal=True)
    fluid = fd.density_summation_freestream(
        fluid, s.nl_ff, kernel, 2, RHO0_F, case.adaptation.sigma0,
        contacts=[(fish, s.nl_fs, fish_mod.RHO0_S)])
    fluid = fd.viscous_force(fluid, s.nl_ff, kernel, 2, MU_F, h, walls=walls)
    fluid = fd.transport_velocity_correction(
        fluid, s.nl_ff, kernel, 2, h, coefficient=0.2, walls=walls,
        scope_mask=(fluid["Indicator"] == 0) & fluid["Alive"])
    fish = fsi.viscous_force_from_fluid(fish, fluid, s.nl_sf, kernel, 2,
                                        MU_F, h)
    return fluid, fsi.update_elastic_normal_direction(fish)


def solid_substep(case: FishFSICase, fish: dict, dt_s, t) -> dict:
    """One of the fish's own sub-steps: the active strain at t, then both
    halves of the total-Lagrangian step with the composite PK1."""
    h = case.adaptation.h
    fish = fish_mod.impose_active_strain(fish, t, origin=(CX, CY))
    fish = sd.integration_1st_half_pk2(fish, case.rp, case.material_s, dt_s,
                                       h, case.kernel.w0(2),
                                       pk1_fn=fish_mod._pk1)
    return sd.integration_2nd_half(fish, case.rp, dt_s)


def solid_substeps(case: FishFSICase, fish: dict, dt, t_now) -> tuple:
    """The fish's sub-steps over the acoustic dt from t_now, one host read
    each in the loop's test.  Returns (fish, count)."""
    c0s = case.material_s.sound_speed
    so = fsi.initialize_displacement(fish)
    ds_sum = torch.zeros_like(dt)
    k = 0
    while bool(ds_sum < dt):
        dt_s = torch.minimum(
            sd.solid_acoustic_time_step(so, c0s, case.adaptation.h),
            dt - ds_sum)
        so = solid_substep(case, so, dt_s, t_now + ds_sum)
        ds_sum = ds_sum + dt_s
        k += 1
    return fsi.update_average_velocity_acceleration(so, dt), k


def acoustic_substep(case: FishFSICase, s: FishFSISim, fluid: dict,
                     fish: dict, dt_adv, t_now):
    """One acoustic sub-step from t_now: the 1st half against the fish, the
    free-stream correction, the pressure force on the fish, the 2nd half
    (no Riemann dissipation), the fish's sub-steps.  Returns (fluid, fish,
    dt, solid sub-steps)."""
    kernel, h = case.kernel, case.adaptation.h
    dt = torch.minimum(fd.acoustic_time_step(fluid, case.eos, h), dt_adv)
    walls = [(fish, s.nl_fs)]
    fluid = fd.acoustic_step_1st_half(fluid, s.nl_ff, kernel, 2, case.eos,
                                      case.riemann, dt, walls=walls)
    fluid = fd.free_stream_velocity_correction(fluid, free_stream_target,
                                               t_now, RHO0_F)
    fish = fsi.pressure_force_from_fluid(fish, fluid, s.nl_sf, kernel, 2,
                                         case.riemann)
    fluid = fd.acoustic_step_2nd_half(fluid, s.nl_ff, kernel, 2,
                                      case.no_riemann, dt, walls=walls)
    fish, k = solid_substeps(case, fish, dt, t_now)
    return fluid, fish, dt, k


def open_boundaries(case: FishFSICase, fluid: dict, pos_prev) -> dict:
    """The disposer, then the emitter (crossing from `pos_prev`); the
    injection overflow flag left in the state."""
    fluid = bd.disposer_outflow_deletion(fluid, case.disposer)
    return bd.emitter_inflow_injection(fluid, case.emitter, prev_pos=pos_prev)


def _advection_step(case: FishFSICase, s: FishFSISim) -> FishFSISim:
    pos_prev = s.fluid["Position"]         # the emitter's crossing test
    dt_adv = fd.advection_viscous_time_step(s.fluid, case.adaptation.h, U_F,
                                            RHO0_F, MU_F)
    fluid, fish = advection_prep(case, s)
    relax_t = torch.zeros_like(dt_adv)
    n_ac = n_s = 0
    while bool(relax_t < dt_adv):          # one host read per sub-step
        fluid, fish, dt, k = acoustic_substep(case, s, fluid, fish, dt_adv,
                                              s.time + relax_t)
        relax_t = relax_t + dt
        n_ac += 1
        n_s += k
    fluid = open_boundaries(case, fluid, pos_prev)
    inj_ovf = fluid.pop("_InjectionOverflow")
    nl_ff, nl_fs, nl_sf, ovf = rebuild_relations(case, fluid, fish)
    return FishFSISim(fluid=fluid, fish=fish, nl_ff=nl_ff, nl_fs=nl_fs,
                      nl_sf=nl_sf, time=s.time + relax_t, n_adv=s.n_adv + 1,
                      n_ac=s.n_ac + n_ac, n_s=s.n_s + n_s,
                      overflow=s.overflow | ovf | inj_ovf)


def make_advection_step(case: FishFSICase):
    return lambda s: _advection_step(case, s)


def make_run_chunk(case: FishFSICase):
    """run_chunk(sim, t_target): advection steps until sim.time >=
    t_target."""
    return chunk_runner(lambda s: _advection_step(case, s))


def fish_center_of_mass(s: FishFSISim) -> np.ndarray:
    m = s.fish["Mass"].cpu().numpy()
    p = s.fish["Position"].cpu().numpy()
    return (m[:, None] * p).sum(0) / m.sum()
