"""Multi-resolution free-stream flow around a cylinder at Re = 100
(counterpart of sphinxsys_tpu/cases/mr_cylinder_2d.py; reference tests/
2d_examples/test_2d_free_stream_around_cylinder_mr/): a 30 x 16 channel
with an inlet sponge, the free stream ramped to U = 1, a horizontal
refinement strip (y in [5, 11], 2x refined: the reference's
AdaptiveWithinShape level-1 region) holding the cylinder (r = 1 at
(10, 8)), and a rigid cylinder wall body at dx/4 spacing.  Every fluid op
runs with per-particle smoothing lengths (physics/fluid_adaptive.py) over
the multi-level neighbour search; the open boundaries recycle particles
emitter -> disposer as the fish case does, the clones carrying their MR
identity (size, mass, h).

The body-fitted start (`relax_ic`) relaxes the cylinder body, then the
fine fluid annulus against it (`_relax_near_cylinder`, deterministic
given the cylinder); the cylinder's jitter is the port's seeded
torch.Generator (physics/relax.py), so the parity tests carry the JAX
package's relaxed positions across (`relaxed=`).  The acoustic sub-steps
end on the summed time (one host read a sub-step); the chunk loop reads
the time once a step.

    case, fluid = build_case(dx=0.8, relax_ic=False, device="cpu")
    sim = make_run_chunk(case)(init_sim(case, fluid), 0.2)
    print(sim.n_adv, sim.n_ac, cylinder_forces(case, sim))
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sphinxsys_tpu_torch.core import geometry as G
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.kernels import WendlandC2
from sphinxsys_tpu_torch.core.materials import WeaklyCompressibleFluid
from sphinxsys_tpu_torch.core.state import make_fluid_state, make_solid_state
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.neighbors.cell_list import (CellGrid, CellTable,
                                                    build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.multilevel import (
    build_adaptive_neighbor_list, build_multilevel_tables)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list)
from sphinxsys_tpu_torch.physics import boundary as bd
from sphinxsys_tpu_torch.physics import fluid as fd
from sphinxsys_tpu_torch.physics import fluid_adaptive as fa
from sphinxsys_tpu_torch.physics import fsi
from sphinxsys_tpu_torch.physics import relax as rx
from sphinxsys_tpu_torch.physics import riemann as rs
from sphinxsys_tpu_torch.physics.pair import pair_geometry
from sphinxsys_tpu_torch.solver import chunk_runner

DL = 30.0
DH = 16.0
DX_REF = 0.4
DL_SPONGE = DX_REF * 20.0
BW = 4.0 * DX_REF
CX, CY = 10.0, 0.5 * DH
R_CYL = 1.0
STRIP_LO, STRIP_HI = 5.0, 11.0
# the lattices' cut planes sit midway between the last coarse row
# (4.6 / 11.4) and the first fine row (4.9 / 11.1): each side ends half its
# own spacing from the interface
CUT_LO, CUT_HI = 4.8, 11.2
RAMP_W = 2.0 * DX_REF           # the hr transition band at the strip edges
RHO0_F = 1.0
U_F = 1.0
C_F = 10.0 * U_F
RE = 100.0
MU_F = RHO0_F * U_F * (2.0 * R_CYL) / RE
T_REF = 2.0
# the relaxation of the fluid annulus: movers inside R_MOVE, a frozen
# lattice collar out to R_REGION
R_MOVE, R_REGION = 2.4, 3.1
# the fields an emitter clone inherits: the hint and the MR identity
CLONE_FIELDS = bd._PARTICLE_FIELDS_HINT + (
    "SmoothingLengthRatio", "ViscousForce", "ViscousForcePrev",
    "StartupForcePrev", "Indicator", "PreviousSurfaceIndicator",
    "PositionDivergence")


@dataclasses.dataclass
class MRCylSim:
    fluid: dict
    nl_ff: NeighborList
    nl_fw: NeighborList     # fluid -> cylinder
    nl_wf: NeighborList     # cylinder -> fluid (the fine kernel)
    time: torch.Tensor
    n_adv: int
    n_ac: int
    overflow: torch.Tensor


@dataclasses.dataclass(frozen=True)
class MRCylCase:
    dx: float
    adaptation: SPHAdaptation
    eos: WeaklyCompressibleFluid
    riemann: rs.AcousticRiemannSolver
    no_riemann: rs.NoRiemannSolver
    cylinder: dict
    wall_table: CellTable
    emitter: bd.AlignedBoxRegion
    emitter_buffer: bd.AlignedBoxRegion
    disposer: bd.AlignedBoxRegion
    n_fluid: int         # the capacity
    n_cyl: int
    refine: bool
    cap: int
    k_levels: tuple
    k_wall: tuple
    k_wf: int
    grid_fine: CellGrid  # the fine-cutoff grid of the cylinder lists

    @property
    def kernel(self):
        return self.adaptation.kernel

    @property
    def kernel_fine(self):
        # every cylinder-contact pair involves strip (hr = 2) fluid
        return WendlandC2(h=self.adaptation.h / (2.0 if self.refine else 1.0))

    @property
    def bounds(self):
        return ((-DL_SPONGE - BW, -BW), (DL + BW, DH + BW))


def _strip_hr(pos):
    """The smoothing-length ratio field: 2 deep inside the strip, ramping
    to 1 at its edges (a sharp 2x h jump starves the interface's
    kernels)."""
    d_edge = np.minimum(pos[:, 1] - CUT_LO, CUT_HI - pos[:, 1])
    return 1.0 + np.clip(d_edge / RAMP_W, 0.0, 1.0)


def relax_cylinder_body(pos_w, dx, n_iter: int = 600, device="cuda"):
    """The cylinder body's level-set-corrected relaxation
    (RelaxationStepLevelSetCorrectionInner) at dx/4, float64 on
    `device`; host positions in and out."""
    device = resolve_device(device)
    dxw = dx / 4.0
    ad_w = SPHAdaptation(spacing=dxw, dim=2)
    grid_w = grid_from_bounds((CX - R_CYL - 4 * dxw, CY - R_CYL - 4 * dxw),
                              (CX + R_CYL + 4 * dxw, CY + R_CYL + 4 * dxw),
                              ad_w.cutoff)
    ball = G.Ball(center=(CX, CY), radius=R_CYL)
    p = rx.relax_shape(ball, torch.as_tensor(pos_w, dtype=torch.float64,
                                             device=device),
                       dxw * dxw, ad_w, grid_w, n_iterations=n_iter,
                       cell_cap=24, k_max=48)
    return p.cpu().numpy()


def relax_annulus(pos_f, pos_w_rel, dx, n_iter: int = 500, device="cuda"):
    """The fine fluid annulus (hr = 2) relaxed against the relaxed cylinder
    (RelaxationStepLevelSetCorrectionComplex: the inner residual and the
    contact residual -2 dW V e), the lattice collar R_MOVE <= r < R_REGION
    frozen, every particle bounded outside the cylinder; float64 on
    `device`, a fixed number of iterations with no host read.  Returns the
    whole fine lattice with the region replaced."""
    device = resolve_device(device)
    dxf = dx / 2.0
    dxw = dx / 4.0
    ad_f = SPHAdaptation(spacing=dxf, dim=2)
    kernel = ad_f.kernel
    r = np.hypot(pos_f[:, 0] - CX, pos_f[:, 1] - CY)
    region = r < R_REGION
    f64 = dict(dtype=torch.float64, device=device)
    frozen = torch.as_tensor(r[region] >= R_MOVE, device=device)
    p = torch.as_tensor(pos_f[region], **f64)
    n = p.shape[0]
    vol_f = torch.full((n,), dxf * dxf, **f64)
    grid_f = grid_from_bounds(
        (CX - R_REGION - 4 * dxf, CY - R_REGION - 4 * dxf),
        (CX + R_REGION + 4 * dxf, CY + R_REGION + 4 * dxf), ad_f.cutoff)
    cylp = torch.as_tensor(np.array(pos_w_rel), **f64)
    ncyl = cylp.shape[0]
    table_c = build_cell_table(cylp, ncyl, grid_f, cap=48)
    outside = G.InverseShape(G.Ball(center=(CX, CY), radius=R_CYL))
    for _ in range(n_iter):
        table = build_cell_table(p, n, grid_f, cap=24)
        nl = build_neighbor_list(p, n, p, n, table, grid_f, ad_f.cutoff,
                                 k_max=48, include_self=False)
        res = rx.relaxation_residual(p, vol_f, nl, kernel, 2)
        nlc = build_neighbor_list(p, n, cylp, ncyl, table_c, grid_f,
                                  ad_f.cutoff, k_max=40, include_self=True)
        pgc = pair_geometry(p, cylp, nlc, kernel, 2, need_W=False)
        res = res - torch.sum((2.0 * pgc.dW * (dxw * dxw))[..., None]
                              * pgc.e, dim=1)
        res = torch.where(frozen[:, None], torch.zeros_like(res), res)
        p = p + 0.5 * res * rx.relaxation_scaling(res, ad_f.h)
        p = rx.surface_bounding(p, outside, dxf)
    out = pos_f.copy()
    out[region] = p.cpu().numpy()
    return out


def _relax_near_cylinder(pos_f, pos_w, dx, n_iter_cyl: int = 600,
                         n_iter_f: int = 500, device="cuda"):
    """The body-fitted start (the reference's --relax branch,
    mr_free_stream_around_cylinder.cpp:68-113): the cylinder body, then
    the fine fluid annulus against it.  Returns (pos_f, pos_w)."""
    pos_w_rel = relax_cylinder_body(pos_w, dx, n_iter_cyl, device)
    return relax_annulus(pos_f, pos_w_rel, dx, n_iter_f, device), pos_w_rel


def lattices(dx: float, refine: bool = True):
    """The coarse lattice outside the strip, the fine (dx/2) one inside it,
    the cylinder cut out of both, and the cylinder's dx/4 lattice strictly
    inside the circle: (pos_c, pos_f, pos_w)."""
    def in_strip(p):
        if not refine:
            return np.zeros(len(p), bool)
        return (p[:, 1] > CUT_LO) & (p[:, 1] < CUT_HI)

    def in_cyl(p, margin=0.0):
        return np.hypot(p[:, 0] - CX, p[:, 1] - CY) < R_CYL + margin

    xs_c = np.arange(-DL_SPONGE + dx / 2, DL, dx)
    ys_c = np.arange(dx / 2, DH, dx)
    pos_c = np.stack(np.meshgrid(xs_c, ys_c, indexing="ij"), -1).reshape(-1, 2)
    pos_c = pos_c[~in_strip(pos_c) & ~in_cyl(pos_c, margin=0.5 * dx)]
    xs_f = np.arange(-DL_SPONGE + dx / 4, DL, dx / 2)
    ys_f = np.arange(dx / 4, DH, dx / 2)
    pos_f = np.stack(np.meshgrid(xs_f, ys_f, indexing="ij"), -1).reshape(-1, 2)
    pos_f = pos_f[in_strip(pos_f) & ~in_cyl(pos_f, margin=0.5 * dx / 2)]
    dxw = dx / 4.0
    xs_w = np.arange(CX - R_CYL, CX + R_CYL + dxw, dxw)
    pos_w = np.stack(np.meshgrid(xs_w, xs_w - (CX - CY), indexing="ij"),
                     -1).reshape(-1, 2)
    pos_w = pos_w[in_cyl(pos_w, margin=-0.5 * dxw)]
    return pos_c, pos_f, pos_w


def build_case(dx: float = DX_REF, dtype=PRODUCTION_DTYPE,
               reserve: float = 0.3, cap: int = 64, k_levels=(96, 128),
               k_wall=(56,), k_wf: int = 48, refine: bool = True,
               relax_ic: bool = True, relaxed=None, device="cuda"):
    """`refine=False` is the uniform-resolution control (hr = 1
    everywhere).  `relax_ic` runs `_relax_near_cylinder` (float64, on
    `device`); `relaxed=(pos_f, pos_w)` takes relaxed fine-fluid and
    cylinder positions instead.  Returns (case, fluid)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    pos_c, pos_f, pos_w = lattices(dx, refine)
    if relaxed is not None:
        pos_f, pos_w = (np.asarray(a, np.float64) for a in relaxed)
    elif relax_ic and refine:
        pos_f, pos_w = _relax_near_cylinder(pos_f, pos_w, dx, device=device)

    pos = np.concatenate([pos_c, pos_f])
    vols = np.concatenate([np.full(len(pos_c), dx * dx),
                           np.full(len(pos_f), (dx / 2) ** 2)])
    hr = np.ones(len(pos))
    hr[len(pos_c):] = _strip_hr(pos_f)

    n_f = len(pos)
    cap_f = int(n_f * (1.0 + reserve))
    fluid = make_fluid_state(pos, dx * dx, RHO0_F, dtype, device,
                             capacity=cap_f)
    volp = np.concatenate([vols, np.full(cap_f - n_f, (dx / 2) ** 2)])
    hrp = np.concatenate([hr, np.full(cap_f - n_f, 1.0)])

    def t(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=device)

    fluid["VolumetricMeasure"] = t(volp)
    fluid["Mass"] = t(RHO0_F * volp)
    fluid["SmoothingLengthRatio"] = t(hrp)
    fluid["Alive"] = torch.arange(cap_f, device=device) < n_f
    zeros_v = torch.zeros((cap_f, 2), dtype=dtype, device=device)
    for k in ("ViscousForce", "ViscousForcePrev", "ForcePrior",
              "StartupForcePrev"):
        # the startup force is folded into ForcePrior by its change
        # (StartupForcePrev), the viscous force likewise
        fluid[k] = zeros_v.clone()
    fluid["Indicator"] = torch.zeros(cap_f, dtype=torch.int32, device=device)
    fluid["PreviousSurfaceIndicator"] = torch.ones(cap_f, dtype=torch.int32,
                                                   device=device)
    fluid["PositionDivergence"] = torch.zeros(cap_f, dtype=dtype,
                                              device=device)

    # the cylinder at dx/4; its table level is the fine fluid's (the pair
    # h is the fluid's)
    dxw = dx / 4.0
    nw = len(pos_w)
    cyl = make_solid_state(pos_w, dxw * dxw, RHO0_F, dtype, device)
    rvec = pos_w - np.asarray([CX, CY])
    rn = np.linalg.norm(rvec, axis=1, keepdims=True)
    cyl["NormalDirection"] = t(rvec / np.maximum(rn, 1e-12))
    cyl["SmoothingLengthRatio"] = torch.full((nw,), 2.0 if refine else 1.0,
                                             dtype=dtype, device=device)
    for k in ("AverageVelocity", "AverageAcceleration", "Force",
              "ForcePrior", "ViscousForceFromFluid", "PressureForceFromFluid",
              "PreviousViscousForceFromFluid",
              "PreviousPressureForceFromFluid"):
        cyl[k] = torch.zeros((nw, 2), dtype=dtype, device=device)

    lo, hi = (-DL_SPONGE - BW, -BW), (DL + BW, DH + BW)
    # every fluid-cylinder pair is fine-level (the cylinder sits deep in
    # the strip): the contact lists run on a plain fine grid
    cut_wall = adaptation.cutoff / (2.0 if refine else 1.0)
    grid_fine = grid_from_bounds(lo, hi, cut_wall)
    wall_table = build_cell_table(cyl["Position"], nw, grid_fine, cap=4 * cap)

    emitter = bd.AlignedBoxRegion(lower=(-DL_SPONGE, 0.0),
                                  upper=(-DL_SPONGE + BW, DH), axis=0)
    emitter_buffer = bd.AlignedBoxRegion(lower=(-DL_SPONGE, 0.0),
                                         upper=(0.0, DH), axis=0)
    # deletion only past the outlet plane x = DL (DisposerOutflowDeletion's
    # checkUpperBound, fluid_boundary.cpp:98-106)
    disposer = bd.AlignedBoxRegion(lower=(DL, -BW),
                                   upper=(DL + 2 * BW, DH + BW), axis=0)

    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    case = MRCylCase(dx=dx, adaptation=adaptation, eos=eos,
                     riemann=rs.acoustic_riemann(eos),
                     no_riemann=rs.no_riemann(eos), cylinder=cyl,
                     wall_table=wall_table, emitter=emitter,
                     emitter_buffer=emitter_buffer, disposer=disposer,
                     n_fluid=cap_f, n_cyl=nw, refine=refine, cap=cap,
                     k_levels=tuple(k_levels), k_wall=tuple(k_wall),
                     k_wf=k_wf, grid_fine=grid_fine)
    return case, fluid


def rebuild_relations(case: MRCylCase, fluid: dict):
    """The adaptive fluid list and the two cylinder lists at the fine
    cutoff, over the live rows: (nl_ff, nl_fw, nl_wf, overflow)."""
    lo, hi = case.bounds
    h_ref = case.adaptation.h
    pos = fluid["Position"]
    hr = fluid["SmoothingLengthRatio"]
    valid = fluid["Alive"]
    cyl_pos = case.cylinder["Position"]
    ml = build_multilevel_tables(pos, valid, hr, lo, hi, h_ref, n_levels=2,
                                 cap=case.cap)
    nl_ff = build_adaptive_neighbor_list(pos, valid, hr, pos, hr, ml, 2.0,
                                         h_ref,
                                         k_max_per_level=list(case.k_levels))
    cut_wall = case.adaptation.cutoff / (2.0 if case.refine else 1.0)
    nl_fw = build_neighbor_list(pos, valid, cyl_pos, case.n_cyl,
                                case.wall_table, case.grid_fine, cut_wall,
                                k_max=case.k_wall[0], include_self=True)
    table_f = build_cell_table(pos, valid, case.grid_fine, cap=case.cap)
    nl_wf = build_neighbor_list(cyl_pos, case.n_cyl, pos, valid, table_f,
                                case.grid_fine, cut_wall, k_max=case.k_wf,
                                include_self=True)
    return nl_ff, nl_fw, nl_wf, nl_ff.overflow | nl_fw.overflow \
        | nl_wf.overflow


def init_sim(case: MRCylCase, fluid: dict) -> MRCylSim:
    nl_ff, nl_fw, nl_wf, ovf = rebuild_relations(case, fluid)
    pos = fluid["Position"]
    return MRCylSim(fluid=dict(fluid), nl_ff=nl_ff, nl_fw=nl_fw, nl_wf=nl_wf,
                    time=torch.zeros((), dtype=pos.dtype, device=pos.device),
                    n_adv=0, n_ac=0, overflow=ovf)


def free_stream_target(pos, vel, t):
    """FreeStreamVelocity (mr_free_stream_around_cylinder.h:74-89): the
    ramp 0.5 U (1 - cos(pi t / T)) to U at T."""
    ramp = torch.where(t < T_REF,
                       0.5 * U_F * (1.0 - torch.cos(math.pi * t / T_REF)),
                       U_F)
    return ramp.expand(pos.shape[:1])


def _startup_force(fluid: dict, t) -> dict:
    """StartupAcceleration (external_force.h:59-73): a(t) = 0.5 pi
    sin(pi t / T) U / T for t < T, 0 after, folded into ForcePrior by its
    change since the last step (the BaseForcePrior delta convention: an
    overwrite would clobber the viscous force folded there)."""
    a = torch.where(t < T_REF,
                    0.5 * math.pi * torch.sin(math.pi * t / T_REF)
                    * (U_F / T_REF), 0.0)
    force = torch.stack([a * fluid["Mass"], torch.zeros_like(fluid["Mass"])],
                        dim=-1)
    force = torch.where(fluid["Alive"][:, None], force,
                        torch.zeros_like(force))
    out = dict(fluid)
    out["ForcePrior"] = fluid["ForcePrior"] + force - fluid["StartupForcePrev"]
    out["StartupForcePrev"] = force
    return out


def _inflow_condition(fluid: dict, region, t, relaxation: float = 0.1):
    """InflowVelocityCondition in the sponge: vx relaxed toward the ramp."""
    pos, vel = fluid["Position"], fluid["Velocity"]
    target = free_stream_target(pos, vel, t)
    in_buf = region.contains(pos) & fluid["Alive"]
    vx = torch.where(in_buf, vel[:, 0] + relaxation * (target - vel[:, 0]),
                     vel[:, 0])
    return dict(fluid, Velocity=torch.stack([vx, vel[:, 1]], dim=-1))


def advection_prep(case: MRCylCase, s: MRCylSim):
    """The startup force, the advection time step, the surface indication,
    the free-stream density, the viscous force and the transport
    correction: (dt_adv, fluid)."""
    kernel, h_ref = case.kernel, case.adaptation.h
    h_fine = h_ref / (2.0 if case.refine else 1.0)
    cyl = case.cylinder
    walls = [(cyl, s.nl_fw)]
    fluid = _startup_force(s.fluid, s.time)
    dt_adv = fd.advection_viscous_time_step(fluid, h_fine, U_F, RHO0_F, MU_F)
    fluid = fa.free_surface_indication_adaptive(fluid, s.nl_ff, kernel, 2,
                                                walls=walls,
                                                spatial_temporal=True)
    fluid = fa.density_summation_freestream_adaptive(
        fluid, s.nl_ff, kernel, 2, RHO0_F, wall=cyl, nl_wall=s.nl_fw)
    fluid = fa.viscous_force_adaptive(fluid, s.nl_ff, kernel, 2, MU_F, h_ref,
                                      wall=cyl, nl_wall=s.nl_fw)
    fluid = fa.transport_velocity_correction_adaptive(
        fluid, s.nl_ff, kernel, 2, h_ref, walls=walls,
        scope_mask=(fluid["Indicator"] == 0) & fluid["Alive"])
    return dt_adv, fluid


def acoustic_substep(case: MRCylCase, s: MRCylSim, f: dict, dt_adv, t):
    """One acoustic sub-step at time t (the step's start plus the
    sub-steps so far): (fluid, dt)."""
    kernel, cyl = case.kernel, case.cylinder
    h_fine = case.adaptation.h / (2.0 if case.refine else 1.0)
    dt = torch.minimum(fd.acoustic_time_step(f, case.eos, h_fine), dt_adv)
    f = fa.acoustic_step_1st_half_adaptive(f, s.nl_ff, kernel, 2, case.eos,
                                           case.riemann, dt, wall=cyl,
                                           nl_wall=s.nl_fw)
    f = fd.free_stream_velocity_correction(f, free_stream_target, t, RHO0_F)
    f = _inflow_condition(f, case.emitter_buffer, t)
    f = fa.acoustic_step_2nd_half_adaptive(f, s.nl_ff, kernel, 2,
                                           case.no_riemann, dt, wall=cyl,
                                           nl_wall=s.nl_fw)
    return f, dt


def open_boundaries(case: MRCylCase, fluid: dict, pos_prev):
    """The disposer, then the emitter (its clones carry CLONE_FIELDS):
    (fluid, injection overflow)."""
    fluid = bd.disposer_outflow_deletion(fluid, case.disposer)
    fluid = bd.emitter_inflow_injection(fluid, case.emitter,
                                        fields=CLONE_FIELDS,
                                        prev_pos=pos_prev)
    inj = fluid.pop("_InjectionOverflow")
    return fluid, inj


def _advection_step(case: MRCylCase, s: MRCylSim) -> MRCylSim:
    pos_prev = s.fluid["Position"]
    dt_adv, fluid = advection_prep(case, s)
    relax_t = torch.zeros_like(dt_adv)
    n_ac = 0
    while bool(relax_t < dt_adv):          # one host read per sub-step
        fluid, dt = acoustic_substep(case, s, fluid, dt_adv, s.time + relax_t)
        relax_t = relax_t + dt
        n_ac += 1
    fluid, inj = open_boundaries(case, fluid, pos_prev)
    nl_ff, nl_fw, nl_wf, ovf = rebuild_relations(case, fluid)
    return MRCylSim(fluid=fluid, nl_ff=nl_ff, nl_fw=nl_fw, nl_wf=nl_wf,
                    time=s.time + relax_t, n_adv=s.n_adv + 1,
                    n_ac=s.n_ac + n_ac, overflow=s.overflow | ovf | inj)


def make_advection_step(case: MRCylCase):
    return lambda s: _advection_step(case, s)


def make_run_chunk(case: MRCylCase):
    """run_chunk(sim, t_target): steps until sim.time >= t_target."""
    return chunk_runner(make_advection_step(case))


def cylinder_forces(case: MRCylCase, s: MRCylSim):
    """The total (viscous, pressure) force of the fluid on the cylinder
    through the fine contact kernel (the Cylinder_TotalViscousForceFromFluid
    and PressureForceFromFluid observers): two (2,) tensors."""
    kf = case.kernel_fine
    cyl = fsi.viscous_force_from_fluid(case.cylinder, s.fluid, s.nl_wf, kf,
                                       2, MU_F, kf.h)
    cyl = fsi.pressure_force_from_fluid(cyl, s.fluid, s.nl_wf, kf, 2,
                                        case.riemann)
    return (torch.sum(cyl["ViscousForceFromFluid"], dim=0),
            torch.sum(cyl["PressureForceFromFluid"], dim=0))


def n_alive(s: MRCylSim) -> int:
    return int(s.fluid["Alive"].sum())
