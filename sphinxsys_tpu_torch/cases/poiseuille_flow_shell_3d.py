"""3D Poiseuille flow in a pipe walled by a rigid shell (counterpart of
sphinxsys_tpu/cases/poiseuille_flow_shell_3d.py; reference tests/
3d_examples/test_3d_poiseuille_flow_shell, its CI `10_particles`
configuration): a blood-like fluid (rho 1050, mu 3.6e-3, Re = 100) driven
through a D = 6.35 mm pipe of length 10 R by a parabolic inflow; the
pipe's wall is one layer of shell particles at half the fluid's
resolution (thickness dx / 4).  The fluid meets the shell as a wall
through the curvature-corrected dummy stacks (physics/shell_fluid.py),
rebuilt every advection step; the shell is rigid and static, its
curvatures taken once.  7,540 shell particles, the fluid's capacity 1.5x
its start.

Oracle (cpp:375-399): at t = 2 the axial velocity at the radial probes
(y = L / 2) is the parabola 2 U_f (1 - r^2 / R^2) within 10% of U_max.

    case, fluid = build_case(device="cpu", n_particles=6)
    sim = make_run_chunk(case)(init_sim(case, fluid), 0.01)
    print(sim.n_adv, sim.n_ac, n_alive(sim))
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.materials import WeaklyCompressibleFluid
from sphinxsys_tpu_torch.core.state import (State, make_fluid_state,
                                            make_solid_state)
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.io.observation import observe_quantity
from sphinxsys_tpu_torch.neighbors.cell_list import (CellGrid, CellTable,
                                                    build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list)
from sphinxsys_tpu_torch.physics import boundary as bd
from sphinxsys_tpu_torch.physics import fluid as fd
from sphinxsys_tpu_torch.physics import riemann as rs
from sphinxsys_tpu_torch.physics import shell as sh
from sphinxsys_tpu_torch.physics import shell_fluid as sf
from sphinxsys_tpu_torch.solver import chunk_runner

SCALE = 0.001
DIAMETER = 6.35 * SCALE
R_FLUID = 0.5 * DIAMETER
FULL_LENGTH = 10.0 * R_FLUID

RHO0_F = 1050.0
MU_F = 3.6e-3
RE = 100.0
U_F = RE * MU_F / RHO0_F / DIAMETER          # the mean velocity, 0.054
U_MAX = 2.0 * U_F                            # the parabola's peak
C_F = 10.0 * U_MAX
# the fields an inflow clone inherits
INJECTED = bd._PARTICLE_FIELDS_HINT + ("ViscousForce", "ViscousForcePrev",
                                       "Indicator", "PreviousSurfaceIndicator",
                                       "PositionDivergence")


@dataclasses.dataclass
class PipeSim:
    fluid: State
    nl_ff: NeighborList
    nl_fs: NeighborList      # fluid -> shell
    time: torch.Tensor
    n_adv: int
    n_ac: int
    overflow: torch.Tensor


@dataclasses.dataclass(frozen=True)
class PipeCase:
    dx: float
    res_shell: float
    adaptation: SPHAdaptation
    eos: WeaklyCompressibleFluid
    riemann: object
    no_riemann: object
    shell: State               # the rigid shell (static)
    shell_k1: torch.Tensor     # its principal curvatures, taken once
    shell_k2: torch.Tensor
    shell_table: CellTable
    grid: CellGrid
    emitter: bd.AlignedBoxRegion
    emitter_buffer: bd.AlignedBoxRegion
    disposer: bd.AlignedBoxRegion
    n_fluid: int               # the capacity
    n_shell: int
    k_ff: int
    k_fs: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def _shell_lattice(res_shell: float, wall_thickness: float):
    """The ShellBoundary generator (poiseuille_flow_shell.cpp:64-99): rings
    on the mid-surface radius R + res_shell / 2, axially from
    -wall_thickness to L + wall_thickness, outward radial normals."""
    r_mid = R_FLUID + 0.5 * res_shell
    n_circ = int(2.0 * r_mid * math.pi / res_shell)
    n_h = int((FULL_LENGTH + 2.0 * wall_thickness) / res_shell)
    theta = (np.arange(n_circ) + 0.5) * 2.0 * math.pi / n_circ
    y = (-wall_thickness + (FULL_LENGTH + 2.0 * wall_thickness)
         * np.arange(n_h) / n_h + 0.5 * res_shell)
    tt, yy = np.meshgrid(theta, y, indexing="ij")
    pos = np.stack([r_mid * np.cos(tt).ravel(), yy.ravel(),
                    r_mid * np.sin(tt).ravel()], axis=-1)
    nrm = np.stack([np.cos(tt).ravel(), np.zeros(pos.shape[0]),
                    np.sin(tt).ravel()], axis=-1)
    return pos, nrm


def build_case(n_particles: int = 10, dtype=PRODUCTION_DTYPE,
               reserve: float = 0.5, k_ff: int = 96, k_fs: int = 128,
               k_ss: int = 112, cap: int = 40, device="cuda"):
    """The fluid (a lattice fill of the pipe, capacity (1 + reserve) x its
    start, the indicator and viscous-force fields), the shell (area
    res_shell^2, thickness res_shell / 2, mass area thickness, outward
    normals) and its curvatures with the fluid's kernel reduced once, the
    inflow and outflow regions.  Returns (case, fluid)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    dx = DIAMETER / n_particles
    res_shell = 0.5 * dx
    shell_thickness = 0.5 * res_shell
    wall_thickness = 4.0 * dx
    inflow_length = 10.0 * dx
    adaptation = SPHAdaptation(spacing=dx, dim=3)
    kernel = adaptation.kernel

    xs = np.arange(-R_FLUID + dx / 2, R_FLUID, dx)
    ys = np.arange(dx / 2, FULL_LENGTH, dx)
    pos = np.stack(np.meshgrid(xs, ys, xs, indexing="ij"), -1).reshape(-1, 3)
    pos = pos[pos[:, 0] ** 2 + pos[:, 2] ** 2 < R_FLUID ** 2]
    cap_f = int(len(pos) * (1.0 + reserve))
    fluid = bd.ensure_alive_mask(make_fluid_state(pos, dx ** 3, RHO0_F, dtype,
                                                  device, capacity=cap_f))
    zi = torch.zeros(cap_f, dtype=torch.int32, device=device)
    fluid["Indicator"] = zi
    fluid["PreviousSurfaceIndicator"] = zi.clone()
    fluid["PositionDivergence"] = torch.zeros(cap_f, dtype=dtype,
                                              device=device)
    fluid["ViscousForce"] = torch.zeros((cap_f, 3), dtype=dtype, device=device)
    fluid["ViscousForcePrev"] = torch.zeros((cap_f, 3), dtype=dtype,
                                            device=device)

    spos, snrm = _shell_lattice(res_shell, wall_thickness)
    n_s = len(spos)
    shell = make_solid_state(spos, res_shell * res_shell, 1.0, dtype, device)
    shell["NormalDirection"] = torch.as_tensor(snrm, dtype=dtype,
                                               device=device)
    shell["Thickness"] = torch.full((n_s,), shell_thickness, dtype=dtype,
                                    device=device)
    # the mass consistent with the shell rho0 = 1 of the density summation
    shell["Mass"] = shell["VolumetricMeasure"] * shell["Thickness"]

    lo = (-R_FLUID - res_shell - 4 * dx, -wall_thickness - 4 * dx,
          -R_FLUID - res_shell - 4 * dx)
    hi = (R_FLUID + res_shell + 4 * dx, FULL_LENGTH + wall_thickness + 4 * dx,
          R_FLUID + res_shell + 4 * dx)
    grid = grid_from_bounds(lo, hi, kernel.cutoff)
    shell_table = build_cell_table(shell["Position"], n_s, grid, 2 * cap)
    nl_ss = build_neighbor_list(shell["Position"], n_s, shell["Position"],
                                n_s, shell_table, grid, kernel.cutoff,
                                k_max=k_ss, include_self=False)
    k1, k2 = sf.shell_curvature(shell, nl_ss, sh.ReducedKernel(kernel), 3)

    # the inflow and outflow regions along y (cpp:141-151)
    emitter = bd.AlignedBoxRegion(lower=(-R_FLUID, 0.0, -R_FLUID),
                                  upper=(R_FLUID, 4.0 * dx, R_FLUID), axis=1)
    emitter_buffer = bd.AlignedBoxRegion(
        lower=(-R_FLUID, -2.0 * dx, -R_FLUID),
        upper=(R_FLUID, inflow_length - 2.0 * dx, R_FLUID), axis=1)
    disposer = bd.AlignedBoxRegion(
        lower=(-1.1 * R_FLUID, FULL_LENGTH - 4.0 * dx, -1.1 * R_FLUID),
        upper=(1.1 * R_FLUID, FULL_LENGTH + 4.0 * dx, 1.1 * R_FLUID), axis=1)
    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    case = PipeCase(dx=dx, res_shell=res_shell, adaptation=adaptation,
                    eos=eos, riemann=rs.acoustic_riemann(eos),
                    no_riemann=rs.no_riemann(eos), shell=shell, shell_k1=k1,
                    shell_k2=k2, shell_table=shell_table, grid=grid,
                    emitter=emitter, emitter_buffer=emitter_buffer,
                    disposer=disposer, n_fluid=cap_f, n_shell=n_s,
                    k_ff=k_ff, k_fs=k_fs)
    return case, fluid


def rebuild_relations(case: PipeCase, fluid: State):
    """The fluid's inner list and its list to the shell, over the live
    rows, and their overflow flag."""
    pos, valid = fluid["Position"], fluid["Alive"]
    cutoff = case.kernel.cutoff
    table = build_cell_table(pos, valid, case.grid, case.n_fluid // 64)
    nl_ff = build_neighbor_list(pos, valid, pos, valid, table, case.grid,
                                cutoff, k_max=case.k_ff, include_self=False)
    nl_fs = build_neighbor_list(pos, valid, case.shell["Position"],
                                case.n_shell, case.shell_table, case.grid,
                                cutoff, k_max=case.k_fs, include_self=True)
    return nl_ff, nl_fs, nl_ff.overflow | nl_fs.overflow


def init_sim(case: PipeCase, fluid: State) -> PipeSim:
    nl_ff, nl_fs, ovf = rebuild_relations(case, fluid)
    return PipeSim(fluid=fluid, nl_ff=nl_ff, nl_fs=nl_fs,
                   time=fluid["Position"].new_zeros(()), n_adv=0, n_ac=0,
                   overflow=ovf)


def inflow_condition(fluid: State, region, relaxation: float = 1.0) -> State:
    """InflowVelocityCondition (cpp:103-124): the parabolic axial profile
    in the emitter's buffer."""
    pos, vel = fluid["Position"], fluid["Velocity"]
    r2 = (pos[:, 0] ** 2 + pos[:, 2] ** 2) / (R_FLUID * R_FLUID)
    target = torch.clamp(2.0 * U_F * (1.0 - r2), min=0.0)
    in_buf = region.contains(pos) & fluid["Alive"]
    vy = torch.where(in_buf, vel[:, 1] + relaxation * (target - vel[:, 1]),
                     vel[:, 1])
    return dict(fluid, Velocity=torch.stack([vel[:, 0], vy, vel[:, 2]],
                                            dim=-1))


def shell_pairs(case: PipeCase, s: PipeSim, fluid: State):
    """The advection step's frozen corrected pairs; the shell's normals
    already point fluid -> shell."""
    return sf.shell_contact_pairs(fluid["Position"], case.shell,
                                  case.shell_k1, case.shell_k2, s.nl_fs,
                                  case.kernel, 3, case.res_shell)


def advection_prep(case: PipeCase, s: PipeSim, pairs) -> State:
    """The surface indication, the free-stream density summation, the
    viscous force and the transport-velocity correction of the bulk."""
    kernel, dim, h = case.kernel, 3, case.adaptation.h
    sw = [(case.shell, s.nl_fs, pairs)]
    fluid = fd.free_surface_indication(s.fluid, s.nl_ff, kernel, dim,
                                       spatial_temporal=True, shell_walls=sw)
    fluid = fd.density_summation_freestream(
        fluid, s.nl_ff, kernel, dim, RHO0_F, case.adaptation.sigma0,
        shell_contacts=[(case.shell, s.nl_fs, pairs, 1.0)])
    fluid = fd.viscous_force(fluid, s.nl_ff, kernel, dim, MU_F, h,
                             shell_walls=sw)
    return fd.transport_velocity_correction(
        fluid, s.nl_ff, kernel, dim, h, shell_walls=sw,
        scope_mask=fluid["Indicator"] == 0)


def acoustic_substep(case: PipeCase, s: PipeSim, f: State, dt_adv, rt,
                     pairs):
    """Both halves against the shell and the inflow condition: (fluid, dt)."""
    kernel, dim, h = case.kernel, 3, case.adaptation.h
    sw = [(case.shell, s.nl_fs, pairs)]
    dt = torch.minimum(fd.acoustic_time_step(f, case.eos, h),
                       dt_adv - rt + 1e-12)
    f = fd.acoustic_step_1st_half(f, s.nl_ff, kernel, dim, case.eos,
                                  case.riemann, dt, shell_walls=sw)
    f = fd.acoustic_step_2nd_half(f, s.nl_ff, kernel, dim, case.no_riemann,
                                  dt, shell_walls=sw)
    return inflow_condition(f, case.emitter_buffer), dt


def _advection_step(case: PipeCase, s: PipeSim) -> PipeSim:
    pos_prev = s.fluid["Position"]
    pairs = shell_pairs(case, s, s.fluid)
    dt_adv = fd.advection_viscous_time_step(s.fluid, case.adaptation.h, U_MAX,
                                            RHO0_F, MU_F)
    fluid = advection_prep(case, s, pairs)
    relax_t = torch.zeros_like(dt_adv)
    n_ac = 0
    while bool(relax_t < dt_adv):          # one host read a sub-step
        fluid, dt = acoustic_substep(case, s, fluid, dt_adv, relax_t, pairs)
        relax_t = relax_t + dt
        n_ac += 1
    fluid = bd.emitter_inflow_injection(fluid, case.emitter, fields=INJECTED,
                                        prev_pos=pos_prev)
    inj_ovf = fluid.pop("_InjectionOverflow")
    fluid = bd.disposer_outflow_deletion(fluid, case.disposer)
    nl_ff, nl_fs, ovf = rebuild_relations(case, fluid)
    return PipeSim(fluid=fluid, nl_ff=nl_ff, nl_fs=nl_fs,
                   time=s.time + relax_t, n_adv=s.n_adv + 1,
                   n_ac=s.n_ac + n_ac, overflow=s.overflow | ovf | inj_ovf)


def make_advection_step(case: PipeCase):
    return lambda s: _advection_step(case, s)


def make_run_chunk(case: PipeCase):
    """run_chunk(sim, t_target): advection steps until sim.time >=
    t_target."""
    return chunk_runner(make_advection_step(case))


def radial_observation_points(n: int = 10):
    """createRadialObservationPoints (cpp:44-60): at y = L / 2, the points
    z = +- R i / (n + 1)."""
    y = 0.5 * FULL_LENGTH
    pts = []
    for i in range(n):
        z = R_FLUID * i / (n + 1)
        pts.append((0.0, y, z))
        pts.append((0.0, y, -z))
    return np.asarray(pts)


def axial_observation_points(n: int = 51):
    return np.asarray([(0.0, FULL_LENGTH * i / (n - 1), 0.0)
                       for i in range(n)])


def observed_velocity(case: PipeCase, s: PipeSim, obs_pos) -> torch.Tensor:
    """The Shepard-interpolated fluid velocity at the probes."""
    f = s.fluid
    obs = torch.as_tensor(np.asarray(obs_pos), dtype=f["Position"].dtype,
                          device=f["Position"].device)
    table = build_cell_table(f["Position"], f["Alive"], case.grid,
                             case.n_fluid // 64)
    nl = build_neighbor_list(obs, obs.shape[0], f["Position"], f["Alive"],
                             table, case.grid, case.kernel.cutoff,
                             k_max=case.k_ff, include_self=True)
    return observe_quantity(obs, f, "Velocity", nl, case.kernel, 3)


def analytic_profile(obs_pos):
    r2 = (obs_pos[:, 0] ** 2 + obs_pos[:, 2] ** 2) / (R_FLUID * R_FLUID)
    return 2.0 * U_F * (1.0 - r2)


def n_alive(s: PipeSim) -> int:
    return int(torch.sum(s.fluid["Alive"]))
