"""A hydrostatic water column on an elastic shell gate (counterpart of
sphinxsys_tpu/cases/hydrostatic_fsi_2d.py; reference tests/2d_examples/
test_2d_hydrostatic_fluid_shell, its dp_2 CI configuration): a 1 x 2 m
water column rests on a clamped elastic shell gate across the tank's
floor; the side walls are rigid one-layer shells.  The walls and the gate
meet the fluid through the curvature-corrected dummy stacks
(physics/shell_fluid.py), rebuilt every advection step; the gate feels
the fluid through PressureForceFromFluid on the fluid -> shell pairs and
sub-cycles its own stress relaxation inside each acoustic sub-step.  The
fluid is damped pairwise against itself, the gate and the walls
(DampingPairwiseWithWall): the first caller of
dissipation.damping_pairwise_wall.

Oracle: the clamped-clamped plate's mid-span deflection under the
uniform pressure rho g H, w = p L^4 / (384 E I), I = t^3 / 12 (the
reference asserts 15%).  At dx = 0.025: 3,200 fluid particles, 168 wall
and 48 gate particles.

    case, fluid, gate = build_case(device="cpu")
    sim = make_run_chunk(case)(init_sim(case, fluid, gate), 1e-3)
    print(sim.n_adv, sim.n_ac, center_displacement(case, sim))
"""

from __future__ import annotations

import dataclasses
import math
import types

import numpy as np
import torch

from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.materials import (SaintVenantKirchhoffSolid,
                                                WeaklyCompressibleFluid)
from sphinxsys_tpu_torch.core.state import State, make_fluid_state
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.neighbors.cell_list import (CellGrid, CellTable,
                                                    build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list)
from sphinxsys_tpu_torch.physics import dissipation as dp
from sphinxsys_tpu_torch.physics import fluid as fd
from sphinxsys_tpu_torch.physics import fsi
from sphinxsys_tpu_torch.physics import general as gd
from sphinxsys_tpu_torch.physics import riemann as rs
from sphinxsys_tpu_torch.physics import shell as sh
from sphinxsys_tpu_torch.physics import shell_fluid as sf
from sphinxsys_tpu_torch.physics import solid as sd
from sphinxsys_tpu_torch.solver import chunk_runner

DL = 1.0          # the tank's length
DH = 2.1          # the tank's height
DAM_H = 2.0       # the water's height
GATE_T = 0.05     # the gate's thickness
RHO0_F = 1000.0
GRAVITY_G = 9.81
U_REF = 2.0 * math.sqrt(DAM_H * GRAVITY_G)
C_F = 10.0 * U_REF
RHO0_S = 2700.0
POISSON = 0.495
YOUNGS = 6.75e10

# the clamped-clamped plate's mid-span deflection
ANALYTIC_DISP = (RHO0_F * GRAVITY_G * DAM_H * DL ** 4
                 / 384.0 / YOUNGS / (GATE_T ** 3 / 12.0))


@dataclasses.dataclass
class HFSISim:
    fluid: State
    gate: State
    nl_ff: NeighborList
    nl_fw: NeighborList     # fluid -> the rigid side walls (shells)
    nl_fg: NeighborList     # fluid -> the gate
    nl_gf: NeighborList     # the gate -> fluid
    time: torch.Tensor
    n_adv: int
    n_ac: int
    overflow: torch.Tensor
    n_s: int = 0            # the gate's sub-steps


class GateSubcycle:
    """The gate's sub-step, its dt included, as one CUDA graph a replay:
    an acoustic sub-step holds ~330 gate sub-steps of ~620 small launches
    each, and the host's launches, not the card, set their pace.  The
    state lives in the graph's static buffers for the whole sub-cycle
    (copied in once, out once); each replay ends by copying its result
    into them and leaves `ds_sum < dt` on the card, read once a sub-step
    as the host loop reads it.  One graph per dtype, device and field
    set, captured at first use."""

    def __init__(self):
        self._graphs = {}

    def _capture(self, case: HFSICase, g: State, dt):
        static = {k: v.clone() for k, v in g.items() if torch.is_tensor(v)}
        rest = {k: v for k, v in g.items() if not torch.is_tensor(v)}
        ds_sum, static_dt = torch.zeros_like(dt), dt.clone()

        def body():
            out, new_sum = _timed_substep(case, {**rest, **static}, ds_sum,
                                          static_dt)
            assert set(out) == set(static) | set(rest)
            for k, v in static.items():
                v.copy_(out[k])
            ds_sum.copy_(new_sum)
            return ds_sum < static_dt

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):       # warm-up off the capture
            body()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            go_on = body()
        return graph, static, rest, ds_sum, static_dt, go_on

    def run(self, case: HFSICase, g: State, dt):
        """The sub-cycle over dt from g: (gate, the sub-step count)."""
        key = (g["Position"].dtype, g["Position"].device, tuple(sorted(g)))
        if key not in self._graphs:
            self._graphs[key] = self._capture(case, g, dt)
        graph, static, rest, ds_sum, static_dt, go_on = self._graphs[key]
        for k, v in static.items():
            v.copy_(g[k])
        ds_sum.zero_()
        static_dt.copy_(dt)
        k = 0
        while bool(ds_sum < dt) if k == 0 else bool(go_on):
            graph.replay()
            k += 1
        return {**rest, **{k_: v.clone() for k_, v in static.items()}}, k


@dataclasses.dataclass(frozen=True)
class HFSICase:
    dx: float
    adaptation: SPHAdaptation
    grid: CellGrid
    eos: WeaklyCompressibleFluid
    riemann: object
    no_riemann: object
    gravity: gd.Gravity
    material_s: SaintVenantKirchhoffSolid
    wall: State               # the rigid side walls (a static shell state)
    wall_table: CellTable
    gate_rp: sd.ReferencePairs   # the gate's frozen pairs (reduced kernel)
    nl_gg: NeighborList       # the gate's inner list (its curvature)
    clamp_mask: torch.Tensor
    mu_f: float
    eta_gate: float
    n_fluid: int
    n_gate: int
    n_wall: int
    cell_cap: int
    k_inner: int
    k_shell: int
    k_gf: int
    center_idx: int           # the gate particle nearest mid-span
    # not an init field: each case, `dataclasses.replace`'s too, captures
    # its own graphs against its own tensors
    subcycle: GateSubcycle = dataclasses.field(
        init=False, default_factory=GateSubcycle, compare=False)

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = 0.025, dtype=PRODUCTION_DTYPE, cell_cap: int = 24,
               k_inner: int = 32, k_shell: int = 16, k_gf: int = 40,
               device="cuda"):
    """The water column, the side walls (x = -dx/2 and DL + dx/2, inward
    normals), the gate (one line under the column, 4 dx past each side),
    the gate's frozen pairs and B, the clamp |x - DL/2| > DL/2.  Returns
    (case, fluid, gate)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    BW = 4 * dx
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    kernel = adaptation.kernel

    xs = np.arange(dx / 2, DL, dx)
    ys = np.arange(dx / 2, DAM_H, dx)
    pos_f = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    fluid = make_fluid_state(pos_f, dx * dx, RHO0_F, dtype, device)

    yw = np.arange(dx / 2, DH, dx)
    pos_w = np.concatenate([
        np.stack([np.full_like(yw, -0.5 * dx), yw], -1),
        np.stack([np.full_like(yw, DL + 0.5 * dx), yw], -1)])
    n_w = np.concatenate([np.tile([1.0, 0.0], (len(yw), 1)),
                          np.tile([-1.0, 0.0], (len(yw), 1))])
    wall = sh.make_shell_state(pos_w, n_w, dx, dx,
                               types.SimpleNamespace(rho0=1.0), dtype, device)
    wall["AverageVelocity"] = torch.zeros_like(wall["Velocity"])
    wall["AverageAcceleration"] = torch.zeros_like(wall["Velocity"])

    xg = np.arange(-BW + dx / 2, DL + BW, dx)
    pos_g = np.stack([xg, np.full_like(xg, -0.5 * dx)], -1)
    n_g = np.tile([0.0, 1.0], (len(xg), 1))
    material_s = SaintVenantKirchhoffSolid(rho0=RHO0_S, youngs_modulus=YOUNGS,
                                           poisson_ratio=POISSON)
    gate = sh.make_shell_state(pos_g, n_g, dx, GATE_T, material_s, dtype,
                               device)
    zeros = torch.zeros_like(gate["Velocity"])
    gate["AverageVelocity"] = zeros
    gate["AverageAcceleration"] = zeros
    gate["TemporaryPosition"] = gate["Position"]
    gate["PressureForceFromFluid"] = zeros
    gate["PreviousPressureForceFromFluid"] = zeros

    grid = grid_from_bounds((-BW - dx, -GATE_T - dx), (DL + BW + dx, DH),
                            adaptation.cutoff)
    n_gate = len(xg)
    wall_table = build_cell_table(wall["Position"], len(pos_w), grid,
                                  cell_cap)
    # the gate's stress relaxation runs on the reduced kernel; its
    # curvature on the same pairs with the fluid's kernel, reduced once
    gate_table = build_cell_table(gate["Position"], n_gate, grid, cell_cap)
    nl_gg = build_neighbor_list(gate["Position"], n_gate, gate["Position"],
                                n_gate, gate_table, grid, adaptation.cutoff,
                                k_max=k_shell, include_self=False)
    gate_rp = sd.freeze_reference_pairs(gate["Position"], nl_gg,
                                        sh.ReducedKernel(kernel), 2)
    gate = sh.shell_correct_configuration(gate, gate_rp)

    gravity = gd.Gravity(acceleration=(0.0, -GRAVITY_G))
    fluid = gd.gravity_force(fluid, gravity)
    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    case = HFSICase(
        dx=dx, adaptation=adaptation, grid=grid, eos=eos,
        riemann=rs.acoustic_riemann(eos), no_riemann=rs.no_riemann(eos),
        gravity=gravity, material_s=material_s, wall=wall,
        wall_table=wall_table, gate_rp=gate_rp, nl_gg=nl_gg,
        clamp_mask=torch.as_tensor((xg < 0.0) | (xg > DL), device=device),
        mu_f=RHO0_F * U_REF * DL / 0.1,            # Re = 0.1 (quasi-static)
        eta_gate=0.4 / 4.0 * math.sqrt(RHO0_S * YOUNGS) * GATE_T * GATE_T,
        n_fluid=len(pos_f), n_gate=n_gate, n_wall=len(pos_w),
        cell_cap=cell_cap, k_inner=k_inner, k_shell=k_shell, k_gf=k_gf,
        center_idx=int(np.argmin(np.abs(xg - 0.5 * DL))))
    return case, fluid, gate


def rebuild_relations(case: HFSICase, fluid: State, gate: State):
    """The four lists (fluid inner, fluid -> walls, fluid -> gate, gate ->
    fluid) and their overflow flag."""
    pos, n = fluid["Position"], fluid["NReal"]
    cutoff = case.adaptation.cutoff
    table = build_cell_table(pos, n, case.grid, case.cell_cap)
    nl_ff = build_neighbor_list(pos, n, pos, n, table, case.grid, cutoff,
                                k_max=case.k_inner, include_self=False)
    nl_fw = build_neighbor_list(pos, n, case.wall["Position"],
                                case.wall["NReal"], case.wall_table,
                                case.grid, cutoff, k_max=case.k_shell,
                                include_self=True)
    gate_table = build_cell_table(gate["Position"], case.n_gate, case.grid,
                                  case.cell_cap)
    nl_fg = build_neighbor_list(pos, n, gate["Position"], case.n_gate,
                                gate_table, case.grid, cutoff,
                                k_max=case.k_shell, include_self=True)
    nl_gf = build_neighbor_list(gate["Position"], case.n_gate, pos, n, table,
                                case.grid, cutoff, k_max=case.k_gf,
                                include_self=True)
    ovf = nl_ff.overflow | nl_fw.overflow | nl_fg.overflow | nl_gf.overflow
    return nl_ff, nl_fw, nl_fg, nl_gf, ovf


def init_sim(case: HFSICase, fluid: State, gate: State) -> HFSISim:
    nl_ff, nl_fw, nl_fg, nl_gf, ovf = rebuild_relations(case, fluid, gate)
    return HFSISim(fluid=fluid, gate=gate, nl_ff=nl_ff, nl_fw=nl_fw,
                   nl_fg=nl_fg, nl_gf=nl_gf,
                   time=fluid["Position"].new_zeros(()), n_adv=0, n_ac=0,
                   overflow=ovf)


def contact_pairs(case: HFSICase, s: HFSISim, fluid: State, gate: State):
    """The advection step's frozen corrected pairs (fluid -> walls, fluid
    -> gate, gate -> fluid); the normals point into the fluid, so
    normal_correction.  The gate's curvature is taken with the fluid's
    kernel reduced once."""
    kernel, dim = case.kernel, 2
    k1_g, k2_g = sf.shell_curvature(gate, case.nl_gg,
                                    sh.ReducedKernel(kernel), dim)
    zero_w = torch.zeros(case.wall["Position"].shape[0],
                         dtype=fluid["Position"].dtype,
                         device=fluid["Position"].device)
    pos = fluid["Position"]
    pairs_fw = sf.shell_contact_pairs(pos, case.wall, zero_w, zero_w, s.nl_fw,
                                      kernel, dim, case.dx,
                                      normal_correction=True)
    pairs_fg = sf.shell_contact_pairs(pos, gate, k1_g, k2_g, s.nl_fg, kernel,
                                      dim, case.dx, normal_correction=True)
    pairs_gf = sf.fluid_to_shell_pairs(gate, k1_g, k2_g, pos, s.nl_gf, kernel,
                                       dim, case.dx, normal_correction=True)
    return pairs_fw, pairs_fg, pairs_gf


def gate_substep(case: HFSICase, g: State, dt_s) -> State:
    """One sub-step of the gate: the first half, the clamp, the pairwise
    damping of the velocity and the angular velocity, the clamp, the
    second half."""
    kernel, h = case.kernel, case.adaptation.h
    g = sh.shell_stress_relaxation_1st_half(g, case.gate_rp, case.material_s,
                                            dt_s, h)
    g = sh.fix_shell(g, case.clamp_mask)
    for field in ("Velocity", "AngularVelocity"):
        g = dp.damping_pairwise(g, field, case.nl_gg, kernel, 2,
                                case.eta_gate, dt_s)
    g = sh.fix_shell(g, case.clamp_mask)
    return sh.shell_stress_relaxation_2nd_half(g, case.gate_rp, dt_s)


def _timed_substep(case: HFSICase, g: State, ds_sum, dt):
    """One sub-step at dt_s = min(the shell's dt, dt - ds_sum): (gate,
    ds_sum + dt_s)."""
    dt_s = torch.minimum(
        sh.shell_acoustic_time_step(g, case.material_s, case.adaptation.h),
        dt - ds_sum)
    return gate_substep(case, g, dt_s), ds_sum + dt_s


def _eager_substeps(case: HFSICase, g: State, dt):
    """The sub-cycle over dt from g as a host loop: (gate, the sub-step
    count); one host read a sub-step."""
    ds_sum = torch.zeros_like(dt)
    k = 0
    while bool(ds_sum < dt):
        g, ds_sum = _timed_substep(case, g, ds_sum, dt)
        k += 1
    return g, k


def gate_substeps(case: HFSICase, g: State, dt):
    """The gate's sub-cycling over one acoustic dt (cpp:337-350): (gate,
    the sub-step count).  On the card each sub-step is a replay of
    `case.subcycle`'s graph, on the CPU the eager loop."""
    g = fsi.initialize_displacement(g)
    if g["Position"].is_cuda:
        g, k = case.subcycle.run(case, g, dt)
    else:
        g, k = _eager_substeps(case, g, dt)
    return fsi.update_average_velocity_acceleration(g, dt), k


def acoustic_substep(case: HFSICase, s: HFSISim, f: State, g: State, dt_adv,
                     pairs):
    """One acoustic sub-step: the fluid's damping, both halves against the
    walls and the gate, the pressure force on the gate, its sub-cycling.
    Returns (fluid, gate, dt, the gate's sub-steps)."""
    kernel, dim, h = case.kernel, 2, case.adaptation.h
    pairs_fw, pairs_fg, pairs_gf = pairs
    dt = torch.minimum(fd.acoustic_time_step(f, case.eos, h), dt_adv)
    f = dp.damping_pairwise(f, "Velocity", s.nl_ff, kernel, dim, case.mu_f,
                            dt)
    f = dp.damping_pairwise_wall(f, "Velocity", g, s.nl_fg, kernel, dim,
                                 case.mu_f, dt)
    f = dp.damping_pairwise_wall(f, "Velocity", case.wall, s.nl_fw, kernel,
                                 dim, case.mu_f, dt)
    sw = [(case.wall, s.nl_fw, pairs_fw), (g, s.nl_fg, pairs_fg)]
    f = fd.acoustic_step_1st_half(f, s.nl_ff, kernel, dim, case.eos,
                                  case.riemann, dt, shell_walls=sw)
    g = fsi.force_prior_update(g, "PressureForceFromFluid",
                               sf.pressure_force_from_fluid_on_shell(
                                   g, f, pairs_gf, s.nl_gf, case.no_riemann))
    f = fd.acoustic_step_2nd_half(f, s.nl_ff, kernel, dim, case.no_riemann,
                                  dt, shell_walls=sw)
    g, k = gate_substeps(case, g, dt)
    return f, g, dt, k


def _advection_step(case: HFSICase, s: HFSISim) -> HFSISim:
    fluid, gate = s.fluid, s.gate
    pairs = contact_pairs(case, s, fluid, gate)
    dt_adv = fd.advection_time_step(fluid, case.adaptation.h, U_REF)
    fluid = fd.density_summation(
        fluid, s.nl_ff, case.kernel, 2, RHO0_F, case.adaptation.sigma0,
        free_surface=True,
        shell_contacts=[(case.wall, s.nl_fw, pairs[0], 1.0),
                        (gate, s.nl_fg, pairs[1], RHO0_S)])
    relax_t = torch.zeros_like(dt_adv)
    n_ac = n_s = 0
    while bool(relax_t < dt_adv):          # one host read a sub-step
        fluid, gate, dt, k = acoustic_substep(case, s, fluid, gate, dt_adv,
                                              pairs)
        relax_t = relax_t + dt
        n_ac += 1
        n_s += k
    gate = sh.update_shell_normal(gate)
    nl_ff, nl_fw, nl_fg, nl_gf, ovf = rebuild_relations(case, fluid, gate)
    return HFSISim(fluid=fluid, gate=gate, nl_ff=nl_ff, nl_fw=nl_fw,
                   nl_fg=nl_fg, nl_gf=nl_gf, time=s.time + relax_t,
                   n_adv=s.n_adv + 1, n_ac=s.n_ac + n_ac, n_s=s.n_s + n_s,
                   overflow=s.overflow | ovf)


def make_advection_step(case: HFSICase):
    return lambda s: _advection_step(case, s)


def make_run_chunk(case: HFSICase):
    """run_chunk(sim, t_target): advection steps until sim.time >=
    t_target."""
    return chunk_runner(make_advection_step(case))


def center_displacement(case: HFSICase, s: HFSISim) -> float:
    g = s.gate
    return float(g["Position"][case.center_idx, 1]
                 - g["InitialPosition"][case.center_idx, 1])
