"""Elastic gate under a water column (counterpart of
sphinxsys_tpu/cases/elastic_gate_2d.py; reference tests/2d_examples/
test_2d_elastic_gate/elastic_gate.cpp): a 100 x 140 water column in the
right corner of a 500-long tank, held back by a rubber gate (width 5,
clamped above y = 79) that bends open and releases the water; gravity
9.8e-3, c = 20 sqrt(140 g), an SVK gate (rho 1.1, E = 7.8e3, nu = 0.47)
at twice the fluid's resolution, INVISCID fluid with Riemann dissipation
in BOTH halves, no transport-velocity correction.

The observer is the gate's bottom-left particle (a material point), whose
Position carries the reference's DTW database.  The cross-body pair
terms use the fluid's (coarser) kernel, as the reference's
ContactRelation does.

Three nested host loops, one host read of each condition (the advection
step, its acoustic sub-steps, the gate's sub-steps inside each), as in
cases/fish_fsi_2d.py.

    case, fluid, gate = build_case(device="cpu")      # 2,240 + 480
    sim = make_run_chunk(case)(init_sim(case, fluid, gate), 4.0)
    print(tip_position(case, sim))
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from sphinxsys_tpu_torch.cases import fish_undulation_2d as fish_mod
from sphinxsys_tpu_torch.core import geometry as G
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.generators import generate_lattice
from sphinxsys_tpu_torch.core.materials import (SaintVenantKirchhoffSolid,
                                                WeaklyCompressibleFluid)
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
from sphinxsys_tpu_torch.physics import riemann as rs
from sphinxsys_tpu_torch.physics import solid as sd
from sphinxsys_tpu_torch.solver import chunk_runner

DL = 500.0
DH = 200.1
DAM_L = 100.0
DAM_H = 140.0
GATE_W = 5.0
BASE_Y = 79.0            # clamped above this height
RHO0_F = 1.0
GRAVITY_G = 9.8e-3
U_F = 1.0
C_F = 20.0 * math.sqrt(140.0 * GRAVITY_G)
RHO0_S = 1.1
POISSON = 0.47
YOUNGS = 7.8e3 * RHO0_F * U_F * U_F


@dataclasses.dataclass
class GateSim:
    """The carry: the fluid, the gate, the four lists, the time (0-d
    tensor), the advection, acoustic and gate step counts and the overflow
    flag."""

    fluid: dict
    gate: dict
    nl_ff: NeighborList
    nl_fw: NeighborList
    nl_fg: NeighborList      # fluid -> gate (wall-type contact)
    nl_gf: NeighborList      # gate -> fluid (the pressure force)
    time: torch.Tensor
    n_adv: int
    n_ac: int
    n_s: int
    overflow: torch.Tensor


@dataclasses.dataclass(frozen=True)
class GateCase:
    dx: float
    adaptation: SPHAdaptation
    grid: CellGrid
    eos: WeaklyCompressibleFluid
    riemann: rs.AcousticRiemannSolver
    gravity: gd.Gravity
    material_s: SaintVenantKirchhoffSolid
    wall: Any
    wall_table: CellTable
    rp: sd.ReferencePairs
    clamp_mask: torch.Tensor
    tip_idx: int
    n_fluid: int
    n_wall: int
    n_gate: int
    cell_cap: int
    k_inner: int
    k_contact: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = GATE_W / 2.0, dtype=PRODUCTION_DTYPE,
               cell_cap: int = 24, k_inner: int = 48, k_contact: int = 48,
               device="cuda"):
    """The water column, the tank walls, the gate on its fine lattice
    (shifted so that a lattice plane lands on the clamp line) with its
    frozen pairs at the fine resolution, the clamp mask and the tip
    observer.  Returns (case, fluid, gate)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    BW = 4 * dx
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    dxs = dx / 2.0               # the gate's 2x refinement

    xs = np.arange(DL - DAM_L + dx / 2, DL, dx)
    ys = np.arange(dx / 2, DAM_H, dx)
    pos_f = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)

    outer = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                  halfsize=(DL / 2 + BW, DH / 2 + BW))
    inner = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                  halfsize=(DL / 2, DH / 2))
    wall_shape = G.make_complex(("add", outer), ("sub", inner))
    dom_lo, dom_hi = (-BW, -BW), (DL + BW, DH + BW)
    pos_w, _ = generate_lattice(wall_shape, dom_lo, dom_hi, dx)

    # the gate: a fine lattice column, shifted up so that a lattice plane
    # lands on the clamp line (OffsetInitialPosition, elastic_gate.cpp:22)
    off_y = BASE_Y - math.floor(BASE_Y / dxs) * dxs
    gx = np.arange(DL - DAM_L - GATE_W + dxs / 2, DL - DAM_L, dxs)
    gy = np.arange(dxs / 2, DAM_H + BW, dxs) + off_y
    pos_g = np.stack(np.meshgrid(gx, gy, indexing="ij"), -1).reshape(-1, 2)

    fluid = make_fluid_state(pos_f, dx * dx, RHO0_F, dtype, device)
    wall = make_solid_state(pos_w, dx * dx, RHO0_F, dtype, device)
    wall = gd.normal_direction_from_shape(wall, wall_shape)

    material_s = SaintVenantKirchhoffSolid(rho0=RHO0_S, youngs_modulus=YOUNGS,
                                           poisson_ratio=POISSON)
    gate = sd.make_elastic_solid_state(pos_g, dxs * dxs, material_s, dtype,
                                       device)
    n_g = len(pos_g)
    zeros = torch.zeros_like(gate["Position"])
    gate["AverageVelocity"] = zeros
    gate["AverageAcceleration"] = zeros
    gate["TemporaryPosition"] = gate["Position"]
    gate["PressureForceFromFluid"] = zeros
    gate["PreviousPressureForceFromFluid"] = zeros
    # the normals point from the gate to the fluid's side (+x)
    gate["NormalDirection"] = torch.as_tensor(
        [1.0, 0.0], dtype=dtype, device=device).repeat(n_g, 1)
    gate["InitialNormalDirection"] = gate["NormalDirection"]

    # the frozen total-Lagrangian pairs at the FINE resolution
    fine = SPHAdaptation(spacing=dxs, dim=2)
    grid_g = grid_from_bounds(
        (DL - DAM_L - GATE_W - 4 * dxs, -4 * dxs),
        (DL - DAM_L + 4 * dxs, DAM_H + BW + 4 * dxs), fine.cutoff)
    rp = fish_mod.frozen_pairs(gate, grid_g, fine, 32, cell_cap=16)
    gate["LinearGradientCorrectionMatrix"] = \
        sd.linear_gradient_correction_matrix(rp, gate["VolumetricMeasure"])

    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    gravity = gd.Gravity(acceleration=(0.0, -GRAVITY_G))
    fluid = gd.gravity_force(fluid, gravity)
    grid = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff)
    case = GateCase(
        dx=dx, adaptation=adaptation, grid=grid, eos=eos,
        riemann=rs.acoustic_riemann(eos), gravity=gravity,
        material_s=material_s, wall=wall,
        wall_table=build_cell_table(wall["Position"], wall["NReal"], grid,
                                    cell_cap),
        rp=rp, clamp_mask=torch.as_tensor(pos_g[:, 1] >= BASE_Y,
                                          device=device),
        tip_idx=int(np.argmin(pos_g[:, 0] + pos_g[:, 1])),
        n_fluid=len(pos_f), n_wall=len(pos_w), n_gate=n_g,
        cell_cap=cell_cap, k_inner=k_inner, k_contact=k_contact)
    return case, fluid, gate


def rebuild_relations(case: GateCase, fluid: dict, gate: dict):
    """The lists: fluid inner, fluid -> wall, fluid -> gate, gate ->
    fluid.  The gate is finer, ~4x the fluid's count a cell, so its table
    has 4x the cap.  Returns (nl_ff, nl_fw, nl_fg, nl_gf, overflow)."""
    pos = fluid["Position"]
    n = fluid["NReal"]
    cutoff, kc = case.adaptation.cutoff, case.k_contact
    table = build_cell_table(pos, n, case.grid, case.cell_cap)
    nl_ff = build_neighbor_list(pos, n, pos, n, table, case.grid, cutoff,
                                k_max=case.k_inner, include_self=False)
    nl_fw = build_neighbor_list(pos, n, case.wall["Position"],
                                case.wall["NReal"], case.wall_table,
                                case.grid, cutoff, k_max=kc,
                                include_self=True)
    table_g = build_cell_table(gate["Position"], case.n_gate, case.grid,
                               4 * case.cell_cap)
    nl_fg = build_neighbor_list(pos, n, gate["Position"], case.n_gate,
                                table_g, case.grid, cutoff, k_max=kc,
                                include_self=True)
    nl_gf = build_neighbor_list(gate["Position"], case.n_gate, pos, n, table,
                                case.grid, cutoff, k_max=kc,
                                include_self=True)
    ovf = nl_ff.overflow | nl_fw.overflow | nl_fg.overflow | nl_gf.overflow
    return nl_ff, nl_fw, nl_fg, nl_gf, ovf


def init_sim(case: GateCase, fluid: dict, gate: dict) -> GateSim:
    nl_ff, nl_fw, nl_fg, nl_gf, ovf = rebuild_relations(case, fluid, gate)
    pos = fluid["Position"]
    return GateSim(fluid=dict(fluid), gate=dict(gate), nl_ff=nl_ff,
                   nl_fw=nl_fw, nl_fg=nl_fg, nl_gf=nl_gf,
                   time=torch.zeros((), dtype=pos.dtype, device=pos.device),
                   n_adv=0, n_ac=0, n_s=0, overflow=ovf)


def advection_prep(case: GateCase, s: GateSim):
    """The free-surface density summation against the wall and the gate,
    the gate's normals.  Returns (fluid, gate)."""
    fluid = fd.density_summation(
        s.fluid, s.nl_ff, case.kernel, 2, RHO0_F, case.adaptation.sigma0,
        contacts=[(case.wall, s.nl_fw, RHO0_F), (s.gate, s.nl_fg, RHO0_S)],
        free_surface=True)
    return fluid, fsi.update_elastic_normal_direction(s.gate)


def gate_substep(case: GateCase, gate: dict, dt_s) -> dict:
    """One of the gate's sub-steps: the 1st half (the fine h, the fluid
    kernel's W0, as the JAX package), the clamp, the 2nd half."""
    h_s = case.adaptation.h / 2.0
    gate = sd.integration_1st_half_pk2(gate, case.rp, case.material_s, dt_s,
                                       h_s, case.kernel.w0(2))
    gate = sd.fix_constraint(gate, case.clamp_mask)
    return sd.integration_2nd_half(gate, case.rp, dt_s)


def gate_substeps(case: GateCase, gate: dict, dt) -> tuple:
    """The gate's sub-steps over the acoustic dt, one host read each in
    the loop's test.  Returns (gate, count)."""
    c0s = case.material_s.sound_speed
    h_s = case.adaptation.h / 2.0
    g = fsi.initialize_displacement(gate)
    ds_sum = torch.zeros_like(dt)
    k = 0
    while bool(ds_sum < dt):
        dt_s = torch.minimum(sd.solid_acoustic_time_step(g, c0s, h_s),
                             dt - ds_sum)
        g = gate_substep(case, g, dt_s)
        ds_sum = ds_sum + dt_s
        k += 1
    return fsi.update_average_velocity_acceleration(g, dt), k


def acoustic_substep(case: GateCase, s: GateSim, fluid: dict, gate: dict,
                     dt_adv):
    """One acoustic sub-step: the 1st half against the wall and the gate,
    the pressure force on the gate, the 2nd half (Riemann-dissipated,
    Integration2ndHalfWithWallRiemann, elastic_gate.cpp:188), the gate's
    sub-steps.  Returns (fluid, gate, dt, gate sub-steps)."""
    kernel, h = case.kernel, case.adaptation.h
    dt = torch.minimum(fd.acoustic_time_step(fluid, case.eos, h), dt_adv)
    walls = [(case.wall, s.nl_fw), (gate, s.nl_fg)]
    fluid = fd.acoustic_step_1st_half(fluid, s.nl_ff, kernel, 2, case.eos,
                                      case.riemann, dt, walls=walls)
    gate = fsi.pressure_force_from_fluid(gate, fluid, s.nl_gf, kernel, 2,
                                         case.riemann)
    fluid = fd.acoustic_step_2nd_half(fluid, s.nl_ff, kernel, 2,
                                      case.riemann, dt, walls=walls)
    gate, k = gate_substeps(case, gate, dt)
    return fluid, gate, dt, k


def _advection_step(case: GateCase, s: GateSim) -> GateSim:
    dt_adv = fd.advection_time_step(s.fluid, case.adaptation.h, U_F)
    fluid, gate = advection_prep(case, s)
    relax_t = torch.zeros_like(dt_adv)
    n_ac = n_s = 0
    while bool(relax_t < dt_adv):          # one host read per sub-step
        fluid, gate, dt, k = acoustic_substep(case, s, fluid, gate, dt_adv)
        relax_t = relax_t + dt
        n_ac += 1
        n_s += k
    nl_ff, nl_fw, nl_fg, nl_gf, ovf = rebuild_relations(case, fluid, gate)
    return GateSim(fluid=fluid, gate=gate, nl_ff=nl_ff, nl_fw=nl_fw,
                   nl_fg=nl_fg, nl_gf=nl_gf, time=s.time + relax_t,
                   n_adv=s.n_adv + 1, n_ac=s.n_ac + n_ac, n_s=s.n_s + n_s,
                   overflow=s.overflow | ovf)


def make_advection_step(case: GateCase):
    return lambda s: _advection_step(case, s)


def make_run_chunk(case: GateCase):
    """run_chunk(sim, t_target): advection steps until sim.time >=
    t_target."""
    return chunk_runner(lambda s: _advection_step(case, s))


def tip_position(case: GateCase, s: GateSim) -> torch.Tensor:
    """The observed gate-tip material point (Observer_Position)."""
    return s.gate["Position"][case.tip_idx]
