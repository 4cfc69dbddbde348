"""Gravity-driven Poiseuille channel flow (counterpart of
sphinxsys_tpu/cases/poiseuille_flow_2d.py; reference tests/2d_examples/
test_2d_poiseuille_flow/poiseuille_flow.cpp): an x-periodic channel DL = 6,
DH = 1, dx = DH / 20, rho0 = 1, mu = 0.1, driven by g = 12 mu U_f / rho /
DH^2 (the steady centreline speed 1.5 U_f); the kernel-corrected pressure
relaxation with the wall Riemann solver, the second half without one,
the density summation without a free surface, the viscous force and the
transport-velocity correction.  TotalKineticEnergy is its regression
quantity (the reference's plateau 3.6625).

As the JAX package's, the viscous force and the transport correction are
the plain forms, not the reference's B-weighted variants.  Positions are
wrapped into the box at every rebuild.

    case, fluid = build_case(dx=0.1, device="cpu")
    sim = make_run_chunk(case)(init_sim(case, fluid), 0.2)
    print(kinetic_energy(sim))
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.materials import WeaklyCompressibleFluid
from sphinxsys_tpu_torch.core.state import make_fluid_state, make_solid_state
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.neighbors.cell_list import (CellGrid, CellTable,
                                                    build_cell_table,
                                                    grid_from_bounds,
                                                    wrap_positions)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list)
from sphinxsys_tpu_torch.physics import fluid as fd
from sphinxsys_tpu_torch.physics import riemann as rs
from sphinxsys_tpu_torch.solver import chunk_runner

DL = 6.0
DH = 1.0
DX = DH / 20.0
N_WALL_LAYERS = 4

RHO0_F = 1.0
MU_F = 1.0e-1
U_F = 1.0
GRAVITY_G = 12.0 * MU_F * U_F / RHO0_F / DH / DH
U_MAX = 1.5 * U_F
C_F = 10.0 * U_MAX


@dataclasses.dataclass
class SimState:
    fluid: dict
    nl_inner: NeighborList
    nl_wall: NeighborList
    time: torch.Tensor
    n_adv: int
    n_ac: int
    overflow: torch.Tensor


@dataclasses.dataclass(frozen=True)
class PoiseuilleCase:
    dx: float
    adaptation: SPHAdaptation
    grid: CellGrid
    eos: WeaklyCompressibleFluid
    riemann: rs.AcousticRiemannSolver
    no_riemann: rs.NoRiemannSolver
    wall: Any
    wall_table: CellTable
    n_fluid: int
    cell_cap: int
    k_inner: int
    k_wall: int

    @property
    def kernel(self):
        return self.adaptation.kernel

    @property
    def box(self):
        return self.grid.periodic_lengths


def _make_walls(dx: float, dtype, device) -> dict:
    """Four layers below y = 0 and above y = DH, normals into the
    channel."""
    xs = np.arange(dx / 2, DL, dx)
    ys = np.arange(dx / 2, N_WALL_LAYERS * dx, dx)
    bot = np.stack(np.meshgrid(xs, -ys, indexing="ij"), -1).reshape(-1, 2)
    top = np.stack(np.meshgrid(xs, DH + ys, indexing="ij"), -1).reshape(-1, 2)
    pos = np.concatenate([bot, top], axis=0)
    normals = np.concatenate([np.tile([0.0, 1.0], (len(bot), 1)),
                              np.tile([0.0, -1.0], (len(top), 1))], axis=0)
    wall = make_solid_state(pos, dx * dx, RHO0_F, dtype, device)
    wall["NormalDirection"] = torch.as_tensor(normals, dtype=dtype,
                                              device=device)
    return wall


def build_case(dx: float = DX, dtype=PRODUCTION_DTYPE, cell_cap: int = 24,
               k_inner: int = 40, k_wall: int = 24, device="cuda"):
    """The fluid at rest on the channel's lattice, the driving gravity in
    ForcePrior, B = I; the walls and the x-periodic grid.  Returns (case,
    fluid)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    xs = np.arange(dx / 2, DL, dx)
    ys = np.arange(dx / 2, DH, dx)
    pos = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    fluid = make_fluid_state(pos, dx * dx, RHO0_F, dtype, device)
    g = torch.zeros_like(fluid["Velocity"])
    g[:, 0] = GRAVITY_G
    fluid["ForcePrior"] = g * fluid["Mass"][:, None]
    fluid["ViscousForce"] = torch.zeros_like(fluid["Velocity"])
    fluid["ViscousForcePrev"] = torch.zeros_like(fluid["Velocity"])
    fluid["LinearGradientCorrectionMatrix"] = torch.eye(
        2, dtype=dtype, device=device).repeat(len(pos), 1, 1)

    grid = grid_from_bounds((0.0, -(N_WALL_LAYERS + 0.5) * dx),
                            (DL, DH + (N_WALL_LAYERS + 0.5) * dx),
                            adaptation.cutoff, periodic=(True, False))
    wall = _make_walls(dx, dtype, device)
    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    case = PoiseuilleCase(
        dx=dx, adaptation=adaptation, grid=grid, eos=eos,
        riemann=rs.acoustic_riemann(eos), no_riemann=rs.no_riemann(eos),
        wall=wall, wall_table=build_cell_table(wall["Position"],
                                               wall["NReal"], grid, cell_cap),
        n_fluid=len(pos), cell_cap=cell_cap, k_inner=k_inner, k_wall=k_wall)
    return case, fluid


def rebuild_lists(case: PoiseuilleCase, fluid: dict):
    """Positions wrapped into the box, then the (inner, wall) lists.
    Returns (wrapped positions, nl_inner, nl_wall)."""
    pos = wrap_positions(fluid["Position"], case.grid)
    n = fluid["NReal"]
    cutoff = case.adaptation.cutoff
    table = build_cell_table(pos, n, case.grid, case.cell_cap)
    nl = build_neighbor_list(pos, n, pos, n, table, case.grid, cutoff,
                             k_max=case.k_inner, include_self=False)
    nlw = build_neighbor_list(pos, n, case.wall["Position"],
                              case.wall["NReal"], case.wall_table, case.grid,
                              cutoff, k_max=case.k_wall, include_self=False)
    return pos, nl, nlw


def init_sim(case: PoiseuilleCase, fluid: dict) -> SimState:
    pos, nl, nlw = rebuild_lists(case, fluid)
    return SimState(fluid=dict(fluid, Position=pos), nl_inner=nl,
                    nl_wall=nlw,
                    time=torch.zeros((), dtype=pos.dtype, device=pos.device),
                    n_adv=0, n_ac=0,
                    overflow=torch.zeros((), dtype=torch.bool,
                                         device=pos.device))


def advection_prep(case: PoiseuilleCase, s: SimState) -> dict:
    """The density summation, the alpha = 0.5 correction matrix, the
    viscous force and the transport-velocity correction, all against the
    wall and through the box."""
    kernel, h, box, wall = case.kernel, case.adaptation.h, case.box, case.wall
    fluid = fd.density_summation(s.fluid, s.nl_inner, kernel, 2, RHO0_F,
                                 case.adaptation.sigma0,
                                 contacts=[(wall, s.nl_wall, RHO0_F)],
                                 free_surface=False, box=box)
    fluid = fd.kernel_correction_matrix(fluid, s.nl_inner, kernel, 2,
                                        wall=wall, nl_wall=s.nl_wall,
                                        alpha=0.5, box=box)
    fluid = fd.viscous_force(fluid, s.nl_inner, kernel, 2, MU_F, h,
                             wall=wall, nl_wall=s.nl_wall, box=box)
    return fd.transport_velocity_correction(fluid, s.nl_inner, kernel, 2, h,
                                            wall=wall, nl_wall=s.nl_wall,
                                            box=box)


def acoustic_substep(case: PoiseuilleCase, s: SimState, fluid: dict, dt_adv):
    """The corrected first half (Riemann-dissipated) and the second half
    without dissipation.  Returns (fluid, dt)."""
    kernel, h, box, wall = case.kernel, case.adaptation.h, case.box, case.wall
    dt = torch.minimum(fd.acoustic_time_step(fluid, case.eos, h), dt_adv)
    fluid = fd.acoustic_step_1st_half(fluid, s.nl_inner, kernel, 2, case.eos,
                                      case.riemann, dt, wall=wall,
                                      nl_wall=s.nl_wall, box=box,
                                      correction=True)
    fluid = fd.acoustic_step_2nd_half(fluid, s.nl_inner, kernel, 2,
                                      case.no_riemann, dt, wall=wall,
                                      nl_wall=s.nl_wall, box=box)
    return fluid, dt


def _advection_step(case: PoiseuilleCase, s: SimState) -> SimState:
    dt_adv = fd.advection_viscous_time_step(s.fluid, case.adaptation.h, U_F,
                                            RHO0_F, MU_F)
    fluid = advection_prep(case, s)
    relax_t = torch.zeros_like(dt_adv)
    n_ac = 0
    while bool(relax_t < dt_adv):          # one host read per sub-step
        fluid, dt = acoustic_substep(case, s, fluid, dt_adv)
        relax_t = relax_t + dt
        n_ac += 1
    pos, nl, nlw = rebuild_lists(case, fluid)
    return SimState(fluid=dict(fluid, Position=pos), nl_inner=nl,
                    nl_wall=nlw, time=s.time + relax_t, n_adv=s.n_adv + 1,
                    n_ac=s.n_ac + n_ac,
                    overflow=s.overflow | nl.overflow | nlw.overflow)


def make_advection_step(case: PoiseuilleCase):
    return lambda s: _advection_step(case, s)


def make_run_chunk(case: PoiseuilleCase):
    """run_chunk(sim, t_target): advection steps until sim.time >=
    t_target."""
    return chunk_runner(lambda s: _advection_step(case, s))


def kinetic_energy(s: SimState) -> float:
    """0.5 sum m |v|^2 over the rows below NReal (on the host)."""
    f = s.fluid
    n = f["NReal"]
    v2 = torch.sum(f["Velocity"][:n].double() ** 2, dim=-1)
    return float(0.5 * torch.sum(f["Mass"][:n].double() * v2))


def analytic_profile(y, t, n_terms: int = 60):
    """The start-up transient (series solution):
    u(y, t) = (g / 2 nu) y (H - y)
        - sum_{n odd} 4 g H^2 / (nu pi^3 n^3) sin(n pi y / H)
          exp(-n^2 pi^2 nu t / H^2)."""
    nu = MU_F / RHO0_F
    u = GRAVITY_G / (2.0 * nu) * y * (DH - y)
    for n in range(1, 2 * n_terms, 2):
        u = u - (4.0 * GRAVITY_G * DH * DH / (nu * math.pi ** 3 * n ** 3)
                 * np.sin(n * math.pi * y / DH)
                 * math.exp(-n * n * math.pi ** 2 * nu * t / DH / DH))
    return u


def mean_profile(case: PoiseuilleCase, s: SimState,
                 n_bins: int | None = None):
    """The mean streamwise velocity in n_bins bands of y (on the host):
    (band centres, means)."""
    n_bins = n_bins or int(round(DH / case.dx))
    y = s.fluid["Position"][:, 1].double().cpu().numpy()
    u = s.fluid["Velocity"][:, 0].double().cpu().numpy()
    edges = np.linspace(0.0, DH, n_bins + 1)
    idx = np.clip(np.digitize(y, edges) - 1, 0, n_bins - 1)
    prof = np.asarray([u[idx == b].mean() for b in range(n_bins)])
    return 0.5 * (edges[:-1] + edges[1:]), prof
