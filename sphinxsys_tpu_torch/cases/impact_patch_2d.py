"""2D impact patch: two halves of a fluid column slamming into each other
(counterpart of sphinxsys_tpu/cases/impact_patch_2d.py; reference
tests/2d_examples/test_2d_impact_patch/impact_patch.cpp): a free
LL x LH (0.667 x 2) rectangle of weakly compressible fluid (c = 100)
centred at the origin, vy = -1 on its top half and +1 on its bottom half.
The halves collide at y = 0, two lateral jets form and the kinetic energy
falls from 2/3 to the reference DB's ~0.546 plateau.

Operations as the reference's (impact_patch.cpp:126-133): the alpha = 0.5
kernel correction, the spatial-temporal free-surface indication (its
Indicator carried from step to step), the corrected first half and the
plain second half, both Riemann-dissipated, the free-surface density
summation, the bulk-scoped transport-velocity correction without a
limiter, and the advection dt scaled by 0.3 (cpp:201).  No wall.

    case, fluid = build_case(dx=LL / 10, device="cpu")
    sim = make_run_chunk(case)(init_sim(case, fluid), 0.05)
    print(kinetic_energy(sim))
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.materials import WeaklyCompressibleFluid
from sphinxsys_tpu_torch.core.state import make_fluid_state
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.neighbors.cell_list import (CellGrid,
                                                    build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list)
from sphinxsys_tpu_torch.physics import fluid as fd
from sphinxsys_tpu_torch.physics import riemann as rs
from sphinxsys_tpu_torch.solver import chunk_runner

LL = 0.667          # column width (impact_patch.cpp:12)
LH = 2.0            # column height
RHO0_F = 1.0
U_MAX = 1.0
C_F = 100.0         # impact_patch.cpp:22


@dataclasses.dataclass
class SimState:
    fluid: dict
    nl_inner: NeighborList
    time: torch.Tensor
    n_adv: int
    n_ac: int
    overflow: torch.Tensor


@dataclasses.dataclass(frozen=True)
class FreePatchCase:
    dx: float
    adaptation: SPHAdaptation
    grid: CellGrid
    eos: WeaklyCompressibleFluid
    riemann: rs.AcousticRiemannSolver
    n_fluid: int
    cell_cap: int
    k_inner: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def free_patch_state(pos: np.ndarray, vel: np.ndarray, dx: float, dtype,
                     device) -> dict:
    """A free fluid patch: the state with its velocity, the indication's
    fields (Indicator 0, PreviousSurfaceIndicator 1) and B = I."""
    n = len(pos)
    fluid = make_fluid_state(pos, dx * dx, RHO0_F, dtype, device)
    fluid["Velocity"] = torch.as_tensor(vel, dtype=dtype, device=device)
    fluid["Indicator"] = torch.zeros(n, dtype=torch.int32, device=device)
    fluid["PreviousSurfaceIndicator"] = torch.ones(n, dtype=torch.int32,
                                                   device=device)
    fluid["PositionDivergence"] = torch.zeros(n, dtype=dtype, device=device)
    fluid["LinearGradientCorrectionMatrix"] = torch.eye(
        2, dtype=dtype, device=device).repeat(n, 1, 1)
    return fluid


def build_case(dx: float = LL / 25.0, dtype=PRODUCTION_DTYPE,
               cell_cap: int = 24, k_inner: int = 48, half_span: float = 3.2,
               device="cuda"):
    """The column on its lattice with the halves' velocities
    (InitialVelocity, impact_patch.cpp:56-75); the grid covers
    [-half_span, half_span]^2.  Returns (case, fluid)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    xs = np.arange(-LL / 2 + dx / 2, LL / 2, dx)
    ys = np.arange(-LH / 2 + dx / 2, LH / 2, dx)
    pos = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    vel = np.zeros_like(pos)
    vel[:, 1] = np.where(pos[:, 1] >= 0.0, -1.0, 1.0)
    fluid = free_patch_state(pos, vel, dx, dtype, device)
    grid = grid_from_bounds((-half_span, -half_span), (half_span, half_span),
                            adaptation.cutoff)
    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    case = FreePatchCase(dx=dx, adaptation=adaptation, grid=grid, eos=eos,
                           riemann=rs.acoustic_riemann(eos),
                           n_fluid=len(pos), cell_cap=cell_cap,
                           k_inner=k_inner)
    return case, fluid


def rebuild_lists(case, fluid: dict) -> NeighborList:
    """The inner list (the patch's only relation)."""
    pos = fluid["Position"]
    n = fluid["NReal"]
    table = build_cell_table(pos, n, case.grid, case.cell_cap)
    return build_neighbor_list(pos, n, pos, n, table, case.grid,
                               case.adaptation.cutoff, k_max=case.k_inner,
                               include_self=False)


def init_sim(case, fluid: dict) -> SimState:
    nl = rebuild_lists(case, fluid)
    pos = fluid["Position"]
    return SimState(fluid=dict(fluid), nl_inner=nl,
                    time=torch.zeros((), dtype=pos.dtype, device=pos.device),
                    n_adv=0, n_ac=0,
                    overflow=torch.zeros((), dtype=torch.bool,
                                         device=pos.device))


def advection_prep(case: FreePatchCase, s: SimState) -> dict:
    """The spatial-temporal indication, the free-surface density
    summation, the alpha = 0.5 correction matrix and the bulk-scoped
    transport-velocity correction."""
    kernel, h = case.kernel, case.adaptation.h
    fluid = fd.free_surface_indication(s.fluid, s.nl_inner, kernel, 2,
                                       spatial_temporal=True)
    fluid = fd.density_summation(fluid, s.nl_inner, kernel, 2, RHO0_F,
                                 case.adaptation.sigma0, free_surface=True)
    fluid = fd.kernel_correction_matrix(fluid, s.nl_inner, kernel, 2,
                                        alpha=0.5)
    return fd.transport_velocity_correction(
        fluid, s.nl_inner, kernel, 2, h, limiter_slope=None,
        scope_mask=fluid["Indicator"] == 0)


def acoustic_substep(case, s: SimState, fluid: dict, dt_adv):
    """The corrected first half and the second half, inner only.  Returns
    (fluid, dt)."""
    kernel, h = case.kernel, case.adaptation.h
    dt = torch.minimum(fd.acoustic_time_step(fluid, case.eos, h), dt_adv)
    fluid = fd.acoustic_step_1st_half(fluid, s.nl_inner, kernel, 2, case.eos,
                                      case.riemann, dt, correction=True)
    fluid = fd.acoustic_step_2nd_half(fluid, s.nl_inner, kernel, 2,
                                      case.riemann, dt)
    return fluid, dt


def relax_and_rebuild(case, s: SimState, fluid: dict, dt_adv) -> SimState:
    """The acoustic loop to dt_adv (one host read a sub-step), then the
    list rebuilt: the free patches' step after their prep."""
    relax_t = torch.zeros_like(dt_adv)
    n_ac = 0
    while bool(relax_t < dt_adv):
        fluid, dt = acoustic_substep(case, s, fluid, dt_adv)
        relax_t = relax_t + dt
        n_ac += 1
    nl = rebuild_lists(case, fluid)
    return SimState(fluid=fluid, nl_inner=nl, time=s.time + relax_t,
                    n_adv=s.n_adv + 1, n_ac=s.n_ac + n_ac,
                    overflow=s.overflow | nl.overflow)


def _advection_step(case: FreePatchCase, s: SimState) -> SimState:
    dt_adv = 0.3 * fd.advection_time_step(s.fluid, case.adaptation.h,
                                          U_MAX)                  # cpp:201
    return relax_and_rebuild(case, s, advection_prep(case, s), dt_adv)


def make_advection_step(case: FreePatchCase):
    return lambda s: _advection_step(case, s)


def make_run_chunk(case: FreePatchCase):
    """run_chunk(sim, t_target): advection steps until sim.time >=
    t_target."""
    return chunk_runner(lambda s: _advection_step(case, s))


def kinetic_energy(s: SimState) -> float:
    """0.5 sum m |v|^2 over the rows below NReal (on the host)."""
    f = s.fluid
    n = f["NReal"]
    v2 = torch.sum(f["Velocity"][:n].double() ** 2, dim=-1)
    return float(0.5 * torch.sum(f["Mass"][:n].double() * v2))
