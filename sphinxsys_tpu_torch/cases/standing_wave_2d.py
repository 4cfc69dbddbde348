"""2D standing wave in a closed tank with a wave gauge (counterpart of
sphinxsys_tpu/cases/standing_wave_2d.py; reference tests/2d_examples/
test_2d_standing_wave/standing_wave.cpp): a 2 x 2 tank filled to the
cosine-perturbed surface y = 1 + 0.1 cos(pi x) (rho0 = 1000, g = 9.81,
dx = 0.02), the dual-criteria loop with the kernel-corrected pressure
relaxation.  The gauge at x = 1 reports FreeSurfaceHeight (the
UpperFrontInAxisDirection reduce over a column of half-width 1.3 dx).

The first mode's period from the finite-depth dispersion relation,
omega^2 = g k tanh(k h) with k = pi, h = 1, is T1 ~ 1.135 s: the gauge
sits at the cos(pi x) antinode and oscillates at that period.  Both
loops are host loops, one host read of each condition.

    case, fluid = build_case(dx=0.05, device="cpu")
    sim = make_run_chunk(case)(init_sim(case, fluid), 0.1)
    print(float(free_surface_height(case, sim.fluid)))
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
from sphinxsys_tpu_torch.physics import general as gd
from sphinxsys_tpu_torch.physics import riemann as rs
from sphinxsys_tpu_torch.solver import chunk_runner

DL = 2.0
DH = 2.0
LH = 1.0                    # mean water depth
AMP = 0.1                   # surface perturbation amplitude
RHO0_F = 1000.0
GRAVITY_G = 9.81
U_REF = 2.0 * math.sqrt(GRAVITY_G * LH)
C_F = 10.0 * U_REF
# the first mode's period (finite-depth dispersion)
K1 = math.pi
OMEGA1 = math.sqrt(GRAVITY_G * K1 * math.tanh(K1 * LH))
T1 = 2.0 * math.pi / OMEGA1


@dataclasses.dataclass
class SimState:
    """The carry: the fluid, its two lists, the time (0-d tensor), the
    advection and acoustic step counts and the overflow flag."""

    fluid: dict
    nl_inner: NeighborList
    nl_wall: NeighborList
    time: torch.Tensor
    n_adv: int
    n_ac: int
    overflow: torch.Tensor


@dataclasses.dataclass(frozen=True)
class StandingWaveCase:
    dx: float
    adaptation: SPHAdaptation
    grid: CellGrid
    eos: WeaklyCompressibleFluid
    riemann: rs.AcousticRiemannSolver
    gravity: gd.Gravity
    wall: Any
    wall_table: CellTable
    n_fluid: int
    n_wall: int
    cell_cap: int
    k_inner: int
    k_wall: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = 0.02, dtype=PRODUCTION_DTYPE, cell_cap: int = 24,
               k_inner: int = 64, k_wall: int = 40, device="cuda"):
    """The water under the perturbed surface (standing_wave.cpp:50-73),
    gravity in ForcePrior, B = I, the tank walls with their shape normals.
    Returns (case, fluid)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    bw = 4 * dx
    adaptation = SPHAdaptation(spacing=dx, dim=2)

    xs = np.arange(dx / 2, DL, dx)
    ys = np.arange(dx / 2, DH, dx)
    pos = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    surf = LH + AMP * np.cos(np.pi * pos[:, 0])
    pos_f = pos[pos[:, 1] < surf]

    outer = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                  halfsize=(DL / 2 + bw, DH / 2 + bw))
    inner = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                  halfsize=(DL / 2, DH / 2))
    wall_shape = G.make_complex(("add", outer), ("sub", inner))
    dom_lo, dom_hi = (-bw, -bw), (DL + bw, DH + bw)
    pos_w, _ = generate_lattice(wall_shape, dom_lo, dom_hi, dx)

    fluid = make_fluid_state(pos_f, dx * dx, RHO0_F, dtype, device)
    fluid["LinearGradientCorrectionMatrix"] = torch.eye(
        2, dtype=dtype, device=device).repeat(len(pos_f), 1, 1)
    wall = make_solid_state(pos_w, dx * dx, RHO0_F, dtype, device)
    wall = gd.normal_direction_from_shape(wall, wall_shape)

    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    gravity = gd.Gravity(acceleration=(0.0, -GRAVITY_G))
    fluid = gd.gravity_force(fluid, gravity)

    grid = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff)
    case = StandingWaveCase(
        dx=dx, adaptation=adaptation, grid=grid, eos=eos,
        riemann=rs.acoustic_riemann(eos), gravity=gravity, wall=wall,
        wall_table=build_cell_table(wall["Position"], wall["NReal"], grid,
                                    cell_cap),
        n_fluid=len(pos_f), n_wall=len(pos_w), cell_cap=cell_cap,
        k_inner=k_inner, k_wall=k_wall)
    return case, fluid


def rebuild_relations(case: StandingWaveCase, fluid: dict):
    """The fluid's cell table and its (inner, wall) lists."""
    pos = fluid["Position"]
    n = fluid["NReal"]
    cutoff = case.adaptation.cutoff
    table = build_cell_table(pos, n, case.grid, case.cell_cap)
    nl_inner = build_neighbor_list(pos, n, pos, n, table, case.grid, cutoff,
                                   k_max=case.k_inner, include_self=False)
    nl_wall = build_neighbor_list(pos, n, case.wall["Position"],
                                  case.wall["NReal"], case.wall_table,
                                  case.grid, cutoff, k_max=case.k_wall,
                                  include_self=True)
    return nl_inner, nl_wall


def init_sim(case: StandingWaveCase, fluid: dict) -> SimState:
    nl_inner, nl_wall = rebuild_relations(case, fluid)
    pos = fluid["Position"]
    return SimState(fluid=dict(fluid), nl_inner=nl_inner, nl_wall=nl_wall,
                    time=torch.zeros((), dtype=pos.dtype, device=pos.device),
                    n_adv=0, n_ac=0,
                    overflow=torch.zeros((), dtype=torch.bool,
                                         device=pos.device))


def advection_prep(case: StandingWaveCase, s: SimState) -> dict:
    """The free-surface density summation and the alpha = 0.5 correction
    matrix over the fluid and the wall."""
    kernel = case.kernel
    fluid = fd.density_summation(s.fluid, s.nl_inner, kernel, 2, RHO0_F,
                                 case.adaptation.sigma0,
                                 contacts=[(case.wall, s.nl_wall, RHO0_F)],
                                 free_surface=True)
    return fd.kernel_correction_matrix(fluid, s.nl_inner, kernel, 2,
                                       wall=case.wall, nl_wall=s.nl_wall,
                                       alpha=0.5)


def acoustic_substep(case: StandingWaveCase, s: SimState, fluid: dict):
    """Both acoustic halves against the wall, the first corrected; the
    acoustic dt is not capped by the advection dt (standing_wave.cpp).
    Returns (fluid, dt)."""
    kernel, h = case.kernel, case.adaptation.h
    dt = fd.acoustic_time_step(fluid, case.eos, h)
    fluid = fd.acoustic_step_1st_half(fluid, s.nl_inner, kernel, 2, case.eos,
                                      case.riemann, dt, wall=case.wall,
                                      nl_wall=s.nl_wall, correction=True)
    fluid = fd.acoustic_step_2nd_half(fluid, s.nl_inner, kernel, 2,
                                      case.riemann, dt, wall=case.wall,
                                      nl_wall=s.nl_wall)
    return fluid, dt


def _advection_step(case: StandingWaveCase, s: SimState) -> SimState:
    # the reference scales the advection criterion by 0.3 and corrects the
    # pressure relaxation (standing_wave.cpp:151-153, 226-228): without
    # both the gauge's amplitude decays from ~0.11 to ~0.04 by t = 10
    dt_adv = 0.3 * fd.advection_time_step(s.fluid, case.adaptation.h, U_REF)
    fluid = advection_prep(case, s)
    relax_t = torch.zeros_like(dt_adv)
    n_ac = 0
    while bool(relax_t < dt_adv):          # one host read per sub-step
        fluid, dt = acoustic_substep(case, s, fluid)
        relax_t = relax_t + dt
        n_ac += 1
    nl_inner, nl_wall = rebuild_relations(case, fluid)
    return SimState(fluid=fluid, nl_inner=nl_inner, nl_wall=nl_wall,
                    time=s.time + relax_t, n_adv=s.n_adv + 1,
                    n_ac=s.n_ac + n_ac,
                    overflow=s.overflow | nl_inner.overflow | nl_wall.overflow)


def make_advection_step(case: StandingWaveCase):
    return lambda s: _advection_step(case, s)


def make_run_chunk(case: StandingWaveCase):
    """run_chunk(sim, t_target): advection steps until sim.time >=
    t_target."""
    return chunk_runner(lambda s: _advection_step(case, s))


def free_surface_height(case: StandingWaveCase, fluid: dict,
                        x_gauge: float = 1.0,
                        half_width: float | None = None):
    """The FreeSurfaceHeight gauge (standing_wave.cpp:85-101): the largest
    y over the rows below NReal inside the column |x - x_gauge| <= 1.3 dx,
    a 0-d tensor."""
    hw = half_width if half_width is not None else 1.3 * case.dx
    pos = fluid["Position"]
    valid = torch.arange(pos.shape[0], device=pos.device) < fluid["NReal"]
    in_col = valid & (torch.abs(pos[:, 0] - x_gauge) <= hw)
    return torch.max(torch.where(in_col, pos[:, 1],
                                 torch.full_like(pos[:, 1], -math.inf)))
