"""2D Taylor–Green vortex — doubly periodic viscous flow (counterpart of
sphinxsys_tpu/cases/taylor_green_2d.py; reference
tests/2d_examples/test_2d_taylor_green/taylor_green.cpp):
  * unit box, doubly periodic, dx = 1/100 by default;
  * rho0 = 1, U = 1, c = 10, Re = 100 -> mu = 0.01;
  * initial velocity u = -cos(2 pi x) sin(2 pi y), v = sin(2 pi x) cos(2 pi y);
  * advection step: viscous-aware dt, density summation (with the volume
    update), viscous force, transport-velocity correction (limiter slope
    100); acoustic loop: 1st half with the acoustic Riemann solver, 2nd
    half with none, dt = min(dt_acoustic, dt_advection);
  * analytic decay: |v| ~ exp(-8 pi^2 nu t), kinetic energy
    ~ exp(-16 pi^2 nu t) — the physics oracle.

Periodicity has no ghost particles: cell windows wrap modulo the grid and
pair displacements take the minimum image.  Two routes run it, as for the
dambreak (cases/dambreak_2d.py): the gather route (`init_sim`,
`make_run_chunk`: neighbour lists rebuilt every advection step, positions
wrapped into the box first, a Morton resort every `sort_every` advection
steps) and the cell-block engine (`build_block_case`).  On the gather
route `relax_ic` > 0 starts from a relaxed particle distribution
(physics/relax.py).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sphinxsys_tpu_torch.core import geometry as G
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.generators import generate_lattice
from sphinxsys_tpu_torch.core.materials import WeaklyCompressibleFluid
from sphinxsys_tpu_torch.core.state import make_fluid_state
from sphinxsys_tpu_torch.device import PRODUCTION_DTYPE, resolve_device
from sphinxsys_tpu_torch.neighbors.cell_list import (
    CellGrid, build_cell_table, grid_from_bounds, morton_resort, wrap_positions,
)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list)
from sphinxsys_tpu_torch.physics import fluid as fd
from sphinxsys_tpu_torch.physics import riemann as rs
from sphinxsys_tpu_torch.physics.relax import relax_periodic
from sphinxsys_tpu_torch.solver import chunk_runner

DL = 1.0
DH = 1.0
RHO0_F = 1.0
U_F = 1.0
C_F = 10.0 * U_F
RE = 100.0
MU_F = RHO0_F * U_F * DL / RE


@dataclasses.dataclass(frozen=True)
class TaylorGreenCase:
    dx: float
    adaptation: SPHAdaptation
    grid: CellGrid
    eos: WeaklyCompressibleFluid
    riemann: rs.AcousticRiemannSolver
    no_riemann: rs.NoRiemannSolver
    n_fluid: int
    cell_cap: int = 24
    k_inner: int = 64
    sort_every: int = 100

    @property
    def kernel(self):
        return self.adaptation.kernel

    @property
    def box(self):
        return self.grid.periodic_lengths


@dataclasses.dataclass
class SimState:
    """The gather route's carry (cases/dambreak_2d.py's, with no wall)."""

    fluid: dict
    nl_inner: NeighborList
    time: torch.Tensor
    n_adv: int
    n_ac: int
    overflow: torch.Tensor


def build_case(dx: float = 0.01, dtype=PRODUCTION_DTYPE, device="cuda",
               relax_ic: int = 0, cell_cap: int = 24, k_inner: int = 64):
    """The scene and the fluid state.  `relax_ic` > 0: that many iterations
    of periodic particle relaxation before the velocity is sampled (the
    reference case starts from a relaxed distribution, with no particle
    exactly on a velocity extremum), run on `device` in `dtype`.  The
    analytic initial velocity is evaluated in numpy on the positions:
    float64 on the lattice, the relaxed positions' dtype after
    relaxation, as the JAX package evaluates it."""
    device = resolve_device(device)
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    shape = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                  halfsize=(DL / 2, DH / 2))
    pos, vol = generate_lattice(shape, (0.0, 0.0), (DL, DH), dx)
    grid = grid_from_bounds((0.0, 0.0), (DL, DH), adaptation.cutoff,
                            periodic=(True, True))
    if relax_ic > 0:
        pos = relax_periodic(
            torch.as_tensor(pos, dtype=dtype, device=device), vol, adaptation,
            grid, n_iterations=relax_ic, cell_cap=max(cell_cap, 32),
            k_max=k_inner, box=grid.periodic_lengths).cpu().numpy()
    fluid = make_fluid_state(pos, vol, RHO0_F, dtype=dtype, device=device)
    vel = np.stack([
        -np.cos(2 * math.pi * pos[:, 0]) * np.sin(2 * math.pi * pos[:, 1]),
        np.sin(2 * math.pi * pos[:, 0]) * np.cos(2 * math.pi * pos[:, 1]),
    ], axis=-1)
    fluid["Velocity"] = torch.as_tensor(vel, dtype=dtype, device=device)
    # the viscous ForcePrior bookkeeping, registered up front
    fluid["ViscousForce"] = torch.zeros_like(fluid["Velocity"])
    fluid["ViscousForcePrev"] = torch.zeros_like(fluid["Velocity"])
    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    case = TaylorGreenCase(dx=dx, adaptation=adaptation, grid=grid, eos=eos,
                           riemann=rs.acoustic_riemann(eos),
                           no_riemann=rs.no_riemann(eos), n_fluid=len(pos),
                           cell_cap=cell_cap, k_inner=k_inner)
    return case, fluid


# ---------------------------------------------------------------------------
# The gather route
# ---------------------------------------------------------------------------

def rebuild_inner(case: TaylorGreenCase, fluid: dict):
    """Positions wrapped into the box, and the inner list on them."""
    pos = wrap_positions(fluid["Position"], case.grid)
    n = fluid["NReal"]
    table = build_cell_table(pos, n, case.grid, case.cell_cap)
    nl = build_neighbor_list(pos, n, pos, n, table, case.grid,
                             case.adaptation.cutoff, k_max=case.k_inner,
                             include_self=False)
    return pos, nl


def init_sim(case: TaylorGreenCase, fluid: dict) -> SimState:
    pos, nl = rebuild_inner(case, fluid)
    return SimState(fluid=dict(fluid, Position=pos), nl_inner=nl,
                    time=torch.zeros((), dtype=pos.dtype, device=pos.device),
                    n_adv=0, n_ac=0, overflow=nl.overflow)


def advection_prep(case: TaylorGreenCase, s: SimState, fluid: dict) -> dict:
    """Density summation (with the volume update), the viscous force and
    the transport-velocity correction (limiter slope 100)."""
    kernel, h, box = case.kernel, case.adaptation.h, case.box
    fluid = fd.density_summation(fluid, s.nl_inner, kernel, 2, RHO0_F,
                                 case.adaptation.sigma0, free_surface=False,
                                 box=box)
    fluid = fd.viscous_force(fluid, s.nl_inner, kernel, 2, MU_F, h, box=box)
    return fd.transport_velocity_correction(fluid, s.nl_inner, kernel, 2, h,
                                            limiter_slope=100.0, box=box)


def acoustic_substep(case: TaylorGreenCase, s: SimState, fluid: dict, dt_adv):
    """One acoustic sub-step, dt capped by the advection dt: (fluid, dt)."""
    kernel, h, box = case.kernel, case.adaptation.h, case.box
    dt = torch.minimum(fd.acoustic_time_step(fluid, case.eos, h), dt_adv)
    fluid = fd.acoustic_step_1st_half(fluid, s.nl_inner, kernel, 2, case.eos,
                                      case.riemann, dt, box=box)
    fluid = fd.acoustic_step_2nd_half(fluid, s.nl_inner, kernel, 2,
                                      case.no_riemann, dt, box=box)
    return fluid, dt


def _advection_step(case: TaylorGreenCase, s: SimState) -> SimState:
    fluid = s.fluid
    dt_adv = fd.advection_viscous_time_step(fluid, case.adaptation.h, U_F,
                                            RHO0_F, MU_F)
    fluid = advection_prep(case, s, fluid)
    relax_t = torch.zeros_like(dt_adv)
    n_ac = 0
    while bool(relax_t < dt_adv):          # one host sync per sub-step
        fluid, dt = acoustic_substep(case, s, fluid, dt_adv)
        relax_t = relax_t + dt
        n_ac += 1
    n_adv = s.n_adv + 1
    if case.sort_every and n_adv % case.sort_every == 0:
        fluid = morton_resort(fluid, case.grid)
    pos, nl = rebuild_inner(case, fluid)
    return SimState(fluid=dict(fluid, Position=pos), nl_inner=nl,
                    time=s.time + relax_t, n_adv=n_adv, n_ac=s.n_ac + n_ac,
                    overflow=s.overflow | nl.overflow)


def make_run_chunk(case: TaylorGreenCase):
    """run_chunk(sim, t_target): advance by advection steps until
    sim.time >= t_target."""
    return chunk_runner(lambda s: _advection_step(case, s))


def make_advection_step(case: TaylorGreenCase):
    return lambda s: _advection_step(case, s)


def build_block_case(dx: float = 0.01, dtype=PRODUCTION_DTYPE, device="cuda",
                     cap: int = 12, c_max: int | None = None,
                     use_kernels: bool = True):
    """The scene on the cell-block engine.  Every cell of the periodic box
    is occupied, so c_max defaults to the cell count, rounded to 256 as the
    JAX package rounds it."""
    from sphinxsys_tpu_torch.engine import scene as sc

    base, fluid = build_case(dx=dx, dtype=dtype, device=device)
    scene = sc.standard_scene(
        base, rho0=RHO0_F, speed_ref=U_F, device=device, dim=2, mu=MU_F,
        tvc_coef=0.2, tvc_limiter=100.0, free_surface=False,
        riemann2=base.no_riemann, cap=cap, c_max=c_max, c_max_multiple=256,
        use_kernels=use_kernels, cap_ac_dt=True)
    return scene, fluid
