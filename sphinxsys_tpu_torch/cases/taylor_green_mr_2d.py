"""Multi-resolution Taylor-Green vortex: an adaptive-h dynamic fluid
(counterpart of sphinxsys_tpu/cases/taylor_green_mr_2d.py; the MR fluid
loop of the reference's ParticleWithLocalRefinement fluids, e.g.
test_2d_free_stream_around_cylinder_mr): a 2x-refined disk inside the
coarse periodic Taylor-Green box, the multi-level neighbour search
rebuilt every advection step (the particles move and carry their h), and
every fluid op evaluated with per-particle smoothing lengths
(physics/fluid_adaptive.py).

The oracle is the analytic viscous decay |v| ~ exp(-8 pi^2 nu t) of the
mixed-resolution field.  The acoustic sub-steps end on the summed time
(one host read a sub-step), the chunk loop reads the time once a step;
the list rebuild reads nothing back.

    case, fluid = build_case(dx=0.05, device="cpu")
    sim = make_run_chunk(case)(init_sim(case, fluid), 0.02)
    print(sim.n_adv, sim.n_ac, max_speed(sim))
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.materials import WeaklyCompressibleFluid
from sphinxsys_tpu_torch.core.state import State, make_fluid_state
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.neighbors.cell_list import (grid_from_bounds,
                                                    wrap_positions)
from sphinxsys_tpu_torch.neighbors.multilevel import (
    build_adaptive_neighbor_list, build_multilevel_tables)
from sphinxsys_tpu_torch.neighbors.neighbor_list import NeighborList
from sphinxsys_tpu_torch.physics import fluid as fd
from sphinxsys_tpu_torch.physics import fluid_adaptive as fa
from sphinxsys_tpu_torch.physics import riemann as rs
from sphinxsys_tpu_torch.solver import chunk_runner

DL = 1.0
DH = 1.0
RHO0_F = 1.0
U_F = 1.0
C_F = 10.0 * U_F
RE = 100.0
MU_F = RHO0_F * U_F * DL / RE
REFINE_CENTER = (0.5, 0.5)
REFINE_R = 0.25
RAMP_W = 0.1    # the h transition band: the fine particles ramp hr 2 -> 1
                # toward the interface, so no kernel support is starved


@dataclasses.dataclass
class SimState:
    fluid: dict
    nl_inner: NeighborList
    time: torch.Tensor
    n_adv: int
    n_ac: int
    overflow: torch.Tensor


@dataclasses.dataclass(frozen=True)
class TGMRCase:
    dx: float
    adaptation: SPHAdaptation
    eos: WeaklyCompressibleFluid
    riemann: rs.AcousticRiemannSolver
    no_riemann: rs.NoRiemannSolver
    n_fluid: int
    cap: int
    k_levels: tuple

    @property
    def kernel(self):
        return self.adaptation.kernel

    @property
    def box(self):
        return (DL, DH)


def build_case(dx: float = 0.02, dtype=PRODUCTION_DTYPE, cap: int = 48,
               k_levels=(96, 128), device="cuda"):
    """The coarse lattice less the disk and the dx/2 lattice inside it, hr
    ramped from 2 to 1 over RAMP_W to the disk's edge, the vortex's
    velocity.  Returns (case, fluid)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    c = np.asarray(REFINE_CENTER)

    def in_disk(p):
        return np.linalg.norm(p - c, axis=1) < REFINE_R

    xs_c = np.arange(dx / 2, DL, dx)
    pos_c = np.stack(np.meshgrid(xs_c, xs_c, indexing="ij"), -1).reshape(-1, 2)
    keep_c = ~in_disk(pos_c)
    xs_f = np.arange(dx / 4, DL, dx / 2)
    pos_f = np.stack(np.meshgrid(xs_f, xs_f, indexing="ij"), -1).reshape(-1, 2)
    keep_f = in_disk(pos_f)
    pos = np.concatenate([pos_c[keep_c], pos_f[keep_f]])
    vols = np.concatenate([np.full(keep_c.sum(), dx * dx),
                           np.full(keep_f.sum(), (dx / 2) ** 2)])
    d = np.linalg.norm(pos - c, axis=1)
    hr_ramp = 1.0 + np.clip((REFINE_R - d) / RAMP_W, 0.0, 1.0)
    h_ratio = np.where(np.concatenate([np.zeros(keep_c.sum(), bool),
                                       np.ones(keep_f.sum(), bool)]),
                       hr_ramp, 1.0)

    fluid = make_fluid_state(pos, vols, RHO0_F, dtype, device)
    fluid["SmoothingLengthRatio"] = torch.as_tensor(h_ratio, dtype=dtype,
                                                    device=device)
    vel = np.stack([
        -np.cos(2 * math.pi * pos[:, 0]) * np.sin(2 * math.pi * pos[:, 1]),
        np.sin(2 * math.pi * pos[:, 0]) * np.cos(2 * math.pi * pos[:, 1]),
    ], axis=-1)
    fluid["Velocity"] = torch.as_tensor(vel, dtype=dtype, device=device)
    fluid["ViscousForce"] = torch.zeros_like(fluid["Velocity"])
    fluid["ViscousForcePrev"] = torch.zeros_like(fluid["Velocity"])

    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    case = TGMRCase(dx=dx, adaptation=adaptation, eos=eos,
                    riemann=rs.acoustic_riemann(eos),
                    no_riemann=rs.no_riemann(eos), n_fluid=len(pos),
                    cap=cap, k_levels=tuple(k_levels))
    return case, fluid


def rebuild_inner(case: TGMRCase, fluid: State):
    """The periodic wrap, the multi-level tables and the adaptive pair
    search, every advection step (the MR fluid's updateCellLinkedList).
    Returns (wrapped positions, list)."""
    grid0 = grid_from_bounds((0.0, 0.0), (DL, DH), case.adaptation.cutoff,
                             periodic=(True, True))
    pos = wrap_positions(fluid["Position"], grid0)
    hr = fluid["SmoothingLengthRatio"]
    n = pos.shape[0]
    ml = build_multilevel_tables(pos, n, hr, (0.0, 0.0), (DL, DH),
                                 case.adaptation.h, kernel_size=2.0,
                                 n_levels=2, cap=case.cap,
                                 periodic=(True, True))
    nl = build_adaptive_neighbor_list(pos, n, hr, pos, hr, ml, 2.0,
                                      case.adaptation.h,
                                      k_max_per_level=list(case.k_levels),
                                      box=case.box)
    return pos, nl


def init_sim(case: TGMRCase, fluid: State) -> SimState:
    pos, nl = rebuild_inner(case, fluid)
    fluid = dict(fluid, Position=pos)
    return SimState(fluid=fluid, nl_inner=nl,
                    time=torch.zeros((), dtype=pos.dtype, device=pos.device),
                    n_adv=0, n_ac=0,
                    overflow=torch.zeros((), dtype=torch.bool,
                                         device=pos.device))


def advection_prep(case: TGMRCase, s: SimState):
    """The advection step's time step, density, viscous force and
    transport correction: (dt_adv, fluid)."""
    kernel, h, box = case.kernel, case.adaptation.h, case.box
    fluid = s.fluid
    dt_adv = fd.advection_viscous_time_step(fluid, h / 2.0, U_F, RHO0_F, MU_F)
    fluid = fa.density_summation_adaptive(fluid, s.nl_inner, kernel, 2,
                                          RHO0_F, box=box)
    fluid = fa.viscous_force_adaptive(fluid, s.nl_inner, kernel, 2, MU_F, h,
                                      box=box)
    fluid = fa.transport_velocity_correction_adaptive(fluid, s.nl_inner,
                                                      kernel, 2, h, box=box)
    return dt_adv, fluid


def acoustic_substep(case: TGMRCase, s: SimState, f: State, dt_adv):
    """One acoustic sub-step at the finest resolution's dt: (fluid, dt)."""
    kernel, box = case.kernel, case.box
    dt = torch.minimum(fd.acoustic_time_step(f, case.eos,
                                             case.adaptation.h / 2.0),
                       dt_adv)
    f = fa.acoustic_step_1st_half_adaptive(f, s.nl_inner, kernel, 2,
                                           case.eos, case.riemann, dt,
                                           box=box)
    f = fa.acoustic_step_2nd_half_adaptive(f, s.nl_inner, kernel, 2,
                                           case.no_riemann, dt, box=box)
    return f, dt


def _advection_step(case: TGMRCase, s: SimState) -> SimState:
    dt_adv, fluid = advection_prep(case, s)
    relax_t = torch.zeros_like(dt_adv)
    n_ac = 0
    while bool(relax_t < dt_adv):          # one host read per sub-step
        fluid, dt = acoustic_substep(case, s, fluid, dt_adv)
        relax_t = relax_t + dt
        n_ac += 1
    pos, nl = rebuild_inner(case, fluid)
    return SimState(fluid=dict(fluid, Position=pos), nl_inner=nl,
                    time=s.time + relax_t, n_adv=s.n_adv + 1,
                    n_ac=s.n_ac + n_ac, overflow=s.overflow | nl.overflow)


def make_advection_step(case: TGMRCase):
    return lambda s: _advection_step(case, s)


def make_run_chunk(case: TGMRCase):
    """run_chunk(sim, t_target): steps until sim.time >= t_target."""
    return chunk_runner(make_advection_step(case))


def max_speed(s: SimState) -> float:
    return float(torch.max(torch.linalg.vector_norm(s.fluid["Velocity"],
                                                    dim=-1)))
