"""2D Eulerian Taylor-Green vortex with the Laguerre-Gauss kernel
(counterpart of sphinxsys_tpu/cases/eulerian_taylor_green_2d.py;
reference tests/2d_examples/test_2d_eulerian_taylor_green_LG/
2d_eulerian_taylor_green_LG.cpp): static control volumes on a doubly
periodic unit box, the compressible HLLC two-half integration with the
limiter (gamma = 1.4, c = 10 U: Ma = 0.1), the viscous force at Re = 100
and the Laguerre-Gauss kernel, from u = -cos(2 pi x) sin(2 pi y),
v = sin(2 pi x) cos(2 pi y) (cpp:55-66).

The particles never move, so the list is built once.  The kinetic energy
decays as KE(0) exp(-16 pi^2 nu t).  A step reads nothing back; the
chunk loop reads the time once a step.

    case, fluid = build_case(dx=0.1, device="cpu")
    sim = make_run_chunk(case)(init_sim(case, fluid), 0.01)
    print(sim.n_steps, kinetic_energy(sim))
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.kernels import LaguerreGauss
from sphinxsys_tpu_torch.core.materials import CompressibleFluid
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.neighbors.cell_list import (build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list)
from sphinxsys_tpu_torch.physics import eulerian as eu
from sphinxsys_tpu_torch.physics import fluid as fd
from sphinxsys_tpu_torch.solver import chunk_runner

DL = 1.0
RHO0_F = 1.0
U_F = 1.0
C_F = 10.0 * U_F
RE = 100.0
MU_F = RHO0_F * U_F * DL / RE
GAMMA = 1.4
LIMITER = 1.0


@dataclasses.dataclass
class SimState:
    fluid: dict
    time: torch.Tensor
    n_steps: int
    overflow: torch.Tensor


@dataclasses.dataclass(frozen=True)
class EulerianTGCase:
    dx: float
    adaptation: SPHAdaptation
    gas: CompressibleFluid
    nl: NeighborList
    box: tuple
    n_fluid: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = DL / 50.0, dtype=PRODUCTION_DTYPE,
               cell_cap: int = 24, k_inner: int = 48, device="cuda"):
    """The lattice with the vortex's velocity at p0 = c^2 rho0 / gamma
    (cpp:59) and its frozen periodic list (overflow checked once, on the
    host).  Returns (case, fluid)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    adaptation = SPHAdaptation(spacing=dx, dim=2, kernel_cls=LaguerreGauss)
    xs = np.arange(dx / 2, DL, dx)
    pos = np.stack(np.meshgrid(xs, xs, indexing="ij"), -1).reshape(-1, 2)
    x, y = pos[:, 0], pos[:, 1]
    vel = np.stack([-np.cos(2 * math.pi * x) * np.sin(2 * math.pi * y),
                    np.sin(2 * math.pi * x) * np.cos(2 * math.pi * y)], -1)
    gas = CompressibleFluid(rho0=RHO0_F, gamma=GAMMA)
    p0 = C_F * C_F * RHO0_F / GAMMA
    fluid = eu.make_compressible_eulerian_state(pos, dx * dx, gas, RHO0_F,
                                                p0, dtype, device, vel0=vel)
    fluid["ViscousForce"] = torch.zeros_like(fluid["Velocity"])
    fluid["ViscousForcePrev"] = torch.zeros_like(fluid["Velocity"])

    grid = grid_from_bounds((0.0, 0.0), (DL, DL), adaptation.cutoff,
                            periodic=(True, True))
    n = fluid["NReal"]
    table = build_cell_table(fluid["Position"], n, grid, cell_cap)
    nl = build_neighbor_list(fluid["Position"], n, fluid["Position"], n,
                             table, grid, adaptation.cutoff, k_max=k_inner,
                             include_self=False)
    if bool(nl.overflow):
        raise RuntimeError("eulerian_taylor_green_2d: the list overflows")
    case = EulerianTGCase(dx=dx, adaptation=adaptation, gas=gas, nl=nl,
                          box=grid.periodic_lengths, n_fluid=len(pos))
    return case, fluid


def init_sim(case: EulerianTGCase, fluid: dict) -> SimState:
    pos = fluid["Position"]
    return SimState(fluid=dict(fluid),
                    time=torch.zeros((), dtype=pos.dtype, device=pos.device),
                    n_steps=0,
                    overflow=torch.zeros((), dtype=torch.bool,
                                         device=pos.device))


def time_step(case: EulerianTGCase, f: dict):
    return eu.compressible_time_step(f, case.gas, case.adaptation.h, cfl=0.6,
                                     dim=2)


def fluid_step(case: EulerianTGCase, f: dict, dt) -> dict:
    """The viscous force, then the two HLLC halves."""
    kernel, h = case.kernel, case.adaptation.h
    f = fd.viscous_force(f, case.nl, kernel, 2, MU_F, h, box=case.box)
    f = eu.compressible_integration_1st_half(f, case.nl, kernel, 2, case.gas,
                                             dt, box=case.box,
                                             limiter=LIMITER)
    return eu.compressible_integration_2nd_half(f, case.nl, kernel, 2,
                                                case.gas, dt, box=case.box,
                                                limiter=LIMITER)


def make_advection_step(case: EulerianTGCase):
    def step(s: SimState) -> SimState:
        dt = time_step(case, s.fluid)
        return SimState(fluid=fluid_step(case, s.fluid, dt),
                        time=s.time + dt, n_steps=s.n_steps + 1,
                        overflow=s.overflow)

    return step


def make_run_chunk(case: EulerianTGCase):
    """run_chunk(sim, t_target): steps until sim.time >= t_target."""
    return chunk_runner(make_advection_step(case))


def kinetic_energy(s: SimState) -> float:
    """sum m |v|^2 / 2 in float64 on the host."""
    f = s.fluid
    v2 = (f["Velocity"].double() ** 2).sum(-1)
    return float(0.5 * torch.sum(f["Mass"].double() * v2))


def analytic_kinetic_energy(t: float, ke0: float = 0.25) -> float:
    """KE(0) exp(-16 pi^2 nu t), nu = mu / rho0."""
    return ke0 * math.exp(-16.0 * math.pi ** 2 * MU_F / RHO0_F * t)
