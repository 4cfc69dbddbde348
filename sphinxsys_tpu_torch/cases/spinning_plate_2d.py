"""Spinning square plate, the updated-Lagrangian solid's tensile-instability
and angular-momentum test (counterpart of
sphinxsys_tpu/cases/spinning_plate_2d.py; reference tests/2d_examples/
test_2d_spinning_plate/spinning_plate.cpp): a free 1 x 1 GeneralContinuum
square (rho0 = 1100, E = 1.7e7, nu = 0.45, dx = 0.05) given the rigid
rotation omega_0 = -50 rad/s spins for t = 0.5.  Without the hourglass
control the tensile instability tears it apart; with it the kinetic
energy stays near its lattice value 228593.75.

The reference's initial condition takes angle = atan2(x, y) and sets v =
(omega y, -omega x).  The loop is oscillating_beam_ul_2d's (`ul_prep`,
`ul_substep`) without a clamp, at the acoustic CFL 0.1 (cpp:109).

    case, plate = build_case(dx=0.1, device="cpu")
    sim = make_run_chunk(case)(init_sim(case, plate), 0.002)
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from sphinxsys_tpu_torch.cases import oscillating_beam_ul_2d as ob
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.materials import WeaklyCompressibleFluid
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.neighbors.cell_list import CellGrid, grid_from_bounds
from sphinxsys_tpu_torch.physics import continuum as cn
from sphinxsys_tpu_torch.physics import fluid as fd
from sphinxsys_tpu_torch.physics import riemann as rs
from sphinxsys_tpu_torch.solver import chunk_runner

PL = 1.0
DX = PL / 20.0
RHO0 = 1.1e3
YOUNGS = 1.7e7
POISSON = 0.45
C0 = float(np.sqrt(YOUNGS / (3.0 * (1.0 - 2.0 * POISSON) * RHO0)))
ANGULAR_0 = -50.0
U_REF = float(abs(ANGULAR_0) * 0.5 * np.sqrt(2.0))


@dataclasses.dataclass
class SimState:
    """The plate, the time (0-d tensor), the advection and acoustic step
    counts, the overflow flag."""

    plate: dict
    time: torch.Tensor
    n_steps: int
    overflow: torch.Tensor
    n_ac: int = 0


@dataclasses.dataclass(frozen=True)
class SpinCase:
    dx: float
    adaptation: SPHAdaptation
    grid: CellGrid
    material: Any
    eos: Any
    riemann_p: Any
    riemann_rho: Any
    n: int
    cell_cap: int
    k_inner: int

    @property
    def kernel(self):
        return self.adaptation.kernel

    @property
    def dim(self) -> int:
        return self.adaptation.dim


def build_case(dx: float = DX, dtype=PRODUCTION_DTYPE, cell_cap: int = 16,
               k_inner: int = 32, device="cuda"):
    """The square lattice about the origin, spinning.  Returns (case,
    plate)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    material = cn.GeneralContinuum(rho0=RHO0, c0=C0, youngs_modulus=YOUNGS,
                                   poisson_ratio=POISSON)
    eos = WeaklyCompressibleFluid(rho0=RHO0, c0=C0)
    xs = np.arange(-PL / 2 + dx / 2, PL / 2, dx)
    pos = np.stack(np.meshgrid(xs, xs, indexing="ij"), -1).reshape(-1, 2)
    plate = cn.make_ul_solid_state(pos, dx * dx, material, dtype, device)
    vel = np.stack([ANGULAR_0 * pos[:, 1], -ANGULAR_0 * pos[:, 0]], axis=-1)
    plate["Velocity"] = torch.as_tensor(vel, dtype=dtype, device=device)
    grid = grid_from_bounds((-PL, -PL), (PL, PL), adaptation.cutoff)
    case = SpinCase(dx=dx, adaptation=adaptation, grid=grid,
                    material=material, eos=eos,
                    riemann_p=rs.no_riemann(eos),
                    riemann_rho=rs.dissipative_riemann(eos), n=len(pos),
                    cell_cap=cell_cap, k_inner=k_inner)
    return case, plate


def init_sim(case: SpinCase, plate: dict) -> SimState:
    pos = plate["Position"]
    return SimState(plate=dict(plate),
                    time=torch.zeros((), dtype=pos.dtype, device=pos.device),
                    n_steps=0, overflow=torch.zeros((), dtype=torch.bool,
                                                    device=pos.device))


def acoustic_substep(case: SpinCase, plate: dict, nl):
    """One sub-step at the acoustic dt of CFL 0.1.  Returns (plate, dt)."""
    dt = fd.acoustic_time_step(plate, case.eos, case.adaptation.h, cfl=0.1)
    return ob.ul_substep(case, plate, nl, dt), dt


def _advection_step(case: SpinCase, s: SimState) -> SimState:
    plate, nl = ob.ul_prep(case, s.plate)
    adv_dt = fd.advection_time_step(plate, case.adaptation.h, U_REF, cfl=0.2)
    t_rel = torch.zeros_like(adv_dt)
    n_ac = 0
    while bool(t_rel < adv_dt):            # one host read per sub-step
        plate, dt = acoustic_substep(case, plate, nl)
        t_rel = t_rel + dt
        n_ac += 1
    return SimState(plate=plate, time=s.time + t_rel, n_steps=s.n_steps + 1,
                    overflow=s.overflow | nl.overflow, n_ac=s.n_ac + n_ac)


def make_advection_step(case: SpinCase):
    return lambda s: _advection_step(case, s)


def make_run_chunk(case: SpinCase):
    """run_chunk(sim, t_target): advection steps until sim.time >=
    t_target."""
    return chunk_runner(make_advection_step(case))


def kinetic_energy(s: SimState) -> float:
    """ReducedQuantityRecording<TotalKineticEnergy>."""
    p = s.plate
    return float(torch.sum(0.5 * p["Mass"]
                           * torch.sum(p["Velocity"] ** 2, dim=-1)))
