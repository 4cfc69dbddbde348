"""2D oscillating beam, updated-Lagrangian with generalized hourglass
control (counterpart of sphinxsys_tpu/cases/oscillating_beam_ul_2d.py;
reference tests/2d_examples/test_2d_oscillating_beam_UL/
oscillating_beam_UL.cpp): oscillating_beam_2d's first-mode-kicked
cantilever (0.2 x 0.02, clamp depth 0.06, dx = PH / 10, rho0 = 1e3,
E = 2e6, nu = 0.3975) integrated on the current configuration.  The WCSPH
pressure and density halves carry the volumetric part (the linear EoS),
the deviatoric shear stress evolves with a Jaumann rate, and the
co-rotating pair-velocity penalty holds the zero-energy modes.

An advection step (oscillating_beam_UL.cpp:179-210): the volume update,
the inner list, the correction matrix on the current configuration, the
advection dt (CFL 0.2); then acoustic sub-steps (CFL 0.4) of pressure
relaxation with the shear force -> the clamp -> shear stress -> shear
acceleration -> density relaxation until they span it.  Both loops are
host loops, one host read of each condition.  `ul_prep`,
`inner_relation` and `ul_substep` serve the spinning plate and the Taylor
bar too.

    case, beam = build_case(device="cpu")                 # 1,612 particles
    sim = make_run_chunk(case)(init_sim(case, beam), 0.002)
    print(sim.n_steps, sim.n_ac, kinetic_energy(sim))
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.materials import WeaklyCompressibleFluid
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.neighbors.cell_list import (CellGrid,
                                                    build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import build_neighbor_list
from sphinxsys_tpu_torch.physics import continuum as cn
from sphinxsys_tpu_torch.physics import fluid as fd
from sphinxsys_tpu_torch.physics import riemann as rs
from sphinxsys_tpu_torch.physics import solid as sd
from sphinxsys_tpu_torch.solver import chunk_runner

PL = 0.2
PH = 0.02
SL = 0.06
DX = PH / 10.0
BW = 4 * DX
RHO0 = 1.0e3
YOUNGS = 2.0e6
POISSON = 0.3975
C0 = math.sqrt(YOUNGS / (3.0 * (1.0 - 2.0 * POISSON) * RHO0))
KL = 1.875
_M = math.sin(KL) + math.sinh(KL)
_N = math.cos(KL) + math.cosh(KL)
_Q = 2.0 * (math.cos(KL) * math.sinh(KL) - math.sin(KL) * math.cosh(KL))
VF = 0.05
U_REF = abs(VF * C0 * (_M * (math.cos(KL) - math.cosh(KL))
                       - _N * (math.sin(KL) - math.sinh(KL))) / _Q)


@dataclasses.dataclass
class SimState:
    """The beam, the time (0-d tensor), the advection and acoustic step
    counts, the overflow flag."""

    beam: dict
    time: torch.Tensor
    n_steps: int
    overflow: torch.Tensor
    n_ac: int = 0


@dataclasses.dataclass(frozen=True)
class ULBeamCase:
    dx: float
    adaptation: SPHAdaptation
    grid: CellGrid
    material: cn.GeneralContinuum
    eos: WeaklyCompressibleFluid
    riemann_p: Any
    riemann_rho: Any
    base_mask: torch.Tensor
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
    """The clamp frame [-SL - BW, 0] x [-PH/2 - BW, PH/2 + BW] and the beam
    [-SL, PL] x [-PH/2, PH/2] on one lattice, the first mode's velocity on
    x > 0, the clamp (the frame less the beam's strip).  Returns (case,
    beam)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    material = cn.GeneralContinuum(rho0=RHO0, c0=C0, youngs_modulus=YOUNGS,
                                   poisson_ratio=POISSON)
    eos = WeaklyCompressibleFluid(rho0=RHO0, c0=C0)

    pts = []
    for x in np.arange(-SL - BW + dx / 2, PL, dx):
        if x < 0.0:
            ys = np.arange(-PH / 2 - BW + dx / 2, PH / 2 + BW, dx)
        else:
            ys = np.arange(-PH / 2 + dx / 2, PH / 2, dx)
        pts.extend((x, y) for y in ys if x < 0.0 or abs(y) < PH / 2)
    pos = np.asarray(pts)

    beam = cn.make_ul_solid_state(pos, dx * dx, material, dtype, device)
    beam["InitialPosition"] = beam["Position"]
    x = pos[:, 0] / PL
    vel = np.zeros_like(pos)
    vel[:, 1] = np.where(
        x > 0.0, VF * C0 / _Q * (_M * (np.cos(KL * x) - np.cosh(KL * x))
                                 - _N * (np.sin(KL * x) - np.sinh(KL * x))),
        0.0)
    beam["Velocity"] = torch.as_tensor(vel, dtype=dtype, device=device)
    base_mask = torch.as_tensor(
        (pos[:, 0] < 0.0) & ((pos[:, 0] < -SL) | (np.abs(pos[:, 1]) > PH / 2)),
        device=device)

    grid = grid_from_bounds((-SL - BW - 4 * dx, -0.7 * PL), (1.1 * PL, 0.7 * PL),
                            adaptation.cutoff)
    case = ULBeamCase(dx=dx, adaptation=adaptation, grid=grid,
                      material=material, eos=eos,
                      riemann_p=rs.no_riemann(eos),
                      riemann_rho=rs.dissipative_riemann(eos),
                      base_mask=base_mask, n=len(pos), cell_cap=cell_cap,
                      k_inner=k_inner)
    return case, beam


def init_sim(case: ULBeamCase, beam: dict) -> SimState:
    pos = beam["Position"]
    return SimState(beam=dict(beam),
                    time=torch.zeros((), dtype=pos.dtype, device=pos.device),
                    n_steps=0, overflow=torch.zeros((), dtype=torch.bool,
                                                    device=pos.device))


def inner_relation(case, body: dict):
    """The body's cell table and inner list."""
    pos, n = body["Position"], body["NReal"]
    table = build_cell_table(pos, n, case.grid, case.cell_cap)
    return build_neighbor_list(pos, n, pos, n, table, case.grid,
                               case.adaptation.cutoff, k_max=case.k_inner,
                               include_self=False)


def ul_prep(case, body: dict):
    """The advection step's prep: Vol = m / rho, the inner list, B on the
    current configuration (alpha = 0).  Returns (body, list)."""
    body = cn.volume_update(body)
    nl = inner_relation(case, body)
    return cn.correction_matrix_current(body, nl, case.kernel, case.dim,
                                        alpha=0.0), nl


def ul_substep(case, body: dict, nl, dt, fix=None, plasticity=None) -> dict:
    """Pressure relaxation with the shear force folded in, the clamp where
    `fix` is a mask, the shear stress (J2 where `plasticity`), the shear
    acceleration, the density relaxation."""
    kernel, dim = case.kernel, case.dim
    body = fd.acoustic_step_1st_half(body, nl, kernel, dim, case.eos,
                                     case.riemann_p, dt,
                                     extra_force=cn.ul_shear_force(body))
    if fix is not None:
        body = sd.fix_constraint(body, fix)
    body = cn.shear_stress_hourglass_1st_half(body, nl, kernel, dim,
                                              case.material, dt,
                                              plasticity=plasticity)
    body = cn.shear_acceleration_hourglass_2nd_half(body, nl, kernel, dim,
                                                    case.material, dt)
    return fd.acoustic_step_2nd_half(body, nl, kernel, dim, case.riemann_rho,
                                     dt)


def acoustic_substep(case: ULBeamCase, beam: dict, nl):
    """One sub-step at the acoustic dt (CFL 0.4).  Returns (beam, dt)."""
    dt = fd.acoustic_time_step(beam, case.eos, case.adaptation.h, cfl=0.4)
    return ul_substep(case, beam, nl, dt, fix=case.base_mask), dt


def _advection_step(case: ULBeamCase, s: SimState) -> SimState:
    beam, nl = ul_prep(case, s.beam)
    adv_dt = fd.advection_time_step(beam, case.adaptation.h, U_REF, cfl=0.2)
    t_rel = torch.zeros_like(adv_dt)
    n_ac = 0
    while bool(t_rel < adv_dt):            # one host read per sub-step
        beam, dt = acoustic_substep(case, beam, nl)
        t_rel = t_rel + dt
        n_ac += 1
    return SimState(beam=beam, time=s.time + t_rel, n_steps=s.n_steps + 1,
                    overflow=s.overflow | nl.overflow, n_ac=s.n_ac + n_ac)


def make_advection_step(case: ULBeamCase):
    return lambda s: _advection_step(case, s)


def make_run_chunk(case: ULBeamCase):
    """run_chunk(sim, t_target): advection steps until sim.time >=
    t_target."""
    return chunk_runner(make_advection_step(case))


def tip_observer(case: ULBeamCase, beam: dict):
    """The frozen-weight observer at (PL, 0) (oscillating_beam_UL.cpp:52):
    (row indices, normalised W V weights) on the beam's device."""
    dtype, dev = beam["Position"].dtype, beam["Position"].device
    pos0 = beam["InitialPosition"].cpu().numpy()
    r = np.linalg.norm(pos0 - np.asarray([PL, 0.0]), axis=1)
    idx = np.nonzero(r < case.adaptation.cutoff)[0]
    w = np.asarray([float(case.kernel.W(torch.as_tensor(ri, dtype=dtype), 2))
                    for ri in r[idx]])
    w = w * beam["VolumetricMeasure"].cpu().numpy()[idx]
    return (torch.as_tensor(idx, device=dev),
            torch.as_tensor(w / (w.sum() + 1e-15), dtype=dtype, device=dev))


def observe_tip(s: SimState, idx, weights) -> np.ndarray:
    return torch.sum(s.beam["Position"][idx] * weights[:, None],
                     dim=0).cpu().numpy()


def kinetic_energy_of(body: dict) -> float:
    """TotalKineticEnergy over the rows below NReal."""
    n = body["Position"].shape[0]
    valid = torch.arange(n, device=body["Position"].device) < body["NReal"]
    ke = 0.5 * body["Mass"] * torch.sum(body["Velocity"] ** 2, dim=-1)
    return float(torch.sum(torch.where(valid, ke, torch.zeros_like(ke))))


def kinetic_energy(s: SimState) -> float:
    """TotalKineticEnergy (the reference's DTW-regressed quantity)."""
    return kinetic_energy_of(s.beam)
