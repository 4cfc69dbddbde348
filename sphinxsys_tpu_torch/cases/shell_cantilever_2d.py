"""2D shell cantilever strip (counterpart of
sphinxsys_tpu/cases/shell_cantilever_2d.py): one row of shell particles
along x with oscillating_beam_2d's material (rho0 = 1e3, E = 2e6,
nu = 0.3975), length 0.2, thickness 0.02, a clamped insert of 0.06 and
the beam's first-mode initial velocity, so that the shell must reproduce
the solid beam's tip oscillation (period ~0.28 s) with ~50x fewer
particles.  A step: the first half, the clamp, the second half; the
acoustic dt is taken after the step (the first step's dt is 0).

    case, sim = build_case(device="cpu")                  # 53 particles
    sim = make_run_chunk(case)(sim, 0.01)
    print(sim.n_steps, tip_displacement(case, sim))
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.materials import SaintVenantKirchhoffSolid
from sphinxsys_tpu_torch.core.state import State
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.neighbors.cell_list import (build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import build_neighbor_list
from sphinxsys_tpu_torch.physics import shell as sh
from sphinxsys_tpu_torch.physics import solid as sd
from sphinxsys_tpu_torch.solver import chunk_runner

PL = 0.2    # the cantilever's length
SL = 0.06   # the clamped insert
PH = 0.02   # the thickness
RHO0 = 1.0e3
YOUNGS = 2.0e6
POISSON = 0.3975

KL = 1.875
_M = math.sin(KL) + math.sinh(KL)
_N = math.cos(KL) + math.cosh(KL)
_Q = 2.0 * (math.cos(KL) * math.sinh(KL) - math.sin(KL) * math.cosh(KL))
VF = 0.05


@dataclasses.dataclass
class ShellSim:
    """The shell, the time, the step count, the next step's dt."""

    shell: State
    time: torch.Tensor
    n_steps: int
    dt: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ShellCase:
    dx: float
    adaptation: SPHAdaptation
    material: SaintVenantKirchhoffSolid
    rp: sd.ReferencePairs
    base_mask: torch.Tensor
    n_shell: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def first_mode(x: np.ndarray, c0: float) -> np.ndarray:
    """The clamped beam's first-mode speed at x / PL > 0
    (oscillating_beam.cpp's initial condition), 0 elsewhere."""
    return np.where(x > 0.0,
                    VF * c0 * (_M * (np.cos(KL * x) - np.cosh(KL * x))
                               - _N * (np.sin(KL * x) - np.sinh(KL * x)))
                    / _Q, 0.0)


def build_case(dx: float = PL / 40.0, dtype=PRODUCTION_DTYPE, device="cuda"):
    """The strip, its frozen pairs on the reduced kernel and B, the clamp
    x <= 0, the first mode's velocity.  Returns (case, sim)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    xs = np.arange(-SL, PL + dx / 2, dx)
    pos = np.stack([xs, np.zeros_like(xs)], -1)
    normal = np.tile(np.asarray([0.0, 1.0]), (len(xs), 1))
    material = SaintVenantKirchhoffSolid(rho0=RHO0, youngs_modulus=YOUNGS,
                                         poisson_ratio=POISSON)
    shell = sh.make_shell_state(pos, normal, dx, PH, material, dtype, device)

    grid = grid_from_bounds((-SL - 0.05, -0.1), (PL + 0.05, 0.1),
                            adaptation.cutoff)
    n = len(xs)
    p0 = shell["Position"]
    table = build_cell_table(p0, n, grid, 16)
    nl = build_neighbor_list(p0, n, p0, n, table, grid, adaptation.cutoff,
                             k_max=16, include_self=False)
    rp = sd.freeze_reference_pairs(p0, nl, sh.ReducedKernel(adaptation.kernel),
                                   2)
    shell = sh.shell_correct_configuration(shell, rp)

    vel = np.zeros_like(pos)
    vel[:, 1] = first_mode(xs / PL, material.sound_speed)
    shell["Velocity"] = torch.as_tensor(vel, dtype=dtype, device=device)
    case = ShellCase(dx=dx, adaptation=adaptation, material=material, rp=rp,
                     base_mask=torch.as_tensor(xs <= 0.0, device=device),
                     n_shell=n)
    zero = p0.new_zeros(())
    return case, ShellSim(shell=shell, time=zero, n_steps=0, dt=zero.clone())


def _step(case: ShellCase, s: ShellSim) -> ShellSim:
    h = case.adaptation.h
    shell = sh.shell_stress_relaxation_1st_half(s.shell, case.rp,
                                                case.material, s.dt, h)
    shell = sh.fix_shell(shell, case.base_mask)
    shell = sh.shell_stress_relaxation_2nd_half(shell, case.rp, s.dt)
    dt_next = sh.shell_acoustic_time_step(shell, case.material, h)
    return ShellSim(shell=shell, time=s.time + dt_next,
                    n_steps=s.n_steps + 1, dt=dt_next)


def make_step(case: ShellCase):
    return lambda s: _step(case, s)


def make_run_chunk(case: ShellCase):
    """run_chunk(sim, t_target): steps until sim.time >= t_target (one
    host read a step)."""
    return chunk_runner(make_step(case))


def tip_displacement(case: ShellCase, s: ShellSim) -> float:
    i = case.n_shell - 1
    return float(s.shell["Position"][i, 1] - s.shell["InitialPosition"][i, 1])
