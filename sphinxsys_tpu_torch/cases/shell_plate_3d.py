"""3D shell plate cantilever (counterpart of
sphinxsys_tpu/cases/shell_plate_3d.py): a 0.26 x 0.06 strip of shell
particles in the z = 0 plane (normal +z), clamped at x <= 0, given the
first-mode beam velocity in z.  With nu = 0 cylindrical bending is
Euler-Bernoulli beam theory, so the tip oscillates with
omega = (1.875 / L)^2 sqrt(E t^2 / (12 rho)) (T ~ 0.277 s); the case runs
the two-angle rotation algebra (thin_structure_math.cpp, Vec3d).

    case, sim = build_case(device="cpu")                  # 189 particles
    sim = make_run_chunk(case)(sim, 0.01)
    print(sim.n_steps, tip_displacement(case, sim))
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sphinxsys_tpu_torch.cases.shell_cantilever_2d import KL, ShellSim, \
    first_mode
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.materials import SaintVenantKirchhoffSolid
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.neighbors.cell_list import (build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import build_neighbor_list
from sphinxsys_tpu_torch.physics import shell as sh
from sphinxsys_tpu_torch.physics import solid as sd
from sphinxsys_tpu_torch.solver import chunk_runner

PL = 0.2    # the cantilever's length (x)
SL = 0.06   # the clamped insert
PW = 0.06   # the strip's width (y)
PH = 0.02   # the thickness
RHO0 = 1.0e3
YOUNGS = 2.0e6
POISSON = 0.0   # nu = 0: cylindrical bending is beam theory


@dataclasses.dataclass(frozen=True)
class PlateCase:
    dx: float
    adaptation: SPHAdaptation
    material: SaintVenantKirchhoffSolid
    rp: sd.ReferencePairs
    base_mask: torch.Tensor
    tip_mask: torch.Tensor
    n_shell: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def theoretical_period():
    return 2.0 * math.pi / ((KL / PL) ** 2
                            * math.sqrt(YOUNGS * PH * PH / (12.0 * RHO0)))


def build_case(dx: float = PL / 20.0, dtype=PRODUCTION_DTYPE, device="cuda"):
    """The plate, its frozen pairs on the reduced kernel and B, the clamp
    x <= 0, the tip row, the first mode's velocity in z.  Returns
    (case, sim)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    adaptation = SPHAdaptation(spacing=dx, dim=3)
    xs = np.arange(-SL, PL + dx / 2, dx)
    ys = np.arange(0.0, PW + dx / 2, dx)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    pos = np.stack([X.ravel(), Y.ravel(), np.zeros(X.size)], -1)
    normal = np.tile(np.asarray([0.0, 0.0, 1.0]), (len(pos), 1))
    material = SaintVenantKirchhoffSolid(rho0=RHO0, youngs_modulus=YOUNGS,
                                         poisson_ratio=POISSON)
    shell = sh.make_shell_state(pos, normal, dx, PH, material, dtype, device)

    grid = grid_from_bounds((-SL - 0.05, -0.05, -0.05),
                            (PL + 0.05, PW + 0.05, 0.05), adaptation.cutoff)
    n = len(pos)
    p0 = shell["Position"]
    table = build_cell_table(p0, n, grid, 32)
    nl = build_neighbor_list(p0, n, p0, n, table, grid, adaptation.cutoff,
                             k_max=32, include_self=False)
    rp = sd.freeze_reference_pairs(p0, nl, sh.ReducedKernel(adaptation.kernel),
                                   3)
    shell = sh.shell_correct_configuration(shell, rp)

    vel = np.zeros_like(pos)
    vel[:, 2] = first_mode(pos[:, 0] / PL, material.sound_speed)
    shell["Velocity"] = torch.as_tensor(vel, dtype=dtype, device=device)
    case = PlateCase(
        dx=dx, adaptation=adaptation, material=material, rp=rp,
        base_mask=torch.as_tensor(pos[:, 0] <= 0.0, device=device),
        tip_mask=torch.as_tensor(pos[:, 0] > PL - dx / 2, device=device),
        n_shell=n)
    zero = p0.new_zeros(())
    return case, ShellSim(shell=shell, time=zero, n_steps=0, dt=zero.clone())


def _step(case: PlateCase, s: ShellSim) -> ShellSim:
    h = case.adaptation.h
    shell = sh.shell_stress_relaxation_1st_half(s.shell, case.rp,
                                                case.material, s.dt, h)
    shell = sh.fix_shell(shell, case.base_mask)
    shell = sh.shell_stress_relaxation_2nd_half(shell, case.rp, s.dt)
    dt_next = sh.shell_acoustic_time_step(shell, case.material, h)
    return ShellSim(shell=shell, time=s.time + dt_next,
                    n_steps=s.n_steps + 1, dt=dt_next)


def make_step(case: PlateCase):
    return lambda s: _step(case, s)


def make_run_chunk(case: PlateCase):
    """run_chunk(sim, t_target): steps until sim.time >= t_target."""
    return chunk_runner(make_step(case))


def tip_displacement(case: PlateCase, s: ShellSim) -> float:
    """The tip row's mean z-displacement."""
    dz = s.shell["Position"][:, 2] - s.shell["InitialPosition"][:, 2]
    return float(dz[case.tip_mask].mean())
