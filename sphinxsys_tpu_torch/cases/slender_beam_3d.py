"""A 3D slender beam (bar) under a ramped distributed load (counterpart of
sphinxsys_tpu/cases/slender_beam_3d.py; reference tests/3d_examples/
test_3d_slender_beam/test_3d_slender_beam.cpp): a 40-particle bar of
length 10 (1 x 1 cross-section), St. Venant-Kirchhoff E = 1.3024653e6,
nu = 0.3, simply supported (the end particles' velocity zeroed each half
step, their rotations free, ConstrainBarBodyRegionAlongAxis:321), loaded
by the uniform acceleration q / (PT rho) - g ramped over t_ramp = 0.1,
with pairwise damping (eta = 200) of Velocity, AngularVelocity and
BinormalAngularVelocity, to end_time = 0.8.  The reference's mid-span
deflection: 1.8687 (+-10%).

    case, sim = build_case(device="cpu")
    sim = make_run_chunk(case)(sim, 0.01)
    print(sim.n_steps, midspan_displacement(case, sim))

As in the JAX package, the time advances by the next step's dt
(time += dt_next after a step of dt).  One host read a step (the loop's
time test).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.materials import SaintVenantKirchhoffSolid
from sphinxsys_tpu_torch.core.state import State
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.neighbors.cell_list import (build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list)
from sphinxsys_tpu_torch.physics import bar as bd
from sphinxsys_tpu_torch.physics import solid as sd
from sphinxsys_tpu_torch.physics.dissipation import damping_pairwise
from sphinxsys_tpu_torch.solver import chunk_runner

PL = 10.0
PT = 1.0
PW = 1.0
N_PART = 40
DX = PL / N_PART
BWD = 1
BW = DX * BWD
RHO0 = 1.0
YOUNGS = 1.3024653e6
POISSON = 0.3
PHYS_VISC = 200.0
Q_LOAD = 100.0 * YOUNGS * 1.0e-4
T_RAMP = 0.1
GRAV = 0.009646
AZ_FULL = Q_LOAD / (PT * RHO0) - GRAV
DISPL_MAX_REFERENCE = 1.8687     # test_3d_slender_beam.cpp:43
DAMPED = ("Velocity", "AngularVelocity", "BinormalAngularVelocity")


class BarSim(NamedTuple):
    bar: State
    time: torch.Tensor
    n_steps: int
    dt: torch.Tensor          # the step's dt (0 before the first)


@dataclasses.dataclass(frozen=True)
class BarCase:
    adaptation: SPHAdaptation
    material: SaintVenantKirchhoffSolid
    rp: sd.ReferencePairs
    nl: NeighborList
    line_kernel: bd.LineKernel
    end_mask: torch.Tensor
    n_bar: int


def build_case(dtype=PRODUCTION_DTYPE, device="cuda"):
    """The bar with its support particles, its frozen pairs on the line
    kernel and the axial B, then one zero-dt step of both halves (which
    registers the stress resultants, as the JAX package's build does).
    Returns (case, sim)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    xs = DX * np.arange(N_PART + 2 * BWD) - BW + DX * 0.5
    pos = np.stack([xs, np.zeros_like(xs), np.zeros_like(xs)], -1)
    material = SaintVenantKirchhoffSolid(rho0=RHO0, youngs_modulus=YOUNGS,
                                         poisson_ratio=POISSON)
    bar = bd.make_bar_state(pos, (0.0, 0.0, 1.0), (0.0, 1.0, 0.0), DX, PT,
                            PW, material, dtype, device)
    adaptation = SPHAdaptation(spacing=DX, dim=3)
    grid = grid_from_bounds((-BW - 4 * DX, -4 * DX, -4 * DX),
                            (PL + BW + 4 * DX, 4 * DX, 4 * DX),
                            adaptation.cutoff)
    n = len(xs)
    p0 = bar["Position"]
    table = build_cell_table(p0, n, grid, 16)
    nl = build_neighbor_list(p0, n, p0, n, table, grid, adaptation.cutoff,
                             k_max=16, include_self=False)
    lk = bd.LineKernel(adaptation.kernel)
    rp = sd.freeze_reference_pairs(p0, nl, lk, 3)
    bar = bd.bar_correct_configuration(bar, rp)
    bar = bd.bar_stress_relaxation_1st_half(bar, rp, material, 0.0,
                                            adaptation.h)
    bar = bd.bar_stress_relaxation_2nd_half(bar, rp, 0.0)
    case = BarCase(adaptation=adaptation, material=material, rp=rp, nl=nl,
                   line_kernel=lk,
                   end_mask=torch.as_tensor((xs < 0.0) | (xs > PL),
                                            device=device),
                   n_bar=n)
    zero = p0.new_zeros(())
    return case, BarSim(bar=bar, time=zero, n_steps=0, dt=zero)


def _constrain_velocity(bar: State, mask) -> State:
    """ConstrainBarBodyRegionAlongAxis::update: the translational velocity
    zeroed (simply supported: the rotations stay free)."""
    out = dict(bar)
    out["Velocity"] = torch.where(mask[:, None],
                                  torch.zeros_like(bar["Velocity"]),
                                  bar["Velocity"])
    return out


def damping(case: BarCase, bar: State, dt) -> State:
    """Pairwise damping of the velocity and both angular velocities."""
    for field in DAMPED:
        bar = damping_pairwise(bar, field, case.nl, case.line_kernel, 3,
                               PHYS_VISC, dt)
    return bar


def _step(case: BarCase, s: BarSim) -> BarSim:
    h = case.adaptation.h
    bar = dict(s.bar)
    # the ramped distributed load (IncreaseToFullGravity)
    az = torch.clamp(s.time / T_RAMP, max=1.0) * AZ_FULL
    fp = torch.zeros_like(bar["Velocity"])
    fp[:, 2] = az * bar["Mass"]
    bar["ForcePrior"] = fp
    bar = bd.bar_stress_relaxation_1st_half(bar, case.rp, case.material,
                                            s.dt, h)
    bar = _constrain_velocity(bar, case.end_mask)
    bar = damping(case, bar, s.dt)
    bar = _constrain_velocity(bar, case.end_mask)
    bar = bd.bar_stress_relaxation_2nd_half(bar, case.rp, s.dt)
    dt_next = bd.bar_acoustic_time_step(bar, case.material, h)
    return BarSim(bar=bar, time=s.time + dt_next, n_steps=s.n_steps + 1,
                  dt=dt_next)


def make_step(case: BarCase):
    return lambda s: _step(case, s)


def make_run_chunk(case: BarCase):
    """run_chunk(sim, t_target): steps until sim.time >= t_target."""
    return chunk_runner(lambda s: _step(case, s))


def midspan_displacement(case: BarCase, s: BarSim) -> float:
    """The observer at (PL/2, 0, 0): the mean z displacement of the two
    centre particles (the lattice straddles x = 5)."""
    x0 = s.bar["InitialPosition"][:, 0].double().cpu().numpy()
    order = np.argsort(np.abs(x0 - 0.5 * PL))[:2]
    dz = (s.bar["Position"][:, 2] - s.bar["InitialPosition"][:, 2]) \
        .double().cpu().numpy()
    return float(dz[order].mean())
