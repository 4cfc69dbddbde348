"""Rotating square patch (counterpart of
sphinxsys_tpu/cases/rotation_patch_2d.py; reference tests/2d_examples/
test_2d_rotation_patch/rotation_patch.cpp): a free 1 x 1 square of weakly
compressible fluid centred at the origin, started in rigid rotation
(omega = 1) with the consistent initial pressure (the double-sine series
that solves the pressure Poisson equation of the rotating square,
rotation_patch.cpp:66-90), and left to deform: its corners are thrown
out into four arms while the kinetic energy stays at 1/12 (the
reference's DB: 0.0830-0.0837 over t = 0..8).

Operations as the reference's (rotation_patch.cpp:147-152): the
spatial-temporal free-surface indication, the alpha = 0.5 kernel
correction, the corrected first half and the plain second half, the
free-stream density summation and the bulk-scoped transport-velocity
correction without a limiter; no wall.  The acoustic loop, the list and
the free-patch state are impact_patch_2d's.

    case, fluid = build_case(dx=LL / 20, device="cpu")
    sim = make_run_chunk(case)(init_sim(case, fluid), 0.05)
    print(kinetic_energy(sim))
"""

from __future__ import annotations

import math

import numpy as np
import torch

# the free patch's case, carry, list, loop and energy, this case's too
from sphinxsys_tpu_torch.cases.impact_patch_2d import (  # noqa: F401
    FreePatchCase, SimState, acoustic_substep, free_patch_state, init_sim,
    kinetic_energy, rebuild_lists, relax_and_rebuild)
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.materials import WeaklyCompressibleFluid
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.neighbors.cell_list import grid_from_bounds
from sphinxsys_tpu_torch.physics import fluid as fd
from sphinxsys_tpu_torch.physics import riemann as rs
from sphinxsys_tpu_torch.solver import chunk_runner

LL = 1.0
OMEGA = 1.0
RHO0_F = 1.0
U_MAX = 1.0
C_F = 10.0 * U_MAX


def _initial_pressure(pos: np.ndarray, n_modes: int = 21) -> np.ndarray:
    """The consistent initial pressure (rotation_patch.cpp:73-86):
    p = sum_{m, n odd} rho (-32 omega^2) / (m n pi^2 ((m pi / L)^2
    + (n pi / L)^2)) sin(m pi x* / L) sin(n pi y* / L), on the host in
    float64."""
    x = pos[:, 0] + LL / 2
    y = pos[:, 1] + LL / 2
    p = np.zeros(len(x))
    for m in range(1, n_modes + 1, 2):
        for n in range(1, n_modes + 1, 2):
            c1 = m * n * math.pi ** 2 * ((m * math.pi / LL) ** 2
                                         + (n * math.pi / LL) ** 2)
            p += (RHO0_F * (-32.0 * OMEGA ** 2) / c1
                  * np.sin(m * math.pi * x / LL)
                  * np.sin(n * math.pi * y / LL))
    return p


def build_case(dx: float = LL / 100.0, dtype=PRODUCTION_DTYPE,
               cell_cap: int = 24, k_inner: int = 48, half_span: float = 2.5,
               device="cuda"):
    """The square in rigid rotation with its consistent pressure and the
    EoS's density for it; the grid covers [-half_span, half_span]^2 (the
    arms stay within ~2 LL over t = 0..8).  Returns (case, fluid)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    xs = np.arange(-LL / 2 + dx / 2, LL / 2, dx)
    pos = np.stack(np.meshgrid(xs, xs, indexing="ij"), -1).reshape(-1, 2)
    vel = np.stack([OMEGA * pos[:, 1], -OMEGA * pos[:, 0]], axis=-1)
    fluid = free_patch_state(pos, vel, dx, dtype, device)
    fluid["Pressure"] = torch.as_tensor(_initial_pressure(pos), dtype=dtype,
                                        device=device)
    # the EoS's density, so that the initial pressure acts
    fluid["Density"] = RHO0_F + fluid["Pressure"] / (C_F * C_F)
    grid = grid_from_bounds((-half_span, -half_span), (half_span, half_span),
                            adaptation.cutoff)
    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    case = FreePatchCase(dx=dx, adaptation=adaptation, grid=grid,
                         eos=eos, riemann=rs.acoustic_riemann(eos),
                         n_fluid=len(pos), cell_cap=cell_cap,
                         k_inner=k_inner)
    return case, fluid


def advection_prep(case: FreePatchCase, s: SimState) -> dict:
    """The spatial-temporal indication, the free-stream density summation,
    the alpha = 0.5 correction matrix and the bulk-scoped
    transport-velocity correction."""
    kernel, h = case.kernel, case.adaptation.h
    fluid = fd.free_surface_indication(s.fluid, s.nl_inner, kernel, 2,
                                       spatial_temporal=True)
    fluid = fd.density_summation_freestream(fluid, s.nl_inner, kernel, 2,
                                            RHO0_F, case.adaptation.sigma0)
    fluid = fd.kernel_correction_matrix(fluid, s.nl_inner, kernel, 2,
                                        alpha=0.5)
    return fd.transport_velocity_correction(
        fluid, s.nl_inner, kernel, 2, h, limiter_slope=None,
        scope_mask=fluid["Indicator"] == 0)


def _advection_step(case: FreePatchCase, s: SimState) -> SimState:
    dt_adv = fd.advection_time_step(s.fluid, case.adaptation.h, U_MAX)
    return relax_and_rebuild(case, s, advection_prep(case, s), dt_adv)


def make_advection_step(case: FreePatchCase):
    return lambda s: _advection_step(case, s)


def make_run_chunk(case: FreePatchCase):
    """run_chunk(sim, t_target): advection steps until sim.time >=
    t_target."""
    return chunk_runner(lambda s: _advection_step(case, s))
