"""A half-sphere shell's stability under tangential gravity (counterpart
of sphinxsys_tpu/cases/shell_stability_half_sphere_3d.py; reference
tests/3d_examples/test_3d_shell_stability_half_sphere): a hemispherical
shell (R = 50 mm, thickness 1 mm, St. Venant-Kirchhoff rho = 1e3 kg/m^3,
E = 5e7 Pa, nu = 0.3, in mm units rho = 1e-6, E = 50), its equator edge
(z < 0.67 dp) held, under gravity -9.8066 / 1e-3 along x, with velocity
and rotation projection damping.  A stability gate: to t = 0.5 with a
bounded displacement, no NaN and no collapse of the time step.

The positions are the JAX package's in-framework generator: Fibonacci
hemisphere seeds and the tangential CVT relaxation (core/surface_cvt.py,
200 sweeps), which holds the reference's initialisation gates (minimum
pair distance > dp / 2; the total area).  3,927 particles at dp = 2,
float64 by default.

    case, sim = build_case(device="cpu", cvt_iters=20)
    sim = make_run_chunk(case)(sim, 1e-4)
    print(sim.n_steps, max_displacement(sim))
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.materials import SaintVenantKirchhoffSolid
from sphinxsys_tpu_torch.core.state import State
from sphinxsys_tpu_torch.core.surface_cvt import (cvt_relax_on_surface,
                                                  fibonacci_sphere,
                                                  sphere_projector)
from sphinxsys_tpu_torch.device import resolve_device, resolve_dtype
from sphinxsys_tpu_torch.neighbors.cell_list import (build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list)
from sphinxsys_tpu_torch.physics import dissipation as dpp
from sphinxsys_tpu_torch.physics import shell as sh
from sphinxsys_tpu_torch.physics import solid as sd
from sphinxsys_tpu_torch.solver import chunk_runner

UNIT_MM = 1e-3
RADIUS = 50.0
THICKNESS = 1.0
RHO0 = 1.0e3 * UNIT_MM ** 3
YOUNGS = 5.0e7 * UNIT_MM ** 2
POISSON = 0.3
GRAVITY_X = -9.8066 / UNIT_MM
END_TIME = 0.5


def physical_viscosity(shape_constant: float = 0.4) -> float:
    """get_physical_viscosity_general (cpp:96-103): beta / 4 sqrt(rho E) L."""
    return shape_constant / 4.0 * math.sqrt(RHO0 * YOUNGS) * THICKNESS


@dataclasses.dataclass
class SphereSim:
    shell: State
    time: torch.Tensor
    n_steps: int
    dt: torch.Tensor
    max_dt: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SphereCase:
    dp: float
    adaptation: SPHAdaptation
    material: SaintVenantKirchhoffSolid
    rp: sd.ReferencePairs
    nl: NeighborList
    edge_mask: torch.Tensor
    n_shell: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def generate_particles(dp: float, cvt_iters: int, dtype, device):
    """The hemisphere's CVT-relaxed positions and normals (numpy) and the
    per-particle area total_area / n."""
    total_area = 0.5 * 4.0 * math.pi * RADIUS * RADIUS
    n = int(round(total_area / dp ** 2))
    seeds = fibonacci_sphere(n, RADIUS, hemisphere=True)
    pos, normals = cvt_relax_on_surface(
        seeds, sphere_projector(RADIUS, hemisphere=True), dp,
        n_iter=cvt_iters, dtype=dtype, device=device)
    return pos, normals, total_area / n


def build_case(dp_ratio: float = 2.0, dtype=torch.float64, cvt_iters: int = 200,
               device="cuda", particles=None):
    """The CVT hemisphere, its frozen pairs on the reduced kernel and B, the
    held equator (z < 0.67 dp).  `particles` = (pos, normals, area) skips
    the generator (a parity test carries another package's positions
    across).  Returns (case, sim), dt 1e-6 before the first step."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    dp = dp_ratio * THICKNESS
    if particles is None:
        particles = generate_particles(dp, cvt_iters, dtype, device)
    pos, normals, particle_area = particles
    n = len(pos)
    adaptation = SPHAdaptation(spacing=dp, dim=3)
    material = SaintVenantKirchhoffSolid(rho0=RHO0, youngs_modulus=YOUNGS,
                                         poisson_ratio=POISSON)
    shell = sh.make_shell_state(pos, normals, dp, THICKNESS, material, dtype,
                                device, volume=particle_area)
    cutoff = adaptation.cutoff
    pad = 5 * dp
    grid = grid_from_bounds((-RADIUS - pad,) * 3, (RADIUS + pad,) * 3, cutoff)
    p0 = shell["Position"]
    table = build_cell_table(p0, n, grid, 32)
    nl = build_neighbor_list(p0, n, p0, n, table, grid, cutoff, k_max=48,
                             include_self=False)
    if bool(nl.overflow):
        raise ValueError("half sphere: the frozen pairs overflow k_max")
    rp = sd.freeze_reference_pairs(p0, nl, sh.ReducedKernel(adaptation.kernel),
                                   3)
    shell = sh.shell_correct_configuration(shell, rp)
    case = SphereCase(dp=dp, adaptation=adaptation, material=material, rp=rp,
                      nl=nl, edge_mask=torch.as_tensor(
                          np.asarray(pos)[:, 2] < 0.67 * dp, device=device),
                      n_shell=n)
    return case, SphereSim(shell=shell, time=p0.new_zeros(()), n_steps=0,
                           dt=p0.new_tensor(1e-6), max_dt=p0.new_zeros(()))


def _constrain(shell: State, mask) -> State:
    """ConstrainShellBodyRegion: the velocity and angular velocity 0."""
    out = dict(shell)
    for k in ("Velocity", "AngularVelocity"):
        out[k] = torch.where(mask[:, None], torch.zeros_like(shell[k]),
                             shell[k])
    return out


def damping(case: SphereCase, shell: State, dt) -> State:
    """Projection damping of the velocity and the angular velocity at the
    expected rate of DampingWithRandomChoice(0.2)."""
    eta = physical_viscosity() / 0.2
    for field in ("Velocity", "AngularVelocity"):
        shell = dpp.damping_projection(shell, field, case.nl, case.kernel, 3,
                                       eta, dt)
    return shell


def _step(case: SphereCase, s: SphereSim) -> SphereSim:
    h = case.adaptation.h
    dt = s.dt
    shell = dict(s.shell)
    gx = shell["Mass"] * GRAVITY_X
    shell["ForcePrior"] = torch.stack(
        [gx, torch.zeros_like(gx), torch.zeros_like(gx)], dim=-1)
    shell = sh.shell_stress_relaxation_1st_half(shell, case.rp, case.material,
                                                dt, h)
    shell = _constrain(shell, case.edge_mask)
    shell = damping(case, shell, dt)
    shell = _constrain(shell, case.edge_mask)
    shell = sh.shell_stress_relaxation_2nd_half(shell, case.rp, dt)
    dt_next = sh.shell_acoustic_time_step(shell, case.material, h)
    return SphereSim(shell=shell, time=s.time + dt, n_steps=s.n_steps + 1,
                     dt=dt_next, max_dt=torch.maximum(s.max_dt, dt_next))


def make_step(case: SphereCase):
    return lambda s: _step(case, s)


def make_run_chunk(case: SphereCase):
    """run_chunk(sim, t_target): steps until sim.time >= t_target."""
    return chunk_runner(make_step(case))


def max_displacement(s: SphereSim) -> float:
    """VariableNorm<Vecd, ReduceMax> of the displacement (cpp:185)."""
    d = s.shell["Position"] - s.shell["InitialPosition"]
    return float(torch.linalg.vector_norm(d, dim=1).max())
