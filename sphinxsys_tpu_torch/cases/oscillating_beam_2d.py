"""2D oscillating beam, the canonical total-Lagrangian solid (counterpart
of sphinxsys_tpu/cases/oscillating_beam_2d.py; reference tests/
2d_examples/test_2d_oscillating_beam/oscillating_beam.cpp): a 0.2 x 0.02
beam with a clamped insert of depth 0.06, dx = PH / 10, St.
Venant-Kirchhoff (rho0 = 1e3, E = 2e6, nu = 0.3975), the first mode's
initial velocity, the tip observer at (PL, 0).  A step: the first half,
the clamp, the second half; the acoustic dt is taken after the step, so
the first step's dt is 0.

`integrator="cauchy"` takes PK1 from the Cauchy stress of the Almansi
strain (Integration1stHalfCauchy, `solid.cauchy_pk1_fn`): the scene of
oscillating_beam_cauchy_2d.  The pairs are frozen at the build; the loop
reads the time once a step.

    case, sim = build_case(device="cpu")                  # 1,612 particles
    sim = make_run_chunk(case)(sim, 0.01)
    print(sim.n_steps, tip_displacement(case, sim))
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sphinxsys_tpu_torch.core import geometry as G
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.generators import generate_lattice
from sphinxsys_tpu_torch.core.materials import SaintVenantKirchhoffSolid
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.neighbors.cell_list import (CellGrid,
                                                    build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import build_neighbor_list
from sphinxsys_tpu_torch.physics import solid as sd
from sphinxsys_tpu_torch.solver import chunk_runner

# oscillating_beam.cpp:14-36
PL = 0.2
PH = 0.02
SL = 0.06
RHO0_S = 1.0e3
YOUNGS = 2.0e6
POISSON = 0.3975

KL = 1.875
_M = math.sin(KL) + math.sinh(KL)
_N = math.cos(KL) + math.cosh(KL)
_Q = 2.0 * (math.cos(KL) * math.sinh(KL) - math.sin(KL) * math.cosh(KL))
VF = 0.05


@dataclasses.dataclass
class BeamSim:
    """The beam, the time and the next step's dt (0-d tensors), the step
    count."""

    solid: dict
    time: torch.Tensor
    n_steps: int
    dt: torch.Tensor


@dataclasses.dataclass(frozen=True)
class BeamCase:
    dx: float
    adaptation: SPHAdaptation
    material: SaintVenantKirchhoffSolid
    rp: sd.ReferencePairs
    base_mask: torch.Tensor     # the clamped particles
    n_solid: int
    grid: CellGrid = None
    integrator: str = "pk2"     # "pk2" | "cauchy"

    @property
    def kernel(self):
        return self.adaptation.kernel


def first_mode_velocity(pos: np.ndarray, c0: float, vf: float = VF):
    """vy of the clamped beam's first mode on x > 0 (BeamInitialCondition,
    oscillating_beam.cpp): vf c0 (M (cos kx - cosh kx) - N (sin kx -
    sinh kx)) / Q, x in units of PL; (n, 2) on the host."""
    x = pos[:, 0] / PL
    vy = np.where(x > 0.0,
                  vf * c0 * (_M * (np.cos(KL * x) - np.cosh(KL * x))
                             - _N * (np.sin(KL * x) - np.sinh(KL * x))) / _Q,
                  0.0)
    vel = np.zeros_like(pos)
    vel[:, 1] = vy
    return vel


def build_case(dx: float | None = None, dtype=PRODUCTION_DTYPE,
               k_inner: int = 64, integrator: str = "pk2", device="cuda"):
    """The beam and its clamp frame on one lattice, frozen pairs and B, the
    clamp (the base minus the beam, createBeamConstrainShape), the first
    mode's velocity.  Returns (case, sim)."""
    if integrator not in ("pk2", "cauchy"):
        raise ValueError(f"integrator={integrator!r}: 'pk2' or 'cauchy'")
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    dx = dx or PH / 10.0
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    bw = dx * 4

    # the base band x in [-SL - BW, 0], the beam x in [-SL, PL]
    # (oscillating_beam.cpp:41-47)
    base_shape = G.Box(G.Transform(translation=(-(SL + bw) / 2, 0.0)),
                       halfsize=((SL + bw) / 2, PH / 2 + bw))
    beam_shape = G.Box(G.Transform(translation=((PL - SL) / 2, 0.0)),
                       halfsize=((PL + SL) / 2, PH / 2))
    body_shape = G.make_complex(("add", base_shape), ("add", beam_shape))
    dom_lo = (-SL - bw, -PL / 2)
    dom_hi = (PL + 3 * bw, PL / 2)
    pos, vol = generate_lattice(body_shape, dom_lo, dom_hi, dx)

    material = SaintVenantKirchhoffSolid(rho0=RHO0_S, youngs_modulus=YOUNGS,
                                         poisson_ratio=POISSON)
    solid = sd.make_elastic_solid_state(pos, vol, material, dtype, device)

    grid = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff)
    p0, n = solid["Position"], solid["NReal"]
    table = build_cell_table(p0, n, grid, 32)
    nl = build_neighbor_list(p0, n, p0, n, table, grid, adaptation.cutoff,
                             k_max=k_inner, include_self=False)
    if bool(nl.overflow):
        raise ValueError("raise k_inner: the frozen pairs must be exact")
    rp = sd.freeze_reference_pairs(p0, nl, adaptation.kernel, 2)
    solid["LinearGradientCorrectionMatrix"] = \
        sd.linear_gradient_correction_matrix(rp, solid["VolumetricMeasure"])

    # the clamp frame: the base minus the beam, tested on the host
    p64 = torch.as_tensor(pos, dtype=torch.float64)
    base_mask = (base_shape.contains(p64)
                 & ~beam_shape.contains(p64)).to(device)
    solid["Velocity"] = torch.as_tensor(
        first_mode_velocity(pos, material.sound_speed), dtype=dtype,
        device=device)

    case = BeamCase(dx=dx, adaptation=adaptation, material=material, rp=rp,
                    base_mask=base_mask, n_solid=len(pos), grid=grid,
                    integrator=integrator)
    zero = torch.zeros((), dtype=dtype, device=device)
    return case, BeamSim(solid=solid, time=zero, n_steps=0, dt=zero.clone())


def _step(case: BeamCase, s: BeamSim) -> BeamSim:
    h = case.adaptation.h
    pk1_fn = sd.cauchy_pk1_fn(case.material) \
        if case.integrator == "cauchy" else None
    solid = sd.integration_1st_half_pk2(s.solid, case.rp, case.material, s.dt,
                                        h, case.kernel.w0(2), pk1_fn=pk1_fn)
    solid = sd.fix_constraint(solid, case.base_mask)
    solid = sd.integration_2nd_half(solid, case.rp, s.dt)
    dt_next = sd.solid_acoustic_time_step(solid, case.material.sound_speed, h)
    return BeamSim(solid=solid, time=s.time + dt_next, n_steps=s.n_steps + 1,
                   dt=dt_next)


def make_step(case: BeamCase):
    return lambda s: _step(case, s)


def make_run_chunk(case: BeamCase):
    """run_chunk(sim, t_target): steps until sim.time >= t_target."""
    return chunk_runner(lambda s: _step(case, s))


def tip_displacement(case, s: BeamSim) -> float:
    """The y-displacement of the particle nearest the tip observer
    (PL, 0)."""
    pos0 = s.solid["InitialPosition"][: case.n_solid].double().cpu().numpy()
    i = int(np.argmin(np.linalg.norm(pos0 - np.asarray([PL, 0.0]), axis=1)))
    return float(s.solid["Position"][i, 1] - s.solid["InitialPosition"][i, 1])
