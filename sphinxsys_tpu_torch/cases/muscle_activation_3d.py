"""3D muscle activation: a prescribed linear active-stress ramp in a
myocardium cube (counterpart of sphinxsys_tpu/cases/muscle_activation_3d.py;
reference tests/3d_examples/test_3d_muscle_activation/src/
muscle_activation.cpp): a unit Muscle cube (a0 = (0.059, ...), b0 =
(8.023, ...), fibre x, bulk 450) with an SL holder at x < 0 held in x only
(FixedInAxisDirection diag(0, 1, 1) zeroes vel_x), activated by
    Ta_i += -0.5 * 30 * x0_i / PL * dt   for t <= 1   (cpp:43-52),
so the fibre stress Ta f f is compressive and strongest at the free end:
the cube elongates in x to t_end = 1.2.  CFL 0.3, as the JAX package's
(0.6 goes unstable near full activation).  The pairs are frozen at the
build; one host read a step.

    case, body = build_case(dx=0.1, device="cpu")          # 1,200 particles
    sim = make_run_chunk(case)(init_sim(case, body), 0.05)
    print(sim.n_steps, free_end_x(sim))
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# the solid block's build, carry and init_sim are the cantilever's
from sphinxsys_tpu_torch.cases.passive_cantilever_3d import (  # noqa: F401
    SimState, frozen_block, init_sim)
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.materials import Muscle
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.physics import solid as sd
from sphinxsys_tpu_torch.solver import chunk_runner

PL = PH = PW = 1.0
DX = PH / 25.0
SL = 4.0 * DX
RHO0 = 1.0
A0 = (0.059, 0.0, 0.0, 0.0)
B0 = (8.023, 0.0, 0.0, 0.0)
REF_VOLTAGE = 30.0
STRESS_FACTOR = -0.5
BULK = 30.0 * REF_VOLTAGE * abs(STRESS_FACTOR)


@dataclasses.dataclass(frozen=True)
class MuscleActivationCase:
    dx: float
    adaptation: SPHAdaptation
    material: Muscle
    rp: sd.ReferencePairs
    holder_mask: torch.Tensor
    n: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = DX, dtype=PRODUCTION_DTYPE, cell_cap: int = 36,
               k_inner: int = 96, device="cuda"):
    """The cube and its holder on one lattice (the holder SL = 4 DX thick
    at any dx, as the JAX package's), frozen pairs and B, Ta = 0 and the
    fibres along f0.  Returns (case, body)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    material = Muscle(rho0=RHO0, bulk_modulus_param=BULK,
                      f0=(1.0, 0.0, 0.0), s0=(0.0, 1.0, 0.0), a0=A0, b0=B0)
    xs = np.arange(-SL + dx / 2, PL, dx)
    ys = np.arange(dx / 2, PH, dx)
    zs = np.arange(dx / 2, PW, dx)
    pos = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), -1).reshape(-1, 3)
    n = len(pos)
    body, rp = frozen_block(pos, dx, material, (-SL - 4 * dx, -SL, -SL),
                            (PL + SL, PH + SL, PW + SL), cell_cap, k_inner,
                            dtype, device)
    body["ActiveContractionStress"] = torch.zeros(n, dtype=dtype,
                                                  device=device)
    body["Fiber"] = torch.as_tensor(material.f0, dtype=dtype,
                                    device=device).expand(n, 3).contiguous()
    case = MuscleActivationCase(
        dx=dx, adaptation=SPHAdaptation(spacing=dx, dim=3),
        material=material, rp=rp,
        holder_mask=torch.as_tensor(pos[:, 0] < 0.0, device=device), n=n)
    return case, body


def _activation(case: MuscleActivationCase, body: dict, t, dt) -> dict:
    """MyocardiumActivation::update (muscle_activation.cpp:43-52): Ta +=
    -0.5 V dt while t <= 1, V = 30 x0 / PL on x0 > 0."""
    x0 = body["InitialPosition"][:, 0]
    zero = torch.zeros_like(x0)
    voltage = torch.where(x0 <= 0.0, zero, REF_VOLTAGE * x0 / PL)
    ramp = torch.where(t <= 1.0, STRESS_FACTOR * voltage * dt, zero)
    return dict(body, ActiveContractionStress=body["ActiveContractionStress"]
                + ramp)


def _fix_x(body: dict, mask: torch.Tensor) -> dict:
    """FixedInAxisDirection diag(0, 1, 1): vel_x = 0 on the holder."""
    vel = body["Velocity"]
    vx = torch.where(mask, torch.zeros_like(vel[:, 0]), vel[:, 0])
    return dict(body, Velocity=torch.cat([vx[:, None], vel[:, 1:]], dim=-1))


def _step(case: MuscleActivationCase, s: SimState) -> SimState:
    body = s.body
    h = case.adaptation.h
    dt = sd.solid_acoustic_time_step(body, case.material.sound_speed, h,
                                     cfl=0.3)
    body = _activation(case, body, s.time, dt)
    body = sd.integration_1st_half_pk2(
        body, case.rp, case.material, dt, h, case.kernel.w0(3),
        active_stress_fn=sd.active_fiber_stress)
    body = _fix_x(body, case.holder_mask)
    body = sd.integration_2nd_half(body, case.rp, dt)
    return SimState(body=body, time=s.time + dt, n_steps=s.n_steps + 1,
                    overflow=s.overflow)


def make_step(case: MuscleActivationCase):
    return lambda s: _step(case, s)


def make_run_chunk(case: MuscleActivationCase):
    """run_chunk(sim, t_target): steps until sim.time >= t_target."""
    return chunk_runner(lambda s: _step(case, s))


def free_end_x(s: SimState) -> float:
    """The mean current x of the initially free face (x0 > max x0 -
    1e-6)."""
    x0 = s.body["InitialPosition"][:, 0]
    face = x0 > torch.max(x0) - 1e-6
    return float(torch.sum(torch.where(face, s.body["Position"][:, 0],
                                       torch.zeros_like(x0)))
                 / torch.sum(face))
