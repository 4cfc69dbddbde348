"""A 3D Neo-Hookean cantilever sagging under gravity with physical damping
(counterpart of sphinxsys_tpu/cases/passive_cantilever_neohookean_3d.py;
reference tests/3d_examples/test_3d_passive_cantilever_neohookean/
passive_cantilever_neohookean.cpp): a 0.1 x 0.04 x 0.04 block (rho 1265,
E 5e4, nu 0.45) clamped by an SL = 0.02 holder at x < 0, dropped into
full gravity (0, -9.8, 0) at t = 0, with pairwise damping of its velocity
(eta = 50, every step).  The corner observer at (PL, PH, PW) falls to
y ~ -0.00117 near t = 0.17 and settles near 0.00382 by t = 1 in the
reference's database.

    case, body = build_case(dx=0.01, device="cpu")
    sim = make_run_chunk(case)(init_sim(case, body), 0.01)
    print(observe_corner(sim, *corner_observer(case, body)))

The pairs are frozen at the build, the damping walks the same list; one
host read a step (the loop's time test).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sphinxsys_tpu_torch.cases.passive_cantilever_3d import (  # noqa: F401
    corner_observer as _corner_observer, frozen_block, observe_corner)
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.materials import NeoHookeanSolid
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.neighbors.neighbor_list import NeighborList
from sphinxsys_tpu_torch.physics import dissipation as dp
from sphinxsys_tpu_torch.physics import solid as sd
from sphinxsys_tpu_torch.solver import chunk_runner

PL, PH, PW = 0.1, 0.04, 0.04
SL = 0.02
DX = PH / 6.0
RHO0 = 1265.0
POISSON = 0.45
YOUNGS = 5.0e4
ETA = 50.0                       # physical_viscosity
GRAVITY = (0.0, -9.8, 0.0)
OBSERVER = (PL, PH, PW)


@dataclasses.dataclass
class SimState:
    body: dict
    time: torch.Tensor
    n_steps: int
    overflow: torch.Tensor


@dataclasses.dataclass(frozen=True)
class NeoHookeanCantileverCase:
    dx: float
    adaptation: SPHAdaptation
    material: NeoHookeanSolid
    rp: sd.ReferencePairs
    nl: NeighborList
    holder_mask: torch.Tensor
    n: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = DX, dtype=PRODUCTION_DTYPE, cell_cap: int = 36,
               k_inner: int = 96, device="cuda"):
    """The cantilever and its holder on one lattice, gravity as the force
    prior, the frozen pairs (the damping's list too) and B.  Returns
    (case, body)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    material = NeoHookeanSolid(rho0=RHO0, youngs_modulus=YOUNGS,
                               poisson_ratio=POISSON)
    xs = np.arange(-SL + dx / 2, PL, dx)
    ys = np.arange(dx / 2, PH, dx)
    zs = np.arange(dx / 2, PW, dx)
    pos = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), -1).reshape(-1, 3)
    body, rp = frozen_block(pos, dx, material, (-SL - 4 * dx, -2 * PH, -PW),
                            (PL + 4 * dx, 2 * PH, 2 * PW), cell_cap, k_inner,
                            dtype, device)
    g = torch.as_tensor(GRAVITY, dtype=dtype, device=device)
    body["ForcePrior"] = body["Mass"][:, None] * g
    nl = NeighborList(idx=rp.idx, count=rp.mask.sum(dim=1).to(torch.int32),
                      overflow=torch.zeros((), dtype=torch.bool,
                                           device=device))
    case = NeoHookeanCantileverCase(
        dx=dx, adaptation=SPHAdaptation(spacing=dx, dim=3),
        material=material, rp=rp, nl=nl,
        holder_mask=torch.as_tensor(pos[:, 0] < 0.0, device=device),
        n=len(pos))
    return case, body


def init_sim(case, body: dict) -> SimState:
    pos = body["Position"]
    return SimState(body=body, time=pos.new_zeros(()), n_steps=0,
                    overflow=torch.zeros((), dtype=torch.bool,
                                         device=pos.device))


def damping(case: NeoHookeanCantileverCase, body: dict, dt) -> dict:
    """muscle_damping: pairwise implicit damping of the velocity
    (passive_cantilever_neohookean.cpp:90-91), two sweeps."""
    return dp.damping_pairwise(body, "Velocity", case.nl, case.kernel, 3,
                               ETA, dt)


def _step(case: NeoHookeanCantileverCase, s: SimState) -> SimState:
    body = s.body
    h = case.adaptation.h
    dt = sd.solid_acoustic_time_step(body, case.material.sound_speed, h,
                                     cfl=0.6)
    body = sd.integration_1st_half_pk2(body, case.rp, case.material, dt, h,
                                       case.kernel.w0(3))
    body = sd.fix_constraint(body, case.holder_mask)
    body = damping(case, body, dt)
    body = sd.fix_constraint(body, case.holder_mask)
    body = sd.integration_2nd_half(body, case.rp, dt)
    return SimState(body=body, time=s.time + dt, n_steps=s.n_steps + 1,
                    overflow=s.overflow)


def make_step(case: NeoHookeanCantileverCase):
    return lambda s: _step(case, s)


def make_run_chunk(case: NeoHookeanCantileverCase):
    """run_chunk(sim, t_target): steps until sim.time >= t_target."""
    return chunk_runner(lambda s: _step(case, s))


def corner_observer(case, body: dict):
    """The frozen-weight observer at (PL, PH, PW): (row indices,
    normalised W V weights) on the body's device."""
    return _corner_observer(case, body, OBSERVER)
