"""3D passive cantilever: the anisotropic Muscle material under an oblique
kick (counterpart of sphinxsys_tpu/cases/passive_cantilever_3d.py;
reference tests/3d_examples/test_3d_passive_cantilever/
passive_cantilever.cpp): a 6 x 1 x 1 cantilever (dx = 1/12) of passive
Muscle (a0 = (G, 0, 0, 0), b0 = (1, 0, 0, 0), fibre x, sheet y,
K = E / 3(1 - 2 nu)), clamped by an SL = 0.5 holder at x < 0, kicked with
v = (0, 5 sqrt(3), 5) on x > 0 and left to whip to t = 3
(Integration1stHalfPK2, the holder, the second half).  The corner
observer at (PL, PH, PW) swings through y in [-2.9, 4.2] in the
reference's DB.  The pairs are frozen at the build; one host read a
step.

    case, body = build_case(dx=0.25, device="cpu")
    sim = make_run_chunk(case)(init_sim(case, body), 0.01)
    print(observe_corner(sim, *corner_observer(case, body)))
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.materials import Muscle
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.neighbors.cell_list import (build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import build_neighbor_list
from sphinxsys_tpu_torch.physics import solid as sd
from sphinxsys_tpu_torch.solver import chunk_runner

PL, PH, PW = 6.0, 1.0, 1.0
SL = 0.5
DX = PH / 12.0
RHO0 = 1100.0
POISSON = 0.45
YOUNGS = 1.7e7
A_ISO = YOUNGS / (2.0 * (1.0 + POISSON))
BULK = YOUNGS / 3.0 / (1.0 - 2.0 * POISSON)
OBSERVER = (PL, PH, PW)


@dataclasses.dataclass
class SimState:
    body: dict
    time: torch.Tensor
    n_steps: int
    overflow: torch.Tensor


@dataclasses.dataclass(frozen=True)
class CantileverCase:
    dx: float
    adaptation: SPHAdaptation
    material: Muscle
    rp: sd.ReferencePairs
    holder_mask: torch.Tensor
    n: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def frozen_block(pos: np.ndarray, dx: float, material, lo, hi,
                 cell_cap: int, k_inner: int, dtype, device):
    """A solid block's state on `pos` with its frozen pairs (the grid over
    [lo, hi]) and B: (body, rp).  An overflow raises: the frozen pairs
    must be exact."""
    adaptation = SPHAdaptation(spacing=dx, dim=3)
    body = sd.make_elastic_solid_state(pos, dx ** 3, material, dtype, device)
    grid = grid_from_bounds(lo, hi, adaptation.cutoff)
    p0, n = body["Position"], body["NReal"]
    table = build_cell_table(p0, n, grid, cell_cap)
    nl = build_neighbor_list(p0, n, p0, n, table, grid, adaptation.cutoff,
                             k_max=k_inner, include_self=False)
    if bool(nl.overflow):
        raise ValueError("raise k_inner: the frozen pairs must be exact")
    rp = sd.freeze_reference_pairs(p0, nl, adaptation.kernel, 3)
    body["LinearGradientCorrectionMatrix"] = \
        sd.linear_gradient_correction_matrix(rp, body["VolumetricMeasure"])
    return body, rp


def build_case(dx: float = DX, dtype=PRODUCTION_DTYPE, cell_cap: int = 36,
               k_inner: int = 96, device="cuda"):
    """The cantilever and its holder on one lattice, frozen pairs and B,
    the kick.  Returns (case, body)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    material = Muscle(rho0=RHO0, bulk_modulus_param=BULK,
                      f0=(1.0, 0.0, 0.0), s0=(0.0, 1.0, 0.0),
                      a0=(A_ISO, 0.0, 0.0, 0.0), b0=(1.0, 0.0, 0.0, 0.0))
    xs = np.arange(-SL + dx / 2, PL, dx)
    ys = np.arange(dx / 2, PH, dx)
    zs = np.arange(dx / 2, PW, dx)
    pos = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), -1).reshape(-1, 3)
    body, rp = frozen_block(pos, dx, material, (-SL - 4 * dx, -PH, -PW),
                            (PL + 4 * dx, 2 * PH, 2 * PW), cell_cap, k_inner,
                            dtype, device)
    vel = np.zeros_like(pos)
    kick = pos[:, 0] > 0.0
    vel[:, 1] = np.where(kick, 5.0 * math.sqrt(3.0), 0.0)
    vel[:, 2] = np.where(kick, 5.0, 0.0)
    body["Velocity"] = torch.as_tensor(vel, dtype=dtype, device=device)
    case = CantileverCase(dx=dx, adaptation=SPHAdaptation(spacing=dx, dim=3),
                          material=material, rp=rp,
                          holder_mask=torch.as_tensor(pos[:, 0] < 0.0,
                                                      device=device),
                          n=len(pos))
    return case, body


def init_sim(case, body: dict) -> SimState:
    pos = body["Position"]
    return SimState(body=body, time=pos.new_zeros(()), n_steps=0,
                    overflow=torch.zeros((), dtype=torch.bool,
                                         device=pos.device))


def _step(case: CantileverCase, s: SimState) -> SimState:
    body = s.body
    h = case.adaptation.h
    dt = sd.solid_acoustic_time_step(body, case.material.sound_speed, h,
                                     cfl=0.6)
    body = sd.integration_1st_half_pk2(body, case.rp, case.material, dt, h,
                                       case.kernel.w0(3))
    body = sd.fix_constraint(body, case.holder_mask)
    body = sd.integration_2nd_half(body, case.rp, dt)
    return SimState(body=body, time=s.time + dt, n_steps=s.n_steps + 1,
                    overflow=s.overflow)


def make_step(case: CantileverCase):
    return lambda s: _step(case, s)


def make_run_chunk(case: CantileverCase):
    """run_chunk(sim, t_target): steps until sim.time >= t_target."""
    return chunk_runner(lambda s: _step(case, s))


def corner_observer(case, body: dict, point=OBSERVER):
    """The frozen-weight observer at `point` (passive_cantilever.cpp:19):
    (row indices, normalised W V weights) on the body's device."""
    dtype, dev = body["Position"].dtype, body["Position"].device
    pos0 = body["InitialPosition"].cpu().numpy()
    r = np.linalg.norm(pos0 - np.asarray(point), axis=1)
    idx = np.nonzero(r < case.adaptation.cutoff)[0]
    w = np.asarray([float(case.kernel.W(torch.as_tensor(ri, dtype=dtype), 3))
                    for ri in r[idx]])
    w = w * body["VolumetricMeasure"].cpu().numpy()[idx]
    return (torch.as_tensor(idx, device=dev),
            torch.as_tensor(w / (w.sum() + 1e-15), dtype=dtype, device=dev))


def observe_corner(s: SimState, idx, weights) -> np.ndarray:
    return torch.sum(s.body["Position"][idx] * weights[:, None],
                     dim=0).cpu().numpy()
