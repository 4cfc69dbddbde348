"""2D depolarization, the monodomain benchmark on a unit square
(counterpart of sphinxsys_tpu/cases/depolarization_2d.py; reference tests/
2d_examples/test_2d_depolarization/depolarization.cpp): a 1 x 1 muscle
block (dx = 1/50) with the directional monodomain diffusion (d = 1, no
bias) and the Aliev-Panfilow reaction (k = 8, a = 0.15, b = 0,
mu1 = 0.2, mu2 = 0.3, eps = 0.04), started from a Gaussian bump at the
(1, 0) corner and stepped by Strang splitting (half a reaction, the
corrected RK2 diffusion, half a reaction back; depolarization.cpp:
155-160).  The wave sweeps the square; the observer at (0.3, 0.7) reads
the voltage through frozen kernel weights.

The time is float32 whatever the body's dtype, as in the JAX package, so
both count the same steps to a given end.

    case, body = build_case(dx=0.1, device="cpu")
    sim = make_run_chunk(case)(init_sim(case, body), 0.1)
    print(observe_voltage(sim, *voltage_observer(case, body)))
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.neighbors.cell_list import (build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list)
from sphinxsys_tpu_torch.physics import diffusion as df
from sphinxsys_tpu_torch.physics.fluid import kernel_correction_matrix
from sphinxsys_tpu_torch.solver import chunk_runner

L = 1.0
H = 1.0
DX = H / 50.0
MODEL = df.AlievPanfilowModel(k_a=0.0, c_m=1.0, k=8.0, a=0.15, b=0.0,
                              mu_1=0.2, mu_2=0.3, epsilon=0.04)
DIFFUSION = df.DirectionalDiffusion(d_coeff=1.0, bias_coeff=0.0,
                                    bias_direction=(1.0, 0.0))
OBSERVER = (0.3, 0.7)


@dataclasses.dataclass
class SimState:
    body: dict
    time: torch.Tensor
    n_steps: int
    overflow: torch.Tensor


@dataclasses.dataclass(frozen=True)
class DepolarizationCase:
    dx: float
    adaptation: SPHAdaptation
    nl: NeighborList
    n: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = DX, dtype=PRODUCTION_DTYPE, cell_cap: int = 16,
               k_inner: int = 32, device="cuda"):
    """The block at rest with the bump and its correction matrix
    (electro_physiology.h:125), the frozen list (its overflow checked
    once, on the host).  Returns (case, body)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    xs = np.arange(dx / 2, L, dx)
    ys = np.arange(dx / 2, H, dx)
    pos = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    n = len(pos)
    v0 = np.exp(-4.0 * ((pos[:, 0] - 1.0) ** 2 + pos[:, 1] ** 2))

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    body = {"Position": t(pos), "VolumetricMeasure": t(np.full(n, dx * dx)),
            "NReal": n, "Voltage": t(v0), "GateVariable": t(np.zeros(n))}
    grid = grid_from_bounds((0.0, 0.0), (L, H), adaptation.cutoff)
    table = build_cell_table(body["Position"], n, grid, cell_cap)
    nl = build_neighbor_list(body["Position"], n, body["Position"], n, table,
                             grid, adaptation.cutoff, k_max=k_inner,
                             include_self=False)
    if bool(nl.overflow):
        raise RuntimeError("depolarization_2d: the neighbour list overflows")
    body = kernel_correction_matrix(body, nl, adaptation.kernel, 2)
    return DepolarizationCase(dx=dx, adaptation=adaptation, nl=nl, n=n), body


def init_sim(case: DepolarizationCase, body: dict) -> SimState:
    device = body["Position"].device
    return SimState(body=dict(body),
                    time=torch.zeros((), dtype=torch.float32, device=device),
                    n_steps=0,
                    overflow=torch.zeros((), dtype=torch.bool, device=device))


def make_advection_step(case: DepolarizationCase):
    dt = df.diffusion_time_step(case.adaptation.h, DIFFUSION, 2)

    def step(s: SimState) -> SimState:
        body = df.electrophysiology_step(s.body, case.nl, case.kernel, 2,
                                         DIFFUSION, MODEL, dt)
        return SimState(body=body, time=s.time + dt, n_steps=s.n_steps + 1,
                        overflow=s.overflow)

    return step


def make_run_chunk(case: DepolarizationCase):
    """run_chunk(sim, t_target): steps until sim.time >= t_target (in
    float32)."""
    return chunk_runner(make_advection_step(case))


def voltage_observer(case: DepolarizationCase, body: dict):
    """The frozen weights at OBSERVER (depolarization.cpp:17, 117): W(r)
    in float32, as the JAX package takes them, times the volume,
    normalised.  Returns (rows, weights in the body's dtype)."""
    pos = body["Position"].double().cpu().numpy()
    r = np.linalg.norm(pos - np.asarray(OBSERVER), axis=1)
    idx = np.nonzero(r < case.adaptation.cutoff)[0]
    w = case.kernel.W(torch.as_tensor(r[idx], dtype=torch.float32),
                      2).double().numpy()
    w = w * body["VolumetricMeasure"].double().cpu().numpy()[idx]
    device = body["Position"].device
    return (torch.as_tensor(idx, device=device),
            torch.as_tensor(w / w.sum(), dtype=body["Voltage"].dtype,
                            device=device))


def observe_voltage(s: SimState, idx, weights) -> float:
    return float(torch.sum(s.body["Voltage"][idx] * weights))
