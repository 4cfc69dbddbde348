"""Particle state (counterpart of sphinxsys_tpu/core/state.py): a body's
state is a dict {reference variable name: tensor}; "NReal" (a Python int)
counts the real rows (a state carried across from the JAX package may be
padded past them).  An open-boundary body also carries "Alive", a (N,)
bool mask of its live rows (physics/boundary.py).  The helpers take the
dtype and device from their caller: nothing here picks a device."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

State = Dict[str, torch.Tensor]

N_REAL = "NReal"
FAR_AWAY = 1.0e16  # padding particles parked far outside any domain


def valid_mask(state: State) -> torch.Tensor:
    """(N,) bool — True for real particles: the "Alive" mask where the
    state carries one, otherwise index < NReal (`nreal_mask`)."""
    if "Alive" in state:
        return state["Alive"]
    return nreal_mask(state)


def nreal_mask(state: State) -> torch.Tensor:
    """(N,) bool — index < NReal, whether or not the state carries Alive
    (the fluid time steps mask by it, as the JAX package's do)."""
    n = state["Position"].shape[0]
    return torch.arange(n, device=state["Position"].device) < state[N_REAL]


def make_base_state(pos: np.ndarray, volume, rho0: float, dtype: torch.dtype,
                    device, capacity: int | None = None) -> State:
    """Position, VolumetricMeasure, Density, Mass (+ NReal) of n particles.
    `capacity` > n pads the rows past them as the JAX package pads them:
    Position FAR_AWAY, volume 1, density rho0, mass 1 (finite derived
    quantities; every list, gather and reduction masks them out)."""
    pos = np.asarray(pos)
    n = pos.shape[0]
    cap = capacity or n
    if cap < n:
        raise ValueError(f"capacity {cap} < number of particles {n}")
    vol = np.broadcast_to(np.asarray(volume, dtype=np.float64), (n,)).copy()

    def t(a, fill):
        pad = [(0, cap - n)] + [(0, 0)] * (a.ndim - 1)
        return torch.as_tensor(np.pad(a, pad, constant_values=fill),
                               dtype=dtype, device=device)

    return {
        "Position": t(pos, FAR_AWAY),
        "VolumetricMeasure": t(vol, 1.0),
        "Density": t(np.full(n, rho0), rho0),
        "Mass": t(rho0 * vol, 1.0),
        N_REAL: n,
    }


def make_fluid_state(pos: np.ndarray, volume, rho0: float, dtype: torch.dtype,
                     device, capacity: int | None = None) -> State:
    """Base + the WCSPH integration variables (fluid_integration.hpp:12-23)."""
    state = make_base_state(pos, volume, rho0, dtype, device, capacity)
    shape = state["Position"].shape
    for k in ("Velocity", "Force", "ForcePrior"):
        state[k] = torch.zeros(shape, dtype=dtype, device=device)
    for k in ("Pressure", "DensityChangeRate", "DensitySummation"):
        state[k] = torch.zeros(shape[:1], dtype=dtype, device=device)
    return state


def make_solid_state(pos: np.ndarray, volume, rho0: float, dtype: torch.dtype,
                     device) -> State:
    """Base + normals and the averaged wall kinematics the fluid wall
    boundary reads (zero for static walls)."""
    state = make_base_state(pos, volume, rho0, dtype, device)
    shape = state["Position"].shape
    for k in ("Velocity", "NormalDirection", "AverageVelocity",
              "AverageAcceleration"):
        state[k] = torch.zeros(shape, dtype=dtype, device=device)
    return state
