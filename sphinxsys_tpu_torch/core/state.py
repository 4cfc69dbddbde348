"""Particle state (counterpart of sphinxsys_tpu/core/state.py): a body's
state is a dict {reference variable name: tensor}; "NReal" (a Python int)
counts the real rows (a state carried across from the JAX package may be
padded past them).  The helpers take the dtype and device from their
caller: nothing here picks a device."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

State = Dict[str, torch.Tensor]

N_REAL = "NReal"
FAR_AWAY = 1.0e16  # padding particles parked far outside any domain


def valid_mask(state: State) -> torch.Tensor:
    """(N,) bool — True for real particles (index < NReal)."""
    n = state["Position"].shape[0]
    return torch.arange(n, device=state["Position"].device) < state[N_REAL]


def make_base_state(pos: np.ndarray, volume, rho0: float, dtype: torch.dtype,
                    device) -> State:
    """Position, VolumetricMeasure, Density, Mass (+ NReal) of n particles."""
    pos = np.asarray(pos)
    n = pos.shape[0]
    vol = np.broadcast_to(np.asarray(volume, dtype=np.float64), (n,)).copy()

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return {
        "Position": t(pos),
        "VolumetricMeasure": t(vol),
        "Density": t(np.full(n, rho0)),
        "Mass": t(rho0 * vol),
        N_REAL: n,
    }


def make_fluid_state(pos: np.ndarray, volume, rho0: float, dtype: torch.dtype,
                     device) -> State:
    """Base + the WCSPH integration variables (fluid_integration.hpp:12-23)."""
    state = make_base_state(pos, volume, rho0, dtype, device)
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
