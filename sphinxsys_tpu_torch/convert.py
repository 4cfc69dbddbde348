"""State carried across from the JAX package: its state dicts and BlockSim
arrays, handed over as numpy, become the port's CPU tensors, and back.
The parity tests use these to feed both sides identical inputs."""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a):
    return torch.as_tensor(np.array(a))  # a private, writable copy


def state_from_numpy(state: dict) -> dict:
    """Particle state dict (numpy values; "NReal" a scalar) -> tensors of
    the same dtypes."""
    return {k: int(np.asarray(v)) if k == "NReal" else _tensor(v)
            for k, v in state.items()}


def block_state_from_numpy(fb: dict) -> dict:
    """Block state dict ((C+1, cap, ...) numpy arrays incl. SlotMask and
    OriginalID) -> tensors of the same dtypes."""
    return {k: _tensor(v) for k, v in fb.items()}


def to_numpy(x):
    """Tensors (also inside dicts, lists and tuples) -> numpy."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_numpy(v) for v in x)
    return x
