"""Checkpoint / restart and reload (counterpart of
sphinxsys_tpu/io/restart.py; reference io_base.h RestartIO and
ReloadParticleIO).

A restart snapshot is one compressed .npz per body, every state entry an
array ("NReal" a 0-d integer), plus `rst_<step>.json` with the physical
time and the step counters; a reload file holds a relaxed body's real
positions and volumes.  The file names and the npz layout are the JAX
package's, so each package reads the other's snapshots.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch


def _restart_name(output_dir: str, body: str, step: int) -> str:
    return os.path.join(output_dir, f"{body}_rst_{step:07d}.npz")


def _host(value) -> np.ndarray:
    if torch.is_tensor(value):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def write_restart(output_dir: str, step: int, bodies: Dict[str, dict],
                  physical_time: float, **metadata) -> None:
    os.makedirs(output_dir, exist_ok=True)
    for name, state in bodies.items():
        np.savez_compressed(_restart_name(output_dir, name, step),
                            **{k: _host(v) for k, v in state.items()})
    meta = {"physical_time": float(physical_time), "step": int(step), **metadata}
    with open(os.path.join(output_dir, f"rst_{step:07d}.json"), "w") as f:
        json.dump(meta, f)


def _like(template, value: np.ndarray):
    """`value` in the template's kind: a tensor in its dtype on its device,
    a Python scalar of its type, else the array as read."""
    if torch.is_tensor(template):
        return torch.from_numpy(np.array(value)).to(device=template.device,
                                                    dtype=template.dtype)
    if isinstance(template, (bool, int, float)):
        return type(template)(value)
    return value


def read_restart(output_dir: str, step: int, bodies: Dict[str, dict]):
    """Load snapshot `step` into states shaped like the templates
    `bodies`.  Returns (bodies, metadata).  The caller rebuilds cell and
    neighbour lists (the reference's contract, Dambreak.cpp:131-138)."""
    out = {}
    for name, template in bodies.items():
        with np.load(_restart_name(output_dir, name, step)) as data:
            out[name] = {k: _like(template[k], data[k]) for k in template}
    with open(os.path.join(output_dir, f"rst_{step:07d}.json")) as f:
        meta = json.load(f)
    return out, meta


def write_reload(output_dir: str, body: str, state: dict) -> None:
    """Store a relaxed particle distribution for body-fitted ICs."""
    os.makedirs(output_dir, exist_ok=True)
    n = int(state["NReal"])
    np.savez_compressed(os.path.join(output_dir, f"{body}_reload.npz"),
                        Position=_host(state["Position"])[:n],
                        VolumetricMeasure=_host(state["VolumetricMeasure"])[:n])


def read_reload(output_dir: str, body: str):
    """-> (positions, volumes) as numpy, for ParticleGenerator<...,Reload>
    semantics."""
    with np.load(os.path.join(output_dir, f"{body}_reload.npz")) as data:
        return data["Position"], data["VolumetricMeasure"]
