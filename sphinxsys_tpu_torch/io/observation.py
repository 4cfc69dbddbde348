"""Observation: kernel interpolation of fields at probe points
(counterpart of sphinxsys_tpu/io/observation.py; reference
general_interpolation.h ObservingAQuantity — Shepard-normalised kernel
interpolation through a contact relation — and io_observation.h
ObservedQuantityRecording, the .dat appender).

The probes' relation is a neighbour list with the probes as query rows
and the observed body as source (`build_neighbor_list(obs_pos, n_obs,
body pos, ..., include_self=True)`); the sums run over its slots in slot
order, as the JAX package's do.
"""

from __future__ import annotations

import numpy as np
import torch

from sphinxsys_tpu_torch.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_tpu_torch.physics.pair import pair_geometry

TINY = 1.0e-15


def observe_quantity(obs_pos, src_state, quantity: str, nl: NeighborList,
                     kernel, dim: int) -> torch.Tensor:
    """Shepard interpolation of `quantity` at observer positions:
    q_obs = sum_j q_j W_ij V_j / (sum_j W_ij V_j + tiny)."""
    pg = pair_geometry(obs_pos, src_state["Position"], nl, kernel, dim,
                       need_dW=False)
    vol_j, _ = gather(src_state["VolumetricMeasure"], nl.idx)
    data_j, _ = gather(src_state[quantity], nl.idx)
    weight = pg.W * vol_j
    if data_j.ndim == 3:  # vector quantity
        num = torch.sum(weight[..., None] * data_j, dim=1)
    else:
        num = torch.sum(weight * data_j, dim=1)
    den = torch.sum(weight, dim=1) + TINY
    return num / (den[:, None] if data_j.ndim == 3 else den)


class RecordedSeries:
    """Host-side time-series recorder (the .dat writer role of
    ObservedQuantityRecording); rows = (time, values...)."""

    def __init__(self, name: str):
        self.name = name
        self.times: list[float] = []
        self.values: list = []

    def append(self, t: float, value):
        self.times.append(float(t))
        if torch.is_tensor(value):
            value = value.detach().cpu().numpy()
        self.values.append(np.array(value))

    def asarray(self):
        return np.asarray(self.times), np.asarray(self.values)

    def write_dat(self, path: str, quantity_name: str | None = None):
        """Write in the reference's .dat layout: run_time then columns."""
        t, v = self.asarray()
        v2 = v.reshape(len(t), -1)
        header = "run_time\t" + "\t".join(
            f"{quantity_name or self.name}[{i}]" for i in range(v2.shape[1]))
        np.savetxt(path, np.column_stack([t, v2]), header=header, delimiter="\t")
