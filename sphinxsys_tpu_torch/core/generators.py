"""Lattice particle generator (counterpart of
sphinxsys_tpu/core/generators.py): cell centres of a zero-buffer mesh
over the domain bounds at the reference spacing, kept where the shape
contains them.  Host-side float64, run once at case build."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sphinxsys_tpu_torch.core.geometry import Shape


def lattice_positions(domain_lower, domain_upper, spacing: float) -> np.ndarray:
    """All lattice cell-centre candidates: lower + (i + 0.5) * dx for
    i < ceil(extent / dx) per axis (base_mesh.cpp:10-15)."""
    lo = np.asarray(domain_lower, dtype=np.float64)
    hi = np.asarray(domain_upper, dtype=np.float64)
    n_cells = np.ceil((hi - lo) / spacing).astype(int)
    axes = [lo[d] + (np.arange(n_cells[d]) + 0.5) * spacing for d in range(len(lo))]
    grids = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1)


def generate_lattice(shape: Shape, domain_lower, domain_upper, spacing: float,
                     chunk: int = 1 << 20) -> Tuple[np.ndarray, float]:
    """Fill `shape` with lattice particles.  Returns (positions (N, dim)
    float64, particle volume = spacing^dim)."""
    cand = lattice_positions(domain_lower, domain_upper, spacing)
    keep = []
    for start in range(0, len(cand), chunk):
        block = cand[start:start + chunk]
        inside = shape.contains(torch.as_tensor(block, dtype=torch.float64))
        keep.append(block[inside.numpy()])
    pos = np.concatenate(keep, axis=0) if keep else np.zeros((0, cand.shape[1]))
    return pos, float(spacing) ** cand.shape[1]
