"""Pairwise geometry of a neighbour list (counterpart of
sphinxsys_tpu/physics/pair.py): W_ij, dW_ij and the unit vector e_ij are
recomputed from positions at each use, so a list stays valid while the
positions move.

Conventions (reference particle_neighborhood/neighborhood.h):
    disp = pos_i - pos_j,  e_ij = disp / r_ij   (points from j toward i)
    dW_ij = dW/dr < 0; the kernel gradient is grad_i W = dW_ij e_ij.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sphinxsys_tpu_torch.neighbors.cell_list import min_image
from sphinxsys_tpu_torch.neighbors.neighbor_list import NeighborList, gather

TINY = 1.0e-15


class PairGeometry(NamedTuple):
    """Per-(i, slot) pair quantities, shape (Nq, K) / (Nq, K, dim)."""

    r: torch.Tensor      # |pos_i - pos_j|
    e: torch.Tensor      # unit vector j -> i
    W: torch.Tensor      # kernel value, 0 on masked slots (None if not asked)
    dW: torch.Tensor     # radial derivative, 0 on masked slots (or None)
    mask: torch.Tensor   # (Nq, K) bool


def pair_geometry(pos_q, pos_s, nl: NeighborList, kernel, dim: int,
                  need_W: bool = True, need_dW: bool = True,
                  box=None) -> PairGeometry:
    pos_j, mask = gather(pos_s, nl.idx)
    disp = pos_q[:, None, :] - pos_j
    if box is not None and any(b > 0 for b in box):
        disp = min_image(disp, box)
    r = torch.sqrt(torch.sum(disp * disp, dim=-1) + TINY)
    e = disp / (r[..., None] + TINY)
    fmask = mask.to(pos_q.dtype)
    W = kernel.W(r, dim) * fmask if need_W else None
    dW = kernel.dW(r, dim) * fmask if need_dW else None
    return PairGeometry(r=r, e=e, W=W, dW=dW, mask=mask)


def psum(x: torch.Tensor, mask=None) -> torch.Tensor:
    """Sum over the neighbour-slot axis (axis 1)."""
    return torch.sum(x, dim=1)
