"""Solid <-> shell tie coupling by Shepard-weight kinematic and force
mappings (counterpart of sphinxsys_tpu/physics/solid_shell.py; reference
solid_dynamics/solid_to_shell_coupling.{h,hpp}: TotalWeightComputation,
ConsistentMapping, ConservativeMapping).  A volumetric solid tied to a
shell mid-surface exchanges kinematics and forces through cross-body
pairs frozen at the initial configuration (the reference never updates
the coupling relations: the tie is total-Lagrangian).

  * TotalWeight: tw_i = sum_j W_ij Vol_j over the contact body, once;
  * ConsistentMapping (kinematics, shell <- solid): where tw_i > TINY,
    field_i = sum_j W_ij Vol_j field_j / tw_i;
  * ConservativeMapping (force, solid <- shell): field_i = sum_j W_ij
    Vol_i / tw_j field_j, so the total force carried across equals the
    tied shell's.

The pairs are (N, K) tensors; the search runs at the larger smoothing
length of the two bodies (MaxSmoothingLengthContactRelation): pass that
cutoff's list to `freeze_coupling`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sphinxsys_tpu_torch.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_tpu_torch.physics.pair import pair_geometry

TINY = 1.0e-15


class CouplingPairs(NamedTuple):
    """Frozen tie pairs from body A's particles to body B's."""

    idx: torch.Tensor           # (Na, K) rows of body B
    W: torch.Tensor             # (Na, K) the kernel at the tie configuration
    mask: torch.Tensor          # (Na, K) slot validity, 1.0 / 0.0
    vol_j: torch.Tensor         # (Na, K) body B's volumetric measure
    total_weight: torch.Tensor  # (Na,) sum_j W_ij Vol_j


def freeze_coupling(pos_a, pos_b, vol_b, nl: NeighborList, kernel,
                    dim: int) -> CouplingPairs:
    """The frozen pairs of body A against body B and their TotalWeight
    (solid_to_shell_coupling.hpp TotalWeightComputation::update)."""
    pg = pair_geometry(pos_a, pos_b, nl, kernel, dim, need_dW=False)
    vol_j, _ = gather(vol_b, nl.idx)
    fmask = pg.mask.to(pos_a.dtype)
    W = pg.W * fmask
    return CouplingPairs(idx=nl.idx, W=W, mask=fmask, vol_j=vol_j,
                         total_weight=torch.sum(W * vol_j, dim=1))


def consistent_mapping(cp: CouplingPairs, data_b, current, part_mask=None):
    """ConsistentMapping::update: `data_b` (body B's per-particle values,
    the velocity) interpolated onto body A where the tie has support;
    rows with tw <= TINY, or outside `part_mask`, keep `current`."""
    data_j, _ = gather(data_b, cp.idx)
    w = cp.W * cp.vol_j
    tied = cp.total_weight > TINY
    if part_mask is not None:
        tied = tied & part_mask
    if data_j.dim() == 3:
        num = torch.sum(w[..., None] * data_j, dim=1)
        return torch.where(tied[..., None],
                           num / (cp.total_weight + TINY)[..., None], current)
    num = torch.sum(w * data_j, dim=1)
    return torch.where(tied, num / (cp.total_weight + TINY), current)


def conservative_mapping(cp: CouplingPairs, vol_a, tw_b, data_b):
    """ConservativeMapping::update: body B's per-particle values (the
    force) spread onto body A with the total kept, each pair W_ij Vol_a_i /
    tw_b_j data_b_j; a source without tie support (tw_b_j <= TINY) gives
    nothing."""
    data_j, _ = gather(data_b, cp.idx)
    tw_j, _ = gather(tw_b, cp.idx)
    share = torch.where(tw_j > TINY, cp.W * vol_a[:, None] / (tw_j + TINY),
                        torch.zeros_like(cp.W))
    if data_j.dim() == 3:
        return torch.sum(share[..., None] * data_j, dim=1)
    return torch.sum(share * data_j, dim=1)
