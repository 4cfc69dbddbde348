"""Multi-level (adaptive smoothing length) neighbour search (counterpart of
sphinxsys_tpu/neighbors/multilevel.py; reference MultilevelCellLinkedList
and its adaptive neighbourhood construction, meshes/cell_linked_list.h:
169-219, neighborhood.cpp:100-121, adaptations/adaptation.h:125):

  * particles carry SmoothingLengthRatio  h_ratio = h_ref / h_i  (>= 1
    for refined particles);
  * a pair (i, j) is a neighbour when  r < kernel_size * max(h_i, h_j);
  * the cell structure is a ladder of grids whose spacing halves per
    level; level-l particles are tabulated on their own level's grid, and
    every finer level also on the coarser grids, so a coarse-radius query
    stays a 3^d window.

The combined list concatenates the per-level searches along the slot
axis and keeps each level's dropped slots as holes (the sentinel Ns), as
the JAX package does: the slot layout fixes the summation order of every
pair sum over it, so `idx`, `count` and `overflow` equal JAX's exactly.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from sphinxsys_tpu_torch.neighbors.cell_list import (build_cell_table,
                                                    grid_from_bounds,
                                                    min_image, valid_rows)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list,
                                                        gather)


class MultilevelTables(NamedTuple):
    """Per-level cell tables of one body: tables[l] holds every particle
    of level >= l on the level-l grid, so a level-l-radius query is one
    3^d window."""

    grids: tuple            # (L,) CellGrid, coarse -> fine
    tables: tuple           # (L,) CellTable
    level_of: torch.Tensor  # (N,) int32 particle level (0 = coarsest)
    cutoffs: tuple          # (L,) float level cutoff radii


def particle_levels(h_ratio, n_levels: int) -> torch.Tensor:
    """Each particle's level, floor(log2(h_ratio)) clipped: level 0 holds
    h in (h_ref/2, h_ref], level 1 (h_ref/4, h_ref/2], ..."""
    lv = torch.floor(torch.log2(torch.clamp(h_ratio, min=1.0)) + 1e-6)
    return torch.clamp(lv, 0, n_levels - 1).to(torch.int32)


def build_multilevel_tables(pos, valid, h_ratio, lower, upper, h_ref: float,
                            kernel_size: float = 2.0, n_levels: int = 2,
                            cap: int = 24, periodic=None) -> MultilevelTables:
    """`valid`: an int (the first rows) or a (N,) bool mask; level l's
    table has the cap cap * 2^l."""
    level_of = particle_levels(h_ratio, n_levels)
    valid = valid_rows(valid, pos.shape[0], pos.device)
    grids, tables, cutoffs = [], [], []
    for l in range(n_levels):
        cutoff_l = kernel_size * h_ref / (2 ** l)
        grid = grid_from_bounds(lower, upper, cutoff_l, periodic=periodic)
        mask = valid & (level_of >= l)
        tables.append(build_cell_table(pos, mask, grid, cap=cap * (2 ** l)))
        grids.append(grid)
        cutoffs.append(cutoff_l)
    return MultilevelTables(grids=tuple(grids), tables=tuple(tables),
                            level_of=level_of, cutoffs=tuple(cutoffs))


def _periodic(box) -> bool:
    return box is not None and any(b > 0 for b in box)


def build_adaptive_neighbor_list(pos_q, valid_q, h_ratio_q, pos_s, h_ratio_s,
                                 ml: MultilevelTables, kernel_size: float,
                                 h_ref: float,
                                 k_max_per_level: Sequence[int],
                                 include_self: bool = False,
                                 box=None) -> NeighborList:
    """Per level l a 3^d-window query of the level-l table at the level-l
    cutoff, kept where the pair's level (its coarser member's) is l and
    r < kernel_size * max(h_i, h_j), so each pair appears once.  The
    pair cut takes r = |d| without TINY, as the JAX package's."""
    n_levels = len(ml.grids)
    nq, ns = pos_q.shape[0], pos_s.shape[0]
    lvl_s = ml.level_of
    h_q = h_ref / torch.clamp(h_ratio_q, min=1e-30)
    lvl_q = particle_levels(h_ratio_q, n_levels)
    rows = torch.arange(nq, device=pos_q.device)[:, None]
    idxs, counts, overflows = [], [], []
    for l in range(n_levels):
        nl = build_neighbor_list(pos_q, valid_q, pos_s, ns, ml.tables[l],
                                 ml.grids[l], ml.cutoffs[l],
                                 k_max=k_max_per_level[l], include_self=True)
        lvl_j, mask = gather(lvl_s, nl.idx)
        hr_j, _ = gather(h_ratio_s, nl.idx)
        pos_j, _ = gather(pos_s, nl.idx)
        disp = pos_q[:, None, :] - pos_j
        if _periodic(box):
            disp = min_image(disp, box)
        r = torch.sqrt(torch.sum(disp * disp, dim=-1))
        h_j = h_ref / torch.clamp(hr_j, min=1e-30)
        pair_cut = kernel_size * torch.maximum(h_q[:, None], h_j)
        pair_level = torch.minimum(lvl_q[:, None], lvl_j)
        keep = mask & (pair_level == l) & (r < pair_cut)
        if not include_self:
            keep = keep & (nl.idx != rows)
        idxs.append(torch.where(keep, nl.idx, torch.full_like(nl.idx, ns)))
        counts.append(torch.sum(keep, dim=1, dtype=torch.int32))
        overflows.append(nl.overflow)
    return NeighborList(idx=torch.cat(idxs, dim=1), count=sum(counts),
                        overflow=torch.any(torch.stack(overflows)))


def adaptive_density_summation(pos, mass, h_ratio, nl: NeighborList, kernel,
                               dim: int, h_ref: float):
    """rho_i = m_i W(0; h_i) + sum_j m_j W(r_ij; h_i): the summation with
    each particle's own kernel (the gather side of the reference's
    DensitySummationAdaptive)."""
    pos_j, mask = gather(pos, nl.idx)
    m_j, _ = gather(mass, nl.idx)
    d = pos[:, None, :] - pos_j
    r = torch.sqrt(torch.sum(d * d, dim=-1))
    W = kernel.W_adaptive(r, h_ratio[:, None], dim) * mask
    return mass * kernel.w0_adaptive(h_ratio, dim) + torch.sum(m_j * W, dim=1)
