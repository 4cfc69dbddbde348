"""Fixed-capacity neighbour lists (counterpart of
sphinxsys_tpu/neighbors/neighbor_list.py: `NeighborList`,
`build_neighbor_list`, `gather`, `brute_force_neighbors`).

A relation is a dense (Nq, K) index tensor with a per-row count: each query
row scans the 3^dim cell window around it (periodic axes wrap modulo the
grid), keeps the candidates within the cutoff and compacts them to the left
in window order, then in-cell order.  `idx` equals the JAX package's row
for row.  The build runs in row chunks: each row's result depends on that
row alone, and unchunked the candidate temporaries of a million-site solid
(972 candidates a row) would take tens of GB.

An inner relation is build_neighbor_list(query=body, source=body,
include_self=False); a contact relation is query=body_a, source=body_b.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sphinxsys_tpu_torch.neighbors.cell_blocks import window_offsets
from sphinxsys_tpu_torch.neighbors.cell_list import (CellGrid, CellTable,
                                                    min_image, valid_rows)

ROW_CHUNK = 1 << 15


class NeighborList(NamedTuple):
    """idx: (Nq, K) int32 source indices, padded with the sentinel Ns;
    count: (Nq,) int32; overflow: () bool (a row had more than K
    neighbours, or the cell table overflowed: rebuild larger)."""

    idx: torch.Tensor
    count: torch.Tensor
    overflow: torch.Tensor


def _rows(pos_q, q_valid, rows, pos_s, table: CellTable, grid: CellGrid,
          cutoff: float, k_max: int, include_self: bool):
    """(idx, count) of the query rows `rows` (a slice)."""
    ns = pos_s.shape[0]
    dim = grid.dim
    dev = pos_q.device
    pq = pos_q[rows]
    coords = grid.cell_coords(pq)
    gshape = torch.as_tensor(grid.shape, dtype=torch.int32, device=dev)
    periodic = grid.periodic or (False,) * dim
    pmask = torch.as_tensor(periodic, device=dev)
    cands = []
    for off in window_offsets(dim):
        nc = coords + torch.as_tensor(off, dtype=torch.int32, device=dev)
        if any(periodic):
            nc = torch.where(pmask, torch.remainder(nc, gshape), nc)
        inb = torch.all((nc >= 0) & (nc < gshape), dim=-1)
        flat = torch.where(
            inb, grid.flatten_coords(torch.minimum(torch.clamp(nc, min=0),
                                                   gshape - 1)),
            torch.full_like(inb, grid.ncells, dtype=torch.int32))
        cands.append(table.table[flat.long()])   # row ncells: out of grid
    cand = torch.cat(cands, dim=1)               # (R, 3^dim * cap)

    # sentinel candidates gather a clipped index and are masked explicitly
    pos_j = pos_s[torch.clamp(cand, max=ns - 1).long()]
    disp = pq[:, None, :] - pos_j
    if any(periodic):
        disp = min_image(disp, grid.periodic_lengths)
    r2 = torch.sum(disp * disp, dim=-1)
    mask = (cand < ns) & (r2 < cutoff * cutoff) & q_valid[rows][:, None]
    if not include_self:
        q_index = torch.arange(rows.start, rows.stop, device=dev)
        mask &= cand != q_index[:, None]

    # left compaction: each kept candidate to its rank in the row; the
    # rest, and ranks >= k_max, land in a dump column (JAX's mode="drop")
    rank = torch.cumsum(mask.to(torch.int32), dim=1) - 1
    rank = torch.where(mask & (rank < k_max), rank,
                       torch.full_like(rank, k_max))
    idx = torch.full((cand.shape[0], k_max + 1), ns, dtype=torch.int32,
                     device=dev)
    idx.scatter_(1, rank.long(), cand)
    return idx[:, :k_max], torch.sum(mask, dim=1, dtype=torch.int32)


def build_neighbor_list(pos_q, n_real_q, pos_s, n_real_s, table: CellTable,
                        grid: CellGrid, cutoff: float, k_max: int,
                        include_self: bool,
                        row_chunk: int = ROW_CHUNK) -> NeighborList:
    """All source particles within `cutoff` of each query particle.

    pos_q:  (Nq, dim) query positions; rows >= n_real_q ignored (n_real_q
            may also be a (Nq,) bool validity mask).
    pos_s:  (Ns, dim) source positions, count-sorted into `table`.
    include_self: False for inner relations (query and source the same
            body).  `n_real_s` is unused, as in the JAX package: the table
            holds only the valid sources.
    row_chunk: query rows built at a time (the result does not depend on
            it)."""
    nq = pos_q.shape[0]
    q_valid = valid_rows(n_real_q, nq, pos_q.device)
    parts = [_rows(pos_q, q_valid, slice(r0, min(r0 + row_chunk, nq)), pos_s,
                   table, grid, cutoff, k_max, include_self)
             for r0 in range(0, nq, row_chunk)]
    idx = torch.cat([p[0] for p in parts])
    count = torch.cat([p[1] for p in parts])
    overflow = (torch.max(count) > k_max) | table.overflow
    return NeighborList(idx=idx, count=count, overflow=overflow)


def gather(src: torch.Tensor, nbr_idx: torch.Tensor):
    """Source per-particle data for each neighbour slot: src (Ns, ...),
    nbr_idx (Nq, K) with sentinel Ns -> (values (Nq, K, ...), mask (Nq, K));
    sentinel slots read row Ns - 1."""
    ns = src.shape[0]
    return src[torch.clamp(nbr_idx, max=ns - 1).long()], nbr_idx < ns


def brute_force_neighbors(pos_q, n_real_q, pos_s, n_real_s, cutoff: float,
                          include_self: bool):
    """O(Nq Ns) pair finder, the tests' oracle: a set of (i, j) pairs."""
    pos_q = np.asarray(pos_q)[: int(n_real_q)]
    pos_s = np.asarray(pos_s)[: int(n_real_s)]
    pairs = set()
    for i in range(len(pos_q)):
        d = np.linalg.norm(pos_s - pos_q[i], axis=-1)
        for j in np.nonzero(d < cutoff)[0]:
            if include_self or j != i:
                pairs.add((i, int(j)))
    return pairs
