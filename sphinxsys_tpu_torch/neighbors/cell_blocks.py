"""Cell-block slotting (counterpart of sphinxsys_tpu/neighbors/cell_blocks.py).

Particles are count-sorted into dense per-occupied-cell blocks of `cap`
slots: block arrays have shape (C_max+1, cap, ...) with an all-padding
sentinel row at C_max.  Each occupied cell stores the block row of its
3^dim window neighbours (`nbr_block`, sentinel C_max); a pair sweep walks
those rows.  The integer outputs equal the JAX package's exactly — the
within-cell slot order sets the summation order, so trajectories only
match if it is the same: a stable sort by cell id keeps particle index
order inside each cell.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import torch

from sphinxsys_tpu_torch.neighbors.cell_list import CellGrid


def window_offsets(dim: int):
    return list(itertools.product(*([(-1, 0, 1)] * dim)))


class BlockMap(NamedTuple):
    """occ_cells (C_max,) sorted occupied cell ids, sentinel `ncells`;
    n_occ () occupied-cell count; nbr_block (C_max, 3^dim) window rows,
    sentinel C_max; slot_particle (C_max*cap,) particle index per slot,
    sentinel N; slot_mask (C_max*cap,) bool; overflow () bool (cap or C_max
    exceeded: results invalid); order_n (M,) first M entries of the stable
    cell-id argsort; start (C_max,) sorted position where row r's run
    begins (sentinel M).  All integer tensors are int32."""

    occ_cells: torch.Tensor
    n_occ: torch.Tensor
    nbr_block: torch.Tensor
    slot_particle: torch.Tensor
    slot_mask: torch.Tensor
    overflow: torch.Tensor
    order_n: torch.Tensor
    start: torch.Tensor

    @property
    def c_max(self) -> int:
        return self.occ_cells.shape[0]

    @property
    def cap(self) -> int:
        return self.slot_particle.shape[0] // self.occ_cells.shape[0]


def _unflatten(flat: torch.Tensor, grid: CellGrid) -> torch.Tensor:
    """Row-major flat cell id -> (..., dim) int32 coords."""
    coords = []
    rem = flat
    for d in range(grid.dim - 1, -1, -1):
        coords.append(torch.remainder(rem, grid.shape[d]))
        rem = torch.div(rem, grid.shape[d], rounding_mode="floor")
    return torch.stack(coords[::-1], dim=-1).to(torch.int32)


def neighbor_window_rows(occ_cells: torch.Tensor, grid: CellGrid,
                         dense_map: torch.Tensor, c_max_src: int) -> torch.Tensor:
    """(C,) occupied cell ids + (ncells+1,) dense cell->row map -> (C, 3^dim)
    window-neighbour block rows (sentinel c_max_src).  One lookup per
    window; window coordinates wrap modulo the grid shape on periodic
    axes.  Rows of sentinel cells are all-sentinel: the JAX package's
    shifted-table paths (a TPU gather workaround) give the same integers
    on occupied rows, and its per-window fallback, which every
    doubly-periodic grid takes, unflattens the sentinel id into a real
    cell there.  A periodic axis needs 3 cells or more: with fewer, the
    -1 and +1 windows name the same cell and its pairs count twice."""
    ncells = grid.ncells
    dev = occ_cells.device
    gshape = torch.as_tensor(grid.shape, dtype=torch.int32, device=dev)
    periodic = grid.periodic or (False,) * grid.dim
    pmask = torch.as_tensor(periodic, device=dev)
    coords = _unflatten(occ_cells, grid)
    real = occ_cells < ncells
    sentinel = torch.full_like(occ_cells, c_max_src)
    out = []
    for off in window_offsets(grid.dim):
        nc = coords + torch.as_tensor(off, dtype=torch.int32, device=dev)
        if any(periodic):
            nc = torch.where(pmask, torch.remainder(nc, gshape), nc)
        inb = torch.all((nc >= 0) & (nc < gshape), dim=-1) & real
        target = torch.where(
            inb, grid.flatten_coords(torch.minimum(torch.clamp(nc, min=0),
                                                   gshape - 1)),
            torch.full_like(occ_cells, ncells))
        out.append(torch.where(inb, dense_map[target], sentinel))
    return torch.stack(out, dim=1)


def dense_cell_map(occ_cells: torch.Tensor, ncells: int, c_max: int) -> torch.Tensor:
    """Dense cell id -> block row table ((ncells+1,), sentinel c_max).
    Padding entries of occ_cells all point at `ncells`; their duplicate
    writes land there and are overwritten by the sentinel afterwards (on
    CUDA duplicate-index writes are unordered)."""
    dm = torch.full((ncells + 1,), c_max, dtype=torch.int32,
                    device=occ_cells.device)
    dm[torch.clamp(occ_cells, max=ncells).long()] = torch.arange(
        c_max, dtype=torch.int32, device=occ_cells.device)
    dm[ncells] = c_max
    return dm


def cross_neighbor_blocks(occ_cells_q: torch.Tensor, grid: CellGrid,
                          bm_src: BlockMap, src_dense_map=None) -> torch.Tensor:
    """Window rows of ANOTHER body's block map (contact relations): for each
    query occupied cell, the source block row of each window cell
    (sentinel = source c_max)."""
    c_max_s = bm_src.c_max
    dm = src_dense_map if src_dense_map is not None else dense_cell_map(
        bm_src.occ_cells, grid.ncells, c_max_s)
    return neighbor_window_rows(occ_cells_q, grid, dm, c_max_s)


def build_block_map(pos: torch.Tensor, valid, grid: CellGrid, cap: int,
                    c_max: int, n_max: int | None = None, carry=None):
    """Count-sort particles into occupied-cell blocks.

    pos:   (N, dim) — N may itself be a slot array being re-slotted.
    valid: (N,) bool, or an int n_real (rows >= n_real invalid).
    n_max: static bound on the number of valid rows; everything after the
           sort runs on the first n_max sorted rows only.
    carry: optional (N, CH) columns; then also returns their blocks
           (C_max, cap, CH): block row r holds the CH columns of the sorted
           rows start[r] .. start[r]+cap-1 (zeros past the end), unmasked.
    """
    n = pos.shape[0]
    dev = pos.device
    ncells = grid.ncells
    m = n if n_max is None else min(n_max, n)
    i32 = torch.int32
    if isinstance(valid, int):
        valid = torch.arange(n, device=dev) < valid
    cid = torch.where(valid, grid.cell_id(pos),
                      torch.full((n,), ncells, dtype=i32, device=dev))

    scid_full, order = torch.sort(cid, stable=True)
    order = order.to(i32)
    order_n = order[:m]
    scid = scid_full[:m]
    prev = torch.cat([torch.full((1,), -1, dtype=i32, device=dev), scid[:-1]])
    is_first = (scid != prev) & (scid < ncells)
    csum = torch.cumsum(is_first.to(i32), 0, dtype=i32)
    occ_rank = csum - 1                   # block row of each sorted particle
    n_occ = csum[-1]

    # start[r] / occ_cells[r]: sorted position and cell id of the r-th run.
    # The JAX package compacts the run heads with a stable 0/1-key sort;
    # here they scatter to their (unique) ranks, rows past c_max dropped
    # into a dump slot.
    pos_m = torch.arange(m, dtype=i32, device=dev)
    head = torch.where(is_first & (occ_rank < c_max), occ_rank,
                       torch.full_like(occ_rank, c_max)).long()
    start = torch.full((c_max + 1,), m, dtype=i32, device=dev)
    start[head] = pos_m
    start = start[:c_max]
    occ_cells = torch.full((c_max + 1,), ncells, dtype=i32, device=dev)
    occ_cells[head] = scid
    occ_cells = occ_cells[:c_max]
    found = torch.arange(c_max, device=dev) < n_occ

    rank = pos_m - start[torch.clamp(occ_rank, 0, c_max - 1).long()]
    sort_valid = scid < ncells

    # slot_particle: row r's occupants are sorted positions start[r] ..
    n_valid = torch.sum(sort_valid.to(i32))
    nxt = torch.cat([start[1:], torch.full((1,), m, dtype=i32, device=dev)])
    count = torch.minimum(nxt, n_valid) - torch.minimum(start, n_valid)
    k_idx = torch.arange(cap, dtype=i32, device=dev)
    occ_pos = start[:, None] + k_idx[None, :]
    valid_slot = (k_idx[None, :] < torch.clamp(count, max=cap)[:, None]) \
        & found[:, None]
    gathered = order_n[torch.clamp(occ_pos, max=m - 1).long()]
    slot_particle = torch.where(valid_slot, gathered,
                                torch.full_like(gathered, n)).reshape(-1)
    slot_mask = slot_particle < n

    overflow = (n_occ > c_max) | torch.any(sort_valid & (rank >= cap))
    if m < n:
        # n_max too small: a valid row spilled past m
        overflow = overflow | (cid[order[m].long()] < ncells)

    dense_map = dense_cell_map(occ_cells, ncells, c_max)
    nbr_block = neighbor_window_rows(occ_cells, grid, dense_map, c_max)

    bm = BlockMap(occ_cells=occ_cells, n_occ=n_occ, nbr_block=nbr_block,
                  slot_particle=slot_particle, slot_mask=slot_mask,
                  overflow=overflow, order_n=order_n, start=start)
    if carry is None:
        return bm
    sc = carry[order_n.long()]
    sc = torch.cat([sc, sc.new_zeros((cap, sc.shape[1]))], dim=0)
    rows = torch.clamp(start, max=m).long()[:, None] \
        + torch.arange(cap, device=dev)[None, :]
    return bm, sc[rows]


def occupied_rows(nbr_block: torch.Tensor) -> int:
    """Number of leading block rows in use.  Occupied rows form a prefix;
    every later row holds padding only and its windows are all the
    sentinel (C_max), so sweeps may stop there.  Reads back one integer."""
    used = torch.nonzero(torch.any(nbr_block < nbr_block.shape[0], dim=1))
    return int(used.max()) + 1 if used.numel() else 0


def to_blocks(bm: BlockMap, arr: torch.Tensor, fill=0.0) -> torch.Tensor:
    """Particle array (N, ...) -> block array (C_max+1, cap, ...) with an
    all-`fill` sentinel row at C_max."""
    n = arr.shape[0]
    safe = torch.clamp(bm.slot_particle, max=n - 1).long()
    mask = bm.slot_mask.reshape((-1,) + (1,) * (arr.ndim - 1))
    flat = torch.where(mask, arr[safe],
                       torch.as_tensor(fill, dtype=arr.dtype, device=arr.device))
    blocks = flat.reshape((bm.c_max, bm.cap) + tuple(arr.shape[1:]))
    sentinel = torch.full((1, bm.cap) + tuple(arr.shape[1:]), fill,
                          dtype=arr.dtype, device=arr.device)
    return torch.cat([blocks, sentinel], dim=0)
