"""Background cell grid and the dense cell table (counterpart of
sphinxsys_tpu/neighbors/cell_list.py: `CellGrid`, `grid_from_bounds`,
`cell_coords`, `cell_id`, `wrap_positions`, `CellTable`,
`build_cell_table`, the Morton keys and `spatial_sort_permutation`;
`min_image`, which JAX keeps in physics/pair.py)."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CellGrid:
    """Static background-grid metadata.  `periodic` marks wrap-around axes
    (the grid then tiles the domain exactly)."""

    lower: Tuple[float, ...]
    spacing: Tuple[float, ...]  # cell edge per axis, >= kernel cutoff
    shape: Tuple[int, ...]      # cells per axis
    periodic: Tuple[bool, ...] | None = None

    @property
    def dim(self) -> int:
        return len(self.shape)

    @property
    def ncells(self) -> int:
        return int(np.prod(self.shape))

    @property
    def periodic_lengths(self) -> Tuple[float, ...]:
        """Domain length per axis where periodic, else 0 (no wrap)."""
        if self.periodic is None:
            return (0.0,) * self.dim
        return tuple(s * n if p else 0.0
                     for s, n, p in zip(self.spacing, self.shape, self.periodic))

    def strides(self) -> Tuple[int, ...]:
        """Row-major strides of the flat cell index."""
        st = [1] * self.dim
        for d in range(self.dim - 2, -1, -1):
            st[d] = st[d + 1] * self.shape[d + 1]
        return tuple(st)

    def cell_coords(self, pos: torch.Tensor) -> torch.Tensor:
        """(..., dim) positions -> (..., dim) int32 cell coords:
        floor((pos - lower) / spacing) in the positions' dtype (a division,
        not a reciprocal multiply: boundary particles must land in the same
        cell as in the JAX package), wrapped on periodic axes, clipped
        otherwise.  The clip happens before the integer cast so FAR-parked
        padding cannot overflow it."""
        lo = torch.as_tensor(self.lower, dtype=pos.dtype, device=pos.device)
        sp = torch.as_tensor(self.spacing, dtype=pos.dtype, device=pos.device)
        n = torch.as_tensor(self.shape, dtype=torch.int64, device=pos.device)
        c = torch.floor((pos - lo) / sp)
        periodic = self.periodic or (False,) * self.dim
        if any(periodic):
            pmask = torch.as_tensor(periodic, device=pos.device)
            big = float(2 ** 40)
            ci = torch.clamp(c, -big, big).to(torch.int64)
            wrapped = torch.remainder(ci, n)
            clipped = torch.minimum(torch.clamp(ci, min=0), n - 1)
            return torch.where(pmask, wrapped, clipped).to(torch.int32)
        nf = n.to(pos.dtype)
        c = torch.minimum(torch.clamp(c, min=0.0), nf - 1.0)
        return c.to(torch.int32)

    def flatten_coords(self, coords: torch.Tensor) -> torch.Tensor:
        """Row-major linear cell index (int32)."""
        s = torch.as_tensor(self.strides(), dtype=torch.int32,
                            device=coords.device)
        return torch.sum(coords * s, dim=-1, dtype=torch.int32)

    def cell_id(self, pos: torch.Tensor) -> torch.Tensor:
        return self.flatten_coords(self.cell_coords(pos))


def wrap_positions(pos: torch.Tensor, grid: CellGrid) -> torch.Tensor:
    """Periodic bounding (domain_bounding.h bounding_): map positions back
    into the primary domain on periodic axes.  `torch.remainder` takes the
    sign of the divisor, as `jnp.mod` does."""
    if grid.periodic is None or not any(grid.periodic):
        return pos
    lo = torch.as_tensor(grid.lower, dtype=pos.dtype, device=pos.device)
    length = torch.as_tensor([s * n for s, n in zip(grid.spacing, grid.shape)],
                             dtype=pos.dtype, device=pos.device)
    pmask = torch.as_tensor(grid.periodic, device=pos.device)
    return torch.where(pmask, lo + torch.remainder(pos - lo, length), pos)


def min_image(disp: torch.Tensor, box) -> torch.Tensor:
    """Minimum-image displacement on the periodic axes; `box` gives the
    per-axis periodic lengths (0: the axis does not wrap), e.g.
    grid.periodic_lengths.  disp - L round(disp / L), torch.round rounding
    half to even as jnp.round does."""
    length = torch.as_tensor(box, dtype=disp.dtype, device=disp.device)
    safe = torch.where(length > 0, length, torch.ones_like(length))
    return torch.where(length > 0, disp - length * torch.round(disp / safe),
                       disp)


def valid_rows(n_real, n: int, device) -> torch.Tensor:
    """(n,) bool rows to use: `n_real` an int (the first n_real rows) or
    already a (n,) bool mask."""
    if isinstance(n_real, torch.Tensor) and n_real.dim() == 1:
        return n_real
    return torch.arange(n, device=device) < int(n_real)


def grid_from_bounds(lower, upper, cutoff: float, buffer_cells: int = 1,
                     periodic=None) -> CellGrid:
    """Grid covering [lower, upper]: non-periodic axes get cell size =
    cutoff plus `buffer_cells` of margin each side; periodic axes tile the
    extent exactly with n = floor(L / cutoff) cells."""
    lower = np.asarray(lower, dtype=np.float64)
    upper = np.asarray(upper, dtype=np.float64)
    dim = len(lower)
    periodic = tuple(periodic) if periodic is not None else (False,) * dim
    lo, spacing, shape = [], [], []
    for d in range(dim):
        if periodic[d]:
            L = upper[d] - lower[d]
            n = max(int(np.floor(L / cutoff)), 1)
            lo.append(float(lower[d]))
            spacing.append(L / n)
            shape.append(n)
        else:
            lo.append(float(lower[d] - buffer_cells * cutoff))
            extent = upper[d] + buffer_cells * cutoff - lo[-1]
            shape.append(max(int(np.ceil(extent / cutoff)), 1))
            spacing.append(float(cutoff))
    return CellGrid(lower=tuple(lo), spacing=tuple(spacing), shape=tuple(shape),
                    periodic=periodic if any(periodic) else None)


class CellTable(NamedTuple):
    """Dense per-cell particle table.

    table:    (ncells + 1, cap) int32 particle indices, padded with the
              sentinel N; row `ncells` is the target of out-of-grid window
              lookups.  As in the JAX package, it also receives the invalid
              rows (cell id `ncells`) up to `cap` of them.
    counts:   (ncells,) int32 particles in each cell.
    overflow: () bool, a cell held more than `cap` (its extra particles
              were dropped; rebuild with a larger cap)."""

    table: torch.Tensor
    counts: torch.Tensor
    overflow: torch.Tensor


def build_cell_table(pos: torch.Tensor, n_real, grid: CellGrid,
                     cap: int) -> CellTable:
    """Count-sort the particles into the dense cell table: a stable sort by
    cell id (index order kept inside a cell), run offsets by searchsorted,
    each particle scattered to its in-cell rank (ranks >= cap dropped).

    pos:    (N, dim) positions (rows past the real ones may be anything)
    n_real: an int (rows >= n_real ignored) or a (N,) bool validity mask."""
    n = pos.shape[0]
    dev = pos.device
    ncells = grid.ncells
    cid = torch.where(valid_rows(n_real, n, dev), grid.cell_id(pos),
                      torch.full((n,), ncells, dtype=torch.int32, device=dev))
    sorted_cid, order = torch.sort(cid, stable=True)
    offsets = torch.searchsorted(
        sorted_cid, torch.arange(ncells + 1, dtype=torch.int32, device=dev))
    rank = torch.arange(n, device=dev) - offsets[
        torch.clamp(sorted_cid, max=ncells).long()]
    table = torch.full((ncells + 1, cap), n, dtype=torch.int32, device=dev)
    keep = rank < cap
    table[sorted_cid[keep].long(), rank[keep]] = order[keep].to(torch.int32)
    counts = (offsets[1:] - offsets[:-1]).to(torch.int32)
    return CellTable(table=table, counts=counts,
                     overflow=torch.max(counts) > cap)


# ---------------------------------------------------------------------------
# Morton (Z-order) keys for the spatial resort.  torch has no general
# uint32 arithmetic: the bits are interleaved in int64 and masked to 32.
# ---------------------------------------------------------------------------

def _part1by1(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 16 bits of x to the even bit positions."""
    x = x & 0xFFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    return (x | (x << 1)) & 0x55555555


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x to every third bit position."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def morton_key(coords: torch.Tensor) -> torch.Tensor:
    """(..., dim) non-negative int cell coords -> (...,) int64 Morton code
    in [0, 2^32) (meshes/base_mesh.h:85-104 MortonCode): the JAX package's
    uint32 key, bit for bit."""
    c = coords.to(torch.int64) & 0xFFFFFFFF
    dim = coords.shape[-1]
    if dim == 1:
        return c[..., 0]
    if dim == 2:
        return _part1by1(c[..., 0]) | (_part1by1(c[..., 1]) << 1)
    if dim == 3:
        return (_part1by2(c[..., 0]) | (_part1by2(c[..., 1]) << 1)
                | (_part1by2(c[..., 2]) << 2))
    raise ValueError(f"dim must be 1/2/3, got {dim}")


def spatial_sort_permutation(pos: torch.Tensor, n_real,
                             grid: CellGrid) -> torch.Tensor:
    """Permutation placing the real particles in Morton order of their
    cells, padding rows (key 0xFFFFFFFF) at the tail; a stable sort, so
    particles of one cell keep their index order and the permutation
    equals the JAX package's (`jnp.argsort`) index for index.  Applying it
    to every per-particle field is ParticleSortCK
    (particle_sort_ck.hpp:64-105)."""
    n = pos.shape[0]
    key = torch.where(valid_rows(n_real, n, pos.device),
                      morton_key(grid.cell_coords(pos)),
                      torch.full((n,), 0xFFFFFFFF, dtype=torch.int64,
                                 device=pos.device))
    return torch.argsort(key, stable=True)


def morton_resort(state: dict, grid: CellGrid) -> dict:
    """Every per-particle field of a state (a tensor whose leading
    dimension is N) in the Morton order of `spatial_sort_permutation`;
    NReal and the other fields as they are."""
    perm = spatial_sort_permutation(state["Position"], state["NReal"], grid)
    n = perm.shape[0]
    return {k: v[perm] if torch.is_tensor(v) and v.dim() >= 1
            and v.shape[0] == n else v for k, v in state.items()}
