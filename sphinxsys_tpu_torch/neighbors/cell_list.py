"""Background cell grid (counterpart of sphinxsys_tpu/neighbors/cell_list.py:
`CellGrid`, `grid_from_bounds`, `cell_coords`, `cell_id`,
`wrap_positions`)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

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
