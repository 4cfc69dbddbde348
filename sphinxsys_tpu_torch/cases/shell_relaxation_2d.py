"""Shell (thick-structure) particle relaxation of a 2D thin pipe
(counterpart of sphinxsys_tpu/cases/shell_relaxation_2d.py; reference
tests/2d_examples/test_2d_shell_particle_relaxation/
test_2d_shell_particle_relaxation.cpp): an annulus of inner radius 24.5
and thickness 1 at dx = 0.5 is filled with surface-lattice particles,
relaxed for 2,000 ShellRelaxationStep iterations onto its mid-surface
(radius 25) and given consistent normals by
ShellNormalDirectionPrediction.  The level set is 5x finer than the
particles (LS_SPACING = 0.1).

The reference case has no regression data; its oracle is analytic: the
particles on the mid circle (|r - 25| << dx), the arc spacing uniform,
the normals radial with one global sign.

    pos, normals, updated = run_case(n_iterations=50, device="cpu")
"""

from __future__ import annotations

import numpy as np
import torch

import sphinxsys_tpu_torch.core.geometry as G
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.generators import generate_surface_lattice
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.meshes.levelset import build_levelset
from sphinxsys_tpu_torch.neighbors.cell_list import CellGrid
from sphinxsys_tpu_torch.physics.relax_shell import (shell_normal_prediction,
                                                    shell_relax)

RADIUS = 24.5          # inner radius
THICKNESS = 1.0
R_MID = RADIUS + 0.5 * THICKNESS
DX = 0.5
# the reference refines the level set by dx / (0.1 thickness) = 5x
LS_SPACING = DX / (DX / (0.1 * THICKNESS))


def build_case(dx: float = DX, dtype=PRODUCTION_DTYPE, device="cuda"):
    """(pipe shape, level set, surface-lattice positions (a tensor),
    particle area, adaptation, grid)."""
    device, dtype = resolve_device(device), resolve_dtype(dtype)
    pipe = G.make_complex(
        ("add", G.Ball(center=(0.0, 0.0), radius=RADIUS + THICKNESS)),
        ("sub", G.Ball(center=(0.0, 0.0), radius=RADIUS)))
    pad = 4 * dx
    lo = np.array([-RADIUS - THICKNESS - pad] * 2)
    hi = np.array([RADIUS + THICKNESS + pad] * 2)
    levelset = build_levelset(pipe, lo, hi, LS_SPACING, dtype=dtype,
                              device=device)
    pos0, _, area = generate_surface_lattice(pipe, lo, hi, dx, THICKNESS)
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    cell = adaptation.cutoff
    nc = tuple(int(np.ceil((hi[d] - lo[d]) / cell)) + 1 for d in range(2))
    grid = CellGrid(lower=tuple(lo), spacing=(cell, cell), shape=nc)
    return (pipe, levelset, torch.as_tensor(pos0, dtype=dtype, device=device),
            area, adaptation, grid)


def run_case(n_iterations: int = 2000, dx: float = DX, seed: int = 0,
             dtype=PRODUCTION_DTYPE, device="cuda"):
    """Returns (relaxed positions, predicted normals, the flood's updated
    flags)."""
    _, levelset, pos0, area, adaptation, grid = build_case(dx, dtype, device)
    pos = shell_relax(levelset, pos0, area * THICKNESS, adaptation, grid,
                      n_iterations=n_iterations, seed=seed)
    normals, updated = shell_normal_prediction(pos, levelset, THICKNESS,
                                               adaptation, grid)
    return pos, normals, updated
