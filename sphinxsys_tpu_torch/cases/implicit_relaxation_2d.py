"""Implicit particle relaxation of a turbine-blade section (counterpart of
sphinxsys_tpu/cases/implicit_relaxation_2d.py; reference
tests/2d_examples/test_2d_implicit_relaxation/implicit_relaxation.cpp):
the blade polygon (data/TurbineBlade.dat) at dx = 1/25 is lattice-filled,
jittered by 0.25 dx and relaxed by RelaxationStepLevelSetCorrection
InnerImplicit for 1,000 iterations; the regression quantity is the body's
mean |residual| ("ParticleKineticEnergy") every 200 iterations.

The solve is physics/relax.py's order-free two-pass form of the
reference's sequenced sweep, the surface correction the level set's
sampled cut-cell integrals (meshes/levelset.py).

The blade's vertex file is not part of this repository.  `load_blade`
reads it from the path the caller gives, or from the file named by the
environment variable BLADE_ENV; with neither it raises
FileNotFoundError.  `build_case` / `run_case(blade=...)` take any
Polygon, such as `naca0012(chord)`, the closed-form section the tests and
the chip check relax in its place.

    pos, curve, pos0 = run_case(n_iterations=20, blade=naca0012(4.0),
                                device="cpu")
"""

from __future__ import annotations

import os

import numpy as np
import torch

from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.generators import generate_lattice
from sphinxsys_tpu_torch.core.geometry import Polygon
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.meshes.levelset import build_levelset
from sphinxsys_tpu_torch.neighbors.cell_list import CellGrid
from sphinxsys_tpu_torch.physics.relax import relax_shape_implicit

DX = 1.0 / 25.0
BLADE_ENV = "SPHINXSYS_TURBINE_BLADE"


def load_blade(path: str | None = None) -> Polygon:
    """The blade polygon from its vertex file (two columns, x y): `path`,
    else the file BLADE_ENV names."""
    path = path or os.environ.get(BLADE_ENV)
    if not path:
        raise FileNotFoundError(
            "implicit_relaxation_2d needs the TurbineBlade.dat vertex file "
            "(reference tests/2d_examples/test_2d_implicit_relaxation/data/): "
            f"pass blade_path= (the CLI's --set blade_path=...) or set "
            f"{BLADE_ENV}")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no blade vertex file at {path}")
    return Polygon(vertices=tuple(map(tuple, np.loadtxt(path))))


def naca0012(chord: float = 4.0, n_side: int = 100) -> Polygon:
    """A NACA 0012 section of `chord` by its closed-form half thickness
    0.6 c (0.2969 sqrt(x) - 0.1260 x - 0.3516 x^2 + 0.2843 x^3
    - 0.1036 x^4), x = x / c, the trailing edge closed; `n_side` points a
    side, cosine-spaced, counter-clockwise from the trailing edge."""
    x = 0.5 * (1.0 - np.cos(np.linspace(0.0, np.pi, n_side)))
    t = 0.6 * (0.2969 * np.sqrt(x) - 0.1260 * x - 0.3516 * x ** 2
               + 0.2843 * x ** 3 - 0.1036 * x ** 4)
    upper = np.stack([x[::-1], t[::-1]], -1)           # trailing -> leading
    lower = np.stack([x[1:-1], -t[1:-1]], -1)          # leading -> trailing
    return Polygon(vertices=tuple(map(tuple, chord * np.concatenate(
        [upper, lower]))))


def build_case(blade: Polygon, dx: float = DX, dtype=PRODUCTION_DTYPE,
               device="cuda"):
    """The lattice fill of `blade` and its level set with the kernel
    integrals: (lattice positions (a tensor), particle volume, adaptation,
    grid, level set)."""
    device, dtype = resolve_device(device), resolve_dtype(dtype)
    lo, hi = blade.bounds()
    pad = 4 * dx
    dom_lo = np.asarray(lo) - pad
    dom_hi = np.asarray(hi) + pad
    pos0, vol = generate_lattice(blade, dom_lo, dom_hi, dx)
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    cell = adaptation.cutoff
    n_cells = tuple(int(np.ceil((dom_hi[d] - dom_lo[d]) / cell)) + 1
                    for d in range(2))
    grid = CellGrid(lower=tuple(dom_lo), spacing=(cell, cell), shape=n_cells)
    ls = build_levelset(blade, dom_lo, dom_hi, dx, dtype=dtype,
                        device=device).update_kernel_integrals(
                            adaptation.kernel, 2)
    return (torch.as_tensor(pos0, dtype=dtype, device=device), vol,
            adaptation, grid, ls)


def run_case(n_iterations: int = 1000, record_every: int = 200,
             seed: int = 0, blade_path: str | None = None,
             blade: Polygon | None = None, dx: float = DX,
             dtype=PRODUCTION_DTYPE, device="cuda"):
    """Relax the blade (`blade`, else `load_blade(blade_path)`).  Returns
    (relaxed positions, the mean |residual| every `record_every`
    iterations, the lattice positions)."""
    blade = blade if blade is not None else load_blade(blade_path)
    pos0, vol, adaptation, grid, ls = build_case(blade, dx, dtype, device)
    pos, curve = relax_shape_implicit(
        blade, pos0, vol, adaptation, grid, n_iterations=n_iterations,
        record_every=record_every, seed=seed, levelset=ls)
    return pos, curve, pos0
