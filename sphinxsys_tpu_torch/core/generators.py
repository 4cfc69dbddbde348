"""Particle generators (counterpart of sphinxsys_tpu/core/generators.py):
the lattice fill (cell centres of a zero-buffer mesh over the domain
bounds at the reference spacing, kept where the shape contains them), the
surface (shell) lattice, the shell normals' orientation and the observer
points.  Host-side float64, run once at case build: the shape is
evaluated on CPU tensors."""

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


def _inside(shape: Shape, cand: np.ndarray, chunk: int) -> np.ndarray:
    """The candidates `shape` contains, in their order."""
    keep = []
    for start in range(0, len(cand), chunk):
        block = cand[start:start + chunk]
        inside = shape.contains(torch.as_tensor(block, dtype=torch.float64))
        keep.append(block[inside.numpy()])
    return np.concatenate(keep, axis=0) if keep else np.zeros((0, cand.shape[1]))


def generate_lattice(shape: Shape, domain_lower, domain_upper, spacing: float,
                     chunk: int = 1 << 20) -> Tuple[np.ndarray, float]:
    """Fill `shape` with lattice particles.  Returns (positions (N, dim)
    float64, particle volume = spacing^dim)."""
    cand = lattice_positions(domain_lower, domain_upper, spacing)
    return _inside(shape, cand, chunk), float(spacing) ** cand.shape[1]


def generate_surface_lattice(shape: Shape, domain_lower, domain_upper,
                             spacing: float, thickness: float,
                             seed: int = 0, chunk: int = 1 << 20,
                             ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Surface (shell) particles of the thin volume `shape`
    (ParticleGenerator<SurfaceParticles, Lattice>,
    particle_generator_lattice.cpp:44-56 and
    particle_generator_lattice_2d.cpp:26-70): a fine lattice (half the
    spacing, or half the thickness where the shell is thinner than a
    particle) measures the shell's volume; its occupied cells are thinned
    to planned = round(volume / (spacing^(d-1) thickness)) by uniform
    draws of numpy's default_rng(seed), the JAX package's generator, so
    both packages keep the same cells.  Returns (positions (N, d),
    the shape's normals there (N, d), area = spacing^(d-1))."""
    lattice_spacing = 0.5 * spacing if thickness > spacing else 0.5 * thickness
    cand = lattice_positions(domain_lower, domain_upper, lattice_spacing)
    dim = cand.shape[1]
    occupied = _inside(shape, cand, chunk)
    all_cells = len(occupied)
    total_volume = all_cells * lattice_spacing ** dim
    avg_particle_volume = spacing ** (dim - 1) * thickness
    planned = int(total_volume / avg_particle_volume + 0.5)
    interval = max(planned / max(all_cells, 1), 1e-30)
    rng = np.random.default_rng(seed)
    selected = rng.uniform(0.0, 1.0, size=all_cells) <= interval
    selected &= np.cumsum(selected) <= planned   # the reference's cap
    pos = occupied[selected]
    normals = shape.find_normal_direction(
        torch.as_tensor(pos, dtype=torch.float64)).detach().numpy()
    return pos, normals, float(spacing) ** (dim - 1)


def consistent_shell_normals(positions: np.ndarray, normals: np.ndarray,
                             reference_direction) -> np.ndarray:
    """Surface-lattice normals turned to one side: each normal whose dot
    with `reference_direction(positions)` (e.g. the radial direction of a
    cylindrical shell) is negative is flipped.  The particles straddle
    the mid-surface, so the SDF gradient flips sign across it; the
    reference mends this later in ShellNormalDirectionPrediction
    (physics/relax_shell.py)."""
    ref = np.asarray(reference_direction(positions), dtype=np.float64)
    flip = np.sum(normals * ref, axis=-1, keepdims=True) < 0.0
    return np.where(flip, -normals, normals)


def generate_observers(points) -> np.ndarray:
    """Observer particle positions (ObserverParticles), float64."""
    return np.asarray(points, dtype=np.float64)
