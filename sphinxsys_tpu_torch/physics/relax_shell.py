"""Thick-shell particle relaxation: mid-surface fitting and normal
prediction (counterpart of sphinxsys_tpu/physics/relax_shell.py;
reference relax_dynamics/relax_thick_shell.{h,cpp}): lattice particles of
a thin (thickness t) volume are relaxed onto its mid-surface and given
consistent normals.

  * ShellMidSurfaceBounding (relax_thick_shell.cpp:18-24): every
    iteration pos -= 0.2 |grad phi| (0.5 dx) n, with the raw level-set
    gradient, ~1 away from the medial axis and ~0 on it;
  * ShellRelaxationStep (cpp:174-190): the plain inner residual, its
    max-residual scaling, the move and the mid-surface bounding;
  * ShellNormalDirectionPrediction (cpp:26-83): n <- normal(pos + 0.3 t n)
    until every cosine of the change passes cos(0.01 pi), then the
    orientations made consistent by the JAX package's parallel flood
    (every particle not yet updated that has an updated neighbour takes
    its orientation from the first such neighbour, all in one sweep),
    then the prediction again and the W-weighted smoothing.

The loops of the JAX package's `lax.while_loop`s are host loops: the
prediction reads its all-passed flag every iteration (it must stop at the
first passing one), the flood its all-updated flag every FLOOD_CHECK
sweeps (a sweep after all are updated changes nothing).  The neighbour
list is the port's `neighbors` builders', rebuilt every relaxation
iteration; an overflow in any iteration raises once the loop is done.
"""

from __future__ import annotations

import math

import torch

from sphinxsys_tpu_torch.neighbors.cell_list import CellGrid
from sphinxsys_tpu_torch.neighbors.neighbor_list import gather
from sphinxsys_tpu_torch.physics.pair import pair_geometry
from sphinxsys_tpu_torch.physics.relax import (_inner_list, _raise_on,
                                              randomize_positions,
                                              relaxation_residual,
                                              relaxation_scaling)

TINY = 1.0e-15
FLOOD_CHECK = 8      # flood sweeps between reads of the all-updated flag


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def probe_raw_gradient(levelset, pts):
    """The level set's gradient at query points, not normalised
    (LevelSetShape::findLevelSetGradient)."""
    return levelset._multilinear(levelset.gradient(), pts)


def mid_surface_bounding(pos, levelset, spacing: float):
    """ShellMidSurfaceBounding::update (relax_thick_shell.cpp:18-24)."""
    g = probe_raw_gradient(levelset, pos)
    n = g / (_norm(g) + TINY)
    return pos - 0.2 * _norm(g) * (0.5 * spacing) * n


def shell_relax_iterations(levelset, pos, volume: float, adaptation,
                           grid: CellGrid, n_iterations: int = 2000,
                           cell_cap: int = 32, k_max: int = 48):
    """The iterations of `shell_relax` from jittered, bounded positions:
    the plain inner residual, its scaling, the move, the mid-surface
    bounding."""
    kernel, dim = adaptation.kernel, pos.shape[1]
    vol = torch.full((pos.shape[0],), volume, dtype=pos.dtype,
                     device=pos.device)
    overflow = torch.zeros((), dtype=torch.bool, device=pos.device)
    p = pos
    for _ in range(n_iterations):
        nl = _inner_list(p, grid, adaptation.cutoff, cell_cap, k_max)
        overflow = overflow | nl.overflow
        res = relaxation_residual(p, vol, nl, kernel, dim)
        p = p + 0.5 * res * relaxation_scaling(res, adaptation.h)
        p = mid_surface_bounding(p, levelset, adaptation.spacing)
    _raise_on(overflow, "shell_relax", cell_cap, k_max)
    return p


def shell_relax(levelset, pos0, volume: float, adaptation, grid: CellGrid,
                n_iterations: int = 2000, cell_cap: int = 32,
                k_max: int = 48, seed: int = 0):
    """ShellRelaxationStep driver (test_2d_shell_particle_relaxation.cpp):
    jitter (the port's generator), bound to the mid-surface, then
    `shell_relax_iterations`."""
    pos = mid_surface_bounding(
        randomize_positions(pos0, adaptation.spacing, seed), levelset,
        adaptation.spacing)
    return shell_relax_iterations(levelset, pos, volume, adaptation, grid,
                                  n_iterations, cell_cap, k_max)


def _predict_normals(pos, n0, levelset, thickness: float,
                     convergence: float, max_iters: int = 100):
    """n <- the level set's normal at pos + 0.3 t n, iterated until every
    particle's cosine of the change exceeds `convergence`
    (NormalPrediction + PredictionConvergenceCheck).  Stops at the first
    passing iteration (one host read an iteration).  Returns (n, the
    iterations run)."""
    n = n0
    for it in range(max_iters):
        new = levelset.probe_normal_direction(pos + 0.3 * thickness * n)
        ok = bool(torch.all(torch.sum(new * n, dim=-1) > convergence))
        n = new
        if ok:
            return n, it + 1
    return n, max_iters


def _consistency_flood(n, nl, consistency: float, seed_index,
                       max_sweeps: int = 4096):
    """ConsistencyCorrection as parallel wavefront propagation from one
    updated seed: each sweep, every particle not yet updated with an
    updated real neighbour flips its sign against the first such
    neighbour if aligned with its opposite, copies it if near-orthogonal,
    and is updated.  Sweeps in groups of FLOOD_CHECK between reads of the
    all-updated flag.  Returns (n, updated, the sweeps run before all
    were updated: the JAX loop's count, a 0-d device tensor)."""
    N = n.shape[0]
    updated = torch.zeros((N,), dtype=torch.bool, device=n.device)
    updated[seed_index] = True
    sweeps = 0
    counted = torch.zeros((), dtype=torch.int64, device=n.device)
    while sweeps < max_sweeps and not bool(torch.all(updated)):
        for _ in range(min(FLOOD_CHECK, max_sweeps - sweeps)):
            counted = counted + (~torch.all(updated)).to(torch.int64)
            upd_j, mask = gather(updated, nl.idx)
            valid = upd_j & mask
            has_src = torch.any(valid, dim=1)
            # the first updated slot (argmax of a bool: its first maximum)
            src_slot = torch.argmax(valid.to(torch.uint8), dim=1)
            src_idx = torch.gather(nl.idx, 1, src_slot[:, None])[:, 0]
            n_src = n[torch.clamp(src_idx, max=N - 1)]
            dot = torch.sum(n_src * n, dim=-1)
            flip = dot < -consistency          # aligned with -n_j
            adopt = torch.abs(dot) <= consistency  # near-orthogonal
            cand = torch.where(adopt[:, None], n_src,
                               torch.where(flip[:, None], -n, n))
            take = has_src & ~updated
            n = torch.where(take[:, None], cand, n)
            updated = updated | take
            sweeps += 1
    return n, updated, counted


def _smooth_normals(pos, n, nl, kernel, dim: int):
    """SmoothingNormal (ParticleSmoothing with W_ij weights and the self
    weight W0), normalised (relax_thick_shell.cpp:164-172)."""
    pg = pair_geometry(pos, pos, nl, kernel, dim, need_dW=False)
    n_j, _ = gather(n, nl.idx)
    w0 = kernel.w0(dim)
    num = w0 * n + torch.sum(pg.W[..., None] * n_j, dim=1)
    den = w0 + torch.sum(pg.W, dim=1)
    sm = num / (den[..., None] + TINY)
    return sm / (_norm(sm) + TINY)


def shell_normal_prediction(pos, levelset, thickness: float, adaptation,
                            grid: CellGrid, cell_cap: int = 32,
                            k_max: int = 48, consistency: float = None):
    """ShellNormalDirectionPrediction::exec (relax_thick_shell.cpp:38-44):
    predict -> consistency flood -> predict -> smooth.  Returns the unit
    normals (N, dim) and the flood's updated flags (N,)."""
    dim, N = pos.shape[1], pos.shape[0]
    convergence = math.cos(0.01 * math.pi)
    if consistency is None:
        consistency = math.cos(math.pi / 20.0)
    nl = _inner_list(pos, grid, adaptation.cutoff, cell_cap, k_max)
    _raise_on(nl.overflow, "shell_normal_prediction", cell_cap, k_max)
    n0 = levelset.probe_normal_direction(pos)
    n1, _ = _predict_normals(pos, n0, levelset, thickness, convergence)
    n2, updated, _ = _consistency_flood(n1, nl, consistency, N // 3)
    n3, _ = _predict_normals(pos, n2, levelset, thickness, convergence)
    return _smooth_normals(pos, n3, nl, adaptation.kernel, dim), updated
