"""Body-fitted particle relaxation (counterpart of
sphinxsys_tpu/physics/relax.py, its explicit variant; reference
relax_dynamics/relax_stepping.{h,cpp}, base_relax_dynamics.cpp): turns a
lattice fill into an isotropic, body-fitted particle distribution.

    randomize -> loop { residual = -2 sum dW V_j e_ij (+ surface correction)
                        scaling  = 0.0625 h / max|residual|
                        x += 0.5 residual scaling
                        surface bounding: phi > -dx/2 -> x -= (phi + dx/2) n }

The implicit variant (`relax_shape_implicit`, the level-set-corrected
implicit step of relax_stepping.{h,hpp,cpp}) solves each particle's
d x d linearised system per iteration, in the JAX package's order-free
two-pass form, through core/linalg.py's closed forms.

The jitter is kept apart from the iterations: `relax_shape_iterations`,
`relax_shape_implicit_iterations` and `relax_periodic_iterations` run the
loop from positions already jittered, so the same loop can start from
another generator's jitter.  The loop is a fixed number of iterations on
the host, with no read of the device (the implicit step's dt comes from
the previous residual's max on the device); a neighbour-list overflow in
any iteration raises once the loop is done.
"""

from __future__ import annotations

import numpy as np
import torch

from sphinxsys_tpu_torch.core.linalg import inv, mm, mv
from sphinxsys_tpu_torch.neighbors.cell_list import (CellGrid,
                                                    build_cell_table,
                                                    wrap_positions)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (build_neighbor_list,
                                                        gather)
from sphinxsys_tpu_torch.physics.pair import pair_geometry

TINY = 1.0e-15


def randomize_positions(pos: torch.Tensor, spacing: float,
                        seed: int = 0) -> torch.Tensor:
    """RandomizeParticlePosition (base_relax_dynamics.cpp): jitter by
    U(-1, 1) spacing dt with the reference's dt = 0.25.  The draw comes
    from a torch.Generator seeded with `seed` on the positions' device; it
    cannot reproduce the JAX package's jax.random bits."""
    gen = torch.Generator(device=pos.device).manual_seed(seed)
    u = torch.rand(pos.shape, generator=gen, dtype=pos.dtype,
                   device=pos.device)
    return pos + 0.25 * spacing * (2.0 * u - 1.0)


def relaxation_residual(pos, vol, nl, kernel, dim: int, box=None):
    """residual_i = -2 sum_j dW_ij V_j e_ij (relax_stepping.cpp); `box`
    gives minimum-image displacements on periodic axes."""
    pg = pair_geometry(pos, pos, nl, kernel, dim, need_W=False, box=box)
    vol_j, _ = gather(vol, nl.idx)
    return -torch.sum((2.0 * pg.dW * vol_j)[..., None] * pg.e, dim=1)


def half_space_gradient_table(kernel, dim: int, n_samples: int = 64):
    """L(d) = |integral of grad W over the half space beyond distance d|
    (the flat-surface closed form of LevelSetShape::computeKernelIntegral,
    level_set_shape.h:67): in 2D L(d) = int W(sqrt(x^2 + d^2)) dx, in 3D
    L(d) = 2 pi int_0^inf W(sqrt(s^2 + d^2)) s ds.  Host float64; returns
    (d_grid, L) as numpy arrays."""
    cutoff = kernel.cutoff
    W = lambda r: kernel.W(torch.as_tensor(r, dtype=torch.float64),
                           dim).numpy()
    d_grid = np.linspace(0.0, cutoff, n_samples)
    xs = np.linspace(-cutoff, cutoff, 801)
    dxs = xs[1] - xs[0]
    L = np.zeros_like(d_grid)
    for i, d in enumerate(d_grid):
        if dim == 2:
            L[i] = np.sum(W(np.sqrt(xs ** 2 + d ** 2))) * dxs
        else:
            s = np.linspace(0.0, cutoff, 401)
            ds = s[1] - s[0]
            L[i] = 2.0 * np.pi * np.sum(W(np.sqrt(s ** 2 + d ** 2)) * s) * ds
    return d_grid, L


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear interpolation, held constant outside [xp[0],
    xp[-1]] (the formula of jnp.interp)."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    f = fp[i - 1] + (delta / dx) * df
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def surface_residual_correction(pos, shape, table):
    """Missing-neighbour correction near the body surface: the truncated
    kernel sum completed by the flat-surface integral, pointing inward
    (-n L(|phi|))."""
    d_grid, L = (torch.as_tensor(a, dtype=pos.dtype, device=pos.device)
                 for a in table)
    phi = shape.signed_distance(pos)   # negative inside
    n = shape.find_normal_direction(pos)
    depth = torch.clamp(-phi, min=0.0, max=float(d_grid[-1]))
    return -2.0 * interp(depth, d_grid, L)[..., None] * n


def relaxation_scaling(residual, h_ref: float):
    """0.0625 h / max|residual| (relax_stepping.cpp RelaxationScaling)."""
    return 0.0625 * h_ref / (
        torch.max(torch.linalg.vector_norm(residual, dim=-1)) + TINY)


def surface_bounding(pos, shape, spacing: float):
    """ShapeSurfaceBounding (general_constraint.cpp): particles with
    phi > -dx/2 projected back to the inner surface band."""
    phi = shape.signed_distance(pos)
    d = 0.5 * spacing
    n = shape.find_normal_direction(pos)
    shift = torch.where((phi > -d)[..., None], (phi + d)[..., None] * n,
                        torch.zeros_like(n))
    return pos - shift


def _inner_list(p, grid: CellGrid, cutoff: float, cell_cap: int, k_max: int):
    n = p.shape[0]
    table = build_cell_table(p, n, grid, cell_cap)
    return build_neighbor_list(p, n, p, n, table, grid, cutoff, k_max=k_max,
                               include_self=False)


def _raise_on(overflow, what: str, cell_cap: int, k_max: int):
    if bool(overflow):
        raise ValueError(f"{what}: cell_cap={cell_cap} / k_max={k_max} "
                         "overflowed in an iteration; raise them")


def relax_shape_iterations(shape, pos, volume: float, adaptation,
                           grid: CellGrid, n_iterations: int = 200,
                           cell_cap: int = 32, k_max: int = 48,
                           surface_correction: bool = True):
    """The iterations of `relax_shape` from jittered, bounded positions
    (RelaxationStepInner, relax_stepping.h:224, with the surface
    correction).  Returns the relaxed positions."""
    kernel, dim = adaptation.kernel, pos.shape[1]
    vol = torch.full((pos.shape[0],), volume, dtype=pos.dtype,
                     device=pos.device)
    table_L = half_space_gradient_table(kernel, dim) \
        if surface_correction else None
    overflow = torch.zeros((), dtype=torch.bool, device=pos.device)
    p = pos
    for _ in range(n_iterations):
        nl = _inner_list(p, grid, adaptation.cutoff, cell_cap, k_max)
        overflow = overflow | nl.overflow
        res = relaxation_residual(p, vol, nl, kernel, dim)
        if table_L is not None:
            res = res + surface_residual_correction(p, shape, table_L)
        p = p + 0.5 * res * relaxation_scaling(res, adaptation.h)
        p = surface_bounding(p, shape, adaptation.spacing)
    _raise_on(overflow, "relax_shape", cell_cap, k_max)
    return p


def relax_shape(shape, pos0, volume: float, adaptation, grid: CellGrid,
                n_iterations: int = 200, cell_cap: int = 32, k_max: int = 48,
                seed: int = 0, surface_correction: bool = True):
    """Relax the particles `pos0` (a tensor) inside `shape`: jitter, bound,
    then `relax_shape_iterations`."""
    pos = surface_bounding(randomize_positions(pos0, adaptation.spacing, seed),
                           shape, adaptation.spacing)
    return relax_shape_iterations(shape, pos, volume, adaptation, grid,
                                  n_iterations, cell_cap, k_max,
                                  surface_correction)


def half_space_kernel_tables(kernel, dim: int, n_samples: int = 64):
    """Flat-surface closures of the implicit level-set correction
    (RelaxationResidual<Inner<LevelSetCorrection, Implicit>>,
    relax_stepping.cpp): K(d) = integral of W over the half space beyond
    depth d (the overlap kernel integral) and L'(d) = d/dd of the
    gradient-integral magnitude (the flat surface's second-gradient
    integral is -L'(d) n n^T).  Host float64 quadrature; returns (d_grid,
    K, Lp) as numpy arrays."""
    cutoff = kernel.cutoff
    W = lambda r: kernel.W(torch.as_tensor(r, dtype=torch.float64),
                           dim).numpy()
    d_grid = np.linspace(0.0, cutoff, n_samples)
    ys = np.linspace(0.0, cutoff, 401)
    dy = ys[1] - ys[0]
    if dim == 2:
        xs = np.linspace(-cutoff, cutoff, 801)
        line = np.sum(W(np.sqrt(xs[None, :] ** 2 + ys[:, None] ** 2)),
                      axis=1) * (xs[1] - xs[0])
    else:
        s = np.linspace(0.0, cutoff, 401)
        Wg = W(np.sqrt(s[None, :] ** 2 + ys[:, None] ** 2))
        line = 2.0 * np.pi * np.sum(Wg * s[None, :], axis=1) * (s[1] - s[0])
    # K(y) = int_y^cutoff line(t) dt, the reversed cumulative integral
    tail = np.concatenate([np.cumsum(line[::-1])[::-1][1:] * dy, [0.0]])
    K = np.interp(d_grid, ys, tail)
    _, L = half_space_gradient_table(kernel, dim, n_samples)
    return d_grid, K, np.gradient(L, d_grid)


def implicit_relaxation_update(pos, vol, nl, kernel, dim: int, dtsq,
                               shape=None, tables=None, levelset=None):
    """One implicit relaxation solve in the JAX package's Jacobi two-pass
    form of the reference's sequenced splitting sweep (relax_stepping.cpp
    RelaxationResidual<Inner<Implicit>>::computeErrorAndParameters /
    updateStates): pass 1 solves every particle's local system
    (a^2 + c) k = error from the same configuration, pass 2 applies each
    particle's own move a k and the gathered neighbour pushes -B_ij k_j.
    The d x d systems are solved by the closed-form inverse.

    The surface correction is the sampled level set's (`levelset`: its
    overlap, gradient and second-gradient integrals, relax_stepping.cpp:
    97-110) or, without one, the flat-surface `tables` (d_grid, K, Lp, L)
    probed at the depth of `shape`.  Returns (new_pos, residual), the
    residual -error / dt^2 the reference records as
    ParticleKineticEnergy."""
    pg = pair_geometry(pos, pos, nl, kernel, dim, need_W=False)
    vol_j, _ = gather(vol, nl.idx)
    d2w = kernel.d2W(pg.r, dim) * pg.mask.to(pos.dtype)
    ee = pg.e[..., :, None] * pg.e[..., None, :]            # (N, K, d, d)
    B = 2.0 * ee * (d2w * vol_j * dtsq)[..., None, None]
    error = torch.sum((2.0 * pg.dW * vol_j * dtsq)[..., None] * pg.e, dim=1)
    eye = torch.eye(dim, dtype=pos.dtype, device=pos.device)
    a = -eye - torch.sum(B, dim=1)
    c = torch.sum(mm(B, B), dim=1)
    sg = overlap = None
    if levelset is not None:
        overlap = levelset.probe_kernel_integral(pos) * dtsq
        grad_int = levelset.probe_kernel_gradient_integral(pos)
        sg = levelset.probe_kernel_second_gradient_integral(pos)
    elif shape is not None and tables is not None:
        d_grid, K, Lp, L = (torch.as_tensor(x, dtype=pos.dtype,
                                            device=pos.device)
                            for x in tables)
        phi = shape.signed_distance(pos)
        n = shape.find_normal_direction(pos)
        depth = torch.clamp(-phi, min=0.0, max=float(d_grid[-1]))
        overlap = interp(depth, d_grid, K) * dtsq
        grad_int = interp(depth, d_grid, L)[..., None] * n
        sg = -interp(depth, d_grid, Lp)[..., None, None] * (
            n[..., :, None] * n[..., None, :])
    if sg is not None:
        error = error + 2.0 * grad_int * dtsq * (1.0 + overlap)[..., None]
        a = a - 2.0 * sg * dtsq * (1.0 + overlap)[..., None, None]
    k = mv(inv(mm(a, a) + c), error)                       # (N, d)
    # pass 2: own move + neighbour pushes (B with the receiver's volume)
    k_j, _ = gather(k, nl.idx)
    B_recv = 2.0 * ee * (d2w * dtsq)[..., None, None] \
        * vol[:, None, None, None]
    push = torch.sum(mv(B_recv, k_j), dim=1)
    return pos + mv(a, k) - push, -error / dtsq


def relax_shape_implicit_iterations(shape, pos, volume: float, adaptation,
                                    grid: CellGrid, n_iterations: int = 1000,
                                    cell_cap: int = 32, k_max: int = 48,
                                    record_every: int = 200, levelset=None):
    """The iterations of `relax_shape_implicit` from jittered, bounded
    positions (RelaxationStepLevelSetCorrectionInnerImplicit,
    relax_stepping.hpp:66-89): dt = min(sqrt(0.0625 h / max|residual|),
    0.01) from the previous iteration's residual (a device value), the
    implicit solve, the surface bounding.  Returns (positions, curve),
    curve[m] the mean |residual| after (m + 1) record_every iterations."""
    kernel, dim = adaptation.kernel, pos.shape[1]
    vol = torch.full((pos.shape[0],), volume, dtype=pos.dtype,
                     device=pos.device)
    d_grid, K, Lp = half_space_kernel_tables(kernel, dim)
    _, L = half_space_gradient_table(kernel, dim)
    tables = (d_grid, K, Lp, L)
    overflow = torch.zeros((), dtype=torch.bool, device=pos.device)
    res_max = torch.zeros((), dtype=pos.dtype, device=pos.device)
    curve = []
    p = pos
    for it in range(n_iterations):
        dt = torch.clamp(torch.sqrt(0.0625 * adaptation.h
                                    / (res_max + TINY)), max=0.01)
        nl = _inner_list(p, grid, adaptation.cutoff, cell_cap, k_max)
        overflow = overflow | nl.overflow
        p, res = implicit_relaxation_update(p, vol, nl, kernel, dim, dt * dt,
                                            shape, tables, levelset=levelset)
        p = surface_bounding(p, shape, adaptation.spacing)
        rn = torch.linalg.vector_norm(res, dim=-1)
        if (it + 1) % record_every == 0:
            curve.append(torch.mean(rn))
        res_max = torch.max(rn)
    _raise_on(overflow, "relax_shape_implicit", cell_cap, k_max)
    n_records = n_iterations // record_every
    return p, (torch.stack(curve[:n_records]) if n_records
               else p.new_zeros((0,)))


def relax_shape_implicit(shape, pos0, volume: float, adaptation,
                         grid: CellGrid, n_iterations: int = 1000,
                         cell_cap: int = 32, k_max: int = 48, seed: int = 0,
                         record_every: int = 200, levelset=None):
    """Relax `pos0` inside `shape` by the implicit level-set-corrected step
    (test_2d_implicit_relaxation): jitter, bound, then
    `relax_shape_implicit_iterations`.  Returns (positions, curve)."""
    pos = surface_bounding(randomize_positions(pos0, adaptation.spacing, seed),
                           shape, adaptation.spacing)
    return relax_shape_implicit_iterations(shape, pos, volume, adaptation,
                                           grid, n_iterations, cell_cap,
                                           k_max, record_every, levelset)


def relax_periodic_iterations(pos, volume: float, adaptation, grid: CellGrid,
                              n_iterations: int = 200, cell_cap: int = 32,
                              k_max: int = 48, box=None):
    """The iterations of `relax_periodic` from jittered, wrapped positions:
    no surface bounding, positions wrapped into the box every iteration,
    residuals with minimum-image displacements."""
    kernel, dim = adaptation.kernel, pos.shape[1]
    vol = torch.full((pos.shape[0],), volume, dtype=pos.dtype,
                     device=pos.device)
    overflow = torch.zeros((), dtype=torch.bool, device=pos.device)
    p = pos
    for _ in range(n_iterations):
        nl = _inner_list(p, grid, adaptation.cutoff, cell_cap, k_max)
        overflow = overflow | nl.overflow
        res = relaxation_residual(p, vol, nl, kernel, dim, box=box)
        p = wrap_positions(p + 0.5 * res * relaxation_scaling(res, adaptation.h),
                           grid)
    _raise_on(overflow, "relax_periodic", cell_cap, k_max)
    return p


def relax_periodic(pos0, volume: float, adaptation, grid: CellGrid,
                   n_iterations: int = 200, cell_cap: int = 32,
                   k_max: int = 48, seed: int = 0, box=None):
    """Periodic-domain relaxation (the Taylor–Green relaxed initial
    condition): jitter, wrap, then `relax_periodic_iterations`."""
    pos = wrap_positions(randomize_positions(pos0, adaptation.spacing, seed),
                         grid)
    return relax_periodic_iterations(pos, volume, adaptation, grid,
                                     n_iterations, cell_cap, k_max, box)
