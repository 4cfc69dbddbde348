"""2D oscillating beam on an anisotropic particle lattice, dp_x = 4 dp_y
(counterpart of sphinxsys_tpu/cases/anisotropic_beam_2d.py; reference
tests/2d_examples/test_2d_anisotropic_beam/test_2d_anisotropic_beam.cpp):
oscillating_beam_2d's clamped beam, material and first mode, on a 4x
coarser spacing along the beam with the AnisotropicKernel (the scaling
vector (4, 1) dp_y) restoring the kernel's consistency: 4x fewer
particles reproduce the isotropic beam.

The anisotropic gradient is a whole vector, not dW e_ij, so the frozen
pairs carry it as e := -grad_W / |grad_W|, dW := -|grad_W| (dW e is then
grad_W and every total-Lagrangian op runs unchanged); the correction
matrix (AnisotropicCorrectConfiguration, cpp:132-186) comes from the true
pair displacements against that gradient.  The list is an isotropic
search at the support's long radius, masked by the elliptical support.

    case, sim = build_case(device="cpu")                  # 280 particles
    sim = make_run_chunk(case)(sim, 0.01)
    print(sim.n_steps, tip_displacement(case, sim))
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# the beam's constants, carry, first mode and observer are the isotropic
# beam's
from sphinxsys_tpu_torch.cases.oscillating_beam_2d import (  # noqa: F401
    PL, PH, POISSON, RHO0_S, YOUNGS, BeamSim, first_mode_velocity,
    tip_displacement)
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.kernels import AnisotropicKernel
from sphinxsys_tpu_torch.core.linalg import inv, outer_sum
from sphinxsys_tpu_torch.core.materials import SaintVenantKirchhoffSolid
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.neighbors.cell_list import (build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list,
                                                        gather)
from sphinxsys_tpu_torch.physics import solid as sd
from sphinxsys_tpu_torch.solver import chunk_runner

SL = 0.02                    # the constrained length (cpp:14)
RATIO = 4.0                  # dp_x / dp_y (cpp:16)


@dataclasses.dataclass(frozen=True)
class AnisoBeamCase:
    dx: float                 # dp_y
    kernel: AnisotropicKernel
    h: float                  # the base smoothing length (y)
    material: SaintVenantKirchhoffSolid
    rp: sd.ReferencePairs
    base_mask: torch.Tensor
    n_solid: int
    w0: float                 # W at zero displacement, in float32


def freeze_anisotropic_pairs(pos0, nl: NeighborList, kernel: AnisotropicKernel,
                             dim: int) -> sd.ReferencePairs:
    """The frozen pairs with the anisotropic gradient packed into (dW, e),
    dW e = grad_W, masked by the elliptical support."""
    pos_j, mask = gather(pos0, nl.idx)
    disp = pos0[:, None, :] - pos_j
    inside = kernel.within_cutoff(disp) & mask
    W = kernel.W_disp(disp, dim)
    gvec = kernel.grad_W(disp, dim)
    gnorm = torch.sqrt(torch.sum(gvec * gvec, dim=-1))
    e = -gvec / (gnorm[..., None] + 1e-30)
    r = torch.sqrt(torch.sum(disp * disp, dim=-1))
    fm = inside.to(pos0.dtype)
    return sd.ReferencePairs(idx=nl.idx, W=W * fm, dW=-gnorm * fm, r=r,
                             e=e * fm[..., None], mask=fm)


def build_case(dy: float = PH / 10.0, dtype=PRODUCTION_DTYPE,
               k_inner: int = 128, device="cuda"):
    """The beam on its anisotropic lattice, the frozen anisotropic pairs,
    B = inv(-sum (x_i - x_j) outer grad_W V_j + 1e-6 I), the clamp
    x <= 0, the first mode's velocity.  Returns (case, sim)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    dx_big = RATIO * dy
    base = SPHAdaptation(spacing=dy, dim=2)
    kernel = AnisotropicKernel(base.kernel, (RATIO, 1.0))
    material = SaintVenantKirchhoffSolid(rho0=RHO0_S, youngs_modulus=YOUNGS,
                                         poisson_ratio=POISSON)
    xs = np.arange(-SL + dx_big / 2, PL, dx_big)
    ys = np.arange(-PH / 2 + dy / 2, PH / 2, dy)
    pos = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    solid = sd.make_elastic_solid_state(pos, dx_big * dy, material, dtype,
                                        device)

    # an isotropic search at the long radius kernel_size h RATIO (cpp:108)
    cutoff = kernel.kernel_size * base.h * RATIO
    grid = grid_from_bounds((-SL - 2 * dx_big, -PL / 2),
                            (PL + 2 * dx_big, PL / 2), cutoff)
    p0, n = solid["Position"], solid["NReal"]
    table = build_cell_table(p0, n, grid, 64)
    nl = build_neighbor_list(p0, n, p0, n, table, grid, cutoff,
                             k_max=k_inner, include_self=False)
    if bool(nl.overflow):
        raise ValueError("raise k_inner: the frozen pairs must be exact")
    rp = freeze_anisotropic_pairs(p0, nl, kernel, 2)

    # AnisotropicCorrectConfiguration (cpp:132-186), from the true
    # displacements
    pos_j, _ = gather(p0, nl.idx)
    disp = p0[:, None, :] - pos_j
    gvec = (rp.dW * rp.mask)[..., None] * rp.e
    vol_j, _ = gather(solid["VolumetricMeasure"], nl.idx)
    A = -outer_sum(disp, gvec * vol_j[..., None])
    solid["LinearGradientCorrectionMatrix"] = inv(
        A + 1e-6 * torch.eye(2, dtype=A.dtype, device=A.device))
    solid["Velocity"] = torch.as_tensor(
        first_mode_velocity(pos, material.sound_speed), dtype=dtype,
        device=device)
    # the damping's W(0), taken in float32 as the JAX package takes it
    w0 = float(kernel.W_disp(torch.zeros(2, dtype=torch.float32), 2))
    case = AnisoBeamCase(dx=dy, kernel=kernel, h=base.h, material=material,
                         rp=rp, base_mask=torch.as_tensor(pos[:, 0] <= 0.0,
                                                          device=device),
                         n_solid=len(pos), w0=w0)
    zero = torch.zeros((), dtype=dtype, device=device)
    return case, BeamSim(solid=solid, time=zero, n_steps=0, dt=zero.clone())


def _step(case: AnisoBeamCase, s: BeamSim) -> BeamSim:
    solid = sd.integration_1st_half_pk2(s.solid, case.rp, case.material,
                                        s.dt, case.h, case.w0)
    solid = sd.fix_constraint(solid, case.base_mask)
    solid = sd.integration_2nd_half(solid, case.rp, s.dt)
    # the time step from the short axis's spacing (scaling_factor, cpp:23)
    dt_next = sd.solid_acoustic_time_step(solid, case.material.sound_speed,
                                          case.h)
    return BeamSim(solid=solid, time=s.time + dt_next, n_steps=s.n_steps + 1,
                   dt=dt_next)


def make_step(case: AnisoBeamCase):
    return lambda s: _step(case, s)


def make_run_chunk(case: AnisoBeamCase):
    """run_chunk(sim, t_target): steps until sim.time >= t_target."""
    return chunk_runner(lambda s: _step(case, s))
