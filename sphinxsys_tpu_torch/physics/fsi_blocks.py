"""FSI forces on a solid from a block-layout fluid (counterpart of
sphinxsys_tpu/physics/fsi_blocks.py; reference
fluid_structure_interaction.hpp): each solid particle reads the fluid
blocks of its 3^dim cell window directly, (n_s, 3^dim, cap, ch) gathers
in place of per-pair neighbour lists.  The solid is small beside the
fluid, so the re-gather every acoustic sub-step stays cheap (the
reference recomputes the same contact sums per step too,
fsi2.cpp:228-231).  Torch ops: the JAX package has no kernel here (XLA
fuses them).
"""

from __future__ import annotations

import torch

from sphinxsys_tpu_torch.neighbors.cell_blocks import cross_neighbor_blocks
from sphinxsys_tpu_torch.physics.fluid_blocks import _min_image, pack_channels
from sphinxsys_tpu_torch.physics.fsi import force_prior_update

TINY = 1.0e-15


def solid_windows(solid_pos, grid, bm_fluid, fluid_dense_map):
    """(n_s, 3^dim) fluid block rows of each solid particle's cell window
    (sentinel: the fluid's c_max, its all-padding row).  Rebuild whenever
    the fluid re-slots."""
    return cross_neighbor_blocks(grid.cell_id(solid_pos), grid, bm_fluid,
                                 src_dense_map=fluid_dense_map)


def _pair_geom_sf(solid_pos, pj_pos, box):
    """(n_s, W, cap) pair geometry (r, e), e along solid - fluid (i - j)."""
    disp = _min_image(solid_pos[:, None, None, :] - pj_pos, box)
    r = torch.sqrt(torch.sum(disp * disp, dim=-1) + TINY)
    return r, disp / (r[..., None] + TINY)


def viscous_force_from_fluid_b(solid: dict, fluid_b: dict, windows, kernel,
                               dim: int, mu: float, smoothing_length: float,
                               box=None) -> dict:
    """ViscousForceFromFluid (fluid_structure_interaction.cpp):
    F_i = V_i sum_j 2 mu 2 (v_ave_i - v_j)/(r + 0.01 h) dW V_j, through
    ForcePrior."""
    w = windows.long()
    pj = pack_channels(fluid_b["Position"], fluid_b["Velocity"],
                       fluid_b["VolumetricMeasure"])[w]   # (n_s, W, cap, 5)
    m = fluid_b["SlotMask"][w]
    r, _ = _pair_geom_sf(solid["Position"], pj[..., :dim], box)
    dWV = kernel.dW(r, dim) * m.to(r.dtype) * pj[..., 2 * dim]
    vderiv = 2.0 * (solid["AverageVelocity"][:, None, None, :]
                    - pj[..., dim:2 * dim]) \
        / (r + 0.01 * smoothing_length)[..., None]
    force = 2.0 * mu * torch.sum(vderiv * dWV[..., None], dim=(1, 2))
    force = force * solid["VolumetricMeasure"][:, None]
    return force_prior_update(solid, "ViscousForceFromFluid", force)


def pressure_force_from_fluid_b(solid: dict, fluid_b: dict, windows, kernel,
                                dim: int, riemann, box=None) -> dict:
    """PressureForceFromFluid (fluid_structure_interaction.hpp:31-60): the
    fluid's wall-contact pressure and dissipation terms mirrored onto the
    solid, through ForcePrior."""
    w = windows.long()
    pj = pack_channels(fluid_b["Position"], fluid_b["Pressure"],
                       fluid_b["Density"], fluid_b["Mass"],
                       fluid_b["Velocity"], fluid_b["VolumetricMeasure"],
                       fluid_b["ForcePrior"])[w]          # (n_s, W, cap, 10)
    m = fluid_b["SlotMask"][w]
    r, e = _pair_geom_sf(solid["Position"], pj[..., :dim], box)
    p_j = pj[..., dim]
    rho_j = pj[..., dim + 1]
    mass_j = pj[..., dim + 2]
    vel_j = pj[..., dim + 3:2 * dim + 3]
    vol_j = pj[..., 2 * dim + 3]
    fp_j = pj[..., 2 * dim + 4:3 * dim + 4]

    acc_ave = solid["AverageAcceleration"][:, None, None, :]
    vel_ave = solid["AverageVelocity"][:, None, None, :]
    n_i = solid["NormalDirection"][:, None, None, :]

    face_acc = torch.sum((fp_j / torch.clamp(mass_j, min=TINY)[..., None]
                          - acc_ave) * e, dim=-1)
    p_in_wall = p_j + rho_j * r * torch.clamp(face_acc, min=0.0)
    face_to_fluid_n = -torch.sign(torch.sum(e * n_i, dim=-1))[..., None] * n_i
    u_jump = 2.0 * torch.sum((vel_j - vel_ave) * face_to_fluid_n, dim=-1)
    term = (riemann.dissipative_p_jump(u_jump)[..., None] * face_to_fluid_n
            + (p_in_wall + p_j)[..., None] * e)
    dWV = kernel.dW(r, dim) * m.to(r.dtype) * vol_j
    force = -torch.sum(term * dWV[..., None], dim=(1, 2))
    force = force * solid["VolumetricMeasure"][:, None]
    return force_prior_update(solid, "PressureForceFromFluid", force)
