"""Momentum-conservative multi-phase surface tension (counterpart of
sphinxsys_tpu/physics/surface_tension.py; reference fluid_dynamics/
surface_tension.{h,cpp}, Zhang & Hu's stress form): the interface is a
colour gradient taken over the other phase's neighbours only; the tension
enters the momentum equation as the divergence of the tangential stress
sigma (I - n n^T) |grad C|, plus a penalty ("hourglass") force that
damps the zero-surface-energy modes.

The pair terms are torch ops over the (N, K) lists, the per-pair
(d, d) tensors (N, K, d, d) contracted by einsum in the JAX package's
order.  As there (and in the reference, surface_tension.cpp:29-52), with
several contact bodies ColorGradient and NormDirection keep the last
one's and the stress accumulates; every case has one.  Matrix norms are
Frobenius.

State keys: ColorGradient, NormDirection (N, d), SurfaceTensionStress
(N, d, d), SurfaceTensionForce and SurfaceTensionForcePrev (N, d).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from sphinxsys_tpu_torch.core.state import State, nreal_mask
from sphinxsys_tpu_torch.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_tpu_torch.physics.pair import pair_geometry

TINY = 1.0e-15


def contact_fraction(rho0_self: float, rho0_other: float) -> float:
    """rho0_i / (rho0_i + rho0_k) (surface_tension.cpp:24-26)."""
    return rho0_self / (rho0_self + rho0_other)


def _eye(dim, like):
    return torch.eye(dim, dtype=like.dtype, device=like.device)


def surface_tension_stress(fluid: State, contacts: Sequence[tuple], kernel,
                           dim: int, coeff: float, box=None) -> State:
    """SurfaceTensionStress::interaction (surface_tension.cpp:29-52).
    `contacts`: (other state, list, fraction_k) triples, fraction_k =
    contact_fraction(rho0 of this phase, rho0 of that one).  Writes
    ColorGradient, NormDirection and SurfaceTensionStress."""
    pos = fluid["Position"]
    n = pos.shape[0]
    eye = _eye(dim, pos)
    cg = torch.zeros((n, dim), dtype=pos.dtype, device=pos.device)
    norm_dir = torch.zeros_like(cg)
    stress = torch.zeros((n, dim, dim), dtype=pos.dtype, device=pos.device)
    for other, nl, frac_k in contacts:
        pg = pair_geometry(pos, other["Position"], nl, kernel, dim,
                           need_W=False, box=box)
        vol_j, _ = gather(other["VolumetricMeasure"], nl.idx)
        cg_k = -torch.sum((2.0 * frac_k * pg.dW * vol_j)[..., None] * pg.e,
                          dim=1)
        cg = cg_k                                   # overwritten, as there
        cg_norm = torch.linalg.vector_norm(cg_k, dim=-1)
        norm_dir = cg_k / (cg_norm[:, None] + TINY)
        tangent = eye - norm_dir[:, :, None] * norm_dir[:, None, :]
        stress = stress + coeff * tangent * cg_norm[:, None, None]
    out = dict(fluid)
    out["ColorGradient"] = cg
    out["NormDirection"] = norm_dir
    out["SurfaceTensionStress"] = stress
    return out


def _mismatch(cg_avg, e, r, identity_part):
    """M = (cg_avg outer e_ij) r_ij;  identity_part - M M / (|M|_F + eps)
    (surface_tension.cpp:67-69, inner with identity_part 0, and :111-112,
    contact with identity_part I); |M|_F = sqrt(sum M^2 + TINY)."""
    M = cg_avg[..., :, None] * e[..., None, :] * r[..., None, None]
    MM = torch.einsum("...ij,...jk->...ik", M, M)
    frob = torch.sqrt(torch.sum(M * M, dim=(-2, -1)) + TINY)
    return identity_part - MM / (frob[..., None, None] + TINY)


def surface_stress_force(fluid: State, nl_inner: NeighborList,
                         contacts: Sequence[tuple], kernel, dim: int,
                         coeff: float, hourglass_coeff: float = 4.5,
                         box=None) -> State:
    """SurfaceStressForceComplex (surface_tension.cpp:55-124), into
    ForcePrior by the bookkeeping ForcePrior += F - SurfaceTensionForcePrev.

    Inner:   F_i = m_i / rho_i sum_j dW V_j (S_i + S_j + HG_ij) e_ij,
             HG_ij = k sigma (T_i + T_j) / 2 mismatch / (r + eps),
             mismatch = -M M / |M| of the averaged colour gradient;
    Contact: F_i += m_i / rho_i sum_k dW V_k (2 (1 - f) S_i + 2 f S_k
             + HG^c) e_ik, HG^c = -4 f (1 - f) k sigma (n_i n_i^T + n_k
             n_k^T) / 2 mismatch^c / r, mismatch^c = I - M M / |M|."""
    pos = fluid["Position"]
    eye = _eye(dim, pos)
    cg_i = fluid["ColorGradient"]
    nd_i = fluid["NormDirection"]
    S_i = fluid["SurfaceTensionStress"]
    vol = fluid["VolumetricMeasure"]
    tangent_i = eye - nd_i[:, :, None] * nd_i[:, None, :]

    # --- inner (the same phase) ---
    pg = pair_geometry(pos, pos, nl_inner, kernel, dim, need_W=False, box=box)
    cg_j, _ = gather(cg_i, nl_inner.idx)
    nd_j, _ = gather(nd_i, nl_inner.idx)
    S_j, _ = gather(S_i, nl_inner.idx)
    vol_j, _ = gather(vol, nl_inner.idx)
    tangent_j = eye - nd_j[..., :, None] * nd_j[..., None, :]
    cg_avg = 0.5 * (cg_i[:, None, :] + cg_j)
    mism = _mismatch(cg_avg, pg.e, pg.r, 0.0)
    hg = (hourglass_coeff * coeff * 0.5
          * torch.einsum("...ij,...jk->...ik", tangent_i[:, None] + tangent_j,
                         mism)
          / (pg.r[..., None, None] + TINY))
    S_sum = S_i[:, None] + S_j + hg
    force = torch.sum((pg.dW * vol_j)[..., None]
                      * torch.einsum("...ij,...j->...i", S_sum, pg.e), dim=1)

    # --- the other phases ---
    for other, nl, frac_k in contacts:
        pgc = pair_geometry(pos, other["Position"], nl, kernel, dim,
                            need_W=False, box=box)
        cg_k, _ = gather(other["ColorGradient"], nl.idx)
        nd_k, _ = gather(other["NormDirection"], nl.idx)
        S_k, _ = gather(other["SurfaceTensionStress"], nl.idx)
        vol_k, _ = gather(other["VolumetricMeasure"], nl.idx)
        cg_avg_c = 0.5 * (cg_i[:, None, :] + cg_k)
        mism_c = _mismatch(cg_avg_c, pgc.e, pgc.r, eye)
        nn = 0.5 * (nd_i[:, None, :, None] * nd_i[:, None, None, :]
                    + nd_k[..., :, None] * nd_k[..., None, :])
        hg_c = (-4.0 * frac_k * (1.0 - frac_k) * hourglass_coeff * coeff
                * torch.einsum("...ij,...jk->...ik", nn, mism_c)
                / (pgc.r[..., None, None] + TINY))
        S_c = (2.0 * (1.0 - frac_k) * S_i[:, None] + 2.0 * frac_k * S_k
               + hg_c)
        force = force + torch.sum(
            (pgc.dW * vol_k)[..., None]
            * torch.einsum("...ij,...j->...i", S_c, pgc.e), dim=1)

    force = fluid["Mass"][:, None] * force / (fluid["Density"][:, None] + TINY)
    prev = fluid.get("SurfaceTensionForcePrev")
    if prev is None:
        prev = torch.zeros_like(force)
    out = dict(fluid)
    out["SurfaceTensionForce"] = force
    out["ForcePrior"] = fluid["ForcePrior"] + force - prev
    out["SurfaceTensionForcePrev"] = force
    return out


def surface_tension_time_step(fluid: State, eos, h_min: float, rho0: float,
                              coeff: float, cfl: float = 0.6):
    """SurfaceTensionTimeStep (fluid_time_step.cpp:33-42): the acoustic
    criterion over the rows below NReal, its signal speed floored by the
    capillary wave speed sqrt(2 pi sigma / (rho0 h)); a 0-d tensor."""
    c = eos.sound_speed(fluid["Pressure"], fluid["Density"])
    v = c + torch.linalg.vector_norm(fluid["Velocity"], dim=-1)
    reduced = torch.max(torch.where(nreal_mask(fluid), v, torch.zeros_like(v)))
    cap = math.sqrt(2.0 * math.pi * coeff / (rho0 * h_min))
    return cfl * h_min / (torch.clamp(reduced, min=cap) + TINY)
