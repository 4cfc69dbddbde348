"""Surface contact: solid <-> solid, solid <-> shell and shell <-> shell
dynamic contact and shell self contact (counterpart of
sphinxsys_tpu/physics/surface_contact.py; reference SurfaceContactRelation
/ ShellSelfContactRelation):

  * builders: NeighborBuilderSurfaceContactFromSolid (the kernel of the
    averaged smoothing length h = (h_a + h_b) / 2, W less W(dp_avg),
    neighborhood.cpp:486-529), NeighborBuilderSurfaceContactFromShell (the
    same kernel and the curvature-corrected dummy stack along the shell's
    normal, neighborhood.cpp:255-310, 478-484),
    NeighborBuilderShellSelfContact (the shell's own unreduced kernel,
    pairs far apart in the initial configuration only, each pair's
    neighbour normal turned away from i, neighborhood.cpp:403-476);
  * RepulsionFactorSummation<Contact<>>: sigma_i = sum W_ij
    ParticleVolume_j (a shell's ParticleVolume = area thickness);
  * RepulsionForce<Contact<>>: f_i = ParticleVolume_i sum_k K_ave_k
    sum_j -2 sigma* e_ij dW_ij V_j, sigma* = (sigma_i + sigma_j) / 2, the
    harmonic contact stiffness (contact_repulsion.cpp:34-75);
  * RepulsionForce<Contact<Inner<>>> (self contact) adds the acoustic
    impedance damping 0.5 sqrt(rho K) (v_i - v_j).(-e)
    (contact_repulsion.cpp:9-32).

Every builder returns SurfacePairs with the volume measures folded in, so
the factor and the force are the same for any body type.  The dummy
stack is shell_fluid.dummy_stack.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sphinxsys_tpu_torch.core.kernels import WendlandC2
from sphinxsys_tpu_torch.core.state import State
from sphinxsys_tpu_torch.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_tpu_torch.physics.pair import pair_geometry
from sphinxsys_tpu_torch.physics.shell_fluid import dummy_stack

TINY = 1.0e-15


class SurfacePairs(NamedTuple):
    """Per-(i, slot) contact quantities with the volumes folded in: the
    factor's term is Wv, the force's -2 sigma* e dWV."""

    Wv: torch.Tensor    # W_ij ParticleVolume_j (offset / dummy corrected)
    dWV: torch.Tensor   # dW_ij V_j (a shell's: the corrected dWV area_j)
    e: torch.Tensor     # the unit vector j -> i (a shell's: dummy weighted)
    mask: torch.Tensor
    idx: torch.Tensor   # the neighbour rows (for sigma_j)


def surface_kernel(h_a: float, h_b: float) -> WendlandC2:
    """The contact kernel of the averaged smoothing length
    (NeighborBuilderSurfaceContact, neighborhood.cpp:162-168)."""
    return WendlandC2(h=0.5 * (h_a + h_b))


def solid_surface_pairs(pos_q, target: State, nl: NeighborList, kernel,
                        dim: int, dp_q: float, dp_target: float,
                        box=None) -> SurfacePairs:
    """NeighborBuilderSurfaceContactFromSolid: W less the rest-separation
    offset W(dp_avg), so that the factor vanishes at a resting touch."""
    pg = pair_geometry(pos_q, target["Position"], nl, kernel, dim, box=box)
    vol_j, _ = gather(target["VolumetricMeasure"], nl.idx)
    offset = kernel.W(torch.tensor(0.5 * (dp_q + dp_target),
                                   dtype=pos_q.dtype, device=pos_q.device),
                      dim)
    W_red = torch.clamp(pg.W - offset, min=0.0) * pg.mask
    return SurfacePairs(Wv=W_red * vol_j, dWV=pg.dW * vol_j, e=pg.e,
                        mask=pg.mask, idx=nl.idx)


def _shell_pairs(pos_q, shell: State, pg, n_j, k1_j, k2_j, W, dW, fmask,
                 mask, nl, kernel, dim: int, shell_spacing: float):
    """The dummy stack along n_j, then W scaled from area to volume by
    d / thickness and multiplied by ParticleVolume = area thickness
    (Wv = W_total d area_j)."""
    pos_j, _ = gather(shell["Position"], nl.idx)
    area_j, _ = gather(shell["VolumetricMeasure"], nl.idx)
    W_t, dW_t, dWe_t = dummy_stack(
        lambda kd: pos_q[:, None, :] - (pos_j + n_j * kd), k1_j, k2_j, fmask,
        W, dW, pg.e, kernel, dim, shell_spacing)
    return SurfacePairs(Wv=W_t * shell_spacing * area_j,
                        dWV=dW_t * shell_spacing * area_j,
                        e=dWe_t / (dW_t[..., None] - TINY), mask=mask,
                        idx=nl.idx)


def shell_surface_pairs(pos_q, shell: State, k1_ave, k2_ave,
                        nl: NeighborList, kernel, dim: int,
                        shell_spacing: float,
                        normal_correction: bool = False,
                        box=None) -> SurfacePairs:
    """NeighborBuilderSurfaceContactFromShell: the shell seen as a volume
    through its dummy stack."""
    pg = pair_geometry(pos_q, shell["Position"], nl, kernel, dim, box=box)
    corr = -1.0 if normal_correction else 1.0
    n_j, _ = gather(shell["NormalDirection"], nl.idx)
    k1_j, _ = gather(k1_ave, nl.idx)
    k2_j, _ = gather(k2_ave, nl.idx)
    return _shell_pairs(pos_q, shell, pg, corr * n_j, corr * k1_j,
                        corr * k2_j, pg.W, pg.dW, pg.mask.to(pg.r.dtype),
                        pg.mask, nl, kernel, dim, shell_spacing)


def shell_self_pairs(shell: State, k1, k2, nl: NeighborList, kernel,
                     dim: int, shell_spacing: float,
                     box=None) -> SurfacePairs:
    """NeighborBuilderShellSelfContact: the unreduced own kernel; only pairs
    farther apart than the cutoff in the initial configuration touch; the
    neighbour's normal turned per pair to point from i toward j (the
    stack grows away from i).  Pass the shell's own curvatures, not the
    averaged ones."""
    pos = shell["Position"]
    pg = pair_geometry(pos, pos, nl, kernel, dim, box=box)
    pos0 = shell["InitialPosition"]
    pos0_j, _ = gather(pos0, nl.idx)
    far0 = torch.linalg.vector_norm(pos0[:, None, :] - pos0_j, dim=-1) \
        > kernel.cutoff
    mask = pg.mask & far0
    fmask = mask.to(pg.r.dtype)
    n_j, _ = gather(shell["NormalDirection"], nl.idx)
    # the direction corrector -sgn(e . n_j): the dummies extend away from i
    corr = -torch.sign(torch.sum(pg.e * n_j, dim=-1))
    k1_j, _ = gather(k1, nl.idx)
    k2_j, _ = gather(k2, nl.idx)
    return _shell_pairs(pos, shell, pg, corr[..., None] * n_j, corr * k1_j,
                        corr * k2_j, pg.W * fmask, pg.dW * fmask, fmask, mask,
                        nl, kernel, dim, shell_spacing)


# ---------------------------------------------------------------------------
# the factor and the forces (the same for any body type)
# ---------------------------------------------------------------------------

def repulsion_factor(pairs_list) -> torch.Tensor:
    """RepulsionFactorSummation<Contact<>>: sigma_i = the sum over every
    contact body of W_ij ParticleVolume_j."""
    sigma = None
    for pairs in pairs_list:
        s = torch.sum(pairs.Wv, dim=1)
        sigma = s if sigma is None else sigma + s
    return sigma


def repulsion_force(state: State, sigma, contacts,
                    particle_volume=None) -> torch.Tensor:
    """RepulsionForce<Contact<>>: `contacts` as (pairs, sigma of the other
    body, K_ave) triples; the force array (the caller folds it into
    ForcePrior).  `particle_volume`: ParticleVolume_i (VolumetricMeasure
    by default; area thickness for a shell)."""
    v_i = state["VolumetricMeasure"] if particle_volume is None \
        else particle_volume
    force = torch.zeros_like(state["Position"])
    for pairs, sigma_other, k_ave in contacts:
        sig_j, _ = gather(sigma_other, pairs.idx)
        sig_star = 0.5 * (sigma[:, None] + sig_j)
        f_k = -2.0 * torch.sum((sig_star * pairs.dWV)[..., None] * pairs.e,
                               dim=1)
        force = force + k_ave * f_k
    return force * v_i[:, None]


def self_repulsion_force(shell: State, sigma_self, pairs: SurfacePairs,
                         contact_stiffness: float, rho0: float,
                         particle_volume) -> torch.Tensor:
    """RepulsionForce<Contact<Inner<>>> (contact_repulsion.cpp:9-32) on the
    self-contact pairs: 2 (p* + the impedance term), p = sigma K, the
    acoustic impedance sqrt(rho K)."""
    impedance = (rho0 * contact_stiffness) ** 0.5
    p = sigma_self * contact_stiffness
    p_j, _ = gather(p, pairs.idx)
    p_star = 0.5 * (p[:, None] + p_j)
    vel_j, _ = gather(shell["Velocity"], pairs.idx)
    dv = shell["Velocity"][:, None, :] - vel_j
    imp_p = 0.5 * impedance * torch.sum(dv * (-pairs.e), dim=-1)
    f = -2.0 * torch.sum(((p_star + imp_p) * pairs.dWV)[..., None] * pairs.e,
                         dim=1)
    return f * particle_volume[:, None]
