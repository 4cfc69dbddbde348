"""Shell <-> fluid coupling through curvature-corrected dummy particles
(counterpart of sphinxsys_tpu/physics/shell_fluid.py; reference
particle_neighborhood/neighborhood.cpp
BaseNeighborBuilderContactFromShell::update_neighbors:259-317 and
NeighborBuilderContactFromFluidToShell:335-395; the curvature,
thin_structure_dynamics.cpp AverageShellCurvature).

A shell is one layer of surface particles, but the fluid needs the kernel
support of a solid wall behind it: a stack of dummy particles along the
shell's normal, their volumes grown or shrunk by its principal
curvatures, folds into corrected pair quantities when the pairs are
built:

  W_corr   = [W(r)   + sum_k W(d_k) f_k] spacing / thickness_j
  dWV_corr = [dW(r)  + sum_k dW(d_k) f_k] spacing
  e_corr   = [dW(r) e + sum_k dW(d_k) f_k e_k] / [dW(r) + sum_k dW(d_k) f_k]
  f_k      = (1 + k k1 D)(1 + k k2 D),  dummy k at pos_j + k D n_j

The reference's loop breaks (the dummy past the cutoff, a factor <= 0)
are masks: along a ray the dummy's distance crosses the cutoff upward
once and the factors are monotone in k.  The stack is a Python loop of
`n_dummy_static` steps in ascending k over the (N, K) tensors, built
once an advection step and passed frozen into the acoustic sub-steps.
`dummy_stack` serves physics/surface_contact.py's builders too.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from sphinxsys_tpu_torch.core.state import State
from sphinxsys_tpu_torch.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_tpu_torch.physics.pair import pair_geometry

TINY = 1.0e-15


class ShellContactPairs(NamedTuple):
    """Frozen corrected pair quantities of a fluid -> shell (or solid ->
    shell) contact, (N, K) / (N, K, dim)."""

    r: torch.Tensor      # the true distance to the shell particle
    e: torch.Tensor      # the corrected unit vector (dummy-stack weighted)
    W: torch.Tensor      # the corrected W_ij (area -> volume scaled)
    dWV: torch.Tensor    # the corrected dW (volume factors and spacing in);
                         # times the shell's area measure it is dW V_j
    n: torch.Tensor      # the direction-corrected shell normal
    mask: torch.Tensor


def shell_curvature(shell: State, nl_inner: NeighborList, kernel, dim: int,
                    normal_key: str = "NormalDirection"):
    """AverageShellCurvature: the principal curvatures (k1, k2) from the
    normal-gradient tensor dn = -sum (n_i - n_j) outer (dW V_j e_ij) over
    the shell's inner pairs built with the contact body's kernel (reduced
    once: pass it wrapped in shell.ReducedKernel).  `nl_inner` is any
    (idx-carrying) list, a ReferencePairs too."""
    n = shell[normal_key]
    pos = shell["Position"]
    pg = pair_geometry(pos, pos, nl_inner, kernel, dim, need_W=False)
    n_j, _ = gather(n, nl_inner.idx)
    vol_j, _ = gather(shell["VolumetricMeasure"], nl_inner.idx)
    gradw = (pg.dW * vol_j)[..., None] * pg.e
    dn = -torch.sum((n[:, None, :] - n_j)[..., :, None] * gradw[..., None, :],
                    dim=1)
    if dim == 2:
        k1 = dn[:, 0, 0] + dn[:, 1, 1]
        return k1, torch.zeros_like(k1)
    tr = dn[:, 0, 0] + dn[:, 1, 1] + dn[:, 2, 2]
    H = 0.5 * tr
    K = (dn[:, 0, 0] * dn[:, 1, 1] + dn[:, 0, 0] * dn[:, 2, 2]
         + dn[:, 1, 1] * dn[:, 2, 2] - dn[:, 0, 1] * dn[:, 1, 0]
         - dn[:, 0, 2] * dn[:, 2, 0] - dn[:, 1, 2] * dn[:, 2, 1])
    s = torch.sqrt(torch.clamp(H * H - K, min=0.0))
    return H + s, H - s


def n_dummy_static(kernel, shell_spacing: float) -> int:
    """The stack's length, covering every dummy the reference's loop can
    visit: within the cutoff for at most ~2 cutoff / spacing steps."""
    return int(2.0 * kernel.cutoff / shell_spacing) + 2


def dummy_stack(disp_at: Callable, k1, k2, fmask, W, dW, e, kernel, dim: int,
                shell_spacing: float):
    """The corrected totals of the normal-ray dummy stack
    (BaseNeighborBuilderContactFromShell::update_neighbors): from the
    pair's own (W, dW, e) (W may be None: not accumulated), add each dummy
    k = 1 .. n_dummy_static in turn, `disp_at(k)` the (N, K, d)
    displacement of the query from dummy k, k1 / k2 the direction-corrected
    curvatures.  Returns (W_total, dW_total, (dW e)_total)."""
    d = shell_spacing
    dWe = dW[..., None] * e
    for k in range(1, n_dummy_static(kernel, shell_spacing) + 1):
        kf = float(k)
        disp = disp_at(kf * d)
        r_dum = torch.sqrt(torch.sum(disp * disp, dim=-1) + TINY)
        f1 = 1.0 + kf * k1 * d
        f2 = 1.0 + kf * k2 * d
        ok = (r_dum < kernel.cutoff) & (f1 > 0.0) & (f2 > 0.0)
        vol_f = torch.where(ok, f1 * f2, torch.zeros_like(f1)) * fmask
        if W is not None:
            W = W + kernel.W(r_dum, dim) * vol_f
        dWd = kernel.dW(r_dum, dim) * vol_f
        dW = dW + dWd
        dWe = dWe + dWd[..., None] * (disp / r_dum[..., None])
    return W, dW, dWe


def shell_contact_pairs(pos_q, shell: State, k1, k2, nl: NeighborList,
                        kernel, dim: int, shell_spacing: float,
                        normal_correction: bool = False,
                        box=None) -> ShellContactPairs:
    """The corrected pairs of a fluid (or solid) body seeing a shell as a
    wall (NeighborBuilderContactFromShellToFluid).  `normal_correction`
    when the stored normals point from the shell toward this body (they
    must point away from it)."""
    corr = -1.0 if normal_correction else 1.0
    pg = pair_geometry(pos_q, shell["Position"], nl, kernel, dim, box=box)
    n_j, _ = gather(shell["NormalDirection"], nl.idx)
    n_j = corr * n_j
    k1_j, _ = gather(k1, nl.idx)
    k2_j, _ = gather(k2, nl.idx)
    thick_j, _ = gather(shell["Thickness"], nl.idx)
    pos_j, _ = gather(shell["Position"], nl.idx)
    W, dW, dWe = dummy_stack(
        lambda kd: pos_q[:, None, :] - (pos_j + n_j * kd),
        corr * k1_j, corr * k2_j, pg.mask.to(pg.r.dtype), pg.W, pg.dW, pg.e,
        kernel, dim, shell_spacing)
    return ShellContactPairs(
        r=pg.r, e=dWe / (dW[..., None] - TINY),        # dW < 0: no cancel
        W=W * shell_spacing / torch.clamp(thick_j, min=TINY),
        dWV=dW * shell_spacing, n=n_j, mask=pg.mask)


def fluid_to_shell_pairs(shell: State, k1, k2, fluid_pos, nl: NeighborList,
                         kernel, dim: int, shell_spacing: float,
                         normal_correction: bool = False,
                         box=None) -> ShellContactPairs:
    """The corrected pairs of the shell feeling the fluid
    (NeighborBuilderContactFromFluidToShell): the dummies stack along the
    shell's own normal at particle i; W is left uncorrected (the pressure
    force does not read it)."""
    corr = -1.0 if normal_correction else 1.0
    pos_i = shell["Position"]
    pg = pair_geometry(pos_i, fluid_pos, nl, kernel, dim, box=box)
    n_i = corr * shell["NormalDirection"]
    pos_j, _ = gather(fluid_pos, nl.idx)
    _, dW, dWe = dummy_stack(
        lambda kd: (pos_i[:, None, :] + n_i[:, None, :] * kd) - pos_j,
        (corr * k1)[:, None], (corr * k2)[:, None], pg.mask.to(pg.r.dtype),
        None, pg.dW, pg.e, kernel, dim, shell_spacing)
    return ShellContactPairs(r=pg.r, e=dWe / (dW[..., None] - TINY), W=pg.W,
                             dWV=dW * shell_spacing,
                             n=shell["NormalDirection"], mask=pg.mask)


# ---------------------------------------------------------------------------
# the fluid's terms against a shell (frozen corrected pairs)
# ---------------------------------------------------------------------------

def density_summation_shell_term(fluid: State, shell: State,
                                 pairs: ShellContactPairs, nl: NeighborList,
                                 rho0: float, sigma0: float,
                                 shell_rho0: float):
    """The contact's part of rho_sum (density_summation.cpp Contact<>):
    sigma = sum W_corr m_k / rho0_k, added as sigma rho0^2 / sigma0 / m_i."""
    mass_k, _ = gather(shell["Mass"], nl.idx)
    sigma_c = torch.sum(pairs.W * mass_k / shell_rho0, dim=1)
    return sigma_c * rho0 * rho0 / sigma0 / fluid["Mass"]


def acoustic_1st_half_shell_term(p, rho, fluid: State, shell: State,
                                 pairs: ShellContactPairs, nl: NeighborList,
                                 riemann):
    """The wall terms of the first half against a shell
    (fluid_integration.hpp:89-113 on the corrected pairs): (the force
    without V_i, the density dissipation rate)."""
    area_k, _ = gather(shell["VolumetricMeasure"], nl.idx)
    acc_ave_k, _ = gather(shell["AverageAcceleration"], nl.idx)
    dWV = pairs.dWV * area_k
    acc_prior = fluid["ForcePrior"] / fluid["Mass"][:, None]
    face_acc = torch.sum((acc_prior[:, None, :] - acc_ave_k) * (-pairs.e),
                         dim=-1)
    p_in_wall = p[:, None] + rho[:, None] * pairs.r \
        * torch.clamp(face_acc, min=0.0)
    force = -torch.sum((p[:, None] + p_in_wall)[..., None] * dWV[..., None]
                       * pairs.e, dim=1)
    rho_diss = torch.sum(riemann.dissipative_u_jump(p[:, None] - p_in_wall)
                         * dWV, dim=1)
    return force, rho_diss


def acoustic_2nd_half_shell_term(vel, fluid: State, shell: State,
                                 pairs: ShellContactPairs, nl: NeighborList,
                                 riemann):
    """The wall terms of the second half against a shell
    (fluid_integration.hpp:159-231): (the p-dissipation force without
    V_i, the density change rate).  The face normal sgn(e.n) n does not
    depend on the stored normal's orientation: the raw normals serve."""
    area_k, _ = gather(shell["VolumetricMeasure"], nl.idx)
    vel_ave_k, _ = gather(shell["AverageVelocity"], nl.idx)
    n_k, _ = gather(shell["NormalDirection"], nl.idx)
    dWV = pairs.dWV * area_k
    face_n = torch.sign(torch.sum(pairs.e * n_k, dim=-1))[..., None] * n_k
    dv = vel[:, None, :] - (2.0 * vel_ave_k - vel[:, None, :])
    dcr = torch.sum(torch.sum(dv * pairs.e, dim=-1) * dWV, dim=1)
    u_jump = 2.0 * torch.sum((vel[:, None, :] - vel_ave_k) * face_n, dim=-1)
    force = torch.sum((riemann.dissipative_p_jump(u_jump) * dWV)[..., None]
                      * face_n, dim=1)
    return force, dcr


def pressure_force_from_fluid_on_shell(shell: State, fluid: State,
                                       pairs: ShellContactPairs,
                                       nl: NeighborList,
                                       riemann) -> torch.Tensor:
    """PressureForceFromFluid (fluid_structure_interaction.hpp) on the
    shell's particles over the fluid -> shell corrected pairs: the force
    array (the caller folds it into ForcePrior)."""
    vol_k, _ = gather(fluid["VolumetricMeasure"], nl.idx)
    rho_k, _ = gather(fluid["Density"], nl.idx)
    mass_k, _ = gather(fluid["Mass"], nl.idx)
    p_k, _ = gather(fluid["Pressure"], nl.idx)
    vel_k, _ = gather(fluid["Velocity"], nl.idx)
    fprior_k, _ = gather(fluid["ForcePrior"], nl.idx)
    mask = pairs.mask.to(p_k.dtype)
    acc_ave = shell["AverageAcceleration"]
    vel_ave = shell["AverageVelocity"]
    n_i = shell["NormalDirection"]

    face_acc = torch.sum((fprior_k / torch.clamp(mass_k, min=TINY)[..., None]
                          - acc_ave[:, None, :]) * pairs.e, dim=-1)
    p_in_wall = p_k + rho_k * pairs.r * torch.clamp(face_acc, min=0.0)
    e_dot_n = torch.sum(pairs.e * n_i[:, None, :], dim=-1)
    face_to_fluid_n = -torch.sign(e_dot_n)[..., None] * n_i[:, None, :]
    u_jump = 2.0 * torch.sum((vel_k - vel_ave[:, None, :]) * face_to_fluid_n,
                             dim=-1)
    term = (riemann.dissipative_p_jump(u_jump)[..., None] * face_to_fluid_n
            + (p_in_wall + p_k)[..., None] * pairs.e)
    force = -torch.sum(term * (pairs.dWV * vol_k * mask)[..., None], dim=1)
    return force * shell["VolumetricMeasure"][:, None]
