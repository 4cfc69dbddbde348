"""WCSPH fluid ops in cell-block layout (counterpart of
sphinxsys_tpu/physics/fluid_blocks.py).

A block state is a dict of (C+1, cap, ...) tensors with the reference
variable names plus "SlotMask" ((C+1, cap) bool); row C is the all-padding
sentinel.  Three families:

* the `*_b` forms: every pair sweep a loop over the 3^dim windows of dense
  (C, cap_i, cap_j) tensor ops with explicit slot masks — the float64 CPU
  oracle held against the JAX package's `*_b` forms.  They sweep only the
  occupied rows (`occupied_rows`): later rows hold padding, which adds
  exactly zero;
* the `*_p2` forms: the same updates with the pair sums taken by
  ops/block_sweeps.py (the CUDA kernels on the card, their plain versions
  on the CPU);
* the first-generation packed acoustic halves `*_packed` (2D, cap 16, no
  periodic box): the same acoustic updates with the pair sums taken by
  ops/packed_sweeps.py on one packed (rows, 16, 8) tensor per body.

Every form takes `box`, the periodic lengths (0 on an axis that does not
wrap): pair displacements then take the minimum image.  Padding stays
inert under the wrap through the explicit slot masks here and VOL = 0 /
the mask channel in the sweeps (the wrap folds FAR-parked positions back
into range).

Reference: fluid_integration.hpp (dual-criteria WCSPH, SURVEY.md §3.2),
viscous_dynamics.hpp, transport_velocity_correction.hpp.
"""

from __future__ import annotations

import torch

from sphinxsys_tpu_torch.neighbors.cell_blocks import occupied_rows, window_offsets
from sphinxsys_tpu_torch.neighbors.cell_list import min_image
from sphinxsys_tpu_torch.ops import block_sweeps as sweeps
from sphinxsys_tpu_torch.ops import packed_sweeps as packed
from sphinxsys_tpu_torch.physics.riemann import (
    AcousticRiemannSolver, DissipativeRiemannSolver,
)

TINY = 1.0e-15


def _center_index(dim: int) -> int:
    return window_offsets(dim).index((0,) * dim)


def _min_image(disp, box):
    """Minimum-image displacement on the periodic axes (box length 0: the
    axis does not wrap)."""
    if box is None or not any(b > 0 for b in box):
        return disp
    return min_image(disp, box)


def pack_channels(*arrays):
    """Pack (C+1, cap) / (C+1, cap, d) arrays into one (C+1, cap, ch)."""
    return torch.cat([a if a.dim() == 3 else a[..., None] for a in arrays],
                     dim=-1)


def _pair_geom(pos_i, mask_i, pos_j, mask_j, w, dim, exclude_self, box=None):
    """(C, capi, capj) pair geometry (r, e, mask) given gathered j data."""
    c = pos_j.shape[0]
    disp = _min_image(pos_i[:c, :, None, :] - pos_j[:, None, :, :], box)
    r2 = torch.sum(disp * disp, dim=-1)
    r = torch.sqrt(r2 + TINY)
    e = disp / (r[..., None] + TINY)
    mask = mask_i[:c, :, None] & mask_j[:, None, :]
    if exclude_self and w == _center_index(dim):
        capi = pos_i.shape[1]
        eye = torch.eye(capi, dtype=torch.bool, device=pos_i.device)
        mask = mask & ~eye[None, :, :]
    return r, e, mask


def _pair_vec_sum(a, v):
    """sum_j a_ij v_ij: (C, capi, capj) x (C, capi, capj, dim) -> (C, capi, dim)."""
    return torch.einsum("cij,cijk->cik", a, v)


def _zero_pad(x, c):
    """Rows [:n] -> rows [:c], the rest zero."""
    return torch.cat([x, x.new_zeros((c - x.shape[0],) + tuple(x.shape[1:]))])


def _masked_max(x, mask):
    return torch.max(torch.where(mask, x, torch.zeros_like(x)))


def _pad_rows(x, like, c):
    """Concatenate computed rows [:c] with `like`'s sentinel rows."""
    return torch.cat([x, like[c:]], dim=0)


# ---------------------------------------------------------------------------
# time steps
# ---------------------------------------------------------------------------

def acoustic_time_step_b(fb, eos, h_min: float, cfl: float = 0.6):
    c = eos.sound_speed(fb["Pressure"], fb["Density"])
    speed = torch.linalg.vector_norm(fb["Velocity"], dim=-1)
    reduced = _masked_max(c + speed, fb["SlotMask"])
    return cfl * h_min / (reduced + TINY)


def advection_time_step_b(fb, h_min: float, speed_ref: float, cfl: float = 0.25):
    accel_scale = 4.0 * h_min * torch.linalg.vector_norm(
        fb["Force"] + fb["ForcePrior"], dim=-1) / torch.clamp(fb["Mass"], min=TINY)
    v2 = torch.sum(fb["Velocity"] ** 2, dim=-1)
    reduced = _masked_max(torch.maximum(v2, accel_scale), fb["SlotMask"])
    return cfl * h_min / (torch.clamp(torch.sqrt(reduced), min=speed_ref) + TINY)


# ---------------------------------------------------------------------------
# density summation
# ---------------------------------------------------------------------------

def _density_update(fb, rho_sum, c, rho0, free_surface):
    out = dict(fb)
    pad = fb["Density"]
    if free_surface:
        out["Density"] = _pad_rows(torch.clamp(rho_sum, min=rho0), pad, c)
    else:
        out["Density"] = _pad_rows(rho_sum, pad, c)
        out["VolumetricMeasure"] = torch.where(
            fb["SlotMask"], fb["Mass"] / torch.clamp(out["Density"], min=TINY),
            fb["VolumetricMeasure"])
    out["DensitySummation"] = _pad_rows(rho_sum, pad, c)
    return out


def density_summation_b(fb, nbr_inner, kernel, dim: int, rho0: float,
                        sigma0: float, wall_b=None, nbr_wall=None,
                        free_surface: bool = True, box=None):
    """rho = (w0 + sum_j W_ij) rho0/sigma0 + sum_k W_ik V_k rho0^2/(sigma0 m_i)
    (wall contact through V = m/rho0)."""
    pos, mask = fb["Position"], fb["SlotMask"]
    c, n = nbr_inner.shape[0], occupied_rows(nbr_inner)
    sigma = torch.full((c, pos.shape[1]), kernel.w0(dim), dtype=pos.dtype,
                       device=pos.device)
    for w in range(len(window_offsets(dim))):
        j = nbr_inner[:n, w].long()
        r, _, m = _pair_geom(pos, mask, pos[j], mask[j], w, dim, True, box)
        sigma[:n] = sigma[:n] + torch.sum(kernel.W(r, dim) * m.to(r.dtype), dim=2)
    rho_sum = sigma * rho0 / sigma0

    if wall_b is not None:
        wsum = torch.zeros_like(rho_sum)
        for w in range(len(window_offsets(dim))):
            j = nbr_wall[:n, w].long()
            r, _, m = _pair_geom(pos, mask, wall_b["Position"][j],
                                 wall_b["SlotMask"][j], w, dim, False, box)
            W = kernel.W(r, dim) * m.to(r.dtype)
            wsum[:n] = wsum[:n] + torch.sum(
                W * wall_b["VolumetricMeasure"][j][:, None, :], dim=2)
        rho_sum = rho_sum + wsum * rho0 * rho0 / sigma0 / torch.clamp(
            fb["Mass"][:c], min=TINY)
    return _density_update(fb, rho_sum, c, rho0, free_surface)


def density_summation_p2(fb, nbr_inner, wall_b, nbr_wall, kernel, rho0: float,
                         sigma0: float, dim: int, free_surface: bool = True,
                         box=None):
    """density_summation_b through the B1 sweep.  The sweep's fluid sum
    counts the self pair as W(0) = w0, and its wall sum uses V_k = m_k/rho0_k.

    NOTE: the fluid sum is a number density (sum W, as in the reference's
    DensitySummation<Inner> and density_summation_b), which presumes
    equal-mass fluid particles (the dambreak); for any masses this form
    and density_summation_b compute the same algebra."""
    c = nbr_inner.shape[0]
    s = sweeps.density_sweep(
        fb["Position"], fb["SlotMask"], nbr_inner,
        *_wall_args(wall_b, nbr_wall, "Position", "VolumetricMeasure"),
        inv_h=1.0 / kernel.h, factor_w=kernel._factor_w(dim), box=box)
    rho_sum = s[..., 0] * rho0 / sigma0 + s[..., 1] * rho0 * rho0 / (
        sigma0 * torch.clamp(fb["Mass"][:c], min=TINY))
    return _density_update(fb, rho_sum, c, rho0, free_surface)


def _wall_args(wall_b, nbr_wall, *keys):
    if wall_b is None:
        return (None,) * len(keys) + (None,)
    return tuple(wall_b[k] for k in keys) + (nbr_wall,)


# ---------------------------------------------------------------------------
# acoustic half-steps
# ---------------------------------------------------------------------------

def _half_step_fields(fb, eos, dt):
    mask = fb["SlotMask"]
    rho = torch.where(mask, fb["Density"] + fb["DensityChangeRate"] * (0.5 * dt),
                      fb["Density"])
    p = eos.pressure(rho)
    pos = fb["Position"] + torch.where(mask[..., None], fb["Velocity"] * (0.5 * dt),
                                       torch.zeros_like(fb["Velocity"]))
    return rho, p, pos


def _first_half_update(fb, force, rd, rho, p, pos, dt, c):
    out = dict(fb)
    mask = fb["SlotMask"]
    vol = fb["VolumetricMeasure"]
    force_total = fb["Force"] + torch.cat(
        [force * vol[:c][..., None], torch.zeros_like(fb["Force"][c:])], dim=0)
    drho_dt = torch.cat([rd * rho[:c], fb["DensityChangeRate"][c:]], dim=0)
    acc = (fb["ForcePrior"] + force_total) / torch.clamp(
        fb["Mass"], min=TINY)[..., None]
    vel = fb["Velocity"] + torch.where(mask[..., None], acc * dt,
                                       torch.zeros_like(acc))
    out.update({"Density": rho, "Pressure": p, "Position": pos,
                "Force": force_total, "DensityChangeRate": drho_dt,
                "Velocity": vel})
    return out


def _second_half_update(fb, force, dcr, pos, dt, c):
    out = dict(fb)
    mask = fb["SlotMask"]
    rho = fb["Density"]
    drho_dt = fb["DensityChangeRate"] + torch.cat(
        [dcr * rho[:c], torch.zeros_like(rho[c:])], dim=0)
    force_full = torch.cat([force, torch.zeros_like(fb["Velocity"][c:])], dim=0)
    rho_new = torch.where(mask, rho + drho_dt * (0.5 * dt), rho)
    out.update({"Position": pos, "DensityChangeRate": drho_dt,
                "Force": force_full, "Density": rho_new})
    return out


def acoustic_step_1st_half_b(fb, nbr_inner, kernel, dim: int, eos, riemann, dt,
                             wall_b=None, nbr_wall=None, box=None):
    mask = fb["SlotMask"]
    rho, p, pos = _half_step_fields(fb, eos, dt)
    vol = fb["VolumetricMeasure"]
    c, n = nbr_inner.shape[0], occupied_rows(nbr_inner)
    n_w = len(window_offsets(dim))

    force = torch.zeros_like(fb["Velocity"][:n])
    rho_diss = torch.zeros_like(p[:n])
    p_i = p[:n, :, None]
    for w in range(n_w):
        j = nbr_inner[:n, w].long()
        r, e, m = _pair_geom(pos, mask, pos[j], mask[j], w, dim, True, box)
        dWV = kernel.dW(r, dim) * m.to(r.dtype) * vol[j][:, None, :]
        p_j = p[j][:, None, :]
        force = force - _pair_vec_sum((p_i + p_j) * dWV, e)
        rho_diss = rho_diss + torch.sum(
            riemann.dissipative_u_jump(p_i - p_j) * dWV, dim=2)

    if wall_b is not None:
        acc_prior = fb["ForcePrior"] / torch.clamp(fb["Mass"], min=TINY)[..., None]
        for w in range(n_w):
            j = nbr_wall[:n, w].long()
            r, e, m = _pair_geom(pos, mask, wall_b["Position"][j],
                                 wall_b["SlotMask"][j], w, dim, False, box)
            dWV = kernel.dW(r, dim) * m.to(r.dtype) \
                * wall_b["VolumetricMeasure"][j][:, None, :]
            wall_acc = wall_b["AverageAcceleration"][j][:, None, :, :]
            face_acc = torch.sum((acc_prior[:n, :, None, :] - wall_acc) * (-e),
                                 dim=-1)
            p_in_wall = p_i + rho[:n, :, None] * r * torch.clamp(face_acc, min=0.0)
            force = force - _pair_vec_sum((p_i + p_in_wall) * dWV, e)
            rho_diss = rho_diss + torch.sum(
                riemann.dissipative_u_jump(p_i - p_in_wall) * dWV, dim=2)
    return _first_half_update(fb, _zero_pad(force, c), _zero_pad(rho_diss, c),
                              rho, p, pos, dt, c)


def acoustic_step_2nd_half_b(fb, nbr_inner, kernel, dim: int, riemann, dt,
                             wall_b=None, nbr_wall=None, box=None):
    mask = fb["SlotMask"]
    pos = _second_half_pos(fb, dt)
    vel = fb["Velocity"]
    vol = fb["VolumetricMeasure"]
    c, n = nbr_inner.shape[0], occupied_rows(nbr_inner)
    n_w = len(window_offsets(dim))

    dcr = torch.zeros_like(fb["Density"][:n])
    p_diss = torch.zeros_like(vel[:n])
    v_i = vel[:n, :, None, :]
    for w in range(n_w):
        j = nbr_inner[:n, w].long()
        r, e, m = _pair_geom(pos, mask, pos[j], mask[j], w, dim, True, box)
        dWV = kernel.dW(r, dim) * m.to(r.dtype) * vol[j][:, None, :]
        u_jump = torch.sum((v_i - vel[j][:, None, :, :]) * e, dim=-1)
        dcr = dcr + torch.sum(u_jump * dWV, dim=2)
        p_diss = p_diss + _pair_vec_sum(
            riemann.dissipative_p_jump(u_jump) * dWV, e)
    force = p_diss * vol[:n][..., None]

    if wall_b is not None:
        for w in range(n_w):
            j = nbr_wall[:n, w].long()
            r, e, m = _pair_geom(pos, mask, wall_b["Position"][j],
                                 wall_b["SlotMask"][j], w, dim, False, box)
            dWV = kernel.dW(r, dim) * m.to(r.dtype) \
                * wall_b["VolumetricMeasure"][j][:, None, :]
            vel_ave = wall_b["AverageVelocity"][j][:, None, :, :]
            n_k = wall_b["NormalDirection"][j][:, None, :, :]
            face_n = torch.sign(torch.sum(e * n_k, dim=-1))[..., None] * n_k
            vel_in_wall = 2.0 * vel_ave - v_i
            dcr = dcr + torch.sum(torch.sum((v_i - vel_in_wall) * e, dim=-1) * dWV,
                                  dim=2)
            u_jump_w = 2.0 * torch.sum((v_i - vel_ave) * face_n, dim=-1)
            force = force + _pair_vec_sum(
                riemann.dissipative_p_jump(u_jump_w) * dWV, face_n) \
                * vol[:n][..., None]
    return _second_half_update(fb, _zero_pad(force, c), _zero_pad(dcr, c), pos,
                               dt, c)


def acoustic_step_1st_half_p2(fb, nbr_inner, wall_b, nbr_wall, kernel, eos,
                              riemann, dt, dim: int, wall_static: bool = False,
                              box=None):
    """acoustic_step_1st_half_b through the B2 sweep.  `wall_static` drops
    the wall acceleration channel (identically zero for fixed walls)."""
    rho, p, pos = _half_step_fields(fb, eos, dt)
    c = nbr_inner.shape[0]
    acc_prior = fb["ForcePrior"] / torch.clamp(fb["Mass"], min=TINY)[..., None]
    wall = _wall_args(wall_b, nbr_wall, "Position", "VolumetricMeasure",
                      "AverageAcceleration")
    if wall_static and wall_b is not None:
        wall = wall[:2] + (None,) + wall[3:]
    inv_h = 1.0 / kernel.h
    out = sweeps.ac1_sweep(
        pos, p, rho, acc_prior, fb["VolumetricMeasure"], nbr_inner, *wall,
        inv_h=inv_h, dw_scale=kernel._factor_w(dim) * inv_h * 0.625,
        inv_rho0c0=riemann.inv_rho0c0_ave, box=box)
    return _first_half_update(fb, out[..., :dim], out[..., dim], rho, p, pos,
                              dt, c)


def ac2_limiter(riemann):
    """(rho0c0_geo, limiter_coeff) that JAX's Pallas paths pass the 2nd-half
    sweeps for a solver, tested in JAX's order (Dissipative before its base
    class Acoustic):
      * Dissipative: limiter 1e30, so min(1e30 inv_c0 max(u, 0), 1) is 1
        for u > 0 but 0 for u <= 0, where its `*_b` form (limiter == 1)
        keeps rho0c0_geo u;
      * Acoustic: its own limiter_coeff;
      * No: rho0c0_geo = 0 and limiter 1 — it still carries a non-zero
        rho0c0_geo_ave, which would add dissipation that its `*_b` form
        does not have."""
    if isinstance(riemann, DissipativeRiemannSolver):
        return riemann.rho0c0_geo_ave, 1.0e30
    if isinstance(riemann, AcousticRiemannSolver):
        return riemann.rho0c0_geo_ave, riemann.limiter_coeff
    return 0.0, 1.0


def ac2_dissipation(riemann):
    """(rho0c0_geo, lim_scale) of the B3 sweep for a 2nd-half solver:
    lim_scale = limiter_coeff * inv_c0_ave, formed in double as JAX's
    static-float product is (`ac2_limiter`)."""
    geo, limiter = ac2_limiter(riemann)
    return geo, limiter * riemann.inv_c0_ave


def _second_half_pos(fb, dt):
    mask = fb["SlotMask"]
    return fb["Position"] + torch.where(mask[..., None],
                                        fb["Velocity"] * (0.5 * dt),
                                        torch.zeros_like(fb["Velocity"]))


def acoustic_step_2nd_half_p2(fb, nbr_inner, wall_b, nbr_wall, kernel, riemann,
                              dt, dim: int, wall_static: bool = False, box=None):
    """acoustic_step_2nd_half_b through the B3 sweep.  `wall_static` drops
    the wall velocity channel."""
    geo, lim_scale = ac2_dissipation(riemann)
    pos = _second_half_pos(fb, dt)
    vol = fb["VolumetricMeasure"]
    c = nbr_inner.shape[0]
    wall = _wall_args(wall_b, nbr_wall, "Position", "VolumetricMeasure",
                      "AverageVelocity", "NormalDirection")
    if wall_static and wall_b is not None:
        wall = wall[:2] + (None,) + wall[3:]
    inv_h = 1.0 / kernel.h
    out = sweeps.ac2_sweep(
        pos, fb["Velocity"], vol, nbr_inner, *wall, inv_h=inv_h,
        dw_scale=kernel._factor_w(dim) * inv_h * 0.625,
        rho0c0_geo=geo, lim_scale=lim_scale, box=box)
    force = out[..., 1:] * vol[:c][..., None]
    return _second_half_update(fb, force, out[..., 0], pos, dt, c)


# ---------------------------------------------------------------------------
# first-generation packed acoustic halves (2D, Wendland C2, cap 16,
# non-periodic): the pair sums through ops/packed_sweeps.py (B5a-d), one
# packed (rows, 16, 8) tensor per body; the update stages are the *_p2 ones
# ---------------------------------------------------------------------------

def pack_wall_ac1(wall_b):
    """Static wall tensor of the 1st-half wall sweep:
    [x, y, vol, ax, ay, mask, 0, 0]."""
    m = wall_b["SlotMask"].to(wall_b["VolumetricMeasure"].dtype)
    z = torch.zeros_like(m)
    pos, acc = wall_b["Position"], wall_b["AverageAcceleration"]
    return torch.stack([pos[..., 0], pos[..., 1], wall_b["VolumetricMeasure"],
                        acc[..., 0], acc[..., 1], m, z, z], dim=-1)


def pack_wall_ac2(wall_b):
    """Static wall tensor of the 2nd-half wall sweep:
    [x, y, vol, vax, vay, nx, ny, mask]."""
    m = wall_b["SlotMask"].to(wall_b["VolumetricMeasure"].dtype)
    pos, vel = wall_b["Position"], wall_b["AverageVelocity"]
    n = wall_b["NormalDirection"]
    return torch.stack([pos[..., 0], pos[..., 1], wall_b["VolumetricMeasure"],
                        vel[..., 0], vel[..., 1], n[..., 0], n[..., 1], m],
                       dim=-1)


def _check_packed_case(fb, box):
    """The packed sweeps are 2D, cap 16 and non-periodic only."""
    if fb["Position"].shape[-1] != 2:
        raise ValueError("the packed acoustic halves are 2D only")
    if fb["Position"].shape[1] != packed.CAP:
        raise ValueError(f"the packed acoustic halves take cap {packed.CAP}, "
                         f"got {fb['Position'].shape[1]}")
    if box is not None and any(b > 0 for b in box):
        raise ValueError("the packed acoustic halves do not wrap a periodic box")


def packed_ac1_inputs(fb, eos, dt):
    """The 1st half's half-step fields and its sweeps' packed tensors:
    (rho, p, pos, packed [x, y, vx, vy, p, vol, mask, 0],
    packed_i [x, y, p, rho, ax, ay, mask, 0] of the wall sweep)."""
    mask = fb["SlotMask"]
    rho, p, pos = _half_step_fields(fb, eos, dt)
    acc = fb["ForcePrior"] / torch.clamp(fb["Mass"], min=TINY)[..., None]
    z = torch.zeros_like(p)
    packed_i = torch.stack([pos[..., 0], pos[..., 1], p, rho, acc[..., 0],
                            acc[..., 1], mask.to(p.dtype), z], dim=-1)
    return (rho, p, pos, packed.pack_state_2d(
        pos, fb["Velocity"], p, fb["VolumetricMeasure"], mask), packed_i)


def packed_ac2_inputs(fb, dt):
    """The 2nd half's positions and its sweeps' packed tensors: (pos,
    packed [x, y, vx, vy, p, vol, mask, 0],
    packed_i [x, y, vx, vy, mask, 0, 0, 0] of the wall sweep)."""
    mask, vel, vol = fb["SlotMask"], fb["Velocity"], fb["VolumetricMeasure"]
    pos = _second_half_pos(fb, dt)
    z = torch.zeros_like(vol)
    packed_i = torch.stack([pos[..., 0], pos[..., 1], vel[..., 0], vel[..., 1],
                            mask.to(vol.dtype), z, z, z], dim=-1)
    return pos, packed.pack_state_2d(pos, vel, fb["Pressure"], vol,
                                     mask), packed_i


def packed_ac1_constants(kernel, riemann):
    """Keyword constants of the 1st-half packed sweeps."""
    return dict(kernel_h=kernel.h, factor_w=kernel._factor_w(2),
                inv_rho0c0_ave=riemann.inv_rho0c0_ave)


def packed_ac2_constants(kernel, riemann):
    """Keyword constants of the 2nd-half packed sweeps; the Dissipative
    solver gets limiter 1e30 (`ac2_limiter`), as in JAX."""
    geo, limiter = ac2_limiter(riemann)
    return dict(kernel_h=kernel.h, factor_w=kernel._factor_w(2),
                rho0c0_geo=geo, inv_c0=riemann.inv_c0_ave,
                limiter_coeff=limiter)


def acoustic_step_1st_half_packed(fb, nbr_inner, kernel, eos, riemann, dt,
                                  wall_packed=None, nbr_wall=None, box=None):
    """acoustic_step_1st_half_b through the B5a (inner) and B5c (wall)
    sweeps; counterpart of JAX's `acoustic_step_1st_half_pallas`.
    `wall_packed` is `pack_wall_ac1(wall_b)`."""
    _check_packed_case(fb, box)
    rho, p, pos, pk, pk_i = packed_ac1_inputs(fb, eos, dt)
    consts = packed_ac1_constants(kernel, riemann)
    force, rd = packed.ac1_inner_sweep(pk, nbr_inner, **consts)
    if wall_packed is not None:
        force_w, rd_w = packed.ac1_wall_sweep(pk_i, wall_packed, nbr_wall,
                                              **consts)
        force = force + force_w
        rd = rd + rd_w
    return _first_half_update(fb, force, rd, rho, p, pos, dt,
                              nbr_inner.shape[0])


def acoustic_step_2nd_half_packed(fb, nbr_inner, kernel, riemann, dt,
                                  wall_packed=None, nbr_wall=None, box=None):
    """acoustic_step_2nd_half_b through the B5b (inner) and B5d (wall)
    sweeps; counterpart of JAX's `acoustic_step_2nd_half_pallas`.  The wall
    term uses the same solver as the inner one; `wall_packed` is
    `pack_wall_ac2(wall_b)`."""
    _check_packed_case(fb, box)
    pos, pk, pk_i = packed_ac2_inputs(fb, dt)
    consts = packed_ac2_constants(kernel, riemann)
    dcr, pdiss = packed.ac2_inner_sweep(pk, nbr_inner, **consts)
    if wall_packed is not None:
        dcr_w, pdiss_w = packed.ac2_wall_sweep(pk_i, wall_packed, nbr_wall,
                                               **consts)
        dcr = dcr + dcr_w
        pdiss = pdiss + pdiss_w
    c = nbr_inner.shape[0]
    return _second_half_update(fb, pdiss * fb["VolumetricMeasure"][:c][..., None],
                               dcr, pos, dt, c)


# ---------------------------------------------------------------------------
# viscous force + transport-velocity correction
# ---------------------------------------------------------------------------

def advection_viscous_time_step_b(fb, h_min: float, speed_ref: float,
                                  rho0: float, mu: float, cfl: float = 0.25):
    """AdvectionViscousTimeStep: the viscous diffusion speed mu/(rho0 h)
    joins U_ref (fluid_time_step.cpp)."""
    return advection_time_step_b(fb, h_min, max(mu / rho0 / h_min, speed_ref),
                                 cfl)


def _viscous_update(fb, force, c):
    """ForcePrior += this step's viscous force - the previous step's."""
    force_full = torch.cat([force, torch.zeros_like(fb["Velocity"][c:])], dim=0)
    out = dict(fb)
    prev = fb.get("ViscousForcePrev", torch.zeros_like(force_full))
    out["ForcePrior"] = fb["ForcePrior"] + force_full - prev
    out["ViscousForcePrev"] = force_full
    return out


def _tvc_update(fb, incon, c, h_ref, coefficient, limiter_slope):
    """x_i += coef h^2 limiter(h^2 |I|^2) I_i on the real slots."""
    h2 = h_ref * h_ref
    if limiter_slope is not None:
        sq = torch.sum(incon ** 2, dim=-1)
        lim = torch.clamp(limiter_slope * h2 * sq, max=1.0)[..., None]
    else:
        lim = 1.0
    shift = coefficient * h2 * lim * incon
    pos = fb["Position"]
    shift_full = torch.cat([shift, torch.zeros_like(pos[c:])], dim=0)
    out = dict(fb)
    out["Position"] = torch.where(fb["SlotMask"][..., None], pos + shift_full,
                                  pos)
    return out


def viscous_force_b(fb, nbr_inner, kernel, dim: int, mu: float,
                    smoothing_length: float, wall_b=None, nbr_wall=None,
                    box=None):
    """F_i = 2 mu V_i sum_j (v_i - v_j)/(r + 0.01 h) dW V_j, the wall jump
    doubled against the averaged wall velocity (viscous_dynamics.hpp);
    ForcePrior bookkeeping included."""
    pos, vel, mask = fb["Position"], fb["Velocity"], fb["SlotMask"]
    vol = fb["VolumetricMeasure"]
    eps_r = 0.01 * smoothing_length
    c, n = nbr_inner.shape[0], occupied_rows(nbr_inner)
    v_i = vel[:n, :, None, :]
    force = torch.zeros_like(vel[:n])
    for w in range(len(window_offsets(dim))):
        j = nbr_inner[:n, w].long()
        r, _, m = _pair_geom(pos, mask, pos[j], mask[j], w, dim, True, box)
        dWV = kernel.dW(r, dim) * m.to(r.dtype) * vol[j][:, None, :]
        vderiv = (v_i - vel[j][:, None, :, :]) / (r + eps_r)[..., None]
        force = force + torch.sum(vderiv * dWV[..., None], dim=2)

    if wall_b is not None:
        for w in range(len(window_offsets(dim))):
            j = nbr_wall[:n, w].long()
            r, _, m = _pair_geom(pos, mask, wall_b["Position"][j],
                                 wall_b["SlotMask"][j], w, dim, False, box)
            dWV = kernel.dW(r, dim) * m.to(r.dtype) \
                * wall_b["VolumetricMeasure"][j][:, None, :]
            vel_ave = wall_b["AverageVelocity"][j][:, None, :, :]
            vderiv = 2.0 * (v_i - vel_ave) / (r + eps_r)[..., None]
            force = force + torch.sum(vderiv * dWV[..., None], dim=2)
    force = 2.0 * mu * _zero_pad(force, c) * vol[:c][..., None]
    return _viscous_update(fb, force, c)


def transport_velocity_correction_b(fb, nbr_inner, kernel, dim: int,
                                    h_ref: float, coefficient: float = 0.2,
                                    limiter_slope: float | None = None,
                                    wall_b=None, nbr_wall=None, box=None):
    """I_i = -sum_j 2 dW V_j e_ij (+ wall terms);
    x_i += coef h^2 limiter(h^2 |I|^2) I_i
    (transport_velocity_correction.hpp:37-67)."""
    pos, mask = fb["Position"], fb["SlotMask"]
    vol = fb["VolumetricMeasure"]
    c, n = nbr_inner.shape[0], occupied_rows(nbr_inner)
    incon = torch.zeros_like(pos[:n])
    for w in range(len(window_offsets(dim))):
        j = nbr_inner[:n, w].long()
        r, e, m = _pair_geom(pos, mask, pos[j], mask[j], w, dim, True, box)
        dWV = kernel.dW(r, dim) * m.to(r.dtype) * vol[j][:, None, :]
        incon = incon - torch.sum((2.0 * dWV)[..., None] * e, dim=2)

    if wall_b is not None:
        for w in range(len(window_offsets(dim))):
            j = nbr_wall[:n, w].long()
            r, e, m = _pair_geom(pos, mask, wall_b["Position"][j],
                                 wall_b["SlotMask"][j], w, dim, False, box)
            dWV = kernel.dW(r, dim) * m.to(r.dtype) \
                * wall_b["VolumetricMeasure"][j][:, None, :]
            incon = incon - torch.sum((2.0 * dWV)[..., None] * e, dim=2)
    return _tvc_update(fb, _zero_pad(incon, c), c, h_ref, coefficient,
                       limiter_slope)


def visc_tvc_p2(fb, nbr_inner, wall_b, nbr_wall, kernel, dim: int, mu: float,
                smoothing_length: float, tvc_coefficient: float = 0.2,
                tvc_limiter_slope: float | None = None,
                wall_static: bool = False, box=None):
    """viscous_force_b + transport_velocity_correction_b through the one B4
    sweep: both read the same j data, so one window pass gives both sums
    (the TVC shift is applied after, so the viscous sum sees the positions
    before it, as in the two-pass form).  Each update applies where its
    coefficient (`mu`, `tvc_coefficient`) is positive.  `wall_static` drops
    the wall velocity channel."""
    pos, vel = fb["Position"], fb["Velocity"]
    vol = fb["VolumetricMeasure"]
    c = nbr_inner.shape[0]
    wall = _wall_args(wall_b, nbr_wall, "Position", "VolumetricMeasure",
                      "AverageVelocity")
    if wall_static and wall_b is not None:
        wall = wall[:2] + (None,) + wall[3:]
    inv_h = 1.0 / kernel.h
    s = sweeps.visc_tvc_sweep(
        pos, vel, vol, nbr_inner, *wall, inv_h=inv_h,
        dw_scale=kernel._factor_w(dim) * inv_h * 0.625,
        eps_r=0.01 * smoothing_length, box=box)
    out = fb
    if mu > 0.0:
        out = _viscous_update(out, 2.0 * mu * s[..., :dim] * vol[:c][..., None],
                              c)
    if tvc_coefficient > 0.0:
        out = _tvc_update(out, s[..., dim:], c, smoothing_length,
                          tvc_coefficient, tvc_limiter_slope)
    return out
