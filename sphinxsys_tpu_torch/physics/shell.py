"""Thin-shell (Mindlin-Reissner) structural dynamics (counterpart of
sphinxsys_tpu/physics/shell.py; reference particle_dynamics/
solid_dynamics/thin_structure_dynamics.{h,cpp} and
thin_structure_math.cpp): a shell is a mid-surface layer of particles
with a rotation degree of freedom; the pseudo-normal tracks the rotated
director, the stresses integrate through the thickness at three Gauss
points with a plane-stress correction and a 5/6 shear correction, and
the pairs exchange the resultant stress, moment and shear.

The pairs are the frozen initial configuration (`solid.ReferencePairs`),
built with the dimension-reduced kernel (`ReducedKernel`).  Rotations
follow the reference's convention: 2D stores the angle about z in
component 0; 3D stores (theta_x, theta_y, 0), the local pseudo-normal
Ry(theta_y) Rx(theta_x) e_n.

Local frames: TransformationMatrix0 = Q0 maps global -> initial local
with the last local axis along the initial normal
(vector_functions.cpp getTransformationMatrix):
    2D: Q0 = [[ n_y, -n_x],
              [ n_x,  n_y]]
    3D: the z -> n Rodrigues rotation, its rows the local axes.
F, the bending gradient, B and the rotations live in the initial local
frame; positions, velocities, pseudo-normals and the global stress and
moment in the global frame.

Products, determinants and inverses of the (N, d, d) stacks are the
closed forms of core/linalg.py, the pair contractions broadcast sums, the
JAX package's `.at[...].set` out-of-place `torch.where`s.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from sphinxsys_tpu_torch.core.linalg import det, inv, mm, mv, outer_sum
from sphinxsys_tpu_torch.core.state import State, make_base_state
from sphinxsys_tpu_torch.neighbors.neighbor_list import gather
from sphinxsys_tpu_torch.physics.solid import ReferencePairs

TINY = 1.0e-15

GAUSS_3_POINTS = (0.0, 0.7745966692414834, -0.7745966692414834)
GAUSS_3_WEIGHTS = (0.8888888888888889, 0.5555555555555556, 0.5555555555555556)
SHEAR_CORRECTION = 5.0 / 6.0


@dataclasses.dataclass(frozen=True)
class ReducedKernel:
    """The once-reduced kernel of codimension-1 surface particles
    (base_kernel.cpp Kernel::reduceOnce): a d-dimensional shell's pair
    sums run over a (d-1)-manifold, so W / dW take the (d-1)-dimensional
    normalisation."""

    base: object  # the smoothing kernel

    @property
    def h(self):
        return self.base.h

    @property
    def cutoff(self):
        return self.base.cutoff

    def W(self, r, dim: int):
        return self.base.W(r, dim - 1)

    def dW(self, r, dim: int):
        return self.base.dW(r, dim - 1)

    def w0(self, dim: int):
        return self.base.w0(dim - 1)


def _tr(M):
    return M.transpose(-1, -2)


def _set_col(M, col: int, value):
    """M with column `col` replaced by `value` ((..., d) or a scalar)."""
    d = M.shape[-1]
    sel = torch.arange(d, device=M.device) == col
    if not torch.is_tensor(value):
        value = torch.full_like(M[..., 0], value)
    return torch.where(sel, value[..., :, None], M)


def _corner(M, k: int):
    """(d, d) bool: the entry (k, k)."""
    d = M.shape[-1]
    i = torch.arange(d, device=M.device)
    return (i[:, None] == k) & (i[None, :] == k)


# ---------------------------------------------------------------------------
# 2D rotation algebra (thin_structure_math.cpp, Vec2d overloads)
# ---------------------------------------------------------------------------

def transformation_matrix_2d(n):
    """(N, 2) normals -> (N, 2, 2) global -> local maps."""
    nx, ny = n[..., 0], n[..., 1]
    return torch.stack([torch.stack([ny, -nx], dim=-1),
                        torch.stack([nx, ny], dim=-1)], dim=-2)


def rotate_pseudo_normal_2d(theta):
    """R(theta) [0, 1] = [sin, cos]."""
    return torch.stack([torch.sin(theta), torch.cos(theta)], dim=-1)


def pseudo_normal_rate_2d(theta, omega):
    return torch.stack([torch.cos(theta) * omega,
                        -torch.sin(theta) * omega], dim=-1)


def rotation_accel_from_pseudo_normal_2d(a_local, theta, omega):
    """domega/dt from the local pseudo-normal acceleration
    (getRotationFromPseudoNormal, 2D)."""
    c, s = torch.cos(theta), torch.sin(theta)
    return c * (a_local[..., 0] + s * omega * omega) \
        - s * (a_local[..., 1] + c * omega * omega)


# ---------------------------------------------------------------------------
# 3D rotation algebra (thin_structure_math.cpp, Vec3d overloads)
# ---------------------------------------------------------------------------

def transformation_matrix_3d(n):
    """(N, 3) normals -> (N, 3, 3) global -> local maps: the z -> n
    Rodrigues rotation, its rows the local axes (vector_functions.cpp:
    111-127).  The TINY guard keeps n = (0, 0, -1) finite."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    temp = 1.0 + nz
    frac = temp / (temp * temp + TINY)
    row0 = torch.stack([nz + ny * ny * frac, -nx * ny * frac, -nx], dim=-1)
    row1 = torch.stack([-nx * ny * frac, nz + nx * nx * frac, -ny], dim=-1)
    row2 = torch.stack([nx, ny, nz], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def rotate_pseudo_normal_3d(rot):
    """Ry(theta_1) Rx(theta_0) e_z = (sin t1 cos t0, -sin t0, cos t0 cos t1)."""
    s0, c0 = torch.sin(rot[..., 0]), torch.cos(rot[..., 0])
    s1, c1 = torch.sin(rot[..., 1]), torch.cos(rot[..., 1])
    return torch.stack([s1 * c0, -s0, c0 * c1], dim=-1)


def pseudo_normal_rate_3d(rot, angvel):
    """getVectorChangeRateAfterThinStructureRotation (Vec3d)."""
    s0, c0 = torch.sin(rot[..., 0]), torch.cos(rot[..., 0])
    s1, c1 = torch.sin(rot[..., 1]), torch.cos(rot[..., 1])
    w0, w1 = angvel[..., 0], angvel[..., 1]
    return torch.stack([-s0 * s1 * w0 + c0 * c1 * w1,
                        -c0 * w0,
                        -s0 * c1 * w0 - c0 * s1 * w1], dim=-1)


def rotation_accel_from_pseudo_normal_3d(a_local, rot, angvel):
    """(domega0/dt, domega1/dt, 0) from the local pseudo-normal
    acceleration (getRotationFromPseudoNormal, Vec3d); the TINY guard keeps
    the zero-angle denominator finite."""
    a0, a1, a2 = a_local[..., 0], a_local[..., 1], a_local[..., 2]
    s0, c0 = torch.sin(rot[..., 0]), torch.cos(rot[..., 0])
    s1, c1 = torch.sin(rot[..., 1]), torch.cos(rot[..., 1])
    w0, w1 = angvel[..., 0], angvel[..., 1]

    r0a = -(a2 * c1 + a0 * s1 + w1 * w1 * c0 + w0 * w0 * c0)
    r0b = s0 * w0 * w0 - a1
    acc0 = s0 * r0a + c0 * r0b

    r1a = a0 * c1 - a2 * s1 + 2.0 * w1 * w0 * s0
    r1b1 = (a0 * c0 + w1 * w1 * c0 * c0 * s1 + w0 * w0 * s1
            - a1 * s1 * s0 + 2.0 * w1 * w0 * c1 * c0 * s0)
    r1b2 = -(a2 * c0 + w1 * w1 * c1 * c0 * c0 + w0 * w0 * c1
             - a1 * c1 * s0 - 2.0 * w1 * w0 * c0 * s1 * s0)
    acc1 = (r1a * r1a * (r1b1 * c1 + r1b2 * s1)
            / (r1b1 * r1b1 + r1b2 * r1b2 + TINY))
    return torch.stack([acc0, acc1, torch.zeros_like(acc0)], dim=-1)


# ---------------------------------------------------------------------------
# dimension dispatch
# ---------------------------------------------------------------------------

def transformation_matrix(n, dim: int):
    return transformation_matrix_2d(n) if dim == 2 \
        else transformation_matrix_3d(n)


def rotate_pseudo_normal(rot, dim: int):
    """The local pseudo-normal from the rotation angles, (N, dim)."""
    if dim == 2:
        return rotate_pseudo_normal_2d(rot[..., 0])
    return rotate_pseudo_normal_3d(rot)


def pseudo_normal_rate(rot, angvel, dim: int):
    if dim == 2:
        return pseudo_normal_rate_2d(rot[..., 0], angvel[..., 0])
    return pseudo_normal_rate_3d(rot, angvel)


def rotation_accel_from_pseudo_normal(a_local, rot, angvel, dim: int):
    """(N, dim) angular acceleration, the unused trailing components 0."""
    if dim == 2:
        acc = rotation_accel_from_pseudo_normal_2d(a_local, rot[..., 0],
                                                   angvel[..., 0])
        return torch.stack([acc, torch.zeros_like(acc)], dim=-1)
    return rotation_accel_from_pseudo_normal_3d(a_local, rot, angvel)


def correction_matrix(A_local, dim: int):
    """getCorrectionMatrix: the inverse of the in-plane block, the normal
    row and column 0 (thin_structure_math.cpp:180-194)."""
    B = torch.zeros_like(A_local)
    if dim == 2:
        return torch.where(_corner(A_local, 0), 1.0 / A_local[..., :1, :1], B)
    inv2 = inv(A_local[..., :2, :2])
    return torch.cat([torch.cat([inv2, B[..., :2, 2:]], dim=-1),
                      B[..., 2:, :]], dim=-2)


def corrected_almansi_strain(almansi, nu, dim: int):
    """Plane-stress correction eps_nn = -nu tr_inplane / (1 - nu)
    (getCorrectedAlmansiStrain)."""
    tr_inplane = almansi[..., 0, 0]
    for k in range(1, dim - 1):
        tr_inplane = tr_inplane + almansi[..., k, k]
    value = (-nu * tr_inplane / (1.0 - nu))[..., None, None]
    return torch.where(_corner(almansi, dim - 1), value, almansi)


def make_shell_state(pos, normal, spacing: float, thickness: float, material,
                     dtype: torch.dtype, device, volume=None) -> State:
    """Shell particle state (SurfaceParticles, surface_particles.cpp:28-43).
    VolumetricMeasure is the mid-surface measure spacing^(d-1), or `volume`
    (the CVT generators' total_area / n); Mass carries the thickness
    factor (surface_particles.h:52, ParticleVolume = Vol thickness), so
    external (coupling) forces divide by the true mass while the stress
    relaxation's accelerations cancel it."""
    pos = np.asarray(pos)
    n, dim = pos.shape
    vol = spacing ** (dim - 1) if volume is None else volume
    state = make_base_state(pos, vol, material.rho0, dtype, device)
    state["Mass"] = state["Mass"] * torch.as_tensor(thickness, dtype=dtype,
                                                    device=device)
    normal = torch.as_tensor(np.asarray(normal), dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros((n, *shape), dtype=dtype, device=device)

    eye = torch.eye(dim, dtype=dtype, device=device).expand(n, dim, dim)
    state.update({
        "InitialPosition": state["Position"].clone(),
        "Velocity": zeros(dim), "Force": zeros(dim), "ForcePrior": zeros(dim),
        "NormalDirection": normal, "InitialNormalDirection": normal.clone(),
        "PseudoNormal": normal.clone(),
        "Rotation": zeros(dim),             # 2D: component 0 = angle about z
        "AngularVelocity": zeros(dim), "AngularAcceleration": zeros(dim),
        "Thickness": torch.full((n,), thickness, dtype=dtype, device=device),
        "DeformationGradient": eye.contiguous(),
        "DeformationRate": zeros(dim, dim),
        "BendingDeformationGradient": zeros(dim, dim),
        "BendingDeformationRate": zeros(dim, dim),
        "GlobalStress": zeros(dim, dim), "GlobalMoment": zeros(dim, dim),
        "GlobalShearStress": zeros(dim),
        "GlobalF": eye.contiguous(), "GlobalFBending": zeros(dim, dim),
        "MidSurfaceCauchyStress": zeros(dim, dim),
        "PseudoNormalRate": zeros(dim),
        "TransformationMatrix0": transformation_matrix(normal, dim),
    })
    return state


def shell_correct_configuration(shell: State, rp: ReferencePairs) -> State:
    """ShellCorrectConfiguration (thin_structure_dynamics.h:89-105): B from
    the local in-plane configuration (getCorrectionMatrix)."""
    out = dict(shell)
    dim = shell["Position"].shape[-1]
    vol_j, _ = gather(shell["VolumetricMeasure"], rp.idx)
    grad = (rp.dW * vol_j * rp.mask)[..., None] * rp.e
    r_ji = -rp.r[..., None] * rp.e
    eye = torch.eye(dim, dtype=grad.dtype, device=grad.device)
    A = outer_sum(r_ji, grad) + 1e-7 * eye
    Q0 = shell["TransformationMatrix0"]
    A_local = mm(mm(Q0, A), _tr(Q0))
    out["LinearGradientCorrectionMatrix"] = correction_matrix(A_local, dim)
    return out


def _stress_cauchy_linear(almansi, lambda0, G0):
    """sigma = lambda0 tr(eps) I + 2 G0 eps of (..., d, d) Almansi strains."""
    eye = torch.eye(almansi.shape[-1], dtype=almansi.dtype,
                    device=almansi.device)
    tr = torch.diagonal(almansi, dim1=-2, dim2=-1).sum(-1)
    return lambda0 * tr[..., None, None] * eye + 2.0 * G0 * almansi


@functools.lru_cache(maxsize=None)
def _shear_correction(dim: int, dtype, device):
    """The modelling weights: the normal row and column scaled by 5/6 each,
    the (n, n) entry 0.  Cached: a CUDA graph of the step (the gate's
    sub-cycle, cases/hydrostatic_fsi_2d.py) cannot copy from the host."""
    corr = np.ones((dim, dim))
    corr[dim - 1, :] *= SHEAR_CORRECTION
    corr[:, dim - 1] *= SHEAR_CORRECTION
    corr[dim - 1, dim - 1] = 0.0
    return torch.as_tensor(corr, dtype=dtype, device=device)


def shell_stress_relaxation_1st_half(shell: State, rp: ReferencePairs,
                                     material, dt, smoothing_length: float,
                                     n_gauss: int = 3) -> State:
    """ShellStressRelaxationFirstHalf (thin_structure_dynamics.cpp): the
    half drift, the Gauss integration through the thickness, the pair
    exchange of the resultant stress, moment and shear, the velocity and
    angular-velocity kicks."""
    out = dict(shell)
    dim = shell["Position"].shape[-1]
    rho0 = material.rho0
    nu = material.poisson_ratio
    G0 = material.shear_modulus
    lambda0 = material.lambda0
    Q0 = shell["TransformationMatrix0"]
    Q0T = _tr(Q0)
    thickness = shell["Thickness"]

    # ---- initialization ----------------------------------------------------
    pos = shell["Position"] + shell["Velocity"] * (0.5 * dt)
    rot = shell["Rotation"] + shell["AngularVelocity"] * (0.5 * dt)
    pseudo_n = mv(Q0T, rotate_pseudo_normal(rot, dim))
    F = shell["DeformationGradient"] + shell["DeformationRate"] * (0.5 * dt)
    Fb = shell["BendingDeformationGradient"] \
        + shell["BendingDeformationRate"] * (0.5 * dt)
    global_F = mm(mm(Q0T, F), Q0)
    global_Fb = mm(mm(Q0T, Fb), Q0)
    J = det(F)
    inv_T_global_F = _tr(inv(global_F))
    rho = rho0 / J

    Qc = transformation_matrix(pseudo_n, dim)   # the current local frame
    Q0c = mm(Qc, Q0T)                            # initial local -> current
    Q0cT = _tr(Q0c)

    resultant_stress = torch.zeros_like(F)
    resultant_moment = torch.zeros_like(F)
    resultant_shear = torch.zeros_like(pos)
    mid_cauchy = None
    # numerical damping scaling diag(h, ..., min(thickness, h))
    scale_diag = torch.stack(
        [torch.full_like(thickness, smoothing_length)] * (dim - 1)
        + [torch.clamp(thickness, max=smoothing_length)], dim=-1)
    cs0 = math.sqrt(G0 / rho0)
    c0 = material.sound_speed
    eye = torch.eye(dim, dtype=F.dtype, device=F.device)
    corr = _shear_correction(dim, F.dtype, F.device)
    half_th = (thickness * 0.5)[..., None, None]

    for gp, gw in zip(GAUSS_3_POINTS[:n_gauss], GAUSS_3_WEIGHTS[:n_gauss]):
        F_g = F + gp * Fb * half_th
        dF_g = shell["DeformationRate"] \
            + gp * shell["BendingDeformationRate"] * half_th
        inv_F_g = inv(F_g)
        almansi = mm(mm(Q0c, 0.5 * (eye - mm(_tr(inv_F_g), inv_F_g))), Q0cT)
        almansi = corrected_almansi_strain(almansi, nu, dim)
        cauchy = _stress_cauchy_linear(almansi, lambda0, G0)
        # NumericalDampingRightCauchy with the diagonal column scaling
        F_gT = _tr(F_g)
        strain_rate = 0.5 * (mm(_tr(dF_g), F_g) + mm(F_gT, dF_g))
        normal_rate = strain_rate * eye
        damping = 0.5 * rho0 * (cs0 * (strain_rate - normal_rate)
                                + c0 * normal_rate)
        damping = damping * scale_diag[..., None, :]
        cauchy = cauchy + mm(mm(mm(mm(Q0c, F_g), damping), F_gT), Q0cT) \
            / det(F_g)[..., None, None]
        # the shear correction and the zero normal stress
        cauchy = cauchy * corr
        if mid_cauchy is None:
            mid_cauchy = cauchy
        half_t = (0.5 * thickness * gw)[..., None, None]
        resultant_stress = resultant_stress + half_t * cauchy
        resultant_moment = resultant_moment + half_t * cauchy \
            * (gp * 0.5 * thickness)[..., None, None]
        resultant_shear = resultant_shear - half_t[..., 0] \
            * cauchy[..., :, dim - 1]
        # zeroed at every point: the next points add to the zeroed sums
        resultant_stress = _set_col(resultant_stress, dim - 1, 0.0)
        resultant_moment = _set_col(resultant_moment, dim - 1, 0.0)

    QcT = _tr(Qc)
    Jm = J[..., None, None]
    global_stress = Jm * mm(mm(mm(QcT, resultant_stress), Qc), inv_T_global_F)
    global_moment = Jm * mm(mm(mm(QcT, resultant_moment), Qc), inv_T_global_F)
    global_shear = J[..., None] * mv(QcT, resultant_shear)

    # ---- interaction ---------------------------------------------------------
    vol_j, _ = gather(shell["VolumetricMeasure"], rp.idx)
    gs_j, _ = gather(global_stress, rp.idx)
    gm_j, _ = gather(global_moment, rp.idx)
    coeff = (rp.dW * vol_j * rp.mask)[..., None]
    mass = shell["Mass"]
    force = mass[:, None] * torch.sum(
        mv(global_stress[:, None] + gs_j, rp.e) * coeff, dim=1)
    pseudo_acc = global_shear + torch.sum(
        mv(global_moment[:, None] + gm_j, rp.e) * coeff, dim=1)

    force = force / (rho0 * thickness)[..., None]
    dpseudo_n_d2t = pseudo_acc * (12.0 / (rho0 * thickness ** 3))[..., None]
    a_local = mv(Q0, dpseudo_n_d2t)
    omega = shell["AngularVelocity"]
    domega_dt = rotation_accel_from_pseudo_normal(a_local, rot, omega, dim)

    # ---- update ----------------------------------------------------------------
    vel = shell["Velocity"] + (shell["ForcePrior"] + force) \
        / mass[:, None] * dt
    out.update({
        "Position": pos, "Density": rho, "PseudoNormal": pseudo_n,
        "DeformationGradient": F, "BendingDeformationGradient": Fb,
        "GlobalF": global_F, "GlobalFBending": global_Fb,
        "GlobalStress": global_stress, "GlobalMoment": global_moment,
        "GlobalShearStress": global_shear,
        "MidSurfaceCauchyStress": mid_cauchy,
        "Force": force, "Rotation": rot,
        "AngularVelocity": omega + domega_dt * dt,
        "AngularAcceleration": domega_dt, "Velocity": vel,
    })
    return out


def shell_stress_relaxation_2nd_half(shell: State, rp: ReferencePairs,
                                     dt) -> State:
    """ShellStressRelaxationSecondHalf: the position and rotation drift,
    the deformation rates from the pair velocity and pseudo-normal-rate
    gradients, the drift of F and the bending gradient."""
    out = dict(shell)
    dim = shell["Position"].shape[-1]
    Q0 = shell["TransformationMatrix0"]
    Q0T = _tr(Q0)

    pos = shell["Position"] + shell["Velocity"] * (0.5 * dt)
    rot = shell["Rotation"] + shell["AngularVelocity"] * (0.5 * dt)
    omega = shell["AngularVelocity"]
    dpseudo_n_dt = mv(Q0T, pseudo_normal_rate(rot, omega, dim))
    pseudo_n = mv(Q0T, rotate_pseudo_normal(rot, dim))

    vel = shell["Velocity"]
    vol_j, _ = gather(shell["VolumetricMeasure"], rp.idx)
    vel_j, _ = gather(vel, rp.idx)
    dn_j, _ = gather(dpseudo_n_dt, rp.idx)
    grad = (rp.dW * vol_j * rp.mask)[..., None] * rp.e
    part1 = -outer_sum(vel[:, None] - vel_j, grad)
    part2 = -outer_sum(dpseudo_n_dt[:, None] - dn_j, grad)

    B = shell["LinearGradientCorrectionMatrix"]
    dF_dt = _set_col(mm(mm(mm(Q0, part1), Q0T), B), dim - 1,
                     mv(Q0, dpseudo_n_dt))
    dFb_dt = mm(mm(mm(Q0, part2), Q0T), B)

    out.update({
        "Position": pos, "Rotation": rot,
        "PseudoNormal": pseudo_n, "PseudoNormalRate": dpseudo_n_dt,
        "DeformationRate": dF_dt, "BendingDeformationRate": dFb_dt,
        "DeformationGradient": shell["DeformationGradient"]
        + dF_dt * (0.5 * dt),
        "BendingDeformationGradient": shell["BendingDeformationGradient"]
        + dFb_dt * (0.5 * dt),
    })
    return out


def shell_acoustic_time_step(shell: State, material, smoothing_length: float,
                             cfl: float = 0.6) -> torch.Tensor:
    """ShellAcousticTimeStepSize (thin_structure_dynamics.cpp): a 0-d
    tensor on the shell's device (no host read)."""
    def norm(v):
        return torch.linalg.vector_norm(v, dim=-1)

    accel = norm(shell["Force"] + shell["ForcePrior"]) / shell["Mass"]
    c0 = material.sound_speed
    E0, nu, rho0 = (material.youngs_modulus, material.poisson_ratio,
                    material.rho0)
    t0 = torch.minimum(torch.sqrt(smoothing_length / (accel + TINY)),
                       smoothing_length / (c0 + norm(shell["Velocity"])))
    t1 = torch.minimum(
        torch.sqrt(1.0 / (norm(shell["AngularAcceleration"]) + TINY)),
        1.0 / (norm(shell["AngularVelocity"]) + TINY))
    th = shell["Thickness"]
    t2 = smoothing_length * torch.sqrt(
        rho0 * (1.0 - nu * nu) / E0
        / (2.0 + (math.pi ** 2 / 12.0) * (1.0 - nu)
           * (1.0 + 1.5 * (smoothing_length / th) ** 2)))
    per = torch.minimum(torch.minimum(t0, t1), t2)
    return cfl * torch.min(per)


def update_shell_normal(shell: State) -> State:
    """UpdateShellNormalDirection: the current mid-surface normal from the
    local deformation gradient, turned back to the global frame
    (getNormalFromDeformationGradientTensor)."""
    out = dict(shell)
    F = shell["DeformationGradient"]
    dim = F.shape[-1]
    if dim == 2:
        c0 = F[..., :, 0]
        v = torch.stack([-c0[..., 1], c0[..., 0]], dim=-1)
    else:
        v = torch.linalg.cross(F[..., :, 0], F[..., :, 1], dim=-1)
    v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1.0e-15)
    out["NormalDirection"] = mv(_tr(shell["TransformationMatrix0"]), v)
    return out


def fix_shell(shell: State, mask) -> State:
    """The clamp of the shell cases: on the rows of `mask`, the position
    back to the initial one, the velocity, rotation and angular velocity
    0."""
    out = dict(shell)
    m = mask[:, None]
    out["Position"] = torch.where(m, shell["InitialPosition"],
                                  shell["Position"])
    for k in ("Velocity", "Rotation", "AngularVelocity"):
        out[k] = torch.where(m, torch.zeros_like(shell[k]), shell[k])
    return out
