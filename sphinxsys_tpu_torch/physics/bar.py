"""Slender-bar (beam) dynamics, the two-director reduced-dimension solid
(counterpart of sphinxsys_tpu/physics/bar.py; reference
src/for_3D_build/particle_dynamics/solid_dynamics/
slender_structure_dynamics.{h,cpp} and slender_structure_math.cpp): a
line of particles carries a pseudo-normal and a pseudo-binormal director;
the stresses integrate over the rectangular cross-section by a four-point
Gauss rule, and the pairs exchange the resultant stress, two moments and
two shear stresses.

The JAX package's conventions, each the reference's:
  * the local frame Q0 = getTransformationMatrix(n0, b0) has the rows
    (b x n axial, b binormal, n normal); F's columns 2 and 1 are
    overwritten by the rotated directors' rates;
  * the correction matrix keeps only the axial (0, 0) entry
    (slender_structure_math.cpp:116-121);
  * the angular accelerations keep only the axial component of each local
    director acceleration (slender_structure_math.cpp:77-88);
  * both director accelerations scale with 12/(rho0 t^4), the binormal's
    with a minus sign (slender_structure_dynamics.h:209-211);
  * the stress resultant zeroes its columns 1 and 2 only, as the shell
    does (thin_structure_dynamics.cpp:208), which keeps the shear rows as
    the bent bar's restoring force (the JAX package's deviation from
    slender_structure_dynamics.cpp:225-239).

3D only, as in the reference.  Products of the (N, 3, 3) stacks are the
closed forms of core/linalg.py.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sphinxsys_tpu_torch.core.linalg import det, inv, mm, mv, outer_sum
from sphinxsys_tpu_torch.core.state import State
from sphinxsys_tpu_torch.neighbors.neighbor_list import gather
from sphinxsys_tpu_torch.physics.shell import _stress_cauchy_linear
from sphinxsys_tpu_torch.physics.solid import ReferencePairs

TINY = 1.0e-15
SHEAR_CORRECTION = 5.0 / 6.0

# the four-point 2D Gauss rule (slender_structure_dynamics.h:245-249)
_G4 = 1.0 / math.sqrt(3.0)
GAUSS4_X = (-_G4, _G4, _G4, -_G4)
GAUSS4_Y = (-_G4, -_G4, _G4, _G4)
GAUSS4_W = (1.0, 1.0, 1.0, 1.0)

LOCAL_N0 = (0.0, 0.0, 1.0)
LOCAL_B0 = (0.0, 1.0, 0.0)


def _shear_correction() -> np.ndarray:
    """The cross-section's stress weights: rows and columns 1 and 2 scaled
    by 5/6 each, the (1, 1) and (2, 2) entries zero."""
    corr = np.ones((3, 3))
    for k in (2, 1):
        corr[k, :] *= SHEAR_CORRECTION
        corr[:, k] *= SHEAR_CORRECTION
    corr[1, 1] = corr[2, 2] = 0.0
    return corr


@dataclasses.dataclass(frozen=True)
class LineKernel:
    """The twice-reduced kernel of codimension-2 line particles
    (base_kernel.cpp Kernel::reduceTwice): a bar's pair sums run over a 1D
    manifold, so W / dW take the 1D normalisation."""

    base: object  # the smoothing kernel

    @property
    def h(self):
        return self.base.h

    @property
    def cutoff(self):
        return self.base.cutoff

    def W(self, r, dim: int):
        return self.base.W(r, dim - 2)

    def dW(self, r, dim: int):
        return self.base.dW(r, dim - 2)

    def w0(self, dim: int):
        return self.base.w0(dim - 2)


def transformation_matrix_bar(n, b):
    """getTransformationMatrix(direction_of_z=n, direction_of_y=b)
    (vector_functions.cpp:130-139): rows (b x n, b, n)."""
    return torch.stack([torch.linalg.cross(b, n, dim=-1), b, n], dim=-2)


def rotate_vector(rotation, v0):
    """getVectorAfterThinStructureRotation (Rodrigues with the reference's
    regularisation, slender_structure_math.cpp:10-26): v0 turned by the
    rotation vector of each row."""
    theta = torch.linalg.vector_norm(rotation, dim=-1)
    rx, ry, rz = rotation[..., 0], rotation[..., 1], rotation[..., 2]
    z = torch.zeros_like(rx)
    R1 = torch.stack([torch.stack([z, -rz, ry], -1),
                      torch.stack([rz, z, -rx], -1),
                      torch.stack([-ry, rx, z], -1)], -2)
    eye = torch.eye(3, dtype=rotation.dtype, device=rotation.device)
    s = (torch.sin(theta) / (theta + 1e-15))[..., None, None]
    c = ((1.0 - torch.cos(theta)) / (theta * theta + 1e-15))[..., None, None]
    R = eye + s * R1 + c * mm(R1, R1)
    return mv(R, torch.as_tensor(v0, dtype=rotation.dtype,
                                 device=rotation.device))


def make_bar_state(pos, normal, binormal, spacing: float, thickness: float,
                   width: float, material, dtype: torch.dtype,
                   device) -> State:
    """A line of bar particles.  VolumetricMeasure is the linear measure
    (the spacing); Mass = rho0 spacing thickness width."""
    pos = torch.as_tensor(np.array(pos), dtype=dtype, device=device)
    n = pos.shape[0]

    def rows(v):
        return torch.as_tensor(v, dtype=dtype, device=device).expand(n, 3) \
            .contiguous()

    def full(v):
        return torch.full((n,), v, dtype=dtype, device=device)

    normal, binormal = rows(normal), rows(binormal)
    zeros_v = torch.zeros((n, 3), dtype=dtype, device=device)
    zeros_m = torch.zeros((n, 3, 3), dtype=dtype, device=device)
    eye = torch.eye(3, dtype=dtype, device=device).expand(n, 3, 3).contiguous()
    th, wd, vol = full(thickness), full(width), full(spacing)
    state = {
        "Position": pos, "InitialPosition": pos.clone(),
        "Velocity": zeros_v, "Force": zeros_v, "ForcePrior": zeros_v,
        "VolumetricMeasure": vol, "Mass": material.rho0 * vol * th * wd,
        "Density": full(material.rho0), "Thickness": th, "Width": wd,
        "NormalDirection": normal, "InitialNormalDirection": normal,
        "PseudoNormal": normal,
        "BinormalDirection": binormal, "InitialBinormalDirection": binormal,
        "PseudoBinormal": binormal,
        "Rotation": zeros_v, "AngularVelocity": zeros_v,
        "AngularAcceleration": zeros_v,
        "BinormalRotation": zeros_v, "BinormalAngularVelocity": zeros_v,
        "BinormalAngularAcceleration": zeros_v,
        "PseudoNormalRate": zeros_v, "PseudoBinormalRate": zeros_v,
        "DeformationGradient": eye, "DeformationRate": zeros_m,
        "BendingDeformationGradient": zeros_m,
        "BendingDeformationRate": zeros_m,
        "BinormalBending": zeros_m, "BinormalBendingRate": zeros_m,
        "TransformationMatrix0": transformation_matrix_bar(normal, binormal),
        "NReal": n,
    }
    return state


def _grad(bar: State, rp: ReferencePairs):
    vol_j, _ = gather(bar["VolumetricMeasure"], rp.idx)
    return (rp.dW * vol_j * rp.mask)[..., None] * rp.e


def bar_correct_configuration(bar: State, rp: ReferencePairs) -> State:
    """BarCorrectConfiguration: B = diag(1/A00, 0, 0) of the local frame's
    A (only the axial direction is kernel-complete on a line)."""
    out = dict(bar)
    Q0 = bar["TransformationMatrix0"]
    grad = _grad(bar, rp)
    eye = torch.eye(3, dtype=grad.dtype, device=grad.device)
    A = outer_sum(-(rp.r[..., None] * rp.e), grad) + 1e-7 * eye
    A_local = mm(mm(Q0, A), Q0.transpose(-1, -2))
    B = torch.zeros_like(A)
    B[..., 0, 0] = 1.0 / A_local[..., 0, 0]
    out["LinearGradientCorrectionMatrix"] = B
    return out


def _unit(v):
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + TINY)


def bar_stress_relaxation_1st_half(bar: State, rp: ReferencePairs, material,
                                   dt, smoothing_length: float) -> State:
    """BarStressRelaxationFirstHalf: the half drift, the cross-section's
    Gauss stress integration, the pair exchange of stress, moments and
    shears, the velocity and angular-velocity kicks."""
    out = dict(bar)
    rho0 = material.rho0
    inv_rho0 = 1.0 / rho0
    nu = material.poisson_ratio
    G0 = material.shear_modulus
    lambda0 = material.lambda0
    Q0 = bar["TransformationMatrix0"]
    Q0T = Q0.transpose(-1, -2)
    th, wd = bar["Thickness"], bar["Width"]

    def half(k, rate):
        return bar[k] + bar[rate] * (0.5 * dt)

    pos = half("Position", "Velocity")
    rot = half("Rotation", "AngularVelocity")
    rot_b = half("BinormalRotation", "BinormalAngularVelocity")
    pseudo_n = half("PseudoNormal", "PseudoNormalRate")
    pseudo_b = half("PseudoBinormal", "PseudoBinormalRate")
    F = half("DeformationGradient", "DeformationRate")
    Fb = half("BendingDeformationGradient", "BendingDeformationRate")
    Fbb = half("BinormalBending", "BinormalBendingRate")

    J = det(F)
    inv_F = inv(F)
    rho = rho0 / J

    # the current directors from F (slender_structure_math.cpp:91-98)
    f0, f1, f2 = F[..., :, 0], F[..., :, 1], F[..., :, 2]
    n_cur = mv(Q0T, _unit(torch.linalg.cross(f0, f1, dim=-1)))
    b_cur = mv(Q0T, _unit(torch.linalg.cross(f2, f0, dim=-1)))
    Qc = transformation_matrix_bar(n_cur, b_cur)
    Q0c = mm(Qc, Q0T)                  # initial local -> current local
    Q0cT = Q0c.transpose(-1, -2)

    eye = torch.eye(3, dtype=F.dtype, device=F.device)
    h = torch.full_like(th, smoothing_length)
    scale_diag = torch.stack([h, torch.clamp(wd, max=smoothing_length),
                              torch.clamp(th, max=smoothing_length)], dim=-1)
    cs0 = math.sqrt(G0 / rho0)
    c0 = material.sound_speed
    corr = torch.as_tensor(_shear_correction(), dtype=F.dtype,
                           device=F.device)
    half_t = (th * 0.5)[..., None, None]
    half_w = (wd * 0.5)[..., None, None]

    res_stress = res_moment = res_b_moment = torch.zeros_like(F)
    res_shear = res_b_shear = torch.zeros_like(pos)
    mid_cauchy = None
    for gx, gy, gw in zip(GAUSS4_X, GAUSS4_Y, GAUSS4_W):
        F_g = F + gy * Fb * half_t + gx * Fbb * half_w
        dF_g = bar["DeformationRate"] \
            + gy * bar["BendingDeformationRate"] * half_t \
            + gx * bar["BinormalBendingRate"] * half_w
        inv_F_g = inv(F_g)
        almansi = mm(mm(Q0c, 0.5 * (eye - mm(inv_F_g.transpose(-1, -2),
                                             inv_F_g))), Q0cT)
        # getCorrectedAlmansiStrain (the bar corrects e22 only)
        almansi = almansi.clone()
        almansi[..., 2, 2] = -nu * (almansi[..., 0, 0]
                                    + almansi[..., 1, 1]) / (1.0 - nu)
        cauchy = _stress_cauchy_linear(almansi, lambda0, G0)
        # NumericalDampingRightCauchy with diag(h, min(w, h), min(t, h))
        F_gT = F_g.transpose(-1, -2)
        strain_rate = 0.5 * (mm(dF_g.transpose(-1, -2), F_g) + mm(F_gT, dF_g))
        normal_rate = strain_rate * eye
        damping = 0.5 * rho0 * (cs0 * (strain_rate - normal_rate)
                                + c0 * normal_rate)
        damping = damping * scale_diag[..., None, :]
        cauchy = cauchy + mm(mm(mm(mm(Q0c, F_g), damping), F_gT), Q0cT) \
            / det(F_g)[..., None, None]
        cauchy = cauchy * corr
        if mid_cauchy is None:
            mid_cauchy = cauchy
        area_w = (0.5 * wd * 0.5 * th * gw)[..., None, None]
        res_stress = res_stress + area_w * cauchy
        res_moment = res_moment + area_w * cauchy * (gy * half_t)
        res_b_moment = res_b_moment + area_w * cauchy * (gx * half_w)
        res_shear = res_shear - area_w[..., 0] * cauchy[..., :, 2]
        res_b_shear = res_b_shear - area_w[..., 0] * cauchy[..., :, 1]
    # the modelling zeroes (the shell's columns only: module docstring)
    res_stress, res_moment, res_b_moment, res_shear, res_b_shear = (
        t.clone() for t in (res_stress, res_moment, res_b_moment, res_shear,
                            res_b_shear))
    res_stress[..., :, 1:] = 0.0
    res_moment[..., :, 2] = 0.0
    res_b_moment[..., :, 1] = 0.0
    res_shear[..., 1] = 0.0
    res_b_shear[..., 2] = 0.0

    QcT = Qc.transpose(-1, -2)
    Jm = J[..., None, None]
    right = mm(mm(mm(Qc, Q0T), inv_F.transpose(-1, -2)), Q0)
    global_stress = Jm * mm(mm(QcT, res_stress), right)
    global_moment = Jm * mm(mm(QcT, res_moment), right)
    global_b_moment = Jm * mm(mm(QcT, res_b_moment), right)
    global_shear = J[..., None] * mv(QcT, res_shear)
    global_b_shear = J[..., None] * mv(QcT, res_b_shear)

    vol_j, _ = gather(bar["VolumetricMeasure"], rp.idx)
    coeff = (rp.dW * vol_j * rp.mask)[..., None]

    def pair_sum(M):
        M_j, _ = gather(M, rp.idx)
        return torch.sum(mv(M[:, None] + M_j, rp.e) * coeff, dim=1)

    mass = bar["Mass"]
    force = mass[:, None] * pair_sum(global_stress)
    n_acc = global_shear + pair_sum(global_moment)
    b_acc = global_b_shear + pair_sum(global_b_moment)

    force = force * inv_rho0 / (th * wd)[..., None]
    d2n = n_acc * (inv_rho0 * 12.0 / th ** 4)[..., None]
    d2b = -b_acc * (inv_rho0 * 12.0 / th ** 4)[..., None]

    # the small-deformation angular recovery (slender_structure_math.cpp:
    # 77-88)
    a_n_local = mv(Q0, d2n)
    a_b_local = mv(Q0, d2b)
    z = torch.zeros_like(a_n_local[..., 0])
    domega = torch.stack([z, a_n_local[..., 0], z], dim=-1)
    domega_b = torch.stack([z, z, a_b_local[..., 0]], dim=-1)

    vel = bar["Velocity"] + (bar["ForcePrior"] + force) / mass[:, None] * dt
    out.update({
        "Position": pos, "Density": rho,
        "Rotation": rot, "BinormalRotation": rot_b,
        "PseudoNormal": pseudo_n, "PseudoBinormal": pseudo_b,
        "DeformationGradient": F, "BendingDeformationGradient": Fb,
        "BinormalBending": Fbb,
        "GlobalStress": global_stress, "GlobalMoment": global_moment,
        "GlobalBinormalMoment": global_b_moment,
        "GlobalShearStress": global_shear,
        "GlobalBinormalShearStress": global_b_shear,
        "MidSurfaceCauchyStress": mid_cauchy,
        "Force": force,
        "AngularAcceleration": domega,
        "BinormalAngularAcceleration": domega_b,
        "AngularVelocity": bar["AngularVelocity"] + domega * dt,
        "BinormalAngularVelocity": bar["BinormalAngularVelocity"]
        + domega_b * dt,
        "Velocity": vel,
    })
    return out


def bar_stress_relaxation_2nd_half(bar: State, rp: ReferencePairs,
                                   dt) -> State:
    """BarStressRelaxationSecondHalf: the drift, the directors rebuilt from
    the rotations, the deformation rates from the pair gradients, the
    drift of F and the bending gradients."""
    out = dict(bar)
    Q0 = bar["TransformationMatrix0"]
    Q0T = Q0.transpose(-1, -2)

    pos = bar["Position"] + bar["Velocity"] * (0.5 * dt)
    rot = bar["Rotation"] + bar["AngularVelocity"] * (0.5 * dt)
    rot_b = bar["BinormalRotation"] + bar["BinormalAngularVelocity"] \
        * (0.5 * dt)
    pseudo_n = mv(Q0T, rotate_vector(rot, LOCAL_N0))
    pseudo_b = mv(Q0T, rotate_vector(rot_b, LOCAL_B0))
    safe_dt = torch.clamp(torch.as_tensor(dt, dtype=pos.dtype,
                                          device=pos.device), min=1e-10)
    dn_dt = (pseudo_n - bar["PseudoNormal"]) / (0.5 * safe_dt)
    db_dt = (pseudo_b - bar["PseudoBinormal"]) / (0.5 * safe_dt)

    grad = _grad(bar, rp)

    def rate(v):
        v_j, _ = gather(v, rp.idx)
        return -outer_sum(v[:, None] - v_j, grad)

    B = bar["LinearGradientCorrectionMatrix"]

    def local(M):
        return mm(mm(mm(Q0, M), Q0T), B)

    dF_dt = local(rate(bar["Velocity"])).clone()
    dF_dt[..., :, 2] = mv(Q0, dn_dt)
    dF_dt[..., :, 1] = mv(Q0, db_dt)
    dFb_dt = local(rate(dn_dt))
    dFbb_dt = local(rate(db_dt))

    out.update({
        "Position": pos, "Rotation": rot, "BinormalRotation": rot_b,
        "PseudoNormal": pseudo_n, "PseudoBinormal": pseudo_b,
        "PseudoNormalRate": dn_dt, "PseudoBinormalRate": db_dt,
        "DeformationRate": dF_dt, "BendingDeformationRate": dFb_dt,
        "BinormalBendingRate": dFbb_dt,
        "DeformationGradient": bar["DeformationGradient"]
        + dF_dt * (0.5 * dt),
        "BendingDeformationGradient": bar["BendingDeformationGradient"]
        + dFb_dt * (0.5 * dt),
        "BinormalBending": bar["BinormalBending"] + dFbb_dt * (0.5 * dt),
    })
    return out


def bar_acoustic_time_step(bar: State, material, smoothing_length: float,
                           cfl: float = 0.6) -> torch.Tensor:
    """BarAcousticTimeStepSize (slender_structure_dynamics.cpp:31-45): a 0-d
    tensor on the bar's device (no host read)."""
    def norm(k):
        return torch.linalg.vector_norm(bar[k], dim=-1)

    accel = torch.linalg.vector_norm(bar["Force"] + bar["ForcePrior"],
                                     dim=-1) / bar["Mass"]
    c0 = material.sound_speed
    E0, nu, rho0 = (material.youngs_modulus, material.poisson_ratio,
                    material.rho0)
    t0 = torch.minimum(torch.sqrt(smoothing_length / (accel + TINY)),
                       smoothing_length / (c0 + norm("Velocity")))
    domega = torch.maximum(norm("AngularAcceleration"),
                           norm("BinormalAngularAcceleration"))
    omega = torch.maximum(norm("AngularVelocity"),
                          norm("BinormalAngularVelocity"))
    t1 = torch.minimum(torch.sqrt(1.0 / (domega + TINY)), 1.0 / (omega + TINY))
    t2 = smoothing_length * torch.sqrt(
        rho0 * (1.0 - nu * nu) / E0
        / (2.0 + (math.pi ** 2 / 12.0) * (1.0 - nu)
           * (1.0 + 1.5 * (smoothing_length / bar["Thickness"]) ** 2)))
    return cfl * torch.min(torch.minimum(torch.minimum(t0, t1), t2))


def constrain_bar_region(bar: State, mask) -> State:
    """ConstrainBarBodyRegion: zero velocity and both angular velocities on
    the masked rows."""
    out = dict(bar)
    m = mask[:, None]
    for k in ("Velocity", "AngularVelocity", "BinormalAngularVelocity"):
        out[k] = torch.where(m, torch.zeros_like(bar[k]), bar[k])
    return out
