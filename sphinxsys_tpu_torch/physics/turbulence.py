"""Standard k-epsilon RANS turbulence with wall functions (counterpart of
sphinxsys_tpu/physics/turbulence.py; reference extra_src/for_2D_build/
k-epsilon_turbulent_model.{h,cpp} and extra_src/shared/
rans_turbulence_dynamics.h): the wall-function machinery, the K and
Epsilon transport equations, the turbulent kinetic-energy force, the
turbulent viscous force and the eddy-viscosity closure.

The reference's per-particle branches are masked selects over the (N, K)
neighbour lists, as in the JAX package: the nearest-wall scan
(JudgeIsNearWall::interaction, cpp:630-707) is a masked argmin over the
wall slots, and the reference's order-dependent running-minimum filter
of the interface distance is the JAX package's order-free limit.  The
turbulent correction matrix's determinant and inverse are core/linalg.py's
closed forms.  The K equation writes the updated k that the Epsilon
equation then reads: call them in that order.

State fields (registered by register_turbulence_fields):
  TurbulenceKineticEnergy (k), TurbulentDissipation (eps),
  TurbulentViscosity (mu_t), K_Production, TurbulentVelocityGradient
  (N, d, d), IsNearWallP1 / P2 (int32), WallNearestNormal / Tau,
  DistanceToDummyInterface, Y_P, WallYstar, WallYplus, FrictionVelocity.
"""

from __future__ import annotations

import dataclasses

import torch

from sphinxsys_tpu_torch.core.linalg import det, inv, mm, mv
from sphinxsys_tpu_torch.core.state import State
from sphinxsys_tpu_torch.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_tpu_torch.physics.pair import pair_geometry

TINY = 1.0e-15


@dataclasses.dataclass(frozen=True)
class TurbuClosure:
    """BaseTurbuClosureCoeff (k-epsilon_turbulent_model.cpp:13-20)."""

    karman: float = 0.41
    const_E: float = 9.8
    c_mu: float = 0.09
    intensity: float = 5.0e-2
    sigma_k: float = 1.0
    c_1: float = 1.44
    c_2: float = 1.92
    sigma_e: float = 1.3
    length_ratio_eps_inlet: float = 0.07
    start_time_laminar: float = 0.0
    y_star_laminar: float = 11.225

    @property
    def c_mu_25(self) -> float:
        return self.c_mu ** 0.25

    @property
    def c_mu_75(self) -> float:
        return self.c_mu ** 0.75


def _norm(v, keepdim=True):
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=keepdim))


def register_turbulence_fields(fluid: State, dim: int, k0: float, eps0: float,
                               mu_t0: float, y_p_constant: float) -> State:
    """Every turbulence state variable (the registerStateVariableData calls
    of the reference constructors), so that a step's state keeps one
    set of keys."""
    pos = fluid["Position"]
    n, dt_, dev = pos.shape[0], pos.dtype, pos.device
    out = dict(fluid)

    def full(shape, v=0.0, dtype=dt_):
        return torch.full(shape, v, dtype=dtype, device=dev)

    eye = torch.eye(dim, dtype=dt_, device=dev).expand(n, dim, dim).clone()
    for k, v in (("TurbulenceKineticEnergy", full((n,), k0)),
                 ("TurbulentDissipation", full((n,), eps0)),
                 ("TurbulentViscosity", full((n,), mu_t0)),
                 ("K_Production", full((n,))),
                 ("TurbulentVelocityGradient", full((n, dim, dim))),
                 ("TurbulentCorrectionMatrix", eye),
                 ("IsNearWallP1", full((n,), 0, torch.int32)),
                 ("IsNearWallP2", full((n,), 0, torch.int32)),
                 ("WallNearestNormal", full((n, dim))),
                 ("WallNearestTau", full((n, dim))),
                 ("DistanceToDummyInterface", full((n,))),
                 ("Y_P", full((n,), y_p_constant)),
                 ("WallYstar", full((n,))),
                 ("WallYplus", full((n,))),
                 ("FrictionVelocity", full((n, dim))),
                 ("TkeForcePrev", full((n, dim))),
                 ("TurbulentStrainRate", full((n, dim, dim))),
                 ("TangentialVelocity", full((n,))),
                 ("ViscousForce", full((n, dim))),
                 ("ViscousForcePrev", full((n, dim)))):
        out.setdefault(k, v)
    return out


# ---------------------------------------------------------------------------
# Wall-law scalar helpers (WallFunction, k-epsilon_turbulent_model.cpp:22-67)
# ---------------------------------------------------------------------------

def dimensionless_velocity(y_star, time, cl: TurbuClosure):
    """u* by the laminar law below y* = 11.225, the log law above
    (get_dimensionless_velocity)."""
    log_law = torch.abs(torch.log(cl.const_E * torch.clamp(y_star, min=TINY))
                        / cl.karman)
    laminar = (y_star < cl.y_star_laminar) & (time > cl.start_time_laminar)
    return torch.where(laminar, y_star, log_law)


def _tangent(n):
    """The 2D tangent (n_y, -n_x) (cpp:694-698); in 3D n x z."""
    if n.shape[-1] == 2:
        return torch.stack([n[..., 1], -n[..., 0]], dim=-1)
    z = torch.zeros_like(n)
    z[..., 2] = 1.0
    return torch.linalg.cross(n, z, dim=-1)


# ---------------------------------------------------------------------------
# Near-wall status (JudgeIsNearWall)
# ---------------------------------------------------------------------------

def judge_is_near_wall(fluid: State, wall: State, nbr_wall: NeighborList,
                       kernel, dim: int, fluid_spacing: float,
                       wall_spacing: float) -> State:
    """JudgeIsNearWall (k-epsilon_turbulent_model.cpp:598-724): the
    nearest wall neighbour (least r_ij among those with r_dummy_j =
    |n_j . disp_ij| - wall_spacing / 2 > 0) gives the wall normal, the
    tangent and the interface distance; P2 = 10 where any wall neighbour
    exists, P1 = 1 where also the distance < fluid_spacing."""
    pos = fluid["Position"]
    pg = pair_geometry(pos, wall["Position"], nbr_wall, kernel, dim)
    n_j, _ = gather(wall["NormalDirection"], nbr_wall.idx)

    disp = pg.r[..., None] * pg.e  # (N, K, d): pos_i - pos_j
    r_dummy = torch.abs(torch.sum(n_j * disp, dim=-1)) - 0.5 * wall_spacing
    valid = pg.mask & (r_dummy > TINY)

    r_for_min = torch.where(valid, pg.r, torch.full_like(pg.r, float("inf")))
    j_near = torch.argmin(r_for_min, dim=1)
    has_near = torch.isfinite(torch.amin(r_for_min, dim=1))
    rows = torch.arange(pos.shape[0], device=pos.device)
    e_n = torch.where(has_near[:, None], n_j[rows, j_near],
                      torch.zeros_like(pos))
    dist = torch.where(has_near, r_dummy[rows, j_near],
                       torch.zeros_like(pos[:, 0]))

    p2 = torch.where(torch.any(pg.mask, dim=1), 10, 0).to(torch.int32)
    p1 = torch.where((p2 == 10) & (dist < fluid_spacing), 1, 0).to(
        torch.int32)
    out = dict(fluid)
    out["IsNearWallP1"] = p1
    out["IsNearWallP2"] = p2
    out["WallNearestNormal"] = e_n
    out["WallNearestTau"] = _tangent(e_n)
    out["DistanceToDummyInterface"] = dist
    return out


# ---------------------------------------------------------------------------
# Turbulent gradient-correction matrix
# ---------------------------------------------------------------------------

def turbulent_correction_matrix(fluid: State, nbr_inner: NeighborList, kernel,
                                dim: int, alpha: float = 0.0) -> State:
    """TurbulentLinearGradientCorrectionMatrix<Inner<>> (k-epsilon_
    turbulent_model.cpp:879-905): B = -sum r_ji grad W_ij V_j (inner only),
    then the determinant-weighted blend of inverse(B) with the identity
    (weight2 = max(alpha - det, 0), renormalised)."""
    pos, vol = fluid["Position"], fluid["VolumetricMeasure"]
    pg = pair_geometry(pos, pos, nbr_inner, kernel, dim, need_W=False)
    vol_j, _ = gather(vol, nbr_inner.idx)
    gradw = (pg.dW * vol_j)[..., None] * pg.e  # (N, K, d)
    r_ji = pg.r[..., None] * pg.e
    eye = torch.eye(dim, dtype=pos.dtype, device=pos.device)
    B = 1.0e-6 * eye - torch.sum(r_ji[..., :, None] * gradw[..., None, :],
                                 dim=1)
    d = det(B)
    det_sqr = torch.clamp(alpha - d, min=0.0)
    w1 = d / (d + det_sqr + TINY)
    w2 = det_sqr / (d + det_sqr + TINY)
    out = dict(fluid)
    out["TurbulentCorrectionMatrix"] = (w1[:, None, None] * inv(B)
                                        + w2[:, None, None] * eye)
    return out


# ---------------------------------------------------------------------------
# Velocity gradient (GetVelocityGradient Inner + Contact<Wall>)
# ---------------------------------------------------------------------------

def turbulent_velocity_gradient(fluid: State, nbr_inner: NeighborList,
                                wall: State, nbr_wall: NeighborList, kernel,
                                dim: int, weight_sub: float) -> State:
    """GetVelocityGradient (k-epsilon_turbulent_model.cpp:69-141):
    grad_i = sum_j -(v_i - v_j) (dW V_j e_ij)^T; where P2_i = 10 and
    P1_j = 1 the pair blends in (weight_sub) the neighbour's gradient
    extrapolated over the pair, -(grad_j r_ij e_ij) (dW V_j e)^T; the wall
    adds -(v_i - 0) terms; the result is right-multiplied by the turbulent
    correction matrix.  P1 particles keep their wall-function gradient."""
    pos, vel, vol = fluid["Position"], fluid["Velocity"], \
        fluid["VolumetricMeasure"]
    grad_old = fluid["TurbulentVelocityGradient"]
    p1, p2 = fluid["IsNearWallP1"], fluid["IsNearWallP2"]

    pg = pair_geometry(pos, pos, nbr_inner, kernel, dim, need_W=False)
    vel_j, _ = gather(vel, nbr_inner.idx)
    vol_j, _ = gather(vol, nbr_inner.idx)
    p1_j, _ = gather(p1, nbr_inner.idx)
    grad_j, _ = gather(grad_old, nbr_inner.idx)  # (N, K, d, d)

    nablaWV = (pg.dW * vol_j)[..., None] * pg.e  # (N, K, d)
    vdiff = vel[:, None, :] - vel_j
    P1_term = -vdiff[..., :, None] * nablaWV[..., None, :]  # (N, K, d, d)
    vel_ext = mv(grad_j, pg.r[..., None] * pg.e)
    P2_term = -vel_ext[..., :, None] * nablaWV[..., None, :]
    blend = ((p2 == 10)[:, None] & (p1_j == 1))[..., None, None]
    pair_term = torch.where(blend,
                            (1.0 - weight_sub) * P1_term
                            + weight_sub * P2_term, P1_term)
    grad = torch.sum(pair_term, dim=1)

    pgw = pair_geometry(pos, wall["Position"], nbr_wall, kernel, dim,
                        need_W=False)
    wvol_j, _ = gather(wall["VolumetricMeasure"], nbr_wall.idx)
    nablaWVw = (pgw.dW * wvol_j)[..., None] * pgw.e
    grad = grad - torch.sum(vel[:, None, :, None] * nablaWVw[..., None, :],
                            dim=1)

    grad = mm(grad, fluid["TurbulentCorrectionMatrix"])
    out = dict(fluid)
    out["TurbulentVelocityGradient"] = torch.where(
        (p1 == 1)[:, None, None], grad_old, grad)
    return out


# ---------------------------------------------------------------------------
# K and Epsilon transport (K_TurbulentModelInner / E_TurbulentModelInner)
# ---------------------------------------------------------------------------

def _harmonic_lap(pg, q_i, q_j, mu_i, mu_j, rho, vol_j, h):
    """sum_j 2 mu_harmo (q_i - q_j) / (r + 0.01 h) dW V_j / rho_i."""
    mu_h = 2.0 * mu_i[:, None] * mu_j / (mu_i[:, None] + mu_j + TINY)
    dq = (q_i[:, None] - q_j) / (pg.r + 0.01 * h)
    return torch.sum(2.0 * mu_h * dq * pg.dW * vol_j, dim=1) / rho


def k_equation(fluid: State, nbr_inner: NeighborList, kernel, dim: int,
               mu: float, h: float, dt, cl: TurbuClosure = TurbuClosure(),
               stl: bool = True) -> State:
    """K_TurbulentModelInner (k-epsilon_turbulent_model.cpp:172-238):
    dk/dt = G_k - eps + lap(mu_t / sigma_k + mu, k), G_k the Reynolds
    stress contracted with the velocity gradient (P1 particles keep the
    wall-function G_k); `stl` divides the dissipation implicitly,
    k = (k + (G_k + lap) dt) / (1 + eps dt / k)."""
    pos, vol = fluid["Position"], fluid["VolumetricMeasure"]
    rho = fluid["Density"]
    k, eps = fluid["TurbulenceKineticEnergy"], fluid["TurbulentDissipation"]
    mu_t = fluid["TurbulentViscosity"]
    grad = fluid["TurbulentVelocityGradient"]
    p1 = fluid["IsNearWallP1"]

    pg = pair_geometry(pos, pos, nbr_inner, kernel, dim, need_W=False)
    vol_j, _ = gather(vol, nbr_inner.idx)
    k_j, _ = gather(k, nbr_inner.idx)
    mu_t_j, _ = gather(mu_t, nbr_inner.idx)
    mu_eff = mu_t / cl.sigma_k + mu
    mu_eff_j = mu_t_j / cl.sigma_k + mu
    k_lap = _harmonic_lap(pg, k, k_j, mu_eff, mu_eff_j, rho, vol_j, h)

    strain = 0.5 * (grad + grad.transpose(-1, -2))
    eye = torch.eye(dim, dtype=pos.dtype, device=pos.device)
    re_stress = (2.0 * strain * (mu_t / rho)[:, None, None]
                 - (2.0 / 3.0) * k[:, None, None] * eye)
    g_k_bulk = torch.sum(re_stress * grad, dim=(-1, -2))
    g_k = torch.where(p1 == 1, fluid["K_Production"], g_k_bulk)

    out = dict(fluid)
    out["K_Production"] = g_k
    out["TurbulentStrainRate"] = strain
    if stl:
        k_new = (k + (g_k + k_lap) * dt) \
            / (1.0 + eps * dt / torch.clamp(k, min=TINY))
    else:
        k_new = k + (g_k - eps + k_lap) * dt
    out["TurbulenceKineticEnergy"] = k_new
    return out


def epsilon_equation(fluid: State, nbr_inner: NeighborList, kernel, dim: int,
                     mu: float, h: float, dt,
                     cl: TurbuClosure = TurbuClosure(),
                     stl: bool = True) -> State:
    """E_TurbulentModelInner (k-epsilon_turbulent_model.cpp:249-313):
    deps/dt = C1 eps G_k / k - C2 eps^2 / k + lap(mu_t / sigma_e + mu,
    eps), with the k the K equation wrote; P1 particles keep their
    wall-law eps."""
    pos, vol = fluid["Position"], fluid["VolumetricMeasure"]
    rho = fluid["Density"]
    k, eps = fluid["TurbulenceKineticEnergy"], fluid["TurbulentDissipation"]
    mu_t = fluid["TurbulentViscosity"]
    p1 = fluid["IsNearWallP1"]

    pg = pair_geometry(pos, pos, nbr_inner, kernel, dim, need_W=False)
    vol_j, _ = gather(vol, nbr_inner.idx)
    eps_j, _ = gather(eps, nbr_inner.idx)
    mu_t_j, _ = gather(mu_t, nbr_inner.idx)
    mu_eff = mu_t / cl.sigma_e + mu
    mu_eff_j = mu_t_j / cl.sigma_e + mu
    e_lap = _harmonic_lap(pg, eps, eps_j, mu_eff, mu_eff_j, rho, vol_j, h)

    k_safe = torch.clamp(k, min=TINY)
    e_prod = cl.c_1 * eps * fluid["K_Production"] / k_safe
    e_diss = cl.c_2 * eps * eps / k_safe
    if stl:
        eps_new = ((eps + (e_prod + e_lap) * dt)
                   / (1.0 + cl.c_2 * eps * dt / k_safe))
    else:
        eps_new = eps + (e_prod - e_diss + e_lap) * dt
    out = dict(fluid)
    out["TurbulentDissipation"] = torch.where(p1 == 1, eps, eps_new)
    return out


# ---------------------------------------------------------------------------
# Turbulent kinetic-energy force (TKEnergyForceComplex)
# ---------------------------------------------------------------------------

def tke_energy_force(fluid: State, nbr_inner: NeighborList, wall: State,
                     nbr_wall: NeighborList, kernel, dim: int) -> State:
    """TKEnergyForce Inner + Contact (k-epsilon_turbulent_model.cpp:
    315-367): F_i = -(2/3) m_i [sum_j (k_i + k_j) dW V_j e_ij +
    sum_wall 2 k_i dW V_j e_ij], folded into ForcePrior with the previous
    call's contribution taken out (re-evaluated every acoustic sub-step)."""
    pos, vol = fluid["Position"], fluid["VolumetricMeasure"]
    k = fluid["TurbulenceKineticEnergy"]

    pg = pair_geometry(pos, pos, nbr_inner, kernel, dim, need_W=False)
    vol_j, _ = gather(vol, nbr_inner.idx)
    k_j, _ = gather(k, nbr_inner.idx)
    k_grad = torch.sum(((k[:, None] + k_j) * pg.dW * vol_j)[..., None]
                       * pg.e, dim=1)
    pgw = pair_geometry(pos, wall["Position"], nbr_wall, kernel, dim,
                        need_W=False)
    wvol_j, _ = gather(wall["VolumetricMeasure"], nbr_wall.idx)
    k_grad = k_grad + torch.sum(
        (2.0 * k[:, None] * pgw.dW * wvol_j)[..., None] * pgw.e, dim=1)

    force = -(2.0 / 3.0) * k_grad * fluid["Mass"][:, None]
    out = dict(fluid)
    out["ForcePrior"] = fluid["ForcePrior"] + force - fluid["TkeForcePrev"]
    out["TkeForcePrev"] = force
    return out


# ---------------------------------------------------------------------------
# Turbulent viscous force (TurbuViscousForce Inner + Contact<Wall>)
# ---------------------------------------------------------------------------

def turbulent_viscous_force(fluid: State, nbr_inner: NeighborList,
                            wall: State, nbr_wall: NeighborList, kernel,
                            dim: int, mu: float, h: float, c0: float, time,
                            cl: TurbuClosure = TurbuClosure(),
                            extra_dissipation: bool = True) -> State:
    """TurbuViscousForce (k-epsilon_turbulent_model.cpp:369-474): the
    inner shear with the pairwise harmonic mean of mu + mu_t, and
    optionally the extra dissipation limiter (the longitudinal part
    swapped for rho h min(3 max(du, 0), c0) where that exceeds the
    harmonic viscosity); the wall term is the wall-function shear stress
    rho u_fric^2 sign(u_tau) (e_tau e_n^T) on P2 particles."""
    pos, vel, vol = fluid["Position"], fluid["Velocity"], \
        fluid["VolumetricMeasure"]
    rho = fluid["Density"]
    mu_t = fluid["TurbulentViscosity"]
    k = fluid["TurbulenceKineticEnergy"]
    p2 = fluid["IsNearWallP2"]
    eps_r = 0.01 * h

    pg = pair_geometry(pos, pos, nbr_inner, kernel, dim, need_W=False)
    vol_j, _ = gather(vol, nbr_inner.idx)
    vel_j, _ = gather(vel, nbr_inner.idx)
    mu_t_j, _ = gather(mu_t, nbr_inner.idx)
    mu_i = mu_t + mu
    mu_j = mu_t_j + mu
    mu_h = 2.0 * mu_i[:, None] * mu_j / (mu_i[:, None] + mu_j + TINY)

    vdiff = vel[:, None, :] - vel_j
    vderiv = vdiff / (pg.r + eps_r)[..., None]
    shear = mu_h[..., None] * vderiv
    shear_long = torch.sum(shear * pg.e, dim=-1, keepdim=True) * pg.e
    if extra_dissipation:
        u_jump = torch.sum(vdiff * pg.e, dim=-1)
        dissip = rho[:, None] * h * torch.clamp(
            3.0 * torch.clamp(u_jump, min=0.0), max=c0)
        corrected = (torch.sum(dissip[..., None] * vderiv * pg.e, dim=-1,
                               keepdim=True) * pg.e)
        use_corr = (mu_h < dissip)[..., None]
        shear = shear - shear_long + torch.where(use_corr, corrected,
                                                 shear_long)
    force = torch.sum(shear * (2.0 * pg.dW * vol_j)[..., None], dim=1)
    force = force * (fluid["Mass"] / rho)[:, None]

    # the wall-function shear stress (cpp:422-474)
    pgw = pair_geometry(pos, wall["Position"], nbr_wall, kernel, dim,
                        need_W=False)
    wvol_j, _ = gather(wall["VolumetricMeasure"], nbr_wall.idx)
    n_j, _ = gather(wall["NormalDirection"], nbr_wall.idx)
    vel_n = torch.sum(vel[:, None, :] * n_j, dim=-1, keepdim=True) * n_j
    vel_tau = vel[:, None, :] - vel_n
    e_tau = vel_tau / (_norm(vel_tau) + TINY)
    u_tau_mag = torch.abs(torch.sum(vel[:, None, :] * e_tau, dim=-1))

    k05 = torch.sqrt(torch.clamp(k, min=TINY))[:, None]
    y_p = fluid["Y_P"][:, None]
    nu = mu / torch.clamp(rho, min=TINY)[:, None]
    y_star = cl.c_mu_25 * k05 * y_p / nu
    u_star = dimensionless_velocity(y_star, time, cl)
    fric2 = cl.c_mu_25 * k05 * u_tau_mag / torch.clamp(u_star, min=TINY)
    sgn = torch.sign(torch.sum(vel[:, None, :] * e_tau, dim=-1) + TINY)
    wss_mag = rho[:, None] * fric2 * sgn
    wss_e = wss_mag[..., None] * e_tau \
        * torch.sum(n_j * pgw.e, dim=-1)[..., None]
    fw = torch.sum(wss_e * (2.0 * pgw.dW * wvol_j)[..., None], dim=1)
    fw = fw * (fluid["Mass"] / rho)[:, None]
    force = force + torch.where((p2 == 10)[:, None], fw,
                                torch.zeros_like(fw))

    out = dict(fluid)
    out["ViscousForce"] = force
    out["ForcePrior"] = fluid["ForcePrior"] + force - fluid.get(
        "ViscousForcePrev", torch.zeros_like(force))
    out["ViscousForcePrev"] = force
    return out


# ---------------------------------------------------------------------------
# Standard wall-function correction
# ---------------------------------------------------------------------------

def standard_wall_function_correction(fluid: State, wall: State,
                                      nbr_wall: NeighborList, kernel,
                                      dim: int, mu: float, time,
                                      cl: TurbuClosure = TurbuClosure()
                                      ) -> State:
    """StandardWallFunctionCorrection (k-epsilon_turbulent_model.cpp:
    726-877): y*, the friction velocity and y+ of P2 particles; on P1
    particles eps, the velocity gradient and G_k overridden by the
    wall-law values weighted (W V) over the wall neighbourhood:
      eps_p = C_mu^3/4 k^3/2 / (kappa y_p)   [log layer]
            = 2 k nu / y_p^2                 [laminar layer]
      dudn  = u_fric^2 / (C_mu^1/4 k^1/2 kappa y_p), grad = dudn e_tau e_n^T
      G_k_p = rho u_fric^2 dudn              [log layer, else 0]."""
    pos, vel = fluid["Position"], fluid["Velocity"]
    rho = fluid["Density"]
    k = fluid["TurbulenceKineticEnergy"]
    p1, p2 = fluid["IsNearWallP1"], fluid["IsNearWallP2"]
    e_n = fluid["WallNearestNormal"]

    k05 = torch.sqrt(torch.clamp(k, min=TINY))
    k15 = torch.clamp(k, min=TINY) ** 1.5
    nu = mu / torch.clamp(rho, min=TINY)
    y_p = fluid["Y_P"]

    vel_tau_vec = vel - torch.sum(vel * e_n, dim=-1, keepdim=True) * e_n
    e_i_tau = vel_tau_vec / (_norm(vel_tau_vec) + TINY)
    u_tan = torch.abs(torch.sum(e_i_tau * vel, dim=-1))

    y_star = y_p * cl.c_mu_25 * k05 / nu
    u_star = dimensionless_velocity(y_star, time, cl)
    fric_mag = torch.sqrt(cl.c_mu_25 * k05 * u_tan
                          / torch.clamp(u_star, min=TINY))
    fric_vel = fric_mag[:, None] * e_i_tau
    fric_vel = torch.where(torch.sum(vel * fric_vel, dim=-1, keepdim=True)
                           < 0, -fric_vel, fric_vel)

    out = dict(fluid)
    near = p2 == 10
    zero = torch.zeros_like(y_star)
    out["WallYstar"] = torch.where(near, y_star, zero)
    out["WallYplus"] = torch.where(near, y_p * fric_mag / nu, zero)
    out["FrictionVelocity"] = torch.where(near[:, None], fric_vel,
                                          torch.zeros_like(fric_vel))
    out["TangentialVelocity"] = torch.where(near, u_tan, zero)

    # P1 overrides, weighted over the wall neighbours (their own tangents)
    pgw = pair_geometry(pos, wall["Position"], nbr_wall, kernel, dim,
                        need_dW=False)
    wvol_j, _ = gather(wall["VolumetricMeasure"], nbr_wall.idx)
    n_j, _ = gather(wall["NormalDirection"], nbr_wall.idx)
    w_j = pgw.W * wvol_j
    total_w = torch.sum(w_j, dim=1) + TINY

    e_j_tau = _tangent(n_j)
    u_tau_j = torch.abs(torch.sum(vel[:, None, :] * e_j_tau, dim=-1))
    y_star_j = (cl.c_mu_25 * k05 / nu)[:, None] * y_p[:, None]
    u_star_j = dimensionless_velocity(y_star_j, time, cl)
    fric_j2 = cl.c_mu_25 * k05[:, None] * u_tau_j \
        / torch.clamp(u_star_j, min=TINY)
    denom_log = cl.c_mu_25 * k05[:, None] * cl.karman * y_p[:, None]
    dudn_mag_j = fric_j2 / torch.clamp(denom_log, min=TINY)
    sgn_j = torch.sign(torch.sum(vel[:, None, :] * e_j_tau, dim=-1) + TINY)

    laminar_j = (y_star_j < cl.y_star_laminar) \
        & (time > cl.start_time_laminar)
    eps_log = (cl.c_mu_75 * k15 / (cl.karman * y_p))[:, None]
    eps_lam = (2.0 * k * nu / (y_p * y_p))[:, None]
    eps_j = torch.where(laminar_j, eps_lam, eps_log)
    gk_log = rho[:, None] * fric_j2 * dudn_mag_j
    gk_j = torch.where(laminar_j, torch.zeros_like(gk_log), gk_log)

    eps_p = torch.sum(w_j * eps_j, dim=1) / total_w
    dudn_p = torch.sum(w_j * dudn_mag_j * sgn_j, dim=1) / total_w
    gk_p = torch.sum(w_j * gk_j, dim=1) / total_w
    grad_p = dudn_p[:, None, None] * (e_i_tau[..., :, None]
                                      * e_n[..., None, :])

    is_p1 = p1 == 1
    out["TurbulentDissipation"] = torch.where(is_p1, eps_p,
                                              fluid["TurbulentDissipation"])
    out["TurbulentVelocityGradient"] = torch.where(
        is_p1[:, None, None], grad_p, fluid["TurbulentVelocityGradient"])
    out["K_Production"] = torch.where(is_p1, gk_p, fluid["K_Production"])
    return out


def constrain_normal_velocity_region_p(fluid: State) -> State:
    """ConstrainNormalVelocityInRegionP (cpp:867-877): the wall-normal
    velocity of P1 particles removed."""
    vel, e_n = fluid["Velocity"], fluid["WallNearestNormal"]
    v_proj = vel - torch.sum(vel * e_n, dim=-1, keepdim=True) * e_n
    out = dict(fluid)
    out["Velocity"] = torch.where((fluid["IsNearWallP1"] == 1)[:, None],
                                  v_proj, vel)
    return out


def eddy_viscosity_update(fluid: State,
                          cl: TurbuClosure = TurbuClosure()) -> State:
    """TurbulentEddyViscosity (cpp:476-489): mu_t = rho C_mu k^2 / eps."""
    out = dict(fluid)
    out["TurbulentViscosity"] = (
        fluid["Density"] * cl.c_mu * fluid["TurbulenceKineticEnergy"] ** 2
        / torch.clamp(fluid["TurbulentDissipation"], min=TINY))
    return out


def turbulent_advection_time_step(fluid: State, mu: float, rho0: float,
                                  h: float, u_max: float,
                                  cfl: float = 0.25):
    """TurbulentAdvectionTimeStepSize (cpp:491-519): the viscous speed
    with mu + mu_t per particle; a 0-d tensor."""
    visc_speed = (mu + fluid["TurbulentViscosity"]) / rho0 / h
    vel2 = torch.sum(fluid["Velocity"] ** 2, dim=-1)
    speed2 = torch.max(torch.maximum(visc_speed ** 2, vel2))
    ref = max(u_max, mu / rho0 / h)
    return cfl * h / (torch.clamp(torch.sqrt(speed2), min=ref) + TINY)


def turbulent_inflow_values(u_inlet: float, characteristic_length: float,
                            cl: TurbuClosure = TurbuClosure()):
    """Intensity-based inlet turbulence (InflowTurbulentCondition, type
    0): k = 1.5 (I u)^2, eps = C_mu^3/4 k^1.5 / (0.07 L).  Python floats."""
    k_in = 1.5 * (cl.intensity * u_inlet) ** 2
    length = cl.length_ratio_eps_inlet * characteristic_length
    eps_in = cl.c_mu_75 * k_in ** 1.5 / length
    return k_in, eps_in
