"""Non-Newtonian viscosity models and dynamics (counterpart of
sphinxsys_tpu/physics/viscosity.py; reference materials/viscosity.{h,cpp},
fluid_dynamics/non_newtonian_dynamics/non_newtonian_dynamics.{h,cpp} and
the VariableViscosity pair functor of viscous_dynamics.h:55-65).

Three families:

  * generalized Newtonian: the Herschel-Bulkley and Carreau models give
    a per-particle "VariableViscosity" from the deviatoric strain-rate
    magnitude sqrt(2 tr(D^2)) (ShearRateDependentViscosity::update);
  * `viscous_force_variable`: the viscous force with the harmonic pair
    viscosity 2 mu_i mu_j / (mu_i + mu_j)
    (NonNewtonianViscousForceWithWall);
  * Oldroyd-B: an "ElasticStress" evolved by the upper-convected Maxwell
    rate and fed back as a pair force inside the pressure relaxation
    (Oldroyd_BIntegration1st/2ndHalf).

Every op is a pure function of torch tensors on the (N, K) lists; the
per-particle matrix products are the broadcast sums of core/linalg.py.
"""

from __future__ import annotations

import dataclasses

import torch

from sphinxsys_tpu_torch.core.linalg import mm, mv
from sphinxsys_tpu_torch.core.state import State, valid_mask
from sphinxsys_tpu_torch.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_tpu_torch.physics.general import velocity_gradient
from sphinxsys_tpu_torch.physics.pair import pair_geometry

TINY = 1.0e-15


# ---------------------------------------------------------------------------
# Material models (materials/viscosity.h)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HerschelBulkleyViscosity:
    """mu(gamma) = (tau_y + K gamma^n) / gamma, the shear rate clamped to
    [min_shear_rate, max_shear_rate] (viscosity.cpp:30-36)."""

    min_shear_rate: float
    max_shear_rate: float
    consistency_index: float
    power_index: float
    yield_stress: float

    def viscosity(self, shear_rate):
        sr = torch.clamp(shear_rate, self.min_shear_rate, self.max_shear_rate)
        return (self.yield_stress
                + self.consistency_index * sr ** self.power_index) / sr

    @property
    def reference_viscosity(self) -> float:
        """The viscosity at the lower clamp (the largest it takes)."""
        return float(self.viscosity(torch.as_tensor(self.min_shear_rate,
                                                    dtype=torch.float64)))


@dataclasses.dataclass(frozen=True)
class CarreauViscosity:
    """mu(gamma) = mu_inf + (mu0 - mu_inf)(1 + (t_c gamma)^2)^((n-1)/2)
    (viscosity.cpp:43-49)."""

    min_shear_rate: float
    max_shear_rate: float
    characteristic_time: float
    mu_infty: float
    mu0: float
    power_index: float

    def viscosity(self, shear_rate):
        sr = torch.clamp(shear_rate, self.min_shear_rate, self.max_shear_rate)
        return self.mu_infty + (self.mu0 - self.mu_infty) * (
            1.0 + (self.characteristic_time * sr) ** 2
        ) ** (0.5 * (self.power_index - 1.0))

    @property
    def reference_viscosity(self) -> float:
        return self.mu0


@dataclasses.dataclass(frozen=True)
class OldroydBViscosity:
    """Solvent viscosity mu, relaxation time lambda, polymeric viscosity
    mu_p (viscosity.h:69-81)."""

    mu: float
    relaxation_time: float
    mu_p: float


# ---------------------------------------------------------------------------
# Shear-rate dependent viscosity field
# ---------------------------------------------------------------------------

def shear_rate_magnitude(vel_grad, dim: int):
    """sqrt(2 tr(D^2)) of the deviatoric strain rate D."""
    D = 0.5 * (vel_grad + vel_grad.transpose(-1, -2))
    tr = torch.diagonal(D, dim1=-2, dim2=-1).sum(-1)
    D = D - (tr / dim)[..., None, None] * torch.eye(
        dim, dtype=vel_grad.dtype, device=vel_grad.device)
    return torch.sqrt(2.0 * torch.sum(D * D, dim=(-2, -1)))


def update_variable_viscosity(state: State, nl: NeighborList, kernel,
                              dim: int, model, box=None) -> State:
    """"VelocityGradient" and the per-particle "VariableViscosity"
    mu(shear rate) (ShearRateDependentViscosity)."""
    g = velocity_gradient(state, nl, kernel, dim, box)
    out = dict(state)
    out["VelocityGradient"] = g
    out["VariableViscosity"] = model.viscosity(shear_rate_magnitude(g, dim))
    return out


def viscous_force_variable(fluid: State, nl_inner: NeighborList, kernel,
                           dim: int, smoothing_length: float,
                           walls=(), box=None) -> State:
    """The viscous force with the harmonic pair viscosity
    2 mu_i mu_j / (mu_i + mu_j) (viscous_dynamics.h:166-167); the wall
    terms take mu_i (the wall carries no viscosity).  Into ForcePrior by
    the bookkeeping of fluid.viscous_force: ForcePrior += F - F_prev,
    F_prev = ViscousForcePrev (zero where the state has none)."""
    pos, vel, vol = fluid["Position"], fluid["Velocity"], \
        fluid["VolumetricMeasure"]
    mu = fluid["VariableViscosity"]
    eps_r = 0.01 * smoothing_length

    pg = pair_geometry(pos, pos, nl_inner, kernel, dim, need_W=False, box=box)
    vel_j, _ = gather(vel, nl_inner.idx)
    vol_j, _ = gather(vol, nl_inner.idx)
    mu_j, _ = gather(mu, nl_inner.idx)
    mu_ij = 2.0 * mu[:, None] * mu_j / (mu[:, None] + mu_j + TINY)
    vderiv = (vel[:, None, :] - vel_j) / (pg.r + eps_r)[..., None]
    force = 2.0 * torch.sum(mu_ij[..., None] * vderiv
                            * (pg.dW * vol_j)[..., None], dim=1)

    for wstate, wnl in walls:
        pgw = pair_geometry(pos, wstate["Position"], wnl, kernel, dim,
                            need_W=False, box=box)
        wall_vol, _ = gather(wstate["VolumetricMeasure"], wnl.idx)
        vel_ave_k, _ = gather(wstate["AverageVelocity"], wnl.idx)
        vderiv_w = 2.0 * (vel[:, None, :] - vel_ave_k) \
            / (pgw.r + eps_r)[..., None]
        force = force + 2.0 * mu[:, None] * torch.sum(
            vderiv_w * (pgw.dW * wall_vol)[..., None], dim=1)

    out = dict(fluid)
    out["ViscousForce"] = force * vol[:, None]
    prev = fluid.get("ViscousForcePrev")
    if prev is None:
        prev = torch.zeros_like(force)
    out["ForcePrior"] = fluid["ForcePrior"] + out["ViscousForce"] - prev
    out["ViscousForcePrev"] = out["ViscousForce"]
    return out


def srd_viscous_time_step(fluid: State, smoothing_length: float,
                          diffusion_cfl: float = 0.125):
    """dt = CFL h^2 / max(mu / rho) over the real particles
    (SRDViscousTimeStepSize, non_newtonian_dynamics.cpp:100-115); a 0-d
    tensor."""
    nu = fluid["VariableViscosity"] / fluid["Density"]
    nu = torch.where(valid_mask(fluid), nu, torch.zeros_like(nu))
    return diffusion_cfl * smoothing_length ** 2 / (torch.max(nu) + TINY)


# ---------------------------------------------------------------------------
# Oldroyd-B viscoelasticity
# ---------------------------------------------------------------------------

def make_oldroyd_b_state(fluid: State, dim: int) -> State:
    """Register "ElasticStress" and "ElasticStressChangeRate" (zero)."""
    out = dict(fluid)
    pos = fluid["Position"]
    shape = (pos.shape[0], dim, dim)
    for k in ("ElasticStress", "ElasticStressChangeRate"):
        if k not in out:
            out[k] = torch.zeros(shape, dtype=pos.dtype, device=pos.device)
    return out


def elastic_stress_force(fluid: State, nl_inner: NeighborList, kernel,
                         dim: int, walls=(), box=None):
    """F_i = V_i sum_j (tau_i + tau_j) dW_ij V_j e_ij; a wall pair takes
    2 tau_i (non_newtonian_dynamics.cpp:27-72)."""
    pos, vol = fluid["Position"], fluid["VolumetricMeasure"]
    tau = fluid["ElasticStress"]

    pg = pair_geometry(pos, pos, nl_inner, kernel, dim, need_W=False, box=box)
    vol_j, _ = gather(vol, nl_inner.idx)
    tau_j, _ = gather(tau, nl_inner.idx)
    grad = (pg.dW * vol_j)[..., None] * pg.e
    force = torch.sum(mv(tau[:, None] + tau_j, grad), dim=1)

    for wstate, wnl in walls:
        pgw = pair_geometry(pos, wstate["Position"], wnl, kernel, dim,
                            need_W=False, box=box)
        wall_vol, _ = gather(wstate["VolumetricMeasure"], wnl.idx)
        gw = torch.sum((pgw.dW * wall_vol)[..., None] * pgw.e, dim=1)
        force = force + 2.0 * mv(tau, gw)

    return force * vol[:, None]


def oldroyd_b_stress_half_step(fluid: State, dt) -> State:
    """tau += dtau/dt dt / 2 (the start of the first half, the end of the
    second)."""
    out = dict(fluid)
    out["ElasticStress"] = (fluid["ElasticStress"]
                            + fluid["ElasticStressChangeRate"] * (0.5 * dt))
    return out


def oldroyd_b_stress_rate(fluid: State, nl_inner: NeighborList, kernel,
                          dim: int, model: OldroydBViscosity,
                          box=None) -> State:
    """The upper-convected Maxwell rate (Oldroyd_BIntegration2ndHalf::
    update): dtau/dt = gradv^T tau + tau gradv - tau / lambda
    + (gradv^T + gradv) mu_p / lambda, from a fresh velocity gradient."""
    g = velocity_gradient(fluid, nl_inner, kernel, dim, box)
    gT = g.transpose(-1, -2)
    tau = fluid["ElasticStress"]
    lam, mu_p = model.relaxation_time, model.mu_p
    out = dict(fluid)
    out["VelocityGradient"] = g
    out["ElasticStressChangeRate"] = (mm(gT, tau) + mm(tau, g) - tau / lam
                                      + (gT + g) * (mu_p / lam))
    return out


def oldroyd_b_1st_half(fluid: State, nl_inner: NeighborList, kernel,
                       dim: int, eos, riemann, dt, walls=(),
                       box=None) -> State:
    """Oldroyd_BIntegration1stHalfWithWall: the stress half-step, then the
    acoustic pressure relaxation with the elastic force added to
    ForcePrior for this sub-step only."""
    from sphinxsys_tpu_torch.physics import fluid as fd

    fluid = oldroyd_b_stress_half_step(fluid, dt)
    f_el = elastic_stress_force(fluid, nl_inner, kernel, dim, walls, box)
    work = dict(fluid)
    work["ForcePrior"] = fluid["ForcePrior"] + f_el
    work = fd.acoustic_step_1st_half(work, nl_inner, kernel, dim, eos,
                                     riemann, dt, walls=walls, box=box)
    work["ForcePrior"] = fluid["ForcePrior"]
    return work


def oldroyd_b_2nd_half(fluid: State, nl_inner: NeighborList, kernel,
                       dim: int, riemann, dt, model: OldroydBViscosity,
                       walls=(), box=None) -> State:
    """Oldroyd_BIntegration2ndHalfWithWall: the density relaxation, then
    the stress rate and the trailing stress half-step."""
    from sphinxsys_tpu_torch.physics import fluid as fd

    fluid = fd.acoustic_step_2nd_half(fluid, nl_inner, kernel, dim, riemann,
                                      dt, walls=walls, box=box)
    fluid = oldroyd_b_stress_rate(fluid, nl_inner, kernel, dim, model, box)
    return oldroyd_b_stress_half_step(fluid, dt)
