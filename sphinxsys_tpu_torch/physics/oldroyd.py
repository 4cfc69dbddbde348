"""Oldroyd-B viscoelastic fluid integration (counterpart of
sphinxsys_tpu/physics/oldroyd.py; reference non_newtonian_dynamics.cpp,
Oldroyd_BIntegration1st/2ndHalf).  The weakly-compressible acoustic
halves gain

  * a polymeric force
        F_i = m_i / rho_i sum_j (tau_i + tau_j) dW_ij V_j e_ij     (inner)
            + m_i / rho_i sum_w 2 tau_i dW_iw V_w e_iw             (wall),
    passed to the first half as its `extra_force`;
  * the upper-convected Maxwell transport
        dtau/dt = gradV^T tau + tau gradV - tau / lambda
                  + mu_p / lambda (gradV + gradV^T),
    integrated with the density's half-dt staggering (tau += dtau/dt dt/2
    at the start of the first half and at the end of the second,
    non_newtonian_dynamics.cpp:20-25, 88-97).
"""

from __future__ import annotations

import torch

from sphinxsys_tpu_torch.core.linalg import mm, mv
from sphinxsys_tpu_torch.core.state import State
from sphinxsys_tpu_torch.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_tpu_torch.physics.pair import pair_geometry


def register_variables(fluid: State, dim: int) -> State:
    """ElasticStress, ElasticStressChangeRate and VelocityGradient, zero
    where the state has none."""
    out = dict(fluid)
    pos = fluid["Position"]
    shape = (pos.shape[0], dim, dim)
    for k in ("ElasticStress", "ElasticStressChangeRate", "VelocityGradient"):
        if k not in out:
            out[k] = torch.zeros(shape, dtype=pos.dtype, device=pos.device)
    return out


def stress_half_step(fluid: State, dt) -> State:
    """tau += dtau/dt dt / 2."""
    out = dict(fluid)
    out["ElasticStress"] = (fluid["ElasticStress"]
                            + fluid["ElasticStressChangeRate"] * (0.5 * dt))
    return out


def elastic_stress_force(fluid: State, nl_inner: NeighborList, kernel,
                         dim: int, wall: State | None = None,
                         nl_wall: NeighborList | None = None,
                         box=None) -> torch.Tensor:
    """The polymeric force (N, dim), a Force increment."""
    pos, tau = fluid["Position"], fluid["ElasticStress"]
    vol = fluid["VolumetricMeasure"]
    pg = pair_geometry(pos, pos, nl_inner, kernel, dim, need_W=False, box=box)
    tau_j, _ = gather(tau, nl_inner.idx)
    vol_j, _ = gather(vol, nl_inner.idx)
    grad = (pg.dW * vol_j)[..., None] * pg.e
    force = torch.sum(mv(tau[:, None] + tau_j, grad), dim=1)

    if wall is not None:
        pgw = pair_geometry(pos, wall["Position"], nl_wall, kernel, dim,
                            need_W=False, box=box)
        wvol_j, _ = gather(wall["VolumetricMeasure"], nl_wall.idx)
        gradw = (pgw.dW * wvol_j)[..., None] * pgw.e
        force = force + 2.0 * mv(tau, torch.sum(gradw, dim=1))

    return force * (fluid["Mass"] / fluid["Density"])[:, None]


def stress_rate(fluid: State, model) -> State:
    """The upper-convected Maxwell rate from the state's VelocityGradient."""
    out = dict(fluid)
    g = fluid["VelocityGradient"]
    gt = g.transpose(-1, -2)
    tau = fluid["ElasticStress"]
    out["ElasticStressChangeRate"] = (
        mm(gt, tau) + mm(tau, g) - tau / model.relaxation_time
        + (gt + g) * (model.mu_p / model.relaxation_time))
    return out
