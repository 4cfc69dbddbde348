"""Windkessel (three-element RCR) outlet condition and the pressure
condition of the buffers (counterpart of sphinxsys_tpu/physics/
windkessel.py; reference extra_src/shared/pressure_boundary/
windkessel_bc.h, TargetOutletPressureWindkessel, and pressure_boundary.h).

The outlet pressure follows the lumped ODE

    dp/dt = -p / (C Rd) + (Rp + Rd) Q / (C Rd) + Rp dQ/dt,

advanced by a Heun step, with the flow rate Q measured through the outlet
buffer.  The Windkessel state is three 0-d tensors on the fluid's device:
accumulating the flow and stepping the ODE read nothing back.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sphinxsys_tpu_torch.core.state import State, valid_mask
from sphinxsys_tpu_torch.neighbors.neighbor_list import gather
from sphinxsys_tpu_torch.physics.pair import pair_geometry

TINY = 1.0e-15


class WindkesselState(NamedTuple):
    p: torch.Tensor         # the outlet pressure p_n
    q: torch.Tensor         # the flow rate Q_n
    flow_acc: torch.Tensor  # the flow volume accumulated since the update


def init_windkessel(p0: float = 0.0, dtype=torch.float32,
                    device="cpu") -> WindkesselState:
    z = torch.zeros((), dtype=dtype, device=device)
    return WindkesselState(p=torch.full((), p0, dtype=dtype, device=device),
                           q=z, flow_acc=z.clone())


def accumulate_flow(wk: WindkesselState, fluid: State, region,
                    axis: int, dt) -> WindkesselState:
    """Add sum(v_axis V) / L_axis dt over the live particles in `region`
    (the smooth form of the reference's counted crossings)."""
    inside = region.contains(fluid["Position"]) & valid_mask(fluid)
    length = region.upper[axis] - region.lower[axis]
    q = fluid["Velocity"][:, axis] * fluid["VolumetricMeasure"]
    flux = torch.sum(torch.where(inside, q, torch.zeros_like(q))) / length
    return wk._replace(flow_acc=wk.flow_acc + flux * dt)


def windkessel_update(wk: WindkesselState, dt, Rp: float, C: float,
                      Rd: float) -> WindkesselState:
    """The Heun step of the RCR ODE (windkessel_bc.h updateNextPressure):
    Q_n = accumulated flow / dt, dQ/dt = (Q_n - Q_0) / dt; the
    accumulator is emptied."""
    q_n = wk.flow_acc / (dt + TINY)
    dq_dt = (q_n - wk.q) / (dt + TINY)

    def rate(p):
        return -p / (C * Rd) + (Rp + Rd) * q_n / (C * Rd) + Rp * dq_dt

    dp = rate(wk.p)
    p_star = wk.p + dp * dt
    p_new = wk.p + 0.5 * dt * (dp + rate(p_star))
    return WindkesselState(p=p_new, q=q_n,
                           flow_acc=torch.zeros_like(wk.flow_acc))


def impose_pressure_condition(fluid: State, region, p_target, eos) -> State:
    """The live particles in `region` take the pressure `p_target` and
    its equation-of-state density."""
    out = dict(fluid)
    inside = region.contains(fluid["Position"]) & valid_mask(fluid)
    p_t = torch.as_tensor(p_target, dtype=fluid["Pressure"].dtype,
                          device=fluid["Pressure"].device)
    out["Pressure"] = torch.where(inside, p_t, fluid["Pressure"])
    out["Density"] = torch.where(inside, eos.density_from_pressure(p_t),
                                 fluid["Density"])
    return out


def kernel_gradient_sum(fluid: State, nl_inner, kernel, dim: int,
                        contacts=(), box=None):
    """S_i = sum_j dW_ij V_j e_ij over the inner and the contact lists:
    ~0 in the bulk, pointing into the domain where the support is cut
    (the open ends)."""
    pos = fluid["Position"]

    def one(pos_s, vol_s, nl):
        pg = pair_geometry(pos, pos_s, nl, kernel, dim, need_W=False,
                           box=box)
        vol_j, _ = gather(vol_s, nl.idx)
        return torch.sum((pg.dW * vol_j)[..., None] * pg.e, dim=1)

    S = one(pos, fluid["VolumetricMeasure"], nl_inner)
    for c_state, nl_c in contacts:
        S = S + one(c_state["Position"], c_state["VolumetricMeasure"], nl_c)
    return S


def pressure_condition_velocity(fluid: State, region, p_target, dt,
                                kernel_sum, axis: int = 0) -> State:
    """The PressureCondition velocity update (pressure_boundary.h:60-70):
    the live particles in `region` gain 2 S_i p_target / rho dt, the
    compensation of their cut support, and keep only their `axis`
    component."""
    out = dict(fluid)
    inside = (region.contains(fluid["Position"]) & valid_mask(fluid))[:, None]
    vel = fluid["Velocity"]
    kick = 2.0 * kernel_sum * p_target / fluid["Density"][:, None] * dt
    vel = vel + torch.where(inside, kick, torch.zeros_like(kick))
    keep = torch.arange(vel.shape[1], device=vel.device) == axis
    aligned = torch.where(keep, vel, torch.zeros_like(vel))
    out["Velocity"] = torch.where(inside, aligned, vel)
    return out
