"""Diffusion, reaction and electrophysiology (counterpart of
sphinxsys_tpu/physics/diffusion.py; reference diffusion_reaction_dynamics/
diffusion_dynamics.{h,hpp}, reaction_dynamics.h and electro_physiology/
electro_physiology.cpp:24-56).

The SPH diffusion operator (diffusion_dynamics.hpp:76-99):

    dC/dt_i = sum_j d_ij (C_i - C_j) 2 dW_ij V_j / r_ij,

with Dirichlet, Neumann and Robin contacts; the reaction update of each
species is the exponential integrator (reaction_dynamics.h:48-52)

    C <- C e^{-L dt} + P (1 - e^{-L dt}) / L,

swept forward, then backward, over the species.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch

from sphinxsys_tpu_torch.core.linalg import (cholesky,
                                             lower_triangular_inverse, mv)
from sphinxsys_tpu_torch.core.state import State
from sphinxsys_tpu_torch.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_tpu_torch.physics.pair import pair_geometry

TINY = 1.0e-15


# ---------------------------------------------------------------------------
# Diffusion models (materials/diffusion_reaction.h:47-296)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class IsotropicDiffusion:
    d_coeff: float

    def inter_particle_coeff(self, e_ij):
        return self.d_coeff

    @property
    def reference_diffusivity(self) -> float:
        return self.d_coeff


@dataclasses.dataclass(frozen=True)
class DirectionalDiffusion:
    """D = d I + d_bias f f^T; the pair coefficient 1 / (e^T D^-1 e)
    (diffusion_reaction.h:190-194), by Sherman-Morrison
    d / (1 - b / (d + b) (e.f)^2) for unit e and f."""

    d_coeff: float
    bias_coeff: float
    bias_direction: tuple

    def inter_particle_coeff(self, e_ij):
        f = torch.as_tensor(self.bias_direction, dtype=e_ij.dtype,
                            device=e_ij.device)
        proj = torch.sum(e_ij * f, dim=-1)
        d, b = self.d_coeff, self.bias_coeff
        return d / (1.0 - (b / (d + b)) * proj * proj)

    @property
    def reference_diffusivity(self) -> float:
        return self.d_coeff + self.bias_coeff


@dataclasses.dataclass(frozen=True)
class LocalDirectionalDiffusion:
    """Diffusion biased along a per-particle fiber (LocalDirectionalDiffusion,
    materials/diffusion_reaction.h:236-242): D_i = d I + d_bias f_i f_i^T.
    The pair coefficient is 1 / |0.5 (T_i + T_j) e|^2 with T = chol(D)^-1,
    the inverse Cholesky factor.  `inverse_cholesky` forms T once a
    particle; diffusion_rate gathers T_j by the list (JAX forms it on the
    gathered (N, K, d) fibers: the same values, K times the work).
    `fiber_key` names the state's fiber field, which diffusion_step reads
    when the diffusion carries this attribute."""

    d_coeff: float
    bias_coeff: float
    fiber_key: str = "Fiber"

    def inverse_cholesky(self, f):
        """T = chol(d I + b f f^T)^-1 for a (..., dim) fiber stack, in the
        closed forms of core/linalg.py."""
        eye = torch.eye(f.shape[-1], dtype=f.dtype, device=f.device)
        D = self.d_coeff * eye + self.bias_coeff * (f[..., :, None]
                                                    * f[..., None, :])
        return lower_triangular_inverse(cholesky(D))

    def inter_particle_coeff(self, e_ij, T_i=None, T_j=None):
        """(N, K) coefficients from the (N, d, d) T_i and the gathered
        (N, K, d, d) T_j; without them (a contact), d + b / 2."""
        if T_i is None:
            return self.d_coeff + 0.5 * self.bias_coeff
        g = mv(0.5 * (T_i[:, None] + T_j), e_ij)
        return 1.0 / (torch.sum(g * g, dim=-1) + TINY)

    @property
    def reference_diffusivity(self) -> float:
        return self.d_coeff + self.bias_coeff


def diffusion_time_step(h: float, diffusion, dim: int) -> float:
    """dt = 0.5 h^2 / d / dim (diffusion_reaction.cpp:16-19)."""
    return 0.5 * h * h / diffusion.reference_diffusivity / dim


# ---------------------------------------------------------------------------
# Diffusion relaxation
# ---------------------------------------------------------------------------

def diffusion_rate(pos_q, species_q, vol_s, pos_s, species_s,
                   nl: NeighborList, kernel, dim: int, diffusion, box=None,
                   B_q=None, B_s=None, local_diff_q=None, local_diff_s=None,
                   fiber_q=None, fiber_s=None):
    """dC/dt through one relation.  `B_q` / `B_s`: the two sides'
    correction matrices; the pair's area then takes the corrected
    gradient 0.5 (B_i + B_j) e (CorrectedKernelGradientInner,
    diffusion_dynamics.h:92-103).  `local_diff_q` / `local_diff_s`:
    per-particle diffusivities (LocalIsotropicDiffusion), the pair
    coefficient their mean 0.5 (k_i + k_j), or k_i against a body
    without one.  `fiber_q` / `fiber_s`: the two sides' fibers of a
    LocalDirectionalDiffusion (`fiber_s` defaults to `fiber_q`)."""
    pg = pair_geometry(pos_q, pos_s, nl, kernel, dim, need_W=False, box=box)
    vol_j, _ = gather(vol_s, nl.idx)
    c_j, _ = gather(species_s, nl.idx)
    if local_diff_q is not None:
        if local_diff_s is None:
            d_ij = local_diff_q[:, None]
        else:
            k_j, _ = gather(local_diff_s, nl.idx)
            d_ij = 0.5 * (local_diff_q[:, None] + k_j)
    elif fiber_q is not None:
        T_q = diffusion.inverse_cholesky(fiber_q)
        T_s = T_q if fiber_s is None else diffusion.inverse_cholesky(fiber_s)
        T_j, _ = gather(T_s, nl.idx)
        d_ij = diffusion.inter_particle_coeff(pg.e, T_q, T_j)
    else:
        d_ij = diffusion.inter_particle_coeff(pg.e)
    area = 2.0 * pg.dW * vol_j / (pg.r + TINY)
    if B_q is not None:
        B_j, _ = gather(B_s if B_s is not None else B_q, nl.idx)
        Be = mv(0.5 * (B_q[:, None] + B_j), pg.e)
        area = area * torch.sum(Be * pg.e, dim=-1)
    return torch.sum(d_ij * (species_q[:, None] - c_j) * area, dim=1)


def _normal_area(pos_q, n_q, vol_s, pos_s, n_s, nl: NeighborList, kernel,
                 dim: int, box=None):
    """The surface-area measure of a Neumann or Robin contact pair
    (diffusion_dynamics.hpp:258-262, 329-332):
    area_ij = dW_ij V_j e_ij . (n_i - n_j)."""
    pg = pair_geometry(pos_q, pos_s, nl, kernel, dim, need_W=False, box=box)
    vol_j, _ = gather(vol_s, nl.idx)
    n_j, _ = gather(n_s, nl.idx)
    n_ij = n_q[:, None, :] - n_j
    return (pg.dW * vol_j) * torch.sum(pg.e * n_ij, dim=-1)


def neumann_rate(state: State, species: str, contact_state: State,
                 nl_c: NeighborList, kernel, dim: int, box=None):
    """The Neumann contact's rate (diffusion_dynamics.hpp:233-265):
    sum_j area_ij flux_j, the boundary's "<species>Flux"."""
    area = _normal_area(state["Position"], state["NormalDirection"],
                        contact_state["VolumetricMeasure"],
                        contact_state["Position"],
                        contact_state["NormalDirection"], nl_c, kernel, dim,
                        box)
    flux_j, _ = gather(contact_state[species + "Flux"], nl_c.idx)
    return torch.sum(area * flux_j, dim=1)


def robin_rate(state: State, species: str, contact_state: State,
               nl_c: NeighborList, kernel, dim: int, c_infinity, box=None):
    """The Robin contact's rate (diffusion_dynamics.hpp:296-337):
    sum_j conv_j area_ij (C_inf - C_i), the boundary's
    "<species>Convection"."""
    area = _normal_area(state["Position"], state["NormalDirection"],
                        contact_state["VolumetricMeasure"],
                        contact_state["Position"],
                        contact_state["NormalDirection"], nl_c, kernel, dim,
                        box)
    conv_j, _ = gather(contact_state[species + "Convection"], nl_c.idx)
    phi = c_infinity - state[species]
    return torch.sum(area * conv_j, dim=1) * phi


def diffusion_step(state: State, species: str, nl_inner: NeighborList,
                   kernel, dim: int, diffusion, dt,
                   dirichlet_contacts: Sequence[tuple] = (),
                   neumann_contacts: Sequence[tuple] = (),
                   robin_contacts: Sequence[tuple] = (), box=None,
                   correction: bool = False, local_diff: str = None) -> State:
    """One explicit Euler step of `species`.
      dirichlet_contacts: (state, list) pairs with fixed `species` values,
          the jump doubled (diffusion_dynamics.hpp:180);
      neumann_contacts: (state, list) pairs carrying "<species>Flux" and
          NormalDirection;
      robin_contacts: (state, list, c_infinity) triples carrying
          "<species>Convection";
      correction: the inner pairs take the state's
          LinearGradientCorrectionMatrix;
      local_diff: the state key of a per-particle diffusivity.
    A diffusion with a `fiber_key` (LocalDirectionalDiffusion) reads that
    field for its inner pairs."""
    pos = state["Position"]
    c = state[species]
    B = state["LinearGradientCorrectionMatrix"] if correction else None
    kq = state[local_diff] if local_diff is not None else None
    fq = state[diffusion.fiber_key] if hasattr(diffusion, "fiber_key") \
        else None
    rate = diffusion_rate(pos, c, state["VolumetricMeasure"], pos, c,
                          nl_inner, kernel, dim, diffusion, box, B_q=B,
                          local_diff_q=kq, local_diff_s=kq, fiber_q=fq)
    for c_state, nl_c in dirichlet_contacts:
        rate = rate + 2.0 * diffusion_rate(
            pos, c, c_state["VolumetricMeasure"], c_state["Position"],
            c_state[species], nl_c, kernel, dim, diffusion, box,
            local_diff_q=kq,
            local_diff_s=c_state.get(local_diff) if local_diff else None)
    for c_state, nl_c in neumann_contacts:
        rate = rate + neumann_rate(state, species, c_state, nl_c, kernel,
                                   dim, box)
    for c_state, nl_c, c_inf in robin_contacts:
        rate = rate + robin_rate(state, species, c_state, nl_c, kernel, dim,
                                 c_inf, box)
    out = dict(state)
    out[species] = c + rate * dt
    return out


def diffusion_step_local_rk2(state: State, species: str,
                             nl_inner: NeighborList, kernel, dim: int,
                             diffusion, dt, local_diff: str,
                             robin_contacts: Sequence[tuple] = (),
                             box=None) -> State:
    """The RK2 relaxation with a per-particle diffusivity and Robin
    boundaries (the windows frame's composition): two Euler steps, then
    the mean of the start and the second."""
    c0 = state[species]
    s1 = diffusion_step(state, species, nl_inner, kernel, dim, diffusion, dt,
                        robin_contacts=robin_contacts, box=box,
                        local_diff=local_diff)
    s2 = diffusion_step(s1, species, nl_inner, kernel, dim, diffusion, dt,
                        robin_contacts=robin_contacts, box=box,
                        local_diff=local_diff)
    out = dict(s2)
    out[species] = 0.5 * (c0 + s2[species])
    return out


def diffusion_step_rk2(state: State, species: str, nl_inner: NeighborList,
                       kernel, dim: int, diffusion, dt,
                       dirichlet_contacts: Sequence[tuple] = (), box=None,
                       neumann_contacts: Sequence[tuple] = (),
                       robin_contacts: Sequence[tuple] = (),
                       correction: bool = False) -> State:
    """DiffusionRelaxationRK2: two Euler steps, then the mean of the start
    and the second."""
    c0 = state[species]
    s1 = diffusion_step(state, species, nl_inner, kernel, dim, diffusion, dt,
                        dirichlet_contacts, neumann_contacts, robin_contacts,
                        box, correction)
    s2 = diffusion_step(s1, species, nl_inner, kernel, dim, diffusion, dt,
                        dirichlet_contacts, neumann_contacts, robin_contacts,
                        box, correction)
    out = dict(s2)
    out[species] = 0.5 * (c0 + s2[species])
    return out


# ---------------------------------------------------------------------------
# Reaction models and the operator-split relaxation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AlievPanfilowModel:
    """The two-variable excitation-recovery cell model
    (electro_physiology.cpp:24-56), its rates split into production P and
    loss L for the exponential integrator:
        Voltage V:      P = -k V (V^2 - a V - V) / c_m,  L = (k a + w) / c_m
        GateVariable w: P = -g k V (V - b - 1),          L = g,
                        g = eps + mu1 w / (mu2 + V);
    with k_a != 0 also "ActiveContractionStress"."""

    k_a: float = 0.0
    c_m: float = 1.0
    k: float = 8.0
    a: float = 0.15
    b: float = 0.15
    mu_1: float = 0.2
    mu_2: float = 0.3
    epsilon: float = 0.002

    @property
    def species_names(self):
        if self.k_a != 0.0:
            return ("Voltage", "GateVariable", "ActiveContractionStress")
        return ("Voltage", "GateVariable")

    def rates(self, name: str, species: Dict[str, torch.Tensor]):
        v = species["Voltage"]
        w = species["GateVariable"]
        if name == "Voltage":
            production = -self.k * v * (v * v - self.a * v - v) / self.c_m
            loss = (self.k * self.a + w) / self.c_m
        elif name == "GateVariable":
            g = self.epsilon + self.mu_1 * w / (self.mu_2 + v + TINY)
            production = -g * self.k * v * (v - self.b - 1.0)
            loss = g
        elif name == "ActiveContractionStress":
            v_dim = v * 100.0 - 80.0
            factor = 0.1 + 0.9 * torch.exp(-torch.exp(-v_dim))
            production = factor * self.k_a * (v_dim + 80.0)
            loss = factor
        else:
            raise KeyError(name)
        return production, loss


def _exponential_update(c, production, loss, dt):
    """The quasi-steady exponential integrator (reaction_dynamics.h:48-52)."""
    alpha = torch.exp(-loss * dt)
    return c * alpha + production * (1.0 - alpha) / (loss + TINY)


def reaction_step(state: State, model, dt, backward: bool = False) -> State:
    """One sweep over the model's species, each updated from the values
    the sweep has reached (ReactionRelaxation forward / backward,
    reaction_dynamics.h:55-80)."""
    out = dict(state)
    names = list(model.species_names)
    if backward:
        names = names[::-1]
    for name in names:
        species = {k: out[k] for k in model.species_names}
        production, loss = model.rates(name, species)
        out[name] = _exponential_update(out[name], production, loss, dt)
    return out


def electrophysiology_step(state: State, nl_inner: NeighborList, kernel,
                           dim: int, diffusion, model, dt, box=None) -> State:
    """The monodomain Strang splitting (electro_physiology.h:42-104): half
    a reaction forward, the RK2 diffusion of Voltage (corrected where the
    state carries its correction matrix), half a reaction backward."""
    s = reaction_step(state, model, 0.5 * dt)
    s = diffusion_step_rk2(s, "Voltage", nl_inner, kernel, dim, diffusion, dt,
                           box=box,
                           correction="LinearGradientCorrectionMatrix" in s)
    return reaction_step(s, model, 0.5 * dt, backward=True)
