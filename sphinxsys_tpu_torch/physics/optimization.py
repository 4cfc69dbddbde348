"""Target-driven (PDE-constrained) optimization (counterpart of
sphinxsys_tpu/physics/optimization.py; the reference's
diffusion_optimization_dynamics/ splitting iterations).

The diffusion relaxation is a differentiable function of the
per-particle diffusivity, so the gradient of a steady-state mismatch with
respect to the whole field comes from torch.autograd through the
relaxation loop (JAX: jax.grad).  `optimize_diffusivity` fits the
log-diffusivity by Adam, written out with optax.adam's constants and
arithmetic (b1 0.9, b2 0.999, eps 1e-8, bias-corrected moments), so both
packages take the same steps.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from sphinxsys_tpu_torch.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_tpu_torch.physics.pair import pair_geometry

TINY = 1.0e-15
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1.0e-8


def _pair_terms(pos, diffusivity, vol, nl: NeighborList, kernel, dim: int,
                box=None):
    """The per-pair factors of the rate that do not depend on the
    temperature: 0.5 (D_i + D_j) and the area 2 dW V_j / (r + TINY)."""
    pg = pair_geometry(pos, pos, nl, kernel, dim, need_W=False, box=box)
    vol_j, _ = gather(vol, nl.idx)
    d_j, _ = gather(diffusivity, nl.idx)
    return 0.5 * (diffusivity[:, None] + d_j), 2.0 * pg.dW * vol_j / (pg.r + TINY)


def _rate(temperature, nl, d_ij, area):
    t_j, _ = gather(temperature, nl.idx)
    return torch.sum(d_ij * (temperature[:, None] - t_j) * area, dim=1)


def diffusion_rate_local(pos, temperature, diffusivity, vol, nl: NeighborList,
                         kernel, dim: int, box=None):
    """dT/dt with a per-particle diffusivity field: the pair coefficient
    0.5 (D_i + D_j), the reference's LocalDiffusion convention."""
    return _rate(temperature, nl, *_pair_terms(pos, diffusivity, vol, nl,
                                                kernel, dim, box))


class OptimizationResult(NamedTuple):
    diffusivity: torch.Tensor
    losses: torch.Tensor


def solve_steady_temperature(diffusivity, pos, vol, nl, kernel, dim,
                             dirichlet_mask, dirichlet_values, t_init,
                             dt, n_steps: int, box=None):
    """Relax the temperature to (near) steady state by `n_steps` explicit
    steps with the Dirichlet particles held: the forward solve, recorded
    by autograd where `diffusivity` requires a gradient.  The pair factors
    that do not change with T are formed once (the same values as
    `diffusion_rate_local`'s)."""
    d_ij, area = _pair_terms(pos, diffusivity, vol, nl, kernel, dim, box)
    T = t_init
    for _ in range(n_steps):
        T = torch.where(dirichlet_mask, dirichlet_values,
                        T + _rate(T, nl, d_ij, area) * dt)
    return T


def optimize_diffusivity(pos, vol, nl, kernel, dim, dirichlet_mask,
                         dirichlet_values, target_T, d_init,
                         dt, n_solver_steps: int = 200,
                         n_opt_steps: int = 60, lr: float = 0.1,
                         d_bounds=(1e-3, 10.0), box=None) -> OptimizationResult:
    """Fit the log-diffusivity by Adam on mean((T_steady - T_target)^2),
    the gradient by autograd through the solve; the log clipped to
    log(d_bounds) after each step."""
    t0 = torch.where(dirichlet_mask, dirichlet_values,
                     torch.mean(dirichlet_values))
    log_d = torch.log(d_init).detach()
    mu = torch.zeros_like(log_d)
    nu = torch.zeros_like(log_d)
    lo, hi = math.log(d_bounds[0]), math.log(d_bounds[1])
    losses = []
    for k in range(1, n_opt_steps + 1):
        x = log_d.clone().requires_grad_(True)
        T = solve_steady_temperature(torch.exp(x), pos, vol, nl, kernel, dim,
                                     dirichlet_mask, dirichlet_values, t0,
                                     dt, n_solver_steps, box)
        loss = torch.mean((T - target_T) ** 2)
        (g,) = torch.autograd.grad(loss, x)
        mu = (1.0 - ADAM_B1) * g + ADAM_B1 * mu
        nu = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * nu
        mu_hat = mu / (1.0 - ADAM_B1 ** k)
        nu_hat = nu / (1.0 - ADAM_B2 ** k)
        log_d = torch.clamp(log_d - lr * mu_hat / (torch.sqrt(nu_hat)
                                                   + ADAM_EPS), lo, hi)
        losses.append(loss.detach())
    return OptimizationResult(diffusivity=torch.exp(log_d),
                              losses=torch.stack(losses))
