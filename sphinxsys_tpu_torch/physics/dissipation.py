"""Operator-split implicit damping (counterpart of
sphinxsys_tpu/physics/dissipation.py; reference particle_dynamics/
dissipation_dynamics/particle_dynamics_dissipation.{h,hpp}): the damping
of a field (the velocity, for the viscous damping of solids) by per-pair
implicit updates.

The reference walks the pairs in coloured Gauss-Seidel sweeps; as in the
JAX package, every pair updates at once (Jacobi) with the same per-pair
implicit increment

    b      = rate dW_ij V_i V_j dt / r_ij        (b <= 0)
    dphi   = b (phi_i - phi_j) / (C_i C_j - b (C_i + C_j))
    phi_i += dphi C_j ;  phi_j -= dphi C_i

for a fixed number of sweeps, with an overshoot limiter that keeps each
sweep stable.  `damping_implicit_cg` solves the backward-Euler system of
the same operator exactly, by a Jacobi-preconditioned conjugate gradient
that runs a fixed number of iterations on the device and freezes its
iterate once the stopping test fails: it reads nothing back to the host.
"""

from __future__ import annotations

import torch

from sphinxsys_tpu_torch.core.state import State
from sphinxsys_tpu_torch.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_tpu_torch.physics.pair import pair_geometry

TINY = 1.0e-15


def _pair_weight(state: State, src: State, nl: NeighborList, kernel,
                 dim: int, box=None):
    """(dW_ij V_i V_j / (r_ij + TINY), the pair mask): the pair factor of
    every damping form, 0 on the list's sentinel slots."""
    pg = pair_geometry(state["Position"], src["Position"], nl, kernel, dim,
                       need_W=False, box=box)
    vol_j, _ = gather(src["VolumetricMeasure"], nl.idx)
    return (pg.dW * state["VolumetricMeasure"][:, None] * vol_j
            / (pg.r + TINY)), pg.mask


def _relax(phi, coef, phi_j):
    """phi_i - sum_j coef_ij (phi_i - phi_j), a scalar or a vector field."""
    if phi.dim() == 2:
        return phi - torch.sum(coef[..., None] * (phi[:, None, :] - phi_j),
                               dim=1)
    return phi - torch.sum(coef * (phi[:, None] - phi_j), dim=1)


def damping_pairwise(state: State, field: str, nl_inner: NeighborList,
                     kernel, dim: int, eta: float, dt,
                     capacity_key: str = "Mass", n_sweeps: int = 2,
                     box=None) -> State:
    """Implicit pairwise damping of `field` (a vector or a scalar) with the
    damping rate eta (the dynamic viscosity, for the velocity) and the
    per-particle capacity (the mass, for the velocity), `n_sweeps` Jacobi
    sweeps.  The overshoot limiter scales each pair by
    min(1, 1/a_i, 1/a_j), a_i = sum_j coef_ij, the same factor on both
    sides, so the momentum stays conserved."""
    out = dict(state)
    phi = state[field]
    cap = state[capacity_key]
    w, _ = _pair_weight(state, state, nl_inner, kernel, dim, box)
    b = eta * w * dt                                     # (N, K) <= 0
    cap_j, _ = gather(cap, nl_inner.idx)
    denom = cap[:, None] * cap_j - b * (cap[:, None] + cap_j)
    coef = -b * cap_j / denom
    a = torch.sum(coef, dim=1)
    a_j, _ = gather(a, nl_inner.idx)
    scale = torch.clamp(torch.minimum(1.0 / torch.clamp(a[:, None], min=TINY),
                                      1.0 / torch.clamp(a_j, min=TINY)),
                        max=1.0)
    coef = coef * scale
    for _ in range(n_sweeps):
        phi_j, _ = gather(phi, nl_inner.idx)
        phi = _relax(phi, coef, phi_j)
    out[field] = phi
    return out


def damping_pairwise_wall(state: State, field: str, wall: State,
                          nl_wall: NeighborList, kernel, dim: int,
                          eta: float, dt, capacity_key: str = "Mass",
                          wall_field: str | None = None, box=None,
                          n_sweeps: int = 2) -> State:
    """Damping<Contact<Pairwise, Wall>> (particle_dynamics_dissipation.hpp:
    123-157): implicit damping of `field` toward the wall's `wall_field`
    (zero where None, a static wall), the wall side never updated:

        b = rate dW_ij V_i V_j dt / r_ij,  phi_i += b (phi_i - phi_w) / (C_i - 2 b)

    in `n_sweeps` Jacobi passes, each pair's weight limited as
    damping_pairwise's."""
    out = dict(state)
    phi = state[field]
    cap = state[capacity_key]
    w, _ = _pair_weight(state, wall, nl_wall, kernel, dim, box)
    b = eta * w * dt
    coef = -b / (cap[:, None] - 2.0 * b)
    a = torch.sum(coef, dim=1)
    coef = coef * torch.clamp(1.0 / torch.clamp(a[:, None], min=TINY),
                              max=1.0)
    if wall_field is not None:
        phi_w, _ = gather(wall[wall_field], nl_wall.idx)
    else:
        phi_w = torch.zeros((*coef.shape, *phi.shape[1:]), dtype=phi.dtype,
                            device=phi.device)
    for _ in range(n_sweeps):
        phi = _relax(phi, coef, phi_w)
    out[field] = phi
    return out


def damping_projection(state: State, field: str, nl_inner: NeighborList,
                       kernel, dim: int, eta: float, dt,
                       capacity_key: str = "Mass", box=None) -> State:
    """Damping<Inner<Projection>> (particle_dynamics_dissipation.hpp:
    19-63) as the JAX package's order-free Jacobi analog: every particle's
    projection from the same state,

        b_ij  = 2 eta dW_ij V_i V_j dt / r_ij,
        err_i = -sum_j (phi_i - phi_j) b_ij,  a_i = sum_j b_ij - C_i,
        c_i   = sum_j b_ij^2,  k_i = err_i / (a_i^2 + c_i),
        dphi_m = k_m a_m - sum_j (phi_j + k_j a_j - phi_m + k_j b_mj) b_mj / C_m."""
    out = dict(state)
    phi = state[field]
    cap = state[capacity_key]
    w, mask = _pair_weight(state, state, nl_inner, kernel, dim, box)
    b = 2.0 * eta * w * dt * mask.to(phi.dtype)
    vec = phi.dim() == 2
    bv = b[..., None] if vec else b
    phi_j, _ = gather(phi, nl_inner.idx)
    phi_i = phi[:, None, :] if vec else phi[:, None]
    err = -torch.sum((phi_i - phi_j) * bv, dim=1)
    a = torch.sum(b, dim=1) - cap
    c = torch.sum(b * b, dim=1)
    denom = a * a + c + TINY
    k = err / (denom[:, None] if vec else denom)
    k_j, _ = gather(k, nl_inner.idx)
    a_j, _ = gather(a, nl_inner.idx)
    if vec:
        exch = phi_j + k_j * a_j[..., None] - phi_i + k_j * bv
        dphi = k * a[:, None] - torch.sum(exch * bv, dim=1) / cap[:, None]
    else:
        exch = phi_j + k_j * a_j - phi_i + k_j * b
        dphi = k * a - torch.sum(exch * b, dim=1) / cap
    out[field] = phi + dphi
    return out


def conjugate_gradient(matvec, b, x0, precond, tol: float, max_iter: int):
    """Preconditioned CG for SPD `matvec`, step for step JAX 0.9.0's
    `_cg_solve` (jax/_src/scipy/sparse/linalg.py:103-140) with a
    preconditioner: the test `r.r > max(tol^2 b.b, 0)` and `k < max_iter`
    before each iteration, the dot products over the whole field.  All
    `max_iter` iterations run on the device; once the test fails, x, r,
    gamma and p are frozen (torch.where, so the 0/0 of a converged
    iteration never reaches them).  No host read.  Returns (x, the
    iterations taken as a 0-d int64 tensor)."""
    def vdot(u, v):
        return torch.sum(u * v)

    atol2 = torch.clamp(tol * tol * vdot(b, b), min=0.0)
    r = b - matvec(x0)
    p = z = precond(r)
    gamma = vdot(r, z)
    x = x0
    active = torch.ones((), dtype=torch.bool, device=b.device)
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    for _ in range(max_iter):
        active = active & (vdot(r, r) > atol2)
        Ap = matvec(p)
        alpha = gamma / vdot(p, Ap)
        x_ = x + alpha * p
        r_ = r - alpha * Ap
        z_ = precond(r_)
        gamma_ = vdot(r_, z_)
        p_ = z_ + (gamma_ / gamma) * p
        x = torch.where(active, x_, x)
        r = torch.where(active, r_, r)
        p = torch.where(active, p_, p)
        gamma = torch.where(active, gamma_, gamma)
        k = k + active.to(torch.int64)
    return x, k


def implicit_cg_system(state: State, field: str, nl_inner: NeighborList,
                       kernel, dim: int, eta: float, dt, walls=(),
                       capacity_key: str = "Mass", box=None,
                       inner_factor: float = 2.0):
    """The backward-Euler damping system of `damping_implicit_cg`:
    (matvec, rhs, Jacobi preconditioner) of

        (M + dt A) phi_new = M phi_old + dt A_w phi_wall,
        (A phi)_i = sum_j w_ij (phi_i - phi_j),
        w_ij = inner_factor eta |dW_ij| V_i V_j / r_ij,

    plus each wall's rows, 2 eta |dW_iw| V_i V_w / r_iw, damping toward
    its `wall_field` (zero where None).  `walls`: (wall state, list,
    wall_field) triples."""
    phi0 = state[field]
    cap = state[capacity_key]
    w_in = -inner_factor * eta * _pair_weight(state, state, nl_inner,
                                              kernel, dim, box)[0]
    idx = nl_inner.idx
    vec = phi0.dim() == 2
    rhs = cap[:, None] * phi0 if vec else cap * phi0
    diag_w = torch.zeros_like(cap)
    for wstate, nlw, wall_field in walls:
        w_w = -eta * _pair_weight(state, wstate, nlw, kernel, dim, box)[0]
        diag_w = diag_w + 2.0 * torch.sum(w_w, dim=1)
        if wall_field is not None:
            phi_w, _ = gather(wstate[wall_field], nlw.idx)
            ww = w_w[..., None] if vec else w_w
            rhs = rhs + dt * (2.0 * torch.sum(ww * phi_w, dim=1))
    own = cap + dt * diag_w

    def matvec(phi):
        phi_j, _ = gather(phi, idx)
        if vec:
            lap = torch.sum(w_in[..., None] * (phi[:, None, :] - phi_j), dim=1)
            return own[:, None] * phi + dt * lap
        lap = torch.sum(w_in * (phi[:, None] - phi_j), dim=1)
        return own * phi + dt * lap

    diag = cap + dt * (diag_w + torch.sum(w_in, dim=1))
    pre = (1.0 / diag)[:, None] if vec else 1.0 / diag
    return matvec, rhs, lambda r: pre * r


def damping_implicit_cg(state: State, field: str, nl_inner: NeighborList,
                        kernel, dim: int, eta: float, dt, walls=(),
                        capacity_key: str = "Mass", box=None,
                        tol: float = 1.0e-6, max_iter: int = 60,
                        inner_factor: float = 2.0) -> State:
    """The exact backward-Euler damping solve (`implicit_cg_system`) by
    Jacobi-preconditioned CG from phi_old (`conjugate_gradient`): the
    deep-implicit answer that the Jacobi sweeps of damping_pairwise, which
    move momentum one kernel support a call, only approach."""
    matvec, rhs, pre = implicit_cg_system(state, field, nl_inner, kernel,
                                          dim, eta, dt, walls, capacity_key,
                                          box, inner_factor)
    out = dict(state)
    out[field], _ = conjugate_gradient(matvec, rhs, state[field], pre, tol,
                                       max_iter)
    return out
