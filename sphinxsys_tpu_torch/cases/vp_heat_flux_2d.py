"""Target-driven thermal optimisation: steady conduction and an optimised
conductivity layout (counterpart of sphinxsys_tpu/cases/vp_heat_flux_2d.py;
reference tests/optimization/ test_2d_VP_heat_flux_steady,
_optimization, test_2d_VP_same_sink_steady and _optimization).

  * "heat_flux": a unit square (dx = 1/50) in a wall frame with two
    Dirichlet patches on the bottom (300 at x in (0.3, 0.4), 350 at x in
    (0.6, 0.7)) and a heat flux q = 2000 on the top (x in (0.45, 0.55));
  * "same_sink": both sinks at 300 (x in (0.4, 0.6), bottom and top) and
    a uniform heat source 1000.

The steady field solves the linear system of the reference's converged
splitting iteration (diffusion_splitting_state.hpp:20-130),

    sum_j 2 k_ij dW_ij V_j / r_ij (T_i - T_j)                     (inner)
  + sum_w [phi_w > 0] 4 k_i dW_iw V_w / r_iw (T_i - phi_w)    (Dirichlet)
  = sum_w q_w dW_iw V_w e_iw . (n_i - n_w) + src_i (Neumann, source),

k_ij = (k_i + k_j) / 2, as one dense solve (`torch.linalg.solve_ex`, no
host read) under autograd: the gradient of the mean temperature in the
per-particle conductivity comes through the solve.  The optimisation is
Adam (written out in optax's order) on log k, each step followed by the
reference's projection (k >= 0.1, mean k = 1) and a Shepard smoothing
blend.

    case = build_case("heat_flux", dx=0.1, device="cpu")
    k, T, hist = optimize_conductivity(case, n_steps=5)
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from sphinxsys_tpu_torch.core import geometry as G
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.generators import generate_lattice
from sphinxsys_tpu_torch.device import resolve_device, resolve_dtype
from sphinxsys_tpu_torch.neighbors.cell_list import (build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list,
                                                        gather)
from sphinxsys_tpu_torch.physics import general as gd
from sphinxsys_tpu_torch.physics.pair import pair_geometry

L = 1.0
H = 1.0
DIFF_COEFF = 1.0          # the initial (mean) conductivity
LEFT_T = 300.0
RIGHT_T = 350.0
HEAT_FLUX = 2000.0
SINK_T = 300.0
HEAT_SOURCE = 1000.0
K_MIN = 0.1               # the reference's lower bound on k
# optax.adam's defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1.0e-8


@dataclasses.dataclass(frozen=True)
class VPCase:
    config: str
    dx: float
    adaptation: SPHAdaptation
    body: Any            # the thermal domain (Position, volume, normals)
    wall: Any            # the frame (Phi Dirichlet values, HeatFlux)
    nl_inner: NeighborList
    nl_c: NeighborList
    heat_source: torch.Tensor
    flux_region: torch.Tensor   # (N,) bool: the flux patch's top strip

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(config: str = "heat_flux", dx: float = H / 50.0,
               dtype=torch.float64, cell_cap: int = 16, k_inner: int = 40,
               k_contact: int = 32, device="cuda") -> VPCase:
    """The body, the frame with its Dirichlet and flux values, the frozen
    lists (their overflow checked once, on the host)."""
    if config not in ("heat_flux", "same_sink"):
        raise ValueError(f"config {config!r}: heat_flux or same_sink")
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    bw = 4.0 * dx
    body_shape = G.Box(G.Transform(translation=(L / 2, H / 2)),
                       halfsize=(L / 2, H / 2))
    outer = G.Box(G.Transform(translation=(L / 2, H / 2)),
                  halfsize=(L / 2 + bw, H / 2 + bw))
    wall_shape = G.make_complex(("add", outer), ("sub", body_shape))
    lo, hi = (-bw, -bw), (L + bw, H + bw)
    pos_b, vol = generate_lattice(body_shape, lo, hi, dx)
    pos_w, _ = generate_lattice(wall_shape, lo, hi, dx)

    def mkstate(pos):
        return {"Position": torch.as_tensor(pos, dtype=dtype, device=device),
                "VolumetricMeasure": torch.full((len(pos),), vol,
                                                dtype=dtype, device=device),
                "NReal": len(pos)}

    body = gd.normal_direction_from_shape(mkstate(pos_b), body_shape)
    wall = gd.normal_direction_from_shape(mkstate(pos_w), wall_shape)
    xw, yw = pos_w[:, 0], pos_w[:, 1]
    phi_w = np.zeros(len(pos_w))
    flux_w = np.zeros(len(pos_w))
    src_b = np.zeros(len(pos_b))
    if config == "heat_flux":       # VP_heat_flux_steady.cpp:119-134
        phi_w = np.where((yw < 0.0) & (xw > 0.3 * L) & (xw < 0.4 * L),
                         LEFT_T, phi_w)
        phi_w = np.where((yw < 0.0) & (xw > 0.6 * L) & (xw < 0.7 * L),
                         RIGHT_T, phi_w)
        flux_w = np.where((yw > H) & (xw > 0.45 * L) & (xw < 0.55 * L),
                          HEAT_FLUX, flux_w)
    else:                            # VP_same_sink_steady.cpp:109-121
        phi_w = np.where((yw < 0.0) & (xw > 0.4 * L) & (xw < 0.6 * L),
                         SINK_T, phi_w)
        phi_w = np.where((yw > H) & (xw > 0.4 * L) & (xw < 0.6 * L),
                         SINK_T, phi_w)
        src_b[:] = HEAT_SOURCE
    wall["Phi"] = torch.as_tensor(phi_w, dtype=dtype, device=device)
    wall["HeatFlux"] = torch.as_tensor(flux_w, dtype=dtype, device=device)
    xb, yb = pos_b[:, 0], pos_b[:, 1]
    flux_region = (yb > H - dx) & (xb > 0.45 * L) & (xb < 0.55 * L)

    grid = grid_from_bounds(lo, hi, adaptation.cutoff)
    nb, nw = body["NReal"], wall["NReal"]
    tb = build_cell_table(body["Position"], nb, grid, cell_cap)
    tw = build_cell_table(wall["Position"], nw, grid, cell_cap)
    nl_inner = build_neighbor_list(body["Position"], nb, body["Position"], nb,
                                   tb, grid, adaptation.cutoff,
                                   k_max=k_inner, include_self=False)
    nl_c = build_neighbor_list(body["Position"], nb, wall["Position"], nw,
                               tw, grid, adaptation.cutoff, k_max=k_contact,
                               include_self=True)
    if bool(nl_inner.overflow | nl_c.overflow):
        raise RuntimeError("vp_heat_flux_2d: a neighbour list overflows")
    return VPCase(config=config, dx=dx, adaptation=adaptation, body=body,
                  wall=wall, nl_inner=nl_inner, nl_c=nl_c,
                  heat_source=torch.as_tensor(src_b, dtype=dtype,
                                              device=device),
                  flux_region=torch.as_tensor(flux_region, device=device))


# ---------------------------------------------------------------------------
# the steady solve
# ---------------------------------------------------------------------------

def steady_system(case: VPCase, k):
    """(A, b) of the steady system (module docstring) for the conductivity
    k (N,): A's off-diagonal entries are added at the inner slots."""
    body, wall = case.body, case.wall
    pos, vol = body["Position"], body["VolumetricMeasure"]
    n = pos.shape[0]
    kern = case.kernel

    pg = pair_geometry(pos, pos, case.nl_inner, kern, 2, need_W=False)
    vol_j, _ = gather(vol, case.nl_inner.idx)
    k_j, _ = gather(k, case.nl_inner.idx)
    k_ij = 0.5 * (k[:, None] + k_j)
    a_in = -2.0 * k_ij * pg.dW * vol_j / (pg.r + 1e-15)
    a_in = torch.where(pg.mask, a_in, torch.zeros_like(a_in))

    pgw = pair_geometry(pos, wall["Position"], case.nl_c, kern, 2,
                        need_W=False)
    volw_j, _ = gather(wall["VolumetricMeasure"], case.nl_c.idx)
    phi_j, _ = gather(wall["Phi"], case.nl_c.idx)
    a_w = -2.0 * 2.0 * k[:, None] * pgw.dW * volw_j / (pgw.r + 1e-15)
    a_w = torch.where(pgw.mask & (phi_j > 0.0), a_w, torch.zeros_like(a_w))

    nw_j, _ = gather(wall["NormalDirection"], case.nl_c.idx)
    n_ij = body["NormalDirection"][:, None, :] - nw_j
    area = pgw.dW * volw_j * torch.sum(pgw.e * n_ij, dim=-1)
    q_j, _ = gather(wall["HeatFlux"], case.nl_c.idx)
    flux = torch.sum(torch.where(pgw.mask, area * q_j, torch.zeros_like(area)),
                     dim=1)

    diag = torch.sum(a_in, dim=1) + torch.sum(a_w, dim=1)
    # entry (i, j) of each inner slot; the sentinel slots go to a dump
    # entry past the matrix
    idx = case.nl_inner.idx.long()
    rows = torch.arange(n, device=pos.device)[:, None]
    flat = torch.where(idx < n, rows * n + idx, torch.full_like(idx, n * n))
    A = torch.zeros(n * n + 1, dtype=k.dtype, device=k.device).index_add(
        0, flat.reshape(-1), -a_in.reshape(-1))[:n * n].reshape(n, n)
    A = A + torch.diag(diag)
    b = torch.sum(a_w * phi_j, dim=1) + flux + case.heat_source
    return A, b


def steady_temperature(case: VPCase, k) -> torch.Tensor:
    """The steady field for the conductivity k, one dense LU solve;
    differentiable in k."""
    A, b = steady_system(case, k)
    return torch.linalg.solve_ex(A, b, check_errors=False)[0]


def boundary_averaged_temperature(case: VPCase, T):
    """The mean over the flux patch's strip."""
    w = case.flux_region.to(T.dtype)
    return torch.sum(T * w) / torch.sum(w)


# ---------------------------------------------------------------------------
# the optimisation
# ---------------------------------------------------------------------------

def _shepard_smooth(case: VPCase, k, blend):
    """One Shepard-filter blend of k (the stand-in for the reference's
    RegularizationByDiffusionAnalogy: the same fixed points, the same
    smoothing direction)."""
    pos, vol = case.body["Position"], case.body["VolumetricMeasure"]
    pg = pair_geometry(pos, pos, case.nl_inner, case.kernel, 2,
                       need_dW=False)
    vol_j, _ = gather(vol, case.nl_inner.idx)
    k_j, _ = gather(k, case.nl_inner.idx)
    w_self = case.kernel.W(torch.zeros_like(k), 2) * vol
    num = torch.sum(pg.W * vol_j * k_j, dim=1) + w_self * k
    den = torch.sum(pg.W * vol_j, dim=1) + w_self
    return (1.0 - blend) * k + blend * num / den


def project_conductivity(k, k0=DIFF_COEFF):
    """k >= K_MIN and mean(k) = k0 (ThermalConductivityConstraint): three
    rounds of rescale and clamp."""
    for _ in range(3):
        k = k * (k0 / torch.mean(k))
        k = torch.maximum(k, torch.full_like(k, K_MIN))
    return k


def loss(case: VPCase, theta, with_region: bool = True):
    """The mean steady temperature of k = project(exp(theta)), plus 0.2 of
    the flux strip's mean (the heat-flux config's second gate) where
    `with_region`."""
    T = steady_temperature(case, project_conductivity(torch.exp(theta)))
    j = torch.mean(T)
    if with_region:
        j = j + 0.2 * boundary_averaged_temperature(case, T)
    return j


def adam_update(g, mu, nu, count: int, lr: float):
    """optax.adam's update in its order of operations: the moments, their
    bias corrections at step `count` (1-based), -lr m / (sqrt(v) + eps).
    Returns (update, mu, nu)."""
    mu = (1.0 - ADAM_B1) * g + ADAM_B1 * mu
    nu = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * nu
    mu_hat = mu / (1.0 - ADAM_B1 ** count)
    nu_hat = nu / (1.0 - ADAM_B2 ** count)
    return -lr * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)), mu, nu


def optimization_step(case: VPCase, theta, mu, nu, count: int, lr: float,
                      smooth_blend: float, with_region: bool = True):
    """The loss and its gradient through the solve, Adam on theta = log k,
    then the smoothing blend.  Returns (theta, mu, nu, loss)."""
    th = theta.detach().requires_grad_(True)
    with torch.enable_grad():
        j = loss(case, th, with_region)
        (g,) = torch.autograd.grad(j, th)
    upd, mu, nu = adam_update(g, mu, nu, count, lr)
    theta = theta + upd
    if smooth_blend > 0.0:
        theta = torch.log(_shepard_smooth(case, torch.exp(theta),
                                          smooth_blend))
    return theta, mu, nu, j.detach()


def optimize_conductivity(case: VPCase, n_steps: int = 150, lr: float = 0.1,
                          smooth_blend: float = 0.05, seed: int = 0,
                          k_init=None):
    """Adam on log k from a random start (uniform in [0.5, 1.5] from a
    seeded torch.Generator, not JAX's bits: pass `k_init` to start from a
    given field).  Returns (k, T, the loss of each step as numpy)."""
    pos = case.body["Position"]
    if k_init is None:
        gen = torch.Generator(device="cpu").manual_seed(seed)
        k_init = DIFF_COEFF * (0.5 + torch.rand(pos.shape[0], generator=gen,
                                                dtype=pos.dtype))
    theta = torch.log(project_conductivity(
        torch.as_tensor(k_init, dtype=pos.dtype).to(pos.device)))
    mu, nu = torch.zeros_like(theta), torch.zeros_like(theta)
    # the strip is where the body's top rows are (both configs have it)
    with_region = bool(case.flux_region.any())
    history = []
    for step in range(1, n_steps + 1):
        theta, mu, nu, j = optimization_step(case, theta, mu, nu, step, lr,
                                             smooth_blend, with_region)
        history.append(j)
    hist = torch.stack(history).double().cpu().numpy() if history \
        else np.zeros(0)
    k = project_conductivity(torch.exp(theta))
    return k, steady_temperature(case, k), hist
