"""2D diffusion in a unit square with Dirichlet and Neumann or Robin
boundaries (counterpart of sphinxsys_tpu/cases/diffusion_bcs_2d.py;
reference tests/2d_examples/test_2d_diffusion_NeumannBC/ and
test_2d_diffusion_RobinBC/, diffusion_NeumannBC.h:15-57):
  * a 1 x 1 domain, dx = H / 100, d = 1, Phi0 = 100;
  * Dirichlet patches above the top edge: 300 at x in [0.3, 0.4], 350 at
    x in [0.6, 0.7] (bands 2 dx thick);
  * mode "neumann": a bottom patch x in [0.45, 0.55] with the flux 900;
    mode "robin": the same patch with convection 100 against 400;
  * the RK2 relaxation; five observers on the x = 0.5 midline.

    case = build_case(dx=0.05, device="cpu")
    sim = make_run_chunk(case)(init_sim(case), 0.01)
    print(observe_phi(case, sim))

Each step is one RK2 diffusion step on frozen lists; the loop reads the
time once a step.
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
                                                        build_neighbor_list)
from sphinxsys_tpu_torch.physics import diffusion as dfn
from sphinxsys_tpu_torch.physics import general as gd
from sphinxsys_tpu_torch.solver import chunk_runner

L = 1.0
H = 1.0
DIFFUSION_COEFF = 1.0
INITIAL_T = 100.0
LEFT_T = 300.0
RIGHT_T = 350.0
HEAT_FLUX = 900.0
CONVECTION = 100.0
T_INFINITY = 400.0


@dataclasses.dataclass
class SimState:
    body: dict
    time: torch.Tensor
    n_steps: int


@dataclasses.dataclass(frozen=True)
class DiffusionBCCase:
    mode: str                  # "neumann" or "robin"
    dx: float
    adaptation: SPHAdaptation
    dt: float
    body0: Any
    wall_d: Any                # the Dirichlet patches
    wall_n: Any                # the Neumann / Robin patch
    nl_inner: NeighborList
    nl_d: NeighborList
    nl_n: NeighborList
    obs_idx: torch.Tensor      # (observers, K) source rows
    obs_w: torch.Tensor        # (observers, K) frozen weights

    @property
    def kernel(self):
        return self.adaptation.kernel


def observer_weights(pos, obs_points, kernel, vol, cutoff, dim=2):
    """Frozen kernel-interpolation weights W(r) V_j / sum, over each
    observer's support (ObservedQuantityRecording), on the host in
    float64.  Returns (rows (observers, K) int, weights (observers, K)),
    zero-padded."""
    pos = np.asarray(pos)
    idx_list, w_list = [], []
    for pt in obs_points:
        r = np.linalg.norm(pos - np.asarray(pt), axis=1)
        idx = np.nonzero(r < cutoff)[0]
        w = kernel.W(torch.as_tensor(r[idx], dtype=torch.float64),
                     dim).numpy() * np.asarray(vol)[idx]
        idx_list.append(idx)
        w_list.append(w / (w.sum() + 1e-15))
    k = max(len(i) for i in idx_list)
    idx_a = np.zeros((len(obs_points), k), np.int64)
    w_a = np.zeros((len(obs_points), k))
    for i, (ix, w) in enumerate(zip(idx_list, w_list)):
        idx_a[i, :len(ix)] = ix
        w_a[i, :len(ix)] = w
    return idx_a, w_a


def build_case(mode: str = "neumann", dx: float = H / 100.0,
               dtype=torch.float64, cell_cap: int = 16, k_inner: int = 48,
               k_contact: int = 32, device="cuda") -> DiffusionBCCase:
    """The body at Phi0 with its shape normals, the Dirichlet patches, the
    flux or convection patch, the frozen lists (their overflow checked
    once, on the host) and the observers."""
    if mode not in ("neumann", "robin"):
        raise ValueError(f"mode {mode!r}: neumann or robin")
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    bw = 2.0 * dx
    domain = G.Box(G.Transform(translation=(L / 2, H / 2)),
                   halfsize=(L / 2, H / 2))
    left = G.Box(G.Transform(translation=(0.35 * L, H + bw / 2)),
                 halfsize=(0.05 * L, bw / 2))
    right = G.Box(G.Transform(translation=(0.65 * L, H + bw / 2)),
                  halfsize=(0.05 * L, bw / 2))
    dirichlet_shape = G.make_complex(("add", left), ("add", right))
    flux_patch = G.Box(G.Transform(translation=(0.5 * L, -bw / 2)),
                       halfsize=(0.05 * L, bw / 2))
    lo, hi = (-bw, -bw), (L + bw, H + bw)
    pos_b, vol = generate_lattice(domain, lo, hi, dx)
    pos_d, _ = generate_lattice(dirichlet_shape, lo, hi, dx)
    pos_n, _ = generate_lattice(flux_patch, lo, hi, dx)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def mkstate(pos):
        return {"Position": t(pos), "VolumetricMeasure": t(np.full(len(pos),
                                                                   vol)),
                "NReal": len(pos)}

    body = mkstate(pos_b)
    body["Phi"] = t(np.full(len(pos_b), INITIAL_T))
    body = gd.normal_direction_from_shape(body, domain)
    wall_d = mkstate(pos_d)
    wall_d["Phi"] = t(np.where(pos_d[:, 0] < 0.5 * L, LEFT_T, RIGHT_T))
    wall_n = mkstate(pos_n)
    wall_n["Phi"] = t(np.zeros(len(pos_n)))
    if mode == "neumann":
        wall_n["PhiFlux"] = t(np.full(len(pos_n), HEAT_FLUX))
    else:
        wall_n["PhiConvection"] = t(np.full(len(pos_n), CONVECTION))
    wall_n = gd.normal_direction_from_shape(wall_n, flux_patch)

    grid = grid_from_bounds(lo, hi, adaptation.cutoff)
    cutoff = adaptation.cutoff
    nb = body["NReal"]
    tb = build_cell_table(body["Position"], nb, grid, cell_cap)
    nl_inner = build_neighbor_list(body["Position"], nb, body["Position"], nb,
                                   tb, grid, cutoff, k_max=k_inner,
                                   include_self=False)
    lists = []
    for w in (wall_d, wall_n):
        tw = build_cell_table(w["Position"], w["NReal"], grid, cell_cap)
        lists.append(build_neighbor_list(body["Position"], nb, w["Position"],
                                         w["NReal"], tw, grid, cutoff,
                                         k_max=k_contact, include_self=True))
    nl_d, nl_n = lists
    if bool(nl_inner.overflow | nl_d.overflow | nl_n.overflow):
        raise RuntimeError("diffusion_bcs_2d: a neighbour list overflows")
    dt = dfn.diffusion_time_step(adaptation.h,
                                 dfn.IsotropicDiffusion(DIFFUSION_COEFF), 2)
    obs_points = [(0.5 * L, H * i / 4.0) for i in range(5)]
    obs_idx, obs_w = observer_weights(pos_b, obs_points, adaptation.kernel,
                                      np.full(len(pos_b), vol), cutoff)
    return DiffusionBCCase(mode=mode, dx=dx, adaptation=adaptation, dt=dt,
                           body0=body, wall_d=wall_d, wall_n=wall_n,
                           nl_inner=nl_inner, nl_d=nl_d, nl_n=nl_n,
                           obs_idx=torch.as_tensor(obs_idx, device=device),
                           obs_w=t(obs_w))


def init_sim(case: DiffusionBCCase) -> SimState:
    pos = case.body0["Position"]
    return SimState(body=dict(case.body0),
                    time=torch.zeros((), dtype=pos.dtype, device=pos.device),
                    n_steps=0)


def diffusion_step(case: DiffusionBCCase, body: dict) -> dict:
    """One RK2 step against the Dirichlet patches and the mode's patch."""
    neumann = [(case.wall_n, case.nl_n)] if case.mode == "neumann" else ()
    robin = ([(case.wall_n, case.nl_n, T_INFINITY)]
             if case.mode == "robin" else ())
    return dfn.diffusion_step_rk2(
        body, "Phi", case.nl_inner, case.kernel, 2,
        dfn.IsotropicDiffusion(DIFFUSION_COEFF), case.dt,
        dirichlet_contacts=[(case.wall_d, case.nl_d)],
        neumann_contacts=neumann, robin_contacts=robin)


def make_advection_step(case: DiffusionBCCase):
    return lambda s: SimState(body=diffusion_step(case, s.body),
                              time=s.time + case.dt, n_steps=s.n_steps + 1)


def make_run_chunk(case: DiffusionBCCase):
    """run_chunk(sim, t_target): steps until sim.time >= t_target."""
    return chunk_runner(make_advection_step(case))


def observe_phi(case: DiffusionBCCase, s: SimState):
    """Phi at the five midline observers."""
    return torch.sum(s.body["Phi"][case.obs_idx] * case.obs_w, dim=1)
