"""Electro-contraction of a left ventricle driven by a Purkinje tree (3D)
(counterpart of sphinxsys_tpu/cases/pkj_lv_electrocontraction_3d.py;
reference tests/3d_examples/test_3d_pkj_lv_electrocontraction/
pkj_lv_electrocontraction.cpp).  A Purkinje tree grown over the
ventricle's inner surface (core/network.py) conducts the excitation fast
(the network's RK2 electrophysiology on the tree's list, cpp:173); its
leaves stimulate the myocardium; the monodomain Aliev-Panfilow
reaction-diffusion carries the wave through the muscle, and its active
stress Ta f f drives the total-Lagrangian mechanics (cpp:186-200).

As in the JAX package: the ventricle is an ellipsoidal shell (outer (1,
1, 1.5), inner (0.7, 0.7, 1.25), the base cut at z = 0.55) instead of the
STL heart, one body carries the physiology and the mechanics, and the
fibers are circumferential, f = normalize(-y, x, 0).

A step: n_pkj_sub tree sub-steps (the root held at 0.92 until STIM_T),
the leaves' voltage onto the muscle within 2 dx, the muscle's
electrophysiology, n_mech_sub mechanics sub-steps; the counts are fixed
at the build, so a step reads nothing back.

    case, sim = build_case(dx=0.24, device="cpu")
    sim = make_run_chunk(case)(sim, 0.1)
    print(sim.n_steps, apex_voltage(case, sim), midwall_ring_radius(case, sim))
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sphinxsys_tpu_torch.core import geometry as G
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.generators import generate_lattice
from sphinxsys_tpu_torch.core.materials import SaintVenantKirchhoffSolid
from sphinxsys_tpu_torch.core.network import generate_network
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.neighbors.cell_list import (build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list)
from sphinxsys_tpu_torch.physics import bar as bd
from sphinxsys_tpu_torch.physics import diffusion as df
from sphinxsys_tpu_torch.physics import solid as sd
from sphinxsys_tpu_torch.solver import chunk_runner

OUTER = (1.0, 1.0, 1.5)
INNER = (0.7, 0.7, 1.25)
Z_CUT = 0.55                 # the base opening
LO = (-1.1, -1.1, -1.6)
HI = (1.1, 1.1, 0.7)
RHO0 = 1.0
YOUNGS = 50.0
POISSON = 0.45
D_MYO = 0.05
D_PKJ = 0.5     # the cable balance: a front sqrt(D / k) ~ 2 segments wide
                # propagates on the small tree
STIM_T = 0.5    # the root held until the tree ignites
K_A = 0.3                    # excitation-contraction gain
SEG = 0.12                   # Purkinje segment length
N_STIM = 3                   # the stimulated root particles


@dataclasses.dataclass
class Sim:
    myo: dict                # the myocardium: voltage and mechanics
    pkj_v: torch.Tensor      # the tree's voltages
    pkj_w: torch.Tensor
    time: torch.Tensor
    n_steps: int
    dt_s: torch.Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class PkjLVCase:
    dx: float
    adaptation: SPHAdaptation
    material: SaintVenantKirchhoffSolid
    rp: sd.ReferencePairs
    nl_myo: NeighborList
    nl_pkj: NeighborList
    pkj_pos: torch.Tensor
    line_kernel: bd.LineKernel
    base_mask: torch.Tensor
    leaf_nearest: torch.Tensor   # (n_myo,) the nearest leaf, a tree index
    leaf_mask: torch.Tensor      # (n_myo,) within 2 dx of a leaf
    model_myo: df.AlievPanfilowModel
    model_pkj: df.AlievPanfilowModel
    n_myo: int
    n_pkj: int
    dt_d: float
    n_pkj_sub: int
    n_mech_sub: int


def lv_shell():
    """The ventricle: the outer ellipsoid less the inner, cut above
    Z_CUT (a HalfSpace's inside is where its sd < 0, the side away from
    its outward normal)."""
    return G.make_complex(
        ("add", G.Ellipsoid(center=(0.0, 0.0, 0.0), semi_axes=OUTER)),
        ("sub", G.Ellipsoid(center=(0.0, 0.0, 0.0), semi_axes=INNER)),
        ("sub", G.HalfSpace(point=(0.0, 0.0, Z_CUT),
                            outward_normal=(0.0, 0.0, -1.0))))


def lv_body(dx: float, material, dtype, device, k_inner: int):
    """The shell's lattice as an elastic solid, its frozen inner list,
    reference pairs and correction matrix.  Returns (pos (host float64),
    volume, adaptation, body, list, pairs)."""
    pos, vol = generate_lattice(lv_shell(), LO, HI, dx)
    n = len(pos)
    body = sd.make_elastic_solid_state(pos, vol, material, dtype, device)
    adaptation = SPHAdaptation(spacing=dx, dim=3)
    grid = grid_from_bounds(LO, HI, adaptation.cutoff)
    table = build_cell_table(body["Position"], n, grid, 40)
    nl = build_neighbor_list(body["Position"], n, body["Position"], n, table,
                             grid, adaptation.cutoff, k_max=k_inner,
                             include_self=False)
    if bool(nl.overflow):
        raise RuntimeError("the ventricle's neighbour list overflows")
    rp = sd.freeze_reference_pairs(body["Position"], nl, adaptation.kernel, 3)
    body["LinearGradientCorrectionMatrix"] = \
        sd.linear_gradient_correction_matrix(rp, body["VolumetricMeasure"])
    for name in ("Voltage", "GateVariable", "ActiveContractionStress"):
        body[name] = torch.zeros(n, dtype=dtype, device=device)
    return pos, vol, adaptation, body, nl, rp


def build_case(dx: float = 0.12, dtype=PRODUCTION_DTYPE, k_inner: int = 72,
               seed: int = 3, device="cuda"):
    """The ventricle at rest, its tree and the tree's root stimulus.
    Returns (case, sim)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    material = SaintVenantKirchhoffSolid(rho0=RHO0, youngs_modulus=YOUNGS,
                                         poisson_ratio=POISSON)
    p, vol, adaptation, myo, nl, rp = lv_body(dx, material, dtype, device,
                                              k_inner)
    n = len(p)

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    fib = np.stack([-p[:, 1], p[:, 0], np.zeros(n)], -1)
    fib /= np.linalg.norm(fib, axis=1, keepdims=True) + 1e-12
    myo["Fiber"] = t(fib)
    base_mask = t(p[:, 2] > Z_CUT - 1.2 * dx, torch.bool)

    # the Purkinje tree on the inner surface
    net = generate_network(G.Ellipsoid(center=(0.0, 0.0, 0.0),
                                       semi_axes=INNER),
                           starting_point=(0.0, -0.699, 0.35),
                           second_point=(0.0, -0.69, 0.25), iterations=5,
                           segment_length=SEG, segments_per_branch=4,
                           angle=0.4, repulsivity=0.3, seed=seed)
    n_pkj = net.n_particles
    adj = net.adjacency(k_max=4)
    nl_pkj = NeighborList(idx=t(adj, torch.int64),
                          count=t((adj < n_pkj).sum(1), torch.int32),
                          overflow=torch.zeros((), dtype=torch.bool,
                                               device=device))
    # the leaves: each terminal branch's last particle
    leaf_ids = [b.particles[-1] for b in net.branches
                if not b.children and b.particles]
    leaves = net.positions[leaf_ids]
    d2 = np.linalg.norm(p[:, None, :] - leaves[None], axis=-1)
    nearest = np.argmin(d2, axis=1)
    leaf_mask = d2[np.arange(n), nearest] < 2.0 * dx

    h = adaptation.h
    dt_d = 0.5 * h * h / D_MYO / 3.0
    # the line operator's eigenvalue exceeds the nominal D by the
    # kernel's discretisation factor: an 8x margin
    dt_pkj = 0.5 * SEG * SEG / D_PKJ / 8.0
    n_pkj_sub = max(1, int(np.ceil(dt_d / dt_pkj)))
    dt_s = 0.5 * h / material.sound_speed
    n_mech_sub = max(1, int(np.ceil(dt_d / dt_s)))

    case = PkjLVCase(
        dx=dx, adaptation=adaptation, material=material, rp=rp, nl_myo=nl,
        nl_pkj=nl_pkj, pkj_pos=t(net.positions),
        line_kernel=bd.LineKernel(SPHAdaptation(spacing=SEG, dim=3).kernel),
        base_mask=base_mask,
        leaf_nearest=t(np.asarray(leaf_ids)[nearest], torch.int64),
        leaf_mask=t(leaf_mask, torch.bool),
        model_myo=df.AlievPanfilowModel(k_a=K_A),
        model_pkj=df.AlievPanfilowModel(), n_myo=n, n_pkj=n_pkj,
        dt_d=float(dt_d), n_pkj_sub=n_pkj_sub, n_mech_sub=n_mech_sub)

    pkj_v = torch.zeros(n_pkj, dtype=dtype, device=device)
    pkj_v[:N_STIM] = 0.92
    sim = Sim(myo=myo, pkj_v=pkj_v,
              pkj_w=torch.zeros(n_pkj, dtype=dtype, device=device),
              time=torch.zeros((), dtype=dtype, device=device), n_steps=0,
              dt_s=torch.as_tensor(dt_s, dtype=dtype, device=device))
    return case, sim



def _pkj_state(case: PkjLVCase, v, w) -> dict:
    return {"Position": case.pkj_pos, "Voltage": v, "GateVariable": w,
            "VolumetricMeasure": torch.full((case.n_pkj,), SEG,
                                            dtype=v.dtype, device=v.device),
            "NReal": case.n_pkj}


def tree_substeps(case: PkjLVCase, s: Sim, dt) -> dict:
    """The tree's n_pkj_sub electrophysiology sub-steps (NetworkRK2; the
    LineKernel reduces the 3D kernel twice, called with dim 3), the root
    held at 0.92 while t < STIM_T."""
    pk = _pkj_state(case, s.pkj_v, s.pkj_w)
    root = torch.arange(case.n_pkj, device=s.pkj_v.device) < N_STIM
    hold = root & (s.time < STIM_T)
    diffusion = df.IsotropicDiffusion(D_PKJ)
    for _ in range(case.n_pkj_sub):
        pk = df.electrophysiology_step(pk, case.nl_pkj, case.line_kernel, 3,
                                       diffusion, case.model_pkj,
                                       dt / case.n_pkj_sub)
        v = pk["Voltage"]
        pk = dict(pk, Voltage=torch.where(hold, torch.clamp(v, min=0.92), v))
    return pk


def mechanics_substep(case: PkjLVCase, m: dict, dt_s) -> dict:
    """One total-Lagrangian sub-step with the active fiber stress, the
    base fixed."""
    m = sd.integration_1st_half_pk2(m, case.rp, case.material, dt_s,
                                    case.adaptation.h,
                                    case.adaptation.kernel.w0(3),
                                    active_stress_fn=sd.active_fiber_stress)
    m = sd.fix_constraint(m, case.base_mask)
    return sd.integration_2nd_half(m, case.rp, dt_s)


def step_dt(case, s):
    """The diffusion step in the time's dtype, as a 0-d tensor (a fill,
    no copy from the host)."""
    return torch.full((), case.dt_d, dtype=s.time.dtype,
                      device=s.time.device)


def _step(case: PkjLVCase, s: Sim) -> Sim:
    dt = step_dt(case, s)
    pk = tree_substeps(case, s, dt)
    # the leaves stimulate the myocardium
    myo = dict(s.myo)
    leaf_v = pk["Voltage"][case.leaf_nearest]
    myo["Voltage"] = torch.where(case.leaf_mask & (leaf_v > myo["Voltage"]),
                                 leaf_v, myo["Voltage"])
    myo = df.electrophysiology_step(
        myo, case.nl_myo, case.adaptation.kernel, 3,
        df.IsotropicDiffusion(D_MYO), case.model_myo, dt)
    for _ in range(case.n_mech_sub):
        myo = mechanics_substep(case, myo, dt / case.n_mech_sub)
    return Sim(myo=myo, pkj_v=pk["Voltage"], pkj_w=pk["GateVariable"],
               time=s.time + dt, n_steps=s.n_steps + 1, dt_s=s.dt_s)


def make_advection_step(case: PkjLVCase):
    return lambda s: _step(case, s)


def make_run_chunk(case: PkjLVCase):
    """run_chunk(sim, t_target): steps until sim.time >= t_target."""
    return chunk_runner(make_advection_step(case))


def apex_voltage(case: PkjLVCase, s: Sim) -> float:
    apex = int(torch.argmin(s.myo["InitialPosition"][:, 2]))
    return float(s.myo["Voltage"][apex])


def midwall_ring_radius(case: PkjLVCase, s: Sim) -> float:
    """The mean radial distance of the mid-height wall ring (the
    contraction's observable)."""
    p0 = s.myo["InitialPosition"].double().cpu().numpy()
    ring = np.abs(p0[:, 2] + 0.2) < 0.15
    p = s.myo["Position"].double().cpu().numpy()[ring]
    return float(np.linalg.norm(p[:, :2], axis=1).mean())
