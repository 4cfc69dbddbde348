"""2D dynamic self contact: a whipping thin beam folds onto itself
(counterpart of sphinxsys_tpu/cases/self_contact_2d.py; reference tests/
2d_examples/test_2d_self_contact/self_contact.cpp): a very flexible
cantilever (0.2 x 0.01, E = 1e5, the first mode kicked at vf = 0.15)
curls through more than half a turn and presses on its own flank.  The
self-contact pairs are the particles now within the cutoff whose initial
separation exceeded it (NeighborBuilderSelfContact), loaded with the
offset penetration factor, the symmetric penalty and the acoustic
impedance (SelfContactFactorSummation / SelfContactForce); the
integration is the Kirchhoff-decomposed form (self_contact.cpp:102).

The contact list is rebuilt every step from the current positions (all
pairs, as the JAX package's: the initial-distance filter makes that
equal to the reference's surface-layer search).  One host read a step.

    case, beam = build_case(device="cpu")                 # 2,792 particles
    sim = make_run_chunk(case)(init_sim(case, beam), 0.002)
    print(sim.n_steps, observe_tip(sim, *tip_observer(case, beam)))
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.materials import SaintVenantKirchhoffSolid
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.neighbors.cell_list import (CellGrid,
                                                    build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list)
from sphinxsys_tpu_torch.physics import contact as ct
from sphinxsys_tpu_torch.physics import solid as sd
from sphinxsys_tpu_torch.solver import chunk_runner

PL = 0.2
PH = 0.01
SL = 0.04
DX = PH / 10.0
BW = 4 * DX
RHO0 = 1.0e3
YOUNGS = 1.0e5
POISSON = 0.45
KL = 1.875
_M = math.sin(KL) + math.sinh(KL)
_N = math.cos(KL) + math.cosh(KL)
_Q = 2.0 * (math.cos(KL) * math.sinh(KL) - math.sin(KL) * math.cosh(KL))
VF = 0.15


@dataclasses.dataclass
class SimState:
    beam: dict
    time: torch.Tensor
    n_steps: int
    overflow: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SelfContactCase:
    dx: float
    adaptation: SPHAdaptation
    grid: CellGrid
    material: SaintVenantKirchhoffSolid
    rp: sd.ReferencePairs
    base_mask: torch.Tensor
    n: int
    cell_cap: int
    k_contact: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = DX, dtype=PRODUCTION_DTYPE, cell_cap: int = 24,
               k_inner: int = 32, k_contact: int = 48, device="cuda"):
    """The beam with its clamp frame, frozen pairs and B, the first mode's
    kick (self_contact.cpp:70-79).  Folded flanks stack two layers in a
    cell: `cell_cap` and `k_contact` hold ~2x the resting occupancy.
    Returns (case, beam)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    material = SaintVenantKirchhoffSolid(rho0=RHO0, youngs_modulus=YOUNGS,
                                         poisson_ratio=POISSON)

    # the beam's lattice with the clamp frame (createBeamBaseShape + beam)
    xs = np.arange(-SL - BW + dx / 2, PL, dx)
    ys_beam = np.arange(-PH / 2 + dx / 2, PH / 2, dx)
    ys_frame = np.arange(-PH / 2 - BW + dx / 2, PH / 2 + BW, dx)
    pos = np.asarray([(x, y) for x in xs
                      for y in (ys_frame if x < 0.0 else ys_beam)
                      if x < 0.0 or abs(y) < PH / 2])
    beam = sd.make_elastic_solid_state(pos, dx * dx, material, dtype, device)
    beam["RepulsionForce"] = torch.zeros_like(beam["Velocity"])
    beam["PreviousRepulsionForce"] = torch.zeros_like(beam["Velocity"])
    x = pos[:, 0] / PL
    vy = np.where(x > 0.0,
                  VF * material.sound_speed / _Q
                  * (_M * (np.cos(KL * x) - np.cosh(KL * x))
                     - _N * (np.sin(KL * x) - np.sinh(KL * x))), 0.0)
    vel = np.zeros_like(pos)
    vel[:, 1] = vy
    beam["Velocity"] = torch.as_tensor(vel, dtype=dtype, device=device)
    # the clamp: the frame minus the beam strip
    base_mask = torch.as_tensor((pos[:, 0] < 0.0)
                                & (np.abs(pos[:, 1]) > PH / 2), device=device)

    # the beam curls within a PL-radius ball around the clamp at x = 0,
    # left past the frame too (its tip reaches x ~ -0.19 by t = 0.35)
    grid = grid_from_bounds((-1.2 * PL, -1.2 * PL), (1.2 * PL, 1.2 * PL),
                            adaptation.cutoff)
    p0, n = beam["Position"], beam["NReal"]
    table = build_cell_table(p0, n, grid, cell_cap)
    nl = build_neighbor_list(p0, n, p0, n, table, grid, adaptation.cutoff,
                             k_max=k_inner, include_self=False)
    if bool(nl.overflow):
        raise ValueError("raise k_inner: the frozen pairs must be exact")
    rp = sd.freeze_reference_pairs(p0, nl, adaptation.kernel, 2)
    beam["LinearGradientCorrectionMatrix"] = \
        sd.linear_gradient_correction_matrix(rp, beam["VolumetricMeasure"])
    case = SelfContactCase(dx=dx, adaptation=adaptation, grid=grid,
                           material=material, rp=rp, base_mask=base_mask,
                           n=len(pos), cell_cap=cell_cap, k_contact=k_contact)
    return case, beam


def init_sim(case: SelfContactCase, beam: dict) -> SimState:
    pos = beam["Position"]
    return SimState(beam=beam, time=pos.new_zeros(()), n_steps=0,
                    overflow=torch.zeros((), dtype=torch.bool,
                                         device=pos.device))


def self_contact_list(case: SelfContactCase, beam: dict):
    """The current positions' list (k_contact slots) and its
    initial-distance-filtered self-contact list: (nl, nl_self)."""
    pos, n = beam["Position"], beam["NReal"]
    cutoff = case.adaptation.cutoff
    table = build_cell_table(pos, n, case.grid, case.cell_cap)
    nl = build_neighbor_list(pos, n, pos, n, table, case.grid, cutoff,
                             k_max=case.k_contact, include_self=False)
    return nl, ct.filter_self_contact_pairs(nl, beam["InitialPosition"],
                                            cutoff)


def self_contact_force(case: SelfContactCase, beam: dict,
                       nl_self: NeighborList) -> dict:
    """The penetration factor and the self-contact force into
    ForcePrior."""
    factor = ct.repulsion_factor_self(beam, nl_self, case.kernel, 2, case.dx)
    return ct.repulsion_force_self(beam, nl_self, case.kernel, 2, factor,
                                   RHO0, ct.contact_stiffness(case.material))


def _step(case: SelfContactCase, s: SimState) -> SimState:
    """The self-contact force, then the decomposed first half, the clamp
    and the second half."""
    nl, nl_self = self_contact_list(case, s.beam)
    beam = self_contact_force(case, s.beam, nl_self)
    dt = sd.solid_acoustic_time_step(beam, case.material.sound_speed,
                                     case.adaptation.h, cfl=0.6)
    beam = sd.decomposed_integration_1st_half(beam, case.rp, case.material,
                                              dt, case.adaptation.h)
    beam = sd.fix_constraint(beam, case.base_mask)
    beam = sd.integration_2nd_half(beam, case.rp, dt)
    return SimState(beam=beam, time=s.time + dt, n_steps=s.n_steps + 1,
                    overflow=s.overflow | nl.overflow)


def make_step(case: SelfContactCase):
    return lambda s: _step(case, s)


def make_run_chunk(case: SelfContactCase):
    """run_chunk(sim, t_target): steps until sim.time >= t_target."""
    return chunk_runner(lambda s: _step(case, s))


def tip_observer(case: SelfContactCase, beam: dict):
    """The frozen-weight observer at (PL, 0) (self_contact.cpp:97): (row
    indices, normalised W V weights) on the beam's device."""
    dtype, dev = beam["Position"].dtype, beam["Position"].device
    pos0 = beam["InitialPosition"].cpu().numpy()
    r = np.linalg.norm(pos0 - np.asarray([PL, 0.0]), axis=1)
    idx = np.nonzero(r < case.adaptation.cutoff)[0]
    w = np.asarray([float(case.kernel.W(torch.as_tensor(ri, dtype=dtype), 2))
                    for ri in r[idx]])
    w = w * beam["VolumetricMeasure"].cpu().numpy()[idx]
    return (torch.as_tensor(idx, device=dev),
            torch.as_tensor(w / (w.sum() + 1e-15), dtype=dtype, device=dev))


def observe_tip(s: SimState, idx, weights) -> np.ndarray:
    return torch.sum(s.beam["Position"][idx] * weights[:, None],
                     dim=0).cpu().numpy()
