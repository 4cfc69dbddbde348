"""Multi-resolution oscillating cantilever beam, an adaptive-h solid
(counterpart of sphinxsys_tpu/cases/mr_cantilever_beam_2d.py; reference
tests/2d_examples/test_2d_mr_cantilever_beam/
test_2d_mr_cantilever_beam.cpp): the beam of cases/oscillating_beam_2d.py
(0.2 x 0.02, Saint Venant-Kirchhoff, released in its first mode) with the
tip half refined (AdaptiveWithinShape over x >= PL / 2, cpp:172-195): the
spacing dx/2 and the smoothing length h/2 there, dx elsewhere.

The total-Lagrangian pairs are frozen once from the multi-level search
(neighbors/multilevel.py), each at the pair smoothing length
max(h_i, h_j) (solid.freeze_adaptive_reference_pairs); the solid
integrators run unchanged, with the time step and the damping at the
finest h.  The oracle: the MR beam keeps the uniform beam's period.

    case, sim = build_case(dx=0.005, device="cpu")
    sim = make_run_chunk(case)(sim, 0.01)
    print(sim.n_steps, tip_displacement(case, sim))
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sphinxsys_tpu_torch.cases.oscillating_beam_2d import (
    PH, PL, POISSON, RHO0_S, SL, YOUNGS, BeamSim, first_mode_velocity,
    tip_displacement)
from sphinxsys_tpu_torch.core import geometry as G
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.generators import generate_lattice
from sphinxsys_tpu_torch.core.materials import SaintVenantKirchhoffSolid
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.neighbors.multilevel import (
    build_adaptive_neighbor_list, build_multilevel_tables)
from sphinxsys_tpu_torch.physics import solid as sd
from sphinxsys_tpu_torch.solver import chunk_runner

REFINE_X0 = 0.5 * PL       # the refinement region: x >= PL/2 (the tip half)

__all__ = ["MRBeamCase", "BeamSim", "build_case", "make_step",
           "make_run_chunk", "tip_displacement"]


@dataclasses.dataclass(frozen=True)
class MRBeamCase:
    dx: float
    adaptation: SPHAdaptation
    material: SaintVenantKirchhoffSolid
    rp: sd.ReferencePairs
    base_mask: torch.Tensor
    n_solid: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float | None = None, dtype=PRODUCTION_DTYPE,
               k_levels=(160, 224), device="cuda"):
    """The coarse lattice left of REFINE_X0 and the dx/2 lattice right of
    it (hr 1 and 2), the adaptive frozen pairs and B, the clamp, the first
    mode's velocity.  Returns (case, sim)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    dx = dx or PH / 8.0
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    bw = dx * 4

    base_shape = G.Box(G.Transform(translation=(-(SL + bw) / 2, 0.0)),
                       halfsize=((SL + bw) / 2, PH / 2 + bw))
    beam_shape = G.Box(G.Transform(translation=((PL - SL) / 2, 0.0)),
                       halfsize=((PL + SL) / 2, PH / 2))
    body_shape = G.make_complex(("add", base_shape), ("add", beam_shape))
    dom_lo = (-SL - bw, -PL / 2)
    dom_hi = (PL + 3 * bw, PL / 2)
    pos_c, vol_c = generate_lattice(body_shape, dom_lo, dom_hi, dx)
    pos_f, vol_f = generate_lattice(body_shape, dom_lo, dom_hi, dx / 2)
    keep_c = pos_c[:, 0] < REFINE_X0
    keep_f = pos_f[:, 0] >= REFINE_X0
    pos = np.concatenate([pos_c[keep_c], pos_f[keep_f]])
    vols = np.concatenate([np.full(keep_c.sum(), vol_c),
                           np.full(keep_f.sum(), vol_f)])
    h_ratio = np.concatenate([np.ones(keep_c.sum()),
                              np.full(keep_f.sum(), 2.0)])

    material = SaintVenantKirchhoffSolid(rho0=RHO0_S, youngs_modulus=YOUNGS,
                                         poisson_ratio=POISSON)
    solid = sd.make_elastic_solid_state(pos, vols, material, dtype, device)
    hr = torch.as_tensor(h_ratio, dtype=dtype, device=device)
    solid["SmoothingLengthRatio"] = hr

    # the adaptive frozen topology: one multi-level search
    n = len(pos)
    p0 = solid["Position"]
    ml = build_multilevel_tables(p0, n, hr, dom_lo, dom_hi, adaptation.h,
                                 kernel_size=2.0, n_levels=2, cap=64)
    nl = build_adaptive_neighbor_list(p0, n, hr, p0, hr, ml, 2.0,
                                      adaptation.h,
                                      k_max_per_level=list(k_levels))
    if bool(nl.overflow):
        raise ValueError("raise k_levels: the frozen pairs must be exact")
    rp = sd.freeze_adaptive_reference_pairs(p0, hr, nl, adaptation.kernel, 2)
    solid["LinearGradientCorrectionMatrix"] = \
        sd.linear_gradient_correction_matrix(rp, solid["VolumetricMeasure"])

    # the clamp frame: the base minus the beam, tested on the host
    p64 = torch.as_tensor(pos, dtype=torch.float64)
    base_mask = (base_shape.contains(p64)
                 & ~beam_shape.contains(p64)).to(device)
    solid["Velocity"] = torch.as_tensor(
        first_mode_velocity(pos, material.sound_speed), dtype=dtype,
        device=device)

    case = MRBeamCase(dx=dx, adaptation=adaptation, material=material, rp=rp,
                      base_mask=base_mask, n_solid=n)
    zero = torch.zeros((), dtype=dtype, device=device)
    return case, BeamSim(solid=solid, time=zero, n_steps=0, dt=zero.clone())


def _step(case: MRBeamCase, s: BeamSim) -> BeamSim:
    h_fine = case.adaptation.h / 2.0    # dt and damping at the finest level
    solid = sd.integration_1st_half_pk2(s.solid, case.rp, case.material,
                                        s.dt, h_fine, 1.0)
    solid = sd.fix_constraint(solid, case.base_mask)
    solid = sd.integration_2nd_half(solid, case.rp, s.dt)
    dt_next = sd.solid_acoustic_time_step(solid, case.material.sound_speed,
                                          h_fine)
    return BeamSim(solid=solid, time=s.time + dt_next, n_steps=s.n_steps + 1,
                   dt=dt_next)


def make_step(case: MRBeamCase):
    return lambda s: _step(case, s)


def make_run_chunk(case: MRBeamCase):
    """run_chunk(sim, t_target): steps until sim.time >= t_target."""
    return chunk_runner(make_step(case))
