"""2D fish undulation — the active-strain muscle of the fish case, in
vacuum (counterpart of sphinxsys_tpu/cases/fish_undulation_2d.py;
reference tests/2d_examples/test_2d_flow_stream_around_fish/):

  * the fish body (a 5th-order-polynomial outline, DOI
    10.1016/j.jtbi.2016.08.025) is a composite total-Lagrangian solid of
    three materials: active muscle flanks (E = 0.8e6), a passive body
    (E = 0.5e6), a stiff head and spine (E = 1.1e6);
  * the muscle carries the travelling-wave active strain
        E_a00 = -Am hx(x) (1 - e^{-t/0.2}) sin^2(w t/2 + k x/2 + phase)
    with the top and bottom flanks in antiphase (ImposingActiveStrain,
    2d_flow_stream_around_fish.h:167-213), and the stress is
    physics/solid.py's `active_model_pk1` through the `pk1_fn` hook.

Without fluid the linear momentum stays zero and the tail beats at the
4 Hz drive.  As in the JAX package, `build_case` returns (case, sim):

    case, sim = build_case(dx=0.01, device="cpu")         # 36 particles
    sim = make_run_chunk(case)(sim, 0.01)

A step is impose -> 1st half -> 2nd half -> the next dt, whose value
advances the time before the next step uses it (JAX's order).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sphinxsys_tpu_torch.core import geometry as G
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.generators import generate_lattice
from sphinxsys_tpu_torch.core.materials import SaintVenantKirchhoffSolid
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.neighbors.cell_list import (build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import build_neighbor_list
from sphinxsys_tpu_torch.physics import solid as sd
from sphinxsys_tpu_torch.solver import chunk_runner

# 2d_flow_stream_around_fish.h:27-48
FISH_LENGTH = 0.2
FISH_THICKNESS = 0.03
MUSCLE_THICKNESS = 0.02
HEAD_LENGTH = 0.03
BONE_THICKNESS = 0.003
RHO0_S = 1050.0
E_MUSCLE, E_BODY, E_HEAD = 0.8e6, 0.5e6, 1.1e6
POISSON = 0.49

AM = 0.12            # active strain amplitude
FREQUENCY = 4.0      # Hz
WAVELENGTH = 3.0 * FISH_LENGTH
START_TIME = 0.2     # ramp time constant


def outline(x, h, L=FISH_LENGTH):
    """Fish half-width y(x) (2d_fish_and_bones.h:9-23)."""
    a = [1.22 * h / L, 3.19 * h / L**2, -15.73 * h / L**3,
         21.87 * h / L**4, -10.55 * h / L**5]
    return sum(a[n] * x ** (n + 1) for n in range(5))


def fish_polygon(resolution: float, n_points: int = 100) -> G.Polygon:
    """The closed outline, head at x = 0, tail at x = FISH_LENGTH
    (CreatFishShape: the upper camber, then its mirror)."""
    L = FISH_LENGTH
    pts = []
    for t in np.linspace(L, 0.0, n_points + 1):
        y = outline(t, FISH_THICKNESS)
        if y >= resolution:
            pts.append((L - t, y))
    upper = np.asarray(pts)
    lower = upper[::-1].copy()
    lower[:, 1] *= -1.0
    verts = np.concatenate([upper, lower], axis=0)
    return G.Polygon(vertices=tuple(map(tuple, verts)))


def material_regions(pos: np.ndarray, origin=(0.0, 0.0)) -> np.ndarray:
    """MaterialID per particle (FishMaterialInitialization,
    2d_flow_stream_around_fish.h:134-162): 0 the muscle flanks, 1 the
    passive body, 2 the head and spine; `origin` is the nose."""
    x, y = pos[:, 0] - origin[0], pos[:, 1] - origin[1]
    y_muscle = outline(x, MUSCLE_THICKNESS)
    in_tail = x <= (FISH_LENGTH - HEAD_LENGTH)
    upper = in_tail & (y > y_muscle - 0.004) & (y > BONE_THICKNESS / 2)
    lower = in_tail & (y < -y_muscle + 0.004) & (y < -BONE_THICKNESS / 2)
    head_or_bone = (~in_tail) | (np.abs(y) < BONE_THICKNESS / 2)
    mat = np.ones(len(pos), np.int32)
    mat[head_or_bone] = 2
    mat[upper | lower] = 0
    return mat


def composite_fields(pos: np.ndarray, origin, dtype, device) -> dict:
    """MaterialID, Lambda0 and ShearModulus per particle, and a zero
    ActiveStrain: the composite fish's own fields."""
    mat = material_regions(pos, origin)
    youngs = np.choose(mat, [E_MUSCLE, E_BODY, E_HEAD])
    lam = youngs * POISSON / ((1 + POISSON) * (1 - 2 * POISSON))
    g0 = youngs / (2 * (1 + POISSON))
    n = len(pos)
    return {"MaterialID": torch.as_tensor(mat, device=device),
            "Lambda0": torch.as_tensor(lam, dtype=dtype, device=device),
            "ShearModulus": torch.as_tensor(g0, dtype=dtype, device=device),
            "ActiveStrain": torch.zeros((n, 2, 2), dtype=dtype,
                                        device=device)}


def stiffest_material() -> SaintVenantKirchhoffSolid:
    """The head's material: it sets the sound speed and the time step."""
    return SaintVenantKirchhoffSolid(rho0=RHO0_S, youngs_modulus=E_HEAD,
                                     poisson_ratio=POISSON)


def frozen_pairs(fish: dict, grid, adaptation, k_inner: int,
                 cell_cap: int = 24) -> sd.ReferencePairs:
    """The fish's frozen topology on its initial positions; an overflow
    raises (the frozen pairs must be exact)."""
    p0, n = fish["Position"], fish["NReal"]
    table = build_cell_table(p0, n, grid, cell_cap)
    nl = build_neighbor_list(p0, n, p0, n, table, grid, adaptation.cutoff,
                             k_max=k_inner, include_self=False)
    if bool(nl.overflow):
        raise ValueError(f"k_inner={k_inner} / cell_cap={cell_cap} overflow: "
                         "the frozen pairs must be exact")
    return sd.freeze_reference_pairs(p0, nl, adaptation.kernel, 2)


@dataclasses.dataclass
class FishSim:
    fish: dict
    time: torch.Tensor
    n_steps: int
    dt: torch.Tensor


@dataclasses.dataclass(frozen=True)
class FishCase:
    dx: float
    adaptation: SPHAdaptation
    material: SaintVenantKirchhoffSolid   # the stiffest: sets the time step
    rp: sd.ReferencePairs
    n_fish: int
    tail_idx: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = 0.0025, dtype=PRODUCTION_DTYPE, k_inner: int = 48,
               device="cuda"):
    """The fish alone, its frozen pairs and B matrix.  Returns (case, sim)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    lo, hi = (-0.02, -0.05), (FISH_LENGTH + 0.02, 0.05)
    pos, vol = generate_lattice(fish_polygon(dx * 0.5), lo, hi, dx)

    stiff = stiffest_material()
    fish = sd.make_elastic_solid_state(pos, vol, stiff, dtype, device)
    fish.update(composite_fields(pos, (0.0, 0.0), dtype, device))
    rp = frozen_pairs(fish, grid_from_bounds(lo, hi, adaptation.cutoff),
                      adaptation, k_inner)
    fish["LinearGradientCorrectionMatrix"] = \
        sd.linear_gradient_correction_matrix(rp, fish["VolumetricMeasure"])

    case = FishCase(dx=dx, adaptation=adaptation, material=stiff, rp=rp,
                    n_fish=len(pos), tail_idx=int(np.argmax(pos[:, 0])))
    zero = torch.zeros((), dtype=dtype, device=device)
    return case, FishSim(fish=fish, time=zero, n_steps=0, dt=zero)


def impose_active_strain(fish: dict, t, origin=(0.0, 0.0)) -> dict:
    """The travelling-wave muscle activation at time t (ImposingActiveStrain),
    on the muscle flanks (MaterialID 0) of the initial configuration."""
    pos0 = fish["InitialPosition"]
    x = pos0[:, 0] - origin[0]
    y = pos0[:, 1] - origin[1]
    hx = -(x ** 2 - FISH_LENGTH ** 2) / FISH_LENGTH ** 2
    w = 2.0 * math.pi * FREQUENCY
    k = 2.0 * math.pi / WAVELENGTH
    strength = 1.0 - torch.exp(-t / START_TIME)
    phase = torch.where(y > BONE_THICKNESS / 2, torch.zeros_like(y),
                        torch.full_like(y, math.pi / 2))
    ea00 = -AM * hx * strength * torch.sin(w * t / 2 + k * x / 2 + phase) ** 2
    ea00 = torch.where(fish["MaterialID"] == 0, ea00, torch.zeros_like(ea00))
    ea = fish["ActiveStrain"].clone()
    ea[:, 0, 0] = ea00
    return dict(fish, ActiveStrain=ea)


def _pk1(fish: dict, F):
    return sd.active_model_pk1(F, fish["ActiveStrain"], fish["Lambda0"],
                               fish["ShearModulus"])


def _step(case: FishCase, s: FishSim) -> FishSim:
    h = case.adaptation.h
    fish = impose_active_strain(s.fish, s.time)
    fish = sd.integration_1st_half_pk2(fish, case.rp, case.material, s.dt, h,
                                       case.kernel.w0(2), pk1_fn=_pk1)
    fish = sd.integration_2nd_half(fish, case.rp, s.dt)
    dt_next = sd.solid_acoustic_time_step(fish, case.material.sound_speed, h,
                                          cfl=0.45)
    return FishSim(fish=fish, time=s.time + dt_next, n_steps=s.n_steps + 1,
                   dt=dt_next)


def make_run_chunk(case: FishCase):
    """run_chunk(sim, t_target): steps until sim.time >= t_target."""
    return chunk_runner(lambda s: _step(case, s))


def tail_lateral_displacement(case: FishCase, s: FishSim) -> float:
    i = case.tail_idx
    return float(s.fish["Position"][i, 1] - s.fish["InitialPosition"][i, 1])


def center_of_mass(s: FishSim) -> np.ndarray:
    m = s.fish["Mass"].cpu().numpy()
    p = s.fish["Position"].cpu().numpy()
    return (m[:, None] * p).sum(0) / m.sum()
