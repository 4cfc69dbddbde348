"""2D plane-strain necking of a notched steel bar under a quasi-static
stretch (counterpart of sphinxsys_tpu/cases/stretching_2d.py; reference
tests/2d_examples/test_2d_stretching/stretching.cpp): a
NonLinearHardeningPlasticSolid bar (PL x PH, a 1%-PH notch at mid-span)
is pulled apart by two BW-wide end bands, shifted by +-PULL_RATE DT_MACRO
each macro step with their x velocity pinned to zero.  Each macro step
recomputes F by summation, then relaxes acoustically
(DecomposedPlasticIntegration1stHalf, pairwise damping, the second half)
until the kinetic energy falls under KE_GATE x REFER_ENERGY or the
DT_MACRO window is used up (the reference's gated inner loop,
stretching.cpp:317-326).

    case, bar = build_case(device="cpu")
    sim = make_run_chunk(case)(init_sim(case, bar), 0.01)   # one macro step
    print(sim.n_macro, sim.n_sub)

JAX runs the inner loop as a `lax.while_loop`.  Here the host reads the
gate once a sub-step, so that a macro step of n sub-steps reads n + 1
times (the outer loop's time test once); the sub-step count and the state
are JAX's.  Blocks of masked sub-steps with one read a block were slower
on the card (PERF.md §5, the damping family).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from sphinxsys_tpu_torch.core import geometry as G
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.generators import generate_lattice
from sphinxsys_tpu_torch.core.materials import NonLinearHardeningPlasticSolid
from sphinxsys_tpu_torch.core.state import State
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.neighbors.cell_list import (build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list)
from sphinxsys_tpu_torch.physics import dissipation as dp
from sphinxsys_tpu_torch.physics import solid as sd

PL = 0.05334               # the bar's length (stretching.cpp:14)
PH = 0.012826              # its height
RHO0 = 7850.0
SHEAR_MODULUS = 80.1938e9  # stretching.cpp:26-27
BULK_MODULUS = 164.21e9
POISSON = ((3.0 * BULK_MODULUS - 2.0 * SHEAR_MODULUS)
           / (6.0 * BULK_MODULUS + 2.0 * SHEAR_MODULUS))
YOUNGS = (9.0 * SHEAR_MODULUS * BULK_MODULUS
          / (3.0 * BULK_MODULUS + SHEAR_MODULUS))
YIELD_STRESS = 0.45e9
HARDENING_MODULUS = 1.2924e8
SATURATION_FLOW = 7.15e8
SATURATION_EXP = 16.93
PHYSICAL_VISCOSITY = 1.0e4
REFER_ENERGY = 0.5 * 8000 * 0.01        # stretching.cpp:38
PULL_RATE = 0.5e-4                      # m/s shift of each end band
DT_MACRO = 100.0 / 10000.0              # Dt (stretching.cpp:293)
KE_GATE = 0.005                         # stretching.cpp:320


class SimState(NamedTuple):
    bar: State
    time: torch.Tensor       # 0-d, the state's dtype and device
    n_macro: int
    overflow: torch.Tensor   # 0-d bool: a position went non-finite
    n_sub: int = 0           # the acoustic sub-steps of all macro steps


@dataclasses.dataclass(frozen=True)
class StretchingCase:
    dx: float
    adaptation: SPHAdaptation
    material: NonLinearHardeningPlasticSolid
    rp: sd.ReferencePairs
    nl_inner: NeighborList
    left_mask: torch.Tensor
    right_mask: torch.Tensor
    n_bar: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def _bar_shape(bw: float):
    """The beam polygon and its end bands (stretching.cpp:56-83): the top
    and bottom edges dip by 1% of PH at mid-span to seed the neck."""
    notch = 0.01 * PH
    beam = [(0.0, -PH / 2), (0.0, PH / 2), (PL / 2.0, PH / 2 - notch),
            (PL, PH / 2), (PL, -PH / 2), (PL / 2.0, -PH / 2 + notch)]
    left = [(-bw, -PH / 2), (-bw, PH / 2), (0.0, PH / 2), (0.0, -PH / 2)]
    right = [(PL, -PH / 2), (PL, PH / 2), (PL + bw, PH / 2),
             (PL + bw, -PH / 2)]
    return G.make_multi_polygon(("add", beam), ("add", left), ("add", right))


def build_case(dx: float = PH / 15, dtype=PRODUCTION_DTYPE,
               cell_cap: int = 24, k_inner: int = 40, device="cuda"):
    """The bar and its bands on one lattice, the plastic state, the frozen
    pairs (the damping's list too) and B.  Returns (case, bar)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    material = NonLinearHardeningPlasticSolid(
        rho0=RHO0, youngs_modulus=YOUNGS, poisson_ratio=POISSON,
        yield_stress=YIELD_STRESS, hardening_modulus=HARDENING_MODULUS,
        saturation_flow_stress=SATURATION_FLOW,
        saturation_exponent=SATURATION_EXP)
    bw = 4 * dx
    lo = (-bw - 2 * dx, -PH / 2 - 2 * dx)
    hi = (PL + bw + 2 * dx, PH / 2 + 2 * dx)
    pos, vol = generate_lattice(_bar_shape(bw), lo, hi, dx)
    bar = sd.make_elastic_solid_state(pos, vol, material, dtype, device)
    n = len(pos)
    bar["InversePlasticStrain"], bar["HardeningParameter"] = \
        material.initial_plastic_state(n, 2, dtype, device)

    x = np.asarray(pos)[:, 0]
    grid = grid_from_bounds(lo, hi, adaptation.cutoff)
    p0 = bar["Position"]
    table = build_cell_table(p0, n, grid, cell_cap)
    nl = build_neighbor_list(p0, n, p0, n, table, grid, adaptation.cutoff,
                             k_max=k_inner, include_self=False)
    if bool(nl.overflow):
        raise ValueError("raise k_inner: the frozen pairs must be exact")
    rp = sd.freeze_reference_pairs(p0, nl, adaptation.kernel, 2)
    bar["LinearGradientCorrectionMatrix"] = \
        sd.linear_gradient_correction_matrix(rp, bar["VolumetricMeasure"])
    case = StretchingCase(dx=dx, adaptation=adaptation, material=material,
                          rp=rp, nl_inner=nl,
                          left_mask=torch.as_tensor(x < 0.0, device=device),
                          right_mask=torch.as_tensor(x > PL, device=device),
                          n_bar=n)
    return case, bar


def init_sim(case: StretchingCase, bar: State) -> SimState:
    pos = bar["Position"]
    return SimState(bar=bar, time=pos.new_zeros(()), n_macro=0,
                    overflow=torch.zeros((), dtype=torch.bool,
                                         device=pos.device))


def _constrain_x(case: StretchingCase, bar: State) -> State:
    """ConstrainXVelocity (stretching.cpp:148-164): vel_x = 0 in both end
    bands."""
    out = dict(bar)
    vel = bar["Velocity"]
    vx = torch.where(case.left_mask | case.right_mask,
                     torch.zeros_like(vel[:, 0]), vel[:, 0])
    out["Velocity"] = torch.stack([vx, vel[:, 1]], dim=1)
    return out


def pull(case: StretchingCase, bar: State) -> State:
    """The macro step's prelude: the end bands shifted by
    +-PULL_RATE DT_MACRO in x, F recomputed by summation."""
    bar = dict(bar)
    shift = PULL_RATE * DT_MACRO
    pos = bar["Position"]
    zero = torch.zeros_like(pos[:, 0])
    dxs = torch.where(case.left_mask, zero - shift, zero) + \
        torch.where(case.right_mask, zero + shift, zero)
    bar["Position"] = torch.stack([pos[:, 0] + dxs, pos[:, 1]], dim=1)
    return sd.deformation_gradient_by_summation(bar, case.rp)


def damping(case: StretchingCase, bar: State, dt=None) -> State:
    """Pairwise damping of the velocity at the macro step's DT_MACRO, as
    the JAX package's (the acoustic dt, `dt`, is not used)."""
    return dp.damping_pairwise(bar, "Velocity", case.nl_inner, case.kernel, 2,
                               PHYSICAL_VISCOSITY, DT_MACRO)


def substep(case: StretchingCase, bar: State):
    """One acoustic sub-step of the gated loop: (bar, dt, KE /
    REFER_ENERGY), the last two 0-d device tensors."""
    h = case.adaptation.h
    dt = sd.solid_acoustic_time_step(bar, case.material.sound_speed, h)
    bar = sd.decomposed_plastic_integration_1st_half(bar, case.rp,
                                                     case.material, dt, h)
    bar = _constrain_x(case, bar)
    bar = damping(case, bar)
    bar = _constrain_x(case, bar)
    bar = sd.integration_2nd_half(bar, case.rp, dt)
    ke = 0.5 * torch.sum(bar["Mass"] * torch.sum(bar["Velocity"] ** 2, dim=1))
    return bar, dt, ke / REFER_ENERGY


def _open(rel, ke_norm):
    return (rel < DT_MACRO) & (ke_norm > KE_GATE)


def _macro_step(case: StretchingCase, s: SimState) -> SimState:
    """One DT_MACRO window (stretching.cpp:304-352): pull, then sub-steps
    while the gate is open."""
    bar = pull(case, s.bar)
    rel = bar["Position"].new_zeros(())
    ke_norm = torch.full_like(rel, 1.0e4)
    n_sub = 0
    while bool(_open(rel, ke_norm)):
        bar, dt, ke_norm = substep(case, bar)
        rel = rel + dt
        n_sub += 1
    bad = ~torch.all(torch.isfinite(bar["Position"]))
    return SimState(bar=bar, time=s.time + DT_MACRO, n_macro=s.n_macro + 1,
                    overflow=s.overflow | bad, n_sub=s.n_sub + n_sub)


def make_step(case: StretchingCase):
    """One macro step."""
    return lambda s: _macro_step(case, s)


def make_run_chunk(case: StretchingCase):
    """run_chunk(sim, t_target): macro steps until sim.time >= t_target
    (one host read of the time a macro step, besides the gate's)."""
    def run_chunk(s, t_target):
        target = torch.as_tensor(t_target, dtype=s.time.dtype,
                                 device=s.time.device)
        while bool(s.time < target):
            s = _macro_step(case, s)
        return s

    return run_chunk


def von_mises_kirchhoff(case: StretchingCase, bar: State) -> torch.Tensor:
    """The von Mises equivalent of the deviatoric Kirchhoff stress the
    radial return works with: |G (be - tr(be)/d I)| sqrt(3/2)."""
    m = case.material
    nbe, _, _ = m.elastic_left_cauchy(bar["DeformationGradient"],
                                      bar["InversePlasticStrain"],
                                      bar["HardeningParameter"])
    dim = nbe.shape[-1]
    iso = torch.diagonal(nbe, dim1=-2, dim2=-1).sum(-1) / dim
    eye = torch.eye(dim, dtype=nbe.dtype, device=nbe.device)
    dev = m.shear_modulus * (nbe - iso[..., None, None] * eye)
    return torch.sqrt(1.5 * torch.sum(dev * dev, dim=(-2, -1)))


def run(end_time: float = 10.0, dx: float = PH / 15, chunk: float = 1.0,
        device="cuda", dtype=PRODUCTION_DTYPE):
    """The case from its build to end_time in chunks: (case, sim)."""
    case, bar = build_case(dx=dx, device=device, dtype=dtype)
    s = init_sim(case, bar)
    run_chunk = make_run_chunk(case)
    t = 0.0
    while t < end_time - 1e-9:
        t = min(t + chunk, end_time)
        s = run_chunk(s, t)
    return case, s
