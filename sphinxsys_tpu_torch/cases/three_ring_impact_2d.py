"""Three-ring impact: dynamic contact between two shells and a solid ring
(counterpart of sphinxsys_tpu/cases/three_ring_impact_2d.py; reference
tests/2d_examples/test_2d_three_ring_impact): a small stiff shell ring
shot at (-30, 30) into a soft medium shell ring inside a large solid
Neo-Hookean ring whose outer band is held.  It runs the surface-contact
stack (physics/surface_contact.py):

  * shell <-> shell contact (small <-> medium, normal_correction: the
    rings' normals point outward, cpp:241-243);
  * shell <-> solid contact both ways (the medium ring sees a solid
    surface through the offset-reduced kernel, the large ring a shell
    through the dummy stack);
  * the medium ring's self contact (pairs far apart in the initial
    configuration only);
  * the curvatures: each ring's own, with the same kernel, for both.

All three at dp = thickness_l / 8 = 0.25, one dt (the smallest of the
three bodies'), pairwise velocity and rotation damping at the paper's
viscosity: 2,812 + 138 + 113 particles, float64 by default.  The large
ring's lattice is relaxed (physics/relax.relax_shape, 600 iterations);
its jitter is the port's own generator, so a parity test passes
`relaxed=` the other package's positions.

    case, sim = build_case(device="cpu", relax=False)
    sim = make_run_chunk(case)(sim, 1e-3)
    print(sim.n_steps, observer_point(case, sim))
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sphinxsys_tpu_torch.core import geometry as G
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.generators import generate_lattice
from sphinxsys_tpu_torch.core.materials import NeoHookeanSolid
from sphinxsys_tpu_torch.core.state import State
from sphinxsys_tpu_torch.device import resolve_device, resolve_dtype
from sphinxsys_tpu_torch.neighbors.cell_list import (CellGrid,
                                                    build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import build_neighbor_list
from sphinxsys_tpu_torch.physics import contact as ct
from sphinxsys_tpu_torch.physics import dissipation as dp
from sphinxsys_tpu_torch.physics import relax as rx
from sphinxsys_tpu_torch.physics import shell as sh
from sphinxsys_tpu_torch.physics import shell_fluid as sf
from sphinxsys_tpu_torch.physics import solid as sd
from sphinxsys_tpu_torch.physics import surface_contact as sc
from sphinxsys_tpu_torch.solver import chunk_runner

# the geometry (cpp:133-158)
D_IN_L, D_OUT_L = 26.0, 30.0
D_IN_M, D_OUT_M = 10.0, 12.0
D_IN_S, D_OUT_S = 8.0, 10.0
R_MID_M = 0.25 * (D_IN_M + D_OUT_M)
R_MID_S = 0.25 * (D_IN_S + D_OUT_S)
TH_L = 0.5 * (D_OUT_L - D_IN_L)
TH_M = 0.5 * (D_OUT_M - D_IN_M)
TH_S = 0.5 * (D_OUT_S - D_IN_S)
CENTER_L = (0.0, 0.0)
CENTER_M = (-3.95, 3.95)
CENTER_S = (3.95, -4.25)
DP_REF = TH_L / 4.0

# the materials (cpp:160-173)
RHO_L, RHO_M, RHO_S = 1.0, 0.01, 0.1
E_L, E_M, E_S = 288.0e3, 2250.0, 10.0e3
NU = 0.125
V0_S = (-30.0, 30.0)
END_TIME = 1.0


def physical_viscosity(rho, youngs, length_scale, shape_constant=0.4):
    """beta / 4 sqrt(rho E) L (cpp:119-126)."""
    return shape_constant / 4.0 * math.sqrt(rho * youngs) * length_scale


@dataclasses.dataclass
class RingSim:
    ring_l: State
    ring_m: State
    ring_s: State
    time: torch.Tensor
    n_steps: int
    dt: torch.Tensor
    overflow: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ThreeRingCase:
    dp: float
    adaptation: SPHAdaptation
    mat_l: NeoHookeanSolid
    mat_m: NeoHookeanSolid
    mat_s: NeoHookeanSolid
    rp_l: sd.ReferencePairs         # the solid's frozen pairs
    rp_m: sd.ReferencePairs         # the shells' (reduced kernel)
    rp_s: sd.ReferencePairs
    fixed_l: torch.Tensor
    grid: CellGrid
    n_l: int
    n_m: int
    n_s: int
    k_contact: int
    cell_cap: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def ring_shape():
    """The large ring's annulus."""
    return G.make_complex(
        ("add", G.Ball(center=CENTER_L, radius=0.5 * D_OUT_L)),
        ("sub", G.Ball(center=CENTER_L, radius=0.5 * D_IN_L)))


def _ring_shell(center, r_mid, dp, thickness, material, dtype, device):
    n = int(2.0 * math.pi * r_mid / dp)
    th = 2.0 * math.pi * np.arange(n) / n
    normal = np.stack([np.cos(th), np.sin(th)], -1)
    ring = sh.make_shell_state(np.asarray(center) + r_mid * normal, normal,
                               dp, thickness, material, dtype, device)
    for key in ("RepulsionForce", "PreviousRepulsionForce"):
        ring[key] = torch.zeros_like(ring["Position"])
    return ring


def build_case(dp: float = DP_REF / 2.0, dtype=torch.float64,
               relax: bool = True, k_contact: int = 24, cell_cap: int = 16,
               device="cuda", relaxed=None):
    """The large ring (the annulus's lattice, relaxed unless `relax` is
    False, or the positions `relaxed` as given), its frozen pairs and B,
    the held outer band; the two shell rings, their frozen pairs on the
    reduced kernel and B, the small ring's velocity.  Returns (case,
    sim), dt the smallest of the three bodies' acoustic dts."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    adaptation = SPHAdaptation(spacing=dp, dim=2)
    kernel = adaptation.kernel
    mat_l = NeoHookeanSolid(rho0=RHO_L, youngs_modulus=E_L, poisson_ratio=NU)
    mat_m = NeoHookeanSolid(rho0=RHO_M, youngs_modulus=E_M, poisson_ratio=NU)
    mat_s = NeoHookeanSolid(rho0=RHO_S, youngs_modulus=E_S, poisson_ratio=NU)

    shape = ring_shape()
    lo = (-0.5 * D_OUT_L - 2 * dp, -0.5 * D_OUT_L - 2 * dp)
    hi = (0.5 * D_OUT_L + 2 * dp, 0.5 * D_OUT_L + 2 * dp)
    pos_l, vol_l = generate_lattice(shape, lo, hi, dp)
    grid = grid_from_bounds(lo, hi, adaptation.cutoff)
    if relaxed is not None:
        pos_l = np.asarray(relaxed, dtype=np.float64)
    elif relax:
        pos_l = rx.relax_shape(
            shape, torch.as_tensor(pos_l, dtype=torch.float64, device=device),
            vol_l, adaptation, grid, n_iterations=600, cell_cap=24,
            k_max=40).cpu().numpy()
    ring_l = sd.make_elastic_solid_state(pos_l, vol_l, mat_l, dtype, device)
    n_l = len(pos_l)
    fixed_l = torch.as_tensor(np.hypot(pos_l[:, 0], pos_l[:, 1])
                              > 0.5 * D_OUT_L - 0.7 * dp, device=device)
    p_l = ring_l["Position"]
    table_l = build_cell_table(p_l, n_l, grid, cell_cap)
    nl_l = build_neighbor_list(p_l, n_l, p_l, n_l, table_l, grid,
                               adaptation.cutoff, k_max=32,
                               include_self=False)
    if bool(nl_l.overflow):
        raise ValueError("three_ring_impact_2d: the ring's pairs overflow")
    rp_l = sd.freeze_reference_pairs(p_l, nl_l, kernel, 2)
    ring_l["LinearGradientCorrectionMatrix"] = \
        sd.linear_gradient_correction_matrix(rp_l, ring_l["VolumetricMeasure"])
    for key in ("RepulsionForce", "PreviousRepulsionForce"):
        ring_l[key] = torch.zeros_like(p_l)

    ring_m = _ring_shell(CENTER_M, R_MID_M, dp, TH_M, mat_m, dtype, device)
    ring_s = _ring_shell(CENTER_S, R_MID_S, dp, TH_S, mat_s, dtype, device)
    ring_s["Velocity"] = torch.as_tensor(V0_S, dtype=dtype, device=device) \
        .expand_as(ring_s["Position"]).contiguous()
    for key in ("SelfRepulsionForce", "PreviousSelfRepulsionForce"):
        ring_m[key] = torch.zeros_like(ring_m["Position"])

    def shell_rp(ring):
        p, n = ring["Position"], ring["NReal"]
        table = build_cell_table(p, n, grid, cell_cap)
        nl = build_neighbor_list(p, n, p, n, table, grid, adaptation.cutoff,
                                 k_max=12, include_self=False)
        if bool(nl.overflow):
            raise ValueError("three_ring_impact_2d: a shell's pairs overflow")
        return sd.freeze_reference_pairs(p, nl, sh.ReducedKernel(kernel), 2)

    rp_m, rp_s = shell_rp(ring_m), shell_rp(ring_s)
    ring_m = sh.shell_correct_configuration(ring_m, rp_m)
    ring_s = sh.shell_correct_configuration(ring_s, rp_s)
    case = ThreeRingCase(dp=dp, adaptation=adaptation, mat_l=mat_l,
                         mat_m=mat_m, mat_s=mat_s, rp_l=rp_l, rp_m=rp_m,
                         rp_s=rp_s, fixed_l=fixed_l, grid=grid, n_l=n_l,
                         n_m=ring_m["NReal"], n_s=ring_s["NReal"],
                         k_contact=k_contact, cell_cap=cell_cap)
    h = adaptation.h
    dt0 = min(float(sd.solid_acoustic_time_step(ring_l, mat_l.sound_speed, h,
                                                cfl=0.6)),
              float(sh.shell_acoustic_time_step(ring_m, mat_m, h)),
              float(sh.shell_acoustic_time_step(ring_s, mat_s, h)))
    return case, RingSim(ring_l=ring_l, ring_m=ring_m, ring_s=ring_s,
                         time=p_l.new_zeros(()), n_steps=0,
                         dt=p_l.new_tensor(dt0),
                         overflow=torch.zeros((), dtype=torch.bool,
                                              device=device))


def _contact_nl(case: ThreeRingCase, pos_q, n_q, target: State, n_t: int):
    table = build_cell_table(target["Position"], n_t, case.grid,
                             case.cell_cap)
    return build_neighbor_list(pos_q, n_q, target["Position"], n_t, table,
                               case.grid, case.kernel.cutoff,
                               k_max=case.k_contact, include_self=True)


def contact_forces(case: ThreeRingCase, rl: State, rm: State, rs: State):
    """The step's contact lists (rebuilt every step: the bodies move
    fast), the surface pairs with cpp:241-243's normal corrections, the
    repulsion factors and the forces: (f_l, f_m, f_mm self, f_s, the
    lists' overflow)."""
    kernel, dim, dp_ = case.kernel, 2, case.dp
    red = sh.ReducedKernel(kernel)
    k1_m, k2_m = sf.shell_curvature(rm, case.rp_m, red, dim)
    k1_s, k2_s = sf.shell_curvature(rs, case.rp_s, red, dim)
    nl_sm = _contact_nl(case, rs["Position"], case.n_s, rm, case.n_m)
    nl_ms = _contact_nl(case, rm["Position"], case.n_m, rs, case.n_s)
    nl_ml = _contact_nl(case, rm["Position"], case.n_m, rl, case.n_l)
    nl_lm = _contact_nl(case, rl["Position"], case.n_l, rm, case.n_m)
    # the medium ring's self contact (its own positions' list; the
    # initial-configuration exclusion is in shell_self_pairs)
    nl_mm = _contact_nl(case, rm["Position"], case.n_m, rm, case.n_m)
    ovf = (nl_sm.overflow | nl_ms.overflow | nl_ml.overflow | nl_lm.overflow
           | nl_mm.overflow)

    pairs_sm = sc.shell_surface_pairs(rs["Position"], rm, k1_m, k2_m, nl_sm,
                                      kernel, dim, dp_,
                                      normal_correction=True)
    pairs_ms = sc.shell_surface_pairs(rm["Position"], rs, k1_s, k2_s, nl_ms,
                                      kernel, dim, dp_,
                                      normal_correction=True)
    pairs_ml = sc.solid_surface_pairs(rm["Position"], rl, nl_ml, kernel, dim,
                                      dp_, dp_)
    pairs_lm = sc.shell_surface_pairs(rl["Position"], rm, k1_m, k2_m, nl_lm,
                                      kernel, dim, dp_,
                                      normal_correction=True)
    pairs_mm = sc.shell_self_pairs(rm, k1_m, k2_m, nl_mm, kernel, dim, dp_)

    sigma_s = sc.repulsion_factor([pairs_sm])
    sigma_m = sc.repulsion_factor([pairs_ms, pairs_ml])
    sigma_l = sc.repulsion_factor([pairs_lm])
    sigma_mm = sc.repulsion_factor([pairs_mm])
    K_l = ct.contact_stiffness(case.mat_l)
    K_m = ct.contact_stiffness(case.mat_m)
    K_s = ct.contact_stiffness(case.mat_s)

    def k_ave(a, b):
        return 2.0 * a * b / (a + b)

    pv_m = rm["VolumetricMeasure"] * rm["Thickness"]
    pv_s = rs["VolumetricMeasure"] * rs["Thickness"]
    f_s = sc.repulsion_force(rs, sigma_s,
                             [(pairs_sm, sigma_m, k_ave(K_s, K_m))],
                             particle_volume=pv_s)
    f_m = sc.repulsion_force(rm, sigma_m,
                             [(pairs_ms, sigma_s, k_ave(K_m, K_s)),
                              (pairs_ml, sigma_l, k_ave(K_m, K_l))],
                             particle_volume=pv_m)
    f_l = sc.repulsion_force(rl, sigma_l,
                             [(pairs_lm, sigma_m, k_ave(K_l, K_m))])
    f_mm = sc.self_repulsion_force(rm, sigma_mm, pairs_mm, K_m, RHO_M,
                                   particle_volume=pv_m)
    return f_l, f_m, f_mm, f_s, ovf


def _apply_force(ring: State, key: str, force) -> State:
    """ForcePrior += force - the previous one; both stored."""
    out = dict(ring)
    out["ForcePrior"] = ring["ForcePrior"] + force - ring["Previous" + key]
    out[key] = force
    out["Previous" + key] = force
    return out


def damping(case: ThreeRingCase, rl: State, rm: State, rs: State, dt):
    """DampingWithRandomChoice(0.2) in expectation, every step at dt: the
    pairwise velocity damping of the solid and the velocity and rotation
    damping of both shells."""
    kernel, red = case.kernel, sh.ReducedKernel(case.kernel)
    rl = dp.damping_pairwise(rl, "Velocity", case.rp_l, kernel, 2,
                             physical_viscosity(RHO_L, E_L, TH_L), dt)
    eta_m = physical_viscosity(RHO_M, E_M, TH_M)
    eta_s = physical_viscosity(RHO_S, E_S, TH_S)
    for field in ("Velocity", "AngularVelocity"):
        rm = dp.damping_pairwise(rm, field, case.rp_m, red, 2, eta_m, dt)
    for field in ("Velocity", "AngularVelocity"):
        rs = dp.damping_pairwise(rs, field, case.rp_s, red, 2, eta_s, dt)
    return rl, rm, rs


def _step(case: ThreeRingCase, s: RingSim) -> RingSim:
    kernel, h, dt = case.kernel, case.adaptation.h, s.dt
    rl, rm, rs = s.ring_l, s.ring_m, s.ring_s
    f_l, f_m, f_mm, f_s, ovf = contact_forces(case, rl, rm, rs)
    rs = _apply_force(rs, "RepulsionForce", f_s)
    rm = _apply_force(rm, "RepulsionForce", f_m)
    rm = _apply_force(rm, "SelfRepulsionForce", f_mm)
    rl = _apply_force(rl, "RepulsionForce", f_l)

    rl = sd.integration_1st_half_pk2(rl, case.rp_l, case.mat_l, dt, h,
                                     kernel.w0(2))
    rm = sh.shell_stress_relaxation_1st_half(rm, case.rp_m, case.mat_m, dt, h)
    rs = sh.shell_stress_relaxation_1st_half(rs, case.rp_s, case.mat_s, dt, h)
    rl = sd.fix_constraint(rl, case.fixed_l)
    rl, rm, rs = damping(case, rl, rm, rs, dt)
    rl = sd.fix_constraint(rl, case.fixed_l)

    rl = sd.integration_2nd_half(rl, case.rp_l, dt)
    rm = sh.update_shell_normal(
        sh.shell_stress_relaxation_2nd_half(rm, case.rp_m, dt))
    rs = sh.update_shell_normal(
        sh.shell_stress_relaxation_2nd_half(rs, case.rp_s, dt))
    dt_next = torch.minimum(
        torch.minimum(sd.solid_acoustic_time_step(rl, case.mat_l.sound_speed,
                                                  h, cfl=0.6),
                      sh.shell_acoustic_time_step(rm, case.mat_m, h)),
        sh.shell_acoustic_time_step(rs, case.mat_s, h))
    return RingSim(ring_l=rl, ring_m=rm, ring_s=rs, time=s.time + dt,
                   n_steps=s.n_steps + 1, dt=dt_next,
                   overflow=s.overflow | ovf)


def make_step(case: ThreeRingCase):
    return lambda s: _step(case, s)


def make_run_chunk(case: ThreeRingCase):
    """run_chunk(sim, t_target): steps until sim.time >= t_target."""
    return chunk_runner(make_step(case))


def observer_point(case: ThreeRingCase, s: RingSim) -> np.ndarray:
    """The reference's observer: the medium ring's material point first
    facing away from the small ring (cpp:280), its current position."""
    d = np.asarray(CENTER_M) - np.asarray(CENTER_S)
    p0 = np.asarray(CENTER_M) + R_MID_M * d / np.linalg.norm(d)
    pos0 = s.ring_m["InitialPosition"].double().cpu().numpy()
    i = int(np.argmin(np.linalg.norm(pos0 - p0, axis=1)))
    return s.ring_m["Position"][i].double().cpu().numpy()
