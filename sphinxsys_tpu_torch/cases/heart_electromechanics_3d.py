"""Heart electromechanics with the ventricle's volume change (3D)
(counterpart of sphinxsys_tpu/cases/heart_electromechanics_3d.py;
reference tests/3d_examples/test_3d_heart_electromechanics/ and
test_3d_heart_volume_change/):

  1. fibers (excitation_contraction.h:69-162): a field Phi held at 1 on
     the epicardium and 0 on the endocardium diffuses through the wall;
     the fiber is the circumferential direction turned about the
     transmural normal by the helix angle beta = (beta_epi - beta_endo)
     Phi + beta_endo (-70 and +80 degrees), the sheet the normal;
  2. excitation: the Aliev-Panfilow monodomain with the fiber-biased
     LocalDirectionalDiffusion and an apex stimulus;
  3. contraction: Ta f f on top of the LocallyOrthotropicMuscle's
     passive stress in the total-Lagrangian mechanics, the base fixed;
  4. volume change (heart_volume_change.h:95-146): the endocardial
     particles' Nanson-updated area J F^-T n0 dA0 integrates the cavity's
     flow rate Q = sum v . n dA into the ejected volume.

As in the JAX package: an ellipsoidal shell (the Purkinje case's,
pkj_lv_electrocontraction_3d.lv_shell) stands in for the biventricular
STL, its surfaces told by the two ellipsoids' signed distances; one body
carries physiology and mechanics; the constants are nondimensional with
the reference's Ta / a0 ratio.

The mechanics sub-cycle of a step runs on an adaptive dt_i (the solid's
acoustic step, capped), so it ends on a flag: one host read a sub-step,
counted in the sim's `n_sub`.

    case, sim = build_case(dx=0.24, device="cpu")
    sim = make_run_chunk(case)(sim, 0.2)
    print(sim.n_steps, sim.n_sub, float(sim.dv))
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sphinxsys_tpu_torch.cases.pkj_lv_electrocontraction_3d import (
    INNER, OUTER, Z_CUT, lv_body, step_dt)
from sphinxsys_tpu_torch.core import geometry as G
from sphinxsys_tpu_torch.core.linalg import cofactors, mm, mv
from sphinxsys_tpu_torch.core.materials import LocallyOrthotropicMuscle
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.neighbors.neighbor_list import NeighborList
from sphinxsys_tpu_torch.physics import diffusion as df
from sphinxsys_tpu_torch.physics import solid as sd
from sphinxsys_tpu_torch.solver import chunk_runner

RHO0 = 1.0
POISSON = 0.45
A0 = (0.496, 15.196, 3.283, 0.662)      # the reference's a0 * 1e3
B0 = (7.209, 20.417, 11.176, 9.466)     # the reference's b0
K_A = 0.1                               # Ta_max = 10 = 20 a0[0]
D_MYO = 0.05
D_BIAS = 0.1                            # fiber-biased conduction
STIM_T = 0.4
BETA_EPI = -70.0 / 180.0 * np.pi
BETA_ENDO = 80.0 / 180.0 * np.pi


@dataclasses.dataclass
class Sim:
    myo: dict
    dv: torch.Tensor             # the cavity's accumulated volume change
    q: torch.Tensor              # its current flow rate
    time: torch.Tensor
    n_steps: int
    n_sub: int = 0               # mechanics sub-steps (host reads)


@dataclasses.dataclass(frozen=True, eq=False)
class HeartCase:
    dx: float
    adaptation: object
    material: LocallyOrthotropicMuscle
    rp: sd.ReferencePairs
    nl: NeighborList
    base_mask: torch.Tensor
    stim_mask: torch.Tensor
    endo_mask: torch.Tensor      # the endocardial particles
    endo_n0: torch.Tensor        # their initial outward normals
    endo_da0: torch.Tensor       # their initial area measures
    model: df.AlievPanfilowModel
    diffusion: df.LocalDirectionalDiffusion
    n: int
    dt_d: float
    n_mech_sub: int


def face_normal(p: np.ndarray, axes=None) -> np.ndarray:
    """The outward transmural direction: the gradient direction of the
    ellipsoid family of `axes` (OUTER by default) through p (the
    reference probes the level set's normal, excitation_contraction.h:
    135).  The endocardial normals take axes=INNER: the inner ellipsoid is
    no confocal scaling of the outer."""
    ax = np.asarray(OUTER if axes is None else axes)
    n = p / ax[None, :] ** 2
    return n / (np.linalg.norm(n, axis=1, keepdims=True) + 1e-15)


def generate_fibers(pos: np.ndarray, epi_mask, endo_mask, nl, kernel, vol,
                    dtype, device, n_relax: int = 240):
    """The reference's fiber pipeline (excitation_contraction.h:106-162):
    Phi (epi 1, endo 0) diffused through the wall by n_relax RK2 steps in
    `dtype` on `device`, then the circumferential direction turned about
    the face normal by the Rodrigues helix formula on the host in
    float64.  Returns (fibers, sheets, Phi) as host arrays."""
    n = len(pos)
    vol_arr = np.broadcast_to(np.asarray(vol), (n,))

    def t(a, dt=dtype):
        return torch.as_tensor(np.array(a), dtype=dt, device=device)

    state = {"Position": t(pos), "Phi": t(np.where(epi_mask, 1.0, 0.0)),
             "VolumetricMeasure": t(vol_arr), "NReal": n}
    diff = df.IsotropicDiffusion(1.0)
    h = float(np.cbrt(vol_arr[0])) * 1.3
    dt = df.diffusion_time_step(h, diff, 3)
    hold_epi, hold_endo = t(epi_mask, torch.bool), t(endo_mask, torch.bool)
    one = torch.ones((), dtype=dtype, device=device)
    for _ in range(n_relax):
        state = df.diffusion_step_rk2(state, "Phi", nl, kernel, 3, diff, dt)
        phi = torch.where(hold_epi, one,
                          torch.where(hold_endo, 0.0 * one, state["Phi"]))
        state = dict(state, Phi=phi)
    phi = np.clip(state["Phi"].double().cpu().numpy(), 0.0, 1.0)

    face = face_normal(pos)
    centerline = np.array([0.0, 0.0, 1.0])               # apex to base
    cd = np.cross(np.broadcast_to(centerline, face.shape), face)
    cd /= np.linalg.norm(cd, axis=1, keepdims=True) + 1e-15
    beta = (BETA_EPI - BETA_ENDO) * phi + BETA_ENDO
    f0 = (np.cos(beta)[:, None] * cd
          + np.sin(beta)[:, None] * np.cross(face, cd))
    f0 /= np.linalg.norm(f0, axis=1, keepdims=True) + 1e-15
    return f0, face, phi


def build_case(dx: float = 0.12, dtype=PRODUCTION_DTYPE, k_inner: int = 72,
               k_a: float = K_A, mech_cfl_factor: float = 12.0,
               device="cuda"):
    """The ventricle at rest with its generated fibers and sheets.
    Returns (case, sim)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    material = LocallyOrthotropicMuscle(
        rho0=RHO0, bulk_modulus_param=2.0 * A0[0] * (1.0 + POISSON)
        / (3.0 * (1.0 - 2.0 * POISSON)), a0=A0, b0=B0)
    p, vol, adaptation, myo, nl, rp = lv_body(dx, material, dtype, device,
                                              k_inner)
    n = len(p)

    def t(a, dt=dtype):
        return torch.as_tensor(np.array(a), dtype=dt, device=device)

    # the surface layers from the two ellipsoids' signed distances
    with torch.no_grad():
        pos64 = torch.as_tensor(p, dtype=torch.float64)
        sdf_out = G.Ellipsoid(center=(0.0, 0.0, 0.0), semi_axes=OUTER) \
            .signed_distance(pos64).numpy()
        sdf_in = G.Ellipsoid(center=(0.0, 0.0, 0.0), semi_axes=INNER) \
            .signed_distance(pos64).numpy()
    below_base = p[:, 2] < Z_CUT - 1.2 * dx
    epi_mask = (np.abs(sdf_out) < 0.8 * dx) & below_base
    endo_mask = (np.abs(sdf_in) < 0.8 * dx) & below_base

    f0, s0, _ = generate_fibers(p, epi_mask, endo_mask, nl,
                                adaptation.kernel, vol, dtype, device)
    myo["Fiber"] = t(f0)
    myo["Sheet"] = t(s0)

    model = df.AlievPanfilowModel(k_a=k_a)
    diffusion = df.LocalDirectionalDiffusion(D_MYO, D_BIAS)
    h = adaptation.h
    dt_d = df.diffusion_time_step(h, diffusion, 3)
    # the cap of the adaptive sub-step (mech_cfl_factor stiffens the
    # speed it is taken from)
    dt_s = 0.5 * h / (material.sound_speed * mech_cfl_factor)
    case = HeartCase(
        dx=dx, adaptation=adaptation, material=material, rp=rp, nl=nl,
        base_mask=t(p[:, 2] > Z_CUT - 1.2 * dx, torch.bool),
        stim_mask=t(p[:, 2] < -1.15, torch.bool),
        endo_mask=t(endo_mask, torch.bool),
        endo_n0=t(face_normal(p, axes=INNER)),
        endo_da0=t(np.broadcast_to(np.asarray(vol) / dx, (n,))),
        model=model, diffusion=diffusion, n=n, dt_d=float(dt_d),
        n_mech_sub=max(1, int(np.ceil(dt_d / dt_s))))
    zero = torch.zeros((), dtype=dtype, device=device)
    sim = Sim(myo=myo, dv=zero, q=zero.clone(), time=zero.clone(), n_steps=0)
    return case, sim



def cavity_flow_rate(case: HeartCase, myo: dict) -> torch.Tensor:
    """Q = sum_endo v . (J F^-T n0) dA0 (update_srf_area +
    update_flow_rate, heart_volume_change.cpp): positive while the wall
    moves outward (filling), negative during the ejection.  J F^-T is
    F's cofactor matrix."""
    n_cur = mv(cofactors(myo["DeformationGradient"]), case.endo_n0)
    q_i = torch.sum(myo["Velocity"] * n_cur, dim=-1) * case.endo_da0
    return torch.sum(torch.where(case.endo_mask, q_i, torch.zeros_like(q_i)))


def passive_active_pk1(case: HeartCase):
    """The PK1 hook: F (S_passive(F, f, s) + Ta f f)."""
    mat = case.material

    def pk1(solid, F):
        S2 = mat.stress_PK2_local(F, solid["Fiber"], solid["Sheet"])
        return mm(F, S2 + sd.active_fiber_stress(solid, F))

    return pk1


def mechanics_substep(case: HeartCase, m: dict, dt_i) -> dict:
    m = sd.integration_1st_half_pk2(m, case.rp, case.material, dt_i,
                                    case.adaptation.h,
                                    case.adaptation.kernel.w0(3),
                                    pk1_fn=passive_active_pk1(case))
    m = sd.fix_constraint(m, case.base_mask)
    return sd.integration_2nd_half(m, case.rp, dt_i)


def mechanics_dt(case: HeartCase, m: dict, dt, acc):
    """The adaptive sub-step: the solid's acoustic step (whose
    acceleration term follows the stiffened Holzapfel wave speed), capped
    at dt / n_mech_sub and at what is left of dt."""
    cap = dt / case.n_mech_sub
    return torch.minimum(torch.minimum(
        sd.solid_acoustic_time_step(m, case.material.sound_speed,
                                    case.adaptation.h), cap), dt - acc)


def _step(case: HeartCase, s: Sim) -> Sim:
    dt = step_dt(case, s)
    myo = dict(s.myo)
    # the apex stimulus, held during the ignition (ApplyStimulusCurrentSI)
    v = myo["Voltage"]
    myo["Voltage"] = torch.where(case.stim_mask & (s.time < STIM_T),
                                 torch.clamp(v, min=0.92), v)
    myo = df.electrophysiology_step(myo, case.nl, case.adaptation.kernel, 3,
                                    case.diffusion, case.model, dt)
    acc = torch.zeros_like(dt)
    n_sub = 0
    while bool(acc < dt):                  # one host read per sub-step
        dt_i = mechanics_dt(case, myo, dt, acc)
        myo = mechanics_substep(case, myo, dt_i)
        acc = acc + dt_i
        n_sub += 1
    q = cavity_flow_rate(case, myo)
    return Sim(myo=myo, dv=s.dv + q * dt, q=q, time=s.time + dt,
               n_steps=s.n_steps + 1, n_sub=s.n_sub + n_sub)


def make_advection_step(case: HeartCase):
    return lambda s: _step(case, s)


def make_run_chunk(case: HeartCase):
    """run_chunk(sim, t_target): steps until sim.time >= t_target."""
    return chunk_runner(make_advection_step(case))


def cavity_volume0() -> float:
    """The initial cavity: the inner half-ellipsoid below the base cut,
    pi a b c (2/3 + zc - zc^3 / 3)."""
    a, b, c = INNER
    zc = min(Z_CUT / c, 1.0)
    return float(np.pi * a * b * c * (2.0 / 3.0 + zc - zc ** 3 / 3.0))


def base_voltage(case: HeartCase, s: Sim) -> float:
    ring = s.myo["InitialPosition"][:, 2] > 0.3
    return float(s.myo["Voltage"][ring].mean())
