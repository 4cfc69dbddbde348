"""Parity of the port's J2-plastic solids, the plastic and summation
functions of physics/solid.py, physics/bar.py and physics/shell.py's
`_stress_cauchy_linear` with the JAX package, on the CPU in float64.

  * `elastic_left_cauchy` of HardeningPlasticSolid and
    NonLinearHardeningPlasticSolid (the stretching bar's steel), on
    deformation gradients I plus seeded noise with carried plastic states:
    some rows yield, some stay elastic (both asserted); `kirchhoff_stress`;
  * `decomposed_plastic_integration_1st_half`,
    `deformation_gradient_by_summation`, `von_mises_stress` and
    `von_mises_strain` on a 2D block with seeded deformation, velocity and
    plastic state, on JAX's frozen pairs carried across;
  * bar.py's functions on the slender beam's built bar (42 particles)
    with seeded rotations, rates and bending: `make_bar_state`,
    `bar_correct_configuration`, both stress-relaxation halves,
    `bar_acoustic_time_step`, `constrain_bar_region`, `rotate_vector`.

Every output is held within 1e-12 of its max |ref|.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sphinxsys_tpu.core import materials as jmat
from sphinxsys_tpu.core.adaptation import SPHAdaptation
from sphinxsys_tpu.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_tpu.physics import bar as jbd
from sphinxsys_tpu.physics import shell as jsh
from sphinxsys_tpu.physics import solid as jsd
from sphinxsys_tpu_torch import convert
from sphinxsys_tpu_torch.core import materials as tmat
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation as TAdaptation
from sphinxsys_tpu_torch.physics import bar as tbd
from sphinxsys_tpu_torch.physics import shell as tsh
from sphinxsys_tpu_torch.physics import solid as tsd

torch.set_num_threads(1)

TOL = 1e-12
# the stretching bar's steel (cases/stretching_2d.py)
G_, K_ = 80.1938e9, 164.21e9
STEEL = dict(rho0=7850.0,
             youngs_modulus=9.0 * G_ * K_ / (3.0 * K_ + G_),
             poisson_ratio=(3.0 * K_ - 2.0 * G_) / (6.0 * K_ + 2.0 * G_),
             yield_stress=0.45e9, hardening_modulus=1.2924e8)
SATURATION = dict(saturation_flow_stress=7.15e8, saturation_exponent=16.93)
LAWS = {"linear": (jmat.HardeningPlasticSolid, tmat.HardeningPlasticSolid,
                   {}),
        "saturation": (jmat.NonLinearHardeningPlasticSolid,
                       tmat.NonLinearHardeningPlasticSolid, SATURATION)}


def close(got, ref, tol=TOL, what=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-300), (what, err)


def t(a):
    return torch.as_tensor(np.array(a))


def laws(name):
    jcls, tcls, extra = LAWS[name]
    return jcls(**STEEL, **extra), tcls(**STEEL, **extra)


def plastic_inputs(dim, n=96, seed=3):
    """(F, inverse plastic strain, kappa): strains of 0 to ~2e-2 a row
    around the yield strain ~6e-3, plastic strains of ~1e-3, kappa in
    [0, 0.05)."""
    rng = np.random.default_rng(seed)
    scale = 0.012 * rng.uniform(0.0, 1.5, (n, 1, 1))
    F = np.eye(dim) + scale * rng.normal(size=(n, dim, dim))
    P = np.eye(dim) + 0.001 * rng.normal(size=(n, dim, dim))
    inv_ps = 0.5 * (P + np.swapaxes(P, -1, -2))
    kappa = rng.uniform(0.0, 0.05, n)
    kappa[: n // 4] = 0.0
    return F, inv_ps, kappa


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("law", sorted(LAWS))
def test_elastic_left_cauchy(law, dim):
    jm, tm = laws(law)
    F, inv_ps, kappa = plastic_inputs(dim)
    ref = jm.elastic_left_cauchy(jnp.asarray(F), jnp.asarray(inv_ps),
                                 jnp.asarray(kappa))
    got = tm.elastic_left_cauchy(t(F), t(inv_ps), t(kappa))
    for name, g, r in zip(("be", "inv_ps", "kappa"), got, ref):
        close(g, r, what=name)
    yielded = got[2] > t(kappa)
    assert 0 < int(yielded.sum()) < len(kappa)
    J = t(np.linalg.det(F))
    close(tm.kirchhoff_stress(got[0], J),
          jm.kirchhoff_stress(ref[0], jnp.asarray(np.linalg.det(F))),
          what="tau")


def test_initial_plastic_state_and_flow_stress():
    jm, tm = laws("saturation")
    e, k = tm.initial_plastic_state(5, 2, torch.float64, "cpu")
    je, jk = jm.initial_plastic_state(5, 2, jnp.float64)
    close(e, je) and close(k, jk)
    kap = np.linspace(0.0, 0.3, 7)
    close(tm._flow_stress(t(kap)), jm._flow_stress(jnp.asarray(kap)))
    close(tm._flow_stress_derivative(t(kap)),
          jm._flow_stress_derivative(jnp.asarray(kap)))


def test_stress_cauchy_linear():
    rng = np.random.default_rng(4)
    eps = 0.01 * rng.normal(size=(20, 3, 3))
    close(tsh._stress_cauchy_linear(t(eps), 2.5, 1.5),
          jsh._stress_cauchy_linear(jnp.asarray(eps), 2.5, 1.5))


@functools.lru_cache(maxsize=None)
def block():
    """A 2D 12 x 8 block of the saturation law, its frozen pairs (JAX's),
    seeded x, v, F, dF/dt and plastic state: (JAX solid, port solid, JAX
    pairs, port pairs, material pair, h)."""
    dx = 0.001
    jm, tm = laws("saturation")
    ad = SPHAdaptation(spacing=dx, dim=2)
    xs, ys = np.arange(dx / 2, 12 * dx, dx), np.arange(dx / 2, 8 * dx, dx)
    pos = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    n = len(pos)
    js = dict(jsd.make_elastic_solid_state(pos, dx * dx, jm,
                                           dtype=jnp.float64))
    grid = grid_from_bounds((-4 * dx, -4 * dx), (16 * dx, 12 * dx),
                            ad.cutoff)
    table = build_cell_table(js["Position"], js["NReal"], grid, cap=16)
    nl = build_neighbor_list(js["Position"], js["NReal"], js["Position"],
                             js["NReal"], table, grid, ad.cutoff, k_max=32,
                             include_self=False)
    rp = jsd.freeze_reference_pairs(js["Position"], nl, ad.kernel, 2)
    js["LinearGradientCorrectionMatrix"] = \
        jsd.linear_gradient_correction_matrix(rp, js["VolumetricMeasure"])
    rng = np.random.default_rng(5)
    F, inv_ps, kappa = plastic_inputs(2, n=n, seed=6)
    js.update(
        Position=js["Position"] + jnp.asarray(1e-5 * rng.normal(size=(n, 2))),
        Velocity=jnp.asarray(0.01 * rng.normal(size=(n, 2))),
        ForcePrior=jnp.asarray(rng.normal(size=(n, 2))),
        DeformationGradient=jnp.asarray(F),
        DeformationRate=jnp.asarray(0.1 * rng.normal(size=(n, 2, 2))),
        InversePlasticStrain=jnp.asarray(inv_ps),
        HardeningParameter=jnp.asarray(kappa))
    ts = convert.state_from_numpy({k: np.asarray(v) for k, v in js.items()})
    trp = tsd.ReferencePairs(*(t(a) for a in rp))
    return js, ts, rp, trp, (jm, tm), ad.h


def test_decomposed_plastic_integration_1st_half():
    js, ts, rp, trp, (jm, tm), h = block()
    dt = 2e-8
    ref = jsd.decomposed_plastic_integration_1st_half(js, rp, jm, dt, h)
    got = tsd.decomposed_plastic_integration_1st_half(ts, trp, tm, dt, h)
    for k in ("Position", "DeformationGradient", "Density", "Force",
              "Velocity", "InversePlasticStrain", "HardeningParameter"):
        close(got[k], ref[k], what=k)
    assert bool((got["HardeningParameter"] > ts["HardeningParameter"]).any())


def test_deformation_gradient_by_summation():
    js, ts, rp, trp, _, _ = block()
    close(tsd.deformation_gradient_by_summation(ts, trp)
          ["DeformationGradient"],
          jsd.deformation_gradient_by_summation(js, rp)
          ["DeformationGradient"])


def test_von_mises():
    js, ts, _, _, (jm, tm), _ = block()
    close(tsd.von_mises_stress(ts, tm), jsd.von_mises_stress(js, jm))
    close(tsd.von_mises_strain(ts), jsd.von_mises_strain(js))


@functools.lru_cache(maxsize=None)
def bars():
    """The slender beam's built bar on both sides (JAX's, carried across),
    then seeded rotations, angular velocities, director rates, bending
    gradients and velocities: (JAX bar, port bar, JAX pairs, port pairs,
    material pair, h)."""
    from sphinxsys_tpu.cases import slender_beam_3d as jsb
    from sphinxsys_tpu_torch.core.materials import SaintVenantKirchhoffSolid

    jc, jsim = jsb.build_case(dtype=jnp.float64)
    jb = dict(jsim.bar)
    n = jb["Position"].shape[0]
    rng = np.random.default_rng(8)
    for k, s in (("Rotation", 0.05), ("AngularVelocity", 0.5),
                 ("BinormalRotation", 0.05),
                 ("BinormalAngularVelocity", 0.5), ("Velocity", 0.3),
                 ("PseudoNormalRate", 0.2), ("PseudoBinormalRate", 0.2),
                 ("ForcePrior", 1.0)):
        jb[k] = jnp.asarray(s * rng.normal(size=(n, 3)))
    for k, s in (("BendingDeformationGradient", 0.05),
                 ("BinormalBending", 0.05), ("DeformationRate", 0.1),
                 ("BendingDeformationRate", 0.1),
                 ("BinormalBendingRate", 0.1)):
        jb[k] = jnp.asarray(s * rng.normal(size=(n, 3, 3)))
    jb["DeformationGradient"] = jnp.asarray(
        np.eye(3) + 0.02 * rng.normal(size=(n, 3, 3)))
    tb = convert.state_from_numpy({k: np.asarray(v) for k, v in jb.items()})
    trp = tsd.ReferencePairs(*(t(a) for a in jc.rp))
    m = jc.material
    tm = SaintVenantKirchhoffSolid(rho0=m.rho0,
                                   youngs_modulus=m.youngs_modulus,
                                   poisson_ratio=m.poisson_ratio)
    return jb, tb, jc.rp, trp, (m, tm), jc.adaptation.h


def test_make_bar_state_and_correction():
    from sphinxsys_tpu.cases import slender_beam_3d as jsb

    jb, _, rp, trp, (jm, tm), _ = bars()
    pos = np.asarray(jb["InitialPosition"])
    ref = jbd.make_bar_state(pos, (0.0, 0.0, 1.0), (0.0, 1.0, 0.0), jsb.DX,
                             jsb.PT, jsb.PW, jm, dtype=jnp.float64)
    got = tbd.make_bar_state(pos, (0.0, 0.0, 1.0), (0.0, 1.0, 0.0), jsb.DX,
                             jsb.PT, jsb.PW, tm, torch.float64, "cpu")
    assert set(got) == set(ref)
    for k, v in ref.items():
        if k == "NReal":
            assert got[k] == int(v)
        else:
            close(got[k], v, what=k)
    close(tbd.bar_correct_configuration(got, trp)
          ["LinearGradientCorrectionMatrix"],
          jbd.bar_correct_configuration(ref, rp)
          ["LinearGradientCorrectionMatrix"])


def test_rotate_vector():
    rng = np.random.default_rng(9)
    rot = rng.normal(size=(30, 3))
    rot[:3] = 0.0
    for v0 in (tbd.LOCAL_N0, tbd.LOCAL_B0):
        close(tbd.rotate_vector(t(rot), v0),
              jbd.rotate_vector(jnp.asarray(rot), np.asarray(v0)))


def test_bar_stress_relaxation_1st_half():
    jb, tb, rp, trp, (jm, tm), h = bars()
    ref = jbd.bar_stress_relaxation_1st_half(jb, rp, jm, 1e-4, h)
    got = tbd.bar_stress_relaxation_1st_half(tb, trp, tm, 1e-4, h)
    assert set(got) == set(ref)
    for k, v in ref.items():
        if k != "NReal":
            close(got[k], v, what=k)


def test_bar_stress_relaxation_2nd_half_and_time_step():
    jb, tb, rp, trp, (jm, tm), h = bars()
    ref = jbd.bar_stress_relaxation_2nd_half(jb, rp, 1e-4)
    got = tbd.bar_stress_relaxation_2nd_half(tb, trp, 1e-4)
    for k, v in ref.items():
        if k != "NReal":
            close(got[k], v, what=k)
    close(tbd.bar_acoustic_time_step(got, tm, h),
          jbd.bar_acoustic_time_step(ref, jm, h))
    mask = np.arange(tb["Position"].shape[0]) % 3 == 0
    c_ref = jbd.constrain_bar_region(ref, jnp.asarray(mask))
    c_got = tbd.constrain_bar_region(got, t(mask))
    for k in ("Velocity", "AngularVelocity", "BinormalAngularVelocity"):
        close(c_got[k], c_ref[k], what=k)


def test_line_kernel():
    from sphinxsys_tpu.core.adaptation import SPHAdaptation as JA

    jk, tk = jbd.LineKernel(JA(spacing=0.25, dim=3).kernel), \
        tbd.LineKernel(TAdaptation(spacing=0.25, dim=3).kernel)
    r = np.linspace(0.0, 0.6, 13)
    close(tk.W(t(r), 3), jk.W(jnp.asarray(r), 3))
    close(tk.dW(t(r), 3), jk.dW(jnp.asarray(r), 3))
    assert tk.w0(3) == pytest.approx(float(jk.w0(3)), rel=1e-14)
    assert tk.cutoff == pytest.approx(jk.cutoff) and tk.h == jk.h
