"""Parity of the port's new heart-family functions with the JAX package
on the CPU: the closed-form 3 x 3 (and 2 x 2) Cholesky factor and
lower-triangular inverse (against `jnp.linalg.cholesky` and
`jax.scipy.linalg.solve_triangular`), LocalDirectionalDiffusion's pair
coefficient, its rate through a list with per-particle fibers, the Euler
and RK2 steps and the electrophysiology step that read the fiber field
(with a Dirichlet contact, which takes the fiberless coefficient), the
Ellipsoid and HalfSpace shapes (distance, normal, containment, bounds),
LocallyOrthotropicMuscle's PK2 stress, the Laguerre-Gauss kernel and the
adaptation's kernel class, the ideal gas.

Inputs are made from numpy seeds; the diffusion runs on the seeded 3D
scene of tests/test_torch_viscosity.py with random unit fibers.  float64
within 1e-12 of max |JAX| (functions), float32 within 2e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import jax.scipy.linalg

from test_torch_viscosity import DTYPES, TOL, close, kernels, scene

from sphinxsys_tpu.core import adaptation as jad
from sphinxsys_tpu.core import geometry as jg
from sphinxsys_tpu.core import kernels as jk
from sphinxsys_tpu.core import materials as jmat
from sphinxsys_tpu.physics import diffusion as jdf
from sphinxsys_tpu_torch.core import adaptation as tad
from sphinxsys_tpu_torch.core import geometry as tg
from sphinxsys_tpu_torch.core import kernels as tk
from sphinxsys_tpu_torch.core import linalg
from sphinxsys_tpu_torch.core import materials as tmat
from sphinxsys_tpu_torch.physics import diffusion as tdf

torch.set_num_threads(1)

LOCAL = dict(d_coeff=0.05, bias_coeff=0.1)
DT = 1.0e-3


def _spd(rng, n, d):
    """Random SPD stacks, eigenvalues spread over two decades."""
    q, _ = np.linalg.qr(rng.normal(size=(n, d, d)))
    lam = 10.0 ** rng.uniform(-1.0, 1.0, size=(n, d))
    return np.einsum("nij,nj,nkj->nik", q, lam, q)


@pytest.mark.parametrize("d", (2, 3))
def test_cholesky_and_triangular_inverse_match_jax(d):
    M = _spd(np.random.default_rng(5 + d), 64, d)
    # a slightly unsymmetric input: both take the symmetrised matrix
    M = M + 1e-9 * np.random.default_rng(9).normal(size=M.shape)
    L = linalg.cholesky(torch.as_tensor(M))
    jL = jnp.linalg.cholesky(jnp.asarray(M))
    close(L, jL, 1e-12, "cholesky")
    assert float(torch.triu(L, diagonal=1).abs().max()) == 0.0
    T = linalg.lower_triangular_inverse(L)
    eye = jnp.broadcast_to(jnp.eye(d), jL.shape)
    close(T, jax.scipy.linalg.solve_triangular(jL, eye, lower=True), 1e-12,
          "inverse")
    close(linalg.mm(T, L), np.broadcast_to(np.eye(d), M.shape), 1e-12)


def test_cholesky_rejects_other_sizes():
    with pytest.raises(ValueError):
        linalg.cholesky(torch.eye(4, dtype=torch.float64))
    with pytest.raises(ValueError):
        linalg.lower_triangular_inverse(torch.eye(1, dtype=torch.float64))


def _unit(rng, n, d):
    v = rng.normal(size=(n, d))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.mark.parametrize("d", (2, 3))
def test_local_directional_coefficient_matches_jax(d):
    rng = np.random.default_rng(20 + d)
    n, k = 30, 7
    fi, fj = _unit(rng, n, d), _unit(rng, n * k, d).reshape(n, k, d)
    e = _unit(rng, n * k, d).reshape(n, k, d)
    jd = jdf.LocalDirectionalDiffusion(**LOCAL)
    td = tdf.LocalDirectionalDiffusion(**LOCAL)
    ref = jd.inter_particle_coeff(jnp.asarray(e), jnp.asarray(fi),
                                  jnp.asarray(fj))
    T_i = td.inverse_cholesky(torch.as_tensor(fi))
    T_j = td.inverse_cholesky(torch.as_tensor(fj))
    close(td.inter_particle_coeff(torch.as_tensor(e), T_i, T_j), ref, 1e-12)
    close(T_i, jd._inv_chol(jnp.asarray(fi)), 1e-12, "T")
    # along a common fiber the coefficient is d + b, across it d
    f = np.zeros((1, d))
    f[0, 0] = 1.0
    T = td.inverse_cholesky(torch.as_tensor(f))
    along = td.inter_particle_coeff(torch.as_tensor(f[:, None]), T, T[:, None])
    across = np.zeros((1, 1, d))
    across[0, 0, 1] = 1.0
    across = td.inter_particle_coeff(torch.as_tensor(across), T, T[:, None])
    assert float(along) == pytest.approx(0.15, rel=1e-12)
    assert float(across) == pytest.approx(0.05, rel=1e-12)
    assert td.inter_particle_coeff(torch.as_tensor(e)) == \
        jd.inter_particle_coeff(jnp.asarray(e)) == 0.1
    assert td.reference_diffusivity == jd.reference_diffusivity


def _fibered(dtype):
    """The 3D scene with Phi, Voltage / GateVariable, a correction matrix
    near I and random unit fibers, both packages'."""
    (jb, jw, nl, nlw, _), (tb, tw, tnl, tnlw, _) = scene(3, dtype)
    rng = np.random.default_rng(31)
    n, nw = tb["Position"].shape[0], tw["Position"].shape[0]
    extra = {"Fiber": _unit(rng, n, 3), "Phi": 1.0 + rng.random(n),
             "Voltage": rng.random(n), "GateVariable": 0.3 * rng.random(n),
             "LinearGradientCorrectionMatrix": np.eye(3)
             + 0.1 * rng.normal(size=(n, 3, 3))}
    wall = {"Phi": 3.0 + rng.random(nw)}
    jb = dict(jb, **{k: jnp.asarray(v, dtype) for k, v in extra.items()})
    tb = dict(tb, **{k: torch.as_tensor(np.asarray(v, dtype))
                     for k, v in extra.items()})
    jw = dict(jw, **{k: jnp.asarray(v, dtype) for k, v in wall.items()})
    tw = dict(tw, **{k: torch.as_tensor(np.asarray(v, dtype))
                     for k, v in wall.items()})
    return (jb, jw, nl, nlw), (tb, tw, tnl, tnlw)


@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
def test_fiber_rate_matches_jax(dtype):
    (jb, jw, nl, nlw), (tb, tw, tnl, tnlw) = _fibered(dtype)
    jkn, tkn = kernels()
    jd = jdf.LocalDirectionalDiffusion(**LOCAL)
    td = tdf.LocalDirectionalDiffusion(**LOCAL)
    ref = jax.jit(lambda b: jdf.diffusion_rate(
        b["Position"], b["Phi"], b["VolumetricMeasure"], b["Position"],
        b["Phi"], nl, jkn, 3, jd, fiber_q=b["Fiber"], fiber_s=b["Fiber"]))(jb)
    got = tdf.diffusion_rate(tb["Position"], tb["Phi"],
                             tb["VolumetricMeasure"], tb["Position"],
                             tb["Phi"], tnl, tkn, 3, td, fiber_q=tb["Fiber"])
    assert got.dtype == tb["Position"].dtype
    close(got, ref, TOL[dtype])
    # the fibers change the answer (against the fiberless d + b / 2)
    plain = tdf.diffusion_rate(tb["Position"], tb["Phi"],
                               tb["VolumetricMeasure"], tb["Position"],
                               tb["Phi"], tnl, tkn, 3, td)
    assert float((plain - got).abs().max()) > 1e-3 * float(got.abs().max())


@pytest.mark.parametrize("form", ("euler", "rk2_dirichlet", "corrected",
                                  "electrophysiology"))
def test_fiber_steps_match_jax(form):
    (jb, jw, nl, nlw), (tb, tw, tnl, tnlw) = _fibered(np.float64)
    jkn, tkn = kernels()
    jd = jdf.LocalDirectionalDiffusion(**LOCAL)
    td = tdf.LocalDirectionalDiffusion(**LOCAL)
    if form == "euler":
        ref = jax.jit(lambda b: jdf.diffusion_step(b, "Phi", nl, jkn, 3, jd,
                                                   DT))(jb)
        got = tdf.diffusion_step(tb, "Phi", tnl, tkn, 3, td, DT)
    elif form == "rk2_dirichlet":
        ref = jax.jit(lambda b, w: jdf.diffusion_step_rk2(
            b, "Phi", nl, jkn, 3, jd, DT, dirichlet_contacts=[(w, nlw)]))(
                jb, jw)
        got = tdf.diffusion_step_rk2(tb, "Phi", tnl, tkn, 3, td, DT,
                                     dirichlet_contacts=[(tw, tnlw)])
    elif form == "corrected":
        ref = jax.jit(lambda b: jdf.diffusion_step_rk2(
            b, "Phi", nl, jkn, 3, jd, DT, correction=True))(jb)
        got = tdf.diffusion_step_rk2(tb, "Phi", tnl, tkn, 3, td, DT,
                                     correction=True)
    else:
        model = dict(k_a=0.1)
        ref = jax.jit(lambda b: jdf.electrophysiology_step(
            b, nl, jkn, 3, jd, jdf.AlievPanfilowModel(**model), DT))(
                {k: v for k, v in jb.items()
                 if k != "LinearGradientCorrectionMatrix"}
                | {"ActiveContractionStress": jnp.zeros_like(jb["Phi"])})
        got = tdf.electrophysiology_step(
            {k: v for k, v in tb.items()
             if k != "LinearGradientCorrectionMatrix"}
            | {"ActiveContractionStress": torch.zeros_like(tb["Phi"])},
            tnl, tkn, 3, td, tdf.AlievPanfilowModel(**model), DT)
        for k in ("Voltage", "GateVariable", "ActiveContractionStress"):
            close(got[k], ref[k], 1e-12, k)
        return
    close(got["Phi"], ref["Phi"], 1e-12, form)
    close(got["Phi"] - tb["Phi"], ref["Phi"] - jb["Phi"], 1e-10,
          form + " change")


SHAPES = {
    "ellipsoid": (dict(center=(0.1, -0.2, 0.05), semi_axes=(1.0, 0.7, 1.5)),
                  "Ellipsoid"),
    "ellipsoid_2d": (dict(center=(0.1, -0.2), semi_axes=(0.5, 0.9)),
                     "Ellipsoid"),
    "halfspace": (dict(point=(0.0, 0.0, 0.55),
                       outward_normal=(0.3, 0.0, -1.0)), "HalfSpace"),
    "lv": (None, None),
}


def _shape(pkg, name):
    kw, cls = SHAPES[name]
    if name == "lv":
        return pkg.make_complex(
            ("add", pkg.Ellipsoid(center=(0.0, 0.0, 0.0),
                                  semi_axes=(1.0, 1.0, 1.5))),
            ("sub", pkg.Ellipsoid(center=(0.0, 0.0, 0.0),
                                  semi_axes=(0.7, 0.7, 1.25))),
            ("sub", pkg.HalfSpace(point=(0.0, 0.0, 0.55),
                                  outward_normal=(0.0, 0.0, -1.0))))
    return getattr(pkg, cls)(**kw)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_shapes_match_jax(name):
    dim = 2 if name.endswith("2d") else 3
    pts = np.random.default_rng(3).uniform(-1.8, 1.8, size=(400, dim))
    js, ts = _shape(jg, name), _shape(tg, name)
    p = torch.as_tensor(pts)
    with torch.no_grad():
        close(ts.signed_distance(p), js.signed_distance(jnp.asarray(pts)),
              1e-12, "sd")
    assert (ts.contains(p).numpy()
            == np.asarray(js.contains(jnp.asarray(pts)))).all()
    close(ts.find_normal_direction(p),
          js.find_normal_direction(jnp.asarray(pts)), 1e-12, "normal")
    if name != "lv":
        for a, b in zip(ts.bounds(), js.bounds()):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
def test_locally_orthotropic_muscle_matches_jax(dtype):
    rng = np.random.default_rng(41)
    n = 50
    F = (np.eye(3) + 0.15 * rng.normal(size=(n, 3, 3))).astype(dtype)
    f0 = _unit(rng, n, 3).astype(dtype)
    s0 = _unit(rng, n, 3).astype(dtype)
    kw = dict(rho0=1.0, bulk_modulus_param=3.2, a0=(0.496, 15.196, 3.283,
                                                   0.662),
              b0=(7.209, 20.417, 11.176, 9.466))
    jm, tm = jmat.LocallyOrthotropicMuscle(**kw), \
        tmat.LocallyOrthotropicMuscle(**kw)
    ref = jax.jit(jm.stress_PK2_local)(jnp.asarray(F), jnp.asarray(f0),
                                       jnp.asarray(s0))
    got = tm.stress_PK2_local(torch.as_tensor(F), torch.as_tensor(f0),
                              torch.as_tensor(s0))
    assert got.dtype == torch.as_tensor(F).dtype
    close(got, ref, TOL[dtype])
    assert tm.sound_speed == pytest.approx(jm.sound_speed, rel=1e-15)
    # a uniform field is the constant-direction muscle's stress
    const = tmat.Muscle(**kw, f0=tuple(f0[0].tolist()),
                        s0=tuple(s0[0].tolist()))
    Ft = torch.as_tensor(F)
    close(tm.stress_PK2_local(Ft, torch.as_tensor(f0[:1]).expand(n, 3),
                              torch.as_tensor(s0[:1]).expand(n, 3)),
          const.stress_PK2(Ft), 1e-15)


@pytest.mark.parametrize("dim", (1, 2, 3))
def test_laguerre_gauss_matches_jax(dim):
    h = 0.026
    r = np.linspace(0.0, 2.2 * h, 301)
    jkl, tkl = jk.LaguerreGauss(h=h), tk.LaguerreGauss(h=h)
    rt = torch.as_tensor(r)
    close(tkl.W(rt, dim), jkl.W(jnp.asarray(r), dim), 1e-12, "W")
    close(tkl.dW(rt, dim), jkl.dW(jnp.asarray(r), dim), 1e-12, "dW")
    assert tkl.w0(dim) == pytest.approx(jkl.w0(dim), rel=1e-14)
    assert tkl.cutoff == jkl.cutoff
    ja = jad.SPHAdaptation(spacing=0.02, dim=2, kernel_cls=jk.LaguerreGauss)
    ta = tad.SPHAdaptation(spacing=0.02, dim=2, kernel_cls=tk.LaguerreGauss)
    assert isinstance(ta.kernel, tk.LaguerreGauss)
    assert ta.sigma0 == pytest.approx(ja.sigma0, rel=1e-12)
    assert isinstance(tad.SPHAdaptation(spacing=0.02, dim=2).kernel,
                      tk.WendlandC2)


def test_compressible_fluid_matches_jax():
    rng = np.random.default_rng(2)
    rho, e = 0.5 + rng.random(20), 1.0 + rng.random(20)
    jgas, tgas = jmat.CompressibleFluid(gamma=1.4), \
        tmat.CompressibleFluid(gamma=1.4)
    p = tgas.pressure(torch.as_tensor(rho), torch.as_tensor(e))
    close(p, jgas.pressure(jnp.asarray(rho), jnp.asarray(e)), 1e-15)
    close(tgas.sound_speed(p, torch.as_tensor(rho)),
          jgas.sound_speed(jnp.asarray(np.asarray(p)), jnp.asarray(rho)),
          1e-15)
    close(tgas.internal_energy(p, torch.as_tensor(rho)), e, 1e-14)
