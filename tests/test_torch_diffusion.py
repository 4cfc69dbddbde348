"""Parity of the port's physics/diffusion.py with the JAX package on the
CPU: the isotropic and directional models and the time step; the rate
through one relation (plain, corrected, with per-particle
diffusivities); the Neumann and Robin rates and their area measure; the
Euler step with each contact kind, the correction and a local
diffusivity; both RK2 steps; the Aliev-Panfilow rates, the exponential
update, the reaction sweeps (with and without the active stress) and the
electrophysiology step.

Inputs: the seeded 2D scene of tests/test_torch_viscosity.py with a
species "Phi", per-particle conductivities, random unit normals and a
correction matrix near I; its wall strip serves as the Dirichlet, the
Neumann and the Robin body.  float64 within 1e-12 of max |JAX|, float32
within 2e-5.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_viscosity import DTYPES, TOL, close, kernels, scene

from sphinxsys_tpu.physics import diffusion as jdf
from sphinxsys_tpu_torch.physics import diffusion as tdf

torch.set_num_threads(1)

DT = 2.0e-4
ISO = dict(d_coeff=0.7)
DIRECTIONAL = dict(d_coeff=1.0, bias_coeff=0.6, bias_direction=(0.6, 0.8))
AP = dict(k_a=0.0, c_m=1.0, k=8.0, a=0.15, b=0.0, mu_1=0.2, mu_2=0.3,
          epsilon=0.04)


@functools.lru_cache(maxsize=None)
def dscene(dtype=np.float64):
    """The viscosity scene's body and wall with the diffusion fields, both
    packages'."""
    (jb, jw, nl, nlw, _), (tb, tw, tnl, tnlw, _) = scene(2, dtype)
    rng = np.random.default_rng(11)
    n, nw = tb["Position"].shape[0], tw["Position"].shape[0]

    def unit(m):
        v = rng.normal(size=(m, 2))
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    body = {"Phi": 20.0 + 5.0 * rng.random(n),
            "ThermalConductivity": 0.5 + rng.random(n),
            "NormalDirection": unit(n),
            "LinearGradientCorrectionMatrix": np.eye(2)
            + 0.1 * rng.normal(size=(n, 2, 2)),
            "Voltage": rng.random(n), "GateVariable": 0.5 * rng.random(n),
            "ActiveContractionStress": rng.random(n)}
    wall = {"Phi": 40.0 + rng.random(nw), "PhiFlux": 100.0 * rng.normal(
                size=nw),
            "PhiConvection": 10.0 + rng.random(nw),
            "ThermalConductivity": 0.5 + rng.random(nw),
            "NormalDirection": unit(nw)}
    jb2 = dict(jb, **{k: jnp.asarray(v, dtype) for k, v in body.items()})
    jw2 = dict(jw, **{k: jnp.asarray(v, dtype) for k, v in wall.items()})
    tb2 = dict(tb, **{k: torch.as_tensor(np.asarray(v, dtype))
                      for k, v in body.items()})
    tw2 = dict(tw, **{k: torch.as_tensor(np.asarray(v, dtype))
                      for k, v in wall.items()})
    return (jb2, jw2, nl, nlw), (tb2, tw2, tnl, tnlw)


def models(name):
    kw = ISO if name == "isotropic" else DIRECTIONAL
    cls = "IsotropicDiffusion" if name == "isotropic" \
        else "DirectionalDiffusion"
    return getattr(jdf, cls)(**kw), getattr(tdf, cls)(**kw)


@pytest.mark.parametrize("name", ("isotropic", "directional"))
def test_models_and_time_step_match_jax(name):
    jm, tm = models(name)
    assert tm.reference_diffusivity == jm.reference_diffusivity
    assert tdf.diffusion_time_step(0.13, tm, 2) == \
        jdf.diffusion_time_step(0.13, jm, 2)
    e = np.random.default_rng(2).normal(size=(30, 5, 2))
    e /= np.linalg.norm(e, axis=-1, keepdims=True)
    close(np.broadcast_to(np.asarray(tm.inter_particle_coeff(
        torch.as_tensor(e)), np.float64), e.shape[:2]),
          np.broadcast_to(np.asarray(jm.inter_particle_coeff(
              jnp.asarray(e))), e.shape[:2]))
    if name == "directional":   # d + b along the fiber, d across it
        f = torch.tensor([[0.6, 0.8], [-0.8, 0.6]], dtype=torch.float64)
        np.testing.assert_allclose(tm.inter_particle_coeff(f).numpy(),
                                   [1.6, 1.0], rtol=1e-14)


@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
@pytest.mark.parametrize("form", ("plain", "corrected", "local",
                                  "directional"))
def test_diffusion_rate_matches_jax(form, dtype):
    (jb, jw, nl, nlw), (tb, tw, tnl, tnlw) = dscene(dtype)
    jkn, tkn = kernels()
    jm, tm = models("directional" if form == "directional" else "isotropic")
    jkw, tkw = {}, {}
    if form == "corrected":
        jkw["B_q"] = jb["LinearGradientCorrectionMatrix"]
        tkw["B_q"] = tb["LinearGradientCorrectionMatrix"]
    if form == "local":
        jkw.update(local_diff_q=jb["ThermalConductivity"],
                   local_diff_s=jb["ThermalConductivity"])
        tkw.update(local_diff_q=tb["ThermalConductivity"],
                   local_diff_s=tb["ThermalConductivity"])
    ref = jax.jit(lambda b: jdf.diffusion_rate(
        b["Position"], b["Phi"], b["VolumetricMeasure"], b["Position"],
        b["Phi"], nl, jkn, 2, jm, **jkw))(jb)
    got = tdf.diffusion_rate(tb["Position"], tb["Phi"],
                             tb["VolumetricMeasure"], tb["Position"],
                             tb["Phi"], tnl, tkn, 2, tm, **tkw)
    close(got, ref, TOL[dtype], what=form)
    # a contact body without its own diffusivity: the pair takes k_i
    if form == "local":
        ref = jdf.diffusion_rate(jb["Position"], jb["Phi"],
                                 jw["VolumetricMeasure"], jw["Position"],
                                 jw["Phi"], nlw, jkn, 2, jm,
                                 local_diff_q=jb["ThermalConductivity"])
        got = tdf.diffusion_rate(tb["Position"], tb["Phi"],
                                 tw["VolumetricMeasure"], tw["Position"],
                                 tw["Phi"], tnlw, tkn, 2, tm,
                                 local_diff_q=tb["ThermalConductivity"])
        close(got, ref, TOL[dtype], what="contact")


@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
def test_neumann_and_robin_rates_match_jax(dtype):
    (jb, jw, nl, nlw), (tb, tw, tnl, tnlw) = dscene(dtype)
    jkn, tkn = kernels()
    tol = TOL[dtype]
    close(tdf._normal_area(tb["Position"], tb["NormalDirection"],
                           tw["VolumetricMeasure"], tw["Position"],
                           tw["NormalDirection"], tnlw, tkn, 2),
          jdf._normal_area(jb["Position"], jb["NormalDirection"],
                           jw["VolumetricMeasure"], jw["Position"],
                           jw["NormalDirection"], nlw, jkn, 2), tol)
    close(tdf.neumann_rate(tb, "Phi", tw, tnlw, tkn, 2),
          jdf.neumann_rate(jb, "Phi", jw, nlw, jkn, 2), tol, "neumann")
    close(tdf.robin_rate(tb, "Phi", tw, tnlw, tkn, 2, 12.5),
          jdf.robin_rate(jb, "Phi", jw, nlw, jkn, 2, 12.5), tol, "robin")


@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
@pytest.mark.parametrize("bc", ("dirichlet", "neumann", "robin", "all"))
def test_diffusion_step_matches_jax(bc, dtype):
    (jb, jw, nl, nlw), (tb, tw, tnl, tnlw) = dscene(dtype)
    jkn, tkn = kernels()
    jm, tm = models("isotropic")
    tol = TOL[dtype]
    jkw, tkw = {}, {}
    if bc in ("dirichlet", "all"):
        jkw["dirichlet_contacts"] = [(jw, nlw)]
        tkw["dirichlet_contacts"] = [(tw, tnlw)]
    if bc in ("neumann", "all"):
        jkw["neumann_contacts"] = [(jw, nlw)]
        tkw["neumann_contacts"] = [(tw, tnlw)]
    if bc in ("robin", "all"):
        jkw["robin_contacts"] = [(jw, nlw, 12.5)]
        tkw["robin_contacts"] = [(tw, tnlw, 12.5)]
    for extra in ({}, {"correction": True},
                  {"local_diff": "ThermalConductivity"}):
        ref = jax.jit(lambda b: jdf.diffusion_step(
            b, "Phi", nl, jkn, 2, jm, DT, **jkw, **extra))(jb)
        got = tdf.diffusion_step(tb, "Phi", tnl, tkn, 2, tm, DT, **tkw,
                                 **extra)
        close(got["Phi"], ref["Phi"], tol, what=(bc, extra))
        assert float((got["Phi"] - tb["Phi"]).abs().max()) > 1e-3
    ref = jax.jit(lambda b: jdf.diffusion_step_rk2(
        b, "Phi", nl, jkn, 2, jm, DT, correction=True, **jkw))(jb)
    got = tdf.diffusion_step_rk2(tb, "Phi", tnl, tkn, 2, tm, DT,
                                 correction=True, **tkw)
    close(got["Phi"], ref["Phi"], tol, what=(bc, "rk2"))


@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
def test_local_rk2_matches_jax(dtype):
    (jb, jw, nl, nlw), (tb, tw, tnl, tnlw) = dscene(dtype)
    jkn, tkn = kernels()
    jm, tm = models("isotropic")
    ref = jax.jit(lambda b: jdf.diffusion_step_local_rk2(
        b, "Phi", nl, jkn, 2, jm, DT, "ThermalConductivity",
        robin_contacts=[(jw, nlw, 0.0), (jw, nlw, 20.0)]))(jb)
    got = tdf.diffusion_step_local_rk2(
        tb, "Phi", tnl, tkn, 2, tm, DT, "ThermalConductivity",
        robin_contacts=[(tw, tnlw, 0.0), (tw, tnlw, 20.0)])
    close(got["Phi"], ref["Phi"], TOL[dtype])


@pytest.mark.parametrize("k_a", (0.0, 0.5), ids=("two", "active"))
@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
def test_reaction_matches_jax(k_a, dtype):
    (jb, _, _, _), (tb, _, _, _) = dscene(dtype)
    jm = jdf.AlievPanfilowModel(**dict(AP, k_a=k_a))
    tm = tdf.AlievPanfilowModel(**dict(AP, k_a=k_a))
    assert tm.species_names == jm.species_names
    tol = TOL[dtype]
    sp_j = {k: jb[k] for k in jm.species_names}
    sp_t = {k: tb[k] for k in tm.species_names}
    for name in tm.species_names:
        for got, ref in zip(tm.rates(name, sp_t), jm.rates(name, sp_j)):
            close(got, ref, tol, what=name)
    with pytest.raises(KeyError):
        tm.rates("Calcium", sp_t)
    p, l = tm.rates("Voltage", sp_t)
    close(tdf._exponential_update(tb["Voltage"], p, l, 0.1),
          jdf._exponential_update(jb["Voltage"], *jm.rates("Voltage", sp_j),
                                  0.1), tol)
    for backward in (False, True):
        ref = jdf.reaction_step(jb, jm, 0.05, backward=backward)
        got = tdf.reaction_step(tb, tm, 0.05, backward=backward)
        for k in tm.species_names:
            close(got[k], ref[k], tol, what=(backward, k))


@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
@pytest.mark.parametrize("corrected", (False, True), ids=("plain", "B"))
def test_electrophysiology_step_matches_jax(corrected, dtype):
    (jb, _, nl, _), (tb, _, tnl, _) = dscene(dtype)
    if not corrected:
        jb = {k: v for k, v in jb.items()
              if k != "LinearGradientCorrectionMatrix"}
        tb = {k: v for k, v in tb.items()
              if k != "LinearGradientCorrectionMatrix"}
    jkn, tkn = kernels()
    jd, td = models("directional")
    jm, tm = jdf.AlievPanfilowModel(**AP), tdf.AlievPanfilowModel(**AP)
    ref = jax.jit(lambda b: jdf.electrophysiology_step(
        b, nl, jkn, 2, jd, jm, DT))(jb)
    got = tdf.electrophysiology_step(tb, tnl, tkn, 2, td, tm, DT)
    for k in ("Voltage", "GateVariable"):
        close(got[k], ref[k], TOL[dtype], what=k)
