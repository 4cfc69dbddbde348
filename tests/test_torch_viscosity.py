"""Parity of the port's velocity gradient, physics/viscosity.py and
physics/oldroyd.py with the JAX package on the CPU: general.
velocity_gradient (without a wall, with the wall term, with the wall's
distance factor), the Herschel-Bulkley, Carreau and Oldroyd-B models, the
shear rate, the variable viscosity and its force, the SRD time step, and
both Oldroyd-B forms (viscosity.py's halves, oldroyd.py's force and rate).

Inputs come from a numpy seed: a jittered 2D lattice (14 x 10 at dx = 0.1)
with one isolated particle, over a wall strip of three layers with random
normals and averaged velocities; a 3D block for the velocity gradient.
JAX's neighbour lists are carried across, so both sides sum the same
slots.  Every output is held within 1e-12 of its max |JAX| in float64,
within 2e-5 in float32 (both packages' float32 from the same inputs).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sphinxsys_tpu.core import kernels as jk
from sphinxsys_tpu.core.materials import WeaklyCompressibleFluid as JEos
from sphinxsys_tpu.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_tpu.physics import fluid as jfd
from sphinxsys_tpu.physics import general as jgd
from sphinxsys_tpu.physics import oldroyd as job
from sphinxsys_tpu.physics import riemann as jrs
from sphinxsys_tpu.physics import viscosity as jvc
from sphinxsys_tpu_torch import convert
from sphinxsys_tpu_torch.core import kernels as tk
from sphinxsys_tpu_torch.core.materials import WeaklyCompressibleFluid as TEos
from sphinxsys_tpu_torch.physics import fluid as tfd
from sphinxsys_tpu_torch.physics import general as tgd
from sphinxsys_tpu_torch.physics import oldroyd as tob
from sphinxsys_tpu_torch.physics import riemann as trs
from sphinxsys_tpu_torch.physics import viscosity as tvc

torch.set_num_threads(1)

TOL = {np.float64: 1e-12, np.float32: 2e-5}
DTYPES = (np.float64, np.float32)
DX = 0.1
H = 1.3 * DX
DT = 1.0e-3
HB = dict(min_shear_rate=1e-2, max_shear_rate=3.0, consistency_index=0.8,
          power_index=0.5, yield_stress=0.2)
CARREAU = dict(min_shear_rate=1e-2, max_shear_rate=3.0,
               characteristic_time=0.7, mu_infty=0.05, mu0=1.0,
               power_index=0.4)
OLDROYD = dict(mu=0.1, relaxation_time=0.5, mu_p=0.3)


def close(got, ref, tol=1e-12, what=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max(initial=0.0)
    assert err <= tol * max(np.abs(ref).max(initial=0.0), 1e-300), (what,
                                                                      err)


def _sym(rng, n, d, scale):
    a = rng.normal(size=(n, d, d)) * scale
    return 0.5 * (a + a.transpose(0, 2, 1))


def _scene(dim, seed=0):
    """(body, wall) numpy states, float64, and the grid."""
    rng = np.random.default_rng(seed)
    n_axis = (14, 10) if dim == 2 else (6, 5, 4)
    axes = [np.arange(k) * DX + DX / 2 for k in n_axis]
    pos = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, dim)
    pos = pos + 0.2 * DX * (rng.random(pos.shape) - 0.5)
    far = np.full(dim, 0.25)
    far[1] = n_axis[1] * DX + 2.5          # alone, above the block
    pos = np.concatenate([pos, far[None]])
    n = len(pos)
    body = {"Position": pos, "VolumetricMeasure": DX ** dim
            * (1.0 + 0.05 * rng.normal(size=n)),
            "Mass": DX ** dim * (1.0 + 0.05 * rng.normal(size=n)),
            "Velocity": 0.3 * rng.normal(size=(n, dim)),
            "Density": 1.0 + 0.01 * rng.normal(size=n),
            "DensityChangeRate": 0.1 * rng.normal(size=n),
            "Force": 0.01 * rng.normal(size=(n, dim)),
            "ForcePrior": 0.01 * rng.normal(size=(n, dim)),
            "Pressure": rng.normal(size=n),
            "DensitySummation": np.ones(n),
            "VariableViscosity": 0.1 + rng.random(n),
            "ViscousForcePrev": 0.01 * rng.normal(size=(n, dim)),
            "ElasticStress": _sym(rng, n, dim, 0.5),
            "ElasticStressChangeRate": _sym(rng, n, dim, 2.0),
            "VelocityGradient": rng.normal(size=(n, dim, dim)),
            "NReal": np.int32(n)}
    wall_axes = [np.arange(n_axis[0]) * DX + DX / 2,
                 -np.arange(3) * DX - DX / 2, *axes[2:]]
    wpos = np.stack(np.meshgrid(*wall_axes, indexing="ij"),
                    -1).reshape(-1, dim)
    nw = len(wpos)
    normals = rng.normal(size=(nw, dim))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    wall = {"Position": wpos, "VolumetricMeasure": np.full(nw, DX ** dim),
            "Mass": np.full(nw, DX ** dim), "NormalDirection": normals,
            "Velocity": np.zeros((nw, dim)),
            "AverageVelocity": 0.3 * rng.normal(size=(nw, dim)),
            "AverageAcceleration": 2.0 * rng.normal(size=(nw, dim)),
            "NReal": np.int32(nw)}
    # the distance from the wall surface y = 0: (0, y) in 2D
    dfw = np.zeros((n, dim))
    dfw[:, 1] = pos[:, 1]
    hi = tuple(float(x) for x in pos.max(0) + DX)
    lo = (0.0, -0.5, *(-0.5 * np.ones(dim - 2)))
    return body, wall, dfw, grid_from_bounds(lo, hi, 2 * H)


def _cast(state, dtype):
    return {k: v if k == "NReal" or not np.issubdtype(
        np.asarray(v).dtype, np.floating) else np.asarray(v, dtype)
        for k, v in state.items()}


@functools.lru_cache(maxsize=None)
def scene(dim, dtype=np.float64):
    """JAX's (body, wall, inner list, wall list, distance) and the port's,
    in `dtype`."""
    body, wall, dfw, grid = _scene(dim)
    pos, wpos = jnp.asarray(body["Position"]), jnp.asarray(wall["Position"])
    n, nw = int(body["NReal"]), int(wall["NReal"])
    cap = 24 if dim == 2 else 48
    nl = build_neighbor_list(pos, n, pos, n,
                             build_cell_table(pos, n, grid, cap=cap), grid,
                             2 * H, k_max=40 if dim == 2 else 120,
                             include_self=False)
    nlw = build_neighbor_list(pos, n, wpos, nw,
                              build_cell_table(wpos, nw, grid, cap=cap),
                              grid, 2 * H, k_max=24 if dim == 2 else 80,
                              include_self=True)
    assert not bool(nl.overflow) and not bool(nlw.overflow)
    assert int(np.asarray(nl.count)[-1]) == 0       # the isolated particle
    body, wall = _cast(body, dtype), _cast(wall, dtype)
    dfw = np.asarray(dfw, dtype)
    jb = {k: jnp.asarray(v) for k, v in body.items()}
    jw = {k: jnp.asarray(v) for k, v in wall.items()}
    tb, tw = convert.state_from_numpy(body), convert.state_from_numpy(wall)
    tnl, tnlw = (convert.neighbor_list_from_numpy(x) for x in (nl, nlw))
    return (jb, jw, nl, nlw, jnp.asarray(dfw)), \
        (tb, tw, tnl, tnlw, torch.as_tensor(dfw))


def kernels():
    return jk.WendlandC2(h=H), tk.WendlandC2(h=H)


# ---------------------------------------------------------------------------
# the velocity gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
@pytest.mark.parametrize("form", ("inner", "wall", "distance"))
@pytest.mark.parametrize("dim", (2, 3))
def test_velocity_gradient_matches_jax(dim, form, dtype):
    (jb, jw, nl, nlw, jd), (tb, tw, tnl, tnlw, td) = scene(dim, dtype)
    jkn, tkn = kernels()
    jkw, tkw = {}, {}
    if form != "inner":
        jkw["walls"], tkw["walls"] = [(jw, nlw)], [(tw, tnlw)]
    if form == "distance":
        jkw["distance_from_wall"], tkw["distance_from_wall"] = jd, td
    ref = jax.jit(lambda b: jgd.velocity_gradient(b, nl, jkn, dim,
                                                  **jkw))(jb)
    got = tgd.velocity_gradient(tb, tnl, tkn, dim, **tkw)
    assert got.dtype == tb["Position"].dtype
    close(got, ref, TOL[dtype], what=form)
    if form == "distance":     # the factor changes the answer
        plain = tgd.velocity_gradient(tb, tnl, tkn, dim, walls=tkw["walls"])
        assert float((plain - got).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# the models and the variable viscosity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", (("HerschelBulkleyViscosity", HB),
                                     ("CarreauViscosity", CARREAU)),
                         ids=("herschel_bulkley", "carreau"))
def test_models_match_jax(name, kw):
    jm, tm = getattr(jvc, name)(**kw), getattr(tvc, name)(**kw)
    sr = np.concatenate([[1e-9, 1e-2, 3.0, 50.0],
                         np.random.default_rng(3).random(200) * 4.0])
    close(tm.viscosity(torch.as_tensor(sr)), jm.viscosity(jnp.asarray(sr)))
    assert tm.reference_viscosity == pytest.approx(jm.reference_viscosity,
                                                   rel=1e-12)
    # clamped at both ends
    mu = tm.viscosity(torch.as_tensor([1e-9, 1e-2, 3.0, 50.0]))
    assert float(mu[0]) == float(mu[1]) and float(mu[2]) == float(mu[3])
    assert dataclasses.asdict(tvc.OldroydBViscosity(**OLDROYD)) == \
        dataclasses.asdict(jvc.OldroydBViscosity(**OLDROYD))


@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
def test_shear_rate_and_variable_viscosity_match_jax(dtype):
    (jb, _, nl, _, _), (tb, _, tnl, _, _) = scene(2, dtype)
    jkn, tkn = kernels()
    for name, kw in (("HerschelBulkleyViscosity", HB),
                     ("CarreauViscosity", CARREAU)):
        jm, tm = getattr(jvc, name)(**kw), getattr(tvc, name)(**kw)
        ref = jax.jit(lambda b: jvc.update_variable_viscosity(
            b, nl, jkn, 2, jm))(jb)
        got = tvc.update_variable_viscosity(tb, tnl, tkn, 2, tm)
        for k in ("VelocityGradient", "VariableViscosity"):
            close(got[k], ref[k], TOL[dtype], what=(name, k))
        close(tvc.shear_rate_magnitude(got["VelocityGradient"], 2),
              jvc.shear_rate_magnitude(ref["VelocityGradient"], 2),
              TOL[dtype], what=name)
        # some rows are clamped at each end, some not
        sr = tvc.shear_rate_magnitude(got["VelocityGradient"], 2)
        assert int((sr < kw["min_shear_rate"]).sum()) >= 1
        assert int((sr > kw["max_shear_rate"]).sum()) >= 1
    g3 = torch.as_tensor(np.random.default_rng(4).normal(size=(50, 3, 3)))
    close(tvc.shear_rate_magnitude(g3, 3),
          jvc.shear_rate_magnitude(jnp.asarray(g3.numpy()), 3))


@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
def test_variable_force_and_srd_step_match_jax(dtype):
    (jb, jw, nl, nlw, _), (tb, tw, tnl, tnlw, _) = scene(2, dtype)
    jkn, tkn = kernels()
    ref = jax.jit(lambda b: jvc.viscous_force_variable(
        b, nl, jkn, 2, H, walls=[(jw, nlw)]))(jb)
    got = tvc.viscous_force_variable(tb, tnl, tkn, 2, H, walls=[(tw, tnlw)])
    for k in ("ViscousForce", "ForcePrior", "ViscousForcePrev"):
        close(got[k], ref[k], TOL[dtype], what=k)
    # a state without ViscousForcePrev takes it as zero
    jb0 = {k: v for k, v in jb.items() if k != "ViscousForcePrev"}
    tb0 = {k: v for k, v in tb.items() if k != "ViscousForcePrev"}
    close(tvc.viscous_force_variable(tb0, tnl, tkn, 2, H)["ForcePrior"],
          jvc.viscous_force_variable(jb0, nl, jkn, 2, H)["ForcePrior"],
          TOL[dtype])
    close(tvc.srd_viscous_time_step(tb, H), jvc.srd_viscous_time_step(jb, H),
          TOL[dtype])
    # uniform mu: the fluid's own viscous force
    mu = 0.7
    tu = dict(tb, VariableViscosity=torch.full_like(tb["Density"], mu))
    close(tvc.viscous_force_variable(tu, tnl, tkn, 2, H)["ViscousForce"],
          tfd.viscous_force(tu, tnl, tkn, 2, mu, H)["ViscousForce"],
          1e-5 if dtype == np.float32 else 1e-12)


# ---------------------------------------------------------------------------
# Oldroyd-B
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
def test_oldroyd_b_viscosity_forms_match_jax(dtype):
    """viscosity.py's block: the state, the force (with the wall), the
    half step, the rate and both halves."""
    (jb, jw, nl, nlw, _), (tb, tw, tnl, tnlw, _) = scene(2, dtype)
    jkn, tkn = kernels()
    tol = TOL[dtype]
    jm, tm = jvc.OldroydBViscosity(**OLDROYD), tvc.OldroydBViscosity(**OLDROYD)
    bare = {k: v for k, v in tb.items()
            if k not in ("ElasticStress", "ElasticStressChangeRate")}
    st = tvc.make_oldroyd_b_state(bare, 2)
    assert float(st["ElasticStress"].abs().max()) == 0.0
    assert st["ElasticStress"].shape == tb["ElasticStress"].shape
    close(tvc.elastic_stress_force(tb, tnl, tkn, 2, walls=[(tw, tnlw)]),
          jax.jit(lambda b: jvc.elastic_stress_force(
              b, nl, jkn, 2, walls=[(jw, nlw)]))(jb), tol, "force")
    close(tvc.oldroyd_b_stress_half_step(tb, DT)["ElasticStress"],
          jvc.oldroyd_b_stress_half_step(jb, DT)["ElasticStress"], tol)
    ref = jax.jit(lambda b: jvc.oldroyd_b_stress_rate(b, nl, jkn, 2,
                                                      jm))(jb)
    got = tvc.oldroyd_b_stress_rate(tb, tnl, tkn, 2, tm)
    for k in ("VelocityGradient", "ElasticStressChangeRate"):
        close(got[k], ref[k], tol, what=k)
    jeos, teos = JEos(rho0=1.0, c0=10.0), TEos(rho0=1.0, c0=10.0)
    jr, tr = jrs.acoustic_riemann(jeos), trs.acoustic_riemann(teos)
    ref1 = jax.jit(lambda b: jvc.oldroyd_b_1st_half(
        b, nl, jkn, 2, jeos, jr, DT, walls=[(jw, nlw)]))(jb)
    got1 = tvc.oldroyd_b_1st_half(tb, tnl, tkn, 2, teos, tr, DT,
                                  walls=[(tw, tnlw)])
    ref2 = jax.jit(lambda b: jvc.oldroyd_b_2nd_half(
        b, nl, jkn, 2, jr, DT, jm, walls=[(jw, nlw)]))(ref1)
    got2 = tvc.oldroyd_b_2nd_half(got1, tnl, tkn, 2, tr, DT, tm,
                                  walls=[(tw, tnlw)])
    for k in ("Position", "Velocity", "Density", "Pressure", "ForcePrior",
              "ElasticStress"):
        close(got1[k], ref1[k], tol, what=("1st", k))
    for k in ("Position", "Velocity", "Density", "ElasticStress",
              "ElasticStressChangeRate", "VelocityGradient"):
        close(got2[k], ref2[k], tol, what=("2nd", k))


@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
def test_oldroyd_module_matches_jax(dtype):
    """oldroyd.py: the variables, the half step, the force (inner, with
    the wall) and the rate, the force as the first half's extra_force."""
    (jb, jw, nl, nlw, _), (tb, tw, tnl, tnlw, _) = scene(2, dtype)
    jkn, tkn = kernels()
    tol = TOL[dtype]
    bare = {k: v for k, v in tb.items()
            if k not in ("ElasticStress", "ElasticStressChangeRate",
                         "VelocityGradient")}
    st = tob.register_variables(bare, 2)
    for k in ("ElasticStress", "ElasticStressChangeRate", "VelocityGradient"):
        assert st[k].shape == tb[k].shape and float(st[k].abs().max()) == 0
    assert tob.register_variables(tb, 2)["ElasticStress"] is tb["ElasticStress"]
    close(tob.stress_half_step(tb, DT)["ElasticStress"],
          job.stress_half_step(jb, DT)["ElasticStress"], tol)
    close(tob.elastic_stress_force(tb, tnl, tkn, 2),
          jax.jit(lambda b: job.elastic_stress_force(b, nl, jkn, 2))(jb),
          tol, "inner")
    ref_f = jax.jit(lambda b: job.elastic_stress_force(
        b, nl, jkn, 2, wall=jw, nl_wall=nlw))(jb)
    got_f = tob.elastic_stress_force(tb, tnl, tkn, 2, wall=tw, nl_wall=tnlw)
    close(got_f, ref_f, tol, "wall")
    jm, tm = jvc.OldroydBViscosity(**OLDROYD), tvc.OldroydBViscosity(**OLDROYD)
    close(tob.stress_rate(tb, tm)["ElasticStressChangeRate"],
          job.stress_rate(jb, jm)["ElasticStressChangeRate"], tol)
    jeos, teos = JEos(rho0=1.0, c0=10.0), TEos(rho0=1.0, c0=10.0)
    ref = jax.jit(lambda b, f: jfd.acoustic_step_1st_half(
        b, nl, jkn, 2, jeos, jrs.acoustic_riemann(jeos), DT, wall=jw,
        nl_wall=nlw, extra_force=f))(jb, ref_f)
    got = tfd.acoustic_step_1st_half(tb, tnl, tkn, 2, teos,
                                     trs.acoustic_riemann(teos), DT,
                                     wall=tw, nl_wall=tnlw,
                                     extra_force=got_f)
    close(got["Velocity"], ref["Velocity"], tol)


def test_uniform_elastic_stress_gives_no_interior_force():
    """A uniform stress's force cancels in the full support and not where
    it is cut (JAX's test_viscosity.py, on the port)."""
    (_, _, _, _, _), (tb, _, tnl, _, _) = scene(2)
    _, tkn = kernels()
    tau = torch.tensor([[0.3, 0.1], [0.1, -0.2]], dtype=torch.float64)
    st = dict(tb, ElasticStress=tau.expand_as(tb["ElasticStress"]).clone(),
              VolumetricMeasure=torch.full_like(tb["Density"], DX * DX))
    pos = tb["Position"].numpy()
    st["Position"] = torch.as_tensor(np.round((pos - DX / 2) / DX) * DX
                                     + DX / 2)
    force = tvc.elastic_stress_force(st, tnl, tkn, 2).numpy()
    x, y = st["Position"].numpy().T
    interior = (x > 3 * DX) & (x < 11 * DX) & (y > 3 * DX) & (y < 7 * DX)
    assert np.abs(force[interior]).max() < 1e-12
    assert np.abs(force[~interior]).max() > 1e-6
