"""Parity of the port's remaining elastic-solid laws with the JAX package,
on the CPU in float64: `Muscle.stress_PK2` (2D and 3D, random fibre and
sheet directions and all four invariant terms), `stress_cauchy` of the
linear and Neo-Hookean solids, `cauchy_pk1_fn`, `active_fiber_stress` and
the `active_stress_fn` hook of `integration_1st_half_pk2`, and
`AnisotropicKernel`'s `W_disp` / `grad_W` (which at k = (1, 1) is
WendlandC2's dW e).  Deformation gradients are I plus seeded noise; every
output is held within 1e-12 of its max|ref|.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sphinxsys_tpu.core import kernels as jk
from sphinxsys_tpu.core import materials as jmat
from sphinxsys_tpu.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_tpu.physics import solid as jsd
from sphinxsys_tpu_torch import convert
from sphinxsys_tpu_torch.core import kernels as tk, linalg
from sphinxsys_tpu_torch.core import materials as tmat
from sphinxsys_tpu_torch.physics import solid as tsd

torch.set_num_threads(1)

TOL = 1e-12


def _close(got, ref, tol=TOL, what=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-300), (what, err)


def _F(dim, n=64, scale=0.15, seed=1):
    rng = np.random.default_rng(seed)
    return np.eye(dim) + scale * rng.normal(size=(n, dim, dim))


def _unit(v):
    return tuple(float(x) for x in v / np.linalg.norm(v))


def _muscles(dim, seed=2):
    """A muscle with random orthogonal fibre / sheet directions and all
    four terms on (the passive cantilever's and the activated cube's have
    a1 = a2 = a3 = 0)."""
    rng = np.random.default_rng(seed)
    f = rng.normal(size=dim)
    s = rng.normal(size=dim)
    s = s - f * (s @ f) / (f @ f)
    kw = dict(rho0=1.1, bulk_modulus_param=40.0, f0=_unit(f), s0=_unit(s),
              a0=(0.6, 0.4, 0.3, 0.2), b0=(1.5, 2.0, 1.2, 0.8))
    return jmat.Muscle(**kw), tmat.Muscle(**kw)


@pytest.mark.parametrize("dim", (2, 3))
def test_muscle_stress_matches_jax(dim):
    jm, tm = _muscles(dim)
    F = _F(dim)
    _close(tm.stress_PK2(torch.as_tensor(F)), jm.stress_PK2(jnp.asarray(F)),
           what="PK2")
    assert tm.sound_speed == jm.sound_speed and tm.lambda0 == jm.lambda0


def test_muscle_cases_materials_match_jax():
    """The two 3D cases' laws: fibre x, sheet y, the cantilever's shear
    a0 and the cube's b0 = 8.023 (exp(b0 I_1) grows fast)."""
    from sphinxsys_tpu.cases import muscle_activation_3d as jma
    from sphinxsys_tpu.cases import passive_cantilever_3d as jpc

    for case in (jma, jpc):
        kw = dict(rho0=case.RHO0, bulk_modulus_param=case.BULK,
                  f0=(1.0, 0.0, 0.0), s0=(0.0, 1.0, 0.0),
                  a0=getattr(case, "A0", (getattr(case, "A_ISO", 0.0), 0.0,
                                          0.0, 0.0)),
                  b0=getattr(case, "B0", (1.0, 0.0, 0.0, 0.0)))
        F = _F(3, scale=0.1)
        _close(tmat.Muscle(**kw).stress_PK2(torch.as_tensor(F)),
               jmat.Muscle(**kw).stress_PK2(jnp.asarray(F)), what=case)


@pytest.mark.parametrize("dim", (2, 3))
@pytest.mark.parametrize("law", ("linear", "neohookean"))
def test_cauchy_stress_and_pk1_match_jax(dim, law):
    kw = dict(rho0=1000.0, youngs_modulus=2e6, poisson_ratio=0.3975)
    jm, tm = ((jmat.ElasticSolid(**kw), tmat.SaintVenantKirchhoffSolid(**kw))
              if law == "linear" else
              (jmat.NeoHookeanSolid(**kw), tmat.NeoHookeanSolid(**kw)))
    F = _F(dim, scale=0.1)
    eps = 0.5 * (np.eye(dim) - np.linalg.inv(F @ np.swapaxes(F, -1, -2)))
    _close(tm.stress_cauchy(torch.as_tensor(eps)),
           jm.stress_cauchy(jnp.asarray(eps)), what="sigma")
    _close(tsd.cauchy_pk1_fn(tm)({}, torch.as_tensor(F)),
           jsd.cauchy_pk1_fn(jm)({}, jnp.asarray(F)), what="PK1")


def test_cauchy_pk1_tracks_pk2_at_small_strain():
    """Saint Venant-Kirchhoff: the Cauchy and PK2 routes agree to first
    order in the strain."""
    m = tmat.SaintVenantKirchhoffSolid(1000.0, 2e6, 0.3975)
    F = torch.as_tensor(_F(2, scale=1e-4))
    p_cauchy = tsd.cauchy_pk1_fn(m)({}, F)
    p_pk2 = linalg.mm(F, m.stress_PK2(F))
    assert float((p_cauchy - p_pk2).abs().max()) \
        < 1e-3 * float(p_pk2.abs().max())


def _frozen_block(dim, seed=3):
    """A jittered block, JAX's frozen pairs and B, its state with random
    velocities, F, dF/dt, Ta and fibres; the port's carried across."""
    rng = np.random.default_rng(seed)
    dx = 0.1
    axes = [np.arange(n) * dx for n in ((8, 6) if dim == 2 else (5, 4, 4))]
    pos = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, dim)
    pos = pos + 0.1 * dx * (rng.random(pos.shape) - 0.5)
    jm, tm = _muscles(dim)
    js = dict(jsd.make_elastic_solid_state(jnp.asarray(pos), dx ** dim, jm,
                                           dtype=jnp.float64))
    n = len(pos)
    h = 1.3 * dx
    grid = grid_from_bounds(pos.min(0) - 0.5, pos.max(0) + 0.5, 2 * h)
    table = build_cell_table(js["Position"], n, grid, cap=48)
    nl = build_neighbor_list(js["Position"], n, js["Position"], n, table,
                             grid, 2 * h, k_max=80, include_self=False)
    assert not bool(nl.overflow)
    jkern = jk.WendlandC2(h=h)
    rp = jsd.freeze_reference_pairs(js["Position"], nl, jkern, dim)
    js["LinearGradientCorrectionMatrix"] = \
        jsd.linear_gradient_correction_matrix(rp, js["VolumetricMeasure"])
    fib = rng.normal(size=(n, dim))
    extra = {"Velocity": 0.5 * rng.normal(size=(n, dim)),
             "DeformationGradient": _F(dim, n, 0.05, seed + 1),
             "DeformationRate": 0.3 * rng.normal(size=(n, dim, dim)),
             "ForcePrior": 1e-3 * rng.normal(size=(n, dim)),
             "ActiveContractionStress": rng.normal(size=n),
             "Fiber": fib / np.linalg.norm(fib, axis=1, keepdims=True)}
    js.update({k: jnp.asarray(v) for k, v in extra.items()})
    ts = convert.state_from_numpy({k: np.asarray(v) for k, v in js.items()})
    trp = tsd.ReferencePairs(*(torch.as_tensor(np.array(x)) for x in rp))
    return (js, rp, jm, jkern), (ts, trp, tm, tk.WendlandC2(h=h)), h


@pytest.mark.parametrize("dim", (2, 3))
def test_active_stress_hook_matches_jax(dim):
    (js, rp, jm, jkern), (ts, trp, tm, tkern), h = _frozen_block(dim)
    _close(tsd.active_fiber_stress(ts, None),
           jsd.active_fiber_stress()(js, None), what="S_active")
    dt = 1e-4
    ref = jsd.integration_1st_half_pk2(
        js, rp, jm, dt, h, jkern.w0(dim),
        active_stress_fn=jsd.active_fiber_stress())
    got = tsd.integration_1st_half_pk2(
        ts, trp, tm, dt, h, tkern.w0(dim),
        active_stress_fn=tsd.active_fiber_stress)
    for k in ("Force", "Velocity", "StressPK1OnParticle", "Density",
              "Position", "DeformationGradient"):
        _close(got[k], ref[k], what=k)
    passive = tsd.integration_1st_half_pk2(ts, trp, tm, dt, h, tkern.w0(dim))
    assert float((passive["Force"] - got["Force"]).abs().max()) > 0.0


def test_cauchy_integrator_matches_jax():
    (js, rp, _, jkern), (ts, trp, _, tkern), h = _frozen_block(2)
    kw = dict(rho0=1000.0, youngs_modulus=2e6, poisson_ratio=0.3975)
    jm, tm = jmat.SaintVenantKirchhoffSolid(**kw), \
        tmat.SaintVenantKirchhoffSolid(**kw)
    ref = jsd.integration_1st_half_pk2(js, rp, jm, 1e-5, h, jkern.w0(2),
                                       pk1_fn=jsd.cauchy_pk1_fn(jm))
    got = tsd.integration_1st_half_pk2(ts, trp, tm, 1e-5, h, tkern.w0(2),
                                       pk1_fn=tsd.cauchy_pk1_fn(tm))
    for k in ("Force", "Velocity", "StressPK1OnParticle"):
        _close(got[k], ref[k], what=k)


def _displacements(dim, n=400, seed=4, span=0.6):
    rng = np.random.default_rng(seed)
    d = rng.uniform(-span, span, size=(n, dim))
    d[0] = 0.0                       # the self pair
    return d


@pytest.mark.parametrize("kv", ((4.0, 1.0), (1.0, 2.5), (2.0, 1.5, 0.5)))
def test_anisotropic_kernel_matches_jax(kv):
    h = 0.026
    dim = len(kv)
    jkern = jk.AnisotropicKernel(jk.WendlandC2(h=h), kv)
    tkern = tk.AnisotropicKernel(tk.WendlandC2(h=h), kv)
    d = _displacements(dim, span=2.2 * h * max(kv))
    jd, td = jnp.asarray(d), torch.as_tensor(d)
    _close(tkern.transformed_q(td), jkern.transformed_q(jd), what="q")
    np.testing.assert_array_equal(tkern.within_cutoff(td).numpy(),
                                  np.asarray(jkern.within_cutoff(jd)))
    _close(tkern.W_disp(td, dim), jkern.W_disp(jd, dim), what="W")
    _close(tkern.grad_W(td, dim), jkern.grad_W(jd, dim), what="grad W")
    inside = tkern.within_cutoff(td)
    assert 0 < int(inside.sum()) < len(d)
    assert float(tkern.grad_W(td, dim)[0].abs().max()) == 0.0
    assert tkern.h == h and tkern.kernel_size == 2.0


def test_anisotropic_kernel_is_wendland_at_unit_stretch():
    h = 0.013
    iso = tk.WendlandC2(h=h)
    kern = tk.AnisotropicKernel(iso, (1.0, 1.0))
    d = torch.as_tensor(_displacements(2, span=2.5 * h)[1:])
    r = torch.sqrt((d * d).sum(-1))
    e = d / r[:, None]
    _close(kern.grad_W(d, 2), iso.dW(r, 2)[:, None] * e, 1e-13, "grad W")
    _close(kern.W_disp(d, 2), iso.W(r, 2), 1e-13, "W")
