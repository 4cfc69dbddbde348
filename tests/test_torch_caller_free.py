"""Parity of the port's functions with no case caller (the 3D polar
rotation; general.py's velocity_bound_check / quantity_summation /
vorticity; the cubic B-spline, quadratic, hyperbolic and tabulated
kernels and the adaptive helpers; the linear, FENE Neo-Hookean,
orthotropic, viscoplastic and composite solids) with the JAX package,
on the CPU in float64 on seeded numpy inputs, and the JAX tests they
mirror (tests/test_derived.py, test_kernels.py, test_solid.py:114,130,
test_continuum.py:82) at those tests' own tolerances.

Port against JAX: 1e-12 of max|ref| (float64 roundoff: the rotation, the
stresses and the kernels are a handful of operations; the viscoplastic
return's 40 bisections take the same branches)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sphinxsys_tpu.core import kernels as JK
from sphinxsys_tpu.core import materials as JM
from sphinxsys_tpu.core.adaptation import SPHAdaptation as JAdaptation
from sphinxsys_tpu.neighbors import (build_cell_table as j_table,
                                     build_neighbor_list as j_list,
                                     grid_from_bounds as j_grid)
from sphinxsys_tpu.physics import fsi as jfsi
from sphinxsys_tpu.physics import general as jgd
from sphinxsys_tpu_torch.core import kernels as TK
from sphinxsys_tpu_torch.core import materials as TM
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation as TAdaptation
from sphinxsys_tpu_torch.neighbors.cell_list import (
    build_cell_table as t_table, grid_from_bounds as t_grid)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (
    build_neighbor_list as t_list)
from sphinxsys_tpu_torch.physics import fsi as tfsi
from sphinxsys_tpu_torch.physics import general as tgd

torch.set_num_threads(1)
TOL = 1e-12


def close(got, ref, tol=TOL, what=""):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    scale = max(float(np.abs(ref).max()), 1e-300) if ref.size else 1.0
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    assert err <= tol * scale, f"{what}: {err:.3e} of {scale:.3e}"


# ---------------------------------------------------------------------------
# the polar rotation (physics/fsi.py)
# ---------------------------------------------------------------------------

def _random_F(dim, n=200, seed=3):
    """Seeded F with det > 0: I + noise, rows with det <= 0 flipped."""
    rng = np.random.default_rng(seed)
    F = np.eye(dim)[None] + 0.4 * rng.normal(size=(n, dim, dim))
    bad = np.linalg.det(F) <= 0
    F[bad, 0] *= -1.0
    assert (np.linalg.det(F) > 0).all()
    return F


@pytest.mark.parametrize("dim", [2, 3])
def test_polar_rotation_matches_jax_svd(dim):
    """R of the port (2D closed form, 3D U Vh of torch's SVD) against
    JAX's U Vt, on the normals it rotates, and R orthonormal."""
    F = _random_F(dim)
    n0 = np.random.default_rng(4).normal(size=(len(F), dim))
    n0 /= np.linalg.norm(n0, axis=1, keepdims=True)
    ref = jfsi.update_elastic_normal_direction(
        {"DeformationGradient": jnp.asarray(F),
         "InitialNormalDirection": jnp.asarray(n0)})["NormalDirection"]
    got = tfsi.update_elastic_normal_direction(
        {"DeformationGradient": torch.as_tensor(F),
         "InitialNormalDirection": torch.as_tensor(n0)})["NormalDirection"]
    close(got, ref, what=f"{dim}D normals")
    R = tfsi.polar_rotation(torch.as_tensor(F))
    U, _, Vt = np.linalg.svd(F)
    close(R, U @ Vt, what=f"{dim}D R")
    close(R @ R.transpose(-1, -2), np.broadcast_to(np.eye(dim), R.shape),
          what="R R^T")


# ---------------------------------------------------------------------------
# general.py
# ---------------------------------------------------------------------------

def _rotation_cloud(dtype_np=np.float64):
    """tests/test_derived.py's rigid rotation on the unit square, dx 0.04."""
    dx = 0.04
    xs = (np.arange(25) + 0.5) * dx
    pos = np.stack(np.meshgrid(xs, xs, indexing="ij"), -1).reshape(-1, 2)
    p = pos - 0.5
    vel = 1.7 * np.stack([-p[:, 1], p[:, 0]], -1)
    return pos, vel, dx


def test_vorticity_matches_jax_and_rigid_rotation():
    pos, vel, dx = _rotation_cloud()
    n = len(pos)
    jad, tad = JAdaptation(spacing=dx, dim=2), TAdaptation(spacing=dx, dim=2)
    jg = j_grid((0, 0), (1, 1), jad.cutoff)
    tg = t_grid((0, 0), (1, 1), tad.cutoff)
    jp = jnp.asarray(pos)
    jnl = j_list(jp, jnp.int32(n), jp, jnp.int32(n),
                 j_table(jp, jnp.int32(n), jg, cap=32), jg, jad.cutoff,
                 k_max=48, include_self=False)
    tp = torch.as_tensor(pos)
    tnl = t_list(tp, n, tp, n, t_table(tp, n, tg, 32), tg, tad.cutoff,
                 k_max=48, include_self=False)
    np.testing.assert_array_equal(tnl.idx.numpy(), np.asarray(jnl.idx))
    vol = np.full(n, dx * dx)
    jst = {"Position": jp, "Velocity": jnp.asarray(vel),
           "VolumetricMeasure": jnp.asarray(vol), "NReal": jnp.int32(n)}
    tst = {"Position": tp, "Velocity": torch.as_tensor(vel),
           "VolumetricMeasure": torch.as_tensor(vol), "NReal": n}
    ref = jgd.vorticity(jst, jnl, jad.kernel, 2)
    got = tgd.vorticity(tst, tnl, tad.kernel, 2)
    close(got, ref, what="vorticity")
    # tests/test_derived.py:37: curl of omega x r is 2 omega inside, 5%
    interior = ((pos - 0.5 > -0.35) & (pos - 0.5 < 0.35)).all(axis=1)
    np.testing.assert_allclose(got.numpy()[interior], 2 * 1.7, rtol=0.05)


def test_vorticity_3d_matches_jax():
    rng = np.random.default_rng(8)
    dx = 0.1
    xs = np.arange(6) * dx
    pos = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1).reshape(-1, 3)
    pos = pos + 0.01 * rng.normal(size=pos.shape)
    vel = rng.normal(size=pos.shape)
    n = len(pos)
    jad, tad = JAdaptation(spacing=dx, dim=3), TAdaptation(spacing=dx, dim=3)
    jg = j_grid((-0.1,) * 3, (0.7,) * 3, jad.cutoff)
    tg = t_grid((-0.1,) * 3, (0.7,) * 3, tad.cutoff)
    jp, tp = jnp.asarray(pos), torch.as_tensor(pos)
    jnl = j_list(jp, jnp.int32(n), jp, jnp.int32(n),
                 j_table(jp, jnp.int32(n), jg, cap=64), jg, jad.cutoff,
                 k_max=96, include_self=False)
    tnl = t_list(tp, n, tp, n, t_table(tp, n, tg, 64), tg, tad.cutoff,
                 k_max=96, include_self=False)
    vol = np.full(n, dx ** 3)
    ref = jgd.vorticity({"Position": jp, "Velocity": jnp.asarray(vel),
                         "VolumetricMeasure": jnp.asarray(vol)}, jnl,
                        jad.kernel, 3)
    got = tgd.vorticity({"Position": tp, "Velocity": torch.as_tensor(vel),
                         "VolumetricMeasure": torch.as_tensor(vol)}, tnl,
                        tad.kernel, 3)
    close(got, ref, what="3D vorticity")


def test_von_mises_uniaxial_matches_jax():
    """tests/test_derived.py:44: a small shear gamma gives a von Mises
    stress of sqrt(3) G gamma and a strain of gamma / sqrt(3) (1e-2); the
    port's against JAX's at 1e-12."""
    from sphinxsys_tpu.physics import solid as jsd
    from sphinxsys_tpu_torch.physics import solid as tsd

    kw = dict(rho0=1e3, youngs_modulus=2e6, poisson_ratio=0.3)
    jm, tm = JM.SaintVenantKirchhoffSolid(**kw), TM.SaintVenantKirchhoffSolid(**kw)
    gamma = 1e-4
    F = np.asarray([[[1.0, gamma], [0.0, 1.0]]])
    vm = tsd.von_mises_stress({"DeformationGradient": torch.as_tensor(F)}, tm)
    close(vm, jsd.von_mises_stress({"DeformationGradient": jnp.asarray(F)}, jm))
    np.testing.assert_allclose(float(vm[0]), np.sqrt(3) * tm.shear_modulus
                               * gamma, rtol=1e-2)
    ve = tsd.von_mises_strain({"DeformationGradient": torch.as_tensor(F)})
    close(ve, jsd.von_mises_strain({"DeformationGradient": jnp.asarray(F)}))
    np.testing.assert_allclose(float(ve[0]), gamma / np.sqrt(3), rtol=1e-2)


def test_quantity_summation_and_velocity_bound():
    """tests/test_derived.py:67 (the third row is past NReal), also with an
    Alive mask, a scalar field, and the bound check both ways."""
    F = np.asarray([[1.0, 2.0], [3.0, 4.0], [100.0, 100.0]])
    tst = {"NReal": 2, "Position": torch.zeros((3, 2), dtype=torch.float64),
           "F": torch.as_tensor(F), "s": torch.as_tensor(F[:, 0]),
           "Velocity": torch.as_tensor([[0.1, 0.0], [0.0, 2.0], [9.0, 9.0]])}
    np.testing.assert_allclose(tgd.quantity_summation(tst, "F").numpy(),
                               [4.0, 6.0])
    assert float(tgd.quantity_summation(tst, "s")) == 4.0
    alive = dict(tst, Alive=torch.tensor([True, False, True]))
    np.testing.assert_allclose(tgd.quantity_summation(alive, "F").numpy(),
                               [101.0, 102.0])
    jst = {"NReal": jnp.int32(2), "Position": jnp.zeros((3, 2)),
           "Velocity": jnp.asarray(tst["Velocity"].numpy())}
    for bound in (1.5, 2.5, 20.0):
        assert bool(tgd.velocity_bound_check(tst, bound)) == \
            bool(jgd.velocity_bound_check(jst, bound))
    assert bool(tgd.velocity_bound_check(tst, 1.5))
    assert not bool(tgd.velocity_bound_check(tst, 2.5))


# ---------------------------------------------------------------------------
# kernels.py (tests/test_kernels.py)
# ---------------------------------------------------------------------------

KERNELS = ("WendlandC2", "CubicBSpline", "Quadratic", "Hyperbolic")


@pytest.mark.parametrize("name", KERNELS)
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_kernel_matches_jax(name, dim):
    """W, dW, d2W and the adaptive W / dW against JAX's at float64
    roundoff over the support and past it."""
    jk, tk = getattr(JK, name)(h=0.7), getattr(TK, name)(h=0.7)
    r = np.linspace(0.0, 1.2 * jk.cutoff, 397)
    jr, tr = jnp.asarray(r), torch.as_tensor(r)
    for fn in ("W", "dW", "d2W"):
        close(getattr(tk, fn)(tr, dim), getattr(jk, fn)(jr, dim),
              what=f"{name} {fn}")
    ratio = np.linspace(1.0, 2.0, 397)
    close(TK._adaptive_W(tk, tr, torch.as_tensor(ratio), dim),
          JK._adaptive_W(jk, jr, jnp.asarray(ratio), dim), what="adaptive W")
    close(TK._adaptive_dW(tk, tr, torch.as_tensor(ratio), dim),
          JK._adaptive_dW(jk, jr, jnp.asarray(ratio), dim), what="adaptive dW")
    assert tk.w0(dim) == pytest.approx(jk.w0(dim), rel=1e-15)


@pytest.mark.parametrize("name", KERNELS[:3])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_kernel_unity_and_derivative(name, dim):
    """tests/test_kernels.py:13-51: the integral of W is 1 within 2e-3 (the
    quadratic kernel is normalised in 3D only), dW is W's derivative."""
    k = getattr(TK, name)(h=0.7)
    if not (name == "Quadratic" and dim != 3):
        n = 400
        r = (np.arange(n) + 0.5) * (k.cutoff / n)
        w = k.W(torch.as_tensor(r), dim).numpy()
        dr = k.cutoff / n
        shell = {1: 2.0 * np.ones_like(r), 2: 2.0 * np.pi * r,
                 3: 4.0 * np.pi * r ** 2}[dim]
        assert abs(np.sum(w * shell) * dr - 1.0) < 2e-3
    k = getattr(TK, name)(h=1.1)
    r = np.linspace(0.05, k.cutoff * 0.98, 50)
    eps = 1e-4
    fd_ = (k.W(torch.as_tensor(r + eps), dim)
           - k.W(torch.as_tensor(r - eps), dim)).numpy() / (2 * eps)
    np.testing.assert_allclose(k.dW(torch.as_tensor(r), dim).numpy(), fd_,
                               rtol=2e-3, atol=1e-5)


def test_compact_support_and_hyperbolic_normalised():
    """tests/test_kernels.py:54-59 and :87-112 (the hyperbolic part)."""
    k = TK.WendlandC2(h=1.0)
    assert float(k.W(torch.tensor(2.0001), 2)) == 0.0
    assert float(k.dW(torch.tensor(2.0001), 2)) == 0.0
    assert float(k.W(torch.tensor(1.9999), 2)) > 0.0
    k = TK.Hyperbolic(h=1.0)
    r = np.linspace(1e-6, k.cutoff, 4001)
    w = [k.W(torch.as_tensor(r), d).numpy() for d in (1, 2, 3)]
    got = [np.trapezoid(2 * w[0], r), np.trapezoid(2 * np.pi * r * w[1], r),
           np.trapezoid(4 * np.pi * r ** 2 * w[2], r)]
    np.testing.assert_allclose(got, 1.0, rtol=2e-3)


@pytest.mark.parametrize("base", ["WendlandC2", "CubicBSpline"])
def test_tabulated_kernel_matches_jax_and_analytic(base):
    """The table against JAX's at roundoff; and tests/test_kernels.py:
    115-128, the table against the analytic kernel."""
    jk = JK.TabulatedKernel(getattr(JK, base)(h=0.013), resolution=40)
    tk = TK.TabulatedKernel(getattr(TK, base)(h=0.013), resolution=40)
    ak = getattr(TK, base)(h=0.013)
    r = np.linspace(0.0, 1.1 * ak.cutoff, 333)
    tr = torch.as_tensor(r)
    for dim in (2, 3):
        for fn in ("W", "dW", "d2W"):
            close(getattr(tk, fn)(tr, dim), getattr(jk, fn)(jnp.asarray(r), dim),
                  what=f"tabulated {fn}")
        np.testing.assert_allclose(tk.W(tr, dim).numpy(), ak.W(tr, dim).numpy(),
                                   rtol=1e-4, atol=1e-4 * ak.w0(dim))
        dw_scale = abs(float(ak.dW(torch.tensor(0.5 * ak.h, dtype=torch.float64),
                                   dim)))
        np.testing.assert_allclose(tk.dW(tr, dim).numpy(),
                                   ak.dW(tr, dim).numpy(), rtol=1e-3,
                                   atol=2e-3 * dw_scale)
    assert float(tk.W(torch.tensor(1.01 * ak.cutoff, dtype=torch.float64),
                      2)) == 0.0


# ---------------------------------------------------------------------------
# materials.py
# ---------------------------------------------------------------------------

def _F_batch(dim, seed=5, n=64, amp=0.05):
    rng = np.random.default_rng(seed)
    return np.eye(dim)[None] + amp * rng.normal(size=(n, dim, dim))


ELASTIC = {
    "LinearElasticSolid": dict(rho0=1.0, youngs_modulus=1.0e3,
                               poisson_ratio=0.3),
    "FeneNeoHookeanSolid": dict(rho0=1.0, youngs_modulus=1.0e3,
                                poisson_ratio=0.3, j1_m=10.0),
    "OrthotropicSolid": dict(
        rho0=1.0, a=((1.0, 0.0, 0.0), (0.0, 0.6, 0.8), (0.0, -0.8, 0.6)),
        E=(4.0e3, 1.0e3, 2.0e3), G=(400.0, 300.0, 500.0),
        poisson=(0.2, 0.25, 0.3)),
}


@pytest.mark.parametrize("name,dim", [(k, d) for k in ELASTIC for d in (2, 3)
                                      if not (k == "OrthotropicSolid"
                                              and d == 2)])
def test_elastic_solids_match_jax(name, dim):
    """(The orthotropic solid is 3D only, as the reference's.)"""
    jm, tm = getattr(JM, name)(**ELASTIC[name]), getattr(TM, name)(**ELASTIC[name])
    F = _F_batch(dim)
    close(tm.stress_PK2(torch.as_tensor(F)), jm.stress_PK2(jnp.asarray(F)),
          what=name)
    for attr in ("youngs_modulus", "poisson_ratio", "sound_speed",
                 "shear_modulus", "lambda0"):
        assert getattr(tm, attr) == pytest.approx(getattr(jm, attr), rel=1e-15)


def test_fene_and_orthotropic_mirror_jax_tests():
    """tests/test_solid.py:114-143."""
    m = TM.FeneNeoHookeanSolid(rho0=1.0, youngs_modulus=1.0e3,
                               poisson_ratio=0.3, j1_m=10.0)
    S = m.stress_PK2(torch.eye(3, dtype=torch.float64)[None] * 1.001)[0]
    np.testing.assert_allclose(S.numpy(), S.numpy().T, rtol=1e-5)
    assert float(S[0, 0]) > 0.0
    S2 = m.stress_PK2(torch.eye(3, dtype=torch.float64)[None] * 1.5)[0]
    assert float(S2[0, 0]) > 10.0 * float(S[0, 0])

    o = TM.OrthotropicSolid(rho0=1.0, E=(4.0e3, 1.0e3, 1.0e3),
                            G=(400.0, 400.0, 400.0), poisson=(0.2, 0.2, 0.2))
    eps = 1e-3
    Fx = torch.eye(3, dtype=torch.float64)[None].clone()
    Fy = Fx.clone()
    Fx[0, 0, 0] += eps
    Fy[0, 1, 1] += eps
    assert float(o.stress_PK2(Fx)[0, 0, 0]) > 2.0 * float(o.stress_PK2(Fy)[0, 1, 1])
    S0 = o.stress_PK2(torch.eye(3, dtype=torch.float64)[None])[0]
    np.testing.assert_allclose(S0.numpy(), 0.0, atol=1e-8)


VP = dict(rho0=1.0, youngs_modulus=10.0, poisson_ratio=0.3, yield_stress=0.05,
          herschel_bulkley_power=1.0)


@pytest.mark.parametrize("eta,gamma", [(1.0, 0.001), (1e-8, 0.5), (1.0, 0.5),
                                       (1e8, 0.5)])
def test_viscous_plastic_matches_jax(eta, gamma):
    """The return mapping of a batch of sheared F (and the single F of
    tests/test_continuum.py:82) against JAX's, all three outputs."""
    jm = JM.ViscousPlasticSolid(viscous_modulus=eta, **VP)
    tm = TM.ViscousPlasticSolid(viscous_modulus=eta, **VP)
    F = _F_batch(2, seed=6, amp=0.02)
    F[:, 0, 1] += gamma
    F[0] = [[1.0, gamma], [0.0, 1.0]]
    ips = np.broadcast_to(np.eye(2), F.shape).copy()
    kappa = np.zeros(len(F))
    ref = jm.elastic_left_cauchy(jnp.asarray(F), jnp.asarray(ips),
                                 jnp.asarray(kappa), dt=1e-3)
    got = tm.elastic_left_cauchy(torch.as_tensor(F), torch.as_tensor(ips),
                                 torch.as_tensor(kappa), dt=1e-3)
    for g, r, what in zip(got, ref, ("be", "inv_ps", "kappa")):
        close(g, r, what=what)


def test_viscous_plastic_limits():
    """tests/test_continuum.py:82-120: below yield nothing relaxes; at
    eta -> 0 the return reaches the yield surface (within 15%); at
    eta -> inf the trial state stays."""
    import math

    def run(eta, gamma, dt=1e-3):
        m = TM.ViscousPlasticSolid(viscous_modulus=eta, **VP)
        F = torch.tensor([[[1.0, gamma], [0.0, 1.0]]], dtype=torch.float64)
        ips = torch.eye(2, dtype=torch.float64)[None]
        nbe, ips2, _ = m.elastic_left_cauchy(F, ips, torch.zeros(1,
                                             dtype=torch.float64), dt=dt)
        dev = m.shear_modulus * (nbe[0] - (torch.trace(nbe[0]) / 2.0)
                                 * torch.eye(2, dtype=torch.float64))
        return m, float(torch.linalg.norm(dev)), ips2

    sqrt23 = math.sqrt(2.0 / 3.0)
    _, _, ips2 = run(1.0, 0.001)
    np.testing.assert_allclose(ips2[0].numpy(), np.eye(2), atol=1e-5)
    m, s, _ = run(1e-8, 0.5)
    assert abs(s - sqrt23 * m.yield_stress) < 0.15 * sqrt23 * m.yield_stress
    m, s_frozen, _ = run(1e8, 0.5)
    _, s_fast, _ = run(1e-8, 0.5)
    assert s_frozen > 2.0 * s_fast


def test_composite_solid_matches_jax():
    kw = [dict(rho0=1.0, youngs_modulus=1.0e3, poisson_ratio=0.3),
          dict(rho0=2.5, youngs_modulus=4.0e3, poisson_ratio=0.45)]
    jc = JM.CompositeSolid(rho0=1.0, materials=(
        JM.LinearElasticSolid(**kw[0]), JM.NeoHookeanSolid(**kw[1])))
    tc = TM.CompositeSolid(rho0=1.0, materials=(
        TM.LinearElasticSolid(**kw[0]), TM.NeoHookeanSolid(**kw[1])))
    F = _F_batch(3, seed=9)
    ids = np.random.default_rng(10).integers(0, 2, size=len(F)).astype(np.int32)
    close(tc.stress_PK2_composite(torch.as_tensor(F), torch.as_tensor(ids)),
          jc.stress_PK2_composite(jnp.asarray(F), jnp.asarray(ids)),
          what="composite PK2")
    np.testing.assert_array_equal(
        tc.composite_density(torch.as_tensor(ids)).numpy(),
        np.asarray(jc.composite_density(jnp.asarray(ids))))
    assert tc.sound_speed == pytest.approx(jc.sound_speed, rel=1e-15)
    assert tc.youngs_modulus == pytest.approx(jc.youngs_modulus, rel=1e-15)
