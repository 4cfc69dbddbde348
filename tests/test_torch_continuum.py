"""Parity of the port's continuum family with the JAX package, on the CPU
in float64: physics/continuum.py (the Drucker-Prager and J2 materials, the
plastic halves, the stress diffusion, the updated-Lagrangian solid's
correction matrix and hourglass halves), the fluid's `extra_force` and
`surface_projection`, and `geometry.Cylinder`.

Inputs come from a numpy seed: a jittered lattice in 2D (14 x 10 at
dx = 0.1) and 3D (6 x 5 x 4) with one isolated particle (no neighbour:
A = 0, B = 0 on both sides), over a wall strip of three layers with random
normals, velocities and accelerations.  Stresses are drawn so that each
branch of each law is taken by some rows: the Drucker-Prager tension
cut-off, yielding and elastic rows; J2 rows on both sides of f > TINY.
JAX's neighbour lists are carried across, so both sides sum the same
slots, and the JAX functions are jitted whole.  Every output is held
within 1e-12 of its max |JAX|.
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sphinxsys_tpu.core import geometry as jgeo
from sphinxsys_tpu.core import kernels as jk
from sphinxsys_tpu.core import materials as jmat
from sphinxsys_tpu.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_tpu.physics import continuum as jcn
from sphinxsys_tpu.physics import fluid as jfd
from sphinxsys_tpu.physics import riemann as jrs
from sphinxsys_tpu_torch import convert
from sphinxsys_tpu_torch.core import geometry as tgeo
from sphinxsys_tpu_torch.core import kernels as tk
from sphinxsys_tpu_torch.core import materials as tmat
from sphinxsys_tpu_torch.physics import continuum as tcn
from sphinxsys_tpu_torch.physics import fluid as tfd
from sphinxsys_tpu_torch.physics import riemann as trs

torch.set_num_threads(1)

TOL = 1e-12
DX = 0.1
H = 1.3 * DX
DT = 1.0e-3
# the materials of both packages: Drucker-Prager without and with
# cohesion (and dilatancy), J2 without and with hardening
DP = dict(rho0=1.0, c0=20.0, youngs_modulus=400.0, poisson_ratio=0.3,
          friction_angle=0.4)
DP_COHESIVE = dict(DP, cohesion=3.0, dilatancy=0.1)
J2 = dict(rho0=1.0, c0=20.0, youngs_modulus=400.0, poisson_ratio=0.3,
          yield_stress=2.0)
J2_HARD = dict(J2, hardening_modulus=50.0)


def close(got, ref, tol=TOL, what=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max(initial=0.0)
    assert err <= tol * max(np.abs(ref).max(initial=0.0), 1e-300), (what,
                                                                      err)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _sym(rng, n, d, scale):
    a = rng.normal(size=(n, d, d)) * scale[:, None, None]
    return 0.5 * (a + a.transpose(0, 2, 1))


def _dp_stresses(rng, n):
    """3 x 3 stresses: a third in tension (I1 > 0), a third compressed with
    a small deviator (elastic), a third compressed with a large one."""
    p = np.where(np.arange(n) % 3 == 0, -30.0, 8.0) * (1 + rng.random(n))
    dev_scale = np.where(np.arange(n) % 3 == 1, 0.1, 6.0)
    dev = _sym(rng, n, 3, dev_scale)
    dev -= np.trace(dev, axis1=1, axis2=2)[:, None, None] / 3 * np.eye(3)
    return dev - p[:, None, None] * np.eye(3)


def _scene(dim, seed=0):
    """(body, wall) numpy states and the grid."""
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
            "ForcePrior": 0.01 * rng.normal(size=(n, dim))
            + np.eye(dim)[1] * -9.8 * DX ** dim,
            "Pressure": rng.normal(size=n),
            "StressTensor3D": _dp_stresses(rng, n),
            "StressRate3D": _sym(rng, n, 3, np.full(n, 5.0)),
            "StrainTensor3D": _sym(rng, n, 3, np.full(n, 0.01)),
            "VelocityGradient3D": rng.normal(size=(n, 3, 3)),
            "ShearStress": _sym(rng, n, dim, np.where(np.arange(n) % 2,
                                                      0.2, 3.0)),
            "StrainTensor": _sym(rng, n, dim, np.full(n, 0.01)),
            "VelocityGradient": rng.normal(size=(n, dim, dim)),
            "AccHourglass": rng.normal(size=(n, dim)),
            "AccShear": rng.normal(size=(n, dim)),
            "LinearGradientCorrectionMatrix": np.eye(dim)
            + 0.1 * rng.normal(size=(n, dim, dim)),
            "HardeningFactor": 0.01 * rng.random(n),
            "ScalePenaltyForce": 2.0 * rng.random(n),
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
            "AverageVelocity": 0.3 * rng.normal(size=(nw, dim)),
            "AverageAcceleration": 2.0 * rng.normal(size=(nw, dim)),
            "NReal": np.int32(nw)}
    hi = tuple(float(x) for x in pos.max(0) + DX)
    lo = (0.0, -0.5, *(-0.5 * np.ones(dim - 2)))
    return body, wall, grid_from_bounds(lo, hi, 2 * H)


@functools.lru_cache(maxsize=None)
def scene(dim):
    """JAX's (body, wall, inner list, wall list) and the port's, the
    surface indication of JAX's free_surface_indication carried in both."""
    body, wall, grid = _scene(dim)
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
    jb = {k: jnp.asarray(v) for k, v in body.items()}
    ind = jax.jit(lambda b: jfd.free_surface_indication(
        b, nl, jk.WendlandC2(h=H), dim))(jb)
    for k in ("Indicator", "PositionDivergence"):
        body[k] = np.asarray(ind[k])
        jb[k] = ind[k]
    jw = {k: jnp.asarray(v) for k, v in wall.items()}
    tb, tw = convert.state_from_numpy(body), convert.state_from_numpy(wall)
    tnl, tnlw = (convert.neighbor_list_from_numpy(x) for x in (nl, nlw))
    return (jb, jw, nl, nlw), (tb, tw, tnl, tnlw)


def kernels():
    return jk.WendlandC2(h=H), tk.WendlandC2(h=H)


def hold_state(t, j, keys, what=""):
    for k in keys:
        close(t[k], j[k], what=(what, k))


# ---------------------------------------------------------------------------
# the materials
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", (DP, DP_COHESIVE), ids=("dp", "cohesive"))
def test_plastic_continuum_constants(kw):
    j, t = jcn.PlasticContinuum(**kw), tcn.PlasticContinuum(**kw)
    for k in ("alpha_phi", "k_c", "alpha_psi", "shear_modulus",
              "bulk_modulus"):
        assert getattr(t, k) == getattr(j, k), k
    assert t.sound_speed() == j.sound_speed() == kw["c0"]
    # what the fluid time step and the Riemann solvers read
    assert tcn.GeneralContinuum(rho0=2.0, c0=3.0).sound_speed(1, 2) == 3.0
    assert trs.acoustic_riemann(t).rho0c0_i == jrs.acoustic_riemann(j).rho0c0_i


@pytest.mark.parametrize("kw", (DP, DP_COHESIVE), ids=("dp", "cohesive"))
def test_constitutive_relation_matches_jax(kw):
    rng = np.random.default_rng(1)
    n = 300
    sig = _dp_stresses(rng, n)
    L = 0.5 * rng.normal(size=(n, 3, 3))
    j, t = jcn.PlasticContinuum(**kw), tcn.PlasticContinuum(**kw)
    ref = jax.jit(j.constitutive_relation)(jnp.asarray(L), jnp.asarray(sig))
    close(t.constitutive_relation(_t(L), _t(sig)), ref)
    # both sides of f >= TINY are taken
    tr = np.trace(sig, axis1=1, axis2=2)
    dev = sig - tr[:, None, None] / 3 * np.eye(3)
    f = np.sqrt(0.5 * (dev * dev).sum((1, 2)) + 1e-15) \
        + t.alpha_phi * tr - t.k_c
    assert (f >= 1e-15).sum() > 10 and (f < 1e-15).sum() > 10


@pytest.mark.parametrize("kw", (DP, DP_COHESIVE), ids=("dp", "cohesive"))
def test_return_mapping_matches_jax(kw):
    rng = np.random.default_rng(2)
    sig = _dp_stresses(rng, 300)
    j, t = jcn.PlasticContinuum(**kw), tcn.PlasticContinuum(**kw)
    ref = jax.jit(j.return_mapping)(jnp.asarray(sig))
    close(t.return_mapping(_t(sig)), ref)
    I1 = np.trace(sig, axis1=1, axis2=2)
    tension = -t.alpha_phi * I1 + t.k_c < 0
    out = np.asarray(ref)
    moved = np.abs(out - sig).max((1, 2)) > 0
    # the tension cut-off, the yielding and the elastic rows all occur
    assert tension.sum() > 10 and (moved & ~tension).sum() > 10
    assert (~moved).sum() > 10


@pytest.mark.parametrize("dim", (2, 3))
@pytest.mark.parametrize("kw", (J2, J2_HARD), ids=("j2", "hardening"))
def test_j2_plasticity_matches_jax(dim, kw):
    rng = np.random.default_rng(3)
    n = 200
    s = _sym(rng, n, dim, np.where(np.arange(n) % 2, 0.3, 4.0))
    k = 0.05 * rng.random(n)
    L = rng.normal(size=(n, dim, dim))
    j, t = jcn.J2Plasticity(**kw), tcn.J2Plasticity(**kw)
    js, jk_, jL = jnp.asarray(s), jnp.asarray(k), jnp.asarray(L)
    ts, tk_, tL = _t(s), _t(k), _t(L)
    for got, ref in zip(t._yield_f(ts, tk_), jax.jit(j._yield_f)(js, jk_)):
        close(got, ref, what="_yield_f")
    close(t.shear_rate_with_hardening(tL, ts, tk_),
          jax.jit(j.shear_rate_with_hardening)(jL, js, jk_))
    for name in ("hardening_factor_rate", "scale_penalty_force",
                 "return_mapping_shear_stress"):
        close(getattr(t, name)(ts, tk_),
              jax.jit(getattr(j, name))(js, jk_), what=name)
    f = np.asarray(j._yield_f(js, jk_)[0])
    assert (f > 1e-15).sum() > 10 and (f <= 1e-15).sum() > 10


@pytest.mark.parametrize("dim", (2, 3))
def test_degrade_upgrade_are_exact(dim):
    m = _t(np.random.default_rng(4).normal(size=(7, dim, dim)))
    up = tcn._upgrade(m)
    np.testing.assert_array_equal(up.numpy(),
                                  np.asarray(jcn._upgrade(jnp.asarray(
                                      m.numpy()), jnp.float64)))
    assert torch.equal(tcn._degrade(up, dim), m)
    assert not bool(up[:, dim:].any()) and not bool(up[:, :, dim:].any())


@pytest.mark.parametrize("dim", (2, 3))
def test_make_states_match_jax(dim):
    pos = np.random.default_rng(5).random((9, dim))
    m = dict(DP)
    for jf, tf_ in ((jcn.make_continuum_state, tcn.make_continuum_state),
                    (jcn.make_ul_solid_state, tcn.make_ul_solid_state)):
        j = jf(pos, DX ** dim, jcn.PlasticContinuum(**m), dtype=jnp.float64)
        t = tf_(pos, DX ** dim, tcn.PlasticContinuum(**m), torch.float64,
                "cpu")
        assert set(j) == set(t)
        for k, v in j.items():
            if k == "NReal":
                assert t[k] == int(v)
            else:
                close(t[k], v, what=k)
                assert t[k].dtype == torch.float64


# ---------------------------------------------------------------------------
# the plastic halves and the stress diffusion
# ---------------------------------------------------------------------------

def _plastic(dim, half, wall, cohesive):
    (jb, jw, nl, nlw), (tb, tw, tnl, tnlw) = scene(dim)
    jkern, tkern = kernels()
    kw = DP_COHESIVE if cohesive else DP
    jm, tm = jcn.PlasticContinuum(**kw), tcn.PlasticContinuum(**kw)
    jf = getattr(jcn, f"plastic_integration_{half}_half")
    tf_ = getattr(tcn, f"plastic_integration_{half}_half")
    jw_kw = dict(wall=jw, nl_wall=nlw) if wall else {}
    tw_kw = dict(wall=tw, nl_wall=tnlw) if wall else {}
    j = jax.jit(lambda b, w: jf(b, nl, jkern, dim, jm,
                                jrs.acoustic_riemann(jm), DT,
                                **({"wall": w, "nl_wall": nlw} if wall
                                   else {})))(jb, jw)
    t = tf_(tb, tnl, tkern, dim, tm, trs.acoustic_riemann(tm), DT, **tw_kw)
    return t, j


@pytest.mark.parametrize("dim", (2, 3))
@pytest.mark.parametrize("wall", (False, True), ids=("inner", "wall"))
def test_plastic_1st_half_matches_jax(dim, wall):
    t, j = _plastic(dim, "1st", wall, cohesive=False)
    hold_state(t, j, ("Density", "Pressure", "Position", "Force",
                      "DensityChangeRate", "Velocity"), "1st half")


@pytest.mark.parametrize("dim", (2, 3))
@pytest.mark.parametrize("wall", (False, True), ids=("inner", "wall"))
@pytest.mark.parametrize("cohesive", (False, True), ids=("dp", "cohesive"))
def test_plastic_2nd_half_matches_jax(dim, wall, cohesive):
    t, j = _plastic(dim, "2nd", wall, cohesive)
    hold_state(t, j, ("Position", "DensityChangeRate", "Force", "Density",
                      "VolumetricMeasure", "StressTensor3D",
                      "StrainTensor3D", "StressRate3D",
                      "VelocityGradient3D"), "2nd half")
    assert not bool(t["VelocityGradient3D"][:, dim:].any())


@pytest.mark.parametrize("dim", (2, 3))
def test_stress_diffusion_matches_jax(dim):
    (jb, jw, nl, nlw), (tb, tw, tnl, tnlw) = scene(dim)
    jkern, tkern = kernels()
    jm, tm = jcn.PlasticContinuum(**DP), tcn.PlasticContinuum(**DP)
    j = jax.jit(lambda b: jcn.stress_diffusion(b, nl, jkern, dim, jm, H))(jb)
    t = tcn.stress_diffusion(tb, tnl, tkern, dim, tm, H)
    close(t["StressRate3D"], j["StressRate3D"])
    assert float(t["StressRate3D"].abs().max()) > 0


# ---------------------------------------------------------------------------
# the updated-Lagrangian solid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim", (2, 3))
@pytest.mark.parametrize("alpha", (0.0, 1.0e3), ids=("alpha0", "alpha_big"))
def test_correction_matrix_current_matches_jax(dim, alpha):
    (jb, jw, nl, nlw), (tb, tw, tnl, tnlw) = scene(dim)
    jkern, tkern = kernels()
    j = jax.jit(lambda b: jcn.correction_matrix_current(
        b, nl, jkern, dim, alpha=alpha))(jb)
    t = tcn.correction_matrix_current(tb, tnl, tkern, dim, alpha=alpha)
    close(t["LinearGradientCorrectionMatrix"],
          j["LinearGradientCorrectionMatrix"])
    B = t["LinearGradientCorrectionMatrix"]
    eye = torch.eye(dim, dtype=B.dtype)
    if alpha > 0:           # alpha > det everywhere: B ~ I, the isolated I
        assert float((B[:-1] - eye).abs().max()) < 0.1
        assert torch.equal(B[-1], eye)
    else:                   # the isolated particle: A = 0, B = 0
        assert not bool(B[-1].any())


@pytest.mark.parametrize("dim", (2, 3))
@pytest.mark.parametrize("plastic", (None, "j2", "hardening"))
def test_shear_stress_hourglass_1st_half_matches_jax(dim, plastic):
    (jb, jw, nl, nlw), (tb, tw, tnl, tnlw) = scene(dim)
    jkern, tkern = kernels()
    kw = {None: J2, "j2": J2, "hardening": J2_HARD}[plastic]
    jm, tm = jcn.J2Plasticity(**kw), tcn.J2Plasticity(**kw)
    jp, tp = (jm, tm) if plastic else (None, None)
    j = jax.jit(lambda b: jcn.shear_stress_hourglass_1st_half(
        b, nl, jkern, dim, jm, DT, plasticity=jp))(jb)
    t = tcn.shear_stress_hourglass_1st_half(tb, tnl, tkern, dim, tm, DT,
                                            plasticity=tp)
    keys = ["VelocityGradient", "ShearStress", "StrainTensor"]
    if plastic:
        keys += ["HardeningFactor", "ScalePenaltyForce"]
        f = np.asarray(jm._yield_f(j["ShearStress"], j["HardeningFactor"])[0])
        scale = np.asarray(j["ScalePenaltyForce"])
        assert (scale < 2.0).sum() > 5 and (scale == 2.0).sum() > 5, f
    hold_state(t, j, keys, plastic)


@pytest.mark.parametrize("dim", (2, 3))
def test_rodrigues_matches_jax(dim):
    """Spins with theta = omega dt above and below 1e-12 (and zero)."""
    rng = np.random.default_rng(6)
    a = rng.normal(size=(60, dim, dim))
    spin = 0.5 * (a - a.transpose(0, 2, 1))
    spin *= np.logspace(-16, 2, 60)[:, None, None]
    spin[0] = 0.0
    dt = 1.0e-3
    j = np.asarray(jax.jit(jcn._rodrigues)(jnp.asarray(spin), dt))
    t = tcn._rodrigues(_t(spin), dt)
    close(t, j)
    omega = np.sqrt(np.maximum(-0.5 * np.trace(spin @ spin, axis1=1,
                                               axis2=2), 0.0))
    small = omega * dt <= 1e-12
    assert small.sum() > 5 and (~small).sum() > 5
    np.testing.assert_array_equal(t.numpy()[small],
                                  np.broadcast_to(np.eye(dim),
                                                  (small.sum(), dim, dim)))
    assert np.isfinite(t.numpy()).all()


@pytest.mark.parametrize("dim", (2, 3))
@pytest.mark.parametrize("scale", (False, True), ids=("xi", "scaled"))
def test_shear_acceleration_hourglass_2nd_half_matches_jax(dim, scale):
    (jb, jw, nl, nlw), (tb, tw, tnl, tnlw) = scene(dim)
    if not scale:
        jb = {k: v for k, v in jb.items() if k != "ScalePenaltyForce"}
        tb = {k: v for k, v in tb.items() if k != "ScalePenaltyForce"}
    jkern, tkern = kernels()
    jm, tm = jcn.J2Plasticity(**J2), tcn.J2Plasticity(**J2)
    j = jax.jit(lambda b: jcn.shear_acceleration_hourglass_2nd_half(
        b, nl, jkern, dim, jm, DT))(jb)
    t = tcn.shear_acceleration_hourglass_2nd_half(tb, tnl, tkern, dim, tm,
                                                  DT)
    hold_state(t, j, ("AccHourglass", "AccShear"))


@pytest.mark.parametrize("dim", (2, 3))
def test_ul_shear_force_and_volume_update_match_jax(dim):
    (jb, _, _, _), (tb, _, _, _) = scene(dim)
    close(tcn.ul_shear_force(tb), jcn.ul_shear_force(jb))
    close(tcn.volume_update(tb)["VolumetricMeasure"],
          jcn.volume_update(jb)["VolumetricMeasure"])


# ---------------------------------------------------------------------------
# the fluid's extra force and surface projection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim", (2, 3))
def test_extra_force_matches_jax(dim):
    """The first acoustic half with the UL shear force folded in, against
    the wall; without it the velocity differs."""
    (jb, jw, nl, nlw), (tb, tw, tnl, tnlw) = scene(dim)
    jkern, tkern = kernels()
    jeos = jmat.WeaklyCompressibleFluid(rho0=1.0, c0=20.0)
    teos = tmat.WeaklyCompressibleFluid(rho0=1.0, c0=20.0)
    j = jax.jit(lambda b, w: jfd.acoustic_step_1st_half(
        b, nl, jkern, dim, jeos, jrs.no_riemann(jeos), DT, wall=w,
        nl_wall=nlw, extra_force=jcn.ul_shear_force(b)))(jb, jw)
    t = tfd.acoustic_step_1st_half(tb, tnl, tkern, dim, teos,
                                   trs.no_riemann(teos), DT, wall=tw,
                                   nl_wall=tnlw,
                                   extra_force=tcn.ul_shear_force(tb))
    hold_state(t, j, ("Force", "Velocity", "Density", "Pressure",
                      "Position"))
    plain = tfd.acoustic_step_1st_half(tb, tnl, tkern, dim, teos,
                                       trs.no_riemann(teos), DT, wall=tw,
                                       nl_wall=tnlw)
    assert float((plain["Velocity"] - t["Velocity"]).abs().max()) > 1e-4


@pytest.mark.parametrize("dim", (2, 3))
@pytest.mark.parametrize("wall", (False, True), ids=("inner", "wall"))
def test_surface_projection_matches_jax(dim, wall):
    """The unified correction over bulk rows (shifted as before), surface
    rows (shifted tangentially) and deficient surface rows (not shifted);
    the 3D block (6 x 5 x 4) has no bulk row, the 2D one has."""
    (jb, jw, nl, nlw), (tb, tw, tnl, tnlw) = scene(dim)
    jkern, tkern = kernels()
    jkw = dict(wall=jw, nl_wall=nlw) if wall else {}
    tkw = dict(wall=tw, nl_wall=tnlw) if wall else {}
    j = jax.jit(lambda b, w: jfd.transport_velocity_correction(
        b, nl, jkern, dim, H, limiter_slope=100.0, surface_projection=True,
        **({"wall": w, "nl_wall": nlw} if wall else {})))(jb, jw)
    t = tfd.transport_velocity_correction(tb, tnl, tkern, dim, H,
                                          limiter_slope=100.0,
                                          surface_projection=True, **tkw)
    close(t["Position"], j["Position"])
    plain = tfd.transport_velocity_correction(tb, tnl, tkern, dim, H,
                                              limiter_slope=100.0, **tkw)
    shift = (t["Position"] - tb["Position"]).numpy()
    shift0 = (plain["Position"] - tb["Position"]).numpy()
    ind = tb["Indicator"].numpy() == 1
    deficient = ind & (tb["PositionDivergence"].numpy() < 0.6 * dim)
    surface = ind & ~deficient
    assert surface.sum() > 3 and deficient.sum() > 3
    assert (~ind).sum() > 3 or dim == 3
    np.testing.assert_array_equal(shift[~ind], shift0[~ind])
    assert not shift[deficient].any()
    assert np.abs(shift[surface] - shift0[surface]).max() > 0


# ---------------------------------------------------------------------------
# the cylinder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", ((0.0, 1.0, 0.0), (1.0, 2.0, -0.5)),
                         ids=("y", "tilted"))
def test_cylinder_matches_jax(axis):
    """contains, the signed distance and the normal (the SDF's gradient)
    at points inside, outside, beyond the caps and on the axis.  Inside,
    JAX's normal is NaN (the outside part's sqrt(0) differentiated, times
    0); the port's is the unit vector of the nearer face's SDF term: the
    radial direction where dr > dz, else the axis, signed."""
    kw = dict(center=(0.3, 0.05, 0.3), axis=axis, radius=0.1,
              halflength=0.05)
    jc, tc = jgeo.Cylinder(**kw), tgeo.Cylinder(**kw)
    rng = np.random.default_rng(7)
    pts = np.asarray(kw["center"]) + 0.25 * (rng.random((400, 3)) - 0.5)
    pts = np.concatenate([pts, np.asarray(kw["center"])[None]])
    jp, tp = jnp.asarray(pts), _t(pts)
    np.testing.assert_array_equal(tc.contains(tp).numpy(),
                                  np.asarray(jc.contains(jp)))
    inside = np.asarray(jc.contains(jp))
    assert 20 < inside.sum() < len(pts) - 20
    close(tc.signed_distance(tp), jc.signed_distance(jp))
    jn = np.asarray(jc.find_normal_direction(jp))
    tn = tc.find_normal_direction(tp).numpy()
    ok = np.isfinite(jn).all(1)
    np.testing.assert_array_equal(ok, ~inside)
    close(tn[ok], jn[ok])
    a = np.asarray(axis) / np.linalg.norm(axis)
    p = pts[inside] - np.asarray(kw["center"])
    ax = p @ a
    rad = p - ax[:, None] * a
    dr = np.linalg.norm(rad, axis=1) - kw["radius"]
    dz = np.abs(ax) - kw["halflength"]
    with np.errstate(invalid="ignore"):      # the centre: rad = 0, axial
        want = np.where((dr > dz)[:, None],
                        rad / np.linalg.norm(rad, axis=1, keepdims=True),
                        np.sign(ax)[:, None] * a)
    close(tn[inside], want, 1e-9)
    # the granular pile's lattice (repose_angle_3d at RADIUS / 5)
    from sphinxsys_tpu.core.generators import generate_lattice as jgen
    from sphinxsys_tpu_torch.core.generators import generate_lattice as tgen

    lo, hi = (0.0, 0.0, 0.0), (0.6, 0.12, 0.6)
    np.testing.assert_array_equal(tgen(tc, lo, hi, 0.02)[0],
                                  jgen(jc, lo, hi, 0.02)[0])
