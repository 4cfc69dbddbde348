"""Parity of the port's block physics with the JAX package on the same
inputs (a dambreak block state at dx = 0.1 with seeded perturbations):

* the float64 `*_b` forms against JAX's `*_b` forms (rtol 1e-12);
* the float32 `*_p2` forms on the CPU — i.e. the plain PyTorch versions of
  the B1-B3 sweeps — against JAX's `*_p2` forms running the Pallas kernels
  in interpret mode (rtol 2e-5 / atol 1e-5 on real slots), for static
  walls in 2D and 3D and a moving wall with non-zero kinematics;
* B4 (viscous force + transport-velocity correction): the float64 `*_b`
  forms against JAX's, and the port's `visc_tvc_p2` against JAX's Pallas
  interpret with no wall, a static wall and a moving wall;
* the periodic box: B1-B4 and the `*_b` forms on a Taylor–Green block
  state (doubly periodic, seeded perturbations) against JAX's;
* the sweep wrappers' dispatch rules (CPU -> plain, anything else raises).
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sphinxsys_tpu.cases import dambreak_2d as jdb2, dambreak_3d as jdb3
from sphinxsys_tpu.cases import taylor_green_2d as jtg
from sphinxsys_tpu.engine import scene as jsc
from sphinxsys_tpu.physics import fluid_blocks as jfb
from sphinxsys_tpu_torch import convert
from sphinxsys_tpu_torch.cases import dambreak_2d as tdb2, dambreak_3d as tdb3
from sphinxsys_tpu_torch.cases import taylor_green_2d as ttg
from sphinxsys_tpu_torch.ops import _build
from sphinxsys_tpu_torch.ops import block_sweeps as bs
from sphinxsys_tpu_torch.physics import fluid_blocks as tfb

torch.set_num_threads(1)

STATE_FIELDS = ("Position", "Velocity", "Density", "Pressure",
                "DensityChangeRate", "Force", "DensitySummation")
VISC_FIELDS = ("ForcePrior", "ViscousForcePrev", "Position")
MU = 0.05           # a viscosity that makes the viscous force visible
TVC = dict(coefficient=0.2, limiter_slope=100.0)


def _perturbed_scene(jdb, tdb, seed, **kw):
    """JAX block scene at dx = 0.1 (f32), its slotted initial state with
    seeded noise on the real slots, and the port's case objects."""
    jscene, jfluid = jdb.build_block_case(dx=0.1, **kw)
    sim = jsc.init_sim(jscene, jfluid)
    fb = {k: np.array(v) for k, v in sim.fluid_b.items()}
    rng = np.random.default_rng(seed)
    m = fb["SlotMask"]
    dim = fb["Position"].shape[-1]
    n = int(m.sum())
    fb["Position"][m] += rng.uniform(-0.02, 0.02, (n, dim))
    fb["Velocity"][m] = rng.normal(0.0, 0.3, (n, dim))
    fb["Density"][m] = 1.0 + rng.uniform(-0.01, 0.02, n)
    fb["Pressure"][m] = rng.normal(0.0, 2.0, n)
    fb["DensityChangeRate"][m] = rng.normal(0.0, 0.1, n)
    fb["Force"][m] = rng.normal(0.0, 0.05, (n, dim))
    fb["ForcePrior"][m] += rng.normal(0.0, 0.01, (n, dim))
    wall = {k: np.array(v) for k, v in jscene.wall_b.items()}
    tscene, _ = tdb.build_block_case(dx=0.1, device="cpu",
                                     **{k: v for k, v in kw.items() if k == "cap"})
    return dict(jscene=jscene, fb=fb, wall=wall, nbr=np.asarray(sim.nbr_inner),
                nbr_wall=np.asarray(sim.nbr_wall), tscene=tscene, dim=dim)


@pytest.fixture(scope="module")
def scenes():
    return {"2d": _perturbed_scene(jdb2, tdb2, 0, tile_c=32),
            "3d": _perturbed_scene(jdb3, tdb3, 1, cap=32)}


def _moving(wall, seed):
    """The wall with seeded non-zero velocity and acceleration."""
    w = dict(wall)
    rng = np.random.default_rng(seed)
    m = w["SlotMask"]
    shape = w["Position"][m].shape
    for k, s in (("AverageVelocity", 0.2), ("AverageAcceleration", 1.0)):
        w[k] = w[k].copy()
        w[k][m] = rng.normal(0.0, s, shape)
    return w


def _both(s, dtype, wall=None):
    """(jax inputs, torch inputs) of the block state, wall and maps."""
    wall = s["wall"] if wall is None else wall
    cast = lambda d: {k: (v.astype(dtype) if v.dtype.kind == "f" else v)
                      for k, v in d.items()}
    fb, wb = cast(s["fb"]), cast(wall)
    jin = ({k: jnp.asarray(v) for k, v in fb.items()},
           {k: jnp.asarray(v) for k, v in wb.items()},
           jnp.asarray(s["nbr"]), jnp.asarray(s["nbr_wall"]))
    tin = (convert.block_state_from_numpy(fb), convert.block_state_from_numpy(wb),
           torch.as_tensor(np.array(s["nbr"])), torch.as_tensor(np.array(s["nbr_wall"])))
    return jin, tin


def _assert_states(got, ref, mask, keys, rtol, atol, what):
    for k in keys:
        a = convert.to_numpy(got[k])[mask]
        b = np.asarray(ref[k])[mask]
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {k}")


def _jax_halves_b(f, n, w, nw, base, d, dt):
    one = jfb.acoustic_step_1st_half_b(f, n, base.kernel, d, base.eos,
                                       base.riemann, dt, wall_b=w, nbr_wall=nw)
    two = jfb.acoustic_step_2nd_half_b(one, n, base.kernel, d, base.riemann,
                                       dt, wall_b=w, nbr_wall=nw)
    return one, two


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_b_forms_match_jax_f64(scenes, dim):
    s = scenes[dim]
    base, tscene = s["jscene"].base, s["tscene"]
    d = s["dim"]
    (jf, jw, jn, jnw), (tf, tw, tn, tnw) = _both(s, np.float64)
    mask = s["fb"]["SlotMask"]
    eng = tscene.eng
    tol = dict(rtol=1e-12, atol=1e-12)

    dt_j = jfb.acoustic_time_step_b(jf, base.eos, base.adaptation.h)
    dt_t = tfb.acoustic_time_step_b(tf, eng.eos, eng.h)
    assert float(dt_t) == pytest.approx(float(dt_j), rel=1e-14)
    adt_j = jfb.advection_time_step_b(jf, base.adaptation.h, jdb2.U_REF)
    adt_t = tfb.advection_time_step_b(tf, eng.h, tdb2.U_REF)
    assert float(adt_t) == pytest.approx(float(adt_j), rel=1e-14)

    # the JAX references run jitted (eager dispatch of the 3D forms is slow)
    proxy = {"Position": jw["Position"], "Mass": jw["VolumetricMeasure"],
             "SlotMask": jw["SlotMask"]}
    ref = jax.jit(lambda f, n, p, nw: jfb.density_summation_b(
        f, n, base.kernel, d, 1.0, base.adaptation.sigma0,
        contacts=[(p, nw, 1.0)]))(jf, jn, proxy, jnw)
    got = tfb.density_summation_b(tf, tn, eng.kernel, d, 1.0, eng.sigma0,
                                  wall_b=tw, nbr_wall=tnw)
    _assert_states(got, ref, mask, ("Density", "DensitySummation"), **tol,
                   what="density")

    dt = 0.5 * float(dt_j)
    ref1, ref2 = jax.jit(lambda f, n, w, nw: _jax_halves_b(
        f, n, w, nw, base, d, dt))(jf, jn, jw, jnw)
    got1 = tfb.acoustic_step_1st_half_b(tf, tn, eng.kernel, d, eng.eos,
                                        eng.riemann1, dt, wall_b=tw, nbr_wall=tnw)
    _assert_states(got1, ref1, mask, STATE_FIELDS, **tol, what="1st half")
    got2 = tfb.acoustic_step_2nd_half_b(got1, tn, eng.kernel, d, eng.riemann2,
                                        dt, wall_b=tw, nbr_wall=tnw)
    _assert_states(got2, ref2, mask, STATE_FIELDS, **tol, what="2nd half")


@pytest.mark.parametrize("dim,moving", [("2d", False), ("3d", False),
                                        ("2d", True)])
def test_sweeps_match_pallas_interpret_f32(scenes, dim, moving):
    """The *_p2 forms: JAX through the Pallas kernels (interpret mode), the
    port through the plain versions of the same sweeps."""
    s = scenes[dim]
    jscene, tscene, d = s["jscene"], s["tscene"], s["dim"]
    base, eng = jscene.base, tscene.eng
    wall = _moving(s["wall"], 3) if moving else s["wall"]
    static = not moving
    (jf, jw, jn, jnw), (tf, tw, tn, tnw) = _both(s, np.float32, wall)
    mask = s["fb"]["SlotMask"]
    tile_c = jscene.eng.tile_c
    tol = dict(rtol=2e-5, atol=1e-5)

    wall_jt, wflags = jax.jit(lambda w, n: jfb.pack_wall_t(
        w, n, jscene.bm_wall.c_max, tile_c, wall_static=static))(jw, jnw)
    ref = jfb.density_summation_p2(jf, jn, wall_jt, wflags, base.kernel, 1.0,
                                   base.adaptation.sigma0, tile_c=tile_c,
                                   interpret=True, dim=d, wall_static=static)
    got = tfb.density_summation_p2(tf, tn, tw, tnw, eng.kernel, 1.0, eng.sigma0,
                                   d)
    _assert_states(got, ref, mask, ("Density", "DensitySummation"), **tol,
                   what="density p2")

    dt = jnp.asarray(5e-3, jnp.float32)
    tdt = torch.tensor(5e-3, dtype=torch.float32)
    ref1 = jfb.acoustic_step_1st_half_p2(jf, jn, wall_jt, wflags, base.kernel,
                                         base.eos, base.riemann, dt,
                                         tile_c=tile_c, interpret=True, dim=d,
                                         wall_static=static)
    got1 = tfb.acoustic_step_1st_half_p2(tf, tn, tw, tnw, eng.kernel, eng.eos,
                                         eng.riemann1, tdt, d, wall_static=static)
    _assert_states(got1, ref1, mask, STATE_FIELDS, **tol, what="1st half p2")
    ref2 = jfb.acoustic_step_2nd_half_p2(ref1, jn, wall_jt, wflags, base.kernel,
                                         base.riemann, dt, tile_c=tile_c,
                                         interpret=True, dim=d,
                                         wall_static=static)
    got2 = tfb.acoustic_step_2nd_half_p2(got1, tn, tw, tnw, eng.kernel,
                                         eng.riemann2, tdt, d, wall_static=static)
    _assert_states(got2, ref2, mask, STATE_FIELDS, **tol, what="2nd half p2")


def test_density_p2_carries_b_algebra_for_any_mass(scenes):
    """B1's density algebra: rho = (w0 + sum W) rho0/sigma0
    + sum W V_k rho0^2/(sigma0 m_i).  The fluid sum is a number density in
    both forms (as in the reference's DensitySummation<Inner>), which
    presumes equal-mass fluid particles; the p2 form and the b form agree
    for equal AND unequal masses, and only the wall term sees m_i."""
    s = scenes["2d"]
    eng, d = s["tscene"].eng, s["dim"]
    _, (tf, tw, tn, tnw) = _both(s, np.float64)
    mask = s["fb"]["SlotMask"]
    uneven = 1.0 + 0.5 * (torch.arange(tf["Mass"].numel()) % 2).reshape(
        tf["Mass"].shape).double()
    results = []
    for mass in (tf["Mass"], tf["Mass"] * uneven):
        fb = dict(tf, Mass=mass)
        ref = tfb.density_summation_b(fb, tn, eng.kernel, d, 1.0, eng.sigma0,
                                      wall_b=tw, nbr_wall=tnw)
        got = tfb.density_summation_p2(fb, tn, tw, tnw, eng.kernel, 1.0,
                                       eng.sigma0, d)
        np.testing.assert_allclose(got["DensitySummation"][mask].numpy(),
                                   ref["DensitySummation"][mask].numpy(),
                                   rtol=1e-12)
        results.append(got["DensitySummation"][mask].numpy())
    assert not np.allclose(results[0], results[1], rtol=1e-6)


def test_sweep_dispatch(scenes):
    """CPU tensors run the plain version (no launch counted), with or
    without a periodic box; other devices raise; a malformed box raises
    before a launch; building the kernels without nvcc raises."""
    s = scenes["2d"]
    _, (tf, tw, tn, tnw) = _both(s, np.float32)
    kw = dict(inv_h=1.0, factor_w=1.0)
    bs.reset_launch_counts()
    out = bs.density_sweep(tf["Position"], tf["SlotMask"], tn, tw["Position"],
                           tw["VolumetricMeasure"], tnw, **kw)
    assert out.shape == (tn.shape[0], tf["Position"].shape[1], 2)
    boxed = bs.visc_tvc_sweep(tf["Position"], tf["Velocity"],
                              tf["VolumetricMeasure"], tn, inv_h=1.0,
                              dw_scale=1.0, eps_r=0.01, box=(6.0, 0.0))
    assert boxed.shape == (tn.shape[0], tf["Position"].shape[1], 4)
    assert bs.LAUNCHES == {"density": 0, "ac1": 0, "ac2": 0, "visc_tvc": 0}
    with pytest.raises(ValueError, match="cpu or cuda"):
        bs.density_sweep(tf["Position"].to("meta"), tf["SlotMask"].to("meta"),
                         tn.to("meta"), **kw)
    with pytest.raises(ValueError, match="lengths"):
        bs._box3((1.0,), 2)
    assert bs._box3(None, 2) == (0.0, 0.0, 0.0)
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc present: the missing-compiler path is not reachable")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


# ---------------------------------------------------------------------------
# B4: viscous force + transport-velocity correction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_viscous_tvc_b_forms_match_jax_f64(scenes, dim):
    """viscous_force_b and transport_velocity_correction_b, with a moving
    wall (the wall velocity enters the viscous jump), against JAX's."""
    s = scenes[dim]
    base, eng, d = s["jscene"].base, s["tscene"].eng, s["dim"]
    (jf, jw, jn, jnw), (tf, tw, tn, tnw) = _both(s, np.float64,
                                                 _moving(s["wall"], 5))
    mask = s["fb"]["SlotMask"]
    h = base.adaptation.h
    ref = jax.jit(lambda f, n, w, nw: jfb.transport_velocity_correction_b(
        jfb.viscous_force_b(f, n, base.kernel, d, MU, h, walls=[(w, nw)]),
        n, base.kernel, d, h, walls=[(w, nw)], **TVC))(jf, jn, jw, jnw)
    got = tfb.transport_velocity_correction_b(
        tfb.viscous_force_b(tf, tn, eng.kernel, d, MU, h, wall_b=tw,
                            nbr_wall=tnw),
        tn, eng.kernel, d, h, wall_b=tw, nbr_wall=tnw, **TVC)
    _assert_states(got, ref, mask, VISC_FIELDS, rtol=1e-12, atol=1e-12,
                   what="viscous + TVC b")


def _jax_null_wall(c, dim, tile_c):
    """The Pallas wall tensor and flags of a scene without walls (the
    shapes of engine/block_fluid.null_wall_ctx, every tile occupied)."""
    return (jnp.zeros((3 ** dim, 3 * dim + 1, 1, c), jnp.float32),
            jnp.zeros((c // tile_c,), jnp.int32))


@pytest.mark.parametrize("wall", ["none", "static", "moving"])
def test_visc_tvc_matches_pallas_interpret_f32(scenes, wall):
    """visc_tvc_p2: JAX through the B4 Pallas kernel (interpret mode), the
    port through the plain version of the same sweep."""
    s = scenes["2d"]
    jscene, eng, d = s["jscene"], s["tscene"].eng, s["dim"]
    base, tile_c = jscene.base, jscene.eng.tile_c
    h = base.adaptation.h
    static = wall == "static"
    (jf, jw, jn, jnw), (tf, tw, tn, tnw) = _both(
        s, np.float32, _moving(s["wall"], 6) if wall == "moving" else None)
    if wall == "none":
        wall_jt, wflags = _jax_null_wall(jn.shape[0], d, tile_c)
        tw = tnw = None
    else:
        wall_jt, wflags = jax.jit(lambda w, n: jfb.pack_wall_t(
            w, n, jscene.bm_wall.c_max, tile_c, wall_static=static))(jw, jnw)
    kw = dict(tvc_coefficient=TVC["coefficient"],
              tvc_limiter_slope=TVC["limiter_slope"])
    ref = jfb.visc_tvc_p2(jf, jn, wall_jt, wflags, base.kernel, d, MU, h,
                          tile_c=tile_c, interpret=True, wall_static=static,
                          **kw)
    got = tfb.visc_tvc_p2(tf, tn, tw, tnw, eng.kernel, d, MU, h,
                          wall_static=static, **kw)
    _assert_states(got, ref, s["fb"]["SlotMask"], VISC_FIELDS, rtol=2e-5,
                   atol=1e-5, what=f"visc_tvc p2 ({wall} wall)")


# ---------------------------------------------------------------------------
# the periodic box: a Taylor–Green block state
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tg_state():
    """JAX's Taylor–Green block scene at dx = 0.05 (7 x 7 doubly periodic
    grid, Pallas interpret, tile_c 32), its slotted initial state with
    seeded noise on the real slots, and the window maps: JAX's for JAX;
    for the port the same with its padding rows all-sentinel (the port's
    rule; JAX's periodic fallback puts real rows there, which only padding
    slots read)."""
    jscene, jfluid = jtg.build_block_case(dx=0.05, use_pallas=True,
                                          pallas_interpret=True, tile_c=32)
    sim = jsc.init_sim(jscene, jfluid)
    fb = {k: np.array(v) for k, v in sim.fluid_b.items()}
    rng = np.random.default_rng(11)
    m = fb["SlotMask"]
    n = int(m.sum())
    fb["Position"][m] += rng.uniform(-0.005, 0.005, (n, 2))
    fb["Velocity"][m] += rng.normal(0.0, 0.1, (n, 2))
    fb["Density"][m] = 1.0 + rng.uniform(-0.01, 0.02, n)
    fb["Pressure"][m] = rng.normal(0.0, 2.0, n)
    fb["DensityChangeRate"][m] = rng.normal(0.0, 0.1, n)
    fb["Force"][m] = rng.normal(0.0, 0.05, (n, 2))
    fb["ForcePrior"][m] = rng.normal(0.0, 0.01, (n, 2))
    nbr = np.asarray(sim.nbr_inner)
    n_occ = int(np.asarray(sim.fluid_b["SlotMask"])[:-1].any(axis=1).sum())
    nbr_port = nbr.copy()
    nbr_port[n_occ:] = nbr.shape[0]
    tbase, _ = ttg.build_case(dx=0.05, device="cpu")
    return dict(jscene=jscene, tbase=tbase, fb=fb, nbr=nbr, nbr_port=nbr_port)


def _tg_both(t, dtype):
    fb = {k: (v.astype(dtype) if v.dtype.kind == "f" else v)
          for k, v in t["fb"].items()}
    return ({k: jnp.asarray(v) for k, v in fb.items()}, jnp.asarray(t["nbr"]),
            convert.block_state_from_numpy(fb),
            torch.as_tensor(np.array(t["nbr_port"])))


def test_periodic_b_forms_match_jax_f64(tg_state):
    """The `*_b` forms under the minimum image: density summation (no free
    surface), both acoustic halves (the No solver in the 2nd) and the
    viscous + TVC prep, against JAX's."""
    jscene, tb = tg_state["jscene"], tg_state["tbase"]
    base, box = jscene.base, jscene.eng.box
    assert tb.box == box
    k, h = base.kernel, base.adaptation.h
    jf, jn, tf, tn = _tg_both(tg_state, np.float64)
    mask = tg_state["fb"]["SlotMask"]
    tol = dict(rtol=1e-12, atol=1e-12)
    dt = 1e-3

    def jax_all(f, n):
        f0 = jfb.density_summation_b(f, n, k, 2, 1.0, base.adaptation.sigma0,
                                     free_surface=False, box=box)
        f1 = jfb.transport_velocity_correction_b(
            jfb.viscous_force_b(f0, n, k, 2, MU, h, box=box), n, k, 2, h,
            box=box, **TVC)
        f2 = jfb.acoustic_step_1st_half_b(f1, n, k, 2, base.eos, base.riemann,
                                          dt, box=box)
        f3 = jfb.acoustic_step_2nd_half_b(f2, n, k, 2, base.no_riemann, dt,
                                          box=box)
        return f0, f1, f2, f3

    refs = jax.jit(jax_all)(jf, jn)
    tk = tb.kernel
    g0 = tfb.density_summation_b(tf, tn, tk, 2, 1.0, tb.adaptation.sigma0,
                                 free_surface=False, box=box)
    g1 = tfb.transport_velocity_correction_b(
        tfb.viscous_force_b(g0, tn, tk, 2, MU, h, box=box), tn, tk, 2, h,
        box=box, **TVC)
    g2 = tfb.acoustic_step_1st_half_b(g1, tn, tk, 2, tb.eos, tb.riemann, dt,
                                      box=box)
    g3 = tfb.acoustic_step_2nd_half_b(g2, tn, tk, 2, tb.no_riemann, dt,
                                      box=box)
    _assert_states(g0, refs[0], mask, ("Density", "DensitySummation",
                                       "VolumetricMeasure"), **tol,
                   what="density b")
    _assert_states(g1, refs[1], mask, VISC_FIELDS, **tol, what="visc+tvc b")
    _assert_states(g2, refs[2], mask, STATE_FIELDS, **tol, what="1st half b")
    _assert_states(g3, refs[3], mask, STATE_FIELDS, **tol, what="2nd half b")


@pytest.mark.parametrize("solver2", ["no", "acoustic"])
def test_periodic_sweeps_match_pallas_interpret_f32(tg_state, solver2):
    """B1-B4 with the box: JAX's `*_p2` forms through the Pallas kernels
    (interpret mode, no wall), the port's through the plain versions.  The
    2nd half runs the Taylor–Green case's No solver (B3 called with
    rho0c0_geo = 0) and, to exercise B3's force channel under the wrap,
    the acoustic one."""
    jscene, tb = tg_state["jscene"], tg_state["tbase"]
    base, jeng_ = jscene.base, jscene.eng
    box, tile_c = jeng_.box, jeng_.tile_c
    k, tk, h = base.kernel, tb.kernel, base.adaptation.h
    jf, jn, tf, tn = _tg_both(tg_state, np.float32)
    mask = tg_state["fb"]["SlotMask"]
    wall_jt, wflags = _jax_null_wall(jn.shape[0], 2, tile_c)
    assert not jeng_.roll_y
    pk = dict(tile_c=tile_c, interpret=True, box=box, roll_y=False, dim=2)
    tol = dict(rtol=2e-5, atol=1e-5)
    rs_j = base.no_riemann if solver2 == "no" else base.riemann
    rs_t = tb.no_riemann if solver2 == "no" else tb.riemann

    r0 = jfb.density_summation_p2(jf, jn, wall_jt, wflags, k, 1.0,
                                  base.adaptation.sigma0, free_surface=False,
                                  **pk)
    g0 = tfb.density_summation_p2(tf, tn, None, None, tk, 1.0,
                                  tb.adaptation.sigma0, 2,
                                  free_surface=False, box=box)
    _assert_states(g0, r0, mask, ("Density", "DensitySummation",
                                  "VolumetricMeasure"), **tol,
                   what="density p2 (box)")
    # each stage starts from the same state (a chained density would carry
    # its f32 rounding into the pressure, times c0^2)
    r1 = jfb.visc_tvc_p2(jf, jn, wall_jt, wflags, k, 2, MU, h,
                         tvc_coefficient=0.2, tvc_limiter_slope=100.0,
                         **{q: v for q, v in pk.items() if q != "dim"})
    g1 = tfb.visc_tvc_p2(tf, tn, None, None, tk, 2, MU, h, tvc_coefficient=0.2,
                         tvc_limiter_slope=100.0, box=box)
    _assert_states(g1, r1, mask, VISC_FIELDS, **tol, what="visc_tvc p2 (box)")
    dt = jnp.asarray(2e-3, jnp.float32)
    tdt = torch.tensor(2e-3, dtype=torch.float32)
    r2 = jfb.acoustic_step_1st_half_p2(jf, jn, wall_jt, wflags, k, base.eos,
                                       base.riemann, dt, **pk)
    g2 = tfb.acoustic_step_1st_half_p2(tf, tn, None, None, tk, tb.eos,
                                       tb.riemann, tdt, 2, box=box)
    _assert_states(g2, r2, mask, STATE_FIELDS, **tol, what="1st half p2 (box)")
    r3 = jfb.acoustic_step_2nd_half_p2(r2, jn, wall_jt, wflags, k, rs_j, dt,
                                       **pk)
    g3 = tfb.acoustic_step_2nd_half_p2(g2, tn, None, None, tk, rs_t, tdt, 2,
                                       box=box)
    _assert_states(g3, r3, mask, STATE_FIELDS, **tol,
                   what=f"2nd half p2 (box, {solver2} solver)")
