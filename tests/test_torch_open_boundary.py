"""Parity of the port's open boundaries and free stream with the JAX
package, on the CPU in float64: core/geometry.py `Polygon` and
`make_multi_polygon`, physics/boundary.py, the free-stream functions of
physics/fluid.py, `core/state.valid_mask` with Alive, and the T-pipe
(cases/t_pipe_2d.py) through build_case -> init_sim -> make_run_chunk and
through the CLI.

Inputs are made from a seed with numpy and fed to both sides as the same
arrays.  The per-function scene is fish_fsi_2d at dx = 0.01 (3,964 water
particles in 4,360 rows, 36 fish particles): its positions moved by up to
0.1 dx, velocities, densities and the indicator fields drawn at random,
and 5% of its live rows killed (holes in Alive, parked at FAR_AWAY).  The
channel has no wall, so its four sides are free surfaces.  Every output
is held within 1e-12 of its max|ref|, masks and integer fields exactly.

The quirks the port keeps (ROADMAP §C): the fluid time steps mask by
index < NReal, not by Alive (`test_time_steps_mask_by_nreal`); a clone
inherits only the hinted fields (`test_emitter_clones_inherit_hinted_fields_only`);
the VTP writer writes the first NReal rows, dead slots parked at
FAR_AWAY among them (`hold_cli_run`, here and in tests/test_torch_fish.py).
"""

import filecmp
import logging
import os
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sphinxsys_tpu import run as jrun
from sphinxsys_tpu.cases import fish_fsi_2d as jff, fish_undulation_2d as jfu, \
    t_pipe_2d as jtp
from sphinxsys_tpu.core import state as jst
from sphinxsys_tpu.core.generators import lattice_positions as jlattice
from sphinxsys_tpu.physics import boundary as jbd
from sphinxsys_tpu.physics import fluid as jfd
from sphinxsys_tpu_torch import run as trun
from sphinxsys_tpu_torch.cases import fish_fsi_2d as tff, \
    fish_undulation_2d as tfu, t_pipe_2d as ttp
from sphinxsys_tpu_torch.core import geometry as tG
from sphinxsys_tpu_torch.core import state as tst
from sphinxsys_tpu_torch.core.generators import lattice_positions
from sphinxsys_tpu_torch.physics import boundary as tbd
from sphinxsys_tpu_torch.physics import fluid as tfd

torch.set_num_threads(1)

TOL = 1e-12
POS_TOL = 1e-9
FAR = 1.0e16


def _close(got, ref, tol=TOL, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max()
    scale = np.abs(ref).max()
    assert err <= tol * max(scale, 1e-300), f"{what}: {err:.3e} vs {scale:.3e}"


def _t(state):
    return {k: int(np.asarray(v)) if k == "NReal"
            else torch.as_tensor(np.array(v)) for k, v in state.items()}


def _j(state):
    return {k: jnp.asarray(v, jnp.int32) if k == "NReal" else jnp.asarray(v)
            for k, v in state.items()}


def _hold_state(t_state, j_state, keys, tol=TOL):
    for k in keys:
        ref = np.asarray(j_state[k])
        got = t_state[k].numpy()
        if ref.dtype.kind in "biu":
            np.testing.assert_array_equal(got, ref, err_msg=k)
        else:
            _close(got, ref, tol, k)


# ---------------------------------------------------------------------------
# geometry: Polygon, make_multi_polygon
# ---------------------------------------------------------------------------

def _shapes():
    """(name, JAX shape, port shape, lattice lower, upper, dx)."""
    fish = (jfu.fish_polygon(0.00125), tfu.fish_polygon(0.00125))
    fish_box = ((-0.02, -0.05), (jfu.FISH_LENGTH + 0.02, 0.05), 0.0025)
    tp_box = ((-jtp.DL_SPONGE - 4 * jtp.DX - jtp.DX,
               -jtp.DH - 4 * jtp.DX - jtp.DX),
              (jtp.DL + 4 * jtp.DX + jtp.DX,
               2 * jtp.DH + 4 * jtp.DX + jtp.DX), jtp.DX)
    return [("fish", *fish, *fish_box),
            ("t_pipe_water", jtp.water_shape(), ttp.water_shape(), *tp_box),
            ("t_pipe_wall", jtp.wall_shape(), ttp.wall_shape(), *tp_box)]


@pytest.mark.parametrize("name,jshape,tshape,lo,hi,dx", _shapes(),
                         ids=[s[0] for s in _shapes()])
def test_polygon_distance_and_normals(name, jshape, tshape, lo, hi, dx):
    """The signed distance, containment and normals of the fish polygon
    and the T-pipe's multi-polygons on their own lattices, vertex ties and
    clipped edge ends included: equal, NaN where JAX has NaN."""
    cand = lattice_positions(lo, hi, dx)
    np.testing.assert_array_equal(cand, np.asarray(jlattice(lo, hi, dx)))
    pj = jnp.asarray(cand)
    pt = torch.as_tensor(cand)
    _close(tshape.signed_distance(pt).numpy(),
           np.asarray(jshape.signed_distance(pj)), what="sdf")
    np.testing.assert_array_equal(tshape.contains(pt).numpy(),
                                  np.asarray(jshape.contains(pj)))
    nt = tshape.find_normal_direction(pt).numpy()
    nj = np.asarray(jshape.find_normal_direction(pj))
    np.testing.assert_array_equal(np.isnan(nt), np.isnan(nj))
    ok = ~np.isnan(nj)
    assert np.abs(nt[ok] - nj[ok]).max() <= TOL


def test_make_multi_polygon_structure():
    """The T-pipe wall: an added polygon less a subtracted one, each edge
    list as given."""
    t = ttp.wall_shape()
    j = jtp.wall_shape()
    assert t.ops == j.ops == (1, -1)
    for ts, js in zip(t.shapes, j.shapes):
        assert isinstance(ts, tG.Polygon)
        assert ts.vertices == js.vertices


# ---------------------------------------------------------------------------
# the per-function scene: fish_fsi_2d at dx = 0.01, perturbed, with holes
# ---------------------------------------------------------------------------

DX = 0.01


@pytest.fixture(scope="module")
def scene():
    jcase, jfluid, jfish = jff.build_case(dx=DX, dtype=jnp.float64)
    tcase, _, _ = tff.build_case(dx=DX, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(15)
    f = {k: np.array(v) for k, v in jfluid.items()}
    n = f["Position"].shape[0]
    alive = f["Alive"].copy()
    live = np.nonzero(alive)[0]
    kill = rng.choice(live, size=len(live) // 20, replace=False)
    alive[kill] = False
    f["Alive"] = alive
    shape = f["Position"].shape
    f["Position"] = np.where(alive[:, None], f["Position"] + 0.1 * DX
                             * (rng.random(shape) - 0.5), FAR)
    f["Velocity"] = 0.3 * rng.normal(size=shape)
    f["Density"] = 1000.0 * (1.0 + 0.01 * rng.normal(size=n))
    f["DensitySummation"] = 1000.0 * (1.0 + 0.01 * rng.normal(size=n))
    f["Indicator"] = (rng.random(n) < 0.2).astype(np.int32)
    f["PreviousSurfaceIndicator"] = (rng.random(n) < 0.3).astype(np.int32)
    fish = {k: np.array(v) for k, v in jfish.items()}
    fish["Position"] = fish["Position"] + 0.1 * DX * (
        rng.random(fish["Position"].shape) - 0.5)

    jf, jfi = _j(f), _j(fish)
    tf, tfi = _t(f), _t(fish)
    j_lists = jff.rebuild_relations(jcase, jf, jfi)
    t_lists = tff.rebuild_relations(tcase, tf, tfi)
    for tl, jl in zip(t_lists[:3], j_lists[:3]):
        np.testing.assert_array_equal(tl.idx.numpy(), np.asarray(jl.idx))
    assert not bool(t_lists[3]) and not bool(j_lists[3])
    return dict(jcase=jcase, tcase=tcase, jf=jf, tf=tf, jfi=jfi, tfi=tfi,
                jl=j_lists, tl=t_lists, raw=f)


@pytest.mark.parametrize("spatial_temporal", [False, True])
def test_free_surface_indication(scene, spatial_temporal):
    s = scene
    jo = jfd.free_surface_indication(
        s["jf"], s["jl"][0], s["jcase"].kernel, 2,
        contacts=[(s["jfi"], s["jl"][1], None)],
        spatial_temporal=spatial_temporal)
    to = tfd.free_surface_indication(
        s["tf"], s["tl"][0], s["tcase"].kernel, 2,
        contacts=[(s["tfi"], s["tl"][1], None)],
        spatial_temporal=spatial_temporal)
    _hold_state(to, jo, ("Indicator", "PreviousSurfaceIndicator",
                         "PositionDivergence"))
    assert to["Indicator"].dtype == torch.int32
    alive = s["raw"]["Alive"]
    n_surf = int(np.asarray(jo["Indicator"])[alive].sum())
    assert 0.05 * alive.sum() < n_surf < 0.6 * alive.sum()


def test_spatial_temporal_suppresses_new_surface(scene):
    """With the previous indicator all 0, no particle may turn surface:
    the suppression holds every would-be surface particle in the bulk."""
    s = scene
    tf = dict(s["tf"], PreviousSurfaceIndicator=torch.zeros_like(
        s["tf"]["PreviousSurfaceIndicator"]))
    jf = dict(s["jf"], PreviousSurfaceIndicator=jnp.zeros_like(
        s["jf"]["PreviousSurfaceIndicator"]))
    to = tfd.free_surface_indication(tf, s["tl"][0], s["tcase"].kernel, 2,
                                     spatial_temporal=True)
    jo = jfd.free_surface_indication(jf, s["jl"][0], s["jcase"].kernel, 2,
                                     spatial_temporal=True)
    _hold_state(to, jo, ("Indicator", "PositionDivergence"))
    assert int(to["Indicator"].sum()) == 0


def test_density_summation_freestream(scene):
    s = scene
    sigma0 = s["jcase"].adaptation.sigma0
    jo = jfd.density_summation_freestream(
        s["jf"], s["jl"][0], s["jcase"].kernel, 2, jff.RHO0_F, sigma0,
        contacts=[(s["jfi"], s["jl"][1], jfu.RHO0_S)])
    to = tfd.density_summation_freestream(
        s["tf"], s["tl"][0], s["tcase"].kernel, 2, tff.RHO0_F, sigma0,
        contacts=[(s["tfi"], s["tl"][1], tfu.RHO0_S)])
    _hold_state(to, jo, ("Density", "DensitySummation", "VolumetricMeasure"))
    # both branches ran: blended rows and plain-summation rows
    blended = ~np.isclose(np.asarray(jo["Density"]),
                          np.asarray(jo["DensitySummation"]), rtol=0, atol=0)
    assert blended.any() and not blended.all()


def test_free_stream_velocity_correction(scene):
    """A nonzero target (u = 0.4 + 0.1 y) so that the blend shows."""
    s = scene
    t = 0.7
    jo = jfd.free_stream_velocity_correction(
        s["jf"], lambda p, v, t: 0.4 + 0.1 * p[:, 1] + 0.0 * t, t, jff.RHO0_F)
    to = tfd.free_stream_velocity_correction(
        s["tf"], lambda p, v, t: 0.4 + 0.1 * p[:, 1] + 0.0 * t,
        torch.tensor(t, dtype=torch.float64), tff.RHO0_F)
    _hold_state(to, jo, ("Velocity",))
    ind = s["raw"]["Indicator"] == 1
    v0 = s["raw"]["Velocity"]
    np.testing.assert_array_equal(to["Velocity"].numpy()[~ind], v0[~ind])


def test_fish_free_stream_target(scene):
    """u_ref = 0: the target is zero at any time, on the state's device."""
    for t in (0.0, 1.0, 3.0):
        tt = tff.free_stream_target(scene["tf"]["Position"], None,
                                    torch.tensor(t, dtype=torch.float64))
        jt = jff.free_stream_target(scene["jf"]["Position"], None,
                                    jnp.asarray(t))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("limiter", [None, 100.0])
def test_transport_velocity_correction_scope_mask(scene, limiter):
    s = scene
    scope_t = (s["tf"]["Indicator"] == 0) & s["tf"]["Alive"]
    scope_j = (s["jf"]["Indicator"] == 0) & s["jf"]["Alive"]
    h = s["jcase"].adaptation.h
    jo = jfd.transport_velocity_correction(
        s["jf"], s["jl"][0], s["jcase"].kernel, 2, h, limiter_slope=limiter,
        walls=[(s["jfi"], s["jl"][1])], scope_mask=scope_j)
    to = tfd.transport_velocity_correction(
        s["tf"], s["tl"][0], s["tcase"].kernel, 2, h, limiter_slope=limiter,
        walls=[(s["tfi"], s["tl"][1])], scope_mask=scope_t)
    _hold_state(to, jo, ("Position",))
    out = ~scope_t.numpy()
    np.testing.assert_array_equal(to["Position"].numpy()[out],
                                  s["raw"]["Position"][out])


def test_unported_fluid_arguments_still_raise(scene):
    """The level sets and the shell walls of the indication and the
    transport correction are ported (meshes/levelset.py,
    physics/shell_fluid.py): a level-set entry without its probes and a
    wall entry without a shell state fail loudly."""
    s = scene
    with pytest.raises(AttributeError, match="compute_kernel_integral"):
        tfd.density_summation(s["tf"], s["tl"][0], s["tcase"].kernel, 2,
                              1.0, 1.0, levelsets=[object()])
    with pytest.raises(KeyError, match="VolumetricMeasure"):
        tfd.free_surface_indication(s["tf"], s["tl"][0], s["tcase"].kernel,
                                    2, shell_walls=[({}, None, None)])
    with pytest.raises(KeyError, match="VolumetricMeasure"):
        tfd.transport_velocity_correction(s["tf"], s["tl"][0],
                                          s["tcase"].kernel, 2, 0.01,
                                          shell_walls=[({}, None, None)])


# ---------------------------------------------------------------------------
# state masks and the time steps
# ---------------------------------------------------------------------------

def test_valid_mask_honours_alive(scene):
    s = scene
    np.testing.assert_array_equal(tst.valid_mask(s["tf"]).numpy(),
                                  np.asarray(jst.valid_mask(s["jf"])))
    no_alive = {k: v for k, v in s["tf"].items() if k != "Alive"}
    no_alive_j = {k: v for k, v in s["jf"].items() if k != "Alive"}
    np.testing.assert_array_equal(tst.valid_mask(no_alive).numpy(),
                                  np.asarray(jst.valid_mask(no_alive_j)))
    assert not np.array_equal(tst.valid_mask(s["tf"]).numpy(),
                              tst.valid_mask(no_alive).numpy())


def test_time_steps_mask_by_nreal(scene):
    """The JAX package's fluid time steps mask by index < NReal, not by
    Alive: a dead slot below NReal with a large velocity still sets dt,
    a row past NReal does not.  The port keeps that."""
    s = scene
    raw = s["raw"]
    dead = np.nonzero(~raw["Alive"] & (np.arange(len(raw["Alive"]))
                                       < raw["NReal"]))[0]
    assert len(dead) > 0 and raw["NReal"] < len(raw["Alive"])
    vel = np.array(raw["Velocity"])
    vel[dead[0]] = 50.0          # a dead slot below NReal
    vel[-1] = 500.0              # a row past NReal
    jf = dict(s["jf"], Velocity=jnp.asarray(vel))
    tf = dict(s["tf"], Velocity=torch.as_tensor(vel))
    eos_j, eos_t = s["jcase"].eos, s["tcase"].eos
    h = s["jcase"].adaptation.h
    dj = float(jfd.acoustic_time_step(jf, eos_j, h))
    dt = float(tfd.acoustic_time_step(tf, eos_t, h))
    assert dt == pytest.approx(dj, rel=1e-14)
    assert dt == pytest.approx(0.6 * h / (10.0 + 50.0 * np.sqrt(2)), rel=1e-3)
    aj = float(jfd.advection_viscous_time_step(jf, h, 1.0, 1000.0, 0.01))
    at = float(tfd.advection_viscous_time_step(tf, h, 1.0, 1000.0, 0.01))
    assert at == pytest.approx(aj, rel=1e-14)


# ---------------------------------------------------------------------------
# boundary.py: the disposer and the emitter
# ---------------------------------------------------------------------------

def test_aligned_box_region_contains(scene):
    r = scene["jcase"].disposer
    tr = scene["tcase"].disposer
    assert (tr.lower, tr.upper, tr.axis) == (r.lower, r.upper, r.axis)
    np.testing.assert_array_equal(
        tr.contains(scene["tf"]["Position"]).numpy(),
        np.asarray(r.contains(scene["jf"]["Position"])))


def test_disposer(scene):
    s = scene
    jo = jbd.disposer_outflow_deletion(s["jf"], s["jcase"].disposer)
    to = tbd.disposer_outflow_deletion(s["tf"], s["tcase"].disposer)
    np.testing.assert_array_equal(to["Alive"].numpy(), np.asarray(jo["Alive"]))
    np.testing.assert_array_equal(to["Position"].numpy(),
                                  np.asarray(jo["Position"]))
    gone = s["raw"]["Alive"] & ~to["Alive"].numpy()
    assert gone.sum() > 20
    assert (to["Position"].numpy()[gone] == FAR).all()


def test_ensure_alive_mask_from_nreal():
    pos = np.zeros((10, 2))
    tstate = {"Position": torch.as_tensor(pos), "NReal": 7}
    jstate = {"Position": jnp.asarray(pos), "NReal": jnp.asarray(7, jnp.int32)}
    np.testing.assert_array_equal(tbd.ensure_alive_mask(tstate)["Alive"].numpy(),
                                  np.asarray(jbd.ensure_alive_mask(jstate)["Alive"]))


def _emitter_state(rng, n=240, n_dead=40, n_cross=12):
    """A fluid-like state in [0, 1]^2 with `n_dead` dead rows (parked far),
    and prev positions from which `n_cross` live rows in the band
    y in [0.2, 0.8] cross the plane x = 0.3; more rows cross outside
    the band (transverse misses) and some were past the plane already."""
    pos = rng.random((n, 2))
    alive = np.ones(n, bool)
    alive[rng.choice(n, size=n_dead, replace=False)] = False
    pos[~alive] = FAR
    prev = pos.copy()
    live = np.nonzero(alive)[0]
    cross = rng.choice(live, size=n_cross, replace=False)
    pos[cross, 0] = 0.3 + 0.02 * rng.random(n_cross) + 1e-3
    pos[cross, 1] = 0.2 + 0.6 * rng.random(n_cross)
    prev[cross] = pos[cross]
    prev[cross, 0] = 0.3 - 0.02 * rng.random(n_cross)
    state = {"Position": pos, "Alive": alive, "NReal": n,
             "Velocity": rng.normal(size=(n, 2)),
             "Density": 1.0 + 0.01 * rng.normal(size=n),
             "Mass": rng.random(n), "VolumetricMeasure": rng.random(n),
             "Pressure": rng.normal(size=n),
             "ForcePrior": rng.normal(size=(n, 2)),
             "Indicator": rng.integers(0, 2, size=n).astype(np.int32),
             "ViscousForcePrev": rng.normal(size=(n, 2))}
    return state, prev, cross


REGION = dict(lower=(0.0, 0.2), upper=(0.3, 0.8), axis=0)


def _emit_both(state, prev, **kw):
    jr = jbd.AlignedBoxRegion(**REGION)
    tr = tbd.AlignedBoxRegion(**REGION)
    jo = jbd.emitter_inflow_injection(
        _j(state), jr, prev_pos=None if prev is None else jnp.asarray(prev),
        **kw)
    to = tbd.emitter_inflow_injection(
        _t(state), tr,
        prev_pos=None if prev is None else torch.as_tensor(prev), **kw)
    for k in state:
        if k == "NReal":
            continue
        np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]),
                                      err_msg=k)
    assert bool(to["_InjectionOverflow"]) == bool(jo["_InjectionOverflow"])
    return to


def test_emitter_clones_into_jax_slots():
    rng = np.random.default_rng(3)
    state, prev, cross = _emitter_state(rng)
    to = _emit_both(state, prev)
    alive0 = state["Alive"]
    new = to["Alive"].numpy() & ~alive0
    assert new.sum() == len(cross) and not bool(to["_InjectionOverflow"])
    # the clones sit in the first dead slots, in the crossers' index order
    dead = np.nonzero(~alive0)[0]
    np.testing.assert_array_equal(np.nonzero(new)[0], dead[:len(cross)])
    src = np.sort(cross)
    np.testing.assert_array_equal(to["Position"].numpy()[dead[:len(cross)]],
                                  state["Position"][src])
    np.testing.assert_allclose(to["Position"].numpy()[src, 0],
                               state["Position"][src, 0] - 0.3, rtol=0,
                               atol=1e-15)


def test_emitter_clones_inherit_hinted_fields_only():
    """The clone's fields outside _PARTICLE_FIELDS_HINT keep the dead
    slot's old values, as in the JAX package."""
    rng = np.random.default_rng(4)
    state, prev, cross = _emitter_state(rng)
    to = _emit_both(state, prev)
    dead = np.nonzero(~state["Alive"])[0][:len(cross)]
    src = np.sort(cross)
    np.testing.assert_array_equal(to["Velocity"].numpy()[dead],
                                  state["Velocity"][src])
    np.testing.assert_array_equal(to["Indicator"].numpy()[dead],
                                  state["Indicator"][dead])
    np.testing.assert_array_equal(to["ViscousForcePrev"].numpy()[dead],
                                  state["ViscousForcePrev"][dead])


def test_emitter_overflow():
    """More crossers than dead slots: every crosser moves back, the first
    n_dead get clones, the flag is set (and or-ed with an earlier one)."""
    rng = np.random.default_rng(5)
    state, prev, cross = _emitter_state(rng, n_dead=4, n_cross=10)
    to = _emit_both(state, prev)
    assert bool(to["_InjectionOverflow"])
    assert to["Alive"].numpy().all()
    rng = np.random.default_rng(5)
    state2, prev2, _ = _emitter_state(rng, n_dead=40, n_cross=3)
    state2["_InjectionOverflow"] = np.asarray(True)
    assert bool(_emit_both(state2, prev2)["_InjectionOverflow"])


def test_emitter_without_prev_pos():
    """prev_pos=None: a live row in the band within half the emitter's
    length past the plane respawns (also with a band of its own)."""
    rng = np.random.default_rng(6)
    state, _, cross = _emitter_state(rng)
    to = _emit_both(state, None)
    assert (to["Alive"].numpy() & ~state["Alive"]).sum() >= len(cross)
    _emit_both(state, None, crossing_band=0.05)


def test_emitter_without_alive_field():
    rng = np.random.default_rng(7)
    state, prev, _ = _emitter_state(rng, n_dead=0)
    state["NReal"] = 200
    del state["Alive"]
    state["Position"][200:] = FAR
    jo = jbd.emitter_inflow_injection(_j(state), jbd.AlignedBoxRegion(**REGION),
                                      prev_pos=jnp.asarray(prev))
    to = tbd.emitter_inflow_injection(_t(state), tbd.AlignedBoxRegion(**REGION),
                                      prev_pos=torch.as_tensor(prev))
    for k in ("Alive", "Position", "Velocity"):
        np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]))


# ---------------------------------------------------------------------------
# the T-pipe
# ---------------------------------------------------------------------------

T_PIPE_T = 1.0     # the emitter has injected by then (1,460 -> 1,488 alive)


def test_t_pipe_build_matches_jax():
    jc, jf = jtp.build_case(dtype=jnp.float64)
    tc, tf = ttp.build_case(dtype=torch.float64, device="cpu")
    assert tc.n_fluid == 1460 and tf["NReal"] == int(jf["NReal"]) == 2190
    _hold_state(tf, jf, ("Position", "Alive", "Indicator",
                         "PreviousSurfaceIndicator", "Mass",
                         "VolumetricMeasure"))
    _hold_state(tc.wall, jc.wall, ("Position", "NormalDirection"))
    np.testing.assert_array_equal(tc.wall_table.table.numpy(),
                                  np.asarray(jc.wall_table.table))


def test_t_pipe_run_matches_jax():
    jc, jf = jtp.build_case(dtype=jnp.float64)
    js = jtp.make_run_chunk(jc)(jtp.init_sim(jc, jf),
                                jnp.asarray(T_PIPE_T, jnp.float64))
    tc, tf = ttp.build_case(dtype=torch.float64, device="cpu")
    ts = ttp.make_run_chunk(tc)(ttp.init_sim(tc, tf), T_PIPE_T)
    assert ts.n_adv == int(js.n_adv) == 18
    assert not bool(ts.overflow) and not bool(js.overflow)
    assert ttp.n_alive(ts) == jtp.n_alive(js) == 1488
    _hold_state(ts.fluid, js.fluid, ("Alive", "Indicator"))
    jp = np.asarray(js.fluid["Position"])
    alive = np.asarray(js.fluid["Alive"])
    err = np.abs(ts.fluid["Position"].numpy() - jp)[alive].max()
    assert err <= POS_TOL * np.abs(jp[alive]).max()
    np.testing.assert_array_equal(ts.fluid["Position"].numpy()[~alive],
                                  jp[~alive])
    assert ttp.kinetic_energy(ts) == pytest.approx(jtp.kinetic_energy(js),
                                                   rel=1e-9)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _vtp_arrays(path):
    piece = ET.parse(path).getroot()[0][0]
    out = {}
    for parent, key in (("Points", None), ("PointData", "Name")):
        for da in piece.find(parent):
            out[da.attrib[key] if key else "Points"] = da.text.split()
    return out


CLI_RUNS = {
    "t_pipe_2d": ("t_end=0.2",),
    "fish_undulation_2d": ("dx=0.01", "t_end=0.002"),
    "fish_fsi_2d": ("dx=0.01", "t_end=0.005"),
}


def hold_cli_run(case, tmp_path, caplog):
    """`python -m sphinxsys_tpu_torch.run <case>` against JAX's runner
    (CLI_RUNS' parameters):
    * the frame of the built state (t_end = 0, float32) byte-equal, every
      body (the T-pipe water's parked reserve rows among its NReal rows);
    * a float64 frame after a few steps: the same file names, the fish's
      and the wall's files byte-equal, every body's points and densities
      byte-equal (the water's deleted slots at FAR_AWAY among them); the
      water's velocity and pressure within 1e-10 of their max, where
      "%.7g" of float64 roundoff-level values (1e-13 of 1) differs."""
    sets = CLI_RUNS[case]
    for tag, extra in (("built", ("t_end=0", "n_output=1")),
                       ("f64", (*sets, "n_output=1", "dtype=float64"))):
        args = [x for kv in (*sets, *extra) for x in ("--set", kv)]
        jd, td = str(tmp_path / tag / "jax"), str(tmp_path / tag / "port")
        with caplog.at_level(logging.INFO):
            assert jrun.main([case, *args, "--output_dir", jd]) == 0
            assert trun.main([case, *args, "--set", "device=cpu",
                              "--output_dir", td]) == 0
        names = sorted(os.listdir(jd))
        assert names and names == sorted(os.listdir(td))
        for name in names:
            same = filecmp.cmp(os.path.join(jd, name), os.path.join(td, name),
                               shallow=False)
            if tag == "built" or not name.startswith("WaterBody"):
                assert same, (tag, name)
                continue
            ja = _vtp_arrays(os.path.join(jd, name))
            ta = _vtp_arrays(os.path.join(td, name))
            assert sorted(ja) == sorted(ta)
            assert ta["Points"] == ja["Points"] and ta["Density"] == ja["Density"]
            assert "1e+16" in ja["Points"]
            for k in ("Velocity", "Pressure"):
                _close(np.asarray(ta[k], float), np.asarray(ja[k], float),
                       1e-10, (name, k))


def test_cli_matches_jax(tmp_path, caplog):
    """The T-pipe's CLI entry (the fish's: tests/test_torch_fish.py)."""
    hold_cli_run("t_pipe_2d", tmp_path, caplog)
