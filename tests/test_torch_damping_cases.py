"""Parity of the port's seven damping-family cases with the JAX package, on
the CPU in float64 (collision_2d, sliding_2d,
passive_cantilever_neohookean_3d, stretching_2d, muscle_solid_contact_3d,
twisting_rigid_elastic_bar_3d, slender_beam_3d), at reduced widths.

For each case: the builds held to each other (every field of every body
at 1e-12, and the frozen pairs); a few steps from them with equal step
counts and every field of every body within 1e-9 of its max, the rigid
body and the slider too; one more step from JAX's own state carried
across (`convert.sim_from_numpy`); the CLI entry with `--set device=cpu`.
For stretching_2d the runs are three macro steps (1, 1 and 26 sub-steps),
and the sub-step count of each is held equal to JAX's (its gated loop driven eagerly, its state
held to JAX's run first).

`JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_damping_cases.py`
writes the JAX package's own CPU curves that
`sphinxsys_tpu_torch/benchmarks/a7e_damping_long.py` holds the card's
runs to (tests/golden_torch/passive_cantilever_neohookean_3d and
muscle_solid_contact_3d, float32 and float64, ~1 min).
"""

import functools
import json
import os
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_corrected_cases import cli_runs, close, mods, start

from sphinxsys_tpu_torch import convert

torch.set_num_threads(1)

POS_TOL = 1e-9
ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden_torch"

# case -> (build keywords of both packages, run end time, CLI sets, the
# sim's bodies (state dicts), the CLI's body names, the sim's other
# leaves held)
CASES = {
    "collision_2d": (dict(dx=0.1), 0.04, ("dx=0.1", "t_end=0.02"),
                     ("free_ball", "damping_ball"),
                     ("FreeBall", "DampingBall", "WallBoundary"), ()),
    "sliding_2d": (dict(), 0.006, ("t_end=0.003",), ("cube",),
                   ("FreeCube", "WallBoundary"), ()),
    "passive_cantilever_neohookean_3d": (
        dict(dx=0.01), 0.004, ("dx=0.01", "t_end=0.002"), ("body",),
        ("CantileverBody",), ()),
    "stretching_2d": (dict(), 0.03, ("t_end=0.01",), ("bar",),
                      ("StretchingBody",), ()),
    "muscle_solid_contact_3d": (
        dict(dx=0.04 / 6), 1e-3, ("dx=0.006667", "t_end=5e-4"),
        ("myo", "plate"), ("MyocardiumBody", "MovingPlate"),
        ("q", "u", "dt")),
    "twisting_rigid_elastic_bar_3d": (
        dict(res_factor=1), 0.006, ("res_factor=1", "t_end=0.003"),
        ("bar",), ("Bar",), ("dt",)),
    "slender_beam_3d": (dict(), 0.003, ("t_end=0.0015",), ("bar",),
                        ("BarBody",), ("dt",)),
}
COUNTS = ("n_steps", "n_macro")


def _bodies(states):
    """The built state dicts: a build's bodies, the collision's pair, or
    the bodies of a build's own sim."""
    out = []
    for s in states:
        if isinstance(s, dict):
            out.append(s)
        elif isinstance(s, tuple) and not hasattr(s, "_fields"):
            out.extend(s)
        else:
            out.extend(v for v in s if isinstance(v, dict))
    return out


@functools.lru_cache(maxsize=None)
def runs(name):
    """Both packages' builds and their runs to the case's end time; JAX's
    run_chunk compiled once and kept for the next step."""
    kw, t_end = CASES[name][:2]
    jm, tm = mods(name)
    jc, *jst = jm.build_case(dtype=jnp.float64, **kw)
    tc, *tst = tm.build_case(dtype=torch.float64, device="cpu", **kw)
    jrun = jm.make_run_chunk(jc)
    js = jrun(start(jm, jc, jst), jnp.asarray(t_end, jnp.float64))
    ts = tm.make_run_chunk(tc)(start(tm, tc, tst), t_end)
    return jm, tm, jc, tc, jst, tst, js, ts, jrun


# a field whose largest entry is below this is roundoff of a zero (the
# slender bar's binormal angular acceleration, ~1e-14): it is held to
# it, not to a share of itself
ROUNDOFF = 1e-12


def hold_body(tb, jb, tol, what):
    assert set(jb) <= set(tb), set(jb) - set(tb)
    for k, v in jb.items():
        if k == "NReal":
            assert tb[k] == int(v), what
        elif np.abs(np.asarray(v, np.float64)).max(initial=0.0) < ROUNDOFF:
            err = np.abs(tb[k].double().numpy() - np.asarray(v)).max(
                initial=0.0)
            assert err < ROUNDOFF, (what, k, err)
        else:
            close(tb[k], v, tol, what=(what, k))


def hold_sims(name, js, ts):
    for k in COUNTS:
        if hasattr(js, k):
            assert getattr(ts, k) == int(getattr(js, k)), k
    assert float(ts.time) == pytest.approx(float(js.time), rel=1e-12)
    if hasattr(js, "overflow"):
        assert not bool(ts.overflow) and not bool(js.overflow)
    for body in CASES[name][3]:
        hold_body(getattr(ts, body), getattr(js, body), POS_TOL, body)
    for leaf in CASES[name][5]:
        close(getattr(ts, leaf), getattr(js, leaf), POS_TOL, leaf)
    if hasattr(js, "rb"):
        for k, v in js.rb._asdict().items():
            close(getattr(ts.rb, k), v, POS_TOL, ("rb", k))


@pytest.mark.parametrize("name", sorted(CASES))
def test_build_matches_jax(name):
    _, _, jc, tc, jst, tst, _, _, _ = runs(name)
    jb, tb = _bodies(jst), _bodies(tst)
    assert len(jb) == len(tb) > 0
    for i, (j, t) in enumerate(zip(jb, tb)):
        hold_body(t, j, 1e-12, i)
    for rp in ("rp", "rp_free", "rp_damp"):
        if hasattr(jc, rp):
            jr, tr = getattr(jc, rp), getattr(tc, rp)
            np.testing.assert_array_equal(tr.idx.numpy(), np.asarray(jr.idx))
            for k in ("W", "dW", "r", "e"):
                close(getattr(tr, k), getattr(jr, k), what=(rp, k))
    for nl in ("nl", "nl_inner", "nl_damp", "nl_damp_inner"):
        if hasattr(jc, nl):
            np.testing.assert_array_equal(getattr(tc, nl).idx.numpy(),
                                          np.asarray(getattr(jc, nl).idx))
    for mask in ("holder_mask", "clamp_mask", "rigid_mask", "end_mask",
                 "left_mask", "right_mask"):
        if hasattr(jc, mask):
            np.testing.assert_array_equal(getattr(tc, mask).numpy(),
                                          np.asarray(getattr(jc, mask)))
    if hasattr(jc, "wall"):
        hold_body(tc.wall, jc.wall, 1e-12, "wall")
    if hasattr(jc, "rb0"):
        for k, v in jc.rb0._asdict().items():
            close(getattr(tc.rb0, k), v, what=("rb0", k))


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_matches_jax(name):
    _, _, _, _, _, _, js, ts, _ = runs(name)
    assert max(getattr(ts, k, 0) for k in COUNTS) >= 2
    hold_sims(name, js, ts)


@pytest.mark.parametrize("name", sorted(CASES))
def test_continues_jax_state(name):
    jm, tm, jc, tc, _, _, js, ts_own, jrun = runs(name)
    js = js._replace(**{k: jnp.zeros((), jnp.int32) for k in COUNTS
                        if hasattr(js, k)})
    ts = convert.sim_from_numpy(type(ts_own),
                                jax.tree_util.tree_map(np.asarray, js))
    target = float(js.time) + 1e-12
    js1 = jrun(js, jnp.asarray(target, jnp.float64))
    ts1 = tm.make_run_chunk(tc)(ts, target)
    assert max(getattr(ts1, k, 0) for k in COUNTS) == 1
    hold_sims(name, js1, ts1)


@pytest.mark.parametrize("name", sorted(CASES))
def test_cli_entry_runs_on_the_cpu(name, tmp_path, caplog):
    _, _, _, tc, _, tst, _, _, _ = runs(name)
    names = CASES[name][4]
    bodies = _bodies(tst)
    n_real = {b: bodies[i]["NReal"] for i, b in enumerate(names)
              if i < len(bodies)}
    if hasattr(tc, "wall"):
        n_real[names[-1]] = tc.wall["NReal"]
    cli_runs(name, CASES[name][2], names, tmp_path, caplog, n_real)


def jax_substeps(case, bar, n_macro):
    """JAX's stretching macro steps driven eagerly (its own functions, its
    gated loop on the host): (bar, the sub-step count of each)."""
    from sphinxsys_tpu.cases import stretching_2d as jst
    from sphinxsys_tpu.physics import dissipation as jdp
    from sphinxsys_tpu.physics import solid as jsd

    @jax.jit
    def sub(b):
        h = case.adaptation.h
        dt = jsd.solid_acoustic_time_step(b, case.material.sound_speed, h)
        b = jsd.decomposed_plastic_integration_1st_half(b, case.rp,
                                                        case.material, dt, h)
        b = jst._constrain_x(case, b)
        b = jdp.damping_pairwise(b, "Velocity", case.nl_inner, case.kernel,
                                 2, jst.PHYSICAL_VISCOSITY, jst.DT_MACRO)
        b = jst._constrain_x(case, b)
        b = jsd.integration_2nd_half(b, case.rp, dt)
        ke = 0.5 * jnp.sum(b["Mass"] * jnp.sum(b["Velocity"] ** 2, axis=1))
        return b, dt, ke / jst.REFER_ENERGY

    counts = []
    shift = jst.PULL_RATE * jst.DT_MACRO
    for _ in range(n_macro):
        bar = dict(bar)
        dxs = jnp.where(case.left_mask, -shift, 0.0) + \
            jnp.where(case.right_mask, shift, 0.0)
        bar["Position"] = bar["Position"].at[:, 0].add(dxs)
        bar = jsd.deformation_gradient_by_summation(bar, case.rp)
        rel = jnp.zeros((), jnp.float64)
        ke = jnp.full((), 1.0e4, jnp.float64)
        n = 0
        while bool((rel < jst.DT_MACRO) & (ke > jst.KE_GATE)):
            bar, dt, ke = sub(bar)
            rel = rel + dt
            n += 1
        counts.append(n)
    return bar, counts


def test_stretching_substeps_match_jax():
    """The three macro steps' sub-step counts equal JAX's (the third's
    > 1: the gate closed on the kinetic energy)."""
    _, tm, jc, tc, jst, tst, js, ts, _ = runs("stretching_2d")
    jbar, counts = jax_substeps(jc, jst[0], 3)
    hold_body(convert.state_from_numpy({k: np.asarray(v)
                                        for k, v in jbar.items()}),
              js.bar, POS_TOL, "eager")
    assert ts.n_sub == sum(counts) and min(counts) >= 1
    assert max(counts) > 1


def test_stretching_von_mises_kirchhoff():
    jm, tm, jc, tc, _, _, js, ts, _ = runs("stretching_2d")
    close(tm.von_mises_kirchhoff(tc, ts.bar), jm.von_mises_kirchhoff(jc, js.bar),
          POS_TOL)


def test_observers_match_jax():
    """The cases' observers on the runs' end states."""
    jm, tm, jc, tc, jst, tst, js, ts, _ = runs(
        "passive_cantilever_neohookean_3d")
    close(tm.observe_corner(ts, *tm.corner_observer(tc, tst[0])),
          jm.observe_corner(js, *jm.corner_observer(jc, jst[0])), POS_TOL)
    jm, tm, jc, tc, jst, tst, js, ts, _ = runs("sliding_2d")
    close(tm.observe_position(ts, *tm.cube_observer(tc, tst[0])),
          jm.observe_position(js, *jm.cube_observer(jc, jst[0])), POS_TOL)
    p0 = np.asarray(jnp.mean(jst[0]["Position"], axis=0))
    assert tm.slide_distance(ts, p0) == pytest.approx(
        jm.slide_distance(js, p0), rel=1e-9)
    jm, tm, jc, tc, _, _, js, ts, _ = runs("collision_2d")
    close(tm.ball_center(ts.damping_ball), jm.ball_center(js.damping_ball),
          POS_TOL)
    jm, tm, jc, tc, _, _, js, ts, _ = runs("muscle_solid_contact_3d")
    assert tm.kinetic_energy(ts) == pytest.approx(jm.kinetic_energy(js),
                                                  rel=1e-9)
    jm, tm, jc, tc, _, _, js, ts, _ = runs("twisting_rigid_elastic_bar_3d")
    close(tm.observer_displacements(tc, ts),
          jm.observer_displacements(jc, js), POS_TOL)
    jm, tm, jc, tc, _, _, js, ts, _ = runs("slender_beam_3d")
    assert tm.midspan_displacement(tc, ts) == pytest.approx(
        jm.midspan_displacement(jc, js), rel=1e-9)


def test_twisting_damping_list_leaves_out_rigid_pairs():
    _, _, _, tc, _, _, _, _, _ = runs("twisting_rigid_elastic_bar_3d")
    idx = tc.nl_damp.idx
    n = tc.n_bar
    rigid = tc.rigid_mask
    assert bool((idx[rigid] == n).all())
    j = idx[idx < n].long()
    assert not bool(rigid[j].any())
    assert int((tc.rp.idx < n).sum()) > int((idx < n).sum())


# ---------------------------------------------------------------------------
# the JAX package's own curves for the card's long runs
# ---------------------------------------------------------------------------

CURVES = {
    # case -> (the sample interval or step cadence, the end time)
    "passive_cantilever_neohookean_3d": (0.02, 1.0),
    "muscle_solid_contact_3d": (100, 0.1),
}


def jax_curve(name, dtype):
    """The JAX case at its default width in `dtype` on the CPU: the
    cantilever's corner y every 0.02 to t = 1, or the muscle cube's
    kinetic energy every 100 steps to t = 0.1 (the reference database's
    cadences).  Returns (times, values)."""
    from sphinxsys_tpu.cases import muscle_solid_contact_3d as jms
    from sphinxsys_tpu.cases import passive_cantilever_neohookean_3d as jpn

    every, t_end = CURVES[name]
    if name == "passive_cantilever_neohookean_3d":
        case, body = jpn.build_case(dtype=dtype)
        s = jpn.init_sim(case, body)
        obs = jpn.corner_observer(case, body)
        run = jpn.make_run_chunk(case)
        times, vals = [0.0], [float(jpn.observe_corner(s, *obs)[1])]
        for i in range(1, int(round(t_end / every)) + 1):
            s = run(s, jnp.asarray(i * every, dtype))
            times.append(float(s.time))
            vals.append(float(jpn.observe_corner(s, *obs)[1]))
        return times, vals
    case, s = jms.build_case(dtype=dtype)
    step = jax.jit(lambda st: jms._step(case, st))
    times, vals = [0.0], [jms.kinetic_energy(s)]
    while float(s.time) < t_end:
        for _ in range(every):
            s = step(s)
        times.append(float(s.time))
        vals.append(jms.kinetic_energy(s))
    return times, vals


def write_jax_curves():
    for name in CURVES:
        out = {"case": name, "what": ("corner y" if "cantilever" in name
                                      else "kinetic energy"),
               "written_by": "tests/test_torch_damping_cases.py"}
        for tag, dtype in (("f32", jnp.float32), ("f64", jnp.float64)):
            out[f"{tag}_times"], out[tag] = jax_curve(name, dtype)
        d = GOLDEN / name
        os.makedirs(d, exist_ok=True)
        (d / "jax_curves.json").write_text(json.dumps(out, indent=1) + "\n")
        print(name, len(out["f32"]), len(out["f64"]))


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    write_jax_curves()
