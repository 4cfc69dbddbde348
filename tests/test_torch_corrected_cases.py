"""Parity of the port's four kernel-corrected fluid cases with the JAX
package, on the CPU in float64 (standing_wave_2d, poiseuille_flow_2d,
impact_patch_2d, rotation_patch_2d), at reduced widths.

For each case: the builds held to each other (every field at 1e-12); a
few advection steps from them with equal step counts, positions,
velocities and densities within 1e-9 of their max and the case's
observable (the gauge, the kinetic energy); one more step from JAX's own
state, carried across by `convert.sim_from_numpy`; and the CLI entry with
`--set device=cpu`, its frames named and sized as the JAX runner's.
The helpers here serve tests/test_torch_solid_cases.py too.
"""

import functools
import importlib
import logging
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sphinxsys_tpu_torch import convert, run as trun

torch.set_num_threads(1)

TOL = 1e-12
POS_TOL = 1e-9

# case -> (build keywords of both packages, run end time, CLI sets, the
# sim's bodies)
CASES = {
    "standing_wave_2d": (dict(dx=0.1), 0.03, ("dx=0.1", "t_end=0.02"),
                         ("fluid",)),
    "poiseuille_flow_2d": (dict(dx=0.1), 0.1, ("dx=0.1", "t_end=0.05"),
                           ("fluid",)),
    "impact_patch_2d": (dict(dx=0.667 / 10), 0.02,
                        ("dx=0.0667", "t_end=0.01"), ("fluid",)),
    "rotation_patch_2d": (dict(dx=0.05), 0.05, ("dx=0.05", "t_end=0.02"),
                          ("fluid",)),
}
# the CLI's body names (the JAX runner's)
CLI_BODIES = {"standing_wave_2d": ("WaterBody", "Wall"),
              "poiseuille_flow_2d": ("WaterBody", "Wall"),
              "impact_patch_2d": ("WaterBody",),
              "rotation_patch_2d": ("WaterBody",)}
STATE_KEYS = ("Position", "Velocity", "Density", "Pressure",
              "DeformationGradient", "LinearGradientCorrectionMatrix",
              "ActiveContractionStress")


def close(got, ref, tol=TOL, what=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-300), (what, err)


def mods(name):
    return (importlib.import_module(f"sphinxsys_tpu.cases.{name}"),
            importlib.import_module(f"sphinxsys_tpu_torch.cases.{name}"))


def start(mod, case, states):
    """The sim of a build: init_sim's, or the build's own (the beams)."""
    return mod.init_sim(case, *states) if hasattr(mod, "init_sim") \
        else states[0]


def body_states(states):
    """The built state dicts (a beam's build returns its sim)."""
    return [s if isinstance(s, dict) else s.solid for s in states]


# case -> (build keywords, run end time): this file's and
# tests/test_torch_solid_cases.py's
RUNS = {name: v[:2] for name, v in CASES.items()}


@functools.lru_cache(maxsize=None)
def runs(name):
    """Both packages' builds and their runs to the case's end time; JAX's
    run_chunk compiled once and kept for the next step."""
    kw, t_end = RUNS[name]
    jm, tm = mods(name)
    jc, *jst = jm.build_case(dtype=jnp.float64, **kw)
    tc, *tst = tm.build_case(dtype=torch.float64, device="cpu", **kw)
    jrun = jm.make_run_chunk(jc)
    js = jrun(start(jm, jc, jst), jnp.asarray(t_end, jnp.float64))
    ts = tm.make_run_chunk(tc)(start(tm, tc, tst), t_end)
    return jm, tm, jc, tc, jst, tst, js, ts, jrun


def hold_sims(bodies, js, ts, counts=("n_adv", "n_ac", "n_steps")):
    for k in counts:
        if hasattr(js, k):
            assert getattr(ts, k) == int(getattr(js, k)), k
    assert float(ts.time) == pytest.approx(float(js.time), rel=1e-12)
    if hasattr(js, "overflow"):
        assert not bool(ts.overflow) and not bool(js.overflow)
    for body in bodies:
        jb, tb = getattr(js, body), getattr(ts, body)
        for k in STATE_KEYS:
            if k in jb:
                close(tb[k], jb[k], POS_TOL, what=(body, k))


def hold_build(jst, tst):
    for jb, tb in zip(body_states(jst), body_states(tst)):
        assert set(jb) <= set(tb), set(jb) - set(tb)
        assert tb["NReal"] == int(jb["NReal"])
        for k, v in jb.items():
            if k != "NReal":
                close(tb[k], v, what=k)


def continue_one_step(jm, tm, js, ts_own, jrun, tc):
    """JAX's state after its run carried across, one more step on each
    side (JAX's compiled run_chunk to just past its time)."""
    js = js._replace(**{k: jnp.zeros((), jnp.int32)
                        for k in ("n_adv", "n_ac", "n_steps")
                        if hasattr(js, k)})
    ts = convert.sim_from_numpy(type(ts_own),
                                jax.tree_util.tree_map(np.asarray, js))
    target = float(js.time) + 1e-9
    js1 = jrun(js, jnp.asarray(target, jnp.float64))
    ts1 = tm.make_run_chunk(tc)(ts, target)
    assert ts1.n_adv == 1 if hasattr(ts1, "n_adv") else ts1.n_steps == 1
    return js1, ts1


def vtp_points(path) -> int:
    text = open(path).read()
    return int(re.search(r'NumberOfPoints="(\d+)"', text).group(1))


def cli_runs(case, sets, bodies, tmp_path, caplog, n_real):
    """`python -m sphinxsys_tpu_torch.run <case>` on the CPU: exit 0, two
    frames of each of the JAX runner's bodies, each with its body's
    NReal points."""
    args = [x for kv in (*sets, "n_output=2", "dtype=float64", "device=cpu")
            for x in ("--set", kv)]
    out = tmp_path / case
    with caplog.at_level(logging.INFO):
        assert trun.main([case, *args, "--output_dir", str(out)]) == 0
    names = sorted(os.listdir(out))
    assert names == sorted(f"{b}_{i:06d}.vtp" for b in bodies
                           for i in (1, 2))
    for b in bodies:
        assert vtp_points(out / f"{b}_000002.vtp") == n_real[b], b


@pytest.mark.parametrize("name", sorted(CASES))
def test_build_matches_jax(name):
    _, _, jc, tc, jst, tst, _, _, _ = runs(name)
    hold_build(jst, tst)
    for k in ("n_fluid", "n_wall"):
        if hasattr(jc, k):
            assert getattr(tc, k) == getattr(jc, k), k
    if hasattr(jc, "wall"):
        for k in ("Position", "NormalDirection", "VolumetricMeasure"):
            close(tc.wall[k], jc.wall[k], what=("wall", k))


def _observable(name, mod, case, s):
    if name == "standing_wave_2d":
        return float(mod.free_surface_height(case, s.fluid))
    return mod.kinetic_energy(s)


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_matches_jax(name):
    jm, tm, jc, tc, _, _, js, ts, _ = runs(name)
    assert ts.n_adv >= 3
    hold_sims(CASES[name][3], js, ts)
    close(_observable(name, tm, tc, ts), _observable(name, jm, jc, js),
          POS_TOL, "observable")
    # the correction ran: B is not the identity
    B = ts.fluid["LinearGradientCorrectionMatrix"]
    assert float((B - torch.eye(2, dtype=B.dtype)).abs().max()) > 1e-3


@pytest.mark.parametrize("name", sorted(CASES))
def test_continues_jax_state(name):
    jm, tm, jc, tc, _, _, js, ts, jrun = runs(name)
    js1, ts1 = continue_one_step(jm, tm, js, ts, jrun, tc)
    hold_sims(CASES[name][3], js1, ts1)


@pytest.mark.parametrize("name", sorted(CASES))
def test_cli_entry_runs_on_the_cpu(name, tmp_path, caplog):
    _, _, _, tc, _, tst, _, _, _ = runs(name)
    n_real = {"WaterBody": tst[0]["NReal"]}
    if hasattr(tc, "wall"):
        n_real["Wall"] = tc.wall["NReal"]
    cli_runs(name, CASES[name][2], CLI_BODIES[name], tmp_path, caplog,
             n_real)


def test_standing_wave_gauge_and_period():
    """The gauge at the build (the trough, ~0.9) equal on both sides, and
    the analytic period."""
    jm, tm, jc, tc, jst, tst, js, ts, _ = runs("standing_wave_2d")
    h0 = float(tm.free_surface_height(tc, tst[0]))
    assert h0 == float(jm.free_surface_height(jc, jst[0]))
    assert 0.8 < h0 < 1.0
    assert tm.T1 == jm.T1 and abs(tm.T1 - 1.134) < 1e-3


def test_poiseuille_profile_helpers():
    jm, tm, jc, tc, _, _, js, ts, _ = runs("poiseuille_flow_2d")
    ys = np.linspace(0.0, 1.0, 11)
    close(tm.analytic_profile(ys, 0.7), jm.analytic_profile(ys, 0.7))
    for a, b in zip(tm.mean_profile(tc, ts), jm.mean_profile(jc, js)):
        close(a, b, POS_TOL)
    # x stays inside the box: the positions are wrapped at each rebuild
    x = ts.fluid["Position"][:, 0]
    assert float(x.min()) >= 0.0 and float(x.max()) < tm.DL


def test_patches_carry_the_indicator():
    """The spatial-temporal indication's fields after the runs: equal
    Indicator masks, and some surface rows."""
    for name in ("impact_patch_2d", "rotation_patch_2d"):
        _, _, _, _, _, _, js, ts, _ = runs(name)
        for k in ("Indicator", "PreviousSurfaceIndicator"):
            np.testing.assert_array_equal(ts.fluid[k].numpy(),
                                          np.asarray(js.fluid[k]))
        assert 0 < int(ts.fluid["Indicator"].sum()) < ts.fluid["NReal"]
