"""Parity of the port's four rigid-body cases with the JAX package, on the
CPU in float64 (floating_body_2d, stfb_2d, owsc_2d,
nonlinear_wave_fsi_2d), at reduced widths.

For each case, as tests/test_torch_corrected_cases.py does (whose
helpers these are): the builds held to each other (1e-12), the rigid
body or pin joint too; a few advection steps with equal counts, the
fluid's, the wall's and the body's positions, velocities and densities
within 1e-9 of their max, and the rigid state; one more step from JAX's
carried state; the CLI entry with `--set device=cpu`.

stfb's run starts with a 0.05 s hold (init_sim's `settle_time`, 1 s by
default).  The wave cases hold their wavemaker and body for the first
second of total time: their runs start at a total time of 0.99, so that
the steps cross the release.  The CLI runs start the same way, through
the module's `init_sim`: stfb with a settling window of 0.05 s, the wave
cases 0.02 s before the release (they run to a physical time).

Run as a script (`JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_rigid_cases.py`, ~7 min), it writes stfb's float32
witness, `tests/golden_torch/stfb_2d/f32_spread.json`
(`write_stfb_f32_spread`).
"""

import dataclasses
import functools
import json
import os
import platform
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sphinxsys_tpu_torch import convert

from test_torch_corrected_cases import (POS_TOL, TOL, cli_runs, close,
                                        continue_one_step, hold_build,
                                        hold_sims, mods)

torch.set_num_threads(1)

# case -> (build keywords, the sim's bodies and rigid state, the CLI's sets
# and body names)
CASES = {
    "floating_body_2d": (dict(dx=0.05), ("fluid", "block"), "rb",
                         ("dx=0.05", "t_end=0.01"),
                         ("WaterBody", "Block", "Wall")),
    "stfb_2d": (dict(dx=0.1), ("fluid", "block"), "rb",
                ("dx=0.1", "t_end=0.01"),
                ("WaterBody", "Structure", "Wall")),
    "owsc_2d": (dict(dx=0.12), ("fluid", "wall", "flap"), "pj",
                ("dx=0.12", "t_end=0.01"),
                ("WaterBody", "Flap", "Wall")),
    "nonlinear_wave_fsi_2d": (dict(dx=0.12), ("fluid", "wall", "block"), "rb",
                              ("dx=0.12", "t_end=0.01"),
                              ("WaterBody", "Structure", "Wall")),
}
WAVE = ("owsc_2d", "nonlinear_wave_fsi_2d")
SETTLE = 0.05          # stfb's hold
RUN_T = {"floating_body_2d": 0.05, "stfb_2d": 0.03}
WAVE_STEPS, WAVE_T0 = 4, 0.99
CLI_HOLD = {"stfb_2d": SETTLE, "owsc_2d": 0.02, "nonlinear_wave_fsi_2d": 0.02}


def _start(name, mod, case, fluid, j):
    if name == "stfb_2d":
        return mod.init_sim(case, fluid, settle_time=SETTLE)
    s = mod.init_sim(case, fluid)
    if name in WAVE:
        if j:
            return s._replace(total_time=jnp.asarray(WAVE_T0))
        s.total_time = torch.tensor(WAVE_T0, dtype=torch.float64)
    return s


@functools.lru_cache(maxsize=None)
def runs(name):
    """Both packages' builds and runs: to RUN_T, or WAVE_STEPS steps
    across the release; JAX's compiled run_chunk (or step) kept for one
    more."""
    kw = CASES[name][0]
    jm, tm = mods(name)
    jc, jf = jm.build_case(dtype=jnp.float64, **kw)
    tc, tf = tm.build_case(dtype=torch.float64, device="cpu", **kw)
    js = _start(name, jm, jc, jf, True)
    ts = _start(name, tm, tc, tf, False)
    if name in WAVE:
        jstep = jax.jit(lambda s: jm._advection_step(jc, s))
        tstep = tm.make_advection_step(tc)
        for _ in range(WAVE_STEPS):
            js, ts = jstep(js), tstep(ts)
        # one more step is one compiled step (the runs are past release)
        jrun = lambda s, target: jstep(s)           # noqa: E731
    else:
        jrun = jm.make_run_chunk(jc)
        js = jrun(js, jnp.asarray(RUN_T[name], jnp.float64))
        ts = tm.make_run_chunk(tc)(ts, RUN_T[name])
    return jm, tm, jc, tc, jf, tf, js, ts, jrun


def hold_rigid(t, j, tol=POS_TOL):
    """A rigid body or pin joint, field by field, within tol of the
    field's max|ref|; the angle and the angular velocity of a body that
    stays level (the floating block: its torque is roundoff) within tol
    of 1e-3 rad and rad/s, 1e-6 of its heave's scale."""
    for k, v in j._asdict().items():
        v = np.asarray(v)
        scale = max(np.abs(v).max(), 1e-3 if k in ("theta", "omega")
                    else 1e-300)
        err = np.abs(getattr(t, k).numpy() - v).max()
        assert err <= tol * scale, (k, err)


def hold_extras(name, js, ts, tol=POS_TOL):
    for k in ("total_time", "pto_energy", "visc_force", "tension"):
        if hasattr(js, k):
            close(getattr(ts, k), getattr(js, k), tol, k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_build_matches_jax(name):
    _, _, jc, tc, jf, tf, _, _, _ = runs(name)
    hold_build([jf], [tf])
    body0 = "flap0" if name == "owsc_2d" else "block0"
    hold_build([getattr(jc, body0)], [getattr(tc, body0)])
    hold_rigid(getattr(tc, "pj0" if name == "owsc_2d" else "rb0"),
               getattr(jc, "pj0" if name == "owsc_2d" else "rb0"), TOL)
    wall_j = jc.wall0 if name in WAVE else jc.wall
    wall_t = tc.wall0 if name in WAVE else tc.wall
    hold_build([wall_j], [wall_t])
    if name in WAVE:
        np.testing.assert_array_equal(tc.maker_mask.numpy(),
                                      np.asarray(jc.maker_mask))
        assert bool(tc.maker_mask.any())


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_matches_jax(name):
    _, _, _, tc, _, _, js, ts, _ = runs(name)
    bodies, rigid = CASES[name][1:3]
    assert ts.n_adv >= 3 and ts.n_ac > ts.n_adv
    hold_sims(bodies, js, ts)
    hold_rigid(getattr(ts, rigid), getattr(js, rigid))
    hold_extras(name, js, ts)
    if name in WAVE:
        # the steps crossed the release: the clock runs, the wavemaker
        # moved
        assert 0.0 < float(ts.time) < float(ts.total_time) - 0.99
        shift = ts.wall["Position"] - ts.wall["InitialPosition"]
        assert float(shift[tc.maker_mask].abs().max()) > 0.0
        assert float(shift[~tc.maker_mask].abs().max()) == 0.0


@pytest.mark.parametrize("name", sorted(CASES))
def test_continues_jax_state(name):
    jm, tm, jc, tc, _, _, js, ts, jrun = runs(name)
    js1, ts1 = continue_one_step(jm, tm, js, ts, jrun, tc)
    hold_sims(CASES[name][1], js1, ts1)
    hold_rigid(getattr(ts1, CASES[name][2]), getattr(js1, CASES[name][2]))
    hold_extras(name, js1, ts1)


@pytest.mark.parametrize("name", sorted(CASES))
def test_cli_entry_runs_on_the_cpu(name, tmp_path, caplog, monkeypatch):
    _, tm, _, tc, _, tf, _, _, _ = runs(name)
    if name in CLI_HOLD:
        hold, start = CLI_HOLD[name], tm.init_sim

        def init_sim(case, fluid):
            if name == "stfb_2d":
                return start(case, fluid, settle_time=hold)
            s = start(case, fluid)
            s.total_time = torch.full_like(s.total_time,
                                           tm.RELAX_TIME - hold)
            return s

        monkeypatch.setattr(tm, "init_sim", init_sim)
    sets, bodies = CASES[name][3:]
    wall = tc.wall0 if name in WAVE else tc.wall
    body = tc.flap0 if name == "owsc_2d" else tc.block0
    n_real = dict(zip(bodies, (tf["NReal"], body["NReal"], wall["NReal"])))
    cli_runs(name, sets, bodies, tmp_path, caplog, n_real)


def test_cable_forces_match_jax_and_hold_the_tension_leg():
    """_cable_forces against JAX's on the built structure moved and
    turned; and tests/test_nonlinear_wave_fsi.py's static check: lifted
    1 cm, the taut tethers pull down with 2 k s, pushed down they go
    slack."""
    jm, tm, jc, tc, _, _, _, _, _ = runs("nonlinear_wave_fsi_2d")
    rng = np.random.default_rng(4)
    for _ in range(3):
        d = dict(com=jc.rb0.com + jnp.asarray(0.01 * rng.normal(size=2)),
                 vel=jnp.asarray(0.1 * rng.normal(size=2)),
                 theta=jnp.asarray(0.02 * rng.normal()),
                 omega=jnp.asarray(0.1 * rng.normal()))
        jb = jc.rb0._replace(**d)
        tb = convert.rigid_from_numpy(jax.tree.map(np.asarray, jb))
        for a, b in zip(tm._cable_forces(tb, tc.rb0.com),
                        jm._cable_forces(jb, jc.rb0.com)):
            close(a, b)
    rb = tc.rb0
    up = rb._replace(com=rb.com + torch.tensor([0.0, 0.01],
                                               dtype=torch.float64))
    f, _, T = tm._cable_forces(up, rb.com)
    assert float(f[1]) < -2.0 * tm.CABLE_K * 0.009
    assert bool((T > 0).all())
    down = rb._replace(com=rb.com - torch.tensor([0.0, 0.01],
                                                 dtype=torch.float64))
    assert float(tm._cable_forces(down, rb.com)[2].abs().max()) == 0.0


def test_wave_observers_match_jax():
    """The gauges and nonlinear_wave_fsi's riding pressure probe on the
    carried runs' states."""
    jm, tm, jc, tc, _, _, js, ts, _ = runs("nonlinear_wave_fsi_2d")
    close(tm.wave_gauge(ts, x=2.0, half_width=0.15),
          jm.wave_gauge(js, x=2.0, half_width=0.15), POS_TOL)
    close(tm.probe_pressure(tc, ts), jm.probe_pressure(jc, js), POS_TOL)
    jm, tm, jc, tc, _, _, js, ts, _ = runs("stfb_2d")
    close(tm.free_surface_height(tc, ts.fluid),
          jm.free_surface_height(jc, js.fluid), POS_TOL)


STFB_F32 = Path(__file__).parent / "golden_torch" / "stfb_2d" / "f32_spread.json"


def _ulps(a, b):
    """max |a - b| in float32 ulps of max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (max(np.abs(b).max(), 1e-30)
                                        * 2.0 ** -24))


def write_stfb_f32_spread(t_free=0.1):
    """stfb_2d at its default dx in float32 (x64 off) on the CPU, written to
    STFB_F32.  First the port against JAX: the builds field by field,
    then both stepped from JAX's built state carried across, through the
    1 s hold and `t_free` past the release (the first step where the
    fluid's positions part by 10, 10^3 and 10^5 ulps of their max; each
    run's mirror asymmetry; the COM).  Then JAX's own run to t = 10 at
    the committed curve's 30 samples, as built and changed once (one
    fluid particle's x by one ulp; the initial COM x set to the port's),
    each with its position DTW to tests/golden/refdb/stfb_2d."""
    from sphinxsys_tpu.cases import stfb_2d as J
    from sphinxsys_tpu_torch.cases import stfb_2d as T
    from sphinxsys_tpu_torch.io import regression as rg

    t0 = time.time()
    jc, jf = J.build_case()
    tc, tf = T.build_case(dtype=torch.float32, device="cpu")
    build = {f"{name}.{k}": _ulps(t[k].numpy(), np.asarray(v))
             for name, j, t in (("fluid", jf, tf), ("block", jc.block0,
                                                    tc.block0),
                                ("wall", jc.wall, tc.wall))
             for k, v in j.items()
             if k != "NReal" and np.asarray(v).dtype.kind == "f"}
    rb0 = {k: [np.asarray(getattr(tc.rb0, k)).tolist(),
               np.asarray(v).tolist()] for k, v in jc.rb0._asdict().items()}
    p0 = np.asarray(jf["Position"], np.float64)
    cell = {tuple(np.rint(x / jc.dx * 2).astype(int)): i
            for i, x in enumerate(p0)}
    mirror = np.array([cell.get((-a, b), -1) for a, b in
                       np.rint(p0 / jc.dx * 2).astype(int)])
    assert (mirror >= 0).all()

    def asym(pos):
        p = np.asarray(pos, np.float64)
        return float(np.max(np.abs(p[:, 0] + p[mirror, 0])
                            + np.abs(p[:, 1] - p[mirror, 1])))

    js = J.init_sim(jc, jf, settle_time=0.0)
    ts = convert.sim_from_numpy(T.SimState,
                                jax.tree_util.tree_map(np.asarray, js))
    rows, first, step = [], {}, 0
    for frozen, span in ((True, J.RELAX_TIME), (False, t_free)):
        jstep = jax.jit(lambda s, fr=frozen: J._advection_step(jc, s, fr))
        tstep = T.make_advection_step(tc, frozen=frozen)
        js = js._replace(time=jnp.zeros_like(js.time))
        ts.time = torch.zeros_like(ts.time)
        while float(js.time) < span:
            js, ts = jstep(js), tstep(ts)
            step += 1
            pos = _ulps(ts.fluid["Position"].numpy(), js.fluid["Position"])
            for lim in (10, 1000, 100000):
                if lim not in first and pos > lim:
                    first[lim] = [step, float(js.time), frozen]
            rows.append([step, frozen, float(js.time), pos,
                         _ulps(ts.fluid["Density"].numpy(),
                               js.fluid["Density"]),
                         asym(js.fluid["Position"]),
                         asym(ts.fluid["Position"].numpy()),
                         float(js.rb.com[0]), float(ts.rb.com[0])])
            if step % 100 == 0:
                print(rows[-1], f"{time.time() - t0:.0f} s", flush=True)

    ref = rg.read_result_xml(os.path.join(
        Path(__file__).parent, "golden", "refdb", "stfb_2d",
        "Observer_Position_Run_0_result.xml"))[0]
    spread = {}
    for tag in ("as built", "one particle's x + 1 ulp", "COM x the port's"):
        c, f = J.build_case()
        if tag.startswith("one"):
            pos = np.asarray(f["Position"]).copy()
            i = int(np.argmin(np.abs(pos[:, 0] - 0.8)
                              + np.abs(pos[:, 1] + 0.5)))
            pos[i, 0] = np.nextafter(pos[i, 0], np.float32(np.inf))
            f = dict(f, Position=jnp.asarray(pos))
        elif tag.startswith("COM"):
            com = c.rb0.com.at[0].set(float(tc.rb0.com[0]))
            c = dataclasses.replace(c, rb0=c.rb0._replace(com=com))
        s = J.init_sim(c, f)
        run = J.make_run_chunk(c)
        com = [np.asarray(s.rb.com).tolist()]
        for i in range(1, 30):
            s = run(s, jnp.asarray(i * 10.0 / 29, s.time.dtype))
            com.append(np.asarray(s.rb.com).tolist())
        spread[tag] = dict(dtw=float(rg.dtw_distance(np.asarray(com), ref)),
                           com=com)
        print(tag, spread[tag]["dtw"], com[-1], flush=True)
    STFB_F32.parent.mkdir(parents=True, exist_ok=True)
    STFB_F32.write_text(json.dumps({
        "what": "stfb_2d at dx = 0.05 in float32 (x64 off): the port's and "
                "JAX's builds (ulps of each field's max; rb0 [port, JAX]); "
                "both stepped from JAX's built state through the 1 s hold "
                f"and {t_free} s past the release, rows [step, held, t, "
                "fluid position ulps, density ulps, mirror asymmetry JAX, "
                "port, COM x JAX, port], the first step where the "
                "positions part by 10 / 1e3 / 1e5 ulps [step, t, held]; "
                "JAX's own run to t = 10 as built and changed once, its "
                "COM and position DTW to tests/golden/refdb/stfb_2d",
        "command": "JAX_PLATFORMS=cpu PYTHONPATH=. python "
                   "tests/test_torch_rigid_cases.py",
        "platform": f"cpu ({platform.machine()})",
        "seconds": round(time.time() - t0, 1),
        "build_ulps": build, "rb0": rb0, "first_part": first,
        "steps": rows, "jax_spread": spread}) + "\n")
    print(f"wrote {STFB_F32}")


if __name__ == "__main__":
    write_stfb_f32_spread()
