"""Parity of the port's four fluid cases that need no new physics module
with the JAX package, on the CPU in float64 (stlw_2d, filling_tank_2d,
elastic_gate_2d, flow_around_cylinder_2d).

For each case: the builds held to each other; a few advection steps from
them with equal step counts, positions and velocities within 1e-9 of
their max (the live rows where the fluid has an Alive mask, which must
be identical) and the case's observable (the stlw gauge, the tank's
alive count and energy, the gate tip, the cylinder's viscous force);
one more step from JAX's own state, carried across by
`convert.sim_from_numpy`; and the CLI entry, frame by frame.  The
cylinder runs unrelaxed on both sides (the relaxation's jitter is each
package's own random stream) and, relaxed, from JAX's relaxed cylinder
carried across.
"""

import functools
import importlib
import json
import logging
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sphinxsys_tpu import run as jrun
from sphinxsys_tpu.cases import elastic_gate_2d as jeg
from sphinxsys_tpu.core import materials as jmat
from sphinxsys_tpu.physics import general as jgd
from sphinxsys_tpu_torch import convert, run as trun
from sphinxsys_tpu_torch.core import materials as tmat
from sphinxsys_tpu_torch.physics import general as tgd

from test_torch_open_boundary import _vtp_arrays

torch.set_num_threads(1)

TOL = 1e-12
POS_TOL = 1e-9

# case -> (build keywords of both packages, run end time)
CASES = {
    "stlw_2d": (dict(), 0.05),
    "filling_tank_2d": (dict(dx=0.05), 0.05),
    "elastic_gate_2d": (dict(), 2.0),
    "flow_around_cylinder_2d": (dict(relax_cyl=0), 0.3),
}
# the bodies of each sim (the cases' names for them)
BODIES = {"stlw_2d": ("fluid",), "filling_tank_2d": ("fluid",),
          "elastic_gate_2d": ("fluid", "gate"),
          "flow_around_cylinder_2d": ("fluid", "cyl")}


def _close(got, ref, tol=TOL, what=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-300), (what, err)


def _mods(name):
    return (importlib.import_module(f"sphinxsys_tpu.cases.{name}"),
            importlib.import_module(f"sphinxsys_tpu_torch.cases.{name}"))


@functools.lru_cache(maxsize=None)
def _runs(name):
    """Both packages' builds and their runs to the case's end time."""
    jm, tm = _mods(name)
    kw, t_end = CASES[name]
    jc, *jst = jm.build_case(dtype=jnp.float64, **kw)
    tc, *tst = tm.build_case(dtype=torch.float64, device="cpu", **kw)
    js = jm.make_run_chunk(jc)(jm.init_sim(jc, *jst),
                               jnp.asarray(t_end, jnp.float64))
    ts = tm.make_run_chunk(tc)(tm.init_sim(tc, *tst), t_end)
    return jm, tm, jc, tc, jst, tst, js, ts


def _observable(name, mod, case, s):
    if name == "stlw_2d":
        return float(mod.free_surface_height(case, s.fluid))
    if name == "filling_tank_2d":
        return [mod.n_alive(s), mod.mechanical_energy(case, s)]
    if name == "elastic_gate_2d":
        return np.asarray(mod.tip_position(case, s))
    return np.asarray(mod.total_viscous_force(s))


def _hold_sims(name, jm, tm, jc, tc, js, ts):
    assert ts.n_adv == int(js.n_adv)
    for k in ("n_ac", "n_s"):
        if hasattr(js, k):
            assert getattr(ts, k) == int(getattr(js, k)), k
    assert float(ts.time) == pytest.approx(float(js.time), rel=1e-12)
    assert not bool(ts.overflow) and not bool(js.overflow)
    for body in BODIES[name]:
        jb, tb = getattr(js, body), getattr(ts, body)
        rows = np.ones(jb["Position"].shape[0], bool)
        if "Alive" in jb:
            rows = np.asarray(jb["Alive"])
            np.testing.assert_array_equal(tb["Alive"].numpy(), rows)
        for k in ("Position", "Velocity", "Density", "Pressure",
                  "PressureForceFromFluid", "ViscousForceFromFluid"):
            if k in jb and not (body == "cyl" and k in ("Velocity",
                                                        "Density")):
                _close(tb[k].numpy()[rows], np.asarray(jb[k])[rows], POS_TOL,
                       what=(body, k))
    got, ref = _observable(name, tm, tc, ts), _observable(name, jm, jc, js)
    if name == "flow_around_cylinder_2d":
        # a sum over the cylinder's particles that nearly cancels early
        # on: held at the scale of its terms
        scale = np.abs(np.asarray(js.cyl["ViscousForceFromFluid"])).sum()
        assert np.abs(got - ref).max() <= POS_TOL * scale, (got, ref)
    else:
        _close(got, ref, POS_TOL, what="observable")


@pytest.mark.parametrize("name", sorted(CASES))
def test_build_matches_jax(name):
    _, _, jc, tc, jst, tst, _, _ = _runs(name)
    for jb, tb in zip(jst, tst):
        assert set(jb) <= set(tb), set(jb) - set(tb)
        assert tb["NReal"] == int(jb["NReal"])
        for k, v in jb.items():
            if k != "NReal":
                _close(tb[k], v, what=k)
    for k in ("n_fluid", "n_wall", "n_gate", "n_seed", "tip_idx"):
        if hasattr(jc, k):
            assert getattr(tc, k) == getattr(jc, k), k
    if hasattr(jc, "wall"):
        for k in ("Position", "NormalDirection", "VolumetricMeasure"):
            _close(tc.wall[k], jc.wall[k], what=("wall", k))


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_matches_jax(name):
    jm, tm, jc, tc, _, _, js, ts = _runs(name)
    assert ts.n_adv >= 3
    _hold_sims(name, jm, tm, jc, tc, js, ts)


@pytest.mark.parametrize("name", sorted(CASES))
def test_continues_jax_state(name):
    """JAX's state after its run, carried across, one more advection step
    on each side."""
    jm, tm, jc, tc, _, _, js, ts_own = _runs(name)
    js = js._replace(**{k: jnp.zeros((), jnp.int32)
                        for k in ("n_adv", "n_ac", "n_s") if hasattr(js, k)})
    ts = convert.sim_from_numpy(type(ts_own),
                                jax.tree_util.tree_map(np.asarray, js))
    js1 = jax.jit(lambda s: jm._advection_step(jc, s))(js)
    _hold_sims(name, jm, tm, jc, tc, js1, tm.make_advection_step(tc)(ts))


def test_stlw_gauge_stays_near_the_surface():
    """Still water stays still: the gauge near y = 0 (the reference DB's
    -0.02 offset) on both sides."""
    jm, tm, jc, tc, jst, tst, js, ts = _runs("stlw_2d")
    h0 = float(tm.free_surface_height(tc, tst[0]))
    assert h0 == float(jm.free_surface_height(jc, jst[0]))
    assert -0.05 < float(tm.free_surface_height(tc, ts.fluid)) < 0.05


def test_filling_tank_injects():
    jm, tm, jc, tc, _, tst, js, ts = _runs("filling_tank_2d")
    assert tm.n_alive(ts) == jm.n_alive(js) > tc.n_seed
    rng = np.random.default_rng(21)
    f = {k: v.clone() for k, v in tst[0].items() if k != "NReal"}
    n = f["Position"].shape[0]
    f["Alive"] = torch.as_tensor(rng.random(n) < 0.5)
    f["Position"] = torch.as_tensor(
        np.asarray([-tc.dx * 4, 1.0]) + rng.random((n, 2)) * [0.4, 0.2])
    f["Velocity"] = torch.as_tensor(rng.normal(size=(n, 2)))
    f["Density"] = torch.as_tensor(1 + 0.01 * rng.normal(size=n))
    f["Pressure"] = torch.as_tensor(rng.normal(size=n))
    got = tm.inflow_condition(tc, f)
    ref = jm._inflow_condition(jc, {k: jnp.asarray(v.numpy())
                                    for k, v in f.items()})
    for k in ("Velocity", "Density", "Pressure"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


def test_cylinder_freestream_and_buffer():
    jm, tm = _mods("flow_around_cylinder_2d")
    for t in (0.0, 0.7, 1.99, 2.0, 3.5):
        tt = torch.tensor(t, dtype=torch.float64)
        _close(tm.freestream_velocity(tt),
               jm.freestream_velocity(jnp.asarray(t), jnp.float64))
    pos = np.random.default_rng(22).uniform([-3, -1], [16, 11], (500, 2))
    np.testing.assert_array_equal(
        tm._buffer_mask(torch.as_tensor(pos)).numpy(),
        np.asarray(jm._buffer_mask(jnp.asarray(pos))))


def test_cylinder_relaxed_from_jax():
    """JAX's relaxed cylinder (its own jitter), carried across, in the
    port's unrelaxed case: equal runs to t = 0.2.  The port's own
    relaxation keeps the cylinder inside its shape."""
    jm, tm = _mods("flow_around_cylinder_2d")
    jc, jf, jcy = jm.build_case(dtype=jnp.float64, relax_cyl=50)
    tc, tf, _ = tm.build_case(dtype=torch.float64, relax_cyl=0, device="cpu")
    tcy = convert.state_from_numpy({k: np.asarray(v) for k, v in jcy.items()})
    js = jm.make_run_chunk(jc)(jm.init_sim(jc, jf, jcy),
                               jnp.asarray(0.2, jnp.float64))
    ts = tm.make_run_chunk(tc)(tm.init_sim(tc, tf, tcy), 0.2)
    _hold_sims("flow_around_cylinder_2d", jm, tm, jc, tc, js, ts)
    _, _, own = tm.build_case(dtype=torch.float64, relax_cyl=20, device="cpu")
    r = torch.linalg.vector_norm(own["Position"] - torch.tensor(
        [tm.CX, tm.CY], dtype=torch.float64), dim=-1)
    assert bool(torch.isfinite(r).all()) and float(r.max()) < tm.R_CYL


def test_gravity_delta_form_and_eos_inverse():
    rng = np.random.default_rng(23)
    n = 50
    st = {"Position": rng.normal(size=(n, 2)), "Mass": rng.random(n),
          "ForcePrior": rng.normal(size=(n, 2)),
          "GravityForcePrev": rng.normal(size=(n, 2))}
    g = (0.0, -9.81)
    got = tgd.gravity_force({k: torch.as_tensor(v) for k, v in st.items()},
                            tgd.Gravity(g))
    ref = jgd.gravity_force({k: jnp.asarray(v) for k, v in st.items()},
                            jgd.Gravity(g))
    for k in ("ForcePrior", "GravityForcePrev"):
        _close(got[k], ref[k], what=k)
    p = rng.normal(size=n) * 1e4
    _close(tmat.WeaklyCompressibleFluid(1000.0, 30.0).density_from_pressure(
        torch.as_tensor(p)), jmat.WeaklyCompressibleFluid(
            rho0=1000.0, c0=30.0).density_from_pressure(jnp.asarray(p)))


# the CLI runs: --set overrides given to both packages
CLI_RUNS = {
    "stlw_2d": ("dx=0.1", "t_end=0.03"),
    "filling_tank_2d": ("dx=0.05", "t_end=0.01"),
    "elastic_gate_2d": ("t_end=1.0",),
    "flow_around_cylinder_2d": ("relax_cyl=0", "t_end=0.1"),
    "tethered_fish_2d": ("dx=0.15", "t_end=0.05"),
}


def hold_cli(case, tmp_path, caplog, built=True):
    """`python -m sphinxsys_tpu_torch.run <case>` against JAX's runner
    (CLI_RUNS' parameters): the frame of the built state (t_end = 0,
    float32) byte-equal, every body (unless `built` is False); a float64
    frame after a few steps: the same file names, every body's points
    byte-equal, the static bodies' files byte-equal, velocity, pressure
    and density within 1e-10 of their max (where "%.7g" of float64
    roundoff-level values differs)."""
    import filecmp

    sets = CLI_RUNS[case]
    runs = (("built", ("t_end=0", "n_output=1")),
            ("f64", (*sets, "n_output=1", "dtype=float64")))
    for tag, extra in runs[0 if built else 1:]:
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
            if tag == "built" or name.startswith("Wall"):
                assert same, (tag, name)
                continue
            ja, ta = (_vtp_arrays(os.path.join(d, name)) for d in (jd, td))
            assert sorted(ja) == sorted(ta)
            assert ta["Points"] == ja["Points"], name
            for k in ("Velocity", "Pressure", "Density"):
                if k in ja:
                    _close(np.asarray(ta[k], float), np.asarray(ja[k], float),
                           1e-10, (name, k))


@pytest.mark.parametrize("case", sorted(set(CLI_RUNS) - {"tethered_fish_2d"}))
def test_cli_matches_jax(case, tmp_path, caplog):
    """The gate's and the cylinder's built states are held by
    test_build_matches_jax; their CLI runs take the float64 frame only
    (each JAX run compiles the case's step anew)."""
    hold_cli(case, tmp_path, caplog,
             built=case in ("stlw_2d", "filling_tank_2d"))


# ---------------------------------------------------------------------------
# The JAX package's own float32 elastic-gate tip curve, which
# sphinxsys_tpu_torch/benchmarks/a7_long.py holds the card's run to:
#   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_a7_cases.py gate
# ---------------------------------------------------------------------------

GATE_CURVE = Path(__file__).parent / "golden_torch" / "elastic_gate" / \
    "jax_f32_tip.json"
GATE_T_END = 400.0
GATE_SNAPSHOTS = 100


def write_gate_curve(t_end=GATE_T_END, n_snap=GATE_SNAPSHOTS):
    """elastic_gate_2d at its default dx = 2.5 in float32 (x64 off), on the
    CPU, to t_end: the tip observer's position at n_snap + 1 samples (t = 0
    included) and the step counts, as tests/test_elastic_gate.py samples
    it."""
    import json
    import platform
    import time

    case, fluid, gate = jeg.build_case()
    s = jeg.init_sim(case, fluid, gate)
    run = jeg.make_run_chunk(case)
    tip = np.asarray(jeg.tip_position(case, s))
    rows = [[0.0, float(tip[0]), float(tip[1]), 0, 0, 0, False]]
    t0 = time.time()
    for i in range(1, n_snap + 1):
        s = run(s, jnp.asarray(i * t_end / n_snap, s.time.dtype))
        tip = np.asarray(jeg.tip_position(case, s))
        rows.append([float(s.time), float(tip[0]), float(tip[1]),
                     int(s.n_adv), int(s.n_ac), int(s.n_s), bool(s.overflow)])
        print(rows[-1], f"{time.time() - t0:.0f} s", flush=True)
    GATE_CURVE.parent.mkdir(parents=True, exist_ok=True)
    GATE_CURVE.write_text(json.dumps({
        "what": "elastic_gate_2d (sphinxsys_tpu.cases.elastic_gate_2d) at "
                f"dx = {case.dx} in float32, x64 off, to t = {t_end}: rows "
                "[t, tip x, tip y, n_adv, n_ac, n_s, overflow]",
        "command": "JAX_PLATFORMS=cpu PYTHONPATH=. python "
                   "tests/test_torch_a7_cases.py gate",
        "platform": f"cpu ({platform.machine()})",
        "seconds": round(time.time() - t0, 1),
        "n_fluid": case.n_fluid, "n_gate": case.n_gate,
        "rows": rows}) + "\n")
    print(f"wrote {GATE_CURVE}")


def test_committed_gate_curve():
    """The committed JAX float32 tip curve: its 101 samples finite, no
    overflow, and its t = 0 row the port's float32 build's tip."""
    from sphinxsys_tpu_torch.cases import elastic_gate_2d as teg

    curve = json.loads(GATE_CURVE.read_text())
    rows = np.asarray([r[:6] for r in curve["rows"]], float)
    assert rows.shape == (GATE_SNAPSHOTS + 1, 6)
    assert np.isfinite(rows).all() and not any(r[6] for r in curve["rows"])
    assert np.all(np.diff(rows[:, 0]) > 0) and rows[-1, 0] >= GATE_T_END
    case, _, gate = teg.build_case(device="cpu")
    np.testing.assert_array_equal(gate["Position"][case.tip_idx].numpy(),
                                  rows[0, 1:3].astype(np.float32))


if __name__ == "__main__":
    import sys

    if sys.argv[1:] == ["gate"]:
        write_gate_curve()
