"""Parity of the port's water_entry_exit_2d with the JAX package on the
CPU, float64, at dx = 2 R / 10 (600 water, 664 wall, 80 cylinder
particles): the build (every body's fields at 1e-12, the rigid body, the
wetting observer), a run of the free fall (equal advection and acoustic
step counts, every field within 1e-9 of its max), then JAX's own state
carried across just before the impact (t = 0.13) and both stepped
through it to t = 0.17 (the same check, the wetting Phi risen), and the
CLI entry.  The cylinder's angle and angular rate are roundoff of a
symmetric problem (~1e-16 rad): they are held within 1e-9 on a scale of
1 rad, not of their own max.

The case's four gates (tests/test_water_entry_exit.py, slow) and the DTW
of its centre trajectory and wetting Phi against the committed reference
curves run on the card: sphinxsys_tpu_torch/benchmarks/
a7i_diffusion_eulerian_long.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_corrected_cases import cli_runs, close

from sphinxsys_tpu.cases import water_entry_exit_2d as jwe
from sphinxsys_tpu_torch import convert
from sphinxsys_tpu_torch.cases import water_entry_exit_2d as twe

torch.set_num_threads(1)

DX = 2 * jwe.R_CYL / 10
T_FALL = 0.02
T_CARRY, T_IMPACT = 0.13, 0.17
KEYS = {"fluid": ("Position", "Velocity", "Density", "Pressure", "Phi",
                  "ForcePrior", "Indicator"),
        "cyl": ("Position", "Velocity", "Phi", "ForcePrior",
                "AverageVelocity", "AverageAcceleration")}
RUN_TOL = 1e-9


@functools.lru_cache(maxsize=None)
def runs():
    jc, jf = jwe.build_case(dx=DX, dtype=jnp.float64)
    tc, tf = twe.build_case(dx=DX, dtype=torch.float64, device="cpu")
    jrun = jwe.make_run_chunk(jc)
    js = jrun(jwe.init_sim(jc, jf), jnp.asarray(T_FALL, jnp.float64))
    ts = twe.make_run_chunk(tc)(twe.init_sim(tc, tf), T_FALL)
    return jc, tc, jf, tf, js, ts, jrun


def hold(js, ts, tol):
    for k in ("n_adv", "n_ac"):
        assert getattr(ts, k) == int(getattr(js, k)), k
    assert not bool(ts.overflow) and not bool(js.overflow)
    assert float(ts.time) == pytest.approx(float(js.time), rel=1e-12)
    for body, keys in KEYS.items():
        for k in keys:
            close(getattr(ts, body)[k], getattr(js, body)[k], tol,
                  f"{body} {k}")
    for f in ("com", "vel"):
        close(getattr(ts.rb, f), getattr(js.rb, f), tol, f)
    # the problem is symmetric: the angle and its rate are roundoff
    # (~1e-16), held on a scale of 1 rad
    for f in ("theta", "omega"):
        assert abs(float(getattr(ts.rb, f)) - float(getattr(js.rb, f))) \
            <= tol, f


def test_water_entry_build_matches_jax():
    jc, tc, jf, tf, *_ = runs()
    assert (tc.n_fluid, tc.n_wall, tc.n_cyl, tc.bottom_idx) == (
        jc.n_fluid, jc.n_wall, jc.n_cyl, jc.bottom_idx)
    assert set(tf) == set(jf)
    for k in jf:
        if k != "NReal":
            close(tf[k], jf[k], 1e-12, k)
    for k in jc.cyl0:
        if k != "NReal":
            close(tc.block0[k], jc.cyl0[k], 1e-12, k)
    for f in jc.rb0._fields:
        close(getattr(tc.rb0, f), getattr(jc.rb0, f), 1e-12, f)
    assert tc.diffusion.d_coeff == jc.diffusion.d_coeff


def test_water_entry_free_fall_matches_jax():
    *_, js, ts, _ = runs()
    assert ts.n_adv >= 10
    hold(js, ts, RUN_TOL)
    assert twe.bottom_wetting(runs()[1], ts) == 0.0


def test_water_entry_impact_from_jax_state():
    jc, tc, *_, jrun = runs()
    jf = jwe.build_case(dx=DX, dtype=jnp.float64)[1]
    js = jrun(jwe.init_sim(jc, jf), jnp.asarray(T_CARRY, jnp.float64))
    own = convert.sim_from_numpy(twe.SimState, jax.tree_util.tree_map(
        np.asarray, js))
    assert twe.bottom_wetting(tc, own) < 0.01   # just before the entry
    js2 = jrun(js, jnp.asarray(T_IMPACT, jnp.float64))
    ts2 = twe.make_run_chunk(tc)(own, T_IMPACT)
    hold(js2, ts2, RUN_TOL)
    np.testing.assert_allclose(twe.center_position(ts2),
                               np.asarray(jwe.center_position(js2)),
                               rtol=1e-12)
    phi = twe.bottom_wetting(tc, ts2)
    assert phi == pytest.approx(float(jwe.bottom_wetting(jc, js2)),
                                rel=1e-9)
    assert phi > 0.5            # the water wets the entered cylinder


def test_water_entry_cli_entry_runs_on_the_cpu(tmp_path, caplog):
    cli_runs("water_entry_exit_2d", (f"dx={DX!r}", "t_end=0.004"),
             ("WaterBody", "Cylinder", "Wall"), tmp_path, caplog,
             {"WaterBody": 600, "Cylinder": 80, "Wall": 664})


def write_jax_f32():
    """The JAX package's float32 CPU runs of the long script's two water
    protocols (its gate run at dx = 2 R / 20 and its DTW run at the
    default width) -> tests/golden_torch/water_entry_exit_2d/jax_f32.json
    (~30 min on 8 cores)."""
    import json
    import os

    from sphinxsys_tpu_torch.benchmarks import \
        a7i_diffusion_eulerian_long as long
    from sphinxsys_tpu_torch.io.regression import (dtw_distance,
                                                   read_result_xml)

    jax.config.update("jax_enable_x64", False)
    out = {}
    case, fluid = jwe.build_case(dx=2 * jwe.R_CYL / long.WATER_GATE_DX_DIV)
    s = jwe.init_sim(case, fluid)
    run = jwe.make_run_chunk(case)
    rows = [[0.0, *map(float, s.rb.com), 0.0]]
    for t in long.WATER_GATE_TIMES:
        s = run(s, jnp.asarray(t, s.time.dtype))
        rows.append([float(s.time), *map(float, s.rb.com),
                     float(jwe.bottom_wetting(case, s))])
    ts, xs, ys, phis = (list(c) for c in zip(*rows))
    out["gate"] = dict(ts=ts, xs=xs, ys=ys, phis=phis, gates=long.water_gates(
        ts, xs, ys, phis), overflow=bool(s.overflow))
    print(out["gate"], flush=True)

    case, fluid = jwe.build_case()
    s = jwe.init_sim(case, fluid)
    run = jwe.make_run_chunk(case)
    coms = [np.asarray(s.rb.com, np.float64).tolist()]
    phis = [float(jwe.bottom_wetting(case, s))]
    for t in long.WATER_DTW_TIMES:
        s = run(s, jnp.asarray(t, s.time.dtype))
        coms.append(np.asarray(s.rb.com, np.float64).tolist())
        phis.append(float(jwe.bottom_wetting(case, s)))
        print(t, coms[-1], phis[-1], flush=True)
    db = os.path.join(long.REFDB, "water_entry_exit_2d")
    ref_c = read_result_xml(os.path.join(
        db, "CylinderObserver_Position_Run_0_result.xml"))[0]
    ref_p = read_result_xml(os.path.join(
        db, "WettingObserver_Phi_Run_0_result.xml"))[0]
    out["dtw"] = dict(position=coms, phi=phis, distance=dict(
        position=dtw_distance(np.asarray(coms), ref_c),
        phi=dtw_distance(np.asarray(phis), ref_p)), overflow=bool(s.overflow))
    path = os.path.join(long.GOLDEN_TORCH, "water_entry_exit_2d",
                        "jax_f32.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(out["dtw"]["distance"])


if __name__ == "__main__":
    write_jax_f32()
