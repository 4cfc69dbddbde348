"""Parity of the port's heart_electromechanics_3d with the JAX package on
the CPU, float64, at dx = 0.24 (201 particles): the build (the generated
fibers and sheets, the surface masks, the endocardial normals and areas,
every field at 1e-12, the sub-step cap), a run of ten steps (equal step
counts and equal mechanics sub-steps: JAX's are counted by a host
callback in its module's `sd.solid_acoustic_time_step` while it traces;
every field, the flow rate and the ejected volume within 1e-9 of their
max), one step from JAX's own state carried across, the cavity's flow
rate on a deformed, moving state, and the CLI entry.  The three gates of
tests/test_heart_electromechanics.py (to t = 8 at the default width) run
on the card: sphinxsys_tpu_torch/benchmarks/a7i_diffusion_eulerian_long.py.
"""

import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_corrected_cases import cli_runs, close

from sphinxsys_tpu.cases import heart_electromechanics_3d as jhm
from sphinxsys_tpu_torch import convert
from sphinxsys_tpu_torch.cases import heart_electromechanics_3d as thm

torch.set_num_threads(1)

DX = 0.24
T_END = 1.0
FIELDS = ("Position", "Velocity", "Voltage", "GateVariable",
          "ActiveContractionStress", "DeformationGradient",
          "DeformationRate", "Force")
SUBSTEPS = []


def _count(_):
    SUBSTEPS.append(1)


def counted_run_chunk(jc):
    """JAX's run_chunk, traced with its module's
    `sd.solid_acoustic_time_step` wrapped in a callback that counts the
    mechanics sub-steps; the module is restored after the trace."""
    sd = jhm.sd

    def acoustic(*args, **kw):
        dt = sd.solid_acoustic_time_step(*args, **kw)
        jax.debug.callback(_count, dt)
        return dt

    jrun = jhm.make_run_chunk(jc)

    def run(s, t):
        jhm.sd = types.SimpleNamespace(**{**vars(sd),
                                          "solid_acoustic_time_step":
                                          acoustic})
        try:
            SUBSTEPS.clear()
            out = jax.block_until_ready(jrun(s, jnp.asarray(t, jnp.float64)))
        finally:
            jhm.sd = sd
        return out, len(SUBSTEPS)

    return run


@functools.lru_cache(maxsize=None)
def runs():
    jc, js0 = jhm.build_case(dx=DX, dtype=jnp.float64)
    tc, ts0 = thm.build_case(dx=DX, dtype=torch.float64, device="cpu")
    jrun = counted_run_chunk(jc)
    js, n_sub = jrun(js0, T_END)
    ts = thm.make_run_chunk(tc)(ts0, T_END)
    return jc, tc, js0, ts0, js, n_sub, ts, jrun


def test_heart_build_matches_jax():
    jc, tc, js0, ts0, *_ = runs()
    assert (tc.n, tc.n_mech_sub, tc.dt_d) == (jc.n, jc.n_mech_sub, jc.dt_d)
    assert set(ts0.myo) == set(js0.myo)
    for k in js0.myo:
        if k != "NReal":
            close(ts0.myo[k], js0.myo[k], 1e-12, k)
    for name in ("base_mask", "stim_mask", "endo_mask"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)))
    assert int(tc.endo_mask.sum()) > 10 and int(tc.stim_mask.sum()) > 0
    close(tc.endo_n0, jc.endo_n0, 1e-15, "normals")
    close(tc.endo_da0, jc.endo_da0, 1e-15, "areas")
    f, s = ts0.myo["Fiber"].numpy(), ts0.myo["Sheet"].numpy()
    assert np.allclose(np.linalg.norm(f, axis=1), 1.0, atol=1e-12)
    assert np.abs(np.sum(f * s, axis=1)).max() < 1e-12


def test_heart_run_matches_jax():
    jc, tc, _, _, js, n_sub, ts, _ = runs()
    assert ts.n_steps == int(js.n_steps) == 10
    assert ts.n_sub == n_sub > ts.n_steps * tc.n_mech_sub - 1
    for k in FIELDS:
        close(ts.myo[k], js.myo[k], 1e-9, k)
    close(ts.q, js.q, 1e-9, "flow rate")
    close(ts.dv, js.dv, 1e-9, "volume change")
    assert thm.base_voltage(tc, ts) == pytest.approx(
        jhm.base_voltage(jc, js), rel=1e-9)
    assert thm.cavity_volume0() == jhm.cavity_volume0()
    # the wave has started and the muscle moved
    assert float(ts.myo["ActiveContractionStress"].max()) > 1.0
    assert float(ts.myo["Velocity"].abs().max()) > 1e-3


def test_heart_continues_jax_state():
    jc, tc, _, _, js, _, ts, jrun = runs()
    target = float(js.time) + 0.1
    js2, n_sub = jrun(js, target)
    own = convert.sim_from_numpy(thm.Sim, jax.tree_util.tree_map(
        np.asarray, js))
    ts2 = thm.make_run_chunk(tc)(own, target)
    assert ts2.n_steps == int(js2.n_steps) and ts2.n_sub == n_sub
    for k in FIELDS:
        close(ts2.myo[k], js2.myo[k], 1e-11, k)
    close(ts2.dv, js2.dv, 1e-11, "volume change")


def test_cavity_flow_rate_matches_jax():
    jc, tc, js0, ts0, *_ = runs()
    rng = np.random.default_rng(8)
    n = tc.n
    F = np.eye(3) + 0.1 * rng.normal(size=(n, 3, 3))
    v = rng.normal(size=(n, 3))
    ref = jhm.cavity_flow_rate(jc, dict(js0.myo, DeformationGradient=F,
                                        Velocity=v))
    got = thm.cavity_flow_rate(tc, dict(ts0.myo,
                                        DeformationGradient=torch.as_tensor(F),
                                        Velocity=torch.as_tensor(v)))
    close(got, ref, 1e-12)


def test_heart_cli_entry_runs_on_the_cpu(tmp_path, caplog):
    cli_runs("heart_electromechanics_3d", ("dx=0.24", "t_end=0.2"),
             ("Myocardium",), tmp_path, caplog, {"Myocardium": 201})


def write_jax_f32():
    """The JAX package's float32 CPU run of the long script's protocol (the
    default width, readings at t = 2, 5 and 8, the gates) ->
    tests/golden_torch/heart_electromechanics_3d/jax_f32.json."""
    import json
    import os

    from sphinxsys_tpu_torch.benchmarks import \
        a7i_diffusion_eulerian_long as long

    jax.config.update("jax_enable_x64", False)
    case, s = jhm.build_case()
    v0 = jhm.cavity_volume0()
    base = np.asarray(case.base_mask)
    f, sh = np.asarray(s.myo["Fiber"], np.float64), \
        np.asarray(s.myo["Sheet"], np.float64)
    out = dict(n=case.n,
               fiber_norm=float(np.abs(np.linalg.norm(f, axis=1) - 1).max()),
               fiber_sheet=float(np.abs((f * sh).sum(1)).max()))
    run = jhm.make_run_chunk(case)
    reads = []
    for t in long.HEART_TIMES:
        s = run(s, jnp.asarray(t, s.time.dtype))
        p = np.asarray(s.myo["Position"])
        reads.append(dict(
            t=float(s.time), n_steps=int(s.n_steps),
            base=jhm.base_voltage(case, s),
            ta_max=float(np.asarray(s.myo["ActiveContractionStress"]).max()),
            dv=float(s.dv) / v0, q=float(s.q),
            finite=bool(np.isfinite(p).all()
                        and np.isfinite(np.asarray(s.myo["Velocity"])).all()),
            base_moved=float(np.abs(p[base] - np.asarray(
                s.myo["InitialPosition"])[base]).max())))
        print(reads[-1], flush=True)
    r2, r5 = reads[0], reads[1]
    out["readings"] = reads
    out["gates"] = long.heart_gates(
        out["fiber_norm"], out["fiber_sheet"], r2["base"], r5["base"],
        r5["ta_max"], r2["dv"], r5["dv"], r2["finite"] and r5["finite"],
        max(r2["base_moved"], r5["base_moved"]), jhm.K_A)
    path = os.path.join(long.GOLDEN_TORCH, "heart_electromechanics_3d",
                        "jax_f32.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    write_jax_f32()
