"""The port's IO and driver layer held to the JAX package's, on the CPU:

* io/regression.py, on every committed golden XML under tests/golden/:
  the same parsed arrays, the same bytes written back, the same DTW
  thresholds, distances and verdicts (the stored run itself and a seeded
  perturbation of it); the time- and ensemble-average tests on seeded
  series (the same databases, byte for byte, and verdicts);
* io/vtk.py: `write_vtp` byte-equal to JAX's for the same values, float32
  and float64, with negative zero, 1e-30 and 1e30, 2D and 3D, padding rows
  past NReal, through the port's native formatter (built by g++ here) and
  its Python one, against JAX's Python formatter and its native one
  (native/fastio.cpp, compiled here into a temporary directory);
* io/restart.py: snapshots written by JAX read by the port (dtype and
  device from the template, NReal an int) and the reverse;
* io/observation.py: `observe_quantity` in float64, scalar and vector;
* io/failure.py: the planted violation's dump, byte-equal to JAX's, and
  a NaN velocity firing the check (JAX's lets it pass);
* solver.py: the triggers and EventScheduler firing in JAX's sequence,
  rk2_sequence, and run_simulation with failure_check (raises, one VTP a
  body), trace_dir (a Chrome trace) and a capacity overflow (raises),
  beside JAX's output times;
* utils/config.py: the same RunConfig from the flags the port keeps, the
  reference's flags for unported paths rejected.
"""

import dataclasses
import glob
import importlib.util
import json
import os
import subprocess
import sysconfig

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sphinxsys_tpu import solver as jsolver
from sphinxsys_tpu.cases import dambreak_2d as jdb
from sphinxsys_tpu.core.state import make_fluid_state as j_make_fluid_state
from sphinxsys_tpu.io import failure as jfail
from sphinxsys_tpu.io import observation as jobs
from sphinxsys_tpu.io import regression as jrg
from sphinxsys_tpu.io import restart as jrst
from sphinxsys_tpu.io import vtk as jvtk
from sphinxsys_tpu.neighbors import build_cell_table as j_build_cell_table
from sphinxsys_tpu.neighbors import build_neighbor_list as j_build_nl
from sphinxsys_tpu.utils.config import RunConfig as JRunConfig
from sphinxsys_tpu_torch import convert, solver as tsolver
from sphinxsys_tpu_torch.cases import dambreak_2d as tdb
from sphinxsys_tpu_torch.io import failure as tfail
from sphinxsys_tpu_torch.io import observation as tobs
from sphinxsys_tpu_torch.io import regression as trg
from sphinxsys_tpu_torch.io import restart as trst
from sphinxsys_tpu_torch.io import vtk as tvtk
from sphinxsys_tpu_torch.neighbors.cell_list import build_cell_table
from sphinxsys_tpu_torch.neighbors.neighbor_list import build_neighbor_list
from sphinxsys_tpu_torch.utils.config import RunConfig as TRunConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
RESULT_XMLS = sorted(glob.glob(os.path.join(GOLDEN, "**", "*_Run_*_result.xml"),
                               recursive=True))
DTW_SETS = sorted(p[:-len("_dtwdistance.xml")] for p in glob.glob(
    os.path.join(GOLDEN, "**", "*_dtwdistance.xml"), recursive=True))


def _rel(p):
    return os.path.relpath(p, GOLDEN)


# ---------------------------------------------------------------------------
# io/regression.py
# ---------------------------------------------------------------------------

def test_golden_inventory():
    """Every committed result XML and DTW set is covered below."""
    assert len(RESULT_XMLS) >= 38 and len(DTW_SETS) >= 13


@pytest.mark.parametrize("path", RESULT_XMLS, ids=_rel)
def test_result_xml_parse_and_write_match_jax(path, tmp_path):
    got, ref = trg.read_result_xml(path), jrg.read_result_xml(path)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    trg.write_result_xml(str(tmp_path / "t.xml"), got)
    jrg.write_result_xml(str(tmp_path / "j.xml"), ref)
    assert (tmp_path / "t.xml").read_bytes() == (tmp_path / "j.xml").read_bytes()
    np.testing.assert_array_equal(trg.read_result_xml(str(tmp_path / "t.xml")),
                                  got)


@pytest.mark.parametrize("prefix", DTW_SETS, ids=_rel)
def test_dtw_verdicts_match_jax(prefix):
    db_dir, stem = os.path.split(prefix)
    body, quantity = stem.split("_", 1)
    tt = trg.DTWRegressionTest(db_dir, body, quantity)
    jt = jrg.DTWRegressionTest(db_dir, body, quantity)
    assert tt.run_files == jt.run_files and tt.run_files
    np.testing.assert_array_equal(tt.threshold, jt.threshold)
    stored = trg.read_result_xml(tt.run_files[0])
    rng = np.random.default_rng(len(stem))
    scale = np.abs(stored).max() + 1e-12
    for observed in (stored, stored + 0.05 * scale * rng.normal(size=stored.shape),
                     stored + 0.5 * scale):
        for a, b in zip(tt.distances(observed), jt.distances(observed)):
            np.testing.assert_array_equal(a, b)
        assert tt.test(observed) == jt.test(observed)
    assert tt.test(stored)[0]                      # a run passes its own DB
    assert not tt.test(stored + 0.5 * scale)[0]    # and a shifted one fails


@pytest.mark.parametrize("shape_a,shape_b", [((40,), (40,)), ((23,), (26,)),
                                             ((30, 3), (33, 3))])
def test_dtw_distance_matches_jax(shape_a, shape_b):
    rng = np.random.default_rng(5)
    a, b = rng.normal(size=shape_a), rng.normal(size=shape_b)
    assert trg.dtw_distance(a, b) == jrg.dtw_distance(a, b)
    assert trg.dtw_distance(a, a) == 0.0


def test_value_format_matches_jax():
    for v in (1.25, -0.0, 1e-30, np.float32(0.1), [0.45, 0.0016],
              [[1.0, 2.5], [3.0, -4.0]]):
        s = trg.format_value(v)
        assert s == jrg.format_value(v)
        np.testing.assert_array_equal(trg.parse_value(s), jrg.parse_value(s))


def _series(seed, n=60, comps=(2,), steady_at=20):
    """Seeded series (n_snapshots, n_observations, [d]): a ramp that
    settles at snapshot `steady_at`, then noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    base = np.minimum(t, steady_at) / steady_at + 1.0
    shape = (n, *comps)
    return base.reshape(n, *([1] * len(comps))) + 0.01 * rng.normal(size=shape)


@pytest.mark.parametrize("comps", [(2,), (2, 3)])
def test_time_average_regression_matches_jax(comps, tmp_path):
    runs = [_series(s, comps=comps) for s in (1, 2, 3)]
    assert trg.search_steady_start(runs[0]) == jrg.search_steady_start(runs[0])
    tt = trg.TimeAverageRegressionTest(str(tmp_path / "t"), "B", "Q")
    jt = jrg.TimeAverageRegressionTest(str(tmp_path / "j"), "B", "Q")
    for k, r in enumerate(runs):
        for a, b in zip(tt.update_db(r, k), jt.update_db(r, k)):
            np.testing.assert_array_equal(a, b)
    assert open(tt.path, "rb").read() == open(jt.path, "rb").read()
    for probe in (runs[0], runs[0] * 1.5):
        assert tt.test(probe) == jt.test(probe)
    assert tt.test(runs[0])[0] and not tt.test(runs[0] * 1.5)[0]


@pytest.mark.parametrize("comps", [(2,), (2, 3)])
def test_ensemble_average_regression_matches_jax(comps, tmp_path):
    runs = [_series(s, comps=comps) for s in (4, 5, 6)]
    tt = trg.EnsembleAverageRegressionTest(str(tmp_path / "t"), "B", "Q")
    jt = jrg.EnsembleAverageRegressionTest(str(tmp_path / "j"), "B", "Q")
    for k, r in enumerate(runs):
        for a, b in zip(tt.update_db(r, k), jt.update_db(r, k)):
            np.testing.assert_array_equal(a, b)
    assert open(tt.path, "rb").read() == open(jt.path, "rb").read()
    for probe in (runs[1], runs[1] + 1.0):
        assert tt.test(probe) == jt.test(probe)
    assert not tt.test(runs[1] + 1.0)[0]


# ---------------------------------------------------------------------------
# io/vtk.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_native_fastio(tmp_path_factory):
    """JAX's native formatter (native/fastio.cpp, a CPython extension),
    compiled into a temporary directory; None where g++ or the Python
    headers are missing."""
    include = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(include, "Python.h")):
        return None
    out = tmp_path_factory.mktemp("fastio") / (
        "_sphinxsys_fastio" + (sysconfig.get_config_var("EXT_SUFFIX") or ".so"))
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                    f"-I{include}", os.path.join(ROOT, "native", "fastio.cpp"),
                    "-o", str(out)], check=True)
    spec = importlib.util.spec_from_file_location("_sphinxsys_fastio", out)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _vtp_state(dtype, dim, seed=0):
    rng = np.random.default_rng(seed)
    n, n_real = 12, 9
    pos = rng.normal(size=(n, dim)) * 10.0 ** rng.integers(-5, 5, size=(n, dim))
    pos[0, :2] = (-0.0, 1e-30)
    pos[1, :2] = (1e30, -1e-7)
    vel = rng.normal(size=(n, dim))
    vel[2] = 0.0
    p = rng.normal(size=n) * 1e3
    p[3] = -0.0
    rho = 1.0 + 1e-3 * rng.normal(size=n)
    return {"NReal": np.asarray(n_real, np.int32),
            "Position": pos.astype(dtype), "Velocity": vel.astype(dtype),
            "Pressure": p.astype(dtype), "Density": rho.astype(dtype)}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("jax_formatter", ["python", "native"])
def test_write_vtp_bytes_match_jax(dtype, dim, native, jax_formatter, tmp_path,
                                   jax_native_fastio, monkeypatch):
    if jax_formatter == "native":
        if jax_native_fastio is None:
            pytest.fail("g++ and the Python headers build native/fastio.cpp "
                        "on this machine")
        monkeypatch.setattr(jvtk, "_fastio", jax_native_fastio)
    else:
        monkeypatch.setattr(jvtk, "_fastio", None)
    state = _vtp_state(dtype, dim)
    names = ["Velocity", "Pressure", "Density"]
    jvtk.write_vtp(str(tmp_path / "j.vtp"),
                   {k: jnp.asarray(v) for k, v in state.items()}, names)
    tvtk.write_vtp(str(tmp_path / "t.vtp"), convert.state_from_numpy(state),
                   names, native=native)
    ref = (tmp_path / "j.vtp").read_bytes()
    assert (tmp_path / "t.vtp").read_bytes() == ref
    assert b'NumberOfPoints="9"' in ref and b"-0 1e-30" in ref


def test_native_formatter_is_built_once_and_keyed(tmp_path):
    """The library sits under build/host/, named by the hash of its source
    and flags; big arrays (several threads) format like small ones."""
    lib = tvtk.fastio()
    assert tvtk.library_path().exists()
    assert tvtk.library_path().parent == tvtk.BUILD_DIR
    a = np.random.default_rng(3).normal(size=(70_000, 3)).astype(np.float32)
    assert tvtk._format_rows(a, True) == tvtk._format_rows(a, False)
    assert tvtk.fastio() is lib


def test_body_states_recording_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jvtk, "_fastio", None)
    state = _vtp_state(np.float32, 2, seed=4)
    jrec = jvtk.BodyStatesRecording(str(tmp_path / "j"))
    trec = tvtk.BodyStatesRecording(str(tmp_path / "t"))
    jrec.add_to_write("WaterBody", "Pressure", "Velocity")
    trec.add_to_write("WaterBody", "Pressure", "Velocity")
    for _ in range(2):
        jrec.write({"WaterBody": {k: jnp.asarray(v) for k, v in state.items()}})
        trec.write({"WaterBody": convert.state_from_numpy(state)})
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) == [
        "WaterBody_0000000.vtp", "WaterBody_0000001.vtp"]
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == (tmp_path / "j" / n).read_bytes()


# ---------------------------------------------------------------------------
# io/restart.py
# ---------------------------------------------------------------------------

def _fluid_pair(seed=1, n=10):
    rng = np.random.default_rng(seed)
    j = dict(j_make_fluid_state(rng.uniform(size=(n, 2)), 0.01, 1.0,
                                dtype=jnp.float64))
    j["Velocity"] = jnp.asarray(rng.normal(size=(n, 2)), jnp.float64)
    j["Pressure"] = jnp.asarray(rng.normal(size=n), jnp.float64)
    j["Alive"] = jnp.asarray(rng.integers(0, 2, size=n), jnp.int32)
    t = convert.state_from_numpy({k: np.asarray(v) for k, v in j.items()})
    t["Velocity"] = t["Velocity"].to(torch.float32)   # a template dtype
    return j, t


def test_restart_written_by_jax_read_by_port(tmp_path):
    j, t = _fluid_pair()
    jrst.write_restart(str(tmp_path), 5, {"water": j}, physical_time=1.25,
                       n_adv=7)
    loaded, meta = trst.read_restart(str(tmp_path), 5, {"water": t})
    assert meta == {"physical_time": 1.25, "step": 5, "n_adv": 7}
    w = loaded["water"]
    assert w["NReal"] == 10 and type(w["NReal"]) is int
    for k, v in t.items():
        if k == "NReal":
            continue
        assert w[k].dtype == v.dtype and w[k].device == v.device, k
        np.testing.assert_array_equal(
            w[k].numpy(), np.asarray(j[k]).astype(w[k].numpy().dtype), err_msg=k)


def test_restart_written_by_port_read_by_jax(tmp_path):
    j, t = _fluid_pair(seed=2)
    trst.write_restart(str(tmp_path), 3, {"water": t}, physical_time=0.5,
                       n_ac=11)
    jname = os.path.join(str(tmp_path), "water_rst_0000003.npz")
    assert os.path.exists(jname)
    loaded, meta = jrst.read_restart(str(tmp_path), 3, {"water": j})
    assert meta == {"physical_time": 0.5, "step": 3, "n_ac": 11}
    w = loaded["water"]
    assert int(w["NReal"]) == 10
    for k, v in t.items():
        if k != "NReal":
            np.testing.assert_array_equal(np.asarray(w[k]),
                                          v.numpy().astype(np.asarray(j[k]).dtype))
    back, _ = trst.read_restart(str(tmp_path), 3, {"water": t})
    for k, v in t.items():
        if k != "NReal":
            assert torch.equal(back["water"][k], v), k


def test_reload_roundtrip_matches_jax(tmp_path):
    j, t = _fluid_pair(seed=3)
    t["NReal"] = 7
    trst.write_reload(str(tmp_path), "body", t)
    pos, vol = jrst.read_reload(str(tmp_path), "body")
    tpos, tvol = trst.read_reload(str(tmp_path), "body")
    np.testing.assert_array_equal(pos, tpos)
    np.testing.assert_array_equal(pos, np.asarray(j["Position"])[:7])
    assert vol.shape == (7,)


# ---------------------------------------------------------------------------
# io/observation.py
# ---------------------------------------------------------------------------

def test_observe_quantity_matches_jax():
    """The 2D dambreak's fluid (dx = 0.1, float64) with seeded pressure and
    velocity, observed at probes inside, at the free surface and outside
    the fluid (an empty row gives 0 / TINY on both sides)."""
    case, fluid = jdb.build_case(dx=0.1, dtype=jnp.float64)
    rng = np.random.default_rng(7)
    f = {k: np.array(v) for k, v in fluid.items()}
    n = f["Position"].shape[0]
    f["Position"] = f["Position"] + 0.02 * (rng.random((n, 2)) - 0.5)
    f["Pressure"] = rng.normal(size=n)
    f["Velocity"] = rng.normal(size=(n, 2))
    obs = np.asarray([[jdb.DL - 0.05, 0.2], [0.5, 0.5], [1.0, 0.99],
                      [4.0, 4.0]])
    jf = {k: jnp.asarray(v) for k, v in f.items()}
    table = j_build_cell_table(jf["Position"], jf["NReal"], case.grid,
                               cap=case.cell_cap)
    jnl = j_build_nl(jnp.asarray(obs), jnp.asarray(4, jnp.int32),
                     jf["Position"], jf["NReal"], table, case.grid,
                     case.adaptation.cutoff, k_max=64, include_self=True)
    tcase, _ = tdb.build_case(dx=0.1, dtype=torch.float64, device="cpu")
    tf = convert.state_from_numpy(f)
    ttable = build_cell_table(tf["Position"], tf["NReal"], tcase.grid,
                              tcase.cell_cap)
    tnl = build_neighbor_list(torch.as_tensor(obs), 4, tf["Position"],
                              tf["NReal"], ttable, tcase.grid,
                              tcase.adaptation.cutoff, k_max=64,
                              include_self=True)
    np.testing.assert_array_equal(tnl.idx.numpy(), np.asarray(jnl.idx))
    for q in ("Pressure", "Velocity"):
        ref = np.asarray(jobs.observe_quantity(jnp.asarray(obs), jf, q, jnl,
                                               case.kernel, 2))
        got = tobs.observe_quantity(torch.as_tensor(obs), tf, q, tnl,
                                    tcase.kernel, 2).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-12 * np.abs(ref).max())
        assert np.all(got[3] == 0.0)


def test_recorded_series_dat_matches_jax(tmp_path):
    js, ts = jobs.RecordedSeries("Pressure"), tobs.RecordedSeries("Pressure")
    rng = np.random.default_rng(8)
    for k in range(5):
        v = rng.normal(size=2)
        js.append(0.1 * k, jnp.asarray(v))
        ts.append(torch.as_tensor(0.1 * k, dtype=torch.float64),
                  torch.as_tensor(v))
    js.write_dat(str(tmp_path / "j.dat"))
    ts.write_dat(str(tmp_path / "t.dat"))
    assert (tmp_path / "t.dat").read_bytes() == (tmp_path / "j.dat").read_bytes()


# ---------------------------------------------------------------------------
# io/failure.py
# ---------------------------------------------------------------------------

def test_failure_dump_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jvtk, "_fastio", None)
    fluid = _vtp_state(np.float32, 2, seed=9)
    wall = _vtp_state(np.float32, 2, seed=10)
    fluid["Velocity"][10] = 1e3        # a padding row: never counts
    jcheck = jfail.WriteToVtpIfVelocityOutOfBound(str(tmp_path / "j"), 50.0)
    tcheck = tfail.WriteToVtpIfVelocityOutOfBound(str(tmp_path / "t"), 50.0)

    def bodies(jax_side):
        conv = ((lambda s: {k: jnp.asarray(v) for k, v in s.items()})
                if jax_side else convert.state_from_numpy)
        return {"WaterBody": conv(fluid), "Wall": conv(wall)}

    assert not jcheck(bodies(True), 0.5) and not tcheck(bodies(False), 0.5)
    assert not os.path.exists(tmp_path / "t")
    fluid["Velocity"][4] = (40.0, 40.0)   # |v| = 56.6 > 50, a real row
    assert jcheck(bodies(True), 0.75) and tcheck(bodies(False), 0.75)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) == [
        "Wall_velocity_out_of_bound_0.750000.vtp",
        "WaterBody_velocity_out_of_bound_0.750000.vtp"]
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == (tmp_path / "j" / n).read_bytes()
    assert tcheck(bodies(False), 1.0)          # idempotent, no new dump
    assert len(os.listdir(tmp_path / "t")) == 2


def test_failure_check_fires_on_nan(tmp_path):
    """A NaN velocity in a real row fires the check (JAX's `>` lets it
    pass); one in a padding row does not."""
    fluid = _vtp_state(np.float32, 2, seed=9)
    fluid["Velocity"][10] = np.nan       # a padding row: never counts
    check = tfail.WriteToVtpIfVelocityOutOfBound(str(tmp_path), 50.0)
    assert not check({"WaterBody": convert.state_from_numpy(fluid)}, 0.5)
    fluid["Velocity"][4, 1] = np.nan     # a real row
    assert check({"WaterBody": convert.state_from_numpy(fluid)}, 0.75)
    assert os.listdir(tmp_path) == [
        "WaterBody_velocity_out_of_bound_0.750000.vtp"]


# ---------------------------------------------------------------------------
# solver.py
# ---------------------------------------------------------------------------

def test_triggers_fire_in_jax_sequence():
    times = np.cumsum(np.random.default_rng(11).uniform(0.0, 0.07, size=200))
    for args in ((0.1,), (0.25, 0.05)):
        ji, ti = jsolver.TriggerByInterval(*args), tsolver.TriggerByInterval(*args)
        assert [ji(t) for t in times] == [ti(t) for t in times]
        assert ji.next_time == ti.next_time
    jc, tc = jsolver.TriggerByCount(3), tsolver.TriggerByCount(3)
    assert [jc() for _ in range(10)] == [tc() for _ in range(10)]


def test_event_scheduler_fires_in_jax_sequence():
    fired = {"j": [], "t": []}
    scheds = {"j": jsolver.EventScheduler(), "t": tsolver.EventScheduler()}
    when = [0.3, 0.1, 0.2, 0.1, 0.5, 0.2 + 1e-13]
    for side, sch in scheds.items():
        for k, t in enumerate(when):
            sch.schedule(t, lambda now, k=k, side=side: fired[side].append((k, now)))
    for now in (0.05, 0.1, 0.25, 0.4, 0.6):
        assert scheds["t"].next_time(9.0) == scheds["j"].next_time(9.0)
        for sch in scheds.values():
            sch.fire_due(now)
    assert fired["t"] == fired["j"] and len(fired["t"]) == len(when)
    assert scheds["t"].next_time(9.0) == 9.0


def test_rk2_sequence_matches_jax():
    def jstep(s, dt):
        return {"x": s["x"] + dt * jnp.sin(s["x"]), "y": s["y"]}

    def tstep(s, dt):
        return {"x": s["x"] + dt * torch.sin(s["x"]), "y": s["y"]}

    x0 = np.linspace(0.0, 3.0, 7)
    j = jsolver.rk2_sequence(jstep, ("x",))({"x": jnp.asarray(x0), "y": 1}, 0.1)
    t = tsolver.rk2_sequence(tstep, ("x",))({"x": torch.as_tensor(x0), "y": 1},
                                            0.1)
    np.testing.assert_allclose(t["x"].numpy(), np.asarray(j["x"]), rtol=0,
                               atol=1e-15)
    assert t["y"] == 1


def test_run_simulation_output_times_match_jax():
    """The 2D dambreak (dx = 0.1, float64) through both drivers: on_output
    fires at the same simulated times, with the same step counts."""
    jcase, jfluid = jdb.build_case(dx=0.1, dtype=jnp.float64)
    jt = []
    jsolver.run_simulation(jdb.make_run_chunk(jcase), jdb.init_sim(jcase, jfluid),
                           0.2, 0.05, on_output=lambda s: jt.append(
                               (float(s.time), int(s.n_adv))), verbose=False)
    tcase, tfluid = tdb.build_case(dx=0.1, dtype=torch.float64, device="cpu")
    tt = []
    tsolver.run_simulation(tdb.make_run_chunk(tcase), tdb.init_sim(tcase, tfluid),
                           0.2, 0.05, on_output=lambda s: tt.append(
                               (float(s.time), s.n_adv)), verbose=False)
    assert [n for _, n in tt] == [n for _, n in jt] and len(tt) >= 3
    np.testing.assert_allclose([t for t, _ in tt], [t for t, _ in jt],
                               rtol=1e-12)


def test_run_simulation_failure_check_dumps_and_raises(tmp_path):
    case, fluid = tdb.build_case(dx=0.1, device="cpu")
    check = tfail.WriteToVtpIfVelocityOutOfBound(str(tmp_path), bound=1e-6)
    outputs = []
    with pytest.raises(RuntimeError, match="failure check fired at t = 0.0"):
        tsolver.run_simulation(
            tdb.make_run_chunk(case), tdb.init_sim(case, fluid), 0.2, 0.05,
            on_output=outputs.append, verbose=False,
            failure_check=lambda s: check({"WaterBody": s.fluid,
                                           "Wall": case.wall}, float(s.time)))
    assert outputs == []          # it fires before the first output
    names = sorted(os.listdir(tmp_path))
    assert len(names) == 2 and names[0].startswith("Wall_velocity_out_of_bound_")


def test_run_simulation_writes_trace(tmp_path):
    case, fluid = tdb.build_case(dx=0.1, device="cpu")
    sim, timer = tsolver.run_simulation(
        tdb.make_run_chunk(case), tdb.init_sim(case, fluid), 0.02, 0.01,
        verbose=False, trace_dir=str(tmp_path / "trace"))
    assert float(sim.time) >= 0.02 and "integrate" in timer.totals
    (path,) = glob.glob(str(tmp_path / "trace" / "trace_*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    with tsolver.ProfilerTrace(str(tmp_path / "t2")) as tr:
        with tsolver.ProfilerTrace.annotate("my_phase"):
            torch.ones(3).sum()
    with open(tr.path) as f:
        assert "my_phase" in {e.get("name") for e in json.load(f)["traceEvents"]}


def test_run_simulation_runs_sims_without_overflow_flag():
    """The lattice column has no capacity and no `overflow` flag."""
    from sphinxsys_tpu_torch.cases import twisting_column_3d as tc

    case, col = tc.build_case(dx=0.1, engine="lattice", device="cpu")
    sim = tc.init_sim(case, col)
    assert not hasattr(sim, "overflow")
    sim, _ = tsolver.run_simulation(tc.make_run_chunk(case), sim, 0.002,
                                    0.001, verbose=False)
    assert sim.n_steps > 0


def test_run_simulation_raises_on_overflow():
    case, fluid = tdb.build_case(dx=0.1, device="cpu")
    run = tdb.make_run_chunk(case)
    outputs = []

    def overflowing(s, t):
        return dataclasses.replace(run(s, t), overflow=torch.tensor(True))

    with pytest.raises(RuntimeError, match="capacity overflow"):
        tsolver.run_simulation(overflowing, tdb.init_sim(case, fluid), 0.02,
                               0.01, on_output=outputs.append, verbose=False)
    assert outputs == []


# ---------------------------------------------------------------------------
# utils/config.py
# ---------------------------------------------------------------------------

def test_run_config_matches_jax(tmp_path):
    """The flags the port keeps parse as JAX's do; save / load round-trips."""
    pfile = tmp_path / "p.json"
    pfile.write_text(json.dumps({"dx": 0.05, "name": "x"}))
    argv = ["--no-state-recording", "--log_level", "30",
            "--output_dir", "o", "--parameter_file", str(pfile),
            "--set", "dx=0.1", "--set", "device=cpu", "--set", "flag=true",
            "--set", "shape=[1, 2]"]
    j, t = JRunConfig.from_cli(list(argv)), TRunConfig.from_cli(list(argv))
    fields = [f.name for f in dataclasses.fields(TRunConfig)]
    assert fields == ["state_recording", "log_level", "output_dir",
                      "parameters"]
    assert {k: getattr(j, k) for k in fields} == t.__dict__
    assert t.parameters == {"dx": 0.1, "name": "x", "device": "cpu",
                            "flag": True, "shape": [1, 2]}
    assert t.param("dx", 1.0) == 0.1 and t.param("other", 2) == 2
    t.save(str(tmp_path / "t" / "cfg.json"))
    assert TRunConfig.load(str(tmp_path / "t" / "cfg.json")) == t


@pytest.mark.parametrize("flag", [["--relax"], ["--reload"], ["--regression"],
                                  ["--restart_step", "3"]])
def test_run_config_rejects_unported_flags(flag):
    """The reference's flags for paths no case of the port has are not
    accepted: argparse exits with code 2."""
    with pytest.raises(SystemExit) as e:
        TRunConfig.from_cli(flag)
    assert e.value.code == 2
