"""Parity of the port's four FVM cases with the JAX package's on the CPU,
float64, at reduced widths over a few steps: the cylinder O-grid at
12 x 24 (through the Fluent writer and parser), the supersonic cylinder
at 10 x 24, the double Mach reflection at 48 x 12 with and without MUSCL,
and the 3D channel on the hex box of tests/test_torch_fvm.py with the
channel's boundary codes and BCSpec (the reference's ICEM mesh is not in
the repository; both packages' `read_fluent_msh` return the box).  Equal
step counts, the time within 1e-12, every field within 1e-9 of its max
|JAX|, and each case's observables; then the CLI entries on the CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_corrected_cases import cli_runs
from test_torch_fvm import HEX_L, hex_box_raw
from test_torch_viscosity import close

from sphinxsys_tpu.cases import double_mach_reflection_2d as jdmr
from sphinxsys_tpu.cases import fvm_channel_3d as jch
from sphinxsys_tpu.cases import fvm_cylinder_2d as jcyl
from sphinxsys_tpu.cases import supersonic_cylinder_2d as jsup
from sphinxsys_tpu.fvm import mesh as jm
from sphinxsys_tpu_torch import run as trun
from sphinxsys_tpu_torch.cases import double_mach_reflection_2d as tdmr
from sphinxsys_tpu_torch.cases import fvm_channel_3d as tch
from sphinxsys_tpu_torch.cases import fvm_cylinder_2d as tcyl
from sphinxsys_tpu_torch.cases import supersonic_cylinder_2d as tsup

torch.set_num_threads(1)

RUN_TOL = 1e-9
F64 = dict(dtype=torch.float64, device="cpu")
FIELDS = ("Density", "Velocity", "Pressure", "TotalEnergyDensity")


def channel_raw():
    """The test box with the channel's codes: inlet x0, outlet x1, walls
    y, symmetry z."""
    raw = hex_box_raw()
    ctr = np.stack([raw.nodes[f[:n]].mean(0) for f, n in
                    zip(raw.face_nodes, raw.face_nnodes)])
    bt = raw.face_btype.copy()
    for axis, (lo, hi) in enumerate(((10, 5), (3, 3), (7, 7))):
        bt[(bt != 2) & (ctr[:, axis] < 1e-9)] = lo
        bt[(bt != 2) & (ctr[:, axis] > HEX_L[axis] - 1e-9)] = hi
    return jm.RawMesh(dim=3, nodes=raw.nodes, face_nodes=raw.face_nodes,
                      face_cells=raw.face_cells, face_btype=bt,
                      face_nnodes=raw.face_nnodes)


def _build(name, monkeypatch):
    """(JAX module, port module, JAX case/state, port case/state, t_end)."""
    if name == "cylinder":
        return (jcyl, tcyl, jcyl.build_case(nr=12, nt=24, dtype=jnp.float64),
                tcyl.build_case(nr=12, nt=24, **F64), 0.05)
    if name == "supersonic":
        return (jsup, tsup, jsup.build_case(nr=10, nt=24, dtype=jnp.float64),
                tsup.build_case(nr=10, nt=24, **F64), 0.1)
    if name.startswith("dmr"):
        muscl = name == "dmr_muscl"
        return (jdmr, tdmr,
                jdmr.build_case(nx=48, ny=12, dtype=jnp.float64, muscl=muscl),
                tdmr.build_case(nx=48, ny=12, muscl=muscl, **F64), 0.01)
    raw = channel_raw()
    monkeypatch.setattr(jch, "read_fluent_msh", lambda path: raw)
    return (jch, tch, jch.build_case(mesh_path="box", dtype=jnp.float64),
            tch.build_case(raw=raw, **F64), 0.1)


def _fields(name, s):
    return s.state if name == "channel" else s.fluid


CASES = ("cylinder", "supersonic", "dmr_first_order", "dmr_muscl",
         "channel")


@pytest.mark.parametrize("name", CASES)
def test_case_run_matches_jax(name, monkeypatch):
    jmod, tmod, (jc, jf), (tc, tf), t_end = _build(name, monkeypatch)
    assert tc.dm.n_cells == jc.dm.n_cells
    for k in jf:
        close(tf[k], jf[k], 1e-15, ("start", k))
    js = jmod.make_run_chunk(jc)(jmod.init_sim(jc, jf),
                                 jnp.asarray(t_end, jnp.float64))
    ts = tmod.make_run_chunk(tc)(tmod.init_sim(tc, tf), t_end)
    assert ts.n_steps == int(js.n_steps) >= 3
    assert float(ts.time) == pytest.approx(float(js.time), rel=1e-12)
    jfl, tfl = _fields(name, js), _fields(name, ts)
    assert set(tfl) == set(jfl)
    for k in FIELDS:
        if k in jfl:
            close(tfl[k], jfl[k], RUN_TOL, k)
            assert bool(torch.isfinite(tfl[k]).all()), k
    if name == "cylinder":
        close(tcyl.cylinder_force(tc, ts), jcyl.cylinder_force(jc, js),
              RUN_TOL, "force")
        assert tcyl.drag_coefficient(tc, ts) == pytest.approx(
            jcyl.drag_coefficient(jc, js), rel=1e-9)
        body, jbody = tcyl.cells_as_body(tc, ts), jcyl.cells_as_body(jc, js)
        assert body["NReal"] == int(jbody["NReal"])
        for k in ("Position", "VolumetricMeasure"):
            close(body[k], jbody[k], 1e-15, k)
    elif name == "supersonic":
        np.testing.assert_allclose(tsup.stagnation_state(tc, ts),
                                   jsup.stagnation_state(jc, js), rtol=1e-9)
    elif name.startswith("dmr"):
        assert tdmr.wall_shock_position(tc, ts) == \
            jdmr.wall_shock_position(jc, js)
    else:
        for b in (10, 5):
            assert tch.boundary_flux(tc, ts, b) == pytest.approx(
                jch.boundary_flux(jc, js, b), rel=1e-9, abs=1e-12)
        assert tch.max_speed(ts) == pytest.approx(jch.max_speed(js),
                                                  rel=1e-12)


def test_dmr_ghosts_follow_the_time():
    """The top boundary's travelling shock: the post-shock faces grow with
    t, and the JAX package's ghosts equal the port's at two times."""
    jc, _ = jdmr.build_case(nx=48, ny=12, dtype=jnp.float64)
    tc, _ = tdmr.build_case(nx=48, ny=12, **F64)
    rng = np.random.default_rng(2)
    F = tc.dm.area.shape[0]
    l = [rng.random(F), rng.normal(size=(F, 2)), rng.random(F),
         rng.random(F)]
    r = [rng.random(F), rng.normal(size=(F, 2)), rng.random(F),
         rng.random(F)]
    post = []
    for t in (0.0, 0.1):
        got = tdmr._ghosts([torch.as_tensor(a) for a in l],
                           [torch.as_tensor(a) for a in r], tc.dm,
                           torch.tensor(t, dtype=torch.float64))
        ref = jdmr._ghosts([jnp.asarray(a) for a in l],
                           [jnp.asarray(a) for a in r], jc.dm,
                           jnp.asarray(t))
        for g, x in zip(got, ref):
            close(g, x, 1e-15, t)
        post.append(int((got[0] == tdmr.RHO_POST).sum()))
    assert post[1] > post[0]


def test_channel_raises_without_its_mesh(tmp_path):
    with pytest.raises(FileNotFoundError, match="ICEM"):
        tch.build_case(mesh_path=str(tmp_path / "none.msh"), **F64)


def test_channel_has_no_default_mesh_path(tmp_path, monkeypatch):
    """The mesh is not in the repository: with neither `mesh_path=` nor
    FVM3D_MESH the case reads nothing and says how to give it; FVM3D_MESH
    is the path it reads when set."""
    monkeypatch.delenv("FVM3D_MESH", raising=False)
    with pytest.raises(FileNotFoundError, match="mesh_path= or FVM3D_MESH"):
        tch.build_case(**F64)
    missing = str(tmp_path / "env.msh")
    monkeypatch.setenv("FVM3D_MESH", missing)
    with pytest.raises(FileNotFoundError, match="env.msh"):
        tch.build_case(**F64)


@pytest.mark.parametrize("case,sets,bodies,n", (
    ("fvm_cylinder_2d", ("nr=6", "nt=12", "t_end=0.02"), ("FluidCells",),
     72),
    ("supersonic_cylinder_2d", ("nr=6", "nt=12", "t_end=0.05"),
     ("GasCells",), 72),
    ("double_mach_reflection_2d", ("nx=24", "ny=6", "t_end=0.004"),
     ("GasCells",), 144),
))
def test_fvm_cli_entries_run_on_the_cpu(case, sets, bodies, n, tmp_path,
                                        caplog):
    cli_runs(case, sets, bodies, tmp_path, caplog, {bodies[0]: n})


def test_channel_cli_entry(tmp_path, monkeypatch, caplog):
    """The entry writes no body (JAX's neither); it runs on a mesh file's
    path, here the test box behind a stub reader."""
    mesh = tmp_path / "box.msh"
    mesh.write_text("")
    monkeypatch.setattr(tch, "read_fluent_msh", lambda path: channel_raw())
    args = [x for kv in (f"mesh_path={mesh}", "t_end=0.05", "n_output=2",
                         "dtype=float64", "device=cpu") for x in ("--set", kv)]
    out = tmp_path / "out"
    assert trun.main(["fvm_channel_3d", *args, "--output_dir", str(out)]) == 0
    assert not out.exists() or not list(out.iterdir())
    with pytest.raises(FileNotFoundError):
        trun.main(["fvm_channel_3d", "--set",
                   f"mesh_path={tmp_path / 'none.msh'}", "--set",
                   "device=cpu", "--output_dir", str(out)])


# the float32 check of chip_smoke.py phase 22 (`a7j_fvm_f32_check`): each
# FVM case at its JAX default width, built in float32 and in float64,
# these steps on each; the spread of float32's change from the start
# against float64's, as a share of float64's largest change
F32_STEPS = 10
F32_FIELDS = ("Density", "Velocity", "Pressure", "TotalEnergyDensity")
CHANNEL_CELLS = (64, 40, 2)
CHANNEL_LENGTHS = (0.77, 0.5, 0.03)


def jax_f32_spread():
    """The JAX package's own float32 spread from its float64 on the CPU
    -> tests/golden_torch/fvm/jax_f32_spread.json (~1 min)."""
    import json
    import os

    import jax

    from sphinxsys_tpu_torch.fvm.meshgen import hex_box

    jax.config.update("jax_enable_x64", True)
    raw = hex_box(*CHANNEL_CELLS, CHANNEL_LENGTHS, tch.CHANNEL_SIDES)
    jch.read_fluent_msh = lambda path: raw
    mods = {"fvm_cylinder_2d": jcyl, "supersonic_cylinder_2d": jsup,
            "double_mach_reflection_2d": jdmr, "fvm_channel_3d": jch}
    out = {}
    for name, mod in mods.items():
        runs = []
        for dt in (jnp.float64, jnp.float32):
            case, st = mod.build_case(dtype=dt)
            s = mod.init_sim(case, st)
            fields = s.state if name == "fvm_channel_3d" else s.fluid
            start = {k: np.asarray(v, np.float64) for k, v in fields.items()}
            run = mod.make_run_chunk(case)
            for _ in range(F32_STEPS):      # one step each: the next float
                s = run(s, s.time * (1.0 + 2.0 ** -20) + 1e-30)
            assert int(s.n_steps) == F32_STEPS
            fields = s.state if name == "fvm_channel_3d" else s.fluid
            runs.append({k: np.asarray(v, np.float64) - start[k]
                         for k, v in fields.items()})
        spread = {k: float(np.abs(runs[1][k] - runs[0][k]).max()
                           / np.abs(runs[0][k]).max())
                  for k in F32_FIELDS if k in runs[0]}
        out[name] = dict(steps=F32_STEPS, spread=spread)
        print(name, spread)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "golden_torch", "fvm", "jax_f32_spread.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(dict(protocol="each case at its JAX default width (the "
                       "channel on hex_box" + str(CHANNEL_CELLS) + "), built "
                       "in float32 and float64, " + str(F32_STEPS)
                       + " steps; max |f32 change - f64 change| / max |f64 "
                       "change|", cases=out), f, indent=1)


if __name__ == "__main__":
    jax_f32_spread()
