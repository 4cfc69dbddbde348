"""Parity of the port's fsi2 (cases/fsi2.py on the moving-wall block engine:
engine/scene.py `Hooks` / `moving_wall_scene`, engine/block_fluid.py
`refresh_wall_blocks`, physics/fsi.py, physics/fsi_blocks.py,
core/geometry.py `Ball`) with the JAX package's `build_block_case`, on the
CPU in float64, at dx = 0.1 (5,180 fluid, 1,104 wall and 150 solid
particles on a 50 x 21 cell grid periodic in x).

* the built state: fluid, the trimmed wall, the solid with its Ball and
  box normals, the held part and B; the initial slotting (every block
  field, both window maps, the solid's fluid windows);
* the two FSI forces and the moving wall's refresh on the slotted state
  with seeded fluid and solid kinematics, within 1e-12 of max|ref|;
* one run to t = 0.1 against JAX's XLA block route: equal counts
  (3 advection steps, 15 acoustic and 30 solid sub-steps), the fluid's
  velocity and the solid's positions within 1e-10, through the block
  forms and through the sweeps' plain versions (float64 reaches 9e-13
  and 2e-11 there).

Beyond t ~ 0.1 fsi2 is too sensitive to hold pointwise: JAX's own float32
runs of its block and gather routes, with x64 on and off, part by up to
0.55 in the beam tip's displacement within t = 1.  Those four runs to
t = 5 are in tests/golden_torch/fsi2/jax_f32_runs.json (written by running
this file: see write_jax_runs); chip_smoke.py draws the card run's count
band and tip envelope from them."""

import json
import platform
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sphinxsys_tpu.cases import fsi2 as jf
from sphinxsys_tpu.engine import block_fluid as jem
from sphinxsys_tpu.engine import scene as jsc
from sphinxsys_tpu.physics import fsi as jfsi
from sphinxsys_tpu.physics import fsi_blocks as jfsb
from sphinxsys_tpu_torch import convert
from sphinxsys_tpu_torch.cases import fsi2 as tf
from sphinxsys_tpu_torch.engine import block_fluid as tem
from sphinxsys_tpu_torch.engine import scene as tsc
from sphinxsys_tpu_torch.physics import fsi as tfsi
from sphinxsys_tpu_torch.physics import fsi_blocks as tfsb

torch.set_num_threads(1)

DX = 0.1
T_END = 0.1
JAX_RUNS = Path(__file__).resolve().parent / "golden_torch" / "fsi2" \
    / "jax_f32_runs.json"


def _close(got, ref, tol, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-300), f"{what}: {err:.3e}"


@pytest.fixture(scope="module")
def jax_case():
    """JAX's block case in float64, its initial BlockSim and its run to
    T_END on the XLA route."""
    scene, fluid, solid = jf.build_block_case(dx=DX, dtype=jnp.float64)
    s0 = jf.init_block_sim(scene, fluid, solid)
    s1 = jsc.make_run_chunk(scene)(s0, jnp.asarray(T_END, jnp.float64))
    return scene, fluid, solid, s0, s1


@pytest.fixture(scope="module")
def port_case():
    scene, fluid, solid = tf.build_block_case(dx=DX, dtype=torch.float64,
                                              device="cpu", use_kernels=False)
    return scene, fluid, solid, tf.init_block_sim(scene, fluid, solid)


def test_built_state_matches_jax(jax_case, port_case):
    jscene, jfluid, jsolid, _, _ = jax_case
    tscene, tfluid, tsolid, _ = port_case
    jb, tb = jscene.base, tscene.base
    assert (tb.n_fluid, tb.n_wall, tb.n_solid) == (jb.n_fluid, jb.n_wall,
                                                    jb.n_solid) == (5180, 1104, 150)
    grid = lambda g: (g.lower, g.spacing, g.shape, g.periodic)
    assert grid(tb.grid_f) == grid(jb.grid_f)
    for k in ("Position", "VolumetricMeasure", "Mass", "Density", "Velocity"):
        np.testing.assert_array_equal(tfluid[k].numpy(), np.asarray(jfluid[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(tscene.wall_valid.numpy(),
                                  np.asarray(jscene.wall_valid))
    assert int(tscene.wall_valid[:tb.n_wall].sum()) < tb.n_wall   # trimmed
    np.testing.assert_array_equal(tb.wall["Position"].numpy(),
                                  np.asarray(jb.wall["Position"]))
    _close(tb.wall["NormalDirection"].numpy(), jb.wall["NormalDirection"],
           1e-12, "wall normals")
    np.testing.assert_array_equal(tsolid["Position"].numpy(),
                                  np.asarray(jsolid["Position"]))
    for k in ("NormalDirection", "InitialNormalDirection",
              "LinearGradientCorrectionMatrix"):
        _close(tsolid[k].numpy(), jsolid[k], 1e-12, k)
    assert bool(torch.isfinite(tsolid["NormalDirection"]).all())
    np.testing.assert_array_equal(tb.base_mask.numpy(), np.asarray(jb.base_mask))
    np.testing.assert_array_equal(tb.rp.idx.numpy(), np.asarray(jb.rp.idx))
    assert (tscene.eng.c_max, tscene.c_max_wall) == (jscene.eng.c_max,
                                                     jscene.c_max_wall)


def test_initial_slotting_matches_jax(jax_case, port_case):
    _, _, _, js0, _ = jax_case
    _, _, _, ts0 = port_case
    for k, v in convert.to_numpy(ts0.fluid_b).items():
        np.testing.assert_array_equal(v, np.asarray(js0.fluid_b[k]), err_msg=k)
    np.testing.assert_array_equal(ts0.nbr_inner.numpy(), np.asarray(js0.nbr_inner))
    np.testing.assert_array_equal(ts0.nbr_wall.numpy(), np.asarray(js0.nbr_wall))
    np.testing.assert_array_equal(ts0.aux["sol_win"].numpy(),
                                  np.asarray(js0.aux["sol_win"]))
    for k, v in convert.to_numpy(ts0.wall_b0).items():
        tol = 1e-12 if k == "NormalDirection" else 0.0
        np.testing.assert_allclose(v, np.asarray(js0.wall_b0[k]), rtol=0,
                                   atol=tol, err_msg=k)


def _noisy(js0, jsolid, seed=5):
    """The slotted fluid blocks and the solid with seeded pressure,
    velocity, ForcePrior and wall kinematics, as numpy (JAX side) and as
    tensors (port side)."""
    rng = np.random.default_rng(seed)
    fb = {k: np.array(v) for k, v in js0.fluid_b.items()}
    m = fb["SlotMask"]
    fb["Pressure"] = np.where(m, rng.normal(size=m.shape), 0.0)
    fb["Velocity"] = np.where(m[..., None], rng.normal(size=m.shape + (2,)), 0.0)
    fb["ForcePrior"] = np.where(m[..., None],
                                1e-3 * rng.normal(size=m.shape + (2,)), 0.0)
    so = {k: np.array(v) for k, v in jsolid.items()}
    n = so["Position"].shape[0]
    so["AverageVelocity"] = 0.1 * rng.normal(size=(n, 2))
    so["AverageAcceleration"] = rng.normal(size=(n, 2))
    so["Position"] = so["Position"] + 0.01 * DX * rng.normal(size=(n, 2))
    jfb = {k: jnp.asarray(v) for k, v in fb.items()}
    jso = {k: jnp.asarray(v) for k, v in so.items()}
    return jfb, jso, convert.block_state_from_numpy(fb), \
        convert.state_from_numpy(so)


def test_fsi_forces_and_wall_refresh_match_jax(jax_case, port_case):
    jscene, _, jsolid, js0, _ = jax_case
    tscene, _, _, ts0 = port_case
    jfb, jso, tfb, tso = _noisy(js0, jsolid)
    kernel_j, kernel_t = jscene.base.kernel, tscene.base.kernel
    box = tscene.eng.box
    win_j, win_t = js0.aux["sol_win"], ts0.aux["sol_win"]
    jv = jfsb.viscous_force_from_fluid_b(jso, jfb, win_j, kernel_j, 2,
                                         jf.MU_F, jscene.base.adaptation.h,
                                         box=box)
    tv = tfsb.viscous_force_from_fluid_b(tso, tfb, win_t, kernel_t, 2,
                                         tf.MU_F, tscene.base.adaptation.h,
                                         box=box)
    jp = jfsb.pressure_force_from_fluid_b(jso, jfb, win_j, kernel_j, 2,
                                          jscene.base.riemann, box=box)
    tp = tfsb.pressure_force_from_fluid_b(tso, tfb, win_t, kernel_t, 2,
                                          tscene.base.riemann, box=box)
    for k in ("ViscousForceFromFluid", "ForcePrior"):
        _close(tv[k].numpy(), jv[k], 1e-12, f"viscous {k}")
    for k in ("PressureForceFromFluid", "ForcePrior"):
        _close(tp[k].numpy(), jp[k], 1e-12, f"pressure {k}")
    assert float(tp["PressureForceFromFluid"].abs().max()) > 0.0

    jw = jem.refresh_wall_blocks(jscene.eng, js0.wall_bm,
                                 jscene.wall_state_fn({"solid": jso}),
                                 js0.wall_b0)
    tw = tem.refresh_wall_blocks(ts0.wall_bm,
                                 tscene.wall_state_fn({"solid": tso}),
                                 ts0.wall_b0)
    for k, v in tw.items():
        _close(v.numpy(), jw[k], 1e-12, f"refreshed wall {k}")


def test_elastic_normal_update_matches_jax():
    """The closed-form 2D polar rotation against JAX's SVD."""
    rng = np.random.default_rng(8)
    n = 200
    F = np.eye(2) + 0.3 * rng.normal(size=(n, 2, 2))
    F = F[np.linalg.det(F) > 0.1]
    n0 = rng.normal(size=(len(F), 2))
    n0 /= np.linalg.norm(n0, axis=1, keepdims=True)
    j = jfsi.update_elastic_normal_direction(
        {"DeformationGradient": jnp.asarray(F),
         "InitialNormalDirection": jnp.asarray(n0)})
    t = tfsi.update_elastic_normal_direction(
        {"DeformationGradient": torch.as_tensor(F),
         "InitialNormalDirection": torch.as_tensor(n0)})
    _close(t["NormalDirection"].numpy(), j["NormalDirection"], 1e-12)


@pytest.mark.parametrize("t", [0.3, 1.7, 2.5])
def test_inflow_matches_jax(jax_case, t):
    _, _, jsolid, js0, _ = jax_case
    jfb, _, tfb, _ = _noisy(js0, jsolid)
    j = jf.inflow_velocity_b(jfb, jnp.asarray(t, jnp.float64), 20 * DX)
    o = tf.inflow_velocity_b(tfb, torch.tensor(t, dtype=torch.float64), 20 * DX)
    _close(o["Velocity"].numpy(), j["Velocity"], 1e-15)


@pytest.mark.parametrize("use_kernels", [False, True], ids=["blocks", "sweeps"])
def test_run_matches_jax(jax_case, port_case, use_kernels):
    """To T_END through make_run_chunk: JAX's counts (3 / 15 / 30), the
    fluid's velocity by particle and the solid's positions within 1e-10
    (the block forms, or the sweeps' plain versions, which the kernels
    take on the card)."""
    jscene, _, _, _, js = jax_case
    if use_kernels:
        tscene, tfluid, tsolid = tf.build_block_case(
            dx=DX, dtype=torch.float64, device="cpu", use_kernels=True)
        ts0 = tf.init_block_sim(tscene, tfluid, tsolid)
    else:
        tscene, _, _, ts0 = port_case
    ts = tsc.make_run_chunk(tscene)(ts0, T_END)
    assert (ts.n_adv, ts.n_ac, ts.aux["n_s"]) == (
        int(js.n_adv), int(js.n_ac), int(js.aux["n_s"])) == (3, 15, 30)
    assert not bool(ts.overflow) and not bool(js.overflow)
    assert float(ts.time) == pytest.approx(float(js.time), rel=1e-12)
    pj = jsc.blocks_to_particles(jscene, js)
    pt = tsc.blocks_to_particles(tscene, ts)
    assert np.abs(pt["Velocity"].numpy() - np.asarray(pj["Velocity"])).max() < 1e-10
    so_t, so_j = ts.aux["solid"], js.aux["solid"]
    assert np.abs(so_t["Position"].numpy()
                  - np.asarray(so_j["Position"])).max() < 1e-10
    idx, w = tf.tip_observer(tscene.base, so_t)
    ji, jw = jf.tip_observer(jscene.base, so_j)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    tip_j = np.asarray(jnp.sum(so_j["Position"][ji] * jw[:, None], axis=0))
    assert np.abs(tf.observe_tip(so_t, idx, w).numpy() - tip_j).max() < 1e-10


def test_relax_insert_builds_and_runs():
    """build_case(relax_insert=20) on the CPU: the insert's relaxation
    residual (with the surface correction) falls from the jittered,
    bounded lattice it starts from, every insert particle stays inside its
    shape, the frozen topology is built on the relaxed positions, and the
    gather route takes an advection step without overflow."""
    from sphinxsys_tpu_torch.neighbors.cell_list import build_cell_table
    from sphinxsys_tpu_torch.neighbors.neighbor_list import build_neighbor_list
    from sphinxsys_tpu_torch.physics import relax as rx

    case, fluid, solid = tf.build_case(dx=DX, dtype=torch.float64,
                                       device="cpu", relax_insert=20)
    _, _, lattice = tf.build_case(dx=DX, dtype=torch.float64, device="cpu")
    shape = tf.insert_shape()
    ad = case.adaptation
    table_L = rx.half_space_gradient_table(ad.kernel, 2)
    n = case.n_solid
    vol = torch.full((n,), DX * DX, dtype=torch.float64)

    def residual(pos):
        nl = build_neighbor_list(pos, n, pos, n, build_cell_table(
            pos, n, case.grid_s, 24), case.grid_s, ad.cutoff, 64, False)
        res = rx.relaxation_residual(pos, vol, nl, ad.kernel, 2) \
            + rx.surface_residual_correction(pos, shape, table_L)
        return float(torch.linalg.vector_norm(res, dim=-1).max())

    pos = solid["Position"]
    start = rx.surface_bounding(rx.randomize_positions(lattice["Position"],
                                                       DX, 0), shape, DX)
    assert residual(pos) < residual(start)
    assert float(shape.signed_distance(pos).max()) < 0.0
    assert float((pos - lattice["Position"]).abs().max()) > 1e-3
    torch.testing.assert_close(solid["InitialPosition"], pos, rtol=0, atol=0)
    sim = tf.make_advection_step(case)(tf.init_sim(case, fluid, solid))
    assert (sim.n_adv, sim.n_ac) == (1, 5) and not bool(sim.overflow)
    assert bool(torch.isfinite(sim.solid["Position"]).all())


def test_jax_f32_runs_hold_chip_smoke_gates():
    """The committed JAX runs (four, to t = 5) and what chip_smoke.py
    draws from them: each run's counts at the block route's end time
    (FSI2_T_END) sit in the block route's count band, each gather run's
    counts at the gather route's end time (FSI2_GATHER_T_END) in the
    gather band, and every tip inside the envelope, so the card's runs
    are held to a spread JAX's own float32 runs show."""
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    runs = json.loads(JAX_RUNS.read_text())["runs"]
    assert {(r["route"], r["x64"]) for r in runs} == {
        ("block", True), ("block", False), ("gather", True), ("gather", False)}
    gates = cs.fsi2_gates()
    for r in runs:
        t, n_adv, n_ac, n_s, dx, dy = np.asarray(r["rows"]).T
        assert t[-1] >= 5.0 and not r["overflow"]
        at = np.argmax(t >= cs.FSI2_T_END)
        assert t[at] >= cs.FSI2_T_END
        assert gates["n_ac"][0] <= n_ac[at] <= gates["n_ac"][1]
        assert gates["n_s"][0] <= n_s[at] <= gates["n_s"][1]
        assert np.hypot(dx, dy).max() <= gates["tip_radius"]
    block64 = next(r for r in runs if r["route"] == "block" and r["x64"])
    assert block64["rows"][-1][2:4] == [790, 1580]
    at = next(row for row in block64["rows"] if row[0] >= cs.FSI2_T_END)
    assert gates["n_ac"] == pytest.approx(
        ((1 - cs.FSI2_COUNT_BAND) * at[2], (1 + cs.FSI2_COUNT_BAND) * at[2]))
    assert gates["n_s"] == pytest.approx(
        ((1 - cs.FSI2_COUNT_BAND) * at[3], (1 + cs.FSI2_COUNT_BAND) * at[3]))
    gather = cs.fsi2_gather_gates()          # the gather route's (phase 11)
    assert gather["tip_radius"] == gates["tip_radius"]
    for r in runs:
        if r["route"] == "gather":
            t, _, n_ac, n_s, dx, dy = np.asarray(r["rows"]).T
            at = np.argmax(t >= cs.FSI2_GATHER_T_END)
            assert t[at] >= cs.FSI2_GATHER_T_END
            assert gather["n_ac"][0] <= n_ac[at] <= gather["n_ac"][1]
            assert gather["n_s"][0] <= n_s[at] <= gather["n_s"][1]
            assert np.hypot(dx, dy).max() <= gather["gather_tip"]


def _jax_run(route: str, x64: bool, t_end: float = 5.0, every: float = 0.05):
    """One JAX float32 run of fsi2 at dx = 0.1 on the CPU (`route` "block":
    build_block_case's XLA route; "gather": build_case's neighbour lists),
    sampled every `every`: rows [t, n_adv, n_ac, n_s, tip dx, tip dy]."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", x64)
    if route == "block":
        scene, fluid, solid = jf.build_block_case(dx=DX, dtype=jnp.float32)
        s, run, base = jf.init_block_sim(scene, fluid, solid), \
            jsc.make_run_chunk(scene), scene.base
        get = lambda s: (s.aux["solid"], int(s.aux["n_s"]))
    else:
        base, fluid, solid = jf.build_case(dx=DX, dtype=jnp.float32)
        s, run = jf.init_sim(base, fluid, solid), jf.make_run_chunk(base)
        get = lambda s: (s.solid, int(s.n_s))
    idx, w = jf.tip_observer(base, solid)
    tip = lambda so: np.asarray(jnp.sum(so["Position"][idx] * w[:, None], 0))
    tip0 = tip(solid)
    rows, k = [], 0
    while float(s.time) < t_end:
        k += 1
        s = run(s, jnp.asarray(k * every, jnp.float32))
        so, n_s = get(s)
        d = tip(so) - tip0
        rows.append([float(s.time), int(s.n_adv), int(s.n_ac), n_s,
                     float(d[0]), float(d[1])])
    return {"route": route, "x64": x64, "overflow": bool(s.overflow),
            "jax_version": jax.__version__, "rows": rows}


def write_jax_runs():
    """Write JAX_RUNS: the four runs, each in a process of its own (x64 is
    set once per process), all four at once."""
    import os

    procs = [subprocess.Popen(
        [sys.executable, __file__, route, str(int(x64))],
        env=dict(os.environ, JAX_PLATFORMS="cpu",
                 JAX_ENABLE_X64=str(int(x64))),
        stdout=subprocess.PIPE, text=True)
        for route in ("block", "gather") for x64 in (True, False)]
    runs = []
    for p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{p.args} failed ({p.returncode})")
        runs.append(json.loads(out.strip().splitlines()[-1]))
    JAX_RUNS.parent.mkdir(parents=True, exist_ok=True)
    JAX_RUNS.write_text(json.dumps({
        "what": "fsi2 (sphinxsys_tpu.cases.fsi2) at dx = 0.1 in float32 to "
                "t = 5, sampled every 0.05: rows [t, n_adv, n_ac, n_s, "
                "tip dx, tip dy], the tip the frozen-weight observer at "
                "(6, 2)",
        "command": "JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_fsi2.py",
        "platform": f"cpu ({platform.machine()})",
        "runs": runs,
    }) + "\n")
    print(f"wrote {len(runs)} runs to {JAX_RUNS}")


if __name__ == "__main__":
    if len(sys.argv) == 3:
        print(json.dumps(_jax_run(sys.argv[1], bool(int(sys.argv[2])))))
    else:
        write_jax_runs()
