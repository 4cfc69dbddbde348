"""The port's gather routes (build_case -> init_sim -> make_run_chunk, and
solver.run_simulation) held to the JAX package's, on the CPU:

* in float64 against JAX's gather route: equal advection and acoustic
  step counts and positions within 1e-9 of max|x| for the 2D dambreak
  (dx = 0.1 to t = 0.3), the 3D dambreak (dx = 0.2 to t = 0.2) and
  Taylor–Green (dx = 0.05 to t = 0.05); one dambreak and one Taylor–Green
  run with `sort_every=2`, so that the Morton resort runs; fsi2's gather
  route to t = 0.1 with JAX's counts 3 / 15 / 30, the fluid's velocity and
  the insert's positions within 1e-10;
* the third oracle, in float32: the port's gather route against the
  port's block route (the sweeps' plain versions, which the CUDA kernels
  take on the card) on the three scenes of tests/test_scene_engines.py,
  with equal counts and positions within 2e-3 of max|x|, its tolerance;
* the dambreak's mechanical energy at dx = 0.05 to t = 2.5 in float32,
  sampled every 0.1 through solver.run_simulation, against the committed
  golden curve (tests/golden/dambreak_2d, the JAX gather engine's) by the
  reference's DTW criterion.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sphinxsys_tpu.cases import dambreak_2d as jdb, dambreak_3d as jdb3, \
    fsi2 as jf, taylor_green_2d as jtg
from sphinxsys_tpu.io.regression import DTWRegressionTest
from sphinxsys_tpu_torch import solver
from sphinxsys_tpu_torch.cases import dambreak_2d as tdb, dambreak_3d as tdb3, \
    fsi2 as tf, taylor_green_2d as ttg
from sphinxsys_tpu_torch.engine import scene as tsc
from sphinxsys_tpu_torch.physics import general as tgd

torch.set_num_threads(1)

POS_TOL = 1e-9
VEL_TOL = 1e-10
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "dambreak_2d")
CASES = {"dambreak_2d": (jdb, tdb), "dambreak_3d": (jdb3, tdb3),
         "taylor_green_2d": (jtg, ttg)}


def _jax_run(jm, dx, t_end, sort_every=None):
    case, fluid = jm.build_case(dx=dx, dtype=jnp.float64)
    if sort_every is not None:
        case = dataclasses.replace(case, sort_every=sort_every)
    return jm.make_run_chunk(case)(jm.init_sim(case, fluid),
                                   jnp.asarray(t_end, jnp.float64))


def _port_run(tm, dx, t_end, sort_every=None):
    case, fluid = tm.build_case(dx=dx, dtype=torch.float64, device="cpu")
    if sort_every is not None:
        case = dataclasses.replace(case, sort_every=sort_every)
    sim, _ = solver.run_simulation(tm.make_run_chunk(case),
                                   tm.init_sim(case, fluid), t_end,
                                   t_end / 2, verbose=False)
    return sim


def _hold_positions(tpos, jpos):
    jpos = np.asarray(jpos)
    err = np.abs(tpos.numpy() - jpos).max()
    assert err <= POS_TOL * np.abs(jpos).max(), err


@pytest.mark.parametrize("name,dx,t_end", [
    ("dambreak_2d", 0.1, 0.3), ("dambreak_3d", 0.2, 0.2),
    ("taylor_green_2d", 0.05, 0.05)])
def test_gather_route_matches_jax(name, dx, t_end):
    jm, tm = CASES[name]
    js, ts = _jax_run(jm, dx, t_end), _port_run(tm, dx, t_end)
    assert (ts.n_adv, ts.n_ac) == (int(js.n_adv), int(js.n_ac))
    assert ts.n_adv >= 3
    assert not bool(ts.overflow) and not bool(js.overflow)
    assert float(ts.time) == pytest.approx(float(js.time), rel=1e-12)
    _hold_positions(ts.fluid["Position"], js.fluid["Position"])
    np.testing.assert_allclose(ts.fluid["Velocity"].numpy(),
                               np.asarray(js.fluid["Velocity"]), rtol=0,
                               atol=VEL_TOL)


@pytest.mark.parametrize("name,dx,t_end", [
    ("dambreak_2d", 0.1, 0.1), ("taylor_green_2d", 0.05, 0.05)])
def test_morton_resort_matches_jax(name, dx, t_end):
    """sort_every=2: the resort runs after every second advection step;
    the rows end in JAX's order (another order than the unsorted run's)."""
    jm, tm = CASES[name]
    js = _jax_run(jm, dx, t_end, sort_every=2)
    ts = _port_run(tm, dx, t_end, sort_every=2)
    assert (ts.n_adv, ts.n_ac) == (int(js.n_adv), int(js.n_ac))
    assert ts.n_adv >= 2
    _hold_positions(ts.fluid["Position"], js.fluid["Position"])
    for k in ("Velocity", "Density", "Mass"):
        np.testing.assert_allclose(ts.fluid[k].numpy(), np.asarray(js.fluid[k]),
                                   rtol=0, atol=VEL_TOL, err_msg=k)
    unsorted = _port_run(tm, dx, t_end)
    assert not np.array_equal(unsorted.fluid["Position"].numpy(),
                              ts.fluid["Position"].numpy())


def test_fsi2_gather_route_matches_jax():
    jcase, jfluid, jsolid = jf.build_case(dx=0.1, dtype=jnp.float64)
    js = jf.make_run_chunk(jcase)(jf.init_sim(jcase, jfluid, jsolid),
                                  jnp.asarray(0.1, jnp.float64))
    tcase, tfluid, tsolid = tf.build_case(dx=0.1, dtype=torch.float64,
                                          device="cpu")
    ts = tf.make_run_chunk(tcase)(tf.init_sim(tcase, tfluid, tsolid), 0.1)
    assert (ts.n_adv, ts.n_ac, ts.n_s) == (
        int(js.n_adv), int(js.n_ac), int(js.n_s)) == (3, 15, 30)
    assert not bool(ts.overflow) and not bool(js.overflow)
    _hold_positions(ts.fluid["Position"], js.fluid["Position"])
    np.testing.assert_allclose(ts.fluid["Velocity"].numpy(),
                               np.asarray(js.fluid["Velocity"]), rtol=0,
                               atol=VEL_TOL)
    np.testing.assert_allclose(ts.solid["Position"].numpy(),
                               np.asarray(js.solid["Position"]), rtol=0,
                               atol=VEL_TOL)
    idx, w = tf.tip_observer(tcase, ts.solid)
    ji, jw = jf.tip_observer(jcase, js.solid)
    tip_j = np.asarray(jf.observe_tip(js, ji, jw))
    assert np.abs(tf.observe_tip(ts.solid, idx, w).numpy() - tip_j).max() \
        < VEL_TOL


# the scenes of tests/test_scene_engines.py: (case, dx, t_end, block knobs)
SCENES = [
    ("dambreak_2d", 0.1, 0.30, dict(cap=16)),
    ("dambreak_3d", 0.2, 0.20, dict(cap=48)),
    ("taylor_green_2d", 0.05, 0.05, dict()),
]


@pytest.mark.parametrize("name,dx,t_end,block_kw", SCENES,
                         ids=[s[0] for s in SCENES])
def test_gather_route_matches_block_route(name, dx, t_end, block_kw):
    """The third oracle within the port, in float32: the gather route and
    the block route (use_kernels=True) give equal counts and positions
    within 2e-3 of max|x| (minimum image where the box wraps)."""
    _, tm = CASES[name]
    case, fluid = tm.build_case(dx=dx, device="cpu")
    sg = tm.make_run_chunk(case)(tm.init_sim(case, fluid), t_end)
    scene, fluid_b = tm.build_block_case(dx=dx, device="cpu", **block_kw)
    assert scene.eng.use_kernels
    sb = tsc.make_run_chunk(scene)(tsc.init_sim(scene, fluid_b), t_end)
    assert not bool(sg.overflow) and not bool(sb.overflow)
    assert (sg.n_adv, sg.n_ac) == (sb.n_adv, sb.n_ac)
    n = scene.n_fluid
    pos_g = sg.fluid["Position"][:n].numpy()
    pos_b = tsc.blocks_to_particles(scene, sb)["Position"][:n].numpy()
    d = pos_g - pos_b
    if scene.wrap:
        L = np.asarray(case.grid.periodic_lengths)
        d -= np.round(d / L) * L
    assert np.abs(d).max() < 2e-3 * np.abs(pos_g).max(), np.abs(d).max()


def test_dambreak_energy_holds_golden_curve():
    """The 2D dambreak at dx = 0.05 (800 fluid particles) in float32 to
    t = 2.5 through solver.run_simulation, the mechanical energy sampled
    every 0.1 (26 values, t = 0 included), within 1.01 times the DTW
    threshold of the committed run (tests/test_golden_regression.py:20-34
    holds the JAX gather engine to the same curve)."""
    case, fluid = tdb.build_case(dx=0.05, device="cpu")
    assert case.n_fluid == 800
    sim = tdb.init_sim(case, fluid)
    energy = lambda s: float(tgd.total_mechanical_energy(s.fluid,
                                                         case.gravity))
    series = [energy(sim)]
    sim, _ = solver.run_simulation(tdb.make_run_chunk(case), sim, 2.5, 0.1,
                                   on_output=lambda s: series.append(
                                       energy(s)), verbose=False)
    assert len(series) == 26 and not bool(sim.overflow)
    ok, report = DTWRegressionTest(GOLDEN, "WaterBody",
                                   "TotalMechanicalEnergy").test(
                                       np.asarray(series))
    assert ok, report


def test_list_overflow_raises_in_run_simulation():
    """A neighbour list too short for the lattice (k_inner = 8 against
    ~20 neighbours in 2D) sets the overflow flag at init_sim, and
    solver.run_simulation raises at the first output."""
    case, fluid = tdb.build_case(dx=0.1, dtype=torch.float64, device="cpu",
                                 k_inner=8)
    sim = tdb.init_sim(case, fluid)
    assert bool(sim.overflow)
    with pytest.raises(RuntimeError, match="overflow"):
        solver.run_simulation(tdb.make_run_chunk(case), sim, 0.02, 0.01,
                              verbose=False)
