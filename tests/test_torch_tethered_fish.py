"""Parity of the port's tethered fish (sphinxsys_tpu_torch/cases/
tethered_fish_2d.py: the articulated Planar head, the cable spring, the
passive fish in the ramped channel flow) with the JAX package, on the CPU
in float64 at dx = 0.15.

The builds are held to each other, then both packages run the same
advection steps from their builds to t = 0.15 (equal step counts, q and u
within 1e-12, positions, velocities and forces within 1e-9 of their max,
identical Alive and Indicator masks), and the port continues JAX's own
state, carried across by `convert.sim_from_numpy`, for one step.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sphinxsys_tpu.cases import tethered_fish_2d as jtf
from sphinxsys_tpu.physics import articulated as ja
from sphinxsys_tpu_torch import convert
from sphinxsys_tpu_torch.cases import tethered_fish_2d as ttf
from sphinxsys_tpu_torch.physics import articulated as ta

from test_torch_a7_cases import hold_cli

torch.set_num_threads(1)

DX = 0.15
T_END = 0.15
TOL = 1e-12
POS_TOL = 1e-9


def _close(got, ref, tol=TOL, what=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-300), (what, err)


@pytest.fixture(scope="module")
def runs():
    jc, jf, jfi = jtf.build_case(dx=DX, dtype=jnp.float64)
    tc, tf, tfi = ttf.build_case(dx=DX, dtype=torch.float64, device="cpu")
    jrun = jtf.make_run_chunk(jc)
    js0 = jtf.init_sim(jc, jf, jfi)
    js = jrun(js0, jnp.asarray(T_END, jnp.float64))
    ts = ttf.make_run_chunk(tc)(ttf.init_sim(tc, tf, tfi), T_END)
    return jc, tc, (jf, jfi), (tf, tfi), js, ts


def test_build_matches_jax(runs):
    jc, tc, (jf, jfi), (tf, tfi), _, _ = runs
    assert (tc.n_fluid, tc.n_fish) == (jc.n_fluid, jc.n_fish)
    for k in ("Position", "Mass", "VolumetricMeasure", "NormalDirection",
              "LinearGradientCorrectionMatrix"):
        _close(tfi[k], jfi[k], what=k)
    np.testing.assert_array_equal(tf["Position"].numpy(),
                                  np.asarray(jf["Position"]))
    np.testing.assert_array_equal(tf["Alive"].numpy(), np.asarray(jf["Alive"]))
    assert tf["NReal"] == int(jf["NReal"]) == tc.n_fluid
    np.testing.assert_array_equal(tc.head_mask.numpy(),
                                  np.asarray(jc.head_mask))
    for k in ("head_station", "nose_station"):
        _close(getattr(tc, k), getattr(jc, k), what=k)
    for f in ("axis", "r_parent", "mass", "inertia", "com"):
        _close(getattr(tc.tree, f), getattr(jc.tree, f), what=f)
    np.testing.assert_array_equal(tc.rp.idx.numpy(), np.asarray(jc.rp.idx))


def test_cable_and_head_forces(runs):
    """The cable force, the head's force and torque and the joint torques
    they map to, on a random mobilizer state and random particle
    forces."""
    jc, tc, (_, jfi), (_, tfi), _, _ = runs
    rng = np.random.default_rng(3)
    q = np.asarray([0.4, -0.1, 0.2]) + 0.05 * rng.normal(size=3)
    u = rng.normal(size=3)
    n = tc.n_fish
    F, Fp = rng.normal(size=(n, 2)), rng.normal(size=(n, 2))
    jk = ja.forward_kinematics(jc.tree, jnp.asarray(q), jnp.asarray(u))
    tk = ta.forward_kinematics(tc.tree, torch.as_tensor(q), torch.as_tensor(u))
    for g, r, what in zip(ttf.cable_force(tc, tk), jtf.cable_force(jc, jk),
                          ("force", "torque", "tension")):
        _close(g, r, what=what)
    assert float(ttf.cable_force(tc, tk)[2]) > 0.0     # taut at q_x = 0.4
    jfish = dict(jfi, Force=jnp.asarray(F), ForcePrior=jnp.asarray(Fp))
    tfish = dict(tfi, Force=torch.as_tensor(F), ForcePrior=torch.as_tensor(Fp))
    for g, r, what in zip(ttf._head_force_torque(tc, tfish, tk),
                          jtf._head_force_torque(jc, jfish, jk),
                          ("force", "torque")):
        _close(g, r, what=what)


def test_run_matches_jax(runs):
    jc, tc, _, _, js, ts = runs
    assert ts.n_adv == int(js.n_adv) >= 4
    assert ts.n_s > ts.n_ac >= ts.n_adv
    assert float(ts.time) == pytest.approx(float(js.time), rel=1e-12)
    assert not bool(ts.overflow) and not bool(js.overflow)
    _close(ts.q, js.q, what="q")
    _close(ts.u, js.u, what="u")
    assert abs(float(ts.q[0])) > 0.0
    for k in ("Alive", "Indicator"):
        np.testing.assert_array_equal(ts.fluid[k].numpy(),
                                      np.asarray(js.fluid[k]), err_msg=k)
    alive = np.asarray(js.fluid["Alive"])
    for k in ("Position", "Velocity", "Density", "Force", "ForcePrior"):
        jv = np.asarray(js.fluid[k])
        _close(ts.fluid[k].numpy()[alive], jv[alive], POS_TOL, what=k)
    for k in ("Position", "Velocity", "Force", "ForcePrior",
              "PressureForceFromFluid", "ViscousForceFromFluid",
              "DeformationGradient"):
        _close(ts.fish[k], js.fish[k], POS_TOL, what=k)
    _close(ttf.head_com(tc, ts), jtf.head_com(jc, js))
    assert ttf.cable_tension(tc, ts) == pytest.approx(
        jtf.cable_tension(jc, js), abs=1e-12)


def test_head_moves_rigidly(runs):
    """The head particles keep their pairwise distances within 1e-4 of
    the head's size (tests/test_tethered_fish.py's bound): the constraint
    sets a rigid motion, the 2nd half's x += v dt / 2 moves along its
    linear velocity field."""
    _, tc, _, _, _, ts = runs
    head = tc.head_mask
    p = ts.fish["Position"][head]
    p0 = ts.fish["InitialPosition"][head]
    d, d0 = torch.cdist(p, p), torch.cdist(p0, p0)
    assert float((d - d0).abs().max()) < 1e-4 * max(float(d0.max()), 1.0)
    assert float(torch.linalg.vector_norm(p - p0, dim=-1).min()) > 1e-4


def test_continues_jax_state(runs):
    """JAX's state after its run, carried across, one more advection step
    on each side."""
    jc, tc, _, _, js, _ = runs
    ts = convert.sim_from_numpy(ttf.TetherSim,
                                jax.tree_util.tree_map(np.asarray, js))
    assert ts.n_adv == int(js.n_adv) and ts.n_ac == 0
    js1 = jax.jit(lambda s: jtf._advection_step(jc, s))(js)
    ts1 = ttf.make_advection_step(tc)(ts)
    assert float(ts1.time) == pytest.approx(float(js1.time), rel=1e-12)
    _close(ts1.q, js1.q, what="q")
    _close(ts1.u, js1.u, what="u")
    alive = np.asarray(js1.fluid["Alive"])
    np.testing.assert_array_equal(ts1.fluid["Alive"].numpy(), alive)
    _close(ts1.fluid["Position"].numpy()[alive],
           np.asarray(js1.fluid["Position"])[alive], POS_TOL)
    _close(ts1.fish["Position"], js1.fish["Position"], POS_TOL)


def test_cli_matches_jax(tmp_path, caplog):
    """The float64 frame (the built state is held by
    test_build_matches_jax)."""
    hold_cli("tethered_fish_2d", tmp_path, caplog, built=False)


# ---------------------------------------------------------------------------
# The JAX package's own float32 run of the case at its default width, which
# benchmarks/a7_long.py prints beside the card's:
#   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_tethered_fish.py
# ---------------------------------------------------------------------------

JAX_FULL_WIDTH = Path(__file__).parent / "golden_torch" / "tethered_fish" / \
    "jax_f32_full_width.json"


def write_jax_full_width(t_end=10.0, every=0.05, wall_limit=3600.0):
    """tethered_fish_2d at dx = FISH_L / 100 in float32 (x64 off) on the
    CPU, sampled every `every` to t_end: rows [t, n_adv, max speed of the
    live fluid, head drift x, y, cable tension, overflow]; stops at the
    first overflow or after `wall_limit` seconds, whichever comes first."""
    import json
    import platform
    import time

    case, fluid, fish = jtf.build_case()
    s = jtf.init_sim(case, fluid, fish)
    run = jtf.make_run_chunk(case)
    com0 = jtf.head_com(case, s)
    rows = []
    t0 = time.time()
    for i in range(1, round(t_end / every) + 1):
        s = run(s, jnp.asarray(i * every, s.time.dtype))
        alive = np.asarray(s.fluid["Alive"])
        vmax = float(np.sqrt((np.asarray(s.fluid["Velocity"])[alive] ** 2)
                             .sum(-1).max()))
        drift = jtf.head_com(case, s) - com0
        rows.append([float(s.time), int(s.n_adv), vmax, float(drift[0]),
                     float(drift[1]), jtf.cable_tension(case, s),
                     bool(s.overflow)])
        print(rows[-1], f"{time.time() - t0:.0f} s", flush=True)
        JAX_FULL_WIDTH.parent.mkdir(parents=True, exist_ok=True)
        JAX_FULL_WIDTH.write_text(json.dumps({
            "what": "tethered_fish_2d (sphinxsys_tpu.cases.tethered_fish_2d) "
                    f"at dx = {case.dx} in float32, x64 off: rows [t, n_adv, "
                    "max live fluid speed, head drift x, y, cable tension, "
                    "overflow], to the first overflow or the wall limit",
            "command": "JAX_PLATFORMS=cpu PYTHONPATH=. python "
                       "tests/test_torch_tethered_fish.py",
            "platform": f"cpu ({platform.machine()})",
            "seconds": round(time.time() - t0, 1),
            "n_fluid": case.n_fluid, "n_fish": case.n_fish,
            "rows": rows}) + "\n")
        if bool(s.overflow) or time.time() - t0 > wall_limit:
            break
    print(f"wrote {JAX_FULL_WIDTH}")


if __name__ == "__main__":
    write_jax_full_width()
