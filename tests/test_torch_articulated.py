"""Parity of the port's articulated multibody solver
(sphinxsys_tpu_torch/physics/articulated.py) and its play_simbody case
with the JAX package, on the CPU in float64 (JAX with x64 on).

Each function is held within 1e-12 of max|ref| on random (q, u, tau,
forces) drawn from a numpy seed, on three trees carried across by
`convert.tree_from_numpy`: the tethered fish's Planar mobilizer (sliders
and a pin, massless links), play_simbody's triple pendulum and a double
pendulum with offset COMs under gravity.  play_simbody's 10 steps and
its restart from step 5 are held to JAX's at 1e-12, and the XML
snapshot of the same (step, t, q, u) is byte for byte JAX's.
"""

import filecmp
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sphinxsys_tpu.cases import play_simbody_3d as jps
from sphinxsys_tpu.physics import articulated as ja
from sphinxsys_tpu_torch import convert, run as trun
from sphinxsys_tpu_torch.cases import play_simbody_3d as tps
from sphinxsys_tpu_torch.physics import articulated as ta

torch.set_num_threads(1)

TOL = 1e-12
GRAVITY = (0.0, -9.81, 0.0)


def _close(got, ref, tol=TOL, what=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-300), (what, err)


def _double_pendulum():
    d = jnp.float64
    return ja.ArticulatedTree(
        parent=np.asarray([-1, 0]),
        axis=jnp.tile(jnp.asarray([0.0, 0.0, 1.0], d), (2, 1)),
        r_parent=jnp.asarray([[0.0, 0.0, 0.0], [0.0, -1.0, 0.0]], d),
        r_child=jnp.tile(jnp.asarray([0.0, 1.0, 0.0], d), (2, 1)),
        mass=jnp.asarray([1.0, 2.0], d),
        inertia=jnp.concatenate([jnp.eye(3, dtype=d)[None] * 0.4,
                                 jnp.eye(3, dtype=d)[None] * 0.1]),
        com=jnp.asarray([[0.1, 0.0, 0.0], [0.0, -0.2, 0.0]], d))


TREES = {
    "planar": lambda: ja.planar_tree(2.0, 0.5, (1.0, 2.0, 0.0),
                                     dtype=jnp.float64),
    "simbody": lambda: jps.build_tree(),
    "double": _double_pendulum,
}


def _pair(name):
    jt = TREES[name]()
    tt = convert.tree_from_numpy(jax.tree_util.tree_map(np.asarray, jt))
    return jt, tt


def _draw(seed, n, scale=1.0):
    rng = np.random.default_rng(seed)
    return [scale * rng.normal(size=n) for _ in range(3)]


def test_tree_from_numpy_keeps_the_tree():
    jt, tt = _pair("planar")
    assert tt.joint_type == ("slider", "slider", "pin") and tt.n_links == 3
    np.testing.assert_array_equal(tt.parent, np.asarray(jt.parent))
    assert tt.mass.dtype == torch.float64
    _close(tt.inertia, jt.inertia)
    built = ta.planar_tree(2.0, 0.5, (1.0, 2.0, 0.0), dtype=torch.float64)
    for f in ("axis", "r_parent", "r_child", "mass", "inertia", "com"):
        _close(getattr(built, f), getattr(jt, f), what=f)
    _close(tps.build_tree(device="cpu").r_child, jps.build_tree().r_child)


@pytest.mark.parametrize("name", sorted(TREES))
def test_kinematics_and_energies(name):
    jt, tt = _pair(name)
    q, u, _ = _draw(1, jt.n_links)
    jk = ja.forward_kinematics(jt, jnp.asarray(q), jnp.asarray(u))
    tk = ta.forward_kinematics(tt, torch.as_tensor(q), torch.as_tensor(u))
    for f in ("R", "p", "v", "w", "c", "vc"):
        _close(getattr(tk, f), getattr(jk, f), what=f)
    _close(ta.kinetic_energy(tt, torch.as_tensor(q), torch.as_tensor(u)),
           ja.kinetic_energy(jt, jnp.asarray(q), jnp.asarray(u)))
    _close(ta.potential_energy(tt, torch.as_tensor(q), GRAVITY),
           ja.potential_energy(jt, jnp.asarray(q), GRAVITY))
    _close(ta.mass_matrix(tt, torch.as_tensor(q)),
           ja.mass_matrix(jt, jnp.asarray(q)))


@pytest.mark.parametrize("name", sorted(TREES))
def test_forward_dynamics_free(name):
    jt, tt = _pair(name)
    q, u, tau = _draw(2, jt.n_links)
    got = ta.forward_dynamics(tt, *map(torch.as_tensor, (q, u, tau)), GRAVITY)
    ref = ja.forward_dynamics(jt, *map(jnp.asarray, (q, u, tau)), GRAVITY)
    _close(got, ref)


@pytest.mark.parametrize("pres", [(0,), (1, 2), (0, 1, 2)])
def test_forward_dynamics_prescribed_blocks(pres):
    """M_ff udot_f = rhs_f - M_fp udot_p on the triple pendulum with
    gravity, for a prescribed root, a prescribed tail and all three."""
    jt, tt = _pair("simbody")
    q, u, tau = _draw(3, 3)
    a = np.random.default_rng(4).normal(size=3)
    free = np.asarray([i for i in range(3) if i not in pres], int)
    pres = np.asarray(pres, int)
    got = ta.forward_dynamics(tt, *map(torch.as_tensor, (q, u, tau)), GRAVITY,
                              prescribed_udot=torch.as_tensor(a),
                              free_idx=free, pres_idx=pres)
    ref = ja.forward_dynamics(jt, *map(jnp.asarray, (q, u, tau)), GRAVITY,
                              prescribed_udot=jnp.asarray(a), free_idx=free,
                              pres_idx=pres)
    _close(got, ref)
    _close(got[pres], a[pres])


@pytest.mark.parametrize("name", sorted(TREES))
def test_generalized_forces(name):
    jt, tt = _pair(name)
    n = jt.n_links
    rng = np.random.default_rng(5)
    q = rng.normal(size=n)
    F, T = rng.normal(size=(n, 3)), rng.normal(size=(n, 3))
    _close(ta.generalized_forces(tt, *map(torch.as_tensor, (q, F, T))),
           ja.generalized_forces(jt, *map(jnp.asarray, (q, F, T))))


@pytest.mark.parametrize("name", sorted(TREES))
def test_rk4_step(name):
    jt, tt = _pair(name)
    q, u, tau = _draw(6, jt.n_links, 0.5)
    tstep = ta.make_articulated_step(tt, GRAVITY, joint_damping=0.3)
    jstep = ja.make_articulated_step(jt, GRAVITY, joint_damping=0.3)
    gq, gu = tstep(torch.tensor(0.7, dtype=torch.float64),
                   *map(torch.as_tensor, (q, u)),
                   torch.tensor(1e-2, dtype=torch.float64),
                   torch.as_tensor(tau))
    rq, ru = jstep(0.7, jnp.asarray(q), jnp.asarray(u), 1e-2, jnp.asarray(tau))
    _close(gq, rq, what="q")
    _close(gu, ru, what="u")


def test_rk4_step_with_motions():
    """A prescribed root and two free links under gravity: the prescribed
    rows exact, the free ones integrated."""
    jt, tt = _pair("simbody")
    jm = ja.MotionSet.build([ja.sinusoid_motion(0.3, 1.0, 2.0, 0.1), None,
                             None])
    tm = ta.MotionSet.build([ta.sinusoid_motion(0.3, 1.0, 2.0, 0.1), None,
                             None])
    q, u, tau = _draw(7, 3, 0.3)
    gq, gu = ta.make_articulated_step(tt, GRAVITY, tm)(
        0.4, *map(torch.as_tensor, (q, u)), 5e-3, torch.as_tensor(tau))
    rq, ru = ja.make_articulated_step(jt, GRAVITY, jm)(
        0.4, jnp.asarray(q), jnp.asarray(u), 5e-3, jnp.asarray(tau))
    _close(gq, rq, what="q")
    _close(gu, ru, what="u")


@pytest.mark.parametrize("t", [0.0, 0.37, 3.2, 10.0, 11.5])
def test_motion_rates(t):
    """q, its rate and acceleration (torch.func.grad against jax.grad),
    inside, at both ends of and past the ramp."""
    jm, tm = jps.build_motions(), tps.build_motions()
    got = tm.q_u_udot(torch.tensor(t, dtype=torch.float64), torch.float64)
    ref = jm.q_u_udot(t, jnp.float64)
    for g, r, what in zip(got, ref, ("q", "u", "udot")):
        _close(g, r, what=what)
    # the closed form of the ramped sinusoid's first joint past the ramp
    if t > 10.0:
        a, w = math.pi / 40.0, 2.0 * math.pi
        _close(got[1][0], a * w * math.cos(w * t))


def test_constrain_by_link():
    jt, tt = _pair("planar")
    rng = np.random.default_rng(8)
    q, u = rng.normal(size=3), rng.normal(size=3)
    n = 20
    st = {"Position": rng.normal(size=(n, 3)),
          "Velocity": rng.normal(size=(n, 3)),
          "AverageVelocity": rng.normal(size=(n, 3))}
    mask = rng.random(n) < 0.5
    station = rng.normal(size=(n, 3))
    ref = ja.constrain_by_link(
        {k: jnp.asarray(v) for k, v in st.items()}, jnp.asarray(mask),
        ja.forward_kinematics(jt, jnp.asarray(q), jnp.asarray(u)), 2,
        jnp.asarray(station))
    got = ta.constrain_by_link(
        {k: torch.as_tensor(v) for k, v in st.items()}, torch.as_tensor(mask),
        ta.forward_kinematics(tt, torch.as_tensor(q), torch.as_tensor(u)), 2,
        torch.as_tensor(station))
    for k in st:
        _close(got[k], ref[k], what=k)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_state_xml_bytes(tmp_path, dtype):
    rng = np.random.default_rng(9)
    t = dtype(rng.random() * 10)
    q, u = rng.normal(size=3).astype(dtype), rng.normal(size=3).astype(dtype)
    jp = ja.write_state_xml(str(tmp_path / "jax"), 7, jnp.asarray(t),
                            jnp.asarray(q), jnp.asarray(u))
    tp = ta.write_state_xml(str(tmp_path / "port"), 7, torch.as_tensor(t),
                            torch.as_tensor(q), torch.as_tensor(u))
    assert filecmp.cmp(jp, tp, shallow=False)
    for got, ref in zip(ta.read_state_xml(str(tmp_path / "jax"), 7),
                        ja.read_state_xml(str(tmp_path / "port"), 7)):
        np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def simbody_runs(tmp_path_factory):
    jd = str(tmp_path_factory.mktemp("jax"))
    td = str(tmp_path_factory.mktemp("port"))
    js = jps.run_case(jd)
    ts = tps.run_case(td, device="cpu")
    return jd, td, js, ts


def test_play_simbody_matches_jax(simbody_runs):
    """10 unit steps of 20 RK4 sub-steps: every snapshot within 1e-12 of
    JAX's, and the final q on the closed-form motions."""
    jd, td, js, ts = simbody_runs
    for step in range(1, tps.NUM_STEPS + 1):
        (tt_, tq, tu), (jt_, jq, ju) = (ta.read_state_xml(td, step),
                                        ja.read_state_xml(jd, step))
        assert tt_ == pytest.approx(jt_, rel=1e-15)
        _close(tq, jq, what=("q", step))
        _close(tu, ju, what=("u", step))
    _close(ts.q, js.q)
    _close(ts.u, js.u)
    ref_q, ref_u, _ = tps.build_motions().q_u_udot(ts.t, torch.float64)
    _close(ts.q, ref_q)
    _close(ts.u, ref_u)


def test_play_simbody_restart(simbody_runs, tmp_path):
    """Restarted from step 5's snapshot, steps 6-10 equal the
    uninterrupted run's bit for bit."""
    _, td, _, ts = simbody_runs
    import shutil

    rd = tmp_path / "restart"
    rd.mkdir()
    shutil.copy(f"{td}/multibody_state_000005.xml", rd)
    rs = tps.run_case(str(rd), restart_step=5, device="cpu")
    assert torch.equal(rs.q, ts.q) and torch.equal(rs.u, ts.u)
    for step in range(6, 11):
        name = f"multibody_state_{step:06d}.xml"
        assert filecmp.cmp(f"{td}/{name}", str(rd / name), shallow=False)


def test_play_simbody_cli(tmp_path, caplog):
    """The CLI entry with `--set restart_step=`; `--restart_step` itself
    stays rejected."""
    import logging

    from sphinxsys_tpu import run as jrun

    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    with caplog.at_level(logging.INFO):
        assert jrun.main(["play_simbody_3d", "--output_dir", jd]) == 0
        assert trun.main(["play_simbody_3d", "--set", "device=cpu",
                          "--output_dir", td]) == 0
        assert trun.main(["play_simbody_3d", "--set", "device=cpu",
                          "--set", "restart_step=8", "--output_dir", td]) == 0
    for step in range(1, 11):
        for got, ref in zip(ta.read_state_xml(td, step),
                            ja.read_state_xml(jd, step)):
            _close(got, ref, what=step)
    with pytest.raises(SystemExit):
        trun.main(["play_simbody_3d", "--restart_step", "5"])
