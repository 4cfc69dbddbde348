"""Parity of the port's rigid bodies (physics/rigid.py: the planar body,
the 6-DOF quaternion body, the pin joint) and wavemakers
(physics/wavemaker.py) with the JAX package, on the CPU in float64, and
the port's counterparts of the JAX package's function-level tests
(tests/test_rigid.py, tests/test_owsc.py, tests/test_nonlinear_wave_fsi.py).

Inputs are made from a seed with numpy and fed to both sides as the same
arrays: particle sets with a random mask, forces, normals, rigid states
and times.  Every output is held within 1e-12 of its max|ref|; the
counterparts keep the JAX tests' own bounds.
"""

import math

import numpy as np
import torch

import jax
import jax.numpy as jnp

from sphinxsys_tpu.physics import rigid as jrg
from sphinxsys_tpu.physics import wavemaker as jwm
from sphinxsys_tpu_torch import convert
from sphinxsys_tpu_torch.physics import rigid as trg
from sphinxsys_tpu_torch.physics import wavemaker as twm

torch.set_num_threads(1)

TOL = 1e-12
T64 = torch.float64


def close(got, ref, tol=TOL, what=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max() if got.size else 0.0
    assert err <= tol * max(np.abs(ref).max() if ref.size else 0.0, 1e-300), \
        (what, err)


def hold_tuple(t, j):
    assert type(t).__name__ == type(j).__name__
    for k, v in j._asdict().items():
        close(getattr(t, k), v, what=k)


def _t(x):
    return torch.as_tensor(np.array(x))


def _particles(rng, n, dim):
    """A particle set on both sides: positions, masses, forces, velocities
    and rotated normals, and a mask that leaves some rows out."""
    pos = rng.normal(size=(n, dim))
    nd = rng.normal(size=(n, dim))
    nd /= np.linalg.norm(nd, axis=-1, keepdims=True)
    s = {"Position": pos, "Mass": 0.5 + rng.random(n),
         "Force": rng.normal(size=(n, dim)),
         "ForcePrior": rng.normal(size=(n, dim)),
         "Velocity": rng.normal(size=(n, dim)),
         "AverageVelocity": rng.normal(size=(n, dim)),
         "NormalDirection": nd, "InitialNormalDirection": nd[::-1].copy()}
    mask = rng.random(n) < 0.7
    j = {k: jnp.asarray(v) for k, v in s.items()}
    t = {k: _t(v) for k, v in s.items()}
    return j, t, jnp.asarray(mask), torch.as_tensor(mask)


def _rb2(rng):
    vals = dict(com=rng.normal(size=2), vel=rng.normal(size=2),
                theta=rng.normal(), omega=rng.normal(),
                mass=1.0 + rng.random(), inertia=0.5 + rng.random())
    return (jrg.RigidBody2D(**{k: jnp.asarray(v) for k, v in vals.items()}),
            trg.RigidBody2D(**{k: _t(v) for k, v in vals.items()}))


def _rb3(rng):
    q = rng.normal(size=4)
    A = rng.normal(size=(3, 3))
    vals = dict(com=rng.normal(size=3), vel=rng.normal(size=3),
                quat=q / np.linalg.norm(q), ang_mom=rng.normal(size=3),
                mass=1.0 + rng.random(), inertia_body=A @ A.T + np.eye(3))
    return (jrg.RigidBody3D(**{k: jnp.asarray(v) for k, v in vals.items()}),
            trg.RigidBody3D(**{k: _t(v) for k, v in vals.items()}))


def _pj(rng):
    vals = dict(pivot=rng.normal(size=2), theta=rng.normal(),
                omega=rng.normal(), mass=1.0 + rng.random(),
                inertia=0.5 + rng.random(), com0=rng.normal(size=2))
    return (jrg.PinJoint2D(**{k: jnp.asarray(v) for k, v in vals.items()}),
            trg.PinJoint2D(**{k: _t(v) for k, v in vals.items()}))


# ---------------------------------------------------------------------------
# the planar body
# ---------------------------------------------------------------------------

def test_planar_body_functions_match_jax():
    rng = np.random.default_rng(1)
    j, t, jm, tm = _particles(rng, 57, 2)
    hold_tuple(trg.rigid_body_from_particles(t, tm),
               jrg.rigid_body_from_particles(j, jm))
    jb, tb = _rb2(rng)
    for keys in (("Force", "ForcePrior"), ("ForcePrior",)):
        jf, jt = jrg.total_force_and_torque(j, jm, jb, force_keys=keys)
        tf, tt = trg.total_force_and_torque(t, tm, tb, force_keys=keys)
        close(tf, jf)
        close(tt, jt)
    f, tq, dt = rng.normal(size=2), rng.normal(), 1e-3
    for g in (None, (0.0, -9.81)):
        hold_tuple(trg.rigid_step(tb, _t(f), _t(tq), dt, gravity=g),
                   jrg.rigid_step(jb, jnp.asarray(f), jnp.asarray(tq), dt,
                                  gravity=g))
    # gravity as a tensor made once (what the cases pass)
    hold_tuple(trg.rigid_step(tb, _t(f), _t(tq), _t(dt),
                              gravity=torch.tensor([0.0, -9.81], dtype=T64)),
               jrg.rigid_step(jb, jnp.asarray(f), jnp.asarray(tq), dt,
                              gravity=(0.0, -9.81)))
    pos0, com0 = rng.normal(size=(57, 2)), rng.normal(size=2)
    jo = jrg.constrain_by_rigid_body(j, jm, jb, jnp.asarray(pos0),
                                     jnp.asarray(com0))
    to = trg.constrain_by_rigid_body(t, tm, tb, _t(pos0), _t(com0))
    for k in ("Position", "Velocity", "AverageVelocity", "NormalDirection"):
        close(to[k], jo[k], what=k)
    # rows outside the mask keep their values
    assert torch.equal(to["Position"][~tm], t["Position"][~tm])


def test_rotation_is_stacked_on_the_device():
    th = torch.tensor(0.3, dtype=T64)
    c, s = math.cos(0.3), math.sin(0.3)
    close(trg.rotation_2d(th), [[c, -s], [s, c]])


def test_rigid_ballistics_with_spin():
    """tests/test_rigid.py:13: a free body under gravity with a constant
    torque, the parabola and the spin-up, 1,000 steps."""
    rb = trg.RigidBody2D(com=torch.zeros(2, dtype=T64),
                         vel=torch.tensor([1.0, 2.0], dtype=T64),
                         theta=torch.zeros((), dtype=T64),
                         omega=torch.zeros((), dtype=T64),
                         mass=torch.tensor(2.0, dtype=T64),
                         inertia=torch.tensor(0.5, dtype=T64))
    g = torch.tensor([0.0, -9.81], dtype=T64)
    torque, zero = torch.tensor(0.1, dtype=T64), torch.zeros(2, dtype=T64)
    for _ in range(1000):
        rb = trg.rigid_step(rb, zero, torque, 1e-3, gravity=g)
    np.testing.assert_allclose(float(rb.com[0]), 1.0, rtol=1e-3)
    np.testing.assert_allclose(float(rb.com[1]), 2.0 - 0.5 * 9.81,
                               rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(float(rb.omega), 0.2, rtol=1e-6)
    np.testing.assert_allclose(float(rb.theta), 0.1, rtol=2e-3)


def test_constraint_imposes_rigid_motion():
    """tests/test_rigid.py:33: a 90-degree turn about COM0, then the
    translation; v = V + omega x r."""
    pos0 = np.asarray([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    state = {"Position": _t(pos0), "Velocity": torch.zeros(3, 2, dtype=T64)}
    rb = trg.RigidBody2D(com=_t([2.0, 1.0]), vel=_t([0.5, 0.0]),
                         theta=_t(math.pi / 2), omega=_t(1.0), mass=_t(1.0),
                         inertia=_t(1.0))
    com0 = pos0.mean(axis=0)
    out = trg.constrain_by_rigid_body(state, torch.ones(3, dtype=torch.bool),
                                      rb, _t(pos0), _t(com0))
    p = out["Position"].numpy()
    expect = np.asarray([2.0, 1.0]) + (pos0 - com0) @ np.asarray(
        [[0.0, -1.0], [1.0, 0.0]]).T
    np.testing.assert_allclose(p, expect, atol=1e-6)
    r = p - np.asarray([2.0, 1.0])
    np.testing.assert_allclose(out["Velocity"].numpy(), np.asarray(
        [0.5, 0.0]) + np.stack([-r[:, 1], r[:, 0]], -1), atol=1e-6)


# ---------------------------------------------------------------------------
# the 6-DOF body
# ---------------------------------------------------------------------------

def test_quaternion_body_functions_match_jax():
    rng = np.random.default_rng(3)
    j, t, jm, tm = _particles(rng, 61, 3)
    hold_tuple(trg.rigid_body_from_particles_3d(t, tm),
               jrg.rigid_body_from_particles_3d(j, jm))
    jb, tb = _rb3(rng)
    close(trg.quat_to_matrix(tb.quat), jrg.quat_to_matrix(jb.quat))
    a, b = rng.normal(size=4), rng.normal(size=4)
    close(trg.quat_multiply(_t(a), _t(b)),
          jrg.quat_multiply(jnp.asarray(a), jnp.asarray(b)))
    close(trg.angular_velocity(tb), jrg.angular_velocity(jb))
    jf, jt = jrg.total_force_and_torque_3d(j, jm, jb)
    tf, tt = trg.total_force_and_torque_3d(t, tm, tb)
    close(tf, jf)
    close(tt, jt)
    f, tq = rng.normal(size=3), rng.normal(size=3)
    for g in (None, (0.0, 0.0, -9.81)):
        hold_tuple(trg.rigid_step_3d(tb, _t(f), _t(tq), 1e-3, gravity=g),
                   jrg.rigid_step_3d(jb, jnp.asarray(f), jnp.asarray(tq),
                                     1e-3, gravity=g))
    pos0, com0 = rng.normal(size=(61, 3)), rng.normal(size=3)
    jo = jrg.constrain_by_rigid_body_3d(j, jm, jb, jnp.asarray(pos0),
                                        jnp.asarray(com0))
    to = trg.constrain_by_rigid_body_3d(t, tm, tb, _t(pos0), _t(com0))
    for k in ("Position", "Velocity", "AverageVelocity", "NormalDirection"):
        close(to[k], jo[k], what=k)


def test_box_inertia_tensor_from_particles():
    """tests/test_rigid.py:89: a particle-sampled box's inertia is the
    grid's discrete 1/12 m (b^2 + c^2 - 2 dx^2), near the continuum's."""
    dx, (a, b, c), rho = 0.05, (0.4, 0.2, 0.1), 2.0
    axes = [np.arange(-e / 2 + dx / 2, e / 2, dx) for e in (a, b, c)]
    pos = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    n = len(pos)
    rb = trg.rigid_body_from_particles_3d(
        {"Position": _t(pos), "Mass": torch.full((n,), rho * dx ** 3,
                                                  dtype=T64)},
        torch.ones(n, dtype=torch.bool))
    m = rho * a * b * c
    np.testing.assert_allclose(float(rb.mass), m, rtol=1e-12)
    da, db, dc = a ** 2 - dx ** 2, b ** 2 - dx ** 2, c ** 2 - dx ** 2
    I = rb.inertia_body.numpy()
    np.testing.assert_allclose(np.diag(I), m / 12.0 * np.array(
        [db + dc, da + dc, da + db]), rtol=1e-9)
    np.testing.assert_allclose(np.diag(I), m / 12.0 * np.array(
        [b ** 2 + c ** 2, a ** 2 + c ** 2, a ** 2 + b ** 2]), rtol=0.15)
    assert np.abs(I - np.diag(np.diag(I))).max() < 1e-12


def _free_top():
    I = np.diag([1.0, 2.0, 3.0])
    vals = dict(com=np.zeros(3), vel=np.zeros(3),
                quat=np.array([1.0, 0.0, 0.0, 0.0]),
                ang_mom=I @ np.array([2.0, 0.1, 1.0]), mass=np.array(1.0),
                inertia_body=I)
    return (jrg.RigidBody3D(**{k: jnp.asarray(v) for k, v in vals.items()}),
            trg.RigidBody3D(**{k: _t(v) for k, v in vals.items()}))


def test_torque_free_tumbling_conserves_invariants():
    """tests/test_rigid.py:118: a free asymmetric top to t = 2 (4,000
    steps): L exactly kept, the rotational energy to the integrator's
    order, q unit; and the trajectory held to JAX's (its steps compiled
    as one loop) at 1e-9."""
    jb, tb = _free_top()

    def ke(rb):
        w = trg.angular_velocity(rb)
        R = trg.quat_to_matrix(rb.quat)
        return 0.5 * float(w @ (R @ (rb.inertia_body @ (R.T @ w))))

    L0, ke0 = tb.ang_mom.clone(), ke(tb)
    zero = torch.zeros(3, dtype=T64)
    for _ in range(4000):
        tb = trg.rigid_step_3d(tb, zero, zero, 5e-4)
    np.testing.assert_allclose(tb.ang_mom.numpy(), L0.numpy(), rtol=1e-12)
    np.testing.assert_allclose(ke(tb), ke0, rtol=2e-3)
    np.testing.assert_allclose(float(torch.linalg.vector_norm(tb.quat)), 1.0,
                               rtol=1e-9)
    assert abs(float(tb.quat[0])) < 0.999
    jz = jnp.zeros(3)
    jb = jax.lax.fori_loop(0, 4000, lambda i, b: jrg.rigid_step_3d(
        b, jz, jz, 5e-4), jb)
    for k, v in jb._asdict().items():
        close(getattr(tb, k), v, 1e-9, k)


def test_constant_torque_spin_up_and_gravity_3d():
    """tests/test_rigid.py:143: the parabola and the spin-up about a
    principal axis; the attitude a pure z-rotation."""
    I = torch.diag(torch.tensor([0.5, 0.5, 0.8], dtype=T64))
    rb = trg.RigidBody3D(com=torch.zeros(3, dtype=T64),
                         vel=_t([1.0, 0.0, 2.0]),
                         quat=_t([1.0, 0.0, 0.0, 0.0]),
                         ang_mom=torch.zeros(3, dtype=T64), mass=_t(2.0),
                         inertia_body=I)
    torque, zero = _t([0.0, 0.0, 0.4]), torch.zeros(3, dtype=T64)
    g = _t([0.0, 0.0, -9.81])
    for _ in range(1000):
        rb = trg.rigid_step_3d(rb, zero, torque, 1e-3, gravity=g)
    np.testing.assert_allclose(float(rb.com[0]), 1.0, rtol=1e-3)
    np.testing.assert_allclose(float(rb.com[2]), 2.0 - 0.5 * 9.81,
                               rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(float(trg.angular_velocity(rb)[2]), 0.5,
                               rtol=1e-6)
    np.testing.assert_allclose(rb.quat[1:3].numpy(), 0.0, atol=1e-12)


def test_constraint_imposes_rigid_motion_3d():
    """tests/test_rigid.py:163: 90 degrees about z, v = V + omega x r."""
    pos0 = np.asarray([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                       [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    state = {"Position": _t(pos0), "Velocity": torch.zeros(4, 3, dtype=T64)}
    half = math.sqrt(0.5)
    omega = np.asarray([0.0, 0.0, 1.5])
    I = 2.0 * np.eye(3)
    rb = trg.RigidBody3D(com=_t([2.0, 1.0, 0.5]), vel=_t([0.5, 0.0, 0.0]),
                         quat=_t([half, 0.0, 0.0, half]),
                         ang_mom=_t(I @ omega), mass=_t(1.0),
                         inertia_body=_t(I))
    com0 = pos0.mean(axis=0)
    out = trg.constrain_by_rigid_body_3d(
        state, torch.ones(4, dtype=torch.bool), rb, _t(pos0), _t(com0))
    p = out["Position"].numpy()
    Rz = np.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    np.testing.assert_allclose(p, np.asarray([2.0, 1.0, 0.5])
                               + (pos0 - com0) @ Rz.T, atol=1e-12)
    r = p - np.asarray([2.0, 1.0, 0.5])
    np.testing.assert_allclose(out["Velocity"].numpy(),
                               np.asarray([0.5, 0.0, 0.0])
                               + np.cross(omega, r), atol=1e-12)


# ---------------------------------------------------------------------------
# the pin joint
# ---------------------------------------------------------------------------

def test_pin_joint_functions_match_jax():
    rng = np.random.default_rng(5)
    j, t, jm, tm = _particles(rng, 43, 2)
    pivot = (0.3, -0.2)
    hold_tuple(trg.pin_joint_from_particles(t, tm, pivot),
               jrg.pin_joint_from_particles(j, jm, pivot))
    jp, tp = _pj(rng)
    for keys in (("Force", "ForcePrior"), ("ForcePrior",)):
        close(trg.pin_torque(t, tm, tp, force_keys=keys),
              jrg.pin_torque(j, jm, jp, force_keys=keys))
    tq = rng.normal()
    for kw in (dict(), dict(damping=20.0), dict(stiffness=8.0),
               dict(damping=2.0, gravity=(0.0, -9.81))):
        hold_tuple(trg.pin_joint_step(tp, _t(tq), 1e-3, **kw),
                   jrg.pin_joint_step(jp, jnp.asarray(tq), 1e-3, **kw))
    pos0 = rng.normal(size=(43, 2))
    jo = jrg.constrain_by_pin_joint(j, jm, jp, jnp.asarray(pos0))
    to = trg.constrain_by_pin_joint(t, tm, tp, _t(pos0))
    for k in ("Position", "Velocity", "AverageVelocity", "NormalDirection"):
        close(to[k], jo[k], what=k)


def test_pin_joint_dynamics_units():
    """tests/test_owsc.py:23: the undamped pendulum-spring about the
    pivot swings at omega_n = sqrt(k / I) and keeps its amplitude."""
    z2 = torch.zeros(2, dtype=T64)
    pj = trg.PinJoint2D(pivot=z2, theta=_t(0.2), omega=_t(0.0), mass=_t(1.0),
                        inertia=_t(0.5), com0=z2)
    th = []
    zero = torch.zeros((), dtype=T64)
    for _ in range(5000):
        pj = trg.pin_joint_step(pj, zero, 1e-3, stiffness=8.0)
        th.append(float(pj.theta))
    th = np.asarray(th)
    zc = np.nonzero((th[:-1] > 0) & (th[1:] <= 0))[0] * 1e-3
    assert abs(np.diff(zc).mean() - 2 * np.pi / 4.0) < 0.02
    assert abs(th).max() < 0.21


def test_rigid_tuples_cross_over():
    """convert.rigid_from_numpy: JAX's tuples of numpy leaves become the
    port's, field for field."""
    rng = np.random.default_rng(7)
    for j, _ in (_rb2(rng), _rb3(rng), _pj(rng)):
        t = convert.rigid_from_numpy(jax.tree.map(np.asarray, j))
        hold_tuple(t, j)
        assert all(torch.is_tensor(v) for v in t)


# ---------------------------------------------------------------------------
# physics/wavemaker.py
# ---------------------------------------------------------------------------

def test_dispersion_and_strokes_match_jax():
    for om, h in ((math.pi, 0.691), (2.0, 0.8), (6.0, 0.3), (0.5, 5.0)):
        k = twm.dispersion_wavenumber(om, h, 9.81)
        assert k == jwm.dispersion_wavenumber(om, h, 9.81)
        assert twm.piston_stroke(0.1, k, h, 9.81, om) == \
            jwm.piston_stroke(0.1, k, h, 9.81, om)
    tp = twm.make_piston(5.0, 10.0, 0.691, 9.81, model_scale=25.0)
    jp = jwm.make_piston(5.0, 10.0, 0.691, 9.81, model_scale=25.0)
    assert (tp.stroke, tp.omega) == (jp.stroke, jp.omega)


def test_motions_match_jax():
    rng = np.random.default_rng(9)
    ts = rng.random(7) * 30.0
    tp = twm.make_piston(5.0, 10.0, 0.691, 9.81, model_scale=25.0)
    jp = jwm.make_piston(5.0, 10.0, 0.691, 9.81, model_scale=25.0)
    kw = dict(depth=0.8, tf=20.48, xf=12.0, fmin=0.32, fmax=0.96,
              amplitude=0.0068, n_components=32, g=9.81)
    tk = twm.make_focused_packet(dtype=T64, **kw)
    jk = jwm.make_focused_packet(dtype=jnp.float64, **kw)
    for f in ("om", "k", "S"):
        close(getattr(tk, f), getattr(jk, f), what=f)
    for t in ts:
        for tm_, jm_ in ((tp, jp), (tk, jk)):
            for f in ("displacement", "velocity", "acceleration"):
                close(getattr(tm_, f)(_t(t)), getattr(jm_, f)(jnp.asarray(t)),
                      what=f)


def test_packet_tables_in_the_run_dtype_and_device():
    kw = dict(depth=0.8, tf=20.48, xf=12.0, fmin=0.32, fmax=0.96,
              amplitude=0.0068, n_components=32, g=9.81)
    pk = twm.make_focused_packet(dtype=torch.float32, device="cpu", **kw)
    assert pk.om.dtype == pk.k.dtype == pk.S.dtype == torch.float32
    t = torch.tensor(20.0, dtype=torch.float32)
    assert pk.velocity(t).dtype == torch.float32


def test_apply_wavemaker_and_damping_zone_match_jax():
    rng = np.random.default_rng(11)
    j, t, jm, tm = _particles(rng, 50, 2)
    j["InitialPosition"] = j["Position"] + 0.01
    t["InitialPosition"] = t["Position"] + 0.01
    j["AverageAcceleration"] = jnp.asarray(rng.normal(size=(50, 2)))
    t["AverageAcceleration"] = _t(np.asarray(j["AverageAcceleration"]))
    motion = (twm.make_piston(5.0, 10.0, 0.691, 9.81, model_scale=25.0),
              jwm.make_piston(5.0, 10.0, 0.691, 9.81, model_scale=25.0))
    for axis in (0, 1):
        to = twm.apply_wavemaker(t, tm, motion[0], _t(1.3), axis=axis)
        jo = jwm.apply_wavemaker(j, jm, motion[1], jnp.asarray(1.3),
                                 axis=axis)
        for k in ("Position", "Velocity", "AverageVelocity",
                  "AverageAcceleration"):
            close(to[k], jo[k], what=(axis, k))
        assert torch.equal(to["Position"][~tm], t["Position"][~tm])
    # a wall without AverageAcceleration: the rows outside get zero
    t2 = {k: v for k, v in t.items() if k != "AverageAcceleration"}
    j2 = {k: v for k, v in j.items() if k != "AverageAcceleration"}
    close(twm.apply_wavemaker(t2, tm, motion[0], _t(0.4))[
        "AverageAcceleration"],
        jwm.apply_wavemaker(j2, jm, motion[1], jnp.asarray(0.4))[
            "AverageAcceleration"])
    to = twm.damping_zone(t, tm, -0.5, 1.5, _t(2e-3))
    jo = jwm.damping_zone(j, jm, -0.5, 1.5, jnp.asarray(2e-3))
    close(to["Velocity"], jo["Velocity"])


def test_piston_stroke_dispersion():
    """tests/test_owsc.py:45: the OWSC target's om = pi, its k solves the
    dispersion relation, the stroke lies in (0.2, 0.25)."""
    piston = twm.make_piston(5.0, 10.0, 0.691, 9.81, model_scale=25.0)
    assert abs(piston.omega - np.pi) < 1e-12
    k = twm.dispersion_wavenumber(piston.omega, 0.691, 9.81)
    assert abs(9.81 * k * np.tanh(k * 0.691) - np.pi ** 2) < 1e-8
    assert 0.2 < piston.stroke < 0.25


def test_focused_packet_dispersion_and_strokes():
    """tests/test_nonlinear_wave_fsi.py:23: 32 components on the
    dispersion relation, strokes positive and falling with f, the piston
    velocity's crescendo before tf."""
    from sphinxsys_tpu_torch.cases import nonlinear_wave_fsi_2d as nw

    pk = twm.make_focused_packet(dtype=T64, **nw.PACKET)
    om, k, S = pk.om.numpy(), pk.k.numpy(), pk.S.numpy()
    assert om.shape == (32,)
    assert np.abs(om ** 2 - 9.81 * k * np.tanh(k * 0.8)).max() < 1e-8
    assert (S > 0).all() and (np.diff(S) < 0).all() and S.max() < 0.1
    t = np.linspace(0, 40, 4001)
    v = np.asarray([float(pk.velocity(torch.tensor(ti, dtype=T64)))
                    for ti in t])
    t_peak = t[np.abs(v).argmax()]
    assert abs(v).max() > 3.0 * np.abs(v[t < 5.0]).max()
    assert 12.0 < t_peak < 22.0, t_peak
