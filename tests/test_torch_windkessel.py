"""Parity of the port's physics/windkessel.py and the bidirectional buffer
(physics/boundary.py) with the JAX package on the CPU: the Heun update of
the RCR outlet against JAX's and against the constant-flow pressure
Q (Rp + Rd); the flow accumulation, the imposed pressure, the kernel
gradient sum and the pressure condition's velocity on the seeded scene of
tests/test_torch_viscosity.py (float64 within 1e-12 of max |JAX|,
float32 within 2e-5); the bidirectional buffer's exchange against JAX's on
random crossings, and its exact live count through both planes of a
conveyor run either way.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_viscosity import DTYPES, TOL, close, kernels, scene

from sphinxsys_tpu.core.materials import WeaklyCompressibleFluid as JEos
from sphinxsys_tpu.physics import boundary as jbd
from sphinxsys_tpu.physics import windkessel as jwk
from sphinxsys_tpu_torch.core.materials import WeaklyCompressibleFluid as TEos
from sphinxsys_tpu_torch.core.state import FAR_AWAY
from sphinxsys_tpu_torch.physics import boundary as tbd
from sphinxsys_tpu_torch.physics import windkessel as twk

torch.set_num_threads(1)


def run_ode(q_fn, Rp, C, Rd, dt, n_steps, p0=0.0):
    wk = twk.init_windkessel(p0, dtype=torch.float64)
    ps, ts = [], []
    for i in range(n_steps):
        t = i * dt
        wk = wk._replace(flow_acc=torch.tensor(q_fn(t) * dt,
                                               dtype=torch.float64))
        wk = twk.windkessel_update(wk, dt, Rp, C, Rd)
        ps.append(float(wk.p))
        ts.append(t + dt)
    return np.asarray(ts), np.asarray(ps)


def test_constant_flow_reaches_total_resistance_pressure():
    """p -> Q (Rp + Rd) with the time constant C Rd, from the Rp jump."""
    Rp, C, Rd, Q = 0.5, 2.0, 3.0, 1.5
    tau = C * Rd
    t, p = run_ode(lambda t: Q, Rp, C, Rd, dt=tau / 200, n_steps=200 * 8)
    p_inf = Q * (Rp + Rd)
    np.testing.assert_allclose(p[-1], p_inf, rtol=1e-3)
    i_tau = np.argmin(np.abs(t - tau))
    expect_tau = Q * Rp + (p_inf - Q * Rp) * (1 - math.exp(-1.0))
    np.testing.assert_allclose(p[i_tau], expect_tau, rtol=2e-2)


@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
def test_heun_update_matches_jax(dtype):
    """A random flow history through both packages' updates, the state
    carried on each side."""
    rng = np.random.default_rng(5)
    Rp, C, Rd = 1.52e6, 1.96e-7, 6.85e6
    jw = jwk.init_windkessel(10665.6, jnp.dtype(dtype))
    tw = twk.init_windkessel(10665.6, torch.float64 if dtype == np.float64
                             else torch.float32)
    assert tw.p.dtype == tw.q.dtype == tw.flow_acc.dtype
    assert tw.p.shape == () and float(tw.q) == 0.0
    dt = 0.02
    for q in rng.random(40) * 1e-7:
        jw = jw._replace(flow_acc=jnp.asarray(q * dt, jnp.dtype(dtype)))
        tw = tw._replace(flow_acc=torch.tensor(q * dt, dtype=tw.p.dtype))
        jw = jwk.windkessel_update(jw, jnp.asarray(dt, jnp.dtype(dtype)),
                                   Rp, C, Rd)
        tw = twk.windkessel_update(tw, torch.tensor(dt, dtype=tw.p.dtype),
                                   Rp, C, Rd)
        for k in ("p", "q", "flow_acc"):
            close(getattr(tw, k), getattr(jw, k), TOL[dtype], what=k)


@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
def test_pressure_condition_matches_jax(dtype):
    (jb, jw, nl, nlw, _), (tb, tw, tnl, tnlw, _) = scene(2, dtype)
    jkn, tkn = kernels()
    tol = TOL[dtype]
    jr = jbd.AlignedBoxRegion(lower=(0.0, 0.0), upper=(0.55, 1.2))
    tr = tbd.AlignedBoxRegion(lower=(0.0, 0.0), upper=(0.55, 1.2))
    jeos, teos = JEos(rho0=1.0, c0=10.0), TEos(rho0=1.0, c0=10.0)
    p_t = np.asarray(2.5, dtype)
    ref = jwk.impose_pressure_condition(jb, jr, jnp.asarray(p_t), jeos)
    got = twk.impose_pressure_condition(tb, tr, torch.as_tensor(p_t), teos)
    for k in ("Pressure", "Density"):
        close(got[k], ref[k], tol, what=k)
    inside = tr.contains(tb["Position"])
    assert 0 < int(inside.sum()) < inside.numel()

    jwk0 = jwk.init_windkessel(0.0, jnp.dtype(dtype))
    twk0 = twk.init_windkessel(0.0, got["Pressure"].dtype)
    dt = np.asarray(1e-3, dtype)
    ref_w = jwk.accumulate_flow(jwk0, jb, jr, 0, jnp.asarray(dt))
    got_w = twk.accumulate_flow(twk0, tb, tr, 0, torch.as_tensor(dt))
    close(got_w.flow_acc, ref_w.flow_acc, tol)

    ref_s = jax.jit(lambda b: jwk.kernel_gradient_sum(
        b, nl, jkn, 2, contacts=[(jw, nlw)]))(jb)
    got_s = twk.kernel_gradient_sum(tb, tnl, tkn, 2, contacts=[(tw, tnlw)])
    close(got_s, ref_s, tol)
    ref_v = jwk.pressure_condition_velocity(jb, jr, jnp.asarray(p_t),
                                            jnp.asarray(dt), ref_s)
    got_v = twk.pressure_condition_velocity(tb, tr, torch.as_tensor(p_t),
                                            torch.as_tensor(dt), got_s)
    close(got_v["Velocity"], ref_v["Velocity"], tol)
    assert float(got_v["Velocity"][inside][:, 1].abs().max()) == 0.0


def _conveyor_state(xp, dl=40.0, dh=4.0, dx=1.0, fill=1.6):
    xs = np.arange(dx / 2, dl, dx)
    ys = np.arange(dx / 2, dh, dx)
    pos = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    n0 = len(pos)
    cap = int(fill * n0)
    pos = np.concatenate([pos, np.full((cap - n0, 2), 1e9)])
    return {"Position": xp.asarray(pos), "Velocity": xp.asarray(
                np.zeros((cap, 2))),
            "Alive": xp.asarray(np.arange(cap) < n0),
            "_InjectionOverflow": xp.asarray(np.zeros((), bool))}, n0


def test_conveyor_keeps_the_live_count_exact():
    """Uniform transport right, then left, through both buffers: the live
    count never changes, and no overflow (JAX's
    test_conveyor_exact_count_conservation on the port)."""
    state, n0 = _conveyor_state(torch)
    dx, dl, dh = 1.0, 40.0, 4.0
    buf_l = tbd.AlignedBoxRegion(lower=(0.0, 0.0), upper=(5 * dx, dh))
    buf_r = tbd.AlignedBoxRegion(lower=(dl - 5 * dx, 0.0), upper=(dl, dh))
    for u in (0.37 * dx, -0.37 * dx):
        for _ in range(60):
            prev = state["Position"]
            pos = prev.clone()
            pos[:, 0] += torch.where(state["Alive"], u, 0.0)
            state = dict(state, Position=pos)
            state = tbd.bidirectional_buffer_exchange(state, buf_l, inward=+1,
                                                      prev_pos=prev)
            state = tbd.bidirectional_buffer_exchange(state, buf_r,
                                                      inward=-1,
                                                      prev_pos=prev)
            assert int(state["Alive"].sum()) == n0
        assert not bool(state["_InjectionOverflow"])
        alive = state["Alive"]
        x = state["Position"][alive, 0]
        assert float(x.min()) >= 0.0 and float(x.max()) <= dl


@pytest.mark.parametrize("fill", (1.6, 1.0), ids=("room", "overflow"))
@pytest.mark.parametrize("use_prev", (True, False), ids=("prev", "bare"))
def test_exchange_matches_jax(fill, use_prev):
    """Random displacements through both buffers, each step's result from
    JAX's previous state: every field, the live mask and the overflow flag
    equal JAX's; with no spare slot, clones are dropped and the flag set."""
    rng = np.random.default_rng(7)
    js, _ = _conveyor_state(jnp, fill=fill)
    js["Velocity"] = jnp.asarray(rng.normal(size=js["Velocity"].shape))
    js["Density"] = jnp.asarray(1.0 + 0.01 * rng.normal(
        size=js["Velocity"].shape[0]))
    dl, dh = 40.0, 4.0
    regions = [((0.0, 0.0), (5.0, dh), +1), ((dl - 5.0, 0.0), (dl, dh), -1)]
    flagged = cloned = deleted = 0
    for step in range(12):
        prev = js["Position"]
        u = rng.normal(size=prev.shape) * np.array([1.2, 0.3])
        moved = jnp.where(js["Alive"][:, None], prev + u, prev)
        js = dict(js, Position=moved)
        ts = {k: torch.as_tensor(np.array(v)) for k, v in js.items()}
        tprev = torch.as_tensor(np.array(prev))
        for lo, hi, inward in regions:
            jr = jbd.AlignedBoxRegion(lower=lo, upper=hi)
            tr = tbd.AlignedBoxRegion(lower=lo, upper=hi)
            n_before = int(ts["Alive"].sum())
            js = jbd.bidirectional_buffer_exchange(
                js, jr, inward=inward, prev_pos=prev if use_prev else None)
            ts = tbd.bidirectional_buffer_exchange(
                ts, tr, inward=inward,
                prev_pos=tprev if use_prev else None)
            for k, v in js.items():
                np.testing.assert_array_equal(ts[k].numpy(), np.asarray(v),
                                              err_msg=(step, k))
            n_after = int(ts["Alive"].sum())
            cloned += max(n_after - n_before, 0)
            deleted += max(n_before - n_after, 0)
        flagged += bool(ts["_InjectionOverflow"])
    if use_prev:
        assert cloned > 0 and deleted > 0
    # without prev_pos every live particle past the inner plane is a
    # crosser: the dead slots run out whatever the fill
    assert (flagged > 0) == (fill < 1.5 or not use_prev)
    dead = ~ts["Alive"]
    assert bool((ts["Position"][dead] >= 1e8).all())
    assert FAR_AWAY > 1e9
