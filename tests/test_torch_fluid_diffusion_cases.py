"""Parity of the port's nine small-fluid and plain-diffusion cases with the
JAX package, on the CPU in float64: lid_driven_cavity_2d, throat_2d,
channel_windkessel_2d, pulsatile_poiseuille_2d, heat_transfer_2d,
diffusion_bcs_2d, windows_frame_diffusion_2d and depolarization_2d at
reduced widths (the cavity at dx = 0.05, the throat at 0.4, the
Windkessel channel at DH / 6, the pulsatile channel 8 across, the heat
channel at 0.04, the diffusion square at 0.05, the frame at 0.004, the
muscle block at 0.1), and vp_heat_flux_2d at dx = 0.05.

For each stepped case: the builds held to each other (every field at
1e-12); a run of a few advection steps with equal advection and acoustic
step counts (JAX's lid cavity, throat and pulsatile sims keep no sub-step
count: their module's `fd.acoustic_time_step` is wrapped in a counter
while JAX traces the run), every field within 1e-9 of its max (an
open-boundary fluid's on its live rows, the live mask equal); one more
step from JAX's own state carried across (`convert.sim_from_numpy`); the
CLI entry with `--set device=cpu`.  The pulsatile run crosses the inlet
buffer (clones made); the Windkessel channel is carried across from JAX's
state just before its first RCR update and stepped past it.

The Windkessel channel at this width is chaotic: JAX's own run from
positions scaled by 1 + 1e-15 parts from it by 1e-8 of the velocity
within 30 steps.  Its runs here are short (a few steps), where both
packages agree to roundoff.

vp_heat_flux_2d: the steady field of both configs, the loss and its
gradient through the solve at 1e-10 of JAX's (`jax.value_and_grad`), and
the optimisation's Adam steps against optax at 1e-12.

The lid cavity's kinetic energy to t = 3 at its default width against
the committed golden curve (tests/golden/lid_driven_cavity_2d) is marked
slow; the card holds it in sphinxsys_tpu_torch/benchmarks/
a7g_fluid_diffusion_long.py.
"""

import functools
import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_continuum_cases import counted_run_chunk
from test_torch_corrected_cases import cli_runs, close, mods

from sphinxsys_tpu_torch import convert

torch.set_num_threads(1)

TOL = 1e-12
POS_TOL = 1e-9
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# case -> (build keywords of both packages, run end time, CLI sets, the
# sim's body, the CLI's body names)
CASES = {
    "lid_driven_cavity_2d": (dict(dx=0.05), 0.05,
                             ("dx=0.05", "t_end=0.02"), "fluid",
                             ("FluidBody", "Wall")),
    "throat_2d": (dict(dx=0.4), 0.2, ("dx=0.4", "t_end=0.1"), "fluid",
                  ("FluidBody", "WallBoundary")),
    "channel_windkessel_2d": (dict(dx=0.00635 / 6), 0.0012,
                              ("dx=0.0010583", "t_end=0.0005"), "fluid",
                              ("WaterBody", "Wall")),
    "pulsatile_poiseuille_2d": (dict(n_across=8), 0.06,
                                ("n_across=8", "t_end=0.005"), "fluid",
                                ("WaterBody", "Wall")),
    "heat_transfer_2d": (dict(dx=0.04), 0.05, ("dx=0.04", "t_end=0.02"),
                         "fluid", ("ThermofluidBody", "ThermosolidBody")),
    "diffusion_bcs_2d": (dict(dx=0.05), 0.003, ("dx=0.05", "t_end=0.002"),
                         "body", ("DiffusionBody",)),
    "windows_frame_diffusion_2d": (dict(dx=0.004), 2e-4,
                                   ("dx=0.004", "t_end=1e-4"), "body",
                                   ("DiffusionBody",
                                    "InternalConvectionBoundary",
                                    "ExternalConvectionBoundary")),
    "depolarization_2d": (dict(dx=0.1), 0.05, ("dx=0.1", "t_end=0.02"),
                          "body", ("MuscleBlock",)),
}
# JAX's sims without a sub-step count
UNCOUNTED = ("lid_driven_cavity_2d", "throat_2d", "pulsatile_poiseuille_2d")
COUNTS = ("n_adv", "n_ac", "n_steps")


def _build(mod, **kw):
    built = mod.build_case(**kw)
    return built if isinstance(built, tuple) else (built,)


def _start(mod, case, states):
    return mod.init_sim(case, *states)


def _jax_runner(name, jm, jc):
    if name in UNCOUNTED:
        return counted_run_chunk(jm, jc)
    plain = jm.make_run_chunk(jc)

    def run(s, t):
        s = plain(s, t)
        return s, int(s.n_ac) if hasattr(s, "n_ac") else None

    return run


@functools.lru_cache(maxsize=None)
def runs(name):
    """Both packages' builds and their runs to the case's end time.
    Returns (jm, tm, jc, tc, JAX's built states, the port's, JAX's sim,
    its sub-steps, the port's sim, JAX's run)."""
    kw, t_end = CASES[name][:2]
    jm, tm = mods(name)
    jc, *jst = _build(jm, dtype=jnp.float64, **kw)
    tc, *tst = _build(tm, dtype=torch.float64, device="cpu", **kw)
    jrun = _jax_runner(name, jm, jc)
    js, jn_ac = jrun(_start(jm, jc, jst), jnp.asarray(t_end, jnp.float64))
    ts = tm.make_run_chunk(tc)(_start(tm, tc, tst), t_end)
    return jm, tm, jc, tc, jst, tst, js, jn_ac, ts, jrun


def hold_body(tb, jb, tol, what):
    """Every field of JAX's body within tol of its max; an open-boundary
    fluid's per-particle fields on its live rows, the live mask equal."""
    assert set(jb) <= set(tb), set(jb) - set(tb)
    live = None
    if "Alive" in jb:
        live = np.asarray(jb["Alive"])
        np.testing.assert_array_equal(tb["Alive"].numpy(), live)
    for k, v in jb.items():
        if k == "NReal":
            assert tb[k] == int(v), what
            continue
        v = np.asarray(v)
        got = tb[k].detach().numpy()
        if live is not None and v.ndim >= 1 and v.shape[0] == live.shape[0]:
            v, got = v[live], got[live]
        if v.dtype == bool:
            np.testing.assert_array_equal(got, v, err_msg=str((what, k)))
        else:
            close(got, v, tol, what=(what, k))


def hold_sims(name, js, jn_ac, ts):
    for k in COUNTS:
        if hasattr(js, k):
            assert getattr(ts, k) == int(getattr(js, k)), k
    if jn_ac is not None:
        assert ts.n_ac == jn_ac
    assert float(ts.time) == pytest.approx(float(js.time), rel=1e-12)
    if hasattr(js, "overflow"):
        assert not bool(ts.overflow) and not bool(js.overflow)
    body = CASES[name][3]
    hold_body(getattr(ts, body), getattr(js, body), POS_TOL, body)
    if hasattr(js, "wkstate"):
        # the flow rate and the accumulated volume, each against its scale
        # (U_MAX DH, and that over the elapsed time): either may be ~0
        jm = mods(name)[0]
        scale = jm.U_MAX * jm.DH
        close(ts.wkstate.p, js.wkstate.p, POS_TOL, what="p")
        for k, s in (("q", scale), ("flow_acc", scale * float(js.time))):
            err = abs(float(getattr(ts.wkstate, k))
                      - float(getattr(js.wkstate, k)))
            assert err <= POS_TOL * s, (k, err)
        close(ts.next_update, js.next_update, TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_build_matches_jax(name):
    _, _, jc, tc, jst, tst, _, _, _, _ = runs(name)
    for jb, tb in zip(jst, tst):
        hold_body(tb, jb, TOL, "built")
    for k in ("n_fluid", "n", "dt"):
        if hasattr(jc, k):
            assert getattr(tc, k) == getattr(jc, k), k
    for side in ("wall", "body0", "wall_d", "wall_n", "air_in", "air_ex"):
        if hasattr(jc, side):
            hold_body(getattr(tc, side), getattr(jc, side), TOL, side)
    for k in ("obs_idx", "obs_w"):
        if hasattr(jc, k):
            close(getattr(tc, k), getattr(jc, k), TOL, what=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_matches_jax(name):
    _, _, _, _, _, _, js, jn_ac, ts, _ = runs(name)
    steps = getattr(ts, "n_adv", None) or ts.n_steps
    assert steps >= 2
    hold_sims(name, js, jn_ac, ts)


@pytest.mark.parametrize("name", sorted(CASES))
def test_continues_jax_state(name):
    jm, tm, jc, tc, _, _, js, _, ts_own, jrun = runs(name)
    js = js._replace(**{k: jnp.zeros((), jnp.int32) for k in COUNTS
                        if hasattr(js, k)})
    ts = convert.sim_from_numpy(type(ts_own),
                                jax.tree_util.tree_map(np.asarray, js))
    # just past the time, in its own dtype (the muscle block's is float32)
    target = float(np.nextafter(np.asarray(js.time), np.inf))
    js1, jn_ac = jrun(js, jnp.asarray(target, js.time.dtype))
    ts1 = tm.make_run_chunk(tc)(ts, target)
    assert (getattr(ts1, "n_adv", None) or ts1.n_steps) == 1
    hold_sims(name, js1, jn_ac, ts1)


@pytest.mark.parametrize("name", sorted(CASES))
def test_cli_entry_runs_on_the_cpu(name, tmp_path, caplog):
    _, _, _, tc, _, tst, _, _, _, _ = runs(name)
    names = CASES[name][4]
    bodies = list(tst) or [tc.body0]
    n_real = {names[0]: bodies[0]["NReal"]}
    if hasattr(tc, "wall"):
        n_real[names[1]] = tc.wall["NReal"]
    if hasattr(tc, "air_in"):
        n_real[names[1]] = tc.air_in["NReal"]
        n_real[names[2]] = tc.air_ex["NReal"]
    cli_runs(name, CASES[name][2], names, tmp_path, caplog, n_real)


def test_pulsatile_run_crosses_the_buffers():
    """The parity run clones into dead slots: the live count grew, as in
    JAX, and the exchange flagged no overflow."""
    _, tm, _, tc, _, tst, js, _, ts, _ = runs("pulsatile_poiseuille_2d")
    n0 = int(tst[0]["Alive"].sum())
    assert tm.n_alive(ts) > n0
    assert tm.n_alive(ts) == int(np.asarray(js.fluid["Alive"]).sum())
    assert not bool(ts.fluid["_InjectionOverflow"])


def test_windkessel_update_falls_on_jax_substep():
    """JAX's channel just before its first update (t = 0.02) carried
    across, both run past it: the same sub-steps, the update taken once
    on each (next update 0.04), the pressure, flow and fields alike."""
    name = "channel_windkessel_2d"
    jm, tm, jc, tc, jst, _, _, _, ts_own, jrun = runs(name)
    js, _ = jrun(jm.init_sim(jc, *jst), jnp.asarray(0.0196, jnp.float64))
    assert float(js.next_update) == pytest.approx(0.02)
    js = js._replace(n_adv=jnp.zeros((), jnp.int32),
                     n_ac=jnp.zeros((), jnp.int32))
    ts = convert.sim_from_numpy(type(ts_own),
                                jax.tree_util.tree_map(np.asarray, js))
    js1, jn_ac = jrun(js, jnp.asarray(0.0202, jnp.float64))
    ts1 = tm.make_run_chunk(tc)(ts, 0.0202)
    assert float(ts1.next_update) == pytest.approx(0.04)
    assert float(ts1.wkstate.q) != 0.0
    assert tm.outlet_pressure_mmhg(ts1) != pytest.approx(80.0, abs=1e-9)
    hold_sims(name, js1, jn_ac, ts1)


def test_windkessel_inflow_waveform_matches_jax():
    jm, tm = mods("channel_windkessel_2d")
    for t in np.linspace(0.0, 1.3, 27):
        for dt in (jnp.float64, jnp.float32):
            ref = jm.inflow_velocity(jnp.asarray(t, dt))
            got = tm.inflow_velocity(torch.tensor(
                t, dtype=torch.float64 if dt == jnp.float64
                else torch.float32))
            close(got, ref, TOL if dt == jnp.float64 else 1e-6)


def test_observers_match_jax():
    """The frozen observers of the diffusion cases and the heat channel's
    Shepard observer, on the parity runs' end states."""
    for name in ("diffusion_bcs_2d", "windows_frame_diffusion_2d"):
        jm, tm, jc, tc, _, _, js, _, ts, _ = runs(name)
        close(tm.observe_phi(tc, ts), jm.observe_phi(jc, js), POS_TOL, name)
    jm, tm, jc, tc, jst, tst, js, _, ts, _ = runs("depolarization_2d")
    jidx, jw = jm.voltage_observer(jc, jst[0])
    tidx, tw = tm.voltage_observer(tc, tst[0])
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    close(tw, jw, 1e-6)
    assert tm.observe_voltage(ts, tidx, tw) == pytest.approx(
        jm.observe_voltage(js, jidx, jw), rel=1e-6)
    jm, tm, jc, tc, _, _, js, _, ts, _ = runs("heat_transfer_2d")
    assert tm.observe_phi(tc, ts) == pytest.approx(jm.observe_phi(jc, js),
                                                   rel=1e-12)
    _, jp = jm.phi_profile(jc, js, n_bins=10)
    _, tp = tm.phi_profile(tc, ts, n_bins=10)
    close(tp, jp, TOL)


# ---------------------------------------------------------------------------
# vp_heat_flux_2d
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def vp_cases(config):
    jm, tm = mods("vp_heat_flux_2d")
    return jm, tm, jm.build_case(config, dx=0.05), \
        tm.build_case(config, dx=0.05, device="cpu")


def _k(n, seed=0):
    return 0.5 + np.random.default_rng(seed).random(n)


@pytest.mark.parametrize("config", ("heat_flux", "same_sink"))
def test_vp_build_and_steady_field_match_jax(config):
    jm, tm, jc, tc = vp_cases(config)
    for side in ("body", "wall"):
        hold_body(getattr(tc, side), getattr(jc, side), TOL, side)
    close(tc.heat_source, jc.heat_source, TOL)
    np.testing.assert_array_equal(tc.flux_region.numpy(),
                                  np.asarray(jc.flux_region))
    n = tc.body["NReal"]
    for k in (np.full(n, jm.DIFF_COEFF), _k(n)):
        close(tm.steady_temperature(tc, torch.as_tensor(k)),
              jm.steady_temperature(jc, jnp.asarray(k)), TOL, config)
    T = tm.steady_temperature(tc, torch.as_tensor(_k(n)))
    assert float(tm.boundary_averaged_temperature(tc, T)) == pytest.approx(
        float(jm.boundary_averaged_temperature(jc, jnp.asarray(T.numpy()))),
        rel=1e-14)


@pytest.mark.parametrize("config", ("heat_flux", "same_sink"))
def test_vp_loss_and_gradient_match_jax(config):
    """The loss of theta = log k and its gradient through the solve (and
    the projection), against jax.value_and_grad of JAX's loss."""
    jm, tm, jc, tc = vp_cases(config)
    n = tc.body["NReal"]
    theta = np.log(_k(n, 3))

    def jloss(th):
        T = jm.steady_temperature(jc, jm.project_conductivity(jnp.exp(th)))
        return jnp.mean(T) + 0.2 * jm.boundary_averaged_temperature(jc, T)

    jj, jg = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(theta))
    th = torch.as_tensor(theta).requires_grad_(True)
    tj = tm.loss(tc, th)
    (tg,) = torch.autograd.grad(tj, th)
    assert float(tj) == pytest.approx(float(jj), rel=1e-12)
    close(tg, jg, 1e-10)
    close(tm.project_conductivity(torch.as_tensor(np.exp(theta))),
          jm.project_conductivity(jnp.exp(jnp.asarray(theta))), TOL)
    assert float(tm.project_conductivity(torch.as_tensor(
        np.exp(theta))).mean()) == pytest.approx(1.0, abs=1e-12)


def test_vp_adam_matches_optax():
    """The written-out update against optax.adam on the same gradients,
    and the whole optimisation (the loss, Adam, the smoothing) against
    JAX's for a few steps from the same start."""
    import optax

    rng = np.random.default_rng(9)
    p = rng.normal(size=50)
    opt = optax.adam(0.1)
    state = opt.init(jnp.asarray(p))
    tp = torch.as_tensor(p)
    mu, nu = torch.zeros_like(tp), torch.zeros_like(tp)
    jm, tm, jc, tc = vp_cases("heat_flux")
    for step in range(1, 6):
        g = rng.normal(size=50) * 10.0 ** rng.integers(-3, 3)
        upd, state = opt.update(jnp.asarray(g), state)
        tu, mu, nu = tm.adam_update(torch.as_tensor(g), mu, nu, step, 0.1)
        close(tu, upd, TOL, what=step)
        close(mu, state[0].mu, TOL)
        close(nu, state[0].nu, TOL)
    for config in ("heat_flux", "same_sink"):
        jm, tm, jc, tc = vp_cases(config)
        k0 = _k(tc.body["NReal"], 4)
        jk, jT, jh = jm.optimize_conductivity(jc, n_steps=4,
                                              k_init=jnp.asarray(k0))
        tk, tT, th = tm.optimize_conductivity(tc, n_steps=4,
                                              k_init=torch.as_tensor(k0))
        close(th, jh, TOL, what=config)
        close(tk, jk, TOL, what=config)
        close(tT, jT, TOL, what=config)
        assert th[-1] < th[0]


def test_vp_cli_runs_on_the_cpu(tmp_path, caplog):
    from sphinxsys_tpu_torch import run as trun
    from test_torch_corrected_cases import vtp_points

    out = tmp_path / "vp"
    with caplog.at_level(logging.INFO):
        assert trun.main(["vp_heat_flux_2d", "--set", "dx=0.1", "--set",
                          "n_steps=2", "--set", "device=cpu",
                          "--output_dir", str(out)]) == 0
    assert sorted(os.listdir(out)) == ["DiffusionBody_opt.vtp"]
    assert vtp_points(out / "DiffusionBody_opt.vtp") == 100
    assert "optimized mean T" in caplog.text


# ---------------------------------------------------------------------------
# the lid cavity's golden curve (slow)
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_lid_cavity_ke_holds_the_golden_curve():
    """The default-width cavity in float32 to t = 3, its kinetic energy at
    every 0.25 held by DTW to tests/golden/lid_driven_cavity_2d, as
    tests/test_golden_regression.py holds JAX's."""
    from sphinxsys_tpu_torch.cases import lid_driven_cavity_2d as lc
    from sphinxsys_tpu_torch.io.regression import DTWRegressionTest

    case, fluid = lc.build_case(device="cpu")
    s = lc.init_sim(case, fluid)
    run = lc.make_run_chunk(case)
    kes = [lc.kinetic_energy(s)]
    for i in range(1, 13):
        s = run(s, i * 0.25)
        kes.append(lc.kinetic_energy(s))
    test = DTWRegressionTest(os.path.join(ROOT, "tests", "golden",
                                          "lid_driven_cavity_2d"),
                             "FluidBody", "TotalKineticEnergy")
    ok, report = test.test(np.asarray(kes))
    assert ok, report


# ---------------------------------------------------------------------------
# JAX's own float32 lid cavity, the curve the card's run is printed beside
# ---------------------------------------------------------------------------

JAX_LID = os.path.join(ROOT, "tests", "golden_torch", "lid_driven_cavity_2d",
                       "jax_f32_ke.json")


def write_jax_lid_curve():
    """JAX's lid cavity at its default width in float32 on the CPU, its
    kinetic energy every 0.25 to t = 3, and its DTW distance to the golden
    curve (the distance a7g_fluid_diffusion_long.py prints beside the
    card's).  Writes JAX_LID."""
    import json

    from sphinxsys_tpu.cases import lid_driven_cavity_2d as lc
    from sphinxsys_tpu.physics import general as gd
    from sphinxsys_tpu_torch.io.regression import DTWRegressionTest

    case, fluid = lc.build_case()
    s = lc.init_sim(case, fluid)
    run = lc.make_run_chunk(case)
    kes = [float(gd.total_kinetic_energy(s.fluid))]
    for i in range(1, 13):
        s = run(s, jnp.asarray(i * 0.25, s.time.dtype))
        kes.append(float(gd.total_kinetic_energy(s.fluid)))
    test = DTWRegressionTest(os.path.join(ROOT, "tests", "golden",
                                          "lid_driven_cavity_2d"),
                             "FluidBody", "TotalKineticEnergy")
    ok, report = test.test(np.asarray(kes))
    out = {"case": "lid_driven_cavity_2d", "what": "kinetic energy",
           "times": [0.25 * i for i in range(13)], "f32": kes,
           "dtw": [float(d[0]) for d in test.distances(np.asarray(kes))],
           "passes": bool(ok),
           "written_by": "tests/test_torch_fluid_diffusion_cases.py"}
    os.makedirs(os.path.dirname(JAX_LID), exist_ok=True)
    with open(JAX_LID, "w") as f:
        f.write(json.dumps(out, indent=1) + "\n")
    print(report)


if __name__ == "__main__":
    write_jax_lid_curve()
