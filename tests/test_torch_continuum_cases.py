"""Parity of the port's six continuum-family cases with the JAX package, on
the CPU in float64 (column_collapse_2d, cohesive_soil_failure_2d,
repose_angle_3d, oscillating_beam_ul_2d, spinning_plate_2d,
taylor_bar_ul_3d), at reduced widths: the column at LH / 12, the cohesive
column at LL / 20, the repose pile at RADIUS / 4, the UL beam at its
default width, the plate at dx = 0.1 and the Taylor bar at PL / 3 (half
`build_case_ci`'s width).

For each case: the builds held to each other (every field of the body and
the wall at 1e-12); a few advection steps from them with equal advection
and acoustic step counts; one more step from JAX's own state carried
across (`convert.sim_from_numpy`); the CLI entry with `--set device=cpu`.
The UL cases' JAX sims count no acoustic sub-steps: their case module's
`fd.acoustic_time_step` is wrapped, while JAX traces the run, in a
counter fed by `jax.debug.callback` (one call per sub-step).

The elastic UL cases (the beam, the plate) hold every field of the body
within 1e-9 of its max over the runs.  The plastic ones (the three soils,
the Taylor bar) cannot: the return mapping leaves particles on the yield
surface, where the next rate's branch (Drucker-Prager's f >= TINY, J2's
f > TINY, TINY = 1e-15 against stresses of 1e4-1e9) is decided by the
roundoff of either package, and a flipped branch moves the stress by a
per cent.  JAX does the same against itself: its own run from positions,
velocities or stresses scaled by 1 +- 1e-15 parts from it as far.  So their runs are held
within SPREAD_FACTOR times that distance of JAX's (and never looser than
1e-9 of the max), and their sub-steps in lockstep: each sub-step from
JAX's state carried across, every field within 1e-9 of its max on the
rows whose branch is not decided by roundoff (|f - TINY| above 1e-11 of
the stress scale, and, for the J2 bar's accelerations, not next to such
a row); the rows left out are counted.
"""

import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_corrected_cases import cli_runs, close, mods
from test_torch_damping_cases import hold_body

from sphinxsys_tpu_torch import convert

torch.set_num_threads(1)

POS_TOL = 1e-9

# case -> (build keywords of both packages, run end time, CLI sets, the
# sim's body, the CLI's body names)
CASES = {
    "column_collapse_2d": (dict(dx=0.1 / 12), 0.004,
                           ("dx=0.008333", "t_end=0.002"), "soil",
                           ("SoilBody", "Wall")),
    "cohesive_soil_failure_2d": (dict(dx=4.0 / 20), 0.03,
                                 ("dx=0.2", "t_end=0.02"), "soil",
                                 ("GranularBody", "WallBoundary")),
    "repose_angle_3d": (dict(dx=0.1 / 4), 0.006,
                        ("dx=0.025", "t_end=0.004"), "soil",
                        ("GranularBody", "Wall")),
    "oscillating_beam_ul_2d": (dict(), 5e-4, ("t_end=2e-4",), "beam",
                               ("BeamBody",)),
    "spinning_plate_2d": (dict(dx=0.1), 0.003, ("dx=0.1", "t_end=0.002"),
                          "plate", ("SquareBody",)),
    "taylor_bar_ul_3d": (dict(dx=0.00391 / 3), 4e-7,
                         ("dx=0.0013033", "t_end=2e-7"), "column",
                         ("Column", "Wall")),
}
UL = ("oscillating_beam_ul_2d", "spinning_plate_2d", "taylor_bar_ul_3d")
PLASTIC = ("column_collapse_2d", "cohesive_soil_failure_2d",
           "repose_angle_3d", "taylor_bar_ul_3d")
# a plastic run's distance to JAX's is held within this many times JAX's
# own distance to its run from positions scaled by 1 + PERTURB
SPREAD_FACTOR = 10.0
PERTURB = 1e-15
SUBSTEPS = []       # one entry a JAX acoustic sub-step of a UL case


def _count(dt):
    SUBSTEPS.append(1)


def counted_run_chunk(jm, jc):
    """JAX's run_chunk of a UL case, traced with its module's
    `fd.acoustic_time_step` wrapped in a host callback that counts the
    sub-steps; the module is restored after the trace."""
    fd = jm.fd

    def acoustic_time_step(*args, **kw):
        dt = fd.acoustic_time_step(*args, **kw)
        jax.debug.callback(_count, dt)
        return dt

    jrun = jm.make_run_chunk(jc)

    def run(s, t):
        jm.fd = types.SimpleNamespace(**{**vars(fd),
                                         "acoustic_time_step":
                                         acoustic_time_step})
        try:
            SUBSTEPS.clear()
            out = jax.block_until_ready(jrun(s, t))
        finally:
            jm.fd = fd
        return out, len(SUBSTEPS)

    return run


@functools.lru_cache(maxsize=None)
def runs(name):
    """Both packages' builds and their runs to the case's end time; JAX's
    run_chunk compiled once and kept for the next step.  Returns (jm, tm,
    jc, tc, jax body, port body, JAX's sim, its acoustic sub-steps, the
    port's sim, JAX's run)."""
    kw, t_end = CASES[name][:2]
    jm, tm = mods(name)
    jc, jb = jm.build_case(dtype=jnp.float64, **kw)
    tc, tb = tm.build_case(dtype=torch.float64, device="cpu", **kw)
    if name in UL:
        jrun = counted_run_chunk(jm, jc)
    else:
        plain = jm.make_run_chunk(jc)

        def jrun(s, t):
            s = plain(s, t)
            return s, int(s.n_ac)
    js, jn_ac = jrun(jm.init_sim(jc, jb), jnp.asarray(t_end, jnp.float64))
    ts = tm.make_run_chunk(tc)(tm.init_sim(tc, tb), t_end)
    return jm, tm, jc, tc, jb, tb, js, jn_ac, ts, jrun


def perturbed(name, js):
    """JAX's sim with its body's positions, its velocities, and its stress
    (the shear stress of the bar) each scaled by 1 + PERTURB and by
    1 - PERTURB: six sims."""
    body = CASES[name][3]
    stress = "ShearStress" if name == "taylor_bar_ul_3d" else "StressTensor3D"
    out = []
    for k in ("Position", "Velocity", stress):
        for sign in (1.0, -1.0):
            b = dict(getattr(js, body))
            b[k] = b[k] * (1.0 + sign * PERTURB)
            out.append(js._replace(**{body: b}))
    return out


def witnesses(name, jrun, js, target):
    """JAX's runs of a plastic case from its perturbed sims."""
    return [jrun(p, jnp.asarray(target, jnp.float64))[0]
            for p in perturbed(name, js)]


def hold_sims(name, js, jn_ac, ts, jps=()):
    """Equal counts; the time and the body strictly (elastic), or within
    SPREAD_FACTOR of JAX's own largest distance to its perturbed runs
    `jps` (plastic)."""
    count = "n_steps" if name in UL else "n_adv"
    assert getattr(ts, count) == int(getattr(js, count)) >= 1, count
    assert ts.n_ac == jn_ac >= getattr(ts, count)
    assert not bool(ts.overflow) and not bool(js.overflow)
    body = CASES[name][3]
    tb, jb = getattr(ts, body), getattr(js, body)
    if name not in PLASTIC:
        assert float(ts.time) == pytest.approx(float(js.time), rel=1e-12)
        hold_body(tb, jb, POS_TOL, body)
        return
    spread_t = max(abs(float(p.time) - float(js.time)) for p in jps)
    assert abs(float(ts.time) - float(js.time)) <= SPREAD_FACTOR * max(
        spread_t, 1e-12 * float(js.time)), spread_t
    for k, v in jb.items():
        if k == "NReal" or not jnp.issubdtype(v.dtype, jnp.floating):
            continue
        ref = np.asarray(v)
        scale = max(np.abs(ref).max(initial=0.0), 1e-300)
        spread = max(np.abs(np.asarray(getattr(p, body)[k]) - ref).max(
            initial=0.0) for p in jps)
        err = np.abs(tb[k].numpy() - ref).max(initial=0.0)
        assert err <= SPREAD_FACTOR * max(spread, POS_TOL * scale), \
            (k, err / scale, spread / scale)


@pytest.mark.parametrize("name", sorted(CASES))
def test_build_matches_jax(name):
    _, _, jc, tc, jb, tb, _, _, _, _ = runs(name)
    hold_body(tb, jb, 1e-12, "body")
    for k in ("n_soil", "n_wall", "n"):
        if hasattr(jc, k):
            assert getattr(tc, k) == getattr(jc, k), k
    if hasattr(jc, "wall"):
        hold_body(tc.wall, jc.wall, 1e-12, "wall")
    if hasattr(jc, "base_mask"):
        np.testing.assert_array_equal(tc.base_mask.numpy(),
                                      np.asarray(jc.base_mask))
    for k in ("alpha_phi", "k_c", "shear_modulus", "c0", "rho0"):
        if hasattr(jc.material, k):
            assert getattr(tc.material, k) == getattr(jc.material, k), k


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_matches_jax(name):
    jm, _, jc, _, jb, _, js, jn_ac, ts, jrun = runs(name)
    jps = witnesses(name, jrun, jm.init_sim(jc, jb), CASES[name][1]) \
        if name in PLASTIC else ()
    hold_sims(name, js, jn_ac, ts, jps)


@pytest.mark.parametrize("name", sorted(CASES))
def test_continues_jax_state(name):
    jm, tm, jc, tc, _, _, js, _, ts_own, jrun = runs(name)
    counts = ("n_adv", "n_ac", "n_steps")
    js = js._replace(**{k: jnp.zeros((), jnp.int32) for k in counts
                        if hasattr(js, k)})
    ts = convert.sim_from_numpy(type(ts_own),
                                jax.tree_util.tree_map(np.asarray, js))
    target = float(js.time) + 1e-12
    js1, jn_ac = jrun(js, jnp.asarray(target, jnp.float64))
    ts1 = tm.make_run_chunk(tc)(ts, target)
    assert (ts1.n_steps if name in UL else ts1.n_adv) == 1
    jps = witnesses(name, jrun, js, target) if name in PLASTIC else ()
    hold_sims(name, js1, jn_ac, ts1, jps)


def _roundoff_branch_rows(name, jc, body):
    """The rows whose plastic branch is decided by roundoff: |f - TINY| of
    the input stress within 1e-9 of the stress scale."""
    tiny = 1e-15
    if name == "taylor_bar_ul_3d":
        s = np.asarray(body["ShearStress"])
        k = np.asarray(body["HardeningFactor"])
        m = jc.material
        J2 = 0.5 * np.sum(s * s.transpose(0, 2, 1), axis=(1, 2))
        f = np.sqrt(2.0 * J2) - np.sqrt(2.0 / 3.0) * (
            m.hardening_modulus * k + m.yield_stress)
    else:
        s = np.asarray(body["StressTensor3D"])
        m = jc.material
        tr = np.trace(s, axis1=1, axis2=2)
        dev = s - tr[:, None, None] / 3.0 * np.eye(3)
        f = np.sqrt(0.5 * np.sum(dev * dev, axis=(1, 2)) + tiny) \
            + m.alpha_phi * tr - m.k_c
    return np.abs(f - tiny) <= 1e-11 * max(np.abs(s).max(), 1e-300)


def _jax_substep(name, jm, jc, nl, nl_w):
    """JAX's acoustic sub-step of the case, jitted: the Taylor bar's own
    `_acoustic_step`; the soils' loop body (column_collapse_2d.py and its
    twins) from JAX's functions, in its order."""
    from sphinxsys_tpu.physics import continuum as jcn
    from sphinxsys_tpu.physics import fluid as jfd

    if name == "taylor_bar_ul_3d":
        return jax.jit(lambda b, dt: jm._acoustic_step(jc, b, nl, nl_w, dt))
    k, dim, h, m = jc.kernel, jc.adaptation.dim, jc.adaptation.h, jc.material

    def sub(so, dt_adv):
        dt = jnp.minimum(jfd.acoustic_time_step(so, m, h, cfl=0.4), dt_adv)
        so = jcn.stress_diffusion(so, nl, k, dim, m, h)
        so = jcn.plastic_integration_1st_half(so, nl, k, dim, m, jc.riemann,
                                              dt, wall=jc.wall, nl_wall=nl_w)
        so = jcn.plastic_integration_2nd_half(so, nl, k, dim, m, jc.riemann,
                                              dt, wall=jc.wall, nl_wall=nl_w)
        return so, dt

    return jax.jit(sub)


def _lists(jm, jc, tm, tc, tbody):
    """The Taylor bar's (inner, wall) lists of the port, and as JAX's."""
    from sphinxsys_tpu.neighbors.neighbor_list import NeighborList

    nls = (tm.ob.inner_relation(tc, tbody), tm.wall_relation(tc, tbody))
    return nls, tuple(NeighborList(*(jnp.asarray(x.numpy()) for x in nl))
                      for nl in nls)


@pytest.mark.parametrize("name", PLASTIC)
def test_substeps_match_jax_in_lockstep(name):
    """Two sub-steps from the runs' end state, each from JAX's state
    carried across: dt at 1e-12, every field at 1e-9 of its max on the
    rows whose branch roundoff does not decide (the plastic fields; the
    bar's accelerations also off their neighbours; at least a quarter of
    the rows), all rows for the rest."""
    from sphinxsys_tpu_torch.cases import column_collapse_2d as tcc

    jm, tm, jc, tc, _, _, js, _, ts, _ = runs(name)
    jbody = getattr(js, CASES[name][3])
    tbody = convert.state_from_numpy({k: np.asarray(v)
                                      for k, v in jbody.items()})
    if name == "taylor_bar_ul_3d":
        (nl, nl_w), (jnl, jnl_w) = _lists(jm, jc, tm, tc, tbody)
        jsub = _jax_substep(name, jm, jc, jnl, jnl_w)
        dt = 0.5 * float(jm.fd.acoustic_time_step(
            jbody, jc.eos, jc.adaptation.h, cfl=0.4))
        plastic = ("ShearStress", "HardeningFactor", "ScalePenaltyForce",
                   "AccShear", "AccHourglass")
    else:
        jsub = _jax_substep(name, jm, jc, js.nl_inner, js.nl_wall)
        ts = convert.sim_from_numpy(type(ts), jax.tree_util.tree_map(
            np.asarray, js))
        plastic = ("StressTensor3D",)
    left_out = 0
    for _ in range(2):
        rows = _roundoff_branch_rows(name, jc, jbody)
        if name == "taylor_bar_ul_3d":
            near = np.isin(nl.idx.numpy(), np.nonzero(rows)[0]).any(1)
            rows = rows | near
            jout = jsub(jbody, jnp.asarray(dt, jnp.float64))
            tout = tm.acoustic_substep(tc, tbody, nl, nl_w,
                                       torch.tensor(dt, dtype=torch.float64))
        else:
            jout, jdt = jsub(jbody, jnp.asarray(1.0, jnp.float64))
            tout, tdt = tcc.acoustic_substep(
                tc, ts, tbody, torch.tensor(1.0, dtype=torch.float64))
            assert float(tdt) == pytest.approx(float(jdt), rel=1e-12)
        left_out += int(rows.sum())
        for k, v in jout.items():
            if k == "NReal" or not jnp.issubdtype(v.dtype, jnp.floating):
                continue
            keep = ~rows if k in plastic else np.ones(len(rows), bool)
            close(tout[k].numpy()[keep], np.asarray(v)[keep], POS_TOL,
                  (k, int(rows.sum())))
        jbody = jout
        tbody = convert.state_from_numpy({k: np.asarray(v)
                                          for k, v in jout.items()})
    print(f"{name}: {left_out} of {2 * len(rows)} rows left out")
    assert left_out < 0.75 * 2 * len(rows)


@pytest.mark.parametrize("name", sorted(CASES))
def test_cli_entry_runs_on_the_cpu(name, tmp_path, caplog):
    _, _, _, tc, _, tb, _, _, _, _ = runs(name)
    names = CASES[name][4]
    n_real = {names[0]: tb["NReal"]}
    if hasattr(tc, "wall"):
        n_real[names[1]] = tc.wall["NReal"]
    cli_runs(name, CASES[name][2], names, tmp_path, caplog, n_real)


def test_observers_match_jax():
    """The cases' reductions of JAX's states, carried across: the builds
    and the runs' end states (the plastic runs part from JAX's at
    roundoff, so their own end states are not compared here)."""
    def port_sim(name, js):
        _, _, _, _, _, _, _, _, ts, _ = runs(name)
        return convert.sim_from_numpy(type(ts), jax.tree_util.tree_map(
            np.asarray, js))

    jm, tm, jc, tc, jb, tb, js, _, _, _ = runs("repose_angle_3d")
    for j in (jm.init_sim(jc, jb), js):
        assert tm.mechanical_energy(tc, port_sim("repose_angle_3d", j)) \
            == pytest.approx(jm.mechanical_energy(jc, j), rel=1e-12)
    jm, tm, jc, tc, jb, tb, js, _, ts, _ = runs("oscillating_beam_ul_2d")
    jidx, jw = jm.tip_observer(jc, jb)
    tidx, tw = tm.tip_observer(tc, tb)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    close(tw, jw)
    close(tm.observe_tip(ts, tidx, tw), jm.observe_tip(js, jidx, jw),
          POS_TOL)
    for name in UL:
        jm, tm, jc, tc, _, _, js, _, _, _ = runs(name)
        assert tm.kinetic_energy(port_sim(name, js)) == pytest.approx(
            jm.kinetic_energy(js), rel=1e-12)
    jm, tm, jc, tc, _, _, js, _, _, _ = runs("taylor_bar_ul_3d")
    assert tm.mushroom_radius(tc, port_sim("taylor_bar_ul_3d", js)) == \
        pytest.approx(jm.mushroom_radius(jc, js), rel=1e-12)
    jm, tm, jc, tc, _, _, js, _, _, _ = runs("column_collapse_2d")
    assert tm.runout_front(tc, port_sim("column_collapse_2d", js)) == \
        float(np.asarray(js.soil["Position"])[:jc.n_soil, 0].max())


def test_plate_keeps_its_lattice_energy():
    """The plate's kinetic energy at the build is the lattice value of the
    reference's database at the default width, 228593.75."""
    from sphinxsys_tpu_torch.cases import spinning_plate_2d as sp

    case, plate = sp.build_case(dtype=torch.float64, device="cpu")
    assert sp.kinetic_energy(sp.init_sim(case, plate)) == pytest.approx(
        228593.75, rel=1e-12)


def test_cohesive_initial_energy_and_stress():
    """The cohesive column's potential energy at the build is
    rho0 LL LH g LH / 2 = 145040 J, and its geostatic stress JAX's."""
    from sphinxsys_tpu_torch.cases import cohesive_soil_failure_2d as cs
    from sphinxsys_tpu_torch.physics import general as gd

    _, tm, _, tc, _, tb, _, _, _, _ = runs("cohesive_soil_failure_2d")
    e0 = float(gd.total_mechanical_energy(tb, tc.gravity))
    assert e0 == pytest.approx(145040.0, rel=1e-4)
    s = tb["StressTensor3D"]
    y = tb["Position"][:, 1]
    close(s[:, 1, 1], -cs.RHO0_S * cs.GRAVITY_G * y)
    assert not bool((s[:, 0, 1]).any())


# ---------------------------------------------------------------------------
# the JAX package's own curves for the card's long runs
# ---------------------------------------------------------------------------

CURVES = {
    # case -> (the sample interval, the end time): the kinetic energy
    "oscillating_beam_ul_2d": (0.01, 1.0),
    "spinning_plate_2d": (0.01, 0.5),
}


def jax_curve(name, dtype):
    """The JAX case at its default width in `dtype` on the CPU: its kinetic
    energy every 0.01 to the end time.  Returns (times, values)."""
    jm = mods(name)[0]
    every, t_end = CURVES[name]
    case, body = jm.build_case(dtype=dtype)
    s = jm.init_sim(case, body)
    run = jm.make_run_chunk(case)
    times, vals = [0.0], [jm.kinetic_energy(s)]
    for i in range(1, int(round(t_end / every)) + 1):
        s = run(s, jnp.asarray(i * every, dtype))
        times.append(float(s.time))
        vals.append(jm.kinetic_energy(s))
    assert not bool(s.overflow)
    return times, vals


def write_jax_curves():
    import json
    import os
    import pathlib

    golden = pathlib.Path(__file__).resolve().parent / "golden_torch"
    for name in CURVES:
        out = {"case": name, "what": "kinetic energy",
               "written_by": "tests/test_torch_continuum_cases.py"}
        for tag, dtype in (("f32", jnp.float32), ("f64", jnp.float64)):
            out[f"{tag}_times"], out[tag] = jax_curve(name, dtype)
        d = golden / name
        os.makedirs(d, exist_ok=True)
        (d / "jax_curves.json").write_text(json.dumps(out, indent=1) + "\n")
        print(name, len(out["f32"]), len(out["f64"]), flush=True)


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    write_jax_curves()
