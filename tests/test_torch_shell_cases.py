"""Parity of the port's eight shell-family cases with the JAX package, on
the CPU in float64 (shell_cantilever_2d, shell_plate_3d, roof_3d,
shell_stability_half_sphere_3d, solid_shell_coupling_3d,
hydrostatic_fsi_2d, poiseuille_flow_shell_3d, three_ring_impact_2d), at
their default or reduced widths.

For each case: the builds held to each other (every field of every body
at 1e-12); a few steps from them with equal step counts and every field
of every body within 1e-9 of its max; one more step from JAX's own state
carried across (`convert.sim_from_numpy`); the CLI entry with
`--set device=cpu`.  Carried across as ROADMAP C says: the half sphere's
CVT positions (the generator's parity is tests/test_torch_shell.py's),
the three rings' large ring (`relaxed=`; here JAX's lattice, its
relaxation's own jitter being each package's; the relaxed build runs on
the card), and the pipe's shell, which JAX builds in float32 whatever
the case's dtype.  A shell's stresses and
moments early in a run are roundoff of strains ~1e-12 (the roof and the
gate at E ~ 1e8-1e11; the half sphere's and the coupled plate's moments,
differences of the Gauss points' stresses; the rings' unrelaxed solid
lattice, whose rates are roundoff away from the contact): those bodies'
fields other than Position are held within ten times JAX's own spread
under a 1e-15 scaling of their deformation gradient, never tighter than
1e-9 and never looser than 1e-2; their positions at 1e-9 (ROADMAP C).
"""

import dataclasses
import functools
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_corrected_cases import cli_runs, close, mods

from sphinxsys_tpu_torch import convert

torch.set_num_threads(1)

TOL = 1e-12
POS_TOL = 1e-9
ROUNDOFF = 1e-12
SPREAD_SCALE = 1e-15
SPREAD_FACTOR = 10.0
SPREAD_CAP = 1e-2

# case -> (build keywords of both packages, run end time, CLI sets, the
# sim's bodies, the CLI's body names)
CASES = {
    "shell_cantilever_2d": (dict(), 5e-4, ("t_end=2e-4",), ("shell",),
                            ("Shell",)),
    "shell_plate_3d": (dict(), 5e-4, ("t_end=2e-4",), ("shell",),
                       ("Plate",)),
    "roof_3d": (dict(), 1e-4, ("t_end=2e-5",), ("shell",),
                ("CylinderBody",)),
    "shell_stability_half_sphere_3d": (
        dict(dp_ratio=8.0, cvt_iters=20), 1e-4,
        ("dp_ratio=8", "cvt_iters=5", "t_end=2e-5"), ("shell",), ("Shell",)),
    "solid_shell_coupling_3d": (dict(dx=0.2), 3e-3,
                                ("dx=0.2", "t_end=2e-5"), ("cube", "shell"),
                                ("Cube", "Shell")),
    "hydrostatic_fsi_2d": (dict(dx=0.1), 0.006, ("dx=0.1", "t_end=0.002"),
                           ("fluid", "gate"), ("WaterBody", "Gate", "Wall")),
    "poiseuille_flow_shell_3d": (dict(n_particles=8), 0.006,
                                 ("n_particles=8", "t_end=0.002"),
                                 ("fluid",), ("WaterBody", "Shell")),
    "three_ring_impact_2d": (dict(dp=1.0, relax=False), 4.5e-3,
                             ("dp=1.0", "relax=0", "t_end=1e-3"),
                             ("ring_l", "ring_m", "ring_s"),
                             ("RingL", "RingM", "RingS")),
}
# the bodies held to JAX's own spread (the module docstring)
SPREAD = {"roof_3d": "shell", "hydrostatic_fsi_2d": "gate",
          "shell_stability_half_sphere_3d": "shell",
          "solid_shell_coupling_3d": "shell",
          "three_ring_impact_2d": "ring_l"}
COUNTS = ("n_steps", "n_adv", "n_ac")


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_build(name, jc, jst, tm, kw):
    """The port's build, with JAX's positions carried across where the
    module docstring says."""
    f64 = dict(dtype=torch.float64, device="cpu")
    if name == "shell_stability_half_sphere_3d":
        sh = jst[0].shell
        particles = (np.asarray(sh["Position"]),
                     np.asarray(sh["NormalDirection"]),
                     float(sh["VolumetricMeasure"][0]))
        return tm.build_case(particles=particles, **f64, **kw)
    if name == "three_ring_impact_2d":
        return tm.build_case(relaxed=np.asarray(jst[0].ring_l["Position"]),
                             **f64, **kw)
    tc, *tst = tm.build_case(**f64, **kw)
    if name == "poiseuille_flow_shell_3d":
        shell = {k: v.double() if v.is_floating_point() else v
                 for k, v in convert.state_from_numpy(
                     to_numpy(jc.shell)).items() if torch.is_tensor(v)}
        shell["NReal"] = int(jc.shell["NReal"])
        tc = dataclasses.replace(
            tc, shell=shell,
            shell_k1=torch.as_tensor(np.array(jc.shell_k1, np.float64)),
            shell_k2=torch.as_tensor(np.array(jc.shell_k2, np.float64)))
    return (tc, *tst)


def start(mod, case, states):
    return mod.init_sim(case, *states) if hasattr(mod, "init_sim") \
        else states[0]


@functools.lru_cache(maxsize=None)
def runs(name):
    """Both builds and their runs to the case's end time; JAX's run_chunk
    compiled once and kept for the next step."""
    kw, t_end = CASES[name][:2]
    jm, tm = mods(name)
    jc, *jst = jm.build_case(dtype=jnp.float64, **kw)
    tc, *tst = port_build(name, jc, jst, tm, kw)
    jrun = jm.make_run_chunk(jc)
    js0 = start(jm, jc, jst)
    js = jrun(js0, jnp.asarray(t_end, jnp.float64))
    ts = tm.make_run_chunk(tc)(start(tm, tc, tst), t_end)
    return jm, tm, jc, tc, jst, tst, js0, js, ts, jrun


def bodies_of(states):
    out = []
    for s in states:
        if isinstance(s, dict):
            out.append(s)
        else:
            out.extend(v for v in (getattr(s, f) for f in dir(s)
                                   if not f.startswith("_"))
                       if isinstance(v, dict))
    return out


def hold_body(tb, jb, tol, what, spread=None):
    """Every field of a body; `spread` (field -> JAX's own spread, a share
    of the field's max) loosens a field other than Position to
    SPREAD_FACTOR times it, at most SPREAD_CAP."""
    assert set(jb) <= set(tb), set(jb) - set(tb)
    for k, v in jb.items():
        if k == "NReal":
            assert tb[k] == int(v), what
            continue
        v = np.asarray(v)
        if v.dtype.kind in "biu":
            np.testing.assert_array_equal(tb[k].numpy(), v, err_msg=str(k))
        elif np.abs(v.astype(np.float64)).max(initial=0.0) < ROUNDOFF:
            err = np.abs(tb[k].double().numpy() - v).max(initial=0.0)
            assert err < ROUNDOFF, (what, k, err)
        else:
            t = tol
            if spread is not None and k != "Position":
                t = min(SPREAD_CAP, max(tol, SPREAD_FACTOR * spread[k]))
            close(tb[k], v, t, what=(what, k))


@functools.lru_cache(maxsize=None)
def jax_spread(name):
    """JAX's own spread: its run from the start to the case's end time
    with the spread body's DeformationGradient scaled by 1 + 1e-15,
    against its unperturbed run, a share of each field's max."""
    _, _, _, _, _, _, js0, js, _, jrun = runs(name)
    body = SPREAD[name]
    b = dict(getattr(js0, body))
    b["DeformationGradient"] = b["DeformationGradient"] * (1.0 + SPREAD_SCALE)
    jp = jrun(js0._replace(**{body: b}),
              jnp.asarray(CASES[name][1], jnp.float64))
    ref, pert = getattr(js, body), getattr(jp, body)
    out = {}
    for k, v in ref.items():
        v = np.asarray(v, np.float64) if k != "NReal" else None
        if v is not None and v.dtype.kind == "f":
            out[k] = np.abs(np.asarray(pert[k]) - v).max(initial=0.0) \
                / max(np.abs(v).max(initial=0.0), 1e-300)
    return out


def hold_sims(name, js, ts, spread=None):
    for k in COUNTS:
        if hasattr(js, k):
            assert getattr(ts, k) == int(getattr(js, k)), k
    assert float(ts.time) == pytest.approx(float(js.time), rel=1e-12)
    if hasattr(js, "overflow"):
        assert not bool(ts.overflow) and not bool(js.overflow)
    for body in CASES[name][3]:
        hold_body(getattr(ts, body), getattr(js, body), POS_TOL, body,
                  spread if SPREAD.get(name) == body else None)
    if hasattr(js, "dt"):
        close(ts.dt, js.dt, POS_TOL, "dt")


@pytest.mark.parametrize("name", sorted(CASES))
def test_build_matches_jax(name):
    _, _, jc, tc, jst, tst, _, _, _, _ = runs(name)
    jb, tb = bodies_of(jst), bodies_of(tst)
    assert len(jb) == len(tb) > 0
    for i, (j, t) in enumerate(zip(jb, tb)):
        hold_body(t, j, TOL, i)
    for rp in ("rp", "rp_cube", "rp_shell", "gate_rp", "rp_l", "rp_m",
               "rp_s"):
        if hasattr(jc, rp):
            jr, tr = getattr(jc, rp), getattr(tc, rp)
            np.testing.assert_array_equal(tr.idx.numpy(), np.asarray(jr.idx))
            for k in ("W", "dW", "r", "e"):
                close(getattr(tr, k), getattr(jr, k), TOL, (rp, k))
    for mask in ("base_mask", "tip_mask", "boundary_mask", "edge_mask",
                 "shell_fixed", "shell_tied_part", "grav_mask", "clamp_mask",
                 "fixed_l"):
        if hasattr(jc, mask):
            np.testing.assert_array_equal(getattr(tc, mask).numpy(),
                                          np.asarray(getattr(jc, mask)))
    if hasattr(jc, "wall"):
        hold_body(tc.wall, jc.wall, TOL, "wall")
    for cp in ("cp_shell", "cp_cube"):
        if hasattr(jc, cp):
            for k in ("W", "vol_j", "total_weight"):
                close(getattr(getattr(tc, cp), k),
                      getattr(getattr(jc, cp), k), TOL, (cp, k))


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_matches_jax(name):
    _, _, _, _, _, _, _, js, ts, _ = runs(name)
    assert max(getattr(ts, k, 0) for k in COUNTS) >= 3
    spread = jax_spread(name) if name in SPREAD else None
    hold_sims(name, js, ts, spread)


@pytest.mark.parametrize("name", sorted(CASES))
def test_continues_jax_state(name):
    _, tm, _, tc, _, _, _, js, ts_own, jrun = runs(name)
    js = js._replace(**{k: jnp.zeros((), jnp.int32) for k in COUNTS
                        if hasattr(js, k)})
    ts = convert.sim_from_numpy(type(ts_own), to_numpy(js))
    target = float(js.time) + 1e-12
    js1 = jrun(js, jnp.asarray(target, jnp.float64))
    ts1 = tm.make_run_chunk(tc)(ts, target)
    assert max(getattr(ts1, k, 0) for k in ("n_steps", "n_adv")) == 1
    spread = jax_spread(name) if name in SPREAD else None
    hold_sims(name, js1, ts1, spread)


@pytest.mark.parametrize("name", sorted(CASES))
def test_cli_entry_runs_on_the_cpu(name, tmp_path, caplog):
    _, _, _, tc, _, tst, _, _, ts, _ = runs(name)
    names = CASES[name][4]
    bodies = CASES[name][3]
    n_real = {n: getattr(ts, b)["NReal"] for n, b in zip(names, bodies)}
    for n, attr in (("Wall", "wall"), ("Shell", "shell")):
        if n in names and n not in n_real:
            n_real[n] = getattr(tc, attr)["NReal"]
    cli_runs(name, CASES[name][2], names, tmp_path, caplog, n_real)


def test_observables_match_jax():
    """The cases' readers on the runs' end states."""
    for name, reader in (("shell_cantilever_2d", "tip_displacement"),
                         ("shell_plate_3d", "tip_displacement"),
                         ("solid_shell_coupling_3d", "center_deflection"),
                         ("hydrostatic_fsi_2d", "center_displacement")):
        jm, tm, jc, tc, _, _, _, js, ts, _ = runs(name)
        assert getattr(tm, reader)(tc, ts) == pytest.approx(
            getattr(jm, reader)(jc, js), rel=POS_TOL, abs=1e-300)
    jm, tm, jc, tc, _, _, _, js, ts, _ = runs("roof_3d")
    close(tm.observer_position(tc, ts), jm.observer_position(jc, js), POS_TOL)
    jm, tm, jc, tc, _, _, _, js, ts, _ = runs(
        "shell_stability_half_sphere_3d")
    assert tm.max_displacement(ts) == pytest.approx(jm.max_displacement(js),
                                                    rel=POS_TOL)
    jm, tm, jc, tc, _, _, _, js, ts, _ = runs("three_ring_impact_2d")
    close(tm.observer_point(tc, ts), jm.observer_point(jc, js), POS_TOL)
    jm, tm, jc, tc, _, _, _, js, ts, _ = runs("solid_shell_coupling_3d")
    assert tm.u_max(ts) == pytest.approx(jm.u_max(js), rel=POS_TOL)
    jm, tm, jc, tc, _, _, _, js, ts, _ = runs("poiseuille_flow_shell_3d")
    obs = tm.radial_observation_points()
    close(tm.observed_velocity(tc, ts, obs), jm.observed_velocity(jc, js, obs),
          POS_TOL)
    close(tm.analytic_profile(obs), jm.analytic_profile(obs), TOL)


def test_gate_subcycles_and_damps_against_the_walls():
    """The gate's sub-steps ran (more than one an acoustic step: the
    shell's dt is far below the fluid's) and the fluid's damping against
    the walls changed the velocity (damping_pairwise_wall's first
    caller)."""
    from sphinxsys_tpu_torch.physics import dissipation as dp

    _, tm, _, tc, _, _, _, _, ts, _ = runs("hydrostatic_fsi_2d")
    assert ts.n_s > ts.n_ac
    f = dict(ts.fluid, Velocity=torch.ones_like(ts.fluid["Velocity"]))
    g = dp.damping_pairwise_wall(f, "Velocity", tc.wall, ts.nl_fw, tc.kernel,
                                 2, tc.mu_f, 1e-4)
    near = ts.nl_fw.count > 0
    assert bool(near.any())
    assert bool((g["Velocity"][near] != 1.0).any())
    assert bool((g["Velocity"][~near] == 1.0).all())


# ---------------------------------------------------------------------------
# the committed curves
# ---------------------------------------------------------------------------

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
JAX_DTW = GOLDEN.parent / "golden_torch" / "shell_goldens" / "jax_f32_dtw.json"
# case -> (the sample times, the DTW database, its body, its quantity)
GOLDENS = {
    "shell_cantilever_2d": ([i * 0.02 for i in range(1, 21)],
                            "shell_cantilever_2d", "Shell",
                            "TipDisplacementY"),
    "shell_plate_3d": ([i * 0.002 for i in range(1, 16)], "shell_plate_3d",
                       "Plate", "CenterDeflection"),
    "roof_3d": ([i * 0.02 for i in range(1, 101)], "refdb/roof_3d",
                "CylinderObserver", "Position"),
}


def port_curve(name, dtype):
    """The port's curve of a committed database's quantity on the CPU: the
    tip samples from 0 (the goldens of tests/test_golden_regression.py),
    or the roof's observer position every 0.02 to t = 2."""
    import importlib

    tm = importlib.import_module(f"sphinxsys_tpu_torch.cases.{name}")
    times = GOLDENS[name][0]
    tc, s = tm.build_case(dtype=dtype, device="cpu")
    run = tm.make_run_chunk(tc)
    if name == "roof_3d":
        out = [tm.observer_position(tc, s)]
        read = lambda s: tm.observer_position(tc, s)       # noqa: E731
    else:
        out = [0.0]
        read = lambda s: tm.tip_displacement(tc, s)        # noqa: E731
    for t in times:
        s = run(s, t)
        out.append(read(s))
    return np.asarray(out)


def dtw_distances(name, curve):
    """(the database's DTWRegressionTest, the curve's DTW distance to each
    committed run); the roof's database (the JAX package's own float64
    run, no threshold file) gives (None, [its distance])."""
    from sphinxsys_tpu_torch.io.regression import (DTWRegressionTest,
                                                   dtw_distance,
                                                   read_result_xml)

    _, db, body, quantity = GOLDENS[name]
    if name == "roof_3d":
        stored = read_result_xml(str(GOLDEN / db / f"{body}_{quantity}"
                                     "_Run_0_result.xml"))[0]
        return None, [dtw_distance(stored, np.asarray(curve))]
    test = DTWRegressionTest(str(GOLDEN / db), body, quantity)
    return test, [float(d[0]) for d in test.distances(np.asarray(curve))]


def test_plate_golden_dtw():
    """The plate's tip curve in float32 (its default) held by the port's
    DTWRegressionTest to tests/golden/shell_plate_3d, as
    tests/test_golden_regression.py holds JAX's."""
    curve = port_curve("shell_plate_3d", torch.float32)
    test, _ = dtw_distances("shell_plate_3d", curve)
    ok, report = test.test(curve)
    assert ok, report


@pytest.mark.slow
def test_cantilever_golden_dtw():
    """The cantilever's tip curve in float32 to t = 0.4 (~8,000 steps, ~1
    min here) held to tests/golden/shell_cantilever_2d."""
    curve = port_curve("shell_cantilever_2d", torch.float32)
    test, _ = dtw_distances("shell_cantilever_2d", curve)
    ok, report = test.test(curve)
    assert ok, report


def write_jax_dtw():
    """The JAX package's own float32 CPU curves' DTW distances to the three
    committed databases (the roof's: its float64 run's curve), written to
    JAX_DTW for sphinxsys_tpu_torch/benchmarks/a7h_shell_long.py to print
    beside the card's."""
    import importlib
    import json
    import os

    out = {"written_by": "tests/test_torch_shell_cases.py"}
    for name, (times, _, _, _) in GOLDENS.items():
        jm = importlib.import_module(f"sphinxsys_tpu.cases.{name}")
        jc, s = jm.build_case(dtype=jnp.float32)
        run = jm.make_run_chunk(jc)
        if name == "roof_3d":
            curve = [jm.observer_position(jc, s)]
        else:
            curve = [0.0]
        for t in times:
            s = run(s, jnp.asarray(t, jnp.float32))
            curve.append(jm.observer_position(jc, s) if name == "roof_3d"
                         else float(jm.tip_displacement(jc, s)))
        _, dist = dtw_distances(name, np.asarray(curve, np.float64))
        out[name] = dict(dtw=dist, n_steps=int(s.n_steps))
        print(name, dist, flush=True)
    os.makedirs(JAX_DTW.parent, exist_ok=True)
    JAX_DTW.write_text(json.dumps(out, indent=1) + "\n")


JAX_HALF_SPHERE = JAX_DTW.parent / "jax_f64_half_sphere.json"


def write_jax_half_sphere():
    """The JAX package's shell_stability_half_sphere_3d at its defaults
    (float64, the CVT's 200 sweeps) on the CPU to the reference's end
    time t = 0.5: the largest displacement every 0.02, written to
    JAX_HALF_SPHERE for sphinxsys_tpu_torch/benchmarks/a7h_shell_long.py
    to print beside the card's (~2.5 min)."""
    import json

    from sphinxsys_tpu.cases import shell_stability_half_sphere_3d as hs

    case, s = hs.build_case()
    run = hs.make_run_chunk(case)
    times, md = [round(i * 0.02, 2) for i in range(1, 26)], []
    for t in times:
        s = run(s, jnp.asarray(t, jnp.float64))
        md.append(hs.max_displacement(s))
        print(t, md[-1], int(s.n_steps), flush=True)
    JAX_HALF_SPHERE.write_text(json.dumps(dict(
        written_by="tests/test_torch_shell_cases.py half_sphere",
        dtype="float64", n=int(case.n_shell), times=times,
        max_displacement=md, n_steps=int(s.n_steps), dt=float(s.dt)),
        indent=1) + "\n")


if __name__ == "__main__":
    # python tests/test_torch_shell_cases.py [dtw] [half_sphere]
    import sys

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    for what in sys.argv[1:] or ("dtw", "half_sphere"):
        {"dtw": write_jax_dtw, "half_sphere": write_jax_half_sphere}[what]()
