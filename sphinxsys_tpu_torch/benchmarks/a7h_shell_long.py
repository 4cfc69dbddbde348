"""The shell family's cases to their JAX tests' end times, each held to
that test's gates:

    python -m sphinxsys_tpu_torch.benchmarks.a7h_shell_long
        [--cases cantilever,plate,roof,half_sphere,coupling,gate,pipe,rings]
        [--device cuda] [--dtype case] [--out a7h_shell_long.json]

  * cantilever: shell_cantilever_2d at its default width, the tip every
    0.02 to t = 0.64 (tests/test_shell.py:46-68): the period within 0.015
    of the solid beam's 0.280, the largest |tip| within 0.012 of its
    0.114; the samples to t = 0.4 held by DTWRegressionTest to
    tests/golden/shell_cantilever_2d (tests/test_golden_regression.py:
    140-151);
  * plate: shell_plate_3d, the tip row's mean every 0.002 to t = 0.03,
    held to tests/golden/shell_plate_3d (:154-165);
  * roof: roof_3d in float64, the observer every 0.02 to t = 2
    (tests/test_roof.py): the sag within 10% of 0.0881 at t = 0.2 and of
    0.2626 at t = 0.5, the diaphragms' velocity along the axis only, the
    sag at t = 2 within the reference's 10% of 0.3024; the curve's DTW
    distance to the JAX package's committed float64 run
    (tests/golden/refdb/roof_3d) printed;
  * half_sphere: shell_stability_half_sphere_3d (its CVT on the card)
    every 0.02 to t = 0.5 (tests/test_shell_half_sphere.py:37-52, run on
    to the reference's end time, whose gates are its stability: cpp:
    262-286): finite and dt above max_dt / 1e3 at every sample, the
    largest displacement in (0.1, 0.2 R) at t = 0.1 (the JAX test's
    time) and at t = 0.5, the JAX package's own float64 CPU figures
    printed beside (tests/golden_torch/shell_goldens/
    jax_f64_half_sphere.json, written by `PYTHONPATH=.:tests python
    tests/test_torch_shell_cases.py half_sphere`);
  * coupling: solid_shell_coupling_3d to t = 2 (tests/test_solid_shell.py:
    74-94): finite, the centre's deflection in (-1, -0.1), the clamped
    rows unmoved (< 1e-12), the cube's base above -1, u_max < 3;
  * gate: hydrostatic_fsi_2d at dx = 0.025 to t = 0.16
    (tests/test_shell_fluid.py:117-140): no overflow, finite, the
    mid-span deflection downward and within 15% of the analytic
    p L^4 / (384 E I), no fluid below -2 dx;
  * pipe: poiseuille_flow_shell_3d to t = 2
    (benchmarks/run_pipe_shell_validation.py): the axial velocity at the
    radial probes within 10% of U_max of the parabola, no overflow;
  * rings: three_ring_impact_2d (its large ring relaxed on the card) to
    t = 0.05 (tests/test_surface_contact.py:133-147): no overflow, every
    ring finite, the small ring's centre moved more than 1 along both of
    its initial velocity's axes.

Beside each DTW distance, the JAX package's own float32 CPU distance to
the same database (tests/golden_torch/shell_goldens/jax_f32_dtw.json,
written by `PYTHONPATH=.:tests python tests/test_torch_shell_cases.py dtw`).

--dtype "case" (the default: each case's own) or float32 / float64.
Each run reports its step counts, its wall time and each gate's value
beside its bound, and writes them with the samples to --out as JSON.
Exits 1 if a run raised, overflowed or failed a gate (the other runs go
on).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from sphinxsys_tpu_torch.benchmarks.a7bc_long import (GOLDEN, _curve,
                                                      _finite, _gate,
                                                      _record, run_all)
from sphinxsys_tpu_torch.benchmarks.a7e_damping_long import GOLDEN as \
    GOLDEN_TORCH

JAX_DTW = os.path.join(GOLDEN_TORCH, "shell_goldens", "jax_f32_dtw.json")
JAX_HALF_SPHERE = os.path.join(GOLDEN_TORCH, "shell_goldens",
                               "jax_f64_half_sphere.json")


def _kw(dtype, **kw):
    return dict(kw, dtype=dtype) if dtype is not None else kw


def _jax_dtw(name):
    with open(JAX_DTW) as f:
        return json.load(f)[name]["dtw"]


def _golden_dtw(name, db, body, quantity, samples):
    """(passed, the distances, the report) of the port's DTWRegressionTest
    on tests/golden/<db>; JAX's own float32 distance printed beside."""
    from sphinxsys_tpu_torch.io.regression import DTWRegressionTest

    test = DTWRegressionTest(os.path.join(GOLDEN, db), body, quantity)
    ok, report = test.test(np.asarray(samples))
    dist = [float(d[0]) for d in test.distances(np.asarray(samples))]
    print(f"  {name} DTW to the golden: this run {dist}, JAX's float32 CPU "
          f"run {_jax_dtw(name)} (limit 1.01 x {float(test.threshold[0]):.4g})",
          flush=True)
    return ok, dist, report


def _period(times, d):
    t, d = np.asarray(times), np.asarray(d)
    crossings = t[np.where(np.diff(np.sign(d)))[0]]
    return 2 * float(np.mean(np.diff(crossings))) if len(crossings) > 1 \
        else float("nan")


def cantilever(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import shell_cantilever_2d as sc

    case, s = sc.build_case(**_kw(dtype, device=device))
    times = [i * 0.02 for i in range(1, 33)]
    s, tips, wall = _curve(sc.make_run_chunk(case), s, times,
                           lambda s: sc.tip_displacement(case, s), progress=8)
    t_real = times[:len(tips)]
    period = _period(t_real, tips)
    amp = float(np.abs(tips).max())
    ok, dist, report = _golden_dtw("shell_cantilever_2d", "shell_cantilever_2d",
                                   "Shell", "TipDisplacementY",
                                   [0.0] + tips[:20])
    return _record("shell_cantilever_2d", s, wall, n=case.n_shell,
                   dtw=dist, jax_f32_dtw=_jax_dtw("shell_cantilever_2d"),
                   dtw_report=report, gates=dict(
                       period=_gate(period, abs(period - 0.280) < 0.015,
                                    "0.280 +- 0.015"),
                       amplitude=_gate(amp, abs(amp - 0.114) < 0.012,
                                       "0.114 +- 0.012"),
                       dtw=_gate(dist, ok, "DTWRegressionTest")),
                   samples=tips)


def plate(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import shell_plate_3d as sp

    case, s = sp.build_case(**_kw(dtype, device=device))
    s, tips, wall = _curve(sp.make_run_chunk(case), s,
                           [i * 0.002 for i in range(1, 16)],
                           lambda s: sp.tip_displacement(case, s))
    tips = [0.0] + tips
    ok, dist, report = _golden_dtw("shell_plate_3d", "shell_plate_3d",
                                   "Plate", "CenterDeflection", tips)
    return _record("shell_plate_3d", s, wall, n=case.n_shell, dtw=dist,
                   jax_f32_dtw=_jax_dtw("shell_plate_3d"),
                   dtw_report=report,
                   gates=dict(dtw=_gate(dist, ok and len(tips) == 16,
                                        "DTWRegressionTest")),
                   samples=tips)


def roof(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import roof_3d as rf
    from sphinxsys_tpu_torch.io.regression import (dtw_distance,
                                                   read_result_xml)

    case, s = rf.build_case(**_kw(dtype, device=device))
    s0 = s.shell["Position"].clone()
    obs0 = rf.observer_position(case, s)
    times = [i * rf.END_TIME / 100.0 for i in range(1, 101)]
    s, curve, wall = _curve(rf.make_run_chunk(case), s, times,
                            lambda s: rf.observer_position(case, s),
                            progress=20)
    curve = np.asarray([obs0] + curve)
    sag = {t: float(obs0[2] - curve[i + 1][2]) for i, t in enumerate(times)
           if i + 1 < len(curve)}
    stored = read_result_xml(os.path.join(
        GOLDEN, "refdb", "roof_3d",
        "CylinderObserver_Position_Run_0_result.xml"))[0]
    dist = dtw_distance(stored, curve)
    jax_dist = _jax_dtw("roof_3d")
    print(f"  roof DTW to the JAX package's committed float64 curve: this "
          f"run {dist:.4g}, JAX's float32 CPU run {jax_dist}", flush=True)
    vel = s.shell["Velocity"][case.boundary_mask]
    off_axis = float(vel[:, [0, 2]].abs().max())
    d_end = sag.get(times[-1], float("nan"))
    s02, s05 = sag.get(times[9], float("nan")), sag.get(times[24],
                                                        float("nan"))
    moved = float((s.shell["Position"] - s0).abs().max())
    return _record("roof_3d", s, wall, n=case.n_shell, dtw=dist,
                   jax_f32_dtw=jax_dist, gates=dict(
                       sag_02=_gate(s02, abs(s02 - 0.0881) / 0.0881 < 0.10,
                                    "0.0881 +- 10%"),
                       sag_05=_gate(s05, abs(s05 - 0.2626) / 0.2626 < 0.10,
                                    "0.2626 +- 10%"),
                       sag_2=_gate(d_end, abs(d_end - rf.DISPL_MAX_REF)
                                   / rf.DISPL_MAX_REF < 0.10,
                                   "0.3024 +- 10%"),
                       diaphragms=_gate(off_axis, off_axis < 1e-10,
                                        "< 1e-10"),
                       finite=_gate(moved, np.isfinite(moved), "finite")),
                   samples=curve.tolist())


def half_sphere(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import shell_stability_half_sphere_3d as hs

    with open(JAX_HALF_SPHERE) as f:
        jax_md = json.load(f)["max_displacement"]
    case, s = hs.build_case(**_kw(dtype, device=device))
    run = hs.make_run_chunk(case)
    dts, mds, wall = [], [], 0.0
    ok_dt, finite = True, True
    for i in range(1, 26):
        s, out, w = _curve(run, s, [i * 0.02], lambda s: (
            float(s.dt), float(s.max_dt), hs.max_displacement(s)))
        wall += w
        dt, max_dt, md = out[0]
        dts.append(dt)
        mds.append(md)
        ok_dt &= dt > max_dt / 1e3
        finite &= _finite(s.shell["Position"])
        if i % 5 == 0:
            print(f"  t={float(s.time):.3f} max displacement {md:.4f} "
                  f"(JAX's float64 CPU run {jax_md[i - 1]:.4f}) dt {dt:.3e} "
                  f"wall={wall:.1f} s", flush=True)
    bound = f"(0.1, {0.2 * hs.RADIUS:g})"
    return _record("shell_stability_half_sphere_3d", s, wall, n=case.n_shell,
                   gates=dict(
                       finite=_gate(finite, finite, "finite"),
                       dt=_gate(min(dts), ok_dt, "> max_dt / 1e3"),
                       md_01=_gate(mds[4], 0.1 < mds[4] < 0.2 * hs.RADIUS,
                                   bound),
                       md_05=_gate(mds[-1], 0.1 < mds[-1] < 0.2 * hs.RADIUS,
                                   bound)),
                   jax_f64_md=jax_md, samples=mds)


def coupling(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import solid_shell_coupling_3d as ssc

    case, s = ssc.build_case(**_kw(dtype, device=device))
    s, defl, wall = _curve(ssc.make_run_chunk(case), s,
                           [0.25 * i for i in range(1, 9)],
                           lambda s: ssc.center_deflection(case, s),
                           progress=4)
    d = defl[-1]
    fixed = float((s.shell["Position"] - s.shell["InitialPosition"])
                  [case.shell_fixed].abs().max())
    base = float(s.cube["Position"][:, 1].min())
    u = ssc.u_max(s)
    finite = _finite(s.cube["Velocity"], s.shell["Position"])
    return _record("solid_shell_coupling_3d", s, wall, n_cube=case.n_cube,
                   n_shell=case.n_shell, gates=dict(
                       finite=_gate(finite, finite, "finite"),
                       deflection=_gate(d, -1.0 < d < -0.1, "(-1, -0.1)"),
                       clamp=_gate(fixed, fixed < 1e-12, "< 1e-12"),
                       base=_gate(base, base > -1.0, "> -1"),
                       u_max=_gate(u, u < 3.0, "< 3")), samples=defl)


def gate(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import hydrostatic_fsi_2d as hf

    case, fluid, g = hf.build_case(**_kw(dtype, dx=0.025, device=device))
    s, disp, wall = _curve(hf.make_run_chunk(case), hf.init_sim(case, fluid,
                                                                g),
                           [0.02 * i for i in range(1, 9)],
                           lambda s: hf.center_displacement(case, s),
                           progress=2)
    d = disp[-1]
    err = abs(abs(d) - hf.ANALYTIC_DISP) / hf.ANALYTIC_DISP
    y_min = float(s.fluid["Position"][:, 1].min())
    finite = _finite(s.fluid["Velocity"])
    return _record("hydrostatic_fsi_2d", s, wall, n_fluid=case.n_fluid,
                   n_gate=case.n_gate, n_s=s.n_s, gates=dict(
                       finite=_gate(finite, finite, "finite"),
                       downward=_gate(d, d < 0.0, "< 0"),
                       analytic=_gate(err, err < 0.15,
                                      f"|d| within 15% of "
                                      f"{hf.ANALYTIC_DISP:.4e}"),
                       no_leak=_gate(y_min, y_min > -2 * case.dx,
                                     f"> {-2 * case.dx:g}")),
                   samples=disp)


def pipe(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import poiseuille_flow_shell_3d as pf

    case, fluid = pf.build_case(**_kw(dtype, device=device))
    obs = pf.radial_observation_points()
    ana = pf.analytic_profile(obs)

    def profile_err(s):
        v = pf.observed_velocity(case, s, obs)[:, 1].double().cpu().numpy()
        return float(np.max(np.abs(v - ana)) / pf.U_MAX)

    s, errs, wall = _curve(pf.make_run_chunk(case), pf.init_sim(case, fluid),
                           [0.25 * i for i in range(1, 9)], profile_err,
                           progress=1)
    e = errs[-1]
    return _record("poiseuille_flow_shell_3d", s, wall, n=case.n_fluid,
                   n_shell=case.n_shell, n_alive=pf.n_alive(s), gates=dict(
                       profile=_gate(e, e < 0.10, "< 0.10 U_max"),
                       t_end=_gate(float(s.time), float(s.time) >= 2.0,
                                   ">= 2")), samples=errs)


def rings(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import three_ring_impact_2d as tr

    case, s = tr.build_case(**_kw(dtype, device=device))
    s, obs, wall = _curve(tr.make_run_chunk(case), s, [0.01 * i
                                                       for i in range(1, 6)],
                          lambda s: tr.observer_point(case, s).tolist())
    com = s.ring_s["Position"].mean(0).double().cpu().numpy()
    finite = _finite(*(r["Position"] for r in (s.ring_l, s.ring_m,
                                               s.ring_s)))
    return _record("three_ring_impact_2d", s, wall, n_l=case.n_l,
                   n_m=case.n_m, n_s=case.n_s, gates=dict(
                       finite=_gate(finite, finite, "finite"),
                       flight=_gate(com.tolist(),
                                    com[0] < tr.CENTER_S[0] - 1.0
                                    and com[1] > tr.CENTER_S[1] + 1.0,
                                    "moved > 1 along (-x, +y)")),
                   samples=obs)


RUNS = {"cantilever": cantilever, "plate": plate, "roof": roof,
        "half_sphere": half_sphere, "coupling": coupling, "gate": gate,
        "pipe": pipe, "rings": rings}


def main(argv=None) -> int:
    return run_all(RUNS, argv, "a7h_shell_long.json",
                   __doc__.splitlines()[0], default_dtype="case")


if __name__ == "__main__":
    raise SystemExit(main())
