"""The continuum-family cases to their JAX tests' end times, each held to
that test's gates that need no external reference database:

    python -m sphinxsys_tpu_torch.benchmarks.a7f_continuum_long
        [--cases column_arrest,column_runout,cohesive,repose,taylor_bar,
                 ul_beam,spinning_plate]
        [--device cuda] [--dtype float32] [--out a7f_continuum_long.json]

  * column_arrest: column_collapse_2d at dx = LH / 12 to t = 0.6
    (tests/test_continuum.py:57-72): no overflow, finite, the front past
    1.5 LL, max |v| < 0.5, the soil above -5 dx;
  * column_runout: column_collapse_2d at its default dx = LH / 50, the
    run-out front (max x) at t = 0, 0.04, ..., 0.6, held by the port's
    DTWRegressionTest to tests/golden/column_collapse_2d
    (tests/test_golden_regression.py:170-180);
  * cohesive: cohesive_soil_failure_2d at its default dx = LL / 50 to
    t = 2, the mechanical energy at 0.5, 1, 1.5, 2
    (tests/test_cohesive_soil.py:21-48): E0 within 1e-4 of 145040, the
    arrest E / E0 within 1% of 129900 / 145040, the last half-second's
    change < 0.002 E0, no rise above 1e-3 E0, the column standing above
    0.9 LH and its toe short of 0.99 DL;
  * repose: repose_angle_3d at dx = RADIUS / 5, the mechanical energy every
    0.1 to t = 0.7 (tests/test_repose_angle.py:14-57): E0 within 0.1 of
    4.00, every step of the curve below 1e-2, the settled energy within
    0.05 of 1.517 and its last step below 0.01; the pile's height in
    (0.03, 0.08), its flank slope in (8, 32) degrees, its centre within
    0.02 of DL / 2;
  * taylor_bar: taylor_bar_ul_3d at `build_case_ci` to t = 1.2e-5
    (tests/test_taylor_bar.py:69-95): KE0 within 15% of the analytic
    0.5 rho pi r^2 h v^2, KE / KE0 in (0.25, 0.60), the mushroom's radius
    past its start by dx / 2, z finite and above -2 dx, no overflow;
  * ul_beam: oscillating_beam_ul_2d at its default width, the kinetic
    energy every 0.01 to t = 1, its DTW distance to the JAX package's own
    CPU curve of the same dtype (tests/golden_torch/oscillating_beam_ul_2d
    /jax_curves.json) within DTW_FACTOR times the distance between JAX's
    float32 and float64 curves (printed beside it), KE0 within 1% of
    JAX's, and the first minimum of KE (the first 20 samples) within 2
    samples of JAX's;
  * spinning_plate: spinning_plate_2d at its default width, the kinetic
    energy every 0.01 to t = 0.5: KE0 equal to the lattice value
    228593.75 (to float32's rounding of the sum where float32), every
    sample within 2% of KE0 of JAX's curve of the same dtype
    (tests/golden_torch/spinning_plate_2d/jax_curves.json), the end below
    the start, and its DTW distance held as the beam's.

Left out, because they read the reference's own regression database,
which the repository does not hold: the UL beam's DTW gate 15 and the
plate's pointwise gate against that database
(tests/test_refdb_parity2.py:70-93, tests/test_spinning_plate.py), and
tests/test_refdb_parity.py's column-collapse energy.  The UL beam and the
plate are held instead to the JAX package's own curves, as above.

--dtype float32 (the default, the JAX cases' default) or float64.  Each
run reports its step counts, its wall time and each gate's value beside
its bound, and writes them with the samples to --out as JSON.  Exits 1 if
a run raised, overflowed or failed a gate (the other runs go on).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from sphinxsys_tpu_torch.benchmarks.a7bc_long import (GOLDEN, _curve,
                                                      _finite, _gate,
                                                      _record, run_all)
from sphinxsys_tpu_torch.benchmarks.a7e_damping_long import GOLDEN as \
    GOLDEN_TORCH
from sphinxsys_tpu_torch.benchmarks.a7e_damping_long import _dtw_gate

# the JAX package's cohesive-soil arrest (its test's reference DB band)
E0_COHESIVE = 145040.0
E_ARREST_COHESIVE = 129900.0
KE0_PLATE = 228593.75


def _np(t):
    return t.detach().double().cpu().numpy()


def column_arrest(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import column_collapse_2d as cc

    case, soil = cc.build_case(dx=cc.LH / 12, dtype=dtype, device=device)
    s, fronts, wall = _curve(cc.make_run_chunk(case), cc.init_sim(case, soil),
                             [0.2, 0.4, 0.6], lambda s: cc.runout_front(case, s))
    pos = _np(s.soil["Position"])[:case.n_soil]
    vmax = float(torch.linalg.vector_norm(
        s.soil["Velocity"][:case.n_soil], dim=-1).max())
    finite = bool(np.isfinite(pos).all())
    return _record("column_collapse_2d", s, wall, dx=case.dx,
                   n_soil=case.n_soil, gates=dict(
                       finite=_gate(finite, finite, "finite"),
                       spread=_gate(pos[:, 0].max(),
                                    pos[:, 0].max() > 1.5 * cc.LL,
                                    f"> {1.5 * cc.LL:g}"),
                       arrest=_gate(vmax, vmax < 0.5, "< 0.5"),
                       floor=_gate(pos[:, 1].min(),
                                   pos[:, 1].min() > -5 * case.dx,
                                   f"> {-5 * case.dx:g}")),
                   samples=fronts)


def column_runout(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import column_collapse_2d as cc
    from sphinxsys_tpu_torch.io.regression import DTWRegressionTest

    case, soil = cc.build_case(dtype=dtype, device=device)
    s = cc.init_sim(case, soil)
    f0 = cc.runout_front(case, s)
    s, fronts, wall = _curve(cc.make_run_chunk(case), s,
                             [i * 0.04 for i in range(1, 16)],
                             lambda s: cc.runout_front(case, s), progress=5)
    fronts = [f0] + fronts
    test = DTWRegressionTest(os.path.join(GOLDEN, "column_collapse_2d"),
                             "SoilBody", "RunoutFront")
    ok, report = test.test(np.asarray(fronts))
    return _record("column_collapse_2d", s, wall, dx=case.dx,
                   n_soil=case.n_soil, dtw_report=report,
                   gates=dict(dtw=_gate(ok, ok and len(fronts) == 16,
                                        "DTWRegressionTest")),
                   samples=fronts)


def cohesive(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import cohesive_soil_failure_2d as cs
    from sphinxsys_tpu_torch.physics import general as gd

    case, soil = cs.build_case(dtype=dtype, device=device)
    s = cs.init_sim(case, soil)
    e0 = float(gd.total_mechanical_energy(s.soil, case.gravity))
    s, es, wall = _curve(cs.make_run_chunk(case), s, [0.5, 1.0, 1.5, 2.0],
                         lambda s: float(gd.total_mechanical_energy(
                             s.soil, case.gravity)), progress=1)
    p = _np(s.soil["Position"])[:case.n_soil]
    arrest = es[-1] / E0_COHESIVE
    want = E_ARREST_COHESIVE / E0_COHESIVE
    rise = max(b - a for a, b in zip(es, es[1:]))
    return _record(
        "cohesive_soil_failure_2d", s, wall, dx=case.dx, n_soil=case.n_soil,
        e0=e0, gates=dict(
            e0=_gate(e0, abs(e0 - E0_COHESIVE) <= 1e-4 * E0_COHESIVE,
                     f"{E0_COHESIVE:g} +- 1e-4"),
            arrest=_gate(arrest, abs(arrest - want) <= 0.01 * want,
                         f"{want:.5f} +- 1%"),
            arrested=_gate(abs(es[-1] - es[-2]),
                           abs(es[-1] - es[-2]) < 0.002 * E0_COHESIVE,
                           f"< {0.002 * E0_COHESIVE:g}"),
            decreasing=_gate(rise, rise <= 1e-3 * E0_COHESIVE,
                             f"<= {1e-3 * E0_COHESIVE:g}"),
            standing=_gate(p[:, 1].max(), p[:, 1].max() > 0.9 * cs.LH,
                           f"> {0.9 * cs.LH:g}"),
            toe=_gate(p[:, 0].max(), p[:, 0].max() < 0.99 * cs.DL,
                      f"< {0.99 * cs.DL:g}")),
        samples=es)


def repose(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import repose_angle_3d as ra

    case, soil = ra.build_case(dx=ra.RADIUS / 5, dtype=dtype, device=device)
    s = ra.init_sim(case, soil)
    e0 = ra.mechanical_energy(case, s)
    s, es, wall = _curve(ra.make_run_chunk(case), s,
                         [i * 0.1 for i in range(1, 8)],
                         lambda s: ra.mechanical_energy(case, s), progress=1)
    e = np.asarray(es)
    pos = _np(s.soil["Position"])[:case.n_soil]
    r = np.hypot(pos[:, 0] - ra.DL / 2, pos[:, 2] - ra.DW / 2)
    h_max = float(pos[:, 1].max())
    slope = float(np.degrees(np.arctan2(h_max, np.quantile(r, 0.95))))
    drift = float(abs(pos[:, 0].mean() - ra.DL / 2))
    step = float(np.diff(e).max())
    return _record(
        "repose_angle_3d", s, wall, dx=case.dx, n_soil=case.n_soil, e0=e0,
        gates=dict(
            e0=_gate(e0, abs(e0 - 4.00) < 0.1, "4.00 +- 0.1"),
            monotone=_gate(step, step < 1e-2, "< 1e-2"),
            settled=_gate(e[-1], abs(e[-1] - 1.517) < 0.05, "1.517 +- 0.05"),
            plateau=_gate(abs(e[-1] - e[-2]), abs(e[-1] - e[-2]) < 0.01,
                          "< 0.01"),
            height=_gate(h_max, 0.03 < h_max < 0.08, "(0.03, 0.08)"),
            slope=_gate(slope, 8.0 < slope < 32.0, "(8, 32) degrees"),
            centred=_gate(drift, drift < 0.02, "< 0.02")),
        samples=es)


def taylor_bar(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import taylor_bar_ul_3d as tb

    case, col = tb.build_case_ci(dtype=dtype, device=device)
    s = tb.init_sim(case, col)
    ke0 = tb.kinetic_energy(s)
    ke_exact = 0.5 * tb.RHO0 * math.pi * tb.PL ** 2 * tb.PW * tb.VEL0 ** 2
    r0 = tb.mushroom_radius(case, s)
    s, kes, wall = _curve(tb.make_run_chunk(case), s,
                          [i * 1.0e-6 for i in range(1, 13)],
                          tb.kinetic_energy, progress=4)
    frac = kes[-1] / ke0
    r1 = tb.mushroom_radius(case, s)
    z = _np(s.column["Position"])[:, 2]
    finite = bool(np.isfinite(z).all())
    return _record(
        "taylor_bar_ul_3d", s, wall, dx=case.dx, n=case.n, ke0=ke0,
        gates=dict(
            ke0=_gate(ke0, abs(ke0 - ke_exact) / ke_exact < 0.15,
                      f"{ke_exact:.2f} +- 15%"),
            ke_fraction=_gate(frac, 0.25 < frac < 0.60, "(0.25, 0.60)"),
            mushroom=_gate(r1, r1 > r0 + 0.5 * case.dx,
                           f"> {r0 + 0.5 * case.dx:.6f}"),
            z=_gate(float(z.min()), finite and z.min() > -2 * case.dx,
                    f"finite, > {-2 * case.dx:.6f}")),
        samples=kes)


def _jax_curve(name, dtype):
    """JAX's own curve of the case in the run's dtype."""
    import json

    with open(os.path.join(GOLDEN_TORCH, name, "jax_curves.json")) as f:
        ref = json.load(f)
    return np.asarray(ref["f64" if dtype == torch.float64 else "f32"])


def ul_beam(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import oscillating_beam_ul_2d as ob

    case, beam = ob.build_case(dtype=dtype, device=device)
    s = ob.init_sim(case, beam)
    ke0 = ob.kinetic_energy(s)
    s, kes, wall = _curve(ob.make_run_chunk(case), s,
                          [i * 0.01 for i in range(1, 101)],
                          ob.kinetic_energy, progress=10)
    kes = [ke0] + kes
    dt = beam["Position"].dtype
    ref = _jax_curve("oscillating_beam_ul_2d", dt)
    dist, spread, gate = _dtw_gate("oscillating_beam_ul_2d", kes, dt)
    first_min = int(np.argmin(kes[:20]))
    ref_min = int(np.argmin(ref[:20]))
    finite = _finite(s.beam["Position"])
    return _record(
        "oscillating_beam_ul_2d", s, wall, n=case.n,
        dtw_to_jax=dist, jax_f32_f64_dtw=spread, gates=dict(
            finite=_gate(finite, finite, "finite"),
            ke0=_gate(ke0, abs(ke0 - ref[0]) <= 0.01 * ref[0],
                      f"{ref[0]:.6f} +- 1%"),
            first_minimum=_gate(first_min, abs(first_min - ref_min) <= 2,
                                f"{ref_min} +- 2 samples"),
            dtw_to_jax=gate), samples=kes)


def spinning_plate(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import spinning_plate_2d as sp

    case, plate = sp.build_case(dtype=dtype, device=device)
    s = sp.init_sim(case, plate)
    ke0 = sp.kinetic_energy(s)
    s, kes, wall = _curve(sp.make_run_chunk(case), s,
                          [i * 0.01 for i in range(1, 51)],
                          sp.kinetic_energy, progress=10)
    kes = [ke0] + kes
    dt = plate["Position"].dtype
    ref = _jax_curve("spinning_plate_2d", dt)
    dist, spread, gate = _dtw_gate("spinning_plate_2d", kes, dt)
    rel = float(np.abs(np.asarray(kes) - ref).max() / ref[0]) \
        if len(kes) == len(ref) else math.inf
    # the lattice value, to the rounding of a sum of 400 terms in the dtype
    eps = 400 * torch.finfo(dt).eps
    finite = _finite(s.plate["Position"])
    return _record(
        "spinning_plate_2d", s, wall, n=case.n,
        dtw_to_jax=dist, jax_f32_f64_dtw=spread, gates=dict(
            finite=_gate(finite, finite, "finite"),
            ke0=_gate(ke0, abs(ke0 - KE0_PLATE) <= eps * KE0_PLATE,
                      f"{KE0_PLATE} +- {eps:.1e}"),
            pointwise=_gate(rel, rel < 0.02, "< 2% of KE0, every sample"),
            decays=_gate(kes[-1], kes[-1] < kes[0], f"< {kes[0]:.2f}"),
            dtw_to_jax=gate), samples=kes)


RUNS = {"column_arrest": column_arrest, "column_runout": column_runout,
        "cohesive": cohesive, "repose": repose, "taylor_bar": taylor_bar,
        "ul_beam": ul_beam, "spinning_plate": spinning_plate}


def main(argv=None) -> int:
    return run_all(RUNS, argv, "a7f_continuum_long.json",
                   __doc__.splitlines()[0])


if __name__ == "__main__":
    raise SystemExit(main())
