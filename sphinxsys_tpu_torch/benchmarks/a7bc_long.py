"""The kernel-corrected fluid cases and the remaining solid cases to their
JAX tests' end times, each held to that test's gates that need no
external reference database:

    python -m sphinxsys_tpu_torch.benchmarks.a7bc_long
        [--cases standing_wave,standing_wave_refdb,poiseuille,
                 poiseuille_refdb,impact_patch,rotation_patch,
                 oscillating_beam,cauchy_beam,self_contact,
                 passive_cantilever,muscle_activation,anisotropic_beam]
        [--device cuda] [--dtype float32] [--out a7bc_long.json]

  * standing_wave: standing_wave_2d at dx = 0.05, the gauge every 0.05 to
    t = 1.5 (tests/test_standing_wave.py): no overflow, the period (the
    second minimum's time) within 6% of T1, the gauge's minimum in
    (0.85, 0.95) and its maximum in (1.02, 1.15);
  * standing_wave_refdb: at dx = 0.02 to t = 10, the gauge and the
    mechanical energy every 200 advection steps
    (benchmarks/run_refdb_parity.py's cadence), their DTW distances to the
    JAX package's curves in tests/golden/refdb/standing_wave_2d printed
    (no test of the JAX package gates them);
  * poiseuille: poiseuille_flow_2d at dx = 0.05 to t = 2 and 4
    (tests/test_poiseuille.py): the mean profile within 5% of the
    analytic transient's max at both, the centreline above 1.3, the
    kinetic energy within 1% of 3.6625;
  * poiseuille_refdb: to t = 100, the kinetic energy at 85 samples, its
    DTW distance to tests/golden/refdb/poiseuille_flow_2d (the JAX
    package's curve) within tests/test_refdb_parity.py's gate 15 (there
    against the reference DB; its plateau-ratio gate needs that DB and is
    left out);
  * impact_patch: impact_patch_2d at dx = LL / 25, the kinetic energy
    every 0.02 to t = 1 (tests/test_impact_patch.py): the initial 2/3
    within 1e-3, no step of the curve above 0.003, its max below
    2/3 x 1.001, the lateral jets past |x| = 1.5 and |y| < 0.5.  The
    plateau and DTW gates read the reference's own regression database,
    which is not in the repository, and are left out;
  * rotation_patch: rotation_patch_2d at dx = LL / 50 to t = 1.5
    (tests/test_rotation_patch.py): KE0 within 2% and KE within 6% of
    1/12, the largest radius above 0.75, L_z < 0;
  * oscillating_beam: oscillating_beam_2d at PH / 10, the tip every 0.05
    to t = 1, held by the port's DTWRegressionTest to
    tests/golden/oscillating_beam_2d (tests/test_golden_regression.py:
    39-53);
  * cauchy_beam: oscillating_beam_cauchy_2d against oscillating_beam_2d at
    dx = PH / 6, the tip every 0.035 to t = 0.42 (tests/test_solid.py:
    192-213): the trough within 5% and one sample of the PK2 beam's, the
    curves within 15% of its max;
  * self_contact: self_contact_2d at dx = PH / 10, the tip every 0.01 to
    t = 1, its DTW distance to tests/golden/refdb/self_contact_2d (the
    JAX package's curve) printed; no overflow, finite; the early-tip gate
    of tests/test_self_contact.py reads the reference DB and is left out;
  * passive_cantilever: passive_cantilever_3d at dx = 1/12, the corner
    every 0.05 to t = 1 (tests/test_passive_cantilever.py): the observer
    at the start within 0.005 of (5.9498, 0.9498, 0.9498), the first
    swing's peak y and z within 0.15 of 4.155 and 2.794, the corner at
    t = 1 within 0.12 of (6.028, 0.011, 0.310);
  * muscle_activation: muscle_activation_3d at dx = 1/12 to t = 0.6 and
    1.2 (tests/test_solid_cases_3d.py:54-82): the free face pushed out
    by > 0.005 each time, its y and z centred within 0.02, the holder
    still in x within 1e-6;
  * anisotropic_beam: anisotropic_beam_2d and oscillating_beam_2d at
    dy = PH / 10, the tip every 0.01 to t = 0.3
    (tests/test_anisotropic_beam.py): 280 particles, the swing's extremes
    within 4%, the first minimum within 0.02 and the curves within 15%
    of the isotropic max.

Each run reports its step counts, its wall time and each gate's value
beside its bound, and writes them with the samples to --out as JSON.
Exits 1 if a run raised, overflowed or failed a gate (the other runs go
on).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from sphinxsys_tpu_torch.device import resolve_device, resolve_dtype

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GOLDEN = os.path.join(ROOT, "tests", "golden")
REFDB = os.path.join(GOLDEN, "refdb")


def _gate(value, ok, bound) -> dict:
    return dict(value=value if isinstance(value, (list, bool)) else
                float(value), bound=bound, ok=bool(ok))


def _finite(*tensors) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def _record(case_name, s, wall, **kw) -> dict:
    n = (getattr(s, "n_adv", None) or getattr(s, "n_steps", None)
         or s.n_macro)
    counts = {k: getattr(s, k) for k in ("n_adv", "n_ac", "n_steps",
                                         "n_macro", "n_sub")
              if hasattr(s, k)}
    return dict(case=case_name, t_reached=float(s.time), **counts,
                overflow=bool(getattr(s, "overflow", False)), wall_s=wall,
                ms_per_step=wall / max(n, 1) * 1e3, **kw)


def _curve(run, s, times, measure, progress=None):
    """The sim run to each time, `measure(s)` after each: (sim, samples,
    wall s)."""
    out = []
    t0 = time.perf_counter()
    for i, t in enumerate(times):
        s = run(s, t)
        out.append(measure(s))
        if bool(getattr(s, "overflow", False)):
            break
        if progress and (i + 1) % progress == 0:
            print(f"  t={float(s.time):.4f} {out[-1]} "
                  f"wall={time.perf_counter() - t0:.1f} s", flush=True)
    return s, out, time.perf_counter() - t0


def standing_wave(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import standing_wave_2d as sw

    case, fluid = sw.build_case(dx=0.05, dtype=dtype, device=device)
    s = sw.init_sim(case, fluid)
    times = [i * 0.05 for i in range(1, 31)]
    s, hs, wall = _curve(sw.make_run_chunk(case), s, times,
                         lambda s: float(sw.free_surface_height(case,
                                                                s.fluid)))
    hs = np.asarray(hs)
    ts = np.asarray(times[:len(hs)])
    i_max = int(np.argmax(hs[: len(hs) // 2]))
    i_min2 = int(np.argmin(hs[i_max:])) + i_max
    period = float(ts[i_min2])
    finite = bool(np.isfinite(hs).all())
    return _record("standing_wave_2d", s, wall, dx=case.dx,
                   n_fluid=case.n_fluid, gates=dict(
                       finite=_gate(finite, finite, "finite"),
                       period=_gate(period, abs(period - sw.T1)
                                    < 0.06 * sw.T1,
                                    f"{sw.T1:.4f} +- 6%"),
                       gauge_min=_gate(hs.min(), 0.85 < hs.min() < 0.95,
                                       "(0.85, 0.95)"),
                       gauge_max=_gate(hs.max(), 1.02 < hs.max() < 1.15,
                                       "(1.02, 1.15)")),
                   samples=hs.tolist())


def standing_wave_refdb(device, dtype) -> dict:
    """run_refdb_parity.py's run: every 200 advection steps to t = 10."""
    from sphinxsys_tpu_torch.cases import standing_wave_2d as sw
    from sphinxsys_tpu_torch.io import regression as rg
    from sphinxsys_tpu_torch.physics import general as gd

    case, fluid = sw.build_case(dx=0.02, dtype=dtype, device=device)
    s = sw.init_sim(case, fluid)
    step = sw.make_advection_step(case)

    def measure(s):
        return (float(gd.total_mechanical_energy(s.fluid, case.gravity)),
                float(sw.free_surface_height(case, s.fluid)))

    rows = [measure(s)]
    t0 = time.perf_counter()
    while float(s.time) < 10.0 and not bool(s.overflow):
        for _ in range(200):
            s = step(s)
            if bool(s.time >= 10.0):
                break
        rows.append(measure(s))
        if len(rows) % 20 == 0:
            print(f"  n_adv={s.n_adv} t={float(s.time):.3f} {rows[-1]} "
                  f"wall={time.perf_counter() - t0:.1f} s", flush=True)
    wall = time.perf_counter() - t0
    rows = np.asarray(rows)
    dist = {}
    for k, (body, q) in enumerate((("WaterBody", "TotalMechanicalEnergy"),
                                   ("WaveProbe", "FreeSurfaceHeight"))):
        ref = rg.read_result_xml(os.path.join(
            REFDB, "standing_wave_2d", f"{body}_{q}_Run_0_result.xml"))[0]
        dist[q] = rg.dtw_distance(rows[:, k], ref)
    finite = bool(np.isfinite(rows).all())
    return _record("standing_wave_2d", s, wall, dx=case.dx,
                   n_fluid=case.n_fluid, dtw_to_jax_curves=dist,
                   gates=dict(finite=_gate(finite, finite, "finite")),
                   samples=rows.tolist())


def poiseuille(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import poiseuille_flow_2d as pf

    case, fluid = pf.build_case(dtype=dtype, device=device)
    s = pf.init_sim(case, fluid)
    run = pf.make_run_chunk(case)
    gates = {}
    t0 = time.perf_counter()
    for t in (2.0, 4.0):
        s = run(s, t)
        ys, prof = pf.mean_profile(case, s)
        exact = pf.analytic_profile(ys, float(s.time))
        err = float(np.abs(prof - exact).max() / exact.max())
        gates[f"profile_t{t:g}"] = _gate(err, err < 0.05, "< 0.05")
    wall = time.perf_counter() - t0
    ke = pf.kinetic_energy(s)
    gates["centreline"] = _gate(prof.max(), prof.max() > 1.3, "> 1.3")
    gates["kinetic_energy"] = _gate(ke, abs(ke - 3.6625) < 0.01 * 3.6625,
                                    "3.6625 +- 1%")
    return _record("poiseuille_flow_2d", s, wall, dx=case.dx,
                   n_fluid=case.n_fluid, gates=gates,
                   samples=prof.tolist())


def poiseuille_refdb(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import poiseuille_flow_2d as pf
    from sphinxsys_tpu_torch.io import regression as rg

    case, fluid = pf.build_case(dtype=dtype, device=device)
    s = pf.init_sim(case, fluid)
    ke0 = pf.kinetic_energy(s)
    s, series, wall = _curve(pf.make_run_chunk(case), s,
                             [i * 100.0 / 85 for i in range(1, 85)],
                             pf.kinetic_energy, progress=10)
    series = [ke0, *series]
    ref = rg.read_result_xml(os.path.join(
        REFDB, "poiseuille_flow_2d",
        "WaterBody_TotalKineticEnergy_Run_0_result.xml"))[0]
    dist = rg.dtw_distance(np.asarray(series), ref)
    return _record("poiseuille_flow_2d", s, wall, dx=case.dx,
                   n_fluid=case.n_fluid, plateau=float(np.mean(series[-10:])),
                   jax_plateau=float(np.mean(ref[-10:])),
                   gates=dict(dtw=_gate(dist, dist < 15.0, "< 15")),
                   samples=series)


def impact_patch(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import impact_patch_2d as ip

    case, fluid = ip.build_case(dtype=dtype, device=device)
    s = ip.init_sim(case, fluid)
    ke0 = ip.kinetic_energy(s)
    s, kes, wall = _curve(ip.make_run_chunk(case), s,
                          [i * 0.02 for i in range(1, 51)],
                          ip.kinetic_energy, progress=10)
    kes = np.asarray(kes)
    exact = 0.5 * ip.LL * ip.LH
    p = s.fluid["Position"][: s.fluid["NReal"]].double().cpu().numpy()
    rise = float(np.diff(kes).max())
    return _record("impact_patch_2d", s, wall, dx=case.dx,
                   n_fluid=case.n_fluid, final_ke=float(kes[-1]), gates=dict(
                       ke0=_gate(ke0, abs(ke0 - exact) < 1e-3 * exact,
                                 f"{exact:.4f} +- 0.1%"),
                       no_creation=_gate(kes.max(), kes.max()
                                         <= exact * 1.001,
                                         f"<= {exact * 1.001:.5f}"),
                       no_rise=_gate(rise, rise < 0.003, "< 0.003"),
                       jets_x=_gate([p[:, 0].min(), p[:, 0].max()],
                                    p[:, 0].max() > 1.5
                                    and p[:, 0].min() < -1.5,
                                    "beyond +-1.5"),
                       flat_y=_gate([p[:, 1].min(), p[:, 1].max()],
                                    p[:, 1].max() < 0.5
                                    and p[:, 1].min() > -0.5,
                                    "within +-0.5")),
                   samples=kes.tolist())


def rotation_patch(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import rotation_patch_2d as rp

    case, fluid = rp.build_case(dx=rp.LL / 50.0, dtype=dtype, device=device)
    s = rp.init_sim(case, fluid)
    ke0 = rp.kinetic_energy(s)
    t0 = time.perf_counter()
    s = rp.make_run_chunk(case)(s, 1.5)
    wall = time.perf_counter() - t0
    ke = rp.kinetic_energy(s)
    f = s.fluid
    n = f["NReal"]
    pos = f["Position"][:n].double().cpu().numpy()
    vel = f["Velocity"][:n].double().cpu().numpy()
    m = f["Mass"][:n].double().cpu().numpy()
    r_max = float(np.linalg.norm(pos, axis=1).max())
    lz = float(np.sum(m * (pos[:, 0] * vel[:, 1] - pos[:, 1] * vel[:, 0])))
    return _record("rotation_patch_2d", s, wall, dx=case.dx,
                   n_fluid=case.n_fluid, gates=dict(
                       ke0=_gate(ke0, abs(ke0 - 1 / 12) < 0.02 / 12,
                                 "1/12 +- 2%"),
                       ke=_gate(ke, abs(ke - 1 / 12) < 0.06 / 12,
                                "1/12 +- 6%"),
                       r_max=_gate(r_max, r_max > 0.75, "> 0.75"),
                       l_z=_gate(lz, lz < 0.0, "< 0")))


def _beam_tips(mod, case, s, times):
    return _curve(mod.make_run_chunk(case), s, times,
                  lambda s: mod.tip_displacement(case, s))


def oscillating_beam(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import oscillating_beam_2d as ob
    from sphinxsys_tpu_torch.io.regression import DTWRegressionTest

    case, s = ob.build_case(dtype=dtype, device=device)
    s, tips, wall = _beam_tips(ob, case, s, [i * 0.05 for i in range(1, 21)])
    tips = [0.0, *tips]
    test = DTWRegressionTest(os.path.join(GOLDEN, "oscillating_beam_2d"),
                             "BeamObserver", "TipDisplacementY")
    ok, report = test.test(np.asarray(tips))
    return _record("oscillating_beam_2d", s, wall, n_solid=case.n_solid,
                   dtw_report=str(report),
                   gates=dict(dtw=_gate(ok, ok, "DTWRegressionTest")),
                   samples=tips)


def cauchy_beam(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import oscillating_beam_2d as ob
    from sphinxsys_tpu_torch.cases import oscillating_beam_cauchy_2d as obc

    times = [i * 0.035 for i in range(1, 13)]
    curves, wall, sims = [], 0.0, []
    for mod in (obc, ob):
        case, s = mod.build_case(dx=ob.PH / 6, dtype=dtype, device=device)
        s, tips, w = _beam_tips(mod, case, s, times)
        curves.append(np.asarray([0.0, *tips]))
        wall += w
        sims.append(s)
    d_c, d_p = curves
    t = np.asarray([0.0, *times])
    i_c, i_p = int(np.argmin(d_c)), int(np.argmin(d_p))
    diff = float(np.max(np.abs(d_c - d_p)))
    return _record("oscillating_beam_cauchy_2d", sims[0], wall, gates=dict(
        trough=_gate(d_c[i_c], abs(d_c[i_c] - d_p[i_p]) < 0.05 * abs(d_p[i_p]),
                     f"{d_p[i_p]:.5f} +- 5%"),
        trough_time=_gate(t[i_c], abs(t[i_c] - t[i_p]) < 0.04,
                          f"{t[i_p]:.3f} +- 0.04"),
        pointwise=_gate(diff, diff < 0.15 * np.max(np.abs(d_p)),
                        f"< {0.15 * np.max(np.abs(d_p)):.5f}")),
        samples=[d_c.tolist(), d_p.tolist()])


def self_contact(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import self_contact_2d as sc
    from sphinxsys_tpu_torch.io import regression as rg

    case, beam = sc.build_case(dtype=dtype, device=device)
    s = sc.init_sim(case, beam)
    idx, w = sc.tip_observer(case, beam)
    tip0 = sc.observe_tip(s, idx, w)
    s, tips, wall = _curve(sc.make_run_chunk(case), s,
                           [i * 0.01 for i in range(1, 101)],
                           lambda s: sc.observe_tip(s, idx, w), progress=10)
    tips = np.asarray([tip0, *tips], np.float64)
    ref = rg.read_result_xml(os.path.join(
        REFDB, "self_contact_2d", "BeamObserver_Position_Run_0_result.xml"))[0]
    finite = bool(np.isfinite(tips).all()) and _finite(s.beam["Position"])
    return _record("self_contact_2d", s, wall, n=case.n,
                   dtw_to_jax_curve=rg.dtw_distance(tips, ref),
                   gates=dict(finite=_gate(finite, finite, "finite")),
                   samples=tips.tolist())


def passive_cantilever(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import passive_cantilever_3d as pc

    case, body = pc.build_case(dtype=dtype, device=device)
    s = pc.init_sim(case, body)
    idx, w = pc.corner_observer(case, body)
    obs0 = pc.observe_corner(s, idx, w)
    s, obs, wall = _curve(pc.make_run_chunk(case), s,
                          [i * 0.05 for i in range(1, 21)],
                          lambda s: pc.observe_corner(s, idx, w), progress=5)
    obs = np.asarray(obs)
    peak = obs[int(np.argmax(obs[:, 1]))]
    end = obs[-1]
    e0 = float(np.abs(obs0 - [5.9498, 0.9498, 0.9498]).max())
    ee = float(np.abs(end - [6.028, 0.011, 0.310]).max())
    finite = _finite(s.body["Position"])
    return _record("passive_cantilever_3d", s, wall, n=case.n, gates=dict(
        finite=_gate(finite, finite, "finite"),
        start=_gate(e0, e0 < 0.005, "< 0.005 of (5.9498, 0.9498, 0.9498)"),
        peak_y=_gate(peak[1], abs(peak[1] - 4.155) < 0.15, "4.155 +- 0.15"),
        peak_z=_gate(peak[2], abs(peak[2] - 2.794) < 0.15, "2.794 +- 0.15"),
        return_swing=_gate(ee, ee < 0.12, "< 0.12 of (6.028, 0.011, 0.310)")),
        samples=obs.tolist())


def muscle_activation(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import muscle_activation_3d as ma

    case, body = ma.build_case(dx=1.0 / 12.0, dtype=dtype, device=device)
    s = ma.init_sim(case, body)
    run = ma.make_run_chunk(case)
    x0 = ma.free_end_x(s)
    t0 = time.perf_counter()
    s = run(s, 0.6)
    x_mid = ma.free_end_x(s)
    s = run(s, 1.2)
    x_end = ma.free_end_x(s)
    wall = time.perf_counter() - t0
    b = s.body
    pos = b["Position"].double().cpu().numpy()
    pos0 = b["InitialPosition"].double().cpu().numpy()
    face = pos0[:, 0] > 1.0 - case.dx
    hm = case.holder_mask.cpu().numpy()
    holder = float(np.abs(pos[hm, 0] - pos0[hm, 0]).max())
    y_c, z_c = float(pos[face, 1].mean()), float(pos[face, 2].mean())
    finite = _finite(b["Position"])
    return _record("muscle_activation_3d", s, wall, n=case.n,
                   free_end_x=[x0, x_mid, x_end], gates=dict(
                       finite=_gate(finite, finite, "finite"),
                       push_t0_6=_gate(x_mid - x0, x_mid > x0 + 0.005,
                                       "> 0.005"),
                       push_t1_2=_gate(x_end - x_mid, x_end > x_mid + 0.005,
                                       "> 0.005"),
                       centre_y=_gate(y_c, abs(y_c - 0.5) < 0.02,
                                      "0.5 +- 0.02"),
                       centre_z=_gate(z_c, abs(z_c - 0.5) < 0.02,
                                      "0.5 +- 0.02"),
                       holder_x=_gate(holder, holder < 1e-6, "< 1e-6")))


def anisotropic_beam(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import anisotropic_beam_2d as ab
    from sphinxsys_tpu_torch.cases import oscillating_beam_2d as ob

    times = list(np.arange(0.01, 0.30 + 1e-9, 0.01))
    case_a, s_a = ab.build_case(dtype=dtype, device=device)
    s_a, ya, wall_a = _beam_tips(ab, case_a, s_a, times)
    case_i, s_i = ob.build_case(dtype=dtype, device=device)
    _, yi, wall_i = _beam_tips(ob, case_i, s_i, times)
    ya, yi, ts = np.asarray(ya), np.asarray(yi), np.asarray(times)
    dt_min = float(abs(ts[np.argmin(ya)] - ts[np.argmin(yi)]))
    diff = float(np.max(np.abs(ya - yi)))
    return _record("anisotropic_beam_2d", s_a, wall_a + wall_i,
                   n_solid=case_a.n_solid, gates=dict(
                       n_solid=_gate(case_a.n_solid, case_a.n_solid == 280,
                                     "280"),
                       max=_gate(ya.max(), abs(ya.max() - yi.max())
                                 <= 0.04 * abs(yi.max()),
                                 f"{yi.max():.5f} +- 4%"),
                       min=_gate(ya.min(), abs(ya.min() - yi.min())
                                 <= 0.04 * abs(yi.min()),
                                 f"{yi.min():.5f} +- 4%"),
                       first_minimum=_gate(dt_min, dt_min <= 0.02,
                                           "<= 0.02"),
                       pointwise=_gate(diff, diff < 0.15 * yi.max(),
                                       f"< {0.15 * yi.max():.5f}")),
                   samples=[ya.tolist(), yi.tolist()])


RUNS = {"standing_wave": standing_wave,
        "standing_wave_refdb": standing_wave_refdb,
        "poiseuille": poiseuille, "poiseuille_refdb": poiseuille_refdb,
        "impact_patch": impact_patch, "rotation_patch": rotation_patch,
        "oscillating_beam": oscillating_beam, "cauchy_beam": cauchy_beam,
        "self_contact": self_contact,
        "passive_cantilever": passive_cantilever,
        "muscle_activation": muscle_activation,
        "anisotropic_beam": anisotropic_beam}


def run_all(runs: dict, argv, default_out: str, description: str,
            default_dtype: str = "float32") -> int:
    """The runs named by --cases (all of `runs` by default) on --device in
    --dtype ("case": each case's own default, passed as None), each
    reported and written to --out as it ends; 1 if any raised, overflowed
    or failed a gate."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--cases", default=",".join(runs))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default=default_dtype)
    ap.add_argument("--out", default=default_out)
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    card = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    dtype = None if a.dtype == "case" else resolve_dtype(a.dtype)
    results, ok = {"device": card, "dtype": a.dtype}, True
    for name in a.cases.split(","):
        try:
            res = runs[name](device, dtype)
        except Exception as exc:      # reported as a failed run, not hidden
            res = dict(error=repr(exc), gates={})
        results[name] = res
        passed = "error" not in res and not res.get("overflow", False) \
            and all(g["ok"] for g in res["gates"].values())
        ok &= passed
        print(f"{name}: " + json.dumps({k: v for k, v in res.items()
                                        if k != "samples"}), flush=True)
        for g, v in res["gates"].items():
            print(f"{name}: gate {g} = {v['value']!r} against {v['bound']}: "
                  f"{'pass' if v['ok'] else 'FAIL'}", flush=True)
        print(f"{name}: gates {'pass' if passed else 'FAIL'}", flush=True)
        with open(a.out, "w") as f:
            json.dump(results, f)
    return 0 if ok else 1


def main(argv=None) -> int:
    return run_all(RUNS, argv, "a7bc_long.json", __doc__.splitlines()[0])


if __name__ == "__main__":
    raise SystemExit(main())
