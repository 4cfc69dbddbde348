"""The multi-phase and rigid-body cases to their JAX tests' end times, each
held to that test's gates that need no external reference database:

    python -m sphinxsys_tpu_torch.benchmarks.a7d_rigid_long
        [--cases two_phase,two_phase_golden,square_droplet,
                 square_droplet_refdb,cubic_droplet,droplet_impact,
                 floating_body,floating_body_golden,stfb,stfb_refdb,
                 owsc,nonlinear_wave_fsi]
        [--device cuda] [--dtype float32] [--out a7d_rigid_long.json]

  * two_phase: two_phase_dambreak_2d at dx = 0.1 to t = 3, the front every
    0.5 (tests/test_two_phase.py): no overflow, the front past 3.3 at
    t = 1.5 and at the far wall (DL - 3 dx) at the end, |rho_w / rho0 - 1|
    < 0.05, the air's density below 0.01 rho0_w and above 0.1 rho0_a, its
    velocity finite, its mass n_air rho0_a dx^2 within 1e-6, its volume
    within 30% of its start;
  * two_phase_golden: at the default dx = 0.05, the water's kinetic energy
    every 0.08 to t = 1.2, held by the port's DTWRegressionTest to
    tests/golden/two_phase_dambreak_2d (tests/test_golden_regression.py:
    185-198);
  * square_droplet: square_droplet_2d at dx = 0.08
    (tests/test_surface_tension.py): the top edge's stress tangential
    (S n < 1e-5 of max|S|, trace = sigma |grad C| within 1e-5), the
    capillary time-step floor within 1e-5, the corner radius above 0.6 at
    the start and pulled in by 0.02 at t = 0.2 with 0 < KE < 5 and the
    centre within 0.05 of the origin, and the Laplace jump
    p_in - p_out within 50% of sigma / R at t = 1;
  * square_droplet_refdb: at the default dx = 0.04, the water's kinetic
    energy every 0.02 to t = 2 (benchmarks/run_refdb_parity.py's cadence),
    its DTW distance to the JAX package's curve in
    tests/golden/refdb/square_droplet_2d printed, not gated;
  * cubic_droplet: cubic_droplet_3d at dx = 0.1 to t = 0.3, the kinetic
    energy every 0.05 (tests/test_cubic_droplet.py): no overflow, the
    largest radius in (0.55, 0.70).  Its DTW gate reads the reference's
    own database, which is not in the repository, and is left out;
  * droplet_impact: droplet_impact_2d at its default dx = R / 20 to
    t = 0.02 (tests/test_droplet_impact.py): KE(0) within 1e-6 of 9.875,
    KE at t = 0.004, 0.012 and 0.02 within 5% of the test's inline
    reference, KE(0.02) < KE(0), t / n_adv > 1e-4, the air's density below
    0.01, its velocity finite;
  * floating_body: floating_body_2d at dx = 0.025, the draft every 0.125
    to t = 2 (tests/test_rigid.py:57-86): no overflow, the second half's
    mean draft in (0.4, 1.4) x RHO_RATIO BH, the largest draft above half
    that and below BH, |theta| < 0.3, the block within 0.1 of the centre;
  * floating_body_golden: at the default dx = 0.02, the block's COM height
    every 0.1 to t = 2, held by DTWRegressionTest to
    tests/golden/floating_body_2d (tests/test_golden_regression.py:
    237-255);
  * stfb: stfb_2d at its default dx after a 0.6 s hold, to t = 0.6
    (tests/test_stfb.py:40-58): no overflow, the COM within 0.03 of
    (0, -0.2), |theta| < 0.05, |V| < 0.25;
  * stfb_refdb: after the default 1 s hold, the COM and the gauge at 30
    times over 10 s (run_refdb_parity.py's cadence), their DTW distances
    to tests/golden/refdb/stfb_2d printed, not gated;
  * owsc: owsc_2d at dx = 0.06 to t = 6, sampled every 0.25
    (tests/test_owsc.py:60-100): no overflow, finite, the gauge at x = 3
    above 0.72 and below 0.67 after t = 1.5 (its peaks 1.4-2.8 s apart
    where it has two), the flap's pitch after t = 4 in (0.15, 1.0) with
    both signs past 0.05, the damper's energy at the end above five times
    its value at t = 3.5 (floor 0.1);
  * nonlinear_wave_fsi: nonlinear_wave_fsi_2d at dx = 0.06 to t = 2,
    sampled every 0.25 (tests/test_nonlinear_wave_fsi.py:70-100): no
    overflow, the pressure finite, the COM within 0.05 of its start,
    |theta| < 0.2, both tethers' mean tension above 100, the gauge at
    x = 2 off 0.8 by more than 0.015.

Each run reports its step counts, its wall time and each gate's value
beside its bound, and writes them with the samples to --out as JSON.
Exits 1 if a run raised, overflowed or failed a gate (the other runs go
on).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from sphinxsys_tpu_torch.benchmarks.a7bc_long import (GOLDEN, REFDB, _curve,
                                                      _gate, _record, run_all)


def _np(t):
    return t.detach().double().cpu().numpy()


def _real(state, key):
    return _np(state[key][: state["NReal"]])


def two_phase(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import two_phase_dambreak_2d as tp

    case, water, air = tp.build_case(dx=0.1, dtype=dtype, device=device)
    s = tp.init_sim(case, water, air)
    times = [i * 0.5 for i in range(1, 7)]
    s, fronts, wall = _curve(tp.make_run_chunk(case), s, times,
                             lambda s: float(tp.water_front(s)))
    ts = np.asarray([t for t in times[:len(fronts)]])
    i15 = int(np.argmin(np.abs(ts - 1.5)))
    rho_w, rho_a = _real(s.water, "Density"), _real(s.air, "Density")
    m_air = float(_np(s.air["Mass"]).sum())
    m_exp = case.n_air * tp.RHO0_A * case.dx ** 2
    vol = float(_real(s.air, "VolumetricMeasure").sum())
    vol0 = case.n_air * case.dx ** 2
    finite = bool(torch.isfinite(s.air["Velocity"]).all())
    dev = float(np.abs(rho_w / tp.RHO0_F - 1.0).max())
    return _record("two_phase_dambreak_2d", s, wall, dx=case.dx,
                   n_water=case.n_water, n_air=case.n_air, gates=dict(
                       front_t1_5=_gate(fronts[i15], fronts[i15] > 3.3,
                                        "> 3.3"),
                       front_end=_gate(fronts[-1], fronts[-1]
                                       > tp.DL - 3 * case.dx,
                                       f"> {tp.DL - 3 * case.dx:.3f}"),
                       water_density=_gate(dev, dev < 0.05, "< 0.05"),
                       air_density_max=_gate(rho_a.max(), rho_a.max()
                                             < 0.01 * tp.RHO0_F, "< 0.01"),
                       air_density_min=_gate(rho_a.min(), rho_a.min()
                                             > 0.1 * tp.RHO0_A, "> 1e-4"),
                       air_velocity=_gate(finite, finite, "finite"),
                       air_mass=_gate(m_air, abs(m_air - m_exp)
                                      <= 1e-6 * m_exp,
                                      f"{m_exp:.6g} +- 1e-6"),
                       air_volume=_gate(vol, 0.7 * vol0 < vol < 1.3 * vol0,
                                        f"({0.7 * vol0:.4f}, "
                                        f"{1.3 * vol0:.4f})")),
                   samples=fronts)


def two_phase_golden(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import two_phase_dambreak_2d as tp
    from sphinxsys_tpu_torch.io.regression import DTWRegressionTest
    from sphinxsys_tpu_torch.physics import general as gd

    case, water, air = tp.build_case(dtype=dtype, device=device)
    s = tp.init_sim(case, water, air)
    ke = lambda s: float(gd.total_kinetic_energy(s.water))   # noqa: E731
    ke0 = ke(s)
    s, kes, wall = _curve(tp.make_run_chunk(case), s,
                          [i * 0.08 for i in range(1, 16)], ke)
    kes = [ke0, *kes]
    test = DTWRegressionTest(os.path.join(GOLDEN, "two_phase_dambreak_2d"),
                             "WaterBody", "TotalKineticEnergy")
    ok, report = test.test(np.asarray(kes))
    return _record("two_phase_dambreak_2d", s, wall, dx=case.dx,
                   n_water=case.n_water, n_air=case.n_air,
                   dtw_report=str(report),
                   gates=dict(dtw=_gate(ok, ok, "DTWRegressionTest")),
                   samples=kes)


def square_droplet(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import square_droplet_2d as sq
    from sphinxsys_tpu_torch.physics import surface_tension as st

    case, water, air = sq.build_case(dx=0.08, dtype=dtype, device=device)
    s = sq.init_sim(case, water, air)
    gates = {}
    w = st.surface_tension_stress(s.water, [(s.air, s.nl_wa, sq.FRAC_W)],
                                  case.kernel, 2, sq.SIGMA)
    pos, cg = _np(w["Position"]), _np(w["ColorGradient"])
    S, nd = _np(w["SurfaceTensionStress"]), _np(w["NormDirection"])
    sel = (np.abs(pos[:, 0]) < 0.3) & (pos[:, 1] > 0.5 - 0.1)
    sel &= np.linalg.norm(cg, axis=-1) > 0.5 * np.abs(cg[sel][:, 1]).max()
    Sn = np.abs(np.einsum("nij,nj->ni", S[sel], nd[sel])).max() \
        / np.abs(S[sel]).max()
    tr = S[sel][:, 0, 0] + S[sel][:, 1, 1]
    tr_err = float(np.abs(tr / (sq.SIGMA * np.linalg.norm(cg[sel], axis=-1))
                          - 1.0).max())
    gates["tangential"] = _gate(Sn, Sn < 1e-5, "< 1e-5")
    gates["trace"] = _gate(tr_err, tr_err < 1e-5, "< 1e-5")
    h = case.adaptation.h
    dt = float(st.surface_tension_time_step(water, case.eos_w, h, sq.RHO0_F,
                                            sq.SIGMA))
    expect = 0.6 * h / max(sq.C_F, np.sqrt(2 * np.pi * sq.SIGMA
                                           / (sq.RHO0_F * h)))
    gates["capillary_dt"] = _gate(dt, abs(dt / expect - 1) < 1e-5,
                                  f"{expect:.6g} +- 1e-5")
    r0 = sq.water_max_radius(s)
    gates["corner_start"] = _gate(r0, r0 > 0.60, "> 0.60")
    run = sq.make_run_chunk(case)
    t0 = time.perf_counter()
    s = run(s, 0.2)
    ke, r = sq.water_kinetic_energy(s), sq.water_max_radius(s)
    com = float(np.linalg.norm(_real(s.water, "Position").mean(axis=0)))
    gates["ke_t0_2"] = _gate(ke, 0.0 < ke < 5.0, "(0, 5)")
    gates["corner_t0_2"] = _gate(r, r < r0 - 0.02, f"< {r0 - 0.02:.4f}")
    gates["centre"] = _gate(com, com < 0.05, "< 0.05")
    s = run(s, 1.0)
    wall = time.perf_counter() - t0
    rw = np.linalg.norm(_real(s.water, "Position"), axis=1)
    ra = np.linalg.norm(_real(s.air, "Position"), axis=1)
    p_in = float(np.median(_real(s.water, "Pressure")[rw < 0.3]))
    p_out = float(np.median(_real(s.air, "Pressure")[(ra > 0.75)
                                                      & (ra < 0.95)]))
    R = float(np.sqrt(_real(s.water, "VolumetricMeasure").sum() / np.pi))
    jump = (p_in - p_out) / (sq.SIGMA / R)
    gates["laplace"] = _gate(jump, abs(jump - 1.0) <= 0.5,
                             "1 +- 0.5 of sigma / R")
    return _record("square_droplet_2d", s, wall, dx=case.dx,
                   n_water=case.n_water, n_air=case.n_air, gates=gates,
                   samples=[r0, r, ke, p_in, p_out, R])


def square_droplet_refdb(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import square_droplet_2d as sq
    from sphinxsys_tpu_torch.io import regression as rg

    case, water, air = sq.build_case(dtype=dtype, device=device)
    s = sq.init_sim(case, water, air)
    ke0 = sq.water_kinetic_energy(s)
    s, kes, wall = _curve(sq.make_run_chunk(case), s,
                          [i * 0.02 for i in range(1, 101)],
                          sq.water_kinetic_energy, progress=20)
    kes = [ke0, *kes]
    ref = rg.read_result_xml(os.path.join(
        REFDB, "square_droplet_2d",
        "WaterBody_TotalKineticEnergy_Run_0_result.xml"))[0]
    finite = bool(np.isfinite(kes).all())
    return _record("square_droplet_2d", s, wall, dx=case.dx,
                   n_water=case.n_water, n_air=case.n_air,
                   dtw_to_jax_curve=rg.dtw_distance(np.asarray(kes), ref),
                   gates=dict(finite=_gate(finite, finite, "finite")),
                   samples=kes)


def cubic_droplet(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import cubic_droplet_3d as cd

    case, water, air = cd.build_case(dx=2.0 / 20, dtype=dtype, device=device)
    s = cd.init_sim(case, water, air)
    s, kes, wall = _curve(cd.make_run_chunk(case), s,
                          [i * 0.05 for i in range(1, 7)],
                          cd.water_kinetic_energy)
    r = cd.water_max_radius(s)
    return _record("cubic_droplet_3d", s, wall, dx=case.dx,
                   n_water=case.n_water, n_air=case.n_air,
                   gates=dict(rmax=_gate(r, 0.55 < r < 0.70, "(0.55, 0.70)")),
                   samples=kes)


# tests/test_droplet_impact.py's inline reference KE at t = k 0.004
DROPLET_REF_KE = {0: 9.875, 1: 9.6867, 3: 9.6982, 5: 8.7790}


def droplet_impact(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import droplet_impact_2d as di

    case, water, air = di.build_case(dtype=dtype, device=device)
    s = di.init_sim(case, water, air)
    kes = {0: di.water_kinetic_energy(s)}
    run = di.make_run_chunk(case)
    t0 = time.perf_counter()
    for i in (1, 3, 5):
        s = run(s, i * 0.004)
        kes[i] = di.water_kinetic_energy(s)
    wall = time.perf_counter() - t0
    gates = {"ke0": _gate(kes[0], abs(kes[0] / DROPLET_REF_KE[0] - 1)
                          < 1e-6, f"{DROPLET_REF_KE[0]} +- 1e-6")}
    for i in (1, 3, 5):
        err = abs(kes[i] - DROPLET_REF_KE[i]) / DROPLET_REF_KE[i]
        gates[f"ke_t{i * 0.004:g}"] = _gate(kes[i], err < 0.05,
                                           f"{DROPLET_REF_KE[i]} +- 5%")
    gates["decays"] = _gate(kes[5], kes[5] < kes[0], f"< {kes[0]:.4f}")
    dt_mean = float(s.time) / s.n_adv
    gates["dt_adv"] = _gate(dt_mean, dt_mean > 1e-4, "> 1e-4")
    rho_a = _real(s.air, "Density")
    gates["air_density"] = _gate(rho_a.max(), rho_a.max() < 0.01, "< 0.01")
    finite = bool(torch.isfinite(s.air["Velocity"]).all())
    gates["air_velocity"] = _gate(finite, finite, "finite")
    return _record("droplet_impact_2d", s, wall, dx=case.dx,
                   n_water=case.n_water, n_air=case.n_air, gates=gates,
                   samples=[kes[k] for k in sorted(kes)])


def floating_body(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import floating_body_2d as fb

    case, fluid = fb.build_case(dx=0.025, dtype=dtype, device=device)
    s = fb.init_sim(case, fluid)
    s, drafts, wall = _curve(fb.make_run_chunk(case), s,
                             [i * 0.125 for i in range(1, 17)], fb.draft)
    drafts = np.asarray(drafts)
    target = fb.RHO_RATIO * fb.BH
    mean = float(drafts[len(drafts) // 2:].mean())
    theta, x = float(s.rb.theta), float(s.rb.com[0])
    return _record("floating_body_2d", s, wall, dx=case.dx,
                   n_fluid=case.n_fluid, n_block=case.n_block, gates=dict(
                       mean_draft=_gate(mean, 0.4 * target < mean
                                        < 1.4 * target,
                                        f"({0.4 * target:.3f}, "
                                        f"{1.4 * target:.3f})"),
                       sank=_gate(drafts.max(), drafts.max() > 0.5 * target,
                                  f"> {0.5 * target:.3f}"),
                       not_through=_gate(drafts.max(), drafts.max() < fb.BH,
                                         f"< {fb.BH}"),
                       theta=_gate(theta, abs(theta) < 0.3, "|.| < 0.3"),
                       centred=_gate(x, abs(x - fb.DL / 2) < 0.1,
                                     f"{fb.DL / 2} +- 0.1")),
                   samples=drafts.tolist())


def floating_body_golden(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import floating_body_2d as fb
    from sphinxsys_tpu_torch.io.regression import DTWRegressionTest

    case, fluid = fb.build_case(dtype=dtype, device=device)
    s = fb.init_sim(case, fluid)
    y0 = fb.heave(s)
    s, ys, wall = _curve(fb.make_run_chunk(case), s,
                         [i * 0.1 for i in range(1, 21)], fb.heave)
    ys = [y0, *ys]
    test = DTWRegressionTest(os.path.join(GOLDEN, "floating_body_2d"),
                             "FloatingBlock", "CenterOfMassY")
    ok, report = test.test(np.asarray(ys))
    return _record("floating_body_2d", s, wall, dx=case.dx,
                   n_fluid=case.n_fluid, dtw_report=str(report),
                   gates=dict(dtw=_gate(ok, ok, "DTWRegressionTest")),
                   samples=ys)


def stfb(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import stfb_2d as sf

    case, fluid = sf.build_case(dtype=dtype, device=device)
    t0 = time.perf_counter()
    s = sf.init_sim(case, fluid, settle_time=0.6)
    s = sf.make_run_chunk(case)(s, 0.6)
    wall = time.perf_counter() - t0
    com = _np(s.rb.com)
    theta, speed = float(s.rb.theta), float(torch.linalg.norm(s.rb.vel))
    return _record("stfb_2d", s, wall, dx=case.dx, n_fluid=case.n_fluid,
                   gates=dict(
                       com_x=_gate(com[0], abs(com[0]) < 0.03, "|.| < 0.03"),
                       com_y=_gate(com[1], abs(com[1] + 0.2) < 0.03,
                                   "-0.2 +- 0.03"),
                       theta=_gate(theta, abs(theta) < 0.05, "|.| < 0.05"),
                       speed=_gate(speed, speed < 0.25, "< 0.25")),
                   samples=com.tolist())


def stfb_refdb(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import stfb_2d as sf
    from sphinxsys_tpu_torch.io import regression as rg

    case, fluid = sf.build_case(dtype=dtype, device=device)
    t0 = time.perf_counter()
    s = sf.init_sim(case, fluid)          # the 1 s hold

    def measure(s):
        return [*_np(s.rb.com).tolist(),
                float(sf.free_surface_height(case, s.fluid))]

    rows = [measure(s)]
    s, more, _ = _curve(sf.make_run_chunk(case), s,
                        [i * 10.0 / 29 for i in range(1, 30)], measure,
                        progress=5)
    wall = time.perf_counter() - t0
    rows = np.asarray([*rows, *more])
    com_ref = rg.read_result_xml(os.path.join(
        REFDB, "stfb_2d", "Observer_Position_Run_0_result.xml"))[0]
    gauge_ref = rg.read_result_xml(os.path.join(
        REFDB, "stfb_2d", "FreeSurfaceGauge_FreeSurfaceHeight_Run_0_result.xml"
    ))[0]
    finite = bool(np.isfinite(rows).all())
    return _record("stfb_2d", s, wall, dx=case.dx, n_fluid=case.n_fluid,
                   dtw_to_jax_curves=dict(
                       Position=rg.dtw_distance(rows[:, :2], com_ref),
                       FreeSurfaceHeight=rg.dtw_distance(rows[:, 2],
                                                         gauge_ref)),
                   gates=dict(finite=_gate(finite, finite, "finite")),
                   samples=rows.tolist())


def owsc(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import owsc_2d as ow

    case, fluid = ow.build_case(dx=0.06, dtype=dtype, device=device)
    s = ow.init_sim(case, fluid)

    def measure(s):
        return [float(s.time), float(ow.wave_gauge(case, s)),
                float(s.pj.theta), float(s.pto_energy)]

    s, rows, wall = _curve(ow.make_run_chunk(case), s,
                           [i * 0.25 for i in range(1, 25)], measure,
                           progress=4)
    t, gauge, theta, energy = map(np.asarray, zip(*rows))
    sel, late = t > 1.5, t > 4.0
    peaks = [i for i in range(1, len(t) - 1)
             if sel[i] and gauge[i] >= gauge[i - 1] and gauge[i] > gauge[i + 1]
             and gauge[i] > 0.71]
    period = float(np.diff(t[peaks]).mean()) if len(peaks) >= 2 else None
    e_pre = float(energy[np.searchsorted(t, 3.5)])
    finite = bool(np.isfinite(gauge).all() and np.isfinite(theta).all())
    pitch = float(np.abs(theta[late]).max())
    gates = dict(
        finite=_gate(finite, finite, "finite"),
        gauge_high=_gate(gauge[sel].max(), gauge[sel].max() > 0.72, "> 0.72"),
        gauge_low=_gate(gauge[sel].min(), gauge[sel].min() < 0.67, "< 0.67"),
        pitch=_gate(pitch, 0.15 < pitch < 1.0, "(0.15, 1.0)"),
        pitch_both_ways=_gate([float(theta[late].max()),
                               float(theta[late].min())],
                              (theta[late] > 0.05).any()
                              and (theta[late] < -0.05).any(),
                              "> 0.05 and < -0.05"),
        pto_energy=_gate(energy[-1], energy[-1] > 5.0 * max(e_pre, 0.1),
                         f"> {5.0 * max(e_pre, 0.1):.3f}"))
    if period is not None:
        gates["period"] = _gate(period, 1.4 < period < 2.8, "(1.4, 2.8)")
    return _record("owsc_2d", s, wall, dx=case.dx, n_fluid=case.n_fluid,
                   gates=gates, samples=rows)


def nonlinear_wave_fsi(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import nonlinear_wave_fsi_2d as nw

    case, fluid = nw.build_case(dx=0.06, dtype=dtype, device=device)
    com0 = _np(case.rb0.com)
    s = nw.init_sim(case, fluid)

    def measure(s):
        return [float(s.time), *_np(s.rb.com).tolist(), float(s.rb.theta),
                *_np(s.tension).tolist(),
                float(nw.wave_gauge(s, x=2.0, half_width=0.078))]

    s, rows, wall = _curve(nw.make_run_chunk(case), s,
                           [i * 0.25 for i in range(1, 9)], measure)
    t, cx, cy, th, ta, tb, gauge = map(np.asarray, zip(*rows))
    finite = bool(torch.isfinite(s.fluid["Pressure"]).all())
    dx_, dy_ = float(np.abs(cx - com0[0]).max()), \
        float(np.abs(cy - com0[1]).max())
    dev = float(np.abs(gauge - 0.8).max())
    return _record("nonlinear_wave_fsi_2d", s, wall, dx=case.dx,
                   n_fluid=case.n_fluid, gates=dict(
                       pressure=_gate(finite, finite, "finite"),
                       com_x=_gate(dx_, dx_ < 0.05, "< 0.05"),
                       com_y=_gate(dy_, dy_ < 0.05, "< 0.05"),
                       theta=_gate(np.abs(th).max(), np.abs(th).max() < 0.2,
                                   "< 0.2"),
                       tension_a=_gate(ta.mean(), ta.mean() > 100.0,
                                       "> 100"),
                       tension_b=_gate(tb.mean(), tb.mean() > 100.0,
                                       "> 100"),
                       gauge=_gate(dev, dev > 0.015, "> 0.015")),
                   samples=rows)


RUNS = {"two_phase": two_phase, "two_phase_golden": two_phase_golden,
        "square_droplet": square_droplet,
        "square_droplet_refdb": square_droplet_refdb,
        "cubic_droplet": cubic_droplet, "droplet_impact": droplet_impact,
        "floating_body": floating_body,
        "floating_body_golden": floating_body_golden,
        "stfb": stfb, "stfb_refdb": stfb_refdb, "owsc": owsc,
        "nonlinear_wave_fsi": nonlinear_wave_fsi}


def main(argv=None) -> int:
    return run_all(RUNS, argv, "a7d_rigid_long.json", __doc__.splitlines()[0])


if __name__ == "__main__":
    raise SystemExit(main())
