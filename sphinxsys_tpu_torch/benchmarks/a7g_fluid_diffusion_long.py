"""The small-fluid and plain-diffusion cases to their JAX tests' end times,
each held to that test's gates that need no external reference database:

    python -m sphinxsys_tpu_torch.benchmarks.a7g_fluid_diffusion_long
        [--cases throat,lid_cavity,windkessel,womersley,buffer_count,vp,
                 heat_transfer,depolarization]
        [--device cuda] [--dtype case] [--out a7g_fluid_diffusion_long.json]

  * throat: throat_2d at its default width to t = 2, 5 and 10
    (tests/test_throat.py:36-63): KE(2) within 20% of 0.00172, KE(5)
    within 20% of 0.000502, KE(10) in (0.00024, 0.00050), max |tau| < 50,
    max N1 = tau_xx - tau_yy > 0.1, no overflow;
  * lid_cavity: lid_driven_cavity_2d at its default width, the kinetic
    energy every 0.25 to t = 3, held by DTWRegressionTest to
    tests/golden/lid_driven_cavity_2d (tests/test_golden_regression.py:
    221-232); JAX's own float32 CPU distance to the same curve
    (tests/golden_torch/lid_driven_cavity_2d/jax_f32_ke.json, written by
    tests/test_torch_fluid_diffusion_cases.py) is printed beside the
    card's;
  * windkessel: channel_windkessel_2d at its default width to t = 0.065
    (tests/test_windkessel_case.py:30-51): no overflow, finite,
    |rho / rho0 - 1| < 0.15, the bulk's mean u within 0.6 max(u_in, 0.1)
    of the inflow u_in(t), the outlet pressure in (80.5, 200) mmHg; and
    the inflow waveform (:14-27): non-negative, periodic over 1 s, mean in
    (0.15, 0.35), peak > 0.4, trough < 0.15;
  * womersley: pulsatile_poiseuille_2d 12 across to 0.1 and 0.2 of the
    viscous time (tests/test_pulsatile_poiseuille.py:27-55): the
    centreline within 0.15 |u_ref| + 0.02 u_ref of the exact startup
    solution at each, the last above 0.2 u_ref, no overflow;
  * buffer_count: pulsatile_poiseuille_2d 10 across to 0.15 of the viscous
    time (:89-104): the live count within 8% of the start, no overflow;
  * vp: vp_heat_flux_2d in float64 (tests/test_vp_optimization.py): the
    heat-flux steady mean T within 0.3 of 442.74, the flux strip hotter
    than the mean, T in (290, 700); the same-sink mean within 3.0 of
    587.88; 80 Adam steps of the heat-flux layout: mean T < 410, the
    strip's < 510, mean k within 0.01 of 1, min k >= 0.1, the first loss
    > 440 and the mean 50 below it; 60 of the same-sink: mean T < 502,
    mean k within 0.01 of 1.  The random start is the port's seeded
    generator, not JAX's bits;
  * heat_transfer: heat_transfer_2d at its default width to t = 0.75
    (tests/test_heat_transfer.py:17-48): Phi within the walls' 20 and 40,
    the y-profile decreasing, its first band above 30 and its middle
    within 0.05 of 20, the observer within 0.01 of 20, the sponge's
    centreline u within 15% of 1.5 u_ave(0.75);
  * depolarization: depolarization_2d at its default width, the observer
    every 0.1 to t = 6 (tests/test_depolarization.py:31-57): the half
    crossing in (0.8, 2.8), no drop below -0.005, the plateau within 0.01
    of 0.9737 (the test's reference-database value its comment quotes).

Left out, because it reads the reference's own regression database,
which the repository does not hold: the depolarization observer's first
sample against that database (tests/test_depolarization.py:43-45).

--dtype "case" (the default: each case's own, float32 but the thermal
optimisation's float64), float32 or float64.  Each run reports its step
counts, its wall time and each gate's value beside its bound, and writes
them with the samples to --out as JSON.  Exits 1 if a run raised,
overflowed or failed a gate (the other runs go on).
"""

from __future__ import annotations

import json
import math
import os
import time

import numpy as np
import torch

from sphinxsys_tpu_torch.benchmarks.a7bc_long import (GOLDEN, _curve,
                                                      _finite, _gate,
                                                      _record, run_all)
from sphinxsys_tpu_torch.benchmarks.a7e_damping_long import GOLDEN as \
    GOLDEN_TORCH


def _kw(dtype, **kw):
    return dict(kw, dtype=dtype) if dtype is not None else kw


def _np(t):
    return t.detach().double().cpu().numpy()


def throat(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import throat_2d as th

    case, fluid = th.build_case(**_kw(dtype, device=device))
    s, kes, wall = _curve(th.make_run_chunk(case), th.init_sim(case, fluid),
                          [2.0, 5.0, 10.0], th.kinetic_energy, progress=1)
    tau = s.fluid["ElasticStress"]
    tau_max = float(tau.abs().max())
    n1 = float((tau[:, 0, 0] - tau[:, 1, 1]).max())
    ke = kes + [math.nan] * (3 - len(kes))
    return _record("throat_2d", s, wall, n=case.n_fluid, gates=dict(
        ke2=_gate(ke[0], abs(ke[0] - 0.00172) <= 0.2 * 0.00172,
                  "0.00172 +- 20%"),
        ke5=_gate(ke[1], abs(ke[1] - 0.000502) <= 0.2 * 0.000502,
                  "0.000502 +- 20%"),
        ke10=_gate(ke[2], 0.00024 < ke[2] < 0.00050, "(0.00024, 0.00050)"),
        tau=_gate(tau_max, tau_max < 50.0, "< 50"),
        n1=_gate(n1, n1 > 0.1, "> 0.1")), samples=kes)


def lid_cavity(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import lid_driven_cavity_2d as lc
    from sphinxsys_tpu_torch.io.regression import DTWRegressionTest

    case, fluid = lc.build_case(**_kw(dtype, device=device))
    s = lc.init_sim(case, fluid)
    ke0 = lc.kinetic_energy(s)
    s, kes, wall = _curve(lc.make_run_chunk(case), s,
                          [i * 0.25 for i in range(1, 13)], lc.kinetic_energy,
                          progress=4)
    kes = [ke0] + kes
    test = DTWRegressionTest(os.path.join(GOLDEN, "lid_driven_cavity_2d"),
                             "FluidBody", "TotalKineticEnergy")
    ok, report = test.test(np.asarray(kes))
    dist = [float(d[0]) for d in test.distances(np.asarray(kes))]
    with open(os.path.join(GOLDEN_TORCH, "lid_driven_cavity_2d",
                           "jax_f32_ke.json")) as f:
        jax_dist = json.load(f)["dtw"]
    print(f"  lid cavity DTW to the golden: card {dist}, JAX's float32 "
          f"CPU run {jax_dist} (limit 1.01 x {float(test.threshold[0]):.4g})",
          flush=True)
    return _record("lid_driven_cavity_2d", s, wall, n=case.n_fluid,
                   dtw=dist, jax_f32_dtw=jax_dist, dtw_report=report,
                   gates=dict(dtw=_gate(dist, ok and len(kes) == 13,
                                        "DTWRegressionTest")),
                   samples=kes)


def windkessel(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import channel_windkessel_2d as cw

    t = torch.linspace(0.0, 1.0, 201, dtype=torch.float64)
    u = cw.inflow_velocity(t).numpy()
    period = abs(float(cw.inflow_velocity(torch.tensor(0.3)))
                 - float(cw.inflow_velocity(torch.tensor(1.3))))
    case, fluid = cw.build_case(**_kw(dtype, device=device))
    s, ps, wall = _curve(cw.make_run_chunk(case), cw.init_sim(case, fluid),
                         [0.02, 0.04, 0.065], cw.outlet_pressure_mmhg)
    live = s.fluid["Alive"]
    v = _np(s.fluid["Velocity"][live])
    rho = _np(s.fluid["Density"][live])
    u_in = float(cw.inflow_velocity(s.time))
    du = abs(v[:, 0].mean() - u_in)
    dev_rho = float(np.abs(rho / cw.RHO0_F - 1.0).max())
    finite = bool(np.isfinite(v).all() and np.isfinite(rho).all())
    return _record("channel_windkessel_2d", s, wall, n_alive=cw.n_alive(s),
                   gates=dict(
                       waveform=_gate(
                           [float(u.min()), period, float(u.mean()),
                            float(u.max())],
                           u.min() >= 0.0 and period < 1e-5
                           and 0.15 < u.mean() < 0.35 and u.max() > 0.4
                           and u.min() < 0.15,
                           ">= 0, periodic to 1e-5, mean (0.15, 0.35), "
                           "peak > 0.4, trough < 0.15"),
                       finite=_gate(finite, finite, "finite"),
                       density=_gate(dev_rho, dev_rho < 0.15, "< 0.15"),
                       inflow=_gate(du, du < 0.6 * max(u_in, 0.1),
                                    f"< {0.6 * max(u_in, 0.1):.4f}"),
                       pressure=_gate(ps[-1], 80.5 < ps[-1] < 200.0,
                                      "(80.5, 200) mmHg")),
                   samples=ps)


def womersley(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import pulsatile_poiseuille_2d as pp

    case, fluid = pp.build_case(**_kw(dtype, n_across=12, device=device))
    t_visc = (0.5 * case.dh) ** 2 / (case.mu / case.rho0)
    s = pp.init_sim(case, fluid)
    run = pp.make_run_chunk(case)
    rows, t0 = [], time.perf_counter()
    gates = {}
    for frac in (0.1, 0.2):
        s = run(s, frac * t_visc)
        u_sim = pp.centerline_velocity(case, s)
        u_ref = float(pp.womersley_startup_velocity(case, 0.0, float(s.time)))
        rows.append([float(s.time), u_sim, u_ref])
        bound = 0.15 * abs(u_ref) + 0.02 * case.u_ref
        gates[f"centreline_{frac:g}"] = _gate(abs(u_sim - u_ref),
                                              abs(u_sim - u_ref) < bound,
                                              f"< {bound:.4e}")
    gates["developed"] = _gate(rows[-1][1], rows[-1][1] > 0.2 * case.u_ref,
                               f"> {0.2 * case.u_ref:.4e}")
    return _record("pulsatile_poiseuille_2d", s, time.perf_counter() - t0,
                   n_alive=pp.n_alive(s), gates=gates, samples=rows)


def buffer_count(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import pulsatile_poiseuille_2d as pp

    case, fluid = pp.build_case(**_kw(dtype, n_across=10, device=device))
    t_visc = (0.5 * case.dh) ** 2 / (case.mu / case.rho0)
    s = pp.init_sim(case, fluid)
    n0 = pp.n_alive(s)
    s, counts, wall = _curve(pp.make_run_chunk(case), s,
                             [0.05 * t_visc, 0.1 * t_visc, 0.15 * t_visc],
                             pp.n_alive)
    dn = abs(counts[-1] - n0)
    return _record("pulsatile_poiseuille_2d", s, wall, n0=n0, gates=dict(
        count=_gate(dn, dn < 0.08 * n0, f"< {0.08 * n0:g}")),
        samples=counts)


def vp(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import vp_heat_flux_2d as v

    dtype = torch.float64 if dtype is None else dtype
    t0 = time.perf_counter()
    hf = v.build_case("heat_flux", dtype=dtype, device=device)
    n = hf.body["NReal"]
    T = v.steady_temperature(hf, torch.full((n,), v.DIFF_COEFF, dtype=dtype,
                                            device=device))
    mean_hf = float(T.mean())
    strip = float(v.boundary_averaged_temperature(hf, T))
    ss = v.build_case("same_sink", dtype=dtype, device=device)
    mean_ss = float(v.steady_temperature(ss, torch.full(
        (n,), v.DIFF_COEFF, dtype=dtype, device=device)).mean())
    k, T1, hist = v.optimize_conductivity(hf, n_steps=80)
    k2, T2, hist2 = v.optimize_conductivity(ss, n_steps=60)
    wall = time.perf_counter() - t0
    m1, s1 = float(T1.mean()), float(v.boundary_averaged_temperature(hf, T1))
    m2 = float(T2.mean())
    return dict(case="vp_heat_flux_2d", n=n, wall_s=wall, overflow=False,
                gates=dict(
                    n=_gate(n, n == 2500, "2500"),
                    steady_hf=_gate(mean_hf, abs(mean_hf - 442.74) < 0.3,
                                    "442.74 +- 0.3"),
                    strip_hotter=_gate(strip, strip > mean_hf,
                                       f"> {mean_hf:.2f}"),
                    bounds=_gate([float(T.min()), float(T.max())],
                                 T.min() > 290.0 and T.max() < 700.0,
                                 "(290, 700)"),
                    steady_ss=_gate(mean_ss, abs(mean_ss - 587.88) < 3.0,
                                    "587.88 +- 3.0"),
                    opt_hf=_gate(m1, m1 < 410.0, "< 410"),
                    opt_hf_strip=_gate(s1, s1 < 510.0, "< 510"),
                    k_mean=_gate([float(k.mean()), float(k2.mean())],
                                 abs(float(k.mean()) - 1.0) < 0.01
                                 and abs(float(k2.mean()) - 1.0) < 0.01,
                                 "1 +- 0.01"),
                    k_min=_gate(float(k.min()), float(k.min())
                                >= v.K_MIN - 1e-12, f">= {v.K_MIN}"),
                    progress=_gate([float(hist[0]), m1],
                                   hist[0] > 440.0 and m1 < hist[0] - 50.0,
                                   "first > 440, mean < first - 50"),
                    opt_ss=_gate(m2, m2 < 502.0, "< 502")),
                samples=dict(heat_flux=hist.tolist(),
                             same_sink=hist2.tolist()))


def heat_transfer(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import heat_transfer_2d as ht

    case, fluid = ht.build_case(**_kw(dtype, device=device))
    s, obs, wall = _curve(ht.make_run_chunk(case), ht.init_sim(case, fluid),
                          [0.25, 0.5, 0.75], lambda s: ht.observe_phi(case, s))
    f = s.fluid
    n = f["NReal"]
    phi = _np(f["Phi"])[:n]
    _, prof = ht.phi_profile(case, s)
    pos, u = _np(f["Position"])[:n], _np(f["Velocity"])[:n]
    centre = (pos[:, 0] < 0.0) & (np.abs(pos[:, 1] - 0.2) < 2 * case.dx)
    u_ave = 0.5 * ht.U_F * (1.0 - np.cos(np.pi * 0.75 / ht.T_RAMP))
    u_c = float(u[centre, 0].max())
    rise = float(np.diff(prof).max())
    mid = abs(prof[len(prof) // 2] - ht.PHI_FLUID_INITIAL)
    return _record("heat_transfer_2d", s, wall, n=case.n_fluid, gates=dict(
        bounds=_gate([float(phi.min()), float(phi.max())],
                     phi.min() >= ht.PHI_UPPER_WALL - 1e-3
                     and phi.max() <= ht.PHI_LOWER_WALL + 1e-3,
                     "[20 - 1e-3, 40 + 1e-3]"),
        monotone=_gate(rise, rise < 1e-6, "< 1e-6"),
        hot_layer=_gate(prof[0], prof[0] > 30.0, "> 30"),
        centreline=_gate(mid, mid < 0.05, "< 0.05"),
        observer=_gate(obs[-1], abs(obs[-1] - 20.0) < 0.01, "20 +- 0.01"),
        inflow=_gate(u_c, abs(u_c - 1.5 * u_ave) <= 0.15 * 1.5 * u_ave,
                     f"{1.5 * u_ave:.4f} +- 15%")), samples=obs)


def depolarization(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import depolarization_2d as dp

    case, body = dp.build_case(**_kw(dtype, device=device))
    s = dp.init_sim(case, body)
    idx, w = dp.voltage_observer(case, body)
    v0 = dp.observe_voltage(s, idx, w)
    s, vs, wall = _curve(dp.make_run_chunk(case), s,
                         [i * 0.1 for i in range(1, 61)],
                         lambda s: dp.observe_voltage(s, idx, w), progress=10)
    ours = np.asarray([v0] + vs)
    t_half = 0.1 * int(np.argmax(ours > 0.5))
    drop = float(np.diff(ours).min())
    finite = _finite(s.body["Voltage"])
    return _record("depolarization_2d", s, wall, n=case.n, gates=dict(
        finite=_gate(finite, finite, "finite"),
        arrival=_gate(t_half, 0.8 < t_half < 2.8, "(0.8, 2.8)"),
        monotone=_gate(drop, drop > -0.005, "> -0.005"),
        plateau=_gate(ours[-1], abs(ours[-1] - 0.9737) < 0.01,
                      "0.9737 +- 0.01")), samples=ours.tolist())


RUNS = {"throat": throat, "lid_cavity": lid_cavity, "windkessel": windkessel,
        "womersley": womersley, "buffer_count": buffer_count, "vp": vp,
        "heat_transfer": heat_transfer, "depolarization": depolarization}


def main(argv=None) -> int:
    return run_all(RUNS, argv, "a7g_fluid_diffusion_long.json",
                   __doc__.splitlines()[0], default_dtype="case")


if __name__ == "__main__":
    raise SystemExit(main())
