"""The rest of the diffusion family and the Eulerian Taylor-Green vortex
to their JAX tests' end times, each held to that test's gates:

    python -m sphinxsys_tpu_torch.benchmarks.a7i_diffusion_eulerian_long
        [--cases water,water_dtw,pkj,heart,tg] [--device cuda]
        [--dtype float32] [--out a7i_diffusion_eulerian_long.json]

  * water: water_entry_exit_2d at dx = 2 R / 20, sampled every 0.05 to
    t = 0.5 (tests/test_water_entry_exit.py:24-73): the free fall within
    2e-3 of y0 - g t^2 / 2 at t = 0.1; the deepest centre in (0.09,
    0.145) at a time in (0.22, 0.45), a rebound of 0.02 after it; x
    within 5e-3 of DL / 2; the bottom's Phi 0 before t = 0.1, above 0.9
    at the end, never falling by 1e-4, at most 1 + 1e-5;
  * water_dtw: the same case at its default dx = 2 R / 40, the centre and
    the bottom's Phi at t = i / 12.5, i = 0..12 (benchmarks/
    run_refdb_parity.py:246-287); their DTW distances to the committed
    reference curves tests/golden/refdb/water_entry_exit_2d/*.xml, each
    printed beside the JAX package's own float32 CPU distance (no gate);
  * pkj: pkj_lv_electrocontraction_3d at its default width to t = 6
    (tests/test_pkj_lv.py): the tree grown (> 30 particles, on the inner
    surface within 5%), finite voltages, the apex above 0.9, an active
    share in (0.15, 0.95), Ta above 1, the mid-wall ring shrunk below
    0.98 of its start; then on to t = 10 (the CLI's end), its readings
    printed;
  * heart: heart_electromechanics_3d at its default width to t = 2 and 5
    (tests/test_heart_electromechanics.py): unit fibers normal to the
    sheets (1e-3), the base ring below 0.1 at t = 2 and above 0.9 at
    t = 5, Ta's max in (0.7, 1.1) x 100 k_a, the ejected volume below
    -0.005 V0 at t = 2 and in (-0.45, -0.08) V0 at t = 5, falling, the
    positions finite and the base unmoved (1e-6); then on to t = 8 (the
    CLI's end), its readings printed;
  * tg: eulerian_taylor_green_2d at dx = 1 / 50, the kinetic energy every
    0.1 to t = 5, held within TG_CURVE_TOL (relative, at every sample) of
    the JAX package's own float32 CPU curve
    (tests/golden_torch/eulerian_taylor_green_2d/jax_f32_ke.json; the
    reference's ensemble database that tests/test_eulerian_taylor_green.py
    reads is not in the repository), KE(0) = 0.25 within 1e-5, the
    density within 1% of 1 at the end; the curve's decay rate printed
    beside the analytic 16 pi^2 nu.

The JAX package's float32 CPU readings of every run sit in
tests/golden_torch/<case>/jax_f32*.json, written by `JAX_PLATFORMS=cpu
PYTHONPATH=.:tests python tests/test_torch_<file>.py jax_f32` (the water
entry's, the Purkinje case's, the heart's and the Eulerian test files);
each run prints them beside its own.  Exits 1 if a run raised,
overflowed or failed a gate (the other runs go on).
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from sphinxsys_tpu_torch.benchmarks.a7bc_long import (REFDB, _curve,
                                                      _finite, _gate,
                                                      _record, run_all)
from sphinxsys_tpu_torch.benchmarks.a7e_damping_long import GOLDEN as \
    GOLDEN_TORCH

# the sampling protocols, shared with the tests' JAX float32 writers
WATER_GATE_DX_DIV = 20                        # dx = 2 R / 20
WATER_GATE_TIMES = [0.05 * i for i in range(1, 11)]
WATER_DTW_TIMES = [i / 12.5 for i in range(1, 13)]
PKJ_GATE_T, PKJ_END_T = 6.0, 10.0
HEART_TIMES = (2.0, 5.0, 8.0)
TG_TIMES = [0.1 * i for i in range(1, 51)]
# the card's float32 curve against JAX's float32 CPU curve, relative at
# every sample: a hundred times a float32 run's roundoff over ~7,000 steps
TG_CURVE_TOL = 1e-3


def jax_f32(case_dir: str, name: str = "jax_f32.json"):
    path = os.path.join(GOLDEN_TORCH, case_dir, name)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _kw(dtype, **kw):
    return dict(kw, dtype=dtype) if dtype is not None else kw


# ---------------------------------------------------------------------------
# the gates, on readings (also applied to JAX's own readings)
# ---------------------------------------------------------------------------

def water_gates(ts, xs, ys, phis) -> dict:
    """tests/test_water_entry_exit.py's four gates on the samples (t = 0
    first)."""
    from sphinxsys_tpu_torch.cases import water_entry_exit_2d as we

    ts, xs, ys, phis = (np.asarray(a, np.float64) for a in (ts, xs, ys,
                                                            phis))
    i = int(np.argmin(np.abs(ts - 0.10)))
    fall = abs(ys[i] - (we.CYL_CY - 0.5 * we.GRAVITY_G * ts[i] ** 2))
    i_min = int(np.argmin(ys))
    drift = float(np.max(np.abs(xs - we.DL / 2)))
    return dict(
        free_fall=_gate(fall, fall < 2e-3, "< 2e-3"),
        entry_depth=_gate(ys[i_min], 0.09 < ys[i_min] < 0.145,
                          "(0.09, 0.145)"),
        entry_time=_gate(ts[i_min], 0.22 < ts[i_min] < 0.45, "(0.22, 0.45)"),
        rebound=_gate(np.max(ys[i_min:]) - ys[i_min],
                      np.max(ys[i_min:]) > ys[i_min] + 0.02, "> 0.02"),
        lateral_drift=_gate(drift, drift < 5e-3, "< 5e-3"),
        phi_dry=_gate(phis[ts < 0.1].max(), phis[ts < 0.1].max() == 0.0,
                      "== 0 before t = 0.1"),
        phi_end=_gate(phis[-1], phis[-1] > 0.9, "> 0.9"),
        phi_rising=_gate(np.diff(phis).min(), np.all(np.diff(phis) > -1e-4),
                         "> -1e-4"),
        phi_max=_gate(phis.max(), phis.max() <= 1.0 + 1e-5, "<= 1 + 1e-5"))


def pkj_gates(n_pkj, tree_dev, v_finite, apex, active, ta_max, r0, r1,
              vel_finite) -> dict:
    """tests/test_pkj_lv.py's gate on the readings at t = 6."""
    return dict(
        tree=_gate(n_pkj, n_pkj > 30, "> 30 particles"),
        tree_on_surface=_gate(tree_dev, tree_dev < 0.05, "< 0.05"),
        finite=_gate(bool(v_finite and vel_finite), v_finite and vel_finite,
                     "finite"),
        apex=_gate(apex, apex > 0.9, "> 0.9"),
        active_share=_gate(active, 0.15 < active < 0.95, "(0.15, 0.95)"),
        ta=_gate(ta_max, ta_max > 1.0, "> 1"),
        contraction=_gate(r1 / r0, r1 < 0.98 * r0, "< 0.98"))


def heart_gates(fiber_norm, fiber_sheet, base2, base5, ta5, dv2, dv5,
                finite, base_moved, k_a) -> dict:
    """tests/test_heart_electromechanics.py's three gates (dv as shares of
    the initial cavity)."""
    return dict(
        fiber_unit=_gate(fiber_norm, fiber_norm < 1e-3, "< 1e-3"),
        fiber_sheet=_gate(fiber_sheet, fiber_sheet < 1e-3, "< 1e-3"),
        base_quiet_t2=_gate(base2, base2 < 0.1, "< 0.1"),
        base_active_t5=_gate(base5, base5 > 0.9, "> 0.9"),
        ta_t5=_gate(ta5, 0.7 * k_a * 100.0 < ta5 < 1.1 * k_a * 100.0,
                    f"({0.7 * k_a * 100:g}, {1.1 * k_a * 100:g})"),
        ejection_t2=_gate(dv2, dv2 < -0.005, "< -0.005"),
        ejection_t5=_gate(dv5, dv5 < dv2 and -0.45 < dv5 < -0.08,
                          "(-0.45, -0.08), below t = 2's"),
        finite=_gate(finite, finite, "finite"),
        base_fixed=_gate(base_moved, base_moved < 1e-6, "< 1e-6"))


def decay_rate(times, ke) -> float:
    """The least-squares slope of -log KE over t."""
    t, k = np.asarray(times, np.float64), np.asarray(ke, np.float64)
    return float(-np.polyfit(t, np.log(k), 1)[0])


# ---------------------------------------------------------------------------
# the runs
# ---------------------------------------------------------------------------

def water(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import water_entry_exit_2d as we

    case, fluid = we.build_case(**_kw(dtype, dx=2 * we.R_CYL
                                      / WATER_GATE_DX_DIV, device=device))
    s = we.init_sim(case, fluid)
    c0 = we.center_position(s)

    def measure(s):
        c = we.center_position(s)
        return [float(s.time), float(c[0]), float(c[1]),
                we.bottom_wetting(case, s)]

    s, samples, wall = _curve(we.make_run_chunk(case), s, WATER_GATE_TIMES,
                              measure, progress=2)
    ts, xs, ys, phis = (list(a) for a in zip([0.0, c0[0], c0[1], 0.0],
                                             *samples))
    jax = jax_f32("water_entry_exit_2d")
    if jax:
        g = jax["gate"]
        print(f"  water: JAX's float32 CPU run: min y {min(g['ys']):.4f}, "
              f"final Phi {g['phis'][-1]:.4f}; this run: min y "
              f"{min(ys):.4f}, final Phi {phis[-1]:.4f}", flush=True)
    gates = water_gates(ts, xs, ys, phis)
    gates["finite"] = _gate(_finite(s.fluid["Velocity"], s.cyl["Phi"]),
                            _finite(s.fluid["Velocity"], s.cyl["Phi"]),
                            "finite")
    return _record("water_entry_exit_2d", s, wall, n=case.n_fluid,
                   gates=gates, samples=dict(t=ts, x=xs, y=ys, phi=phis),
                   jax_f32=jax and jax["gate"])


def water_dtw(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import water_entry_exit_2d as we
    from sphinxsys_tpu_torch.io.regression import (dtw_distance,
                                                   read_result_xml)

    case, fluid = we.build_case(**_kw(dtype, device=device))
    s = we.init_sim(case, fluid)
    coms0, phi0 = we.center_position(s), we.bottom_wetting(case, s)
    s, samples, wall = _curve(
        we.make_run_chunk(case), s, WATER_DTW_TIMES,
        lambda s: (we.center_position(s).tolist(), we.bottom_wetting(case,
                                                                     s)),
        progress=3)
    coms = [coms0.tolist()] + [c for c, _ in samples]
    phis = [phi0] + [p for _, p in samples]
    db = os.path.join(REFDB, "water_entry_exit_2d")
    ref_c = read_result_xml(os.path.join(
        db, "CylinderObserver_Position_Run_0_result.xml"))[0]
    ref_p = read_result_xml(os.path.join(
        db, "WettingObserver_Phi_Run_0_result.xml"))[0]
    dist = dict(position=dtw_distance(np.asarray(coms), ref_c),
                phi=dtw_distance(np.asarray(phis), ref_p))
    jax = jax_f32("water_entry_exit_2d")
    jd = jax and jax["dtw"]["distance"]
    print(f"  water_dtw: DTW to the reference curves: this run {dist}, "
          f"JAX's float32 CPU run {jd}", flush=True)
    ok = _finite(s.fluid["Velocity"], s.cyl["Phi"])
    return _record("water_entry_exit_2d dx=2R/40", s, wall, n=case.n_fluid,
                   dtw=dist, jax_f32_dtw=jd,
                   gates=dict(finite=_gate(ok, ok, "finite")),
                   samples=dict(position=coms, phi=phis))


def pkj(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import pkj_lv_electrocontraction_3d as pk

    case, s = pk.build_case(**_kw(dtype, device=device))
    r_tree = np.linalg.norm(case.pkj_pos.double().cpu().numpy()
                            / np.asarray(pk.INNER), axis=1)
    r0 = pk.midwall_ring_radius(case, s)
    run = pk.make_run_chunk(case)

    def readings(s):
        v = s.myo["Voltage"]
        return dict(t=float(s.time), apex=pk.apex_voltage(case, s),
                    active=float((v > 0.5).double().mean()),
                    ta_max=float(s.myo["ActiveContractionStress"].max()),
                    ring=pk.midwall_ring_radius(case, s),
                    v_finite=_finite(v, s.pkj_v),
                    vel_finite=_finite(s.myo["Velocity"]))

    s, (at_gate,), wall = _curve(run, s, [PKJ_GATE_T], readings)
    gates = pkj_gates(case.n_pkj, float(np.abs(r_tree - 1.0).max()),
                      at_gate["v_finite"], at_gate["apex"],
                      at_gate["active"], at_gate["ta_max"], r0,
                      at_gate["ring"], at_gate["vel_finite"])
    s, (at_end,), wall2 = _curve(run, s, [PKJ_END_T], readings)
    jax = jax_f32("pkj_lv_electrocontraction_3d")
    print(f"  pkj: t = {PKJ_GATE_T:g}: {at_gate}; t = {PKJ_END_T:g}: "
          f"{at_end}; JAX's float32 CPU run {jax}", flush=True)
    return _record("pkj_lv_electrocontraction_3d", s, wall + wall2,
                   n=case.n_myo, n_pkj=case.n_pkj, ring0=r0, gates=gates,
                   readings={PKJ_GATE_T: at_gate, PKJ_END_T: at_end},
                   jax_f32=jax)


def heart(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import heart_electromechanics_3d as hm

    case, s = hm.build_case(**_kw(dtype, device=device))
    v0 = hm.cavity_volume0()
    base = case.base_mask
    f, sh = s.myo["Fiber"].double(), s.myo["Sheet"].double()
    fiber_norm = float((torch.linalg.vector_norm(f, dim=1) - 1.0).abs().max())
    fiber_sheet = float((f * sh).sum(1).abs().max())

    def readings(s):
        p = s.myo["Position"]
        return dict(t=float(s.time), base=hm.base_voltage(case, s),
                    ta_max=float(s.myo["ActiveContractionStress"].max()),
                    dv=float(s.dv) / v0, q=float(s.q), n_sub=s.n_sub,
                    finite=_finite(p, s.myo["Velocity"]),
                    base_moved=float((p[base] - s.myo["InitialPosition"][
                        base]).abs().max()))

    s, reads, wall = _curve(hm.make_run_chunk(case), s, list(HEART_TIMES),
                            readings)
    r2, r5 = reads[0], reads[1]
    gates = heart_gates(fiber_norm, fiber_sheet, r2["base"], r5["base"],
                        r5["ta_max"], r2["dv"], r5["dv"],
                        r2["finite"] and r5["finite"],
                        max(r2["base_moved"], r5["base_moved"]), hm.K_A)
    jax = jax_f32("heart_electromechanics_3d")
    print(f"  heart: {reads}; JAX's float32 CPU run {jax}", flush=True)
    return _record("heart_electromechanics_3d", s, wall, n=case.n,
                   gates=gates, readings=reads, jax_f32=jax)


def tg(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import eulerian_taylor_green_2d as etg

    case, fluid = etg.build_case(**_kw(dtype, device=device))
    s = etg.init_sim(case, fluid)
    ke0 = etg.kinetic_energy(s)
    s, ke, wall = _curve(etg.make_run_chunk(case), s, TG_TIMES,
                         etg.kinetic_energy, progress=10)
    jax = jax_f32("eulerian_taylor_green_2d", "jax_f32_ke.json")
    rate = decay_rate([0.0] + TG_TIMES[:len(ke)], [ke0] + ke)
    analytic = 16.0 * math.pi ** 2 * etg.MU_F / etg.RHO0_F
    gates = dict(ke0=_gate(ke0, abs(ke0 - 0.25) < 0.25e-5, "0.25 +- 1e-5"))
    if jax is not None:
        jax_rate = decay_rate(jax["t"], jax["ke"])
        ref = np.asarray(jax["ke"][1:len(ke) + 1])
        rel = float(np.max(np.abs(np.asarray(ke) - ref) / ref))
        gates["jax_curve"] = _gate(rel, rel <= TG_CURVE_TOL and len(ke) ==
                                   len(TG_TIMES), f"<= {TG_CURVE_TOL:g}")
        print(f"  tg: KE(5) {ke[-1]:.6g} (JAX's float32 CPU {ref[-1]:.6g}, "
              f"analytic {etg.analytic_kinetic_energy(5.0):.6g}); the "
              f"largest relative gap to JAX's curve {rel:.3e}; decay rate "
              f"{rate:.5f} (JAX's {jax_rate:.5f}, analytic {analytic:.5f})",
              flush=True)
    rho = s.fluid["Density"]
    drho = float((rho - 1.0).abs().max())
    gates["density"] = _gate(drho, drho < 0.01, "< 0.01")
    return _record("eulerian_taylor_green_2d", s, wall, n=case.n_fluid,
                   gates=gates, ke=[ke0] + ke, decay_rate=rate,
                   analytic_rate=analytic)


RUNS = {"water": water, "water_dtw": water_dtw, "pkj": pkj, "heart": heart,
        "tg": tg}


def main(argv=None) -> int:
    return run_all(RUNS, argv, "a7i_diffusion_eulerian_long.json",
                   __doc__.splitlines()[0])


if __name__ == "__main__":
    raise SystemExit(main())
