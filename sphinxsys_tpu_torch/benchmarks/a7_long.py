"""The articulated and free-stream cases to their JAX tests' end times,
each held to that test's gates:

    python -m sphinxsys_tpu_torch.benchmarks.a7_long
        [--cases tether_short,tether,play_simbody,stlw,filling_tank,
                 cylinder,elastic_gate] [--device cuda] [--dtype float32]
        [--out a7_long.json]

  * tether_short: tethered_fish_2d at dx = 0.15 to t = 0.5, held to
    tests/test_tethered_fish.py:43-74: no overflow, finite fields, the
    head's downstream drift q_x in (0.005, 0.5), |q_y| < 0.2,
    |theta| < 0.3, the cable's tension >= 0, the head rigid (its first
    and last particles' distance within 1e-4 of its start);
  * tether: tethered_fish_2d at its default dx = FISH_L / 100 to the
    CLI's t = 10: no overflow and finite fields; the head's drift, the
    cable's tension and the seconds taken are printed, beside the JAX
    package's own float32 CPU run of the same width
    (tests/golden_torch/tethered_fish/jax_f32_full_width.json);
  * play_simbody: play_simbody_3d's 10 steps in float64, written as XML,
    then a restart from step 5: the final q and u on the closed-form
    motions within 1e-12, the restarted steps bit for bit;
  * stlw: stlw_2d at dx = 0.05 to t = 10, the gauge at
    benchmarks/run_refdb_parity.py's 59 samples, its DTW distance to
    tests/golden/refdb/stlw_2d (the JAX package's float32 curve) within
    tests/test_refdb_parity.py's gate 0.6, printed beside the reference
    DB's own pairwise spread 0.063-0.075;
  * filling_tank: filling_tank_2d at dx = 0.025 to t = 3, held to
    tests/test_filling_tank.py: the live count within 12 of the seed +
    400 t, the mechanical energy within 5% of the reference's at t = 0.5,
    1, 2, 3, the jet on the floor and at the right wall by t = 3;
  * cylinder: flow_around_cylinder_2d at dx = 0.2 to t = 12, held to
    tests/test_flow_around_cylinder.py: the drag above 0.2 at t = 2, its
    mean past t = 5 in (0.22, 0.45), the lift below a quarter of it, the
    inlet's velocity within 0.05 of U;
  * elastic_gate: elastic_gate_2d at dx = 2.5 to t = 400, the tip every
    4: its largest opening deflection and rise within 6% of the JAX
    package's own float32 CPU curve's
    (tests/golden_torch/elastic_gate/jax_f32_tip.json; the bound of
    tests/test_elastic_gate.py against the reference DB), the gate
    relaxing back (the last deflection below 95% of the largest); the
    DTW distance of the two tip curves is printed.

Each run reports its step counts, its wall time and each gate's value
beside its bound, and writes them with the samples to --out as JSON.
Exits 1 if a run overflowed or a gate failed.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from sphinxsys_tpu_torch.device import resolve_device, resolve_dtype

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STLW_CURVE = os.path.join(ROOT, "tests", "golden", "refdb", "stlw_2d",
                          "FreeSurfaceGauge_FreeSurfaceHeight_Run_0_result.xml")
STLW_REF_SPREAD = (0.063, 0.075)      # tests/test_refdb_parity.py:112-114
GATE_CURVE = os.path.join(ROOT, "tests", "golden_torch", "elastic_gate",
                          "jax_f32_tip.json")
TETHER_JAX = os.path.join(ROOT, "tests", "golden_torch", "tethered_fish",
                          "jax_f32_full_width.json")
GATE_T_END = 400.0                    # the curve's 100 samples, every 4
FILLING_REF_E = {0.5: 0.459, 1.0: 0.852, 2.0: 1.535, 3.0: 2.099}


def _gate(value, ok, bound) -> dict:
    return dict(value=float(value), bound=bound, ok=bool(ok))


def _finite(*tensors) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def _tether(device, dtype, dx, t_end, every):
    from sphinxsys_tpu_torch.cases import tethered_fish_2d as tf

    case, fluid, fish = tf.build_case(dx=dx, dtype=dtype, device=device)
    s = tf.init_sim(case, fluid, fish)
    run = tf.make_run_chunk(case)
    com0 = tf.head_com(case, s)
    rows = []
    t0 = time.perf_counter()
    for i in range(1, round(t_end / every) + 1):
        s = run(s, i * every)
        com = tf.head_com(case, s)
        rows.append([float(s.time), *(com - com0).tolist(),
                     tf.cable_tension(case, s), *s.q.cpu().tolist(),
                     s.n_adv, s.n_ac, s.n_s])
        if bool(s.overflow):
            break
        if i % max(1, round(0.5 / every)) == 0:
            print(f"tether dx={dx:.4f} t={rows[-1][0]:.3f} n_adv={s.n_adv} "
                  f"n_s={s.n_s} drift={rows[-1][1:3]} tension="
                  f"{rows[-1][3]:.4f} wall={time.perf_counter() - t0:.1f} s",
                  flush=True)
    wall = time.perf_counter() - t0
    alive = s.fluid["Alive"]
    finite = _finite(s.fluid["Velocity"][alive], s.fish["Position"], s.q)
    rec = dict(dx=dx, t_end=t_end, t_reached=float(s.time),
               n_fluid=case.n_fluid, n_fish=case.n_fish, n_adv=s.n_adv,
               n_ac=s.n_ac, n_s=s.n_s, overflow=bool(s.overflow), wall_s=wall,
               ms_per_adv=wall / max(s.n_adv, 1) * 1e3,
               head_drift=rows[-1][1:3], cable_tension=rows[-1][3],
               q=s.q.cpu().tolist(), samples=rows)
    return case, s, rec, finite


def tether_short(device, dtype) -> dict:
    case, s, rec, finite = _tether(device, dtype, 0.15, 0.5, 0.1)
    q = s.q.cpu().numpy()
    head = case.head_mask
    p = s.fish["Position"][head].cpu().numpy()
    p0 = s.fish["InitialPosition"][head].cpu().numpy()
    d = np.linalg.norm(p[0] - p[-1])
    d0 = np.linalg.norm(p0[0] - p0[-1])
    tension = rec["cable_tension"]
    rec["gates"] = dict(
        finite=_gate(finite, finite, "finite"),
        drift_x=_gate(q[0], 0.005 < q[0] < 0.5, "(0.005, 0.5)"),
        drift_y=_gate(abs(q[1]), abs(q[1]) < 0.2, "< 0.2"),
        rotation=_gate(abs(q[2]), abs(q[2]) < 0.3, "< 0.3"),
        tension=_gate(tension, tension >= 0.0, ">= 0"),
        head_rigid=_gate(abs(d - d0), abs(d - d0) < 1e-4 * max(d0, 1.0),
                         f"< {1e-4 * max(d0, 1.0):.2e}"))
    return rec


def tether(device, dtype) -> dict:
    """The gate is the run's own: no overflow, finite fields.  The JAX
    package's own float32 CPU run of the same width
    (tests/golden_torch/tethered_fish/jax_f32_full_width.json, to its
    first overflow or its wall limit) is printed beside: its steps and
    peak speed at the port's last time, and where it stopped."""
    from sphinxsys_tpu_torch.cases import tethered_fish_2d as tf

    _, _, rec, finite = _tether(device, dtype, tf.FISH_L / 100.0, 10.0, 0.1)
    rec["gates"] = dict(finite=_gate(finite, finite, "finite"))
    if os.path.exists(TETHER_JAX):
        rows = json.load(open(TETHER_JAX))["rows"]
        near = min(rows, key=lambda r: abs(r[0] - rec["t_reached"]))
        rec["jax_f32_cpu"] = dict(
            t=near[0], n_adv=near[1], max_speed=near[2],
            last_t=rows[-1][0], last_n_adv=rows[-1][1],
            overflow_at=next((r[0] for r in rows if r[6]), None))
    return rec


def play_simbody(device, dtype) -> dict:
    """Always float64: the tree asks for it."""
    from sphinxsys_tpu_torch.cases import play_simbody_3d as ps

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        s = ps.run_case(d, device=device)
        wall = time.perf_counter() - t0
        names = [f"multibody_state_{i:06d}.xml" for i in range(6, 11)]
        first = [open(os.path.join(d, n), "rb").read() for n in names]
        r = ps.run_case(d, restart_step=5, device=device)
        again = [open(os.path.join(d, n), "rb").read() for n in names]
    q, u, _ = ps.build_motions().q_u_udot(s.t, torch.float64)
    eq = float(torch.abs(s.q - q).max() / torch.abs(q).max())
    eu = float(torch.abs(s.u - u).max() / torch.abs(u).max())
    same = first == again and torch.equal(r.q, s.q) and torch.equal(r.u, s.u)
    return dict(t=float(s.t), q=s.q.cpu().tolist(), u=s.u.cpu().tolist(),
                wall_s=wall, gates=dict(
                    q_closed_form=_gate(eq, eq <= 1e-12, "<= 1e-12"),
                    u_closed_form=_gate(eu, eu <= 1e-12, "<= 1e-12"),
                    restart_bitwise=_gate(same, same, "equal")))


def stlw(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import stlw_2d as sw
    from sphinxsys_tpu_torch.io import regression as rg

    case, fluid = sw.build_case(dtype=dtype, device=device)
    s = sw.init_sim(case, fluid)
    run = sw.make_run_chunk(case)
    series = [float(sw.free_surface_height(case, s.fluid))]
    t0 = time.perf_counter()
    for i in range(1, 59):
        s = run(s, i * 10.0 / 58)
        series.append(float(sw.free_surface_height(case, s.fluid)))
        if bool(s.overflow):
            break
    wall = time.perf_counter() - t0
    ref = rg.read_result_xml(STLW_CURVE)[0]
    dist = rg.dtw_distance(np.asarray(series), ref)
    return dict(dx=case.dx, n_fluid=case.n_fluid, t_reached=float(s.time),
                n_adv=s.n_adv, n_ac=s.n_ac, overflow=bool(s.overflow),
                wall_s=wall, ms_per_adv=wall / max(s.n_adv, 1) * 1e3,
                dtw_to_jax_curve=dist, reference_db_spread=STLW_REF_SPREAD,
                gates=dict(dtw=_gate(dist, dist < 0.6, "< 0.6")),
                samples=series)


def filling_tank(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import filling_tank_2d as ft

    case, fluid = ft.build_case(dtype=dtype, device=device)
    s = ft.init_sim(case, fluid)
    run = ft.make_run_chunk(case)
    gates, rows = {}, []
    t0 = time.perf_counter()
    for t, e_ref in sorted(FILLING_REF_E.items()):
        s = run(s, t)
        n, e = ft.n_alive(s), ft.mechanical_energy(case, s)
        expected = case.n_seed + int(round(400 * float(s.time)))
        rows.append([float(s.time), n, expected, e, e_ref])
        gates[f"alive_t{t:g}"] = _gate(n - expected, abs(n - expected) <= 12,
                                       f"|.| <= 12 of {expected}")
        gates[f"energy_t{t:g}"] = _gate(
            e, abs(e - e_ref) <= 0.05 * e_ref, f"{e_ref} +- 5%")
        if bool(s.overflow):
            break
    wall = time.perf_counter() - t0
    alive = s.fluid["Alive"]
    pos = s.fluid["Position"]
    y_min = float(torch.min(torch.where(alive, pos[:, 1], 1e9)))
    x_max = float(torch.max(torch.where(alive, pos[:, 0], -1e9)))
    gates["floor"] = _gate(y_min, y_min < case.dx, f"< {case.dx}")
    gates["right_wall"] = _gate(x_max, x_max > ft.DL - 2 * case.dx,
                                f"> {ft.DL - 2 * case.dx:.3f}")
    return dict(dx=case.dx, rows_capacity=int(pos.shape[0]),
                t_reached=float(s.time), n_adv=s.n_adv, n_ac=s.n_ac,
                overflow=bool(s.overflow), wall_s=wall,
                ms_per_adv=wall / max(s.n_adv, 1) * 1e3, gates=gates,
                samples=rows)


def cylinder(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import flow_around_cylinder_2d as fc

    case, fluid, cyl = fc.build_case(dtype=dtype, device=device)
    s = fc.init_sim(case, fluid, cyl)
    run = fc.make_run_chunk(case)
    hist = []
    t0 = time.perf_counter()
    for i in range(1, 13):
        s = run(s, float(i))
        hist.append([float(s.time), *fc.total_viscous_force(s).tolist()])
        if bool(s.overflow):
            break
    wall = time.perf_counter() - t0
    h = np.asarray(hist)
    dev = h[h[:, 0] > 5.0]
    mean = float(dev[:, 1].mean())
    lift = float(np.abs(dev[:, 2]).max())
    n = case.n_fluid
    pos, vel = s.fluid["Position"][:n], s.fluid["Velocity"][:n]
    inlet = pos[:, 0] < -0.5
    u_in = float(vel[inlet, 0].mean())
    v_in = float(vel[inlet, 1].abs().mean())
    finite = _finite(vel)
    return dict(dx=case.dx, n_fluid=n, n_cyl=s.cyl["NReal"],
                t_reached=float(s.time), n_adv=s.n_adv, n_ac=s.n_ac,
                overflow=bool(s.overflow), wall_s=wall,
                ms_per_adv=wall / max(s.n_adv, 1) * 1e3,
                gates=dict(
                    drag_t2=_gate(h[1, 1], h[1, 1] > 0.2, "> 0.2"),
                    drag_mean=_gate(mean, 0.22 < mean < 0.45, "(0.22, 0.45)"),
                    lift_max=_gate(lift, lift < 0.25 * mean,
                                   f"< {0.25 * mean:.4f}"),
                    inlet_u=_gate(u_in, abs(u_in - fc.U_F) < 0.05,
                                  "1 +- 0.05"),
                    inlet_v=_gate(v_in, v_in < 0.05, "< 0.05"),
                    finite=_gate(finite, finite, "finite")),
                samples=hist)


def elastic_gate(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import elastic_gate_2d as eg
    from sphinxsys_tpu_torch.io import regression as rg

    ref = json.load(open(GATE_CURVE))
    ref_rows = np.asarray([r[:6] for r in ref["rows"]], float)
    case, fluid, gate = eg.build_case(dtype=dtype, device=device)
    s = eg.init_sim(case, fluid, gate)
    run = eg.make_run_chunk(case)
    pts = [eg.tip_position(case, s).cpu().numpy()]
    t0 = time.perf_counter()
    every = GATE_T_END / (len(ref_rows) - 1)
    for i in range(1, len(ref_rows)):
        s = run(s, i * every)
        pts.append(eg.tip_position(case, s).cpu().numpy())
        if bool(s.overflow):
            break
        if len(pts) % 20 == 0:
            print(f"elastic_gate t={float(s.time):.1f} n_adv={s.n_adv} "
                  f"n_s={s.n_s} tip={pts[-1].tolist()} "
                  f"wall={time.perf_counter() - t0:.1f} s", flush=True)
    wall = time.perf_counter() - t0
    od = np.asarray(pts, float)
    od = od - od[0]
    rd = ref_rows[:, 1:3] - ref_rows[0, 1:3]
    dx_min, rx_min = od[:, 0].min(), rd[:, 0].min()
    dy_max, ry_max = od[:, 1].max(), rd[:, 1].max()
    return dict(dx=case.dx, n_fluid=case.n_fluid, n_gate=case.n_gate,
                t_reached=float(s.time), n_adv=s.n_adv, n_ac=s.n_ac,
                n_s=s.n_s, jax_counts=ref_rows[-1, 3:6].tolist(),
                overflow=bool(s.overflow), wall_s=wall,
                ms_per_adv=wall / max(s.n_adv, 1) * 1e3,
                dtw_to_jax_curve=rg.dtw_distance(od, rd[:len(od)]),
                gates=dict(
                    max_deflection=_gate(
                        dx_min, abs(dx_min - rx_min) < 0.06 * abs(rx_min),
                        f"{rx_min:.3f} +- 6%"),
                    max_rise=_gate(dy_max, abs(dy_max - ry_max)
                                   < 0.06 * ry_max, f"{ry_max:.3f} +- 6%"),
                    relaxes_back=_gate(abs(od[-1, 0]), abs(od[-1, 0])
                                       < 0.95 * abs(dx_min),
                                       f"< {0.95 * abs(dx_min):.3f}")),
                samples=od.tolist())


RUNS = {"tether_short": tether_short, "tether": tether,
        "play_simbody": play_simbody, "stlw": stlw,
        "filling_tank": filling_tank, "cylinder": cylinder,
        "elastic_gate": elastic_gate}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default=",".join(RUNS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--out", default="a7_long.json")
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    card = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    results, ok = {"device": card, "dtype": a.dtype}, True
    for name in a.cases.split(","):
        res = RUNS[name](device, resolve_dtype(a.dtype))
        results[name] = res
        passed = all(g["ok"] for g in res["gates"].values()) \
            and not res.get("overflow", False)
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


if __name__ == "__main__":
    raise SystemExit(main())
