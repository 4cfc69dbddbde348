"""The open-boundary and fish cases to their JAX tests' end times, each
held to that test's gates:

    python -m sphinxsys_tpu_torch.benchmarks.open_boundary_long
        [--cases fish_fsi,fish_undulation,t_pipe] [--device cuda]
        [--dtype float32] [--out open_boundary_long.json]

  * fish_fsi_2d at dx = 0.0025 to t = 1.7, the fish's centre of mass
    every 0.02 (benchmarks/run_fish_validation.py's samples), held to
    tests/test_fish_fsi.py:33-56: forward travel > 0.4 x 0.2, x at the end
    above x at half time, lateral excursion < 0.05 x 0.4, the water's
    kinetic energy finite and < 10.  The DTW distance to the committed
    curve (tests/golden/fish/, a run of the JAX package on a TPU) is
    printed, not gated, and so is the distance to the JAX package's own
    float32 run on the CPU (tests/golden_torch/fish_fsi/jax_f32_com.json);
  * fish_undulation_2d at dx = 0.0025 to t = 1.0, the tail every 0.025,
    held to tests/test_fish_undulation.py:44-68: the tail beats at 4 Hz
    +- 15% past t = 0.25, its amplitude in (0.005, 0.05), the centre of
    mass drifts < 2e-4;
  * t_pipe_2d at dx = 0.15 to t = 15, held to tests/test_t_pipe.py: the
    kinetic energy 18.28 +- 6%, the peak speed in (1.35, 1.75), the live
    count within 10% of its start, the branch fluxes upward (> 0.05) in
    the top branch and downward (< -0.05) in the bottom one.

Each run reports its step counts, its wall time and each gate's value
beside its bound, and writes them with the samples to --out as JSON.
Exits 1 if a run overflowed or a gate failed.
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
FISH_GOLDEN = os.path.join(ROOT, "tests", "golden", "fish",
                           "FishBody_CenterOfMass_Run_0_result.xml")
# the JAX package's own float32 run on the CPU, the same samples
# (`python tests/test_torch_fish.py com`)
FISH_JAX_CPU = os.path.join(ROOT, "tests", "golden_torch", "fish_fsi",
                            "jax_f32_com.json")


def _gate(value, ok, bound) -> dict:
    return dict(value=float(value), bound=bound, ok=bool(ok))


def fish_fsi(device, dtype, dx=0.0025, t_end=1.7, n_snap=85) -> dict:
    from sphinxsys_tpu_torch.cases import fish_fsi_2d as ff
    from sphinxsys_tpu_torch.io import regression as rg
    from sphinxsys_tpu_torch.physics import general as gd

    case, fluid, fish = ff.build_case(dx=dx, dtype=dtype, device=device)
    s = ff.init_sim(case, fluid, fish)
    run = ff.make_run_chunk(case)
    coms, kes, times = [], [], []
    t0 = time.perf_counter()
    for i in range(1, n_snap + 1):
        s = run(s, i * t_end / n_snap)
        coms.append(ff.fish_center_of_mass(s))
        kes.append(float(gd.total_kinetic_energy(s.fluid)))
        times.append(float(s.time))
        if bool(s.overflow) or not np.isfinite(coms[-1]).all():
            break
        if i % 5 == 0:
            print(f"fish_fsi t={times[-1]:.3f} n_adv={s.n_adv} n_ac={s.n_ac} "
                  f"n_s={s.n_s} com={coms[-1].tolist()} ke={kes[-1]:.4e} "
                  f"wall={time.perf_counter() - t0:.1f} s", flush=True)
    wall = time.perf_counter() - t0
    coms, kes = np.asarray(coms), np.asarray(kes)
    travel = coms[-1, 0] - coms[0, 0]
    n2 = len(coms) // 2
    lateral = np.abs(coms[:, 1] - coms[0, 1]).max()
    golden = rg.read_result_xml(FISH_GOLDEN)[0]
    jax_cpu = np.asarray(json.load(open(FISH_JAX_CPU))["rows"])[:, 1:3]
    m = min(len(golden), len(coms))
    return dict(
        dx=dx, t_end=t_end, t_reached=float(s.time), n_fluid=case.n_fluid,
        n_fish=case.n_fish, n_adv=s.n_adv, n_ac=s.n_ac, n_s=s.n_s,
        alive=int(s.fluid["Alive"].sum()), overflow=bool(s.overflow),
        wall_s=wall, ms_per_adv=wall / max(s.n_adv, 1) * 1e3,
        gates=dict(
            forward_travel=_gate(travel, travel > 0.4 * 0.2, "> 0.08"),
            end_beyond_half=_gate(coms[-1, 0] - coms[n2, 0],
                                  coms[-1, 0] > coms[n2, 0], "> 0"),
            lateral_excursion=_gate(lateral, lateral < 0.05 * 0.4, "< 0.02"),
            kinetic_energy_max=_gate(kes.max(), np.isfinite(kes).all()
                                     and kes.max() < 10.0, "finite, < 10")),
        dtw_to_tpu_curve=float(rg.dtw_distance(coms[:m], golden[:m])),
        dtw_to_jax_cpu_curve=float(rg.dtw_distance(coms[:m], jax_cpu[:m])),
        jax_cpu_forward_travel=float(jax_cpu[-1, 0] - jax_cpu[0, 0]),
        samples=dict(t=times, com=coms.tolist(), ke=kes.tolist()))


def fish_undulation(device, dtype, dx=0.0025, t_end=1.0,
                    every=0.025) -> dict:
    from sphinxsys_tpu_torch.cases import fish_undulation_2d as fu

    case, s = fu.build_case(dx=dx, dtype=dtype, device=device)
    run = fu.make_run_chunk(case)
    ts, tips, coms = [], [], []
    t0 = time.perf_counter()
    for i in range(1, round(t_end / every) + 1):
        s = run(s, i * every)
        ts.append(float(s.time))
        tips.append(fu.tail_lateral_displacement(case, s))
        coms.append(fu.center_of_mass(s))
        if i % 8 == 0:
            print(f"fish_undulation t={ts[-1]:.3f} steps={s.n_steps} "
                  f"tail={tips[-1]:.5f} wall={time.perf_counter() - t0:.1f} s",
                  flush=True)
    wall = time.perf_counter() - t0
    t, d, coms = np.asarray(ts), np.asarray(tips), np.asarray(coms)
    sel = t > 0.25
    cr = np.where(np.diff(np.sign(d[sel])))[0]
    tt = t[sel]
    freq = (0.5 * (len(cr) - 1) / (tt[cr[-1]] - tt[cr[0]])
            if len(cr) >= 2 else float("nan"))
    amp = np.abs(d[sel]).max() if sel.any() else float("nan")
    drift = np.linalg.norm(coms - coms[0], axis=1).max()
    return dict(
        dx=dx, t_end=t_end, t_reached=float(s.time), n_fish=case.n_fish,
        n_steps=s.n_steps, wall_s=wall,
        ms_per_step=wall / max(s.n_steps, 1) * 1e3,
        gates=dict(
            tail_frequency_hz=_gate(freq, abs(freq - 4.0) <= 0.15 * 4.0,
                                    "4 +- 15%"),
            tail_amplitude=_gate(amp, 0.005 < amp < 0.05, "(0.005, 0.05)"),
            com_drift=_gate(drift, drift < 1e-3 * 0.2, "< 2e-4")),
        samples=dict(t=ts, tail=tips, com=coms.tolist()))


def t_pipe(device, dtype, t_end=15.0, every=0.5) -> dict:
    from sphinxsys_tpu_torch.cases import t_pipe_2d as tp
    from sphinxsys_tpu_torch.physics import general as gd

    case, fluid = tp.build_case(dtype=dtype, device=device)
    s = tp.init_sim(case, fluid)
    n0 = tp.n_alive(s)
    run = tp.make_run_chunk(case)
    rows = []
    t0 = time.perf_counter()
    for i in range(1, round(t_end / every) + 1):
        s = run(s, i * every)
        rows.append([float(s.time), s.n_adv, s.n_ac, tp.n_alive(s),
                     tp.kinetic_energy(s)])
        if bool(s.overflow):
            break
    wall = time.perf_counter() - t0
    f = s.fluid
    alive = f["Alive"]
    vel, pos = f["Velocity"], f["Position"]
    vmax = float(gd.maximum_speed(f))
    up = alive & (pos[:, 1] > tp.DH + 1.0)
    down = alive & (pos[:, 1] < -1.0)
    vy_up = float(torch.sum(torch.where(up, vel[:, 1], 0.0)) / torch.sum(up))
    vy_down = float(torch.sum(torch.where(down, vel[:, 1], 0.0))
                    / torch.sum(down))
    ke = tp.kinetic_energy(s)
    n1 = tp.n_alive(s)
    return dict(
        dx=case.dx, t_end=t_end, t_reached=float(s.time), n_alive0=n0,
        n_rows=f["Position"].shape[0], n_adv=s.n_adv, n_ac=s.n_ac,
        overflow=bool(s.overflow), wall_s=wall,
        ms_per_adv=wall / max(s.n_adv, 1) * 1e3,
        gates=dict(
            kinetic_energy=_gate(ke, abs(ke - 18.28) <= 0.06 * 18.28,
                                 "18.28 +- 6%"),
            peak_speed=_gate(vmax, 1.35 < vmax < 1.75, "(1.35, 1.75)"),
            alive_change=_gate(n1 - n0, abs(n1 - n0) < 0.1 * n0,
                               f"|.| < {0.1 * n0:.1f}"),
            vy_top_branch=_gate(vy_up, vy_up > 0.05, "> 0.05"),
            vy_bottom_branch=_gate(vy_down, vy_down < -0.05, "< -0.05")),
        samples=rows)


RUNS = {"fish_fsi": fish_fsi, "fish_undulation": fish_undulation,
        "t_pipe": t_pipe}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default=",".join(RUNS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--out", default="open_boundary_long.json")
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
        print(f"{name}: gates {'pass' if passed else 'FAIL'}", flush=True)
        with open(a.out, "w") as f:
            json.dump(results, f)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
