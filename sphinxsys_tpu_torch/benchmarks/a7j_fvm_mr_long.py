"""The FVM cases and the multi-resolution family to their JAX tests' end
times, each held to that test's gates:

    python -m sphinxsys_tpu_torch.benchmarks.a7j_fvm_mr_long
        [--cases fvm_drag,fvm_golden,bow_shock,sod,dmr,tg_mr,mr_beam,
                 mr_tank,mr_cylinder] [--device cuda] [--dtype float32]
        [--out a7j_fvm_mr_long.json]

  * fvm_drag: fvm_cylinder_2d at nr = 16, nt = 32, r_far = 10 to t = 20
    (tests/test_fvm.py:131-152): finite, |rho - 1| < 0.1, the wake's mean
    u behind the cylinder below 0.75, the mean speed at its sides above
    1, the drag coefficient in (0.5, 6);
  * fvm_golden: fvm_cylinder_2d at its default 48 x 96 O-grid, the
    streamwise force every 2 to t = 60, held by the port's
    DTWRegressionTest to tests/golden/fvm_cylinder_2d
    (tests/test_golden_regression.py:282-297), beside the distances of
    JAX's own float32 runs from a start velocity scaled by 1 + 1e-7 and
    1 + 1e-6 (the shedding is chaotic: ROADMAP C);
  * bow_shock: supersonic_cylinder_2d at nr = 28, nt = 72 to t = 15
    (tests/test_fvm.py:155-186): the nose density 3.1 within 12%, its
    pressure 5.64 p_far within 15%, the upstream free stream within 0.05,
    the shock's crossing of 1.8 rho on the stagnation line in
    (-2.5, -1.1);
  * sod: the Sod tube on rect_grid(200, 4, 1, 0.02) to t = 0.2, the
    first-order and the MUSCL step (tests/test_fvm.py:189-237): MUSCL's
    L1(rho) error below 0.85 of first order's and below 0.027, its
    density in (0.124, 1.001);
  * dmr: double_mach_reflection_2d at 240 x 60 to t = 0.2
    (tests/test_fvm.py:240-263): rho finite and above 1.35, the Mach
    stem's foot in (2.55, 3.05), the density peak in (15, 35), the zone
    ahead of the top shock within 0.05 of the pre-shock density;
  * tg_mr: taylor_green_mr_2d at its default width, max |v| every 0.1 to
    t = 0.4 within (0.82, 1.12) of the analytic viscous decay
    (tests/test_tg_mr.py), no overflow, finite pressure;
  * mr_beam: mr_cantilever_beam_2d at its default width, the tip every
    0.01 to t = 0.16 (tests/test_mr_beam.py): amplitude in (0.08, 0.15),
    the first zero crossing in (0.11, 0.17);
  * mr_tank: the MR hydrostatic tank of tests/test_fluid_adaptive_wall.py
    (a 2x-refined band above a periodic bottom wall under gravity, 30
    advection steps): the speed below 0.06 sqrt(g H), the pressure's
    slope within 20% of -rho g, its fit residual below 0.08 rho g H;
  * mr_cylinder: mr_cylinder_2d at its default width with its body-fitted
    start: at t = 3 (tests/test_mr_cylinder.py:13-50) no overflow, the
    speed near the cylinder below 1.6, the viscous drag above 0.05 and
    the lift below 0.2 of it, the strip's ratios kept; then the viscous
    drag every 0.5 to t = 30 (:53-75): after t = 12 within (0.27, 0.41),
    its mean in [0.30, 0.38], the mean |lift| below 0.1 of it; the
    committed TPU curve tests/golden/mr_cylinder/drag_tpu_r4.npy printed
    beside.

The JAX package's float32 CPU readings of every run sit in
tests/golden_torch/a7j/jax_f32.json, written by `JAX_PLATFORMS=cpu
PYTHONPATH=.:tests python tests/test_torch_mr_cases.py jax_f32`; each run
prints them beside its own.  Exits 1 if a run raised, overflowed or
failed a gate (the other runs go on).
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from sphinxsys_tpu_torch.benchmarks.a7bc_long import (GOLDEN, _curve,
                                                      _finite, _gate,
                                                      _record, run_all)
from sphinxsys_tpu_torch.benchmarks.a7e_damping_long import GOLDEN as \
    GOLDEN_TORCH

# the sampling protocols, shared with the JAX float32 writer
FVM_DRAG = dict(nr=16, nt=32, r_far=10.0, t_end=20.0)
FVM_GOLDEN_TIMES = [2.0 * i for i in range(1, 31)]
BOW = dict(nr=28, nt=72, t_end=15.0)
SOD = dict(nx=200, ny=4, lx=1.0, ly=0.02, t_end=0.2)
DMR = dict(nx=240, ny=60, t_end=0.2)
TG_MR_TIMES = [0.1 * i for i in range(1, 5)]
MR_BEAM_TIMES = [0.01 * i for i in range(1, 17)]
MR_TANK_STEPS = 30
MR_CYL_START_T = 3.0
MR_CYL_TIMES = [0.5 * i for i in range(1, 61)]
JAX_F32 = os.path.join(GOLDEN_TORCH, "a7j", "jax_f32.json")


def jax_f32(name: str):
    if not os.path.exists(JAX_F32):
        return None
    with open(JAX_F32) as f:
        return json.load(f).get(name)


def _kw(dtype, **kw):
    return dict(kw, dtype=dtype) if dtype is not None else kw


def _np(x):
    return x.detach().double().cpu().numpy() if torch.is_tensor(x) \
        else np.asarray(x, np.float64)


def _beside(name, mine):
    print(f"  {name}: this run {mine}; JAX's float32 CPU run "
          f"{jax_f32(name)}", flush=True)


# ---------------------------------------------------------------------------
# the readings and gates, on numpy (the JAX writer feeds its own runs)
# ---------------------------------------------------------------------------

def fvm_drag_readings(centroids, v, rho, cd) -> dict:
    c = np.asarray(centroids)
    behind = (np.abs(c[:, 1]) < 1.0) & (c[:, 0] > 1.5) & (c[:, 0] < 4.0)
    side = (np.abs(c[:, 0]) < 1.0) & (np.abs(c[:, 1]) > 1.2) \
        & (np.abs(c[:, 1]) < 3.0)
    return dict(finite=bool(np.isfinite(v).all() and np.isfinite(rho).all()),
                rho_dev=float(np.abs(rho - 1.0).max()),
                wake=float(v[behind, 0].mean()),
                side=float(np.linalg.norm(v[side], axis=1).mean()),
                cd=float(cd))


def fvm_drag_gates(r) -> dict:
    return dict(finite=_gate(r["finite"], r["finite"], "finite"),
                weakly_compressible=_gate(r["rho_dev"], r["rho_dev"] < 0.1,
                                          "< 0.1"),
                wake=_gate(r["wake"], r["wake"] < 0.75, "< 0.75"),
                side=_gate(r["side"], r["side"] > 1.0, "> 1"),
                cd=_gate(r["cd"], 0.5 < r["cd"] < 6.0, "(0.5, 6)"))


def bow_readings(centroids, rho, p, nose_rho, nose_p) -> dict:
    c = np.asarray(centroids)
    upstream = (np.abs(c[:, 1]) < 0.3) & (c[:, 0] < -4.0) & (c[:, 0] > -8.0)
    line = (np.abs(c[:, 1]) < 0.15) & (c[:, 0] < -1.0)
    xs, rr = c[line, 0], rho[line]
    order = np.argsort(xs)
    xs, rr = xs[order], rr[order]
    hit = np.nonzero(rr > 1.8)[0]
    return dict(positive=bool(np.isfinite(rho).all() and (rho > 0).all()
                              and (p > 0).all()),
                nose_rho=float(nose_rho), nose_p=float(nose_p),
                upstream=float(np.abs(rho[upstream] - 1.0).max()),
                crossing=float(xs[hit[0]]) if len(hit) else float("nan"))


def bow_gates(r, p_far) -> dict:
    return dict(
        positive=_gate(r["positive"], r["positive"], "finite, > 0"),
        nose_rho=_gate(r["nose_rho"], abs(r["nose_rho"] - 3.1) <= 0.12 * 3.1,
                       "3.1 +- 12%"),
        nose_p=_gate(r["nose_p"], abs(r["nose_p"] - 5.64 * p_far)
                     <= 0.15 * 5.64 * p_far, "5.64 p_far +- 15%"),
        upstream=_gate(r["upstream"], r["upstream"] < 0.05, "< 0.05"),
        crossing=_gate(r["crossing"], -2.5 < r["crossing"] < -1.1,
                       "(-2.5, -1.1)"))


def sod_exact(x, t, x0=0.5, gamma=1.4):
    """The exact Sod density for left (1, 0, 1), right (0.125, 0, 0.1)
    (the JAX tests' own, tests/test_compressible_eulerian.py:19-63)."""
    rho_l, p_l, rho_r, p_r = 1.0, 1.0, 0.125, 0.1
    g = gamma
    c_l = math.sqrt(g * p_l / rho_l)
    c_r = math.sqrt(g * p_r / rho_r)

    def f(p, rho_k, p_k, c_k):
        if p > p_k:
            A = 2.0 / ((g + 1) * rho_k)
            B = (g - 1) / (g + 1) * p_k
            return (p - p_k) * math.sqrt(A / (p + B))
        return 2 * c_k / (g - 1) * ((p / p_k) ** ((g - 1) / (2 * g)) - 1)

    p = 0.3
    for _ in range(60):
        fl, fr = f(p, rho_l, p_l, c_l), f(p, rho_r, p_r, c_r)
        dfl = (f(p + 1e-8, rho_l, p_l, c_l) - fl) / 1e-8
        dfr = (f(p + 1e-8, rho_r, p_r, c_r) - fr) / 1e-8
        p -= (fl + fr) / (dfl + dfr)
    u_star = 0.5 * (f(p, rho_r, p_r, c_r) - f(p, rho_l, p_l, c_l))
    rho_star_l = rho_l * (p / p_l) ** (1 / g)
    c_star_l = math.sqrt(g * p / rho_star_l)
    rho_star_r = rho_r * ((p / p_r + (g - 1) / (g + 1))
                          / ((g - 1) / (g + 1) * p / p_r + 1))
    s_shock = u_star + c_r * math.sqrt((g + 1) / (2 * g) * p / p_r
                                       + (g - 1) / (2 * g))
    rho = np.empty_like(x)
    for i, s in enumerate((x - x0) / t):
        if s < -c_l:
            rho[i] = rho_l
        elif s < u_star - c_star_l:
            u = 2 / (g + 1) * (c_l + s)
            c = c_l - (g - 1) / 2 * u
            rho[i] = rho_l * (c / c_l) ** (2 / (g - 1))
        elif s < u_star:
            rho[i] = rho_star_l
        elif s < s_shock:
            rho[i] = rho_star_r
        else:
            rho[i] = rho_r
    return rho


def sod_readings(x, rho_first, rho_muscl, t) -> dict:
    exact = sod_exact(np.asarray(x), t)
    return dict(l1_first=float(np.abs(rho_first - exact).mean()),
                l1_muscl=float(np.abs(rho_muscl - exact).mean()),
                muscl_min=float(rho_muscl.min()),
                muscl_max=float(rho_muscl.max()))


def sod_gates(r) -> dict:
    return dict(
        sharper=_gate(r["l1_muscl"] / r["l1_first"],
                      r["l1_muscl"] < 0.85 * r["l1_first"], "< 0.85"),
        l1=_gate(r["l1_muscl"], r["l1_muscl"] < 0.027, "< 0.027"),
        limited=_gate([r["muscl_min"], r["muscl_max"]],
                      r["muscl_min"] > 0.124 and r["muscl_max"] < 1.001,
                      "(0.124, 1.001)"))


def dmr_readings(centroids, rho, stem, x_s_top) -> dict:
    c = np.asarray(centroids)
    quiet = c[:, 0] > x_s_top + 0.3
    return dict(finite=bool(np.isfinite(rho).all()),
                rho_min=float(rho.min()), rho_max=float(rho.max()),
                stem=float(stem),
                quiet=float(np.abs(rho[quiet] - 1.4).max())
                if quiet.any() else 0.0)


def dmr_gates(r) -> dict:
    return dict(
        finite=_gate(r["finite"], r["finite"], "finite"),
        rho_min=_gate(r["rho_min"], r["rho_min"] > 1.35, "> 1.35"),
        stem=_gate(r["stem"], 2.55 < r["stem"] < 3.05, "(2.55, 3.05)"),
        rho_peak=_gate(r["rho_max"], 15.0 < r["rho_max"] < 35.0, "(15, 35)"),
        quiet=_gate(r["quiet"], r["quiet"] < 0.05, "< 0.05"))


def tg_mr_gates(ratios, overflow, p_finite) -> dict:
    ratios = list(map(float, ratios))
    return dict(decay=_gate(ratios, all(0.82 < r < 1.12 for r in ratios)
                            and len(ratios) == len(TG_MR_TIMES),
                            "(0.82, 1.12) at each t"),
                overflow=_gate(overflow, not overflow, "no overflow"),
                pressure=_gate(p_finite, p_finite, "finite"))


def mr_beam_readings(ts, ys) -> dict:
    t, y = np.asarray(ts), np.asarray(ys)
    cross = np.nonzero((y[:-1] > 0) & (y[1:] <= 0))[0]
    if len(cross) == 0:
        cross = np.nonzero((y[:-1] < 0) & (y[1:] >= 0))[0]
    return dict(finite=bool(np.isfinite(y).all()),
                amplitude=float(np.abs(y).max()),
                t_cross=float(t[cross[0]]) if len(cross) else float("nan"))


def mr_beam_gates(r) -> dict:
    return dict(finite=_gate(r["finite"], r["finite"], "finite"),
                amplitude=_gate(r["amplitude"],
                                0.08 < r["amplitude"] < 0.15, "(0.08, 0.15)"),
                first_crossing=_gate(r["t_cross"],
                                     0.11 < r["t_cross"] < 0.17,
                                     "(0.11, 0.17)"))


def mr_tank_readings(u, p, y, rho0, g, H) -> dict:
    u_scale = math.sqrt(g * H)
    interior = (y > 0.05) & (y < H - 0.1)
    slope, intercept = np.polyfit(y[interior], p[interior], 1)
    resid = p[interior] - (slope * y[interior] + intercept)
    return dict(speed=float(np.linalg.norm(u, axis=1).max() / u_scale),
                slope=float(slope / (-rho0 * g)),
                resid=float(np.abs(resid).max() / (rho0 * g * H)))


def mr_tank_gates(r, overflow) -> dict:
    return dict(at_rest=_gate(r["speed"], r["speed"] < 0.06,
                              "< 0.06 sqrt(g H)"),
                slope=_gate(r["slope"], abs(r["slope"] - 1.0) < 0.2,
                            "-rho g within 20%"),
                residual=_gate(r["resid"], r["resid"] < 0.08,
                               "< 0.08 rho g H"),
                overflow=_gate(overflow, not overflow, "no overflow"))


def mr_cyl_start_readings(pos, v, hr, fv, cx, cy) -> dict:
    sp = np.linalg.norm(v, axis=1)
    near = np.hypot(pos[:, 0] - cx, pos[:, 1] - cy) < 2.0
    deep = (pos[:, 1] > 6.0) & (pos[:, 1] < 10.0)
    outside = (pos[:, 1] < 4.0) | (pos[:, 1] > 12.0)
    return dict(finite=bool(np.isfinite(v).all()),
                near_speed=float(sp[near].max()), fv_x=float(fv[0]),
                fv_y=float(fv[1]),
                hr_deep=float(np.abs(hr[deep] - 2.0).max()),
                hr_outside=float(np.abs(hr[outside] - 1.0).max()))


def mr_cyl_drag_readings(ts, fx, fy) -> dict:
    t, fx, fy = (np.asarray(a, np.float64) for a in (ts, fx, fy))
    tail = fx[t > 12.0]
    return dict(t_end=float(t[-1]), tail_min=float(tail.min()),
                tail_max=float(tail.max()), tail_mean=float(tail.mean()),
                lift=float(np.abs(fy[t > 12.0]).mean()))


def mr_cyl_gates(start, drag, overflow) -> dict:
    return dict(
        overflow=_gate(overflow, not overflow, "no overflow"),
        finite=_gate(start["finite"], start["finite"], "finite"),
        near_speed=_gate(start["near_speed"], start["near_speed"] < 1.6,
                         "< 1.6 at t = 3"),
        drag_t3=_gate(start["fv_x"], start["fv_x"] > 0.05, "> 0.05"),
        lift_t3=_gate(abs(start["fv_y"]),
                      abs(start["fv_y"]) < 0.2 * start["fv_x"],
                      "< 0.2 drag"),
        strip=_gate(max(start["hr_deep"], start["hr_outside"]),
                    start["hr_deep"] < 1e-6 and start["hr_outside"] < 1e-6,
                    "< 1e-6"),
        reached=_gate(drag["t_end"], drag["t_end"] >= 29.0, ">= 29"),
        band=_gate([drag["tail_min"], drag["tail_max"]],
                   drag["tail_min"] > 0.27 and drag["tail_max"] < 0.41,
                   "(0.27, 0.41) after t = 12"),
        mean=_gate(drag["tail_mean"], 0.30 <= drag["tail_mean"] <= 0.38,
                   "[0.30, 0.38]"),
        lift=_gate(drag["lift"], drag["lift"] < 0.1 * drag["tail_mean"],
                   "< 0.1 mean drag"))


# ---------------------------------------------------------------------------
# the runs
# ---------------------------------------------------------------------------

def fvm_drag(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import fvm_cylinder_2d as fc

    case, fluid = fc.build_case(**_kw(dtype, nr=FVM_DRAG["nr"],
                                      nt=FVM_DRAG["nt"],
                                      r_far=FVM_DRAG["r_far"],
                                      device=device))
    s, _, wall = _curve(fc.make_run_chunk(case), fc.init_sim(case, fluid),
                        [FVM_DRAG["t_end"]], lambda s: None)
    r = fvm_drag_readings(case.mesh.centroids, _np(s.fluid["Velocity"]),
                          _np(s.fluid["Density"]),
                          fc.drag_coefficient(case, s))
    _beside("fvm_drag", r)
    return _record("fvm_cylinder_2d 16 x 32", s, wall,
                   n_cells=case.dm.n_cells, readings=r,
                   gates=fvm_drag_gates(r), jax_f32=jax_f32("fvm_drag"))


def fvm_golden(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import fvm_cylinder_2d as fc
    from sphinxsys_tpu_torch.io.regression import DTWRegressionTest

    case, fluid = fc.build_case(**_kw(dtype, device=device))
    s, fx, wall = _curve(fc.make_run_chunk(case), fc.init_sim(case, fluid),
                         FVM_GOLDEN_TIMES,
                         lambda s: float(fc.cylinder_force(case, s)[0]),
                         progress=5)
    test = DTWRegressionTest(os.path.join(GOLDEN, "fvm_cylinder_2d"),
                             "WaterBody", "ForceOnCylinderX")
    ok, report = test.test(np.asarray(fx))
    dist = [float(d) for d in np.ravel(test.distances(np.asarray(fx)))]
    _beside("fvm_golden", dict(distance=dist, fx_end=fx[-1]))
    # the shedding is chaotic: JAX's own float32 run from a velocity
    # scaled by 1 + eps parts from the curve it wrote
    print(f"  fvm_golden: JAX's float32 CPU runs from u (1 + eps): "
          f"{jax_f32('fvm_golden_perturbed')}", flush=True)
    return _record("fvm_cylinder_2d 48 x 96", s, wall,
                   n_cells=case.dm.n_cells, dtw_report=str(report),
                   distance=dist, samples=fx,
                   gates=dict(dtw=_gate(ok, ok, "DTWRegressionTest")),
                   jax_f32=jax_f32("fvm_golden"))


def bow_shock(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import supersonic_cylinder_2d as sc

    case, fluid = sc.build_case(**_kw(dtype, nr=BOW["nr"], nt=BOW["nt"],
                                      device=device))
    s, _, wall = _curve(sc.make_run_chunk(case), sc.init_sim(case, fluid),
                        [BOW["t_end"]], lambda s: None)
    r = bow_readings(case.mesh.centroids, _np(s.fluid["Density"]),
                     _np(s.fluid["Pressure"]), *sc.stagnation_state(case, s))
    _beside("bow_shock", r)
    return _record("supersonic_cylinder_2d 28 x 72", s, wall,
                   n_cells=case.dm.n_cells, readings=r,
                   gates=bow_gates(r, sc.P_FAR),
                   jax_f32=jax_f32("bow_shock"))


def sod(device, dtype) -> dict:
    import time as _time

    from sphinxsys_tpu_torch.core.materials import CompressibleFluid
    from sphinxsys_tpu_torch.fvm import dynamics as fv
    from sphinxsys_tpu_torch.fvm.mesh import compile_mesh
    from sphinxsys_tpu_torch.fvm.meshgen import rect_grid

    dtype = dtype or torch.float32
    mesh = compile_mesh(rect_grid(SOD["nx"], SOD["ny"], SOD["lx"],
                                  SOD["ly"]))
    dm = fv.to_device(mesh, dtype, device)
    gas = CompressibleFluid(gamma=1.4)
    x = mesh.centroids[:, 0]
    far = fv.FarField(rho=1.0, vel=(0.0, 0.0), p=1.0)
    target = torch.tensor(SOD["t_end"], dtype=dtype, device=device)
    rhos, steps, t0 = [], [], _time.perf_counter()
    for step_fn in (fv.compressible_step, fv.compressible_step_muscl):
        st = {"Density": torch.as_tensor(np.where(x < 0.5, 1.0, 0.125),
                                         dtype=dtype, device=device),
              "Velocity": torch.zeros((dm.n_cells, 2), dtype=dtype,
                                      device=device),
              "Pressure": torch.as_tensor(np.where(x < 0.5, 1.0, 0.1),
                                          dtype=dtype, device=device)}
        st["TotalEnergyDensity"] = st["Pressure"] / (gas.gamma - 1.0)
        t, n = torch.zeros((), dtype=dtype, device=device), 0
        while bool(t < target):               # one host read a step
            dt = fv.compressible_time_step_fvm(st, gas, dm, cfl=0.3)
            st, t, n = step_fn(st, dm, gas, far, dt), t + dt, n + 1
        rhos.append(_np(st["Density"]))
        steps.append(n)
    wall = _time.perf_counter() - t0
    r = sod_readings(x, rhos[0], rhos[1], SOD["t_end"])
    _beside("sod", r)
    return dict(case="sod tube 200 x 4", n_cells=dm.n_cells,
                n_steps=steps, t_reached=float(t), overflow=False,
                wall_s=wall, ms_per_step=wall / sum(steps) * 1e3,
                readings=r, gates=sod_gates(r), jax_f32=jax_f32("sod"))


def dmr(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import double_mach_reflection_2d as dm_

    case, fluid = dm_.build_case(**_kw(dtype, nx=DMR["nx"], ny=DMR["ny"],
                                       device=device))
    s, _, wall = _curve(dm_.make_run_chunk(case), dm_.init_sim(case, fluid),
                        [DMR["t_end"]], lambda s: None)
    x_s_top = dm_.X0 + DMR["t_end"] * dm_.SHOCK_SPEED_X + dm_.DH / dm_.TAN60
    r = dmr_readings(case.mesh.centroids, _np(s.fluid["Density"]),
                     dm_.wall_shock_position(case, s), x_s_top)
    _beside("dmr", r)
    return _record("double_mach_reflection_2d 240 x 60", s, wall,
                   n_cells=case.dm.n_cells, readings=r, gates=dmr_gates(r),
                   jax_f32=jax_f32("dmr"))


def tg_mr(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import taylor_green_mr_2d as tg

    case, fluid = tg.build_case(**_kw(dtype, device=device))
    s = tg.init_sim(case, fluid)
    v0 = tg.max_speed(s)
    s, samples, wall = _curve(tg.make_run_chunk(case), s, TG_MR_TIMES,
                              lambda s: (float(s.time), tg.max_speed(s)))
    ratios = [v / (v0 * math.exp(-8 * math.pi ** 2 * tg.MU_F * t))
              for t, v in samples]
    _beside("tg_mr", dict(ratios=ratios))
    return _record("taylor_green_mr_2d", s, wall, n=case.n_fluid,
                   ratios=ratios,
                   gates=tg_mr_gates(ratios, bool(s.overflow),
                                     _finite(s.fluid["Pressure"])),
                   jax_f32=jax_f32("tg_mr"))


def mr_beam(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import mr_cantilever_beam_2d as mb

    case, s = mb.build_case(**_kw(dtype, device=device))
    s, tips, wall = _curve(mb.make_run_chunk(case), s, MR_BEAM_TIMES,
                           lambda s: (float(s.time),
                                      mb.tip_displacement(case, s)))
    r = mr_beam_readings([t for t, _ in tips], [y for _, y in tips])
    _beside("mr_beam", r)
    return _record("mr_cantilever_beam_2d", s, wall, n_solid=case.n_solid,
                   readings=r, gates=mr_beam_gates(r), samples=tips,
                   jax_f32=jax_f32("mr_beam"))


# the MR hydrostatic tank (tests/test_fluid_adaptive_wall.py)
TANK = dict(L=1.0, H=0.6, dx=0.05, g=9.81, y_fine=0.2, ramp0=0.1)


def mr_tank(device, dtype) -> dict:
    from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
    from sphinxsys_tpu_torch.core.materials import WeaklyCompressibleFluid
    from sphinxsys_tpu_torch.core.state import (make_fluid_state,
                                                make_solid_state)
    from sphinxsys_tpu_torch.neighbors.multilevel import (
        build_adaptive_neighbor_list, build_multilevel_tables)
    from sphinxsys_tpu_torch.physics import fluid as fd
    from sphinxsys_tpu_torch.physics import fluid_adaptive as fa
    from sphinxsys_tpu_torch.physics import riemann as rs

    dtype = dtype or torch.float32
    L, H, dx, g = TANK["L"], TANK["H"], TANK["dx"], TANK["g"]
    y_fine, ramp0 = TANK["y_fine"], TANK["ramp0"]
    rho0, c0 = 1000.0, 10.0 * (g * H) ** 0.5
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    xs_c = np.arange(dx / 2, L, dx)
    ys_c = np.arange(y_fine + dx / 2, H, dx)
    pos_c = np.stack(np.meshgrid(xs_c, ys_c, indexing="ij"), -1).reshape(-1, 2)
    xs_f = np.arange(dx / 4, L, dx / 2)
    ys_f = np.arange(dx / 4, y_fine, dx / 2)
    pos_f = np.stack(np.meshgrid(xs_f, ys_f, indexing="ij"), -1).reshape(-1, 2)
    pos = np.concatenate([pos_c, pos_f])
    vols = np.concatenate([np.full(len(pos_c), dx * dx),
                           np.full(len(pos_f), (dx / 2) ** 2)])
    hr = np.concatenate([
        np.ones(len(pos_c)),
        1.0 + np.clip((y_fine - pos_f[:, 1]) / (y_fine - ramp0), 0.0, 1.0)])

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    fluid = make_fluid_state(pos, vols, rho0, dtype, device)
    fluid["SmoothingLengthRatio"] = t(hr)
    eos = WeaklyCompressibleFluid(rho0=rho0, c0=c0)
    p_hydro = rho0 * g * (H - pos[:, 1])
    fluid["Pressure"] = t(p_hydro)
    fluid["Density"] = t(eos.density_from_pressure(p_hydro))
    gvec = torch.zeros_like(fluid["Velocity"])
    gvec[:, 1] = -g
    fluid["ForcePrior"] = gvec * fluid["Mass"][:, None]
    fluid["ViscousForce"] = torch.zeros_like(fluid["Velocity"])
    fluid["ViscousForcePrev"] = torch.zeros_like(fluid["Velocity"])

    dxw = dx / 2
    wx = np.arange(dxw / 2, L, dxw)
    wy = np.arange(dxw / 2, 4 * dx, dxw)
    wpos = np.stack(np.meshgrid(wx, -wy, indexing="ij"), -1).reshape(-1, 2)
    wall = make_solid_state(wpos, dxw * dxw, rho0, dtype, device)
    wall["NormalDirection"] = t(np.tile([0.0, 1.0], (len(wpos), 1)))
    wall["SmoothingLengthRatio"] = torch.full((len(wpos),), 2.0, dtype=dtype,
                                              device=device)
    h_ref = adaptation.h
    lo, hi = (0.0, -4.5 * dx), (L, H + 2 * dx)
    ml_wall = build_multilevel_tables(wall["Position"], len(wpos),
                                      wall["SmoothingLengthRatio"], lo, hi,
                                      h_ref, n_levels=2, cap=48,
                                      periodic=(True, False))
    box = (L, 0.0)
    riem = rs.acoustic_riemann(eos)
    kernel = adaptation.kernel
    n = len(pos)

    def advect(f):
        ml = build_multilevel_tables(f["Position"], n,
                                     f["SmoothingLengthRatio"], lo, hi, h_ref,
                                     n_levels=2, cap=48,
                                     periodic=(True, False))
        nl = build_adaptive_neighbor_list(
            f["Position"], n, f["SmoothingLengthRatio"], f["Position"],
            f["SmoothingLengthRatio"], ml, 2.0, h_ref,
            k_max_per_level=[96, 128], box=box)
        nlw = build_adaptive_neighbor_list(
            f["Position"], n, f["SmoothingLengthRatio"], wall["Position"],
            wall["SmoothingLengthRatio"], ml_wall, 2.0, h_ref,
            k_max_per_level=[48, 64], include_self=True, box=box)
        h_fine = h_ref / 2.0
        dt_adv = fd.advection_time_step(f, h_fine, (g * H) ** 0.5)
        f = fa.density_summation_adaptive(f, nl, kernel, 2, rho0, box=box,
                                          wall=wall, nl_wall=nlw,
                                          free_surface=True)
        rt = torch.zeros_like(dt_adv)
        while bool(rt < dt_adv):
            dt = torch.minimum(fd.acoustic_time_step(f, eos, h_fine), dt_adv)
            f = fa.acoustic_step_1st_half_adaptive(f, nl, kernel, 2, eos,
                                                   riem, dt, box=box,
                                                   wall=wall, nl_wall=nlw)
            f = fa.acoustic_step_2nd_half_adaptive(f, nl, kernel, 2, riem, dt,
                                                   box=box, wall=wall,
                                                   nl_wall=nlw)
            rt = rt + dt
        return f, nl.overflow | nlw.overflow

    import time as _time

    t0 = _time.perf_counter()
    f, overflow = fluid, False
    for _ in range(MR_TANK_STEPS):
        f, ovf = advect(f)
        overflow |= bool(ovf)
    wall_s = _time.perf_counter() - t0
    r = mr_tank_readings(_np(f["Velocity"]), _np(f["Pressure"]),
                         _np(f["Position"])[:, 1], rho0, g, H)
    _beside("mr_tank", r)
    return dict(case="MR hydrostatic tank", n=n, n_adv=MR_TANK_STEPS,
                overflow=overflow, wall_s=wall_s,
                ms_per_step=wall_s / MR_TANK_STEPS * 1e3, readings=r,
                gates=mr_tank_gates(r, overflow),
                jax_f32=jax_f32("mr_tank"))


def mr_cylinder(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import mr_cylinder_2d as mc

    case, fluid = mc.build_case(**_kw(dtype, device=device))
    s = mc.init_sim(case, fluid)
    run = mc.make_run_chunk(case)
    s, _, wall0 = _curve(run, s, [MR_CYL_START_T], lambda s: None)
    al = s.fluid["Alive"]
    start = mr_cyl_start_readings(
        _np(s.fluid["Position"][al]), _np(s.fluid["Velocity"][al]),
        _np(s.fluid["SmoothingLengthRatio"][al]),
        _np(mc.cylinder_forces(case, s)[0]), mc.CX, mc.CY)
    times = [t for t in MR_CYL_TIMES if t > MR_CYL_START_T]

    def measure(s):
        fv, _ = mc.cylinder_forces(case, s)
        return float(s.time), float(fv[0]), float(fv[1])

    s, samples, wall = _curve(run, s, times, measure, progress=10)
    drag = mr_cyl_drag_readings(*zip(*samples))
    golden = np.load(os.path.join(GOLDEN, "mr_cylinder", "drag_tpu_r4.npy"))
    ref = mr_cyl_drag_readings(golden[:, 0], golden[:, 1], golden[:, 2])
    _beside("mr_cylinder", dict(start=start, drag=drag))
    print(f"  mr_cylinder: the committed TPU curve: {ref}", flush=True)
    return _record("mr_cylinder_2d", s, wall0 + wall, n=case.n_fluid,
                   n_alive=mc.n_alive(s), start=start, drag=drag,
                   tpu_curve=ref, samples=samples,
                   gates=mr_cyl_gates(start, drag, bool(s.overflow)),
                   jax_f32=jax_f32("mr_cylinder"))


RUNS = {"fvm_drag": fvm_drag, "fvm_golden": fvm_golden,
        "bow_shock": bow_shock, "sod": sod, "dmr": dmr, "tg_mr": tg_mr,
        "mr_beam": mr_beam, "mr_tank": mr_tank, "mr_cylinder": mr_cylinder}


def main(argv=None) -> int:
    return run_all(RUNS, argv, "a7j_fvm_mr_long.json",
                   __doc__.splitlines()[0])


if __name__ == "__main__":
    raise SystemExit(main())
