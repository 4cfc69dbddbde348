#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — the dual-criteria WCSPH dambreak on the
cell-block engine — at the bench sizes (2D dx=0.0025: 320,000 fluid
particles; 3D dx=0.01: 1,000,000 fluid particles, cap 32, c_max 125,000):

  1. environment: torch / CUDA versions, the card's name and power limit;
  2. build: nvcc compiles sphinxsys_tpu_torch/csrc/block_sweeps.cu;
  3. kernels: each CUDA sweep against its plain PyTorch version on the same
     CUDA inputs (taken from the scene after one advection step), with
     times from CUDA events;
  4. / 5. the 2D and 3D main paths through build_block_case -> init_sim ->
     make_run_chunk -> solver.run_simulation, checking that every kernel
     ran, no capacity overflowed, the fields stay finite and the total
     mechanical energy drifts by less than 1%; then the steady-state step
     time by part, and one advection step under torch.profiler (device
     busy and idle share; Chrome traces to build/traces/).

Its last two lines are a JSON object of per-kernel results and
{"ok": true, "device": {...}}.  Any failed check exits non-zero before
printing them.  Imports no JAX.
"""

from __future__ import annotations

import importlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNELS = {  # wrapper name -> (TPU kernel it replaces, launch-counter key)
    "density_sweep": ("sphinxsys_tpu/ops/pallas_block2.py:493", "density"),
    "ac1_sweep": ("sphinxsys_tpu/ops/pallas_block2.py:98", "ac1"),
    "ac2_sweep": ("sphinxsys_tpu/ops/pallas_block2.py:177", "ac2"),
}
SOURCE = "sphinxsys_tpu_torch/csrc/block_sweeps.cu"
DEVICE = "cuda"
CONFIGS = {  # the bench configs (bench.py:311-318) and their main-path runs
    "2d": dict(module="dambreak_2d", dx=0.0025, kw={}, min_adv=5),
    "3d": dict(module="dambreak_3d", dx=0.01, kw={"cap": 32, "c_max": 125_000},
               min_adv=2),
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def cuda_ms(torch, fn, reps):
    """Median device time of fn() over reps runs (CUDA events), after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def wall_s(torch, fn, reps):
    """Median host wall time (s) of fn() ending in a device sync."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def sweep_inputs(torch, scene, sim):
    """The three sweeps' arguments as the *_p2 forms build them, from the
    current block state (the acoustic ones at the next sub-step's dt)."""
    from sphinxsys_tpu_torch.engine import block_fluid as eng_mod
    from sphinxsys_tpu_torch.physics import fluid_blocks as fbops

    eng, fb = scene.eng, sim.fluid_b
    kern, dim = eng.kernel, eng.dim
    inv_h = 1.0 / kern.h
    dw_scale = kern._factor_w(dim) * inv_h * 0.625
    wb, nw = scene.wall_b, sim.nbr_wall
    dt = eng_mod.acoustic_dt(eng, fb)
    rho, p, pos = fbops._half_step_fields(fb, eng.eos, dt)
    acc = fb["ForcePrior"] / torch.clamp(fb["Mass"], min=fbops.TINY)[..., None]
    return {
        "density_sweep": (
            (fb["Position"], fb["SlotMask"], sim.nbr_inner, wb["Position"],
             wb["VolumetricMeasure"], nw),
            dict(inv_h=inv_h, factor_w=kern._factor_w(dim))),
        "ac1_sweep": (
            (pos, p, rho, acc, fb["VolumetricMeasure"], sim.nbr_inner,
             wb["Position"], wb["VolumetricMeasure"], None, nw),
            dict(inv_h=inv_h, dw_scale=dw_scale,
                 inv_rho0c0=eng.riemann1.inv_rho0c0_ave)),
        "ac2_sweep": (
            (pos, fb["Velocity"], fb["VolumetricMeasure"], sim.nbr_inner,
             wb["Position"], wb["VolumetricMeasure"], None,
             wb["NormalDirection"], nw),
            dict(inv_h=inv_h, dw_scale=dw_scale,
                 rho0c0_geo=eng.riemann2.rho0c0_geo_ave,
                 lim_scale=eng.riemann2.limiter_coeff * eng.riemann2.inv_c0_ave)),
    }


def compare_kernels(torch, tag, scene, sim, results):
    """Phase 3: every kernel against its plain version on the same inputs.

    Tolerance, per output channel over the real slots: the kernel's error
    against the plain version run in float64 must be at most twice the
    float32 plain version's own error against it, plus 1e-6 * max|ref| —
    both sum the same f32 pair terms in different orders, and the ac1
    force cancels terms far larger than the sum, so only an error scale
    measured on the same data is meaningful.  As a gross-error guard the
    kernel must also agree with the f32 plain version to 1e-3 * max|plain|."""
    from sphinxsys_tpu_torch.ops import block_sweeps as bs

    c = sim.nbr_inner.shape[0]
    real = sim.fluid_b["SlotMask"][:c]
    inputs = sweep_inputs(torch, scene, sim)
    for name, (args, kw) in inputs.items():
        wrapper = getattr(bs, name)
        plain = getattr(bs, name + "_plain")
        got = wrapper(*args, **kw)
        torch.cuda.synchronize()
        ref32 = plain(*args, **kw)
        args64 = [a.double() if torch.is_tensor(a) and a.is_floating_point()
                  else a for a in args]
        ref64 = plain(*args64, **kw)
        max_abs = 0.0
        for ch in range(got.shape[-1]):
            k = got[..., ch][real].double()
            p32 = ref32[..., ch][real].double()
            p64 = ref64[..., ch][real]
            scale = float(p64.abs().max())
            err_k = float((k - p64).abs().max())
            err_p = float((p32 - p64).abs().max())
            err_kp = float((k - p32).abs().max())
            max_abs = max(max_abs, err_kp)
            log(f"{tag} {name} ch{ch}: max|ref|={scale:.6e} |k-p32|={err_kp:.3e} "
                f"|k-p64|={err_k:.3e} |p32-p64|={err_p:.3e}")
            check(bool(torch.isfinite(k).all()), f"{tag} {name} ch{ch}: non-finite")
            check(err_k <= 2.0 * err_p + 1e-6 * scale,
                  f"{tag} {name} ch{ch}: kernel error {err_k:.3e} vs f64 exceeds "
                  f"2x the f32 plain error {err_p:.3e} + 1e-6 max|ref|")
            check(err_kp <= 1e-3 * max(scale, 1e-30),
                  f"{tag} {name} ch{ch}: kernel vs f32 plain {err_kp:.3e}")
        ms = cuda_ms(torch, lambda: wrapper(*args, **kw), reps=20)
        plain_ms = cuda_ms(torch, lambda: plain(*args, **kw), reps=3)
        log(f"{tag} {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"max_abs_err {max_abs:.3e}")
        results[f"{name}[{tag}]"] = dict(max_abs_err=max_abs, ms=ms,
                                         plain_ms=plain_ms)


def moving_wall_check(torch, tag, scene, sim):
    """The moving-wall kernel variants (wall velocity / acceleration
    channels present) against their plain versions on the same inputs
    with seeded non-zero wall kinematics."""
    from sphinxsys_tpu_torch.ops import block_sweeps as bs

    g = torch.Generator(device=DEVICE).manual_seed(7)
    wb = scene.wall_b
    wvel = torch.randn(wb["Position"].shape, generator=g, device=DEVICE) * 0.1
    wacc = torch.randn(wb["Position"].shape, generator=g, device=DEVICE)
    c = sim.nbr_inner.shape[0]
    real = sim.fluid_b["SlotMask"][:c]
    inputs = sweep_inputs(torch, scene, sim)
    for name, slot, extra in (("ac1_sweep", 8, wacc), ("ac2_sweep", 6, wvel)):
        args, kw = inputs[name]
        args = list(args)
        args[slot] = extra
        got = getattr(bs, name)(*args, **kw)
        ref = getattr(bs, name + "_plain")(*args, **kw)
        for ch in range(got.shape[-1]):
            scale = float(ref[..., ch][real].abs().max())
            err = float((got[..., ch][real] - ref[..., ch][real]).abs().max())
            check(err <= 1e-3 * max(scale, 1e-30),
                  f"{tag} moving-wall {name} ch{ch}: {err:.3e} vs scale {scale:.3e}")
        log(f"{tag} moving-wall {name}: agrees with its plain version")


def run_main_path(torch, tag, cfg, results):
    """Phases 4/5: the port's main path at the bench size."""
    from sphinxsys_tpu_torch import solver
    from sphinxsys_tpu_torch.engine import block_fluid as eng_mod
    from sphinxsys_tpu_torch.engine import scene as sc
    from sphinxsys_tpu_torch.ops import block_sweeps as bs
    from sphinxsys_tpu_torch.physics import general as gd

    db = importlib.import_module(f"sphinxsys_tpu_torch.cases.{cfg['module']}")
    bs.reset_launch_counts()
    t0 = time.perf_counter()
    scene, fluid = db.build_block_case(dx=cfg["dx"], device=DEVICE, **cfg["kw"])
    sim = sc.init_sim(scene, fluid)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    e0 = float(gd.total_mechanical_energy(sc.blocks_to_particles(scene, sim),
                                          scene.base.gravity))
    dt_est = 0.25 * scene.eng.h / db.U_REF
    end_time = (cfg["min_adv"] + 0.5) * dt_est
    sim, timer = solver.run_simulation(sc.make_run_chunk(scene), sim, end_time,
                                       end_time, verbose=False)
    counts = dict(bs.LAUNCHES)
    torch.cuda.synchronize()

    part = sc.blocks_to_particles(scene, sim)
    e1 = float(gd.total_mechanical_energy(part, scene.base.gravity))
    drift = abs(e1 - e0) / abs(e0)
    log(f"{tag} main path: n_fluid={scene.n_fluid} n_wall={scene.base.n_wall} "
        f"c_max={scene.eng.c_max} cap={scene.eng.cap} "
        f"c_max_wall={scene.bm_wall.c_max} setup {setup_s:.2f} s")
    check(sim.n_adv >= cfg["min_adv"], f"{tag}: only {sim.n_adv} advection steps")
    check(not bool(sim.overflow), f"{tag}: block capacity overflow")
    for k in ("Position", "Velocity", "Density", "Pressure"):
        check(bool(torch.isfinite(part[k]).all()), f"{tag}: non-finite {k}")
    check(drift < 0.01, f"{tag}: energy drift {drift:.3e} >= 1%")
    for name, (_, key) in KERNELS.items():
        check(counts[key] > 0, f"{tag}: kernel {name} never launched")
        results[f"{name}[{tag}]"]["launches"] = counts[key]
    integ = timer.totals["integrate"]
    log(f"{tag} main path: n_adv={sim.n_adv} n_ac={sim.n_ac} t={float(sim.time):.6e} "
        f"energy {e0:.9e} -> {e1:.9e} (drift {drift:.3e}) launches {counts}")
    log(f"{tag} main path: {integ / sim.n_adv * 1e3:.3f} ms per advection step "
        f"({sim.n_ac / sim.n_adv:.2f} acoustic sub-steps each), wall clock")

    # where an advection step's time goes (host wall clock, synchronised)
    wc = eng_mod.WallCtx(scene.wall_b, sim.nbr_wall)
    eng, fb, nbr = scene.eng, sim.fluid_b, sim.nbr_inner
    dt_adv = eng_mod.advection_dt(eng, fb)

    def acoustic_substep():
        dt = eng_mod.acoustic_dt(eng, fb, dt_adv)
        f = eng_mod.acoustic_first_half(eng, fb, nbr, wc, dt)
        eng_mod.acoustic_second_half(eng, f, nbr, wc, dt)

    flat = {k: fb[k].reshape((-1,) + tuple(fb[k].shape[2:])) for k in scene.fields}
    valid = fb["SlotMask"].reshape(-1)
    parts = {
        "advection_step": wall_s(torch, lambda: sc.make_advection_step(scene)(sim), 3),
        "advection_dt": wall_s(torch, lambda: eng_mod.advection_dt(eng, fb), 5),
        "density_prep": wall_s(torch, lambda: eng_mod.advection_prep(eng, fb, nbr, wc), 5),
        "acoustic_substep": wall_s(torch, acoustic_substep, 5),
        "reslot": wall_s(torch, lambda: sc._slot(scene, flat, valid), 5),
    }
    log(f"{tag} step parts (ms, wall clock): "
        + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in parts.items()))
    results[f"_{tag}_main"] = dict(
        n_adv=sim.n_adv, n_ac=sim.n_ac, ms_per_adv=integ / sim.n_adv * 1e3,
        parts_ms={k: v * 1e3 for k, v in parts.items()}, drift=drift)
    return scene, sim


def small_reference_check(torch):
    """The whole 2D slice at dx = 0.1 to t = 0.08 on the card (the CUDA
    kernels) against the same run on the CPU (the sweeps' plain versions,
    which the CPU tests hold to the JAX package's Pallas path within 5e-5):
    equal step counts, positions by particle within 5e-5."""
    from sphinxsys_tpu_torch.cases import dambreak_2d as db
    from sphinxsys_tpu_torch.engine import scene as sc

    runs = {}
    for dev in (DEVICE, "cpu"):
        scene, fluid = db.build_block_case(dx=0.1, device=dev)
        sim = sc.make_run_chunk(scene)(sc.init_sim(scene, fluid), 0.08)
        runs[dev] = (sim, sc.blocks_to_particles(scene, sim)["Position"].cpu())
    (gs, gp), (cs, cp) = runs[DEVICE], runs["cpu"]
    err = float((gp - cp).abs().max())
    log(f"small reference: dx=0.1 to t=0.08 card n_adv={gs.n_adv} n_ac={gs.n_ac}"
        f", cpu n_adv={cs.n_adv} n_ac={cs.n_ac}, max |dpos| {err:.3e}")
    check((gs.n_adv, gs.n_ac) == (cs.n_adv, cs.n_ac), "small reference: step counts differ")
    check(err <= 5e-5, f"small reference: positions differ by {err:.3e}")


def profile_step(torch, tag, scene, sim):
    """One advection step under torch.profiler: device time by kernel, the
    three sweeps' share and the device idle share of the profiled step's
    wall time.  The profiler slows the host side, so the same step is also
    timed unprofiled (median of 3) and an idle-share estimate is printed
    that divides the profiled device busy by that wall time — two different
    executions, labelled as such.  Writes a Chrome trace to build/traces/."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sphinxsys_tpu_torch.engine import scene as sc

    step = sc.make_advection_step(scene)
    plain_wall_us = wall_s(torch, lambda: step(sim), 3) * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(sim)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    out = ROOT / "build" / "traces"
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / f"trace_{tag}_step.json"))
    # device-side events only (kernels, copies); the aten ops that launched
    # them report the same time again
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kern)
    sweeps_us = sum(e.self_device_time_total for e in kern
                    if any(n in e.key for n in ("density_kernel", "ac1_kernel",
                                                "ac2_kernel")))
    log(f"{tag} profile: profiled step wall {wall_us / 1e3:.3f} ms, device busy "
        f"{dev_us / 1e3:.3f} ms (idle share of the profiled step "
        f"{1 - dev_us / wall_us:.3f}), sweep kernels {sweeps_us / 1e3:.3f} ms, "
        f"{len(kern)} kernel kinds")
    log(f"{tag} profile: unprofiled step wall {plain_wall_us / 1e3:.3f} ms; "
        f"estimated idle share {1 - dev_us / plain_wall_us:.3f} (profiled "
        f"device busy over unprofiled wall: two executions)")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"{tag} profile:   {e.self_device_time_total / 1e3:9.3f} ms "
            f"x{e.count:<4d} {e.key[:90]}")


def main() -> int:
    if not (ROOT / "sphinxsys_tpu_torch").is_dir():
        log("FAIL: the sphinxsys_tpu_torch package is not beside this script")
        return 1
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is False")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(smi, flush=True)

    from sphinxsys_tpu_torch.engine import scene as sc
    from sphinxsys_tpu_torch.ops import _build

    so, build_log, build_s = _build.build()
    log(f"build: {so.name} in {build_s:.1f} s")
    for line in build_log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log(f"ptxas: {line.strip()}")
    _build.library()

    results = {}
    for tag, cfg in CONFIGS.items():
        db = importlib.import_module(f"sphinxsys_tpu_torch.cases.{cfg['module']}")
        scene, fluid = db.build_block_case(dx=cfg["dx"], device=DEVICE, **cfg["kw"])
        sim = sc.make_advection_step(scene)(sc.init_sim(scene, fluid))
        compare_kernels(torch, tag, scene, sim, results)
        moving_wall_check(torch, tag, scene, sim)
        del scene, fluid, sim
        torch.cuda.empty_cache()
    small_reference_check(torch)

    for tag, cfg in CONFIGS.items():
        scene, sim = run_main_path(torch, tag, cfg, results)
        profile_step(torch, tag, scene, sim)
        del scene, sim
        torch.cuda.empty_cache()

    kernels = []
    for tag in CONFIGS:
        for name, (replaces, _) in KERNELS.items():
            r = results[f"{name}[{tag}]"]
            kernels.append({"name": f"{name}[{tag}]", "route": "cuda",
                            "source": SOURCE, "replaces": replaces,
                            "launches": r["launches"],
                            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                            "plain_ms": r["plain_ms"]})
    main_paths = {tag: results[f"_{tag}_main"] for tag in CONFIGS}
    log("main paths: " + json.dumps(main_paths))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        log(f"FAIL: {exc}")
        sys.exit(1)
