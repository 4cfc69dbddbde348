#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths — the dual-criteria WCSPH solver on the
cell-block engine — at full size:

  * 2D dambreak, dx=0.0025: 320,000 fluid particles (bench.py:311-318);
  * 3D dambreak, dx=0.01: 1,000,000 fluid particles, cap 32, c_max 125,000;
  * Taylor–Green 2D, dx=0.001: 1,000,000 fluid particles on a 384 x 384
    doubly periodic grid, cap 12, c_max 147,456 (viscous force and
    transport-velocity correction, no wall).

Phases:

  1. environment: torch / CUDA versions, the card's name and power limit;
  2. build: nvcc compiles sphinxsys_tpu_torch/csrc/block_sweeps.cu;
  3. kernels: each CUDA sweep of a path against its plain PyTorch version
     on the same CUDA inputs (the scene after one advection step; for
     Taylor–Green from the lattice with seeded noise), with times from
     CUDA events and each kernel's bound (the least time the card could
     take: the larger of the bytes it must move over 3.35 TB/s and its
     real pairs' flops over 67 TFLOP/s); the moving-wall variants, and B4
     with a static and a moving wall on the 2D dambreak;
  4. small references: the 2D dambreak (dx=0.1) and Taylor–Green (dx=0.05)
     slices on the card against the same runs on the CPU; Taylor–Green at
     dx=0.01 to t=0.1 against the analytic kinetic-energy decay;
  5. the main paths through build_block_case -> init_sim -> make_run_chunk
     -> solver.run_simulation, checking that every kernel of the path ran,
     no capacity overflowed, the fields stay finite and the energy behaves
     (dambreak: mechanical energy drifts < 1%; Taylor–Green: the kinetic
     energy falls); then the steady-state step time by part, and one
     advection step under torch.profiler (device busy and idle share;
     Chrome traces to build/traces/).

Its last two lines are a JSON object of per-kernel results and
{"ok": true, "device": {...}}.  Any failed check exits non-zero before
printing them.  Imports no JAX.
"""

from __future__ import annotations

import importlib
import json
import math
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
    "visc_tvc_sweep": ("sphinxsys_tpu/ops/pallas_block2.py:373", "visc_tvc"),
}
SOURCE = "sphinxsys_tpu_torch/csrc/block_sweeps.cu"
DEVICE = "cuda"
DAMBREAK_KERNELS = ("density_sweep", "ac1_sweep", "ac2_sweep")
CONFIGS = {  # the bench configs (bench.py:311-318), Taylor–Green at 1M
    "2d": dict(module="dambreak_2d", dx=0.0025, kw={}, min_adv=5,
               kernels=DAMBREAK_KERNELS, energy="mechanical", noise=False),
    "3d": dict(module="dambreak_3d", dx=0.01, kw={"cap": 32, "c_max": 125_000},
               min_adv=2, kernels=DAMBREAK_KERNELS, energy="mechanical",
               noise=False),
    "tg": dict(module="taylor_green_2d", dx=0.001, kw={}, min_adv=10,
               kernels=tuple(KERNELS), energy="kinetic", noise=True),
}
# The arrays each kernel reads, by position in its wrapper's arguments:
# (fluid block arrays, wall block arrays, window maps, fluid arrays that
# only its wall branch reads).  A None argument (a static wall's velocity
# or acceleration channel) is not read.
READS = {
    "density_sweep": ((0, 1), (3, 4), (2, 5), ()),
    "ac1_sweep": ((0, 1, 2, 3, 4), (6, 7, 8), (5, 9), (2, 3)),
    "ac2_sweep": ((0, 1, 2), (4, 5, 6, 7), (3, 8), ()),
    "visc_tvc_sweep": ((0, 1, 2), (4, 5, 6), (3, 7), ()),
}
# published H100 SXM peaks (NVIDIA data sheet), at the 700 W limit
PEAK_F32_FLOPS = 67e12      # float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12


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


def perturbed(torch, fluid, dx, seed=11):
    """The fluid state with seeded noise, as the CPU tests put on the
    Taylor–Green lattice: positions moved by up to 0.1 dx, velocities by
    N(0, 0.1).  On the bare lattice B4's transport-velocity sum cancels
    terms ~1e3 times its result, so the f32 rounding of any summation
    order swamps it; the noise makes every channel a sharp check."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    pos, vel = fluid["Position"], fluid["Velocity"]
    shift = torch.rand(pos.shape, generator=g, device=DEVICE) - 0.5
    kick = torch.randn(vel.shape, generator=g, device=DEVICE)
    return dict(fluid, Position=pos + 0.2 * dx * shift,
                Velocity=vel + 0.1 * kick)


def sweep_inputs(torch, scene, sim, kernels):
    """The sweeps' arguments as the *_p2 forms build them, from the current
    block state (the acoustic ones at the next sub-step's dt)."""
    from sphinxsys_tpu_torch.engine import block_fluid as eng_mod
    from sphinxsys_tpu_torch.physics import fluid_blocks as fbops

    eng, fb = scene.eng, sim.fluid_b
    kern, dim = eng.kernel, eng.dim
    inv_h = 1.0 / kern.h
    dw_scale = kern._factor_w(dim) * inv_h * 0.625
    wb, nw = scene.wall_b, sim.nbr_wall
    wall = (lambda *k: (None,) * len(k)) if wb is None \
        else (lambda *k: tuple(wb[x] for x in k))
    dt = eng_mod.acoustic_dt(eng, fb)
    rho, p, pos = fbops._half_step_fields(fb, eng.eos, dt)
    acc = fb["ForcePrior"] / torch.clamp(fb["Mass"], min=fbops.TINY)[..., None]
    geo, lim_scale = fbops.ac2_dissipation(eng.riemann2)
    box = eng.box
    out = {
        "density_sweep": (
            (fb["Position"], fb["SlotMask"], sim.nbr_inner,
             *wall("Position", "VolumetricMeasure"), nw),
            dict(inv_h=inv_h, factor_w=kern._factor_w(dim), box=box)),
        "ac1_sweep": (
            (pos, p, rho, acc, fb["VolumetricMeasure"], sim.nbr_inner,
             *wall("Position", "VolumetricMeasure"), None, nw),
            dict(inv_h=inv_h, dw_scale=dw_scale,
                 inv_rho0c0=eng.riemann1.inv_rho0c0_ave, box=box)),
        "ac2_sweep": (
            (pos, fb["Velocity"], fb["VolumetricMeasure"], sim.nbr_inner,
             *wall("Position", "VolumetricMeasure"), None,
             *wall("NormalDirection"), nw),
            dict(inv_h=inv_h, dw_scale=dw_scale, rho0c0_geo=geo,
                 lim_scale=lim_scale, box=box)),
        "visc_tvc_sweep": (
            (fb["Position"], fb["Velocity"], fb["VolumetricMeasure"],
             sim.nbr_inner, *wall("Position", "VolumetricMeasure"), None, nw),
            dict(inv_h=inv_h, dw_scale=dw_scale, eps_r=0.01 * eng.h, box=box)),
    }
    return {k: out[k] for k in kernels}


def real_pairs(torch, pos, mask, nbr, box, cutoff, wall_pos=None,
               wall_mask=None, nbr_wall=None, chunk=8192):
    """(fluid-fluid, fluid-wall) ordered pairs of real particles closer
    than the cutoff (the self pair counted), from the block map."""
    c = nbr.shape[0]
    periodic = [(k, float(b)) for k, b in enumerate(box) if b > 0.0]

    def count(src_pos, src_mask, table):
        n = torch.zeros((), dtype=torch.int64, device=pos.device)
        for c0 in range(0, c, chunk):
            c1 = min(c0 + chunk, c)
            xi, mi = pos[c0:c1, :, None, :], mask[c0:c1, :, None]
            for w in range(table.shape[1]):
                rows = table[c0:c1, w].long()
                d = xi - src_pos[rows][:, None]
                for k, length in periodic:
                    d[..., k] -= length * torch.round(d[..., k] / length)
                near = torch.sum(d * d, dim=-1) < cutoff * cutoff
                n += torch.sum(near & mi & src_mask[rows][:, None, :])
        return int(n)

    inner = count(pos, mask, nbr)
    wall = count(wall_pos, wall_mask, nbr_wall) if nbr_wall is not None else 0
    return inner, wall


def pair_flops(name, dim, n_periodic, wall=False):
    """Float operations per real pair of a kernel, counted from its source
    (add, mul, compare, sqrt, rsqrt and division one each; the minimum image
    four per periodic axis; the Wendland dW/dr*V_j block 11)."""
    geom = 3 * dim + 4 * n_periodic
    if name == "density_sweep":
        return geom + 14
    if name == "ac1_sweep":
        return geom + 11 + ((5 * dim + 10) if wall else (2 * dim + 6))
    if name == "ac2_sweep":
        return geom + 11 + ((12 * dim + 10) if wall else (6 * dim + 8))
    return geom + 11 + ((4 * dim + 5) if wall else (5 * dim + 4))


def read_bytes(torch, name, args, out):
    """Bytes one call must move: the output written once, and once each
    array that the launched variant reads (READS) — of a block array the
    rows its window map reaches, of a window map all of it."""
    fluid, wall, maps, wall_only = READS[name]
    nbr, nbr_w = (args[i] for i in maps)

    def rows_reached(table, n_rows):
        return int(torch.unique(table[table < n_rows]).numel())

    def row_bytes(a):
        return a[0].numel() * a.element_size()

    total = out.numel() * out.element_size() + sum(
        t.numel() * t.element_size() for t in (nbr, nbr_w) if t is not None)
    n_f = rows_reached(nbr, nbr.shape[0])
    total += sum(n_f * row_bytes(args[i]) for i in fluid
                 if nbr_w is not None or i not in wall_only)
    if nbr_w is not None:
        n_w = rows_reached(nbr_w, args[wall[0]].shape[0] - 1)
        total += sum(n_w * row_bytes(args[i]) for i in wall
                     if args[i] is not None)
    return total


def bound(torch, name, args, out, scene, sim):
    """The least time the card could take for one call (ms): the larger of
    the bytes it must move (`read_bytes`) over the HBM rate and the flops
    of the real pairs it evaluates over the float32 rate.  Returns (ms,
    "bytes"|"operations", real pairs, flops, bytes)."""
    eng, wb = scene.eng, scene.wall_b
    nbytes = read_bytes(torch, name, args, out)
    inner, wall = real_pairs(
        torch, args[0], sim.fluid_b["SlotMask"], sim.nbr_inner, eng.box,
        eng.kernel.cutoff, None if wb is None else wb["Position"],
        None if wb is None else wb["SlotMask"], sim.nbr_wall)
    n_per = sum(1 for b in eng.box if b > 0.0)
    flops = inner * pair_flops(name, eng.dim, n_per) + wall * pair_flops(
        name, eng.dim, n_per, wall=True)
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            inner + wall, flops, nbytes)


def compare(torch, what, name, args, kw, real):
    """One kernel against its plain version on the same inputs.

    Tolerance, per output channel over the real slots: the kernel's error
    against the plain version run in float64 must be at most twice the
    float32 plain version's own error against it, plus 1e-6 * max|ref| —
    both sum the same f32 pair terms in different orders, and the ac1
    force cancels terms far larger than the sum, so only an error scale
    measured on the same data is meaningful.  As a gross-error guard the
    kernel must also agree with the f32 plain version to 1e-3 * max|ref|.
    Returns (kernel output, max|k - p32|)."""
    from sphinxsys_tpu_torch.ops import block_sweeps as bs

    wrapper, plain = getattr(bs, name), getattr(bs, name + "_plain")
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
        log(f"{what} {name} ch{ch}: max|ref|={scale:.6e} |k-p32|={err_kp:.3e} "
            f"|k-p64|={err_k:.3e} |p32-p64|={err_p:.3e}")
        check(bool(torch.isfinite(k).all()), f"{what} {name} ch{ch}: non-finite")
        check(err_k <= 2.0 * err_p + 1e-6 * scale,
              f"{what} {name} ch{ch}: kernel error {err_k:.3e} vs f64 exceeds "
              f"2x the f32 plain error {err_p:.3e} + 1e-6 max|ref|")
        limit = 1e-3 * max(scale, 1e-30)
        check(err_kp <= limit,
              f"{what} {name} ch{ch}: kernel vs f32 plain {err_kp:.3e} > {limit:.3e}")
    return got, max_abs


def compare_kernels(torch, tag, cfg, scene, sim, results):
    """Phase 3: every kernel of the path against its plain version on the
    same inputs, its times and its bound."""
    from sphinxsys_tpu_torch.ops import block_sweeps as bs

    c = sim.nbr_inner.shape[0]
    real = sim.fluid_b["SlotMask"][:c]
    inputs = sweep_inputs(torch, scene, sim, cfg["kernels"])
    for name, (args, kw) in inputs.items():
        wrapper, plain = getattr(bs, name), getattr(bs, name + "_plain")
        got, max_abs = compare(torch, tag, name, args, kw, real)
        ms = cuda_ms(torch, lambda: wrapper(*args, **kw), reps=20)
        plain_ms = cuda_ms(torch, lambda: plain(*args, **kw), reps=3)
        bound_ms, bound_by, pairs, flops, nbytes = bound(
            torch, name, args, got, scene, sim)
        log(f"{tag} {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {pairs} real pairs, "
            f"{flops:.4e} flop, {nbytes} B), max_abs_err {max_abs:.3e}")
        results[f"{name}[{tag}]"] = dict(
            max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, real_pairs=pairs)


def moving_wall_check(torch, tag, scene, sim):
    """The moving-wall kernel variants (wall velocity / acceleration
    channels present) against their plain versions on the same inputs
    with seeded non-zero wall kinematics; and B4, which the dambreak does
    not run, with the static and the moving wall on the same inputs."""
    g = torch.Generator(device=DEVICE).manual_seed(7)
    wb = scene.wall_b
    wvel = torch.randn(wb["Position"].shape, generator=g, device=DEVICE) * 0.1
    wacc = torch.randn(wb["Position"].shape, generator=g, device=DEVICE)
    c = sim.nbr_inner.shape[0]
    real = sim.fluid_b["SlotMask"][:c]
    inputs = sweep_inputs(torch, scene, sim, tuple(KERNELS))
    cases = [("ac1_sweep", 8, wacc), ("ac2_sweep", 6, wvel)]
    if tag == "2d":
        cases += [("visc_tvc_sweep", None, None), ("visc_tvc_sweep", 6, wvel)]
    for name, slot, extra in cases:
        args, kw = inputs[name]
        args = list(args)
        what = f"{tag} static-wall" if slot is None else f"{tag} moving-wall"
        if slot is not None:
            args[slot] = extra
        compare(torch, what, name, args, kw, real)
        log(f"{what} {name}: agrees with its plain version")


def tg_dissipative_ac2_check(torch, scene, sim):
    """The Taylor–Green path passes B3 no dissipation (the No solver); B3's
    force channel with the box is held here with the 1st-half acoustic
    solver's constants instead, on the same inputs."""
    from sphinxsys_tpu_torch.physics import fluid_blocks as fbops

    args, kw = sweep_inputs(torch, scene, sim, ("ac2_sweep",))["ac2_sweep"]
    geo, lim_scale = fbops.ac2_dissipation(scene.eng.riemann1)
    kw = dict(kw, rho0c0_geo=geo, lim_scale=lim_scale)
    c = sim.nbr_inner.shape[0]
    compare(torch, "tg acoustic-solver", "ac2_sweep", args, kw,
            sim.fluid_b["SlotMask"][:c])
    log("tg acoustic-solver ac2_sweep: agrees with its plain version")


def energy(gd, cfg, scene, part):
    if cfg["energy"] == "kinetic":
        return float(gd.total_kinetic_energy(part))
    return float(gd.total_mechanical_energy(part, scene.base.gravity))


def run_main_path(torch, tag, cfg, results):
    """Phase 5: the port's main path at full size."""
    from sphinxsys_tpu_torch import solver
    from sphinxsys_tpu_torch.engine import block_fluid as eng_mod
    from sphinxsys_tpu_torch.engine import scene as sc
    from sphinxsys_tpu_torch.ops import block_sweeps as bs
    from sphinxsys_tpu_torch.physics import general as gd

    db = importlib.import_module(f"sphinxsys_tpu_torch.cases.{cfg['module']}")
    t0 = time.perf_counter()
    scene, fluid = db.build_block_case(dx=cfg["dx"], device=DEVICE, **cfg["kw"])
    sim = sc.init_sim(scene, fluid)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    e0 = energy(gd, cfg, scene, sc.blocks_to_particles(scene, sim))
    dt0 = float(eng_mod.advection_dt(scene.eng, sim.fluid_b))
    end_time = (cfg["min_adv"] + 0.5) * dt0
    bs.reset_launch_counts()
    sim, timer = solver.run_simulation(sc.make_run_chunk(scene), sim, end_time,
                                       end_time, verbose=False)
    counts = dict(bs.LAUNCHES)
    torch.cuda.synchronize()

    part = sc.blocks_to_particles(scene, sim)
    e1 = energy(gd, cfg, scene, part)
    drift = abs(e1 - e0) / abs(e0)
    wall_n = scene.base.n_wall if scene.wall_b is not None else 0
    log(f"{tag} main path: n_fluid={scene.n_fluid} n_wall={wall_n} "
        f"grid={scene.eng.grid.shape} c_max={scene.eng.c_max} "
        f"cap={scene.eng.cap} setup {setup_s:.2f} s")
    check(sim.n_adv >= cfg["min_adv"], f"{tag}: only {sim.n_adv} advection steps")
    check(not bool(sim.overflow), f"{tag}: block capacity overflow")
    for k in ("Position", "Velocity", "Density", "Pressure"):
        check(bool(torch.isfinite(part[k]).all()), f"{tag}: non-finite {k}")
    if cfg["energy"] == "kinetic":
        check(e1 < e0, f"{tag}: kinetic energy did not fall ({e0} -> {e1})")
    else:
        check(drift < 0.01, f"{tag}: energy drift {drift:.3e} >= 1%")
    for name in cfg["kernels"]:
        key = KERNELS[name][1]
        check(counts[key] > 0, f"{tag}: kernel {name} never launched")
        results[f"{name}[{tag}]"]["launches"] = counts[key]
    integ = timer.totals["integrate"]
    log(f"{tag} main path: n_adv={sim.n_adv} n_ac={sim.n_ac} t={float(sim.time):.6e} "
        f"energy {e0:.9e} -> {e1:.9e} (change {drift:.3e}) launches {counts}")
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
        "prep": wall_s(torch, lambda: eng_mod.advection_prep(eng, fb, nbr, wc), 5),
        "acoustic_substep": wall_s(torch, acoustic_substep, 5),
        "reslot": wall_s(torch, lambda: sc._slot(scene, flat, valid), 5),
    }
    log(f"{tag} step parts (ms, wall clock): "
        + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in parts.items()))
    results[f"_{tag}_main"] = dict(
        n_adv=sim.n_adv, n_ac=sim.n_ac, ms_per_adv=integ / sim.n_adv * 1e3,
        parts_ms={k: v * 1e3 for k, v in parts.items()}, energy_change=drift)
    return scene, sim


def small_reference_check(torch, module, dx, t_end):
    """A whole slice at a small size on the card (the CUDA kernels) against
    the same run on the CPU (the sweeps' plain versions, which the CPU tests
    hold to the JAX package's Pallas path within 5e-5): equal step counts,
    positions by particle within 5e-5."""
    from sphinxsys_tpu_torch.engine import scene as sc

    case = importlib.import_module(f"sphinxsys_tpu_torch.cases.{module}")
    runs = {}
    for dev in (DEVICE, "cpu"):
        scene, fluid = case.build_block_case(dx=dx, device=dev)
        sim = sc.make_run_chunk(scene)(sc.init_sim(scene, fluid), t_end)
        runs[dev] = (sim, sc.blocks_to_particles(scene, sim)["Position"].cpu())
    (gs, gp), (cs, cp) = runs[DEVICE], runs["cpu"]
    err = float((gp - cp).abs().max())
    log(f"small reference: {module} dx={dx} to t={t_end} card n_adv={gs.n_adv} "
        f"n_ac={gs.n_ac}, cpu n_adv={cs.n_adv} n_ac={cs.n_ac}, "
        f"max |dpos| {err:.3e}")
    check((gs.n_adv, gs.n_ac) == (cs.n_adv, cs.n_ac),
          f"small reference {module}: step counts differ")
    check(err <= 5e-5, f"small reference {module}: positions differ by {err:.3e}")


def tg_decay_check(torch):
    """Taylor–Green at the reference case's size (dx=0.01, 10,000
    particles) to t=0.1: the kinetic energy within 8% of
    KE0 exp(-16 pi^2 nu t) (the criterion of tests/test_block_engine.py)."""
    from sphinxsys_tpu_torch.cases import taylor_green_2d as tg
    from sphinxsys_tpu_torch.engine import scene as sc
    from sphinxsys_tpu_torch.physics import general as gd

    scene, fluid = tg.build_block_case(dx=0.01, device=DEVICE)
    sim = sc.init_sim(scene, fluid)
    ke0 = float(gd.total_kinetic_energy(sc.blocks_to_particles(scene, sim)))
    sim = sc.make_run_chunk(scene)(sim, 0.1)
    ke = float(gd.total_kinetic_energy(sc.blocks_to_particles(scene, sim)))
    nu = tg.MU_F / tg.RHO0_F
    expected = ke0 * math.exp(-16.0 * math.pi ** 2 * nu * float(sim.time))
    rel = abs(ke - expected) / expected
    log(f"tg decay: dx=0.01 t={float(sim.time):.6f} n_adv={sim.n_adv} "
        f"n_ac={sim.n_ac} KE0={ke0:.9f} KE={ke:.9f} analytic {expected:.9f} "
        f"(rel {rel:.4f})")
    check(not bool(sim.overflow), "tg decay: block capacity overflow")
    check(rel < 0.08, f"tg decay: KE off the analytic decay by {rel:.4f}")


def profile_step(torch, tag, scene, sim):
    """One advection step under torch.profiler: device time by kernel, the
    sweeps' share and the device idle share of the profiled step's wall
    time.  The profiler slows the host side, so the same step is also
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
                                                "ac2_kernel", "visc_tvc_kernel")))
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
        if cfg["noise"]:
            fluid = perturbed(torch, fluid, cfg["dx"])
        sim = sc.make_advection_step(scene)(sc.init_sim(scene, fluid))
        compare_kernels(torch, tag, cfg, scene, sim, results)
        if scene.wall_b is not None:
            moving_wall_check(torch, tag, scene, sim)
        else:
            tg_dissipative_ac2_check(torch, scene, sim)
        del scene, fluid, sim
        torch.cuda.empty_cache()
    small_reference_check(torch, "dambreak_2d", 0.1, 0.08)
    small_reference_check(torch, "taylor_green_2d", 0.05, 0.08)
    tg_decay_check(torch)

    for tag, cfg in CONFIGS.items():
        scene, sim = run_main_path(torch, tag, cfg, results)
        profile_step(torch, tag, scene, sim)
        del scene, sim
        torch.cuda.empty_cache()

    kernels = []
    for tag, cfg in CONFIGS.items():
        for name in cfg["kernels"]:
            r = results[f"{name}[{tag}]"]
            kernels.append({"name": f"{name}[{tag}]", "route": "cuda",
                            "source": SOURCE, "replaces": KERNELS[name][0],
                            "launches": r["launches"],
                            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                            "bound_by": r["bound_by"], "library_ms": None})
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
