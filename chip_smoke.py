#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths — the dual-criteria WCSPH solver on the
cell-block engine — at full size:

  * 2D dambreak, dx=0.0025: 320,000 fluid particles (bench.py:311-318);
  * 3D dambreak, dx=0.01: 1,000,000 fluid particles, cap 32, c_max 125,000;
  * Taylor–Green 2D, dx=0.001: 1,000,000 fluid particles on a 384 x 384
    doubly periodic grid, cap 12, c_max 147,456 (viscous force and
    transport-velocity correction, no wall);
  * 2d16: the 2D dambreak at dx=0.0025 with cap 16, its acoustic sub-steps
    through the first-generation packed halves (B5a-d,
    csrc/packed_sweeps.cu), as benchmarks/micro_sweep.py composed them.

Phases:

  1. environment: torch / CUDA versions, the card's name and power limit;
  2. build: nvcc compiles sphinxsys_tpu_torch/csrc/*.cu, one process per
     source, all started together;
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
     Chrome traces to build/traces/);
  6. 2d16: on the dambreak state after one advection step, B5a-d against
     their plain versions (and with a moving wall and the Dissipative
     solver's constants), timed and bounded; then one advection step's
     acoustic sub-steps through the packed halves and through the *_p2
     halves from the same state (equal sub-step counts, positions within
     5e-5, every packed kernel launched), each route's sub-step time, and
     one packed sub-step under torch.profiler;
  7. layout: on the same state, packed once, B6 and B7
     (csrc/layout_sweeps.cu, two other decompositions of B5a's sweep)
     against their plain versions and both against the B5a kernel, B6 also
     with padding moved into the support, and bounded; then the layout
     drivers (sphinxsys_tpu_torch/benchmarks/exp_layout*.py) on that state,
     launch counts reset just before them and read just after, their
     cross-checks, and B6's, B7's and `prep_t`'s (B7's gather) times from
     their runs.

Every kernel and plain-version time is taken by
sphinxsys_tpu_torch.benchmarks.median_ms, the layout drivers' timer.  Its last two lines are a JSON object of per-kernel
results and {"ok": true, "device": {...}}.  Any failed check exits
non-zero before printing them.  Imports no JAX.
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
PACKED_KERNELS = {  # packed_sweeps wrapper -> (TPU kernel, launch-counter key)
    "ac1_inner_sweep": ("sphinxsys_tpu/ops/pallas_sweep.py:77", "ac1_inner"),
    "ac2_inner_sweep": ("sphinxsys_tpu/ops/pallas_sweep.py:98", "ac2_inner"),
    "ac1_wall_sweep": ("sphinxsys_tpu/ops/pallas_sweep.py:239", "ac1_wall"),
    "ac2_wall_sweep": ("sphinxsys_tpu/ops/pallas_sweep.py:267", "ac2_wall"),
}
PACKED_SOURCE = "sphinxsys_tpu_torch/csrc/packed_sweeps.cu"
# float operations per real pair, counted from csrc/packed_sweeps.cu (add,
# mul, compare, min/max, sqrt and division one each): the pair geometry and
# masked dW/dr 20, then each kernel's own terms
PACKED_PAIR_FLOPS = {"ac1_inner_sweep": 31, "ac2_inner_sweep": 38,
                     "ac1_wall_sweep": 42, "ac2_wall_sweep": 49}
PACKED_DX = 0.0025          # the 2D dambreak at its bench width, cap 16
LAYOUT_KERNELS = {  # layout_sweeps wrapper -> (TPU kernel, launch-counter key)
    "ac1_flat_sweep": ("benchmarks/exp_layout.py:93", "ac1_flat"),
    "ac1_t_sweep": ("benchmarks/exp_layout2.py:80", "ac1_t"),
}
LAYOUT_SOURCE = "sphinxsys_tpu_torch/csrc/layout_sweeps.cu"
# float operations per real pair, counted from csrc/layout_sweeps.cu as
# PACKED_PAIR_FLOPS: the pair geometry 8, the masked dW/dr * V_j 12, the
# force 7 and the density term 4 (B7's rsqrt and r2 * inv_r stand for B6's
# sqrt and division; the per-window and shuffle sums are not per pair)
LAYOUT_PAIR_FLOPS = 31
# the channel planes B7 loads (csrc/layout_sweeps.cu ac1_t_kernel): of xi_t
# x, y, p, mask; of xj_t x, y, p, vol, mask (channels of ops/packed_sweeps)
B7_XI_CHANNELS = (0, 1, 4, 6)
B7_XJ_CHANNELS = (0, 1, 4, 5, 6)
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
# the CUDA kernels' names, for the profile's sweep share
SWEEP_KERNEL_NAMES = ("density_kernel", "ac1_kernel", "ac2_kernel",
                      "visc_tvc_kernel", "ac1_inner_kernel", "ac2_inner_kernel",
                      "ac1_wall_kernel", "ac2_wall_kernel", "ac1_flat_kernel",
                      "ac1_t_kernel")


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


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
    return (*bytes_or_flops(nbytes, flops), inner + wall, flops, nbytes)


def channels(torch, out):
    """A sweep's output as one (C, cap, k) tensor: the packed sweeps return
    (a, b) pairs of (C, cap) / (C, cap, 2) tensors."""
    if torch.is_tensor(out):
        return out
    return torch.cat([a if a.dim() == 3 else a[..., None] for a in out], dim=-1)


def hold(torch, what, got, ref32, ref64, real):
    """A kernel's output `got` against a float32 reference `ref32` and the
    float64 plain version `ref64` of the same function on the same inputs.

    Tolerance, per output channel over the real slots: the kernel's error
    against the float64 plain version must be at most twice the float32
    reference's own error against it, plus 1e-6 * max|ref| — both sum the
    same f32 pair terms in different orders, and the ac1 force cancels
    terms far larger than the sum, so only an error scale measured on the
    same data is meaningful.  As a gross-error guard the kernel must also
    agree with the f32 reference to 1e-3 * max|ref|.  Returns
    max|k - p32|."""
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
        log(f"{what} ch{ch}: max|ref|={scale:.6e} |k-p32|={err_kp:.3e} "
            f"|k-p64|={err_k:.3e} |p32-p64|={err_p:.3e}")
        check(bool(torch.isfinite(k).all()), f"{what} ch{ch}: non-finite")
        check(err_k <= 2.0 * err_p + 1e-6 * scale,
              f"{what} ch{ch}: kernel error {err_k:.3e} vs f64 exceeds "
              f"2x the f32 reference's error {err_p:.3e} + 1e-6 max|ref|")
        limit = 1e-3 * max(scale, 1e-30)
        check(err_kp <= limit,
              f"{what} ch{ch}: kernel vs f32 reference {err_kp:.3e} > {limit:.3e}")
    return max_abs


def compare(torch, what, name, args, kw, real, module=None):
    """One kernel against its plain version on the same inputs, under
    `hold`'s criterion (the f32 reference is the plain version run in
    float32).  Returns (kernel output, max|k - p32|)."""
    from sphinxsys_tpu_torch.ops import block_sweeps as bs

    module = bs if module is None else module
    wrapper, plain = getattr(module, name), getattr(module, name + "_plain")
    got = channels(torch, wrapper(*args, **kw))
    torch.cuda.synchronize()
    ref32 = channels(torch, plain(*args, **kw))
    args64 = [a.double() if torch.is_tensor(a) and a.is_floating_point()
              else a for a in args]
    ref64 = channels(torch, plain(*args64, **kw))
    return got, hold(torch, f"{what} {name}", got, ref32, ref64, real)


def compare_kernels(torch, tag, cfg, scene, sim, results):
    """Phase 3: every kernel of the path against its plain version on the
    same inputs, its times and its bound."""
    from sphinxsys_tpu_torch.benchmarks import median_ms
    from sphinxsys_tpu_torch.ops import block_sweeps as bs

    c = sim.nbr_inner.shape[0]
    real = sim.fluid_b["SlotMask"][:c]
    inputs = sweep_inputs(torch, scene, sim, cfg["kernels"])
    for name, (args, kw) in inputs.items():
        wrapper, plain = getattr(bs, name), getattr(bs, name + "_plain")
        got, max_abs = compare(torch, tag, name, args, kw, real)
        ms = median_ms(lambda: wrapper(*args, **kw), 20, DEVICE)
        plain_ms = median_ms(lambda: plain(*args, **kw), 3, DEVICE)
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


def profile_step(torch, tag, step, what="advection step"):
    """One step (`step()`) under torch.profiler: device time by kernel, the
    sweeps' share and the device idle share of the profiled step's wall
    time.  The profiler slows the host side, so the same step is also
    timed unprofiled (median of 3) and an idle-share estimate is printed
    that divides the profiled device busy by that wall time — two different
    executions, labelled as such.  Writes a Chrome trace to build/traces/."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    plain_wall_us = wall_s(torch, step, 3) * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
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
                    if any(n in e.key for n in SWEEP_KERNEL_NAMES))
    log(f"{tag} profile: profiled {what} wall {wall_us / 1e3:.3f} ms, device busy "
        f"{dev_us / 1e3:.3f} ms (idle share of the profiled step "
        f"{1 - dev_us / wall_us:.3f}), sweep kernels {sweeps_us / 1e3:.3f} ms, "
        f"{len(kern)} kernel kinds")
    log(f"{tag} profile: unprofiled {what} wall {plain_wall_us / 1e3:.3f} ms; "
        f"estimated idle share {1 - dev_us / plain_wall_us:.3f} (profiled "
        f"device busy over unprofiled wall: two executions)")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"{tag} profile:   {e.self_device_time_total / 1e3:9.3f} ms "
            f"x{e.count:<4d} {e.key[:90]}")


# ---------------------------------------------------------------------------
# 2d16: the first-generation packed acoustic halves (B5a-d)
# ---------------------------------------------------------------------------

def packed_inputs(torch, scene, fb, nbr, nbr_wall, dt, wall_b=None,
                  riemann2=None):
    """The four packed sweeps' (args, kw) as the packed halves build them
    from block state `fb` at acoustic dt `dt`; `wall_b` (default: the
    scene's static wall) and `riemann2` (default: the engine's 2nd-half
    solver) may be replaced."""
    from sphinxsys_tpu_torch.physics import fluid_blocks as fbops

    eng = scene.eng
    wall_b = scene.wall_b if wall_b is None else wall_b
    riemann2 = eng.riemann2 if riemann2 is None else riemann2
    _, _, _, pk1, pk1_i = fbops.packed_ac1_inputs(fb, eng.eos, dt)
    _, pk2, pk2_i = fbops.packed_ac2_inputs(fb, dt)
    c1 = fbops.packed_ac1_constants(eng.kernel, eng.riemann1)
    c2 = fbops.packed_ac2_constants(eng.kernel, riemann2)
    return {
        "ac1_inner_sweep": ((pk1, nbr), c1),
        "ac2_inner_sweep": ((pk2, nbr), c2),
        "ac1_wall_sweep": ((pk1_i, fbops.pack_wall_ac1(wall_b), nbr_wall), c1),
        "ac2_wall_sweep": ((pk2_i, fbops.pack_wall_ac2(wall_b), nbr_wall), c2),
    }


def bytes_or_flops(nbytes, flops):
    """(ms, "bytes"|"operations"): the larger of nbytes over the HBM rate
    and flops over the float32 rate."""
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def packed_bound(torch, args, out, pairs, pair_flops, wall=False):
    """The least time the card could take for one packed sweep (ms), as
    `bound` counts it: bytes = the output written once, the window map,
    and once each packed row (16 slots x 8 channels x 4 B = 512 B) the
    sweep needs — for an inner sweep the rows its map reaches, for a wall
    sweep the wall rows its map reaches and the fluid rows that have a wall
    window; flops = the real pairs times `pair_flops`.  Returns (ms,
    "bytes"|"operations", flops, bytes)."""
    table = args[-1]
    src = args[1] if wall else args[0]
    live = table < src.shape[0] - 1
    row_bytes = src[0].numel() * src.element_size()
    nbytes = out.numel() * out.element_size() \
        + table.numel() * table.element_size() \
        + int(torch.unique(table[live]).numel()) * row_bytes
    if wall:
        nbytes += int(torch.any(live, dim=1).sum()) * row_bytes
    flops = pairs * pair_flops
    return (*bytes_or_flops(nbytes, flops), flops, nbytes)


def packed_kernel_phase(torch, scene, sim, results):
    """B5a-d against their plain versions on the same inputs, their times
    and bounds; then the wall sweeps with seeded non-zero wall kinematics
    (the static dambreak wall packs zeros there) and the 2nd-half sweeps
    with the Dissipative solver's constants (limiter 1e30)."""
    from sphinxsys_tpu_torch.benchmarks import median_ms
    from sphinxsys_tpu_torch.engine import block_fluid as eng_mod
    from sphinxsys_tpu_torch.ops import block_sweeps as bs
    from sphinxsys_tpu_torch.ops import packed_sweeps as ps
    from sphinxsys_tpu_torch.physics import riemann as rs

    eng, fb, wb = scene.eng, sim.fluid_b, scene.wall_b
    c = sim.nbr_inner.shape[0]
    real = fb["SlotMask"][:c]
    dt = eng_mod.acoustic_dt(eng, fb)
    inputs = packed_inputs(torch, scene, fb, sim.nbr_inner, sim.nbr_wall, dt)
    pos = inputs["ac1_inner_sweep"][0][0][..., :2]
    inner, wall = real_pairs(torch, pos, fb["SlotMask"], sim.nbr_inner,
                             (0.0, 0.0), eng.kernel.cutoff, wb["Position"],
                             wb["SlotMask"], sim.nbr_wall)
    self_pairs = int(real.sum())
    for name, (args, kw) in inputs.items():
        wrapper, plain = getattr(ps, name), getattr(ps, name + "_plain")
        got, max_abs = compare(torch, "2d16", name, args, kw, real, module=ps)
        ms = median_ms(lambda: wrapper(*args, **kw), 20, DEVICE)
        plain_ms = median_ms(lambda: plain(*args, **kw), 3, DEVICE)
        pairs = inner - self_pairs if name.endswith("inner_sweep") else wall
        bound_ms, bound_by, flops, nbytes = packed_bound(
            torch, args, got, pairs, PACKED_PAIR_FLOPS[name],
            wall=name.endswith("wall_sweep"))
        log(f"2d16 {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {pairs} real pairs, "
            f"{flops:.4e} flop, {nbytes} B), max_abs_err {max_abs:.3e}")
        results[f"{name}[2d16]"] = dict(
            max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, real_pairs=pairs)
    # the *_p2 route's sweeps on the same state, for comparison
    for name, (args, kw) in sweep_inputs(torch, scene, sim,
                                         ("ac1_sweep", "ac2_sweep")).items():
        wrapper = getattr(bs, name)
        log(f"2d16 {name} (B2/B3 on the same state): kernel "
            f"{median_ms(lambda: wrapper(*args, **kw), 20, DEVICE):.4f} ms")

    g = torch.Generator(device=DEVICE).manual_seed(7)
    shape = wb["Position"].shape
    moving = dict(wb, AverageVelocity=0.1 * torch.randn(
        shape, generator=g, device=DEVICE), AverageAcceleration=torch.randn(
        shape, generator=g, device=DEVICE))
    variants = (("moving-wall", dict(wall_b=moving),
                 ("ac1_wall_sweep", "ac2_wall_sweep")),
                ("dissipative", dict(riemann2=rs.dissipative_riemann(eng.eos)),
                 ("ac2_inner_sweep", "ac2_wall_sweep")))
    for what, kw_in, names in variants:
        inp = packed_inputs(torch, scene, fb, sim.nbr_inner, sim.nbr_wall, dt,
                            **kw_in)
        for name in names:
            args, kw = inp[name]
            compare(torch, f"2d16 {what}", name, args, kw, real, module=ps)
            log(f"2d16 {what} {name}: agrees with its plain version")

    # the mask channel as the only guard: padding slots of the neighbour
    # tensor moved into the support of their row's first slot, volume 1
    for name, (args, kw) in inputs.items():
        j = 0 if name.endswith("inner_sweep") else 1
        mask_ch, vol_ch = {"ac1_inner_sweep": (ps.CMASK, ps.CVOL),
                           "ac2_inner_sweep": (ps.CMASK, ps.CVOL),
                           "ac1_wall_sweep": (ps.W1M, ps.W1VOL),
                           "ac2_wall_sweep": (ps.W2M, ps.W2VOL)}[name]
        near_padding_check(torch, ps, name, args, kw, j, mask_ch, vol_ch,
                           eng.kernel.h, real, g)


def near_padding_check(torch, module, name, args, kw, j, mask_ch, vol_ch, h,
                       real, g):
    """`module.name` with the padding slots of its packed argument `j`
    moved into the support of their row's first slot (jitter of up to h/2),
    volume 1: it must agree with its plain version there, and every real
    slot's sums must stay within 1e-6 max|out| of the run without it."""
    pk = args[j]
    pad = pk[..., mask_ch] == 0
    jitter = (torch.rand(pk.shape[:2] + (2,), generator=g, device=DEVICE)
              - 0.5) * h
    near = pk.clone()
    near[..., :2] = torch.where(pad[..., None], pk[:, :1, :2] + jitter,
                                pk[..., :2])
    near[..., vol_ch] = torch.where(pad, torch.ones_like(pad, dtype=pk.dtype),
                                    pk[..., vol_ch])
    near_args = args[:j] + (near,) + args[j + 1:]
    got, _ = compare(torch, "2d16 near-padding", name, near_args, kw, real,
                     module=module)
    ref = channels(torch, getattr(module, name)(*args, **kw))
    diff = float((got - ref)[real].abs().max())
    scale = float(ref[real].abs().max())
    log(f"2d16 near-padding {name}: max |out - out without it| {diff:.3e} "
        f"(max|out| {scale:.3e})")
    check(diff <= 1e-6 * scale,
          f"2d16 near-padding {name}: padding leaks into real slots")


def packed_path(torch, scene, sim, results):
    """One advection step's acoustic sub-steps from `sim` (after its
    density prep, B1) twice: through the packed halves (B5a-d, the main
    path of this configuration, launch counts reset just before it and
    read just after) and through the *_p2 halves (B2/B3).  Equal sub-step
    counts, real-slot positions within 5e-5 (small_reference_check's
    limit), velocity and density within 1e-3 max|ref|, finite fields; then
    each route's sub-step wall time in turns, and one packed sub-step
    under torch.profiler."""
    from sphinxsys_tpu_torch.engine import block_fluid as eng_mod
    from sphinxsys_tpu_torch.ops import packed_sweeps as ps
    from sphinxsys_tpu_torch.physics import fluid_blocks as fbops

    eng, nbr, nbr_w = scene.eng, sim.nbr_inner, sim.nbr_wall
    wc = eng_mod.WallCtx(scene.wall_b, nbr_w)
    dt_adv = eng_mod.advection_dt(eng, sim.fluid_b)
    fb0 = eng_mod.advection_prep(eng, sim.fluid_b, nbr, wc)
    w1 = fbops.pack_wall_ac1(scene.wall_b)
    w2 = fbops.pack_wall_ac2(scene.wall_b)

    def packed_substep(fb, dt):
        fb = fbops.acoustic_step_1st_half_packed(
            fb, nbr, eng.kernel, eng.eos, eng.riemann1, dt, wall_packed=w1,
            nbr_wall=nbr_w)
        return fbops.acoustic_step_2nd_half_packed(
            fb, nbr, eng.kernel, eng.riemann2, dt, wall_packed=w2,
            nbr_wall=nbr_w)

    def p2_substep(fb, dt):
        fb = eng_mod.acoustic_first_half(eng, fb, nbr, wc, dt)
        return eng_mod.acoustic_second_half(eng, fb, nbr, wc, dt)

    def relax(substep):
        fb, t, n = fb0, torch.zeros_like(dt_adv), 0
        while bool(t < dt_adv):
            dt = eng_mod.acoustic_dt(eng, fb, dt_adv)
            fb = substep(fb, dt)
            t = t + dt
            n += 1
        return fb, n

    ps.reset_launch_counts()
    got, n_got = relax(packed_substep)
    counts = dict(ps.LAUNCHES)
    torch.cuda.synchronize()
    ref, n_ref = relax(p2_substep)
    real = fb0["SlotMask"]
    check(n_got == n_ref, f"2d16: {n_got} packed sub-steps, {n_ref} p2 ones")
    for k in ("Position", "Velocity", "Density", "Pressure"):
        check(bool(torch.isfinite(got[k][real]).all()), f"2d16: non-finite {k}")
    dpos = float((got["Position"][real] - ref["Position"][real]).abs().max())
    errs = {}
    for k in ("Velocity", "Density"):
        scale = float(ref[k][real].abs().max())
        errs[k] = float((got[k][real] - ref[k][real]).abs().max())
        check(errs[k] <= 1e-3 * scale,
              f"2d16: {k} differs by {errs[k]:.3e} > 1e-3 max|ref| {scale:.3e}")
    log(f"2d16 path: {n_got} acoustic sub-steps on each route, max |dpos| "
        f"{dpos:.3e}, max |dvel| {errs['Velocity']:.3e}, max |drho| "
        f"{errs['Density']:.3e}, packed launches {counts}")
    check(dpos <= 5e-5, f"2d16: positions differ by {dpos:.3e}")
    for name, (_, key) in PACKED_KERNELS.items():
        check(counts[key] > 0, f"2d16: kernel {name} never launched")
        results[f"{name}[2d16]"]["launches"] = counts[key]

    dt = eng_mod.acoustic_dt(eng, fb0, dt_adv)
    routes = {"p2": p2_substep, "packed": packed_substep}
    turns = [(r, wall_s(torch, lambda: routes[r](fb0, dt), 5) * 1e3)
             for r in ("p2", "packed", "packed", "p2")]
    log("2d16 acoustic sub-step wall clock (ms, median of 5, in turns): "
        + ", ".join(f"{r} {ms:.3f}" for r, ms in turns))
    results["_2d16_main"] = dict(
        n_ac=n_got, dpos=dpos, substep_ms={
            r: [ms for q, ms in turns if q == r] for r in routes})
    profile_step(torch, "2d16", lambda: packed_substep(fb0, dt),
                 what="packed acoustic sub-step")


# ---------------------------------------------------------------------------
# layout: B6 and B7, two other decompositions of B5a's sweep
# ---------------------------------------------------------------------------

def layout_phase(torch, scene, sim, results):
    """On the 2d16 state (the engine's fields after one advection step,
    packed once by `pack_layout_state` and shared with the drivers): B6
    and B7 against their plain versions, B6 with padding moved into the
    support, and both against the B5a kernel on the same packed tensor
    (three kernels, one function); then both layout drivers at PACKED_DX
    on that state, launch counts reset just before them and read just
    after, their cross-checks, and from their timings each kernel's ms and
    plain ms beside its bound."""
    from sphinxsys_tpu_torch.benchmarks import (
        b5a_channels, exp_layout, exp_layout2, pack_layout_state,
    )
    from sphinxsys_tpu_torch.ops import layout_sweeps as ls
    from sphinxsys_tpu_torch.ops import packed_sweeps as ps

    t0 = time.perf_counter()
    st = pack_layout_state(scene, sim)
    pk, nbr, mask = st["packed"], st["nbr"], sim.fluid_b["SlotMask"]
    c = nbr.shape[0]
    real = mask[:c]
    consts = dict(inv_h=st["inv_h"], factor_w=st["factor_w"],
                  inv_rho0c0=st["inv_rho0c0"])
    inner, _ = real_pairs(torch, pk[..., :2], mask, nbr, (0.0, 0.0),
                          scene.eng.kernel.cutoff)
    pairs = inner - int(real.sum())
    # slot pairs evaluated: B5a and B6 visit the live windows, B7 all
    visited = {"ac1_flat_sweep": int((nbr < c).sum()) * ps.CAP ** 2,
               "ac1_t_sweep": c * ps.NW * ps.CAP ** 2}
    xi_t, xj_t = ls.prep_t(pk, nbr)
    b5a32 = torch.stack(b5a_channels(ps.ac1_inner_sweep, st), dim=-1)
    b5a64 = torch.stack(b5a_channels(ps.ac1_inner_sweep_plain,
                                     dict(st, packed=pk.double())), dim=-1)
    g = torch.Generator(device=DEVICE).manual_seed(9)
    checked = {}
    for name, args, transposed in (("ac1_flat_sweep", (pk, nbr), False),
                                   ("ac1_t_sweep", (xi_t, xj_t), True)):
        got, max_abs = compare(torch, "2d16 layout", name, args, consts,
                               real.t() if transposed else real, module=ls)
        as_b5a = got.transpose(0, 1) if transposed else got
        hold(torch, f"2d16 layout {name} vs the B5a kernel", as_b5a, b5a32,
             b5a64, real)
        log(f"2d16 layout {name}: agrees with its plain version and with B5a")
        if transposed:    # the channel planes it loads, and its output
            nbytes = got.numel() * got.element_size() + sum(
                t.numel() // ps.CH * len(chs) * t.element_size()
                for t, chs in ((xi_t, B7_XI_CHANNELS), (xj_t, B7_XJ_CHANNELS)))
            flops = pairs * LAYOUT_PAIR_FLOPS
            bound_ms, bound_by = bytes_or_flops(nbytes, flops)
        else:             # the same bytes as B5a
            bound_ms, bound_by, flops, nbytes = packed_bound(
                torch, args, got, pairs, LAYOUT_PAIR_FLOPS)
        checked[name] = (max_abs, bound_ms, bound_by, flops, nbytes)
    # B7's padding arrives pre-gathered, so only B6 takes this guard
    near_padding_check(torch, ls, "ac1_flat_sweep", (pk, nbr), consts, 0,
                       ps.CMASK, ps.CVOL, scene.eng.kernel.h, real, g)
    del xi_t, xj_t, b5a32, b5a64
    torch.cuda.empty_cache()

    ls.reset_launch_counts()
    ps.reset_launch_counts()
    drivers = {m.__name__.rsplit(".", 1)[-1]:
               m.run(dx=PACKED_DX, device=DEVICE, state=st)
               for m in (exp_layout, exp_layout2)}
    counts = dict(ls.LAUNCHES, ac1_inner=ps.LAUNCHES["ac1_inner"])
    torch.cuda.synchronize()
    log(f"layout drivers: launches {counts}")
    for tag, out in drivers.items():
        check(out["agree"], f"{tag}: cross-checks disagree {out['cross_check']}")
    for key in counts:
        check(counts[key] > 0, f"layout drivers: kernel {key} never launched")
    t1, t2 = drivers["exp_layout"]["ms"], drivers["exp_layout2"]["ms"]
    timed = {  # (kernel ms, plain ms) from the drivers' runs
        "ac1_flat_sweep": (t1["d) B6 kernel (C,256) threads"],
                           t1["b) plain (C,256) flat"]),
        "ac1_t_sweep": (t2["c2) B7 kernel alone"],
                        t2["b2) plain (16,16,C) transposed alone"])}
    prep_ms = t2["g) prep_t (gather + transpose)"]
    for name, (_, key) in LAYOUT_KERNELS.items():
        ms, plain_ms = timed[name]
        max_abs, bound_ms, bound_by, flops, nbytes = checked[name]
        log(f"2d16 {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {pairs} real pairs, "
            f"{flops:.4e} flop, {nbytes} B), max_abs_err {max_abs:.3e}; "
            f"{visited[name]} slot pairs evaluated")
        results[f"{name}[2d16]"] = dict(
            max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, real_pairs=pairs, launches=counts[key])
    log(f"2d16 layout: B5a {t1['c) B5a kernel (C,16) threads']:.4f} ms, "
        f"prep_t {prep_ms:.4f} ms in the same drivers' runs")
    results["_layout_main"] = dict(prep_t_ms=prep_ms, drivers={
        tag: dict(ms=out["ms"], cross_check=out["cross_check"])
        for tag, out in drivers.items()})
    del st
    torch.cuda.empty_cache()
    log(f"layout phase: {time.perf_counter() - t0:.1f} s")


def packed_phase(torch, results):
    """The 2d16 configuration: the 2D dambreak at its bench width with
    cap 16, after one advection step of the engine."""
    from sphinxsys_tpu_torch.cases import dambreak_2d as db
    from sphinxsys_tpu_torch.engine import scene as sc
    from sphinxsys_tpu_torch.ops import packed_sweeps as ps

    scene, fluid = db.build_block_case(dx=PACKED_DX, device=DEVICE, cap=ps.CAP)
    sim = sc.make_advection_step(scene)(sc.init_sim(scene, fluid))
    check(not bool(sim.overflow), "2d16: block capacity overflow")
    log(f"2d16: n_fluid={scene.n_fluid} n_wall={scene.base.n_wall} "
        f"grid={scene.eng.grid.shape} c_max={scene.eng.c_max} "
        f"cap={scene.eng.cap} wall c_max={scene.bm_wall.c_max}")
    packed_kernel_phase(torch, scene, sim, results)
    packed_path(torch, scene, sim, results)
    layout_phase(torch, scene, sim, results)


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

    libs, build_log, build_s = _build.build()
    log(f"build: {', '.join(so.name for so in libs)} in {build_s:.1f} s")
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
        step = sc.make_advection_step(scene)
        profile_step(torch, tag, lambda: step(sim))
        del scene, sim, step
        torch.cuda.empty_cache()
    packed_phase(torch, results)

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
    for table, source in ((PACKED_KERNELS, PACKED_SOURCE),
                          (LAYOUT_KERNELS, LAYOUT_SOURCE)):
        for name, (replaces, _) in table.items():
            r = results[f"{name}[2d16]"]
            kernels.append({"name": f"{name}[2d16]", "route": "cuda",
                            "source": source, "replaces": replaces,
                            "launches": r["launches"],
                            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                            "plain_ms": r["plain_ms"],
                            "bound_ms": r["bound_ms"],
                            "bound_by": r["bound_by"], "library_ms": None})
    main_paths = {tag: results[f"_{tag}_main"]
                  for tag in (*CONFIGS, "2d16", "layout")}
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
