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
    through the packed halves (B5a-d, csrc/packed_sweeps.cu), as
    benchmarks/micro_sweep.py composed them;
  * tc1m: the twisting column on the lattice-stencil solid at dx=0.0175
    (bench.py:330): 349 x 57 x 57 = 1,133,901 sites, 80 taps, its two tap
    sums through L1 / L2 (csrc/lattice_sweeps.cu), and on the gather
    engine (frozen neighbour lists, torch ops);
  * fsi2 at its reference resolution dx=0.1: 5,180 fluid, 1,104 wall and
    150 solid particles, the wall and the elastic beam one moving
    wall-type body on an x-periodic grid, through B1-B4's moving-wall,
    periodic variants;
  * the gather fluid routes (neighbour lists, torch ops): the 2D and 3D
    dambreaks at the widths above, Taylor–Green and fsi2.

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
     with a static and a moving wall on the 2D dambreak; for B1-B4 the
     lane x slot pairs their lane groups evaluate, and, in 2D and 3D,
     padding where the first design never met it (holes: a real slot
     swapped with its row's last padding slot, B1's mask moved with it;
     near padding: padding moved into the support, VOL 0 and mask 0, real
     slots unchanged within 1e-6; B4 with a static and a moving wall);
     then B1-B4 at cap 40 (3D, dx=0.05: two i-chunks a cell, also with
     holes, so that the second chunk holds real slots);
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
     their plain versions (and with a moving wall, the Dissipative
     solver's constants and padding of volume 1 moved into the support),
     timed and bounded, with the lane x slot pairs B5a/B5b evaluate, the
     B2/B3 times on the same state, a check that window 4 is each cell's
     own row (B5a/B5b drop the self pair by slot index), B5a/B5b with
     holes (real slots unchanged through the swap within 1e-6) and with
     coincident particles, and B5c/B5d with holes in the i-rows and the
     wall rows (the same criterion) and with every wall row made full,
     beside the slot pairs their lane groups evaluate and their first
     design's; then one advection step's
     acoustic sub-steps through the packed halves and through the *_p2
     halves from the same state (equal sub-step counts, positions within
     5e-5, every packed kernel launched), each route's sub-step time, and
     one packed sub-step under torch.profiler;
  7. layout: on the same state, packed once, B6 and B7
     (csrc/layout_sweeps.cu, two other decompositions of B5a's sweep)
     against their plain versions and both against the B5a kernel, and
     bounded, with the pairs each evaluates beside its first design's; both
     with holes (real slots unchanged through the swap within 1e-6), with
     coincident particles and with padding of volume 1 moved into the
     support, B7 always through `prep_t`, and B7 at C - 3 cells (4-byte
     copies, a ragged last tile); then the layout drivers
     (sphinxsys_tpu_torch/benchmarks/exp_layout*.py) on that state, launch
     counts reset just before them and read just after, their
     cross-checks, and B6's, B7's and `prep_t`'s (B7's gather) times from
     their runs;
  8. lattice solid: the plain path on the card (use_kernels=False, JAX's
     tap loops as torch ops): its step time and, from one profiled step,
     its device launches; the main path (build_case -> init_sim ->
     make_run_chunk, >= 40 steps, counts reset just before, L1 and L2
     once a step, fields finite, the holder at its initial positions), the
     step by part, one profiled step and pair_interaction_updates_per_sec
     counted as bench.py:239-242 counts it; L1 and L2 against their plain
     versions on that state and on it notched with NaN planted in the
     notch, timed and bounded beside each design's occupancy, L2 also
     beside its library yardstick (one grouped conv3d, never called by
     the port); L1 and L2 where their staged bricks could break: a ragged
     37 x 13 x 11 lattice with a notch and scattered NaN sites, lattices
     one site thick in x, y and z, a brick all invalid next to valid ones;
     the dx=0.1 column through the kernels against the plain versions to
     t=0.02 (equal step counts, positions within 5e-5 of max|x|) and to
     t=0.5 against the JAX package's own float32 tip curve (every one of
     its 140 snapshots) and the committed one (its first 99);
  9. fsi2 (between phases 5 and 6): B1-B4 against their plain versions on
     the state at t=0.5 (also with holes, padding near the real slots and
     coincident particles), timed and bounded; the kernels and the block
     forms on the card to t=0.1 (equal counts, states within
     FSI2_SHORT_TOL); the main path to t=5 (build_block_case ->
     init_block_sim -> make_run_chunk, counts reset just before it, the
     host reads of device values counted) held to the spread of the JAX
     package's own float32 runs (`fsi2_gates`: sub-step counts, tip
     excursion); the step by part and profiled, with the torch-op FSI
     couplings and solid sub-step on their own;
 10. gather solid (inside phase 8): at dx=0.0175 the frozen topology
     built on the card (time, peak memory), GATHER_STEPS steps from the
     lattice main path's state against that path's (positions within
     GATHER_POS_TOL of max|x|), its step profiled; the dx=0.1 column on
     the gather engine to t=0.5 against the JAX curve;
 11. gather fluid (last): the neighbour-list routes (`init_sim` /
     `make_run_chunk` of the dambreaks, Taylor–Green and fsi2: lists
     rebuilt every advection step, the pair sums torch ops over them, no
     hand kernel): the dambreak (dx=0.1, to t=0.08) and Taylor–Green
     (dx=0.05) on the card against the CPU; the third oracle, the gather
     route against the block route's kernels on the scenes of
     tests/test_scene_engines.py (equal counts, positions within 2e-3 of
     max|x|); Taylor–Green at dx=0.01 to t=0.1 against the analytic
     decay; the 2D dambreak at dx=0.0025 (5 advection steps, the Morton
     resort every 2nd) and the 3D one at dx=0.01 (the case's capacities,
     2 steps) through solver.run_simulation, the block kernels' launch
     counts reset just before and read just after (the route launches
     none), no overflow, finite fields, energy drift < 1%, then the step
     by part (rebuild, density summation, acoustic sub-step, resort) with
     each part's peak device memory, one profiled step, each part
     profiled alone (its device time and launches: the pair sums against
     the rebuild) and the run's peak memory, beside phase 5's block-route
     figures; fsi2's gather route to t=0.1 against the CPU and to
     FSI2_T_END, held to the JAX gather runs' count band and the tip
     envelope (`fsi2_gather_gates`), its step by part and profiled, and
     each part profiled alone.

Every kernel and plain-version time is taken by
sphinxsys_tpu_torch.benchmarks.median_ms, the layout drivers' timer.  Its last two lines are a JSON object of per-kernel
results and {"ok": true, "device": {...}}.  Any failed check exits
non-zero before printing them.  Imports no JAX.
"""

from __future__ import annotations

import dataclasses
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
# sqrt and division; B7's per-window sums are not per pair).  Kept as the
# first designs were bounded, so that the bounds of all designs compare.
LAYOUT_PAIR_FLOPS = 31
# the channel planes B7 reads (csrc/layout_sweeps.cu ac1_t_kernel; channels
# of ops/packed_sweeps): of xi_t x, y, p and mask, whole; of xj_t the mask,
# whole, and x, y, p and vol on the j-rows its tiles stage
B7_XI_CHANNELS = (0, 1, 4, 6)
B7_XJ_STAGED = (0, 1, 4, 5)
LATTICE_KERNELS = {  # lattice_sweeps wrapper -> (what it stands in for, counter key)
    "lattice_force": ("sphinxsys_tpu/physics/solid_lattice.py:285 (the tap loop "
                      "of decomposed_integration_1st_half_lattice :241; "
                      "XLA-fused, no Pallas kernel)", "lattice_force"),
    "lattice_dfdt": ("sphinxsys_tpu/physics/solid_lattice.py:335 (the tap loop "
                     "of integration_2nd_half_lattice :314; XLA-fused, no "
                     "Pallas kernel)", "lattice_dfdt"),
}
LATTICE_SOURCE = "sphinxsys_tpu_torch/csrc/lattice_sweeps.cu"
SOLID_DX = 0.0175          # the bench's lattice solid (bench.py:330)
SOLID_STEPS = 40           # bench.py's BENCH_STEPS
SOLID_GOLDEN = ("tests/golden/refdb/twisting_column_3d/"
                "MyObserver_Position_Run_0_result.xml")
# the leading snapshots of SOLID_GOLDEN that the JAX package's own float32
# run (CPU) reproduces within 0.1; it leaves the curve after them, and ends
# after 140 snapshots where the curve has 142
# (tests/test_torch_solid_lattice.py::test_golden_tip_curve_span)
GOLDEN_HELD = 99
# the JAX package's own float32 lattice run on the CPU, written by
# tests/test_torch_solid_lattice.py (140 snapshots), and how far the card's
# run may stray from it over all of them (measured gaps: PERF.md section 6)
JAX_CURVE = "tests/golden_torch/twisting_column_3d/tip_x.json"
JAX_CURVE_BOUND = 0.05
# the gather solid at the bench's dx (phase 10): steps from the lattice main
# path's state, and how far its positions may stray from that path's, of
# max|x| (float32 sums in other orders, B formed in float32 where the
# lattice forms it in float64 and rounds it)
GATHER_STEPS = 5
GATHER_POS_TOL = 1e-5
# fsi2 (phase 9) at its reference resolution: B1-B4 held on the state at
# FSI2_MID; the kernel and block-form routes to FSI2_SHORT, held to
# FSI2_SHORT_TOL (absolute, in positions and velocities: float32 sums in
# other orders, measured 3.1e-6 in velocity on the CPU); the kernels to
# FSI2_T_END, held to the spread of the JAX package's own float32 runs
# (FSI2_JAX_RUNS, `fsi2_gates`)
FSI2_DX = 0.1
FSI2_MID = 0.5
FSI2_SHORT = 0.1
FSI2_SHORT_TOL = 5e-5
FSI2_T_END = 5.0
FSI2_SAMPLE = 0.05
FSI2_JAX_RUNS = "tests/golden_torch/fsi2/jax_f32_runs.json"
FSI2_COUNT_BAND = 0.2
# the gather fluid (phase 11): the dambreaks at the block route's widths,
# the 2D one resorted every 2nd advection step; the third oracle's scenes
# (tests/test_scene_engines.py)
GATHER_CONFIGS = {
    "2d": dict(module="dambreak_2d", dx=0.0025, min_adv=5, sort_every=2),
    "3d": dict(module="dambreak_3d", dx=0.01, min_adv=2, sort_every=None),
}
GATHER_ORACLE_SCENES = (
    ("dambreak_2d", 0.1, 0.30, dict(cap=16)),
    ("dambreak_3d", 0.2, 0.20, dict(cap=48)),
    ("taylor_green_2d", 0.05, 0.05, {}),
)
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
                      "ac1_t_kernel", "lattice_force_kernel",
                      "lattice_dfdt_kernel")


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
    from sphinxsys_tpu_torch.benchmarks import wall_blocks

    eng, wb = scene.eng, wall_blocks(scene, sim)
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
    from sphinxsys_tpu_torch.benchmarks import median_ms, sweep_inputs
    from sphinxsys_tpu_torch.ops import block_sweeps as bs

    c = sim.nbr_inner.shape[0]
    real = sim.fluid_b["SlotMask"][:c]
    inputs = sweep_inputs(scene, sim, cfg["kernels"])
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
        evaluated, split = slot_pairs_evaluated(torch, name, args,
                                                sim.fluid_b["SlotMask"])
        log(f"{tag} {name}: {evaluated} lane x slot pairs evaluated "
            f"(G={lane_group(args[0].shape[1])}; {pairs} real pairs; "
            f"{split:.3f} of the cells split), "
            f"{ms * 1e9 / evaluated:.4f} ps each")


def moving_wall_check(torch, tag, scene, sim):
    """The moving-wall kernel variants (wall velocity / acceleration
    channels present) against their plain versions on the same inputs
    with seeded non-zero wall kinematics; and B4, which the dambreak does
    not run, with the static and the moving wall on the same inputs."""
    from sphinxsys_tpu_torch.benchmarks import sweep_inputs

    g = torch.Generator(device=DEVICE).manual_seed(7)
    wb = scene.wall_b
    wvel = torch.randn(wb["Position"].shape, generator=g, device=DEVICE) * 0.1
    wacc = torch.randn(wb["Position"].shape, generator=g, device=DEVICE)
    c = sim.nbr_inner.shape[0]
    real = sim.fluid_b["SlotMask"][:c]
    inputs = sweep_inputs(scene, sim, tuple(KERNELS))
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


def lane_group(cap):
    """Lanes per cell of the block-sweep kernels (csrc/block_sweeps.cu)."""
    return 16 if cap <= 16 else 32


def slot_pairs_evaluated(torch, name, args, real):
    """(lane x slot pairs a block sweep evaluates, share of split cells)
    from the block map: for every cell and i-chunk of G lanes holding a
    real slot, G times the real j-slots (VOL > 0; B1's fluid rows: mask)
    of its live windows, fluid and wall; a cell whose real i-slots fit in
    half the group splits them between its halves (evaluating about half
    as many per lane)."""
    fluid, wall, maps, _ = READS[name]
    nbr, nbr_w = (args[i] for i in maps)
    vol = args[fluid[-1]]
    c, cap = nbr.shape[0], vol.shape[1]
    g = lane_group(cap)
    n_j = (vol > 0).sum(dim=1)
    per_cell = n_j[nbr.long()].sum(dim=1)
    if nbr_w is not None:
        per_cell = per_cell + (args[wall[1]] > 0).sum(dim=1)[nbr_w.long()].sum(dim=1)
    chunks = torch.stack([real[:c, i0:i0 + g].any(dim=1)
                          for i0 in range(0, cap, g)], dim=1)
    live = chunks.sum(dim=1)
    split = ~real[:c, g // 2:].any(dim=1) & (live > 0)
    return (int((per_cell * live).sum()) * g,
            float(split.sum()) / max(int((live > 0).sum()), 1))


def swap_holes(torch, name, args, mask, wall_mask):
    """Block-sweep arguments with, in every row whose first slot is real
    and last slot padding, the two slots' data swapped (fluid and wall
    blocks; every array in READS, B1's mask too): padding then sits
    mid-row and a real slot in the last i-chunk.  Returns (args, the fluid
    slot mask after the swap)."""
    fluid, wall, _, _ = READS[name]
    args = list(args)

    def perm(m):
        cap = m.shape[1]
        idx = torch.arange(cap, device=m.device).repeat(m.shape[0], 1)
        swap = m[:, 0] & ~m[:, -1]
        idx[swap, 0] = cap - 1
        idx[swap, -1] = 0
        return idx

    for ids, m in ((fluid, mask), (wall, wall_mask)):
        idx = perm(m)
        for i in ids:
            a = args[i]
            if a is not None:
                ix = idx if a.dim() == 2 else idx[..., None].expand_as(a)
                args[i] = torch.gather(a, 1, ix).contiguous()
    return args, torch.gather(mask, 1, perm(mask))


def padding_checks(torch, tag, scene, sim, g):
    """B1-B4 with padding where the first design never met it, each against
    its plain version on the same inputs (B2/B3 with a moving wall, B4 with
    a static and a moving one): `holes`, a real slot swapped with its row's
    last padding slot, fluid and wall (padding mid-row); `near padding`,
    every padding position moved into the support of its row's first slot
    (jitter up to h/2), VOL and mask kept 0, whose real slots must stay
    within 1e-6 max|out| of the run without the move."""
    from sphinxsys_tpu_torch.benchmarks import sweep_inputs, wall_blocks
    from sphinxsys_tpu_torch.ops import block_sweeps as bs

    wb, fb = wall_blocks(scene, sim), sim.fluid_b
    c = sim.nbr_inner.shape[0]
    real = fb["SlotMask"][:c]
    h = scene.eng.kernel.h
    shape = wb["Position"].shape
    wacc = torch.randn(shape, generator=g, device=DEVICE)
    wvel = 0.1 * torch.randn(shape, generator=g, device=DEVICE)
    inputs = sweep_inputs(scene, sim, tuple(KERNELS))
    cases = (("density_sweep", "", None, None),
             ("ac1_sweep", "", 8, wacc), ("ac2_sweep", "", 6, wvel),
             ("visc_tvc_sweep", " static-wall", 6, None),
             ("visc_tvc_sweep", " moving-wall", 6, wvel))
    for name, wall_kind, slot, extra in cases:
        args, kw = inputs[name]
        args = list(args)
        if slot is not None:
            args[slot] = extra
        what = f"{tag}{wall_kind}"
        holed, mask = swap_holes(torch, name, args, fb["SlotMask"],
                                 wb["SlotMask"])
        compare(torch, f"{what} holes", name, holed, kw, mask[:c])
        log(f"{what} holes {name}: agrees with its plain version")

        near = list(args)
        for i, m in ((0, fb["SlotMask"]), (READS[name][1][0], wb["SlotMask"])):
            p = near[i]
            jitter = (torch.rand(p.shape, generator=g, device=DEVICE) - 0.5) * h
            near[i] = torch.where(m[..., None], p, p[:, :1] + jitter)
        got, _ = compare(torch, f"{what} near-padding", name, near, kw, real)
        ref = getattr(bs, name)(*args, **kw)
        diff = float((got - ref)[real].abs().max())
        scale = float(ref[real].abs().max())
        log(f"{what} near-padding {name}: max |out - out without it| "
            f"{diff:.3e} (max|out| {scale:.3e})")
        check(diff <= 1e-6 * scale,
              f"{what} near-padding {name}: padding leaks into real slots")


def cap40_check(torch):
    """B1-B4 at cap 40 (the 3D dambreak's default, dx=0.05), where the
    lane group sweeps a cell in two i-chunks: against their plain versions
    after one advection step (B4 with the static wall), and with holes
    (`swap_holes`) so that the second chunk holds real slots."""
    from sphinxsys_tpu_torch.benchmarks import sweep_inputs
    from sphinxsys_tpu_torch.cases import dambreak_3d as db
    from sphinxsys_tpu_torch.engine import scene as sc

    t0 = time.perf_counter()
    scene, fluid = db.build_block_case(dx=0.05, device=DEVICE)
    sim = sc.make_advection_step(scene)(sc.init_sim(scene, fluid))
    c, cap = sim.nbr_inner.shape[0], scene.eng.cap
    check(cap > lane_group(cap), f"cap40: cap {cap} fits one i-chunk")
    fb, wb = sim.fluid_b, scene.wall_b
    for name, (args, kw) in sweep_inputs(scene, sim, tuple(KERNELS)).items():
        compare(torch, "3d cap40", name, args, kw, fb["SlotMask"][:c])
        holed, mask = swap_holes(torch, name, args, fb["SlotMask"],
                                 wb["SlotMask"])
        check(bool(mask[:c, lane_group(cap):].any()),
              "cap40: no real slot in the second i-chunk")
        compare(torch, "3d cap40 holes", name, holed, kw, mask[:c])
        log(f"3d cap40 {name}: agrees with its plain version, also with "
            f"real slots in its second i-chunk")
    log(f"cap40: n_fluid={scene.n_fluid} cap={cap} c_max={scene.eng.c_max} "
        f"in {time.perf_counter() - t0:.1f} s")


def tg_dissipative_ac2_check(torch, scene, sim):
    """The Taylor–Green path passes B3 no dissipation (the No solver); B3's
    force channel with the box is held here with the 1st-half acoustic
    solver's constants instead, on the same inputs."""
    from sphinxsys_tpu_torch.benchmarks import sweep_inputs
    from sphinxsys_tpu_torch.physics import fluid_blocks as fbops

    args, kw = sweep_inputs(scene, sim, ("ac2_sweep",))["ac2_sweep"]
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
        "reslot": wall_s(torch, lambda: sc._slot(scene, flat, valid, sim.aux), 5),
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
    executions, labelled as such.  Writes a Chrome trace to build/traces/.
    Returns (device busy us, profiled wall us, unprofiled wall us, device
    launches: kernels, copies and sets)."""
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
    launches = sum(e.count for e in kern)
    log(f"{tag} profile: {launches} device launches (kernels, copies, sets)")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"{tag} profile:   {e.self_device_time_total / 1e3:9.3f} ms "
            f"x{e.count:<4d} {e.key[:90]}")
    return dev_us, wall_us, plain_wall_us, launches


# ---------------------------------------------------------------------------
# 2d16: the first-generation packed acoustic halves (B5a-d)
# ---------------------------------------------------------------------------

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


def own_row_check(torch, nbr):
    """B5a/B5b drop the self pair by slot index; that is JAX's (window 4,
    j == i) test where window 4 of every live cell is its own block row
    and no other window repeats it (no periodic box)."""
    c = nbr.shape[0]
    own = nbr[:, 4] == torch.arange(c, device=nbr.device, dtype=nbr.dtype)
    empty = (nbr == c).all(dim=1)
    others = torch.cat([nbr[:, :4], nbr[:, 5:]], dim=1)
    check(bool((own | empty).all()),
          "2d16: window 4 of a live cell is not its own block row")
    check(not bool(((others == nbr[:, 4:5]) & own[:, None]).any()),
          "2d16: another window repeats a cell's own block row")
    log(f"2d16: nbr[:, 4] is the own row of each of the {int(own.sum())} "
        f"live cells and no other window repeats it ({int(empty.sum())} "
        f"empty rows)")


def packed_slot_pairs(torch, ps, packed, nbr):
    """(slot pairs B5a/B5b's first design evaluated, lane x slot pairs its
    lane groups evaluate, share of split cells), from the packed map: the
    first design 16 x 16 per live window of every cell; a lane group 16
    lanes times the real j-slots (mask != 0) of its live windows, for every
    cell with a real slot (a split cell's lanes each take about half)."""
    c = nbr.shape[0]
    real = packed[..., ps.CMASK] != 0          # the sentinel row: none
    before = int((nbr < c).sum()) * ps.CAP ** 2
    per_cell = real.sum(dim=1)[nbr.long()].sum(dim=1)
    has = real[:c].any(dim=1)
    after = int((per_cell * has).sum()) * ps.CAP
    split = has & ~real[:c, ps.CAP // 2:].any(dim=1)
    return before, after, float(split.sum()) / max(int(has.sum()), 1)


def packed_holes(torch, ps, packed, mask_ch=None):
    """`packed` with, in every row whose first slot is real and last slot
    padding (mask channel `mask_ch`, default the inner layout's), the two
    slots swapped (padding mid-row, a real slot in the upper half); and the
    swap, new[r, k] = old[r, idx[r, k]]."""
    m = packed[..., ps.CMASK if mask_ch is None else mask_ch] != 0
    idx = torch.arange(ps.CAP, device=packed.device).repeat(packed.shape[0], 1)
    swap = m[:, 0] & ~m[:, -1]
    idx[swap, 0] = ps.CAP - 1
    idx[swap, -1] = 0
    return torch.gather(packed, 1, idx[..., None].expand_as(packed)), idx


def lane_group_checks(torch, ps, module, inputs, base, c, tag="2d16",
                      prep=None, transposed=()):
    """`module`'s packed sweeps where their first designs never met it,
    each against its plain version on the same inputs: `holes`
    (packed_holes; every real slot's sums must stay within 1e-6 max|out|
    of the run without the swap), and `coincident`, slot 1's particle
    moved onto slot 0's position in every row where both are real (a real
    pair at r = 0 that is not the self pair).  `inputs`: {name: ((packed,
    nbr), kw)}; `base`: each sweep's output on them as (C, 16, 3).
    `prep(name, packed, nbr)`, if given, makes a sweep's arguments (B7's
    `prep_t`); a sweep named in `transposed` returns (16, C) sums."""
    prep = prep or (lambda name, pk, nbr: (pk, nbr))
    for name, ((pk, nbr), kw) in inputs.items():
        t = name in transposed
        holed, idx = packed_holes(torch, ps, pk)
        real_h = (holed[..., ps.CMASK] != 0)[:c]
        got, _ = compare(torch, f"{tag} holes", name, prep(name, holed, nbr),
                         kw, real_h.t() if t else real_h, module=module)
        got = got.transpose(0, 1) if t else got
        back = torch.gather(got, 1, idx[:c, :, None].expand_as(got))
        m = pk[..., ps.CMASK] != 0
        real = m[:c]
        diff = float((back - base[name])[real].abs().max())
        scale = float(base[name][real].abs().max())
        log(f"{tag} holes {name}: agrees with its plain version; max |out - "
            f"out without the swap| {diff:.3e} (max|out| {scale:.3e})")
        check(diff <= 1e-6 * scale,
              f"{tag} holes {name}: real slots moved through the swap")
        both = m[:, 0] & m[:, 1]
        co = pk.clone()
        co[both, 1, :2] = co[both, 0, :2]
        compare(torch, f"{tag} coincident", name, prep(name, co, nbr), kw,
                real.t() if t else real, module=module)
        log(f"{tag} coincident {name}: agrees with its plain version "
            f"({int(both.sum())} coincident pairs)")


def wall_slot_pairs(torch, ps, packed_i, wall, nbr_w, i_ch, w_ch):
    """(slot pairs B5c/B5d's first design evaluated, lane x slot pairs its
    lane groups evaluate, cells with a live wall window, of them those with
    a real i-slot), from the wall map: the first design 16 x 16 per live
    wall window of every cell; a lane group 16 lanes times the real wall
    slots (mask != 0) of its live windows, for every cell with a live
    window and a real i-slot."""
    c, cw = nbr_w.shape[0], wall.shape[0] - 1
    live = nbr_w < cw                     # the sentinel row holds no real slot
    real_w = (wall[..., w_ch] != 0).sum(dim=1)
    windowed = live.any(dim=1)
    working = windowed & (packed_i[:c, :, i_ch] != 0).any(dim=1)
    per_cell = real_w[nbr_w.long()].sum(dim=1)
    before = int(live.sum()) * ps.CAP ** 2
    after = int((per_cell * working).sum()) * ps.CAP
    return before, after, int(windowed.sum()), int(working.sum())


def full_wall_rows(torch, wall, w_ch, h, g):
    """`wall` with every padding slot of a row that holds a real slot made
    real: its row's first slot copied there, mask 1, its position moved by
    up to h/2 (into the support of the fluid beside that slot)."""
    m = wall[..., w_ch] != 0
    fill = ~m & m.any(dim=1, keepdim=True)
    full = torch.where(fill[..., None], wall[:, :1, :].expand_as(wall), wall)
    jitter = (torch.rand(wall.shape[:2] + (2,), generator=g, device=DEVICE)
              - 0.5) * h
    full[..., :2] = torch.where(fill[..., None], full[..., :2] + jitter,
                                full[..., :2])
    full[..., w_ch] = torch.where(fill, torch.ones_like(full[..., w_ch]),
                                  full[..., w_ch])
    return full


def wall_checks(torch, ps, inputs, c, h, g):
    """B5c/B5d where their first design never met them, each against its
    plain version on the same inputs (`inputs`: packed_inputs with a
    moving wall, so that every output channel is live): holes on both
    sides (packed_holes on the i-rows and on the wall rows; every real
    slot's sums within 1e-6 max|out| of the run without the swap) and full
    wall rows (full_wall_rows: the compaction meets whole rows, the
    unsplit cells long lists); and the slot pairs each design evaluates."""
    masks = {"ac1_wall_sweep": (ps.I1M, ps.W1M),   # (i-side, wall) masks
             "ac2_wall_sweep": (ps.I2M, ps.W2M)}
    for name, (i_ch, w_ch) in masks.items():
        (pk_i, wall, nbr_w), kw = inputs[name]
        before, after, windowed, working = wall_slot_pairs(
            torch, ps, pk_i, wall, nbr_w, i_ch, w_ch)
        log(f"2d16 {name}: {after} lane x slot pairs evaluated (first "
            f"design: {before} slot pairs) in {working} cells with a wall "
            f"window and a real slot ({windowed} with a wall window, of "
            f"{c} cells)")
        base = channels(torch, getattr(ps, name)(pk_i, wall, nbr_w, **kw))
        holed_i, idx = packed_holes(torch, ps, pk_i, i_ch)
        holed_w, _ = packed_holes(torch, ps, wall, w_ch)
        real_h = (holed_i[..., i_ch] != 0)[:c]
        got, _ = compare(torch, "2d16 holes", name, (holed_i, holed_w, nbr_w),
                         kw, real_h, module=ps)
        back = torch.gather(got, 1, idx[:c, :, None].expand_as(got))
        real = (pk_i[..., i_ch] != 0)[:c]
        diff = float((back - base)[real].abs().max())
        scale = float(base[real].abs().max())
        log(f"2d16 holes {name}: agrees with its plain version, i-rows and "
            f"wall rows swapped; max |out - out without the swap| "
            f"{diff:.3e} (max|out| {scale:.3e})")
        check(diff <= 1e-6 * scale,
              f"2d16 holes {name}: real slots moved through the swap")
        full = full_wall_rows(torch, wall, w_ch, h, g)
        compare(torch, "2d16 full-wall-rows", name, (pk_i, full, nbr_w), kw,
                real, module=ps)
        _, after_full, _, _ = wall_slot_pairs(torch, ps, pk_i, full, nbr_w,
                                              i_ch, w_ch)
        unsplit = int(((pk_i[:c, ps.CAP // 2:, i_ch] != 0).any(dim=1)
                       & (nbr_w < wall.shape[0] - 1).any(dim=1)).sum())
        log(f"2d16 full-wall-rows {name}: agrees with its plain version "
            f"({after_full} lane x slot pairs; {unsplit} cells with a wall "
            f"window do not split)")


def packed_kernel_phase(torch, scene, sim, results):
    """B5a-d against their plain versions on the same inputs, their times
    and bounds; the lane × slot pairs B5a/B5b evaluate and the B2/B3 times
    on the same state; then the wall sweeps with seeded non-zero wall
    kinematics (the static dambreak wall packs zeros there), the 2nd-half
    sweeps with the Dissipative solver's constants (limiter 1e30), padding
    moved into the support with volume 1 (the mask its only guard),
    B5a/B5b with holes and coincident particles, and B5c/B5d with holes on
    both sides and full wall rows (`wall_checks`)."""
    from sphinxsys_tpu_torch.benchmarks import (
        median_ms, packed_inputs, sweep_inputs,
    )
    from sphinxsys_tpu_torch.ops import block_sweeps as bs
    from sphinxsys_tpu_torch.ops import packed_sweeps as ps
    from sphinxsys_tpu_torch.physics import riemann as rs

    eng, fb, wb = scene.eng, sim.fluid_b, scene.wall_b
    c = sim.nbr_inner.shape[0]
    real = fb["SlotMask"][:c]
    own_row_check(torch, sim.nbr_inner)
    inputs = packed_inputs(scene, sim)
    pos = inputs["ac1_inner_sweep"][0][0][..., :2]
    inner, wall = real_pairs(torch, pos, fb["SlotMask"], sim.nbr_inner,
                             (0.0, 0.0), eng.kernel.cutoff, wb["Position"],
                             wb["SlotMask"], sim.nbr_wall)
    self_pairs = int(real.sum())
    base = {}
    for name, (args, kw) in inputs.items():
        wrapper, plain = getattr(ps, name), getattr(ps, name + "_plain")
        got, max_abs = compare(torch, "2d16", name, args, kw, real, module=ps)
        base[name] = got
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
        if name.endswith("inner_sweep"):
            before, after, split = packed_slot_pairs(torch, ps, args[0],
                                                     args[1])
            log(f"2d16 {name}: {after} lane x slot pairs evaluated (first "
                f"design: {before} slot pairs; {pairs} real pairs; "
                f"{split:.3f} of the cells split), "
                f"{ms * 1e9 / after:.4f} ps each")
    # the *_p2 route's sweeps (B2/B3) on the same state, for comparison
    b2b3 = {}
    for name, (args, kw) in sweep_inputs(scene, sim,
                                         ("ac1_sweep", "ac2_sweep")).items():
        wrapper = getattr(bs, name)
        b2b3[name] = median_ms(lambda: wrapper(*args, **kw), 20, DEVICE)
        log(f"2d16 {name} (B2/B3 on the same state): kernel "
            f"{b2b3[name]:.4f} ms")
    results["_2d16_b2b3_main"] = b2b3

    g = torch.Generator(device=DEVICE).manual_seed(7)
    shape = wb["Position"].shape
    moving = dict(wb, AverageVelocity=0.1 * torch.randn(
        shape, generator=g, device=DEVICE), AverageAcceleration=torch.randn(
        shape, generator=g, device=DEVICE))
    moving_inputs = packed_inputs(scene, sim, wall_b=moving)
    variants = (("moving-wall", moving_inputs,
                 ("ac1_wall_sweep", "ac2_wall_sweep")),
                ("dissipative", packed_inputs(
                    scene, sim, riemann2=rs.dissipative_riemann(eng.eos)),
                 ("ac2_inner_sweep", "ac2_wall_sweep")))
    for what, inp, names in variants:
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
    lane_group_checks(torch, ps, ps, {n: inputs[n] for n in (
        "ac1_inner_sweep", "ac2_inner_sweep")}, base, c)
    wall_checks(torch, ps, moving_inputs, c, eng.kernel.h, g)


def near_padding_check(torch, module, name, args, kw, j, mask_ch, vol_ch, h,
                       real, g, prep=None):
    """`module.name` with the padding slots of its packed argument `j`
    moved into the support of their row's first slot (jitter of up to h/2),
    volume 1: it must agree with its plain version there, and every real
    slot's sums must stay within 1e-6 max|out| of the run without it.
    `prep`, if given, makes the sweep's arguments from these (B7's
    `prep_t`)."""
    prep = (lambda a: a) if prep is None else prep
    pk = args[j]
    pad = pk[..., mask_ch] == 0
    jitter = (torch.rand(pk.shape[:2] + (2,), generator=g, device=DEVICE)
              - 0.5) * h
    near = pk.clone()
    near[..., :2] = torch.where(pad[..., None], pk[:, :1, :2] + jitter,
                                pk[..., :2])
    near[..., vol_ch] = torch.where(pad, torch.ones_like(pad, dtype=pk.dtype),
                                    pk[..., vol_ch])
    near_args = prep(args[:j] + (near,) + args[j + 1:])
    got, _ = compare(torch, "2d16 near-padding", name, near_args, kw, real,
                     module=module)
    ref = channels(torch, getattr(module, name)(*prep(args), **kw))
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

def b7_vote(torch, ps, xi_t, xj_t):
    """B7's tile vote, from its inputs' masks (csrc/layout_sweeps.cu): per
    32-cell tile, which i-rows hold a real slot (16, tiles), which j-rows of
    each window hold one (9, 16, tiles), and the tile's cells (tiles,)."""
    c = xi_t.shape[-1]
    tiles = -(-c // 32)

    def rows(m):   # (..., 16, C) masks -> (..., 16, tiles): row has a real slot
        m = torch.nn.functional.pad(m != 0, (0, tiles * 32 - c))
        return m.reshape(*m.shape[:-1], tiles, 32).any(dim=-1)

    cells = (c - 32 * torch.arange(tiles, device=xi_t.device)).clamp(max=32)
    return rows(xi_t[ps.CMASK]), rows(xj_t[:, ps.CMASK]), cells


def b7_bytes(xi_t, out, vote):
    """(bytes B7 must move, bytes of its first design's count) for one
    sweep.  Each array once: the output; xi_t's x, y, p and mask planes and
    xj_t's 9 mask planes, whole (the tile vote reads them); xj_t's x, y, p
    and vol only on the j-rows that the vote keeps, a j-row with a real
    slot of a window in a tile with a real i-slot (the rows the kernel
    stages).  The first design's count took those 4 planes whole too."""
    i_rows, j_rows, cells = vote
    plane = xi_t[0].numel() * xi_t.element_size()
    fixed = out.numel() * out.element_size() \
        + (len(B7_XI_CHANNELS) + j_rows.shape[0]) * plane
    kept = (j_rows & i_rows.any(dim=0)).sum(dim=(0, 1))       # (tiles,)
    staged = int((kept * cells).sum()) * xi_t.element_size()
    whole = j_rows.shape[0] * plane
    return (fixed + len(B7_XJ_STAGED) * staged,
            fixed + len(B7_XJ_STAGED) * whole)


def layout_pairs_evaluated(torch, ps, pk, nbr, vote):
    """{name: (slot pairs the first design evaluated, pairs the current
    design evaluates)} from the inputs' masks.  First designs: B6 16 x 16
    per live window, B7 16 x 16 per window of every cell.  B6 now: for each
    cell with a real slot, its real i-slots times the real j-slots of its
    live windows.  B7 now (`vote`, b7_vote's): for each 32-cell tile, per
    window, its i-rows with a real slot times its j-rows with one, times
    the 32 cells (csrc/layout_sweeps.cu)."""
    c = nbr.shape[0]
    real = pk[..., ps.CMASK] != 0              # the sentinel row: none
    n_i = real[:c].sum(dim=1)
    n_j = real.sum(dim=1)[nbr.long()].sum(dim=1)
    b6 = int((n_i * n_j).sum())
    i_rows, j_rows, _ = vote
    b7 = int((i_rows.sum(dim=0) * j_rows.sum(dim=(0, 1))).sum()) * 32
    return {"ac1_flat_sweep": (int((nbr < c).sum()) * ps.CAP ** 2, b6),
            "ac1_t_sweep": (c * ps.NW * ps.CAP ** 2, b7)}


def layout_inputs(ls, name, pk, nbr):
    """B6's or B7's arguments from a packed state (B7: `prep_t`)."""
    return (pk, nbr) if name == "ac1_flat_sweep" else ls.prep_t(pk, nbr)


def layout_lane_checks(torch, ls, ps, pk, nbr, consts, real, base, h, g):
    """B6 and B7 where their first designs never met it, each against its
    plain version (B7 on `prep_t` of the same packed tensor): lane_group_
    checks' holes and coincident particles, near padding (padding of
    volume 1 moved into the support: the mask the only guard, which B7's
    tile vote now rests on), and B7 at C - 3 cells (4-byte copies, a
    ragged last tile).  `base`: each sweep's output on `pk` as (C, 16, 3)."""
    c = nbr.shape[0]
    lane_group_checks(torch, ps, ls, {n: ((pk, nbr), consts)
                                      for n in LAYOUT_KERNELS},
                      base, c, tag="2d16 layout",
                      prep=lambda n, p, m: layout_inputs(ls, n, p, m),
                      transposed=("ac1_t_sweep",))
    for name in LAYOUT_KERNELS:
        t = name == "ac1_t_sweep"
        near_padding_check(torch, ls, name, (pk, nbr), consts, 0, ps.CMASK,
                           ps.CVOL, h, real.t() if t else real, g,
                           prep=lambda a, n=name: layout_inputs(ls, n, *a))
    ragged = ls.prep_t(pk, nbr[:c - 3])
    compare(torch, "2d16 layout ragged", "ac1_t_sweep", ragged, consts,
            real[:c - 3].t(), module=ls)
    log(f"2d16 layout ragged ac1_t_sweep: agrees with its plain version at "
        f"C = {c - 3} (4-byte copies, a ragged last tile)")


def layout_phase(torch, scene, sim, results):
    """On the 2d16 state (the engine's fields after one advection step,
    packed once by `pack_layout_state` and shared with the drivers): B6
    and B7 against their plain versions and both against the B5a kernel
    on the same packed tensor (three kernels, one function), the pairs
    each evaluates, then `layout_lane_checks`; then both layout drivers at
    PACKED_DX on that state, launch counts reset just before them and read
    just after, their cross-checks, and from their timings each kernel's
    ms and plain ms beside its bound."""
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
    xi_t, xj_t = ls.prep_t(pk, nbr)
    vote = b7_vote(torch, ps, xi_t, xj_t)
    evaluated = layout_pairs_evaluated(torch, ps, pk, nbr, vote)
    b5a32 = torch.stack(b5a_channels(ps.ac1_inner_sweep, st), dim=-1)
    b5a64 = torch.stack(b5a_channels(ps.ac1_inner_sweep_plain,
                                     dict(st, packed=pk.double())), dim=-1)
    checked, base = {}, {}
    for name, args, transposed in (("ac1_flat_sweep", (pk, nbr), False),
                                   ("ac1_t_sweep", (xi_t, xj_t), True)):
        got, max_abs = compare(torch, "2d16 layout", name, args, consts,
                               real.t() if transposed else real, module=ls)
        base[name] = got.transpose(0, 1) if transposed else got
        hold(torch, f"2d16 layout {name} vs the B5a kernel", base[name],
             b5a32, b5a64, real)
        log(f"2d16 layout {name}: agrees with its plain version and with B5a")
        if transposed:    # the planes and rows it reads, and its output
            nbytes, whole = b7_bytes(xi_t, got, vote)
            flops = pairs * LAYOUT_PAIR_FLOPS
            bound_ms, bound_by = bytes_or_flops(nbytes, flops)
            log(f"2d16 layout {name}: bound {bound_ms:.4f} ms from {nbytes} B "
                f"(the first design's count, every staged plane whole: "
                f"{whole} B, {bytes_or_flops(whole, flops)[0]:.4f} ms)")
        else:             # the same bytes as B5a
            bound_ms, bound_by, flops, nbytes = packed_bound(
                torch, args, got, pairs, LAYOUT_PAIR_FLOPS)
        checked[name] = (max_abs, bound_ms, bound_by, flops, nbytes)
    del xi_t, xj_t, vote, b5a32, b5a64
    layout_lane_checks(torch, ls, ps, pk, nbr, consts, real, base,
                       scene.eng.kernel.h,
                       torch.Generator(device=DEVICE).manual_seed(9))
    del base
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
        "ac1_flat_sweep": (t1[exp_layout.B6_KERNEL],
                           t1["b) plain (C,256) flat"]),
        "ac1_t_sweep": (t2[exp_layout2.B7_KERNEL],
                        t2["b2) plain (16,16,C) transposed alone"])}
    prep_ms = t2["g) prep_t (gather + transpose)"]
    for name, (_, key) in LAYOUT_KERNELS.items():
        ms, plain_ms = timed[name]
        max_abs, bound_ms, bound_by, flops, nbytes = checked[name]
        first, now = evaluated[name]
        log(f"2d16 {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {pairs} real pairs, "
            f"{flops:.4e} flop, {nbytes} B), max_abs_err {max_abs:.3e}; "
            f"{now} pairs evaluated (first design: {first} slot pairs), "
            f"{ms * 1e9 / now:.4f} ps each")
        results[f"{name}[2d16]"] = dict(
            max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, real_pairs=pairs, launches=counts[key],
            pairs_evaluated=now)
    log(f"2d16 layout: B5a {t1['c) B5a kernel (16-lane groups)']:.4f} ms, "
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


# ---------------------------------------------------------------------------
# 8. the lattice solid: the twisting column on L1 / L2
# ---------------------------------------------------------------------------

def lattice_pairs(torch, lat, valid):
    """Real pairs per tap: sites i (every one is computed) whose j = i + o
    lies in the box and is valid, from this run's mask."""
    from sphinxsys_tpu_torch.ops import lattice_sweeps as ls

    m = max(abs(c) for o, *_ in lat.taps for c in o)
    mP = ls._pad(valid.reshape(lat.shape).to(torch.int32), m)
    return [int(ls._tap(mP, o, m, lat.shape).sum()) for o, *_ in lat.taps]


def lattice_bound(torch, name, lat, args, out):
    """The least time the card could take for one L1 / L2 call (ms): the
    larger of its bytes (each input once, the output once) over the HBM
    rate and its real pairs' flops over the float32 rate.  Flops per real
    pair of tap o, counted from the tap sums (add, mul, sub one each; e_b
    = 0 terms skipped; the kernels' multiply by w_j, which stands for the
    skip of an invalid j, is not counted): L1 14 + 9 nnz(e_o), L2 3 + 6
    nnz(e_o).  Returns (ms, by, real pairs, flops, bytes)."""
    pairs = lattice_pairs(torch, lat, args[3] if name == "lattice_force"
                          else args[1])
    nnz = [sum(1 for c in e0 if c != 0.0) for o, r0, e0, W0, dW0 in lat.taps]
    per = [(14 + 9 * k) if name == "lattice_force" else (3 + 6 * k)
           for k in nnz]
    flops = sum(p * f for p, f in zip(pairs, per))
    nbytes = out.numel() * out.element_size() + sum(
        a.numel() * a.element_size() for a in args if torch.is_tensor(a))
    return (*bytes_or_flops(nbytes, flops), sum(pairs), flops, nbytes)


def lattice_hold(torch, what, name, args):
    """One lattice kernel against its plain version on the same CUDA inputs
    (float32, and float64 for `hold`'s error scale), every site held, the
    invalid ones too (the kernel computes them as JAX does).  Returns
    (kernel output, max|k - p32|)."""
    from sphinxsys_tpu_torch.ops import lattice_sweeps as ls

    wrapper, plain = getattr(ls, name), getattr(ls, name + "_plain")
    got = wrapper(*args)
    torch.cuda.synchronize()
    ref32 = plain(*args)
    ref64 = plain(*[a.double() if torch.is_tensor(a) and a.is_floating_point()
                    else a for a in args])
    n = got.shape[0]
    flat = [t.reshape(n, -1) for t in (got, ref32, ref64)]
    real = torch.ones(n, dtype=torch.bool, device=got.device)
    return got, hold(torch, f"{what} {name}", *flat, real)


def golden_tip_x():
    """Tip x of the JAX twisting-column curve (snapshot order)."""
    import xml.etree.ElementTree as ET

    part = ET.parse(ROOT / SOLID_GOLDEN).getroot().find(
        "Result_Element/Particle_0")
    snaps = sorted(part.attrib.items(), key=lambda kv: int(kv[0].split("_")[1]))
    return [json.loads(v.lstrip("~"))[0] for _, v in snaps]


def jax_tip_x():
    """Tip x of the port-owned JAX curve (JAX_CURVE), snapshot order."""
    return json.loads((ROOT / JAX_CURVE).read_text())["tip_x"]


def solid_plain_path(torch, case, col, results):
    """The plain path on the card (`use_kernels=False`: JAX's tap loops as
    torch ops): its steady step time and, from one profiled step, its
    device launches — what a hand kernel has to beat."""
    import dataclasses

    from sphinxsys_tpu_torch.cases import twisting_column_3d as tc

    pcase = dataclasses.replace(case, use_kernels=False)
    s = tc.init_sim(pcase, col)
    for _ in range(2):
        s = tc._step(pcase, s)
    ms = wall_s(torch, lambda: tc._step(pcase, s), 3) * 1e3
    dev_us, wall_us, _, launches = profile_step(
        torch, "tc1m_plain", lambda: tc._step(pcase, s), "plain step")
    log(f"tc1m plain path: steady step {ms:.3f} ms (wall clock, median of 3), "
        f"{launches} device launches a step, device busy {dev_us / 1e3:.3f} ms "
        f"of a profiled {wall_us / 1e3:.3f} ms")
    results["_tc1m_plain_main"] = dict(ms_per_step=ms, launches_per_step=launches,
                                  device_busy_ms=dev_us / 1e3)


def solid_main_path(torch, results):
    """The bench's lattice solid (dx = 0.0175: 349 x 57 x 57 = 1,133,901
    sites, the holder 6 layers deep) through
    build_case -> init_sim -> make_run_chunk for >= SOLID_STEPS steps, L1 and
    L2 once a step; then the step by part, one profiled step, and the
    pair-update rate counted as bench.py counts it."""
    from sphinxsys_tpu_torch.benchmarks import lattice_inputs
    from sphinxsys_tpu_torch.cases import twisting_column_3d as tc
    from sphinxsys_tpu_torch.ops import lattice_sweeps as ls
    from sphinxsys_tpu_torch.physics import solid as sd
    from sphinxsys_tpu_torch.physics import solid_lattice as sl

    t0 = time.perf_counter()
    case, col = tc.build_case(dx=SOLID_DX, engine="lattice", device=DEVICE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    lat = case.lat
    log(f"tc1m: lattice {lat.shape} = {case.n_column} sites, {len(lat.taps)} "
        f"taps, setup {setup_s:.2f} s")
    solid_plain_path(torch, case, col, results)

    run = tc.make_run_chunk(case)
    ls.reset_launch_counts()
    t0 = time.perf_counter()
    s = run(tc.init_sim(case, col), 1e-9)           # one step: learn dt
    dt0 = float(s.time) / s.n_steps
    while s.n_steps < SOLID_STEPS:
        s = run(s, float(s.time) + (SOLID_STEPS - s.n_steps + 0.5) * dt0)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = dict(ls.LAUNCHES)
    c = s.column
    for k in ("Position", "Velocity", "DeformationGradient", "DeformationRate",
              "Force", "Density"):
        check(bool(torch.isfinite(c[k]).all()), f"tc1m: non-finite {k}")
    hm = case.holder_mask
    held = float((c["Position"][hm] - c["InitialPosition"][hm]).abs().max())
    check(held < 1e-3, f"tc1m: the holder moved by {held:.3e}")
    for name, (_, key) in LATTICE_KERNELS.items():
        check(counts[key] == s.n_steps,
              f"tc1m: {name} launched {counts[key]} times in {s.n_steps} steps")
    pairs = sum((lat.shape[0] - abs(o[0])) * (lat.shape[1] - abs(o[1]))
                * (lat.shape[2] - abs(o[2])) for o, *_ in lat.taps)
    rate = 2 * s.n_steps * pairs / elapsed
    log(f"tc1m main path: {s.n_steps} steps to t={float(s.time):.6e} in "
        f"{elapsed:.3f} s ({elapsed / s.n_steps * 1e3:.3f} ms a step, wall "
        f"clock, first step included), launches {counts}, holder |dx| "
        f"{held:.3e}; pairs a sweep {pairs}, pair_interaction_updates_per_sec "
        f"{rate:.6e}")

    # the steady step by part (host wall clock, synchronised)
    dt = sd.solid_acoustic_time_step(c, case.material.sound_speed,
                                     case.adaptation.h, cfl=0.5)
    args = lattice_inputs(case, c, dt)
    half1 = sl.decomposed_integration_1st_half_lattice(
        c, lat, case.material, dt, case.adaptation.h)
    fixed = sd.fix_constraint(half1, case.holder_mask)
    parts = {
        "step": wall_s(torch, lambda: tc._step(case, s), 5),
        "dt": wall_s(torch, lambda: sd.solid_acoustic_time_step(
            c, case.material.sound_speed, case.adaptation.h, cfl=0.5), 5),
        "prelude": wall_s(torch, lambda: sl.decomposed_stress(
            c, case.material, dt, case.adaptation.h), 5),
        "L1": wall_s(torch, lambda: ls.lattice_force(*args["lattice_force"]), 5),
        "half1": wall_s(torch, lambda: sl.decomposed_integration_1st_half_lattice(
            c, lat, case.material, dt, case.adaptation.h), 5),
        "constraint": wall_s(torch, lambda: sd.fix_constraint(
            half1, case.holder_mask), 5),
        "L2": wall_s(torch, lambda: ls.lattice_dfdt(*args["lattice_dfdt"]), 5),
        "half2": wall_s(torch, lambda: sl.integration_2nd_half_lattice(
            fixed, lat, dt), 5),
    }
    parts = {k: v * 1e3 for k, v in parts.items()}
    parts["epilogue1"] = parts["half1"] - parts["prelude"] - parts["L1"]
    parts["epilogue2"] = parts["half2"] - parts["L2"]
    log("tc1m step parts (ms, wall clock): "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
    dev_us, wall_us, plain_us, launches = profile_step(
        torch, "tc1m", lambda: tc._step(case, s), "step")
    results["_tc1m_main"] = dict(
        steps=s.n_steps, ms_per_step=elapsed / s.n_steps * 1e3, parts_ms=parts,
        device_busy_ms=dev_us / 1e3, launches_per_step=launches,
        pairs_per_sweep=pairs, pair_interaction_updates_per_sec=rate)
    for name, (_, key) in LATTICE_KERNELS.items():
        results[f"{name}[tc1m]"] = dict(launches=counts[key])
    return case, s


def solid_kernel_checks(torch, case, s, results):
    """L1 and L2 against their plain versions on the 1.13M state after the
    main path, timed and bounded, each beside its design's occupancy (L2
    also beside its library yardstick, `dfdt_conv3d`); then on the same
    state notched, with NaN planted in the notch."""
    from sphinxsys_tpu_torch.benchmarks import lattice_inputs, median_ms, notched
    from sphinxsys_tpu_torch.ops import lattice_sweeps as ls
    from sphinxsys_tpu_torch.physics import solid as sd

    c = s.column
    dt = sd.solid_acoustic_time_step(c, case.material.sound_speed,
                                     case.adaptation.h, cfl=0.5)
    for name, args in lattice_inputs(case, c, dt).items():
        wrapper, plain = getattr(ls, name), getattr(ls, name + "_plain")
        got, max_abs = lattice_hold(torch, "tc1m", name, args)
        ms = median_ms(lambda: wrapper(*args), 20, DEVICE)
        plain_ms = median_ms(lambda: plain(*args), 3, DEVICE)
        bound_ms, bound_by, pairs, flops, nbytes = lattice_bound(
            torch, name, case.lat, args, got)
        occ = ls.occupancy(name)
        library_ms = dfdt_conv3d(torch, args) if name == "lattice_dfdt" \
            else None
        log(f"tc1m {name}: kernel {ms:.4f} ms ({occ['blocks_per_sm']} blocks "
            f"an SM of {occ['threads']} threads, {occ['smem_bytes']} B of "
            f"shared memory a block), plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}: {pairs} real pairs, {flops:.4e} "
            f"flop, {nbytes} B), library {library_ms} ms, max_abs_err "
            f"{max_abs:.3e}")
        results[f"{name}[tc1m]"].update(
            max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, real_pairs=pairs, library_ms=library_ms,
            occupancy=occ)
    cut_col, n_cut = notched(c)
    for name, args in lattice_inputs(case, cut_col, dt).items():
        got, _ = lattice_hold(torch, f"tc1m notched ({n_cut} NaN sites)", name,
                              args)


def dfdt_conv3d(torch, args):
    """L2's library yardstick: one grouped torch.nn.functional.conv3d of the
    channels [sel(valid, v_x), sel(valid, v_y), sel(valid, v_z), valid]
    (padding 2, groups 4) with the weights g_b,o = dW0 V0 e_b,o at o + 2,
    which gives Gv_ab = sum_o g_b,o w_j v_a,j and Gw_b = sum_o g_b,o w_j;
    then dFdt_ab = Gv_ab - v_a,i Gw_b.  The port never calls it.  Timed
    (the conv3d call alone) with cuDNN's TF32 off, set and then restored,
    and held to the float64 plain version: the expanded form cancels
    across |v| / |v_i - v_j|, so its float32 error is bounded by the
    rounding of the expansion itself, 2e-5 max|v| max_b sum_o |g_b,o|
    (~125 terms at 6e-8 each), not by the result's own size.  Returns ms."""
    from sphinxsys_tpu_torch.benchmarks import median_ms
    from sphinxsys_tpu_torch.ops import lattice_sweeps as ls

    vel, valid, shape, taps, vol0 = args
    off, rows, _ = ls._dfdt_table(taps, float(vol0))
    m = ls._halo(off)
    k = 2 * m + 1
    weight = torch.zeros((4, 3, k, k, k), dtype=torch.float64)
    for (ox, oy, oz), g in zip(off.tolist(), rows):
        for b in range(3):
            weight[:, b, ox + m, oy + m, oz + m] = g[b]
    weight = weight.reshape(12, 1, k, k, k).to(vel.device, torch.float32)
    v = torch.where(valid[:, None], vel, 0.0)
    x = torch.cat([v, valid[:, None].to(vel.dtype)], dim=1).T.reshape(
        1, 4, *shape).contiguous()
    conv = torch.nn.functional.conv3d
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        ms = median_ms(lambda: conv(x, weight, padding=m, groups=4), 20, DEVICE)
        y = conv(x, weight, padding=m, groups=4).reshape(4, 3, -1)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    got = y[:3].permute(2, 0, 1) - v[:, :, None] * y[3].T[:, None, :]
    ref = ls.lattice_dfdt_plain(vel.double(), valid, shape, taps, vol0)
    err = float((got.double() - ref).abs().max())
    gsum = max(sum(abs(g[b]) for g in rows) for b in range(3))
    limit = 2e-5 * float(v.abs().max()) * gsum
    log(f"L2 library yardstick (conv3d, groups 4, TF32 off): {ms:.4f} ms, "
        f"|conv - p64| {err:.3e} (bound {limit:.3e}, max|ref| "
        f"{float(ref.abs().max()):.3e})")
    check(err <= limit, f"L2 conv3d yardstick off by {err:.3e} > {limit:.3e}")
    return ms


def edge_lattice(torch, shape, cut, seed):
    """L1's and L2's arguments on a synthetic lattice of `shape` (dx = 0.1,
    h = 1.3 dx): positions on the lattice with seeded noise, S ~ 1e5 N(0, 1),
    J ~ 1 + 0.01 N(0, 1), v ~ N(0, 1); the sites of `cut` (a function of
    the site indices (ix, iy, iz)) invalid with NaN planted in every field.
    Returns (inputs by wrapper name, sites cut)."""
    from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
    from sphinxsys_tpu_torch.physics import solid_lattice as sl

    dx = 0.1
    lat = sl.make_lattice(SPHAdaptation(spacing=dx, dim=3).kernel, dx, shape)
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    idx = torch.stack(torch.meshgrid(
        *[torch.arange(n, device=DEVICE) for n in shape], indexing="ij"),
        dim=-1).reshape(-1, 3)
    n = idx.shape[0]
    rand = lambda *sz: torch.randn(*sz, generator=g, device=DEVICE)
    pos = idx.float() * dx + 0.01 * dx * rand(n, 3)
    S, J, vel = 1e5 * rand(n, 3, 3), 1.0 + 0.01 * rand(n), rand(n, 3)
    valid = ~cut(idx[:, 0], idx[:, 1], idx[:, 2])
    for t in (pos, S, J, vel):
        t[~valid] = float("nan")
    return ({"lattice_force": (pos, S, J, valid, shape, lat.taps, dx ** 3,
                               4.2e6),
             "lattice_dfdt": (vel, valid, shape, lat.taps, dx ** 3)},
            int((~valid).sum()))


def solid_edge_checks(torch):
    """Where the staged design could break, L1 and L2 against their plain
    versions at every site: a ragged lattice smaller than a brick in y and
    z (37 x 13 x 11) with a notch and 5% of its sites scattered invalid,
    NaN planted in them; lattices one site thick in x, y and z; a lattice
    whose first brick of each kernel (x < 8, y < 8, z < 32) is all invalid,
    NaN inside, next to valid ones."""
    none = lambda ix, iy, iz: torch.zeros_like(ix, dtype=torch.bool)
    g = torch.Generator(device=DEVICE).manual_seed(17)

    def notch_and_scatter(ix, iy, iz):
        r = torch.rand(ix.shape, generator=g, device=DEVICE)
        return ((ix > 10) & (ix < 16) & (iy > 6)) | (r < 0.05)

    cases = (
        ("ragged 37x13x11, notch and scatter", (37, 13, 11), notch_and_scatter),
        ("one thick in x 1x13x40", (1, 13, 40), none),
        ("one thick in y 13x1x40", (13, 1, 40), none),
        ("one thick in z 13x40x1", (13, 40, 1), none),
        ("dead brick 20x14x40", (20, 14, 40),
         lambda ix, iy, iz: (ix < 8) & (iy < 8) & (iz < 32)),
    )
    for k, (tag, shape, cut) in enumerate(cases):
        inputs, n_cut = edge_lattice(torch, shape, cut, 100 + k)
        for name, args in inputs.items():
            lattice_hold(torch, f"{tag} ({n_cut} NaN sites)", name, args)


def solid_golden_check(torch, engine="lattice"):
    """The twisting column at dx = 0.1 on `engine` (the lattice one through
    the kernels) to t = 0.5, the tip sampled every 20 steps as
    benchmarks/run_refdb_parity.py:544-553 did: the envelope of
    tests/test_twisting_column.py:33-34; the tip x within JAX_CURVE_BOUND
    of the JAX package's own float32 run (JAX_CURVE) at every one of its
    140 snapshots; and within 0.1 (one dx) of the committed curve
    (SOLID_GOLDEN) at each of the GOLDEN_HELD leading snapshots, the span
    over which the JAX package's own run reproduces it; beyond it only the
    largest gap is printed."""
    from sphinxsys_tpu_torch.cases import twisting_column_3d as tc

    case, col = tc.build_case(dx=0.1, engine=engine, device=DEVICE)
    s = tc.init_sim(case, col)
    idx, w = tc.tip_observer(case, col)
    xs = [float(tc.observe_tip(s, idx, w)[0])]
    t0 = time.perf_counter()
    while float(s.time) < 0.5:
        for _ in range(20):
            s = tc._step(case, s)
        xs.append(float(tc.observe_tip(s, idx, w)[0]))
    run_s = time.perf_counter() - t0
    gold = golden_tip_x()
    gaps = [abs(a - b) for a, b in zip(xs, gold)]
    held = max(gaps[:GOLDEN_HELD])
    own = jax_tip_x()
    own_gap = max(abs(a - b) for a, b in zip(xs, own))
    log(f"tc golden ({engine}): dx=0.1 {s.n_steps} steps to t={float(s.time):.6f} in "
        f"{run_s:.2f} s, {len(xs)} snapshots (the curve {len(gold)}), tip x "
        f"in [{min(xs):.4f}, {max(xs):.4f}] (the curve [{min(gold):.4f}, "
        f"{max(gold):.4f}]), max |x - curve| {held:.4e} over the first "
        f"{GOLDEN_HELD} snapshots, {max(gaps):.4e} over all {len(gaps)}; "
        f"max |x - JAX curve| {own_gap:.4e} over its {len(own)} snapshots "
        f"(bound {JAX_CURVE_BOUND})")
    check(9.0 < max(xs) < 10.2 and 2.8 < min(xs) < 3.8,
          f"tc golden: tip envelope [{min(xs)}, {max(xs)}]")
    check(len(xs) >= GOLDEN_HELD, f"tc golden: only {len(xs)} snapshots")
    check(held <= 0.1, f"tc golden: tip x off the curve by {held:.4e}")
    check(len(xs) == len(own),
          f"tc golden: {len(xs)} snapshots, the JAX curve {len(own)}")
    check(own_gap <= JAX_CURVE_BOUND,
          f"tc golden: tip x off the JAX curve by {own_gap:.4e}")
    return dict(snapshots=len(xs), max_gap_held=held, max_gap=max(gaps),
                max_gap_jax_curve=own_gap, tip_min=min(xs), tip_max=max(xs))


def solid_small_reference(torch, t_end=0.02):
    """The dx = 0.1 column on the card through the kernels against the same
    run through the plain versions: equal step counts, positions within
    5e-5 of max|x|."""
    from sphinxsys_tpu_torch.cases import twisting_column_3d as tc

    runs = []
    for use_kernels in (True, False):
        case, col = tc.build_case(dx=0.1, engine="lattice", device=DEVICE,
                                  use_kernels=use_kernels)
        runs.append(tc.make_run_chunk(case)(tc.init_sim(case, col), t_end))
    (k, p) = runs
    err = float((k.column["Position"] - p.column["Position"]).abs().max())
    scale = float(p.column["Position"].abs().max())
    log(f"tc small reference: dx=0.1 to t={t_end} kernels {k.n_steps} steps, "
        f"plain {p.n_steps} steps, max |dpos| {err:.3e} (max|x| {scale:.3f})")
    check(k.n_steps == p.n_steps, "tc small reference: step counts differ")
    check(err <= 5e-5 * scale,
          f"tc small reference: positions differ by {err:.3e}")


def gather_solid_check(torch, lcase, ls_state, results):
    """Phase 10, at the bench's dx: the gather engine's frozen topology
    (cell table, row-chunked neighbour lists, frozen pairs, B) built on the
    card, timed, with its peak device memory; then, from the lattice main
    path's state, GATHER_STEPS steps of each engine (the lattice one
    through L1 / L2): equal step counts and positions within
    GATHER_POS_TOL of max|x|.  The gather engine's pair sums are torch ops
    over the frozen (N, K) lists, no hand kernel: an independent oracle for
    L1 / L2 at full size."""
    from sphinxsys_tpu_torch.cases import twisting_column_3d as tc
    from sphinxsys_tpu_torch.physics import solid as sd

    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gcase, gcol = tc.build_case(dx=SOLID_DX, engine="gather", device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base_mem
    rp = gcase.rp
    pairs = int(rp.mask.sum())
    rp_bytes = sum(t.numel() * t.element_size() for t in rp)
    log(f"tc1m gather: topology of {gcase.n_column} sites, K={rp.idx.shape[1]}, "
        f"{pairs} frozen pairs ({rp_bytes / 1e9:.3f} GB frozen) built in "
        f"{build_s:.2f} s, peak device memory {peak / 1e9:.3f} GB over the "
        f"{base_mem / 1e9:.3f} GB already held")
    check(pairs == results["_tc1m_main"]["pairs_per_sweep"],
          f"tc1m gather: {pairs} frozen pairs, the lattice sweeps "
          f"{results['_tc1m_main']['pairs_per_sweep']}")

    start = {k: v for k, v in ls_state.column.items() if k != "LatticeValid"}
    start["LinearGradientCorrectionMatrix"] = gcol["LinearGradientCorrectionMatrix"]
    g = tc.SimState(column=start, time=ls_state.time, n_steps=0)
    lat = tc.SimState(column=ls_state.column, time=ls_state.time, n_steps=0)
    for _ in range(GATHER_STEPS):
        g, lat = tc._step(gcase, g), tc._step(lcase, lat)
    err = float((g.column["Position"] - lat.column["Position"]).abs().max())
    scale = float(lat.column["Position"].abs().max())
    dt_gap = abs(float(g.time) - float(lat.time))
    log(f"tc1m gather vs lattice: {GATHER_STEPS} steps from the main path's "
        f"state, max |dpos| {err:.3e} (max|x| {scale:.3f}), |dt sum gap| "
        f"{dt_gap:.3e}")
    for k in ("Position", "Velocity", "DeformationGradient"):
        check(bool(torch.isfinite(g.column[k]).all()), f"tc1m gather: non-finite {k}")
    check(err <= GATHER_POS_TOL * scale,
          f"tc1m gather: positions off the lattice path's by {err:.3e}")

    step_ms = wall_s(torch, lambda: tc._step(gcase, g), 3) * 1e3
    dev_us, wall_us, _, launches = profile_step(
        torch, "tc1m_gather", lambda: tc._step(gcase, g), "gather step")
    peak_step = torch.cuda.max_memory_allocated() - base_mem
    log(f"tc1m gather path: steady step {step_ms:.3f} ms (wall clock, median "
        f"of 3; the lattice path's {results['_tc1m_main']['parts_ms']['step']:.3f}"
        f" ms), {launches} device launches a step, device busy "
        f"{dev_us / 1e3:.3f} ms; peak device memory with a step "
        f"{peak_step / 1e9:.3f} GB")
    results["_tc_gather"] = dict(
        build_s=build_s, build_peak_gb=peak / 1e9, frozen_gb=rp_bytes / 1e9,
        step_peak_gb=peak_step / 1e9, ms_per_step=step_ms,
        launches_per_step=launches, device_busy_ms=dev_us / 1e3,
        pos_gap=err, steps=GATHER_STEPS)
    del gcase, gcol, g, lat, rp, start


def solid_phase(torch, results):
    """Phases 8 and 10: the lattice solid, then the gather solid."""
    t0 = time.perf_counter()
    case, s = solid_main_path(torch, results)
    solid_kernel_checks(torch, case, s, results)
    gather_solid_check(torch, case, s, results)
    del case, s
    torch.cuda.empty_cache()
    solid_edge_checks(torch)
    solid_small_reference(torch)
    results["_tc1m_main"]["golden"] = solid_golden_check(torch)
    results["_tc_gather"]["golden"] = solid_golden_check(torch, "gather")
    log(f"solid phases: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# 9. fsi2: the moving-wall, x-periodic path through B1-B4
# ---------------------------------------------------------------------------

def fsi2_gates():
    """What the card's fsi2 run to FSI2_T_END is held to, from the JAX
    package's own float32 runs at dx = 0.1 (FSI2_JAX_RUNS: its block and
    gather routes, x64 on and off, to t = 5; tests/test_torch_fsi2.py
    writes them).  Counts: the acoustic (n_ac) and solid (n_s) sub-steps
    within FSI2_COUNT_BAND of the block route's with x64 on (790 / 1,580;
    the four runs span 785-815 / 1,570-1,629, and their advection counts
    283-322, so a 20% band holds them all and a broken coupling, which
    shrinks the time steps, still falls out).  Tip: the beam tip's
    displacement from its start, |d| at every sample, within the largest
    any of the four runs reaches (0.548, the block route with x64 off, at
    t < 1: the start-up pressure pulse at the tip, which the float32 runs
    resolve each their own way)."""
    runs = json.loads((ROOT / FSI2_JAX_RUNS).read_text())["runs"]
    ref = next(r for r in runs if r["route"] == "block" and r["x64"])
    n_ac, n_s = ref["rows"][-1][2:4]
    band = lambda n: ((1 - FSI2_COUNT_BAND) * n, (1 + FSI2_COUNT_BAND) * n)
    radius = max(math.hypot(row[4], row[5]) for r in runs for row in r["rows"])
    return dict(n_ac=band(n_ac), n_s=band(n_s), tip_radius=radius)


def coincident_check(torch, tag, scene, sim):
    """B1-B4 with coincident particles: in every row whose first two slots
    are real, slot 1 moved onto slot 0 (r = 0 within the cell), each
    against its plain version on the same inputs."""
    from sphinxsys_tpu_torch.benchmarks import sweep_inputs

    c = sim.nbr_inner.shape[0]
    real = sim.fluid_b["SlotMask"][:c]
    both = sim.fluid_b["SlotMask"][:, 0] & sim.fluid_b["SlotMask"][:, 1]
    for name, (args, kw) in sweep_inputs(scene, sim, tuple(KERNELS)).items():
        args = list(args)
        pos = args[0].clone()
        pos[both, 1] = pos[both, 0]
        args[0] = pos
        compare(torch, f"{tag} coincident", name, args, kw, real)
        log(f"{tag} coincident {name}: agrees with its plain version "
            f"({int(both.sum())} rows)")


class SyncCounter:
    """Counts the host reads of device values (`bool`, `float`, `int`,
    `item` of a tensor) inside a `with` block."""

    NAMES = ("__bool__", "__float__", "__int__", "item")

    def __init__(self, torch):
        self.cls, self.n = torch.Tensor, 0
        self.device = torch.device(DEVICE).type

    def __enter__(self):
        self.saved = {k: getattr(self.cls, k) for k in self.NAMES}

        def counted(fn):
            def wrapper(t, *a):
                if t.device.type == self.device:
                    self.n += 1
                return fn(t, *a)
            return wrapper

        for k, fn in self.saved.items():
            setattr(self.cls, k, counted(fn))
        return self

    def __exit__(self, *exc):
        for k, fn in self.saved.items():
            setattr(self.cls, k, fn)


def fsi2_short_check(torch):
    """fsi2 on the card to FSI2_SHORT through the kernels and through the
    block forms (`use_kernels=False`: torch ops, no hand kernel): equal
    counts, the fluid's positions and velocities by particle and the
    solid's positions within FSI2_SHORT_TOL."""
    from sphinxsys_tpu_torch.cases import fsi2 as fc
    from sphinxsys_tpu_torch.engine import scene as sc

    runs = {}
    for use_kernels in (True, False):
        scene, fluid, solid = fc.build_block_case(dx=FSI2_DX, device=DEVICE,
                                                  use_kernels=use_kernels)
        sim = sc.make_run_chunk(scene)(fc.init_block_sim(scene, fluid, solid),
                                       FSI2_SHORT)
        runs[use_kernels] = (sim, sc.blocks_to_particles(scene, sim))
    (k, pk), (b, pb) = runs[True], runs[False]
    counts = lambda s: (s.n_adv, s.n_ac, s.aux["n_s"])
    gaps = {f: float((pk[f] - pb[f]).abs().max()) for f in ("Position", "Velocity")}
    gaps["solid"] = float((k.aux["solid"]["Position"]
                           - b.aux["solid"]["Position"]).abs().max())
    log(f"fsi2 short: to t={FSI2_SHORT} kernels {counts(k)}, block forms "
        f"{counts(b)}; max gaps {gaps} (tolerance {FSI2_SHORT_TOL}; max|v| "
        f"{float(pb['Velocity'].abs().max()):.4e})")
    check(counts(k) == counts(b), "fsi2 short: the two routes' counts differ")
    check(not bool(k.overflow) and not bool(b.overflow), "fsi2 short: overflow")
    for f, gap in gaps.items():
        check(gap <= FSI2_SHORT_TOL, f"fsi2 short: {f} differ by {gap:.3e}")


def fsi2_phase(torch, results):
    """Phase 9: fsi2 at dx = 0.1 (5,180 fluid, 1,104 wall, 150 solid
    particles; the wall and the solid one moving wall-type body, x-periodic)
    on the card: B1-B4 against their plain versions on the state at
    FSI2_MID (also with holes, padding near the real slots and coincident
    particles), timed and bounded; the short two-route check; then the main
    path to FSI2_T_END through build_block_case -> init_block_sim ->
    make_run_chunk, launch counts reset just before it, the host reads of
    device values counted, the tip sampled every FSI2_SAMPLE and held to
    `fsi2_gates`; the step by part and profiled (the advection step, and
    the torch-op FSI couplings and solid sub-step on their own)."""
    from sphinxsys_tpu_torch.cases import fsi2 as fc
    from sphinxsys_tpu_torch.engine import block_fluid as eng_mod
    from sphinxsys_tpu_torch.engine import scene as sc
    from sphinxsys_tpu_torch.ops import block_sweeps as bs
    from sphinxsys_tpu_torch.physics import fsi, fsi_blocks as fsb
    from sphinxsys_tpu_torch.physics import solid as sd

    t0 = time.perf_counter()
    scene, fluid, solid = fc.build_block_case(dx=FSI2_DX, device=DEVICE)
    base, eng = scene.base, scene.eng
    run = sc.make_run_chunk(scene)
    mid = run(fc.init_block_sim(scene, fluid, solid), FSI2_MID)
    log(f"fsi2: n_fluid={base.n_fluid} n_wall={base.n_wall} "
        f"n_solid={base.n_solid} grid={eng.grid.shape} c_max={eng.c_max} "
        f"cap={eng.cap}; the state at t={float(mid.time):.4f} (n_adv "
        f"{mid.n_adv}) in {time.perf_counter() - t0:.1f} s")
    compare_kernels(torch, "fsi2", dict(kernels=tuple(KERNELS)), scene, mid,
                    results)
    padding_checks(torch, "fsi2", scene, mid,
                   torch.Generator(device=DEVICE).manual_seed(19))
    coincident_check(torch, "fsi2", scene, mid)
    fsi2_short_check(torch)

    gates = fsi2_gates()
    sim = fc.init_block_sim(scene, fluid, solid)
    idx, w = fc.tip_observer(base, solid)
    tip0 = fc.observe_tip(solid, idx, w)
    tip_max, samples = 0.0, 0
    bs.reset_launch_counts()
    t1 = time.perf_counter()
    with SyncCounter(torch) as syncs:
        while float(sim.time) < FSI2_T_END:
            samples += 1
            sim = run(sim, samples * FSI2_SAMPLE)
            d = fc.observe_tip(sim.aux["solid"], idx, w) - tip0
            tip_max = max(tip_max, float(torch.linalg.vector_norm(d)))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t1
    counts = dict(bs.LAUNCHES)
    so = sim.aux["solid"]
    n_adv, n_ac, n_s = sim.n_adv, sim.n_ac, sim.aux["n_s"]
    part = sc.blocks_to_particles(scene, sim)
    n_sync = syncs.n - 2 * samples - 1   # the loop's own time tests, tip reads
    log(f"fsi2 main path: to t={float(sim.time):.6f} n_adv={n_adv} n_ac={n_ac} "
        f"n_s={n_s} (band n_ac {gates['n_ac']}, n_s {gates['n_s']}) in "
        f"{elapsed:.2f} s: {elapsed / n_adv * 1e3:.3f} ms an advection step "
        f"(wall clock, mean), launches {counts}, {n_sync} host reads of device "
        f"values ({n_sync / n_adv:.2f} an advection step); tip max|d| "
        f"{tip_max:.4f} (bound {gates['tip_radius']:.4f}), d at the end "
        f"{(fc.observe_tip(so, idx, w) - tip0).tolist()}")
    check(not bool(sim.overflow), "fsi2: block capacity overflow")
    for k in ("Position", "Velocity", "Density", "Pressure"):
        check(bool(torch.isfinite(part[k]).all()), f"fsi2: non-finite fluid {k}")
    for k in ("Position", "Velocity", "DeformationGradient"):
        check(bool(torch.isfinite(so[k]).all()), f"fsi2: non-finite solid {k}")
    check(counts["density"] == counts["visc_tvc"] == n_adv
          and counts["ac1"] == counts["ac2"] == n_ac,
          f"fsi2: launches {counts} for {n_adv} steps and {n_ac} sub-steps")
    check(gates["n_ac"][0] <= n_ac <= gates["n_ac"][1]
          and gates["n_s"][0] <= n_s <= gates["n_s"][1],
          f"fsi2: counts {n_ac} / {n_s} off the band")
    check(tip_max <= gates["tip_radius"],
          f"fsi2: tip displaced {tip_max:.4f} > {gates['tip_radius']:.4f}")
    for name, (_, key) in KERNELS.items():
        results[f"{name}[fsi2]"]["launches"] = counts[key]

    # the step by part (host wall clock, synchronised) and profiled
    h, kern, w0 = base.adaptation.h, base.kernel, base.kernel.w0(2)
    fb, aux = sim.fluid_b, sim.aux
    c0s = base.material_s.sound_speed
    hooks = scene.hooks
    wc = eng_mod.WallCtx(eng_mod.refresh_wall_blocks(
        sim.wall_bm, scene.wall_state_fn(aux), sim.wall_b0), sim.nbr_wall)
    dt = eng_mod.acoustic_dt(eng, fb, eng_mod.advection_dt(eng, fb))
    dt_s = torch.minimum(sd.solid_acoustic_time_step(so, c0s, h), dt)

    def acoustic_substep():
        w_ = eng_mod.WallCtx(eng_mod.refresh_wall_blocks(
            sim.wall_bm, scene.wall_state_fn(aux), sim.wall_b0), sim.nbr_wall)
        f = eng_mod.acoustic_first_half(eng, fb, sim.nbr_inner, w_, dt)
        f, a = hooks.after_first_half(f, aux, dt, sim.time)
        f = eng_mod.acoustic_second_half(eng, f, sim.nbr_inner, w_, dt)
        hooks.post_acoustic(f, a, dt, sim.time + dt)

    def solid_substep():
        d = torch.minimum(sd.solid_acoustic_time_step(so, c0s, h), dt)
        x = sd.integration_1st_half_pk2(so, base.rp, base.material_s, d, h, w0)
        sd.integration_2nd_half(sd.fix_constraint(x, base.base_mask), base.rp, d)

    pressure = lambda: fsb.pressure_force_from_fluid_b(
        so, fb, aux["sol_win"], kern, 2, base.riemann, box=eng.box)
    viscous = lambda: fsi.update_elastic_normal_direction(
        fsb.viscous_force_from_fluid_b(so, fb, aux["sol_win"], kern, 2,
                                       fc.MU_F, h, box=eng.box))
    step = sc.make_advection_step(scene)
    flat = {k: fb[k].reshape((-1,) + tuple(fb[k].shape[2:])) for k in scene.fields}
    parts = {
        "advection_step": wall_s(torch, lambda: step(sim), 3),
        "prep": wall_s(torch, lambda: eng_mod.advection_prep(
            eng, fb, sim.nbr_inner, wc), 5),
        "acoustic_substep": wall_s(torch, acoustic_substep, 5),
        "fluid_halves": wall_s(torch, lambda: eng_mod.acoustic_second_half(
            eng, eng_mod.acoustic_first_half(eng, fb, sim.nbr_inner, wc, dt),
            sim.nbr_inner, wc, dt), 5),
        "solid_substep": wall_s(torch, solid_substep, 5),
        "pressure_force": wall_s(torch, pressure, 5),
        "viscous_force": wall_s(torch, viscous, 5),
        "reslot": wall_s(torch, lambda: sc._slot(scene, flat, fb["SlotMask"].reshape(-1),
                                                 aux), 5),
    }
    parts = {k: v * 1e3 for k, v in parts.items()}
    log("fsi2 step parts (ms, wall clock): "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
    dev_us, wall_us, plain_us, launches = profile_step(torch, "fsi2",
                                                       lambda: step(sim))
    coupling = {}
    for tag, fn in (("solid_substep", solid_substep),
                    ("pressure_force", pressure), ("viscous_force", viscous)):
        c_us, _, _, c_n = profile_step(torch, f"fsi2_{tag}", fn, tag)
        coupling[tag] = dict(device_ms=c_us / 1e3, launches=c_n)
    results["_fsi2_main"] = dict(
        t_end=float(sim.time), n_adv=n_adv, n_ac=n_ac, n_s=n_s,
        ms_per_adv=elapsed / n_adv * 1e3, host_reads_per_adv=n_sync / n_adv,
        parts_ms=parts, device_busy_ms=dev_us / 1e3,
        launches_per_adv=launches, idle_share_est=1 - dev_us / plain_us,
        tip_max=tip_max, coupling=coupling)
    log(f"fsi2 phase: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# 11. gather fluid: the neighbour-list WCSPH routes (torch ops, no kernel)
# ---------------------------------------------------------------------------

def gather_small_reference(torch, module, dx, t_end):
    """A gather route at a small size on the card against the same run on
    the CPU, both float32: equal step counts, positions by particle within
    5e-5 (sums over the same slots in other orders)."""
    case_mod = importlib.import_module(f"sphinxsys_tpu_torch.cases.{module}")
    runs = {}
    for dev in (DEVICE, "cpu"):
        case, fluid = case_mod.build_case(dx=dx, device=dev)
        sim = case_mod.make_run_chunk(case)(case_mod.init_sim(case, fluid),
                                            t_end)
        runs[dev] = (sim, sim.fluid["Position"].cpu())
    (gs, gp), (cs, cp) = runs[DEVICE], runs["cpu"]
    err = float((gp - cp).abs().max())
    log(f"gather small reference: {module} dx={dx} to t={t_end} card "
        f"n_adv={gs.n_adv} n_ac={gs.n_ac}, cpu n_adv={cs.n_adv} "
        f"n_ac={cs.n_ac}, max |dpos| {err:.3e}")
    check((gs.n_adv, gs.n_ac) == (cs.n_adv, cs.n_ac),
          f"gather small reference {module}: step counts differ")
    check(not bool(gs.overflow), f"gather small reference {module}: overflow")
    check(err <= 5e-5, f"gather small reference {module}: positions differ "
          f"by {err:.3e}")


def gather_block_oracle(torch):
    """The third oracle on the card: the gather route against the block
    route through the CUDA kernels, on the scenes of
    tests/test_scene_engines.py: equal counts, positions within 2e-3 of
    max|x| (minimum image where the box wraps)."""
    from sphinxsys_tpu_torch.engine import scene as sc

    for module, dx, t_end, block_kw in GATHER_ORACLE_SCENES:
        cm = importlib.import_module(f"sphinxsys_tpu_torch.cases.{module}")
        case, fluid = cm.build_case(dx=dx, device=DEVICE)
        g = cm.make_run_chunk(case)(cm.init_sim(case, fluid), t_end)
        scene, fluid_b = cm.build_block_case(dx=dx, device=DEVICE, **block_kw)
        b = sc.make_run_chunk(scene)(sc.init_sim(scene, fluid_b), t_end)
        n = scene.n_fluid
        d = g.fluid["Position"][:n] - sc.blocks_to_particles(scene, b)["Position"][:n]
        if scene.wrap:
            from sphinxsys_tpu_torch.neighbors.cell_list import min_image
            d = min_image(d, case.grid.periodic_lengths)
        err = float(d.abs().max())
        scale = float(g.fluid["Position"][:n].abs().max())
        log(f"gather vs block: {module} dx={dx} to t={t_end}: gather "
            f"{g.n_adv}/{g.n_ac}, block (kernels) {b.n_adv}/{b.n_ac}, max "
            f"|dpos| {err:.3e} (bound {2e-3 * scale:.3e})")
        check(not bool(g.overflow) and not bool(b.overflow),
              f"gather vs block {module}: overflow")
        check((g.n_adv, g.n_ac) == (b.n_adv, b.n_ac),
              f"gather vs block {module}: step counts differ")
        check(err < 2e-3 * scale, f"gather vs block {module}: positions "
              f"differ by {err:.3e}")


def peak_gb(torch):
    return torch.cuda.max_memory_allocated() / 1e9


def profile_parts(torch, tag, fns):
    """Each part of a step (name -> fn) profiled alone, as `profile_step`
    profiles a step: {name: device busy ms, device launches, unprofiled
    wall ms and the estimated idle share of that wall}."""
    out = {}
    for name, fn in fns.items():
        dev_us, _, plain_us, n = profile_step(torch, f"{tag}_{name}", fn, name)
        out[name] = dict(device_ms=dev_us / 1e3, launches=n,
                         wall_ms=plain_us / 1e3,
                         idle_share_est=1 - dev_us / plain_us)
    return out


def gather_main_path(torch, tag, cfg, results):
    """The gather dambreak at full width through build_case -> init_sim ->
    make_run_chunk -> solver.run_simulation, the block kernels' launch
    counts reset just before and read just after (the route launches
    none); then the step by part, one profiled step, each part profiled
    alone and the peak device memory, beside the block route's figures for
    the same config from phase 5 of this run."""
    from sphinxsys_tpu_torch import solver
    from sphinxsys_tpu_torch.neighbors.cell_list import morton_resort
    from sphinxsys_tpu_torch.ops import block_sweeps as bs
    from sphinxsys_tpu_torch.physics import fluid as fd
    from sphinxsys_tpu_torch.physics import general as gd

    db = importlib.import_module(f"sphinxsys_tpu_torch.cases.{cfg['module']}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    case, fluid = db.build_case(dx=cfg["dx"], device=DEVICE)
    if cfg["sort_every"]:
        case = dataclasses.replace(case, sort_every=cfg["sort_every"])
    sim = db.init_sim(case, fluid)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    e0 = float(gd.total_mechanical_energy(sim.fluid, case.gravity))
    h = case.adaptation.h
    dt0 = float(fd.advection_time_step(sim.fluid, h, db.U_REF))
    end_time = (cfg["min_adv"] + 0.5) * dt0
    bs.reset_launch_counts()
    sim, timer = solver.run_simulation(db.make_run_chunk(case), sim, end_time,
                                       end_time, verbose=False)
    counts = dict(bs.LAUNCHES)
    torch.cuda.synchronize()
    peak_run = peak_gb(torch)
    e1 = float(gd.total_mechanical_energy(sim.fluid, case.gravity))
    drift = abs(e1 - e0) / abs(e0)
    sorts = sim.n_adv // case.sort_every if case.sort_every else 0
    integ = timer.totals["integrate"]
    log(f"gather {tag} main path: n_fluid={case.n_fluid} n_wall={case.n_wall} "
        f"grid={case.grid.shape} cell_cap={case.cell_cap} K={case.k_inner}/"
        f"{case.k_wall} sort_every={case.sort_every}; setup {setup_s:.2f} s; "
        f"n_adv={sim.n_adv} n_ac={sim.n_ac} ({sorts} resorts) energy "
        f"{e0:.9e} -> {e1:.9e} (change {drift:.3e}); {integ / sim.n_adv * 1e3:.3f}"
        f" ms an advection step (wall clock, mean, the first included); block "
        f"kernel launches {counts}; peak device memory {peak_run:.3f} GB")
    check(sim.n_adv >= cfg["min_adv"], f"gather {tag}: only {sim.n_adv} steps")
    check(cfg["sort_every"] is None or sorts >= 2,
          f"gather {tag}: the resort ran {sorts} times")
    check(not bool(sim.overflow), f"gather {tag}: neighbour-list overflow")
    for k in ("Position", "Velocity", "Density", "Pressure"):
        check(bool(torch.isfinite(sim.fluid[k]).all()),
              f"gather {tag}: non-finite {k}")
    check(drift < 0.01, f"gather {tag}: energy drift {drift:.3e} >= 1%")
    check(not any(counts.values()), f"gather {tag}: the route launched a "
          f"block kernel {counts}")

    # the step by part (host wall clock, synchronised), peak memory of each
    step = db.make_advection_step(case)
    f = sim.fluid
    parts, peaks = {}, {}
    timed = [
        ("advection_step", lambda: step(sim), 3),
        ("rebuild", lambda: db.rebuild_relations(case, f), 5),
        ("density", lambda: fd.density_summation(
            f, sim.nl_inner, case.kernel, case.dim, db.RHO0_F,
            case.adaptation.sigma0,
            contacts=[(case.wall, sim.nl_wall, db.RHO0_F)]), 5),
        ("acoustic_substep", lambda: db.acoustic_substep(case, sim, f), 5)]
    if case.sort_every:
        timed.append(("resort", lambda: morton_resort(f, case.grid), 5))
    for name, fn, reps in timed:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        parts[name] = wall_s(torch, fn, reps) * 1e3
        peaks[name] = (torch.cuda.max_memory_allocated() - base) / 1e9
    dt_adv = fd.advection_time_step(f, h, db.U_REF)
    dt_ac = fd.acoustic_time_step(f, case.eos, h)
    substeps = float(dt_adv / dt_ac)
    block = results.get(f"_{tag}_main", {})
    log(f"gather {tag} step parts (ms, wall clock): "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; ~{substeps:.2f} acoustic sub-steps a step; the block route's "
        f"(phase 5): {json.dumps(block.get('parts_ms'))}")
    log(f"gather {tag} peak device memory above the state, by part (GB): "
        + ", ".join(f"{k} {v:.3f}" for k, v in peaks.items()))
    dev_us, wall_us, plain_us, launches = profile_step(
        torch, f"gather_{tag}", lambda: step(sim))
    # the device time of each part, which decides what the step needs
    # first: the pair sums (the density and the run's sub-steps a step)
    # against the rebuild
    prof = profile_parts(torch, f"gather_{tag}",
                         {k: fn for k, fn, _ in timed if k != "advection_step"})
    per_adv = sim.n_ac / sim.n_adv
    pair_ms = (prof["density"]["device_ms"]
               + per_adv * prof["acoustic_substep"]["device_ms"])
    log(f"gather {tag} device ms by part (each profiled alone): "
        + ", ".join(f"{k} {v['device_ms']:.3f} in {v['launches']} launches "
                    f"(idle share {v['idle_share_est']:.3f})"
                    for k, v in prof.items())
        + f"; pair sums a step (density + {per_adv:.2f} sub-steps) "
        f"{pair_ms:.3f} against the rebuild's "
        f"{prof['rebuild']['device_ms']:.3f}, of the step's device busy "
        f"{dev_us / 1e3:.3f}")
    results[f"_gather_{tag}"] = dict(
        n_fluid=case.n_fluid, n_adv=sim.n_adv, n_ac=sim.n_ac, resorts=sorts,
        ms_per_adv=integ / sim.n_adv * 1e3, parts_ms=parts,
        part_device=prof, pair_sum_device_ms=pair_ms,
        part_peak_gb=peaks, run_peak_gb=peak_run, device_busy_ms=dev_us / 1e3,
        launches_per_adv=launches, idle_share_est=1 - dev_us / plain_us,
        energy_change=drift, block_ms_per_adv=block.get("ms_per_adv"))
    del case, fluid, sim, f, step
    torch.cuda.empty_cache()


def gather_tg_decay(torch, results):
    """Taylor–Green on the gather route at dx=0.01 to t=0.1: the kinetic
    energy within 8% of KE0 exp(-16 pi^2 nu t), as `tg_decay_check`
    holds the block route; then its step by part, one profiled step and
    each part profiled alone."""
    from sphinxsys_tpu_torch.cases import taylor_green_2d as tg
    from sphinxsys_tpu_torch.physics import fluid as fd
    from sphinxsys_tpu_torch.physics import general as gd

    torch.cuda.reset_peak_memory_stats()
    case, fluid = tg.build_case(dx=0.01, device=DEVICE)
    sim = tg.init_sim(case, fluid)
    ke0 = float(gd.total_kinetic_energy(sim.fluid))
    t0 = time.perf_counter()
    sim = tg.make_run_chunk(case)(sim, 0.1)
    elapsed = time.perf_counter() - t0
    ke = float(gd.total_kinetic_energy(sim.fluid))
    nu = tg.MU_F / tg.RHO0_F
    expected = ke0 * math.exp(-16.0 * math.pi ** 2 * nu * float(sim.time))
    rel = abs(ke - expected) / expected
    log(f"gather tg decay: dx=0.01 t={float(sim.time):.6f} n_adv={sim.n_adv} "
        f"n_ac={sim.n_ac} KE0={ke0:.9f} KE={ke:.9f} analytic {expected:.9f} "
        f"(rel {rel:.4f}); {elapsed / sim.n_adv * 1e3:.3f} ms an advection "
        f"step (wall clock, mean)")
    check(not bool(sim.overflow), "gather tg decay: overflow")
    check(rel < 0.08, f"gather tg decay: KE off the analytic decay by {rel:.4f}")

    step = tg.make_advection_step(case)
    f = sim.fluid
    dt_adv = fd.advection_viscous_time_step(f, case.adaptation.h, tg.U_F,
                                            tg.RHO0_F, tg.MU_F)
    fns = {"rebuild": lambda: tg.rebuild_inner(case, f),
           "prep": lambda: tg.advection_prep(case, sim, f),
           "acoustic_substep": lambda: tg.acoustic_substep(case, sim, f,
                                                           dt_adv)}
    parts = {"advection_step": wall_s(torch, lambda: step(sim), 3) * 1e3}
    parts.update({k: wall_s(torch, fn, 5) * 1e3 for k, fn in fns.items()})
    log("gather tg step parts (ms, wall clock): "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
    dev_us, _, plain_us, launches = profile_step(torch, "gather_tg",
                                                 lambda: step(sim))
    prof = profile_parts(torch, "gather_tg", fns)
    results["_gather_tg"] = dict(
        n_fluid=case.n_fluid, n_adv=sim.n_adv, n_ac=sim.n_ac,
        ms_per_adv=elapsed / sim.n_adv * 1e3, parts_ms=parts, part_device=prof,
        device_busy_ms=dev_us / 1e3, launches_per_adv=launches,
        idle_share_est=1 - dev_us / plain_us, ke_rel=rel,
        run_peak_gb=peak_gb(torch))


def fsi2_gather_gates():
    """What the card's fsi2 gather run to FSI2_T_END is held to: the
    acoustic and solid sub-step counts within FSI2_COUNT_BAND of the JAX
    package's float32 gather runs (x64 on: 815 / 1,629; off: 785 / 1,570),
    outside the span of both widened by the band; the tip's excursion
    within the largest of all four JAX float32 runs (`fsi2_gates`: the
    start-up pulse, which each float32 run resolves its own way)."""
    runs = json.loads((ROOT / FSI2_JAX_RUNS).read_text())["runs"]
    gather = [r for r in runs if r["route"] == "gather"]
    n_ac = [r["rows"][-1][2] for r in gather]
    n_s = [r["rows"][-1][3] for r in gather]
    band = lambda ns: ((1 - FSI2_COUNT_BAND) * min(ns),
                       (1 + FSI2_COUNT_BAND) * max(ns))
    gather_tip = max(math.hypot(row[4], row[5]) for r in gather
                     for row in r["rows"])
    return dict(n_ac=band(n_ac), n_s=band(n_s),
                tip_radius=fsi2_gates()["tip_radius"], gather_tip=gather_tip)


def fsi2_gather_path(torch, results):
    """fsi2's gather route on the card: to FSI2_SHORT against the same run
    on the CPU (float32: equal counts, the fluid's positions within
    FSI2_SHORT_TOL); then to FSI2_T_END through build_case -> init_sim ->
    make_run_chunk, the tip sampled every FSI2_SAMPLE and the host reads of
    device values counted, held to `fsi2_gather_gates`; its step by part,
    one profiled step, and each part (the couplings over the insert's
    list among them) profiled alone."""
    from sphinxsys_tpu_torch.cases import fsi2 as fc
    from sphinxsys_tpu_torch.ops import block_sweeps as bs
    from sphinxsys_tpu_torch.physics import fluid as fd
    from sphinxsys_tpu_torch.physics import fsi

    runs = {}
    for dev in (DEVICE, "cpu"):
        case, fluid, solid = fc.build_case(dx=FSI2_DX, device=dev)
        s = fc.make_run_chunk(case)(fc.init_sim(case, fluid, solid), FSI2_SHORT)
        runs[dev] = (s.n_adv, s.n_ac, s.n_s), s.fluid["Position"].cpu(), \
            s.solid["Position"].cpu()
    (kc, pc, so_c), (kh, ph, so_h) = runs[DEVICE], runs["cpu"]
    gap = float((pc - ph).abs().max())
    gap_s = float((so_c - so_h).abs().max())
    log(f"fsi2 gather short: to t={FSI2_SHORT} card {kc}, cpu {kh}; max "
        f"|dpos| fluid {gap:.3e}, solid {gap_s:.3e} (tolerance {FSI2_SHORT_TOL})")
    check(kc == kh, "fsi2 gather short: counts differ")
    check(gap <= FSI2_SHORT_TOL and gap_s <= FSI2_SHORT_TOL,
          "fsi2 gather short: positions differ")

    gates = fsi2_gather_gates()
    torch.cuda.reset_peak_memory_stats()
    case, fluid, solid = fc.build_case(dx=FSI2_DX, device=DEVICE)
    run = fc.make_run_chunk(case)
    sim = fc.init_sim(case, fluid, solid)
    idx, w = fc.tip_observer(case, solid)
    tip0 = fc.observe_tip(solid, idx, w)
    tip_max, samples = 0.0, 0
    bs.reset_launch_counts()
    t1 = time.perf_counter()
    with SyncCounter(torch) as syncs:
        while float(sim.time) < FSI2_T_END:
            samples += 1
            sim = run(sim, samples * FSI2_SAMPLE)
            d = fc.observe_tip(sim.solid, idx, w) - tip0
            tip_max = max(tip_max, float(torch.linalg.vector_norm(d)))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t1
    counts = dict(bs.LAUNCHES)
    n_sync = syncs.n - 2 * samples - 1
    log(f"fsi2 gather main path: to t={float(sim.time):.6f} n_adv={sim.n_adv} "
        f"n_ac={sim.n_ac} n_s={sim.n_s} (band n_ac {gates['n_ac']}, n_s "
        f"{gates['n_s']}) in {elapsed:.2f} s: {elapsed / sim.n_adv * 1e3:.3f} "
        f"ms an advection step (wall clock, mean), {n_sync} host reads of "
        f"device values ({n_sync / sim.n_adv:.2f} an advection step); tip "
        f"max|d| {tip_max:.4f} (bound {gates['tip_radius']:.4f}; JAX's gather "
        f"runs reach {gates['gather_tip']:.4f}); block kernel launches "
        f"{counts}; peak device memory {peak_gb(torch):.3f} GB")
    check(not bool(sim.overflow), "fsi2 gather: neighbour-list overflow")
    for k in ("Position", "Velocity", "Density", "Pressure"):
        check(bool(torch.isfinite(sim.fluid[k]).all()),
              f"fsi2 gather: non-finite fluid {k}")
    for k in ("Position", "Velocity", "DeformationGradient"):
        check(bool(torch.isfinite(sim.solid[k]).all()),
              f"fsi2 gather: non-finite solid {k}")
    check(gates["n_ac"][0] <= sim.n_ac <= gates["n_ac"][1]
          and gates["n_s"][0] <= sim.n_s <= gates["n_s"][1],
          f"fsi2 gather: counts {sim.n_ac} / {sim.n_s} off the band")
    check(tip_max <= gates["tip_radius"],
          f"fsi2 gather: tip displaced {tip_max:.4f} > {gates['tip_radius']:.4f}")
    check(not any(counts.values()), f"fsi2 gather: a block kernel ran {counts}")

    step = fc.make_advection_step(case)
    h, kern = case.adaptation.h, case.kernel
    dt_adv = fd.advection_viscous_time_step(sim.fluid, h, fc.U_F, fc.RHO0_F,
                                            fc.MU_F)
    dt = torch.minimum(fd.acoustic_time_step(sim.fluid, case.eos, h), dt_adv)
    pressure = lambda: fsi.pressure_force_from_fluid(
        sim.solid, sim.fluid, sim.nl_sf, kern, 2, case.riemann, box=case.box)
    viscous = lambda: fsi.update_elastic_normal_direction(
        fsi.viscous_force_from_fluid(sim.solid, sim.fluid, sim.nl_sf, kern, 2,
                                     fc.MU_F, h, box=case.box))
    fns = {"rebuild": lambda: fc.rebuild_relations(case, sim.fluid, sim.solid),
           "prep": lambda: fc.advection_prep(case, sim),
           "acoustic_substep": lambda: fc.acoustic_substep(
               case, sim, sim.fluid, sim.solid, dt_adv, sim.time),
           "solid_substeps": lambda: fc.solid_substeps(case, sim.solid, dt),
           "pressure_force": pressure, "viscous_force": viscous}
    parts = {"advection_step": wall_s(torch, lambda: step(sim), 3) * 1e3}
    parts.update({k: wall_s(torch, fn, 5) * 1e3 for k, fn in fns.items()})
    log("fsi2 gather step parts (ms, wall clock): "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; the block route's (phase 9): "
        f"{json.dumps(results.get('_fsi2_main', {}).get('parts_ms'))}")
    dev_us, _, plain_us, launches = profile_step(torch, "fsi2_gather",
                                                 lambda: step(sim))
    prof = profile_parts(torch, "fsi2_gather", fns)
    results["_gather_fsi2"] = dict(
        t_end=float(sim.time), n_adv=sim.n_adv, n_ac=sim.n_ac, n_s=sim.n_s,
        ms_per_adv=elapsed / sim.n_adv * 1e3,
        host_reads_per_adv=n_sync / sim.n_adv, parts_ms=parts,
        device_busy_ms=dev_us / 1e3, launches_per_adv=launches,
        idle_share_est=1 - dev_us / plain_us, tip_max=tip_max,
        part_device=prof)


def gather_phase(torch, results):
    """Phase 11: the gather fluid routes (neighbour lists rebuilt every
    advection step, the pair sums as torch ops over them, no hand kernel)
    on the card: small references against the CPU, the third oracle
    against the block route's kernels, the 2D and 3D dambreaks at full
    width (the 2D one with the Morton resort), Taylor–Green's decay, and
    fsi2 to FSI2_T_END."""
    t0 = time.perf_counter()
    gather_small_reference(torch, "dambreak_2d", 0.1, 0.08)
    gather_small_reference(torch, "taylor_green_2d", 0.05, 0.08)
    gather_block_oracle(torch)
    gather_tg_decay(torch, results)
    for tag, cfg in GATHER_CONFIGS.items():
        gather_main_path(torch, tag, cfg, results)
    fsi2_gather_path(torch, results)
    log(f"gather phase: {time.perf_counter() - t0:.1f} s")


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

    from sphinxsys_tpu_torch.benchmarks import perturbed
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
            fluid = perturbed(fluid, cfg["dx"])
        sim = sc.make_advection_step(scene)(sc.init_sim(scene, fluid))
        compare_kernels(torch, tag, cfg, scene, sim, results)
        if scene.wall_b is not None:
            moving_wall_check(torch, tag, scene, sim)
            padding_checks(torch, tag, scene, sim,
                           torch.Generator(device=DEVICE).manual_seed(13))
        else:
            tg_dissipative_ac2_check(torch, scene, sim)
        del scene, fluid, sim
        torch.cuda.empty_cache()
    cap40_check(torch)
    small_reference_check(torch, "dambreak_2d", 0.1, 0.08)
    small_reference_check(torch, "taylor_green_2d", 0.05, 0.08)
    tg_decay_check(torch)

    for tag, cfg in CONFIGS.items():
        scene, sim = run_main_path(torch, tag, cfg, results)
        step = sc.make_advection_step(scene)
        profile_step(torch, tag, lambda: step(sim))
        del scene, sim, step
        torch.cuda.empty_cache()
    fsi2_phase(torch, results)
    packed_phase(torch, results)
    solid_phase(torch, results)
    gather_phase(torch, results)

    kernels = []
    for tag, names in [*((t, c["kernels"]) for t, c in CONFIGS.items()),
                       ("fsi2", tuple(KERNELS))]:
        for name in names:
            r = results[f"{name}[{tag}]"]
            kernels.append({"name": f"{name}[{tag}]", "route": "cuda",
                            "source": SOURCE, "replaces": KERNELS[name][0],
                            "launches": r["launches"],
                            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                            "bound_by": r["bound_by"], "library_ms": None})
    for table, source, tag in ((PACKED_KERNELS, PACKED_SOURCE, "2d16"),
                               (LAYOUT_KERNELS, LAYOUT_SOURCE, "2d16"),
                               (LATTICE_KERNELS, LATTICE_SOURCE, "tc1m")):
        for name, (replaces, _) in table.items():
            r = results[f"{name}[{tag}]"]
            kernels.append({"name": f"{name}[{tag}]", "route": "cuda",
                            "source": source, "replaces": replaces,
                            "launches": r["launches"],
                            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                            "plain_ms": r["plain_ms"],
                            "bound_ms": r["bound_ms"],
                            "bound_by": r["bound_by"],
                            "library_ms": r.get("library_ms")})
    main_paths = {tag: results[f"_{tag}_main"]
                  for tag in (*CONFIGS, "fsi2", "2d16", "2d16_b2b3", "layout",
                              "tc1m", "tc1m_plain")}
    main_paths["tc_gather"] = results["_tc_gather"]
    for tag in (*GATHER_CONFIGS, "tg", "fsi2"):
        main_paths[f"gather_{tag}"] = results[f"_gather_{tag}"]
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
