"""Layout experiments of the inner first-half acoustic sweep (counterparts
of the JAX package's benchmarks/exp_layout.py and exp_layout2.py, which
import a case module the engine work has since removed and no longer run):

    python -m sphinxsys_tpu_torch.benchmarks.exp_layout   [--dx 0.1 --device cpu]
    python -m sphinxsys_tpu_torch.benchmarks.exp_layout2  [--dx 0.1 --device cpu]

Each times three decompositions of the same sweep on the same state — B5a
(one thread per (cell, i)), B6 (one per (cell, i, j)) and B7 (one per
(i, cell) on a pre-gathered channel-major copy) — beside plain PyTorch
forms, and cross-checks them.  The default device is the card; the CPU is
asked for explicitly and runs every sweep's plain version.

This module holds what both drivers share: the state, the timer, the
cross-check.
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from sphinxsys_tpu_torch.device import resolve_device

# max |x - y| <= CROSS_TOL max |y| per output channel: the bound the CPU
# tests hold the plain sweeps to against JAX's Pallas kernels; float32 sums
# of the same pair terms in other orders differ by ~1e-7 of it
CROSS_TOL = 2e-5


def layout_state(dx: float, device) -> dict:
    """The 2D dambreak on the cell-block engine at cap 16
    (`build_block_case` -> `init_sim`), after one advection step of the
    engine (at the initial state every pressure is 0 and so is every sum
    of the sweep), packed by `pack_layout_state`."""
    from sphinxsys_tpu_torch.cases import dambreak_2d as db
    from sphinxsys_tpu_torch.engine import scene as sc
    from sphinxsys_tpu_torch.ops import packed_sweeps as ps

    scene, fluid = db.build_block_case(dx=dx, cap=ps.CAP,
                                       device=resolve_device(device))
    sim = sc.make_advection_step(scene)(sc.init_sim(scene, fluid))
    if bool(sim.overflow):
        raise RuntimeError(f"block capacity overflow at dx={dx}")
    return pack_layout_state(scene, sim)


def pack_layout_state(scene, sim) -> dict:
    """A cap-16 2D block state packed as the sweeps take it: packed
    (C+1, 16, 8) [x, y, vx, vy, p, vol, mask, 0], the window map nbr (C, 9)
    and the sweep constants."""
    from sphinxsys_tpu_torch.ops import packed_sweeps as ps

    fb, eng = sim.fluid_b, scene.eng
    packed = ps.pack_state_2d(fb["Position"], fb["Velocity"], fb["Pressure"],
                              fb["VolumetricMeasure"], fb["SlotMask"])
    return dict(packed=packed, nbr=sim.nbr_inner, n_fluid=scene.n_fluid,
                kernel_h=eng.kernel.h, inv_h=1.0 / eng.kernel.h,
                factor_w=eng.kernel._factor_w(2),
                inv_rho0c0=eng.riemann1.inv_rho0c0_ave)


def b5a_channels(fn, st: dict):
    """B5a (`fn`: `ac1_inner_sweep` or its plain version) on the state, as
    (fx, fy, rd) channels of shape (C, 16)."""
    force, rd = fn(st["packed"], st["nbr"], st["kernel_h"], st["factor_w"],
                   st["inv_rho0c0"])
    return force[..., 0], force[..., 1], rd


def median_ms(fn, k: int, device) -> float:
    """Median time of fn() over k runs (ms), after one warm-up run.  On the
    card: CUDA events around each run, a ~0.5 ms device sleep queued before
    the first event so that they bracket device time, not the host's
    enqueue.  On the CPU: the host clock.

    This is also chip_smoke.py's timer: every kernel and plain-version time
    it reports comes from here, so a change to it changes the yardstick of
    every kernel time on record, not only the drivers'."""
    fn()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    times = []
    for _ in range(k):
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(1_000_000)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def rel_err(got, ref) -> float:
    """max over channels of max |got - ref| / max |ref| ((fx, fy, rd)
    tuples of equal shapes)."""
    worst = 0.0
    for a, b in zip(got, ref):
        scale = float(b.abs().max())
        worst = max(worst, float((a - b).abs().max()) / max(scale, 1e-30))
    return worst


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def banner(tag: str, dev: torch.device, st: dict, dx: float) -> None:
    note = "" if dev.type == "cuda" else \
        " (on the CPU every kernel wrapper runs its plain version)"
    print(f"{tag} on {device_name(dev)}: dx={dx} n_fluid={st['n_fluid']} "
          f"c_max={st['nbr'].shape[0]} cap=16{note}", flush=True)


def report(name: str, ms: float) -> None:
    print(f"{name:52s} {ms:9.4f} ms", flush=True)


def cli(run, description: str) -> int:
    """The drivers' command line: --dx, --device, --k; exit 1 when the
    cross-checks disagree."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--dx", type=float, default=0.0025)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--k", type=int, default=20)
    args = ap.parse_args()
    return 0 if run(dx=args.dx, device=args.device, k=args.k)["agree"] else 1
