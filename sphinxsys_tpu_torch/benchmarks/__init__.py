"""Layout experiments of the inner first-half acoustic sweep (counterparts
of the JAX package's benchmarks/exp_layout.py and exp_layout2.py, which
import a case module the engine work has since removed and no longer run):

    python -m sphinxsys_tpu_torch.benchmarks.exp_layout   [--dx 0.1 --device cpu]
    python -m sphinxsys_tpu_torch.benchmarks.exp_layout2  [--dx 0.1 --device cpu]

Each times three decompositions of the same sweep on the same state — B5a
(a 16-lane group per cell over its real slots), B6 (a warp per cell, its
real slot pairs spread over the lanes) and B7 (a thread per (i, cell) on a
pre-gathered channel-major copy, in 32-cell tiles that skip rows without a
real slot) — beside plain PyTorch forms, and cross-checks them.  The default
device is the card; the CPU is asked for explicitly and runs every
sweep's plain version.

`ab_sweeps` times the kernels of several builds of one source
(csrc/block_sweeps.cu, packed_sweeps.cu, layout_sweeps.cu or
lattice_sweeps.cu) against each other on the same inputs:

    python -m sphinxsys_tpu_torch.benchmarks.ab_sweeps A.cu B.cu [...]

This module holds what they share: the states, the block, packed and
lattice sweeps' inputs (also chip_smoke.py's), the timer, the cross-check.
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


def perturbed(fluid: dict, dx: float, seed: int = 11) -> dict:
    """The fluid state with seeded noise, as the CPU tests put on the
    Taylor–Green lattice: positions moved by up to 0.1 dx, velocities by
    N(0, 0.1).  On the bare lattice B4's transport-velocity sum cancels
    terms ~1e3 times its result, so the f32 rounding of any summation
    order swamps it; the noise makes every channel a sharp check."""
    pos, vel = fluid["Position"], fluid["Velocity"]
    g = torch.Generator(device=pos.device).manual_seed(seed)
    shift = torch.rand(pos.shape, generator=g, device=pos.device) - 0.5
    kick = torch.randn(vel.shape, generator=g, device=pos.device)
    return dict(fluid, Position=pos + 0.2 * dx * shift,
                Velocity=vel + 0.1 * kick)


def wall_blocks(scene, sim):
    """The wall block state the sweeps read at the next sub-step: the
    scene's static wall, or its moving wall refreshed in the slots of the
    current advection step from the sim's aux state (None: no wall)."""
    if scene.wall_state_fn is None:
        return scene.wall_b
    from sphinxsys_tpu_torch.engine import block_fluid as eng_mod

    return eng_mod.refresh_wall_blocks(sim.wall_bm, scene.wall_state_fn(sim.aux),
                                       sim.wall_b0)


def sweep_inputs(scene, sim, kernels) -> dict:
    """The block sweeps' (args, kwargs) by wrapper name, as the *_p2 forms
    build them from the current block state (the acoustic ones at the next
    sub-step's dt); a moving wall (an engine with wall_static off) with its
    velocity and acceleration channels."""
    from sphinxsys_tpu_torch.engine import block_fluid as eng_mod
    from sphinxsys_tpu_torch.physics import fluid_blocks as fbops

    eng, fb = scene.eng, sim.fluid_b
    kern, dim = eng.kernel, eng.dim
    inv_h = 1.0 / kern.h
    dw_scale = kern._factor_w(dim) * inv_h * 0.625
    wb, nw = wall_blocks(scene, sim), sim.nbr_wall
    wall = (lambda *k: (None,) * len(k)) if wb is None \
        else (lambda *k: tuple(wb[x] for x in k))
    moving = (lambda k: wb[k]) if wb is not None and not eng.wall_static \
        else (lambda k: None)
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
             *wall("Position", "VolumetricMeasure"),
             moving("AverageAcceleration"), nw),
            dict(inv_h=inv_h, dw_scale=dw_scale,
                 inv_rho0c0=eng.riemann1.inv_rho0c0_ave, box=box)),
        "ac2_sweep": (
            (pos, fb["Velocity"], fb["VolumetricMeasure"], sim.nbr_inner,
             *wall("Position", "VolumetricMeasure"), moving("AverageVelocity"),
             *wall("NormalDirection"), nw),
            dict(inv_h=inv_h, dw_scale=dw_scale, rho0c0_geo=geo,
                 lim_scale=lim_scale, box=box)),
        "visc_tvc_sweep": (
            (fb["Position"], fb["Velocity"], fb["VolumetricMeasure"],
             sim.nbr_inner, *wall("Position", "VolumetricMeasure"),
             moving("AverageVelocity"), nw),
            dict(inv_h=inv_h, dw_scale=dw_scale, eps_r=0.01 * eng.h, box=box)),
    }
    return {k: out[k] for k in kernels}


def packed_inputs(scene, sim, wall_b=None, riemann2=None) -> dict:
    """The four packed sweeps' (args, kwargs) by wrapper name, as the packed
    halves build them from the current block state (at the next sub-step's
    dt); `wall_b` (default: the scene's wall) and `riemann2` (default: the
    engine's 2nd-half solver) may be replaced."""
    from sphinxsys_tpu_torch.engine import block_fluid as eng_mod
    from sphinxsys_tpu_torch.physics import fluid_blocks as fbops

    eng, fb = scene.eng, sim.fluid_b
    wall_b = scene.wall_b if wall_b is None else wall_b
    riemann2 = eng.riemann2 if riemann2 is None else riemann2
    dt = eng_mod.acoustic_dt(eng, fb)
    _, _, _, pk1, pk1_i = fbops.packed_ac1_inputs(fb, eng.eos, dt)
    _, pk2, pk2_i = fbops.packed_ac2_inputs(fb, dt)
    c1 = fbops.packed_ac1_constants(eng.kernel, eng.riemann1)
    c2 = fbops.packed_ac2_constants(eng.kernel, riemann2)
    nbr, nbr_w = sim.nbr_inner, sim.nbr_wall
    return {
        "ac1_inner_sweep": ((pk1, nbr), c1),
        "ac2_inner_sweep": ((pk2, nbr), c2),
        "ac1_wall_sweep": ((pk1_i, fbops.pack_wall_ac1(wall_b), nbr_w), c1),
        "ac2_wall_sweep": ((pk2_i, fbops.pack_wall_ac2(wall_b), nbr_w), c2),
    }


def lattice_inputs(case, col, dt) -> dict:
    """L1's and L2's arguments by wrapper name on a twisting-column state,
    as the step builds them (L1 from the first half's prelude at `dt`)."""
    from sphinxsys_tpu_torch.physics import solid_lattice as sl

    lat, mat = case.lat, case.material
    pos_f, _, _, jm2d, S_f = sl.decomposed_stress(col, mat, dt, case.adaptation.h)
    vol0 = lat.dx ** 3
    return {"lattice_force": (pos_f, S_f, jm2d, col["LatticeValid"], lat.shape,
                              lat.taps, vol0,
                              sl.CORRECTION_FACTOR * mat.shear_modulus),
            "lattice_dfdt": (col["Velocity"], col["LatticeValid"], lat.shape,
                             lat.taps, vol0)}


def notched(col: dict):
    """The column state with the notch x in (2, 2.5), y > 0 made invalid and
    NaN planted in every per-site field there.  Returns (state, number of
    sites cut)."""
    x, y = col["InitialPosition"][:, 0], col["InitialPosition"][:, 1]
    cut = (x > 2.0) & (x < 2.5) & (y > 0.0)
    out = dict(col, LatticeValid=col["LatticeValid"] & ~cut)
    for k in ("Position", "Velocity", "DeformationGradient", "DeformationRate",
              "LinearGradientCorrectionMatrix"):
        t = out[k].clone()
        t[cut] = float("nan")
        out[k] = t
    return out, int(cut.sum())


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
