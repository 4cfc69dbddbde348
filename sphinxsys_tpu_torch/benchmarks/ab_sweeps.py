"""The pair sweeps of several builds of one kernel source timed against
each other on the same inputs, in turns:

    python -m sphinxsys_tpu_torch.benchmarks.ab_sweeps A.cu B.cu [...]

e.g. A.cu a parent commit's sphinxsys_tpu_torch/csrc/block_sweeps.cu,
packed_sweeps.cu, layout_sweeps.cu or lattice_sweeps.cu (from `git
archive`) and B.cu the working tree's.  nvcc compiles each source with
the port's flags (ops/_build.py) into build/ab/, all at once, finding a
quoted include (lane_groups.cuh) beside the source, and the launchers
each library exports are bound by ctypes.  On the states chip_smoke.py measures, each after one
advection step, every build runs each sweep that all builds export on the
same inputs:

  * the block sweeps B1-B4 (block_sweeps.cu): the 2D dambreak at dx=0.0025
    (B1-B4, B4 with its static wall), the 3D one at dx=0.01 with cap 32
    (B1-B3) and Taylor–Green at dx=0.001 with seeded noise (B1-B4);
  * the packed sweeps B5a-d (packed_sweeps.cu): 2d16, the 2D dambreak at
    dx=0.0025 with cap 16, on the inputs the packed halves build;
  * the layout sweeps B6 and B7 (layout_sweeps.cu): the same 2d16 state
    packed as the layout drivers take it (`pack_layout_state`), B7 on
    `prep_t`'s pre-gathered input;
  * the lattice sweeps L1 and L2 (lattice_sweeps.cu): tc1m, the twisting
    column at dx=0.0175 (349 x 57 x 57 sites) after LATTICE_STEPS steps,
    on the arguments `lattice_inputs` forms, and the same state notched
    with NaN planted in the notch (`notched`).

Each build's ptxas lines (registers, spills) are printed, and for the
lattice sweeps each build's occupancy on the card where it exports
`lattice_occupancy`.  A sweep's
outputs are compared with the first build's on the real slots (the
lattice sweeps: on every site; max |diff| / max |first|, which must stay
within 1e-5; 0.0 is bit for bit), and it is timed with `median_ms` (20
runs) in four turns: in order, reversed, in order, reversed.  Needs the
card; exits 1 on a disagreement.
"""

from __future__ import annotations

import ctypes
import importlib
import subprocess
import sys
import time
from pathlib import Path

import torch

from sphinxsys_tpu_torch.benchmarks import (
    lattice_inputs, median_ms, notched, pack_layout_state, packed_inputs,
    perturbed, sweep_inputs,
)
from sphinxsys_tpu_torch.ops import _build
from sphinxsys_tpu_torch.ops import block_sweeps as bs
from sphinxsys_tpu_torch.ops import lattice_sweeps as lat
from sphinxsys_tpu_torch.ops import layout_sweeps as ls
from sphinxsys_tpu_torch.ops import packed_sweeps as ps

OUT_DIR = _build.BUILD_DIR.parent / "ab"
B1_B3 = ("density_sweep", "ac1_sweep", "ac2_sweep")
ALL = B1_B3 + ("visc_tvc_sweep",)
PACKED = ("ac1_inner_sweep", "ac2_inner_sweep", "ac1_wall_sweep",
          "ac2_wall_sweep")
LAYOUT = ("ac1_flat_sweep", "ac1_t_sweep")
STATES = (  # tag, case module, dx, build_block_case options, seeded noise,
    # sweeps
    ("2d", "dambreak_2d", 0.0025, {}, False, ALL),
    ("3d", "dambreak_3d", 0.01, {"cap": 32, "c_max": 125_000}, False, B1_B3),
    ("tg", "taylor_green_2d", 0.001, {}, True, ALL),
    ("2d16", "dambreak_2d", 0.0025, {"cap": ps.CAP}, False, PACKED + LAYOUT),
)
LATTICE = ("lattice_force", "lattice_dfdt")
LATTICE_DX = 0.0175         # tc1m, the bench's lattice solid
LATTICE_STEPS = 3
AGREE = 1e-5


def launcher(name) -> str:
    """A sweep's C launcher (ops/_build.py ARGTYPES)."""
    return name.replace("_sweep", "_launch") if name in PACKED + LAYOUT \
        else f"{name}_launch"


def launch_lattice(lib, name, args, out):
    """L1 or L2 of one build on its wrapper's arguments, into `out`, as
    ops/lattice_sweeps.py passes them to the launcher."""
    ptr = bs._ptr
    if name == "lattice_force":
        pos, S, jm2d, valid, shape, taps, vol0, cfg = args
        off, _, coef = lat._force_table(taps, float(vol0), float(cfg))
        head = (ptr(pos), ptr(S), ptr(jm2d), ptr(valid))
    else:
        vel, valid, shape, taps, vol0 = args
        off, _, coef = lat._dfdt_table(taps, float(vol0))
        head = (ptr(vel), ptr(valid))
    err = getattr(lib, launcher(name))(
        *head, *shape, off.ctypes.data, coef.ctypes.data, len(off), ptr(out),
        torch.cuda.current_stream().cuda_stream)
    bs._raise_on(err, name)


def build(sources) -> list:
    """One library per source, compiled in parallel; each bound to the
    launchers of ops/_build.py that it exports."""
    nvcc = _build.find_nvcc()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for k, src in enumerate(sources):
        so = OUT_DIR / f"{k}_{Path(src).stem}.so"
        jobs.append((so, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {so.name}:\n{log}")
        for line in log.splitlines():   # -Xptxas -v: registers, spills
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                print(f"{so.stem} ptxas: {line.strip()}", flush=True)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _build.ARGTYPES.items():
            fn = getattr(lib, name, None)
            if fn is not None:
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        libs.append(lib)
    return libs


def exported(lib, name) -> bool:
    return hasattr(lib, launcher(name))


def launch_packed(lib, name, args, kw, out):
    """A packed sweep of one build on its wrapper's arguments, into `out`,
    as ops/packed_sweeps.py passes them to the launcher."""
    ptr = bs._ptr
    consts = ps._constants(kw["kernel_h"], kw["factor_w"])
    if name.startswith("ac1"):
        consts += (kw["inv_rho0c0_ave"],)
    else:
        consts += (kw["rho0c0_geo"], kw["limiter_coeff"] * kw["inv_c0"])
    if name.endswith("inner_sweep"):
        packed, nbr = args
        head = (ptr(packed), ptr(nbr), nbr.shape[0])
    else:
        packed_i, wall, nbr_w = args
        head = (ptr(packed_i), ptr(wall), ptr(nbr_w), nbr_w.shape[0],
                wall.shape[0] - 1)
    err = getattr(lib, launcher(name))(
        *head, *consts, ptr(out), torch.cuda.current_stream().cuda_stream)
    bs._raise_on(err, name)


def launch_layout(lib, name, args, kw, out):
    """B6 or B7 of one build on its wrapper's arguments ((packed, nbr) or
    (xi_t, xj_t)), into `out`, as ops/layout_sweeps.py passes them."""
    a, b = args
    c = b.shape[0] if name == "ac1_flat_sweep" else a.shape[-1]
    err = getattr(lib, launcher(name))(
        bs._ptr(a), bs._ptr(b), c, kw["inv_h"],
        ls._dw_scale(kw["inv_h"], kw["factor_w"]), kw["inv_rho0c0"],
        bs._ptr(out), torch.cuda.current_stream().cuda_stream)
    bs._raise_on(err, name)


def launch(lib, name, args, kw, out):
    """`name` of one build on the wrappers' arguments, into `out` (B1's mask
    as float32, as the kernel reads it: `launch_args`)."""
    if name in PACKED:
        launch_packed(lib, name, args, kw, out)
        return
    if name in LAYOUT:
        launch_layout(lib, name, args, kw, out)
        return
    if name in LATTICE:
        launch_lattice(lib, name, args, out)
        return
    dim = args[0].shape[-1]
    box = bs._box3(kw["box"], dim)
    stream = torch.cuda.current_stream().cuda_stream
    ptr = bs._ptr
    if name == "density_sweep":
        pos, mask, nbr, wpos, wvol, nbr_w = args
        head = (dim,)
        consts = (kw["inv_h"], kw["factor_w"])
        fluid = (ptr(pos), ptr(mask), ptr(nbr))
        wall = (ptr(wpos), ptr(wvol), ptr(nbr_w))
    elif name == "ac1_sweep":
        pos, p, rho, acc, vol, nbr, wpos, wvol, wacc, nbr_w = args
        head = (dim, int(wacc is not None))
        consts = (kw["inv_h"], kw["dw_scale"], kw["inv_rho0c0"])
        fluid = (ptr(pos), ptr(p), ptr(rho), ptr(acc), ptr(vol), ptr(nbr))
        wall = (ptr(wpos), ptr(wvol), ptr(wacc), ptr(nbr_w))
    elif name == "ac2_sweep":
        pos, vel, vol, nbr, wpos, wvol, wvel, wn, nbr_w = args
        head = (dim, int(wvel is not None))
        consts = (kw["inv_h"], kw["dw_scale"], kw["rho0c0_geo"],
                  kw["lim_scale"])
        fluid = (ptr(pos), ptr(vel), ptr(vol), ptr(nbr))
        wall = (ptr(wpos), ptr(wvol), ptr(wvel), ptr(wn), ptr(nbr_w))
    else:
        pos, vel, vol, nbr, wpos, wvol, wvel, nbr_w = args
        head = (dim, int(wvel is not None))
        consts = (kw["inv_h"], kw["dw_scale"], kw["eps_r"])
        fluid = (ptr(pos), ptr(vel), ptr(vol), ptr(nbr))
        wall = (ptr(wpos), ptr(wvol), ptr(wvel), ptr(nbr_w))
    c, cap = nbr.shape[0], pos.shape[1]
    cw, capw = (wpos.shape[0] - 1, wpos.shape[1]) if nbr_w is not None \
        else (0, 0)
    err = getattr(lib, name + "_launch")(
        *head, *fluid, c, cap, *wall, cw, capw, *consts, *box, ptr(out),
        stream)
    bs._raise_on(err, name)


def launch_args(name, args) -> tuple:
    """The wrapper's arguments as `launch` takes them: B1's bool mask made
    float32 once, outside the timed calls (the wrapper converts it)."""
    if name != "density_sweep":
        return tuple(args)
    return (args[0], args[1].to(torch.float32).contiguous(), *args[2:])


def out_shape(name, args) -> tuple:
    """A sweep's output shape from its arguments: (C, cap, k); B6's
    (3, C, 16), B7's (3, 16, C), L1's (N, 3) and L2's (N, 3, 3)."""
    if name in LATTICE:
        n = args[0].shape[0]
        return (n, 3) if name == "lattice_force" else (n, 3, 3)
    if name in PACKED:
        return (args[-1].shape[0], ps.CAP, 3)
    if name == "ac1_flat_sweep":
        return (3, args[1].shape[0], ps.CAP)
    if name == "ac1_t_sweep":
        return (3, ps.CAP, args[0].shape[-1])
    pos = args[0]
    c, cap, dim = pos.shape[0] - 1, pos.shape[1], pos.shape[2]
    k = {"density_sweep": 2, "visc_tvc_sweep": 2 * dim}.get(name, dim + 1)
    return (c, cap, k)


def per_slot(name, out):
    """An output as (C, cap, k), slot-major whatever the sweep's layout."""
    if name == "ac1_flat_sweep":
        return out.permute(1, 2, 0)
    if name == "ac1_t_sweep":
        return out.permute(2, 1, 0)
    return out


def state_inputs(scene, sim, sweeps) -> dict:
    """The (args, kwargs) of each sweep in `sweeps` on one state."""
    out = {}
    if any(n in PACKED for n in sweeps):
        out.update(packed_inputs(scene, sim))
    if any(n in LAYOUT for n in sweeps):
        st = pack_layout_state(scene, sim)
        kw = {k: st[k] for k in ("inv_h", "factor_w", "inv_rho0c0")}
        out["ac1_flat_sweep"] = ((st["packed"], st["nbr"]), kw)
        out["ac1_t_sweep"] = (ls.prep_t(st["packed"], st["nbr"]), kw)
    block = tuple(n for n in sweeps if n not in PACKED + LAYOUT)
    if block:
        out.update(sweep_inputs(scene, sim, block))
    return out


def compare_and_time(libs, names, tag, name, args, kw, real, k) -> bool:
    """One sweep of every build on the same inputs: each build's output
    against the first build's on the rows `real` selects, then its time in
    four turns.  Prints one line; True if every build agrees."""
    outs = [torch.empty(out_shape(name, args), device="cuda") for _ in libs]
    for lib, out in zip(libs, outs):
        launch(lib, name, args, kw, out)
    torch.cuda.synchronize()
    first = per_slot(name, outs[0])[real]
    scale = float(first.abs().max())
    diffs = [float((per_slot(name, o)[real] - first).abs().max()) / scale
             for o in outs]
    order = list(range(len(libs)))
    times = [[] for _ in libs]
    for turn in (order, order[::-1], order, order[::-1]):
        for i in turn:
            times[i].append(median_ms(
                lambda: launch(libs[i], name, args, kw, outs[i]), k, "cuda"))
    print(f"{tag} {name}: " + ", ".join(
        f"{n} {min(t):.4f}..{max(t):.4f} ms (diff {d:.1e})"
        for n, t, d in zip(names, times, diffs)), flush=True)
    return all(d <= AGREE for d in diffs)


def lattice_states():
    """tc1m after LATTICE_STEPS steps, then notched: (tag, L1/L2 inputs)."""
    from sphinxsys_tpu_torch.cases import twisting_column_3d as tc
    from sphinxsys_tpu_torch.physics import solid as sd

    case, col = tc.build_case(dx=LATTICE_DX, engine="lattice", device="cuda")
    s = tc.init_sim(case, col)
    for _ in range(LATTICE_STEPS):
        s = tc._step(case, s)
    c = s.column
    dt = sd.solid_acoustic_time_step(c, case.material.sound_speed,
                                     case.adaptation.h, cfl=0.5)
    yield "tc1m", lattice_inputs(case, c, dt)
    cut, n_cut = notched(c)
    yield f"tc1m notched ({n_cut} NaN sites)", lattice_inputs(case, cut, dt)


def print_occupancy(libs, names, name) -> None:
    """One line: each build's design for L1 or L2 on this card, from its
    `lattice_occupancy` (blocks an SM, threads and shared memory a block);
    "-" for a build that does not export it (an older source)."""
    which = 0 if name == "lattice_force" else 1
    parts = []
    for n, lib in zip(names, libs):
        if not hasattr(lib, "lattice_occupancy"):
            parts.append(f"{n} -")
            continue
        res = (ctypes.c_int * 3)()
        bs._raise_on(lib.lattice_occupancy(which, res), f"{name} occupancy")
        parts.append(f"{n} {res[0]} blocks/SM x {res[1]} threads, "
                     f"{res[2]} B smem")
    print(f"{name} occupancy: " + "; ".join(parts), flush=True)


def run(sources, k: int = 20) -> bool:
    """Prints, per state and kernel, each build's time range over the four
    turns and its disagreement with the first build; True if all agree."""
    from sphinxsys_tpu_torch.engine import scene as sc

    t0 = time.perf_counter()
    libs = build(sources)
    names = [f"[{i}]" for i in range(len(sources))]
    print(f"built {len(libs)} sources in {time.perf_counter() - t0:.1f} s on "
          f"{torch.cuda.get_device_name(0)}: " + ", ".join(
              f"{n} {s}" for n, s in zip(names, sources)), flush=True)
    agree = True
    for tag, module, dx, kw_case, noise, sweeps in STATES:
        sweeps = tuple(n for n in sweeps
                       if all(exported(lib, n) for lib in libs))
        if not sweeps:
            continue
        case = importlib.import_module(f"sphinxsys_tpu_torch.cases.{module}")
        scene, fluid = case.build_block_case(dx=dx, device="cuda", **kw_case)
        if noise:
            fluid = perturbed(fluid, dx)
        sim = sc.make_advection_step(scene)(sc.init_sim(scene, fluid))
        c = sim.nbr_inner.shape[0]
        real = sim.fluid_b["SlotMask"][:c]
        inputs = state_inputs(scene, sim, sweeps)
        for name in sweeps:
            args, kw = inputs[name]
            agree &= compare_and_time(libs, names, tag, name,
                                      launch_args(name, args), kw, real, k)
        del scene, fluid, sim, inputs
        torch.cuda.empty_cache()
    if all(exported(lib, n) for lib in libs for n in LATTICE):
        for name in LATTICE:
            print_occupancy(libs, names, name)
        for tag, inputs in lattice_states():
            n = inputs["lattice_force"][0].shape[0]
            every = torch.ones(n, dtype=torch.bool, device="cuda")
            for name in LATTICE:
                agree &= compare_and_time(libs, names, tag, name, inputs[name],
                                          {}, every, k)
    return agree


def main(argv=None) -> int:
    sources = sys.argv[1:] if argv is None else argv
    if not sources:
        print(__doc__)
        return 2
    if not torch.cuda.is_available():
        print("ab_sweeps needs the card (torch.cuda.is_available() is False)")
        return 1
    ok = run(sources)
    print("agree" if ok else "DISAGREE", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
