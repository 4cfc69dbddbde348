"""fsi2 to a long end time, the beam's flapping against the reference's:

    python -m sphinxsys_tpu_torch.benchmarks.fsi2_long [--t-end 200]
        [--dx 0.1] [--device cuda] [--out fsi2_long.json]

Runs `cases/fsi2.py` on the block engine (the kernels on the card), the
beam tip read every --every through the reference's frozen-weight
observer, and reports what tests/test_fsi.py:124-133 holds the JAX
package's committed t = 200 curve to: the flapping amplitude, half the
tip's y range over the second half of the samples (the reference runs:
0.65-0.95), and the mean tip y (2.05 +- 0.15).  Writes the samples, the
counts and the wall time to --out as JSON; prints one line a time unit.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from sphinxsys_tpu_torch.cases import fsi2
from sphinxsys_tpu_torch.device import resolve_device
from sphinxsys_tpu_torch.engine import scene as sc


def run(t_end: float, dx: float, every: float, device) -> dict:
    device = resolve_device(device)
    scene, fluid, solid = fsi2.build_block_case(dx=dx, device=device)
    sim = fsi2.init_block_sim(scene, fluid, solid)
    idx, w = fsi2.tip_observer(scene.base, solid)
    step = sc.make_run_chunk(scene)
    rows = []
    t0 = time.perf_counter()
    k = 0
    while float(sim.time) < t_end:
        k += 1
        sim = step(sim, k * every)
        tip = fsi2.observe_tip(sim.aux["solid"], idx, w).tolist()
        rows.append([float(sim.time), *tip])
        if bool(sim.overflow) or not np.isfinite(tip).all():
            break
        if int(k * every) != int((k - 1) * every):
            print(f"t={float(sim.time):.3f} n_adv={sim.n_adv} n_ac={sim.n_ac} "
                  f"n_s={sim.aux['n_s']} tip={tip} "
                  f"wall={time.perf_counter() - t0:.1f} s", flush=True)
    y = np.asarray([r[2] for r in rows])
    half = y[len(y) // 2:]
    return dict(
        device=(torch.cuda.get_device_name(device)
                if device.type == "cuda" else "cpu"),
        dx=dx, t_end=t_end, t_reached=float(sim.time), n_adv=sim.n_adv,
        n_ac=sim.n_ac, n_s=sim.aux["n_s"], overflow=bool(sim.overflow),
        wall_s=time.perf_counter() - t0,
        amplitude=float(0.5 * (half.max() - half.min())),
        mean_y=float(y.mean()), samples=rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--t-end", type=float, default=200.0)
    ap.add_argument("--dx", type=float, default=0.1)
    ap.add_argument("--every", type=float, default=0.1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="fsi2_long.json")
    a = ap.parse_args(argv)
    res = run(a.t_end, a.dx, a.every, a.device)
    with open(a.out, "w") as f:
        json.dump(res, f)
    print(json.dumps({k: v for k, v in res.items() if k != "samples"}))
    ok = (not res["overflow"] and res["t_reached"] >= a.t_end
          and 0.65 <= res["amplitude"] <= 0.95 and abs(res["mean_y"] - 2.05) < 0.15)
    print("within the reference's flapping (amplitude 0.65-0.95, mean y "
          f"2.05 +- 0.15): {ok}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
