"""How many of a step's launches torch.profiler records on the card.

A step of known launch count (n in-place additions, one kernel each),
between two marker kernels (`torch.cuda._sleep`, the `spin_kernel`), is
profiled 10 times in each of four ways:

  * cold: a profiler session that records from its first op (the way
    `chip_smoke.profile_step` first recorded);
  * cold_pad: as cold, with 20 ms of host sleep inside the recorded
    window before the first marker and after the step's last sync;
  * warm: a session whose recorded step follows a warm-up step, device
    tracing already on (`schedule(warmup=1, active=1)`);
  * warm_pad: as warm, with the pads.

Each trial prints the additions and markers recorded and whether the
first and the last recorded kernel are markers, so that a loss at the
window's start, at its end or inside it can be told apart:

    python -m sphinxsys_tpu_torch.benchmarks.profiler_check [--out FILE]

Exits 1 on a box with no card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

SIZES = (60, 1000, 15000)   # additions a step
TRIALS = 10
PAD_S = 0.02


def recorded(torch, n, way):
    """(additions, markers) that one profiled step records, and whether
    the first and the last kernel it records are markers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    x = torch.zeros(64, device="cuda")

    def step():
        for _ in range(n):
            x.add_(1.0)

    def marked():
        torch.cuda._sleep(100)
        step()
        torch.cuda._sleep(100)
        torch.cuda.synchronize()

    step()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA]
    pad = way.endswith("_pad")
    if way.startswith("cold"):
        with profile(activities=acts) as prof:
            time.sleep(PAD_S if pad else 0.0)
            marked()
            time.sleep(PAD_S if pad else 0.0)
    else:
        with profile(activities=acts, schedule=schedule(
                wait=0, warmup=1, active=1, repeat=1)) as prof:
            step()
            torch.cuda.synchronize()
            prof.step()
            time.sleep(PAD_S if pad else 0.0)
            marked()
            time.sleep(PAD_S if pad else 0.0)
            prof.step()
    kern = sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    spin = ["spin_kernel" in e.name for e in kern]
    return (len(kern) - sum(spin), sum(spin), bool(spin) and spin[0],
            bool(spin) and spin[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("profiler_check: no CUDA device", file=sys.stderr)
        return 1
    out = {"device": torch.cuda.get_device_name(0), "pad_s": PAD_S,
           "runs": []}
    for n in SIZES:
        for way in ("cold", "cold_pad", "warm", "warm_pad"):
            trials = [recorded(torch, n, way) for _ in range(TRIALS)]
            whole = sum(t[0] == n for t in trials)
            out["runs"].append(dict(n=n, way=way, trials=trials,
                                    complete=whole))
            print(f"profiler_check n={n} {way}: {whole} of {len(trials)} "
                  f"trials recorded every addition; (additions, markers, "
                  f"first a marker, last a marker): {trials}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
