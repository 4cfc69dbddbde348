"""Layout experiment 1: pairs flattened per cell (counterpart of the JAX
package's benchmarks/exp_layout.py).

On the TPU the hypothesis was that the (C, 16, 16) pair broadcasts waste
7/8 of the vector lanes and that flattening the pairs onto the lane axis,
(C, 256), recovers them.  On the card the flat layout is B6: one thread
per (cell, i, j) slot pair with a warp-shuffle sum over j, against B5a's
one thread per (cell, i) looping over j.

Variants (the inner first-half acoustic sweep, one launch per run):
  a) plain (C, 16, 16) broadcasts   — B5a's plain version
  b) plain (C, 256) flattened pairs — B6's plain version
  c) B5a kernel (C, 16) threads
  d) B6 kernel (C, 256) threads
Cross-check: b against d (as the JAX script), and B5a (c) against d.

    python -m sphinxsys_tpu_torch.benchmarks.exp_layout [--dx --device --k]

The TPU script ran each variant K times in one jitted loop to amortise the
host link; here each run is one launch, timed alone (CUDA events, median
of k).
"""

from __future__ import annotations

from sphinxsys_tpu_torch.benchmarks import (
    CROSS_TOL, b5a_channels, banner, cli, device_name, layout_state,
    median_ms, rel_err, report,
)
from sphinxsys_tpu_torch.device import resolve_device
from sphinxsys_tpu_torch.ops import layout_sweeps as ls
from sphinxsys_tpu_torch.ops import packed_sweeps as ps


def run(dx: float = 0.0025, device="cuda", k: int = 20,
        state: dict | None = None) -> dict:
    """Time the four variants on the 2D dambreak at `dx` (cap 16) and
    cross-check them; `state`, a `layout_state` at that `dx` on `device`,
    is used instead of building one.  Returns the times (ms), the
    cross-check errors and whether they are within CROSS_TOL."""
    dev = resolve_device(device)
    st = layout_state(dx, dev) if state is None else state
    packed, nbr = st["packed"], st["nbr"]
    consts = (st["inv_h"], st["factor_w"], st["inv_rho0c0"])
    c = nbr.shape[0]
    banner("exp_layout", dev, st, dx)

    variants = {
        "a) plain (C,16,16) broadcast":
            lambda: b5a_channels(ps.ac1_inner_sweep_plain, st),
        "b) plain (C,256) flat":
            lambda: ls.ac1_flat_sweep_plain(packed, nbr, *consts),
        "c) B5a kernel (C,16) threads":
            lambda: b5a_channels(ps.ac1_inner_sweep, st),
        "d) B6 kernel (C,256) threads":
            lambda: ls.ac1_flat_sweep(packed, nbr, *consts),
    }
    ms = {}
    for label, fn in variants.items():
        ms[label] = median_ms(fn, k, dev)
        report(label, ms[label])

    flat_plain = variants["b) plain (C,256) flat"]()
    flat = variants["d) B6 kernel (C,256) threads"]()
    b5a = variants["c) B5a kernel (C,16) threads"]()
    cross = {"b_vs_d": rel_err(flat, flat_plain), "c_vs_d": rel_err(flat, b5a)}
    agree = all(e <= CROSS_TOL for e in cross.values())
    print(f"b vs d (flat plain vs B6): {cross['b_vs_d']:.3e}, c vs d (B5a vs "
          f"B6): {cross['c_vs_d']:.3e} of max|ref| (limit {CROSS_TOL:g}): "
          f"{'agree' if agree else 'DISAGREE'}", flush=True)
    return dict(device=device_name(dev), dx=dx, c_max=c,
                n_fluid=st["n_fluid"], ms=ms, cross_check=cross,
                tolerance=CROSS_TOL, agree=agree)


def main() -> int:
    return cli(run, "Layout experiment 1: B5a against the flat B6 sweep.")


if __name__ == "__main__":
    raise SystemExit(main())
