"""Layout experiment 2: the cell axis fastest (counterpart of the JAX
package's benchmarks/exp_layout2.py).

On the TPU the pairs were laid out (16_i, 16_j, C) so that the cell axis
filled the vector lanes.  On the card that layout is B7: the neighbour
rows are gathered and transposed channel-major beforehand (`prep_t`,
xj_t (9, 8, 16, C)), and one thread per (i, cell), the cell on the
fastest axis, streams them with every read coalesced and none indirect.
A block of 32 cells votes on its masks and stages and sums only the slot
rows that hold a real slot somewhere in the tile.  The gather costs a
295 MB copy at the 2D dambreak's bench width.

Variants (the inner first-half acoustic sweep, one launch per run):
  a)  plain (C, 16, 16) broadcasts      — B5a's plain version
  b)  plain (16, 16, C) transposed, prep_t included
  b2) plain (16, 16, C) transposed alone on a fixed input
  c)  prep_t + B7 kernel
  c2) B7 kernel alone on a fixed input (the tile's live rows only)
  g)  prep_t alone — the input cost of (c)
Cross-check: b against c on the same input (as the JAX script), and the
B5a kernel against c transposed.

    python -m sphinxsys_tpu_torch.benchmarks.exp_layout2 [--dx --device --k]

What is dropped: the JAX script rounded c_max to a multiple of 2048
(MB_CROUND) for its 512-cell tile; B7 takes any cell count.  Each run is
one launch, timed alone (CUDA events, median of k), not a jitted loop.
"""

from __future__ import annotations

from sphinxsys_tpu_torch.benchmarks import (
    CROSS_TOL, b5a_channels, banner, cli, device_name, layout_state,
    median_ms, rel_err, report,
)
from sphinxsys_tpu_torch.device import resolve_device
from sphinxsys_tpu_torch.ops import layout_sweeps as ls
from sphinxsys_tpu_torch.ops import packed_sweeps as ps

B7_KERNEL = "c2) B7 kernel alone (tile's live rows)"


def run(dx: float = 0.0025, device="cuda", k: int = 20,
        state: dict | None = None) -> dict:
    """Time the six variants on the 2D dambreak at `dx` (cap 16) and
    cross-check them; `state`, a `layout_state` at that `dx` on `device`,
    is used instead of building one.  Returns the times (ms), the
    cross-check errors and whether they are within CROSS_TOL."""
    dev = resolve_device(device)
    st = layout_state(dx, dev) if state is None else state
    packed, nbr = st["packed"], st["nbr"]
    consts = (st["inv_h"], st["factor_w"], st["inv_rho0c0"])
    c = nbr.shape[0]
    banner("exp_layout2", dev, st, dx)

    xi_t, xj_t = ls.prep_t(packed, nbr)
    variants = {
        "g) prep_t (gather + transpose)": lambda: ls.prep_t(packed, nbr),
        "a) plain (C,16,16) broadcast":
            lambda: b5a_channels(ps.ac1_inner_sweep_plain, st),
        "b) plain (16,16,C) transposed incl prep_t":
            lambda: ls.ac1_t_sweep_plain(*ls.prep_t(packed, nbr), *consts),
        "b2) plain (16,16,C) transposed alone":
            lambda: ls.ac1_t_sweep_plain(xi_t, xj_t, *consts),
        "c) B7 kernel incl prep_t":
            lambda: ls.ac1_t_sweep(*ls.prep_t(packed, nbr), *consts),
        B7_KERNEL: lambda: ls.ac1_t_sweep(xi_t, xj_t, *consts),
    }
    ms = {}
    for label, fn in variants.items():
        ms[label] = median_ms(fn, k, dev)
        report(label, ms[label])

    t_plain = ls.ac1_t_sweep_plain(xi_t, xj_t, *consts)
    t_kernel = ls.ac1_t_sweep(xi_t, xj_t, *consts)
    b5a = tuple(a.t() for a in b5a_channels(ps.ac1_inner_sweep, st))
    cross = {"b_vs_c": rel_err(t_kernel, t_plain),
             "b5a_vs_c": rel_err(t_kernel, b5a)}
    agree = all(e <= CROSS_TOL for e in cross.values())
    print(f"b vs c (transposed plain vs B7): {cross['b_vs_c']:.3e}, B5a vs c: "
          f"{cross['b5a_vs_c']:.3e} of max|ref| (limit {CROSS_TOL:g}): "
          f"{'agree' if agree else 'DISAGREE'}", flush=True)
    return dict(device=device_name(dev), dx=dx, c_max=c,
                n_fluid=st["n_fluid"], ms=ms, cross_check=cross,
                tolerance=CROSS_TOL, agree=agree)


def main() -> int:
    return cli(run, "Layout experiment 2: the channel-major B7 sweep.")


if __name__ == "__main__":
    raise SystemExit(main())
