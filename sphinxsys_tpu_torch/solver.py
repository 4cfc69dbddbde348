"""Solver loop (counterpart of sphinxsys_tpu/solver.py: `PhaseTimer`,
`run_simulation`): when to stop, when to fire outputs, and wall-clock
accounting per phase; `chunk_runner`, every route's loop of advection
steps up to a target time."""

from __future__ import annotations

import time
from typing import Callable, Dict

import torch


class PhaseTimer:
    """Wall-clock accumulation per named phase (TickCount/TimeInterval).
    A phase that ends in a host sync (as `integrate` does: the loop
    conditions read the device) times the device work inside it."""

    def __init__(self):
        self.totals: Dict[str, float] = {}

    class _Ctx:
        def __init__(self, timer, name):
            self.timer, self.name = timer, name

        def __enter__(self):
            self.t0 = time.perf_counter()

        def __exit__(self, *exc):
            self.timer.totals[self.name] = self.timer.totals.get(
                self.name, 0.0) + time.perf_counter() - self.t0

    def phase(self, name: str):
        return self._Ctx(self, name)

    def report(self) -> str:
        total = sum(self.totals.values())
        lines = [f"Total wall time for computation: {total:.3f} s"]
        for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {k}: {v:.3f} s")
        return "\n".join(lines)


def chunk_runner(advection_step: Callable):
    """run_chunk(sim, t_target) from a route's advection step: advance until
    sim.time >= t_target, compared in the time's dtype, one host read of
    the time a step."""
    def run_chunk(s, t_target):
        target = torch.as_tensor(t_target, dtype=s.time.dtype,
                                 device=s.time.device)
        while bool(s.time < target):
            s = advection_step(s)
        return s

    return run_chunk


def run_simulation(run_chunk, sim, end_time: float, output_interval: float,
                   on_output: Callable | None = None, verbose: bool = True):
    """Drive run_chunk to end_time, firing `on_output(sim)` every output
    interval.  Returns (sim, PhaseTimer).  A capacity overflow (block slots
    or neighbour lists) raises: its results are invalid."""
    timer = PhaseTimer()
    t = float(sim.time)
    n_out = int(t / output_interval)
    while t < end_time - 1e-12:
        target = min((n_out + 1) * output_interval, end_time)
        with timer.phase("integrate"):
            sim = run_chunk(sim, target)
            t = float(sim.time)
        n_out += 1
        if bool(sim.overflow):
            raise RuntimeError("capacity overflow — raise cap / c_max (block "
                               "route) or cell_cap / k_* (gather route)")
        with timer.phase("output"):
            if on_output is not None:
                on_output(sim)
        if verbose:
            print(f"t = {t:.4f} / {end_time}  (adv {sim.n_adv}, "
                  f"ac {sim.n_ac})", flush=True)
    if sim.time.device.type == "cuda":
        torch.cuda.synchronize(sim.time.device)
    return sim, timer
