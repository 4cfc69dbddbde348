"""Solver driver utilities (counterpart of sphinxsys_tpu/solver.py;
reference sph_solver.h TimeStepper, TriggerByInterval, EventScheduler):
when to stop, when to fire outputs and events, wall-clock accounting per
phase, a torch.profiler trace of a run; `chunk_runner`, every route's
loop of advection steps up to a target time."""

from __future__ import annotations

import contextlib
import heapq
import os
import time
from typing import Callable, Dict, List

import torch


class TriggerByInterval:
    """Fires every `interval` of physical time (sph_solver.h:138-152)."""

    def __init__(self, interval: float, start: float = 0.0):
        self.interval = float(interval)
        self.next_time = start + self.interval

    def __call__(self, t: float) -> bool:
        if t >= self.next_time - 1e-12:
            while self.next_time <= t + 1e-12:
                self.next_time += self.interval
            return True
        return False


class TriggerByCount:
    """Fires every n-th call (the reference's iteration-modulo outputs)."""

    def __init__(self, every: int):
        self.every = int(every)
        self.count = 0

    def __call__(self, *_):
        self.count += 1
        return self.count % self.every == 0


class EventScheduler:
    """Priority queue of (time, callback) one-shot events (sph_solver.h:41);
    events at equal times fire in the order they were scheduled."""

    def __init__(self):
        self._heap: List = []
        self._n = 0

    def schedule(self, t: float, fn: Callable):
        heapq.heappush(self._heap, (t, self._n, fn))
        self._n += 1

    def next_time(self, default: float) -> float:
        return self._heap[0][0] if self._heap else default

    def fire_due(self, t: float):
        while self._heap and self._heap[0][0] <= t + 1e-12:
            _, _, fn = heapq.heappop(self._heap)
            fn(t)


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


class ProfilerTrace:
    """torch.profiler over a run region (the JAX package's jax.profiler
    hook): host ops and, where a card is present, its kernels and copies,
    written as a Chrome trace (`trace_<pid>_<ns>.json`) to `trace_dir`
    on exit.  `annotate(name)` tags a host phase, so that the device
    timeline can be segmented per solver phase."""

    def __init__(self, trace_dir: str):
        self.trace_dir = trace_dir
        self.path = None
        self._prof = None

    def __enter__(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
            os.makedirs(self.trace_dir, exist_ok=True)
            self.path = os.path.join(
                self.trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
            self._prof.export_chrome_trace(self.path)
            self._prof = None

    @staticmethod
    def annotate(name: str):
        return torch.profiler.record_function(name)


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


# the step counters a sim may carry, printed by run_simulation
_COUNTS = ("n_adv", "n_ac", "n_s", "n_steps", "n_macro", "n_sub")


def run_simulation(run_chunk, sim, end_time: float, output_interval: float,
                   on_output: Callable | None = None,
                   verbose: bool = True,
                   failure_check: Callable | None = None,
                   trace_dir: str | None = None):
    """Drive run_chunk to end_time, firing `on_output(sim)` every output
    interval — the main-loop shape of every reference case.  Returns
    (sim, PhaseTimer).

    A capacity overflow (block slots or neighbour lists) raises, since its
    results are invalid; a sim without an `overflow` flag (the lattice
    column has no capacity) has none to raise.
    `failure_check(sim) -> bool`: fired every output interval; True
    aborts with the state dumped (io/failure.py's velocity bound is the
    canonical one).
    `trace_dir`: write a torch.profiler trace of the whole run there."""
    timer = PhaseTimer()
    trace = ProfilerTrace(trace_dir) if trace_dir else contextlib.nullcontext()
    with trace:
        t = float(sim.time)
        n_out = int(t / output_interval)
        while t < end_time - 1e-12:
            target = min((n_out + 1) * output_interval, end_time)
            with timer.phase("integrate"):
                sim = run_chunk(sim, target)
                t = float(sim.time)
            n_out += 1
            overflow = getattr(sim, "overflow", None)
            if overflow is not None and bool(overflow):
                raise RuntimeError("capacity overflow — raise cap / c_max "
                                   "(block route) or cell_cap / k_* (gather "
                                   "route)")
            if failure_check is not None and failure_check(sim):
                raise RuntimeError(
                    f"failure check fired at t = {t:.6f}; state dumped")
            with timer.phase("output"):
                if on_output is not None:
                    on_output(sim)
            if verbose:
                counts = ", ".join(f"{k} {getattr(sim, k)}" for k in _COUNTS
                                   if hasattr(sim, k))
                print(f"t = {t:.4f} / {end_time}  ({counts})", flush=True)
        if sim.time.device.type == "cuda":
            torch.cuda.synchronize(sim.time.device)
    return sim, timer


def rk2_sequence(step_fn, keys):
    """Second-order Runge-Kutta sequence combinator (RungeKuttaSequence /
    Dynamics1LevelRK2): run the first-order step twice and average the
    advanced fields with their initial values.

    `step_fn(state, dt, *args, **kwargs) -> state` advances the fields in
    `keys` first order; the returned callable advances them second order.
    """

    def rk2(state, dt, *args, **kwargs):
        s1 = step_fn(state, dt, *args, **kwargs)
        s2 = step_fn(s1, dt, *args, **kwargs)
        out = dict(s2)
        for key in keys:
            out[key] = 0.5 * (state[key] + s2[key])
        return out

    return rk2
