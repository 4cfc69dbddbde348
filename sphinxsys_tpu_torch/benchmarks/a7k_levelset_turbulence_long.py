"""The level-set confinement, the turbulent channel and the two
relaxations to their JAX tests' ends, each held to that test's gates:

    python -m sphinxsys_tpu_torch.benchmarks.a7k_levelset_turbulence_long
        [--cases confinement,channel,shell,blade] [--device cuda]
        [--dtype float32] [--out a7k_long.json]

  * confinement: static_confinement_2d at its default dx = 0.025 to
    t = 20 (tests/test_static_confinement.py:22-41): at t = 1 and 2 the
    mechanical energy within 1.5% of its start; at t = 1, 2 and 3 no
    particle below -dx and none deeper than dx / 2 inside the ramp; at
    t = 3 the front short of DL + dx; the energy every 200 advection
    steps to t = 20 (benchmarks/run_refdb_parity.py's cadence), its DTW
    distance to the committed tests/golden/refdb/static_confinement_2d
    curve below 0.3 (the JAX test's cross-implementation envelope);
  * channel: turbulent_channel_2d at its default width, the centre-line
    eddy viscosity at t = 1 ... 20 held by DTWRegressionTest to
    tests/golden/turbulent_channel_2d
    (tests/test_golden_regression.py:255-276);
  * shell: shell_relaxation_2d at 2,000 iterations
    (tests/test_relax_implicit.py:73-95's gates): every particle within
    0.2 dx of the mid circle, every normal radial (|cos| > 0.99) with one
    global sign, the flood complete;
  * blade: implicit_relaxation_2d's 1,000 iterations on the NACA 0012
    stand-in of chord 4 (the turbine blade's file is not in the
    repository): the mean |residual| every 200 iterations falls at every
    record.

The JAX package's float32 CPU readings of the same runs sit in
tests/golden_torch/a7k/jax_f32.json, written by `JAX_PLATFORMS=cpu
PYTHONPATH=.:tests python tests/test_torch_static_confinement.py
jax_f32` (the confinement's and the channel's also from a start scaled
by 1 + 1e-7: JAX's own float32 spread of the distances); each run
prints them beside its own.  Exits 1 if a run raised, overflowed or
failed a gate (the other runs go on).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from sphinxsys_tpu_torch.benchmarks.a7bc_long import (GOLDEN, REFDB, _gate,
                                                      _record, run_all)
from sphinxsys_tpu_torch.benchmarks.a7e_damping_long import GOLDEN as \
    GOLDEN_TORCH

# the protocols, shared with the JAX float32 writer
CONF_T_END = 20.0
CONF_GATE_TIMES = (1.0, 2.0, 3.0)
CONF_ENERGY_UNTIL = 2.0
CONF_EVERY = 200
CONF_DTW_BOUND = 0.3
CHANNEL_TIMES = [float(i) for i in range(1, 21)]
SHELL_ITERATIONS = 2000
BLADE = dict(chord=4.0, n_iterations=1000, record_every=200)
JAX_F32 = os.path.join(GOLDEN_TORCH, "a7k", "jax_f32.json")
CONF_GOLDEN = os.path.join(REFDB, "static_confinement_2d",
                           "WaterBody_TotalMechanicalEnergy_Run_0_result.xml")


def jax_f32(name: str):
    if not os.path.exists(JAX_F32):
        return None
    with open(JAX_F32) as f:
        return json.load(f).get(name)


def _np(x):
    return x.detach().double().cpu().numpy() if torch.is_tensor(x) \
        else np.asarray(x, np.float64)


def _beside(name, mine):
    print(f"  {name}: this run {mine}; JAX's float32 CPU run "
          f"{jax_f32(name)}", flush=True)
    spread = jax_f32(f"{name}_perturbed")
    if spread is not None:
        key = "dtw_to_committed" if "dtw_to_committed" in spread \
            else "distance"
        print(f"  {name}: JAX's float32 CPU run from a start scaled by "
              f"1 + 1e-7 (its own spread): {key} {spread[key]}", flush=True)


# ---------------------------------------------------------------------------
# the readings and gates, on numpy (the JAX writer feeds its own runs)
# ---------------------------------------------------------------------------

def confinement_gate_reading(t, energy, pos, tri_sd, dx) -> dict:
    """The JAX test's quantities at one gate time."""
    return dict(t=float(t), energy=float(energy),
                min_y=float(pos[:, 1].min()), max_x=float(pos[:, 0].max()),
                in_ramp=int((tri_sd < -0.5 * dx).sum()))


def confinement_readings(e0, at_times, series) -> dict:
    from sphinxsys_tpu_torch.io import regression as rg

    golden = rg.read_result_xml(CONF_GOLDEN)[0]
    return dict(e0=float(e0), at_times=at_times,
                energy_change=[r["energy"] / e0 - 1.0 for r in at_times
                               if r["t"] <= CONF_ENERGY_UNTIL + 1e-9],
                dtw_to_committed=float(rg.dtw_distance(np.asarray(series),
                                                       golden)),
                n_samples=len(series))


def confinement_gates(r, dx, dl) -> dict:
    de = max(abs(x) for x in r["energy_change"])
    below = min(a["min_y"] for a in r["at_times"])
    ramp = max(a["in_ramp"] for a in r["at_times"])
    front = r["at_times"][-1]["max_x"]
    dtw = r["dtw_to_committed"]
    return dict(
        energy=_gate(de, de < 0.015, "|E/E0 - 1| < 0.015 at t = 1, 2"),
        floor=_gate(below, below > -dx, f"min y > -dx = {-dx}"),
        ramp=_gate(ramp, ramp == 0, "none deeper than dx/2 in the ramp"),
        front=_gate(front, front < dl + dx, f"max x < DL + dx at t = 3"),
        dtw=_gate(dtw, dtw < CONF_DTW_BOUND,
                  f"DTW to the committed curve < {CONF_DTW_BOUND}"))


def channel_readings(series) -> dict:
    from sphinxsys_tpu_torch.io.regression import DTWRegressionTest

    test = DTWRegressionTest(os.path.join(GOLDEN, "turbulent_channel_2d"),
                             "WaterBody", "TurbulentViscosity")
    ok, report = test.test(np.asarray(series))
    dist = [float(d) for d in np.ravel(test.distances(np.asarray(series)))]
    return dict(dtw_ok=bool(ok), distance=dist, report=str(report),
                mu_t_end=float(series[-1]))


def channel_gates(r) -> dict:
    return dict(dtw=_gate(r["distance"], r["dtw_ok"],
                          "DTWRegressionTest (the committed threshold)"))


def shell_readings(pos, normals, updated, r_mid) -> dict:
    r = np.linalg.norm(pos, axis=1)
    c = np.sum(normals * pos / r[:, None], axis=1)
    return dict(max_off_mid=float(np.abs(r - r_mid).max()),
                min_abs_cos=float(np.abs(c).min()),
                one_sign=bool((c > 0).all() or (c < 0).all()),
                all_updated=bool(np.asarray(updated).all()))


def shell_gates(r, dx) -> dict:
    return dict(
        mid=_gate(r["max_off_mid"], r["max_off_mid"] < 0.2 * dx,
                  f"|r - 25| < 0.2 dx = {0.2 * dx}"),
        radial=_gate(r["min_abs_cos"], r["min_abs_cos"] > 0.99,
                     "|cos| > 0.99"),
        sign=_gate(r["one_sign"], r["one_sign"], "one global sign"),
        flood=_gate(r["all_updated"], r["all_updated"], "all updated"))


def blade_readings(curve, pos, dx) -> dict:
    d2 = np.sum((pos[:, None, :] - pos[None, :, :]) ** 2, axis=-1)
    np.fill_diagonal(d2, np.inf)
    nn = np.sqrt(d2.min(axis=1))
    return dict(curve=[float(c) for c in curve],
                nn_min_over_dx=float(nn.min() / dx),
                nn_max_over_dx=float(nn.max() / dx))


def blade_gates(r) -> dict:
    c = np.asarray(r["curve"])
    falls = bool(len(c) > 1 and (np.diff(c) < 0).all())
    return dict(falls=_gate(r["curve"], falls,
                            "the mean |residual| falls at every record"))


# ---------------------------------------------------------------------------
# the runs
# ---------------------------------------------------------------------------

def _kw(dtype, **kw):
    return dict(kw, dtype=dtype) if dtype is not None else kw


def confinement(device, dtype) -> dict:
    import time

    from sphinxsys_tpu_torch.cases import static_confinement_2d as sc

    case, fluid = sc.build_case(**_kw(dtype, device=device))
    s = sc.init_sim(case, fluid)
    step = sc.make_advection_step(case)
    tri = sc.triangle_shape()
    e0 = sc.mechanical_energy(case, s)
    series, at_times = [e0], []
    gates = list(CONF_GATE_TIMES)
    t0 = time.perf_counter()
    while float(s.time) < CONF_T_END and not bool(s.overflow):
        s = step(s)
        t = float(s.time)
        if gates and t >= gates[0]:
            pos = s.fluid["Position"]
            at_times.append(confinement_gate_reading(
                gates.pop(0), sc.mechanical_energy(case, s), _np(pos),
                _np(tri.signed_distance(pos)), case.dx))
        if s.n_adv % CONF_EVERY == 0 or t >= CONF_T_END:
            series.append(sc.mechanical_energy(case, s))
            if len(series) % 5 == 0:
                print(f"  n_adv={s.n_adv} t={t:.3f} E={series[-1]:.5f} "
                      f"wall={time.perf_counter() - t0:.1f} s", flush=True)
    wall = time.perf_counter() - t0
    r = confinement_readings(e0, at_times, series)
    _beside("confinement", {k: v for k, v in r.items() if k != "at_times"})
    return _record("static_confinement_2d", s, wall, n_fluid=case.n_fluid,
                   readings=r, samples=series,
                   gates=confinement_gates(r, case.dx, sc.DL),
                   jax_f32=jax_f32("confinement"))


def channel(device, dtype) -> dict:
    import time

    from sphinxsys_tpu_torch.cases import turbulent_channel_2d as tc

    case, fluid = tc.build_case(**_kw(dtype, device=device))
    s = tc.init_sim(case, fluid)
    run = tc.make_run_chunk(case)
    series = []
    t0 = time.perf_counter()
    for t in CHANNEL_TIMES:
        s = run(s, t)
        pos = _np(s.fluid["Position"])
        j = int(np.argmin(np.linalg.norm(
            pos - np.asarray([case.length / 2, tc.DH / 2]), axis=1)))
        series.append(float(s.fluid["TurbulentViscosity"][j]))
        if bool(s.overflow):
            break
    wall = time.perf_counter() - t0
    r = channel_readings(series)
    _beside("channel", {k: v for k, v in r.items() if k != "report"})
    return _record("turbulent_channel_2d", s, wall, n_fluid=case.n_fluid,
                   readings=r, samples=series, gates=channel_gates(r),
                   jax_f32=jax_f32("channel"))


class _Relaxed:
    """A relaxation's result as a sim for `_record`."""

    def __init__(self, n):
        self.time = torch.zeros(())
        self.n_steps = n


def shell(device, dtype) -> dict:
    import time

    from sphinxsys_tpu_torch.cases import shell_relaxation_2d as sr

    t0 = time.perf_counter()
    pos, normals, updated = sr.run_case(
        **_kw(dtype, n_iterations=SHELL_ITERATIONS, device=device))
    wall = time.perf_counter() - t0
    r = shell_readings(_np(pos), _np(normals), updated.cpu().numpy(),
                       sr.R_MID)
    _beside("shell", r)
    return _record("shell_relaxation_2d", _Relaxed(SHELL_ITERATIONS), wall,
                   n_particles=pos.shape[0], readings=r,
                   gates=shell_gates(r, sr.DX), jax_f32=jax_f32("shell"))


def blade(device, dtype) -> dict:
    import time

    from sphinxsys_tpu_torch.cases import implicit_relaxation_2d as ir

    t0 = time.perf_counter()
    pos, curve, _ = ir.run_case(
        **_kw(dtype, n_iterations=BLADE["n_iterations"],
              record_every=BLADE["record_every"],
              blade=ir.naca0012(BLADE["chord"]), device=device))
    wall = time.perf_counter() - t0
    r = blade_readings(_np(curve), _np(pos), ir.DX)
    _beside("blade", r)
    return _record("implicit_relaxation_2d (NACA 0012, chord 4)",
                   _Relaxed(BLADE["n_iterations"]), wall,
                   n_particles=pos.shape[0], readings=r,
                   gates=blade_gates(r), jax_f32=jax_f32("blade"))


RUNS = {"confinement": confinement, "channel": channel, "shell": shell,
        "blade": blade}


def main(argv=None) -> int:
    return run_all(RUNS, argv, "a7k_long.json", __doc__.splitlines()[0])


if __name__ == "__main__":
    raise SystemExit(main())
