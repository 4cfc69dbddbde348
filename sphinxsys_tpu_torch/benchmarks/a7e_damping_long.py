"""The damping-family cases to their JAX tests' end times, each held to
that test's gates that need no external reference database:

    python -m sphinxsys_tpu_torch.benchmarks.a7e_damping_long
        [--cases collision,sliding,cantilever_neohookean,stretching,
                 muscle_solid_contact,twisting_bar,bar_statics,
                 slender_beam]
        [--device cuda] [--dtype case] [--out a7e_damping_long.json]

  * collision: collision_2d at its default dx = 0.025 to t = 10, the balls'
    centres every 0.25 (tests/test_collision.py): no overflow, both centres
    within 0.02 of 2 - t^2/2 before t = 1.6, the free ball's first rebound
    peak (2 < t < 4.5) in (1.1, 1.6), its centre moving by more than 0.3
    after t = 8 and never below 0.35, the damping ball's centre at the end
    within 2 dx of 0.4907;
  * sliding: sliding_2d at its default dx = 0.1, the slide at t = 0.5,
    1, ..., 2.5 within 0.5% of g sin(theta) t^2 / 2
    (tests/test_sliding.py; its ensemble gate reads the reference's own
    database and is left out);
  * cantilever_neohookean: passive_cantilever_neohookean_3d at its default
    dx = PH / 6, the corner observer's y every 0.02 to t = 1, its DTW
    distance to the JAX package's own CPU curve of the same dtype
    (tests/golden_torch/passive_cantilever_neohookean_3d/jax_curves.json)
    within DTW_FACTOR times the distance between JAX's float32 and
    float64 curves (printed beside it).  Its JAX test
    (tests/test_solid_cases_3d.py) reads the reference's database only;
  * stretching: stretching_2d at its default dx = PH / 15 to t = 10
    (tests/test_stretching.py): max kappa < 1e-3 at t = 1, max kappa >
    0.008 at t = 10, kappa at the notch in (0.014, 0.026) and within 15% of
    the quarter sections', the neck's median von Mises Kirchhoff stress /
    flow stress in (0.8, 1.1), the stretch within 5% of 2 PULL_RATE 10; the
    sub-steps and the host reads of each macro step printed;
  * muscle_solid_contact: muscle_solid_contact_3d at its default dx = L / 12
    to t = 0.1, the cube's kinetic energy every 100 steps, held by DTW to
    tests/golden_torch/muscle_solid_contact_3d/jax_curves.json as the
    cantilever is (tests/test_refdb_parity2.py's gate reads the
    reference's database and is left out); no overflow;
  * twisting_bar: twisting_rigid_elastic_bar_3d at res_factor 2, the
    interface corners' displacements every 0.2 until they change by less
    than 1e-2 over five outputs (at most t = 5), each within 12% of the
    FEBio reference (tests/test_refdb_parity2.py:145-165);
  * bar_statics: tests/test_bar.py's bar (L = 0.4, 21 particles): at rest
    it stays at rest (|v|, |omega| < 1e-6 after 20 steps), a bend driven
    kinematically gets a restoring tip force, and the clamped bar's first
    frequency lies within 8% of Euler-Bernoulli's;
  * slender_beam: slender_beam_3d to t = 0.8: the mid-span deflection
    within 10% of 1.8687, the supported ends within 0.05 of the axis.

--dtype case (the default) builds each case in its JAX default: float32,
float64 for muscle_solid_contact and twisting_bar (the DTW goldens are
read at the run's dtype).  Each run reports its step counts, its wall
time and each gate's value beside its bound, and writes them with the
samples to --out as JSON.  Exits 1 if a run raised, overflowed or failed
a gate (the other runs go on).
"""

from __future__ import annotations

import json
import math
import os
import time

import numpy as np
import torch

from sphinxsys_tpu_torch.benchmarks.a7bc_long import (_curve, _finite, _gate,
                                                      _record, run_all)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GOLDEN = os.path.join(ROOT, "tests", "golden_torch")
# a DTW distance to JAX's own curve passes within this many times the
# distance between JAX's float32 and float64 curves of the same case
DTW_FACTOR = 10.0


def _np(t):
    return t.detach().double().cpu().numpy()


def _kw(dtype, **kw):
    """Build keywords: the run's dtype where one was asked for."""
    return kw if dtype is None else dict(kw, dtype=dtype)


def _dtw_gate(name, values, dtype):
    """(distance to JAX's curve of the run's dtype, JAX's float32-float64
    distance, the gate) for a curve sampled as the golden's."""
    from sphinxsys_tpu_torch.io.regression import dtw_distance

    with open(os.path.join(GOLDEN, name, "jax_curves.json")) as f:
        ref = json.load(f)
    tag = "f64" if dtype == torch.float64 else "f32"
    spread = dtw_distance(np.asarray(ref["f32"]), np.asarray(ref["f64"]))
    dist = dtw_distance(np.asarray(values), np.asarray(ref[tag]))
    bound = DTW_FACTOR * spread
    return dist, spread, _gate(dist, dist <= bound,
                               f"<= {DTW_FACTOR:g} x {spread:.3e} (JAX's "
                               f"float32 against float64)")


def collision(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import collision_2d as co

    case, balls = co.build_case(**_kw(dtype, device=device))
    s = co.init_sim(case, balls)
    times = [i * 0.25 for i in range(1, 41)]
    s, rows, wall = _curve(
        co.make_run_chunk(case), s, times,
        lambda s: [float(s.time), float(co.ball_center(s.free_ball)[1]),
                   float(co.ball_center(s.damping_ball)[1])], progress=8)
    t, y1, y2 = map(np.asarray, zip(*rows))
    early = t < 1.6
    fall = 2.0 - 0.5 * t[early] ** 2
    dev = float(max(np.abs(y1[early] - fall).max(),
                    np.abs(y2[early] - fall).max()))
    peak = float(y1[(t > 2.0) & (t < 4.5)].max())
    late = y1[t > 8.0]
    swing = float(late.max() - late.min()) if len(late) else 0.0
    return _record("collision_2d", s, wall, dx=case.dx, gates=dict(
        free_fall=_gate(dev, dev < 0.02, "< 0.02 of 2 - t^2/2"),
        first_rebound=_gate(peak, 1.1 < peak < 1.6, "(1.1, 1.6)"),
        still_bouncing=_gate(swing, swing > 0.3, "> 0.3 after t = 8"),
        no_penetration=_gate(y1.min(), y1.min() > 0.35, "> 0.35"),
        damped_rest=_gate(y2[-1], abs(y2[-1] - 0.4907) < 2 * case.dx,
                          f"0.4907 +- {2 * case.dx:g}")),
        samples=rows)


def sliding(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import sliding_2d as sl

    case, cube = sl.build_case(**_kw(dtype, device=device))
    s = sl.init_sim(case, cube)
    start = _np(cube["Position"]).mean(axis=0)
    times = [0.5, 1.0, 1.5, 2.0, 2.5]
    s, rows, wall = _curve(sl.make_run_chunk(case), s, times,
                           lambda s: [float(s.time),
                                      sl.slide_distance(s, start)])
    gates = {}
    for t, d in rows:
        exact = 0.5 * sl.GRAVITY_G * math.sin(sl.THETA) * t * t
        gates[f"slide_t{t:.2f}"] = _gate(d, abs(d - exact) <= 5e-3 * exact,
                                         f"{exact:.5f} +- 0.5%")
    return _record("sliding_2d", s, wall, n_cube=case.n_cube, gates=gates,
                   samples=rows)


def cantilever_neohookean(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import passive_cantilever_neohookean_3d \
        as pn

    case, body = pn.build_case(**_kw(dtype, device=device))
    s = pn.init_sim(case, body)
    idx, w = pn.corner_observer(case, body)
    y0 = float(pn.observe_corner(s, idx, w)[1])
    s, ys, wall = _curve(pn.make_run_chunk(case), s,
                         [i * 0.02 for i in range(1, 51)],
                         lambda s: float(pn.observe_corner(s, idx, w)[1]),
                         progress=10)
    ys = [y0] + ys
    dist, spread, gate = _dtw_gate("passive_cantilever_neohookean_3d", ys,
                                   body["Position"].dtype)
    finite = _finite(s.body["Position"])
    return _record("passive_cantilever_neohookean_3d", s, wall, n=case.n,
                   dtw_to_jax=dist, jax_f32_f64_dtw=spread, gates=dict(
                       finite=_gate(finite, finite, "finite"),
                       dtw_to_jax=gate), samples=ys)


def _section_kappa(bar, x_centre, half_width):
    pos0 = _np(bar["InitialPosition"])
    kappa = _np(bar["HardeningParameter"])
    return kappa[np.abs(pos0[:, 0] - x_centre) < half_width]


def stretching(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import stretching_2d as st

    case, bar = st.build_case(**_kw(dtype, device=device))
    s = st.init_sim(case, bar)
    run = st.make_run_chunk(case)
    t0 = time.perf_counter()
    s = run(s, 1.0)
    k_early = float(s.bar["HardeningParameter"].max())
    sub_early = s.n_sub
    rows = []
    for t in range(2, 11):
        s = run(s, float(t))
        rows.append([float(s.time), s.n_macro, s.n_sub,
                     float(s.bar["HardeningParameter"].max())])
        print(f"  t={float(s.time):.2f} {rows[-1]} "
              f"wall={time.perf_counter() - t0:.1f} s", flush=True)
        if bool(s.overflow):
            break
    wall = time.perf_counter() - t0
    b = s.bar
    k_notch = float(_section_kappa(b, st.PL / 2, 2 * case.dx).mean())
    k_quarter = 0.5 * float(
        _section_kappa(b, st.PL / 4, 2 * case.dx).mean()
        + _section_kappa(b, 3 * st.PL / 4, 2 * case.dx).mean())
    vm = _np(st.von_mises_kirchhoff(case, b))
    pos0, x = _np(b["InitialPosition"]), _np(b["Position"])[:, 0]
    neck = np.abs(pos0[:, 0] - st.PL / 2) < 2 * case.dx
    flow = _np(case.material._flow_stress(b["HardeningParameter"]))
    ratio = float(np.median(vm[neck] / flow[neck]))
    stretch = (x.max() - x.min()) - (pos0[:, 0].max() - pos0[:, 0].min())
    exact = 2 * st.PULL_RATE * 10.0
    k_max = float(b["HardeningParameter"].max())
    finite = _finite(b["Position"])
    return _record(
        "stretching_2d", s, wall, n_bar=case.n_bar,
        sub_steps_per_macro=s.n_sub / max(s.n_macro, 1),
        host_reads_per_macro=(s.n_sub + s.n_macro) / max(s.n_macro, 1),
        sub_steps_to_t1=sub_early, gates=dict(
            finite=_gate(finite, finite, "finite"),
            elastic_t1=_gate(k_early, k_early < 1e-3, "< 1e-3"),
            plastic_t10=_gate(k_max, k_max > 0.008, "> 0.008"),
            notch=_gate(k_notch, 0.014 < k_notch < 0.026, "(0.014, 0.026)"),
            uniform=_gate(abs(k_notch - k_quarter),
                          abs(k_notch - k_quarter) < 0.15 * k_notch,
                          f"< {0.15 * k_notch:.5f}"),
            radial_return=_gate(ratio, 0.8 < ratio < 1.1, "(0.8, 1.1)"),
            stretch=_gate(stretch, abs(stretch - exact) <= 0.05 * exact,
                          f"{exact:.6f} +- 5%")),
        samples=rows)


def muscle_solid_contact(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import muscle_solid_contact_3d as mc

    case, s = mc.build_case(**_kw(dtype, device=device))
    step = mc.make_step(case)
    kes = [mc.kinetic_energy(s)]
    t0 = time.perf_counter()
    while float(s.time) < mc.END_TIME:
        for _ in range(100):
            s = step(s)
        kes.append(mc.kinetic_energy(s))
    wall = time.perf_counter() - t0
    dist, spread, gate = _dtw_gate("muscle_solid_contact_3d", kes,
                                   s.myo["Position"].dtype)
    finite = _finite(s.myo["Position"], s.plate["Position"])
    return _record("muscle_solid_contact_3d", s, wall, n_myo=case.n_myo,
                   n_plate=case.n_plate, dtw_to_jax=dist,
                   jax_f32_f64_dtw=spread, q=float(s.q), gates=dict(
                       finite=_gate(finite, finite, "finite"),
                       dtw_to_jax=gate), samples=kes)


def twisting_bar(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import twisting_rigid_elastic_bar_3d as tb

    case, s = tb.build_case(**_kw(dtype, device=device))
    run = tb.make_run_chunk(case)
    hist = []
    t0 = time.perf_counter()
    for i in range(1, 26):
        s = run(s, i * 0.2)
        hist.append(tb.observer_displacements(case, s))
        if len(hist) >= 6 and all(
                np.linalg.norm(hist[-k] - hist[-k - 1], axis=1).max() < 1e-2
                for k in range(1, 6)):
            break
    wall = time.perf_counter() - t0
    ref = np.asarray([tb.FEBIO_DISP[tuple(p)] for p in tb.OBSERVERS])
    err = np.linalg.norm(hist[-1] - ref, axis=1) / np.linalg.norm(ref,
                                                                  axis=1)
    return _record("twisting_rigid_elastic_bar_3d", s, wall, n_bar=case.n_bar,
                   gates=dict(febio=_gate(err.tolist(), (err < 0.12).all(),
                                          "< 0.12 each corner")),
                   samples=[h.tolist() for h in hist])


def _test_bar(dtype, device, L=0.4, n=21, thickness=0.03, width=0.03,
              E=2.0e6, rho=1000.0, nu=0.3):
    """tests/test_bar.py's clamped bar: (bar, pairs, material, h, dx)."""
    from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
    from sphinxsys_tpu_torch.core.materials import SaintVenantKirchhoffSolid
    from sphinxsys_tpu_torch.neighbors.cell_list import (build_cell_table,
                                                        grid_from_bounds)
    from sphinxsys_tpu_torch.neighbors.neighbor_list import \
        build_neighbor_list
    from sphinxsys_tpu_torch.physics import bar as bd
    from sphinxsys_tpu_torch.physics import solid as sd

    dx = L / (n - 1)
    pos = np.zeros((n, 3))
    pos[:, 0] = np.linspace(0.0, L, n)
    material = SaintVenantKirchhoffSolid(rho0=rho, youngs_modulus=E,
                                         poisson_ratio=nu)
    bar = bd.make_bar_state(pos, (0.0, 0.0, 1.0), (0.0, 1.0, 0.0), dx,
                            thickness, width, material, dtype, device)
    ad = SPHAdaptation(spacing=dx, dim=3)
    grid = grid_from_bounds((-4 * dx, -4 * dx, -4 * dx),
                            (L + 4 * dx, 4 * dx, 4 * dx), ad.cutoff)
    table = build_cell_table(bar["Position"], n, grid, 8)
    nl = build_neighbor_list(bar["Position"], n, bar["Position"], n, table,
                             grid, ad.cutoff, k_max=12, include_self=False)
    rp = sd.freeze_reference_pairs(bar["Position"], nl,
                                   bd.LineKernel(ad.kernel), 3)
    return bd.bar_correct_configuration(bar, rp), rp, material, ad.h, dx


def bar_statics(device, dtype) -> dict:
    """tests/test_bar.py's three checks of the bar's moment-force chain."""
    from sphinxsys_tpu_torch.physics import bar as bd

    dtype = dtype or torch.float32
    t0 = time.perf_counter()
    bar, rp, m, h, dx = _test_bar(dtype, device)
    dt = bd.bar_acoustic_time_step(bar, m, h)
    s = bar
    for _ in range(20):
        s = bd.bar_stress_relaxation_1st_half(s, rp, m, dt, h)
        s = bd.bar_stress_relaxation_2nd_half(s, rp, dt)
    v_rest = max(float(s["Velocity"].abs().max()),
                 float(s["AngularVelocity"].abs().max()))

    x = bar["Position"][:, 0]
    L = float(x.max())
    clamp = x < 1.5 * dx
    z = torch.zeros_like(x)
    v_imposed = torch.stack([z, z, 0.05 * (x / L) ** 2], -1)
    s = dict(bar)
    dt = bd.bar_acoustic_time_step(s, m, h) * 0.5
    for _ in range(30):
        s["Velocity"] = v_imposed
        s = bd.bar_stress_relaxation_1st_half(s, rp, m, dt, h)
        s = bd.constrain_bar_region(s, clamp)
        s = bd.bar_stress_relaxation_2nd_half(s, rp, dt)
    tip_fz, tip_z = float(s["Force"][-1, 2]), float(s["Position"][-1, 2])

    I_, A = 0.03 * 0.03 ** 3 / 12.0, 0.03 * 0.03
    f1 = (1.875 ** 2 / (2 * math.pi * L ** 2)) * math.sqrt(
        m.youngs_modulus * I_ / (m.rho0 * A))
    s = dict(bar)
    s["Velocity"] = torch.stack([z, z, 0.01 * (x / L) ** 2], -1)
    dt0 = bd.bar_acoustic_time_step(s, m, h) * 0.8
    n_steps = int(1.6 / f1 / float(dt0)) + 1
    s = bd.bar_stress_relaxation_1st_half(s, rp, m, 0.0, h)
    s = bd.bar_stress_relaxation_2nd_half(s, rp, 0.0)
    tips = []
    for _ in range(n_steps):
        s = bd.bar_stress_relaxation_1st_half(s, rp, m, dt0, h)
        s = bd.constrain_bar_region(s, clamp)
        s = bd.bar_stress_relaxation_2nd_half(s, rp, dt0)
        tips.append(s["Position"][-1, 2])
    tips = _np(torch.stack(tips))
    times = float(dt0) * (1.0 + np.arange(n_steps))
    i_max = int(np.argmax(tips))
    i_min = int(np.argmin(tips[i_max:])) + i_max
    f_meas = 1.0 / (2.0 * (times[i_min] - times[i_max]))
    wall = time.perf_counter() - t0
    finite = bool(np.isfinite(tips).all())
    return dict(case="bar_statics", wall_s=wall, n_steps=n_steps,
                f1_beam_theory=f1, gates=dict(
                    at_rest=_gate(v_rest, v_rest < 1e-6, "< 1e-6"),
                    bend=_gate(tip_z, tip_z > 0.0, "> 0"),
                    restoring=_gate(tip_fz, tip_fz < 0.0, "< 0"),
                    finite=_gate(finite, finite, "finite"),
                    frequency=_gate(f_meas, abs(f_meas - f1) / f1 < 0.08,
                                    f"{f1:.4f} +- 8%"),
                    amplitude=_gate(np.abs(tips).max(),
                                    np.abs(tips).max() < 0.05 * L,
                                    f"< {0.05 * L:g}")))


def slender_beam(device, dtype) -> dict:
    from sphinxsys_tpu_torch.cases import slender_beam_3d as sb

    case, s = sb.build_case(**_kw(dtype, device=device))
    s, ds, wall = _curve(sb.make_run_chunk(case), s,
                         [i * 0.1 for i in range(1, 9)],
                         lambda s: sb.midspan_displacement(case, s))
    d = ds[-1]
    ends = float(np.abs(_np(s.bar["Position"][:, 2])
                        [case.end_mask.cpu().numpy()]).max())
    ref = sb.DISPL_MAX_REFERENCE
    return _record("slender_beam_3d", s, wall, n_bar=case.n_bar, gates=dict(
        deflection=_gate(d, abs(d - ref) < 0.1 * ref, f"{ref} +- 10%"),
        supports=_gate(ends, ends < 0.05, "< 0.05")), samples=ds)


RUNS = {"collision": collision, "sliding": sliding,
        "cantilever_neohookean": cantilever_neohookean,
        "stretching": stretching,
        "muscle_solid_contact": muscle_solid_contact,
        "twisting_bar": twisting_bar, "bar_statics": bar_statics,
        "slender_beam": slender_beam}


def main(argv=None) -> int:
    return run_all(RUNS, argv, "a7e_damping_long.json",
                   __doc__.splitlines()[0], default_dtype="case")


if __name__ == "__main__":
    raise SystemExit(main())
