"""Parity of the port's three multi-resolution cases with the JAX
package's on the CPU, float64, at reduced widths over a few advection
steps: taylor_green_mr_2d at dx = 0.05 (the periodic multi-level list
rebuilt every step) here; mr_cantilever_beam_2d in
tests/test_torch_mr_beam.py and mr_cylinder_2d in
tests/test_torch_mr_cylinder.py, both with this file's helpers.

The builds equal JAX's (lists exactly, fields within 1e-12); the runs
keep equal step counts and overflow flags and every field within 1e-9 of
its max |JAX|.  Then the CLI entries on the CPU.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_corrected_cases import cli_runs
from test_torch_viscosity import close

from sphinxsys_tpu.cases import mr_cantilever_beam_2d as jmb
from sphinxsys_tpu.cases import taylor_green_mr_2d as jtg
from sphinxsys_tpu_torch.cases import taylor_green_mr_2d as ttg

torch.set_num_threads(1)

RUN_TOL = 1e-9
F64 = dict(dtype=torch.float64, device="cpu")


def same_list(tl, jl, what):
    np.testing.assert_array_equal(tl.idx.numpy(), np.asarray(jl.idx),
                                  err_msg=what)
    np.testing.assert_array_equal(tl.count.numpy(), np.asarray(jl.count),
                                  err_msg=what)
    assert bool(tl.overflow) == bool(jl.overflow), what


def same_state(ts, js, tol, what, keys=None):
    for k in keys or js:
        if k == "NReal":
            assert int(ts[k]) == int(js[k]), (what, k)
        elif np.asarray(js[k]).dtype.kind in "biu":
            np.testing.assert_array_equal(np.asarray(ts[k]),
                                          np.asarray(js[k]),
                                          err_msg=f"{what} {k}")
        else:
            close(ts[k], js[k], tol, (what, k))


# --------------------------------------------------------------------------
# Taylor-Green MR
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def tg_runs():
    jc, jf = jtg.build_case(dx=0.05, dtype=jnp.float64)
    tc, tf = ttg.build_case(dx=0.05, **F64)
    js0, ts0 = jtg.init_sim(jc, jf), ttg.init_sim(tc, tf)
    js = jtg.make_run_chunk(jc)(js0, jnp.asarray(0.02, jnp.float64))
    ts = ttg.make_run_chunk(tc)(ts0, 0.02)
    return jc, tc, jf, tf, js0, ts0, js, ts


def test_tg_build_matches_jax():
    jc, tc, jf, tf, js0, ts0, *_ = tg_runs()
    assert tc.n_fluid == jc.n_fluid
    assert set(tf) == set(jf)
    same_state(tf, jf, 1e-12, "build")
    same_list(ts0.nl_inner, js0.nl_inner, "init list")
    close(ts0.fluid["Position"], js0.fluid["Position"], 1e-15, "wrapped")


def test_tg_run_matches_jax():
    *_, js, ts = tg_runs()
    assert (ts.n_adv, ts.n_ac) == (int(js.n_adv), int(js.n_ac))
    assert ts.n_adv >= 3
    assert bool(ts.overflow) == bool(js.overflow) is False
    assert float(ts.time) == pytest.approx(float(js.time), rel=1e-12)
    same_state(ts.fluid, js.fluid, RUN_TOL, "run")
    same_list(ts.nl_inner, js.nl_inner, "list")
    assert ttg.max_speed(ts) == pytest.approx(jtg.max_speed(js), rel=1e-9)


@pytest.mark.parametrize("case,sets,bodies,n", (
    ("taylor_green_mr_2d", ("dx=0.1", "t_end=0.01"), ("WaterBody",), None),
    ("mr_cantilever_beam_2d", ("dx=0.005", "t_end=2e-4"), ("BeamBody",),
     None),
))
def test_mr_cli_entries_run_on_the_cpu(case, sets, bodies, n, tmp_path,
                                       caplog):
    import importlib

    mod = importlib.import_module(f"sphinxsys_tpu_torch.cases.{case}")
    kw = dict(kv.split("=") for kv in sets if not kv.startswith("t_end"))
    kw = {k: (False if v == "False" else float(v)) for k, v in kw.items()}
    built = mod.build_case(**kw, **F64)
    case_obj, state = built
    n_real = {}
    for b in bodies:
        if case == "mr_cantilever_beam_2d":
            n_real[b] = int(state.solid["NReal"])
        else:
            n_real[b] = int(state["NReal"])
    cli_runs(case, sets, bodies, tmp_path, caplog, n_real)


def write_jax_f32(names=None):
    """The JAX package's float32 CPU readings of every run of
    sphinxsys_tpu_torch/benchmarks/a7j_fvm_mr_long.py (its protocols and
    reading functions) -> tests/golden_torch/a7j/jax_f32.json (~20 min,
    most of it the MR cylinder to t = 30).  The file is rewritten run by
    run, keeping the runs not named."""
    import json
    import math
    import os
    import time

    import jax

    from sphinxsys_tpu_torch.benchmarks import a7j_fvm_mr_long as L
    from sphinxsys_tpu_torch.io.regression import DTWRegressionTest

    jax.config.update("jax_enable_x64", False)
    f32 = jnp.float32

    def to(run, s, t):
        return run(s, jnp.asarray(t, s.time.dtype))

    def fvm_drag():
        from sphinxsys_tpu.cases import fvm_cylinder_2d as fc
        case, fluid = fc.build_case(nr=L.FVM_DRAG["nr"], nt=L.FVM_DRAG["nt"],
                                    r_far=L.FVM_DRAG["r_far"])
        s = to(fc.make_run_chunk(case), fc.init_sim(case, fluid),
               L.FVM_DRAG["t_end"])
        return L.fvm_drag_readings(case.mesh.centroids,
                                   np.asarray(s.fluid["Velocity"], float),
                                   np.asarray(s.fluid["Density"], float),
                                   fc.drag_coefficient(case, s))

    def fvm_golden():
        from sphinxsys_tpu.cases import fvm_cylinder_2d as fc
        case, fluid = fc.build_case()
        s, run, fx = fc.init_sim(case, fluid), fc.make_run_chunk(case), []
        for t in L.FVM_GOLDEN_TIMES:
            s = to(run, s, t)
            fx.append(float(fc.cylinder_force(case, s)[0]))
        test = DTWRegressionTest(os.path.join(L.GOLDEN, "fvm_cylinder_2d"),
                                 "WaterBody", "ForceOnCylinderX")
        ok, _ = test.test(np.asarray(fx))
        return dict(distance=[float(d) for d in np.ravel(
            test.distances(np.asarray(fx)))], fx_end=fx[-1], ok=bool(ok),
            n_steps=int(s.n_steps))

    def bow_shock():
        from sphinxsys_tpu.cases import supersonic_cylinder_2d as sc
        case, fluid = sc.build_case(nr=L.BOW["nr"], nt=L.BOW["nt"])
        s = to(sc.make_run_chunk(case), sc.init_sim(case, fluid),
               L.BOW["t_end"])
        return L.bow_readings(case.mesh.centroids,
                              np.asarray(s.fluid["Density"], float),
                              np.asarray(s.fluid["Pressure"], float),
                              *sc.stagnation_state(case, s))

    def sod():
        from sphinxsys_tpu.core.materials import CompressibleFluid
        from sphinxsys_tpu.fvm import dynamics as fv
        from sphinxsys_tpu.fvm.mesh import compile_mesh
        from sphinxsys_tpu.fvm.meshgen import rect_grid
        mesh = compile_mesh(rect_grid(L.SOD["nx"], L.SOD["ny"], L.SOD["lx"],
                                      L.SOD["ly"]))
        dm = fv.to_device(mesh)
        gas = CompressibleFluid(gamma=1.4)
        x = mesh.centroids[:, 0]
        far = fv.FarField(rho=1.0, vel=(0.0, 0.0), p=1.0)
        rhos = []
        for step_fn in (fv.compressible_step, fv.compressible_step_muscl):
            st = {"Density": jnp.asarray(np.where(x < 0.5, 1.0, 0.125), f32),
                  "Velocity": jnp.zeros((dm.n_cells, 2), f32),
                  "Pressure": jnp.asarray(np.where(x < 0.5, 1.0, 0.1), f32)}
            st["TotalEnergyDensity"] = st["Pressure"] / (gas.gamma - 1.0)

            @jax.jit
            def adv(st, step_fn=step_fn):
                def body(c):
                    s_, tt = c
                    dt = fv.compressible_time_step_fvm(s_, gas, dm, cfl=0.3)
                    return (step_fn(s_, dm, gas, far, dt), tt + dt)
                return jax.lax.while_loop(
                    lambda c: c[1] < L.SOD["t_end"], body,
                    (st, jnp.zeros((), f32)))[0]

            rhos.append(np.asarray(adv(st)["Density"], float))
        return L.sod_readings(x, rhos[0], rhos[1], L.SOD["t_end"])

    def dmr():
        from sphinxsys_tpu.cases import double_mach_reflection_2d as dm_
        case, fluid = dm_.build_case(nx=L.DMR["nx"], ny=L.DMR["ny"])
        s = to(dm_.make_run_chunk(case), dm_.init_sim(case, fluid),
               L.DMR["t_end"])
        x_s_top = dm_.X0 + L.DMR["t_end"] * dm_.SHOCK_SPEED_X \
            + dm_.DH / dm_.TAN60
        return L.dmr_readings(case.mesh.centroids,
                              np.asarray(s.fluid["Density"], float),
                              dm_.wall_shock_position(case, s), x_s_top)

    def tg_mr():
        case, fluid = jtg.build_case()
        s = jtg.init_sim(case, fluid)
        run, v0, ratios = jtg.make_run_chunk(case), jtg.max_speed(s), []
        for t in L.TG_MR_TIMES:
            s = to(run, s, t)
            ratios.append(jtg.max_speed(s) / (v0 * math.exp(
                -8 * math.pi ** 2 * jtg.MU_F * float(s.time))))
        return dict(ratios=ratios, overflow=bool(s.overflow))

    def mr_beam():
        case, s = jmb.build_case()
        run, tips = jmb.make_run_chunk(case), []
        for t in L.MR_BEAM_TIMES:
            s = to(run, s, t)
            tips.append((float(s.time), jmb.tip_displacement(case, s)))
        return L.mr_beam_readings([t for t, _ in tips],
                                  [y for _, y in tips])

    def mr_tank():
        return _jax_tank(L)

    def mr_cylinder():
        from sphinxsys_tpu.cases import mr_cylinder_2d as mc
        case, fluid = mc.build_case()
        s = mc.init_sim(case, fluid)
        run = mc.make_run_chunk(case)
        s = to(run, s, L.MR_CYL_START_T)
        al = np.asarray(s.fluid["Alive"])
        fv, _ = mc.cylinder_forces(case, s)
        start = L.mr_cyl_start_readings(
            np.asarray(s.fluid["Position"], float)[al],
            np.asarray(s.fluid["Velocity"], float)[al],
            np.asarray(s.fluid["SmoothingLengthRatio"], float)[al],
            np.asarray(fv, float), mc.CX, mc.CY)
        samples = []
        for t in L.MR_CYL_TIMES:
            if t <= L.MR_CYL_START_T:
                continue
            s = to(run, s, t)
            fv, _ = mc.cylinder_forces(case, s)
            samples.append((float(s.time), float(fv[0]), float(fv[1])))
        return dict(start=start,
                    drag=L.mr_cyl_drag_readings(*zip(*samples)),
                    overflow=bool(s.overflow))

    def fvm_golden_perturbed():
        """The same run from a start velocity scaled by 1 + eps: the
        DTW distances of JAX's own float32 curve (the shedding is
        chaotic)."""
        from sphinxsys_tpu.cases import fvm_cylinder_2d as fc
        out = {}
        for eps in (1e-7, 1e-6):
            case, fluid = fc.build_case()
            fluid = dict(fluid, Velocity=fluid["Velocity"] * (1.0 + eps))
            s, run, fx = fc.init_sim(case, fluid), fc.make_run_chunk(case), []
            for t in L.FVM_GOLDEN_TIMES:
                s = to(run, s, t)
                fx.append(float(fc.cylinder_force(case, s)[0]))
            test = DTWRegressionTest(
                os.path.join(L.GOLDEN, "fvm_cylinder_2d"), "WaterBody",
                "ForceOnCylinderX")
            out[f"{eps:g}"] = [float(d) for d in np.ravel(
                test.distances(np.asarray(fx)))]
        return out

    runs = dict(fvm_drag=fvm_drag, fvm_golden=fvm_golden,
                fvm_golden_perturbed=fvm_golden_perturbed,
                bow_shock=bow_shock, sod=sod, dmr=dmr, tg_mr=tg_mr,
                mr_beam=mr_beam, mr_tank=mr_tank, mr_cylinder=mr_cylinder)
    out = {}
    if os.path.exists(L.JAX_F32):
        with open(L.JAX_F32) as f:
            out = json.load(f)
    os.makedirs(os.path.dirname(L.JAX_F32), exist_ok=True)
    for name in names or runs:
        t0 = time.time()
        out[name] = runs[name]()
        print(name, out[name], f"{time.time() - t0:.1f} s", flush=True)
        with open(L.JAX_F32, "w") as f:
            json.dump(out, f, indent=1)


def _jax_tank(L):
    """tests/test_fluid_adaptive_wall.py's tank, float32, its readings."""
    import jax

    from sphinxsys_tpu.core.adaptation import SPHAdaptation
    from sphinxsys_tpu.core.materials import WeaklyCompressibleFluid
    from sphinxsys_tpu.core.state import make_fluid_state, make_solid_state
    from sphinxsys_tpu.neighbors.multilevel import (
        build_adaptive_neighbor_list, build_multilevel_tables)
    from sphinxsys_tpu.physics import fluid as fd
    from sphinxsys_tpu.physics import fluid_adaptive as fa
    from sphinxsys_tpu.physics import riemann as rs

    T = L.TANK
    Lx, H, dx, g = T["L"], T["H"], T["dx"], T["g"]
    y_fine, ramp0 = T["y_fine"], T["ramp0"]
    rho0, c0 = 1000.0, 10.0 * (g * H) ** 0.5
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    xs_c = np.arange(dx / 2, Lx, dx)
    ys_c = np.arange(y_fine + dx / 2, H, dx)
    pos_c = np.stack(np.meshgrid(xs_c, ys_c, indexing="ij"), -1).reshape(-1, 2)
    xs_f = np.arange(dx / 4, Lx, dx / 2)
    ys_f = np.arange(dx / 4, y_fine, dx / 2)
    pos_f = np.stack(np.meshgrid(xs_f, ys_f, indexing="ij"), -1).reshape(-1, 2)
    pos = np.concatenate([pos_c, pos_f])
    vols = np.concatenate([np.full(len(pos_c), dx * dx),
                           np.full(len(pos_f), (dx / 2) ** 2)])
    hr = np.concatenate([
        np.ones(len(pos_c)),
        1.0 + np.clip((y_fine - pos_f[:, 1]) / (y_fine - ramp0), 0.0, 1.0)])
    fluid = dict(make_fluid_state(pos, vols, rho0))
    fluid["VolumetricMeasure"] = jnp.asarray(vols, jnp.float32)
    fluid["Mass"] = jnp.asarray(rho0 * vols, jnp.float32)
    fluid["SmoothingLengthRatio"] = jnp.asarray(hr, jnp.float32)
    eos = WeaklyCompressibleFluid(rho0=rho0, c0=c0)
    p_hydro = rho0 * g * (H - pos[:, 1])
    fluid["Pressure"] = jnp.asarray(p_hydro, jnp.float32)
    fluid["Density"] = jnp.asarray(
        np.asarray(eos.density_from_pressure(jnp.asarray(p_hydro))),
        jnp.float32)
    gvec = jnp.zeros_like(fluid["Velocity"]).at[:, 1].set(-g)
    fluid["ForcePrior"] = gvec * fluid["Mass"][:, None]
    fluid["ViscousForce"] = jnp.zeros_like(fluid["Velocity"])
    fluid["ViscousForcePrev"] = jnp.zeros_like(fluid["Velocity"])
    dxw = dx / 2
    wx = np.arange(dxw / 2, Lx, dxw)
    wy = np.arange(dxw / 2, 4 * dx, dxw)
    wpos = np.stack(np.meshgrid(wx, -wy, indexing="ij"), -1).reshape(-1, 2)
    wall = dict(make_solid_state(wpos, dxw * dxw, rho0))
    wall["NormalDirection"] = jnp.asarray(
        np.tile([0.0, 1.0], (len(wpos), 1)), jnp.float32)
    wall["SmoothingLengthRatio"] = jnp.full((len(wpos),), 2.0, jnp.float32)
    h_ref = adaptation.h
    lo, hi = (0.0, -4.5 * dx), (Lx, H + 2 * dx)
    ml_wall = build_multilevel_tables(wall["Position"], jnp.int32(len(wpos)),
                                      wall["SmoothingLengthRatio"], lo, hi,
                                      h_ref, n_levels=2, cap=48,
                                      periodic=(True, False))
    box = (Lx, 0.0)
    riem = rs.acoustic_riemann(eos)
    kernel = adaptation.kernel
    n = len(pos)

    @jax.jit
    def advect(f):
        ml = build_multilevel_tables(f["Position"], jnp.int32(n),
                                     f["SmoothingLengthRatio"], lo, hi,
                                     h_ref, n_levels=2, cap=48,
                                     periodic=(True, False))
        nl = build_adaptive_neighbor_list(
            f["Position"], jnp.int32(n), f["SmoothingLengthRatio"],
            f["Position"], f["SmoothingLengthRatio"], ml, 2.0, h_ref,
            k_max_per_level=[96, 128], box=box)
        nlw = build_adaptive_neighbor_list(
            f["Position"], jnp.int32(n), f["SmoothingLengthRatio"],
            wall["Position"], wall["SmoothingLengthRatio"], ml_wall, 2.0,
            h_ref, k_max_per_level=[48, 64], include_self=True, box=box)
        h_fine = h_ref / 2.0
        dt_adv = fd.advection_time_step(f, h_fine, (g * H) ** 0.5)
        f = fa.density_summation_adaptive(f, nl, kernel, 2, rho0, box=box,
                                          wall=wall, nl_wall=nlw,
                                          free_surface=True)

        def body(c):
            ff, rt = c
            dt = jnp.minimum(fd.acoustic_time_step(ff, eos, h_fine), dt_adv)
            ff = fa.acoustic_step_1st_half_adaptive(
                ff, nl, kernel, 2, eos, riem, dt, box=box, wall=wall,
                nl_wall=nlw)
            ff = fa.acoustic_step_2nd_half_adaptive(
                ff, nl, kernel, 2, riem, dt, box=box, wall=wall, nl_wall=nlw)
            return (ff, rt + dt)

        f, _ = jax.lax.while_loop(lambda c: c[1] < dt_adv, body,
                                  (f, jnp.zeros((), jnp.float32)))
        return f, nl.overflow | nlw.overflow

    f, ovf = fluid, False
    for _ in range(L.MR_TANK_STEPS):
        f, o = advect(f)
        ovf |= bool(o)
    r = L.mr_tank_readings(np.asarray(f["Velocity"], float),
                           np.asarray(f["Pressure"], float),
                           np.asarray(f["Position"], float)[:, 1], rho0, g, H)
    return dict(r, overflow=ovf)


if __name__ == "__main__":
    import sys

    if sys.argv[1:2] == ["jax_f32"]:
        write_jax_f32(sys.argv[2].split(",") if len(sys.argv) > 2 else None)
