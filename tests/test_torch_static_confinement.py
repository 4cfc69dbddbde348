"""Parity of the port's level-set confinement (physics/fluid.py's
`levelsets=` terms, relax.surface_bounding on a LevelSetShape) and of
cases/static_confinement_2d.py with the JAX package on the CPU, in
float64, at dx = 0.1 (200 water particles).

* the case's two level sets (the tank, the inverse triangle) and their
  kernel integrals: tables exact, fields within 1e-12;
* density_summation, acoustic_step_1st_half and acoustic_step_2nd_half
  with both level sets (JAX's fields carried across by
  convert.levelset_from_jax) and surface_bounding against each, within
  1e-12 of max |JAX|, on the state after three advection steps with its
  velocities perturbed toward the walls from a numpy seed;
* the case over 16 advection steps (80 acoustic sub-steps, a Morton
  resort every 5) within 1e-9 with JAX's step counts; the CLI on the CPU.

The reference's own regression database of this case is not in the
repository; the long run's energy curve is held to the committed
tests/golden/refdb curve by sphinxsys_tpu_torch/benchmarks/
a7k_levelset_turbulence_long.py on the card.
"""

import dataclasses
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from sphinxsys_tpu.cases import static_confinement_2d as jcase
from sphinxsys_tpu.physics import fluid as jfd
from sphinxsys_tpu.physics import relax as jr
from sphinxsys_tpu_torch import convert
from sphinxsys_tpu_torch import run as trun
from sphinxsys_tpu_torch.cases import static_confinement_2d as tcase
from sphinxsys_tpu_torch.meshes.levelset import LevelSetShape as TShape
from sphinxsys_tpu_torch.physics import fluid as tfd
from sphinxsys_tpu_torch.physics import relax as tr

torch.set_num_threads(1)

DX = 0.1
F64 = dict(dtype=torch.float64, device="cpu")


def close(got, ref, tol=1e-12, what=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max(initial=0.0)
    assert err <= tol * max(np.abs(ref).max(initial=0.0), 1e-300), (what,
                                                                      err)


@functools.lru_cache(maxsize=None)
def cases():
    jc, jf = jcase.build_case(dx=DX, dtype=jnp.float64)
    tc, tf = tcase.build_case(dx=DX, **F64)
    return (jc, jf), (tc, tf)


@functools.lru_cache(maxsize=None)
def scene():
    """JAX's state after three advection steps, its velocities perturbed
    toward the walls and the ramp, and its list; the port's copies, with
    JAX's level sets."""
    (jc, jf), (tc, _) = cases()
    js = jcase.make_run_chunk(jc)(jcase.init_sim(jc, jf), jnp.asarray(0.05))
    f = {k: np.array(v) for k, v in js.fluid.items()}
    n = f["Position"].shape[0]
    rng = np.random.default_rng(2)
    f["Velocity"] += rng.normal(size=(n, 2)) * [0.5, 0.3]
    f["Velocity"][:, 1] -= 0.3
    f["Pressure"] = rng.normal(size=n)
    jfl = {k: jnp.asarray(v) for k, v in f.items()}
    tls = tuple(TShape(convert.levelset_from_jax(s.levelset), name=s.name)
                for s in jc.levelsets)
    return (jc, jfl, js.nl_inner), \
        (tc, convert.state_from_numpy(f),
         convert.neighbor_list_from_numpy(js.nl_inner), tls)


def test_level_sets_match_jax():
    (jc, _), (tc, tf) = cases()
    assert tc.n_fluid == jc.n_fluid == 200
    for js, ts in zip(jc.levelsets, tc.levelsets):
        assert ts.name == js.name
        for k in ("coarse_map", "pkg_coord", "pkg_nbr"):
            np.testing.assert_array_equal(
                getattr(ts.levelset, k).numpy(),
                np.asarray(getattr(js.levelset, k)))
        for k in ("phi", "kernel_w", "kernel_gw", "kernel_g2w"):
            close(getattr(ts.levelset, k), getattr(js.levelset, k), what=k)


def test_confinement_terms_match_jax():
    """The three fluid terms and the surface bounding, with and without
    the level sets (the terms change the answer)."""
    (jc, jf, jnl), (tc, tf, tnl, tls) = scene()
    k, sig = jc.kernel, jc.adaptation.sigma0
    dt = 2.0e-3

    def jax_all(f, levelsets):
        d = jfd.density_summation(f, jnl, k, 2, 1.0, sig, free_surface=True,
                                  levelsets=levelsets)
        a = jfd.acoustic_step_1st_half(f, jnl, k, 2, jc.eos, jc.riemann, dt,
                                       levelsets=levelsets)
        b = jfd.acoustic_step_2nd_half(f, jnl, k, 2, jc.riemann, dt,
                                       levelsets=levelsets)
        p = f["Position"]
        bounded = [jr.surface_bounding(p, s, jc.dx) for s in levelsets]
        return d, a, b, bounded

    for with_ls in (True, False):
        jls = jc.levelsets if with_ls else ()
        rd, ra, rb, rbnd = jax.jit(lambda f: jax_all(f, jls))(jf)
        ls = tls if with_ls else ()
        tk = tc.kernel
        gd = tfd.density_summation(tf, tnl, tk, 2, 1.0, sig,
                                   free_surface=True, levelsets=ls)
        ga = tfd.acoustic_step_1st_half(tf, tnl, tk, 2, tc.eos, tc.riemann,
                                        dt, levelsets=ls)
        gb = tfd.acoustic_step_2nd_half(tf, tnl, tk, 2, tc.riemann, dt,
                                        levelsets=ls)
        for got, ref, keys in ((gd, rd, ("DensitySummation", "Density")),
                               (ga, ra, ("Force", "DensityChangeRate",
                                         "Velocity")),
                               (gb, rb, ("DensityChangeRate", "Density"))):
            for key in keys:
                close(got[key], ref[key], what=(with_ls, key))
        for s, ref in zip(ls, rbnd):
            close(tr.surface_bounding(tf["Position"], s, tc.dx), ref,
                  what="bounding")
        if with_ls:
            plain = tfd.acoustic_step_1st_half(tf, tnl, tk, 2, tc.eos,
                                               tc.riemann, dt)
            assert float((plain["Force"] - ga["Force"]).abs().max()) > 1e-6


def test_case_matches_jax():
    """16 advection steps with a Morton resort every 5: JAX's counts, the
    state within 1e-9 of max |JAX|, the energy."""
    (jc, jf), (tc, tf) = cases()
    jc, tc = (dataclasses.replace(c, sort_every=5) for c in (jc, tc))
    js = jcase.make_run_chunk(jc)(jcase.init_sim(jc, jf), jnp.asarray(0.3))
    ts = tcase.make_run_chunk(tc)(tcase.init_sim(tc, tf), 0.3)
    assert (ts.n_adv, ts.n_ac) == (int(js.n_adv), int(js.n_ac)) == (16, 80)
    assert not bool(ts.overflow)
    close(ts.time, js.time, 1e-12, "time")
    for k in ("Position", "Velocity", "Density", "Pressure", "Force"):
        close(ts.fluid[k], js.fluid[k], 1e-9, k)
    close(tcase.mechanical_energy(tc, ts), jcase.mechanical_energy(jc, js),
          1e-9, "energy")


def test_cli_runs_on_the_cpu(tmp_path):
    out = tmp_path / "out"
    assert trun.main(["static_confinement_2d", "--set", f"dx={DX}", "--set",
                      "t_end=0.1", "--set", "n_output=2", "--set",
                      "device=cpu", "--output_dir", str(out)]) == 0
    assert sorted(p.name for p in out.iterdir()) == [
        "WaterBody_000001.vtp", "WaterBody_000002.vtp"]


def _jax_confinement(L, eps=0.0):
    """JAX's confinement run to L.CONF_T_END, its positions scaled by
    1 + eps at the start; the long script's readings."""
    case, fluid = jcase.build_case()
    fluid = dict(fluid, Position=fluid["Position"] * (1.0 + eps))
    s = jcase.init_sim(case, fluid)
    step = jax.jit(lambda st: jcase._advection_step(case, st))
    tri = jcase.triangle_shape()
    e0 = jcase.mechanical_energy(case, s)
    series, at_times, gates = [e0], [], list(L.CONF_GATE_TIMES)
    while float(s.time) < L.CONF_T_END:
        s = step(s)
        t, n = float(s.time), int(s.n_adv)
        if gates and t >= gates[0]:
            pos = np.asarray(s.fluid["Position"], np.float64)
            at_times.append(L.confinement_gate_reading(
                gates.pop(0), jcase.mechanical_energy(case, s), pos,
                np.asarray(tri.signed_distance(s.fluid["Position"])),
                case.dx))
        if n % L.CONF_EVERY == 0 or t >= L.CONF_T_END:
            series.append(jcase.mechanical_energy(case, s))
    r = L.confinement_readings(e0, at_times, series)
    return dict(r, n_adv=int(s.n_adv), n_ac=int(s.n_ac),
                gates={k: v["ok"] for k, v in L.confinement_gates(
                    r, case.dx, jcase.DL).items()})


def _jax_channel(L, eps=0.0):
    """JAX's channel to the last of L.CHANNEL_TIMES, its start velocity
    scaled by 1 + eps; the long script's readings."""
    from sphinxsys_tpu.cases import turbulent_channel_2d as jtc

    case, fluid = jtc.build_case()
    fluid = dict(fluid, Velocity=fluid["Velocity"] * (1.0 + eps))
    s = jtc.init_sim(case, fluid)
    run = jtc.make_run_chunk(case)
    mu_t = []
    for t in L.CHANNEL_TIMES:
        s = run(s, jnp.asarray(t, s.time.dtype))
        pos = np.asarray(s.fluid["Position"])
        j = int(np.argmin(np.linalg.norm(
            pos - np.asarray([case.length / 2, jtc.DH / 2]), axis=1)))
        mu_t.append(float(s.fluid["TurbulentViscosity"][j]))
    return dict(L.channel_readings(mu_t), n_adv=int(s.n_adv),
                n_ac=int(s.n_ac), samples=mu_t)


def jax_f32_readings() -> dict:
    """The JAX package's float32 CPU runs of
    sphinxsys_tpu_torch/benchmarks/a7k_levelset_turbulence_long.py's four
    protocols, read with its own reading functions; the confinement and
    the channel also from a start scaled by 1 + 1e-7 (JAX's own float32
    spread of the DTW distances)."""
    import time

    from sphinxsys_tpu.cases import shell_relaxation_2d as jsr
    from sphinxsys_tpu.core.adaptation import SPHAdaptation
    from sphinxsys_tpu.core.generators import generate_lattice
    from sphinxsys_tpu.core.geometry import Polygon
    from sphinxsys_tpu.meshes.levelset import build_levelset
    from sphinxsys_tpu.neighbors.cell_list import CellGrid
    from sphinxsys_tpu_torch.benchmarks import \
        a7k_levelset_turbulence_long as L
    from sphinxsys_tpu_torch.cases import implicit_relaxation_2d as tir

    out = {}
    t0 = time.time()
    for name, run in (("confinement", _jax_confinement),
                      ("channel", _jax_channel)):
        out[name] = run(L)
        out[f"{name}_perturbed"] = run(L, 1e-7)
        print(name, time.time() - t0, out[name], out[f"{name}_perturbed"],
              flush=True)

    pos, normals, updated = jsr.run_case(n_iterations=L.SHELL_ITERATIONS)
    out["shell"] = L.shell_readings(np.asarray(pos, np.float64),
                                    np.asarray(normals, np.float64),
                                    np.asarray(updated), jsr.R_MID)
    print("shell", time.time() - t0, out["shell"], flush=True)

    blade = Polygon(vertices=tir.naca0012(L.BLADE["chord"]).vertices)
    lo, hi = blade.bounds()
    dom_lo, dom_hi = np.asarray(lo) - 4 * tir.DX, np.asarray(hi) + 4 * tir.DX
    pos0, vol = generate_lattice(blade, dom_lo, dom_hi, tir.DX)
    ad = SPHAdaptation(spacing=tir.DX, dim=2)
    shape = tuple(int(np.ceil((dom_hi[d] - dom_lo[d]) / ad.cutoff)) + 1
                  for d in range(2))
    grid = CellGrid(lower=tuple(dom_lo), spacing=(ad.cutoff,) * 2,
                    shape=shape)
    ls = build_levelset(blade, dom_lo, dom_hi, tir.DX) \
        .update_kernel_integrals(ad.kernel, 2)
    pos, curve = jr.relax_shape_implicit(
        blade, jnp.asarray(pos0), vol, ad, grid,
        n_iterations=L.BLADE["n_iterations"],
        record_every=L.BLADE["record_every"], levelset=ls)
    out["blade"] = L.blade_readings(np.asarray(curve, np.float64),
                                    np.asarray(pos, np.float64), tir.DX)
    print("blade", time.time() - t0, out["blade"], flush=True)
    return out


if __name__ == "__main__":
    # `JAX_PLATFORMS=cpu PYTHONPATH=.:tests python
    # tests/test_torch_static_confinement.py jax_f32` rewrites the JAX
    # package's float32 CPU readings that the long script prints beside
    # the card's (a few minutes: the confinement's ~5,000 steps)
    import json
    import os
    import sys

    from sphinxsys_tpu_torch.benchmarks.a7k_levelset_turbulence_long import \
        JAX_F32

    assert sys.argv[1:] == ["jax_f32"], "usage: ... jax_f32"
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    readings = jax_f32_readings()
    os.makedirs(os.path.dirname(JAX_F32), exist_ok=True)
    with open(JAX_F32, "w") as f:
        json.dump(readings, f, indent=1)
    print("wrote", JAX_F32)
