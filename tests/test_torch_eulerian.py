"""Parity of the port's physics/eulerian.py and the Eulerian Taylor-Green
case with the JAX package on the CPU.

Functions, on the seeded 2D and 3D scenes of tests/test_torch_viscosity.py
(f64 within 1e-12 of max |JAX|, f32 within 2e-5): the acoustic interface
state, both weakly-compressible halves (with and without a wall) and
their time step; the HLLC interface state with and without the limiter
on states whose sound speed is small against the velocities, so that
pairs fall in all four wave regions (every region's count checked), and
with a patch of zero pressure that makes the contact speed's denominator
vanish (the guarded branches; NaN where JAX gives NaN); the compressible
state, both compressible halves and their time step.

The case (eulerian_taylor_green_2d at dx = 0.1 and 0.05): the build (the
list equal, every field at 1e-12), a run of a few steps (equal step
counts, every field within 1e-9 of its max), one step from JAX's own
state carried across, the CLI entry.  Its kinetic energy to t = 5 at the
default width is held on the card by
sphinxsys_tpu_torch/benchmarks/a7i_diffusion_eulerian_long.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_corrected_cases import cli_runs
from test_torch_viscosity import DTYPES, TOL, close, kernels, scene

from sphinxsys_tpu.cases import eulerian_taylor_green_2d as jtg
from sphinxsys_tpu.core.materials import CompressibleFluid as JGas
from sphinxsys_tpu.core.materials import WeaklyCompressibleFluid as JEos
from sphinxsys_tpu.physics import eulerian as jeu
from sphinxsys_tpu.physics import riemann as jrs
from sphinxsys_tpu_torch import convert
from sphinxsys_tpu_torch.cases import eulerian_taylor_green_2d as ttg
from sphinxsys_tpu_torch.core.materials import CompressibleFluid as TGas
from sphinxsys_tpu_torch.core.materials import WeaklyCompressibleFluid as TEos
from sphinxsys_tpu_torch.physics import eulerian as teu
from sphinxsys_tpu_torch.physics import riemann as trs

torch.set_num_threads(1)

DT = 1.0e-3
EOS = dict(rho0=1.0, c0=10.0)
RUN_TOL = 1e-9


def _eulerian(dim, dtype):
    """The scene's body with Momentum, both packages'."""
    (jb, jw, nl, nlw, _), (tb, tw, tnl, tnlw, _) = scene(dim, dtype)
    jb = dict(jb, Momentum=jb["Mass"][:, None] * jb["Velocity"])
    tb = dict(tb, Momentum=tb["Mass"][:, None] * tb["Velocity"])
    return (jb, jw, nl, nlw), (tb, tw, tnl, tnlw)


@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
@pytest.mark.parametrize("wall", (False, True), ids=("inner", "wall"))
@pytest.mark.parametrize("dim", (2, 3))
def test_acoustic_halves_match_jax(dim, wall, dtype):
    (jb, jw, nl, nlw), (tb, tw, tnl, tnlw) = _eulerian(dim, dtype)
    jkn, tkn = kernels()
    jeos, teos = JEos(**EOS), TEos(**EOS)
    jrm, trm = jrs.acoustic_riemann(jeos), trs.acoustic_riemann(teos)
    jkw = dict(wall=jw, nl_wall=nlw) if wall else {}
    tkw = dict(wall=tw, nl_wall=tnlw) if wall else {}
    ref1 = jax.jit(lambda b: jeu.eulerian_integration_1st_half(
        b, nl, jkn, dim, jrm, DT, **jkw))(jb)
    got1 = teu.eulerian_integration_1st_half(tb, tnl, tkn, dim, trm, DT,
                                             **tkw)
    for k in ("Momentum", "Velocity"):
        close(got1[k], ref1[k], TOL[dtype], k)
    ref2 = jax.jit(lambda b: jeu.eulerian_integration_2nd_half(
        b, nl, jkn, dim, jrm, jeos, DT, **jkw))(ref1)
    got2 = teu.eulerian_integration_2nd_half(got1, tnl, tkn, dim, trm, teos,
                                             DT, **tkw)
    for k in ("Mass", "Density", "Pressure"):
        close(got2[k], ref2[k], TOL[dtype], k)
    close(got2["Mass"] - got1["Mass"], ref2["Mass"] - ref1["Mass"],
          100 * TOL[dtype], "mass change")
    close(teu.eulerian_time_step(got2, teos, 0.13),
          jeu.eulerian_time_step(ref2, jeos, 0.13), TOL[dtype], "dt")


def _gas_states(dim, dtype, zero_patch):
    """The scene's body as a gas whose sound speed (p ~ 0.05, c ~ 0.25) is
    small against its velocities (~1.5): pairs in all four wave regions.
    `zero_patch`: a patch of rows at zero pressure (c = 0)."""
    (jb, _, nl, _), (tb, _, tnl, _) = _eulerian(dim, dtype)
    rng = np.random.default_rng(17)
    n = tb["Position"].shape[0]
    vel = 1.5 * rng.normal(size=(n, dim))
    p = 0.05 * (0.5 + rng.random(n))
    if zero_patch:
        p[:12] = 0.0
    rho = 0.8 + 0.4 * rng.random(n)
    E = (p / 0.4 + 0.5 * rho * (vel ** 2).sum(-1)) \
        * np.asarray(tb["VolumetricMeasure"], np.float64)
    extra = {"Velocity": vel, "Pressure": p, "Density": rho,
             "TotalEnergy": E}
    jb = dict(jb, **{k: jnp.asarray(v, dtype) for k, v in extra.items()})
    tb = dict(tb, **{k: torch.as_tensor(np.asarray(v, dtype))
                     for k, v in extra.items()})
    return jb, tb, nl, tnl


def _close_nan(got, ref, tol, what):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert (np.isnan(got) == np.isnan(ref)).all(), what
    ok = ~np.isnan(ref)
    close(got[ok], ref[ok], tol, what)


@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
@pytest.mark.parametrize("limiter", (None, 1.0), ids=("plain", "limited"))
@pytest.mark.parametrize("dim", (2, 3))
def test_hllc_interface_state_matches_jax(dim, limiter, dtype):
    jb, tb, nl, tnl = _gas_states(dim, dtype, zero_patch=False)
    jkn, tkn = kernels()
    gas_j, gas_t = JGas(gamma=1.4), TGas(gamma=1.4)

    def jstar(b):
        pg, rho_j, vel_j, p_j, vol_j = jeu._pair_states(b, nl, jkn, dim, None)
        E = b["TotalEnergy"] / b["VolumetricMeasure"]
        E_j = E[jnp.minimum(nl.idx, E.shape[0] - 1)]
        out = jeu.hllc_interface_state(
            gas_j, b["Density"][:, None], b["Velocity"][:, None, :],
            b["Pressure"][:, None], E[:, None], rho_j, vel_j, p_j, E_j, pg.e,
            limiter=limiter)
        ul = -jnp.sum(pg.e * b["Velocity"][:, None, :], -1)
        ur = -jnp.sum(pg.e * vel_j, -1)
        s_l = ul - gas_j.sound_speed(b["Pressure"][:, None],
                                     b["Density"][:, None])
        s_r = ur + gas_j.sound_speed(p_j, rho_j)
        return out, (s_l, s_r, pg.mask)

    ref, (s_l, s_r, mask) = jax.jit(jstar)(jb)
    (got, e, _) = teu._hllc_pairs(tb, tnl, tkn, dim, gas_t, None, limiter)
    for name, g, r in zip(("rho", "v", "p", "E"), got, ref):
        close(g, r, TOL[dtype], name)
    # every wave region met on real pairs
    s_l, s_r, mask = (np.asarray(x) for x in (s_l, s_r, mask))
    assert (mask & (s_l > 0)).sum() > 20 and (mask & (s_r < 0)).sum() > 20
    assert (mask & (s_l <= 0) & (s_r >= 0)).sum() > 20


@pytest.mark.parametrize("limiter", (None, 1.0), ids=("plain", "limited"))
def test_hllc_guards_match_jax(limiter):
    """A patch at zero pressure: c = 0, the contact speed's denominator
    vanishes between its rows, and the safe() guards take over."""
    jb, tb, nl, tnl = _gas_states(2, np.float64, zero_patch=True)
    jkn, tkn = kernels()
    gas_j, gas_t = JGas(gamma=1.4), TGas(gamma=1.4)
    ref = jax.jit(lambda b: jeu.compressible_integration_1st_half(
        b, nl, jkn, 2, gas_j, DT, limiter=limiter))(jb)
    got = teu.compressible_integration_1st_half(tb, tnl, tkn, 2, gas_t, DT,
                                                limiter=limiter)
    _close_nan(got["Momentum"], ref["Momentum"], 1e-12, "momentum")
    ref2 = jax.jit(lambda b: jeu.compressible_integration_2nd_half(
        b, nl, jkn, 2, gas_j, DT, limiter=limiter))(jb)
    got2 = teu.compressible_integration_2nd_half(tb, tnl, tkn, 2, gas_t, DT,
                                                 limiter=limiter)
    for k in ("Mass", "TotalEnergy", "Pressure"):
        _close_nan(got2[k], ref2[k], 1e-12, k)


@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
@pytest.mark.parametrize("limiter", (None, 1.0), ids=("plain", "limited"))
@pytest.mark.parametrize("dim", (2, 3))
def test_compressible_halves_match_jax(dim, limiter, dtype):
    jb, tb, nl, tnl = _gas_states(dim, dtype, zero_patch=False)
    jkn, tkn = kernels()
    gas_j, gas_t = JGas(gamma=1.4), TGas(gamma=1.4)
    ref1 = jax.jit(lambda b: jeu.compressible_integration_1st_half(
        b, nl, jkn, dim, gas_j, DT, limiter=limiter))(jb)
    got1 = teu.compressible_integration_1st_half(tb, tnl, tkn, dim, gas_t,
                                                 DT, limiter=limiter)
    for k in ("Momentum", "Velocity"):
        close(got1[k], ref1[k], TOL[dtype], k)
    ref2 = jax.jit(lambda b: jeu.compressible_integration_2nd_half(
        b, nl, jkn, dim, gas_j, DT, limiter=limiter))(ref1)
    got2 = teu.compressible_integration_2nd_half(got1, tnl, tkn, dim, gas_t,
                                                 DT, limiter=limiter)
    for k in ("Mass", "TotalEnergy", "Density", "Pressure"):
        close(got2[k], ref2[k], TOL[dtype], k)
    close(teu.compressible_time_step(got2, gas_t, 0.13, dim=dim),
          jeu.compressible_time_step(ref2, gas_j, 0.13, dim=dim),
          TOL[dtype], "dt")


@pytest.mark.parametrize("with_vel", (False, True))
def test_state_constructors_match_jax(with_vel):
    rng = np.random.default_rng(4)
    pos = rng.random((30, 2))
    vel = rng.normal(size=(30, 2)) if with_vel else None
    gas = dict(gamma=1.4)
    ref = jeu.make_compressible_eulerian_state(pos, 0.01, JGas(**gas), 1.2,
                                               71.4, vel0=vel,
                                               dtype=jnp.float64)
    got = teu.make_compressible_eulerian_state(pos, 0.01, TGas(**gas), 1.2,
                                               71.4, torch.float64, "cpu",
                                               vel0=vel)
    assert set(got) == set(ref)
    for k in ref:
        if k != "NReal":
            close(got[k], ref[k], 1e-15, k)
    ref = jeu.make_eulerian_state(pos, 0.01, JEos(**EOS), dtype=jnp.float64)
    got = teu.make_eulerian_state(pos, 0.01, TEos(**EOS), torch.float64,
                                  "cpu")
    assert set(got) == set(ref)
    for k in ref:
        if k != "NReal":
            close(got[k], ref[k], 1e-15, k)


# ---------------------------------------------------------------------------
# the case
# ---------------------------------------------------------------------------

TG_T_END = {0.1: 0.05, 0.05: 0.02}


@functools.lru_cache(maxsize=None)
def tg_runs(dx):
    jc, jf = jtg.build_case(dx=dx, dtype=jnp.float64)
    tc, tf = ttg.build_case(dx=dx, dtype=torch.float64, device="cpu")
    jrun = jtg.make_run_chunk(jc)
    js = jrun(jtg.init_sim(jc, jf), jnp.asarray(TG_T_END[dx], jnp.float64))
    ts = ttg.make_run_chunk(tc)(ttg.init_sim(tc, tf), TG_T_END[dx])
    return jc, tc, jf, tf, js, ts, jrun


FIELDS = ("Position", "Velocity", "Density", "Pressure", "Mass", "Momentum",
          "TotalEnergy", "ViscousForce", "ForcePrior")


@pytest.mark.parametrize("dx", sorted(TG_T_END))
def test_tg_build_matches_jax(dx):
    jc, tc, jf, tf, *_ = tg_runs(dx)
    assert tc.n_fluid == jc.n_fluid and tc.box == tuple(jc.box)
    np.testing.assert_array_equal(tc.nl.idx.numpy(), np.asarray(jc.nl.idx))
    assert set(tf) == set(jf)
    for k in jf:
        if k != "NReal":
            close(tf[k], jf[k], 1e-12, k)
    assert ttg.kinetic_energy(ttg.init_sim(tc, tf)) == pytest.approx(
        0.25, rel=1e-12)


@pytest.mark.parametrize("dx", sorted(TG_T_END))
def test_tg_run_matches_jax(dx):
    *_, js, ts, _ = tg_runs(dx)
    assert ts.n_steps == int(js.n_steps) >= 5
    assert float(ts.time) == pytest.approx(float(js.time), rel=1e-12)
    for k in FIELDS:
        close(ts.fluid[k], js.fluid[k], RUN_TOL, k)
    assert ttg.kinetic_energy(ts) == pytest.approx(jtg.kinetic_energy(js),
                                                   rel=1e-12)
    assert ttg.kinetic_energy(ts) < 0.25


def test_tg_continues_jax_state():
    jc, tc, *_, js, ts, jrun = tg_runs(0.1)
    target = float(js.time) + 1e-4
    js2 = jrun(js, jnp.asarray(target, jnp.float64))
    own = convert.sim_from_numpy(ttg.SimState, jax.tree_util.tree_map(
        np.asarray, js))
    ts2 = ttg.make_run_chunk(tc)(own, target)
    assert ts2.n_steps == int(js2.n_steps)
    for k in FIELDS:
        close(ts2.fluid[k], js2.fluid[k], 1e-12, k)


def test_tg_cli_entry_runs_on_the_cpu(tmp_path, caplog):
    cli_runs("eulerian_taylor_green_2d", ("dx=0.1", "t_end=0.01"),
             ("WaterBody",), tmp_path, caplog, {"WaterBody": 100})


def write_jax_f32():
    """The JAX package's float32 CPU kinetic-energy curve of the long
    script's protocol (dx = 1 / 50, every 0.1 to t = 5) ->
    tests/golden_torch/eulerian_taylor_green_2d/jax_f32_ke.json."""
    import json
    import os

    from sphinxsys_tpu_torch.benchmarks import \
        a7i_diffusion_eulerian_long as long

    jax.config.update("jax_enable_x64", False)
    case, fluid = jtg.build_case()
    s = jtg.init_sim(case, fluid)
    run = jtg.make_run_chunk(case)
    ke, steps = [jtg.kinetic_energy(s)], []
    for t in long.TG_TIMES:
        s = run(s, jnp.asarray(t, s.time.dtype))
        ke.append(jtg.kinetic_energy(s))
        steps.append(int(s.n_steps))
    path = os.path.join(long.GOLDEN_TORCH, "eulerian_taylor_green_2d",
                        "jax_f32_ke.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(dict(t=[0.0] + long.TG_TIMES, ke=ke, n_steps=steps), f,
                  indent=1)
    print(ke[-1], steps[-1])


if __name__ == "__main__":
    write_jax_f32()
