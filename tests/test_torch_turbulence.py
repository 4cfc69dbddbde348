"""Parity of the port's k-epsilon turbulence (physics/turbulence.py) and
the turbulent channel (cases/turbulent_channel_2d.py) with the JAX
package on the CPU, in float64.

Inputs: JAX's channel at its default width (160 fluid, 64 wall
particles) after two advection steps, carried across with its lists,
then perturbed from a numpy seed so that every branch runs: k and eps
spread over two decades (y* on both sides of the laminar limit), the
eddy viscosity, the velocity and its gradient, K_Production.  Each
function is held within 1e-12 of max |JAX| (the laminar switch at t = 0
and t = 0.5, the source-term linearisation on and off, the extra
dissipation on and off); the K equation then the Epsilon equation on the
K equation's output, as the case calls them.  The case over three
advection steps (15 acoustic sub-steps) within 1e-9, with JAX's step
counts; the CLI on the CPU.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sphinxsys_tpu.cases import turbulent_channel_2d as jcase
from sphinxsys_tpu.physics import turbulence as jtb
from sphinxsys_tpu_torch import convert
from sphinxsys_tpu_torch import run as trun
from sphinxsys_tpu_torch.cases import turbulent_channel_2d as tcase
from sphinxsys_tpu_torch.physics import turbulence as ttb

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")
CL_J, CL_T = jtb.TurbuClosure(), ttb.TurbuClosure()
DT = 2.0e-3
MU, H, C0 = jcase.MU_F, 1.3 * jcase.DX, jcase.C_F


def close(got, ref, tol=1e-12, what=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max(initial=0.0)
    assert err <= tol * max(np.abs(ref).max(initial=0.0), 1e-300), (what,
                                                                      err)


def hold(got: dict, ref: dict, keys, tol=1e-12):
    for k in keys:
        close(got[k], ref[k], tol, k)


@functools.lru_cache(maxsize=None)
def scene():
    """(JAX: case, fluid, lists), (the port's: case, fluid, lists)."""
    jc, jf = jcase.build_case(dtype=jnp.float64)
    js = jcase.make_run_chunk(jc)(jcase.init_sim(jc, jf), jnp.asarray(0.02))
    f = {k: np.array(v) for k, v in js.fluid.items()}
    n = f["Position"].shape[0]
    rng = np.random.default_rng(5)
    f["TurbulenceKineticEnergy"] *= 10.0 ** rng.uniform(0.0, 2.0, n)
    f["TurbulentDissipation"] *= 10.0 ** rng.uniform(-0.5, 1.5, n)
    f["TurbulentViscosity"] = f["Density"] * 0.09 \
        * f["TurbulenceKineticEnergy"] ** 2 / f["TurbulentDissipation"]
    f["Velocity"] += 0.05 * rng.normal(size=(n, 2))
    f["TurbulentVelocityGradient"] += 0.2 * rng.normal(size=(n, 2, 2))
    f["K_Production"] = 1e-3 * rng.normal(size=n)
    jfl = {k: jnp.asarray(v) for k, v in f.items()}
    jfl = jtb.judge_is_near_wall(jfl, jc.wall, js.nl_wall, jc.kernel, 2,
                                 jc.dx, jc.dx)
    f = {k: np.asarray(v) for k, v in jfl.items()}
    assert (f["IsNearWallP1"] == 1).any() and (f["IsNearWallP1"] == 0).any()
    tc, _ = tcase.build_case(**F64)
    tf = convert.state_from_numpy(f)
    return (jc, jfl, js.nl_inner, js.nl_wall), \
        (tc, tf, convert.neighbor_list_from_numpy(js.nl_inner),
         convert.neighbor_list_from_numpy(js.nl_wall))


def test_register_fields_and_inflow_match_jax():
    (jc, jf, *_), (tc, tf, *_) = scene()
    base = {k: jf[k] for k in ("Position", "Velocity", "Mass")}
    ref = jtb.register_turbulence_fields(dict(base), 2, 1e-3, 2e-4, 1e-9,
                                         0.05)
    got = ttb.register_turbulence_fields(
        {k: tf[k] for k in base}, 2, 1e-3, 2e-4, 1e-9, 0.05)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]))
        assert str(got[k].dtype).split(".")[-1] == str(ref[k].dtype), k
    assert ttb.turbulent_inflow_values(1.5, 2.0) \
        == jtb.turbulent_inflow_values(1.5, 2.0)


@pytest.mark.parametrize("time", (0.0, 0.5))
def test_dimensionless_velocity_matches_jax(time):
    y = np.concatenate([np.linspace(0.0, 30.0, 61), [1e-20]])
    ref = jtb.dimensionless_velocity(jnp.asarray(y), time, CL_J)
    close(ttb.dimensionless_velocity(torch.as_tensor(y), time, CL_T), ref)


def test_judge_is_near_wall_matches_jax():
    (jc, jf, _, jnw), (tc, tf, _, tnw) = scene()
    ref = jtb.judge_is_near_wall(jf, jc.wall, jnw, jc.kernel, 2, jc.dx,
                                 jc.dx)
    got = ttb.judge_is_near_wall(tf, tc.wall, tnw, tc.kernel, 2, tc.dx,
                                 tc.dx)
    for k in ("IsNearWallP1", "IsNearWallP2"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
        assert got[k].dtype == torch.int32
    hold(got, ref, ("WallNearestNormal", "WallNearestTau",
                    "DistanceToDummyInterface"))


def test_correction_matrix_and_eddy_viscosity_match_jax():
    (jc, jf, jni, _), (tc, tf, tni, _) = scene()
    for alpha in (0.0, 0.5):
        ref = jax.jit(lambda f: jtb.turbulent_correction_matrix(
            f, jni, jc.kernel, 2, alpha))(jf)
        got = ttb.turbulent_correction_matrix(tf, tni, tc.kernel, 2, alpha)
        hold(got, ref, ("TurbulentCorrectionMatrix",))
    hold(ttb.eddy_viscosity_update(tf, CL_T),
         jtb.eddy_viscosity_update(jf, CL_J), ("TurbulentViscosity",))
    for u_max in (1.5, 1e-3):
        close(ttb.turbulent_advection_time_step(tf, MU, 1.0, H, u_max),
              jtb.turbulent_advection_time_step(jf, MU, 1.0, H, u_max))


@pytest.mark.parametrize("time", (0.0, 0.5))
def test_wall_function_and_velocity_gradient_match_jax(time):
    (jc, jf, jni, jnw), (tc, tf, tni, tnw) = scene()
    ref = jax.jit(lambda f: jtb.turbulent_velocity_gradient(
        jtb.standard_wall_function_correction(f, jc.wall, jnw, jc.kernel, 2,
                                              MU, time, CL_J),
        jni, jc.wall, jnw, jc.kernel, 2, 0.1))(jf)
    mid = ttb.standard_wall_function_correction(tf, tc.wall, tnw, tc.kernel,
                                                2, MU, time, CL_T)
    got = ttb.turbulent_velocity_gradient(mid, tni, tc.wall, tnw, tc.kernel,
                                          2, 0.1)
    hold(got, ref, ("WallYstar", "WallYplus", "FrictionVelocity",
                    "TangentialVelocity", "TurbulentDissipation",
                    "K_Production", "TurbulentVelocityGradient"))
    hold(ttb.constrain_normal_velocity_region_p(tf),
         jtb.constrain_normal_velocity_region_p(jf), ("Velocity",))


@pytest.mark.parametrize("stl", (True, False), ids=("stl", "explicit"))
def test_k_then_epsilon_match_jax(stl):
    """The K equation, then the Epsilon equation on its output (it reads
    the updated k)."""
    (jc, jf, jni, _), (tc, tf, tni, _) = scene()

    def jax_pair(f):
        f = jtb.k_equation(f, jni, jc.kernel, 2, MU, H, DT, CL_J, stl=stl)
        return f, jtb.epsilon_equation(f, jni, jc.kernel, 2, MU, H, DT, CL_J,
                                       stl=stl)

    rk, re = jax.jit(jax_pair)(jf)
    gk = ttb.k_equation(tf, tni, tc.kernel, 2, MU, H, DT, CL_T, stl=stl)
    ge = ttb.epsilon_equation(gk, tni, tc.kernel, 2, MU, H, DT, CL_T,
                              stl=stl)
    hold(gk, rk, ("TurbulenceKineticEnergy", "K_Production",
                  "TurbulentStrainRate"))
    hold(ge, re, ("TurbulentDissipation",))
    # the Epsilon equation read the updated k, not the old one
    old = ttb.epsilon_equation(tf, tni, tc.kernel, 2, MU, H, DT, CL_T,
                               stl=stl)
    assert float((old["TurbulentDissipation"]
                  - ge["TurbulentDissipation"]).abs().max()) > 0.0


@pytest.mark.parametrize("extra", (True, False), ids=("limiter", "plain"))
def test_forces_match_jax(extra):
    (jc, jf, jni, jnw), (tc, tf, tni, tnw) = scene()
    ref = jax.jit(lambda f: jtb.turbulent_viscous_force(
        jtb.tke_energy_force(f, jni, jc.wall, jnw, jc.kernel, 2), jni,
        jc.wall, jnw, jc.kernel, 2, MU, H, C0, 0.5, CL_J,
        extra_dissipation=extra))(jf)
    got = ttb.turbulent_viscous_force(
        ttb.tke_energy_force(tf, tni, tc.wall, tnw, tc.kernel, 2), tni,
        tc.wall, tnw, tc.kernel, 2, MU, H, C0, 0.5, CL_T,
        extra_dissipation=extra)
    hold(got, ref, ("ForcePrior", "TkeForcePrev", "ViscousForce",
                    "ViscousForcePrev"))


def test_channel_matches_jax():
    """Three advection steps from the impulsive start: JAX's step counts,
    every field within 1e-9."""
    jc, jf = jcase.build_case(dtype=jnp.float64)
    js = jcase.make_run_chunk(jc)(jcase.init_sim(jc, jf), jnp.asarray(0.05))
    tc, tf = tcase.build_case(**F64)
    ts = tcase.make_run_chunk(tc)(tcase.init_sim(tc, tf), 0.05)
    assert (ts.n_adv, ts.n_ac) == (int(js.n_adv), int(js.n_ac)) == (3, 15)
    assert not bool(ts.overflow)
    close(ts.time, js.time, 1e-12, "time")
    hold(ts.fluid, js.fluid, [k for k in js.fluid if k != "NReal"], 1e-9)
    y, prof = tcase.mean_profile(tc, ts)
    jy, jprof = jcase.mean_profile(jc, js)
    close(y, jy)
    close(prof, jprof, 1e-9)


def test_cli_runs_on_the_cpu(tmp_path):
    out = tmp_path / "out"
    assert trun.main(["turbulent_channel_2d", "--set", "t_end=0.02",
                      "--set", "n_output=2", "--set", "device=cpu",
                      "--output_dir", str(out)]) == 0
    assert sorted(p.name for p in out.iterdir()) == [
        f"{b}_{i:06d}.vtp" for b in ("Wall", "WaterBody") for i in (1, 2)]
