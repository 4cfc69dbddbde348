"""Parity of the port's active-strain fish with the JAX package, on the
CPU in float64: physics/solid.py `cholesky`, `active_model_pk1` and the
`pk1_fn` hook of `integration_1st_half_pk2`; cases/fish_undulation_2d.py
(`impose_active_strain`, the composite build, 200 steps at dx = 0.01)
and cases/fish_fsi_2d.py (dx = 0.01 to t = 0.02: 6 advection, 30
acoustic and 382 solid steps); and their CLI entries.

Inputs are made from a seed with numpy.  Functions are held within 1e-12
of max|ref|, the case runs within 1e-9 of max|x| with equal step counts
and identical Alive and Indicator masks.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sphinxsys_tpu.cases import fish_fsi_2d as jff, fish_undulation_2d as jfu
from sphinxsys_tpu.physics import solid as jsd
from sphinxsys_tpu_torch.cases import fish_fsi_2d as tff, \
    fish_undulation_2d as tfu
from sphinxsys_tpu_torch.core import linalg
from sphinxsys_tpu_torch.physics import solid as tsd

from test_torch_open_boundary import hold_cli_run

torch.set_num_threads(1)

TOL = 1e-12
POS_TOL = 1e-9


def _close(got, ref, tol=TOL, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-300), (what, err)


def _strain(rng, n, dim, scale=0.05):
    """Symmetric active strains with 2 E_a + I positive definite."""
    a = scale * rng.normal(size=(n, dim, dim))
    return 0.5 * (a + np.swapaxes(a, -1, -2))


def test_cholesky_closed_form():
    rng = np.random.default_rng(2)
    M = 2.0 * _strain(rng, 50, 2) + np.eye(2)
    M[:, 0, 1] += 1e-3        # an asymmetric input: the symmetrised one counts
    got = linalg.cholesky(torch.as_tensor(M)).numpy()
    _close(got, np.asarray(jnp.linalg.cholesky(jnp.asarray(M))))
    _close(got @ np.swapaxes(got, -1, -2), 0.5 * (M + np.swapaxes(M, -1, -2)))


@pytest.mark.parametrize("per_particle", [False, True])
def test_active_model_pk1(per_particle):
    rng = np.random.default_rng(11)
    n = 64
    F = np.eye(2) + 0.05 * rng.normal(size=(n, 2, 2))
    Ea = _strain(rng, n, 2)
    lam = 2.0e7 * (1 + rng.random(n)) if per_particle else 2.0e7
    G = 3.0e5 * (1 + rng.random(n)) if per_particle else 3.0e5
    got = tsd.active_model_pk1(torch.as_tensor(F), torch.as_tensor(Ea),
                               torch.as_tensor(lam) if per_particle else lam,
                               torch.as_tensor(G) if per_particle else G)
    ref = jsd.active_model_pk1(jnp.asarray(F), jnp.asarray(Ea),
                               jnp.asarray(lam) if per_particle else lam,
                               jnp.asarray(G) if per_particle else G)
    _close(got.numpy(), np.asarray(ref))


def test_active_model_pk1_zero_strain_is_stvk():
    """E_a = 0: F0 = I, and the law is the passive StVK, P = F S(E)."""
    rng = np.random.default_rng(12)
    F = np.eye(2) + 0.05 * rng.normal(size=(20, 2, 2))
    Ea = np.zeros((20, 2, 2))
    got = tsd.active_model_pk1(torch.as_tensor(F), torch.as_tensor(Ea), 2.0,
                               1.5).numpy()
    _close(got, np.asarray(jsd.active_model_pk1(jnp.asarray(F),
                                                jnp.asarray(Ea), 2.0, 1.5)))
    E = 0.5 * (np.swapaxes(F, -1, -2) @ F - np.eye(2))
    S = 2.0 * np.trace(E, axis1=-2, axis2=-1)[:, None, None] * np.eye(2) \
        + 3.0 * E
    _close(got, F @ S)


@pytest.fixture(scope="module")
def fish_pair():
    jc, js = jfu.build_case(dx=0.01, dtype=jnp.float64)
    tc, ts = tfu.build_case(dx=0.01, dtype=torch.float64, device="cpu")
    return jc, js, tc, ts


def test_fish_build_matches_jax(fish_pair):
    jc, js, tc, ts = fish_pair
    assert tc.n_fish == jc.n_fish == 36 and tc.tail_idx == jc.tail_idx
    for k in ("Position", "Mass", "VolumetricMeasure", "Lambda0",
              "ShearModulus", "LinearGradientCorrectionMatrix"):
        _close(ts.fish[k].numpy(), np.asarray(js.fish[k]), what=k)
    np.testing.assert_array_equal(ts.fish["MaterialID"].numpy(),
                                  np.asarray(js.fish["MaterialID"]))
    assert set(np.unique(ts.fish["MaterialID"].numpy())) == {0, 1, 2}
    np.testing.assert_array_equal(tc.rp.idx.numpy(), np.asarray(jc.rp.idx))


@pytest.mark.parametrize("t", [0.0, 0.13, 0.61])
def test_impose_active_strain(fish_pair, t):
    jc, js, tc, ts = fish_pair
    origin = (0.01, -0.002)
    got = tfu.impose_active_strain(ts.fish, torch.tensor(t, dtype=torch.float64),
                                   origin)["ActiveStrain"]
    ref = jfu.impose_active_strain(js.fish, jnp.asarray(t), origin)["ActiveStrain"]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL * max(np.abs(ref).max(), 1e-3))


def test_pk1_half_step(fish_pair):
    """integration_1st_half_pk2 with the fish's composite PK1 (pk1_fn) on
    a seeded deformation, velocity and active strain."""
    jc, js, tc, ts = fish_pair
    rng = np.random.default_rng(13)
    n = tc.n_fish
    fields = {"DeformationGradient": np.eye(2) + 0.02 * rng.normal(size=(n, 2, 2)),
              "DeformationRate": 0.5 * rng.normal(size=(n, 2, 2)),
              "Velocity": 0.1 * rng.normal(size=(n, 2)),
              "ForcePrior": rng.normal(size=(n, 2)),
              "ActiveStrain": _strain(rng, n, 2)}
    jfish = dict(js.fish, **{k: jnp.asarray(v) for k, v in fields.items()})
    tfish = dict(ts.fish, **{k: torch.as_tensor(v) for k, v in fields.items()})
    h, dt = jc.adaptation.h, 1.3e-5
    w0 = jc.kernel.w0(2)
    jo = jsd.integration_1st_half_pk2(jfish, jc.rp, jc.material, dt, h, w0,
                                      pk1_fn=jfu._pk1)
    to = tsd.integration_1st_half_pk2(tfish, tc.rp, tc.material, dt, h, w0,
                                      pk1_fn=tfu._pk1)
    for k in ("Position", "DeformationGradient", "Density",
              "StressPK1OnParticle", "Force", "Velocity"):
        _close(to[k].numpy(), np.asarray(jo[k]), what=k)
    # the active-stress hook (ported with the muscle), on the fish's
    # material: S_active(F) = F added to its PK2
    jo = jsd.integration_1st_half_pk2(jfish, jc.rp, jc.material, dt, h, w0,
                                      active_stress_fn=lambda s, F: F)
    to = tsd.integration_1st_half_pk2(tfish, tc.rp, tc.material, dt, h, w0,
                                      active_stress_fn=lambda s, F: F)
    for k in ("StressPK1OnParticle", "Force", "Velocity"):
        _close(to[k].numpy(), np.asarray(jo[k]), what=k)


def test_fish_undulation_matches_jax(fish_pair):
    """200 steps at dx = 0.01 through make_run_chunk (the time to which
    JAX's run takes exactly 200)."""
    jc, js, tc, ts = fish_pair
    t_end = 0.0088508
    js = jfu.make_run_chunk(jc)(js, jnp.asarray(t_end, jnp.float64))
    ts = tfu.make_run_chunk(tc)(ts, t_end)
    assert ts.n_steps == int(js.n_steps) == 200
    assert float(ts.time) == pytest.approx(float(js.time), rel=1e-12)
    jp = np.asarray(js.fish["Position"])
    assert np.abs(ts.fish["Position"].numpy() - jp).max() \
        <= POS_TOL * np.abs(jp).max()
    _close(ts.fish["Velocity"].numpy(), np.asarray(js.fish["Velocity"]), 1e-9)
    assert tfu.tail_lateral_displacement(tc, ts) == pytest.approx(
        jfu.tail_lateral_displacement(jc, js), rel=1e-9)
    np.testing.assert_allclose(tfu.center_of_mass(ts), jfu.center_of_mass(js),
                               rtol=0, atol=1e-12)


def test_fish_fsi_matches_jax():
    jc, jf, jfi = jff.build_case(dx=0.01, dtype=jnp.float64)
    js = jff.make_run_chunk(jc)(jff.init_sim(jc, jf, jfi),
                                jnp.asarray(0.02, jnp.float64))
    tc, tf, tfi = tff.build_case(dx=0.01, dtype=torch.float64, device="cpu")
    assert (tc.n_fluid, tc.n_fish) == (jc.n_fluid, jc.n_fish) == (4360, 36)
    _close(tfi["NormalDirection"].numpy(), np.asarray(jfi["NormalDirection"]))
    ts = tff.make_run_chunk(tc)(tff.init_sim(tc, tf, tfi), 0.02)
    assert (ts.n_adv, ts.n_ac, ts.n_s) == (
        int(js.n_adv), int(js.n_ac), int(js.n_s)) == (6, 30, 382)
    assert not bool(ts.overflow) and not bool(js.overflow)
    for k in ("Alive", "Indicator"):
        np.testing.assert_array_equal(ts.fluid[k].numpy(),
                                      np.asarray(js.fluid[k]), err_msg=k)
    alive = np.asarray(js.fluid["Alive"])
    assert alive.sum() == 3798          # the outlet columns deleted
    jp = np.asarray(js.fluid["Position"])
    err = np.abs(ts.fluid["Position"].numpy() - jp)[alive].max()
    assert err <= POS_TOL * np.abs(jp[alive]).max()
    np.testing.assert_array_equal(ts.fluid["Position"].numpy()[~alive],
                                  jp[~alive])
    jpf = np.asarray(js.fish["Position"])
    assert np.abs(ts.fish["Position"].numpy() - jpf).max() \
        <= POS_TOL * np.abs(jpf).max()
    np.testing.assert_allclose(tff.fish_center_of_mass(ts),
                               jff.fish_center_of_mass(js), rtol=0, atol=1e-12)


@pytest.mark.parametrize("case", ["fish_undulation_2d", "fish_fsi_2d"])
def test_cli_matches_jax(case, tmp_path, caplog):
    hold_cli_run(case, tmp_path, caplog)


# ---------------------------------------------------------------------------
# JAX's own float32 counts at the reference width, which chip_smoke.py's
# phase 13 holds the card's run to (within 20%):
#   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_fish.py
# ---------------------------------------------------------------------------

JAX_COUNTS = Path(__file__).parent / "golden_torch" / "fish_fsi" / \
    "jax_f32_counts.json"
COUNT_T_END = 0.05
COUNT_SAMPLE = 0.01


def _jax_f32_counts():
    """fish_fsi_2d at dx = 0.0025 (the reference's) and the T-pipe at its
    dx = 0.15, float32 with x64 off, sampled every COUNT_SAMPLE (the fish
    to COUNT_T_END) and every 0.5 (the T-pipe to 2.0)."""
    from sphinxsys_tpu.cases import t_pipe_2d as jtp

    case, fluid, fish = jff.build_case()
    s = jff.init_sim(case, fluid, fish)
    run = jff.make_run_chunk(case)
    fish_rows = []
    for i in range(1, round(COUNT_T_END / COUNT_SAMPLE) + 1):
        s = run(s, jnp.asarray(i * COUNT_SAMPLE, s.time.dtype))
        fish_rows.append([float(s.time), int(s.n_adv), int(s.n_ac),
                          int(s.n_s), int(jnp.sum(s.fluid["Alive"])),
                          bool(s.overflow)])
    tcase, tfluid = jtp.build_case()
    ts = jtp.init_sim(tcase, tfluid)
    trun = jtp.make_run_chunk(tcase)
    pipe_rows = []
    for i in range(1, 5):
        ts = trun(ts, jnp.asarray(0.5 * i, ts.time.dtype))
        pipe_rows.append([float(ts.time), int(ts.n_adv), jtp.n_alive(ts),
                          bool(ts.overflow)])
    return dict(fish_fsi=dict(dx=case.dx, n_fluid=case.n_fluid,
                              n_fish=case.n_fish,
                              n_alive0=int(jnp.sum(fluid["Alive"])),
                              rows=fish_rows),
                t_pipe=dict(dx=tcase.dx, n_alive0=int(jnp.sum(tfluid["Alive"])),
                            rows=pipe_rows))


def write_jax_counts():
    import json
    import platform

    out = _jax_f32_counts()
    JAX_COUNTS.parent.mkdir(parents=True, exist_ok=True)
    JAX_COUNTS.write_text(json.dumps({
        "what": "the JAX package's float32 (x64 off) CPU runs: fish_fsi_2d "
                "rows [t, n_adv, n_ac, n_s, alive, overflow], t_pipe_2d rows "
                "[t, n_adv, alive, overflow]",
        "command": "JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_fish.py",
        "platform": f"cpu ({platform.machine()})",
        **out}, indent=1) + "\n")
    print(f"wrote {JAX_COUNTS}")


JAX_COM = Path(__file__).parent / "golden_torch" / "fish_fsi" / \
    "jax_f32_com.json"


def write_jax_com(t_end=1.7, n_snap=85):
    """The JAX package's own float32 run of fish_fsi_2d at dx = 0.0025 on
    the CPU, x64 off, to t = 1.7: the fish's centre of mass and the
    water's kinetic energy at benchmarks/run_fish_validation.py's 85
    samples (~10 min on 8 cores):
        JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_fish.py com
    The committed tests/golden/fish curve is a TPU run of the case; this
    is the package on the CPU."""
    import json
    import platform
    import time

    case, fluid, fish = jff.build_case()
    s = jff.init_sim(case, fluid, fish)
    run = jff.make_run_chunk(case)
    rows = []
    t0 = time.time()
    for i in range(1, n_snap + 1):
        s = run(s, jnp.asarray(i * t_end / n_snap, s.time.dtype))
        com = jff.fish_center_of_mass(s)
        m = np.asarray(s.fluid["Alive"])
        ke = float(np.sum(0.5 * np.asarray(s.fluid["Mass"])[m] * np.sum(
            np.asarray(s.fluid["Velocity"])[m] ** 2, -1)))
        rows.append([float(s.time), float(com[0]), float(com[1]), ke,
                     int(s.n_adv), int(s.n_ac), int(s.n_s), bool(s.overflow)])
        print(rows[-1], f"{time.time() - t0:.0f} s", flush=True)
    JAX_COM.parent.mkdir(parents=True, exist_ok=True)
    JAX_COM.write_text(json.dumps({
        "what": "fish_fsi_2d (sphinxsys_tpu.cases.fish_fsi_2d) at dx = 0.0025 "
                "in float32, x64 off, to t = 1.7: rows [t, com x, com y, "
                "water kinetic energy, n_adv, n_ac, n_s, overflow]",
        "command": "JAX_PLATFORMS=cpu PYTHONPATH=. python "
                   "tests/test_torch_fish.py com",
        "platform": f"cpu ({platform.machine()})",
        "rows": rows}) + "\n")
    print(f"wrote {JAX_COM}")


if __name__ == "__main__":
    import sys

    if sys.argv[1:] == ["com"]:
        write_jax_com()
    else:
        write_jax_counts()
