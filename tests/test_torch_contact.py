"""The port's solid contact (physics/contact.py), the Neo-Hookean PK2
stress and the ball–shell collision held to the JAX package, on the CPU:

* every contact function in float64 on a seeded scene — a perturbed
  lattice cube (the solid) just under a perturbed lattice slab (the other
  body / wall / shell), within the cutoff of each other, with random
  velocities, normals and prior forces; the port's neighbour lists are
  carried across, so both sides sum the same slots; each output within
  1e-12 of its max|ref|;
* the shell factor's offset and calibration formed in float32 for a
  float32 state, within a few float32 ulps of JAX's compile-time values;
* JAX's test_shell_contact_factor_monotone_in_penetration on the port;
* the ball–shell case at dx = 0.1 in float64 to t = 0.25 (free fall) and
  to t = 2.0 (through the first contact): equal step counts, positions
  within 1e-10 of max|x|;
* the case at dx = 0.05 to t = 2.0 in float32, its mass-weighted centre
  of mass z every 0.1 held to tests/golden/ball_shell_collision_3d by the
  reference's DTW criterion, no particle past r = 2 + dx/2, no overflow
  (marked slow: ~4 min on one CPU thread).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sphinxsys_tpu.cases import ball_shell_collision_3d as jbs
from sphinxsys_tpu.core import materials as jmat
from sphinxsys_tpu.core.adaptation import SPHAdaptation as JAdaptation
from sphinxsys_tpu.neighbors.neighbor_list import NeighborList as JNeighborList
from sphinxsys_tpu.physics import contact as jct
from sphinxsys_tpu_torch import convert
from sphinxsys_tpu_torch.cases import ball_shell_collision_3d as tbs
from sphinxsys_tpu_torch.core import materials as tmat
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.state import make_solid_state
from sphinxsys_tpu_torch.io.regression import DTWRegressionTest
from sphinxsys_tpu_torch.neighbors.cell_list import (build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import build_neighbor_list
from sphinxsys_tpu_torch.physics import contact as tct

torch.set_num_threads(1)

TOL = 1e-12
DX = 0.1
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "ball_shell_collision_3d")


def _close(got, ref, tol=TOL, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-300), f"{what}: {err:.3e}"


def _lattice(nx, ny, nz, origin):
    g = np.stack(np.meshgrid(*(np.arange(n) for n in (nx, ny, nz)),
                             indexing="ij"), -1).reshape(-1, 3)
    return np.asarray(origin) + (g + 0.5) * DX


@dataclasses.dataclass(frozen=True)
class _Impact:
    """What dynamic_contact_force_with_wall reads of its material."""
    rho0: float = 1.0e3
    c0: float = 40.0


@pytest.fixture(scope="module")
def scene():
    """(jax side, port side, kernel pair): solid A, slab B 0.6 dx above
    its top layer (its x = 0 layer pushed 0.3 dx closer), the lists
    A -> B, B -> A and A's inner list."""
    rng = np.random.default_rng(21)
    pos0_a = _lattice(5, 5, 5, (0.0, 0.0, 0.0))
    pos_a = pos0_a + 0.1 * DX * (rng.random(pos0_a.shape) - 0.5)
    pos_a[:25] += (0.0, 0.3 * DX, 0.0)         # a squeezed corner
    pos_b = _lattice(7, 1, 7, (-DX, 0.46, -DX))      # 0.6 dx above A
    pos_b += 0.1 * DX * (rng.random(pos_b.shape) - 0.5)
    na, nb = len(pos_a), len(pos_b)
    a = {"Position": pos_a, "InitialPosition": pos0_a,
         "VolumetricMeasure": np.full(na, DX ** 3) * (1 + 0.1 * rng.random(na)),
         "Mass": np.full(na, 1e3 * DX ** 3) * (1 + 0.1 * rng.random(na)),
         "Velocity": rng.normal(size=(na, 3)),
         "ForcePrior": rng.normal(size=(na, 3)),
         "RepulsionForce": rng.normal(size=(na, 3)),
         "PreviousRepulsionForce": rng.normal(size=(na, 3)),
         "NReal": np.asarray(na, np.int32)}
    nrm = rng.normal(size=(nb, 3))
    b = {"Position": pos_b,
         "VolumetricMeasure": np.full(nb, DX ** 2) * (1 + 0.1 * rng.random(nb)),
         "Mass": np.full(nb, 1e3 * DX ** 2),
         "Velocity": rng.normal(size=(nb, 3)),
         "NormalDirection": nrm / np.linalg.norm(nrm, axis=1, keepdims=True),
         "NReal": np.asarray(nb, np.int32)}
    ta, tb = convert.state_from_numpy(a), convert.state_from_numpy(b)
    ad = SPHAdaptation(spacing=DX, dim=3)
    grid = grid_from_bounds((-0.3, -0.3, -0.3), (0.9, 0.9, 0.9), ad.cutoff)

    def nl(q, s, self_):
        table = build_cell_table(s["Position"], s["NReal"], grid, 32)
        return build_neighbor_list(q["Position"], q["NReal"], s["Position"],
                                   s["NReal"], table, grid, ad.cutoff,
                                   k_max=80, include_self=not self_)

    tnl = {"ab": nl(ta, tb, False), "ba": nl(tb, ta, False),
           "aa": nl(ta, ta, True)}
    for v in tnl.values():
        assert not bool(v.overflow)
    assert int(tnl["ab"].count.sum()) > 100       # the bodies interact
    jnl = {k: JNeighborList(idx=jnp.asarray(v.idx.numpy()),
                            count=jnp.asarray(v.count.numpy()),
                            overflow=jnp.asarray(bool(v.overflow)))
           for k, v in tnl.items()}
    ja = {k: jnp.asarray(v) for k, v in a.items()}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    kernels = (JAdaptation(spacing=DX, dim=3).kernel, ad.kernel)
    return (ja, jb, jnl), (ta, tb, tnl), kernels


def test_stiffness_and_pk2_match_jax():
    kw = dict(rho0=1e3, youngs_modulus=2e4, poisson_ratio=0.45)
    jm, tm = jmat.NeoHookeanSolid(**kw), tmat.NeoHookeanSolid(**kw)
    assert tct.contact_stiffness(tm) == jct.contact_stiffness(jm)
    F = np.eye(3) + 0.05 * np.random.default_rng(3).normal(size=(50, 3, 3))
    _close(tm.stress_PK2(torch.as_tensor(F)).numpy(),
           np.asarray(jm.stress_PK2(jnp.asarray(F))), what="PK2")
    with pytest.raises(ValueError):
        tct.contact_stiffness(object())


def test_repulsion_factors_match_jax(scene):
    (ja, jb, jnl), (ta, tb, tnl), (jk, tk) = scene
    for got, ref, what in (
            (tct.repulsion_factor_contact(ta, tb, tnl["ab"], tk, 3),
             jct.repulsion_factor_contact(ja, jb, jnl["ab"], jk, 3), "contact"),
            (tct.repulsion_factor_self(ta, tnl["aa"], tk, 3, DX),
             jct.repulsion_factor_self(ja, jnl["aa"], jk, 3, DX), "self")):
        _close(got.numpy(), ref, what=what)
        assert float(got.max()) > 0.0


@pytest.mark.parametrize("impedance", [0.0, 30.0])
def test_repulsion_forces_match_jax(scene, impedance):
    (ja, jb, jnl), (ta, tb, tnl), (jk, tk) = scene
    jfa = jct.repulsion_factor_contact(ja, jb, jnl["ab"], jk, 3)
    jfb = jct.repulsion_factor_contact(jb, ja, jnl["ba"], jk, 3)
    tfa = tct.repulsion_factor_contact(ta, tb, tnl["ab"], tk, 3)
    tfb = tct.repulsion_factor_contact(tb, ta, tnl["ba"], tk, 3)
    outs = [(tct.repulsion_force_wall(ta, tb, tnl["ab"], tk, 3, tfa, 2e4,
                                      impedance=impedance),
             jct.repulsion_force_wall(ja, jb, jnl["ab"], jk, 3, jfa, 2e4,
                                      impedance=impedance))]
    if impedance == 0.0:
        outs.append((tct.repulsion_force_contact(ta, tb, tnl["ab"], tk, 3, tfa,
                                                 tfb, 2e4),
                     jct.repulsion_force_contact(ja, jb, jnl["ab"], jk, 3, jfa,
                                                 jfb, 2e4)))
    else:
        outs.append((tct.repulsion_force_self(ta, tnl["aa"], tk, 3, tfa, 1e3,
                                              2e4),
                     jct.repulsion_force_self(ja, jnl["aa"], jk, 3, jfa, 1e3,
                                              2e4)))
    for t, j in outs:
        for k in ("ForcePrior", "RepulsionForce", "PreviousRepulsionForce"):
            _close(t[k].numpy(), j[k], what=k)


def test_dynamic_contact_force_with_wall_matches_jax(scene):
    (ja, jb, jnl), (ta, tb, tnl), (jk, tk) = scene
    t = tct.dynamic_contact_force_with_wall(ta, tb, tnl["ab"], tk, 3,
                                            _Impact(), DX, 0.8 * DX)
    j = jct.dynamic_contact_force_with_wall(ja, jb, jnl["ab"], jk, 3,
                                            _Impact(), DX, 0.8 * DX)
    _close(t["ForcePrior"].numpy(), j["ForcePrior"], what="ForcePrior")
    assert not np.array_equal(t["ForcePrior"].numpy(), np.asarray(ja["ForcePrior"]))


def test_filter_self_contact_pairs_matches_jax(scene):
    (ja, _, jnl), (ta, _, tnl), (jk, tk) = scene
    cutoff = 1.5 * DX           # keeps the lattice's second shell and beyond
    t = tct.filter_self_contact_pairs(tnl["aa"], ta["InitialPosition"], cutoff)
    j = jct.filter_self_contact_pairs(jnl["aa"], ja["InitialPosition"], cutoff)
    np.testing.assert_array_equal(t.idx.numpy(), np.asarray(j.idx))
    np.testing.assert_array_equal(t.count.numpy(), np.asarray(j.count))
    assert t.count.dtype == torch.int32
    assert 0 < int(t.count.sum()) < int(tnl["aa"].count.sum())


def test_pairwise_friction_matches_jax(scene):
    (ja, jb, jnl), (ta, tb, tnl), (jk, tk) = scene
    for eta in (10.0, 1e6):     # 1e6: the ball case's, saturated
        t = tct.pairwise_friction_from_wall(ta, tb, tnl["ab"], tk, 3, eta,
                                            torch.as_tensor(1e-3, dtype=torch.float64))
        j = jct.pairwise_friction_from_wall(ja, jb, jnl["ab"], jk, 3, eta,
                                            jnp.asarray(1e-3))
        _close(t["Velocity"].numpy(), j["Velocity"], what=f"eta={eta}")


@pytest.mark.parametrize("shell_spacing", [None, 0.8 * DX])
def test_shell_contact_factor_matches_jax(scene, shell_spacing):
    (ja, jb, jnl), (ta, tb, tnl), (jk, tk) = scene
    t = tct.shell_contact_factor(ta, tb, tnl["ab"], tk, 3, DX, shell_spacing)
    j = jct.shell_contact_factor(ja, jb, jnl["ab"], jk, 3, DX, shell_spacing)
    _close(t.numpy(), j, what="factor")
    assert float(t.max()) > 0.0


@pytest.mark.parametrize("dp", [0.05, 0.1, 0.0175])
def test_shell_calibration_in_float32_is_jax_compile_time(dp):
    """JAX forms the offset and calibration in the state's dtype under
    ensure_compile_time_eval (contact.py:227-234); the port forms them in
    that dtype on the host: float32 values within a few float32 ulps of
    JAX's (XLA evaluates the kernel polynomial in another order, 1 ulp
    apart), not the float64 values rounded."""
    jk = JAdaptation(spacing=dp, dim=3).kernel
    with jax.ensure_compile_time_eval():
        f32 = jnp.float32
        offset = jk.W(jnp.asarray(dp, f32), 3)
        cmax = jnp.zeros((), f32)
        for gp, gw in zip(jct.GAUSS_3_POINTS, jct.GAUSS_3_WEIGHTS):
            t = gp * dp * 0.5 + dp * 0.5
            c = 2.0 * (jk.W(jnp.asarray(t, f32), 3) - offset) * dp * 0.5 * gw
            cmax = (cmax + c * np.pi * t).astype(f32)
        calib = (1.0 / (cmax + jct.TINY)).astype(f32)
    kernel = SPHAdaptation(spacing=dp, dim=3).kernel
    got = tct.shell_calibration(kernel, 3, dp, torch.float32)
    f64 = tct.shell_calibration(kernel, 3, dp, torch.float64)
    for g, j, d in zip(got, (float(offset), float(calib)), f64):
        assert float(np.float32(g)) == g           # a float32 value
        assert abs(g - j) <= 1e-6 * abs(j)
        assert abs(d - j) <= 1e-5 * abs(j)
    assert got != f64


def test_shell_contact_factor_monotone_in_penetration():
    """A solid particle approaching a flat shell sheet: the factor is zero
    beyond one spacing and grows monotonically as it approaches (the JAX
    package's test, tests/test_ball_shell_collision.py)."""
    dx = 0.1
    ad = SPHAdaptation(spacing=dx, dim=3)
    xs = np.arange(-0.6, 0.6 + dx / 2, dx)
    X, Z = np.meshgrid(xs, xs, indexing="ij")
    pos_sh = np.stack([X.ravel(), np.zeros(X.size), Z.ravel()], -1)
    shell = make_solid_state(pos_sh, dx * dx, 1e3, torch.float32, "cpu")
    grid = grid_from_bounds((-1, -1, -1), (1, 1, 1), ad.cutoff)
    table = build_cell_table(shell["Position"], shell["NReal"], grid, 32)

    def factor_at(d):
        solid = make_solid_state(np.asarray([[0.0, d, 0.0]]), dx ** 3, 1e3,
                                 torch.float32, "cpu")
        nl = build_neighbor_list(solid["Position"], solid["NReal"],
                                 shell["Position"], shell["NReal"], table,
                                 grid, ad.cutoff, k_max=64, include_self=True)
        return float(tct.shell_contact_factor(solid, shell, nl, ad.kernel, 3,
                                              dx)[0])

    f = [factor_at(d) for d in (1.2 * dx, dx, 0.75 * dx, 0.5 * dx, 0.25 * dx)]
    assert f[0] == 0.0          # outside the corrected support
    assert f[1] < 1e-9          # touches exactly at the offset
    assert 0 < f[2] < f[3] < f[4]
    assert f[4] < 0.2           # the heuristic limiter keeps it small


def test_cylinder_shell_matches_jax():
    j = jbs.make_cylinder_shell(0.05, jnp.float64)
    t = tbs.make_cylinder_shell(0.05, torch.float64, device="cpu")
    assert t["NReal"] == int(j["NReal"]) == 6120
    for k in ("Position", "NormalDirection", "VolumetricMeasure", "Mass"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]), err_msg=k)


@pytest.mark.parametrize("t_end", [0.25, 2.0])
def test_ball_shell_matches_jax(t_end):
    jcase, jball = jbs.build_case(dx=0.1, dtype=jnp.float64)
    js = jbs.make_run_chunk(jcase)(jbs.init_sim(jcase, jball),
                                   jnp.asarray(t_end, jnp.float64))
    tcase, tball = tbs.build_case(dx=0.1, dtype=torch.float64, device="cpu")
    assert tcase.n_ball == jcase.n_ball == 552
    ts = tbs.make_run_chunk(tcase)(tbs.init_sim(tcase, tball), t_end)
    assert ts.n_steps == int(js.n_steps) and ts.n_steps >= 30
    assert not bool(ts.overflow) and not bool(js.overflow)
    assert float(ts.time) == pytest.approx(float(js.time), rel=1e-12)
    _close(ts.ball["Position"].numpy(), js.ball["Position"], tol=1e-10,
           what="Position")
    _close(ts.ball["Velocity"].numpy(), js.ball["Velocity"], tol=1e-8,
           what="Velocity")
    assert tbs.ball_center_z(ts) == pytest.approx(jbs.ball_center_z(js),
                                                  rel=1e-10)
    assert tbs.max_radial_extent(ts) == pytest.approx(
        jbs.max_radial_extent(js), rel=1e-10)


@pytest.mark.slow
def test_ball_shell_com_holds_golden_curve():
    case, ball = tbs.build_case(dx=0.05, device="cpu")
    assert (case.n_ball, case.shell["NReal"]) == (4224, 6120)
    s = tbs.init_sim(case, ball)
    run = tbs.make_run_chunk(case)

    def com_z(s):
        m = s.ball["Mass"].double()
        return float((m * s.ball["Position"][:, 2].double()).sum() / m.sum())

    zs, rmax = [com_z(s)], []
    for i in range(1, 21):
        s = run(s, i * 0.1)
        zs.append(com_z(s))
        rmax.append(tbs.max_radial_extent(s))
    assert s.n_steps == 631                      # the JAX run's count
    assert not bool(s.overflow)
    assert max(rmax) < 2.0 + case.dx / 2
    ok, report = DTWRegressionTest(GOLDEN, "BallBody", "CenterOfMassZ").test(
        np.asarray(zs))
    assert ok, report
