"""The port's shell modules against the JAX package on the CPU, on seeded
numpy inputs: physics/shell.py (the 2D and 3D frame algebra with the
singular edges of its TINY guards, the correction matrix, the corrected
Almansi strain, the state, both stress-relaxation halves, the time step,
the normal update), physics/solid_shell.py (the frozen tie pairs and
both mappings) and core/surface_cvt.py (the projectors, the CVT sweeps
and the generator's own gates).  float64 at 1e-12 of each output's max,
float32 at 2e-5."""

import math
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sphinxsys_tpu.core import surface_cvt as jcvt
from sphinxsys_tpu.physics import shell as jsh
from sphinxsys_tpu.physics import solid_shell as jss

from sphinxsys_tpu_torch import convert
from sphinxsys_tpu_torch.core import surface_cvt as tcvt
from sphinxsys_tpu_torch.physics import shell as tsh
from sphinxsys_tpu_torch.physics import solid_shell as tss

torch.set_num_threads(1)

TOL = {torch.float64: 1e-12, torch.float32: 2e-5}
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}
DTYPES = (torch.float64, torch.float32)


def close(got, ref, tol, what=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    assert np.isfinite(got).all(), what
    err = np.abs(got - ref).max(initial=0.0)
    assert err <= tol * max(np.abs(ref).max(initial=0.0), 1e-300), \
        (what, err, np.abs(ref).max(initial=0.0))


def both(a, dtype):
    """A numpy array as a JAX array and a CPU tensor of `dtype`."""
    return jnp.asarray(a, JDT[dtype]), torch.as_tensor(a, dtype=dtype)


def unit(rng, n, d):
    v = rng.standard_normal((n, d))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


# ---------------------------------------------------------------------------
# the frame algebra
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dim", [2, 3])
def test_frame_algebra_matches_jax(dim, dtype):
    rng = np.random.default_rng(dim)
    n = unit(rng, 16, dim)
    rot = rng.uniform(-1.0, 1.0, (16, dim))
    w = rng.uniform(-3.0, 3.0, (16, dim))
    a = rng.standard_normal((16, dim))
    tol = TOL[dtype]
    jn, tn = both(n, dtype)
    jr, tr = both(rot, dtype)
    jw, tw = both(w, dtype)
    ja, ta = both(a, dtype)
    close(tsh.transformation_matrix(tn, dim),
          jsh.transformation_matrix(jn, dim), tol, "Q")
    close(tsh.rotate_pseudo_normal(tr, dim),
          jsh.rotate_pseudo_normal(jr, dim), tol, "n")
    close(tsh.pseudo_normal_rate(tr, tw, dim),
          jsh.pseudo_normal_rate(jr, jw, dim), tol, "dn")
    close(tsh.rotation_accel_from_pseudo_normal(ta, tr, tw, dim),
          jsh.rotation_accel_from_pseudo_normal(ja, jr, jw, dim), tol,
          "domega")


@pytest.mark.parametrize("nz", [-1.0, -1.0 + 1e-9, 1.0])
def test_transformation_3d_singular_normal(nz):
    """n = (0, 0, -1) and its neighbourhood: (1 + n_z)^2 + TINY keeps the
    map finite, the port's values are JAX's."""
    nx = math.sqrt(max(0.0, 1.0 - nz * nz))
    n = np.asarray([[0.0, 0.0, nz], [nx, 0.0, nz], [0.0, nx, nz]])
    jn, tn = both(n, torch.float64)
    got = tsh.transformation_matrix_3d(tn)
    close(got, jsh.transformation_matrix_3d(jn), 1e-12, nz)
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("scale", [0.0, 1e-12, 1e-6])
def test_rotation_accel_3d_small_angles(scale):
    """At zero and small angles and rates the TINY guard of
    r1b1^2 + r1b2^2 decides acc1: held to JAX's."""
    rng = np.random.default_rng(7)
    rot = scale * rng.standard_normal((12, 3))
    w = scale * rng.standard_normal((12, 3))
    a = scale * rng.standard_normal((12, 3))
    a[:3] = 0.0
    got = tsh.rotation_accel_from_pseudo_normal_3d(
        *(torch.as_tensor(x) for x in (a, rot, w)))
    ref = jsh.rotation_accel_from_pseudo_normal_3d(
        *(jnp.asarray(x) for x in (a, rot, w)))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-300)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dim", [2, 3])
def test_correction_matrix_and_strain_match_jax(dim, dtype):
    rng = np.random.default_rng(10 + dim)
    A = np.eye(dim) + 0.3 * rng.standard_normal((9, dim, dim))
    ja, ta = both(A, dtype)
    close(tsh.correction_matrix(ta, dim), jsh.correction_matrix(ja, dim),
          TOL[dtype], "B")
    close(tsh.corrected_almansi_strain(ta, 0.3, dim),
          jsh.corrected_almansi_strain(ja, 0.3, dim), TOL[dtype], "eps")


# ---------------------------------------------------------------------------
# the state and the stress relaxation
# ---------------------------------------------------------------------------

MATERIAL = dict(rho0=1.0e3, youngs_modulus=2.0e6, poisson_ratio=0.3)


def strip(dim):
    """A curved strip of shell particles (a quarter arc in 2D, a patch of a
    cylinder in 3D): positions, outward normals, the spacing."""
    dx = 0.05
    th = np.arange(12) * dx / 0.6
    if dim == 2:
        return (0.6 * np.stack([np.cos(th), np.sin(th)], -1),
                np.stack([np.cos(th), np.sin(th)], -1), dx)
    T, Y = np.meshgrid(th[:8], np.arange(5) * dx, indexing="ij")
    pos = np.stack([0.6 * np.cos(T), Y, 0.6 * np.sin(T)], -1).reshape(-1, 3)
    nrm = np.stack([np.cos(T), np.zeros_like(T), np.sin(T)],
                   -1).reshape(-1, 3)
    return pos, nrm, dx


def shells(dim, dtype):
    """Both packages' shell states on `strip(dim)`, their frozen pairs and
    B, then the same seeded perturbation of every evolving field."""
    from sphinxsys_tpu.core.adaptation import SPHAdaptation as JA
    from sphinxsys_tpu.core.materials import SaintVenantKirchhoffSolid as JM
    from sphinxsys_tpu.physics import solid as jsd

    from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation as TA
    from sphinxsys_tpu_torch.core.materials import \
        SaintVenantKirchhoffSolid as TM
    from sphinxsys_tpu_torch.neighbors.neighbor_list import NeighborList
    from sphinxsys_tpu_torch.physics import solid as tsd

    pos, nrm, dx = strip(dim)
    jmat, tmat = JM(**MATERIAL), TM(**MATERIAL)
    js = jsh.make_shell_state(pos, nrm, dx, 0.02, jmat, dtype=JDT[dtype])
    ts = tsh.make_shell_state(pos, nrm, dx, 0.02, tmat, dtype, "cpu")
    # a brute-force list, sentinel n, the same on both sides
    n = len(pos)
    cut = TA(spacing=dx, dim=dim).cutoff
    d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
    k = 32
    idx = np.full((n, k), n, np.int32)
    for i in range(n):
        j = [int(x) for x in np.nonzero((d[i] < cut) & (np.arange(n) != i))[0]]
        idx[i, :len(j)] = j
    count = (idx < n).sum(1).astype(np.int32)
    from sphinxsys_tpu.neighbors.neighbor_list import NeighborList as JNL

    jnl = JNL(idx=jnp.asarray(idx), count=jnp.asarray(count),
              overflow=jnp.asarray(False))
    tnl = NeighborList(idx=torch.as_tensor(idx), count=torch.as_tensor(count),
                       overflow=torch.tensor(False))
    jk = jsh.ReducedKernel(JA(spacing=dx, dim=dim).kernel)
    tk = tsh.ReducedKernel(TA(spacing=dx, dim=dim).kernel)
    jrp = jsd.freeze_reference_pairs(js["Position"], jnl, jk, dim)
    trp = tsd.freeze_reference_pairs(ts["Position"], tnl, tk, dim)
    js = jsh.shell_correct_configuration(js, jrp)
    ts = tsh.shell_correct_configuration(ts, trp)
    rng = np.random.default_rng(100 + dim)
    pert = {
        "Velocity": 0.1 * rng.standard_normal((n, dim)),
        "AngularVelocity": 2.0 * rng.standard_normal((n, dim)),
        "Rotation": 0.05 * rng.standard_normal((n, dim)),
        "DeformationGradient": np.eye(dim) + 0.01 * rng.standard_normal(
            (n, dim, dim)),
        "DeformationRate": 0.5 * rng.standard_normal((n, dim, dim)),
        "BendingDeformationGradient": 0.3 * rng.standard_normal(
            (n, dim, dim)),
        "BendingDeformationRate": 5.0 * rng.standard_normal((n, dim, dim)),
        "ForcePrior": 1e-3 * rng.standard_normal((n, dim)),
    }
    if dim == 3:
        for key in ("Rotation", "AngularVelocity"):
            pert[key][:, 2] = 0.0
    for key, v in pert.items():
        js[key], ts[key] = both(v, dtype)
    return js, ts, jrp, trp, jmat, tmat, dx


def hold(ts, js, tol, what):
    for key, v in js.items():
        if key != "NReal":
            close(ts[key], v, tol, (what, key))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dim", [2, 3])
def test_shell_state_and_correction_match_jax(dim, dtype):
    js, ts, jrp, trp, *_ = shells(dim, dtype)
    assert ts["NReal"] == int(js["NReal"])
    assert set(js) <= set(ts)
    for k in ("W", "dW", "r", "e"):
        close(getattr(trp, k), getattr(jrp, k), TOL[dtype], k)
    hold(ts, js, TOL[dtype], "state")


def relax_both(dim, dtype):
    """Both halves from the same perturbed state on each side (the port's
    second half from JAX's first), then the time step and the normal: the
    JAX results and the port's."""
    js, ts, jrp, trp, jmat, tmat, dx = shells(dim, dtype)
    h = 1.3 * dx
    dt = 1e-5
    j1 = jax.jit(lambda s: jsh.shell_stress_relaxation_1st_half(
        s, jrp, jmat, dt, h))(js)
    t1 = tsh.shell_stress_relaxation_1st_half(ts, trp, tmat, dt, h)
    j2 = jax.jit(lambda s: jsh.shell_stress_relaxation_2nd_half(
        s, jrp, dt))(j1)
    t2 = tsh.shell_stress_relaxation_2nd_half(
        convert.state_from_numpy({k: np.asarray(v) for k, v in j1.items()}),
        trp, dt)
    jx = {"dt": jsh.shell_acoustic_time_step(j2, jmat, h),
          "n": jsh.update_shell_normal(j2)["NormalDirection"]}
    tx = {"dt": tsh.shell_acoustic_time_step(t2, tmat, h),
          "n": tsh.update_shell_normal(t2)["NormalDirection"]}
    return (j1, j2, jx), (t1, t2, tx)


def float32_tolerance(ref32, ref64):
    """2e-5, or twice the JAX package's own float32 error against its
    float64 on the same inputs where that is larger (the through-thickness
    moment, a difference of the Gauss points' stresses: ROADMAP C)."""
    ref64 = np.asarray(ref64, np.float64)
    own = np.abs(np.asarray(ref32, np.float64) - ref64).max(initial=0.0) \
        / max(np.abs(ref64).max(initial=0.0), 1e-300)
    return max(TOL[torch.float32], 2.0 * own)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dim", [2, 3])
def test_stress_relaxation_halves_match_jax(dim, dtype):
    """Both halves, the time step and the normal update; float32 against
    `float32_tolerance` of JAX's float64 run of the same inputs."""
    jr, tr = relax_both(dim, dtype)
    ref64 = relax_both(dim, torch.float64)[0] if dtype == torch.float32 \
        else jr
    for j, t, r, what in zip(jr, tr, ref64, ("1st half", "2nd half", "")):
        for key, v in j.items():
            if key == "NReal":
                continue
            tol = TOL[dtype] if dtype == torch.float64 \
                else float32_tolerance(v, r[key])
            close(t[key], v, tol, (what, key))


def test_fix_shell_clamps():
    _, ts, *_ = shells(2, torch.float64)
    mask = torch.arange(ts["Position"].shape[0]) < 3
    moved = dict(ts, Position=ts["Position"] + 1.0)
    out = tsh.fix_shell(moved, mask)
    assert torch.equal(out["Position"][:3], ts["InitialPosition"][:3])
    assert torch.equal(out["Position"][3:], moved["Position"][3:])
    for k in ("Velocity", "Rotation", "AngularVelocity"):
        assert not bool(out[k][:3].any()) and torch.equal(out[k][3:],
                                                          ts[k][3:])


# ---------------------------------------------------------------------------
# the solid-shell tie coupling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_coupling_pairs_and_mappings_match_jax(dtype):
    """The coupling case's frozen tie pairs at a coarse width, then both
    mappings of seeded fields (vector and scalar), with and without the
    part mask."""
    from sphinxsys_tpu.cases import solid_shell_coupling_3d as jm
    from sphinxsys_tpu_torch.cases import solid_shell_coupling_3d as tm

    jc, _ = jm.build_case(dx=0.25, dtype=JDT[dtype])
    tc, _ = tm.build_case(dx=0.25, dtype=dtype, device="cpu")
    tol = TOL[dtype]
    for cp in ("cp_shell", "cp_cube"):
        j, t = getattr(jc, cp), getattr(tc, cp)
        np.testing.assert_array_equal(t.idx.numpy(), np.asarray(j.idx))
        for k in ("W", "mask", "vol_j", "total_weight"):
            close(getattr(t, k), getattr(j, k), tol, (cp, k))
    rng = np.random.default_rng(3)
    vel = rng.standard_normal((tc.n_cube, 3))
    cur = rng.standard_normal((tc.n_shell, 3))
    force = rng.standard_normal((tc.n_shell, 3))
    scal = rng.standard_normal(tc.n_cube)
    for part in (None, "tied"):
        jp = None if part is None else jc.shell_tied_part
        tp = None if part is None else tc.shell_tied_part
        close(tss.consistent_mapping(tc.cp_shell, *(both(x, dtype)[1]
                                                    for x in (vel, cur)),
                                     part_mask=tp),
              jss.consistent_mapping(jc.cp_shell, *(both(x, dtype)[0]
                                                    for x in (vel, cur)),
                                     part_mask=jp), tol, ("consistent", part))
    close(tss.consistent_mapping(tc.cp_shell, both(scal, dtype)[1],
                                 both(cur[:, 0], dtype)[1]),
          jss.consistent_mapping(jc.cp_shell, both(scal, dtype)[0],
                                 both(cur[:, 0], dtype)[0]), tol, "scalar")
    vol = rng.uniform(0.5, 1.5, tc.n_cube)
    for data in (force, force[:, 0]):
        close(tss.conservative_mapping(tc.cp_cube, both(vol, dtype)[1],
                                       tc.cp_shell.total_weight,
                                       both(data, dtype)[1]),
              jss.conservative_mapping(jc.cp_cube, both(vol, dtype)[0],
                                       jc.cp_shell.total_weight,
                                       both(data, dtype)[0]), tol,
              "conservative")


def test_conservative_mapping_keeps_the_total():
    """The cube's mapped force sums to the tied shell force (the Shepard
    weights of each shell row over the cube sum to its total weight)."""
    from sphinxsys_tpu_torch.cases import solid_shell_coupling_3d as tm

    tc, s = tm.build_case(dx=0.25, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(5)
    force = torch.as_tensor(rng.standard_normal((tc.n_shell, 3)))
    tied = tc.cp_shell.total_weight > 1e-15
    got = tss.conservative_mapping(tc.cp_cube, s.cube["VolumetricMeasure"],
                                   tc.cp_shell.total_weight, force)
    np.testing.assert_allclose(got.sum(0).numpy(),
                               force[tied].sum(0).numpy(), rtol=1e-10)


# ---------------------------------------------------------------------------
# the surface CVT
# ---------------------------------------------------------------------------

def test_projectors_match_jax():
    rng = np.random.default_rng(11)
    p = 3.0 * rng.standard_normal((20, 3))
    p[:4, 2] = -np.abs(p[:4, 2])
    for j, t in ((jcvt.sphere_projector(2.0, hemisphere=True),
                  tcvt.sphere_projector(2.0, hemisphere=True)),
                 (jcvt.sphere_projector(2.0), tcvt.sphere_projector(2.0)),
                 (jcvt.cylinder_projector(1.5, axis=1),
                  tcvt.cylinder_projector(1.5, axis=1))):
        jp, jn = j(jnp.asarray(p))
        tp, tn = t(torch.as_tensor(p))
        close(tp, jp, 1e-12)
        close(tn, jn, 1e-12)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cvt_sweeps_match_jax(dtype):
    """40 sweeps of 120 hemisphere points at JAX's dtype: positions and
    normals held to JAX's (float64 at 1e-12, float32 at 2e-5)."""
    R, dp = 10.0, 1.6
    seeds = jcvt.fibonacci_sphere(120, R, hemisphere=True)
    np.testing.assert_array_equal(tcvt.fibonacci_sphere(120, R, True), seeds)
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", dtype == torch.float64)
    try:
        jp, jn = jcvt.cvt_relax_on_surface(
            seeds, jcvt.sphere_projector(R, hemisphere=True), dp, n_iter=40)
    finally:
        jax.config.update("jax_enable_x64", prev)
    tp, tn = tcvt.cvt_relax_on_surface(
        seeds, tcvt.sphere_projector(R, hemisphere=True), dp, n_iter=40,
        dtype=dtype, device="cpu")
    assert tp.dtype == np.dtype(str(dtype).split(".")[1])
    close(tp, jp, TOL[dtype], "pos")
    close(tn, jn, TOL[dtype], "normal")


def test_cvt_generator_gates():
    """The reference's initialisation gates (cpp:196-226), as the JAX
    package's test holds them, at a smaller radius: the minimum pair
    distance above dp / 2, the points on the surface with outward
    normals, none below the equator, and the areas summing to the
    total."""
    R, dp = 12.0, 2.0
    area = 0.5 * 4 * math.pi * R * R
    n = int(round(area / dp ** 2))
    pos, normals = tcvt.cvt_relax_on_surface(
        tcvt.fibonacci_sphere(n, R, hemisphere=True),
        tcvt.sphere_projector(R, hemisphere=True), dp, n_iter=60,
        device="cpu")
    assert tcvt.min_pair_distance(pos) > dp / 2
    assert np.abs(np.linalg.norm(pos, axis=1) - R).max() < 1e-6 * R
    assert (np.sum(pos * normals, axis=1) > 0).all()
    assert pos[:, 2].min() >= 0.0
    assert abs(n * (area / n) - area) < 1e-9 * area
    assert tcvt.min_pair_distance(pos) == pytest.approx(
        jcvt.min_pair_distance(pos))


def test_shell_state_takes_a_volume():
    """`volume` replaces the lattice measure; the mass carries the
    thickness."""
    pos = np.random.default_rng(1).standard_normal((6, 3))
    nrm = pos / np.linalg.norm(pos, axis=1, keepdims=True)
    mat = types.SimpleNamespace(rho0=2.0)
    ts = tsh.make_shell_state(pos, nrm, 0.5, 0.1, mat, torch.float64, "cpu",
                              volume=0.3)
    js = jsh.make_shell_state(pos, nrm, 0.5, 0.1, mat, dtype=jnp.float64,
                              volume=0.3)
    hold(ts, js, 1e-12, "volume")
    close(ts["Mass"], np.full(6, 2.0 * 0.3 * 0.1), 1e-15)
