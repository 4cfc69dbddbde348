"""Parity of the port's image geometry (core/image.py) and porous-media
solid (physics/porous.py) with the JAX package's, on the CPU in float64,
and the JAX tests they mirror:

  * tests/test_image_shape.py: the MetaImage round trip (the port reads
    JAX's files and JAX reads the port's, byte for byte), the trilinear
    SDF and its normals (0.05 of the exact sphere's distance, normals
    radial within 1e-2), the fallback off the lattice, and the lattice
    generated from the image (its volume within 5% of the sphere's).
    Port against JAX: the SDF and the normals within 1e-12 of max|.|.
  * tests/test_porous.py:40,63: the saturation diffusion conserves the
    fluid mass (1e-5) and spreads; a uniform saturation swells the block
    (J - 1 within 0.3x-3x of k_w s / (lambda + G), the centre fixed to
    1e-6).  Port against JAX: every field after 20 saturation steps and
    after 20 stress steps within 1e-12 of max|.| (the pore pressure and
    the stress are float64 sums of a few terms a pair)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sphinxsys_tpu.core import image as JI
from sphinxsys_tpu.core.adaptation import SPHAdaptation as JAdaptation
from sphinxsys_tpu.neighbors import (build_cell_table as j_table,
                                     build_neighbor_list as j_list,
                                     grid_from_bounds as j_grid)
from sphinxsys_tpu.physics import porous as jpm
from sphinxsys_tpu.physics import solid as jsd
from sphinxsys_tpu_torch import convert
from sphinxsys_tpu_torch.core import image as TI
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation as TAdaptation
from sphinxsys_tpu_torch.core.generators import generate_lattice
from sphinxsys_tpu_torch.neighbors.cell_list import (
    build_cell_table as t_table, grid_from_bounds as t_grid)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (
    build_neighbor_list as t_list)
from sphinxsys_tpu_torch.physics import porous as tpm
from sphinxsys_tpu_torch.physics import solid as tsd

torch.set_num_threads(1)
RADIUS = 20.0
TOL = 1e-12


def close(got, ref, tol=TOL, what=""):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    scale = max(float(np.abs(ref).max()), 1e-300)
    assert float(np.abs(got - ref).max()) <= tol * scale, what


# ---------------------------------------------------------------------------
# the image shape
# ---------------------------------------------------------------------------

def test_mhd_roundtrip_both_ways(tmp_path):
    img = TI.sphere_distance_image(radius=RADIUS)
    TI.save_mhd(str(tmp_path / "port.mhd"), img)
    JI.save_mhd(str(tmp_path / "jax.mhd"), JI.sphere_distance_image(radius=RADIUS))
    for name in ("port", "jax"):
        back = TI.load_mhd(str(tmp_path / f"{name}.mhd"))
        np.testing.assert_array_equal(back.data, img.data)
        assert back.spacing == img.spacing and back.origin == img.origin
    assert (tmp_path / "port.raw").read_bytes() == (tmp_path / "jax.raw").read_bytes()
    assert (tmp_path / "port.mhd").read_text() == \
        (tmp_path / "jax.mhd").read_text().replace("jax.raw", "port.raw")
    jb = JI.load_mhd(str(tmp_path / "port.mhd"))
    np.testing.assert_array_equal(np.asarray(jb.data), img.data)


def test_trilinear_sdf_and_normals_match_jax():
    timg = TI.sphere_distance_image(radius=RADIUS)
    jimg = JI.sphere_distance_image(radius=RADIUS)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-24.0, 24.0, (500, 3))
    sd = timg.signed_distance(torch.as_tensor(pts))
    close(sd, jimg.signed_distance(jnp.asarray(pts)), what="sdf")
    exact = np.linalg.norm(pts, axis=1) - RADIUS
    assert np.abs(sd.numpy() - exact).max() < 0.05

    surf = pts / np.linalg.norm(pts, axis=1, keepdims=True) * RADIUS
    n = timg.find_normal_direction(torch.as_tensor(surf))
    close(n, jimg.find_normal_direction(jnp.asarray(surf)), what="normals")
    assert np.abs(np.sum(n.numpy() * surf / RADIUS, axis=1) - 1.0).max() < 1e-2

    far = np.array([[40.0, 0.0, 0.0], [80.0, 0.0, 0.0], [0.0, -70.0, 30.0]])
    sd_far = timg.signed_distance(torch.as_tensor(far))
    close(sd_far, jimg.signed_distance(jnp.asarray(far)), what="far")
    assert 0 < sd_far[0] < sd_far[1]


def test_image_from_numpy_carries_jax_image():
    jimg = JI.sphere_distance_image(radius=RADIUS, shape=(20, 24, 28),
                                    spacing=(2.0, 2.0, 1.5))
    timg = convert.image_from_numpy(jimg)
    np.testing.assert_array_equal(timg.data, np.asarray(jimg.data))
    assert timg.spacing == jimg.spacing and timg.origin == jimg.origin
    pts = np.random.default_rng(3).uniform(-20.0, 20.0, (50, 3))
    close(timg.signed_distance(torch.as_tensor(pts)),
          jimg.signed_distance(jnp.asarray(pts)), what="carried sdf")


def test_lattice_generation_from_image():
    img = TI.sphere_distance_image(radius=RADIUS)
    dx = 2.0
    pos, vol = generate_lattice(img, (-24.0,) * 3, (24.0,) * 3, dx)
    v_exact = 4.0 / 3.0 * np.pi * RADIUS ** 3
    assert abs(len(pos) * vol - v_exact) / v_exact < 0.05
    assert np.linalg.norm(pos, axis=1).max() < RADIUS + dx


# ---------------------------------------------------------------------------
# the porous solid
# ---------------------------------------------------------------------------

MAT = dict(rho0=2.0, youngs_modulus=8.242e6, poisson_ratio=0.26316,
           diffusivity_constant=1.0e-4, fluid_initial_density=1.0,
           water_pressure_constant=3.0e6)


def _block(nx, ny, dx=0.05):
    """tests/test_porous.py's block in both packages: (JAX state, frozen
    pairs), (port state, frozen pairs), materials, h, positions."""
    xs, ys = (np.arange(nx) + 0.5) * dx, (np.arange(ny) + 0.5) * dx
    pos = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    n = len(pos)
    jmat, tmat = jpm.PorousMediaSolid(**MAT), tpm.PorousMediaSolid(**MAT)
    jad, tad = JAdaptation(spacing=dx, dim=2), TAdaptation(spacing=dx, dim=2)
    bounds = ((-0.2, -0.2), (nx * dx + 0.2, ny * dx + 0.2))
    jg, tg = j_grid(*bounds, jad.cutoff), t_grid(*bounds, tad.cutoff)

    js = jpm.make_porous_state(pos, dx * dx, jmat, dtype=jnp.float64)
    jp = js["Position"]
    jnl = j_list(jp, jnp.int32(n), jp, jnp.int32(n),
                 j_table(jp, jnp.int32(n), jg, cap=24), jg, jad.cutoff,
                 k_max=32, include_self=False)
    jrp = jsd.freeze_reference_pairs(jp, jnl, jad.kernel, 2)
    js["LinearGradientCorrectionMatrix"] = jsd.linear_gradient_correction_matrix(
        jrp, js["VolumetricMeasure"])

    ts = tpm.make_porous_state(pos, dx * dx, tmat, torch.float64, "cpu")
    tp = ts["Position"]
    tnl = t_list(tp, n, tp, n, t_table(tp, n, tg, 24), tg, tad.cutoff,
                 k_max=32, include_self=False)
    np.testing.assert_array_equal(tnl.idx.numpy(), np.asarray(jnl.idx))
    trp = tsd.freeze_reference_pairs(tp, tnl, tad.kernel, 2)
    ts["LinearGradientCorrectionMatrix"] = tsd.linear_gradient_correction_matrix(
        trp, ts["VolumetricMeasure"])
    assert set(ts) == set(js)
    return (js, jrp, jmat), (ts, trp, tmat), tad, pos


def _hold(ts, js, what):
    for k in ts:
        if k != "NReal":
            close(ts[k], js[k], what=f"{what} {k}")


def test_saturation_diffusion_matches_jax_conserves_and_spreads():
    (js, jrp, jmat), (ts, trp, tmat), ad, pos = _block(20, 8)
    mid = (pos[:, 0] > 0.3) & (pos[:, 0] < 0.7)
    js = jpm.set_initial_saturation(js, jnp.asarray(mid), 0.4, jmat)
    ts = tpm.set_initial_saturation(ts, torch.as_tensor(mid), 0.4, tmat)
    _hold(ts, js, "initial")
    Dt = tpm.saturation_time_step(tmat, ad.h, 2)
    assert Dt == jpm.saturation_time_step(jmat, ad.h, 2) > 0
    m0 = float(ts["FluidMass"].sum())
    for i in range(400):
        ts = tpm.saturation_relaxation(ts, trp, tmat, torch.tensor(Dt,
                                       dtype=torch.float64))
        if i < 20:
            js = jpm.saturation_relaxation(js, jrp, jmat, jnp.asarray(Dt))
        if i == 19:
            _hold(ts, js, "20 saturation steps")
    sat = ts["FluidSaturation"].numpy()
    np.testing.assert_allclose(float(ts["FluidMass"].sum()), m0, rtol=1e-5)
    assert sat.max() < 0.4 - 1e-3
    assert sat[~mid].max() > 1e-4
    assert sat.min() > -1e-6


def test_uniform_saturation_swells_block_matches_jax():
    (js, jrp, jmat), (ts, trp, tmat), ad, pos = _block(12, 12)
    sat0 = 0.05
    every = np.ones(len(pos), bool)
    js = jpm.set_initial_saturation(js, jnp.asarray(every), sat0, jmat)
    ts = tpm.set_initial_saturation(ts, torch.as_tensor(every), sat0, tmat)
    h, w0 = ad.h, ad.kernel.w0(2)
    dt = 0.1 * h / tmat.sound_speed
    tdt = torch.tensor(dt, dtype=torch.float64)
    com0 = pos.mean(0)
    Js = []
    for i in range(1500):
        ts = tpm.porous_stress_relaxation_1st_half(ts, trp, tmat, tdt, h, w0)
        ts = tpm.porous_stress_relaxation_2nd_half(ts, trp, tmat, tdt)
        if i < 20:
            js = jpm.porous_stress_relaxation_1st_half(js, jrp, jmat,
                                                       jnp.asarray(dt), h, w0)
            js = jpm.porous_stress_relaxation_2nd_half(js, jrp, jmat,
                                                       jnp.asarray(dt))
        if i == 19:
            _hold(ts, js, "20 stress steps")
        if i % 300 == 299:
            Js.append(float(torch.linalg.det(ts["DeformationGradient"]).mean()))
    assert np.isfinite(Js).all()
    assert Js[-1] > 1.005
    expect = tmat.water_pressure_constant * sat0 / (tmat.lambda0
                                                    + tmat.shear_modulus)
    assert 0.3 * expect < Js[-1] - 1.0 < 3.0 * expect
    np.testing.assert_allclose(ts["Position"].numpy().mean(0), com0, atol=1e-6)


def test_momentum_constraint_and_state_from_numpy():
    """porous_momentum_constraint against JAX's; the porous state carried
    across by convert.state_from_numpy equals the port's own build."""
    (js, _, jmat), (ts, _, tmat), _, pos = _block(20, 8)
    rng = np.random.default_rng(1)
    mom = rng.normal(size=(len(pos), 2))
    part = pos[:, 0] < 0.1
    js = jpm.porous_momentum_constraint(dict(js, TotalMomentum=jnp.asarray(mom)),
                                        jnp.asarray(part))
    ts = tpm.porous_momentum_constraint(dict(ts, TotalMomentum=torch.as_tensor(mom)),
                                        torch.as_tensor(part))
    np.testing.assert_array_equal(ts["TotalMomentum"].numpy(),
                                  np.asarray(js["TotalMomentum"]))
    carried = convert.state_from_numpy({k: np.asarray(v) for k, v in js.items()})
    assert set(carried) == set(ts)
    _hold(ts, carried, "carried")
