"""Parity of the port's level set (meshes/levelset.py), triangle mesh
(core/trimesh.py), the rest of core/generators.py and the kernels' d2W
with the JAX package on the CPU, in float64.

* a 2D polygon and a 3D ball: the integer tables (coarse_map, pkg_coord,
  pkg_nbr, the far sentinels) equal, phi, the probes (SDF, normal, the W,
  grad W and d2W e e^T integrals) at random points in and around the
  domain, 30 reinitialisation sweeps and clean_interface within 1e-12 of
  max |JAX|; the probes also from JAX's own field carried across
  (convert.levelset_from_jax);
* an icosphere and a brick through trimesh: the meshes equal, the STL
  reader (binary and ascii) equal, the signed distance, and the level
  set built from the icosphere;
* generate_surface_lattice's particles exact (numpy's generator in
  both), its normals, consistent_shell_normals, generate_observers.
"""

import functools
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sphinxsys_tpu.core import generators as jgen
from sphinxsys_tpu.core import geometry as JG
from sphinxsys_tpu.core import kernels as jk
from sphinxsys_tpu.core import trimesh as jtm
from sphinxsys_tpu.meshes import levelset as jls
from sphinxsys_tpu_torch import convert
from sphinxsys_tpu_torch.core import generators as tgen
from sphinxsys_tpu_torch.core import geometry as TG
from sphinxsys_tpu_torch.core import kernels as tk
from sphinxsys_tpu_torch.core import trimesh as ttm
from sphinxsys_tpu_torch.meshes import levelset as tls

torch.set_num_threads(1)

TOL = 1e-12
POLY = ((0.1, 0.2), (1.3, 0.15), (1.1, 0.9), (0.5, 1.2), (0.2, 0.8))
# shape, domain, spacing of each field
FIELDS = {
    "polygon": (lambda G: G.Polygon(vertices=POLY), (-0.3, -0.3), (1.7, 1.6),
                0.05),
    "ball": (lambda G: G.Ball(center=(0.1, 0.0, -0.1), radius=0.45),
             (-0.6, -0.6, -0.7), (0.7, 0.6, 0.5), 0.1),
    "icosphere": (lambda G: (jtm if G is JG else ttm).icosphere_mesh(
        radius=0.4, subdivisions=1), (-0.6,) * 3, (0.6,) * 3, 0.1),
}


def close(got, ref, tol=TOL, what=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max(initial=0.0)
    assert err <= tol * max(np.abs(ref).max(initial=0.0), 1e-300), (what,
                                                                      err)


@functools.lru_cache(maxsize=None)
def fields(name):
    """(JAX level set with kernel integrals, the port's built alike,
    query points)."""
    make, lo, hi, dx = FIELDS[name]
    h = 1.3 * dx
    j = jls.build_levelset(make(JG), lo, hi, dx, dtype=jnp.float64) \
        .update_kernel_integrals(jk.WendlandC2(h=h), len(lo))
    t = tls.build_levelset(make(TG), lo, hi, dx, dtype=torch.float64,
                           device="cpu") \
        .update_kernel_integrals(tk.WendlandC2(h=h), len(lo))
    rng = np.random.default_rng(len(name))
    pts = rng.uniform(np.asarray(lo) - 0.1, np.asarray(hi) + 0.1,
                      (200, len(lo)))
    return j, t, pts


@pytest.mark.parametrize("name", list(FIELDS))
def test_tables_are_jax_s(name):
    j, t, _ = fields(name)
    assert t.n_pkg == tuple(j.n_pkg) and t.spacing == j.spacing
    for k in ("coarse_map", "pkg_coord", "pkg_nbr"):
        np.testing.assert_array_equal(getattr(t, k).numpy(),
                                      np.asarray(getattr(j, k)), k)
    P = t.n_inner
    assert P == j.n_inner and P > 0
    # the far sentinels: every unoccupied coarse cell maps to P or P + 1
    cm = t.coarse_map.numpy()
    assert set(np.unique(cm[cm >= P])) <= {P, P + 1}
    close(t.phi, j.phi, what="phi")
    np.testing.assert_array_equal(t.phi[P:].numpy(), np.asarray(j.phi[P:]))


PROBES = ("probe_signed_distance", "probe_normal_direction",
          "probe_kernel_integral", "probe_kernel_gradient_integral",
          "probe_kernel_second_gradient_integral")


@pytest.mark.parametrize("name", list(FIELDS))
@pytest.mark.parametrize("carried", (False, True), ids=("built", "carried"))
def test_probes_match_jax(name, carried):
    """Each probe at 200 random points (outside the domain too, where the
    package index clamps); `carried`: on JAX's own field."""
    j, t, pts = fields(name)
    if carried:
        t = convert.levelset_from_jax(j)
    jp, tp = jnp.asarray(pts), torch.as_tensor(pts)
    for probe in PROBES:
        ref = jax.jit(getattr(j, probe))(jp)
        close(getattr(t, probe)(tp), ref, what=probe)


@pytest.mark.parametrize("name", list(FIELDS))
def test_kernel_integrals_match_jax(name):
    j, t, _ = fields(name)
    for k in ("kernel_w", "kernel_gw", "kernel_g2w"):
        close(getattr(t, k), getattr(j, k), what=k)
    # the far-positive row holds the full support, the far-negative none
    assert (t.kernel_w[-2] == 1.0).all() and (t.kernel_w[-1] == 0.0).all()


@pytest.mark.parametrize("name", ("polygon", "ball"))
def test_gradient_reinitialize_clean_interface(name):
    j, t, _ = fields(name)
    close(t.gradient(), j.gradient(), what="gradient")
    # a distorted field (phi^3 / dx^2 keeps the interface) re-distanced
    jd = j.__class__(**{**j.__dict__, "phi": j.phi ** 3 / j.spacing ** 2})
    td = convert.levelset_from_jax(jd)
    ref = jax.jit(lambda p: jd.__class__(**{**jd.__dict__, "phi": p})
                  .reinitialize(30).phi)(jd.phi)
    got = td.reinitialize(30).phi
    close(got, ref, what="reinitialize")
    assert float((got - td.phi).abs().max()) > 1e-3     # it moved
    close(td.clean_interface().phi, jd.clean_interface().phi,
          what="clean_interface")


def test_level_set_shape_probes_and_bounds():
    j, t, pts = fields("polygon")
    js, ts = jls.LevelSetShape(j), tls.LevelSetShape(t)
    tp = torch.as_tensor(pts)
    ref = jax.jit(lambda p: (js.contains(p), js.find_normal_direction(p),
                             js.compute_kernel_gradient_integral(p)))(
        jnp.asarray(pts))
    np.testing.assert_array_equal(ts.contains(tp).numpy(), np.asarray(ref[0]))
    close(ts.find_normal_direction(tp), ref[1])
    close(ts.compute_kernel_gradient_integral(tp), ref[2])
    for a, b in zip(ts.bounds(), js.bounds()):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-15)


def test_kernel_support_assert():
    """A kernel wider than one package halo is refused, as in JAX."""
    _, t, _ = fields("polygon")
    with pytest.raises(AssertionError, match="package halo"):
        t.update_kernel_integrals(tk.WendlandC2(h=3.0 * t.spacing))


def test_d2w_matches_jax():
    r = np.linspace(0.0, 0.3, 97)
    for dim in (1, 2, 3):
        ref = jk.WendlandC2(h=0.13).d2W(jnp.asarray(r), dim)
        close(tk.WendlandC2(h=0.13).d2W(torch.as_tensor(r), dim), ref)
    with pytest.raises(NotImplementedError, match="d2W"):
        tk.LaguerreGauss(h=0.13).d2W(torch.as_tensor(r), 2)


# ---------------------------------------------------------------------------
# triangle meshes
# ---------------------------------------------------------------------------

def _stl_binary(v, f):
    out = bytearray(80) + struct.pack("<I", len(f))
    for tri in f:
        out += struct.pack("<3f", 0, 0, 0)
        for i in tri:
            out += struct.pack("<3f", *v[i])
        out += b"\0\0"
    return bytes(out)


def _stl_ascii(v, f):
    lines = ["solid box"]
    for tri in f:
        lines += ["facet normal 0 0 0", "outer loop"]
        lines += [f"vertex {v[i][0]} {v[i][1]} {v[i][2]}" for i in tri]
        lines += ["endloop", "endfacet"]
    return "\n".join(lines + ["endsolid box"])


@pytest.mark.parametrize("form", ("binary", "ascii"))
def test_stl_reader_matches_jax(form, tmp_path):
    box = jtm.box_mesh(halfsize=(0.5, 0.25, 0.75), center=(0.5, 0.0, 0.0))
    v, f = np.asarray(box.vertices), np.asarray(box.faces)
    path = tmp_path / f"box_{form}.stl"
    if form == "binary":
        path.write_bytes(_stl_binary(v, f))
    else:
        path.write_text(_stl_ascii(v, f))
    jv, jf = jtm.load_stl(str(path), scale=2.0, offset=(1.0, 0.0, -1.0))
    tv, tf = ttm.load_stl(str(path), scale=2.0, offset=(1.0, 0.0, -1.0))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    assert ttm.TriangleMesh.from_stl(str(path)).faces \
        == jtm.TriangleMesh.from_stl(str(path)).faces


@pytest.mark.parametrize("mesh", ("box", "icosphere"))
def test_mesh_signed_distance_matches_jax(mesh):
    make = {"box": lambda m: m.box_mesh(halfsize=(0.5, 0.3, 0.4),
                                        center=(0.1, 0.0, 0.0)),
            "icosphere": lambda m: m.icosphere_mesh(radius=0.5,
                                                    subdivisions=2)}[mesh]
    jm, tm = make(jtm), make(ttm)
    assert tm.vertices == jm.vertices and tm.faces == jm.faces
    for a, b in zip(tm.bounds(), jm.bounds()):
        np.testing.assert_array_equal(a, b)
    pts = np.random.default_rng(3).uniform(-0.8, 0.8, (300, 3))
    ref, inside = jax.jit(lambda p: (jm.signed_distance(p),
                                     jm.contains(p)))(jnp.asarray(pts))
    got = tm.signed_distance(torch.as_tensor(pts))
    close(got, ref, what="sdf")
    assert (got < 0).any() and (got > 0).any()
    close(tm.signed_distance(torch.as_tensor(pts[0])), ref[0],
          what="one point")
    np.testing.assert_array_equal(
        tm.contains(torch.as_tensor(pts)).numpy(), np.asarray(inside))


# ---------------------------------------------------------------------------
# generators
# ---------------------------------------------------------------------------

def _annulus(G):
    return G.make_complex(("add", G.Ball(center=(0.0, 0.0), radius=1.5)),
                          ("sub", G.Ball(center=(0.0, 0.0), radius=1.3)))


@pytest.mark.parametrize("spacing,thickness", ((0.1, 0.2), (0.1, 0.05)))
def test_surface_lattice_matches_jax(spacing, thickness):
    """The particles exactly (both thin numpy's default_rng(seed) draws),
    the normals within 1e-12, the area; then the normals turned radial."""
    lo, hi = (-1.8, -1.8), (1.8, 1.8)
    jp, jn, ja = jgen.generate_surface_lattice(_annulus(JG), lo, hi, spacing,
                                               thickness, seed=4)
    tp, tn, ta = tgen.generate_surface_lattice(_annulus(TG), lo, hi, spacing,
                                               thickness, seed=4)
    np.testing.assert_array_equal(tp, jp)
    assert len(tp) > 50 and ta == ja
    close(tn, jn, what="normals")
    radial = lambda p: p / np.linalg.norm(p, axis=1, keepdims=True)
    got = tgen.consistent_shell_normals(tp, tn, radial)
    np.testing.assert_array_equal(
        got, jgen.consistent_shell_normals(jp, tn, radial))
    assert (np.sum(got * radial(tp), axis=1) >= 0).all()


def test_observers_match_jax():
    pts = [[0.1, 0.2], [0.3, 0.4]]
    got = tgen.generate_observers(pts)
    np.testing.assert_array_equal(got, jgen.generate_observers(pts))
    assert got.dtype == np.float64
