"""Parity of the port's FVM front end (sphinxsys_tpu_torch/fvm/) with the
JAX package's on the CPU.

Meshes: JAX's hand-written two-cell fixture (tests/test_fvm.py) parsed by
both packages; the cylinder O-grid and `rect_grid` written byte-equal;
`compile_mesh` equal bitwise (integers exact) on those grids, on a 3D
RawMesh the test builds in numpy (a 3 x 2 x 2 hex box with quad faces)
and on its split into tetrahedra (triangles padded cyclically to four
nodes), as RawMesh and as the device mesh of `to_device`.  The port's own
3D generator (`meshgen.hex_box`) equals the test's box.

The dynamics are held in tests/test_torch_fvm_dynamics.py, on these
meshes.
"""

import numpy as np
import pytest
import torch

from test_torch_viscosity import DTYPES

from sphinxsys_tpu.fvm import dynamics as jfv
from sphinxsys_tpu.fvm import mesh as jm
from sphinxsys_tpu.fvm import meshgen as jg
from sphinxsys_tpu_torch.fvm import dynamics as tfv
from sphinxsys_tpu_torch.fvm import mesh as tm
from sphinxsys_tpu_torch.fvm import meshgen as tg

torch.set_num_threads(1)

# tests/test_fvm.py's hand-written 2 x 1 quad mesh: 6 nodes, 2 unit cells,
# 7 faces
TINY_MSH = """(0 "hand-written fixture")
(2 2)
(10 (0 1 6 0 2))
(10 (1 1 6 1 2)(
0 0
1 0
2 0
0 1
1 1
2 1
))
(12 (0 1 2 0))
(13 (0 1 7 0))
(13 (4 1 1 2 2)(
2 5 1 2
))
(13 (5 2 7 3 2)(
1 2 1 0
2 3 2 0
3 6 2 0
6 5 2 0
5 4 1 0
4 1 1 0
))
(0 "Zone Sections")
"""
RAW_FIELDS = ("nodes", "face_nodes", "face_cells", "face_btype",
              "face_nnodes")
MESH_FIELDS = ("centroids", "volumes", "owner", "neigh", "area", "normal",
               "midpoint", "btype", "r_eff", "cell_faces", "cell_sign")
DM_FIELDS = ("volumes", "owner", "neigh", "interior", "area", "normal",
             "midpoint", "r_eff", "btype", "cell_faces", "cell_sign",
             "centroids")
BC_CODES = (3, 4, 5, 7, 9, 10, 36)


def same_raw(a, b):
    assert a.dim == b.dim
    for k in RAW_FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        if x is None or y is None:
            assert x is None and y is None, k
            continue
        assert x.dtype == y.dtype and np.array_equal(x, y), k


def same_mesh(a, b):
    assert a.dim == b.dim and a.n_cells == b.n_cells
    assert a.min_edge == b.min_edge
    for k in MESH_FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x, y), k


# --------------------------------------------------------------------------
# meshes
# --------------------------------------------------------------------------

def hex_nodes(n, lengths):
    axes = [np.linspace(0.0, L, k + 1) for L, k in zip(lengths, n)]
    return np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)


def raw_from_cells(nodes, cells, side_btype):
    """A 3D RawMesh from cells given as lists of faces (node tuples in
    cyclic order), faces shared by two cells merged; a boundary face's bc
    from side_btype(its vertex mean).  Faces of three nodes are padded
    cyclically to four."""
    faces, owner = [], {}
    cells_of = []
    for c, cell in enumerate(cells):
        for f in cell:
            key = frozenset(f)
            if key in owner:
                cells_of[owner[key]][1] = c
            else:
                owner[key] = len(faces)
                faces.append(list(f))
                cells_of.append([c, -1])
    fn = np.asarray([(f + f)[:4] for f in faces], np.int64)
    fc = np.asarray(cells_of, np.int64)
    bt = np.asarray([2 if b >= 0 else side_btype(nodes[f].mean(0))
                     for f, (_, b) in zip(faces, cells_of)], np.int64)
    return jm.RawMesh(dim=3, nodes=nodes, face_nodes=fn, face_cells=fc,
                      face_btype=bt,
                      face_nnodes=np.asarray([len(f) for f in faces],
                                             np.int64))


def _hex_corners(i, j, k, n):
    ny, nz = n[1], n[2]
    nid = lambda a, b, c: (a * (ny + 1) + b) * (nz + 1) + c
    return [nid(i + a, j + b, k + c) for a in (0, 1) for b in (0, 1)
            for c in (0, 1)]


def _side_btype(lengths, codes):
    """The bc of a boundary face by its side: x0, x1, y0, y1, z0, z1."""
    def f(ctr):
        for axis in range(3):
            if ctr[axis] < 1e-9:
                return codes[2 * axis]
            if ctr[axis] > lengths[axis] - 1e-9:
                return codes[2 * axis + 1]
        raise AssertionError(ctr)
    return f


HEX_N = (3, 2, 2)
HEX_L = (1.5, 1.0, 0.8)
HEX_CODES = (10, 5, 3, 36, 7, 9)


def hex_box_raw():
    """3 x 2 x 2 hexahedra, quad faces, each side its own bc code."""
    nodes = hex_nodes(HEX_N, HEX_L)
    cells = []
    for i in range(HEX_N[0]):
        for j in range(HEX_N[1]):
            for k in range(HEX_N[2]):
                v = _hex_corners(i, j, k, HEX_N)   # v[4a + 2b + c]
                cells.append([(v[0], v[1], v[3], v[2]), (v[4], v[5], v[7], v[6]),
                              (v[0], v[1], v[5], v[4]), (v[2], v[3], v[7], v[6]),
                              (v[0], v[2], v[6], v[4]), (v[1], v[3], v[7], v[5])])
    return raw_from_cells(nodes, cells, _side_btype(HEX_L, HEX_CODES))


# the six tetrahedra of a cube around its 0-7 diagonal (corner index
# 4a + 2b + c), which tile a box conformingly
TETS = ((0, 1, 3, 7), (0, 3, 2, 7), (0, 2, 6, 7), (0, 6, 4, 7),
        (0, 4, 5, 7), (0, 5, 1, 7))


def tet_box_raw():
    """The same box split into six tetrahedra a hexahedron: triangular
    faces, padded cyclically to four nodes."""
    nodes = hex_nodes(HEX_N, HEX_L)
    cells = []
    for i in range(HEX_N[0]):
        for j in range(HEX_N[1]):
            for k in range(HEX_N[2]):
                v = _hex_corners(i, j, k, HEX_N)
                for t in TETS:
                    a, b, c, d = (v[x] for x in t)
                    cells.append([(a, b, c), (a, b, d), (a, c, d),
                                  (b, c, d)])
    return raw_from_cells(nodes, cells, _side_btype(HEX_L, HEX_CODES))


def with_codes(raw, seed=3):
    """`raw` with its boundary faces' bc codes drawn from BC_CODES (every
    one present)."""
    bt = raw.face_btype.copy()
    bnd = np.nonzero(bt != 2)[0]
    rng = np.random.default_rng(seed)
    codes = np.asarray(BC_CODES)[rng.integers(0, len(BC_CODES), len(bnd))]
    codes[: len(BC_CODES)] = BC_CODES
    bt[bnd] = codes
    return jm.RawMesh(dim=raw.dim, nodes=raw.nodes, face_nodes=raw.face_nodes,
                      face_cells=raw.face_cells, face_btype=bt,
                      face_nnodes=raw.face_nnodes)


RAWS = {
    "ogrid": lambda: jg.cylinder_ogrid(r0=1.0, r1=10.0, nr=12, nt=24),
    "ogrid_stretch": lambda: jg.cylinder_ogrid(r0=1.0, r1=5.0, nr=5, nt=9,
                                               stretch=1.2),
    "rect": lambda: jg.rect_grid(8, 3, 2.0, 0.75),
    "rect_codes": lambda: with_codes(jg.rect_grid(6, 4, 1.5, 1.0)),
    "hex": hex_box_raw,
    "tet": tet_box_raw,
}


def test_fixture_parsed_alike(tmp_path):
    path = tmp_path / "tiny.msh"
    path.write_text(TINY_MSH)
    jraw, traw = jm.read_fluent_msh(str(path)), tm.read_fluent_msh(str(path))
    same_raw(jraw, traw)
    assert traw.nodes.shape == (6, 2) and len(traw.face_nodes) == 7
    same_mesh(jm.compile_mesh(jraw), tm.compile_mesh(traw))
    assert tm.compile_mesh(traw).n_cells == 2


@pytest.mark.parametrize("name", ("ogrid", "rect", "rect_codes"))
def test_written_msh_byte_equal(tmp_path, name):
    raw = RAWS[name]()
    jp, tp = tmp_path / "jax.msh", tmp_path / "port.msh"
    jg.write_fluent_msh(str(jp), raw)
    tg.write_fluent_msh(str(tp), raw)
    assert jp.read_bytes() == tp.read_bytes()
    same_raw(jm.read_fluent_msh(str(jp)), tm.read_fluent_msh(str(tp)))


def test_generators_equal():
    same_raw(jg.cylinder_ogrid(nr=7, nt=15), tg.cylinder_ogrid(nr=7, nt=15))
    same_raw(jg.cylinder_ogrid(r0=0.5, r1=3.0, nr=4, nt=8, stretch=1.1),
             tg.cylinder_ogrid(r0=0.5, r1=3.0, nr=4, nt=8, stretch=1.1))
    same_raw(jg.rect_grid(5, 3, 1.0, 0.5, btype_x=9, btype_y=9),
             tg.rect_grid(5, 3, 1.0, 0.5, btype_x=9, btype_y=9))


def test_hex_box_generator_is_the_test_box():
    """The port's 3D generator compiles to the test's own box (faces in
    another order: the geometry is compared per cell)."""
    sides = dict(zip(tg.HEX_SIDES, HEX_CODES))
    mine = tm.compile_mesh(tg.hex_box(*HEX_N, HEX_L, sides))
    ref = jm.compile_mesh(hex_box_raw())
    np.testing.assert_allclose(mine.centroids, ref.centroids, atol=1e-14)
    np.testing.assert_allclose(mine.volumes, ref.volumes, rtol=1e-14)
    for code in set(HEX_CODES):
        assert np.isclose(mine.area[mine.btype == code].sum(),
                          ref.area[ref.btype == code].sum(), rtol=1e-14)


@pytest.mark.parametrize("name", sorted(RAWS))
def test_compile_mesh_bitwise(name):
    raw = RAWS[name]()
    jmesh, tmesh = jm.compile_mesh(raw), tm.compile_mesh(raw)
    same_mesh(jmesh, tmesh)
    assert (tmesh.volumes > 0).all()
    if name == "tet":
        assert (raw.face_nnodes == 3).all() and raw.face_nodes.shape[1] == 4


def test_to_device_defaults_to_the_card(monkeypatch):
    """Like the case entry points, `to_device` runs on the card unless the
    caller asks for the CPU: with no card it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tfv.to_device(tm.compile_mesh(RAWS["ogrid"]()))


@pytest.mark.parametrize("name", ("ogrid", "hex", "tet"))
@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
def test_to_device_equal(name, dtype):
    mesh = jm.compile_mesh(RAWS[name]())
    jdm = jfv.to_device(mesh, dtype)
    tdm = tfv.to_device(tm.compile_mesh(RAWS[name]()),
                        torch.float64 if dtype == np.float64
                        else torch.float32, "cpu")
    assert tdm.n_cells == jdm.n_cells and tdm.min_edge == jdm.min_edge
    for k in DM_FIELDS:
        a, b = np.asarray(getattr(jdm, k)), getattr(tdm, k).numpy()
        assert a.shape == b.shape and np.array_equal(a, b.astype(a.dtype)), k
        assert a.dtype.kind == b.dtype.kind, k
