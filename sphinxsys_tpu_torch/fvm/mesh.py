"""Fluent/ANSYS .msh parsing and FVM mesh compilation (host-side NumPy;
the port's own copy of sphinxsys_tpu/fvm/mesh.py, numpy only, with its
arithmetic order: the order of the `np.add.at` sums and of the face loop
that fills `cell_faces` fixes each cell's face slots, the summation order
of every cell reduction in fvm/dynamics.py).

Parser counterpart of ANSYSMesh::getDataFromMeshFile
(for_2D_build/bodies/unstructured_mesh_2d.cpp:9-93): reads the ASCII
Fluent format — `(2 d)` dimension, `(10 (zone first last type nd)(...)`
node blocks, `(13 (zone first last bc-type face-type)(...)` face blocks
whose lines give the face's nodes and the two adjacent cells (0 = none,
i.e. a boundary face).  The bc-type of the section is the Fluent boundary
condition id (2 interior, 3 wall, 4 pressure-inlet, 5 pressure-outlet,
7 symmetry, 9 pressure-far-field, 10 velocity-inlet, 36 outflow) — the
same codes the reference's mesh_topology_ carries.

Geometry (ANSYSMesh::getElementCenterCoordinates + elementVolume) is
computed here face-wise by the divergence theorem, so arbitrary polygonal
cells work without node-ordering bookkeeping:
    V_c       = (1/d)   sum_f (x_f . n_out) A_f
    centroid  = (1/V_c) sum_f n_out A_f (x0^2 + x0 x1 + x1^2)/6   (per axis)
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np


@dataclasses.dataclass
class RawMesh:
    dim: int
    nodes: np.ndarray          # (N, d)
    face_nodes: np.ndarray     # (F, 2) 2D / (F, 4) 3D int, 0-based; 3D rows
                               # are padded CYCLICALLY (triangles repeat
                               # their first node) so fan triangulation
                               # adds a zero-area triangle
    face_cells: np.ndarray     # (F, 2) int, 0-based, -1 = boundary side
    face_btype: np.ndarray     # (F,) Fluent bc id of the face's section
    face_nnodes: np.ndarray | None = None   # (F,) 3D: real node count


def _hex(tok: str) -> int:
    return int(tok, 16)


def read_fluent_msh(path: str) -> RawMesh:
    """Parse an ASCII Fluent .msh file (2D)."""
    with open(path) as f:
        text = f.read()
    lines = text.splitlines()

    dim = None
    nodes = []
    face_nodes, face_cells, face_btype = [], [], []

    i = 0
    header_re = re.compile(r"\((\d+)\s*\(([^)]*)\)")
    while i < len(lines):
        line = lines[i].strip()
        m = re.match(r"\(2\s+(\d+)\)", line)
        if m:
            dim = int(m.group(1))
            i += 1
            continue
        m = header_re.match(line)
        if m and m.group(1) == "10":
            hdr = m.group(2).split()
            zone = _hex(hdr[0])
            first, last = _hex(hdr[1]), _hex(hdr[2])
            if zone != 0:          # zone 0 is the declaration section
                count = last - first + 1
                i += 1
                while len(nodes) < count and i < len(lines):
                    toks = lines[i].replace("(", " ").replace(")", " ").split()
                    if len(toks) >= 2:
                        nodes.append([float(t) for t in toks[:dim or 2]])
                    i += 1
                continue
        if m and m.group(1) == "13":
            hdr = m.group(2).split()
            zone = _hex(hdr[0])
            first, last = _hex(hdr[1]), _hex(hdr[2])
            btype = _hex(hdr[3])
            ftype = _hex(hdr[4]) if len(hdr) > 4 else 0
            if zone != 0:
                count = last - first + 1
                got = 0
                i += 1
                while got < count and i < len(lines):
                    toks = lines[i].replace("(", " ").replace(")", " ").split()
                    if toks:
                        vals = [_hex(t) for t in toks]
                        if ftype == 0:      # mixed: leading node count
                            nn = vals[0]
                            vals = vals[1:]
                        else:
                            nn = ftype
                        fn = vals[:nn]
                        c0, c1 = vals[nn], vals[nn + 1]
                        face_nodes.append([n - 1 for n in fn])
                        face_cells.append([c0 - 1, c1 - 1])
                        face_btype.append(btype)
                        got += 1
                    i += 1
                continue
        i += 1

    dim = dim or 2
    nn_arr = np.asarray([len(f) for f in face_nodes], np.int64)
    width = 2 if dim == 2 else 4
    fn_arr = np.empty((len(face_nodes), width), np.int64)
    for k, f in enumerate(face_nodes):     # cyclic pad (see RawMesh)
        fn_arr[k] = (f + f)[:width]
    return RawMesh(dim=dim, nodes=np.asarray(nodes, np.float64),
                   face_nodes=fn_arr,
                   face_cells=np.asarray(face_cells, np.int64),
                   face_btype=np.asarray(face_btype, np.int64),
                   face_nnodes=nn_arr)


@dataclasses.dataclass
class FVMesh:
    """Compiled FVM mesh: flat face arrays + dense cell->face incidence.

    Face normals are unit vectors pointing OUT of the owner cell; for
    interior faces the neighbor is on the normal side, for boundary faces
    neigh == -1.  `r_eff` follows the reference relation construction
    (unstructured_mesh_2d.cpp:199-211): the center-to-center distance
    projected on the face normal for interior faces and TWICE the
    center-to-face distance for boundary faces (the ghost mirror).
    """

    dim: int
    n_cells: int
    centroids: np.ndarray      # (C, d)
    volumes: np.ndarray        # (C,)
    # faces
    owner: np.ndarray          # (F,)
    neigh: np.ndarray          # (F,)   -1 = boundary
    area: np.ndarray           # (F,)
    normal: np.ndarray         # (F, d) unit, out of owner
    midpoint: np.ndarray       # (F, d)
    btype: np.ndarray          # (F,)
    r_eff: np.ndarray          # (F,)
    # dense incidence: cell -> its faces (padded with F = zero-area dummy)
    cell_faces: np.ndarray     # (C, K)
    cell_sign: np.ndarray      # (C, K)  +1: stored normal is outward of cell
    min_edge: float


def compile_mesh(raw: RawMesh) -> FVMesh:
    nodes, fn, fc = raw.nodes, raw.face_nodes, raw.face_cells
    dim = raw.dim
    F = len(fn)
    n_cells = int(fc.max()) + 1

    if dim == 2:
        p0, p1 = nodes[fn[:, 0]], nodes[fn[:, 1]]
        seg = p1 - p0
        area = np.linalg.norm(seg, axis=1)
        normal = np.stack([seg[:, 1], -seg[:, 0]], axis=1) / area[:, None]
        mid = 0.5 * (p0 + p1)
        min_edge = float(area.min())
    else:
        # tri/quad faces, cyclically padded to 4 nodes: fan-triangulate
        # around the vertex mean (exact for planar faces, standard for
        # mildly warped quads); Newell area vectors per triangle
        verts = nodes[fn]                            # (F, 4, 3)
        nnf = raw.face_nnodes
        if nnf is None:
            nnf = np.full(F, 4, np.int64)
        vmask = (np.arange(4)[None, :] < nnf[:, None])
        ctr = np.sum(verts * vmask[..., None], axis=1) / nnf[:, None]
        av = np.zeros((F, 3))
        vflux = np.zeros(F)                          # sum_tri t_av . t_c
        mom_face = np.zeros((F, 3))                  # sum_tri t_av_i sq_i/6
        cmid = np.zeros((F, 3))
        wsum = np.zeros(F)
        edge_len = []
        for k in range(4):
            a = verts[:, k]
            b = verts[:, (k + 1) % 4]
            t_av = 0.5 * np.cross(a - ctr, b - ctr)
            t_c = (ctr + a + b) / 3.0
            w = np.linalg.norm(t_av, axis=1)
            av += t_av
            vflux += np.sum(t_av * t_c, axis=1)
            m01, m12, m20 = (ctr + a) / 2, (a + b) / 2, (b + ctr) / 2
            mom_face += t_av * (m01 * m01 + m12 * m12 + m20 * m20) / 6.0
            cmid += w[:, None] * t_c
            wsum += w
            edge_len.append(np.linalg.norm(b - a, axis=1))  # pad edges = 0,
            # filtered by the > 1e-12 mask below
        area = np.linalg.norm(av, axis=1)
        normal = av / area[:, None]
        mid = cmid / wsum[:, None]
        e = np.stack(edge_len)
        min_edge = float(e[e > 1e-12].min())

    # provisional centroid (mean of face mids) to orient normals
    cnt = np.zeros(n_cells)
    acc = np.zeros((n_cells, dim))
    for side in (0, 1):
        sel = fc[:, side] >= 0
        np.add.at(acc, fc[sel, side], mid[sel])
        np.add.at(cnt, fc[sel, side], 1.0)
    approx_c = acc / cnt[:, None]

    # owner = cells[:,0] unless it's the boundary side
    owner = np.where(fc[:, 0] >= 0, fc[:, 0], fc[:, 1])
    neigh = np.where(fc[:, 0] >= 0, fc[:, 1], -1)
    # orient the normal out of the owner
    flip = np.sum(normal * (mid - approx_c[owner]), axis=1) < 0.0
    normal[flip] = -normal[flip]

    # exact volumes and centroids by the divergence theorem
    volumes = np.zeros(n_cells)
    cmoment = np.zeros((n_cells, dim))
    if dim == 2:
        for cell_col, sgn in ((owner, 1.0), (neigh, -1.0)):
            sel = cell_col >= 0
            c = cell_col[sel]
            w = sgn * area[sel]
            np.add.at(volumes, c,
                      w * np.sum(normal[sel] * mid[sel], axis=1) / dim)
            x0, x1 = p0[sel], p1[sel]
            sq = (x0 * x0 + x0 * x1 + x1 * x1) / 6.0  # int x^2/2 over face
            np.add.at(cmoment, c, (w[:, None] * normal[sel]) * sq)
    else:
        # flip negates the triangle-accumulated flux/moment terms too
        osign = np.where(flip, -1.0, 1.0)
        for cell_col, sgn in ((owner, 1.0), (neigh, -1.0)):
            sel = cell_col >= 0
            c = cell_col[sel]
            w = sgn * osign[sel]
            np.add.at(volumes, c, w * vflux[sel] / 3.0)
            np.add.at(cmoment, c, w[:, None] * mom_face[sel])
    centroids = cmoment / volumes[:, None]

    # r_eff (unstructured_mesh_2d.cpp:199-211)
    d_own = np.sum((centroids[owner] - mid) * normal, axis=1)   # negative
    interior = neigh >= 0
    r_eff = np.where(
        interior,
        np.abs(np.sum((centroids[owner] - centroids[np.maximum(neigh, 0)])
                      * normal, axis=1)),
        2.0 * np.abs(d_own))

    # dense incidence
    k_count = np.zeros(n_cells, np.int64)
    for cell_col in (owner, neigh):
        sel = cell_col >= 0
        np.add.at(k_count, cell_col[sel], 1)
    K = int(k_count.max())
    cell_faces = np.full((n_cells, K), F, np.int64)
    cell_sign = np.zeros((n_cells, K), np.float64)
    slot = np.zeros(n_cells, np.int64)
    for f in range(F):
        c = owner[f]
        cell_faces[c, slot[c]] = f
        cell_sign[c, slot[c]] = 1.0
        slot[c] += 1
        c = neigh[f]
        if c >= 0:
            cell_faces[c, slot[c]] = f
            cell_sign[c, slot[c]] = -1.0
            slot[c] += 1

    min_edge = float(area.min())
    return FVMesh(dim=dim, n_cells=n_cells, centroids=centroids,
                  volumes=volumes, owner=owner, neigh=neigh, area=area,
                  normal=normal, midpoint=mid, btype=raw.face_btype,
                  r_eff=r_eff,
                  cell_faces=cell_faces, cell_sign=cell_sign,
                  min_edge=min_edge)
