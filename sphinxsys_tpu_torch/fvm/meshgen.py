"""Mesh generation + Fluent .msh writing (host-side; the port's own copy
of sphinxsys_tpu/fvm/meshgen.py, numpy only: a written file is byte for
byte the JAX package's, its header line included).

The reference ships pre-built Fluent meshes with its FVM cases (e.g.
tests/2d_examples/test_2d_FVM_flow_around_cylinder/data/fluent_0.3.msh);
this framework generates its meshes and can WRITE the same ASCII Fluent
format, so the parser (fvm/mesh.py) is exercised on real files and users
can drop in their own Fluent meshes interchangeably.
"""

from __future__ import annotations

import numpy as np

from sphinxsys_tpu_torch.fvm.mesh import RawMesh

INTERIOR, WALL, FARFIELD = 2, 3, 9


def cylinder_ogrid(r0: float = 1.0, r1: float = 20.0, nr: int = 40,
                   nt: int = 80, stretch: float | None = None) -> RawMesh:
    """O-grid around a cylinder: quad cells between `nr+1` concentric rings
    (geometrically stretched from radius r0 to r1) and `nt` spokes.  Inner
    ring faces are WALL (Fluent bc 3), outer ring faces FARFIELD (bc 9),
    everything else interior (bc 2) — the same boundary ids the reference
    cylinder mesh uses."""
    if stretch is None:
        # geometric ratio so the first ring thickness ~ r0 * 2 pi / nt
        dr0 = r0 * 2.0 * np.pi / nt
        lo, hi = 1.0001, 1.5
        for _ in range(60):
            q = 0.5 * (lo + hi)
            if dr0 * (q ** nr - 1.0) / (q - 1.0) < r1 - r0:
                lo = q
            else:
                hi = q
        stretch = 0.5 * (lo + hi)
        radii = r0 + dr0 * (stretch ** np.arange(nr + 1) - 1.0) / (stretch - 1.0)
        radii *= (r1 - r0) / (radii[-1] - r0)
        radii += r0 - radii[0]
    else:
        radii = r0 * (r1 / r0) ** (np.arange(nr + 1) / nr)
    theta = 2.0 * np.pi * np.arange(nt) / nt

    nid = lambda i, j: i * nt + (j % nt)
    cid = lambda i, j: i * nt + (j % nt)
    nodes = np.stack([
        np.outer(radii, np.cos(theta)).ravel(),
        np.outer(radii, np.sin(theta)).ravel()], axis=1)

    face_nodes, face_cells, face_btype = [], [], []
    # spoke faces: between ring i and i+1 at angle j — separate cells
    # (i, j-1) and (i, j)
    for i in range(nr):
        for j in range(nt):
            face_nodes.append([nid(i, j), nid(i + 1, j)])
            face_cells.append([cid(i, j - 1), cid(i, j)])
            face_btype.append(INTERIOR)
    # ring faces on ring i between angles j and j+1 — separate cells
    # (i-1, j) and (i, j); ring 0 = wall, ring nr = far field
    for i in range(nr + 1):
        for j in range(nt):
            face_nodes.append([nid(i, j), nid(i, j + 1)])
            if i == 0:
                face_cells.append([cid(0, j), -1])
                face_btype.append(WALL)
            elif i == nr:
                face_cells.append([cid(nr - 1, j), -1])
                face_btype.append(FARFIELD)
            else:
                face_cells.append([cid(i - 1, j), cid(i, j)])
                face_btype.append(INTERIOR)

    return RawMesh(dim=2, nodes=nodes,
                   face_nodes=np.asarray(face_nodes, np.int64),
                   face_cells=np.asarray(face_cells, np.int64),
                   face_btype=np.asarray(face_btype, np.int64))


def write_fluent_msh(path: str, raw: RawMesh) -> None:
    """Write the ASCII Fluent format read by read_fluent_msh (and by the
    reference ANSYSMesh parser): dimension, one node zone, one face section
    per boundary type."""
    n_nodes = len(raw.nodes)
    F = len(raw.face_nodes)
    n_cells = int(raw.face_cells.max()) + 1
    lines = ['(0 "Generated by sphinxsys_tpu fvm.meshgen")',
             f"(2 {raw.dim})",
             f"(10 (0 1 {n_nodes:x} 0 {raw.dim}))",
             f"(10 (1 1 {n_nodes:x} 1 {raw.dim})("]
    for p in raw.nodes:
        lines.append(" ".join(f"{x:.17g}" for x in p))
    lines.append("))")
    lines.append(f"(12 (0 1 {n_cells:x} 0))")
    lines.append(f"(12 (2 1 {n_cells:x} 1 3))")
    lines.append(f"(13 (0 1 {F:x} 0))")

    zone_id = 4
    first = 1
    for btype in sorted(set(raw.face_btype.tolist())):
        sel = np.nonzero(raw.face_btype == btype)[0]
        last = first + len(sel) - 1
        lines.append(f"(13 ({zone_id:x} {first:x} {last:x} {btype:x} 2)(")
        for f in sel:
            n0, n1 = raw.face_nodes[f] + 1
            c0, c1 = raw.face_cells[f] + 1
            lines.append(f"{n0:x} {n1:x} {max(c0, 0):x} {max(c1, 0):x}")
        lines.append("))")
        zone_id += 1
        first = last + 1
    lines.append('(0 "Zone Sections")')
    lines.append("")
    with open(path, "w") as fh:
        fh.write("\n".join(lines))


def rect_grid(nx: int, ny: int, lx: float, ly: float,
              btype_x=WALL, btype_y=7) -> RawMesh:
    """Structured nx x ny quad grid over [0,lx] x [0,ly]: x-end faces get
    `btype_x`, y-end faces `btype_y` (default symmetry) — the quasi-1D
    strip for shock-tube validation (the FVM double-mach-reflection
    family's building block)."""
    xs = np.linspace(0.0, lx, nx + 1)
    ys = np.linspace(0.0, ly, ny + 1)
    nid = lambda i, j: i * (ny + 1) + j
    cid = lambda i, j: i * ny + j
    nodes = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)

    face_nodes, face_cells, face_btype = [], [], []
    # vertical faces (constant x = xs[i]) between cells (i-1,j) and (i,j)
    for i in range(nx + 1):
        for j in range(ny):
            face_nodes.append([nid(i, j), nid(i, j + 1)])
            if i == 0:
                face_cells.append([cid(0, j), -1])
                face_btype.append(btype_x)
            elif i == nx:
                face_cells.append([cid(nx - 1, j), -1])
                face_btype.append(btype_x)
            else:
                face_cells.append([cid(i - 1, j), cid(i, j)])
                face_btype.append(INTERIOR)
    # horizontal faces (constant y = ys[j]) between cells (i,j-1) and (i,j)
    for i in range(nx):
        for j in range(ny + 1):
            face_nodes.append([nid(i, j), nid(i + 1, j)])
            if j == 0:
                face_cells.append([cid(i, 0), -1])
                face_btype.append(btype_y)
            elif j == ny:
                face_cells.append([cid(i, ny - 1), -1])
                face_btype.append(btype_y)
            else:
                face_cells.append([cid(i, j - 1), cid(i, j)])
                face_btype.append(INTERIOR)

    return RawMesh(dim=2, nodes=nodes,
                   face_nodes=np.asarray(face_nodes, np.int64),
                   face_cells=np.asarray(face_cells, np.int64),
                   face_btype=np.asarray(face_btype, np.int64))


HEX_SIDES = ("x0", "x1", "y0", "y1", "z0", "z1")


def hex_box(nx: int, ny: int, nz: int, lengths=(1.0, 1.0, 1.0),
            btypes=None) -> RawMesh:
    """Structured nx x ny x nz hexahedra over [0, lx] x [0, ly] x [0, lz]
    with quad faces (3D; the JAX package has no 3D generator): each
    outer side gets its Fluent bc from `btypes` (keys HEX_SIDES, default
    all wall), the inner faces bc 2.  A face's nodes run round it, so its
    Newell area vector is exact; compile_mesh orients the normals."""
    bt = dict.fromkeys(HEX_SIDES, WALL)
    bt.update(btypes or {})
    axes = [np.linspace(0.0, L, n + 1) for L, n in zip(lengths, (nx, ny, nz))]
    nodes = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    nid = lambda i, j, k: (i * (ny + 1) + j) * (nz + 1) + k
    cid = lambda i, j, k: (i * ny + j) * nz + k
    shape = (nx, ny, nz)

    face_nodes, face_cells, face_btype = [], [], []

    def add(nodes4, axis, idx, cell_of):
        """A face at plane index `idx` along `axis`; cell_of(m) the cell at
        plane-cell index m (None outside)."""
        lo = cell_of(idx - 1) if idx > 0 else None
        hi = cell_of(idx) if idx < shape[axis] else None
        face_nodes.append(nodes4)
        if lo is None:
            face_cells.append([hi, -1])
            face_btype.append(bt[HEX_SIDES[2 * axis]])
        elif hi is None:
            face_cells.append([lo, -1])
            face_btype.append(bt[HEX_SIDES[2 * axis + 1]])
        else:
            face_cells.append([lo, hi])
            face_btype.append(INTERIOR)

    for i in range(nx + 1):
        for j in range(ny):
            for k in range(nz):
                add([nid(i, j, k), nid(i, j + 1, k), nid(i, j + 1, k + 1),
                     nid(i, j, k + 1)], 0, i, lambda m: cid(m, j, k))
    for i in range(nx):
        for j in range(ny + 1):
            for k in range(nz):
                add([nid(i, j, k), nid(i + 1, j, k), nid(i + 1, j, k + 1),
                     nid(i, j, k + 1)], 1, j, lambda m: cid(i, m, k))
    for i in range(nx):
        for j in range(ny):
            for k in range(nz + 1):
                add([nid(i, j, k), nid(i + 1, j, k), nid(i + 1, j + 1, k),
                     nid(i, j + 1, k)], 2, k, lambda m: cid(i, j, m))

    return RawMesh(dim=3, nodes=nodes,
                   face_nodes=np.asarray(face_nodes, np.int64),
                   face_cells=np.asarray(face_cells, np.int64),
                   face_btype=np.asarray(face_btype, np.int64),
                   face_nnodes=np.full(len(face_nodes), 4, np.int64))
