"""Parity of the port's cell table and neighbour lists
(neighbors/cell_list.py `build_cell_table`, neighbors/neighbor_list.py)
with the JAX package: integers exact, `idx` row for row.

Inputs, made from a seed with numpy: a 2D box periodic in x and a 3D box,
random particles plus particles on the cell faces (where floor() decides
the cell) and on the periodic seam, followed by padding rows parked far
away; `n_real` as an int and as a validity mask with holes; the inner
relation (include_self False) and a contact relation between two bodies
(True); a forced overflow of the lists and of the cell table; the
row-chunked build against one chunk."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sphinxsys_tpu.neighbors import cell_list as jcl
from sphinxsys_tpu.neighbors import neighbor_list as jnl
from sphinxsys_tpu_torch.neighbors import cell_list as tcl
from sphinxsys_tpu_torch.neighbors import neighbor_list as tnl

torch.set_num_threads(1)

FAR = 1.0e16
BOXES = {  # name: (lower, upper, cutoff, periodic, n particles)
    "2d-periodic-x": ((0.0, 0.0), (2.08, 1.3), 0.26, (True, False), 260),
    "3d": ((0.0, 0.0, 0.0), (1.2, 0.9, 0.9), 0.3, None, 300),
}


def _body(name, seed, n_pad=7):
    """(positions (N, dim) float64 with n_pad far rows at the end, n_real,
    a validity mask with holes among the real rows)."""
    lo, hi, cutoff, periodic, n = BOXES[name]
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(lo), np.asarray(hi)
    pos = lo + rng.random((n, len(lo))) * (hi - lo)
    # particles exactly on cell faces, and on the periodic seam
    faces = lo + np.round(rng.random((20, len(lo))) * (hi - lo) / cutoff) * cutoff
    pos = np.concatenate([pos, np.minimum(faces, hi - 1e-9)])
    if periodic:
        seam = pos[:6].copy()
        seam[:, 0] = lo[0]
        pos = np.concatenate([pos, seam])
    n_real = len(pos)
    pos = np.concatenate([pos, np.full((n_pad, len(lo)), FAR)])
    mask = np.arange(len(pos)) < n_real
    mask[rng.choice(n_real, n_real // 5, replace=False)] = False
    return pos, n_real, mask


def _grids(name):
    lo, hi, cutoff, periodic, _ = BOXES[name]
    return (jcl.grid_from_bounds(lo, hi, cutoff, periodic=periodic),
            tcl.grid_from_bounds(lo, hi, cutoff, periodic=periodic), cutoff)


def _n_real(kind, n_real, mask):
    return ((jnp.int32(n_real), n_real) if kind == "int"
            else (jnp.asarray(mask), torch.as_tensor(mask)))


def _tables(name, pos, n_real_j, n_real_t, cap):
    jg, tg, _ = _grids(name)
    jt = jcl.build_cell_table(jnp.asarray(pos), n_real_j, jg, cap)
    tt = tcl.build_cell_table(torch.as_tensor(pos), n_real_t, tg, cap)
    return jt, tt


def _assert_table(jt, tt):
    np.testing.assert_array_equal(tt.table.numpy(), np.asarray(jt.table))
    np.testing.assert_array_equal(tt.counts.numpy(), np.asarray(jt.counts))
    assert bool(tt.overflow) == bool(jt.overflow)


@pytest.mark.parametrize("kind", ["int", "mask"])
@pytest.mark.parametrize("name", list(BOXES))
def test_cell_table_matches_jax(name, kind):
    pos, n_real, mask = _body(name, 1)
    jt, tt = _tables(name, pos, *_n_real(kind, n_real, mask), cap=24)
    _assert_table(jt, tt)
    assert not bool(tt.overflow)
    # every valid particle sits in exactly one row of the grid's cells
    valid = np.arange(len(pos)) < n_real if kind == "int" else mask
    held = tt.table.numpy()[:-1]
    assert sorted(held[held < len(pos)].tolist()) == np.nonzero(valid)[0].tolist()


def _lists(name, kind, include_self, k_max, cap=24, row_chunk=tnl.ROW_CHUNK):
    """(JAX list, port list) of the query body against a source body: the
    same body when include_self is False (an inner relation), else a
    second body (a contact relation)."""
    jg, tg, cutoff = _grids(name)
    pos_q, nq, mask_q = _body(name, 2)
    pos_s, ns, mask_s = (pos_q, nq, mask_q) if not include_self \
        else _body(name, 3, n_pad=3)
    rq_j, rq_t = _n_real(kind, nq, mask_q)
    rs_j, rs_t = _n_real(kind, ns, mask_s)
    jt, tt = _tables(name, pos_s, rs_j, rs_t, cap)
    jl = jnl.build_neighbor_list(jnp.asarray(pos_q), rq_j, jnp.asarray(pos_s),
                                 rs_j, jt, jg, cutoff, k_max, include_self)
    tl = tnl.build_neighbor_list(torch.as_tensor(pos_q), rq_t,
                                 torch.as_tensor(pos_s), rs_t, tt, tg, cutoff,
                                 k_max, include_self, row_chunk=row_chunk)
    return jl, tl


def _assert_list(jl, tl):
    np.testing.assert_array_equal(tl.idx.numpy(), np.asarray(jl.idx))
    np.testing.assert_array_equal(tl.count.numpy(), np.asarray(jl.count))
    assert bool(tl.overflow) == bool(jl.overflow)


@pytest.mark.parametrize("include_self", [False, True])
@pytest.mark.parametrize("kind", ["int", "mask"])
@pytest.mark.parametrize("name", list(BOXES))
def test_neighbor_list_matches_jax(name, kind, include_self):
    jl, tl = _lists(name, kind, include_self, k_max=64)
    _assert_list(jl, tl)
    assert not bool(tl.overflow)
    assert int(tl.count.sum()) > 0


@pytest.mark.parametrize("name", list(BOXES))
def test_forced_overflow_matches_jax(name):
    """k_max below the fullest row: the flag is set and the rows keep their
    first k_max neighbours in window order, as in JAX; a cell cap below
    the fullest cell sets the table's flag, which the list carries."""
    jl, tl = _lists(name, "int", False, k_max=5)
    _assert_list(jl, tl)
    assert bool(tl.overflow) and int(tl.count.max()) > 5
    jl, tl = _lists(name, "mask", True, k_max=64, cap=2)
    _assert_list(jl, tl)
    assert bool(tl.overflow)


@pytest.mark.parametrize("name", list(BOXES))
def test_chunked_build_equals_one_chunk(name):
    _, whole = _lists(name, "mask", False, k_max=64, row_chunk=1 << 20)
    _, chunked = _lists(name, "mask", False, k_max=64, row_chunk=7)
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_pairs_match_brute_force():
    """The 3D inner relation holds exactly the pairs the O(N^2) oracle
    finds among the real rows."""
    name = "3d"
    _, tl = _lists(name, "int", False, k_max=64)
    pos, n_real, _ = _body(name, 2)
    found = {(i, int(j)) for i, row in enumerate(tl.idx.numpy()[:n_real])
             for j in row if j < len(pos)}
    assert found == tnl.brute_force_neighbors(pos, n_real, pos, n_real,
                                              BOXES[name][2], False)


def test_gather_matches_jax():
    rng = np.random.default_rng(4)
    src = rng.normal(size=(50, 2, 2))
    idx = rng.integers(0, 51, size=(30, 8)).astype(np.int32)  # 50: sentinel
    jv, jm = jnl.gather(jnp.asarray(src), jnp.asarray(idx))
    tv, tm = tnl.gather(torch.as_tensor(src), torch.as_tensor(idx))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
