"""Parity of the port's cell-block slotting with the JAX package: the
integer outputs of build_block_map (occupied cells, window rows, slot
permutation, run starts, overflow) must be EQUAL, and the carried blocks
exact, on seeded 2D and 3D clouds — including capacity overflows and an
n_max bound."""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sphinxsys_tpu.neighbors import cell_blocks as jcb
from sphinxsys_tpu.neighbors.cell_list import grid_from_bounds as j_grid
from sphinxsys_tpu_torch.neighbors import cell_blocks as tcb
from sphinxsys_tpu_torch.neighbors.cell_list import grid_from_bounds as t_grid

torch.set_num_threads(1)

# name: (dim, n, extent, cap, c_max, n_max, periodic, float dtype)
CLOUDS = {
    "2d": (2, 600, 8.0, 16, 128, None, None, np.float64),
    "2d_f32": (2, 600, 8.0, 16, 128, None, None, np.float32),
    "3d": (3, 500, 6.0, 16, 256, None, None, np.float64),
    "2d_cap_overflow": (2, 600, 8.0, 3, 128, None, None, np.float64),
    "3d_cmax_overflow": (3, 500, 6.0, 16, 32, None, None, np.float64),
    "2d_nmax": (2, 600, 8.0, 16, 128, 500, None, np.float64),
    "2d_nmax_spill": (2, 600, 8.0, 16, 128, 300, None, np.float64),
}
INT_FIELDS = ("occ_cells", "n_occ", "nbr_block", "slot_particle", "slot_mask",
              "overflow", "order_n", "start")


def _cloud(dim, n, extent, dtype, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, extent, size=(n, dim))
    pos[: n // 10] = np.floor(pos[: n // 10])          # exact cell faces
    valid = rng.uniform(size=n) < 0.8
    return pos.astype(dtype), valid


def _grids(dim, extent, periodic):
    args = ((0.0,) * dim, (extent,) * dim, 1.0)
    return j_grid(*args, periodic=periodic), t_grid(*args, periodic=periodic)


@pytest.mark.parametrize("name", list(CLOUDS))
def test_build_block_map_matches_jax(name):
    dim, n, extent, cap, c_max, n_max, periodic, dtype = CLOUDS[name]
    pos, valid = _cloud(dim, n, extent, dtype, seed=len(name))
    carry = np.random.default_rng(5).normal(size=(n, 5)).astype(dtype)
    jg, tg = _grids(dim, extent, periodic)

    jbm, jblocks = jax.jit(partial(jcb.build_block_map, grid=jg, cap=cap,
                                   c_max=c_max, n_max=n_max,
                                   with_inverse=False))(
        jnp.asarray(pos), jnp.asarray(valid), carry=jnp.asarray(carry))
    tbm, tblocks = tcb.build_block_map(torch.as_tensor(pos), torch.as_tensor(valid),
                                       tg, cap=cap, c_max=c_max, n_max=n_max,
                                       carry=torch.as_tensor(carry))
    for k in INT_FIELDS:
        np.testing.assert_array_equal(getattr(tbm, k).numpy(),
                                      np.asarray(getattr(jbm, k)), err_msg=k)
    np.testing.assert_array_equal(tblocks.numpy(), np.asarray(jblocks))
    assert bool(tbm.overflow) == name.endswith(("overflow", "spill"))

    # layout conversion of a particle field
    field = jnp.asarray(carry[:, :dim])
    np.testing.assert_array_equal(
        tcb.to_blocks(tbm, torch.as_tensor(carry[:, :dim]), fill=-7.0).numpy(),
        np.asarray(jcb.to_blocks(jbm, field, fill=-7.0)))


@pytest.mark.parametrize("dim", [2, 3])
def test_cross_neighbor_blocks_match_jax(dim):
    """Window rows into ANOTHER body's blocks (the fluid -> wall map)."""
    extent = 6.0
    jg, tg = _grids(dim, extent, None)
    q_pos, q_valid = _cloud(dim, 400, extent, np.float64, seed=11)
    s_pos, s_valid = _cloud(dim, 300, extent, np.float64, seed=12)
    bms = {}
    for side, build, arr in (("jax", partial(jcb.build_block_map, grid=jg),
                              jnp.asarray),
                             ("torch", partial(tcb.build_block_map, grid=tg),
                              torch.as_tensor)):
        bq = build(arr(q_pos), arr(q_valid), cap=16, c_max=256)
        bsrc = build(arr(s_pos), arr(s_valid), cap=16, c_max=192)
        bms[side] = (bq, bsrc)
    (jq, js), (tq, ts) = bms["jax"], bms["torch"]
    ref = jcb.cross_neighbor_blocks(jq.occ_cells, jg, js)
    got = tcb.cross_neighbor_blocks(tq.occ_cells, tg, ts)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    dm_t = tcb.dense_cell_map(ts.occ_cells, tg.ncells, ts.c_max)
    np.testing.assert_array_equal(
        dm_t.numpy(), np.asarray(jcb.dense_cell_map(js.occ_cells, jg.ncells,
                                                    js.c_max)))
    got_dm = tcb.cross_neighbor_blocks(tq.occ_cells, tg, ts, src_dense_map=dm_t)
    np.testing.assert_array_equal(got_dm.numpy(), np.asarray(ref))


def test_periodic_grid_raises():
    """The window wrap of periodic grids is not ported yet: it raises
    instead of returning unwrapped windows."""
    _, tg = _grids(2, 8.0, (True, False))
    pos, valid = _cloud(2, 600, 8.0, np.float64, seed=3)
    with pytest.raises(NotImplementedError):
        tcb.build_block_map(torch.as_tensor(pos), torch.as_tensor(valid), tg,
                            cap=16, c_max=128)


def test_occupied_rows_is_the_occupied_prefix():
    jg, tg = _grids(2, 8.0, None)
    pos, valid = _cloud(2, 600, 8.0, np.float64, seed=3)
    bm = tcb.build_block_map(torch.as_tensor(pos), torch.as_tensor(valid), tg,
                             cap=16, c_max=128)
    assert tcb.occupied_rows(bm.nbr_block) == int(bm.n_occ)
