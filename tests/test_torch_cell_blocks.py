"""Parity of the port's cell-block slotting with the JAX package: the
integer outputs of build_block_map (occupied cells, window rows, slot
permutation, run starts, overflow) must be EQUAL, and the carried blocks
exact, on seeded 2D and 3D clouds — including capacity overflows, an
n_max bound and periodic grids; and the periodic position wrap."""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sphinxsys_tpu.neighbors import cell_blocks as jcb
from sphinxsys_tpu.neighbors.cell_list import grid_from_bounds as j_grid
from sphinxsys_tpu.neighbors.cell_list import wrap_positions as j_wrap
from sphinxsys_tpu_torch.neighbors import cell_blocks as tcb
from sphinxsys_tpu_torch.neighbors.cell_list import grid_from_bounds as t_grid
from sphinxsys_tpu_torch.neighbors.cell_list import wrap_positions as tcb_wrap

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


# name: (dim, periodic axes)
PERIODIC = {"2d_xy": (2, (True, True)), "2d_x": (2, (True, False)),
            "3d_xyz": (3, (True, True, True))}


@pytest.mark.parametrize("name", list(PERIODIC))
def test_periodic_window_rows_match_jax(name):
    """Window rows wrap modulo the grid on periodic axes.  Every integer
    output of build_block_map is equal, and the window rows are equal on
    the occupied rows.  Padding rows (occ_cells == ncells) are all-sentinel
    in the port; the JAX package's per-window fallback, which every grid
    periodic beyond axis 0 takes, unflattens the sentinel id into a real
    cell there.  Padding rows hold only padding slots, so no sum over real
    slots sees them, and only the occupied rows are compared."""
    dim, periodic = PERIODIC[name]
    extent, n, cap, c_max = 6.0, 700, 48, 256 if dim == 3 else 64
    pos, valid = _cloud(dim, n, extent, np.float64, seed=len(name))
    # some particles outside the box on each side: their cells wrap
    pos[::7, 0] += extent
    pos[3::7, 0] -= extent
    jg, tg = _grids(dim, extent, periodic)
    jbm = jax.jit(partial(jcb.build_block_map, grid=jg, cap=cap, c_max=c_max,
                          with_inverse=False))(jnp.asarray(pos), jnp.asarray(valid))
    tbm = tcb.build_block_map(torch.as_tensor(pos), torch.as_tensor(valid), tg,
                              cap=cap, c_max=c_max)
    for k in INT_FIELDS:
        if k != "nbr_block":
            np.testing.assert_array_equal(getattr(tbm, k).numpy(),
                                          np.asarray(getattr(jbm, k)), err_msg=k)
    assert not bool(tbm.overflow)
    n_occ = int(tbm.n_occ)
    nbr_t, nbr_j = tbm.nbr_block.numpy(), np.asarray(jbm.nbr_block)
    np.testing.assert_array_equal(nbr_t[:n_occ], nbr_j[:n_occ])
    assert (nbr_t[n_occ:] == c_max).all()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_wrap_positions_matches_jax(dtype):
    """Positions far outside the box, on cell faces and exactly on the box
    edges map back into the box as jnp.mod maps them (the sign of the
    divisor), on the periodic axis only."""
    rng = np.random.default_rng(4)
    pos = rng.uniform(-13.0, 19.0, size=(500, 2))
    pos[:40] = np.round(pos[:40])                # multiples of the length
    pos[40:60, 0] = -1e-9                        # just below the lower edge
    pos = pos.astype(dtype)
    jg, tg = _grids(2, 6.0, (True, False))
    got = tcb_wrap(torch.as_tensor(pos), tg).numpy()
    ref = np.asarray(j_wrap(jnp.asarray(pos), jg))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[:, 1], pos[:, 1])
    assert (got[:, 0] >= 0.0).all() and (got[:, 0] <= 6.0).all()


def test_wrap_positions_is_identity_without_periodic_axes():
    """On a grid with no periodic axis the wrap returns the positions
    unchanged, FAR-parked padding included, as JAX's does: the re-slot
    wraps every scene's positions, wall-bounded ones too."""
    rng = np.random.default_rng(5)
    pos = rng.uniform(-13.0, 19.0, size=(300, 3))
    pos[:10] = 1e16
    jg, tg = _grids(3, 6.0, None)
    got = tcb_wrap(torch.as_tensor(pos), tg)
    np.testing.assert_array_equal(got.numpy(), pos)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_wrap(jnp.asarray(pos), jg)))


def test_occupied_rows_is_the_occupied_prefix():
    jg, tg = _grids(2, 8.0, None)
    pos, valid = _cloud(2, 600, 8.0, np.float64, seed=3)
    bm = tcb.build_block_map(torch.as_tensor(pos), torch.as_tensor(valid), tg,
                             cap=16, c_max=128)
    assert tcb.occupied_rows(bm.nbr_block) == int(bm.n_occ)
