"""Parity of the port's cell-block inverse map and packed conversions
(neighbors/cell_blocks.py: build_block_map `with_inverse`, from_blocks,
to_blocks_packed, from_blocks_packed, gather_window) with the JAX
package's, on seeded clouds: every integer and every packed value exact
(int32 fields bit-exact through the float container), and the JAX test
they mirror (tests/test_cell_blocks.py:22-34, :89-97)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sphinxsys_tpu.neighbors import cell_blocks as jcb
from sphinxsys_tpu.neighbors import grid_from_bounds as j_grid
from sphinxsys_tpu_torch.neighbors import cell_blocks as tcb
from sphinxsys_tpu_torch.neighbors.cell_list import grid_from_bounds as t_grid

torch.set_num_threads(1)


# ---------------------------------------------------------------------------

def _cloud(n, dim, seed, dtype=np.float64):
    pos = np.random.default_rng(seed).uniform(0.0, 1.0, size=(n, dim))
    return pos.astype(dtype)


@pytest.mark.parametrize("dim", [2, 3])
def test_inverse_map_and_from_blocks_match_jax(dim):
    """particle_slot equal to JAX's (valid rows, an overflowing cap, a
    c_max too small); from_blocks exact; tests/test_cell_blocks.py:22-34
    and :89-97 (every particle slotted once, the inverse consistent, the
    round trip exact)."""
    n = 500
    pos = _cloud(n, dim, 1)
    valid = np.random.default_rng(2).uniform(size=n) < 0.85
    for cutoff, cap, c_max in ((0.11, 16, 512), (0.11, 2, 24)):
        jg = j_grid([0.0] * dim, [1.0] * dim, cutoff)
        tg = t_grid([0.0] * dim, [1.0] * dim, cutoff)
        jbm = jcb.build_block_map(jnp.asarray(pos), jnp.asarray(valid), jg,
                                  cap=cap, c_max=c_max, with_inverse=True)
        tbm = tcb.build_block_map(torch.as_tensor(pos), torch.as_tensor(valid),
                                  tg, cap=cap, c_max=c_max, with_inverse=True)
        np.testing.assert_array_equal(tbm.particle_slot.numpy(),
                                      np.asarray(jbm.particle_slot))
        assert bool(tbm.overflow) == bool(jbm.overflow)
        vals = np.random.default_rng(5).normal(size=(n, 2))
        blocks = tcb.to_blocks(tbm, torch.as_tensor(vals))
        np.testing.assert_array_equal(
            tcb.from_blocks(tbm, blocks, n).numpy(),
            np.asarray(jcb.from_blocks(jbm, jcb.to_blocks(jbm, jnp.asarray(vals)),
                                       n)))
        if not bool(tbm.overflow):
            sp, ps = tbm.slot_particle.numpy(), tbm.particle_slot.numpy()
            filled = sp[sp < n]
            assert sorted(filled.tolist()) == np.nonzero(valid)[0].tolist()
            assert (sp[ps[valid]] == np.nonzero(valid)[0]).all()
            np.testing.assert_array_equal(
                tcb.from_blocks(tbm, blocks, n).numpy()[valid], vals[valid])
    assert tcb.build_block_map(torch.as_tensor(pos), n, tg, cap=16,
                               c_max=512).particle_slot is None


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_packed_blocks_match_jax_and_ints_ride_exact(dtype):
    """to_blocks_packed / from_blocks_packed against JAX's (exact), int32
    fields bit-exact through the float container (values whose bit
    patterns are float NaN, infinities and subnormals among them), the
    fills in padding slots and the sentinel row, and the mask of a
    particle with no slot."""
    n = 400
    pos = _cloud(n, 2, 3, dtype)
    valid = np.random.default_rng(4).uniform(size=n) < 0.9
    rng = np.random.default_rng(6)
    ids = rng.integers(-2 ** 31, 2 ** 31 - 1, size=n).astype(np.int32)
    ids[:4] = [0x7FC00001, 0x7F800000, 1, -1]        # NaN, inf, subnormal
    fields = {"Position": pos, "Velocity": rng.normal(size=(n, 2)).astype(dtype),
              "Density": rng.normal(size=n).astype(dtype), "OriginalID": ids}
    # JAX packs (N,) and (N, k) fields; the port also (N, d, d) ones
    matrix = torch.as_tensor(rng.normal(size=(n, 2, 2)).astype(dtype))
    fills = {"Position": 1e16, "Density": 1.0, "OriginalID": 2 ** 31 - 1}
    for cap, c_max in ((12, 256), (3, 256)):
        jg, tg = j_grid([0, 0], [1, 1], 0.09), t_grid([0, 0], [1, 1], 0.09)
        jbm = jcb.build_block_map(jnp.asarray(pos), jnp.asarray(valid), jg,
                                  cap=cap, c_max=c_max, with_inverse=True)
        tbm = tcb.build_block_map(torch.as_tensor(pos), torch.as_tensor(valid),
                                  tg, cap=cap, c_max=c_max, with_inverse=True)
        jfb = jcb.to_blocks_packed(jbm, {k: jnp.asarray(v) for k, v in
                                         fields.items()}, fills)
        tfb = tcb.to_blocks_packed(tbm, {k: torch.as_tensor(v) for k, v in
                                         fields.items()}, fills)
        for k in fields:
            assert tfb[k].dtype == torch.as_tensor(fields[k]).dtype
            np.testing.assert_array_equal(tfb[k].numpy(), np.asarray(jfb[k]),
                                          err_msg=k)
            np.testing.assert_array_equal(
                tfb[k].numpy(), tcb.to_blocks(tbm, torch.as_tensor(fields[k]),
                                              fill=fills.get(k, 0.0)).numpy())
        tm = tcb.to_blocks_packed(tbm, {"M": matrix, "OriginalID":
                                        torch.as_tensor(ids)}, fills)
        np.testing.assert_array_equal(tm["M"].numpy(),
                                      tcb.to_blocks(tbm, matrix).numpy())
        back, _ = tcb.from_blocks_packed(tbm, tm, ["M", "OriginalID"], n)
        ok = back["OriginalID"].numpy() == ids
        np.testing.assert_array_equal(back["M"].numpy()[ok], matrix.numpy()[ok])
        jflat, jok = jcb.from_blocks_packed(jbm, jfb, list(fields), n)
        tflat, tok = tcb.from_blocks_packed(tbm, tfb, list(fields), n)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        for k in fields:
            np.testing.assert_array_equal(tflat[k].numpy(), np.asarray(jflat[k]),
                                          err_msg=k)
        ok = tok.numpy()
        np.testing.assert_array_equal(tflat["OriginalID"].numpy()[ok], ids[ok])
        assert (~ok).any() == bool(tbm.overflow) or not valid.all()


def test_gather_window_matches_jax():
    """(The cloud and map of test_inverse_map_and_from_blocks_match_jax[2],
    so that JAX reuses its compiled ops.)"""
    n = 500
    pos = _cloud(n, 2, 1)
    valid = np.random.default_rng(2).uniform(size=n) < 0.85
    jg, tg = j_grid([0.0] * 2, [1.0] * 2, 0.11), t_grid([0.0] * 2, [1.0] * 2, 0.11)
    jbm = jcb.build_block_map(jnp.asarray(pos), jnp.asarray(valid), jg, cap=16,
                              c_max=512, with_inverse=True)
    tbm = tcb.build_block_map(torch.as_tensor(pos), torch.as_tensor(valid), tg,
                              cap=16, c_max=512)
    vals = np.random.default_rng(8).normal(size=(n, 3))
    got = tcb.gather_window(tcb.to_blocks(tbm, torch.as_tensor(vals)),
                            tbm.nbr_block)
    ref = jcb.gather_window(jcb.to_blocks(jbm, jnp.asarray(vals)), jbm.nbr_block)
    assert got.shape == (512, 9, 16, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
