"""The port's ring of ranks (parallel/mesh.py) and the slab machinery of
parallel/domain.py, on the CPU: the communicator's semantics (JAX's
ppermute, zeros at a non-periodic end; pmax / pmin / psum; axis_index),
a rank's error raised from `run`, the state sharding; and the band
compaction and arrival merge held to the JAX package's functions on
seeded inputs (exact: they move rows), migration and band exchange over
a ring of 4 against a plain numpy model of the slab rules."""

import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sphinxsys_tpu.neighbors.cell_list import grid_from_bounds as j_grid
from sphinxsys_tpu.parallel import domain as jdm
from sphinxsys_tpu_torch import convert
from sphinxsys_tpu_torch.neighbors.cell_list import grid_from_bounds as t_grid
from sphinxsys_tpu_torch.parallel import domain as tdm
from sphinxsys_tpu_torch.parallel import mesh

torch.set_num_threads(1)


@pytest.mark.parametrize("periodic", [False, True], ids=["open", "periodic"])
@pytest.mark.parametrize("n", [1, 4])
def test_thread_ring_shift_and_reductions(n, periodic):
    ring = mesh.make_particle_mesh(n, device="cpu")
    assert ring.size == n

    def body(x):
        r = ring.index()
        right, left = ring.shift([x, x * 10], +1, periodic)
        back, = ring.shift([x], -1, periodic)
        return (r, right, left, back, ring.pmax(x[0]), ring.pmin(x[0]),
                ring.psum(x[0]))

    xs = [torch.tensor([float(r + 1), -float(r)]) for r in range(n)]
    out = ring.run(body, xs)
    for r, (idx, right, left, back, mx, mn, sm) in enumerate(out):
        assert idx == r
        src = (r - 1) % n if periodic else r - 1
        want = xs[src] if 0 <= src < n else torch.zeros(2)
        assert torch.equal(right, want) and torch.equal(left, want * 10)
        src = (r + 1) % n if periodic else r + 1
        want = xs[src] if 0 <= src < n else torch.zeros(2)
        assert torch.equal(back, want)
        assert float(mx) == n and float(mn) == 1 and float(sm) == n * (n + 1) / 2


def test_thread_ring_raises_a_rank_error():
    ring = mesh.ThreadRing(3, "cpu", timeout=30.0)

    def body(x):
        if ring.index() == 1:
            raise ValueError("rank 1 fails")
        return ring.pmax(x)

    with pytest.raises(ValueError, match="rank 1 fails"):
        ring.run(body, [torch.tensor(1.0)] * 3)
    # the ring works again afterwards
    assert [float(v) for v in ring.run(ring.psum, [torch.tensor(2.0)] * 3)] \
        == [6.0] * 3
    with pytest.raises(RuntimeError):
        ring.index()                   # not inside a rank's thread
    with pytest.raises(ValueError):
        ring.run(ring.psum, [torch.tensor(1.0)] * 2)


def test_no_ring_without_a_group_and_no_silent_fallback():
    with pytest.raises(RuntimeError, match="process group"):
        mesh.ProcessGroupRing()
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_particle_mesh(2, device="cpu", kind="process")
    with pytest.raises(ValueError):
        mesh.make_particle_mesh(2, device="cpu", kind="mpi")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            mesh.ThreadRing(2, "cuda")
        with pytest.raises(RuntimeError):     # the card is the default
            mesh.ThreadRing(2)


def test_shard_state_and_pytree():
    ring = mesh.ThreadRing(3, "cpu")
    n = 10
    st = {"Position": torch.arange(2 * n, dtype=torch.float64).reshape(n, 2),
          "Mass": torch.ones(n), "OriginalID": torch.arange(n, dtype=torch.int32),
          "NReal": 9, "c0": 2.5, "tab": torch.zeros(4)}
    pieces = mesh.shard_state(st, ring, multiple=8)
    assert [p["Position"].shape[0] for p in pieces] == [8, 8, 8]
    assert [p["NReal"] for p in pieces] == [4, 4, 1]
    assert torch.equal(pieces[0]["Position"][:4], st["Position"][:4])
    assert torch.equal(pieces[1]["Position"][0], st["Position"][4])
    assert torch.equal(pieces[2]["Position"][:2], st["Position"][8:])
    assert float(pieces[2]["Position"][2, 0]) == mesh.FAR
    assert float(pieces[0]["Mass"][5]) == 1.0
    assert int(pieces[2]["OriginalID"][2]) == 0
    assert pieces[1]["c0"] == 2.5 and pieces[1]["tab"] is st["tab"]
    tree = {"a": torch.arange(6), "b": (torch.arange(12).reshape(6, 2), 3),
            "c": torch.arange(4)}
    parts = mesh.shard_pytree_leaves(tree, ring)
    assert torch.equal(parts[2]["a"], torch.tensor([4, 5]))
    assert torch.equal(parts[1]["b"][0], torch.tensor([[4, 5], [6, 7]]))
    assert parts[0]["b"][1] == 3 and parts[0]["c"] is tree["c"]
    assert mesh.round_up(9, 8) == 16


def _band_inputs(seed, n=40):
    rng = np.random.default_rng(seed)
    fields = {"Position": rng.normal(size=(n, 2)),
              "Velocity": rng.normal(size=(n, 2)),
              "OriginalID": rng.integers(0, 10 ** 6, size=n).astype(np.int32)}
    return fields, rng.uniform(size=n) < 0.4


@pytest.mark.parametrize("cap", [4, 32])
def test_compact_band_matches_jax(cap):
    fields, mask = _band_inputs(1)
    jb, jovf = jdm._compact_band({k: jnp.asarray(v) for k, v in fields.items()},
                                 jnp.asarray(mask), cap)
    tb, tovf = tdm._compact_band({k: torch.as_tensor(v) for k, v in
                                  fields.items()}, torch.as_tensor(mask), cap)
    assert bool(tovf) == bool(jovf) == (mask.sum() > cap)
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]),
                                      err_msg=k)


@pytest.mark.parametrize("n_arrive", [3, 30])
def test_merge_arrivals_matches_jax(n_arrive):
    fields, _ = _band_inputs(2)
    n = 40
    rng = np.random.default_rng(3)
    alive = rng.uniform(size=n) < 0.7
    recv = {k: v[:32].copy() for k, v in fields.items()}
    recv["BandAlive"] = (np.arange(32) < n_arrive).astype(np.float64)
    jst = {k: jnp.asarray(v) for k, v in fields.items()}
    jst["Alive"] = jnp.asarray(alive)
    tst = {k: torch.as_tensor(v) for k, v in fields.items()}
    tst["Alive"] = torch.as_tensor(alive)
    keys = list(fields)
    jout, jovf = jdm._merge_arrivals(jst, {k: jnp.asarray(v) for k, v in
                                           recv.items()}, keys)
    tout, tovf = tdm._merge_arrivals(tst, {k: torch.as_tensor(v) for k, v in
                                           recv.items()}, keys)
    assert bool(tovf) == bool(jovf) == (n_arrive > (~alive).sum())
    for k in jout:
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]),
                                      err_msg=k)


@pytest.mark.parametrize("periodic", [False, True], ids=["open", "periodic"])
def test_migration_and_bands_over_a_ring(periodic):
    """4 slabs of [0, 4): each rank's rows are moved by a seeded shift;
    after migrate_rows every live row sits on the rank of its slab (a
    periodic ring wraps rows past the ends by the length), no row is lost
    or doubled; band_exchange hands each rank its neighbours' rows within
    the cutoff of its faces, wrapped across a periodic end."""
    grid = t_grid((0.0, 0.0), (4.0, 1.0), 0.25, buffer_cells=0)
    assert grid.lower[0] == 0.0 and grid.shape[0] == 16
    ring = mesh.ThreadRing(4, "cpu")
    dec = tdm.SlabDecomposition(grid=grid, n_dev=4, cutoff=0.25,
                                periodic=periodic, halo_cap=64, migrate_cap=32,
                                halo_fields=("Position", "OriginalID"))
    rng = np.random.default_rng(5)
    n_loc = 48
    pieces = []
    for r in range(4):
        pos = np.stack([r + rng.uniform(size=n_loc), rng.uniform(size=n_loc)], 1)
        alive = np.arange(n_loc) < 20
        ids = (r * 100 + np.arange(n_loc)).astype(np.int32)
        pos[:20, 0] += rng.uniform(-0.4, 0.4, size=20)
        pieces.append({"Position": torch.as_tensor(pos),
                       "OriginalID": torch.as_tensor(ids),
                       "Alive": torch.as_tensor(alive)})

    def body(f):
        r = ring.index()
        lo, hi = dec.slab(r)
        f, ovf = tdm.migrate_rows(f, dec, ring, lo, hi, r == 3, r == 0,
                                  ["Position", "OriginalID"])
        near_r = f["Alive"] & (f["Position"][:, 0] >= hi - dec.cutoff)
        near_l = f["Alive"] & (f["Position"][:, 0] < lo + dec.cutoff)
        gl, gr, hovf = tdm.band_exchange(
            {"Position": f["Position"], "OriginalID": f["OriginalID"]},
            near_r, near_l, dec, ring, r == 3, r == 0)
        return f, gl, gr, bool(ovf), bool(hovf)

    out = ring.run(body, pieces)
    ids_before = sorted(int(i) for p in pieces
                        for i in p["OriginalID"][p["Alive"]])
    ids_after = []
    owner = {}
    for r, (f, gl, gr, ovf, hovf) in enumerate(out):
        assert not ovf and not hovf
        a = f["Alive"].numpy()
        x = f["Position"].numpy()[a, 0]
        ids = f["OriginalID"].numpy()[a]
        ids_after += ids.tolist()
        lo, hi = dec.slab(r)
        inside = (x >= lo) & (x < hi)
        if not periodic:       # the end slabs keep the rows past the ends
            inside |= (x < lo) & (r == 0) | (x >= hi) & (r == 3)
        assert inside.all()
        for i, xi in zip(ids, x):
            owner[int(i)] = (r, xi)
    assert sorted(ids_after) == ids_before
    for r, (f, gl, gr, _, _) in enumerate(out):
        lo, hi = dec.slab(r)
        for g, side in ((gl, -1), (gr, +1)):
            live = g["BandAlive"].numpy() > 0.5
            got = sorted(g["OriginalID"].numpy()[live].tolist())
            src = (r + side) % 4 if periodic else r + side
            want = []
            if 0 <= src < 4:
                for i, (o, xi) in owner.items():
                    if o != src:
                        continue
                    slo, shi = dec.slab(src)
                    if (side < 0 and xi >= shi - 0.25) or \
                            (side > 0 and xi < slo + 0.25):
                        want.append(i)
            assert got == sorted(want)
            gx = g["Position"].numpy()[live, 0]
            assert ((gx >= lo - 0.25 - 1e-12) & (gx < hi + 0.25)).all()
            assert (g["Position"].numpy()[~live] == tdm.FAR).all()


def test_halo_shard_from_numpy_splits_device_rows():
    fluid = {"Position": np.arange(24.0).reshape(12, 2),
             "Alive": np.arange(12) % 3 > 0}
    sim = convert.halo_shard_from_numpy(fluid, 4, time=0.5, n_adv=2, n_ac=9)
    assert len(sim.fluid) == 4 and sim.n_adv == 2 and sim.n_ac == 9
    assert torch.equal(sim.fluid[1]["Position"],
                       torch.tensor([[6.0, 7.0], [8.0, 9.0], [10.0, 11.0]],
                                    dtype=torch.float64))
    assert sim.fluid[3]["Alive"].tolist() == [False, True, True]
    assert float(sim.time) == 0.5 and not bool(sim.overflow)
    with pytest.raises(ValueError):
        convert.halo_shard_from_numpy(fluid, 5)


def test_slab_geometry_matches_jax():
    jg = j_grid((0.0, 0.0), (5.0, 2.0), 0.3)
    tg = t_grid((0.0, 0.0), (5.0, 2.0), 0.3)
    jd = jdm.SlabDecomposition(grid=jg, n_dev=8, cutoff=0.3)
    td = tdm.SlabDecomposition(grid=tg, n_dev=8, cutoff=0.3)
    for attr in ("lo", "hi", "slab_width", "length"):
        assert getattr(td, attr) == getattr(jd, attr)
    assert td.slab(3) == (td.lo + 3 * td.slab_width,
                          td.lo + 4 * td.slab_width)
    assert threading.active_count() >= 1
