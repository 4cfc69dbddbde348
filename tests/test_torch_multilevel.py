"""Parity of the port's multi-level neighbour search
(sphinxsys_tpu_torch/neighbors/multilevel.py) with the JAX package's on
the CPU.

A seeded two-level cloud (numpy default_rng: uniform positions, h ratios
1, 2 and the ramp between, float64 and float32), with and without a
periodic box, its valid rows given as a count or as a bool mask with
holes: the levels, every level's cell table (table, counts, overflow)
and the adaptive list (idx, count, overflow) equal JAX's exactly, holes
and slot order included; the same with the caps cut so that both
overflow.  The list's pairs are the brute-force set of
tests/test_multilevel.py (r < kernel_size max(h_i, h_j), each pair once).
`adaptive_density_summation` within 1e-12 (float64) and 2e-5 (float32)
of max |JAX|.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_viscosity import DTYPES, TOL, close

from sphinxsys_tpu.core import kernels as jk
from sphinxsys_tpu.neighbors import cell_list as jcl
from sphinxsys_tpu.neighbors import multilevel as jml
from sphinxsys_tpu_torch.core import kernels as tk
from sphinxsys_tpu_torch.neighbors import multilevel as tml

torch.set_num_threads(1)

H_REF = 0.13
KS = 2.0
N = 260


def cloud(dtype, seed=0):
    """(pos, h_ratio, mass) of the cloud on [0, 1]^2."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 1.0, size=(N, 2))
    hr = rng.choice([1.0, 2.0, 1.5, 1.25], size=N)
    mass = 0.01 * (0.5 + rng.random(N)) / hr ** 2
    return pos.astype(dtype), hr.astype(dtype), mass.astype(dtype)


def holes(seed=1):
    rng = np.random.default_rng(seed)
    return rng.random(N) > 0.15


def both(pos, hr, valid, dtype, periodic, cap=48, k=(128, 96)):
    """(JAX tables, list), (port tables, list)."""
    box = (1.0, 1.0) if periodic else None
    per = (True, True) if periodic else None
    jv = jnp.asarray(valid) if isinstance(valid, np.ndarray) \
        else jnp.int32(valid)
    tv = torch.as_tensor(valid) if isinstance(valid, np.ndarray) else valid
    jp, jh = jnp.asarray(pos), jnp.asarray(hr)
    tp, th = torch.as_tensor(pos), torch.as_tensor(hr)

    @jax.jit
    def jax_build(jp, jv, jh):
        jt = jml.build_multilevel_tables(jp, jv, jh, (0.0, 0.0), (1.0, 1.0),
                                         H_REF, kernel_size=KS, n_levels=2,
                                         cap=cap, periodic=per)
        return jt.tables, jt.level_of, jml.build_adaptive_neighbor_list(
            jp, jv, jh, jp, jh, jt, KS, H_REF, k_max_per_level=k, box=box)

    tables, level_of, jl = jax_build(jp, jv, jh)
    cutoffs = tuple(KS * H_REF / 2 ** l for l in range(2))
    jt = jml.MultilevelTables(
        grids=tuple(jcl.grid_from_bounds((0.0, 0.0), (1.0, 1.0), c,
                                         periodic=per) for c in cutoffs),
        tables=tables, level_of=level_of, cutoffs=cutoffs)
    tt = tml.build_multilevel_tables(tp, tv, th, (0.0, 0.0), (1.0, 1.0),
                                     H_REF, kernel_size=KS, n_levels=2,
                                     cap=cap, periodic=per)
    tl = tml.build_adaptive_neighbor_list(tp, tv, th, tp, th, tt, KS, H_REF,
                                          k_max_per_level=k, box=box)
    return (jt, jl), (tt, tl)


def same_tables(jt, tt):
    np.testing.assert_array_equal(tt.level_of.numpy(), np.asarray(jt.level_of))
    assert tt.cutoffs == jt.cutoffs
    for jg, tg in zip(jt.grids, tt.grids):
        assert tuple(tg.lower) == tuple(jg.lower)
        assert tuple(tg.shape) == tuple(jg.shape)
        assert tuple(tg.spacing) == tuple(jg.spacing)
    for a, b in zip(jt.tables, tt.tables):
        np.testing.assert_array_equal(b.table.numpy(), np.asarray(a.table))
        np.testing.assert_array_equal(b.counts.numpy(), np.asarray(a.counts))
        assert bool(b.overflow) == bool(a.overflow)


def same_list(jl, tl):
    np.testing.assert_array_equal(tl.idx.numpy(), np.asarray(jl.idx))
    np.testing.assert_array_equal(tl.count.numpy(), np.asarray(jl.count))
    assert bool(tl.overflow) == bool(jl.overflow)


@pytest.mark.parametrize("masked", (False, True), ids=("count", "mask"))
@pytest.mark.parametrize("periodic", (False, True), ids=("open", "periodic"))
@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
def test_tables_and_list_equal_jax(dtype, periodic, masked):
    pos, hr, _ = cloud(dtype)
    valid = holes() if masked else N - 7
    (jt, jl), (tt, tl) = both(pos, hr, valid, dtype, periodic)
    same_tables(jt, tt)
    same_list(jl, tl)
    assert not bool(tl.overflow)
    # the level-1 block keeps its holes: some slot after a hole is real
    idx = tl.idx.numpy()
    k0 = 128
    assert (idx[:, :k0] < N).sum() > 0 and (idx[:, k0:] < N).sum() > 0


@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
def test_overflow_flags_equal_jax(dtype):
    pos, hr, _ = cloud(dtype)
    for cap, k in ((3, (128, 96)), (48, (12, 9))):
        (jt, jl), (tt, tl) = both(pos, hr, N, dtype, False, cap=cap, k=k)
        same_tables(jt, tt)
        same_list(jl, tl)
        assert bool(tl.overflow)


@pytest.mark.parametrize("periodic", (False, True), ids=("open", "periodic"))
def test_pairs_are_the_brute_force_set(periodic):
    pos, hr, _ = cloud(np.float64)
    _, (_, tl) = both(pos, hr, N, np.float64, periodic)
    idx = tl.idx.numpy()
    got = {(i, int(j)) for i in range(N) for j in idx[i] if j < N}
    assert len(got) == int(tl.count.sum())   # each pair once
    h = H_REF / hr
    d = pos[:, None, :] - pos[None, :, :]
    if periodic:
        d = d - np.round(d)
    r = np.linalg.norm(d, axis=-1)
    want = {(i, j) for i in range(N) for j in range(N)
            if i != j and r[i, j] < KS * max(h[i], h[j])}
    assert got == want, (len(got - want), len(want - got))


@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
def test_adaptive_density_summation_matches_jax(dtype):
    pos, hr, mass = cloud(dtype)
    (_, jl), (_, tl) = both(pos, hr, N, dtype, False)
    ref = jml.adaptive_density_summation(
        jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(hr), jl,
        jk.WendlandC2(h=H_REF), 2, H_REF)
    got = tml.adaptive_density_summation(
        torch.as_tensor(pos), torch.as_tensor(mass), torch.as_tensor(hr), tl,
        tk.WendlandC2(h=H_REF), 2, H_REF)
    close(got, ref, TOL[dtype], "rho")


def test_particle_levels():
    hr = np.asarray([0.5, 1.0, 1.5, 1.999, 2.0, 3.9, 4.0, 9.0])
    for n in (1, 2, 3):
        np.testing.assert_array_equal(
            tml.particle_levels(torch.as_tensor(hr), n).numpy(),
            np.asarray(jml.particle_levels(jnp.asarray(hr), n)))
