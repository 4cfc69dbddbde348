"""Parity of the port's explicit particle relaxation (physics/relax.py) with
the JAX package, on the CPU in float64: the Taylor–Green lattice at
dx = 0.05 (doubly periodic) and fsi2's insert (cylinder and beam) at
dx = 0.1, inside its shape.

The residual, the scaling, the surface bounding, the surface correction
and the half-space table are held within 1e-12 of max|ref|.  The jitter
comes from another generator on each side (jax.random there, a seeded
torch.Generator here), so the loops are held from JAX's jittered
positions: 20 iterations of each loop within 1e-10 of JAX's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sphinxsys_tpu.cases import fsi2 as jf, taylor_green_2d as jtg
from sphinxsys_tpu.core import geometry as JG
from sphinxsys_tpu.core.adaptation import SPHAdaptation as JAdaptation
from sphinxsys_tpu.core.kernels import WendlandC2 as JWendland
from sphinxsys_tpu.neighbors import build_cell_table as jtable
from sphinxsys_tpu.neighbors import build_neighbor_list as jlist
from sphinxsys_tpu.neighbors import grid_from_bounds as jgrid
from sphinxsys_tpu.neighbors.cell_list import wrap_positions as jwrap
from sphinxsys_tpu.physics import relax as jrx
from sphinxsys_tpu_torch.core import geometry as TG
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation as TAdaptation
from sphinxsys_tpu_torch.core.kernels import WendlandC2 as TWendland
from sphinxsys_tpu_torch.neighbors.cell_list import grid_from_bounds as tgrid
from sphinxsys_tpu_torch.neighbors.neighbor_list import NeighborList
from sphinxsys_tpu_torch.physics import relax as trx

torch.set_num_threads(1)

TOL = 1e-12
LOOP_TOL = 1e-10
N_IT = 20


def _close(got, ref, tol=TOL, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-300), f"{what}: {err:.3e}"


def _insert(G):
    """fsi2's insert (cylinder + beam) in the geometry module G."""
    cyl = G.Ball(center=jf.CYL_CENTER, radius=jf.CYL_R)
    beam = G.Box(G.Transform(translation=(jf.CYL_CENTER[0] + (jf.CYL_R + jf.BL)
                                          / 2, jf.CYL_CENTER[1])),
                 halfsize=((jf.CYL_R + jf.BL) / 2, jf.BH / 2))
    return G.make_complex(("add", cyl), ("add", beam))


def _insert_grid(grid_from_bounds, dx):
    pad = 6 * dx
    return grid_from_bounds(
        (jf.CYL_CENTER[0] - jf.CYL_R - pad, jf.CYL_CENTER[1] - jf.CYL_R - pad),
        (jf.CYL_CENTER[0] + jf.CYL_R + jf.BL + pad,
         jf.CYL_CENTER[1] + jf.CYL_R + pad), 2.6 * dx)


@pytest.fixture(scope="module")
def tg_inputs():
    """The TG lattice at dx = 0.05, JAX's jittered and wrapped positions,
    its inner list on them, and the scene's pieces on both sides."""
    jcase, jfluid = jtg.build_case(dx=0.05, dtype=jnp.float64)
    ad_j, ad_t = JAdaptation(spacing=0.05, dim=2), TAdaptation(spacing=0.05,
                                                               dim=2)
    grid_t = tgrid((0.0, 0.0), (1.0, 1.0), ad_t.cutoff, periodic=(True, True))
    pos0 = jfluid["Position"]
    jit = jwrap(jrx.randomize_positions(pos0, 0.05, 3), jcase.grid)
    n = jit.shape[0]
    nl = jlist(jit, n, jit, n, jtable(jit, n, jcase.grid, cap=32), jcase.grid,
               ad_j.cutoff, k_max=64, include_self=False)
    return dict(jcase=jcase, ad_j=ad_j, ad_t=ad_t, grid_t=grid_t, pos0=pos0,
                jit=jit, nl=nl, vol=0.05 ** 2)


@pytest.fixture(scope="module")
def insert_inputs():
    """fsi2's insert at dx = 0.1: JAX's jittered, bounded positions."""
    dx = 0.1
    _, _, jsolid = jf.build_case(dx=dx, dtype=jnp.float64)
    shape_j, shape_t = _insert(JG), _insert(TG)
    pos0 = jsolid["Position"]
    jit = jrx.surface_bounding(jrx.randomize_positions(pos0, dx, 0), shape_j,
                               dx)
    return dict(dx=dx, shape_j=shape_j, shape_t=shape_t, pos0=pos0, jit=jit,
                ad_j=JAdaptation(spacing=dx, dim=2),
                ad_t=TAdaptation(spacing=dx, dim=2),
                grid_j=_insert_grid(jgrid, dx), grid_t=_insert_grid(tgrid, dx),
                vol=dx * dx)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _carried(nl):
    return NeighborList(idx=_t(nl.idx), count=_t(nl.count),
                        overflow=torch.as_tensor(bool(nl.overflow)))


@pytest.mark.parametrize("periodic", [True, False], ids=["box", "no_box"])
def test_residual_and_scaling_match_jax(tg_inputs, periodic):
    """The residual with and without the minimum image, and its scaling,
    on JAX's list carried across."""
    d = tg_inputs
    box = d["jcase"].box if periodic else None
    vol = jnp.full((d["jit"].shape[0],), d["vol"])
    j = jrx.relaxation_residual(d["jit"], vol, d["nl"], d["ad_j"].kernel, 2,
                                box=box)
    t = trx.relaxation_residual(_t(d["jit"]), _t(vol), _carried(d["nl"]),
                                d["ad_t"].kernel, 2, box=box)
    _close(t.numpy(), j, what="residual")
    h = d["ad_j"].h
    assert float(trx.relaxation_scaling(t, h)) == pytest.approx(
        float(jrx.relaxation_scaling(j, h)), rel=TOL)


@pytest.mark.parametrize("dim", [2, 3])
def test_half_space_gradient_table_matches_jax(dim):
    h = 0.13
    dj, Lj = jrx.half_space_gradient_table(JWendland(h=h), dim)
    dt, Lt = trx.half_space_gradient_table(TWendland(h=h), dim)
    _close(dt, dj, what="d_grid")
    _close(Lt, Lj, what="L")
    assert Lt[0] > Lt[-1] == 0.0


def test_surface_terms_match_jax(insert_inputs):
    """The surface correction (through the half-space table and the
    piecewise-linear interpolation) and the surface bounding, on positions
    jittered by up to a spacing so that some leave the shape."""
    d = insert_inputs
    rng = np.random.default_rng(5)
    pos = np.asarray(d["pos0"]) + d["dx"] * (rng.random(d["pos0"].shape) - 0.5)
    table_j = jrx.half_space_gradient_table(d["ad_j"].kernel, 2)
    table_t = trx.half_space_gradient_table(d["ad_t"].kernel, 2)
    j = jrx.surface_residual_correction(jnp.asarray(pos), d["shape_j"], table_j)
    t = trx.surface_residual_correction(_t(pos), d["shape_t"], table_t)
    _close(t.numpy(), j, what="surface correction")
    j = jrx.surface_bounding(jnp.asarray(pos), d["shape_j"], d["dx"])
    t = trx.surface_bounding(_t(pos), d["shape_t"], d["dx"])
    _close(t.numpy(), j, what="surface bounding")
    assert (np.asarray(d["shape_j"].signed_distance(jnp.asarray(pos))) > 0).any()


def test_interp_matches_numpy():
    """The interpolation inside, at the nodes and beyond both ends."""
    xp = torch.linspace(0.0, 2.0, 9, dtype=torch.float64)
    fp = torch.cos(3.0 * xp)
    x = torch.as_tensor(np.r_[-1.0, np.linspace(0.0, 2.0, 37), 2.5])
    np.testing.assert_allclose(trx.interp(x, xp, fp).numpy(),
                               np.interp(x.numpy(), xp.numpy(), fp.numpy()),
                               rtol=0, atol=1e-15)


def test_relax_periodic_loop_matches_jax(tg_inputs):
    """N_IT iterations of the periodic loop from JAX's jittered, wrapped
    positions, against JAX's relax_periodic (same seed)."""
    d = tg_inputs
    jcase = d["jcase"]
    j = jrx.relax_periodic(d["pos0"], d["vol"], d["ad_j"], jcase.grid,
                           n_iterations=N_IT, cell_cap=32, k_max=64, seed=3,
                           box=jcase.box)
    t = trx.relax_periodic_iterations(_t(d["jit"]), d["vol"], d["ad_t"],
                                      d["grid_t"], n_iterations=N_IT,
                                      cell_cap=32, k_max=64, box=jcase.box)
    _close(t.numpy(), j, tol=LOOP_TOL, what="relax_periodic")
    assert np.abs(np.asarray(j) - np.asarray(d["jit"])).max() > 1e-4


def test_relax_shape_loop_matches_jax(insert_inputs):
    """N_IT iterations of the body-fitted loop (with the surface
    correction) from JAX's jittered, bounded positions, against JAX's
    relax_shape (same seed)."""
    d = insert_inputs
    j = jrx.relax_shape(d["shape_j"], d["pos0"], d["vol"], d["ad_j"],
                        d["grid_j"], n_iterations=N_IT, cell_cap=24,
                        k_max=64)
    t = trx.relax_shape_iterations(d["shape_t"], _t(d["jit"]), d["vol"],
                                   d["ad_t"], d["grid_t"], n_iterations=N_IT,
                                   cell_cap=24, k_max=64)
    _close(t.numpy(), j, tol=LOOP_TOL, what="relax_shape")
    assert np.abs(np.asarray(j) - np.asarray(d["jit"])).max() > 1e-4


def test_randomize_positions_is_seeded():
    """The jitter: within 0.25 spacing, the same for one seed, another for
    another seed, in the positions' dtype."""
    pos = torch.zeros((500, 2), dtype=torch.float64)
    a = trx.randomize_positions(pos, 0.1, seed=7)
    b = trx.randomize_positions(pos, 0.1, seed=7)
    c = trx.randomize_positions(pos, 0.1, seed=8)
    assert a.dtype == torch.float64
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.abs().max()) <= 0.025 and float(a.abs().max()) > 0.02
    assert abs(float(a.mean())) < 2e-3


def test_overflow_raises(tg_inputs):
    d = tg_inputs
    with pytest.raises(ValueError, match="overflow"):
        trx.relax_periodic_iterations(_t(d["jit"]), d["vol"], d["ad_t"],
                                      d["grid_t"], n_iterations=1,
                                      cell_cap=32, k_max=8,
                                      box=d["jcase"].box)
