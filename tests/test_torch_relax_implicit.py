"""Parity of the port's implicit relaxation (physics/relax.py's implicit
half, cases/implicit_relaxation_2d.py) with the JAX package on the CPU,
in float64.

The turbine blade's vertex file is not in the repository, so the
functions are held on an in-repo stand-in: a NACA 0012 section of chord 4
from its closed-form thickness (`naca0012`, 820 particles at DX = 1/25).
Each package jitters with its own generator, so the runs start from
JAX's jittered, bounded positions carried across.

* half_space_kernel_tables and one implicit_relaxation_update (the
  sampled level-set branch and the flat-surface tables' branch, JAX's
  list carried across) within 1e-12 of max |JAX|;
* 20 iterations of the relaxation (positions and the residual curve)
  within 1e-9;
* the case's lattice and level set, its blade reader (a path, the
  environment variable, neither), and the CLI without a blade.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sphinxsys_tpu.core.adaptation import SPHAdaptation as JA
from sphinxsys_tpu.core.generators import generate_lattice as j_lattice
from sphinxsys_tpu.core.geometry import Polygon as JPolygon
from sphinxsys_tpu.meshes.levelset import build_levelset as j_levelset
from sphinxsys_tpu.neighbors import build_cell_table, build_neighbor_list
from sphinxsys_tpu.neighbors.cell_list import CellGrid as JGrid
from sphinxsys_tpu.physics import relax as jr
from sphinxsys_tpu_torch import convert
from sphinxsys_tpu_torch import run as trun
from sphinxsys_tpu_torch.cases import implicit_relaxation_2d as ir
from sphinxsys_tpu_torch.physics import relax as tr

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")
N_IT, EVERY = 20, 5


def close(got, ref, tol=1e-12, what=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max(initial=0.0)
    assert err <= tol * max(np.abs(ref).max(initial=0.0), 1e-300), (what,
                                                                      err)


@functools.lru_cache(maxsize=None)
def blade():
    """(JAX: polygon, lattice, volume, adaptation, grid, level set, the
    jittered bounded start), (the port's case build)."""
    tb = ir.naca0012(4.0)
    jb = JPolygon(vertices=tb.vertices)
    lo, hi = jb.bounds()
    dom_lo, dom_hi = np.asarray(lo) - 4 * ir.DX, np.asarray(hi) + 4 * ir.DX
    pos0, vol = j_lattice(jb, dom_lo, dom_hi, ir.DX)
    ad = JA(spacing=ir.DX, dim=2)
    built = ir.build_case(tb, **F64)
    grid = JGrid(lower=tuple(dom_lo), spacing=(ad.cutoff,) * 2,
                 shape=built[3].shape)
    ls = j_levelset(jb, dom_lo, dom_hi, ir.DX, dtype=jnp.float64) \
        .update_kernel_integrals(ad.kernel, 2)
    start = jr.surface_bounding(
        jr.randomize_positions(jnp.asarray(pos0), ad.spacing, 0), jb,
        ad.spacing)
    return (jb, pos0, vol, ad, grid, ls, start), (tb, *built)


def test_case_build_matches_jax():
    (_, pos0, vol, _, grid, ls, _), (_, tpos, tvol, tad, tgrid, tls) = blade()
    np.testing.assert_array_equal(tpos.numpy(), pos0)
    assert len(pos0) == 820 and tvol == vol
    assert (tgrid.lower, tgrid.spacing, tgrid.shape) \
        == (grid.lower, grid.spacing, grid.shape)
    for k in ("coarse_map", "pkg_nbr"):
        np.testing.assert_array_equal(getattr(tls, k).numpy(),
                                      np.asarray(getattr(ls, k)))
    for k in ("phi", "kernel_w", "kernel_gw", "kernel_g2w"):
        close(getattr(tls, k), getattr(ls, k), what=k)


def test_half_space_tables_match_jax():
    (*_, ad, _, _, _), (_, _, _, tad, _, _) = blade()
    for dim in (2, 3):
        for got, ref in zip(tr.half_space_kernel_tables(tad.kernel, dim),
                            jr.half_space_kernel_tables(ad.kernel, dim)):
            close(got, ref, what=dim)


@pytest.mark.parametrize("branch", ("levelset", "tables"))
def test_implicit_update_matches_jax(branch):
    """One solve from the jittered start at dt = 0.01 (the first
    iteration's), JAX's inner list carried across."""
    (jb, _, vol, ad, grid, ls, start), (tb, _, _, tad, _, tls) = blade()
    n = start.shape[0]
    nl = build_neighbor_list(start, n, start, n,
                             build_cell_table(start, n, grid, cap=32), grid,
                             ad.cutoff, k_max=48, include_self=False)
    jvol = jnp.full((n,), vol)
    d_grid, K, Lp = jr.half_space_kernel_tables(ad.kernel, 2)
    _, L = jr.half_space_gradient_table(ad.kernel, 2)
    kw = (dict(levelset=ls) if branch == "levelset"
          else dict(shape=jb, tables=(d_grid, K, Lp, L)))
    ref = jax.jit(lambda p: jr.implicit_relaxation_update(
        p, jvol, nl, ad.kernel, 2, 1e-4, **kw))(start)
    tkw = (dict(levelset=tls) if branch == "levelset"
           else dict(shape=tb, tables=tuple(map(np.asarray,
                                                (d_grid, K, Lp, L)))))
    got = tr.implicit_relaxation_update(
        torch.as_tensor(np.asarray(start)), torch.full((n,), vol,
                                                       dtype=torch.float64),
        convert.neighbor_list_from_numpy(nl), tad.kernel, 2, 1e-4, **tkw)
    for g, r, what in zip(got, ref, ("positions", "residual")):
        close(g, r, what=what)


def test_relaxation_matches_jax():
    """20 iterations, the residual recorded every 5: positions and curve
    within 1e-9; the curve falls."""
    (jb, pos0, vol, ad, grid, ls, start), (tb, _, tvol, tad, tgrid, tls) = \
        blade()
    jp, jcurve = jr.relax_shape_implicit(jb, jnp.asarray(pos0), vol, ad,
                                         grid, n_iterations=N_IT,
                                         record_every=EVERY, levelset=ls)
    tp, tcurve = tr.relax_shape_implicit_iterations(
        tb, torch.as_tensor(np.array(start)), tvol, tad, tgrid,
        n_iterations=N_IT, record_every=EVERY, levelset=tls)
    close(tp, jp, 1e-9, "positions")
    close(tcurve, jcurve, 1e-9, "curve")
    assert tcurve.shape == (N_IT // EVERY,)
    assert (np.diff(tcurve.numpy()) < 0).all()


def test_relaxation_raises_on_overflow():
    (*_,), (tb, tpos, tvol, tad, tgrid, tls) = blade()
    with pytest.raises(ValueError, match="relax_shape_implicit"):
        tr.relax_shape_implicit(tb, tpos, tvol, tad, tgrid, n_iterations=2,
                                k_max=4, levelset=tls)


def test_blade_path_from_caller_or_environment(tmp_path, monkeypatch):
    """The blade reads only a path it is given: the argument, else the
    environment variable; with neither, FileNotFoundError."""
    monkeypatch.delenv(ir.BLADE_ENV, raising=False)
    with pytest.raises(FileNotFoundError, match=ir.BLADE_ENV):
        ir.load_blade()
    with pytest.raises(FileNotFoundError, match="none.dat"):
        ir.load_blade(str(tmp_path / "none.dat"))
    path = tmp_path / "blade.dat"
    np.savetxt(path, np.asarray(ir.naca0012(4.0).vertices))
    got = ir.load_blade(str(path)).vertices
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(ir.naca0012(4.0).vertices))
    monkeypatch.setenv(ir.BLADE_ENV, str(path))
    assert ir.load_blade().vertices == got


def test_cli_without_blade_exits_with_the_message(monkeypatch, tmp_path):
    monkeypatch.delenv(ir.BLADE_ENV, raising=False)
    with pytest.raises(SystemExit) as e:
        trun.main(["implicit_relaxation_2d", "--set", "device=cpu",
                   "--output_dir", str(tmp_path / "out")])
    assert "TurbineBlade.dat" in str(e.value.code)
    assert "/root" not in str(e.value.code)
    assert not (tmp_path / "out").exists()


def test_cli_relaxes_a_blade_file(tmp_path, caplog):
    path = tmp_path / "blade.dat"
    np.savetxt(path, np.asarray(ir.naca0012(4.0).vertices))
    out = tmp_path / "out"
    import logging
    with caplog.at_level(logging.INFO):
        assert trun.main(["implicit_relaxation_2d", "--set",
                          f"blade_path={path}", "--set", "n_iterations=4",
                          "--set", "record_every=2", "--set", "device=cpu",
                          "--set", "dtype=float64", "--output_dir",
                          str(out)]) == 0
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("ite ")]
    assert len(lines) == 2 and lines[0].startswith("ite 2:")
    assert sorted(p.name for p in out.iterdir()) == ["Body_relaxed.vtp"]
