"""Parity of the port's thick-shell relaxation (physics/relax_shell.py,
cases/shell_relaxation_2d.py) with the JAX package on the CPU, in
float64, on the case's own annulus (R = 24.5, thickness 1, dx = 0.5, the
level set at 0.1).

* the case build: the surface-lattice particles exactly, the level set's
  tables exactly and its field within 1e-12;
* probe_raw_gradient and mid_surface_bounding within 1e-12 of max |JAX|;
* 30 relaxation iterations from JAX's jittered, bounded start (each
  package jitters with its own generator) within 1e-9;
* the normal prediction on a jittered ring: _predict_normals and
  _consistency_flood with JAX's iteration and sweep counts (JAX's read by
  bisecting its max_iters / max_sweeps: the least bound whose normals
  are the unbounded run's, whose flags are all updated), the same
  updated flags, _smooth_normals and
  shell_normal_prediction within 1e-9.
"""

import functools
import math

import numpy as np
import torch

import jax
import jax.numpy as jnp

from sphinxsys_tpu.cases import shell_relaxation_2d as jcase
from sphinxsys_tpu.neighbors import build_cell_table, build_neighbor_list
from sphinxsys_tpu.physics import relax as jr
from sphinxsys_tpu.physics import relax_shell as jrs
from sphinxsys_tpu_torch import convert
from sphinxsys_tpu_torch import run as trun
from sphinxsys_tpu_torch.cases import shell_relaxation_2d as tcase
from sphinxsys_tpu_torch.physics import relax_shell as trs

torch.set_num_threads(1)

N_IT = 30
CONVERGENCE = math.cos(0.01 * math.pi)
CONSISTENCY = math.cos(math.pi / 20.0)


def close(got, ref, tol=1e-12, what=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max(initial=0.0)
    assert err <= tol * max(np.abs(ref).max(initial=0.0), 1e-300), (what,
                                                                      err)


@functools.lru_cache(maxsize=None)
def annulus():
    """JAX's case build with its jittered start and its relaxed particles;
    the port's case build."""
    _, jls, jpos0, jarea, jad, jgrid = jcase.build_case()
    start = jrs.mid_surface_bounding(
        jr.randomize_positions(jnp.asarray(jpos0), jad.spacing, 0), jls,
        jad.spacing)
    relaxed = jrs.shell_relax(jls, jnp.asarray(jpos0),
                              jarea * jcase.THICKNESS, jad, jgrid,
                              n_iterations=N_IT)
    return (jls, jpos0, jarea, jad, jgrid, start, relaxed), \
        tcase.build_case(dtype=torch.float64, device="cpu")[1:]


def test_case_build_matches_jax():
    (jls, jpos0, jarea, jad, jgrid, *_), (tls, tpos0, tarea, tad, tgrid) = \
        annulus()
    np.testing.assert_array_equal(tpos0.numpy(), jpos0)
    assert tarea == jarea and len(jpos0) == 315
    assert (tgrid.lower, tgrid.spacing, tgrid.shape) \
        == (jgrid.lower, jgrid.spacing, jgrid.shape)
    for k in ("coarse_map", "pkg_coord", "pkg_nbr"):
        np.testing.assert_array_equal(getattr(tls, k).numpy(),
                                      np.asarray(getattr(jls, k)))
    close(tls.phi, jls.phi, what="phi")


def test_mid_surface_bounding_matches_jax():
    (jls, jpos0, _, jad, *_), (tls, tpos0, *_) = annulus()
    p = jnp.asarray(jpos0)
    ref_g, ref_b = jax.jit(lambda q: (
        jrs.probe_raw_gradient(jls, q),
        jrs.mid_surface_bounding(q, jls, jad.spacing)))(p)
    close(trs.probe_raw_gradient(tls, tpos0), ref_g, what="raw gradient")
    got = trs.mid_surface_bounding(tpos0, tls, jad.spacing)
    close(got, ref_b, what="bounding")
    # the step pulls particles toward the mid circle
    r0 = np.abs(np.linalg.norm(jpos0, axis=1) - tcase.R_MID)
    r1 = np.abs(np.linalg.norm(got.numpy(), axis=1) - tcase.R_MID)
    assert r1.mean() < r0.mean()


def test_relaxation_matches_jax():
    (*_, start, relaxed), (tls, _, tarea, tad, tgrid) = annulus()
    got = trs.shell_relax_iterations(
        tls, torch.as_tensor(np.array(start)), tarea * tcase.THICKNESS, tad,
        tgrid, n_iterations=N_IT)
    close(got, relaxed, 1e-9, "positions")


@functools.lru_cache(maxsize=None)
def prediction_inputs():
    """A ring of 315 particles near the mid circle, jittered from a numpy
    seed (30 relaxation iterations leave gaps wider than the cutoff,
    where the flood stops), its list and the level set's normals."""
    (jls, *_, jad, jgrid, _, _), _ = annulus()
    rng = np.random.default_rng(7)
    n = 315
    theta = 2.0 * np.pi * (np.arange(n) + 0.3 * rng.random(n)) / n
    radius = tcase.R_MID + 0.1 * (rng.random(n) - 0.5)
    relaxed = jnp.asarray(np.stack([radius * np.cos(theta),
                                    radius * np.sin(theta)], -1)
                          [rng.permutation(n)])
    nl = build_neighbor_list(relaxed, n, relaxed, n,
                             build_cell_table(relaxed, n, jgrid, cap=32),
                             jgrid, jad.cutoff, k_max=48, include_self=False)
    n0 = jls.probe_normal_direction(relaxed)
    return relaxed, nl, n0


def _jax_count(done, hi):
    """The least loop bound k <= hi with done(k) (done is monotone in k):
    JAX's loop count, by bisection."""
    lo = 1
    while lo < hi:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if done(mid) else (mid + 1, hi)
    return lo


def test_predict_normals_matches_jax():
    (jls, *_), (tls, *_) = annulus()
    relaxed, _, n0 = prediction_inputs()
    run = lambda m: (jrs._predict_normals(relaxed, n0, jls, 1.0,
                                          CONVERGENCE, max_iters=m),)
    full = np.asarray(run(100)[0])
    n_jax = _jax_count(lambda m: np.array_equal(np.asarray(run(m)[0]), full),
                       100)
    got, its = trs._predict_normals(torch.as_tensor(np.array(relaxed)),
                                    torch.as_tensor(np.array(n0)), tls, 1.0,
                                    CONVERGENCE)
    assert its == n_jax and its >= 2
    close(got, run(its)[0], 1e-9, "normals")


def test_consistency_flood_matches_jax():
    (jls, *_), _ = annulus()
    relaxed, nl, n0 = prediction_inputs()
    n1 = jrs._predict_normals(relaxed, n0, jls, 1.0, CONVERGENCE)
    seed = relaxed.shape[0] // 3
    run = lambda m: jrs._consistency_flood(n1, nl, CONSISTENCY, seed,
                                           max_sweeps=m)
    sweeps = _jax_count(lambda m: bool(run(m)[1].all()), 1024)
    ref_n, ref_updated = run(4096)
    got_n, got_updated, got_sweeps = trs._consistency_flood(
        torch.as_tensor(np.array(n1)), convert.neighbor_list_from_numpy(nl),
        CONSISTENCY, seed)
    assert int(got_sweeps) == sweeps > 1 and bool(got_updated.all())
    np.testing.assert_array_equal(got_updated.numpy(),
                                  np.asarray(ref_updated))
    close(got_n, ref_n, 1e-9, "flooded normals")


def test_smooth_normals_and_prediction_match_jax():
    (jls, *_, jad, jgrid, _, _), (tls, _, _, tad, tgrid) = annulus()
    relaxed, nl, n0 = prediction_inputs()
    ref = jax.jit(lambda p, n: jrs._smooth_normals(p, n, nl, jad.kernel, 2))(
        relaxed, n0)
    tp = torch.as_tensor(np.array(relaxed))
    got = trs._smooth_normals(tp, torch.as_tensor(np.array(n0)),
                              convert.neighbor_list_from_numpy(nl),
                              tad.kernel, 2)
    close(got, ref, what="smoothed")
    ref_n, ref_u = jrs.shell_normal_prediction(relaxed, jls, 1.0, jad, jgrid)
    got_n, got_u = trs.shell_normal_prediction(tp, tls, 1.0, tad, tgrid)
    close(got_n, ref_n, 1e-9, "predicted")
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(ref_u))


def test_cli_runs_on_the_cpu(tmp_path):
    out = tmp_path / "out"
    assert trun.main(["shell_relaxation_2d", "--set", "n_iterations=5",
                      "--set", "device=cpu", "--output_dir", str(out)]) == 0
    assert sorted(p.name for p in out.iterdir()) == ["Shell_relaxed.vtp"]
