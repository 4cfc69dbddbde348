"""Parity of the port's kernel correction (physics/fluid.py
`kernel_correction_matrix` and the corrected first acoustic half) with the
JAX package, on the CPU in float64.

Inputs made from a seed with numpy: a jittered lattice of fluid, in 2D
(14 x 10 at dx = 0.1) and 3D (6 x 5 x 4), over a wall strip of three
layers with random normals, wall velocities and accelerations, plus two
deficient rows: one particle alone (no neighbour) and one with a single
neighbour.  A periodic variant tiles the 2D lattice in x.  JAX's
neighbour lists are carried across, so both sides sum the same slots.
Every field is held within 1e-12 of its max|ref|, the deficient rows
apart from the others (at alpha = 0 their B is ~1e6 I).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sphinxsys_tpu.core import kernels as jk
from sphinxsys_tpu.core import materials as jmat
from sphinxsys_tpu.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_tpu.physics import fluid as jfd
from sphinxsys_tpu.physics import riemann as jrs
from sphinxsys_tpu_torch import convert
from sphinxsys_tpu_torch.core import kernels as tk
from sphinxsys_tpu_torch.core import materials as tmat
from sphinxsys_tpu_torch.physics import fluid as tfd
from sphinxsys_tpu_torch.physics import riemann as trs

torch.set_num_threads(1)

TOL = 1e-12
DX = 0.1
H = 1.3 * DX


def _close(got, ref, tol=TOL, what=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-300), (what, err)


def _scene(dim, periodic=False, seed=0):
    """(fluid, wall) numpy states, the deficient rows' indices, the grid
    and the box."""
    rng = np.random.default_rng(seed)
    n_axis = (14, 10) if dim == 2 else (6, 5, 4)
    axes = [np.arange(n) * DX + DX / 2 for n in n_axis]
    pos = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, dim)
    pos = pos + 0.2 * DX * (rng.random(pos.shape) - 0.5)
    far = np.full(dim, 0.5)
    far[0] = n_axis[0] * DX / 2
    far[1] = n_axis[1] * DX + 2.5          # alone, above the block
    pair = far.copy()
    pair[0] += 3.0 * H                      # one neighbour: the next row
    pair2 = pair + np.eye(dim)[0] * 0.6 * DX
    deficient = np.arange(len(pos), len(pos) + 3)
    pos = np.concatenate([pos, far[None], pair[None], pair2[None]])
    n = len(pos)
    fluid = {"Position": pos, "VolumetricMeasure": DX ** dim
             * (1.0 + 0.05 * rng.normal(size=n)),
             "Mass": DX ** dim * (1.0 + 0.05 * rng.normal(size=n)),
             "Velocity": 0.3 * rng.normal(size=(n, dim)),
             "Density": 1.0 + 0.01 * rng.normal(size=n),
             "DensityChangeRate": 0.1 * rng.normal(size=n),
             "Force": 0.01 * rng.normal(size=(n, dim)),
             "ForcePrior": 0.01 * rng.normal(size=(n, dim)),
             "Pressure": rng.normal(size=n), "NReal": np.int32(n)}
    wall_axes = [np.arange(n_axis[0]) * DX + DX / 2,
                 -np.arange(3) * DX - DX / 2, *axes[2:]]
    wpos = np.stack(np.meshgrid(*wall_axes, indexing="ij"),
                    -1).reshape(-1, dim)
    nw = len(wpos)
    normals = rng.normal(size=(nw, dim))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    wall = {"Position": wpos, "VolumetricMeasure": np.full(nw, DX ** dim),
            "Mass": np.full(nw, DX ** dim), "NormalDirection": normals,
            "AverageVelocity": 0.3 * rng.normal(size=(nw, dim)),
            "AverageAcceleration": 2.0 * rng.normal(size=(nw, dim)),
            "NReal": np.int32(nw)}
    hi = tuple(float(x) for x in (n_axis[0] * DX, *pos[:, 1:].max(0) + DX))
    lo = (0.0, -0.5, *(-0.5 * np.ones(dim - 2)))
    grid = grid_from_bounds(lo, hi, 2 * H,
                            periodic=(periodic,) + (False,) * (dim - 1))
    box = grid.periodic_lengths if periodic else None
    return fluid, wall, deficient, grid, box


def _lists(fluid, wall, grid):
    pos, wpos = jnp.asarray(fluid["Position"]), jnp.asarray(wall["Position"])
    n, nw = int(fluid["NReal"]), int(wall["NReal"])
    dim = pos.shape[1]
    table = build_cell_table(pos, n, grid, cap=24 if dim == 2 else 48)
    wtable = build_cell_table(wpos, nw, grid, cap=24 if dim == 2 else 48)
    nl = build_neighbor_list(pos, n, pos, n, table, grid, 2 * H,
                             k_max=40 if dim == 2 else 120,
                             include_self=False)
    nlw = build_neighbor_list(pos, n, wpos, nw, wtable, grid, 2 * H,
                              k_max=24 if dim == 2 else 80,
                              include_self=True)
    assert not bool(nl.overflow) and not bool(nlw.overflow)
    return nl, nlw


@functools.lru_cache(maxsize=None)
def _both(dim, periodic=False):
    fluid, wall, deficient, grid, box = _scene(dim, periodic)
    nl, nlw = _lists(fluid, wall, grid)
    jf = {k: jnp.asarray(v) for k, v in fluid.items()}
    jw = {k: jnp.asarray(v) for k, v in wall.items()}
    tf_, tw = convert.state_from_numpy(fluid), convert.state_from_numpy(wall)
    tnl, tnlw = (convert.neighbor_list_from_numpy(x) for x in (nl, nlw))
    counts = np.asarray(nl.count)
    assert counts[deficient[0]] == 0 and counts[deficient[1]] == 1
    return (jf, jw, nl, nlw), (tf_, tw, tnl, tnlw), deficient, box


def _hold_rows(got, ref, deficient, what):
    got = got.numpy()
    ref = np.asarray(ref)
    rest = np.setdiff1d(np.arange(len(ref)), deficient)
    _close(got[rest], ref[rest], what=(what, "rows"))
    _close(got[deficient], ref[deficient], what=(what, "deficient rows"))


@pytest.mark.parametrize("dim", (2, 3))
@pytest.mark.parametrize("wall", (False, True))
@pytest.mark.parametrize("alpha", (0.0, 0.5))
def test_correction_matrix_matches_jax(dim, wall, alpha):
    (jf, jw, nl, nlw), (tf_, tw, tnl, tnlw), deficient, _ = _both(dim)
    jkern, tkern = jk.WendlandC2(h=H), tk.WendlandC2(h=H)
    kw_j = dict(wall=jw, nl_wall=nlw) if wall else {}
    kw_t = dict(wall=tw, nl_wall=tnlw) if wall else {}
    ref = jfd.kernel_correction_matrix(jf, nl, jkern, dim, alpha=alpha,
                                       **kw_j)
    got = tfd.kernel_correction_matrix(tf_, tnl, tkern, dim, alpha=alpha,
                                       **kw_t)
    key = "LinearGradientCorrectionMatrix"
    _hold_rows(got[key], ref[key], deficient, "B")
    B = got[key][deficient[0]]
    eye = torch.eye(dim, dtype=B.dtype)
    if alpha > 0:
        # a lone row's A is 1e-6 I: the blend falls back to the identity
        assert float((B - eye).abs().max()) < 1e-5
    else:
        # no blend: det = 1e-6^dim, B = det / (det + 1e-15) 1e6 I
        d = 1e-6 ** dim
        expect = d / (d + 1e-15) * 1e6
        assert float((B - expect * eye).abs().max()) < 1e-9 * expect
    assert set(got) == set(tf_) | {key}


def test_correction_matrix_periodic_box():
    (jf, jw, nl, nlw), (tf_, tw, tnl, tnlw), deficient, box = _both(
        2, periodic=True)
    assert box[0] > 0
    ref = jfd.kernel_correction_matrix(jf, nl, jk.WendlandC2(h=H), 2,
                                       wall=jw, nl_wall=nlw, alpha=0.5,
                                       box=box)
    got = tfd.kernel_correction_matrix(tf_, tnl, tk.WendlandC2(h=H), 2,
                                       wall=tw, nl_wall=tnlw, alpha=0.5,
                                       box=box)
    key = "LinearGradientCorrectionMatrix"
    _hold_rows(got[key], ref[key], deficient, "B periodic")
    # the box matters: the rows at the x ends see their images
    flat = tfd.kernel_correction_matrix(tf_, tnl, tk.WendlandC2(h=H), 2,
                                        wall=tw, nl_wall=tnlw, alpha=0.5)
    assert float((flat[key] - got[key]).abs().max()) > 1e-3


@pytest.mark.parametrize("wall", (False, True))
@pytest.mark.parametrize("periodic", (False, True))
def test_corrected_first_half_matches_jax(wall, periodic):
    (jf, jw, nl, nlw), (tf_, tw, tnl, tnlw), deficient, box = _both(
        2, periodic)
    jkern, tkern = jk.WendlandC2(h=H), tk.WendlandC2(h=H)
    kw_j = dict(wall=jw, nl_wall=nlw) if wall else {}
    kw_t = dict(wall=tw, nl_wall=tnlw) if wall else {}
    jf = jfd.kernel_correction_matrix(jf, nl, jkern, 2, alpha=0.5, box=box,
                                      **kw_j)
    tf_ = tfd.kernel_correction_matrix(tf_, tnl, tkern, 2, alpha=0.5,
                                       box=box, **kw_t)
    jeos = jmat.WeaklyCompressibleFluid(rho0=1.0, c0=10.0)
    teos = tmat.WeaklyCompressibleFluid(rho0=1.0, c0=10.0)
    dt = 2e-3
    ref = jfd.acoustic_step_1st_half(jf, nl, jkern, 2, jeos,
                                     jrs.acoustic_riemann(jeos), dt, box=box,
                                     correction=True, **kw_j)
    got = tfd.acoustic_step_1st_half(tf_, tnl, tkern, 2, teos,
                                     trs.acoustic_riemann(teos), dt, box=box,
                                     correction=True, **kw_t)
    for k in ("Force", "Velocity", "DensityChangeRate", "Position",
              "Density", "Pressure"):
        _hold_rows(got[k], ref[k], deficient, k)
    # the correction changes the force (B is not the identity)
    plain = tfd.acoustic_step_1st_half(tf_, tnl, tkern, 2, teos,
                                       trs.acoustic_riemann(teos), dt,
                                       box=box, **kw_t)
    assert float((plain["Force"] - got["Force"]).abs().max()) \
        > 1e-6 * float(got["Force"].abs().max())
