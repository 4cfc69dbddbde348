"""Parity of the port's adaptive-h fluid ops (physics/fluid_adaptive.py)
with the JAX package's on the CPU (their wall sections alone, the frozen
adaptive solid pairs, the adaptive kernel and InverseShape in
tests/test_torch_adaptive_pairs.py).

Inputs: the seeded 2D and 3D scenes of tests/test_torch_viscosity.py
(a jittered block with an isolated particle over a three-layer wall with
random normals and averaged kinematics; JAX's lists carried across), each
particle given a smoothing-length ratio drawn from {1, 1.5, 2} (the wall's
too) and random surface flags.  The lists are built at the reference
cutoff 2 h_ref, a superset of every adaptive pair (the pairs beyond the
pair cut add exact zeros).  Each function within 1e-12 of max |JAX| in
float64 and 2e-5 in float32, with and without the wall, the 2D ones also
under a periodic box.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_viscosity import DTYPES, TOL, close, kernels, scene

from sphinxsys_tpu.core.materials import WeaklyCompressibleFluid as JEos
from sphinxsys_tpu.physics import fluid_adaptive as jfa
from sphinxsys_tpu.physics import riemann as jrs
from sphinxsys_tpu_torch.core.materials import WeaklyCompressibleFluid as TEos
from sphinxsys_tpu_torch.physics import fluid_adaptive as tfa
from sphinxsys_tpu_torch.physics import riemann as trs

torch.set_num_threads(1)

DT = 1.0e-3
EOS = dict(rho0=1.0, c0=10.0)
H_REF = 0.13
MU = 0.05


@functools.lru_cache(maxsize=None)
def mr_scene(dim, dtype):
    """The scene with SmoothingLengthRatio, Indicator and
    PreviousSurfaceIndicator on the body, SmoothingLengthRatio on the
    wall."""
    (jb, jw, nl, nlw, _), (tb, tw, tnl, tnlw, _) = scene(dim, dtype)
    rng = np.random.default_rng(11)
    n, nw = tb["Position"].shape[0], tw["Position"].shape[0]
    extra_b = {"SmoothingLengthRatio": rng.choice([1.0, 1.5, 2.0], n)
               .astype(dtype),
               "Indicator": rng.integers(0, 2, n).astype(np.int32),
               "PreviousSurfaceIndicator": rng.integers(0, 2, n)
               .astype(np.int32)}
    extra_w = {"SmoothingLengthRatio": rng.choice([1.0, 2.0], nw)
               .astype(dtype)}
    jb = dict(jb, **{k: jnp.asarray(v) for k, v in extra_b.items()})
    tb = dict(tb, **{k: torch.as_tensor(v) for k, v in extra_b.items()})
    jw = dict(jw, **{k: jnp.asarray(v) for k, v in extra_w.items()})
    tw = dict(tw, **{k: torch.as_tensor(v) for k, v in extra_w.items()})
    return (jb, jw, nl, nlw), (tb, tw, tnl, tnlw)


def hold(got, ref, dtype, what):
    if isinstance(ref, (tuple, list)):
        for i, (g, r) in enumerate(zip(got, ref)):
            hold(g, r, dtype, f"{what}[{i}]")
    elif isinstance(ref, dict):
        assert set(got) == set(ref), what
        for k in ref:
            hold(got[k], ref[k], dtype, f"{what}.{k}")
    elif np.asarray(ref).dtype.kind in "biu":
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref),
                                      err_msg=what)
    elif isinstance(ref, (int, float)):
        assert got == ref, what
    else:
        close(got, ref, TOL[dtype], what)


CONFIGS = [(2, None, False), (2, None, True), (2, (1.4, 0.0), True),
           (3, None, False), (3, None, True)]
IDS = ["2d", "2d_wall", "2d_box_wall", "3d", "3d_wall"]


def _args(cfg, dtype):
    dim, box, wall = cfg
    (jb, jw, nl, nlw), (tb, tw, tnl, tnlw) = mr_scene(dim, dtype)
    jkn, tkn = kernels()
    jkw = dict(wall=jw, nl_wall=nlw) if wall else {}
    tkw = dict(wall=tw, nl_wall=tnlw) if wall else {}
    return dim, box, (jb, jw, nl, nlw, jkn, jkw), (tb, tw, tnl, tnlw, tkn,
                                                   tkw)


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
def test_pair_and_density_match_jax(dtype, cfg):
    dim, box, (jb, jw, nl, nlw, jkn, jkw), (tb, tw, tnl, tnlw, tkn, tkw) = \
        _args(cfg, dtype)
    ref = jax.jit(lambda b: (
        jfa.adaptive_pair(b, nl, jkn, dim, box),
        jfa.density_summation_adaptive(b, nl, jkn, dim, 1.0, box=box, **jkw),
        jfa.density_summation_adaptive(b, nl, jkn, dim, 1.0, box=box,
                                       free_surface=True, **jkw),
        jfa.density_summation_freestream_adaptive(b, nl, jkn, dim, 1.0,
                                                  box=box, **jkw)))(jb)
    got = (tfa.adaptive_pair(tb, tnl, tkn, dim, box),
           tfa.density_summation_adaptive(tb, tnl, tkn, dim, 1.0, box=box,
                                          **tkw),
           tfa.density_summation_adaptive(tb, tnl, tkn, dim, 1.0, box=box,
                                          free_surface=True, **tkw),
           tfa.density_summation_freestream_adaptive(tb, tnl, tkn, dim, 1.0,
                                                     box=box, **tkw))
    hold(got, ref, dtype, "density")


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
def test_acoustic_halves_match_jax(dtype, cfg):
    dim, box, (jb, jw, nl, nlw, jkn, jkw), (tb, tw, tnl, tnlw, tkn, tkw) = \
        _args(cfg, dtype)
    jeos, teos = JEos(**EOS), TEos(**EOS)
    jrm, trm = jrs.acoustic_riemann(jeos), trs.acoustic_riemann(teos)
    ref = jax.jit(lambda b: (lambda f1: (f1, jfa.acoustic_step_2nd_half_adaptive(
        f1, nl, jkn, dim, jrm, DT, box=box, **jkw)))(
        jfa.acoustic_step_1st_half_adaptive(b, nl, jkn, dim, jeos, jrm, DT,
                                            box=box, **jkw)))(jb)
    f1 = tfa.acoustic_step_1st_half_adaptive(tb, tnl, tkn, dim, teos, trm, DT,
                                             box=box, **tkw)
    f2 = tfa.acoustic_step_2nd_half_adaptive(f1, tnl, tkn, dim, trm, DT,
                                             box=box, **tkw)
    hold((f1, f2), ref, dtype, "acoustic")


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
def test_viscous_tvc_and_surface_match_jax(dtype, cfg):
    dim, box, (jb, jw, nl, nlw, jkn, jkw), (tb, tw, tnl, tnlw, tkn, tkw) = \
        _args(cfg, dtype)
    jwalls = [(jw, nlw)] if jkw else []
    twalls = [(tw, tnlw)] if tkw else []
    jscope = jb["Indicator"] == 0
    tscope = tb["Indicator"] == 0
    ref = jax.jit(lambda b: (
        jfa.viscous_force_adaptive(b, nl, jkn, dim, MU, H_REF, box=box,
                                   **jkw),
        jfa.transport_velocity_correction_adaptive(b, nl, jkn, dim, H_REF,
                                                   box=box, walls=jwalls),
        jfa.transport_velocity_correction_adaptive(
            b, nl, jkn, dim, H_REF, box=box, walls=jwalls,
            scope_mask=jscope),
        jfa.free_surface_indication_adaptive(b, nl, jkn, dim, walls=jwalls,
                                             box=box),
        jfa.free_surface_indication_adaptive(b, nl, jkn, dim, walls=jwalls,
                                             spatial_temporal=True,
                                             box=box)))(jb)
    got = (tfa.viscous_force_adaptive(tb, tnl, tkn, dim, MU, H_REF, box=box,
                                      **tkw),
           tfa.transport_velocity_correction_adaptive(tb, tnl, tkn, dim,
                                                      H_REF, box=box,
                                                      walls=twalls),
           tfa.transport_velocity_correction_adaptive(
               tb, tnl, tkn, dim, H_REF, box=box, walls=twalls,
               scope_mask=tscope),
           tfa.free_surface_indication_adaptive(tb, tnl, tkn, dim,
                                                walls=twalls, box=box),
           tfa.free_surface_indication_adaptive(tb, tnl, tkn, dim,
                                                walls=twalls,
                                                spatial_temporal=True,
                                                box=box))
    hold(got, ref, dtype, "viscous_tvc_surface")
    # the indication is not trivial here
    ind = got[3]["Indicator"]
    assert 0 < int(ind.sum()) < ind.shape[0]
