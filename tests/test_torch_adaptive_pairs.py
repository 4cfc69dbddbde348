"""Parity of the port's adaptive wall terms (physics/fluid_adaptive.py's
wall sections), `solid.freeze_adaptive_reference_pairs`, the kernels'
`W_adaptive` / `dW_adaptive` and `geometry.InverseShape` with the JAX
package's on the CPU, on the multi-resolution scenes of
tests/test_torch_fluid_adaptive.py: within 1e-12 of max |JAX| in float64
and 2e-5 in float32; the adaptive kernel also in 1D and outside the
particle's own support (exact zeros); InverseShape over a ball and a box
(the normals within 10x the tolerance: autograd against jax.grad).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_fluid_adaptive import EOS, H_REF, MU, hold, mr_scene
from test_torch_viscosity import DTYPES, TOL, close, kernels

from sphinxsys_tpu.core import geometry as jgeo
from sphinxsys_tpu.core.materials import WeaklyCompressibleFluid as JEos
from sphinxsys_tpu.physics import fluid_adaptive as jfa
from sphinxsys_tpu.physics import riemann as jrs
from sphinxsys_tpu.physics import solid as jsd
from sphinxsys_tpu_torch.core import geometry as tgeo
from sphinxsys_tpu_torch.core.materials import WeaklyCompressibleFluid as TEos
from sphinxsys_tpu_torch.physics import fluid_adaptive as tfa
from sphinxsys_tpu_torch.physics import riemann as trs
from sphinxsys_tpu_torch.physics import solid as tsd

torch.set_num_threads(1)


@pytest.mark.parametrize("dim", (2, 3))
@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
def test_wall_terms_match_jax(dtype, dim):
    (jb, jw, nl, nlw), (tb, tw, tnl, tnlw) = mr_scene(dim, dtype)
    jkn, tkn = kernels()
    jeos, teos = JEos(**EOS), TEos(**EOS)
    jrm, trm = jrs.acoustic_riemann(jeos), trs.acoustic_riemann(teos)
    jp, tp = jeos.pressure(jb["Density"]), teos.pressure(tb["Density"])
    ref = jax.jit(lambda b, p: (
        jfa._wall_pair(b["Position"], b["SmoothingLengthRatio"], jw, nlw,
                       jkn, dim, None),
        jfa.density_wall_adaptive(b, jw, nlw, jkn, dim),
        jfa.acoustic_1st_half_wall_adaptive(b, p, b["Density"],
                                            b["Position"], jw, nlw, jkn,
                                            dim, jrm),
        jfa.acoustic_2nd_half_wall_adaptive(b, b["Velocity"], b["Density"],
                                            b["Position"], jw, nlw, jkn,
                                            dim, jrm),
        jfa.viscous_wall_adaptive(b, jw, nlw, jkn, dim, MU, H_REF)))(jb, jp)
    got = (tfa._wall_pair(tb["Position"], tb["SmoothingLengthRatio"], tw,
                          tnlw, tkn, dim, None),
           tfa.density_wall_adaptive(tb, tw, tnlw, tkn, dim),
           tfa.acoustic_1st_half_wall_adaptive(tb, tp, tb["Density"],
                                               tb["Position"], tw, tnlw, tkn,
                                               dim, trm),
           tfa.acoustic_2nd_half_wall_adaptive(tb, tb["Velocity"],
                                               tb["Density"], tb["Position"],
                                               tw, tnlw, tkn, dim, trm),
           tfa.viscous_wall_adaptive(tb, tw, tnlw, tkn, dim, MU, H_REF))
    hold(got, ref, dtype, "wall")


@pytest.mark.parametrize("dim", (2, 3))
@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
def test_freeze_adaptive_pairs_match_jax(dtype, dim):
    (jb, _, nl, _), (tb, _, tnl, _) = mr_scene(dim, dtype)
    jkn, tkn = kernels()
    ref = jax.jit(lambda p, h: jsd.freeze_adaptive_reference_pairs(
        p, h, nl, jkn, dim))(jb["Position"], jb["SmoothingLengthRatio"])
    got = tsd.freeze_adaptive_reference_pairs(
        tb["Position"], tb["SmoothingLengthRatio"], tnl, tkn, dim)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    for k in ("W", "dW", "r", "e"):
        close(getattr(got, k), getattr(ref, k), TOL[dtype], k)


@pytest.mark.parametrize("dim", (1, 2, 3))
@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
def test_adaptive_kernel_matches_jax(dtype, dim):
    rng = np.random.default_rng(4)
    r = (rng.random(400) * 2.2 * H_REF).astype(dtype)
    hr = rng.choice([1.0, 1.5, 2.0, 3.0], 400).astype(dtype)
    jkn, tkn = kernels()
    jr, tr_ = jnp.asarray(r), torch.as_tensor(r)
    jh, th = jnp.asarray(hr), torch.as_tensor(hr)
    close(tkn.W_adaptive(tr_, th, dim), jkn.W_adaptive(jr, jh, dim),
          TOL[dtype], "W")
    close(tkn.dW_adaptive(tr_, th, dim), jkn.dW_adaptive(jr, jh, dim),
          TOL[dtype], "dW")
    close(tkn.w0_adaptive(th, dim),
          jkn._factor_w(dim) * jh ** dim * jkn._w(jnp.zeros((), jh.dtype)),
          TOL[dtype], "w0")
    # outside the particle's own support: exact zeros
    out = tr_ / tkn.h * th >= tkn.kernel_size
    assert bool(out.any()) and not bool(tkn.W_adaptive(tr_, th, dim)[out]
                                        .any())


@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
def test_inverse_shape_matches_jax(dtype):
    rng = np.random.default_rng(6)
    pts = (rng.random((300, 2)) * 4.0 - 2.0).astype(dtype)
    cases = ((jgeo.Ball(center=(0.2, -0.1), radius=0.9),
              tgeo.Ball(center=(0.2, -0.1), radius=0.9)),
             (jgeo.Box(jgeo.Transform(translation=(0.3, 0.1)),
                       halfsize=(0.8, 0.5)),
              tgeo.Box(tgeo.Transform(translation=(0.3, 0.1)),
                       halfsize=(0.8, 0.5))))
    for jshape, tshape in cases:
        ji, ti = jgeo.InverseShape(jshape), tgeo.InverseShape(tshape)
        jp, tp = jnp.asarray(pts), torch.as_tensor(pts)
        close(ti.signed_distance(tp), ji.signed_distance(jp), TOL[dtype],
              "sdf")
        np.testing.assert_array_equal(ti.contains(tp).numpy(),
                                      np.asarray(ji.contains(jp)))
        assert 0 < int(ti.contains(tp).sum()) < len(pts)
        for a, b in zip(ti.bounds(), ji.bounds()):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(
            ti.find_normal_direction(tp).numpy(),
            np.asarray(ji.find_normal_direction(jp)), atol=TOL[dtype] * 10)
