"""Parity of the port's core (kernels, adaptation, geometry, generators,
states, Riemann solver, gravity) with the JAX package: the initial
dambreak scenes at dx = 0.1 in 2D and 3D."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sphinxsys_tpu.cases import dambreak_2d as jdb2, dambreak_3d as jdb3
from sphinxsys_tpu.core.kernels import WendlandC2 as JWendland
from sphinxsys_tpu.core.kernels import lattice_number_density as j_sigma0
from sphinxsys_tpu.physics import general as jgd
from sphinxsys_tpu_torch.cases import dambreak_2d as tdb2, dambreak_3d as tdb3
from sphinxsys_tpu_torch.core.kernels import WendlandC2 as TWendland
from sphinxsys_tpu_torch.core.kernels import lattice_number_density as t_sigma0
from sphinxsys_tpu_torch.device import resolve_device
from sphinxsys_tpu_torch.physics import general as tgd

torch.set_num_threads(1)

CASES = {"2d": (jdb2, tdb2), "3d": (jdb3, tdb3)}
DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}


@pytest.fixture(scope="module")
def scenes():
    """(jax case, jax fluid, port case, port fluid) per (dim, dtype)."""
    out = {}
    for dim, (jdb, tdb) in CASES.items():
        for name, (jdt, tdt) in DTYPES.items():
            jcase, jfluid = jdb.build_case(dx=0.1, dtype=jdt)
            tcase, tfluid = tdb.build_case(dx=0.1, dtype=tdt, device="cpu")
            out[dim, name] = (jcase, jfluid, tcase, tfluid)
    return out


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_initial_state_matches_jax(scenes, dim):
    jcase, jfluid, tcase, tfluid = scenes[dim, "f64"]
    assert (tcase.n_fluid, tcase.n_wall) == (jcase.n_fluid, jcase.n_wall)
    assert tcase.grid.shape == jcase.grid.shape
    np.testing.assert_array_equal(tcase.grid.lower, jcase.grid.lower)
    np.testing.assert_array_equal(tcase.grid.spacing, jcase.grid.spacing)
    for k in ("Position", "Mass", "VolumetricMeasure", "Density", "ForcePrior",
              "Velocity"):
        np.testing.assert_array_equal(tfluid[k].numpy(), np.asarray(jfluid[k]),
                                      err_msg=k)
    for k in ("Position", "Mass", "VolumetricMeasure"):
        np.testing.assert_array_equal(tcase.wall[k].numpy(),
                                      np.asarray(jcase.wall[k]), err_msg=k)
    assert tfluid["NReal"] == int(jfluid["NReal"])
    e_t = float(tgd.total_mechanical_energy(tfluid, tcase.gravity))
    e_j = float(jgd.total_mechanical_energy(jfluid, jcase.gravity))
    assert e_t == pytest.approx(e_j, rel=1e-14)


@pytest.mark.parametrize("dtype,tol", [("f64", 1e-12), ("f32", 1e-6)])
@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_wall_normals_match_jax(scenes, dim, dtype, tol):
    """Normals from autograd of the CSG SDF, tank corners included (the
    max/min subgradient split at ties decides them)."""
    jcase, _, tcase, _ = scenes[dim, dtype]
    n_t = tcase.wall["NormalDirection"].numpy()
    n_j = np.asarray(jcase.wall["NormalDirection"])
    np.testing.assert_allclose(n_t, n_j, rtol=0, atol=tol)
    np.testing.assert_allclose(tcase.wall["SignedDistance"].numpy(),
                               np.asarray(jcase.wall["SignedDistance"]),
                               rtol=0, atol=tol)
    # corners and edges have tied distances: their normals are diagonal
    assert (np.sum(np.abs(n_t) > 0.1, axis=1) > 1).any()


@pytest.mark.parametrize("dim", [2, 3])
def test_wendland_matches_jax(dim):
    h = 0.13
    jk, tk = JWendland(h=h), TWendland(h=h)
    r = np.random.default_rng(0).uniform(0.0, 2.2 * h, size=2000)
    r[:3] = (0.0, 2.0 * h, h)
    for fn in ("W", "dW"):
        got = getattr(tk, fn)(torch.as_tensor(r), dim).numpy()
        ref = np.asarray(getattr(jk, fn)(jnp.asarray(r), dim))
        np.testing.assert_allclose(got, ref, rtol=1e-14,
                                   atol=1e-14 * np.abs(ref).max(), err_msg=fn)
    assert tk.w0(dim) == pytest.approx(jk.w0(dim), rel=1e-14)
    assert tk._factor_w(dim) == jk._factor_w(dim)
    assert t_sigma0(tk, 0.1, dim) == pytest.approx(j_sigma0(jk, 0.1, dim),
                                                   rel=1e-14)


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_adaptation_and_riemann_match_jax(scenes, dim):
    jcase, _, tcase, _ = scenes[dim, "f64"]
    ja, ta = jcase.adaptation, tcase.adaptation
    assert (ta.h, ta.cutoff) == (ja.h, ja.cutoff)
    assert ta.sigma0 == pytest.approx(ja.sigma0, rel=1e-14)
    jr, tr = jcase.riemann, tcase.riemann
    for k in ("inv_rho0c0_ave", "rho0c0_geo_ave", "inv_c0_ave", "limiter_coeff"):
        assert getattr(tr, k) == getattr(jr, k), k
    u = np.random.default_rng(1).normal(size=500)
    np.testing.assert_allclose(tr.dissipative_p_jump(torch.as_tensor(u)).numpy(),
                               np.asarray(jr.dissipative_p_jump(jnp.asarray(u))),
                               rtol=1e-14, atol=0)
    assert tcase.eos.p0 == jcase.eos.p0


@pytest.mark.parametrize("case,entry", [
    (case, entry) for case in ("dambreak_2d", "dambreak_3d", "taylor_green_2d")
    for entry in ("build_case", "build_block_case")
] + [("twisting_column_3d", "build_case"), ("fsi2", "build_case"),
      ("fsi2", "build_block_case")])
def test_entry_points_default_to_the_card(case, entry):
    """The case entry points run on the card unless asked for the CPU:
    with no device given they ask for "cuda", and raise where there is
    none."""
    import importlib
    import inspect

    fn = getattr(importlib.import_module(f"sphinxsys_tpu_torch.cases.{case}"),
                 entry)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        fn(dx=0.1)


def test_cuda_request_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        tdb2.build_block_case(dx=0.1, device="cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")
