"""Whole-slice parity of the port with the JAX package: the dambreak on the
cell-block engine, from build_block_case through the dual-criteria loop.

* 2D float32, the port's kernel path (plain sweep versions on the CPU)
  against JAX's Pallas path in interpret mode, to t = 0.08: equal step
  counts, positions by OriginalID within 5e-5;
* 2D float64, the port's block forms against JAX's block engine, to
  t = 0.08, within 1e-10;
* 3D float64, one advection step of the block forms, within 1e-10;
* the initial slotting of the JAX package's own fluid state, carried
  across with convert.state_from_numpy: every block field equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sphinxsys_tpu.cases import dambreak_2d as jdb2, dambreak_3d as jdb3
from sphinxsys_tpu.engine import scene as jsc
from sphinxsys_tpu.physics import general as jgd
from sphinxsys_tpu_torch import convert, solver
from sphinxsys_tpu_torch.cases import dambreak_2d as tdb2, dambreak_3d as tdb3
from sphinxsys_tpu_torch.engine import scene as tsc
from sphinxsys_tpu_torch.physics import general as tgd

torch.set_num_threads(1)

T_END = 0.08


def _jax_particles(scene, sim):
    return {k: np.asarray(v) for k, v in jsc.blocks_to_particles(scene, sim).items()}


def _port_particles(scene, sim):
    p = tsc.blocks_to_particles(scene, sim)
    return {k: (v.numpy() if torch.is_tensor(v) else v) for k, v in p.items()}


def _compare(jscene, jsim, tscene, tsim, atol, keys=("Position",)):
    assert (tsim.n_adv, tsim.n_ac) == (int(jsim.n_adv), int(jsim.n_ac))
    assert not bool(tsim.overflow) and not bool(jsim.overflow)
    assert float(tsim.time) == pytest.approx(float(jsim.time), rel=1e-6)
    pj, pt = _jax_particles(jscene, jsim), _port_particles(tscene, tsim)
    for k in keys:
        np.testing.assert_allclose(pt[k], pj[k], rtol=0, atol=atol, err_msg=k)
    e_j = float(jgd.total_mechanical_energy(jsc.blocks_to_particles(jscene, jsim),
                                            jscene.base.gravity))
    e_t = float(tgd.total_mechanical_energy(tsc.blocks_to_particles(tscene, tsim),
                                            tscene.base.gravity))
    assert e_t == pytest.approx(e_j, rel=max(atol, 1e-12) * 10)


def test_2d_slice_f32_matches_pallas_interpret():
    jscene, jfluid = jdb2.build_block_case(dx=0.1, use_pallas=True,
                                           pallas_interpret=True, tile_c=32)
    jsim = jsc.make_run_chunk(jscene)(jsc.init_sim(jscene, jfluid),
                                      jnp.asarray(T_END, jnp.float32))
    tscene, tfluid = tdb2.build_block_case(dx=0.1, dtype=torch.float32,
                                           device="cpu")
    assert (tscene.eng.c_max, tscene.bm_wall.c_max) == (jscene.eng.c_max,
                                                        jscene.bm_wall.c_max)
    tsim, timer = solver.run_simulation(tsc.make_run_chunk(tscene),
                                        tsc.init_sim(tscene, tfluid), T_END,
                                        T_END / 2, verbose=False)
    assert set(timer.totals) == {"integrate", "output"}
    _compare(jscene, jsim, tscene, tsim, atol=5e-5)


def test_2d_slice_f64_matches_block_engine():
    jscene, jfluid = jdb2.build_block_case(dx=0.1, dtype=jnp.float64)
    jsim = jsc.make_run_chunk(jscene)(jsc.init_sim(jscene, jfluid),
                                      jnp.asarray(T_END, jnp.float64))
    tscene, tfluid = tdb2.build_block_case(dx=0.1, dtype=torch.float64,
                                           device="cpu", use_kernels=False)
    tsim = tsc.make_run_chunk(tscene)(tsc.init_sim(tscene, tfluid), T_END)
    _compare(jscene, jsim, tscene, tsim, atol=1e-10,
             keys=("Position", "Velocity", "Density", "Pressure"))


def test_3d_f64_step_matches_block_engine():
    jscene, jfluid = jdb3.build_block_case(dx=0.1, dtype=jnp.float64, cap=32)
    jsim = jsc.make_advection_step(jscene)(jsc.init_sim(jscene, jfluid))
    tscene, tfluid = tdb3.build_block_case(dx=0.1, dtype=torch.float64, cap=32,
                                           device="cpu", use_kernels=False)
    tsim = tsc.make_advection_step(tscene)(tsc.init_sim(tscene, tfluid))
    _compare(jscene, jsim, tscene, tsim, atol=1e-10,
             keys=("Position", "Velocity", "Density", "Pressure"))


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_init_sim_slots_jax_state_identically(dim):
    """init_sim on the JAX package's initial fluid state (via convert) puts
    every particle in the same slot as JAX's init_sim: all block fields,
    OriginalID and SlotMask included, and both window maps, are equal."""
    jdb, tdb = {"2d": (jdb2, tdb2), "3d": (jdb3, tdb3)}[dim]
    jscene, jfluid = jdb.build_block_case(dx=0.1, dtype=jnp.float64)
    jsim = jsc.init_sim(jscene, jfluid)
    tscene, _ = tdb.build_block_case(dx=0.1, dtype=torch.float64, device="cpu")
    fluid = convert.state_from_numpy({k: np.asarray(v) for k, v in jfluid.items()})
    tsim = tsc.init_sim(tscene, fluid)
    for k, v in convert.to_numpy(tsim.fluid_b).items():
        np.testing.assert_array_equal(v, np.asarray(jsim.fluid_b[k]), err_msg=k)
    np.testing.assert_array_equal(tsim.nbr_inner.numpy(), np.asarray(jsim.nbr_inner))
    np.testing.assert_array_equal(tsim.nbr_wall.numpy(), np.asarray(jsim.nbr_wall))
    for k, v in convert.to_numpy(tscene.wall_b).items():
        # the normals are computed on each side (autograd / jax.grad): equal
        # to the normals test's 1e-12; everything else is slotted exactly
        tol = 1e-12 if k == "NormalDirection" else 0.0
        np.testing.assert_allclose(v, np.asarray(jscene.wall_b[k]), rtol=0,
                                   atol=tol, err_msg=k)
