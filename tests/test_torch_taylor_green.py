"""Whole-slice parity of the port with the JAX package on the doubly
periodic Taylor–Green vortex (viscous force, transport-velocity correction,
minimum-image wrap) on the cell-block engine, dx = 0.05: a 7 x 7 periodic
grid and 400 particles (3 cells an axis is the least the window wrap
allows: with fewer the -1 and +1 windows name the same cell).

* the initial scene and state, and their energy reductions;
* the initial slotting of JAX's own state, carried across with convert:
  every block field equal;
* float64: the port's `*_b` engine against JAX's block engine to t = 0.08,
  within 1e-10;
* float32: the port's kernel path (the plain sweep versions on the CPU)
  against JAX's Pallas path in interpret mode to t = 0.08: equal step
  counts, velocity within 5e-5 and density within 1e-4 (the tolerances of
  tests/test_block_engine.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sphinxsys_tpu.cases import taylor_green_2d as jtg
from sphinxsys_tpu.engine import scene as jsc
from sphinxsys_tpu.physics import general as jgd
from sphinxsys_tpu_torch import convert, solver
from sphinxsys_tpu_torch.cases import taylor_green_2d as ttg
from sphinxsys_tpu_torch.engine import scene as tsc
from sphinxsys_tpu_torch.physics import general as tgd

torch.set_num_threads(1)

DX = 0.05
T_END = 0.08
FIELDS = ("Position", "Velocity", "Density", "VolumetricMeasure")


def _jax_particles(scene, sim):
    return {k: np.asarray(v) for k, v in jsc.blocks_to_particles(scene, sim).items()}


def _port_particles(scene, sim):
    return convert.to_numpy(tsc.blocks_to_particles(scene, sim))


def _assert_steps(jsim, tsim):
    assert (tsim.n_adv, tsim.n_ac) == (int(jsim.n_adv), int(jsim.n_ac))
    assert not bool(tsim.overflow) and not bool(jsim.overflow)
    assert float(tsim.time) == pytest.approx(float(jsim.time), rel=1e-6)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_initial_scene_matches_jax(dtype):
    jdt, tdt = {"f64": (jnp.float64, torch.float64),
                "f32": (jnp.float32, torch.float32)}[dtype]
    jcase, jfluid = jtg.build_case(dx=DX, dtype=jdt)
    tcase, tfluid = ttg.build_case(dx=DX, dtype=tdt, device="cpu")
    assert tcase.n_fluid == jcase.n_fluid == 400
    assert (tcase.grid.shape, tcase.grid.periodic) == (jcase.grid.shape,
                                                       jcase.grid.periodic)
    assert tcase.grid.shape == (7, 7)
    assert tcase.box == jcase.box
    for k in ("Position", "Velocity", "Mass", "VolumetricMeasure", "Density"):
        np.testing.assert_array_equal(tfluid[k].numpy(), np.asarray(jfluid[k]),
                                      err_msg=k)
    for solver_name in ("riemann", "no_riemann"):
        jr, tr = getattr(jcase, solver_name), getattr(tcase, solver_name)
        assert type(tr).__name__ == type(jr).__name__
        for k in ("inv_rho0c0_ave", "rho0c0_geo_ave", "inv_c0_ave"):
            assert getattr(tr, k) == getattr(jr, k), (solver_name, k)
    u = np.random.default_rng(2).normal(size=300)
    np.testing.assert_array_equal(
        tcase.no_riemann.dissipative_p_jump(torch.as_tensor(u)).numpy(), 0.0)
    assert float(tgd.total_kinetic_energy(tfluid)) == pytest.approx(
        float(jgd.total_kinetic_energy(jfluid)), rel=1e-6)
    assert float(tgd.maximum_speed(tfluid)) == pytest.approx(
        float(jgd.maximum_speed(jfluid)), rel=1e-6)


def test_init_sim_slots_jax_state_identically():
    """init_sim on the JAX package's initial fluid state (via convert) puts
    every particle in the same slot as JAX's init_sim, positions wrapped
    into the box: every block field equal (ViscousForcePrev, OriginalID
    and SlotMask included), and the window rows equal on the occupied rows
    (JAX's periodic fallback fills the padding rows with real rows; the
    port keeps them all-sentinel)."""
    jscene, jfluid = jtg.build_block_case(dx=DX, dtype=jnp.float64)
    jsim = jsc.init_sim(jscene, jfluid)
    tscene, _ = ttg.build_block_case(dx=DX, dtype=torch.float64, device="cpu")
    assert tscene.eng.c_max == jscene.eng.c_max == 256
    assert tscene.fields == jscene.fields
    fluid = convert.state_from_numpy({k: np.asarray(v) for k, v in jfluid.items()})
    tsim = tsc.init_sim(tscene, fluid)
    jfb = {k: np.asarray(v) for k, v in jsim.fluid_b.items()}
    tfb = convert.to_numpy(tsim.fluid_b)
    assert set(tfb) == set(jfb)
    for k, v in tfb.items():
        np.testing.assert_array_equal(v, jfb[k], err_msg=k)
    n_occ = tscene.base.grid.ncells
    nbr = tsim.nbr_inner.numpy()
    np.testing.assert_array_equal(nbr[:n_occ], np.asarray(jsim.nbr_inner)[:n_occ])
    assert (nbr[:n_occ] < tscene.eng.c_max).all()
    assert (nbr[n_occ:] == tscene.eng.c_max).all()


def test_f64_block_engine_matches_jax():
    """The port's `*_b` forms (use_kernels=False) against JAX's block
    engine: equal step counts, every field by OriginalID within 1e-10."""
    jscene, jfluid = jtg.build_block_case(dx=DX, dtype=jnp.float64)
    jsim = jsc.make_run_chunk(jscene)(jsc.init_sim(jscene, jfluid),
                                      jnp.asarray(T_END, jnp.float64))
    tscene, tfluid = ttg.build_block_case(dx=DX, dtype=torch.float64,
                                          device="cpu", use_kernels=False)
    tsim = tsc.make_run_chunk(tscene)(tsc.init_sim(tscene, tfluid), T_END)
    _assert_steps(jsim, tsim)
    pj, pt = _jax_particles(jscene, jsim), _port_particles(tscene, tsim)
    for k in FIELDS + ("ForcePrior", "ViscousForcePrev", "Pressure"):
        np.testing.assert_allclose(pt[k], pj[k], rtol=0, atol=1e-10, err_msg=k)
    ke_t = float(tgd.total_kinetic_energy(tsc.blocks_to_particles(tscene, tsim)))
    ke_j = float(jgd.total_kinetic_energy(jsc.blocks_to_particles(jscene, jsim)))
    assert ke_t == pytest.approx(ke_j, rel=1e-10)
    assert ke_t < 0.25                       # the vortex decays


def test_f32_kernel_path_matches_pallas_interpret():
    """The port's kernel path through solver.run_simulation (the plain
    versions of B1-B4 on the CPU) against JAX's Pallas kernels in interpret
    mode."""
    jscene, jfluid = jtg.build_block_case(dx=DX, use_pallas=True,
                                          pallas_interpret=True, tile_c=32)
    jsim = jsc.make_run_chunk(jscene)(jsc.init_sim(jscene, jfluid),
                                      jnp.asarray(T_END, jnp.float32))
    tscene, tfluid = ttg.build_block_case(dx=DX, dtype=torch.float32,
                                          device="cpu")
    assert tscene.eng.use_kernels
    tsim, _ = solver.run_simulation(tsc.make_run_chunk(tscene),
                                    tsc.init_sim(tscene, tfluid), T_END,
                                    T_END / 2, verbose=False)
    _assert_steps(jsim, tsim)
    pj, pt = _jax_particles(jscene, jsim), _port_particles(tscene, tsim)
    np.testing.assert_allclose(pt["Velocity"], pj["Velocity"], rtol=0,
                               atol=5e-5)
    np.testing.assert_allclose(pt["Density"], pj["Density"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(pt["Position"], pj["Position"], rtol=0,
                               atol=5e-5)


def test_relaxed_lattice_builds_and_runs():
    """build_case(relax_ic=20) on the CPU: the relaxation residual falls
    from the jittered lattice it starts from, the positions stay in the
    box, the velocity is sampled on them, and the gather route takes an
    advection step without overflow."""
    from sphinxsys_tpu_torch.neighbors.cell_list import wrap_positions
    from sphinxsys_tpu_torch.physics import relax as rx

    case, fluid = ttg.build_case(dx=DX, dtype=torch.float64, device="cpu",
                                 relax_ic=20)
    _, lattice = ttg.build_case(dx=DX, dtype=torch.float64, device="cpu")
    vol = torch.full((case.n_fluid,), DX * DX, dtype=torch.float64)

    def residual(pos):
        s = ttg.init_sim(case, dict(lattice, Position=pos))
        return float(torch.linalg.vector_norm(rx.relaxation_residual(
            s.fluid["Position"], vol, s.nl_inner, case.kernel, 2,
            box=case.box), dim=-1).max())

    pos = fluid["Position"]
    start = wrap_positions(rx.randomize_positions(lattice["Position"], DX, 0),
                           case.grid)
    assert residual(pos) < 0.5 * residual(start)
    assert float(pos.min()) >= 0.0 and float(pos.max()) < 1.0
    assert float((pos - lattice["Position"]).abs().max()) > 1e-3
    u = -torch.cos(2 * np.pi * pos[:, 0]) * torch.sin(2 * np.pi * pos[:, 1])
    np.testing.assert_allclose(fluid["Velocity"][:, 0].numpy(), u.numpy(),
                               rtol=0, atol=1e-12)
    sim = ttg.make_advection_step(case)(ttg.init_sim(case, fluid))
    assert sim.n_adv == 1 and sim.n_ac >= 1 and not bool(sim.overflow)
    assert bool(torch.isfinite(sim.fluid["Position"]).all())
