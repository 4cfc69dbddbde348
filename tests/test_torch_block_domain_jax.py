"""The port's distributed cell-block engine against the JAX package's
(parallel/block_domain.py make_distributed_engine_step) on 8 virtual CPU
devices: the 2D dambreak at dx = 0.05, cap 12, 4 advection steps (the
setup of tests/test_block_domain.py), both from JAX's start state
carried across, in float64.  Held at
tests/test_block_domain.py's tolerances (positions 1e-3 of the domain
length, velocities 2e-3), with equal acoustic sub-step counts, the times
to rtol 1e-12, every OriginalID present once on both; and, as both
distribute the same way, the slabs' membership equal.  As both run in
float64, the positions are also held to 1e-9 of the domain length and
the velocities to 1e-9 of their largest magnitude."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sphinxsys_tpu.cases import dambreak_2d as jdb
from sphinxsys_tpu.parallel import block_domain as jbd
from sphinxsys_tpu.parallel.mesh import make_particle_mesh as j_mesh
from sphinxsys_tpu_torch import convert
from sphinxsys_tpu_torch.cases import dambreak_2d as tdb
from sphinxsys_tpu_torch.parallel import block_domain as tbd
from sphinxsys_tpu_torch.parallel import domain as tdm
from sphinxsys_tpu_torch.parallel.mesh import make_particle_mesh

torch.set_num_threads(1)
N_DEV = 8


def test_distributed_engine_matches_jax():
    assert len(jax.devices()) >= N_DEV
    jscene, jfluid = jdb.build_block_case(dx=0.05, cap=12, tile_c=128,
                                          dtype=jnp.float64)
    jh = jbd.distribute_block_engine(jscene.eng, jfluid, j_mesh(N_DEV))
    jstep = jbd.make_distributed_engine_step(
        jscene.eng, j_mesh(N_DEV), wall_b=jscene.wall_b, bm_wall=jscene.bm_wall,
        wall_dense_map=jscene.wall_dense_map, halo_cap=128, migrate_cap=64)
    for _ in range(4):
        jh = jstep(jh)
    assert not bool(jh.overflow)

    assert np.asarray(jfluid["Position"]).dtype == np.float64
    scene, _ = tdb.build_block_case(dx=0.05, cap=12, dtype=torch.float64,
                                    device="cpu")
    fluid = convert.state_from_numpy({k: np.asarray(v)
                                      for k, v in jfluid.items()})
    ring = make_particle_mesh(N_DEV, device="cpu")
    h = tbd.distribute_block_engine(scene.eng, fluid, ring)
    # the same start, split into the same slabs
    h0 = jbd.distribute_block_engine(jscene.eng, jfluid, j_mesh(N_DEV))
    j0 = convert.halo_shard_from_numpy({k: np.asarray(v) for k, v in
                                        h0.fluid.items()}, N_DEV)
    for p, q in zip(h.fluid, j0.fluid):
        assert sorted(p["OriginalID"][p["Alive"]].tolist()) == \
            sorted(q["OriginalID"][q["Alive"]].tolist())
    step = tbd.make_distributed_engine_step(
        scene.eng, ring, wall_b=scene.wall_b, bm_wall=scene.bm_wall,
        wall_dense_map=scene.wall_dense_map, halo_cap=128, migrate_cap=64)
    for _ in range(4):
        h = step(h)
    assert not bool(h.overflow)

    n = int(fluid["NReal"])
    assert h.n_ac == int(jh.n_ac)
    np.testing.assert_allclose(float(h.time), float(jh.time), rtol=1e-12)
    got = tdm.gather_by_id(h, n)
    jgot = tdm.gather_by_id(convert.halo_shard_from_numpy(
        {k: np.asarray(v) for k, v in jh.fluid.items()}, N_DEV), n)
    assert sorted(got["ids"].tolist()) == sorted(jgot["ids"].tolist()) \
        == list(range(n))
    scale = scene.eng.grid.spacing[0] * scene.eng.grid.shape[0]
    err = np.abs(got["Position"] - jgot["Position"]).max()
    assert err < 1e-3 * scale
    np.testing.assert_allclose(got["Velocity"], jgot["Velocity"], atol=2e-3)
    # in float64 the two packages differ by roundoff only: a ring that
    # drops ghosts or skips a refresh shows far above these
    assert err < 1e-9 * scale, f"max position error {err}"
    v_scale = np.abs(jgot["Velocity"]).max()
    v_err = np.abs(got["Velocity"] - jgot["Velocity"]).max()
    assert v_err < 1e-9 * v_scale, f"max velocity error {v_err} / {v_scale}"
