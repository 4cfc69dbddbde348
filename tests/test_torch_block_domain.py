"""The port's distributed cell-block engine
(parallel/block_domain.py) on a ThreadRing of 8 ranks against the port's
single-device block engine, on the CPU in float64 (each rank's sweeps
take their plain versions here; on the card the B1-B3 kernels):
tests/test_block_domain.py's two tests (the 2D dambreak at dx = 0.05,
cap 12: 4 steps matched, and 12 through the surge) at their tolerances
(positions 1e-3 of the domain scale, velocities 2e-3), with equal
acoustic sub-step counts, the times to rtol 1e-12, every OriginalID
present once, and no overflow.  The float64 runs differ only in the
order of the slot sums (measured 4e-16 in 2D positions), so positions
are also held to 1e-9 of the scale and velocities to 1e-9 of their
largest magnitude."""

import numpy as np
import pytest
import torch

from sphinxsys_tpu_torch.cases import dambreak_2d as db
from sphinxsys_tpu_torch.engine import scene as sc
from sphinxsys_tpu_torch.parallel import block_domain as bd
from sphinxsys_tpu_torch.parallel import domain as dm
from sphinxsys_tpu_torch.parallel.mesh import make_particle_mesh

torch.set_num_threads(1)
N_DEV = 8
F64 = dict(dtype=torch.float64, device="cpu")


def _single(scene, fluid, n_steps):
    s = sc.init_sim(scene, fluid)
    step = sc.make_advection_step(scene)
    for _ in range(n_steps):
        s = step(s)
    assert not bool(s.overflow)
    return s, sc.blocks_to_particles(scene, s)


def _distributed(scene, fluid, n_steps, halo_cap, migrate_cap, each=None):
    ring = make_particle_mesh(N_DEV, device="cpu")
    h = bd.distribute_block_engine(scene.eng, fluid, ring)
    step = bd.make_distributed_engine_step(
        scene.eng, ring, wall_b=scene.wall_b, bm_wall=scene.bm_wall,
        wall_dense_map=scene.wall_dense_map, halo_cap=halo_cap,
        migrate_cap=migrate_cap)
    n0 = sum(int(p["Alive"].sum()) for p in h.fluid)
    for _ in range(n_steps):
        h = step(h)
        if each is not None:
            each(h)
    assert not bool(h.overflow)
    assert sum(int(p["Alive"].sum()) for p in h.fluid) == n0
    return h


def _hold(h, s, ref, n, dim, scale):
    assert h.n_ac == s.n_ac, (h.n_ac, s.n_ac)
    np.testing.assert_allclose(float(h.time), float(s.time), rtol=1e-12)
    got = dm.gather_by_id(h, n)
    assert sorted(got["ids"].tolist()) == list(range(n))
    want_pos = ref["Position"][:n].numpy()
    want_vel = ref["Velocity"][:n].numpy()
    err = np.abs(got["Position"] - want_pos).max()
    assert err < 1e-3 * scale, f"max position error {err} vs scale {scale}"
    np.testing.assert_allclose(got["Velocity"], want_vel, atol=2e-3)
    assert got["Position"].shape == (n, dim)
    # float64 runs differ only in the order of the slot sums: a ring that
    # drops ghosts or skips a refresh shows far above these
    assert err < 1e-9 * scale, f"max position error {err} vs scale {scale}"
    v_scale = np.abs(want_vel).max()
    v_err = np.abs(got["Velocity"] - want_vel).max()
    assert v_err < 1e-9 * v_scale, f"max velocity error {v_err} vs {v_scale}"


def test_block_domain_matches_single_device():
    scene, fluid = db.build_block_case(dx=0.05, cap=12, **F64)
    n = int(fluid["NReal"])
    s, ref = _single(scene, fluid, 4)
    h = _distributed(scene, fluid, 4, 128, 64)
    scale = scene.eng.grid.spacing[0] * scene.eng.grid.shape[0]
    _hold(h, s, ref, n, 2, scale)


def test_block_domain_conserves_and_stays_bounded_longer():
    """12 advection steps through the surge: particles conserved, no
    overflow, the front advances and stays inside the tank."""
    scene, fluid = db.build_block_case(dx=0.05, cap=12, **F64)
    fronts = []

    def front(h):
        fronts.append(max(float(p["Position"][p["Alive"], 0].max())
                          for p in h.fluid if bool(p["Alive"].any())))

    _distributed(scene, fluid, 12, 128, 64, each=front)
    assert fronts[-1] >= fronts[0]
    assert fronts[-1] < 5.4


def test_periodic_grid_is_refused():
    from sphinxsys_tpu_torch.cases import taylor_green_2d as tg

    scene, _ = tg.build_block_case(dx=0.1, **F64)
    with pytest.raises(ValueError, match="non-periodic"):
        bd.make_distributed_engine_step(scene.eng,
                                        make_particle_mesh(2, device="cpu"))
