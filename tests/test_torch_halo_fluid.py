"""The port's distributed gather-route fluids (parallel/halo_cases.py
over parallel/domain.py) on a ThreadRing of 8 ranks against the port's
single-device step, on the CPU in float64: tests/test_domain.py's
dambreak (:34) and Taylor-Green (:77) at their widths, steps and
tolerances (positions 1e-3 of the domain scale, velocities 2e-3, the
kinetic energy 1e-3, circular distance 1e-3 L), with the acoustic
sub-step counts equal and the times to rtol 1e-12: the ring's reductions
give the single-device time steps exactly, and the runs differ only in
the order of float64 sums (measured 4e-16 in positions)."""

import numpy as np
import torch

from sphinxsys_tpu_torch.cases import dambreak_2d as db
from sphinxsys_tpu_torch.cases import taylor_green_2d as tg
from sphinxsys_tpu_torch.parallel import domain as dm
from sphinxsys_tpu_torch.parallel import halo_cases as hc
from sphinxsys_tpu_torch.parallel.mesh import make_particle_mesh

torch.set_num_threads(1)
F64 = dict(dtype=torch.float64, device="cpu")


def _with_ids(fluid):
    n = fluid["Position"].shape[0]
    return dict(fluid, OriginalID=torch.arange(n, dtype=torch.int32))


def test_dambreak_matched_step_parity():
    ring = make_particle_mesh(8, device="cpu")
    case, fluid = db.build_case(dx=0.12, cell_cap=16, k_inner=48, k_wall=32,
                                **F64)
    n = int(fluid["NReal"])
    sim_d = hc.distribute_dambreak(case, _with_ids(fluid), ring)
    step_d = hc.make_halo_dambreak_step(case, ring, halo_cap=96,
                                        migrate_cap=48)
    sim_s = db.init_sim(case, fluid)
    step_s = db.make_advection_step(case)
    for _ in range(6):
        sim_d, sim_s = step_d(sim_d), step_s(sim_s)
    assert not bool(sim_d.overflow)
    assert sim_d.n_adv == sim_s.n_adv == 6
    assert sim_d.n_ac == sim_s.n_ac
    np.testing.assert_allclose(float(sim_d.time), float(sim_s.time), rtol=1e-12)
    got = dm.gather_by_id(sim_d, n)
    assert sorted(got["ids"].tolist()) == list(range(n))
    want_pos = sim_s.fluid["Position"][:n].numpy()
    want_vel = sim_s.fluid["Velocity"][:n].numpy()
    scale = np.abs(want_pos).max()
    np.testing.assert_allclose(got["Position"], want_pos, atol=1e-3 * scale)
    np.testing.assert_allclose(got["Velocity"], want_vel, atol=2e-3)
    assert np.abs(got["Position"] - want_pos).max() < 1e-9 * scale


def test_taylor_green_distributed():
    ring = make_particle_mesh(8, device="cpu")
    case, fluid = tg.build_case(dx=0.05, **F64)
    n = int(fluid["NReal"])
    sim_d = hc.distribute_taylor_green(case, _with_ids(fluid), ring)
    step_d = hc.make_halo_taylor_green_step(case, ring, halo_cap=128,
                                            migrate_cap=64)
    sim_s = tg.init_sim(case, fluid)
    step_s = tg.make_advection_step(case)
    n0 = sum(int(p["Alive"].sum()) for p in sim_d.fluid)
    for _ in range(4):
        sim_d, sim_s = step_d(sim_d), step_s(sim_s)
    assert not bool(sim_d.overflow)
    assert sum(int(p["Alive"].sum()) for p in sim_d.fluid) == n0 == n
    assert sim_d.n_ac == sim_s.n_ac
    np.testing.assert_allclose(float(sim_d.time), float(sim_s.time), rtol=1e-12)
    ke_d = sum(float(torch.sum(0.5 * p["Mass"][p["Alive"]]
                               * torch.sum(p["Velocity"][p["Alive"]] ** 2, -1)))
               for p in sim_d.fluid)
    f = sim_s.fluid
    ke_s = float(torch.sum(0.5 * f["Mass"][:n] * torch.sum(f["Velocity"][:n] ** 2,
                                                          -1)))
    assert abs(ke_d - ke_s) / ke_s < 1e-3
    got = dm.gather_by_id(sim_d, n)
    want = f["Position"][:n].numpy()
    # a row that crossed the decomposed axis's end is wrapped at the next
    # step's migration, the single-device run's at the step's end
    L = np.asarray(case.box)
    d = np.abs(got["Position"] - want)
    d = np.minimum(d, L - d)
    assert d.max() < 1e-3 * L.max()
    assert d.max() < 1e-9 * L.max()
