"""The port's distributed total-Lagrangian beam and fsi2
(parallel/halo_cases.py) on a ThreadRing of 8 ranks against the port's
single-device steps, on the CPU in float64: tests/test_domain.py's beam
(:125; positions 1e-6, velocities 1e-4) and fsi2 (:162; fluid
velocities 2e-3, the replicated solid's positions 1e-4, equal solid
sub-step counts) at their widths, steps and tolerances, with the times
to rtol 1e-12 (the ring's reductions give the single-device time steps;
the fsi2 forces on the solid are summed over the ring in rank order, so
they differ from the single-device sums only in order)."""

import numpy as np
import torch

from sphinxsys_tpu_torch.cases import fsi2
from sphinxsys_tpu_torch.cases import oscillating_beam_2d as ob
from sphinxsys_tpu_torch.parallel import domain as dm
from sphinxsys_tpu_torch.parallel import halo_cases as hc
from sphinxsys_tpu_torch.parallel.mesh import make_particle_mesh

torch.set_num_threads(1)
F64 = dict(dtype=torch.float64, device="cpu")


def _with_ids(state):
    n = state["Position"].shape[0]
    return dict(state, OriginalID=torch.arange(n, dtype=torch.int32))


def _tight(got, want):
    """float64 runs that differ only in summation order: within 1e-9 of
    the largest magnitude (of a displacement, a position or a velocity),
    far below what a dropped ghost or a skipped refresh gives."""
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= 1e-9 * scale, f"max error {err} vs scale {scale}"


def test_beam_distributed_matched_step_parity():
    ring = make_particle_mesh(8, device="cpu")
    case, sim_s = ob.build_case(**F64)
    n = case.n_solid
    sim_d = hc.distribute_beam(case, _with_ids(sim_s.solid), ring)
    step_d = hc.make_halo_beam_step(case, ring)
    step_s = ob.make_step(case)
    for _ in range(8):
        sim_d, sim_s = step_d(sim_d), step_s(sim_s)
    assert not bool(sim_d.overflow)
    assert sum(int(p["Alive"].sum()) for p in sim_d.fluid) == n
    np.testing.assert_allclose(float(sim_d.time), float(sim_s.time), rtol=1e-12)
    got = dm.gather_by_id(sim_d, n)
    np.testing.assert_allclose(got["Position"],
                               sim_s.solid["Position"][:n].numpy(), atol=1e-6)
    np.testing.assert_allclose(got["Velocity"],
                               sim_s.solid["Velocity"][:n].numpy(), atol=1e-4)
    _tight(got["Position"] - sim_s.solid["InitialPosition"][:n].numpy(),
           sim_s.solid["Position"][:n].numpy()
           - sim_s.solid["InitialPosition"][:n].numpy())
    _tight(got["Velocity"], sim_s.solid["Velocity"][:n].numpy())


def test_fsi2_distributed_matched_step_parity():
    ring = make_particle_mesh(8, device="cpu")
    case, fluid, solid = fsi2.build_case(dx=0.1, **F64)
    n = int(fluid["NReal"])
    sim_d = hc.distribute_fsi2(case, _with_ids(fluid), solid, ring)
    step_d = hc.make_halo_fsi2_step(case, ring, halo_cap=128, migrate_cap=64)
    sim_s = fsi2.init_sim(case, fluid, solid)
    step_s = fsi2.make_advection_step(case)
    for _ in range(4):
        sim_d, sim_s = step_d(sim_d), step_s(sim_s)
    assert not bool(sim_d.overflow)
    assert sim_d.n_adv == sim_s.n_adv == 4
    assert sim_d.n_ac == sim_s.n_ac
    got = dm.gather_by_id(sim_d, n)
    np.testing.assert_allclose(got["Velocity"],
                               sim_s.fluid["Velocity"][:n].numpy(), atol=2e-3)
    solid_d, n_s, t = sim_d.aux
    np.testing.assert_allclose(solid_d["Position"].numpy(),
                               sim_s.solid["Position"].numpy(), atol=1e-4)
    _tight(got["Velocity"], sim_s.fluid["Velocity"][:n].numpy())
    _tight(got["Position"] - fluid["Position"][:n].numpy(),
           sim_s.fluid["Position"][:n].numpy() - fluid["Position"][:n].numpy())
    # the solid moves ~6e-12 in these steps, its forces summed over the
    # ring in rank order: held to 1e-9 of its extent
    _tight(solid_d["Position"].numpy(), sim_s.solid["Position"].numpy())
    assert n_s == sim_s.n_s
    np.testing.assert_allclose(float(t), float(sim_s.time), rtol=1e-12)
    np.testing.assert_allclose(float(sim_d.time), float(sim_s.time), rtol=1e-12)
