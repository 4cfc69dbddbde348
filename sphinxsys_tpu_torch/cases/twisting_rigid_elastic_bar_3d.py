"""A bar, elastic with a rigid end, under a twisting and bending end load
(counterpart of sphinxsys_tpu/cases/twisting_rigid_elastic_bar_3d.py;
reference tests/3d_examples/test_3d_twisting_rigid_elastic_bar): a
Neo-Hookean bar (x in [-2, 3], 1 x 1 cross-section, z in [0, 1],
rho = 1e-3, E = 5, nu = 0.45, dp = 1/(4 res)) whose last unit length
(x > 2) is a free 6-DOF rigid body, driven by the SPH coupling force on
its particles plus an external load (force (0, -P, 0), torque
(-P h, 0, 0), P ramping to 0.05 over t = 1).  The elastic part runs PK2
stress relaxation with the clamp at x < -2 and pairwise velocity damping
whose list leaves out every pair with a rigid side (ExcludeRigidNeighbors,
cpp:79-103); the rigid constraint is imposed around every elastic stage
(cpp:355-385).  The oracle: the FEBio displacements of the four interface
corners, within 15%.

    case, sim = build_case(res_factor=1, device="cpu")
    sim = make_run_chunk(case)(sim, 0.01)
    print(sim.n_steps, observer_displacements(case, sim))

The JAX package's build defaults to float64, as this one does: its CLI
runs with x64 off and so computes in float32 there, while the port
honours float64 on every device.  One host read a step (the loop's time
test).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.materials import NeoHookeanSolid
from sphinxsys_tpu_torch.core.state import State
from sphinxsys_tpu_torch.device import resolve_device, resolve_dtype
from sphinxsys_tpu_torch.neighbors.cell_list import (build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list)
from sphinxsys_tpu_torch.physics import dissipation as dpp
from sphinxsys_tpu_torch.physics import rigid as rgd
from sphinxsys_tpu_torch.physics import solid as sd
from sphinxsys_tpu_torch.solver import chunk_runner

ELASTIC_L = 4.0
RIGID_L = 1.0
HEIGHT = 1.0
WIDTH = 1.0
X0 = -2.0
RHO0 = 1000.0 * 1e-6          # 1000 * unit_mm^2
YOUNGS = 5.0
POISSON = 0.45
P_MAX = 0.05
MAX_END_TIME = 5.0


def physical_viscosity(shape_constant: float = 0.4) -> float:
    return shape_constant / 4.0 * math.sqrt(RHO0 * YOUNGS) * HEIGHT


class BarSim(NamedTuple):
    bar: State
    rb: rgd.RigidBody3D
    time: torch.Tensor
    n_steps: int
    dt: torch.Tensor          # the next step's dt


@dataclasses.dataclass(frozen=True)
class BarCase:
    dp: float
    adaptation: SPHAdaptation
    material: NeoHookeanSolid
    rp: sd.ReferencePairs
    nl_damp: NeighborList      # the damping's list, rigid pairs left out
    clamp_mask: torch.Tensor
    rigid_mask: torch.Tensor
    rb0: rgd.RigidBody3D
    initial_pos: torch.Tensor
    n_bar: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def force_p(t):
    """The load ramp (cpp:228-231): P = 0.05 min(t, 1)."""
    return P_MAX * torch.clamp(t, max=1.0)


def build_case(res_factor: int = 2, dtype=torch.float64, k_inner: int = 96,
               cell_cap: int = 40, device="cuda"):
    """The bar with one clamp layer, its frozen pairs, B, the damping's
    list and the rigid end's body.  Returns (case, sim)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    dp_ = WIDTH / (4.0 * res_factor)
    adaptation = SPHAdaptation(spacing=dp_, dim=3)
    material = NeoHookeanSolid(rho0=RHO0, youngs_modulus=YOUNGS,
                               poisson_ratio=POISSON)
    # the whole bar with one clamp layer: x in [X0 - dp, X0 + 5]
    xs = np.arange(X0 - dp_ + dp_ / 2, X0 + ELASTIC_L + RIGID_L, dp_)
    ys = np.arange(-0.5 * HEIGHT + dp_ / 2, 0.5 * HEIGHT, dp_)
    zs = np.arange(dp_ / 2, WIDTH, dp_)
    pos = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), -1).reshape(-1, 3)
    n = len(pos)
    bar = sd.make_elastic_solid_state(pos, dp_ ** 3, material, dtype, device)
    rigid_np = pos[:, 0] > X0 + ELASTIC_L
    clamp_mask = torch.as_tensor(pos[:, 0] < X0, device=device)
    rigid_mask = torch.as_tensor(rigid_np, device=device)

    grid = grid_from_bounds((X0 - 6 * dp_, -HEIGHT - 3.0, -WIDTH - 3.0),
                            (X0 + ELASTIC_L + RIGID_L + 3.0, HEIGHT + 3.0,
                             WIDTH + 3.0), adaptation.cutoff)
    p0 = bar["Position"]
    table = build_cell_table(p0, n, grid, cell_cap)
    nl = build_neighbor_list(p0, n, p0, n, table, grid, adaptation.cutoff,
                             k_max=k_inner, include_self=False)
    if bool(nl.overflow):
        raise ValueError("raise k_inner: the frozen pairs must be exact")
    rp = sd.freeze_reference_pairs(p0, nl, adaptation.kernel, 3)
    bar["LinearGradientCorrectionMatrix"] = \
        sd.linear_gradient_correction_matrix(rp, bar["VolumetricMeasure"])

    # the damping's list: the pairs with either side rigid dropped
    idx = nl.idx.cpu().numpy()
    j_rigid = np.where(idx < n, rigid_np[np.minimum(idx, n - 1)], False)
    drop = j_rigid | rigid_np[:, None]
    nl_damp = nl._replace(idx=torch.as_tensor(np.where(drop, n, idx),
                                              dtype=nl.idx.dtype,
                                              device=device))
    rb0 = rgd.rigid_body_from_particles_3d(bar, rigid_mask)
    case = BarCase(dp=dp_, adaptation=adaptation, material=material, rp=rp,
                   nl_damp=nl_damp, clamp_mask=clamp_mask,
                   rigid_mask=rigid_mask, rb0=rb0, initial_pos=p0, n_bar=n)
    sim = BarSim(bar=bar, rb=rb0, time=p0.new_zeros(()), n_steps=0,
                 dt=torch.full((), 1e-5, dtype=dtype, device=device))
    return case, sim


def _constrain_rigid(case: BarCase, bar: State, rb) -> State:
    return rgd.constrain_by_rigid_body_3d(bar, case.rigid_mask, rb,
                                          case.initial_pos, case.rb0.com)


def damping(case: BarCase, bar: State, dt) -> State:
    """DampingWithRandomChoice(0.5, ..., 2 eta): every step at
    2 eta / 0.5 on the list without rigid pairs."""
    return dpp.damping_pairwise(bar, "Velocity", case.nl_damp, case.kernel,
                                3, 2.0 * physical_viscosity() / 0.5, dt)


def rigid_update(case: BarCase, bar: State, rb, time, dt):
    """The rigid end's step from the coupling force and the external load
    (cpp:232-243)."""
    f_c, tq_c = rgd.total_force_and_torque_3d(bar, case.rigid_mask, rb)
    P = force_p(time)
    z = torch.zeros_like(P)
    f_ext = torch.stack([z, -P, z])
    tq_ext = torch.stack([-P * HEIGHT, z, z])
    return rgd.rigid_step_3d(rb, f_c + f_ext, tq_c + tq_ext, dt)


def _step(case: BarCase, s: BarSim) -> BarSim:
    h = case.adaptation.h
    dt = s.dt
    bar, rb = s.bar, s.rb
    bar = sd.integration_1st_half_pk2(bar, case.rp, case.material, dt, h,
                                      case.kernel.w0(3))
    bar = _constrain_rigid(case, bar, rb)
    bar = sd.fix_constraint(bar, case.clamp_mask)
    bar = damping(case, bar, dt)
    bar = sd.fix_constraint(bar, case.clamp_mask)
    bar = _constrain_rigid(case, bar, rb)
    rb = rigid_update(case, bar, rb, s.time, dt)
    bar = _constrain_rigid(case, bar, rb)
    bar = sd.integration_2nd_half(bar, case.rp, dt)
    bar = _constrain_rigid(case, bar, rb)
    dt_next = sd.solid_acoustic_time_step(bar, case.material.sound_speed, h)
    return BarSim(bar=bar, rb=rb, time=s.time + dt, n_steps=s.n_steps + 1,
                  dt=dt_next)


def make_step(case: BarCase):
    return lambda s: _step(case, s)


def make_run_chunk(case: BarCase):
    """run_chunk(sim, t_target): steps until sim.time >= t_target."""
    return chunk_runner(lambda s: _step(case, s))


# the FEBio reference (reference_data/displacement at
# reference_data/initial_position): the interface corners (x = 2) and
# their displacements
OBSERVERS = np.asarray([
    (2.0, 0.5, 0.0),
    (2.0, 0.5, 1.0),
    (2.0, -0.5, 0.0),
    (2.0, -0.5, 1.0),
])
FEBIO_DISP = {
    (2.0, 0.5, 0.0): (-0.504557, -2.60476, 0.0948022),
    (2.0, 0.5, 1.0): (-0.244248, -2.16765, -0.0442815),
    (2.0, -0.5, 0.0): (-1.21962, -2.11663, 0.570901),
    (2.0, -0.5, 1.0): (-0.959311, -1.67953, 0.431817),
}


def observer_displacements(case: BarCase, s: BarSim) -> np.ndarray:
    """The displacement of the material particle nearest each interface
    corner (within dp/2 of it): (4, 3)."""
    pos0 = case.initial_pos.double().cpu().numpy()
    pos = s.bar["Position"].double().cpu().numpy()
    out = []
    for p in OBSERVERS:
        i = int(np.argmin(np.linalg.norm(pos0 - p, axis=1)))
        out.append(pos[i] - pos0[i])
    return np.asarray(out)
