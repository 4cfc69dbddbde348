"""Two soft balls bouncing inside a rigid box, one free and one internally
damped (counterpart of sphinxsys_tpu/cases/collision_2d.py; reference
tests/2d_examples/test_2d_collision/collision.cpp): two Neo-Hookean balls
(r = 0.5, E = 5e4, nu = 0.45) fall under g = 1 inside an 8 x 4 box; the
free ball keeps bouncing while the damping ball (pairwise implicit
damping of its velocity, eta = 1e4, every step) sheds its kinetic energy
and settles on the floor.  Contact is the frictionless penalty pair
(repulsion factor and force from the wall).

    case, balls = build_case(dx=0.1, device="cpu")
    sim = make_run_chunk(case)(init_sim(case, balls), 0.05)

The balls never meet (centres x = 2 and x = 6), so each integrates on its
own against the shared wall, each step rebuilding its contact list
against the wall's static cell table.  One host read a step (the loop's
time test).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from sphinxsys_tpu_torch.core import geometry as G
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.generators import generate_lattice
from sphinxsys_tpu_torch.core.materials import NeoHookeanSolid
from sphinxsys_tpu_torch.core.state import State, make_solid_state
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.neighbors.cell_list import (CellGrid, CellTable,
                                                    build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list)
from sphinxsys_tpu_torch.physics import contact as ct
from sphinxsys_tpu_torch.physics import dissipation as dp
from sphinxsys_tpu_torch.physics import general as gd
from sphinxsys_tpu_torch.physics import solid as sd
from sphinxsys_tpu_torch.solver import chunk_runner

DL, DH = 8.0, 4.0
BALL_R = 0.5
BALL_CENTER_1 = (2.0, 2.0)   # the free ball
BALL_CENTER_2 = (6.0, 2.0)   # the damping ball
GRAVITY_G = 1.0
RHO0 = 1.0e3
YOUNGS = 5.0e4
POISSON = 0.45
PHYSICAL_VISCOSITY = 1.0e4


class SimState(NamedTuple):
    free_ball: State
    damping_ball: State
    time: torch.Tensor        # 0-d, the state's dtype and device
    n_steps: int
    overflow: torch.Tensor    # 0-d bool: a contact list overflowed


@dataclasses.dataclass(frozen=True)
class CollisionCase:
    dx: float
    adaptation: SPHAdaptation
    grid: CellGrid
    material: NeoHookeanSolid
    wall: State
    wall_table: CellTable
    rp_free: sd.ReferencePairs
    rp_damp: sd.ReferencePairs
    nl_damp_inner: NeighborList
    k_contact: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def _make_ball(center, dx, material, adaptation, grid, cell_cap, k_inner,
               dtype, device):
    shape = G.Ball(center=center, radius=BALL_R)
    lo = (center[0] - BALL_R - 2 * dx, center[1] - BALL_R - 2 * dx)
    hi = (center[0] + BALL_R + 2 * dx, center[1] + BALL_R + 2 * dx)
    pos, vol = generate_lattice(shape, lo, hi, dx)
    ball = sd.make_elastic_solid_state(pos, vol, material, dtype, device)
    n = len(pos)
    ball["RepulsionForce"] = torch.zeros((n, 2), dtype=dtype, device=device)
    ball["PreviousRepulsionForce"] = torch.zeros((n, 2), dtype=dtype,
                                                 device=device)
    ball = gd.gravity_force(ball, gd.Gravity(acceleration=(0.0, -GRAVITY_G)))
    p0 = ball["Position"]
    table = build_cell_table(p0, n, grid, cell_cap)
    nl = build_neighbor_list(p0, n, p0, n, table, grid, adaptation.cutoff,
                             k_max=k_inner, include_self=False)
    rp = sd.freeze_reference_pairs(p0, nl, adaptation.kernel, 2)
    ball["LinearGradientCorrectionMatrix"] = \
        sd.linear_gradient_correction_matrix(rp, ball["VolumetricMeasure"])
    return ball, rp, nl


def build_case(dx: float = 0.025, dtype=PRODUCTION_DTYPE, cell_cap: int = 16,
               k_inner: int = 32, k_contact: int = 24, device="cuda"):
    """The box frame (4 dx thick), both balls with their frozen pairs and
    B, the damping ball's inner list.  Returns (case, (free ball, damping
    ball)), as the JAX package's build does."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    material = NeoHookeanSolid(rho0=RHO0, youngs_modulus=YOUNGS,
                               poisson_ratio=POISSON)
    bw = 4 * dx
    centre = G.Transform(translation=(DL / 2, DH / 2))
    frame = G.make_complex(
        ("add", G.Box(transform=centre, halfsize=(DL / 2 + bw, DH / 2 + bw))),
        ("sub", G.Box(transform=centre, halfsize=(DL / 2, DH / 2))))
    wall_pos, wall_vol = generate_lattice(frame, (-bw - dx, -bw - dx),
                                          (DL + bw + dx, DH + bw + dx), dx)
    wall = make_solid_state(wall_pos, wall_vol, RHO0, dtype, device)

    grid = grid_from_bounds((-bw - 4 * dx, -bw - 4 * dx),
                            (DL + bw + 4 * dx, DH + bw + 4 * dx),
                            adaptation.cutoff)
    wall_table = build_cell_table(wall["Position"], wall["NReal"], grid,
                                  cell_cap)
    args = (dx, material, adaptation, grid, cell_cap, k_inner, dtype, device)
    free_ball, rp_free, _ = _make_ball(BALL_CENTER_1, *args)
    damping_ball, rp_damp, nl_damp = _make_ball(BALL_CENTER_2, *args)
    case = CollisionCase(dx=dx, adaptation=adaptation, grid=grid,
                         material=material, wall=wall, wall_table=wall_table,
                         rp_free=rp_free, rp_damp=rp_damp,
                         nl_damp_inner=nl_damp, k_contact=k_contact)
    return case, (free_ball, damping_ball)


def init_sim(case: CollisionCase, balls) -> SimState:
    free_ball, damping_ball = balls
    pos = free_ball["Position"]
    return SimState(free_ball=free_ball, damping_ball=damping_ball,
                    time=pos.new_zeros(()), n_steps=0,
                    overflow=torch.zeros((), dtype=torch.bool,
                                         device=pos.device))


def _ball_substep(case: CollisionCase, ball: State, rp, dt):
    """The contact list against the wall, the repulsion and the first
    half: (ball, the list's overflow)."""
    kernel = case.kernel
    nl = build_neighbor_list(ball["Position"], ball["NReal"],
                             case.wall["Position"], case.wall["NReal"],
                             case.wall_table, case.grid,
                             case.adaptation.cutoff, k_max=case.k_contact,
                             include_self=True)
    factor = ct.repulsion_factor_contact(ball, case.wall, nl, kernel, 2)
    ball = ct.repulsion_force_wall(ball, case.wall, nl, kernel, 2, factor,
                                   ct.contact_stiffness(case.material))
    ball = sd.integration_1st_half_pk2(ball, rp, case.material, dt,
                                       case.adaptation.h, kernel.w0(2))
    return ball, nl.overflow


def damping(case: CollisionCase, ball: State, dt) -> State:
    """The damping ball's velocity damping (collision.cpp:202-203)."""
    return dp.damping_pairwise(ball, "Velocity", case.nl_damp_inner,
                               case.kernel, 2, PHYSICAL_VISCOSITY, dt)


def _step(case: CollisionCase, s: SimState) -> SimState:
    h, c0 = case.adaptation.h, case.material.sound_speed
    dt = torch.minimum(
        sd.solid_acoustic_time_step(s.free_ball, c0, h, cfl=0.45),
        sd.solid_acoustic_time_step(s.damping_ball, c0, h, cfl=0.45))
    free_ball, ovf1 = _ball_substep(case, s.free_ball, case.rp_free, dt)
    free_ball = sd.integration_2nd_half(free_ball, case.rp_free, dt)
    damping_ball, ovf2 = _ball_substep(case, s.damping_ball, case.rp_damp, dt)
    damping_ball = damping(case, damping_ball, dt)
    damping_ball = sd.integration_2nd_half(damping_ball, case.rp_damp, dt)
    return SimState(free_ball=free_ball, damping_ball=damping_ball,
                    time=s.time + dt, n_steps=s.n_steps + 1,
                    overflow=s.overflow | ovf1 | ovf2)


def make_step(case: CollisionCase):
    return lambda s: _step(case, s)


def make_run_chunk(case: CollisionCase):
    """run_chunk(sim, t_target): steps until sim.time >= t_target."""
    return chunk_runner(lambda s: _step(case, s))


def ball_center(ball: State) -> np.ndarray:
    return torch.mean(ball["Position"], dim=0).cpu().numpy()
