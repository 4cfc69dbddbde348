"""3D elastic ball bouncing inside a rigid cylindrical shell (counterpart
of sphinxsys_tpu/cases/ball_shell_collision_3d.py; reference
tests/3d_examples/test_3d_elasticSolid_shell_collision): a Neo-Hookean
ball (E = 2e4, nu = 0.45, radius 0.5) falls under gravity inside a
215-degree cylindrical shell of surface particles (radius 2, thickness
dx) and bounces through the shell contact formulation: ShellContactFactor
(offset and Gauss-calibrated penetration measure) -> the wall repulsion
force -> PairwiseFrictionFromWall.

    case, ball = build_case(dx=0.05)          # 4,224 ball, 6,120 shell
    sim = make_run_chunk(case)(init_sim(case, ball), 2.0)   # JAX: 631 steps

The shell is rigid: only the ball integrates, total-Lagrangian on its
frozen inner pairs.  The contact list (ball rows, shell sources) is
rebuilt every step against the shell's static cell table, as JAX's
`_step` does.  JAX runs the steps as a `lax.while_loop`; here the loop is
on the host with dt a 0-d device tensor, one host read a step (the loop's
time test), so the step count follows the JAX loop's float arithmetic.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from sphinxsys_tpu_torch.core import geometry as G
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.generators import generate_lattice
from sphinxsys_tpu_torch.core.materials import NeoHookeanSolid
from sphinxsys_tpu_torch.core.state import State, make_solid_state
from sphinxsys_tpu_torch.device import PRODUCTION_DTYPE, resolve_device
from sphinxsys_tpu_torch.neighbors.cell_list import (CellGrid, CellTable,
                                                    build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list)
from sphinxsys_tpu_torch.physics import contact as ct
from sphinxsys_tpu_torch.physics import general as gd
from sphinxsys_tpu_torch.physics import solid as sd
from sphinxsys_tpu_torch.solver import chunk_runner

RADIUS = 2.0          # cylinder inner radius
HALF_HEIGHT = 1.0     # cylinder half height (y)
BALL_RADIUS = 0.5
GRAVITY_G = 1.0
RHO0 = 1.0e3
YOUNGS = 2.0e4
POISSON = 0.45
PHYSICAL_VISCOSITY = 1.0e6
ARC_DEG = 215.0       # shell arc


class SimState(NamedTuple):
    ball: Any
    nl_contact: NeighborList
    time: torch.Tensor       # 0-d, the state's dtype and device
    n_steps: int
    overflow: torch.Tensor   # 0-d bool: a contact list overflowed


@dataclasses.dataclass(frozen=True)
class BallShellCase:
    dx: float
    adaptation: SPHAdaptation
    grid: CellGrid
    material: NeoHookeanSolid
    shell: State
    shell_table: CellTable
    rp: sd.ReferencePairs
    n_ball: int
    cell_cap: int
    k_contact: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def make_cylinder_shell(dx: float, dtype=PRODUCTION_DTYPE,
                        device="cuda") -> State:
    """Mid-surface points of the 215-degree cylinder, axis along y,
    opening at the top (ParticleGenerator<SurfaceParticles, Cylinder>),
    with their outward normals."""
    device = resolve_device(device)
    r_mid = RADIUS + dx / 2.0
    n_arc = int(2.0 * r_mid * math.pi * ARC_DEG / 360.0 / dx)
    n_h = 2 * int(HALF_HEIGHT / dx)
    pos, normals = [], []
    for i in range(n_arc + 2):
        phi = (162.5 / 180.0 * math.pi
               + (i - 1 + 0.5) * ARC_DEG / 360.0 * 2.0 * math.pi / n_arc)
        for j in range(n_h):
            x = r_mid * math.cos(phi)
            z = r_mid * math.sin(phi)
            y = (j - n_h / 2) * dx + dx * 0.5
            pos.append((x, y, z))
            normals.append((x / r_mid, 0.0, z / r_mid))
    shell = make_solid_state(np.asarray(pos), dx * dx, RHO0, dtype, device)
    shell["NormalDirection"] = torch.as_tensor(np.asarray(normals), dtype=dtype,
                                               device=device)
    return shell


def build_case(dx: float = 0.05, dtype=PRODUCTION_DTYPE, cell_cap: int = 24,
               k_inner: int = 96, k_contact: int = 64, device="cuda"):
    """The ball with its frozen inner pairs and B matrix, the shell and
    its cell table.  Returns (case, ball state)."""
    device = resolve_device(device)
    adaptation = SPHAdaptation(spacing=dx, dim=3)
    material = NeoHookeanSolid(rho0=RHO0, youngs_modulus=YOUNGS,
                               poisson_ratio=POISSON)

    ball_shape = G.Ball(center=(RADIUS / 2.0, 0.0, 0.0), radius=BALL_RADIUS)
    lo = (-RADIUS - 4 * dx, -HALF_HEIGHT - 4 * dx, -RADIUS - 4 * dx)
    hi = (RADIUS + 4 * dx, HALF_HEIGHT + 4 * dx, RADIUS + 4 * dx)
    pos_b, vol = generate_lattice(ball_shape, lo, hi, dx)

    ball = sd.make_elastic_solid_state(pos_b, vol, material, dtype, device)
    n = len(pos_b)
    ball["RepulsionForce"] = torch.zeros((n, 3), dtype=dtype, device=device)
    ball["PreviousRepulsionForce"] = torch.zeros((n, 3), dtype=dtype,
                                                 device=device)
    ball = gd.gravity_force(ball, gd.Gravity(acceleration=(0.0, 0.0,
                                                           -GRAVITY_G)))
    shell = make_cylinder_shell(dx, dtype, device)

    grid = grid_from_bounds(lo, hi, adaptation.cutoff)
    shell_table = build_cell_table(shell["Position"], shell["NReal"], grid,
                                   cell_cap)
    # frozen total-Lagrangian inner topology and the B correction
    p0 = ball["Position"]
    ball_table = build_cell_table(p0, n, grid, cell_cap)
    nl_inner = build_neighbor_list(p0, n, p0, n, ball_table, grid,
                                   adaptation.cutoff, k_max=k_inner,
                                   include_self=False)
    rp = sd.freeze_reference_pairs(p0, nl_inner, adaptation.kernel, 3)
    ball["LinearGradientCorrectionMatrix"] = \
        sd.linear_gradient_correction_matrix(rp, ball["VolumetricMeasure"])

    case = BallShellCase(dx=dx, adaptation=adaptation, grid=grid,
                         material=material, shell=shell,
                         shell_table=shell_table, rp=rp, n_ball=n,
                         cell_cap=cell_cap, k_contact=k_contact)
    return case, ball


def contact_list(case: BallShellCase, ball: State) -> NeighborList:
    """The shell particles within the cutoff of each ball particle."""
    return build_neighbor_list(ball["Position"], ball["NReal"],
                               case.shell["Position"], case.shell["NReal"],
                               case.shell_table, case.grid,
                               case.adaptation.cutoff, k_max=case.k_contact,
                               include_self=True)


def init_sim(case: BallShellCase, ball: State) -> SimState:
    nl = contact_list(case, ball)
    return SimState(ball=ball, nl_contact=nl,
                    time=ball["Position"].new_zeros(()), n_steps=0,
                    overflow=nl.overflow)


def _step(case: BallShellCase, s: SimState) -> SimState:
    kernel, dim = case.kernel, 3
    h = case.adaptation.h
    ball = s.ball

    nl = contact_list(case, ball)
    factor = ct.shell_contact_factor(ball, case.shell, nl, kernel, dim,
                                     case.dx)
    stiffness = ct.contact_stiffness(case.material)
    ball = ct.repulsion_force_wall(ball, case.shell, nl, kernel, dim,
                                   factor, stiffness)

    dt = sd.solid_acoustic_time_step(ball, case.material.sound_speed, h,
                                     cfl=0.45)
    ball = ct.pairwise_friction_from_wall(ball, case.shell, nl, kernel, dim,
                                          PHYSICAL_VISCOSITY, dt)
    ball = sd.integration_1st_half_pk2(ball, case.rp, case.material, dt, h,
                                       kernel.w0(dim))
    ball = sd.integration_2nd_half(ball, case.rp, dt)

    return SimState(ball=ball, nl_contact=nl, time=s.time + dt,
                    n_steps=s.n_steps + 1, overflow=s.overflow | nl.overflow)


def make_run_chunk(case: BallShellCase):
    """run_chunk(sim, t_target): step until sim.time >= t_target (compared
    in the time's dtype; one host read a step)."""
    return chunk_runner(lambda s: _step(case, s))


def ball_center_z(s: SimState) -> float:
    return float(torch.mean(s.ball["Position"][:, 2]))


def max_radial_extent(s: SimState) -> float:
    """max over ball particles of sqrt(x^2 + z^2), the penetration
    monitor."""
    p = s.ball["Position"]
    return float(torch.max(torch.sqrt(p[:, 0] ** 2 + p[:, 2] ** 2)))
