"""A 2D elastic cube sliding down a frictionless rigid 30-degree slope
(counterpart of sphinxsys_tpu/cases/sliding_2d.py; reference
tests/2d_examples/test_2d_sliding/sliding.cpp): a St. Venant-Kirchhoff
cube (L = 1, E = 5e5, nu = 0.45) rests on the top of a rigid wall, both
turned by -0.5235 rad about the origin, and slides under gravity with
frictionless penalty contact and strong pairwise damping of its velocity
(eta = 1e6, every step).  Oracle: the rigid slide s(t) = g sin(theta)
t^2 / 2 along the incline.

    case, cube = build_case(device="cpu")
    sim = make_run_chunk(case)(init_sim(case, cube), 0.05)

As in the JAX package, the wall is only a 4 dx deep band under its top
surface (contact sees no deeper).  One host read a step (the loop's time
test).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.materials import SaintVenantKirchhoffSolid
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

DL = 20.0
SLOPE_H = 11.55          # the top surface's height before the rotation
L = 1.0                  # the cube's edge
THETA = 0.5235           # the rotation (30 degrees)
RHO0 = 1.0e3
YOUNGS = 5.0e5
POISSON = 0.45
GRAVITY_G = 9.8
PHYSICAL_VISCOSITY = 1.0e6
OBSERVER = (7.2, 9.8)    # sliding.cpp:22 (world frame, after the rotation)


class SimState(NamedTuple):
    cube: State
    time: torch.Tensor        # 0-d, the state's dtype and device
    n_steps: int
    overflow: torch.Tensor    # 0-d bool: the contact list overflowed


@dataclasses.dataclass(frozen=True)
class SlidingCase:
    dx: float
    adaptation: SPHAdaptation
    grid: CellGrid
    material: SaintVenantKirchhoffSolid
    wall: State
    wall_table: CellTable
    rp: sd.ReferencePairs
    nl_inner: NeighborList
    n_cube: int
    k_contact: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def _rotate(pos: np.ndarray, theta: float) -> np.ndarray:
    c, s = math.cos(theta), math.sin(theta)
    return pos @ np.asarray([[c, -s], [s, c]]).T


def build_case(dx: float = L / 10.0, dtype=PRODUCTION_DTYPE,
               cell_cap: int = 16, k_inner: int = 32, k_contact: int = 24,
               device="cuda"):
    """The turned wall band and cube, the cube's frozen pairs, B and inner
    list.  Returns (case, cube)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    material = SaintVenantKirchhoffSolid(rho0=RHO0, youngs_modulus=YOUNGS,
                                         poisson_ratio=POISSON)
    bw = 4 * dx
    nx, ny = int(round(DL / dx)), 4
    ix, iy = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    wall_pos = _rotate(np.stack([(ix.ravel() + 0.5) * dx,
                                 SLOPE_H - (iy.ravel() + 0.5) * dx], axis=1),
                       -THETA)
    wall = make_solid_state(wall_pos, dx * dx, RHO0, dtype, device)

    # the cube [bw, bw + L] x [SLOPE_H + dx, SLOPE_H + L + dx]
    # (sliding.cpp:50-56)
    ncx = int(round(L / dx))
    jx, jy = np.meshgrid(np.arange(ncx), np.arange(ncx), indexing="ij")
    cube_pos = _rotate(np.stack([bw + (jx.ravel() + 0.5) * dx,
                                 SLOPE_H + dx + (jy.ravel() + 0.5) * dx],
                                axis=1), -THETA)
    cube = sd.make_elastic_solid_state(cube_pos, dx * dx, material, dtype,
                                       device)
    n = len(cube_pos)
    cube["RepulsionForce"] = torch.zeros((n, 2), dtype=dtype, device=device)
    cube["PreviousRepulsionForce"] = torch.zeros((n, 2), dtype=dtype,
                                                 device=device)
    cube = gd.gravity_force(cube, gd.Gravity(acceleration=(0.0, -GRAVITY_G)))

    all_pos = np.concatenate([wall_pos, cube_pos])
    grid = grid_from_bounds(tuple(all_pos.min(axis=0) - 4 * dx),
                            tuple(all_pos.max(axis=0) + 4 * dx),
                            adaptation.cutoff)
    wall_table = build_cell_table(wall["Position"], wall["NReal"], grid,
                                  cell_cap)
    p0 = cube["Position"]
    cube_table = build_cell_table(p0, n, grid, cell_cap)
    nl_inner = build_neighbor_list(p0, n, p0, n, cube_table, grid,
                                   adaptation.cutoff, k_max=k_inner,
                                   include_self=False)
    rp = sd.freeze_reference_pairs(p0, nl_inner, adaptation.kernel, 2)
    cube["LinearGradientCorrectionMatrix"] = \
        sd.linear_gradient_correction_matrix(rp, cube["VolumetricMeasure"])
    case = SlidingCase(dx=dx, adaptation=adaptation, grid=grid,
                       material=material, wall=wall, wall_table=wall_table,
                       rp=rp, nl_inner=nl_inner, n_cube=n,
                       k_contact=k_contact)
    return case, cube


def init_sim(case: SlidingCase, cube: State) -> SimState:
    pos = cube["Position"]
    return SimState(cube=cube, time=pos.new_zeros(()), n_steps=0,
                    overflow=torch.zeros((), dtype=torch.bool,
                                         device=pos.device))


def damping(case: SlidingCase, cube: State, dt) -> State:
    """The cube's velocity damping (sliding.cpp:112), every step."""
    return dp.damping_pairwise(cube, "Velocity", case.nl_inner, case.kernel,
                               2, PHYSICAL_VISCOSITY, dt)


def _step(case: SlidingCase, s: SimState) -> SimState:
    kernel, h = case.kernel, case.adaptation.h
    cube = s.cube
    nl = build_neighbor_list(cube["Position"], cube["NReal"],
                             case.wall["Position"], case.wall["NReal"],
                             case.wall_table, case.grid,
                             case.adaptation.cutoff, k_max=case.k_contact,
                             include_self=True)
    factor = ct.repulsion_factor_contact(cube, case.wall, nl, kernel, 2)
    cube = ct.repulsion_force_wall(cube, case.wall, nl, kernel, 2, factor,
                                   ct.contact_stiffness(case.material))
    dt = sd.solid_acoustic_time_step(cube, case.material.sound_speed, h,
                                     cfl=0.45)
    cube = sd.integration_1st_half_pk2(cube, case.rp, case.material, dt, h,
                                       kernel.w0(2))
    cube = damping(case, cube, dt)
    cube = sd.integration_2nd_half(cube, case.rp, dt)
    return SimState(cube=cube, time=s.time + dt, n_steps=s.n_steps + 1,
                    overflow=s.overflow | nl.overflow)


def make_step(case: SlidingCase):
    return lambda s: _step(case, s)


def make_run_chunk(case: SlidingCase):
    """run_chunk(sim, t_target): steps until sim.time >= t_target."""
    return chunk_runner(lambda s: _step(case, s))


def cube_observer(case: SlidingCase, cube: State):
    """The material observer at OBSERVER (sliding.cpp:22): W(r0) V weights
    on the initial configuration, never updated: (row indices, normalised
    weights) on the cube's device."""
    dtype, dev = cube["Position"].dtype, cube["Position"].device
    pos0 = cube["InitialPosition"].cpu().numpy()
    r = np.linalg.norm(pos0 - np.asarray(OBSERVER), axis=1)
    idx = np.nonzero(r < case.adaptation.cutoff)[0]
    w = np.asarray([float(case.kernel.W(torch.as_tensor(ri, dtype=dtype), 2))
                    for ri in r[idx]])
    w = w * cube["VolumetricMeasure"].cpu().numpy()[idx]
    return (torch.as_tensor(idx, device=dev),
            torch.as_tensor(w / (w.sum() + 1e-15), dtype=dtype, device=dev))


def observe_position(s: SimState, idx, weights) -> np.ndarray:
    return torch.sum(s.cube["Position"][idx] * weights[:, None],
                     dim=0).cpu().numpy()


def slide_distance(s: SimState, pos_start: np.ndarray) -> float:
    """The mean displacement's length along the incline."""
    d = torch.mean(s.cube["Position"], dim=0).cpu().numpy() - pos_start
    return float(np.linalg.norm(d))
