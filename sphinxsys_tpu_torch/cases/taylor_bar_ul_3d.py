"""3D Taylor bar impact, the updated-Lagrangian solid with J2 plasticity and
hourglass control (counterpart of sphinxsys_tpu/cases/taylor_bar_ul_3d.py;
reference tests/3d_examples/test_3d_taylor_bar_UL/taylor_bar_UL.{h,cpp}):
an aluminium cylinder (r = 3.91 mm, h = 23.46 mm, rho0 = 2700,
E = 78.2 GPa, nu = 0.3, yield 0.29 GPa) hits a rigid holder at 373 m/s.

An advection step (taylor_bar_UL.cpp:125-157): the volume update, the
inner and column -> wall lists, the correction matrix on the current
configuration, the advection dt (CFL 0.2, U_ref = 373); then acoustic
sub-steps (CFL 0.4, the last one cut to end on the advection dt) of the
wall contact force (into ForcePrior, raw, every sub-step, as the
reference's), pressure relaxation with the shear force, the J2 shear
stress, the shear acceleration and the density relaxation
(oscillating_beam_ul_2d's `ul_substep`).  Both loops are host loops.

    case, col = build_case_ci(dx=PL / 3, device="cpu")
    sim = make_run_chunk(case)(init_sim(case, col), 2e-7)
    print(sim.n_steps, sim.n_ac, kinetic_energy(sim))
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from sphinxsys_tpu_torch.cases import oscillating_beam_ul_2d as ob
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.materials import WeaklyCompressibleFluid
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.neighbors.cell_list import (CellGrid, CellTable,
                                                    build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import build_neighbor_list
from sphinxsys_tpu_torch.physics import contact as ct
from sphinxsys_tpu_torch.physics import continuum as cn
from sphinxsys_tpu_torch.physics import fluid as fd
from sphinxsys_tpu_torch.physics import riemann as rs
from sphinxsys_tpu_torch.solver import chunk_runner

PL = 0.00391                 # column radius
PW = 0.02346                 # column height
DX_REF = PL / 12.0
SL = 4.0 * DX_REF            # holder thickness
RHO0 = 2700.0
POISSON = 0.3
YOUNGS = 78.2e9
YIELD = 0.29e9
VEL0 = 373.0
C0 = math.sqrt(YOUNGS / (3.0 * (1.0 - 2.0 * POISSON) * RHO0))


@dataclasses.dataclass
class SimState:
    """The column, the time (0-d tensor), the advection and acoustic step
    counts, the overflow flag."""

    column: dict
    time: torch.Tensor
    n_steps: int
    overflow: torch.Tensor
    n_ac: int = 0


@dataclasses.dataclass(frozen=True)
class TaylorBarCase:
    dx: float
    adaptation: SPHAdaptation
    grid: CellGrid
    material: cn.J2Plasticity
    eos: WeaklyCompressibleFluid
    riemann_p: Any
    riemann_rho: Any
    wall: Any
    wall_table: CellTable
    n: int
    cell_cap: int
    k_inner: int
    k_wall: int

    @property
    def kernel(self):
        return self.adaptation.kernel

    @property
    def dim(self) -> int:
        return self.adaptation.dim


def build_case(dx: float = DX_REF, dtype=PRODUCTION_DTYPE, cell_cap: int = 40,
               k_inner: int = 96, k_wall: int = 40, device="cuda"):
    """The column's lattice (axis z, z in [dx, PW + dx]) moving at -VEL0
    in z, with its hardening factor and penalty factor registered; the
    holder brick x, y in [-3 PL, 3 PL], z in [-SL, 0], static, each
    particle's normal that of its nearest face.  Returns (case, column)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    adaptation = SPHAdaptation(spacing=dx, dim=3)
    material = cn.J2Plasticity(rho0=RHO0, c0=C0, youngs_modulus=YOUNGS,
                               poisson_ratio=POISSON, yield_stress=YIELD)
    eos = WeaklyCompressibleFluid(rho0=RHO0, c0=C0)

    xs = np.arange(-PL + dx / 2, PL, dx)
    zs = np.arange(dx + dx / 2, PW + dx, dx)
    gx, gy, gz = np.meshgrid(xs, xs, zs, indexing="ij")
    pos = np.stack([gx, gy, gz], -1).reshape(-1, 3)
    pos = pos[np.hypot(pos[:, 0], pos[:, 1]) < PL]
    n = len(pos)

    column = cn.make_ul_solid_state(pos, dx ** 3, material, dtype, device)
    column["InitialPosition"] = column["Position"]
    column["HardeningFactor"] = torch.zeros(n, dtype=dtype, device=device)
    column["ScalePenaltyForce"] = torch.zeros(n, dtype=dtype, device=device)
    vel = np.zeros_like(pos)
    vel[:, 2] = -VEL0
    column["Velocity"] = torch.as_tensor(vel, dtype=dtype, device=device)

    xw = np.arange(-3 * PL + dx / 2, 3 * PL, dx)
    zw = np.arange(-SL + dx / 2, 0.0, dx)
    gx, gy, gz = np.meshgrid(xw, xw, zw, indexing="ij")
    pw = np.stack([gx, gy, gz], -1).reshape(-1, 3)
    d_top = -pw[:, 2]
    d_side = 3 * PL - np.maximum(np.abs(pw[:, 0]), np.abs(pw[:, 1]))
    nrm = np.zeros_like(pw)
    side = d_side < d_top
    nrm[~side, 2] = 1.0
    sx = np.abs(pw[:, 0]) >= np.abs(pw[:, 1])
    nrm[side & sx, 0] = np.sign(pw[side & sx, 0])
    nrm[side & ~sx, 1] = np.sign(pw[side & ~sx, 1])

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    wall = {"Position": t(pw), "Velocity": t(np.zeros_like(pw)),
            "VolumetricMeasure": t(np.full(len(pw), dx ** 3)),
            "NReal": len(pw), "NormalDirection": t(nrm)}
    grid = grid_from_bounds((-4.0 * PL, -4.0 * PL, -SL - 2 * dx),
                            (4.0 * PL, 4.0 * PL, 1.2 * PW), adaptation.cutoff)
    case = TaylorBarCase(
        dx=dx, adaptation=adaptation, grid=grid, material=material, eos=eos,
        riemann_p=rs.no_riemann(eos), riemann_rho=rs.dissipative_riemann(eos),
        wall=wall, wall_table=build_cell_table(wall["Position"], len(pw),
                                               grid, cell_cap),
        n=n, cell_cap=cell_cap, k_inner=k_inner, k_wall=k_wall)
    return case, column


def build_case_ci(dx: float = PL / 6.0, **kw):
    """The coarse width of the JAX package's test (~6.7k particles with
    the holder)."""
    return build_case(dx=dx, **kw)


def init_sim(case: TaylorBarCase, column: dict) -> SimState:
    pos = column["Position"]
    return SimState(column=dict(column),
                    time=torch.zeros((), dtype=pos.dtype, device=pos.device),
                    n_steps=0, overflow=torch.zeros((), dtype=torch.bool,
                                                    device=pos.device))


def wall_relation(case: TaylorBarCase, col: dict):
    """The column -> holder list."""
    return build_neighbor_list(col["Position"], col["NReal"],
                               case.wall["Position"], case.wall["NReal"],
                               case.wall_table, case.grid,
                               case.adaptation.cutoff, k_max=case.k_wall,
                               include_self=True)


def acoustic_substep(case: TaylorBarCase, col: dict, nl, nl_cw, dt):
    """The contact force, then `ul_substep` with the J2 shear stress."""
    col = ct.dynamic_contact_force_with_wall(col, case.wall, nl_cw,
                                             case.kernel, 3, case.material,
                                             spacing_solid=case.dx,
                                             spacing_wall=case.dx)
    return ob.ul_substep(case, col, nl, dt, plasticity=case.material)


def _advection_step(case: TaylorBarCase, s: SimState) -> SimState:
    col, nl = ob.ul_prep(case, s.column)
    nl_cw = wall_relation(case, col)
    adv_dt = fd.advection_time_step(col, case.adaptation.h, VEL0, cfl=0.2)
    t_rel = torch.zeros_like(adv_dt)
    n_ac = 0
    while bool(t_rel < adv_dt):            # one host read per sub-step
        dt = torch.minimum(fd.acoustic_time_step(col, case.eos,
                                                 case.adaptation.h, cfl=0.4),
                           adv_dt - t_rel)
        col = acoustic_substep(case, col, nl, nl_cw, dt)
        t_rel = t_rel + dt
        n_ac += 1
    return SimState(column=col, time=s.time + t_rel, n_steps=s.n_steps + 1,
                    overflow=s.overflow | nl.overflow | nl_cw.overflow,
                    n_ac=s.n_ac + n_ac)


def make_advection_step(case: TaylorBarCase):
    return lambda s: _advection_step(case, s)


def make_run_chunk(case: TaylorBarCase):
    """run_chunk(sim, t_target): advection steps until sim.time >=
    t_target."""
    return chunk_runner(make_advection_step(case))


def kinetic_energy(s: SimState) -> float:
    """Column_TotalKineticEnergy (general_reduce.h TotalKineticEnergy)."""
    return ob.kinetic_energy_of(s.column)


def mushroom_radius(case: TaylorBarCase, s: SimState) -> float:
    """The largest radial extent of the bottom layers (the mushroom)."""
    pos = s.column["Position"]
    near_base = pos[:, 2] < 2.5 * case.dx + 0.05 * PW
    r = torch.hypot(pos[:, 0], pos[:, 1])
    return float(torch.max(torch.where(near_base, r, torch.zeros_like(r))))
