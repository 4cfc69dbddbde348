"""2D granular column collapse, Drucker-Prager soil (counterpart of
sphinxsys_tpu/cases/column_collapse_2d.py; reference tests/2d_examples/
test_2d_column_collapse/column_collapse.cpp): a 0.2 x 0.1 soil column in
a 0.5 x 0.15 tank, rho0 = 2040, E = 5.84e6, nu = 0.3, friction angle
21.9 degrees, g = 9.8.

The dual-criteria loop: an advection step (CFL 0.25, U_ref = sqrt(2 g LH))
with the free-surface density summation against the wall, around acoustic
sub-steps (CFL 0.4, capped by the advection dt) of stress diffusion and
both plastic halves against the wall; then the lists are rebuilt.  Both
loops are host loops, one host read of each condition.  The soil loop
here (`soil_advection_step`, `acoustic_substep`, `SoilCase`) serves the
cohesive soil and the 3D repose pile too.

    case, soil = build_case(dx=LH / 12, device="cpu")
    sim = make_run_chunk(case)(init_sim(case, soil), 0.01)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from sphinxsys_tpu_torch.core import geometry as G
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.generators import generate_lattice
from sphinxsys_tpu_torch.core.state import make_solid_state
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.neighbors.cell_list import (CellGrid, CellTable,
                                                    build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list)
from sphinxsys_tpu_torch.physics import continuum as cm
from sphinxsys_tpu_torch.physics import fluid as fd
from sphinxsys_tpu_torch.physics import general as gd
from sphinxsys_tpu_torch.physics import riemann as rs
from sphinxsys_tpu_torch.solver import chunk_runner

DL, DH = 0.5, 0.15
LL, LH = 0.2, 0.1
RHO0_S = 2040.0
GRAVITY_G = 9.8
YOUNGS = 5.84e6
POISSON = 0.3
C_S = math.sqrt(YOUNGS / (RHO0_S * 3.0 * (1.0 - 2.0 * POISSON)))
FRICTION = 21.9 * math.pi / 180.0
U_REF = math.sqrt(2.0 * GRAVITY_G * LH)


@dataclasses.dataclass
class SimState:
    """The carry: the soil, its (inner, wall) lists, the time (0-d
    tensor), the advection and acoustic step counts, the overflow flag."""

    soil: dict
    nl_inner: NeighborList
    nl_wall: NeighborList
    time: torch.Tensor
    n_adv: int
    n_ac: int
    overflow: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SoilCase:
    """A soil body in a tank of wall particles (the three soil cases)."""

    dx: float
    adaptation: SPHAdaptation
    grid: CellGrid
    material: cm.PlasticContinuum
    riemann: Any
    gravity: gd.Gravity
    wall: Any
    wall_table: CellTable
    n_soil: int
    n_wall: int
    cell_cap: int
    k_inner: int
    k_wall: int
    u_ref: float

    @property
    def kernel(self):
        return self.adaptation.kernel

    @property
    def dim(self) -> int:
        return self.adaptation.dim


def build_soil_case(dx, column, wall_shape, dom_lo, dom_hi, material,
                    gravity, u_ref, dtype, device, cell_cap, k_inner, k_wall,
                    initial_stress: bool):
    """The soil lattice in `column`, the wall lattice in `wall_shape` with
    its shape normals and cell table, gravity in ForcePrior, and where
    `initial_stress` the geostatic stress (SoilInitialCondition):
    sigma_yy = -rho0 g y, sigma_xx = sigma_zz = (1 - sin phi) sigma_yy
    (the height, not the depth, as the reference's).  Returns (case,
    soil)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    dim = len(dom_lo)
    adaptation = SPHAdaptation(spacing=dx, dim=dim)
    pos_s, vol = generate_lattice(column, dom_lo, dom_hi, dx)
    pos_w, _ = generate_lattice(wall_shape, dom_lo, dom_hi, dx)

    soil = cm.make_continuum_state(pos_s, vol, material, dtype, device)
    soil["DensitySummation"] = soil["Density"]
    if initial_stress:
        g = abs(gravity.acceleration[1])
        syy = -material.rho0 * g * soil["Position"][:, 1]
        lateral = syy * (1.0 - math.sin(material.friction_angle))
        soil["StressTensor3D"] = torch.diag_embed(
            torch.stack([lateral, syy, lateral], dim=-1))
    soil = gd.gravity_force(soil, gravity)

    wall = make_solid_state(pos_w, vol, material.rho0, dtype, device)
    wall = gd.normal_direction_from_shape(wall, wall_shape)
    grid = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff)
    case = SoilCase(
        dx=dx, adaptation=adaptation, grid=grid, material=material,
        riemann=rs.acoustic_riemann(material), gravity=gravity, wall=wall,
        wall_table=build_cell_table(wall["Position"], wall["NReal"], grid,
                                    cell_cap),
        n_soil=len(pos_s), n_wall=len(pos_w), cell_cap=cell_cap,
        k_inner=k_inner, k_wall=k_wall, u_ref=u_ref)
    return case, soil


def build_case(dx: float | None = None, dtype=PRODUCTION_DTYPE,
               cell_cap: int = 24, k_inner: int = 64, k_wall: int = 40,
               device="cuda"):
    """The column (dx = LH / 50 by default) and the tank wall, 4 dx thick.
    Returns (case, soil)."""
    dx = dx or LH / 50.0
    bw = 4 * dx
    column = G.Box(G.Transform(translation=(LL / 2, LH / 2)),
                   halfsize=(LL / 2, LH / 2))
    outer = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                  halfsize=(DL / 2 + bw, DH / 2 + bw))
    inner = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                  halfsize=(DL / 2, DH / 2))
    material = cm.PlasticContinuum(rho0=RHO0_S, c0=C_S, youngs_modulus=YOUNGS,
                                   poisson_ratio=POISSON,
                                   friction_angle=FRICTION)
    return build_soil_case(
        dx, column, G.make_complex(("add", outer), ("sub", inner)),
        (-bw, -bw), (DL + bw, DH + bw), material,
        gd.Gravity(acceleration=(0.0, -GRAVITY_G)), U_REF, dtype, device,
        cell_cap, k_inner, k_wall, initial_stress=False)


def rebuild_relations(case: SoilCase, soil: dict):
    """The soil's cell table and its (inner, wall) lists."""
    pos, n = soil["Position"], soil["NReal"]
    cutoff = case.adaptation.cutoff
    table = build_cell_table(pos, n, case.grid, case.cell_cap)
    nl_inner = build_neighbor_list(pos, n, pos, n, table, case.grid, cutoff,
                                   k_max=case.k_inner, include_self=False)
    nl_wall = build_neighbor_list(pos, n, case.wall["Position"],
                                  case.wall["NReal"], case.wall_table,
                                  case.grid, cutoff, k_max=case.k_wall,
                                  include_self=True)
    return nl_inner, nl_wall


def init_sim(case: SoilCase, soil: dict) -> SimState:
    nl_inner, nl_wall = rebuild_relations(case, soil)
    pos = soil["Position"]
    return SimState(soil=dict(soil), nl_inner=nl_inner, nl_wall=nl_wall,
                    time=torch.zeros((), dtype=pos.dtype, device=pos.device),
                    n_adv=0, n_ac=0,
                    overflow=torch.zeros((), dtype=torch.bool,
                                         device=pos.device))


def advection_prep(case: SoilCase, s: SimState) -> dict:
    """DensitySummationComplexFreeSurface against the wall, once an
    advection step (column_collapse.cpp:102)."""
    rho0 = case.material.rho0
    return fd.density_summation(s.soil, s.nl_inner, case.kernel, case.dim,
                                rho0, case.adaptation.sigma0,
                                contacts=[(case.wall, s.nl_wall, rho0)],
                                free_surface=True)


def acoustic_substep(case: SoilCase, s: SimState, soil: dict, dt_adv):
    """The stress diffusion and both plastic halves against the wall, at
    the acoustic dt (CFL 0.4) capped by the advection dt.  Returns
    (soil, dt)."""
    kernel, dim, h = case.kernel, case.dim, case.adaptation.h
    m = case.material
    dt = torch.minimum(fd.acoustic_time_step(soil, m, h, cfl=0.4), dt_adv)
    wall = dict(wall=case.wall, nl_wall=s.nl_wall)
    soil = cm.stress_diffusion(soil, s.nl_inner, kernel, dim, m, h)
    soil = cm.plastic_integration_1st_half(soil, s.nl_inner, kernel, dim, m,
                                           case.riemann, dt, **wall)
    soil = cm.plastic_integration_2nd_half(soil, s.nl_inner, kernel, dim, m,
                                           case.riemann, dt, **wall)
    return soil, dt


def soil_advection_step(case: SoilCase, s: SimState,
                        prep: Callable = advection_prep) -> SimState:
    """The advection dt, `prep`, the acoustic sub-steps until they span
    it, the lists rebuilt."""
    dt_adv = fd.advection_time_step(s.soil, case.adaptation.h, case.u_ref)
    soil = prep(case, s)
    relax_t = torch.zeros_like(dt_adv)
    n_ac = 0
    while bool(relax_t < dt_adv):          # one host read per sub-step
        soil, dt = acoustic_substep(case, s, soil, dt_adv)
        relax_t = relax_t + dt
        n_ac += 1
    nl_inner, nl_wall = rebuild_relations(case, soil)
    return SimState(soil=soil, nl_inner=nl_inner, nl_wall=nl_wall,
                    time=s.time + relax_t, n_adv=s.n_adv + 1,
                    n_ac=s.n_ac + n_ac,
                    overflow=s.overflow | nl_inner.overflow | nl_wall.overflow)


def make_advection_step(case: SoilCase):
    return lambda s: soil_advection_step(case, s)


def make_run_chunk(case: SoilCase):
    """run_chunk(sim, t_target): advection steps until sim.time >=
    t_target."""
    return chunk_runner(make_advection_step(case))


def runout_front(case: SoilCase, s: SimState) -> float:
    """The run-out front, max x of the soil (the golden's RunoutFront)."""
    return float(s.soil["Position"][:case.n_soil, 0].max())
