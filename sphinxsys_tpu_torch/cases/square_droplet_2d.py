"""2D square droplet rounding under surface tension (counterpart of
sphinxsys_tpu/cases/square_droplet_2d.py; reference tests/2d_examples/
test_2d_square_droplet/2d_square_droplet.cpp): a 1 x 1 water square
(rho0 = 1) in air 1000 times lighter inside a closed 2 x 2 box turns
toward a circle under the stress-form surface tension
(physics/surface_tension.py).  Both phases weakly compressible with
c = 10 U_ref.

The advection step of the three surface-tension cases (this one,
cases/cubic_droplet_3d.py and cases/droplet_impact_2d.py), from the
constants their case carries:

  * the plain density summation of both phases against the other phase
    and the wall;
  * the multi-phase transport-velocity correction of both;
  * the viscous force: inner, the other phase at the pair-harmonic
    viscosity, the wall;
  * in every acoustic sub-step, the surface-tension stress of each phase
    from the other, then the stress force of each (the air's from the
    water's new stress, 2d_square_droplet.cpp:221-227), the acoustic dt
    floored by the capillary wave speed (CFL 0.6), and the two-phase
    sub-step of cases/two_phase_dambreak_2d.py;
  * the advection dt: AdvectionViscousTimeStep at CFL 0.1.

Both phases share the steps, as in the JAX package.

    case, water, air = build_case(dx=0.08, device="cpu")
    sim = make_run_chunk(case)(init_sim(case, water, air), 0.05)
    print(water_max_radius(sim))
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

# SimState, init_sim and rebuild are the two-phase ones, named here too
from sphinxsys_tpu_torch.cases.two_phase_dambreak_2d import (  # noqa: F401
    SimState, acoustic_substep, finish_step, init_sim, phase_solvers,
    rebuild)
from sphinxsys_tpu_torch.core import geometry as G
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.generators import generate_lattice
from sphinxsys_tpu_torch.core.materials import WeaklyCompressibleFluid
from sphinxsys_tpu_torch.core.state import (make_fluid_state, make_solid_state,
                                           nreal_mask)
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.neighbors.cell_list import (CellGrid, CellTable,
                                                    build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.physics import fluid as fd
from sphinxsys_tpu_torch.physics import general as gd
from sphinxsys_tpu_torch.physics import riemann as rs
from sphinxsys_tpu_torch.physics import surface_tension as st
from sphinxsys_tpu_torch.solver import chunk_runner

# 2d_square_droplet.cpp:14-29
DL = 2.0
DH = 2.0
LL = 1.0
LH = 1.0
RHO0_F = 1.0
RHO0_A = 0.001
U_REF = 1.0
C_F = 10.0 * U_REF
MU_F = 5.0e-2
MU_A = 5.0e-4
SIGMA = 1.0
MU_WA = 2.0 * MU_F * MU_A / (MU_F + MU_A)   # pair-harmonic (FixedViscosity)
FRAC_W = st.contact_fraction(RHO0_F, RHO0_A)
FRAC_A = st.contact_fraction(RHO0_A, RHO0_F)


@dataclasses.dataclass(frozen=True)
class Materials:
    """A surface-tension case's constants."""

    rho0_f: float
    rho0_a: float
    u_ref: float
    mu_f: float
    mu_a: float
    sigma: float

    @property
    def mu_wa(self) -> float:
        return 2.0 * self.mu_f * self.mu_a / (self.mu_f + self.mu_a)

    @property
    def frac_w(self) -> float:
        return st.contact_fraction(self.rho0_f, self.rho0_a)

    @property
    def frac_a(self) -> float:
        return st.contact_fraction(self.rho0_a, self.rho0_f)


MATERIALS = Materials(rho0_f=RHO0_F, rho0_a=RHO0_A, u_ref=U_REF, mu_f=MU_F,
                      mu_a=MU_A, sigma=SIGMA)


@dataclasses.dataclass(frozen=True)
class DropletCase:
    dx: float
    adaptation: SPHAdaptation
    grid: CellGrid
    mat: Materials
    eos_w: WeaklyCompressibleFluid
    eos_a: WeaklyCompressibleFluid
    rs_w: rs.AcousticRiemannSolver
    rs_a: rs.AcousticRiemannSolver
    rs_wa: rs.AcousticRiemannSolver
    rs_aw: rs.AcousticRiemannSolver
    wall: Any
    wall_table: CellTable
    n_water: int
    n_air: int
    cell_cap: int
    k_inner: int
    k_contact: int

    @property
    def kernel(self):
        return self.adaptation.kernel

    @property
    def dim(self) -> int:
        return self.adaptation.dim


def build_droplet_case(dx: float, dim: int, mat: Materials, droplet,
                       inner, outer, dom_lo, dom_hi, dtype, device,
                       cell_cap: int, k_inner: int, k_contact: int,
                       water_velocity=None):
    """The water inside `droplet`, the air in the rest of `inner`, the
    wall between `inner` and `outer`; the surface-tension and viscous
    fields registered at zero; `water_velocity` the water's initial
    velocity.  Returns (case, water, air)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    adaptation = SPHAdaptation(spacing=dx, dim=dim)
    air_shape = G.make_complex(("add", inner), ("sub", droplet))
    wall_shape = G.make_complex(("add", outer), ("sub", inner))
    pos_w, vol = generate_lattice(droplet, dom_lo, dom_hi, dx)
    pos_a, _ = generate_lattice(air_shape, dom_lo, dom_hi, dx)
    pos_b, _ = generate_lattice(wall_shape, dom_lo, dom_hi, dx)

    water = make_fluid_state(pos_w, vol, mat.rho0_f, dtype, device)
    if water_velocity is not None:
        water["Velocity"][:] = torch.as_tensor(water_velocity, dtype=dtype,
                                               device=device)
    air = make_fluid_state(pos_a, vol, mat.rho0_a, dtype, device)
    for ph in (water, air):
        vec = torch.zeros_like(ph["Position"])
        ph["ColorGradient"] = vec.clone()
        ph["NormDirection"] = vec.clone()
        ph["SurfaceTensionStress"] = torch.zeros(
            (vec.shape[0], dim, dim), dtype=dtype, device=device)
        for k in ("SurfaceTensionForce", "SurfaceTensionForcePrev",
                  "ViscousForce", "ViscousForcePrev"):
            ph[k] = vec.clone()
    wall = make_solid_state(pos_b, vol, mat.rho0_f, dtype, device)
    wall = gd.normal_direction_from_shape(wall, wall_shape)

    grid = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff)
    case = DropletCase(
        dx=dx, adaptation=adaptation, grid=grid, mat=mat,
        **phase_solvers(WeaklyCompressibleFluid(rho0=mat.rho0_f,
                                                c0=10.0 * mat.u_ref),
                        WeaklyCompressibleFluid(rho0=mat.rho0_a,
                                                c0=10.0 * mat.u_ref)),
        wall=wall,
        wall_table=build_cell_table(wall["Position"], wall["NReal"], grid,
                                    cell_cap),
        n_water=len(pos_w), n_air=len(pos_a), cell_cap=cell_cap,
        k_inner=k_inner, k_contact=k_contact)
    return case, water, air


def centred_box(dim: int, half: float):
    return G.Box(G.Transform(translation=(0.0,) * dim), halfsize=(half,) * dim)


def build_case(dx: float = DL / 50.0, dtype=PRODUCTION_DTYPE,
               cell_cap: int = 24, k_inner: int = 48, k_contact: int = 32,
               device="cuda"):
    """The boxes centred at the origin (2d_square_droplet.cpp:33-42).
    Returns (case, water, air)."""
    bw = 4 * dx
    return build_droplet_case(
        dx, 2, MATERIALS, centred_box(2, LL / 2), centred_box(2, DL / 2),
        centred_box(2, DL / 2 + bw), (-DL / 2 - bw,) * 2, (DL / 2 + bw,) * 2,
        dtype, device, cell_cap, k_inner, k_contact)


def advection_prep(case: DropletCase, s: SimState):
    """Both summations, both transport corrections, both viscous forces.
    Returns (water, air)."""
    kernel, dim, h = case.kernel, case.dim, case.adaptation.h
    sigma0, mat, wall = case.adaptation.sigma0, case.mat, case.wall
    water = fd.density_summation(
        s.water, s.nl_ww, kernel, dim, mat.rho0_f, sigma0,
        contacts=[(s.air, s.nl_wa, mat.rho0_a), (wall, s.nl_wb, mat.rho0_f)],
        free_surface=False)
    air = fd.density_summation(
        s.air, s.nl_aa, kernel, dim, mat.rho0_a, sigma0,
        contacts=[(water, s.nl_aw, mat.rho0_f), (wall, s.nl_ab, mat.rho0_f)],
        free_surface=False)
    water = fd.transport_velocity_correction(
        water, s.nl_ww, kernel, dim, h,
        walls=[(air, s.nl_wa), (wall, s.nl_wb)])
    air = fd.transport_velocity_correction(
        air, s.nl_aa, kernel, dim, h,
        walls=[(water, s.nl_aw), (wall, s.nl_ab)])
    water = fd.viscous_force(water, s.nl_ww, kernel, dim, mat.mu_f, h,
                             walls=[(wall, s.nl_wb)],
                             contacts=[(air, s.nl_wa, mat.mu_wa)])
    air = fd.viscous_force(air, s.nl_aa, kernel, dim, mat.mu_a, h,
                           walls=[(wall, s.nl_ab)],
                           contacts=[(water, s.nl_aw, mat.mu_wa)])
    return water, air


def surface_tension(case: DropletCase, s: SimState, w: dict, a: dict):
    """Each phase's stress from the other, then each one's stress force
    (the air's reads the water's new stress).  Returns (water, air)."""
    kernel, dim, mat = case.kernel, case.dim, case.mat
    w = st.surface_tension_stress(w, [(a, s.nl_wa, mat.frac_w)], kernel, dim,
                                  mat.sigma)
    a = st.surface_tension_stress(a, [(w, s.nl_aw, mat.frac_a)], kernel, dim,
                                  mat.sigma)
    w = st.surface_stress_force(w, s.nl_ww, [(a, s.nl_wa, mat.frac_w)],
                                kernel, dim, mat.sigma)
    a = st.surface_stress_force(a, s.nl_aa, [(w, s.nl_aw, mat.frac_a)],
                                kernel, dim, mat.sigma)
    return w, a


def capillary_dt(case: DropletCase, w: dict, a: dict, dt_adv):
    h, mat = case.adaptation.h, case.mat
    return torch.minimum(torch.minimum(
        st.surface_tension_time_step(w, case.eos_w, h, mat.rho0_f, mat.sigma),
        st.surface_tension_time_step(a, case.eos_a, h, mat.rho0_a,
                                     mat.sigma)), dt_adv)


def _advection_step(case: DropletCase, s: SimState) -> SimState:
    h, mat = case.adaptation.h, case.mat
    dt_adv = torch.minimum(
        fd.advection_viscous_time_step(s.water, h, mat.u_ref, mat.rho0_f,
                                       mat.mu_f, cfl=0.1),
        fd.advection_viscous_time_step(s.air, h, mat.u_ref, mat.rho0_a,
                                       mat.mu_a, cfl=0.1))
    water, air = advection_prep(case, s)
    relax_t = torch.zeros_like(dt_adv)
    n_ac = 0
    while bool(relax_t < dt_adv):          # one host read per sub-step
        water, air = surface_tension(case, s, water, air)
        dt = capillary_dt(case, water, air, dt_adv)
        water, air = acoustic_substep(case, s, water, air, dt)
        relax_t = relax_t + dt
        n_ac += 1
    return finish_step(case, s, water, air, relax_t, n_ac)


def make_advection_step(case: DropletCase):
    return lambda s: _advection_step(case, s)


def make_run_chunk(case: DropletCase):
    """run_chunk(sim, t_target): advection steps until sim.time >=
    t_target."""
    return chunk_runner(lambda s: _advection_step(case, s))


def water_kinetic_energy(s: SimState) -> float:
    """The water's TotalKineticEnergy over its rows below NReal (the
    regression quantity)."""
    w = s.water
    ke = 0.5 * w["Mass"] * torch.sum(w["Velocity"] ** 2, dim=-1)
    return float(torch.sum(torch.where(nreal_mask(w), ke,
                                       torch.zeros_like(ke))))


def water_max_radius(s: SimState) -> float:
    """The largest water distance from the origin: from the square's
    corner ~0.687 toward the equal-area circle's 0.564."""
    w = s.water
    r = torch.linalg.vector_norm(w["Position"], dim=-1)
    return float(torch.max(torch.where(nreal_mask(w), r,
                                       torch.zeros_like(r))))
