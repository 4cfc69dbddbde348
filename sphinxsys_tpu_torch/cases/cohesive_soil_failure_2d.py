"""2D cohesive soil failure, Drucker-Prager with cohesion (counterpart of
sphinxsys_tpu/cases/cohesive_soil_failure_2d.py; reference tests/
2d_examples/test_2d_cohesive_soil_failure/cohesive_soil_failure.{h,cpp}):
a 4 x 2 m soil column (rho0 = 1850, E = 1.8e6, nu = 0.3, friction 25
degrees, cohesion 5 kPa) in a 5 x 2.5 m tank slumps under gravity and
arrests with most of the column standing.  Its initial potential energy is
rho0 LL LH g LH / 2 = 145040 J.

The loop is column_collapse_2d's (`soil_advection_step`) from a geostatic
initial stress, with a longer advection prep: the free-surface density
summation, the surface indication against the wall, and the
transport-velocity correction over all particles with the surface
projection (cohesive_soil_failure.cpp:44-65).

    case, soil = build_case(dx=LL / 20, device="cpu")
    sim = make_run_chunk(case)(init_sim(case, soil), 0.05)
"""

from __future__ import annotations

import math

import torch

from sphinxsys_tpu_torch.cases import column_collapse_2d as cc
# the column's sim and init_sim, the case's own through this module
from sphinxsys_tpu_torch.cases.column_collapse_2d import (SimState, SoilCase,
                                                          init_sim)
from sphinxsys_tpu_torch.core import geometry as G
from sphinxsys_tpu_torch.device import PRODUCTION_DTYPE
from sphinxsys_tpu_torch.physics import continuum as cm
from sphinxsys_tpu_torch.physics import fluid as fd
from sphinxsys_tpu_torch.physics import general as gd
from sphinxsys_tpu_torch.solver import chunk_runner

DL, DH = 5.0, 2.5
LL, LH = 4.0, 2.0
RHO0_S = 1850.0
GRAVITY_G = 9.8
YOUNGS = 1.8e6
POISSON = 0.3
C_S = math.sqrt(YOUNGS / (RHO0_S * 3.0 * (1.0 - 2.0 * POISSON)))
FRICTION = 25.0 * math.pi / 180.0
COHESION = 5.0e3
U_REF = math.sqrt(2.0 * GRAVITY_G * LH)


def build_case(dx: float | None = None, dtype=PRODUCTION_DTYPE,
               cell_cap: int = 24, k_inner: int = 64, k_wall: int = 40,
               device="cuda"):
    """The column (dx = LL / 50 by default) under its geostatic stress, the
    surface indication's fields (Indicator 0, PreviousSurfaceIndicator 1,
    PositionDivergence 0) and the tank wall.  Returns (case, soil)."""
    dx = dx or LL / 50.0
    bw = 4 * dx
    column = G.Box(G.Transform(translation=(LL / 2, LH / 2)),
                   halfsize=(LL / 2, LH / 2))
    outer = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                  halfsize=(DL / 2 + bw, DH / 2 + bw))
    inner = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                  halfsize=(DL / 2, DH / 2))
    material = cm.PlasticContinuum(rho0=RHO0_S, c0=C_S, youngs_modulus=YOUNGS,
                                   poisson_ratio=POISSON,
                                   friction_angle=FRICTION, cohesion=COHESION)
    case, soil = cc.build_soil_case(
        dx, column, G.make_complex(("add", outer), ("sub", inner)),
        (-bw, -bw), (DL + bw, DH + bw), material,
        gd.Gravity(acceleration=(0.0, -GRAVITY_G)), U_REF, dtype, device,
        cell_cap, k_inner, k_wall, initial_stress=True)
    n, pos = case.n_soil, soil["Position"]
    soil["Indicator"] = torch.zeros(n, dtype=torch.int32, device=pos.device)
    soil["PreviousSurfaceIndicator"] = torch.ones(n, dtype=torch.int32,
                                                  device=pos.device)
    soil["PositionDivergence"] = torch.zeros(n, dtype=pos.dtype,
                                             device=pos.device)
    return case, soil


def advection_prep(case: SoilCase, s: SimState) -> dict:
    """The density summation, the surface indication (wall as contact),
    then TransportVelocityCorrectionComplex<AllParticles> with the
    truncated-linear limiter and the surface projection (cpp:53)."""
    kernel, h = case.kernel, case.adaptation.h
    soil = cc.advection_prep(case, s)
    soil = fd.free_surface_indication(
        soil, s.nl_inner, kernel, 2,
        contacts=[(case.wall, s.nl_wall, RHO0_S)])
    return fd.transport_velocity_correction(
        soil, s.nl_inner, kernel, 2, h, limiter_slope=100.0,
        wall=case.wall, nl_wall=s.nl_wall, surface_projection=True)


def make_advection_step(case: SoilCase):
    return lambda s: cc.soil_advection_step(case, s, advection_prep)


def make_run_chunk(case: SoilCase):
    """run_chunk(sim, t_target): advection steps until sim.time >=
    t_target."""
    return chunk_runner(make_advection_step(case))
