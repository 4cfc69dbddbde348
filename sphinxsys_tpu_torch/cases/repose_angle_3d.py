"""3D granular repose angle, a Drucker-Prager soil cylinder collapsing on a
plane (counterpart of sphinxsys_tpu/cases/repose_angle_3d.py; reference
tests/3d_examples/test_3d_repose_angle/repose_angle.cpp): r = 0.1,
h = 0.1, rho0 = 2600, E = 5.98e6, nu = 0.3, friction 30 degrees, in a box
tank; the pile settles at the material's repose angle.  The geostatic
initial stress is column_collapse_2d's `build_soil_case`'s
(repose_angle.cpp:55-72), the loop its `soil_advection_step` with
dim = 3.  The regression quantity is the total mechanical energy
(`mechanical_energy`, gravity referred to y = 0).

    case, soil = build_case(dx=RADIUS / 5, device="cpu")
    sim = make_run_chunk(case)(init_sim(case, soil), 0.005)
"""

from __future__ import annotations

import math

from sphinxsys_tpu_torch.cases import column_collapse_2d as cc
# the column's sim and loop, the case's own through this module (the CLI)
from sphinxsys_tpu_torch.cases.column_collapse_2d import (SimState, SoilCase,
                                                          init_sim,
                                                          make_advection_step,
                                                          make_run_chunk)
from sphinxsys_tpu_torch.core import geometry as G
from sphinxsys_tpu_torch.device import PRODUCTION_DTYPE
from sphinxsys_tpu_torch.physics import continuum as cm
from sphinxsys_tpu_torch.physics import general as gd

RADIUS = 0.1
HEIGHT = 0.1
RHO0_S = 2600.0
GRAVITY_G = 9.8
YOUNGS = 5.98e6
POISSON = 0.3
C_S = math.sqrt(YOUNGS / (RHO0_S * 3.0 * (1.0 - 2.0 * POISSON)))
FRICTION = 30.0 * math.pi / 180.0
DL = 2.0 * RADIUS * (1.0 + 1.24 * HEIGHT / RADIUS) + 0.1
DH = HEIGHT + 0.02
DW = DL
U_REF = math.sqrt(2.0 * GRAVITY_G * HEIGHT)


def build_case(dx: float | None = None, dtype=PRODUCTION_DTYPE,
               cell_cap: int = 40, k_inner: int = 96, k_wall: int = 64,
               device="cuda"):
    """The soil cylinder (dx = RADIUS / 10 by default) at the tank's centre,
    its axis along y, and the box tank 4 dx thick.  Returns (case,
    soil)."""
    dx = dx or RADIUS / 10.0
    bw = 4 * dx
    column = G.Cylinder(center=(DL / 2, HEIGHT / 2, DW / 2),
                        axis=(0.0, 1.0, 0.0), radius=RADIUS,
                        halflength=HEIGHT / 2)
    outer = G.Box(G.Transform(translation=(DL / 2, DH / 2, DW / 2)),
                  halfsize=(DL / 2 + bw, DH / 2 + bw, DW / 2 + bw))
    inner = G.Box(G.Transform(translation=(DL / 2, DH / 2, DW / 2)),
                  halfsize=(DL / 2, DH / 2, DW / 2))
    material = cm.PlasticContinuum(rho0=RHO0_S, c0=C_S, youngs_modulus=YOUNGS,
                                   poisson_ratio=POISSON,
                                   friction_angle=FRICTION)
    return cc.build_soil_case(
        dx, column, G.make_complex(("add", outer), ("sub", inner)),
        (-bw, -bw, -bw), (DL + bw, DH + bw, DW + bw), material,
        gd.Gravity(acceleration=(0.0, -GRAVITY_G, 0.0)), U_REF, dtype,
        device, cell_cap, k_inner, k_wall, initial_stress=True)


def mechanical_energy(case: SoilCase, s: SimState) -> float:
    """GranularBody_TotalMechanicalEnergy: kinetic plus m g y over the
    soil, summed in float64 on the host (as JAX's numpy sum)."""
    n = case.n_soil
    soil = s.soil
    m = soil["Mass"][:n].double().cpu()
    v = soil["Velocity"][:n].double().cpu()
    y = soil["Position"][:n, 1].double().cpu()
    return float((0.5 * m * (v * v).sum(1) + m * GRAVITY_G * y).sum())
