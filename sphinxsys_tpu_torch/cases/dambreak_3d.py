"""3D dambreak (counterpart of sphinxsys_tpu/cases/dambreak_3d.py; reference
tests/3d_examples/test_3d_dambreak/dambreak.cpp): tank 5.366 x 2 x 0.5,
water column 2 x 1 x 0.5, the 2D case's materials and loop.  The gather
route (`init_sim`, `make_run_chunk`) is the 2D case's, with no Morton
resort, as in the JAX package; its capacities default to a 3D lattice's
needs: 80 neighbours within the 2.6 dx cutoff, up to 27 sites a cell."""

from __future__ import annotations

import math

from sphinxsys_tpu_torch.cases.dambreak_2d import (  # noqa: F401
    SimState, acoustic_substep, build_tank_case, init_sim, make_advection_step,
    make_run_chunk, rebuild_relations,
)
from sphinxsys_tpu_torch.device import PRODUCTION_DTYPE, resolve_device
from sphinxsys_tpu_torch.physics import general as gd

DL, DH, DW = 5.366, 2.0, 0.5
LL, LH, LW = 2.0, 1.0, 0.5
RHO0_F = 1.0
GRAVITY_G = 1.0
U_REF = 2.0 * math.sqrt(GRAVITY_G * LH)
C_F = 10.0 * U_REF


def build_case(dx: float = 0.05, dtype=PRODUCTION_DTYPE, device="cuda",
               cell_cap: int = 40, k_inner: int = 128, k_wall: int = 80):
    """The scene and the wall's cell table.  Returns (case, fluid state)."""
    return build_tank_case(dx, 3, (DL, DH, DW), (LL, LH, LW),
                           gd.Gravity(acceleration=(0.0, -GRAVITY_G, 0.0)),
                           dtype, resolve_device(device), cell_cap, k_inner,
                           k_wall, sort_every=0)


def build_block_case(dx: float = 0.05, dtype=PRODUCTION_DTYPE, device="cuda",
                     cap: int = 40, c_max: int | None = None,
                     use_kernels: bool = True):
    """The scene on the cell-block engine.  A 2.6dx cell holds up to 27
    lattice particles at t = 0 and the surge front clusters past 32, hence
    the default cap of 40; the bench runs cap 32 at dx = 0.01."""
    from sphinxsys_tpu_torch.engine import scene as sc

    base, fluid = build_case(dx=dx, dtype=dtype, device=device)
    scene = sc.standard_scene(
        base, rho0=RHO0_F, speed_ref=U_REF, device=device, dim=3,
        wall=base.wall, cap=cap, c_max=c_max,
        c_max_multiple=128, use_kernels=use_kernels)
    return scene, fluid
