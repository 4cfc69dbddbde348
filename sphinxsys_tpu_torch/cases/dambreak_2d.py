"""2D dambreak — the canonical WCSPH free-surface case (counterpart of
sphinxsys_tpu/cases/dambreak_2d.py; reference
tests/2d_examples/test_2d_dambreak/Dambreak.cpp):
  * water column 2 x 1 in a 5.366 x 5.366 tank, wall 4*dx thick;
  * rho0 = 1, g = 1, U_ref = 2 sqrt(g LH), c = 10 U_ref;
  * dual-criteria stepping on the cell-block engine (engine/scene.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

from sphinxsys_tpu_torch.core import geometry as G
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.generators import generate_lattice
from sphinxsys_tpu_torch.core.materials import WeaklyCompressibleFluid
from sphinxsys_tpu_torch.core.state import make_fluid_state, make_solid_state
from sphinxsys_tpu_torch.device import PRODUCTION_DTYPE, resolve_device
from sphinxsys_tpu_torch.neighbors.cell_list import CellGrid, grid_from_bounds
from sphinxsys_tpu_torch.physics import general as gd
from sphinxsys_tpu_torch.physics import riemann as rs

DL = 5.366
DH = 5.366
LL = 2.0
LH = 1.0
RHO0_F = 1.0
GRAVITY_G = 1.0
U_REF = 2.0 * math.sqrt(GRAVITY_G * LH)
C_F = 10.0 * U_REF


@dataclasses.dataclass(frozen=True)
class DambreakCase:
    dx: float
    dim: int
    adaptation: SPHAdaptation
    grid: CellGrid
    eos: WeaklyCompressibleFluid
    riemann: rs.AcousticRiemannSolver
    gravity: gd.Gravity
    wall: Any
    n_fluid: int
    n_wall: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_tank_case(dx: float, dim: int, tank, water, gravity, dtype, device):
    """Scene of a water block in a walled tank (shared by the 2D and 3D
    dambreaks).  `tank` and `water` are the inner tank and water extents
    from the origin.  Returns (case, fluid state)."""
    bw = 4 * dx
    adaptation = SPHAdaptation(spacing=dx, dim=dim)
    half = lambda ext: tuple(e / 2 for e in ext)
    water_shape = G.Box(G.Transform(translation=half(water)), halfsize=half(water))
    outer = G.Box(G.Transform(translation=half(tank)),
                  halfsize=tuple(e / 2 + bw for e in tank))
    inner = G.Box(G.Transform(translation=half(tank)), halfsize=half(tank))
    wall_shape = G.make_complex(("add", outer), ("sub", inner))

    dom_lo = (-bw,) * dim
    dom_hi = tuple(e + bw for e in tank)
    pos_f, vol = generate_lattice(water_shape, dom_lo, dom_hi, dx)
    pos_w, _ = generate_lattice(wall_shape, dom_lo, dom_hi, dx)

    fluid = make_fluid_state(pos_f, vol, RHO0_F, dtype=dtype, device=device)
    wall = make_solid_state(pos_w, vol, RHO0_F, dtype=dtype, device=device)
    wall = gd.normal_direction_from_shape(wall, wall_shape)
    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    fluid = gd.gravity_force(fluid, gravity)
    case = DambreakCase(
        dx=dx, dim=dim, adaptation=adaptation,
        grid=grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff), eos=eos,
        riemann=rs.acoustic_riemann(eos), gravity=gravity, wall=wall,
        n_fluid=len(pos_f), n_wall=len(pos_w))
    return case, fluid


def build_case(dx: float = 0.025, dtype=PRODUCTION_DTYPE, device="cuda"):
    """The scene (no neighbour structures).  Returns (case, fluid state)."""
    return build_tank_case(dx, 2, (DL, DH), (LL, LH),
                           gd.Gravity(acceleration=(0.0, -GRAVITY_G)), dtype,
                           resolve_device(device))


def build_block_case(dx: float = 0.025, dtype=PRODUCTION_DTYPE, device="cuda",
                     cap: int = 12, c_max: int | None = None,
                     use_kernels: bool = True):
    """The scene on the cell-block engine.  Returns (BlockScene, fluid)."""
    from sphinxsys_tpu_torch.engine import scene as sc

    base, fluid = build_case(dx=dx, dtype=dtype, device=device)
    scene = sc.standard_scene(
        base, rho0=RHO0_F, speed_ref=U_REF, device=device, dim=2,
        wall=base.wall, cap=cap, c_max=c_max,
        c_max_multiple=256, use_kernels=use_kernels)
    return scene, fluid
