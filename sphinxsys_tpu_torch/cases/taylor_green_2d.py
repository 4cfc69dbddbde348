"""2D Taylor–Green vortex — doubly periodic viscous flow (counterpart of
sphinxsys_tpu/cases/taylor_green_2d.py; reference
tests/2d_examples/test_2d_taylor_green/taylor_green.cpp):
  * unit box, doubly periodic, dx = 1/100 by default;
  * rho0 = 1, U = 1, c = 10, Re = 100 -> mu = 0.01;
  * initial velocity u = -cos(2 pi x) sin(2 pi y), v = sin(2 pi x) cos(2 pi y);
  * advection step: viscous-aware dt, density summation (with the volume
    update), viscous force, transport-velocity correction (limiter slope
    100); acoustic loop: 1st half with the acoustic Riemann solver, 2nd
    half with none, dt = min(dt_acoustic, dt_advection);
  * analytic decay: |v| ~ exp(-8 pi^2 nu t), kinetic energy
    ~ exp(-16 pi^2 nu t) — the physics oracle.

Periodicity has no ghost particles: cell windows wrap modulo the grid and
pair displacements take the minimum image.  Only the cell-block engine is
ported; the relaxed initial lattice (`relax_ic`) waits for the port of
physics/relax.py.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sphinxsys_tpu_torch.core import geometry as G
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.generators import generate_lattice
from sphinxsys_tpu_torch.core.materials import WeaklyCompressibleFluid
from sphinxsys_tpu_torch.core.state import make_fluid_state
from sphinxsys_tpu_torch.device import PRODUCTION_DTYPE, resolve_device
from sphinxsys_tpu_torch.neighbors.cell_list import CellGrid, grid_from_bounds
from sphinxsys_tpu_torch.physics import riemann as rs

DL = 1.0
DH = 1.0
RHO0_F = 1.0
U_F = 1.0
C_F = 10.0 * U_F
RE = 100.0
MU_F = RHO0_F * U_F * DL / RE


@dataclasses.dataclass(frozen=True)
class TaylorGreenCase:
    dx: float
    adaptation: SPHAdaptation
    grid: CellGrid
    eos: WeaklyCompressibleFluid
    riemann: rs.AcousticRiemannSolver
    no_riemann: rs.NoRiemannSolver
    n_fluid: int

    @property
    def kernel(self):
        return self.adaptation.kernel

    @property
    def box(self):
        return self.grid.periodic_lengths


def build_case(dx: float = 0.01, dtype=PRODUCTION_DTYPE, device="cuda",
               relax_ic: int = 0):
    """The scene and the fluid state, with the analytic initial velocity
    evaluated in float64 on the lattice, then cast.  `relax_ic` > 0 (a
    relaxed initial lattice) is not ported and raises."""
    device = resolve_device(device)
    if relax_ic > 0:
        raise NotImplementedError("relax_ic needs physics/relax.py, which is "
                                  "not ported yet")
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    shape = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                  halfsize=(DL / 2, DH / 2))
    pos, vol = generate_lattice(shape, (0.0, 0.0), (DL, DH), dx)
    grid = grid_from_bounds((0.0, 0.0), (DL, DH), adaptation.cutoff,
                            periodic=(True, True))
    fluid = make_fluid_state(pos, vol, RHO0_F, dtype=dtype, device=device)
    vel = np.stack([
        -np.cos(2 * math.pi * pos[:, 0]) * np.sin(2 * math.pi * pos[:, 1]),
        np.sin(2 * math.pi * pos[:, 0]) * np.cos(2 * math.pi * pos[:, 1]),
    ], axis=-1)
    fluid["Velocity"] = torch.as_tensor(vel, dtype=dtype, device=device)
    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    case = TaylorGreenCase(dx=dx, adaptation=adaptation, grid=grid, eos=eos,
                           riemann=rs.acoustic_riemann(eos),
                           no_riemann=rs.no_riemann(eos), n_fluid=len(pos))
    return case, fluid


def build_block_case(dx: float = 0.01, dtype=PRODUCTION_DTYPE, device="cuda",
                     cap: int = 12, c_max: int | None = None,
                     use_kernels: bool = True):
    """The scene on the cell-block engine.  Every cell of the periodic box
    is occupied, so c_max defaults to the cell count, rounded to 256 as the
    JAX package rounds it."""
    from sphinxsys_tpu_torch.engine import scene as sc

    base, fluid = build_case(dx=dx, dtype=dtype, device=device)
    scene = sc.standard_scene(
        base, rho0=RHO0_F, speed_ref=U_F, device=device, dim=2, mu=MU_F,
        tvc_coef=0.2, tvc_limiter=100.0, free_surface=False,
        riemann2=base.no_riemann, cap=cap, c_max=c_max, c_max_multiple=256,
        use_kernels=use_kernels, cap_ac_dt=True)
    return scene, fluid
