"""Double Mach reflection of a Mach-10 shock, compressible FVM, HLLC
(counterpart of sphinxsys_tpu/cases/double_mach_reflection_2d.py;
reference tests/2d_examples/test_2d_FVM_double_mach_reflection/
2d_FVM_double_mach_reflection.{h,cpp}): the domain [0, 4] x [0, 1],
gamma = 1.4, a Mach-10 shock inclined 60 degrees from x = 1/6 on the
floor; pre-shock (rho, u, v, p) = (1.4, 0, 0, 1), post-shock
(8, 8.25 sin60, -8.25 cos60, 140.2/1.2) (h:23-30).  The boundaries
(DMFBoundaryConditionSetup, h:104-180):
  left           the post-shock inflow
  right          zero-gradient outflow
  bottom x<1/6   the post-shock inflow;  bottom x>=1/6  a reflective wall
  top            the exact travelling shock: post-shock where
                 y > tan60 (x - x_s(t)), x_s = 1/6 + 10 t / sin60
to end_time = 0.2 (cpp:64), on a structured quad strip with MUSCL
(second order) by default.

The top boundary reads the device time `t` inside the step; a step reads
nothing back, and the chunk loop reads the time once a step.

    case, fluid = build_case(nx=48, ny=12, device="cpu")
    sim = make_run_chunk(case)(init_sim(case, fluid), 0.01)
    print(sim.n_steps, wall_shock_position(case, sim))
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sphinxsys_tpu_torch.core.materials import CompressibleFluid
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.fvm import dynamics as fv
from sphinxsys_tpu_torch.fvm.mesh import FVMesh, compile_mesh
from sphinxsys_tpu_torch.fvm.meshgen import rect_grid
from sphinxsys_tpu_torch.solver import chunk_runner

DL, DH = 4.0, 1.0
GAMMA = 1.4
RHO_PRE, P_PRE = 1.4, 1.0
RHO_POST = 8.0
U_POST = 8.25 * math.sin(math.pi / 3.0)
V_POST = -8.25 * math.cos(math.pi / 3.0)
P_POST = 140.2 / 1.2
X0 = 1.0 / 6.0
TAN60 = math.tan(math.pi / 3.0)
SHOCK_SPEED_X = 10.0 / math.sin(math.pi / 3.0)
E_PRE = P_PRE / (GAMMA - 1.0)
E_POST = P_POST / (GAMMA - 1.0) + 0.5 * RHO_POST * (U_POST ** 2 + V_POST ** 2)
CFL = 0.25


@dataclasses.dataclass
class SimState:
    fluid: dict
    time: torch.Tensor
    n_steps: int


@dataclasses.dataclass(frozen=True)
class DMRCase:
    dm: fv.DeviceMesh
    gas: CompressibleFluid
    mesh: FVMesh
    muscl: bool


def _ghosts(l, r, dm: fv.DeviceMesh, t):
    """DMFBoundaryConditionSetup: each boundary face's ghost state, chosen
    by its midpoint (the mesh tags every boundary alike)."""
    rho_l, vel_l, p_l, E_l = l
    x, y = dm.midpoint[:, 0], dm.midpoint[:, 1]
    b = ~dm.interior
    eps = 1e-6
    post_vel = torch.as_tensor([U_POST, V_POST], dtype=vel_l.dtype,
                               device=vel_l.device)

    def set_state(sel, rho_v, vel_v, p_v, E_v, cur):
        rho_c, vel_c, p_c, E_c = cur
        return (torch.where(sel, rho_v, rho_c),
                torch.where(sel[:, None], vel_v, vel_c),
                torch.where(sel, p_v, p_c),
                torch.where(sel, E_v, E_c))

    cur = r
    # left, and the bottom left of 1/6: the post-shock inflow
    inflow = b & ((x < eps) | ((y < eps) & (x < X0)))
    cur = set_state(inflow, RHO_POST, post_vel[None, :], P_POST, E_POST, cur)
    # right: the outflow copy
    out = b & (x > DL - eps)
    cur = set_state(out, rho_l, vel_l, p_l, E_l, cur)
    # the bottom from 1/6: a reflective wall (the normal velocity mirrored)
    wall = b & (y < eps) & (x >= X0)
    vn = torch.sum(vel_l * dm.normal, dim=-1, keepdim=True)
    cur = set_state(wall, rho_l, vel_l - 2.0 * vn * dm.normal, p_l, E_l, cur)
    # top: the exact travelling shock
    top = b & (y > DH - eps)
    x_s = X0 + t * SHOCK_SPEED_X
    post_side = y > TAN60 * (x - x_s)
    cur = set_state(top & post_side, RHO_POST, post_vel[None, :], P_POST,
                    E_POST, cur)
    cur = set_state(top & ~post_side, RHO_PRE, torch.zeros_like(vel_l),
                    P_PRE, E_PRE, cur)
    return cur


def build_case(nx: int = 480, ny: int = 120, dtype=PRODUCTION_DTYPE,
               muscl: bool = True, device="cuda"):
    """The nx x ny strip and the post-shock state above the inclined front
    (h:62-99).  Returns (case, fluid)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    mesh = compile_mesh(rect_grid(nx, ny, DL, DH, btype_x=9, btype_y=9))
    dm = fv.to_device(mesh, dtype, device)
    case = DMRCase(dm=dm, gas=CompressibleFluid(gamma=GAMMA), mesh=mesh,
                   muscl=muscl)
    c = mesh.centroids
    post = c[:, 1] > TAN60 * (c[:, 0] - X0)
    rho = np.where(post, RHO_POST, RHO_PRE)
    p = np.where(post, P_POST, P_PRE)
    vel = np.where(post[:, None], np.asarray([U_POST, V_POST]), 0.0)
    E = p / (GAMMA - 1.0) + 0.5 * rho * np.sum(vel ** 2, -1)
    fluid = {k: torch.as_tensor(v, dtype=dtype, device=device)
             for k, v in (("Density", rho), ("Velocity", vel),
                          ("Pressure", p), ("TotalEnergyDensity", E))}
    return case, fluid


def init_sim(case: DMRCase, fluid: dict) -> SimState:
    rho = fluid["Density"]
    return SimState(fluid=dict(fluid),
                    time=torch.zeros((), dtype=rho.dtype, device=rho.device),
                    n_steps=0)


# the far field the ghost override replaces (compressible_step's default
# ghosts are computed, then overridden on every boundary face)
FAR = fv.FarField(rho=RHO_PRE, vel=(0.0, 0.0), p=P_PRE)


def make_advection_step(case: DMRCase):
    step_fn = fv.compressible_step_muscl if case.muscl else \
        fv.compressible_step

    def step(s: SimState) -> SimState:
        dt = fv.compressible_time_step_fvm(s.fluid, case.gas, case.dm,
                                           cfl=CFL)
        f = step_fn(s.fluid, case.dm, case.gas, FAR, dt,
                    ghost_override=_ghosts, t=s.time)
        return SimState(fluid=f, time=s.time + dt, n_steps=s.n_steps + 1)

    return step


def make_run_chunk(case: DMRCase):
    """run_chunk(sim, t_target): steps until sim.time >= t_target."""
    return chunk_runner(make_advection_step(case))


def wall_shock_position(case: DMRCase, s: SimState) -> float:
    """x where the density last stands above 2x pre-shock along the bottom
    row of cells (the Mach stem's foot)."""
    c = case.mesh.centroids
    bottom = c[:, 1] < c[:, 1].min() * 1.5 + 1e-12   # the first cell row
    x = c[bottom, 0]
    rho = s.fluid["Density"].detach().cpu().numpy()[bottom]
    order = np.argsort(x)
    x, rho = x[order], rho[order]
    above = rho > 2.0 * RHO_PRE
    if not above.any():
        return 0.0
    return float(x[np.nonzero(above)[0][-1]])


def cells_as_body(case: DMRCase, s: SimState) -> dict:
    like = s.fluid["Density"]
    return {"Position": case.dm.centroids.to(like.dtype), "Density": like,
            "Velocity": s.fluid["Velocity"],
            "Pressure": s.fluid["Pressure"], "NReal": case.dm.n_cells}
