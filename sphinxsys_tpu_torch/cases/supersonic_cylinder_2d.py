"""Mach-2 supersonic flow around a cylinder, compressible, HLLC
(counterpart of sphinxsys_tpu/cases/supersonic_cylinder_2d.py; reference
tests/2d_examples/test_2d_eulerian_supersonic_flow_new_BC/
2d_eulerian_supersonic_flow_around_cylinder.{h,cpp}): an ideal gas of
gamma = 1.4, rho_far = 1, p_far = 1/gamma (c = 1), a Mach 2 free stream,
a reflective (slip) cylinder wall and the characteristic far field
(supersonic inflow imposes the free stream, outflow copies), on the FVM
O-grid (fvm/dynamics.py compressible_step).

The oracle is the steady bow shock: the normal-shock and isentropic
stagnation relations at M = 2 give a stagnation density of ~3.1 rho_inf
at the cylinder's nose.  A step reads nothing back; the chunk loop reads
the time once a step.

    case, fluid = build_case(nr=10, nt=24, device="cpu")
    sim = make_run_chunk(case)(init_sim(case, fluid), 0.5)
    print(sim.n_steps, stagnation_state(case, sim))
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sphinxsys_tpu_torch.core.materials import CompressibleFluid
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.fvm import compile_mesh, cylinder_ogrid
from sphinxsys_tpu_torch.fvm import dynamics as fv
from sphinxsys_tpu_torch.fvm.mesh import FVMesh
from sphinxsys_tpu_torch.solver import chunk_runner

GAMMA = 1.4
RHO_FAR = 1.0
P_FAR = 1.0 / GAMMA          # c_far = sqrt(gamma p / rho) = 1
MACH = 2.0
R_CYL = 1.0
R_FAR = 11.0                 # calculation_circle_radius (h:14)


@dataclasses.dataclass
class SimState:
    fluid: dict
    time: torch.Tensor
    n_steps: int


@dataclasses.dataclass(frozen=True)
class SupersonicCase:
    dm: fv.DeviceMesh
    gas: CompressibleFluid
    far: fv.FarField
    mesh: FVMesh


def build_case(nr: int = 40, nt: int = 120, dtype=PRODUCTION_DTYPE,
               device="cuda"):
    """The nr x nt O-grid and the free stream in every cell.  Returns
    (case, fluid)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    mesh = compile_mesh(cylinder_ogrid(r0=R_CYL, r1=R_FAR, nr=nr, nt=nt))
    dm = fv.to_device(mesh, dtype, device)
    gas = CompressibleFluid(gamma=GAMMA)
    far = fv.FarField(rho=RHO_FAR, vel=(MACH * 1.0, 0.0), p=P_FAR)
    case = SupersonicCase(dm=dm, gas=gas, far=far, mesh=mesh)
    return case, fv.make_compressible_fvm_state(dm, gas, RHO_FAR,
                                                (MACH * 1.0, 0.0), P_FAR)


def init_sim(case: SupersonicCase, fluid: dict) -> SimState:
    rho = fluid["Density"]
    return SimState(fluid=dict(fluid),
                    time=torch.zeros((), dtype=rho.dtype, device=rho.device),
                    n_steps=0)


def make_advection_step(case: SupersonicCase):
    def step(s: SimState) -> SimState:
        dt = fv.compressible_time_step_fvm(s.fluid, case.gas, case.dm)
        f = fv.compressible_step(s.fluid, case.dm, case.gas, case.far, dt)
        return SimState(fluid=f, time=s.time + dt, n_steps=s.n_steps + 1)

    return step


def make_run_chunk(case: SupersonicCase):
    """run_chunk(sim, t_target): steps until sim.time >= t_target."""
    return chunk_runner(make_advection_step(case))


def nose_cell(case: SupersonicCase) -> int:
    """The windward nose cell (nearest (-R - 0.05, 0))."""
    c = case.mesh.centroids
    return int(np.argmin(np.linalg.norm(
        c - np.asarray([-R_CYL - 0.05, 0.0]), axis=1)))


def stagnation_state(case: SupersonicCase, s: SimState):
    """(density, pressure) at the nose cell."""
    nose = nose_cell(case)
    return (float(s.fluid["Density"][nose]),
            float(s.fluid["Pressure"][nose]))


def cells_as_body(case: SupersonicCase, s: SimState) -> dict:
    like = s.fluid["Density"]
    return {"Position": case.dm.centroids.to(like.dtype), "Density": like,
            "Velocity": s.fluid["Velocity"],
            "Pressure": s.fluid["Pressure"], "NReal": case.dm.n_cells}
