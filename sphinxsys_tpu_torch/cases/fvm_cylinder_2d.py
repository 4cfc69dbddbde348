"""FVM flow around a cylinder, weakly compressible, on an unstructured
mesh (counterpart of sphinxsys_tpu/cases/fvm_cylinder_2d.py; reference
tests/2d_examples/test_2d_FVM_flow_around_cylinder/
2d_FVM_flow_around_cylinder.cpp): rho0 = 1, U = 1, c = 10 U, Re = 100
(mu = rho U 2R / Re), acoustic Riemann fluxes with limiter 200, a
non-slip cylinder wall (Fluent bc 3) and a far-field boundary (bc 9); the
regression quantity is the total (viscous + pressure) force on the
cylinder.

As in the JAX package the mesh is a generated cylinder O-grid, written in
the Fluent format to a temporary file and parsed back through the front
end (the pipeline a user's own ANSYS mesh takes).  A step reads nothing
back; the chunk loop reads the time once a step.

    case, fluid = build_case(nr=12, nt=24, device="cpu")
    sim = make_run_chunk(case)(init_sim(case, fluid), 0.5)
    print(sim.n_steps, drag_coefficient(case, sim))
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import torch

from sphinxsys_tpu_torch.core.materials import WeaklyCompressibleFluid
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.fvm import (compile_mesh, cylinder_ogrid,
                                     read_fluent_msh, write_fluent_msh)
from sphinxsys_tpu_torch.fvm import dynamics as fv
from sphinxsys_tpu_torch.fvm.mesh import FVMesh
from sphinxsys_tpu_torch.physics import riemann as rs
from sphinxsys_tpu_torch.solver import chunk_runner

RHO0_F = 1.0
U_F = 1.0
C_F = 10.0 * U_F
RE = 100.0
R_CYL = 1.0
MU_F = RHO0_F * U_F * (2.0 * R_CYL) / RE


@dataclasses.dataclass
class SimState:
    fluid: dict
    time: torch.Tensor
    n_steps: int


@dataclasses.dataclass(frozen=True)
class FVMCylinderCase:
    dm: fv.DeviceMesh
    eos: WeaklyCompressibleFluid
    riemann: rs.AcousticRiemannSolver
    far: fv.FarField
    mesh: FVMesh


def build_case(nr: int = 48, nt: int = 96, r_far: float = 25.0,
               dtype=PRODUCTION_DTYPE, via_msh_file: bool = True,
               device="cuda"):
    """The O-grid (nr x nt cells) through the Fluent writer and parser,
    compiled and moved to `device`, and the free stream in every cell.
    Returns (case, fluid)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    raw = cylinder_ogrid(r0=R_CYL, r1=r_far, nr=nr, nt=nt)
    if via_msh_file:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "cylinder_ogrid.msh")
            write_fluent_msh(path, raw)
            raw = read_fluent_msh(path)
    mesh = compile_mesh(raw)
    dm = fv.to_device(mesh, dtype, device)
    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    p_far = float(eos.pressure(torch.tensor(RHO0_F, dtype=torch.float64)))
    far = fv.FarField(rho=RHO0_F, vel=(U_F, 0.0), p=p_far)
    case = FVMCylinderCase(dm=dm, eos=eos,
                           riemann=rs.acoustic_riemann(eos,
                                                       limiter_coeff=200.0),
                           far=far, mesh=mesh)
    return case, fv.make_fvm_state(dm, RHO0_F, (U_F, 0.0), p_far)


def init_sim(case: FVMCylinderCase, fluid: dict) -> SimState:
    rho = fluid["Density"]
    return SimState(fluid=dict(fluid),
                    time=torch.zeros((), dtype=rho.dtype, device=rho.device),
                    n_steps=0)


def make_advection_step(case: FVMCylinderCase):
    def step(s: SimState) -> SimState:
        dt = fv.wc_acoustic_dt(s.fluid, case.eos, case.dm)
        f = fv.wc_integration_step(s.fluid, case.dm, case.eos, case.riemann,
                                   case.far, dt, mu=MU_F)
        return SimState(fluid=f, time=s.time + dt, n_steps=s.n_steps + 1)

    return step


def make_run_chunk(case: FVMCylinderCase):
    """run_chunk(sim, t_target): steps until sim.time >= t_target."""
    return chunk_runner(make_advection_step(case))


def cylinder_force(case: FVMCylinderCase, s: SimState) -> torch.Tensor:
    """The total (pressure + viscous) force on the cylinder, (2,)."""
    fp, fvisc = fv.force_on_boundary(s.fluid, case.dm, case.riemann,
                                     case.far, MU_F, boundary=3)
    return fp + fvisc


def drag_coefficient(case: FVMCylinderCase, s: SimState) -> float:
    """Cd = Fx / (0.5 rho U^2 D)."""
    f = cylinder_force(case, s)
    return float(f[0] / (0.5 * RHO0_F * U_F ** 2 * 2.0 * R_CYL))


def cells_as_body(case: FVMCylinderCase, s: SimState) -> dict:
    """The cell-centred fields as a body of points at the centroids, for
    the VTP writer (the reference writes FVM results through
    BodyStatesRecordingInMeshToVtu)."""
    like = s.fluid["Density"]
    return {"Position": case.dm.centroids.to(like.dtype),
            "VolumetricMeasure": case.dm.volumes.to(like.dtype),
            "Density": like, "Velocity": s.fluid["Velocity"],
            "Pressure": s.fluid["Pressure"], "NReal": case.dm.n_cells}
