"""3D FVM inviscid channel flow over a bump on the ICEM mesh (counterpart
of sphinxsys_tpu/cases/fvm_channel_3d.py; reference tests/3d_examples/
test_3d_FVM_incompressible_channel_flow/): a weakly-compressible inviscid
flow through a channel with a lower-wall bump, driven by a velocity inlet
(bc 10, u = 1) against a pressure outlet (bc 5, p = 100/117.6655), slip
(reflective) walls (bc 3) and symmetry faces (bc 7): the ghost policy of
InvCFBoundaryConditionSetup (test_3d_FVM_incompressible_channel_flow.h:
85-121).

The mesh is the reference's shipped Channel_ICEM.msh (5,143 tetrahedra).
The file is not part of the repository: `build_case` reads it from
`mesh_path=` or from the path in the environment variable FVM3D_MESH, and
raises FileNotFoundError when neither is given or the file is not there.  `build_case(raw=...)` runs the same case on any compiled-ready
RawMesh with the same boundary ids (fvm/meshgen.py `hex_box` makes a
structured channel).  Validation is physics-based: steady mass
conservation through the inlet and outlet, and the bump's speed-up.

    from sphinxsys_tpu_torch.fvm.meshgen import hex_box
    raw = hex_box(8, 3, 3, (2.0, 0.5, 0.5), CHANNEL_SIDES)
    case, state = build_case(raw=raw, device="cpu")
    sim = make_run_chunk(case)(init_sim(case, state), 0.05)
    print(sim.n_steps, boundary_flux(case, sim, 10), max_speed(sim))
"""

from __future__ import annotations

import dataclasses
import os

import torch

from sphinxsys_tpu_torch.core.materials import WeaklyCompressibleFluid
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.fvm import dynamics as fv
from sphinxsys_tpu_torch.fvm.mesh import RawMesh, compile_mesh, read_fluent_msh
from sphinxsys_tpu_torch.physics import riemann as rs
from sphinxsys_tpu_torch.physics.eulerian import interface_state
from sphinxsys_tpu_torch.solver import chunk_runner

RHO0_F = 1.0
U_F = 1.0
C_F = 10.0 * U_F
P0 = 50.0 / 117.6655
P_OUT = 100.0 / 117.6655
# the boundary ids of a generated channel (fvm/meshgen.py hex_box): the
# inlet at x = 0, the outlet at x = L, slip walls in y, symmetry in z
CHANNEL_SIDES = {"x0": 10, "x1": 5, "y0": 3, "y1": 3, "z0": 7, "z1": 7}


@dataclasses.dataclass
class FVMSim:
    state: dict
    time: torch.Tensor
    n_steps: int


@dataclasses.dataclass(frozen=True)
class Channel3DCase:
    dm: fv.DeviceMesh
    eos: WeaklyCompressibleFluid
    riemann: rs.AcousticRiemannSolver
    bc: fv.BCSpec
    far: fv.FarField


def build_case(mesh_path: str | None = None, dtype=PRODUCTION_DTYPE,
               device="cuda", raw: RawMesh | None = None):
    """The mesh at `mesh_path` (else $FVM3D_MESH; or `raw`) compiled and
    moved to `device`, and the fluid at rest pressure with u = 1
    everywhere.  Returns (case, state)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    if raw is None:
        mesh_path = mesh_path or os.environ.get("FVM3D_MESH")
        if not mesh_path:
            raise FileNotFoundError(
                "fvm_channel_3d: Channel_ICEM.msh is not in the repository; "
                "give its path through mesh_path= or FVM3D_MESH, or pass "
                "raw=")
        if not os.path.isfile(mesh_path):
            raise FileNotFoundError(
                f"fvm_channel_3d: the ICEM mesh {mesh_path} is not there "
                "(give it through mesh_path= or FVM3D_MESH, or pass raw=)")
        raw = read_fluent_msh(mesh_path)
    dm = fv.to_device(compile_mesh(raw), dtype, device)
    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    bc = fv.BCSpec(wall_slip=True, inlet_vel=(U_F, 0.0, 0.0), outlet_p=P_OUT)
    far = fv.FarField(rho=RHO0_F, vel=(U_F, 0.0, 0.0), p=P0)
    case = Channel3DCase(dm=dm, eos=eos, riemann=rs.acoustic_riemann(eos),
                         bc=bc, far=far)
    return case, fv.make_fvm_state(dm, RHO0_F, (U_F, 0.0, 0.0), P0)


def init_sim(case: Channel3DCase, state: dict) -> FVMSim:
    p = state["Pressure"]
    return FVMSim(state=dict(state),
                  time=torch.zeros((), dtype=p.dtype, device=p.device),
                  n_steps=0)


def make_advection_step(case: Channel3DCase):
    def step(s: FVMSim) -> FVMSim:
        dt = fv.wc_acoustic_dt(s.state, case.eos, case.dm)
        st = fv.wc_integration_step(s.state, case.dm, case.eos, case.riemann,
                                    case.far, dt, bc=case.bc)
        return FVMSim(state=st, time=s.time + dt, n_steps=s.n_steps + 1)

    return step


def make_run_chunk(case: Channel3DCase):
    """run_chunk(sim, t_target): steps until sim.time >= t_target."""
    return chunk_runner(make_advection_step(case))


def max_speed(s: FVMSim) -> float:
    return float(torch.max(torch.linalg.vector_norm(s.state["Velocity"],
                                                    dim=-1)))


def boundary_flux(case: Channel3DCase, s: FVMSim, btype: int) -> float:
    """The outward mass flux through one boundary type (inlet 10, outlet
    5)."""
    dm = case.dm
    left, right = fv.face_states(s.state, dm, case.far, case.bc)
    rho_s, vel_s, p_s = interface_state(case.riemann, *left, *right,
                                        -dm.normal)
    sel = fv.boundary_faces(dm, btype, p_s)
    vn = torch.sum(vel_s * dm.normal, dim=-1)
    return float(torch.sum(sel * rho_s * vn * dm.area))
