"""The Scordelis-Lo cylindrical roof (counterpart of
sphinxsys_tpu/cases/roof_3d.py; reference tests/3d_examples/test_3d_roof/
3d_roof.cpp): an 80-degree cylindrical shell sector (mid-surface radius
25.0, axial height 50, thickness 0.25, St. Venant-Kirchhoff E = 4.32e8,
nu = 0, rho = 36) sags under self-weight (0, 0, -10) ramped to full over
t = 0.1.  The two axial ends sit on rigid diaphragms: their velocity is
projected onto the cylinder's axis (FixedInAxisDirection(0, 1, 0)),
their positions and rotations free.  The lattice is the reference's
generator (3d_roof.cpp:55-77): 17 rows at 5 degrees from 50 degrees,
axial rows at dp = 2 pi R_mid (80 / 360) / 16 with a ghost row past each
end, radial normals, Vol = dp^2: 425 particles, float64 by default.

The damping is the JAX package's: damping_projection of the velocity and
the angular velocity every step at eta / 0.3 (its calibration against
the reference database; see its module docstring).  The observable is
the Shepard-interpolated Position at the reference observer (R_mid at
40 degrees, mid-height); the reference's sag 0.3024 +- 10%.

    case, sim = build_case(device="cpu")
    sim = make_run_chunk(case)(sim, 1e-3)
    print(sim.n_steps, observer_position(case, sim))
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.materials import SaintVenantKirchhoffSolid
from sphinxsys_tpu_torch.core.state import State
from sphinxsys_tpu_torch.device import resolve_device, resolve_dtype
from sphinxsys_tpu_torch.io.observation import observe_quantity
from sphinxsys_tpu_torch.neighbors.cell_list import (build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list)
from sphinxsys_tpu_torch.physics import dissipation as dp
from sphinxsys_tpu_torch.physics import shell as sh
from sphinxsys_tpu_torch.physics import solid as sd
from sphinxsys_tpu_torch.solver import chunk_runner

# 3d_roof.cpp:16-39
RADIUS = 24.875
HEIGHT = 50.0
THICKNESS = 0.25
R_MID = RADIUS + THICKNESS / 2.0
N_PERIPHERAL = 16
DP = 2.0 * R_MID * math.pi * 80.0 / 360.0 / N_PERIPHERAL
RHO0 = 36.0
YOUNGS = 4.32e8
POISSON = 0.0
# the nominal viscosity; the step damps at PHYSICAL_VISCOSITY / DAMPING_RATIO
PHYSICAL_VISCOSITY = 7.0e3 * THICKNESS
DAMPING_RATIO = 0.3
T_FULL_FORCE = 0.1
GRAVITY = -10.0
DISPL_MAX_REF = 0.3024
END_TIME = 2.0

OBS_ANGLE = (50.0 - 2.0 * 80.0 / N_PERIPHERAL) / 180.0 * math.pi
OBS_POINT = (R_MID * math.cos(OBS_ANGLE), 0.5 * HEIGHT,
             R_MID * math.sin(OBS_ANGLE))


@dataclasses.dataclass
class RoofSim:
    shell: State
    time: torch.Tensor
    n_steps: int
    dt: torch.Tensor


@dataclasses.dataclass(frozen=True)
class RoofCase:
    adaptation: SPHAdaptation
    material: SaintVenantKirchhoffSolid
    rp: sd.ReferencePairs
    nl: NeighborList
    boundary_mask: torch.Tensor
    nl_obs: NeighborList
    n_shell: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dtype=torch.float64, device="cuda"):
    """The roof's lattice, its frozen pairs on the reduced kernel and B,
    the diaphragm rows (y < 0 or y > height + dp / 2), the observer's
    list.  Returns (case, sim), dt 1e-6 before the first step."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    adaptation = SPHAdaptation(spacing=DP, dim=3)
    material = SaintVenantKirchhoffSolid(rho0=RHO0, youngs_modulus=YOUNGS,
                                         poisson_ratio=POISSON)
    n_axial = int(HEIGHT / DP + 2)          # j < height / dp + 2 BWD
    pos, normals = [], []
    for i in range(N_PERIPHERAL + 1):
        ang = 50.0 / 180.0 * math.pi \
            + i * 80.0 / 360.0 * 2.0 * math.pi / N_PERIPHERAL
        for j in range(n_axial + 1):
            x = R_MID * math.cos(ang)
            y = DP * j - DP + 0.5 * DP
            z = R_MID * math.sin(ang)
            pos.append((x, y, z))
            normals.append((x / R_MID, 0.0, z / R_MID))
    pos = np.asarray(pos)
    n = len(pos)
    shell = sh.make_shell_state(pos, np.asarray(normals), DP, THICKNESS,
                                material, dtype, device)

    cutoff = adaptation.cutoff
    grid = grid_from_bounds(
        (-RADIUS - 5 * DP, -2 * DP, -RADIUS - 5 * DP),
        (RADIUS + 5 * DP, HEIGHT + 2 * DP, RADIUS + 5 * DP), cutoff)
    p0 = shell["Position"]
    table = build_cell_table(p0, n, grid, 32)
    nl = build_neighbor_list(p0, n, p0, n, table, grid, cutoff, k_max=32,
                             include_self=False)
    if bool(nl.overflow):
        raise ValueError("roof_3d: the frozen pairs overflow k_max")
    rp = sd.freeze_reference_pairs(p0, nl, sh.ReducedKernel(adaptation.kernel),
                                   3)
    shell = sh.shell_correct_configuration(shell, rp)
    boundary_mask = torch.as_tensor((pos[:, 1] < 0.0)
                                    | (pos[:, 1] > HEIGHT + 0.5 * DP),
                                    device=device)
    obs = torch.as_tensor([OBS_POINT], dtype=dtype, device=device)
    nl_obs = build_neighbor_list(obs, 1, p0, n, table, grid, cutoff,
                                 k_max=32, include_self=True)
    case = RoofCase(adaptation=adaptation, material=material, rp=rp, nl=nl,
                    boundary_mask=boundary_mask, nl_obs=nl_obs, n_shell=n)
    return case, RoofSim(shell=shell, time=p0.new_zeros(()), n_steps=0,
                         dt=p0.new_tensor(1e-6))


def _constrain(shell: State, mask) -> State:
    """FixedInAxisDirection(0, 1, 0): the diaphragm rows' velocity
    projected onto the axis; positions and rotations untouched."""
    vel = shell["Velocity"]
    axial = torch.cat([torch.zeros_like(vel[:, :1]), vel[:, 1:2],
                       torch.zeros_like(vel[:, 2:])], dim=-1)
    return dict(shell, Velocity=torch.where(mask[:, None], axial, vel))


def damping(case: RoofCase, shell: State, dt, eta: float) -> State:
    """Projection damping of the velocity and the angular velocity."""
    for field in ("Velocity", "AngularVelocity"):
        shell = dp.damping_projection(shell, field, case.nl, case.kernel, 3,
                                      eta, dt)
    return shell


def _step(case: RoofCase, s: RoofSim) -> RoofSim:
    h = case.adaptation.h
    dt = s.dt
    shell = dict(s.shell)
    # IncreaseToFullGravity (3d_roof.cpp:122-123)
    ramp = torch.clamp(s.time / T_FULL_FORCE, max=1.0)
    gz = shell["Mass"] * GRAVITY * ramp
    shell["ForcePrior"] = torch.stack(
        [torch.zeros_like(gz), torch.zeros_like(gz), gz], dim=-1)
    shell = sh.shell_stress_relaxation_1st_half(shell, case.rp, case.material,
                                                dt, h)
    shell = _constrain(shell, case.boundary_mask)
    shell = damping(case, shell, dt, PHYSICAL_VISCOSITY / DAMPING_RATIO)
    shell = _constrain(shell, case.boundary_mask)
    shell = sh.shell_stress_relaxation_2nd_half(shell, case.rp, dt)
    dt_next = sh.shell_acoustic_time_step(shell, case.material, h)
    return RoofSim(shell=shell, time=s.time + dt, n_steps=s.n_steps + 1,
                   dt=dt_next)


def make_step(case: RoofCase):
    return lambda s: _step(case, s)


def make_run_chunk(case: RoofCase):
    """run_chunk(sim, t_target): steps until sim.time >= t_target."""
    return chunk_runner(make_step(case))


def observer_position(case: RoofCase, s: RoofSim) -> np.ndarray:
    """The Shepard-interpolated shell Position at the reference observer
    (CylinderObserver, the regression database's quantity)."""
    obs = torch.as_tensor([OBS_POINT], dtype=s.shell["Position"].dtype,
                          device=s.shell["Position"].device)
    return observe_quantity(obs, s.shell, "Position", case.nl_obs,
                            case.kernel, 3)[0].cpu().numpy()


def z_displacement(case: RoofCase, s: RoofSim, z0: float) -> float:
    """The sag z_0 - z_now (3d_roof.cpp:43-48)."""
    return float(z0 - observer_position(case, s)[2])
