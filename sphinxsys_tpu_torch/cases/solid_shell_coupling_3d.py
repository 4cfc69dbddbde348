"""A Neo-Hookean cube resting on a clamped shell, tied by the solid-shell
coupling (counterpart of sphinxsys_tpu/cases/solid_shell_coupling_3d.py;
reference tests/3d_examples/test_3d_solid_to_shell_coupling, its dp_1
CI configuration): a 1 x 1 x 1 cube (E = 3 MPa, nu = 0.45, mm units) on
a 5 x 1 shell plate (thickness 0.2) clamped over 0.2 at both x-ends,
gravity -10 y on the cube above the shell's thickness.  A step, in the
reference's order:

    shell 1st half -> the cube's coupling force (ConservativeMapping of
    the shell's Force, plus gravity) -> the cube's PK2 1st half, damping,
    2nd half -> the shell's velocity by ConsistentMapping (the tied part)
    and the clamp -> the shell's damping -> the mapping and the clamp
    again -> the shell's 2nd half.

The coupling pairs are frozen at the initial configuration.  1,100 cube
and 500 shell particles, float64 by default.  The reference's oracle:
the centre's deflection -0.46 +- 10% at the semi-steady state.

    case, sim = build_case(device="cpu")
    sim = make_run_chunk(case)(sim, 1e-4)
    print(sim.n_steps, center_deflection(case, sim))
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.materials import NeoHookeanSolid
from sphinxsys_tpu_torch.core.state import State
from sphinxsys_tpu_torch.device import resolve_device, resolve_dtype
from sphinxsys_tpu_torch.neighbors.cell_list import (build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list)
from sphinxsys_tpu_torch.physics import dissipation as dp
from sphinxsys_tpu_torch.physics import shell as sh
from sphinxsys_tpu_torch.physics import solid as sd
from sphinxsys_tpu_torch.physics import solid_shell as ss
from sphinxsys_tpu_torch.solver import chunk_runner

UNIT_MM = 1e-3
CUBE_L = 1.0
SHELL_T = 0.2
SHELL_L = 5.0
SHELL_W = CUBE_L
CONSTRAINT_L = 2.0 * CUBE_L / 10.0
RHO0 = 1000.0 * UNIT_MM ** 2          # 1e-3
YOUNGS = 3.0                           # 3 MPa
POISSON = 0.45
GRAVITY = -10.0
# beta / 4 sqrt(rho E) L, beta = 0.4 (get_physical_viscosity_general)
PHYSICAL_VISCOSITY = 0.1 * math.sqrt(RHO0 * YOUNGS) * CUBE_L


@dataclasses.dataclass
class SimState:
    cube: State
    shell: State
    time: torch.Tensor
    n_steps: int
    dt: torch.Tensor


@dataclasses.dataclass(frozen=True)
class CouplingCase:
    dx: float
    adaptation: SPHAdaptation
    material: NeoHookeanSolid
    rp_cube: sd.ReferencePairs
    nl_cube: NeighborList
    rp_shell: sd.ReferencePairs
    nl_shell: NeighborList
    cp_shell: ss.CouplingPairs      # shell <- cube (TotalWeight, velocity)
    cp_cube: ss.CouplingPairs       # cube <- shell (force)
    shell_fixed: torch.Tensor
    shell_tied_part: torch.Tensor   # |x| < cube_length / 2
    grav_mask: torch.Tensor         # cube rows above the shell's thickness
    n_cube: int
    n_shell: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = CUBE_L / 10.0, dtype=torch.float64, device="cuda"):
    """The cube and the shell, their frozen inner pairs (the shell's on the
    reduced kernel), B of each, the frozen tie pairs both ways and the
    masks.  Returns (case, sim), dt 1e-5 before the first step."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    adaptation = SPHAdaptation(spacing=dx, dim=3)
    material = NeoHookeanSolid(rho0=RHO0, youngs_modulus=YOUNGS,
                               poisson_ratio=POISSON)
    # the cube: x, z in (-L/2, L/2), y in (-dx/2, L + dx/2)
    ax = np.arange(-0.5 * CUBE_L + 0.5 * dx, 0.5 * CUBE_L, dx)
    ay = np.arange(0.0, CUBE_L + dx, dx)
    X, Y, Z = np.meshgrid(ax, ay, ax, indexing="ij")
    cube_pos = np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1)
    # the shell's mid-surface at y = dx/2, normal +y
    sx = np.arange(-0.5 * SHELL_L + 0.5 * dx, 0.5 * SHELL_L, dx)
    sz = np.arange(-0.5 * SHELL_W + 0.5 * dx, 0.5 * SHELL_W, dx)
    SX, SZ = np.meshgrid(sx, sz, indexing="ij")
    shell_pos = np.stack([SX.ravel(), np.full(SX.size, 0.5 * dx),
                          SZ.ravel()], -1)
    shell_n = np.tile([0.0, 1.0, 0.0], (len(shell_pos), 1))

    cube = sd.make_elastic_solid_state(cube_pos, dx ** 3, material, dtype,
                                       device)
    shell = sh.make_shell_state(shell_pos, shell_n, dx, SHELL_T, material,
                                dtype, device)
    cutoff = adaptation.cutoff
    grid = grid_from_bounds((-0.5 * SHELL_L - 0.3, -0.3, -0.6),
                            (0.5 * SHELL_L + 0.3, CUBE_L + 0.3, 0.6), cutoff)
    n_c, n_s = len(cube_pos), len(shell_pos)
    pc, ps = cube["Position"], shell["Position"]
    tc = build_cell_table(pc, n_c, grid, 36)
    ts = build_cell_table(ps, n_s, grid, 36)

    nl_cc = build_neighbor_list(pc, n_c, pc, n_c, tc, grid, cutoff, k_max=96,
                                include_self=False)
    nl_ss = build_neighbor_list(ps, n_s, ps, n_s, ts, grid, cutoff, k_max=32,
                                include_self=False)
    # the tie pairs at the larger cutoff of the two (equal h here)
    nl_sc = build_neighbor_list(ps, n_s, pc, n_c, tc, grid, cutoff, k_max=64,
                                include_self=False)
    nl_cs = build_neighbor_list(pc, n_c, ps, n_s, ts, grid, cutoff, k_max=32,
                                include_self=False)
    if any(bool(nl.overflow) for nl in (nl_cc, nl_ss, nl_sc, nl_cs)):
        raise ValueError("solid_shell_coupling_3d: a frozen list overflows")
    rp_cube = sd.freeze_reference_pairs(pc, nl_cc, adaptation.kernel, 3)
    cube["LinearGradientCorrectionMatrix"] = \
        sd.linear_gradient_correction_matrix(rp_cube,
                                             cube["VolumetricMeasure"])
    rp_shell = sd.freeze_reference_pairs(ps, nl_ss,
                                         sh.ReducedKernel(adaptation.kernel),
                                         3)
    shell = sh.shell_correct_configuration(shell, rp_shell)
    cp_shell = ss.freeze_coupling(ps, pc, cube["VolumetricMeasure"], nl_sc,
                                  adaptation.kernel, 3)
    cp_cube = ss.freeze_coupling(pc, ps, shell["VolumetricMeasure"], nl_cs,
                                 adaptation.kernel, 3)

    def mask(m):
        return torch.as_tensor(m, device=device)

    case = CouplingCase(
        dx=dx, adaptation=adaptation, material=material, rp_cube=rp_cube,
        nl_cube=nl_cc, rp_shell=rp_shell, nl_shell=nl_ss, cp_shell=cp_shell,
        cp_cube=cp_cube,
        shell_fixed=mask((shell_pos[:, 0] < -0.5 * SHELL_L + CONSTRAINT_L)
                         | (shell_pos[:, 0] > 0.5 * SHELL_L - CONSTRAINT_L)),
        shell_tied_part=mask((shell_pos[:, 0] > -0.5 * CUBE_L)
                             & (shell_pos[:, 0] < 0.5 * CUBE_L)),
        grav_mask=mask(cube_pos[:, 1] > SHELL_T), n_cube=n_c, n_shell=n_s)
    return case, SimState(cube=cube, shell=shell, time=pc.new_zeros(()),
                          n_steps=0, dt=pc.new_tensor(1e-5))


def cube_force_prior(case: CouplingCase, cube: State, shell: State):
    """The cube's coupling force (the shell's Force spread conservatively)
    plus gravity on its part above the shell."""
    f_cpl = ss.conservative_mapping(case.cp_cube, cube["VolumetricMeasure"],
                                    case.cp_shell.total_weight,
                                    shell["Force"])
    grav = torch.where(case.grav_mask, cube["Mass"] * GRAVITY,
                       torch.zeros_like(cube["Mass"]))
    return f_cpl + torch.stack([torch.zeros_like(grav), grav,
                                torch.zeros_like(grav)], dim=-1)


def tie_shell(case: CouplingCase, shell: State, cube: State) -> State:
    """The tied part's velocity from the cube's, then the clamp."""
    shell = dict(shell, Velocity=ss.consistent_mapping(
        case.cp_shell, cube["Velocity"], shell["Velocity"],
        part_mask=case.shell_tied_part))
    return sh.fix_shell(shell, case.shell_fixed)


def _step(case: CouplingCase, s: SimState) -> SimState:
    h = case.adaptation.h
    kernel = case.kernel
    dt = s.dt
    shell = sh.shell_stress_relaxation_1st_half(s.shell, case.rp_shell,
                                                case.material, dt, h)
    cube = dict(s.cube, ForcePrior=cube_force_prior(case, s.cube, shell))
    cube = sd.integration_1st_half_pk2(cube, case.rp_cube, case.material, dt,
                                       h, kernel.w0(3))
    cube = dp.damping_pairwise(cube, "Velocity", case.nl_cube, kernel, 3,
                               PHYSICAL_VISCOSITY, dt)
    cube = sd.integration_2nd_half(cube, case.rp_cube, dt)

    shell = tie_shell(case, shell, cube)
    for field in ("Velocity", "AngularVelocity"):
        shell = dp.damping_pairwise(shell, field, case.nl_shell, kernel, 3,
                                    PHYSICAL_VISCOSITY, dt)
    shell = tie_shell(case, shell, cube)
    shell = sh.shell_stress_relaxation_2nd_half(shell, case.rp_shell, dt)

    dt_next = torch.minimum(
        sd.solid_acoustic_time_step(cube, case.material.sound_speed, h),
        sh.shell_acoustic_time_step(shell, case.material, h))
    return SimState(cube=cube, shell=shell, time=s.time + dt,
                    n_steps=s.n_steps + 1, dt=dt_next)


def make_step(case: CouplingCase):
    return lambda s: _step(case, s)


def make_run_chunk(case: CouplingCase):
    """run_chunk(sim, t_target): steps until sim.time >= t_target."""
    return chunk_runner(make_step(case))


def center_deflection(case: CouplingCase, s: SimState) -> float:
    """The y-displacement of the shell's centre (the observer at
    (0, dx/2, 0)): the mean over the rows within dx of it in x and z."""
    p0 = s.shell["InitialPosition"]
    dy = s.shell["Position"][:, 1] - p0[:, 1]
    near = (p0[:, 0].abs() < case.dx) & (p0[:, 2].abs() < case.dx)
    return float(dy[near].mean())


def u_max(s: SimState) -> float:
    return float(torch.linalg.vector_norm(s.cube["Velocity"], dim=-1).max())
