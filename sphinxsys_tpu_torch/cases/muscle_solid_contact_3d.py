"""A soft cube compressed by a rigid sliding plate (counterpart of
sphinxsys_tpu/cases/muscle_solid_contact_3d.py; reference
tests/3d_examples/test_3d_muscle_solid_contact/muscle_solid_contact.cpp):
a Neo-Hookean cube (L = 0.04, dx = L/12, rho = 1265, E = 5e4, nu = 0.45)
backed by a fixed holder plate is pressed by a rigid plate on a 1-DOF x
slider under gravity g_x = -100 with a linear damper c = 20; the contact
force on the plate drives the slider (q, u), closing the deformable-rigid
loop.  The cube runs PK2 stress relaxation and pairwise damping of its
velocity at eta / ratio = 200 / 0.1, every step.  The reference's
database regresses the cube's kinetic energy every 100 steps.

    case, sim = build_case(dx=0.01, device="cpu")
    sim = make_run_chunk(case)(sim, 1e-3)
    print(sim.n_steps, kinetic_energy(sim))

Contact is the solid-solid repulsion factor and force, both ways, on
lists rebuilt every step (the plate moves).  The JAX package's build
defaults to float64, as this one does: its CLI runs with x64 off and so
computes in float32 there, while the port honours float64 on every
device.  One host read a step (the loop's time test).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.materials import (NeoHookeanSolid,
                                                SaintVenantKirchhoffSolid)
from sphinxsys_tpu_torch.core.state import State
from sphinxsys_tpu_torch.device import resolve_device, resolve_dtype
from sphinxsys_tpu_torch.neighbors.cell_list import (CellGrid,
                                                    build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list)
from sphinxsys_tpu_torch.physics import contact as ct
from sphinxsys_tpu_torch.physics import dissipation as dp
from sphinxsys_tpu_torch.physics import solid as sd
from sphinxsys_tpu_torch.solver import chunk_runner

L = 0.04
PL = 0.1
DX = L / 12.0
BW = 4 * DX
RHO0 = 1265.0
POISSON = 0.45
YOUNGS = 5.0e4
PHYSICAL_VISCOSITY = 200.0
DAMPING_RATIO = 0.1
GRAVITY_X = -100.0
DAMPER_C = 20.0
END_TIME = 0.1


class MuscleSim(NamedTuple):
    myo: State
    plate: State
    q: torch.Tensor         # the slider's coordinate (the plate's x offset)
    u: torch.Tensor         # its velocity
    time: torch.Tensor
    n_steps: int
    dt: torch.Tensor        # the next step's dt
    overflow: torch.Tensor  # 0-d bool: a contact list overflowed


@dataclasses.dataclass(frozen=True)
class MuscleCase:
    adaptation: SPHAdaptation
    material: NeoHookeanSolid
    material_p: SaintVenantKirchhoffSolid
    rp: sd.ReferencePairs
    nl_inner: NeighborList
    holder_mask: torch.Tensor
    grid: CellGrid
    n_myo: int
    n_plate: int
    plate_mass: float
    cell_cap: int = 40
    k_contact: int = 48

    @property
    def kernel(self):
        return self.adaptation.kernel


def _lattice_box(lo, hi, dx):
    axes = [np.arange(a + dx / 2, b, dx) for a, b in zip(lo, hi)]
    return np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)


def build_case(dx: float = DX, dtype=torch.float64, k_inner: int = 96,
               cell_cap: int = 40, k_contact: int = 48, device="cuda"):
    """The cube with its holder (frozen pairs, B, the damping's list) and
    the plate, at rest.  Returns (case, sim)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    adaptation = SPHAdaptation(spacing=dx, dim=3)
    material = NeoHookeanSolid(rho0=RHO0, youngs_modulus=YOUNGS,
                               poisson_ratio=POISSON)
    material_p = SaintVenantKirchhoffSolid(rho0=RHO0, youngs_modulus=YOUNGS,
                                           poisson_ratio=POISSON)
    # the cube [0, L]^3 centred on y, z and its holder plate x in [-BW, 0]
    # (muscle_solid_contact.cpp:16-20)
    cube = _lattice_box((0.0, -0.5 * L, -0.5 * L), (L, 0.5 * L, 0.5 * L), dx)
    holder = _lattice_box((-BW, -0.5 * L - BW, -0.5 * L - BW),
                          (0.0, 0.5 * L + BW, 0.5 * L + BW), dx)
    pos_m = np.concatenate([cube, holder])
    holder_mask = torch.as_tensor(np.concatenate(
        [np.zeros(len(cube), bool), np.ones(len(holder), bool)]),
        device=device)
    # the moving plate: x in [L + BW/2, L + 1.5 BW], y, z in [-PL/2, PL/2]
    pos_p = _lattice_box((L + 0.5 * BW, -0.5 * PL, -0.5 * PL),
                         (L + 1.5 * BW, 0.5 * PL, 0.5 * PL), dx)

    vol = dx ** 3
    myo = sd.make_elastic_solid_state(pos_m, vol, material, dtype, device)
    plate = sd.make_elastic_solid_state(pos_p, vol, material_p, dtype, device)
    plate["AverageVelocity"] = torch.zeros_like(plate["Velocity"])
    for b in (myo, plate):
        b["RepulsionForce"] = torch.zeros_like(b["Velocity"])
        b["PreviousRepulsionForce"] = torch.zeros_like(b["Velocity"])

    grid = grid_from_bounds((-2 * BW, -0.6 * PL, -0.6 * PL),
                            (2.0 * L + 3 * BW, 0.6 * PL, 0.6 * PL),
                            adaptation.cutoff)
    p0, n = myo["Position"], myo["NReal"]
    table = build_cell_table(p0, n, grid, cell_cap)
    nl = build_neighbor_list(p0, n, p0, n, table, grid, adaptation.cutoff,
                             k_max=k_inner, include_self=False)
    if bool(nl.overflow):
        raise ValueError("raise k_inner: the frozen pairs must be exact")
    rp = sd.freeze_reference_pairs(p0, nl, adaptation.kernel, 3)
    myo["LinearGradientCorrectionMatrix"] = \
        sd.linear_gradient_correction_matrix(rp, myo["VolumetricMeasure"])

    case = MuscleCase(adaptation=adaptation, material=material,
                      material_p=material_p, rp=rp, nl_inner=nl,
                      holder_mask=holder_mask, grid=grid, n_myo=len(pos_m),
                      n_plate=len(pos_p), plate_mass=RHO0 * vol * len(pos_p),
                      cell_cap=cell_cap, k_contact=k_contact)
    zero = p0.new_zeros(())
    sim = MuscleSim(myo=myo, plate=plate, q=zero, u=zero, time=zero,
                    n_steps=0, dt=torch.full_like(zero, 1.0e-6),
                    overflow=torch.zeros((), dtype=torch.bool, device=device))
    return case, sim


def _contact_nl(case: MuscleCase, pos_q, n_q, pos_t, n_t) -> NeighborList:
    table = build_cell_table(pos_t, n_t, case.grid, case.cell_cap)
    return build_neighbor_list(pos_q, n_q, pos_t, n_t, table, case.grid,
                               case.adaptation.cutoff, k_max=case.k_contact,
                               include_self=True)


def contact(case: MuscleCase, myo: State, plate: State):
    """The repulsion both ways (ContactFactorSummation + ContactForce):
    (myo, plate, the lists' overflow)."""
    kernel = case.kernel
    nl_mp = _contact_nl(case, myo["Position"], myo["NReal"],
                        plate["Position"], plate["NReal"])
    nl_pm = _contact_nl(case, plate["Position"], plate["NReal"],
                        myo["Position"], myo["NReal"])
    fac_m = ct.repulsion_factor_contact(myo, plate, nl_mp, kernel, 3)
    fac_p = ct.repulsion_factor_contact(plate, myo, nl_pm, kernel, 3)
    myo = ct.repulsion_force_contact(myo, plate, nl_mp, kernel, 3, fac_m,
                                     fac_p,
                                     ct.contact_stiffness(case.material))
    plate = ct.repulsion_force_contact(plate, myo, nl_pm, kernel, 3, fac_p,
                                       fac_m,
                                       ct.contact_stiffness(case.material_p))
    return myo, plate, nl_mp.overflow | nl_pm.overflow


def slider(case: MuscleCase, plate: State, q, u, dt):
    """The plate's slider (Slider mobiliser + UniformGravity +
    MobilityLinearDamper), symplectic Euler from the contact force:
    (plate, q, u)."""
    f_x = torch.sum(plate["RepulsionForce"][:, 0])
    m = case.plate_mass
    acc = f_x / m + GRAVITY_X - DAMPER_C * u / m
    u_new = u + acc * dt
    plate = dict(plate)
    pos = plate["Position"]
    plate["Position"] = torch.cat([pos[:, :1] + u_new * dt, pos[:, 1:]],
                                  dim=1)
    vel = torch.zeros_like(plate["Velocity"])
    vel[:, 0] = u_new
    plate["Velocity"] = vel
    return plate, q + u_new * dt, u_new


def damping(case: MuscleCase, myo: State, dt) -> State:
    """The cube's velocity damping at eta / ratio, every step."""
    return dp.damping_pairwise(myo, "Velocity", case.nl_inner, case.kernel,
                               3, PHYSICAL_VISCOSITY / DAMPING_RATIO, dt)


def _step(case: MuscleCase, s: MuscleSim) -> MuscleSim:
    h = case.adaptation.h
    dt = s.dt
    myo, plate, ovf = contact(case, s.myo, s.plate)
    plate, q, u = slider(case, plate, s.q, s.u, dt)
    myo = sd.integration_1st_half_pk2(myo, case.rp, case.material, dt, h,
                                      case.kernel.w0(3))
    myo = sd.fix_constraint(myo, case.holder_mask)
    myo = damping(case, myo, dt)
    myo = sd.fix_constraint(myo, case.holder_mask)
    myo = sd.integration_2nd_half(myo, case.rp, dt)
    dt_next = sd.solid_acoustic_time_step(myo, case.material.sound_speed, h)
    return MuscleSim(myo=myo, plate=plate, q=q, u=u, time=s.time + dt,
                     n_steps=s.n_steps + 1, dt=dt_next,
                     overflow=s.overflow | ovf)


def make_step(case: MuscleCase):
    return lambda s: _step(case, s)


def make_run_chunk(case: MuscleCase):
    """run_chunk(sim, t_target): steps until sim.time >= t_target."""
    return chunk_runner(lambda s: _step(case, s))


def kinetic_energy(s: MuscleSim) -> float:
    """The cube's TotalKineticEnergy (the regressed quantity)."""
    m = s.myo
    return float(torch.sum(0.5 * m["Mass"]
                           * torch.sum(m["Velocity"] ** 2, dim=-1)))
