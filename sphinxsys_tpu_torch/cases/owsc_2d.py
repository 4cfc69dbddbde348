"""The oscillating wave surge converter (counterpart of
sphinxsys_tpu/cases/owsc_2d.py; reference tests/2d_examples/test_2d_owsc/
owsc.{h,cpp}): an 18.42 m wave tank with a piston wavemaker at its left
end (a fixed region of the wall moved by Biesel's first-order stroke for
the 5 m / 10 s target wave at scale 1:25, owsc.h:261-334), a sloped berm
carrying a base, and a bottom-pinned buoyant flap (mass 33.04, pin at
(7.92, 0.315)) with a linear power take-off damper on the joint (c = 20,
owsc.cpp:158).  A quadratic damping zone over the last 5 m absorbs the
transmitted wave.

As in the JAX package: the flap's rounded bottom is a box joined with a
ball at the pin; the pin is the joint of physics/rigid.py, I domega/dt =
tau_fluid + tau_gravity - c omega; the wavemaker and the flap are held
while the total time is below 1 s, and the physical clock starts at
their release (owsc.cpp:229-269).  The release is a device bool: the
held and moved states are selected by `torch.where`, so the sub-step
reads nothing back.  Observables: the flap's pitch, the total viscous
force on it, the energy the damper takes.

    case, fluid = build_case(dx=0.12, device="cpu")
    sim = init_sim(case, fluid)
    sim = make_advection_step(case)(sim)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from sphinxsys_tpu_torch.cases.floating_body_2d import (hydrostatic, rebuild,
                                                       rigid_block)
from sphinxsys_tpu_torch.core import geometry as G
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.generators import generate_lattice
from sphinxsys_tpu_torch.core.materials import WeaklyCompressibleFluid
from sphinxsys_tpu_torch.core.state import make_fluid_state, make_solid_state
from sphinxsys_tpu_torch.device import (PRODUCTION_DTYPE, resolve_device,
                                        resolve_dtype)
from sphinxsys_tpu_torch.neighbors.cell_list import CellGrid, grid_from_bounds
from sphinxsys_tpu_torch.neighbors.neighbor_list import NeighborList
from sphinxsys_tpu_torch.physics import fluid as fd
from sphinxsys_tpu_torch.physics import fsi
from sphinxsys_tpu_torch.physics import general as gd
from sphinxsys_tpu_torch.physics import rigid as rg
from sphinxsys_tpu_torch.physics import riemann as rs
from sphinxsys_tpu_torch.physics import wavemaker as wm
from sphinxsys_tpu_torch.solver import chunk_runner

# owsc.h:17-72
DL = 18.42
DH = 1.0
DL_EXTRA = 1.0
WATER_H = 0.691
FLAP_WIDTH = 0.12
FLAP_X = 7.92
FLAP_H = 0.48
BASE_BOTTOM = 0.155
BASE_HEIGHT = 0.1
GRAVITY_G = 9.81
RHO0_F = 1000.0
U_REF = 2.0 * math.sqrt(0.79 * GRAVITY_G)
C_F = 10.0 * U_REF
MU_F = 1.0e-6
FLAP_MASS = 33.04
FLAP_VOLUME = 0.0579
RHO0_S = FLAP_MASS / FLAP_VOLUME
PTO_DAMPING = 20.0                       # MobilityLinearDamper (owsc.cpp:158)
PIN = (FLAP_X, BASE_BOTTOM + BASE_HEIGHT + 0.5 * FLAP_WIDTH)  # (7.92, 0.315)
RELAX_TIME = 1.0

# the target wave: 5 m / 10 s at model scale 25 (owsc.h:328-330)
WAVE_HEIGHT, WAVE_PERIOD, MODEL_SCALE = 5.0, 10.0, 25.0

# the berm (owsc.h:40-46)
SLOPE_1 = (DL - 6.2, 0.356)
SLOPE_2 = (DL - 6.2 - 3.7, 0.155)
SLOPE_3 = (DL - 6.2 - 3.7 - 2.4, 0.155)
SLOPE_4 = (DL - 6.2 - 3.7 - 2.4 - 1.3, 0.0)


@dataclasses.dataclass
class SimState:
    """The carry: the fluid, the wall (its wavemaker moves), the flap's
    particles and its joint, the damper's energy, the total viscous force
    on the flap, the four lists, the physical and the total time, the
    step counts and the overflow flag."""

    fluid: dict
    wall: dict
    flap: dict
    pj: rg.PinJoint2D
    pto_energy: torch.Tensor
    visc_force: torch.Tensor
    nl_inner: NeighborList
    nl_fw: NeighborList
    nl_ff: NeighborList
    nl_bf: NeighborList
    time: torch.Tensor
    total_time: torch.Tensor
    n_adv: int
    n_ac: int
    overflow: torch.Tensor


@dataclasses.dataclass(frozen=True)
class OWSCCase:
    dx: float
    adaptation: SPHAdaptation
    grid: CellGrid
    eos: WeaklyCompressibleFluid
    riemann: Any
    gravity: Any
    g_vec: torch.Tensor
    pin: torch.Tensor
    wall0: Any
    maker_mask: torch.Tensor
    piston: wm.PistonMotion
    flap0: Any
    pj0: Any
    mask_b: torch.Tensor
    n_fluid: int
    n_flap: int
    cell_cap: int
    k_inner: int
    k_contact: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def _water_shape(flap_shape, base_shape):
    poly = G.Polygon(vertices=(
        (0.0, 0.0), (0.0, WATER_H), (DL, WATER_H), (DL, 0.356),
        SLOPE_1, SLOPE_2, SLOPE_3, SLOPE_4))
    return G.make_complex(("add", poly), ("sub", flap_shape),
                          ("sub", base_shape))


def build_case(dx: float = FLAP_WIDTH / 4.0, dtype=PRODUCTION_DTYPE,
               cell_cap: int = 24, k_inner: int = 64, k_contact: int = 40,
               device="cuda"):
    """The water at its hydrostatic pressure, the wall with the berm, the
    base and the wavemaker column (-4 dx < x < 0), the flap at the
    reference's mass, the piston.  Returns (case, fluid)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    bw = 4 * dx
    adaptation = SPHAdaptation(spacing=dx, dim=2)

    base_shape = G.Box(
        G.Transform(translation=(FLAP_X, BASE_BOTTOM + BASE_HEIGHT / 2)),
        halfsize=(FLAP_WIDTH / 2, BASE_HEIGHT / 2))
    flap_box = G.Box(
        G.Transform(translation=(FLAP_X, PIN[1] + FLAP_H / 2)),
        halfsize=(FLAP_WIDTH / 2, FLAP_H / 2))
    flap_shape = G.make_complex(
        ("add", flap_box),
        ("add", G.Ball(center=PIN, radius=FLAP_WIDTH / 2)))

    outer = G.Polygon(vertices=(
        (-DL_EXTRA - bw, -bw), (-DL_EXTRA - bw, DH + bw),
        (DL + bw, DH + bw), (DL + bw, 0.35 - bw),
        (SLOPE_1[0], SLOPE_1[1] - bw), (SLOPE_2[0], SLOPE_2[1] - bw),
        (SLOPE_3[0], SLOPE_3[1] - bw), (SLOPE_4[0], SLOPE_4[1] - bw)))
    inner01 = G.Polygon(vertices=(
        (0.0, 0.0), (0.0, DH + bw), (DL, DH + bw), (DL, 0.356),
        SLOPE_1, SLOPE_2, SLOPE_3, SLOPE_4))
    inner02 = G.Box(
        G.Transform(translation=(-(DL_EXTRA + bw) / 2, (DH + bw) / 2)),
        halfsize=((DL_EXTRA - bw) / 2, (DH + bw) / 2))
    wall_shape = G.make_complex(("add", outer), ("sub", inner01),
                                ("sub", inner02), ("add", base_shape))

    dom_lo = (-DL_EXTRA - bw, -bw)
    dom_hi = (DL + bw, DH + bw)
    pos_f, vol = generate_lattice(_water_shape(flap_shape, base_shape),
                                  dom_lo, dom_hi, dx)
    pos_w, _ = generate_lattice(wall_shape, dom_lo, dom_hi, dx)
    pos_b, _ = generate_lattice(flap_shape, dom_lo, dom_hi, dx)

    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    fluid = make_fluid_state(pos_f, vol, RHO0_F, dtype, device)
    fluid = hydrostatic(fluid, pos_f, eos, WATER_H, GRAVITY_G, clamp=True)
    for key in ("ViscousForce", "ViscousForcePrev", "GravityForcePrev"):
        fluid[key] = torch.zeros_like(fluid["Position"])

    wall = make_solid_state(pos_w, vol, RHO0_F, dtype, device)
    wall = gd.normal_direction_from_shape(wall, wall_shape)
    wall["InitialPosition"] = wall["Position"]
    # the wavemaker: the column -BW < x < 0 (createWaveMakerShape)
    xw, yw = pos_w[:, 0], pos_w[:, 1]
    maker_mask = torch.as_tensor((xw > -bw) & (xw < 0.0) & (yw > 0.0),
                                 device=device)

    flap = rigid_block(pos_b, vol, RHO0_S, flap_shape, dtype, device,
                       keys=("PressureForceFromFluid",
                             "ViscousForceFromFluid"))
    mask_b = torch.ones(len(pos_b), dtype=torch.bool, device=device)
    pj0 = rg.pin_joint_from_particles(flap, mask_b, PIN)
    # the reference's flap mass (the lattice's volume differs a little)
    flap["Mass"] = flap["Mass"] * (FLAP_MASS / float(pj0.mass))
    pj0 = rg.pin_joint_from_particles(flap, mask_b, PIN)

    gravity = gd.Gravity(acceleration=(0.0, -GRAVITY_G))
    fluid = gd.gravity_force(fluid, gravity)
    case = OWSCCase(
        dx=dx, adaptation=adaptation,
        grid=grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff), eos=eos,
        riemann=rs.acoustic_riemann(eos), gravity=gravity,
        g_vec=torch.tensor(gravity.acceleration, dtype=dtype, device=device),
        pin=torch.tensor(PIN, dtype=dtype, device=device), wall0=wall,
        maker_mask=maker_mask,
        piston=wm.make_piston(WAVE_HEIGHT, WAVE_PERIOD, WATER_H, GRAVITY_G,
                              model_scale=MODEL_SCALE),
        flap0=flap, pj0=pj0, mask_b=mask_b, n_fluid=len(pos_f),
        n_flap=len(pos_b), cell_cap=cell_cap, k_inner=k_inner,
        k_contact=k_contact)
    return case, fluid


def init_sim(case: OWSCCase, fluid: dict) -> SimState:
    wall, flap = dict(case.wall0), dict(case.flap0)
    *nls, ovf = rebuild(case, fluid, flap, wall=wall)
    z = torch.zeros((), dtype=case.pin.dtype, device=case.pin.device)
    return SimState(fluid=dict(fluid), wall=wall, flap=flap, pj=case.pj0,
                    pto_energy=z, visc_force=torch.zeros_like(case.pin),
                    nl_inner=nls[0], nl_fw=nls[1], nl_ff=nls[2], nl_bf=nls[3],
                    time=z, total_time=z, n_adv=0, n_ac=0, overflow=ovf)


def select(released, moved: dict, held: dict, keys) -> dict:
    """`moved` where the device bool `released`, `held` otherwise, on
    `keys` (the others are the same in both)."""
    out = dict(held)
    for k in keys:
        out[k] = torch.where(released, moved[k], held[k])
    return out


def select_tuple(released, moved, held):
    return type(held)(*[torch.where(released, a, b)
                        for a, b in zip(moved, held)])


WAVEMAKER_KEYS = ("Position", "Velocity", "AverageVelocity",
                  "AverageAcceleration")


def move_wavemaker(case, w: dict, motion, tt, released,
                   relax_time: float) -> dict:
    """The wavemaker's motion at the physical time max(tt - relax_time,
    0), imposed once released (owsc.cpp:254-262)."""
    t_wave = torch.clamp(tt - relax_time, min=0.0)
    w_moved = wm.apply_wavemaker(w, case.maker_mask, motion, t_wave)
    return select(released, w_moved, w, WAVEMAKER_KEYS)


def acoustic_substep(case: OWSCCase, s: SimState, fluid: dict, wall: dict,
                     flap: dict, pj: rg.PinJoint2D, e_pto, tt, dt_adv):
    """The fluid's first half against the wall and the flap, the flap's
    pressure force, the pin joint's step (kept where not yet released),
    the flap moved about the pin, the piston moved, the second half, the
    damper's energy.  Returns (fluid, wall, flap, joint, energy, dt)."""
    kernel, h = case.kernel, case.adaptation.h
    dt = torch.minimum(fd.acoustic_time_step(fluid, case.eos, h), dt_adv)
    released = tt >= RELAX_TIME
    fluid = fd.acoustic_step_1st_half(
        fluid, s.nl_inner, kernel, 2, case.eos, case.riemann, dt,
        walls=[(wall, s.nl_fw), (flap, s.nl_ff)])
    flap = fsi.pressure_force_from_fluid(flap, fluid, s.nl_bf, kernel, 2,
                                         case.riemann)
    # the pin joint (owsc.cpp:253-262), once released
    torque = rg.pin_torque(flap, case.mask_b, pj, force_keys=("ForcePrior",))
    pj_new = rg.pin_joint_step(pj, torque, dt, damping=PTO_DAMPING,
                               gravity=case.g_vec)
    pj_new = select_tuple(released, pj_new, pj)
    flap = rg.constrain_by_pin_joint(flap, case.mask_b, pj_new,
                                     case.flap0["InitialPosition"])
    acc_scale = (pj_new.omega - pj.omega) / (dt + 1e-15)
    r = flap["Position"] - case.pin
    flap["AverageAcceleration"] = acc_scale * torch.stack(
        [-r[:, 1], r[:, 0]], dim=-1)
    wall = move_wavemaker(case, wall, case.piston, tt, released,
                          RELAX_TIME)
    fluid = fd.acoustic_step_2nd_half(
        fluid, s.nl_inner, kernel, 2, case.riemann, dt,
        walls=[(wall, s.nl_fw), (flap, s.nl_ff)])
    e_pto = e_pto + PTO_DAMPING * pj_new.omega ** 2 * dt
    return fluid, wall, flap, pj_new, e_pto, dt


def _advection_step(case: OWSCCase, s: SimState) -> SimState:
    kernel, h = case.kernel, case.adaptation.h
    fluid, wall, flap, pj = s.fluid, s.wall, s.flap, s.pj
    dt_adv = fd.advection_viscous_time_step(fluid, h, U_REF, RHO0_F, MU_F)
    fluid = fd.density_summation(
        fluid, s.nl_inner, kernel, 2, RHO0_F, case.adaptation.sigma0,
        contacts=[(wall, s.nl_fw, RHO0_F), (flap, s.nl_ff, RHO0_F)],
        free_surface=True)
    fluid = fd.viscous_force(fluid, s.nl_inner, kernel, 2, MU_F, h,
                             walls=[(wall, s.nl_fw), (flap, s.nl_ff)])
    flap = fsi.viscous_force_from_fluid(flap, fluid, s.nl_bf, kernel, 2,
                                        MU_F, h)
    visc_total = torch.sum(flap["ViscousForceFromFluid"], dim=0)

    e_pto, tt = s.pto_energy, s.total_time
    relax_t = torch.zeros_like(dt_adv)
    n_ac = 0
    while bool(relax_t < dt_adv):          # one host read per sub-step
        fluid, wall, flap, pj, e_pto, dt = acoustic_substep(
            case, s, fluid, wall, flap, pj, e_pto, tt, dt_adv)
        tt = tt + dt
        relax_t = relax_t + dt
        n_ac += 1

    # the damping zone over the last 5 m (damping_wave.exec(Dt),
    # owsc.cpp:282)
    fluid = wm.damping_zone(fluid, fluid["Position"][:, 0] > (DL - 5.0),
                            DL - 5.0, DL + 4 * case.dx, dt_adv)
    *nls, ovf = rebuild(case, fluid, flap, wall=wall)
    return SimState(fluid=fluid, wall=wall, flap=flap, pj=pj,
                    pto_energy=e_pto, visc_force=visc_total,
                    nl_inner=nls[0], nl_fw=nls[1], nl_ff=nls[2], nl_bf=nls[3],
                    time=torch.clamp(tt - RELAX_TIME, min=0.0),
                    total_time=tt, n_adv=s.n_adv + 1, n_ac=s.n_ac + n_ac,
                    overflow=s.overflow | ovf)


def make_advection_step(case: OWSCCase):
    return lambda s: _advection_step(case, s)


def make_run_chunk(case: OWSCCase):
    """run_chunk(sim, t_target): advection steps until the physical time
    reaches t_target (the 1 s hold comes first)."""
    return chunk_runner(lambda s: _advection_step(case, s))


def flap_angle_deg(s: SimState) -> float:
    return float(s.pj.theta) * 180.0 / np.pi


def wave_gauge(case: OWSCCase, s: SimState, x: float = 3.0):
    """The highest fluid y within 1.3 dx of x (0 where none), a 0-d
    tensor (tests/test_owsc.py's gauge)."""
    pos = s.fluid["Position"]
    band = torch.abs(pos[:, 0] - x) < 1.3 * case.dx
    return torch.max(torch.where(band, pos[:, 1], torch.zeros_like(pos[:, 1])))
