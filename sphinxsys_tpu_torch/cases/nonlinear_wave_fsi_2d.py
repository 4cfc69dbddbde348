"""A focused nonlinear wave on a tension-leg moored floating structure
(counterpart of sphinxsys_tpu/cases/nonlinear_wave_fsi_2d.py; reference
tests/2d_examples/test_2d_nonlinear_wave_fsi/nonlinear_wave_fsi.{h,cpp}):
a 35 m wave tank whose piston wavemaker drives a 32-component focused
packet (focus x = 12, t = 20.48; f in [0.32, 0.96] Hz, a = 0.0068,
h:425-539), a 1:10 beach from x = 15, and a floating structure (a
baseplate, two pillars and a top plate, mass 62.036) held down against
its excess buoyancy by two taut cable springs anchored on the floor
(SimTK::CableSpring, k = 3.163e5, rest length the initial length,
damper 2, cpp:128-139).

As in the JAX package:
  * the wavemaker is physics/wavemaker.py's focused packet on a region
    of the wall, held until the release at 1 s (cpp:261-269);
  * the structure is the planar rigid body of physics/rigid.py with the
    reference's mass and inertia (h:124-198);
  * the tethers are tension-only springs T = max(0, k s (1 + c s_dot))
    at the two baseplate attachment points;
  * the fluid: the kernel-corrected first half (alpha = 0.1), the
    viscous force, the free-surface density summation.
The release is a device bool selected by `torch.where`; the packet's
tables and the cable points are tensors on the device.

    case, fluid = build_case(dx=0.12, device="cpu")
    sim = make_advection_step(case)(init_sim(case, fluid))
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch

from sphinxsys_tpu_torch.cases.floating_body_2d import (hydrostatic,
                                                       move_block, rebuild,
                                                       rigid_block)
from sphinxsys_tpu_torch.cases.owsc_2d import move_wavemaker, select_tuple
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

# nonlinear_wave_fsi.h:12-29
DL = 35.0
DH = 2.0
WL = 20.0
WH = 0.8
TB = 15.0          # the beach's start
DB = 25.0          # the beach's end x (height 1.0 there)
BEH = 2.0
EXS = 2.0
PLATE_H = 0.12
DX_REF = PLATE_H / 4.0
GRAVITY_G = 9.81
RHO0_F = 1000.0
U_F = 2.0 * math.sqrt(0.79 * GRAVITY_G)
C_F = 10.0 * U_F
MU_F = 1.0e-3
RELAX_TIME = 1.0

# the structure's boxes (h:52-93): x, y, l, h
BP = (12.286, 0.573, 1.3, 0.12)
SSP = (BP[0] + 0.25, BP[1] + BP[3], 0.2, 0.24)
PSP = (BP[0] + BP[2] - 0.45, BP[1] + BP[3], 0.2, 0.24)
TP = (BP[0] + 0.18, BP[1] + 0.36, 0.94, 0.11)
STRUCTURE_MASS = 62.036

# the tethers (h:99-109, cpp:128-139)
CABLE_K = 3.163e5
CABLE_DAMP = 2.0
CX_A = BP[0] + 0.35
CX_B = BP[0] + BP[2] - 0.35
CY = BP[1]

# the focused packet (h:544)
PACKET = dict(depth=WH, tf=20.480, xf=12.0, fmin=0.32, fmax=0.96,
              amplitude=0.0068, n_components=32, g=GRAVITY_G)

X_GAUGE = 10.848
FP2 = (12.466, 0.968)


def _structure_mass_properties():
    """The composite COM and Iz about it, and the density (h:124-198)."""
    boxes = [BP, SSP, PSP, TP]
    areas = np.array([b[2] * b[3] for b in boxes])
    area = areas.sum()
    rho = STRUCTURE_MASS / area
    cms = np.array([[b[0] + b[2] / 2, b[1] + b[3] / 2] for b in boxes])
    m = rho * areas
    G_cm = (m[:, None] * cms).sum(0) / m.sum()
    iz_own = m / 12.0 * np.array([b[2] ** 2 + b[3] ** 2 for b in boxes])
    d2 = ((cms - G_cm) ** 2).sum(1)
    iz = float((iz_own + m * d2).sum())
    return G_cm, iz, rho


@dataclasses.dataclass
class SimState:
    """The carry: the fluid, the wall (its wavemaker moves), the
    structure's particles and rigid state, the two cable tensions, the
    four lists, the physical and the total time, the step counts and the
    overflow flag."""

    fluid: dict
    wall: dict
    block: dict
    rb: rg.RigidBody2D
    tension: torch.Tensor
    nl_inner: NeighborList
    nl_fw: NeighborList
    nl_fb: NeighborList
    nl_bf: NeighborList
    time: torch.Tensor
    total_time: torch.Tensor
    n_adv: int
    n_ac: int
    overflow: torch.Tensor


@dataclasses.dataclass(frozen=True)
class WaveFsiCase:
    dx: float
    adaptation: SPHAdaptation
    grid: CellGrid
    eos: WeaklyCompressibleFluid
    riemann: Any
    gravity: Any
    g_vec: torch.Tensor
    wall0: Any
    maker_mask: torch.Tensor
    packet: wm.FocusedPacketMotion
    block0: Any
    rb0: Any
    mask_b: torch.Tensor
    cable_len0: float
    n_fluid: int
    n_block: int
    cell_cap: int
    k_inner: int
    k_contact: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def _box_shape(b):
    return G.Box(G.Transform(translation=(b[0] + b[2] / 2, b[1] + b[3] / 2)),
                 halfsize=(b[2] / 2, b[3] / 2))


def build_case(dx: float = DX_REF, dtype=PRODUCTION_DTYPE,
               cell_cap: int = 24, k_inner: int = 64, k_contact: int = 40,
               device="cuda"):
    """The water at its hydrostatic pressure (B = I), the tank with its
    beach and the wavemaker column, the structure at the reference's mass
    properties, the packet's tables.  Returns (case, fluid)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    bw = 4 * dx
    maker_w = 4 * dx           # Maker_width (h:29)
    adaptation = SPHAdaptation(spacing=dx, dim=2)

    structure_shape = G.make_complex(*[("add", _box_shape(b))
                                       for b in (BP, SSP, PSP, TP)])
    # the air pocket between the pillars, under the top plate (h:349-361)
    mdp = G.Box(G.Transform(translation=((SSP[0] + SSP[2] + PSP[0]) / 2,
                                         (SSP[1] + SSP[1] + SSP[3]) / 2)),
                halfsize=((PSP[0] - SSP[0] - SSP[2]) / 2, SSP[3] / 2))
    water_poly = G.Polygon(vertices=(
        (0.0, 0.0), (0.0, WH), (WH * 10 + TB, WH), (TB, 0.0)))
    water_shape = G.make_complex(
        ("add", water_poly), ("sub", structure_shape), ("sub", mdp))

    outer = G.Polygon(vertices=(
        (-EXS - bw, -bw), (-EXS - bw, DH), (DL + bw, DH),
        (DL + bw, BEH - bw), (DB, 1.0 - bw), (TB - bw, -bw)))
    inner = G.Polygon(vertices=(
        (-EXS, 0.0), (-EXS, DH), (DL, DH), (DL, BEH), (DB, 1.0), (TB, 0.0)))
    maker = G.Box(G.Transform(translation=(-maker_w / 2, 0.75)),
                  halfsize=(maker_w / 2, 0.75))
    wall_shape = G.make_complex(("add", outer), ("sub", inner),
                                ("add", maker))

    dom_lo = (-EXS - bw, -bw)
    dom_hi = (DL + bw, DH + bw)
    pos_f, vol = generate_lattice(water_shape, dom_lo, dom_hi, dx)
    pos_w, _ = generate_lattice(wall_shape, dom_lo, dom_hi, dx)
    pos_b, _ = generate_lattice(structure_shape, dom_lo, dom_hi, dx)

    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    fluid = make_fluid_state(pos_f, vol, RHO0_F, dtype, device)
    fluid = hydrostatic(fluid, pos_f, eos, WH, GRAVITY_G, clamp=True)
    for key in ("ViscousForce", "ViscousForcePrev", "GravityForcePrev"):
        fluid[key] = torch.zeros_like(fluid["Position"])
    fluid["LinearGradientCorrectionMatrix"] = torch.eye(
        2, dtype=dtype, device=device).repeat(len(pos_f), 1, 1)

    wall = make_solid_state(pos_w, vol, RHO0_F, dtype, device)
    wall = gd.normal_direction_from_shape(wall, wall_shape)
    wall["InitialPosition"] = wall["Position"]
    xw, yw = pos_w[:, 0], pos_w[:, 1]
    maker_mask = torch.as_tensor((xw > -maker_w) & (xw < 0.0) & (yw > 0.0)
                                 & (yw < 1.5), device=device)

    G_cm, iz, rho_s = _structure_mass_properties()
    block = rigid_block(pos_b, vol, rho_s, structure_shape, dtype, device,
                        keys=("PressureForceFromFluid",
                              "ViscousForceFromFluid"))
    mask_b = torch.ones(len(pos_b), dtype=torch.bool, device=device)
    rb0 = rg.rigid_body_from_particles(block, mask_b)
    put = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    rb0 = rb0._replace(mass=put(STRUCTURE_MASS), inertia=put(iz),
                       com=put(G_cm))

    gravity = gd.Gravity(acceleration=(0.0, -GRAVITY_G))
    fluid = gd.gravity_force(fluid, gravity)
    case = WaveFsiCase(
        dx=dx, adaptation=adaptation,
        grid=grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff), eos=eos,
        riemann=rs.acoustic_riemann(eos), gravity=gravity,
        g_vec=put(gravity.acceleration), wall0=wall, maker_mask=maker_mask,
        packet=wm.make_focused_packet(dtype=dtype, device=device, **PACKET),
        block0=block, rb0=rb0, mask_b=mask_b, cable_len0=float(CY),
        n_fluid=len(pos_f), n_block=len(pos_b), cell_cap=cell_cap,
        k_inner=k_inner, k_contact=k_contact)
    return case, fluid


def init_sim(case: WaveFsiCase, fluid: dict) -> SimState:
    wall, block = dict(case.wall0), dict(case.block0)
    *nls, ovf = rebuild(case, fluid, block, wall=wall)
    z = torch.zeros((), dtype=case.g_vec.dtype, device=case.g_vec.device)
    return SimState(fluid=dict(fluid), wall=wall, block=block, rb=case.rb0,
                    tension=torch.zeros_like(case.g_vec),
                    nl_inner=nls[0], nl_fw=nls[1], nl_fb=nls[2], nl_bf=nls[3],
                    time=z, total_time=z, n_adv=0, n_ac=0, overflow=ovf)


@functools.lru_cache(maxsize=None)
def _cable_points(dtype, device):
    """Each tether's (anchor on the floor, attachment point at t = 0), as
    tensors made once per dtype and device."""
    return tuple((torch.tensor([cx, 0.0], dtype=dtype, device=device),
                  torch.tensor([cx, CY], dtype=dtype, device=device))
                 for cx in (CX_A, CX_B))


def _cable_forces(rb: rg.RigidBody2D, com0):
    """The tension-only cable springs (SimTK::CableSpring's T = k s (1 + c
    s_dot), floored at 0): (force, torque, the two tensions).  The
    attachment points ride the body (velocity V + omega x arm); the
    anchors sit on the floor below them (cpp:117-139)."""
    force = torch.zeros_like(rb.com)
    torque = torch.zeros_like(rb.theta)
    tensions = []
    R = rg.rotation_2d(rb.theta).to(rb.com.dtype)
    for anchor, attach0 in _cable_points(rb.com.dtype, rb.com.device):
        attach = rb.com + R @ (attach0 - com0)
        arm = attach - rb.com
        v_attach = rb.vel + rb.omega * torch.stack([-arm[1], arm[0]])
        d = attach - anchor
        length = torch.linalg.vector_norm(d)
        e = d / (length + 1e-15)
        stretch = length - CY
        s_dot = torch.dot(e, v_attach)
        T = torch.clamp(CABLE_K * stretch * (1.0 + CABLE_DAMP * s_dot),
                        min=0.0)
        T = torch.where(stretch > 0.0, T, torch.zeros_like(T))
        f = -T * e
        force = force + f
        torque = torque + arm[0] * f[1] - arm[1] * f[0]
        tensions.append(T)
    return force, torque, torch.stack(tensions)


def rigid_update(case: WaveFsiCase, block: dict, rb: rg.RigidBody2D,
                 tension, dt, released):
    """The structure's ForcePrior and the tethers onto the rigid body, one
    rigid step under gravity, kept (with the tensions) only where
    `released`; the structure moved either way (held, the body keeps its
    state and the particles their place).  Returns (block, rigid state,
    tensions)."""
    cf, ct, tension_new = _cable_forces(rb, case.rb0.com)
    force, torque = rg.total_force_and_torque(block, case.mask_b, rb,
                                              force_keys=("ForcePrior",))
    rb_new = rg.rigid_step(rb, force + cf, torque + ct, dt,
                           gravity=case.g_vec)
    rb_new = select_tuple(released, rb_new, rb)
    tension = torch.where(released, tension_new, tension)
    return move_block(case, block, rb, rb_new, dt), rb_new, tension


def acoustic_substep(case: WaveFsiCase, s: SimState, fluid: dict,
                     wall: dict, block: dict, rb: rg.RigidBody2D, tension,
                     tt, dt_adv):
    """The corrected first half against the wall and the structure, the
    structure's pressure force, the tethers and the rigid step (kept
    where not yet released), the structure moved, the packet's piston
    moved, the second half.  Returns (fluid, wall, block, rigid state,
    tensions, dt)."""
    kernel, h = case.kernel, case.adaptation.h
    dt = torch.minimum(fd.acoustic_time_step(fluid, case.eos, h), dt_adv)
    released = tt >= RELAX_TIME
    fluid = fd.acoustic_step_1st_half(
        fluid, s.nl_inner, kernel, 2, case.eos, case.riemann, dt,
        walls=[(wall, s.nl_fw), (block, s.nl_fb)], correction=True)
    block = fsi.pressure_force_from_fluid(block, fluid, s.nl_bf, kernel, 2,
                                          case.riemann)
    block, rb, tension = rigid_update(case, block, rb, tension, dt,
                                      released)
    wall = move_wavemaker(case, wall, case.packet, tt, released, RELAX_TIME)
    fluid = fd.acoustic_step_2nd_half(
        fluid, s.nl_inner, kernel, 2, case.riemann, dt,
        walls=[(wall, s.nl_fw), (block, s.nl_fb)])
    return fluid, wall, block, rb, tension, dt


def _advection_step(case: WaveFsiCase, s: SimState) -> SimState:
    kernel, h = case.kernel, case.adaptation.h
    fluid, wall, block, rb = s.fluid, s.wall, s.block, s.rb
    dt_adv = fd.advection_viscous_time_step(fluid, h, U_F, RHO0_F, MU_F)
    fluid = fd.density_summation(
        fluid, s.nl_inner, kernel, 2, RHO0_F, case.adaptation.sigma0,
        contacts=[(wall, s.nl_fw, RHO0_F), (block, s.nl_fb, RHO0_F)],
        free_surface=True)
    fluid = fd.kernel_correction_matrix(fluid, s.nl_inner, kernel, 2,
                                        wall=wall, nl_wall=s.nl_fw, alpha=0.1)
    fluid = fd.viscous_force(fluid, s.nl_inner, kernel, 2, MU_F, h,
                             walls=[(wall, s.nl_fw), (block, s.nl_fb)])
    block = fsi.viscous_force_from_fluid(block, fluid, s.nl_bf, kernel, 2,
                                         MU_F, h)

    tension, tt = s.tension, s.total_time
    relax_t = torch.zeros_like(dt_adv)
    n_ac = 0
    while bool(relax_t < dt_adv):          # one host read per sub-step
        fluid, wall, block, rb, tension, dt = acoustic_substep(
            case, s, fluid, wall, block, rb, tension, tt, dt_adv)
        tt = tt + dt
        relax_t = relax_t + dt
        n_ac += 1

    *nls, ovf = rebuild(case, fluid, block, wall=wall)
    return SimState(fluid=fluid, wall=wall, block=block, rb=rb,
                    tension=tension,
                    nl_inner=nls[0], nl_fw=nls[1], nl_fb=nls[2], nl_bf=nls[3],
                    time=torch.clamp(tt - RELAX_TIME, min=0.0),
                    total_time=tt, n_adv=s.n_adv + 1, n_ac=s.n_ac + n_ac,
                    overflow=s.overflow | ovf)


def make_advection_step(case: WaveFsiCase):
    return lambda s: _advection_step(case, s)


def make_run_chunk(case: WaveFsiCase):
    """run_chunk(sim, t_target): advection steps until the physical time
    reaches t_target (the 1 s hold comes first)."""
    return chunk_runner(lambda s: _advection_step(case, s))


def wave_gauge(s: SimState, x: float = X_GAUGE, half_width: float = 0.039):
    """UpperFrontInAxisDirection over the gauge band (h:568-579): the
    highest fluid y within half_width of x (0 where none)."""
    pos = s.fluid["Position"]
    band = torch.abs(pos[:, 0] - x) < half_width
    return torch.max(torch.where(band, pos[:, 1], torch.zeros_like(pos[:, 1])))


def probe_pressure(case: WaveFsiCase, s: SimState, point0=FP2):
    """The fp2 probe rides the structure (cpp:192-199); the pressure is
    kernel-interpolated from the fluid at its current position."""
    rb = s.rb
    R = rg.rotation_2d(rb.theta).to(rb.com.dtype)
    pt = rb.com + R @ (torch.as_tensor(point0, dtype=rb.com.dtype,
                                       device=rb.com.device) - case.rb0.com)
    pos, vol = s.fluid["Position"], s.fluid["VolumetricMeasure"]
    r = torch.linalg.vector_norm(pos - pt, dim=1)
    w = torch.where(r < case.adaptation.cutoff, case.kernel.W(r, 2) * vol,
                    torch.zeros_like(r))
    return torch.sum(w * s.fluid["Pressure"]) / (torch.sum(w) + 1e-15)
