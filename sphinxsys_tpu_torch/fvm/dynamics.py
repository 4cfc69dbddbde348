"""Face-based FVM dynamics (counterpart of sphinxsys_tpu/fvm/dynamics.py;
reference FVM_flow_around_cylinder_2d_def.h + eulerian_fluid_dynamics/*).

The reference reuses the SPH pair kernels over an FVM "neighbourhood"
whose dW_ij = -A_f / (2 V_i V_j) encodes the face area
(unstructured_mesh_2d.cpp:212); with that substitution the SPH sums are
exact finite-volume flux divergences.  Here the fluxes are computed per
face and reduced per cell through the dense (C, K) incidence table: two
gathers and a sum over K in slot order (`_cell_reduce`), no scatter.

Boundary conditions are ghost states evaluated per boundary face from the
owner state (fvm_ghost_boundary.h BoundaryConditionSetupInFVM):
  wall(3)      non-slip reflection   vel_g = -vel_i
  symmetry(7)  normal reflection     vel_g = vel_i - 2 (vel_i.n) n
  far-field(9) prescribed freestream
  otherwise    zero-gradient copy

Every select is a `torch.where` in the state's dtype (a Python float
operand stays weakly typed, as in the JAX package), both branches
evaluated.  A step reads nothing back from the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sphinxsys_tpu_torch.device import resolve_device
from sphinxsys_tpu_torch.fvm.mesh import FVMesh
from sphinxsys_tpu_torch.physics.eulerian import (hllc_interface_state,
                                                  interface_state)

TINY = 1.0e-15


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """The compiled mesh as tensors on one device: F real faces and the
    zero-area dummy face F that pads the incidence table."""

    n_cells: int
    volumes: torch.Tensor     # (C,)
    owner: torch.Tensor       # (F+1,) int64
    neigh: torch.Tensor       # (F+1,) boundary faces clamped to the owner
    interior: torch.Tensor    # (F+1,) bool (the dummy face: True)
    area: torch.Tensor        # (F+1,) the dummy face's 0
    normal: torch.Tensor      # (F+1, d)
    midpoint: torch.Tensor    # (F+1, d)
    r_eff: torch.Tensor       # (F+1,) the dummy face's 1
    btype: torch.Tensor       # (F+1,) int64 (the dummy face's 2)
    cell_faces: torch.Tensor  # (C, K) int64, padded with F
    cell_sign: torch.Tensor   # (C, K)
    centroids: torch.Tensor   # (C, d)
    min_edge: float

    @property
    def dim(self) -> int:
        return self.normal.shape[1]

    @property
    def n_faces(self) -> int:
        """Real faces (the dummy face left out)."""
        return self.area.shape[0] - 1


def to_device(mesh: FVMesh, dtype=torch.float32, device="cuda") -> DeviceMesh:
    """Append the zero-area dummy face (the incidence padding target),
    clamp the boundary faces' `neigh` to their owner (the zero-gradient
    ghosts read it) and move everything to `device` (the card unless the
    caller asks for the CPU)."""
    device = resolve_device(device)
    F = len(mesh.area)

    def pad_v(a, fill):
        return np.concatenate([a, np.full((1,) + a.shape[1:], fill, a.dtype)])

    owner = pad_v(mesh.owner, 0)
    neigh_raw = pad_v(mesh.neigh, 0)
    interior = neigh_raw >= 0
    interior[F] = True
    neigh = np.where(neigh_raw >= 0, neigh_raw, owner)

    def f(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def i(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                               device=device)

    return DeviceMesh(
        n_cells=mesh.n_cells, volumes=f(mesh.volumes), owner=i(owner),
        neigh=i(neigh), interior=torch.as_tensor(interior, device=device),
        area=f(pad_v(mesh.area, 0.0)), normal=f(pad_v(mesh.normal, 0.0)),
        midpoint=f(pad_v(mesh.midpoint, 0.0)),
        r_eff=f(pad_v(np.maximum(mesh.r_eff, 1e-12), 1.0)),
        btype=i(pad_v(mesh.btype, 2)), cell_faces=i(mesh.cell_faces),
        cell_sign=f(mesh.cell_sign), centroids=f(mesh.centroids),
        min_edge=float(mesh.min_edge))


def _vec(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def make_fvm_state(dm: DeviceMesh, rho0: float, vel0, p0: float):
    """Uniform Density, Velocity and Pressure in the mesh's dtype."""
    C, like = dm.n_cells, dm.volumes
    return {"Density": torch.full((C,), rho0, dtype=like.dtype,
                                  device=like.device),
            "Velocity": _vec(vel0, like).expand(C, dm.dim).clone(),
            "Pressure": torch.full((C,), p0, dtype=like.dtype,
                                   device=like.device)}


@dataclasses.dataclass(frozen=True)
class FarField:
    rho: float
    vel: tuple
    p: float


@dataclasses.dataclass(frozen=True)
class BCSpec:
    """Per-case ghost-state policy (BoundaryConditionSetupInFVM overrides,
    e.g. test_3d_FVM_incompressible_channel_flow.h:85-121).  The defaults
    are the cylinder's: bc 3/4/10/36 no-slip walls, bc 7 symmetry mirror,
    bc 9/5 far field."""

    wall_slip: bool = False         # bc 3: the slip mirror instead
    inlet_vel: tuple | None = None  # bc 10: fixed velocity, copy p / rho
    outlet_p: float | None = None   # bc 5: fixed pressure, copy vel / rho


def face_states(state, dm: DeviceMesh, far: FarField, bc: BCSpec = BCSpec()):
    """Left (owner) and right (neighbour or ghost) primitive states of
    every face."""
    rho, vel, p = state["Density"], state["Velocity"], state["Pressure"]
    rho_l, vel_l, p_l = rho[dm.owner], vel[dm.owner], p[dm.owner]
    rho_r, vel_r, p_r = rho[dm.neigh], vel[dm.neigh], p[dm.neigh]

    bt, bnd = dm.btype, ~dm.interior
    wall = bnd & ((bt == 3) | (bt == 4) | (bt == 36))
    if bc.inlet_vel is None:
        wall = wall | (bnd & (bt == 10))
    sym = bnd & (bt == 7)
    farf = bnd & (bt == 9)
    if bc.outlet_p is None:
        farf = farf | (bnd & (bt == 5))

    vn = torch.sum(vel_l * dm.normal, dim=-1, keepdim=True)
    mirror = vel_l - 2.0 * vn * dm.normal
    vel_r = torch.where(wall[:, None], mirror if bc.wall_slip else -vel_l,
                        vel_r)
    vel_r = torch.where(sym[:, None], mirror, vel_r)
    vel_r = torch.where(farf[:, None], _vec(far.vel, vel_l)[None, :], vel_r)
    rho_r = torch.where(farf, far.rho, rho_r)
    p_r = torch.where(farf, far.p, p_r)
    # the other boundary ghosts already copy the owner's rho / p: to_device
    # clamps a boundary face's `neigh` to its owner
    if bc.inlet_vel is not None:
        inlet = bnd & (bt == 10)
        vel_r = torch.where(inlet[:, None], _vec(bc.inlet_vel, vel_l)[None, :],
                            vel_r)
    if bc.outlet_p is not None:
        outlet = bnd & (bt == 5)
        vel_r = torch.where(outlet[:, None], vel_l, vel_r)
        p_r = torch.where(outlet, _vec(bc.outlet_p, p_l), p_r)
    return (rho_l, vel_l, p_l), (rho_r, vel_r, p_r)


def _cell_reduce(dm: DeviceMesh, face_flux):
    """Signed face fluxes summed into their cells: (F+1, ...) -> (C, ...),
    a (C, K) gather and a sum over the K slots."""
    g = face_flux[dm.cell_faces]                       # (C, K, ...)
    sign = dm.cell_sign.reshape(dm.cell_sign.shape + (1,) * (g.dim() - 2))
    return torch.sum(g * sign, dim=1)


def _max_speed(c, vel):
    return torch.max(c + torch.linalg.vector_norm(vel, dim=-1))


def wc_acoustic_dt(state, eos, dm: DeviceMesh, cfl: float = 0.6):
    """WCAcousticTimeStepSizeInFVM: CFL min_edge / max(c + |v|), a 0-d
    tensor."""
    c = eos.sound_speed(state["Pressure"], state["Density"])
    return cfl * dm.min_edge / (_max_speed(c, state["Velocity"]) + TINY)


def viscous_force(state, dm: DeviceMesh, far: FarField, mu: float,
                  bc: BCSpec = BCSpec()):
    """ViscousForceInner over the FVM relation: per face
    mu (v_r - v_l) / r_eff A, reduced per cell (the ghost right state gives
    the non-slip wall shear).  (C, d), + accelerates."""
    (_, vel_l, _), (_, vel_r, _) = face_states(state, dm, far, bc)
    f = mu * (vel_r - vel_l) / dm.r_eff[:, None] * dm.area[:, None]
    return _cell_reduce(dm, f)


def _momentum_flux(rho_s, vel_s, p_s, dm: DeviceMesh):
    """(v*.n, rho* v* (v*.n) + p* n) A, per face."""
    vn = torch.sum(vel_s * dm.normal, dim=-1)
    mom = ((rho_s * vn)[:, None] * vel_s + p_s[:, None] * dm.normal) \
        * dm.area[:, None]
    return vn, mom


def wc_integration_step(state, dm: DeviceMesh, eos, riemann, far: FarField,
                        dt, mu: float = 0.0, bc: BCSpec = BCSpec()):
    """One conservative Eulerian WCSPH step (the reference's
    EulerianIntegration1stHalf and 2ndHalf back to back with the same dt,
    both reading the pre-step state: one flux evaluation here).

    d(rho)/dt   = -(1/V) sum_f rho* (v*.n) A
    d(rho v)/dt = -(1/V) sum_f [rho* v* (v*.n) + p* n] A  + F_visc/V
    """
    (rho_l, vel_l, p_l), (rho_r, vel_r, p_r) = face_states(state, dm, far, bc)
    # interface_state's e_ij points j -> i, into the owner: -normal
    rho_s, vel_s, p_s = interface_state(riemann, rho_l, vel_l, p_l,
                                        rho_r, vel_r, p_r, -dm.normal)
    vn, mom_flux = _momentum_flux(rho_s, vel_s, p_s, dm)
    mass_flux = rho_s * vn * dm.area

    div_mass = _cell_reduce(dm, mass_flux)
    div_mom = _cell_reduce(dm, mom_flux)

    rho = state["Density"]
    mom = rho[:, None] * state["Velocity"]
    inv_v = 1.0 / dm.volumes
    rho_new = rho - dt * inv_v * div_mass
    mom_new = mom - dt * inv_v[:, None] * div_mom
    if mu != 0.0:
        mom_new = mom_new + dt * inv_v[:, None] * viscous_force(
            state, dm, far, mu, bc)
    vel_new = mom_new / torch.clamp(rho_new, min=TINY)[:, None]
    out = dict(state)
    out["Density"] = rho_new
    out["Velocity"] = vel_new
    out["Pressure"] = eos.pressure(rho_new)
    return out


def boundary_faces(dm: DeviceMesh, btype: int, like: torch.Tensor):
    """(F+1,) 1.0 on the boundary faces of one Fluent type, else 0."""
    return ((dm.btype == btype) & ~dm.interior).to(like.dtype)


def force_on_boundary(state, dm: DeviceMesh, riemann, far: FarField,
                      mu: float, boundary: int = 3):
    """PressureForceFromFluidInFVM + ViscousForceFromFluidInFVM: the total
    (pressure, viscous) force the fluid exerts on the faces of one boundary
    type (the cylinder's drag and lift)."""
    (rho_l, vel_l, p_l), (rho_r, vel_r, p_r) = face_states(state, dm, far)
    rho_s, vel_s, p_s = interface_state(riemann, rho_l, vel_l, p_l,
                                        rho_r, vel_r, p_r, -dm.normal)
    sel = boundary_faces(dm, boundary, p_s)
    f_press = torch.sum((sel * p_s * dm.area)[:, None] * dm.normal, dim=0)
    shear = mu * (vel_l - vel_r) / dm.r_eff[:, None] * dm.area[:, None]
    f_visc = torch.sum(sel[:, None] * shear, dim=0)
    return f_press, f_visc


# ---------------------------------------------------------------------------
# Compressible (ideal-gas) HLLC path: the reference's
# EulerianCompressibleIntegration1st/2ndHalfHLLCWithLimiterRiemann stack as
# test_2d_eulerian_supersonic_flow_new_BC (the Mach-2 cylinder) and the
# FVM double Mach reflection use it.
# ---------------------------------------------------------------------------

def make_compressible_fvm_state(dm: DeviceMesh, gas, rho0: float, vel0,
                                p0: float):
    """Uniform Density, Velocity, Pressure and TotalEnergyDensity."""
    st = make_fvm_state(dm, rho0, vel0, p0)
    rho, vel, p = st["Density"], st["Velocity"], st["Pressure"]
    st["TotalEnergyDensity"] = p / (gas.gamma - 1.0) \
        + 0.5 * rho * torch.sum(vel ** 2, dim=-1)
    return st


def _far_energy(far: FarField, gas, v_far):
    return far.p / (gas.gamma - 1.0) + 0.5 * far.rho * torch.sum(v_far ** 2)


def _inflow_faces(farf, far: FarField, dm: DeviceMesh, like):
    """The far-field faces the free stream enters (v_far . n_out < 0), and
    v_far."""
    v_far = _vec(far.vel, like)
    return farf & (torch.sum(v_far * dm.normal, dim=-1) < 0.0), v_far


def compressible_face_states(state, dm: DeviceMesh, far: FarField, gas):
    """The supersonic stack's ghosts
    (2d_eulerian_supersonic_flow_around_cylinder.h:80-160):
      wall (3, 7): the slip mirror of the normal velocity;
      far field (9, 5): the supersonic characteristic switch: faces the
        free stream enters impose it, faces it leaves copy the owner."""
    rho, vel, p = state["Density"], state["Velocity"], state["Pressure"]
    E = state["TotalEnergyDensity"]
    l = (rho[dm.owner], vel[dm.owner], p[dm.owner], E[dm.owner])
    rho_r, vel_r, p_r, E_r = (rho[dm.neigh], vel[dm.neigh], p[dm.neigh],
                              E[dm.neigh])

    bt, bnd = dm.btype, ~dm.interior
    wall = bnd & ((bt == 3) | (bt == 7))
    farf = bnd & ((bt == 9) | (bt == 5))

    vn = torch.sum(l[1] * dm.normal, dim=-1, keepdim=True)
    vel_r = torch.where(wall[:, None], l[1] - 2.0 * vn * dm.normal, vel_r)
    rho_r = torch.where(wall, l[0], rho_r)
    p_r = torch.where(wall, l[2], p_r)
    E_r = torch.where(wall, l[3], E_r)

    inflow, v_far = _inflow_faces(farf, far, dm, vel)
    E_far = _far_energy(far, gas, v_far)
    vel_r = torch.where(inflow[:, None], v_far[None, :], vel_r)
    rho_r = torch.where(inflow, far.rho, rho_r)
    p_r = torch.where(inflow, far.p, p_r)
    E_r = torch.where(inflow, E_far, E_r)
    return l, (rho_r, vel_r, p_r, E_r)


def compressible_time_step_fvm(state, gas, dm: DeviceMesh, cfl: float = 0.3):
    c = gas.sound_speed(state["Pressure"], state["Density"])
    return cfl * dm.min_edge / (_max_speed(c, state["Velocity"]) + TINY)


def _compressible_update(state, dm: DeviceMesh, gas, dt, left, right):
    """The HLLC star state of every face and the conservative update:
      F_mass = rho* vn* A,  F_mom = (rho* v* vn* + p* n) A,
      F_E    = (E* + p*) vn* A."""
    rho_s, vel_s, p_s, E_s = hllc_interface_state(gas, *left, *right,
                                                  -dm.normal)
    vn, f_mom = _momentum_flux(rho_s, vel_s, p_s, dm)
    f_mass = rho_s * vn * dm.area
    f_E = (E_s + p_s) * vn * dm.area

    inv_v = 1.0 / dm.volumes
    rho = state["Density"] - dt * inv_v * _cell_reduce(dm, f_mass)
    mom = (state["Density"][:, None] * state["Velocity"]
           - dt * inv_v[:, None] * _cell_reduce(dm, f_mom))
    E = state["TotalEnergyDensity"] - dt * inv_v * _cell_reduce(dm, f_E)

    rho = torch.clamp(rho, min=1e-8)
    vel = mom / rho[:, None]
    e_int = torch.clamp(E - 0.5 * rho * torch.sum(vel ** 2, dim=-1),
                        min=1e-10)
    return {"Density": rho, "Velocity": vel,
            "Pressure": (gas.gamma - 1.0) * e_int, "TotalEnergyDensity": E}


def compressible_step(state, dm: DeviceMesh, gas, far: FarField, dt,
                      ghost_override=None, t=0.0):
    """One conservative ideal-gas step with HLLC face fluxes.
    `ghost_override(l, r, dm, t) -> r` replaces the default boundary ghost
    states entirely (the double Mach reflection's mixed, time-dependent
    boundaries)."""
    left, right = compressible_face_states(state, dm, far, gas)
    if ghost_override is not None:
        right = ghost_override(left, right, dm, t)
    return _compressible_update(state, dm, gas, dt, left, right)


# ---------------------------------------------------------------------------
# MUSCL reconstruction (second order): Green-Gauss cell gradients and
# Barth-Jespersen limiting, for sharp shocks.  2D only, as in the JAX
# package.
# ---------------------------------------------------------------------------

def _not_dummy(dm: DeviceMesh):
    """(C, K) True where the slot holds a real face."""
    return dm.cell_faces < dm.n_faces


def green_gauss_gradient(q, dm: DeviceMesh):
    """(C,) -> (C, d): (1/V) sum_f q_face n_out A with the arithmetic face
    average (a boundary face takes the owner's value)."""
    q_f = 0.5 * (q[dm.owner] + q[dm.neigh])
    q_f = torch.where(dm.interior, q_f, q[dm.owner])
    flux = q_f[:, None] * dm.normal * dm.area[:, None]
    return _cell_reduce(dm, flux) / dm.volumes[:, None]


def _neighbor_minmax(q, dm: DeviceMesh):
    """Per cell: min / max of q over itself and its face neighbours."""
    f = dm.cell_faces
    other = torch.where(dm.cell_sign > 0, q[dm.neigh[f]], q[dm.owner[f]])
    other = torch.where(_not_dummy(dm), other, q[:, None])   # dummy: self
    q_min = torch.minimum(q, torch.amin(other, dim=1))
    q_max = torch.maximum(q, torch.amax(other, dim=1))
    return q_min, q_max


def barth_jespersen_limiter(q, grad, dm: DeviceMesh):
    """(C,) limiter psi in [0, 1]: the reconstructed face values stay
    within the neighbourhood's [min, max]."""
    q_min, q_max = _neighbor_minmax(q, dm)
    f = dm.cell_faces
    d_cf = dm.midpoint[f] - dm.centroids[:, None, :]          # (C, K, d)
    dq = torch.sum(grad[:, None, :] * d_cf, dim=-1)           # (C, K)
    up = torch.where(dq > 0, (q_max - q)[:, None] / torch.clamp(dq, min=TINY),
                     1.0)
    dn = torch.where(dq < 0, (q_min - q)[:, None] / torch.clamp(dq, max=-TINY),
                     1.0)
    psi_f = torch.clamp(torch.minimum(up, dn), max=1.0)
    psi_f = torch.where(_not_dummy(dm), psi_f, 1.0)
    return torch.clamp(torch.amin(psi_f, dim=1), min=0.0)


def muscl_face_values(q, dm: DeviceMesh):
    """The limited linear reconstruction of q at each face from both sides:
    (q_left_at_face, q_right_at_face); a boundary face's right side is the
    owner's reconstruction, replaced by the ghost later."""
    grad = green_gauss_gradient(q, dm)
    psi = barth_jespersen_limiter(q, grad, dm)
    lim_grad = psi[:, None] * grad
    d_l = dm.midpoint - dm.centroids[dm.owner]
    d_r = dm.midpoint - dm.centroids[dm.neigh]
    q_l = q[dm.owner] + torch.sum(lim_grad[dm.owner] * d_l, dim=-1)
    q_r = q[dm.neigh] + torch.sum(lim_grad[dm.neigh] * d_r, dim=-1)
    return q_l, q_r


def compressible_step_muscl(state, dm: DeviceMesh, gas, far: FarField, dt,
                            ghost_override=None, t=0.0):
    """The second-order compressible_step: the primitives (rho, u, v, p)
    MUSCL-reconstructed to the face midpoints before the HLLC flux, the
    boundary ghosts built from the reconstructed owner side.
    `ghost_override` as in compressible_step.  2D only."""
    if dm.dim != 2:
        raise ValueError("compressible_step_muscl is 2D only (it "
                         f"reconstructs u and v), got a {dm.dim}D mesh")
    rho, vel, p = state["Density"], state["Velocity"], state["Pressure"]
    rho_l, rho_r = muscl_face_values(rho, dm)
    p_l, p_r = muscl_face_values(p, dm)
    u_l, u_r = muscl_face_values(vel[:, 0], dm)
    v_l, v_r = muscl_face_values(vel[:, 1], dm)
    vel_l = torch.stack([u_l, v_l], -1)
    vel_r = torch.stack([u_r, v_r], -1)
    # positivity guard on the reconstruction
    rho_l = torch.clamp(rho_l, min=1e-8)
    rho_r = torch.clamp(rho_r, min=1e-8)
    p_l = torch.clamp(p_l, min=1e-10)
    p_r = torch.clamp(p_r, min=1e-10)
    E_l = p_l / (gas.gamma - 1.0) + 0.5 * rho_l * torch.sum(vel_l ** 2, -1)
    E_r = p_r / (gas.gamma - 1.0) + 0.5 * rho_r * torch.sum(vel_r ** 2, -1)

    # the boundary ghosts from the reconstructed left side
    bt, bnd = dm.btype, ~dm.interior
    wall = bnd & ((bt == 3) | (bt == 7))
    farf = bnd & ((bt == 9) | (bt == 5))
    vn = torch.sum(vel_l * dm.normal, dim=-1, keepdim=True)
    vel_r = torch.where(wall[:, None], vel_l - 2.0 * vn * dm.normal, vel_r)
    rho_r = torch.where(wall, rho_l, rho_r)
    p_r = torch.where(wall, p_l, p_r)
    E_r = torch.where(wall, E_l, E_r)
    inflow, v_far = _inflow_faces(farf, far, dm, vel)
    E_far = _far_energy(far, gas, v_far)
    outflow = farf & ~inflow
    vel_r = torch.where(inflow[:, None], v_far[None, :],
                        torch.where(outflow[:, None], vel_l, vel_r))
    rho_r = torch.where(inflow, far.rho, torch.where(outflow, rho_l, rho_r))
    p_r = torch.where(inflow, far.p, torch.where(outflow, p_l, p_r))
    E_r = torch.where(inflow, E_far, torch.where(outflow, E_l, E_r))
    left, right = (rho_l, vel_l, p_l, E_l), (rho_r, vel_r, p_r, E_r)
    if ghost_override is not None:
        right = ghost_override(left, right, dm, t)
    return _compressible_update(state, dm, gas, dt, left, right)
