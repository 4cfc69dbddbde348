"""Rigid bodies coupled to the particles (counterpart of
sphinxsys_tpu/physics/rigid.py; the reference's Simbody bridge,
simbody_sphinxsys/ and solid_dynamics/constraint_dynamics.h:156-184):
the SPH forces on a body part are reduced onto the rigid state, the rigid
equations are stepped, and the rigid motion is imposed back on the
particles.

  * RigidBody2D: the planar body (x, v, theta, omega; mass, inertia about
    the COM), `total_force_and_torque`, the symplectic-Euler
    `rigid_step`, `constrain_by_rigid_body` (x = COM + R (x0 - COM0),
    v = V + omega x r);
  * RigidBody3D: the free 6-DOF body, attitude a unit quaternion
    (w, x, y, z) and the world-frame angular momentum L; the step takes
    L += torque dt, omega = R I_body^-1 R^T L, dq/dt = 0.5 (0, omega) q,
    and renormalises q;
  * PinJoint2D: the revolute joint about a fixed pivot with a linear
    damper (SimTK::MobilizedBody::Pin with MobilityLinearDamper).

Every field is a tensor on the particles' device.  The rotation matrices
are stacked from the device scalars (no host read), `gravity` may be a
tuple or, to spare a host-to-device copy a call, a tensor built once,
and the 3D body's inverse inertia is the closed form of core/linalg.py.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sphinxsys_tpu_torch.core.linalg import inv
from sphinxsys_tpu_torch.core.state import State


def _gravity(gravity, like):
    return torch.as_tensor(gravity, dtype=like.dtype, device=like.device)


def rotation_2d(theta):
    """[[c, -s], [s, c]] of a 0-d tensor angle, stacked on its device."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s]), torch.stack([s, c])])


def _forces(state: State, mask, force_keys):
    f = torch.zeros_like(state["Position"])
    for k in force_keys:
        f = f + state[k]
    return torch.where(mask[:, None], f, torch.zeros_like(f))


def _impose(state: State, mask, new_pos, new_vel, R) -> State:
    """Masked rows take the rigid position and velocity; the averaged
    wall velocity and the rotated initial normals follow."""
    out = dict(state)
    m = mask[:, None]
    out["Position"] = torch.where(m, new_pos, state["Position"])
    out["Velocity"] = torch.where(m, new_vel, state["Velocity"])
    if "AverageVelocity" in state:
        out["AverageVelocity"] = torch.where(m, new_vel,
                                             state["AverageVelocity"])
    if "NormalDirection" in state and "InitialNormalDirection" in state:
        out["NormalDirection"] = torch.where(
            m, state["InitialNormalDirection"] @ R.T, state["NormalDirection"])
    return out


# ---------------------------------------------------------------------------
# The planar body
# ---------------------------------------------------------------------------

class RigidBody2D(NamedTuple):
    com: torch.Tensor       # (2,)
    vel: torch.Tensor       # (2,)
    theta: torch.Tensor     # ()
    omega: torch.Tensor     # ()
    mass: torch.Tensor      # ()
    inertia: torch.Tensor   # () about the COM


def rigid_body_from_particles(state: State, mask) -> RigidBody2D:
    """Mass, COM and inertia of the masked particles, at rest
    (SolidBodyPartForSimbody, body_part_for_simbody.h:43)."""
    pos = state["Position"]
    m = torch.where(mask, state["Mass"], torch.zeros_like(state["Mass"]))
    total = torch.sum(m)
    com = torch.sum(m[:, None] * pos, dim=0) / total
    r = pos - com
    inertia = torch.sum(m * torch.sum(r * r, dim=-1))
    z = torch.zeros((), dtype=pos.dtype, device=pos.device)
    return RigidBody2D(com=com, vel=torch.zeros_like(com), theta=z, omega=z,
                       mass=total, inertia=inertia)


def total_force_and_torque(state: State, mask, rb: RigidBody2D,
                           force_keys=("Force", "ForcePrior")):
    """The masked particles' forces reduced to a COM force and a torque
    (TotalForceForSimBody, constraint_dynamics.h:170-184)."""
    f = _forces(state, mask, force_keys)
    total_f = torch.sum(f, dim=0)
    r = state["Position"] - rb.com
    t = r[:, 0] * f[:, 1] - r[:, 1] * f[:, 0]
    torque = torch.sum(torch.where(mask, t, torch.zeros_like(t)))
    return total_f, torque


def rigid_step(rb: RigidBody2D, force, torque, dt,
               gravity=None) -> RigidBody2D:
    """Symplectic Euler of the planar rigid equations."""
    acc = force / rb.mass
    if gravity is not None:
        acc = acc + _gravity(gravity, force)
    vel = rb.vel + acc * dt
    com = rb.com + vel * dt
    omega = rb.omega + (torque / rb.inertia) * dt
    theta = rb.theta + omega * dt
    return rb._replace(com=com, vel=vel, theta=theta, omega=omega)


def constrain_by_rigid_body(state: State, mask, rb: RigidBody2D,
                            initial_pos, initial_com) -> State:
    """ConstraintBySimBody::update: x = COM + R(theta) (x0 - COM0),
    v = V + omega x r."""
    R = rotation_2d(rb.theta).to(state["Position"].dtype)
    new_pos = rb.com + (initial_pos - initial_com) @ R.T
    r = new_pos - rb.com
    new_vel = rb.vel + rb.omega * torch.stack([-r[:, 1], r[:, 0]], dim=-1)
    return _impose(state, mask, new_pos, new_vel, R)


# ---------------------------------------------------------------------------
# The 6-DOF body (quaternion attitude)
# ---------------------------------------------------------------------------

class RigidBody3D(NamedTuple):
    com: torch.Tensor           # (3,)
    vel: torch.Tensor           # (3,)
    quat: torch.Tensor          # (4,) unit (w, x, y, z), body -> world
    ang_mom: torch.Tensor       # (3,) world frame
    mass: torch.Tensor          # ()
    inertia_body: torch.Tensor  # (3, 3) about the COM, body frame


def quat_to_matrix(q):
    """The body-to-world rotation of a unit quaternion (w, x, y, z)."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)]),
    ])


def quat_multiply(a, b):
    aw, av = a[0], a[1:]
    bw, bv = b[0], b[1:]
    return torch.cat([(aw * bw - torch.dot(av, bv))[None],
                      aw * bv + bw * av + torch.linalg.cross(av, bv)])


def rigid_body_from_particles_3d(state: State, mask) -> RigidBody3D:
    """Mass, COM and the full inertia tensor of the masked particles
    (SolidBodyPartForSimbody's SimTK::MassProperties), at rest."""
    pos = state["Position"]
    m = torch.where(mask, state["Mass"], torch.zeros_like(state["Mass"]))
    total = torch.sum(m)
    com = torch.sum(m[:, None] * pos, dim=0) / total
    r = pos - com
    r2 = torch.sum(r * r, dim=-1)
    eye = torch.eye(3, dtype=pos.dtype, device=pos.device)
    inertia = torch.sum(m[:, None, None] * (r2[:, None, None] * eye
                                            - r[:, :, None] * r[:, None, :]),
                        dim=0)
    q0 = torch.zeros(4, dtype=pos.dtype, device=pos.device)
    q0[0] = 1.0
    return RigidBody3D(com=com, vel=torch.zeros_like(com), quat=q0,
                       ang_mom=torch.zeros_like(com), mass=total,
                       inertia_body=inertia)


def total_force_and_torque_3d(state: State, mask, rb: RigidBody3D,
                              force_keys=("Force", "ForcePrior")):
    """The masked particles' forces reduced to a COM force and a torque
    vector."""
    f = _forces(state, mask, force_keys)
    total_f = torch.sum(f, dim=0)
    r = state["Position"] - rb.com
    torque = torch.sum(torch.linalg.cross(r, f, dim=-1)
                       * mask[:, None].to(f.dtype), dim=0)
    return total_f, torque


def angular_velocity(rb: RigidBody3D):
    """omega = R I_body^-1 R^T L (world frame)."""
    R = quat_to_matrix(rb.quat)
    return R @ (inv(rb.inertia_body) @ (R.T @ rb.ang_mom))


def rigid_step_3d(rb: RigidBody3D, force, torque, dt,
                  gravity=None) -> RigidBody3D:
    """Symplectic Euler on (v, x) and (L, q): the attitude advances with
    the angular velocity of the already-updated L; q is renormalised."""
    acc = force / rb.mass
    if gravity is not None:
        acc = acc + _gravity(gravity, force)
    vel = rb.vel + acc * dt
    com = rb.com + vel * dt
    L = rb.ang_mom + torque * dt
    omega = angular_velocity(rb._replace(ang_mom=L))
    dq = 0.5 * quat_multiply(torch.cat([torch.zeros_like(omega[:1]), omega]),
                             rb.quat)
    quat = rb.quat + dq * dt
    quat = quat / torch.linalg.vector_norm(quat)
    return rb._replace(com=com, vel=vel, quat=quat, ang_mom=L)


def constrain_by_rigid_body_3d(state: State, mask, rb: RigidBody3D,
                               initial_pos, initial_com) -> State:
    """x = COM + R (x0 - COM0), v = V + omega x r."""
    R = quat_to_matrix(rb.quat).to(state["Position"].dtype)
    new_pos = rb.com + (initial_pos - initial_com) @ R.T
    r = new_pos - rb.com
    omega = angular_velocity(rb)
    new_vel = rb.vel + torch.linalg.cross(omega.expand_as(r), r, dim=-1)
    return _impose(state, mask, new_pos, new_vel, R)


# ---------------------------------------------------------------------------
# The planar pin joint (the OWSC flap, owsc.cpp:151-158)
# ---------------------------------------------------------------------------

class PinJoint2D(NamedTuple):
    pivot: torch.Tensor     # (2,) fixed world anchor
    theta: torch.Tensor     # () rotation about the pivot
    omega: torch.Tensor     # ()
    mass: torch.Tensor      # ()
    inertia: torch.Tensor   # () about the pivot
    com0: torch.Tensor      # (2,) initial COM (the gravity torque's arm)


def pin_joint_from_particles(state: State, mask, pivot) -> PinJoint2D:
    pos = state["Position"]
    pv = torch.as_tensor(pivot, dtype=pos.dtype, device=pos.device)
    m = torch.where(mask, state["Mass"], torch.zeros_like(state["Mass"]))
    total = torch.sum(m)
    com = torch.sum(m[:, None] * pos, dim=0) / total
    r = pos - pv
    inertia = torch.sum(m * torch.sum(r * r, dim=-1))
    z = torch.zeros((), dtype=pos.dtype, device=pos.device)
    return PinJoint2D(pivot=pv, theta=z, omega=z, mass=total,
                      inertia=inertia, com0=com)


def pin_torque(state: State, mask, pj: PinJoint2D,
               force_keys=("Force", "ForcePrior")):
    """The torque of the masked particles' forces about the pivot."""
    f = _forces(state, mask, force_keys)
    r = state["Position"] - pj.pivot
    return torch.sum(r[:, 0] * f[:, 1] - r[:, 1] * f[:, 0])


def pin_joint_step(pj: PinJoint2D, torque, dt, damping: float = 0.0,
                   stiffness: float = 0.0, gravity=None) -> PinJoint2D:
    """Symplectic Euler of I_pivot domega/dt = tau - c omega - k theta
    (+ the gravity torque about the pivot); c is the power take-off
    (MobilityLinearDamper)."""
    tau = torque - damping * pj.omega - stiffness * pj.theta
    if gravity is not None:
        g = _gravity(gravity, pj.pivot)
        R = rotation_2d(pj.theta).to(pj.pivot.dtype)
        com = pj.pivot + R @ (pj.com0 - pj.pivot)
        r = com - pj.pivot
        tau = tau + pj.mass * (r[0] * g[1] - r[1] * g[0])
    omega = pj.omega + tau / pj.inertia * dt
    theta = pj.theta + omega * dt
    return pj._replace(theta=theta, omega=omega)


def constrain_by_pin_joint(state: State, mask, pj: PinJoint2D,
                           initial_pos) -> State:
    """x = pivot + R(theta) (x0 - pivot), v = omega x r."""
    R = rotation_2d(pj.theta).to(state["Position"].dtype)
    new_pos = pj.pivot + (initial_pos - pj.pivot) @ R.T
    r = new_pos - pj.pivot
    new_vel = pj.omega * torch.stack([-r[:, 1], r[:, 0]], dim=-1)
    return _impose(state, mask, new_pos, new_vel, R)
