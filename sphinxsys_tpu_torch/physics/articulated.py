"""Articulated rigid multibody trees, the Simbody mobilized-body analog
(counterpart of sphinxsys_tpu/physics/articulated.py; reference
src/shared/simbody_sphinxsys/ and tests/3d_examples/test_3d_play_simbody/
play_simbody.cpp).

Autodiff Lagrangian dynamics, as in the JAX package:

  * forward kinematics is an unrolled traversal over the (static) tree in
    topological order;
  * the mass matrix is the exact Hessian of the kinetic energy in the
    joint rates, M(q) = d^2 T / du^2 (T is quadratic in u);
  * M udot = tau - (dG/dq) u + dT/dq - dV/dq, G := dT/du, every
    derivative by torch.func (JAX's jax.hessian / jax.jacobian /
    jax.grad become torch.func.hessian / jacrev / grad).

Prescribed motions are plain time functions whose rates and
accelerations are torch.func.grad's of the position function; prescribed
DOFs are eliminated block-wise: M_ff udot_f = rhs_f - M_fp udot_p.

Everything a transform traces is out of place (torch.stack, index_put,
torch.where), and the linear solve is torch.linalg.solve_ex without its
error check, so a step on the card reads nothing back to the host.  The
index sets of a MotionSet are moved to the card once per device.

The XML state channel mirrors SimbodyStateEngine (state_engine.h:55):
step-indexed snapshots of (t, q, u), byte for byte the JAX package's.
"""

from __future__ import annotations

import functools
import os
import xml.etree.ElementTree as ET
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.func import grad, hessian, jacrev


class ArticulatedTree(NamedTuple):
    """A tree of pin- or slider-mobilized rigid links (the JAX package's
    ArticulatedTree): link i attaches to ``parent[i]`` (-1 = ground)
    through a joint at station ``r_parent`` in the parent's frame and
    ``r_child`` in its own, about (pin) or along (slider) ``axis``.
    ``parent`` and ``joint_type`` are static; the rest are tensors of one
    dtype and device."""
    parent: np.ndarray        # (n,) int, parent[i] < i, -1 = ground
    axis: torch.Tensor        # (n, 3) unit joint axes
    r_parent: torch.Tensor    # (n, 3) joint station in parent frame
    r_child: torch.Tensor     # (n, 3) joint station in child frame
    mass: torch.Tensor        # (n,)
    inertia: torch.Tensor     # (n, 3, 3) about the body COM, body frame
    com: torch.Tensor         # (n, 3) COM station in body frame
    joint_type: tuple = ()    # static; () = all pins

    @property
    def n_links(self) -> int:
        return len(self.parent)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _rot_axis_angle(axis, q):
    """Rodrigues rotation about a unit axis (3, 3)."""
    c, s = torch.cos(q), torch.sin(q)
    z = torch.zeros((), dtype=axis.dtype, device=axis.device)
    K = torch.stack([torch.stack([z, -axis[2], axis[1]]),
                     torch.stack([axis[2], z, -axis[0]]),
                     torch.stack([-axis[1], axis[0], z])])
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    return eye + s * K + (1.0 - c) * (K @ K)


class LinkKinematics(NamedTuple):
    R: torch.Tensor       # (n, 3, 3) body->world rotations
    p: torch.Tensor       # (n, 3) body-frame origins in world
    v: torch.Tensor       # (n, 3) origin velocities
    w: torch.Tensor       # (n, 3) angular velocities
    c: torch.Tensor       # (n, 3) world COM positions
    vc: torch.Tensor      # (n, 3) world COM velocities


def forward_kinematics(tree: ArticulatedTree, q, u) -> LinkKinematics:
    """World frames and velocities of every link: a Python loop over the
    static topology, no data-dependent control flow."""
    dtype, device = tree.axis.dtype, tree.axis.device
    eye = torch.eye(3, dtype=dtype, device=device)
    zero = torch.zeros(3, dtype=dtype, device=device)
    Rs, ps, vs, ws = [], [], [], []
    for i in range(tree.n_links):
        pi = int(tree.parent[i])
        if pi < 0:
            R_p, p_p, v_p, w_p = eye, zero, zero, zero
        else:
            R_p, p_p, v_p, w_p = Rs[pi], ps[pi], vs[pi], ws[pi]
        a_w = R_p @ tree.axis[i]
        slider = bool(tree.joint_type) and tree.joint_type[i] == "slider"
        if slider:
            R_i = R_p
            rp_w = R_p @ tree.r_parent[i] + q[i] * a_w
            rc_w = R_i @ tree.r_child[i]
            p_i = p_p + rp_w - rc_w
            w_i = w_p
            v_i = v_p + _cross(w_p, rp_w) + u[i] * a_w - _cross(w_i, rc_w)
        else:
            R_i = R_p @ _rot_axis_angle(tree.axis[i], q[i])
            rp_w = R_p @ tree.r_parent[i]
            rc_w = R_i @ tree.r_child[i]
            p_i = p_p + rp_w - rc_w
            w_i = w_p + u[i] * a_w
            v_i = v_p + _cross(w_p, rp_w) - _cross(w_i, rc_w)
        Rs.append(R_i), ps.append(p_i), vs.append(v_i), ws.append(w_i)
    R = torch.stack(Rs)
    p = torch.stack(ps)
    v = torch.stack(vs)
    w = torch.stack(ws)
    c = p + torch.einsum("nij,nj->ni", R, tree.com)
    vc = v + _cross(w, c - p)
    return LinkKinematics(R=R, p=p, v=v, w=w, c=c, vc=vc)


def kinetic_energy(tree: ArticulatedTree, q, u):
    k = forward_kinematics(tree, q, u)
    I_w = torch.einsum("nij,njk,nlk->nil", k.R, tree.inertia, k.R)
    t_lin = 0.5 * torch.sum(tree.mass * torch.sum(k.vc * k.vc, dim=-1))
    t_rot = 0.5 * torch.sum(torch.einsum("ni,nij,nj->n", k.w, I_w, k.w))
    return t_lin + t_rot


def potential_energy(tree: ArticulatedTree, q, gravity):
    k = forward_kinematics(tree, q, torch.zeros_like(q))
    g = torch.as_tensor(gravity, dtype=q.dtype, device=q.device)
    return -torch.sum(tree.mass * (k.c @ g))


def mass_matrix(tree: ArticulatedTree, q):
    """M(q) = d^2 T / du^2, exact (T is quadratic in u)."""
    zero_u = torch.zeros(tree.n_links, dtype=q.dtype, device=q.device)
    return hessian(lambda uu: kinetic_energy(tree, q, uu))(zero_u)


@functools.lru_cache(maxsize=None)
def _index(idx: tuple, device: torch.device):
    """A static index set as a long tensor on `device`, made once."""
    return torch.as_tensor(idx, dtype=torch.long, device=device)


@functools.lru_cache(maxsize=None)
def _one_hot_mask(n: int, idx: tuple, dtype: torch.dtype,
                  device: torch.device):
    m = np.zeros(n, dtype=bool)
    m[np.asarray(idx, int)] = True
    return torch.as_tensor(m, device=device).to(dtype)


def _solve(M, rhs):
    """M x = rhs with no host read of the solver's status."""
    return torch.linalg.solve_ex(M, rhs, check_errors=False)[0]


def forward_dynamics(tree: ArticulatedTree, q, u, tau, gravity,
                     prescribed_udot=None, free_idx=None, pres_idx=None):
    """Joint accelerations from the Euler-Lagrange equation.

    With G(q,u) := dT/du:  M udot = tau - (dG/dq) u + dT/dq - dV/dq.
    If ``pres_idx`` / ``free_idx`` partition the DOFs (static index arrays)
    and ``prescribed_udot`` carries the prescribed accelerations, only the
    free block is solved: M_ff udot_f = rhs_f - M_fp udot_p.  With no free
    DOF the prescribed accelerations are the answer, and nothing else is
    computed (the JAX package's trace drops the same dead terms)."""
    prescribed = pres_idx is not None and len(pres_idx) > 0
    if prescribed and len(free_idx) == 0:
        return prescribed_udot
    T = lambda qq, uu: kinetic_energy(tree, qq, uu)
    M = hessian(lambda uu: T(q, uu))(u)
    dG_dq = jacrev(lambda qq: grad(lambda uu: T(qq, uu))(u))(q)
    dT_dq = grad(lambda qq: T(qq, u))(q)
    dV_dq = grad(lambda qq: potential_energy(tree, qq, gravity))(q)
    rhs = tau - dG_dq @ u + dT_dq - dV_dq
    if not prescribed:
        return _solve(M, rhs)
    free = _index(tuple(int(i) for i in free_idx), u.device)
    pres = _index(tuple(int(i) for i in pres_idx), u.device)
    M_f = M.index_select(0, free)
    M_ff = M_f.index_select(1, free)
    M_fp = M_f.index_select(1, pres)
    rhs_f = rhs.index_select(0, free) - M_fp @ prescribed_udot.index_select(
        0, pres)
    udot = torch.zeros_like(u).index_put((free,), _solve(M_ff, rhs_f))
    mask = _one_hot_mask(len(u), tuple(int(i) for i in pres_idx), u.dtype,
                         u.device)
    return udot + prescribed_udot * mask


def planar_tree(mass: float, inertia_zz: float, origin_w,
                dtype=torch.float32, device="cpu") -> ArticulatedTree:
    """A single rigid body on a Planar mobilizer
    (SimTK::MobilizedBody::Planar, tethered_dead_fish_in_flow.cpp:370):
    massless x/y sliders then a pin about z.  q = (dx, dy, theta) relative
    to the world station ``origin_w``; the body's COM at its frame
    origin."""
    t = functools.partial(torch.as_tensor, dtype=dtype, device=device)
    zeros3 = torch.zeros(3, dtype=dtype, device=device)
    eye_eps = torch.zeros((3, 3), dtype=dtype, device=device)
    izz = t([[0.0, 0, 0], [0, 0.0, 0], [0, 0, inertia_zz]])
    return ArticulatedTree(
        parent=np.asarray([-1, 0, 1]),
        axis=t([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]]),
        r_parent=torch.stack([t(origin_w), zeros3, zeros3]),
        r_child=torch.stack([zeros3, zeros3, zeros3]),
        mass=t([0.0, 0.0, mass]),
        inertia=torch.stack([eye_eps, eye_eps, izz]),
        com=torch.stack([zeros3, zeros3, zeros3]),
        joint_type=("slider", "slider", "pin"))


# ---------------------------------------------------------------------------
# Prescribed motions (SimTK::Motion::Custom analog)
# ---------------------------------------------------------------------------

def sinusoid_motion(amplitude: float, t0: float, rate: float, phase: float
                    ) -> Callable:
    """q(t) = A sin(rate t + phase), quintic-smoothstep-ramped over
    [0, t0] (UdfMotion.h:20-31); its rates are torch.func.grad's."""
    def q_of_t(t):
        s = torch.sin(rate * t + phase) * amplitude
        x = torch.clamp(t / t0, 0.0, 1.0)
        ramp = x ** 3 * (10.0 - 15.0 * x + 6.0 * x * x)
        return s * ramp
    return q_of_t


class MotionSet(NamedTuple):
    """Static per-joint prescribed-motion table."""
    fns: tuple                 # len n; None = free DOF
    pres_idx: np.ndarray       # indices with a motion
    free_idx: np.ndarray       # the rest

    @classmethod
    def build(cls, fns: Sequence[Optional[Callable]]) -> "MotionSet":
        pres = np.asarray([i for i, f in enumerate(fns) if f is not None], int)
        free = np.asarray([i for i, f in enumerate(fns) if f is None], int)
        return cls(fns=tuple(fns), pres_idx=pres, free_idx=free)

    def q_u_udot(self, t, dtype, device=None):
        """Prescribed (q, u, udot) rows at time t (zeros on free DOFs).
        `t` a float or a 0-d tensor (whose device is used when `device`
        is None)."""
        if device is None:
            device = t.device if torch.is_tensor(t) else "cpu"
        tt = torch.as_tensor(t, dtype=dtype, device=device)
        zero = torch.zeros((), dtype=dtype, device=device)
        n = len(self.fns)
        q, u, a = [zero] * n, [zero] * n, [zero] * n
        for i, fn in enumerate(self.fns):
            if fn is None:
                continue
            q[i] = fn(tt)
            u[i] = grad(fn)(tt)
            a[i] = grad(grad(fn))(tt)
        return torch.stack(q), torch.stack(u), torch.stack(a)


def make_articulated_step(tree: ArticulatedTree, gravity,
                          motions: Optional[MotionSet] = None,
                          joint_damping: float = 0.0):
    """RK4 step of (q, u): (t, q, u, dt, tau) -> (q, u), the
    RungeKuttaMerson TimeStepper analog (play_simbody.cpp:60-61) at a
    fixed step.  Prescribed DOFs are overwritten from their motion
    functions at every stage, so they are exact (not integrated)."""
    pres = None if motions is None else tuple(int(i) for i in
                                              motions.pres_idx)

    def impose(t, q, u):
        qp, up, ap = motions.q_u_udot(t, q.dtype, q.device)
        mask = _one_hot_mask(len(q), pres, q.dtype, q.device)
        return q * (1 - mask) + qp * mask, u * (1 - mask) + up * mask, ap

    def deriv(t, q, u, tau):
        tau_eff = tau - joint_damping * u
        if motions is None:
            udot = forward_dynamics(tree, q, u, tau_eff, gravity)
        else:
            q, u, ap = impose(t, q, u)
            udot = forward_dynamics(tree, q, u, tau_eff, gravity,
                                    prescribed_udot=ap,
                                    free_idx=motions.free_idx,
                                    pres_idx=motions.pres_idx)
        return u, udot

    def step(t, q, u, dt, tau):
        k1q, k1u = deriv(t, q, u, tau)
        k2q, k2u = deriv(t + 0.5 * dt, q + 0.5 * dt * k1q,
                         u + 0.5 * dt * k1u, tau)
        k3q, k3u = deriv(t + 0.5 * dt, q + 0.5 * dt * k2q,
                         u + 0.5 * dt * k2u, tau)
        k4q, k4u = deriv(t + dt, q + dt * k3q, u + dt * k3u, tau)
        q = q + dt / 6.0 * (k1q + 2 * k2q + 2 * k3q + k4q)
        u = u + dt / 6.0 * (k1u + 2 * k2u + 2 * k3u + k4u)
        if motions is not None:
            q, u, _ = impose(t + dt, q, u)
        return q, u

    return step


# ---------------------------------------------------------------------------
# SPH coupling
# ---------------------------------------------------------------------------

def generalized_forces(tree: ArticulatedTree, q, forces_w, torques_w):
    """Per-link world forces (at the COM) and torques to joint torques,
    tau = sum_i Jv_i^T F_i + Jw_i^T T_i, both Jacobians by autodiff: Jv
    from the COM positions, Jw from dR/dq via unskew((dR/dq_k) R^T)."""
    def coms(qq):
        return forward_kinematics(tree, qq, torch.zeros_like(qq)).c

    def rots(qq):
        return forward_kinematics(tree, qq, torch.zeros_like(qq)).R

    Jv = jacrev(coms)(q)                                 # (n, 3, ndof)
    tau = torch.einsum("nik,ni->k", Jv, forces_w)
    R = rots(q)
    dR = jacrev(rots)(q)                                 # (n, 3, 3, ndof)
    W = torch.einsum("nijk,nlj->nilk", dR, R)            # skew(Jw col k)
    Jw = torch.stack([W[:, 2, 1, :], W[:, 0, 2, :], W[:, 1, 0, :]], dim=1)
    return tau + torch.einsum("nik,ni->k", Jw, torques_w)


def constrain_by_link(state: dict, mask, kin: LinkKinematics, link: int,
                      initial_station) -> dict:
    """Impose link ``link``'s rigid motion on the particles of ``mask``
    whose body-frame stations are ``initial_station`` (n, 3):
    x = p + R s, v = v_origin + w x (R s)."""
    out = dict(state)
    R, p = kin.R[link], kin.p[link]
    s_w = initial_station @ R.T
    new_pos = p + s_w
    new_vel = kin.v[link] + _cross(kin.w[link].expand_as(s_w), s_w)
    m = mask[:, None]
    out["Position"] = torch.where(m, new_pos, state["Position"])
    out["Velocity"] = torch.where(m, new_vel, state["Velocity"])
    if "AverageVelocity" in state:
        out["AverageVelocity"] = torch.where(m, new_vel,
                                             state["AverageVelocity"])
    return out


# ---------------------------------------------------------------------------
# State engine (SimbodyStateEngine analog, state_engine.h:55)
# ---------------------------------------------------------------------------

def _floats(x):
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x,
                      dtype=np.float64).reshape(-1)


def write_state_xml(output_dir: str, step: int, t, q, u) -> str:
    """Step-indexed XML snapshot of the multibody state
    (SimbodyStateEngine::writeStateToXml analog)."""
    os.makedirs(output_dir, exist_ok=True)
    root = ET.Element("MultibodyState")
    root.set("step", str(int(step)))
    root.set("time", repr(float(_floats(t)[0])))
    root.set("q", " ".join(repr(float(x)) for x in _floats(q)))
    root.set("u", " ".join(repr(float(x)) for x in _floats(u)))
    path = os.path.join(output_dir, f"multibody_state_{int(step):06d}.xml")
    ET.ElementTree(root).write(path)
    return path


def read_state_xml(output_dir: str, step: int):
    """(t, q, u) from a step snapshot (readStateFromXml analog)."""
    path = os.path.join(output_dir, f"multibody_state_{int(step):06d}.xml")
    root = ET.parse(path).getroot()
    t = float(root.get("time"))
    q = np.asarray([float(x) for x in root.get("q").split()])
    u = np.asarray([float(x) for x in root.get("u").split()])
    return t, q, u
