"""Triple-pendulum multibody play case (counterpart of
sphinxsys_tpu/cases/play_simbody_3d.py; reference tests/3d_examples/
test_3d_play_simbody/play_simbody.cpp): three identical links (mass 1,
unit inertia, COM at the body origin) chained by pins, the joint at
(0, -1, 0) in each parent's frame and (0, 1, 0) in the child's, all three
angles PRESCRIBED by ramped sinusoids (UdfMotion.h), gravity off
(play_simbody.cpp:22).  Ten unit-time steps of RK4 sub-steps, the state
written to step-indexed XML snapshots each step, restartable from any
saved step (play_simbody.cpp:51-68).

The tree asks for float64, as the JAX package's does; the JAX package's
CLI runs with x64 off and so computes in float32, the port in float64 on
any device.  JAX's fori_loop of sub-steps is a Python loop here.

    s = run_case("/tmp/out", device="cpu")          # 10 XML snapshots
    s = run_case("/tmp/out", restart_step=5, device="cpu")
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sphinxsys_tpu_torch.device import resolve_device, resolve_dtype
from sphinxsys_tpu_torch.physics import articulated as art

N_LINKS = 3
NUM_STEPS = 10           # play_simbody.cpp:63
DT = 0.05                # RK4 sub-step; the reference's RKM is adaptive
PI = math.pi


def build_tree(dtype=torch.float64, device="cuda") -> art.ArticulatedTree:
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    n = N_LINKS
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    return art.ArticulatedTree(
        parent=np.arange(-1, n - 1),
        axis=t([0.0, 0.0, 1.0]).repeat(n, 1),
        r_parent=t([0.0, -1.0, 0.0]).repeat(n, 1),
        r_child=t([0.0, 1.0, 0.0]).repeat(n, 1),
        mass=torch.ones(n, dtype=dtype, device=device),
        inertia=torch.eye(3, dtype=dtype, device=device).repeat(n, 1, 1),
        com=torch.zeros((n, 3), dtype=dtype, device=device),
    )


def build_motions() -> art.MotionSet:
    """play_simbody.cpp:34-44 motion parameters."""
    return art.MotionSet.build([
        art.sinusoid_motion(PI / 40.0, 10.0, 2.0 * PI, 0.0),
        art.sinusoid_motion(PI / 30.0, 10.0, 2.0 * PI, -0.5 * PI),
        art.sinusoid_motion(PI / 20.0, 10.0, 2.0 * PI, -0.8 * PI),
    ])


@dataclasses.dataclass
class SimState:
    t: torch.Tensor
    q: torch.Tensor
    u: torch.Tensor


def init_sim(tree: art.ArticulatedTree) -> SimState:
    """The pendulum at rest at t = 0, in the tree's dtype and device."""
    z = torch.zeros(N_LINKS, dtype=tree.axis.dtype, device=tree.axis.device)
    return SimState(t=torch.zeros((), dtype=z.dtype, device=z.device),
                    q=z, u=z)


def make_run_step(tree: art.ArticulatedTree, motions: art.MotionSet):
    """Advance one unit-time step (ts.stepTo(step) analog) with fixed-dt
    RK4 sub-steps."""
    step = art.make_articulated_step(tree, gravity=(0.0, 0.0, 0.0),
                                     motions=motions)
    n_sub = int(round(1.0 / DT))

    def run(s: SimState) -> SimState:
        t, q, u = s.t, s.q, s.u
        dt = torch.as_tensor(DT, dtype=q.dtype, device=q.device)
        tau = torch.zeros_like(q)
        for _ in range(n_sub):
            q, u = step(t, q, u, dt, tau)
            t = t + DT
        return SimState(t=t, q=q, u=u)

    return run


def run_case(output_dir: str, restart_step: int = 0,
             device="cuda") -> SimState:
    """The reference main loop: step to each integer time and write the
    state snapshot; on restart, read the saved state and continue."""
    tree = build_tree(device=device)
    run = make_run_step(tree, build_motions())
    if restart_step:
        t, q, u = art.read_state_xml(output_dir, restart_step)
        as_t = lambda v: torch.as_tensor(v, dtype=tree.axis.dtype,
                                         device=tree.axis.device)
        s = SimState(t=as_t(t), q=as_t(q), u=as_t(u))
    else:
        s = init_sim(tree)
    for step_i in range(restart_step + 1, NUM_STEPS + 1):
        s = run(s)
        art.write_state_xml(output_dir, step_i, s.t, s.q, s.u)
    return s
