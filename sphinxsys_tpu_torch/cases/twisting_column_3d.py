"""3D twisting column, a total-Lagrangian solid (counterpart of
sphinxsys_tpu/cases/twisting_column_3d.py; reference
tests/3d_examples/test_3d_twisting_column/twisting_column.cpp): a 6x1x1
Neo-Hookean column (rho0 = 1100, E = 1.7e7, nu = 0.45), clamped by a
one-layer holder at x < 0, given an initial twist (angular velocity
-400 sin(pi x / 2L) about the x axis) and left to oscillate; the tip swings
axially between x ~ 3.2 and ~ 9.6 by t = 0.5.

    case, column = build_case(dx=0.0175, engine="lattice")   # 1,133,901 sites
    sim = make_run_chunk(case)(init_sim(case, column), 0.02)

Two engines, the same physics:
  * "gather" (JAX's default): frozen (N, K) neighbour lists of the
    initial lattice (neighbors/neighbor_list.py, physics/solid.py), the
    pair sums torch ops over the gathered slots;
  * "lattice": the stencil path (physics/solid_lattice.py), whose two tap
    sums are the hand kernels L1 / L2.
Each step: the acoustic time step (one host sync a step, in the loop's
time test), the decomposed first half, the holder, the second half.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.materials import NeoHookeanSolid
from sphinxsys_tpu_torch.device import PRODUCTION_DTYPE, resolve_device
from sphinxsys_tpu_torch.neighbors.cell_list import (build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import build_neighbor_list
from sphinxsys_tpu_torch.physics import solid as sd
from sphinxsys_tpu_torch.physics import solid_lattice as sl

PL, PH, PW = 6.0, 1.0, 1.0
DX = PH / 10.0
SL = DX                  # one-layer holder
RHO0 = 1100.0
POISSON = 0.45
YOUNGS = 1.7e7
ANGULAR_0 = -400.0


class SimState(NamedTuple):
    column: Any
    time: torch.Tensor      # 0-d, the state's dtype and device
    n_steps: int


@dataclasses.dataclass(frozen=True)
class TwistingCase:
    dx: float
    adaptation: SPHAdaptation
    material: NeoHookeanSolid
    holder_mask: torch.Tensor
    n_column: int
    rp: Any = None                  # sd.ReferencePairs (gather engine)
    lat: Any = None                 # sl.LatticeSolid (lattice engine)
    use_kernels: bool = True

    @property
    def kernel(self):
        return self.adaptation.kernel

    @property
    def engine(self) -> str:
        return "lattice" if self.lat is not None else "gather"


def build_case(dx: float = DX, dtype=PRODUCTION_DTYPE, cell_cap: int = 36,
               k_inner: int = 96, engine: str = "gather", device="cuda",
               use_kernels: bool = True):
    """engine="gather": frozen (N, K) pair lists (`cell_cap` and `k_inner`
    size the cell table and the lists; an overflow raises, since the frozen
    pairs must be exact); engine="lattice": the stencil path, whose tap
    sums `use_kernels=False` takes through their plain versions on any
    device.  Returns (case, column state)."""
    device = resolve_device(device)
    if engine not in ("gather", "lattice"):
        raise ValueError(f"engine={engine!r}: 'gather' or 'lattice'")
    adaptation = SPHAdaptation(spacing=dx, dim=3)
    material = NeoHookeanSolid(rho0=RHO0, youngs_modulus=YOUNGS,
                               poisson_ratio=POISSON)

    # lattice covering the column + holder (twisting_column.cpp:20-23)
    xs = np.arange(-SL + dx / 2, PL, dx)
    ys = np.arange(-PH / 2 + dx / 2, PH / 2, dx)
    zs = np.arange(-PW / 2 + dx / 2, PW / 2, dx)
    pos = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), -1).reshape(-1, 3)
    lat_shape = (len(xs), len(ys), len(zs))

    column = sd.make_elastic_solid_state(pos, dx ** 3, material, dtype, device)
    # initial twist (InitialCondition, twisting_column.cpp:53-68)
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    omega = ANGULAR_0 * np.sin(math.pi * x / (2.0 * PL))
    radius = np.sqrt(y * y + z * z)
    ang = np.arctan2(y, z)
    vel = np.zeros_like(pos)
    active = x > 0.0
    vel[:, 1] = np.where(active, omega * radius * np.cos(ang), 0.0)
    vel[:, 2] = np.where(active, -omega * radius * np.sin(ang), 0.0)
    column["Velocity"] = torch.as_tensor(vel, dtype=dtype, device=device)
    holder_mask = torch.as_tensor(x < 0.0, device=device)

    if engine == "lattice":
        lat = sl.make_lattice(adaptation.kernel, dx, lat_shape)
        column["LatticeValid"] = torch.ones(len(pos), dtype=torch.bool,
                                            device=device)
        column["LinearGradientCorrectionMatrix"] = sl.lattice_correction_matrix(
            lat, column["LatticeValid"], dtype=torch.float64).to(dtype)
        return TwistingCase(dx=dx, adaptation=adaptation, material=material,
                            holder_mask=holder_mask, n_column=len(pos),
                            lat=lat, use_kernels=use_kernels), column

    grid = grid_from_bounds((-SL - 4 * dx, -PH, -PW), (PL + 4 * dx, PH, PW),
                            adaptation.cutoff)
    p0, n = column["Position"], column["NReal"]
    table = build_cell_table(p0, n, grid, cell_cap)
    nl = build_neighbor_list(p0, n, p0, n, table, grid, adaptation.cutoff,
                             k_max=k_inner, include_self=False)
    if bool(nl.overflow):
        raise ValueError(f"k_inner={k_inner} / cell_cap={cell_cap} overflow: "
                         "the frozen pairs must be exact")
    rp = sd.freeze_reference_pairs(p0, nl, adaptation.kernel, 3)
    column["LinearGradientCorrectionMatrix"] = \
        sd.linear_gradient_correction_matrix(rp, column["VolumetricMeasure"])
    return TwistingCase(dx=dx, adaptation=adaptation, material=material,
                        holder_mask=holder_mask, n_column=len(pos), rp=rp,
                        use_kernels=use_kernels), column


def init_sim(case: TwistingCase, column: dict) -> SimState:
    return SimState(column=column,
                    time=column["Position"].new_zeros(()), n_steps=0)


def _step(case: TwistingCase, s: SimState) -> SimState:
    col = s.column
    dt = sd.solid_acoustic_time_step(col, case.material.sound_speed,
                                     case.adaptation.h, cfl=0.5)
    if case.lat is not None:
        col = sl.decomposed_integration_1st_half_lattice(
            col, case.lat, case.material, dt, case.adaptation.h,
            use_kernels=case.use_kernels)
        col = sd.fix_constraint(col, case.holder_mask)
        col = sl.integration_2nd_half_lattice(col, case.lat, dt,
                                              use_kernels=case.use_kernels)
    else:
        col = sd.decomposed_integration_1st_half(
            col, case.rp, case.material, dt, case.adaptation.h)
        col = sd.fix_constraint(col, case.holder_mask)
        col = sd.integration_2nd_half(col, case.rp, dt)
    return SimState(column=col, time=s.time + dt, n_steps=s.n_steps + 1)


def make_run_chunk(case: TwistingCase):
    """run_chunk(sim, t_target): step until sim.time >= t_target (compared
    in the time's dtype; one host sync a step)."""
    def run_chunk(s: SimState, t_target) -> SimState:
        target = torch.as_tensor(t_target, dtype=s.time.dtype,
                                 device=s.time.device)
        while bool(s.time < target):
            s = _step(case, s)
        return s

    return run_chunk


def tip_observer(case: TwistingCase, column: dict):
    """Frozen-weight observer at (PL, 0, 0) (twisting_column.cpp:89):
    (site indices, normalised W * V weights) on the column's device."""
    tip = np.asarray([PL, 0.0, 0.0])
    dtype, dev = column["Position"].dtype, column["Position"].device
    pos0 = column["InitialPosition"].cpu().numpy()
    r = np.linalg.norm(pos0 - tip, axis=1)
    idx = np.nonzero(r < case.adaptation.cutoff)[0]
    w = np.asarray([float(case.kernel.W(torch.as_tensor(ri, dtype=dtype), 3))
                    for ri in r[idx]])
    w = w * column["VolumetricMeasure"].cpu().numpy()[idx]
    return (torch.as_tensor(idx, device=dev),
            torch.as_tensor(w / (w.sum() + 1e-15), dtype=dtype, device=dev))


def observe_tip(s: SimState, idx, weights) -> np.ndarray:
    return torch.sum(s.column["Position"][idx] * weights[:, None],
                     dim=0).cpu().numpy()
