"""2D window-frame heat diffusion, ISO 10077-2:2012 Application 4
(counterpart of sphinxsys_tpu/cases/windows_frame_diffusion_2d.py;
reference tests/2d_examples/test_2d_windows_frame_diffusion_D4/
windows_frame_diffusion_D4.{h,cpp}): a wood frame section with an
insulation panel, EPDM gaskets and air cavities (a conductivity for each
region, LocalIsotropicDiffusion), between the internal and the external
air, two bodies of Robin boundaries:
  * internal: convection 1/0.13 (1/0.20 on the two junction wedges),
    T_infinity = 20 C;
  * external: convection 1/0.04, T_infinity = 0 C.
The cavities' conductivities follow the standard's unventilated-cavity
formula (windows_frame_diffusion_D4.h:31-72).  Phi starts at 10 C and
relaxes to the steady conduction field by t = 0.02; five observers at
x = 0.028.

    case = build_case(dx=0.004, device="cpu")
    sim = make_run_chunk(case)(init_sim(case), 1e-4)
    print(observe_phi(case, sim))
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from sphinxsys_tpu_torch.cases.diffusion_bcs_2d import observer_weights
from sphinxsys_tpu_torch.core import geometry as G
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
from sphinxsys_tpu_torch.core.generators import generate_lattice
from sphinxsys_tpu_torch.device import resolve_device, resolve_dtype
from sphinxsys_tpu_torch.neighbors.cell_list import (build_cell_table,
                                                    grid_from_bounds)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                        build_neighbor_list)
from sphinxsys_tpu_torch.physics import diffusion as dfn
from sphinxsys_tpu_torch.physics import general as gd
from sphinxsys_tpu_torch.solver import chunk_runner

L = 0.3
H = 0.093
DX = 0.001

# conductivities, W/(m K) (windows_frame_diffusion_D4.h:24-29)
C1, C3, C4 = 0.025, 1.57, 2.11
WOOD_COND = 0.13
EPDM_COND = 0.25
PANE_COND = 0.035

# temperatures and convection (h:76-89)
INITIAL_T = 10.0
T_INF_E = 0.0
T_INF_I = 20.0
CONV_E = 1.0 / 0.04
CONV_I = 1.0 / 0.13
CONV_I_DECREASED = 1.0 / 0.20


def _ac_conductivity(b: float, d: float, a: float) -> float:
    """The unventilated air cavity's equivalent conductivity
    (getACConductivity, windows_frame_diffusion_D4.h:31-51)."""
    b_eq = math.sqrt(a * b / d)
    d_eq = math.sqrt(a * d / b)
    ha = C1 / d_eq if b_eq < 0.005 else max(C1 / d_eq, C3)
    hr = C4 * (1.0 - d_eq / b_eq + math.sqrt(1.0 + (d_eq / b_eq) ** 2))
    return d_eq * (ha + hr)


AC1_COND = _ac_conductivity(0.006, 0.054, 0.054 * 0.006)
AC2_COND = _ac_conductivity(0.005, 0.034, 0.034 * 0.005)
AC1_OPEN_COND = 2.0 * _ac_conductivity(0.005, 0.018, 0.018 * 0.005)
DIFF_MAX = max(WOOD_COND, EPDM_COND, PANE_COND,
               AC1_COND, AC2_COND, AC1_OPEN_COND)

# the polygons (windows_frame_diffusion_D4.h:96-301)
STRUCTURE = [(0.0, 0.005), (0.0, 0.071), (0.026, 0.071), (0.026, 0.088),
             (0.11, 0.088), (0.11, 0.051), (0.3, 0.051), (0.3, 0.023),
             (0.11, 0.023), (0.11, 0.005)]
INTERNAL_AIR = [(0.0, 0.071), (0.0, 0.076), (0.009, 0.076), (0.009, 0.093),
                (0.140, 0.093), (0.140, 0.056), (0.3, 0.056), (0.3, 0.051),
                (0.11, 0.051), (0.11, 0.088), (0.026, 0.088), (0.026, 0.071)]
DECREASED_CONV_1 = [(0.009, 0.071), (0.026, 0.088), (0.026, 0.071)]
DECREASED_CONV_2 = [(0.110, 0.051), (0.110, 0.088), (0.140, 0.051)]
EXTERNAL_AIR = [(0.0, 0.0), (0.0, 0.005), (0.110, 0.005), (0.110, 0.023),
                (0.300, 0.023), (0.300, 0.018), (0.115, 0.018), (0.115, 0.0)]
EPDM_1 = [(0.026, 0.071), (0.026, 0.074), (0.042, 0.074), (0.042, 0.071)]
EPDM_2 = [(0.048, 0.020), (0.048, 0.023), (0.063, 0.023), (0.063, 0.020)]
EPDM_3 = [(0.095, 0.051), (0.095, 0.054), (0.11, 0.054), (0.11, 0.051)]
EPDM_4 = [(0.095, 0.020), (0.095, 0.023), (0.11, 0.023), (0.11, 0.020)]
PANEL = [(0.095, 0.023), (0.095, 0.051), (0.3, 0.051), (0.3, 0.023)]
AC_1 = [(0.042, 0.020), (0.042, 0.074), (0.048, 0.074), (0.048, 0.020)]
AC_2 = [(0.090, 0.020), (0.090, 0.054), (0.095, 0.054), (0.095, 0.020)]
AC_OPEN_1 = [(0.063, 0.005), (0.063, 0.023), (0.068, 0.023), (0.068, 0.005)]


@dataclasses.dataclass
class SimState:
    body: dict
    time: torch.Tensor
    n_steps: int


@dataclasses.dataclass(frozen=True)
class WindowsFrameCase:
    dx: float
    adaptation: SPHAdaptation
    dt: float
    body0: Any
    air_in: Any
    air_ex: Any
    nl_inner: NeighborList
    nl_in: NeighborList
    nl_ex: NeighborList
    obs_idx: torch.Tensor
    obs_w: torch.Tensor

    @property
    def kernel(self):
        return self.adaptation.kernel


def _contains(poly, pos) -> np.ndarray:
    return G.Polygon(vertices=tuple(map(tuple, poly))).contains(
        torch.as_tensor(pos, dtype=torch.float64)).numpy()


def observation_points():
    """Five points at x = 0.028 (createObservationPoints, h:403-418)."""
    rng, start = H - 0.02, 0.01
    return [(0.028, start + rng * i / 4.0) for i in range(5)]


def build_case(dx: float = DX, dtype=torch.float64, cell_cap: int = 16,
               k_inner: int = 48, k_contact: int = 32,
               device="cuda") -> WindowsFrameCase:
    """The frame with its conductivities and shape normals at 10 C, the
    two air bodies with their convection coefficients, the frozen lists
    (their overflow checked once, on the host) and the observers."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    frame_shape = G.Polygon(vertices=tuple(STRUCTURE))
    air_in_shape = G.Polygon(vertices=tuple(INTERNAL_AIR))
    air_ex_shape = G.Polygon(vertices=tuple(EXTERNAL_AIR))
    bw = 2.0 * dx
    lo, hi = (-bw, -bw), (L + bw, H + bw)
    pos_b, vol = generate_lattice(frame_shape, lo, hi, dx)
    pos_i, _ = generate_lattice(air_in_shape, lo, hi, dx)
    pos_e, _ = generate_lattice(air_ex_shape, lo, hi, dx)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def mkstate(pos):
        return {"Position": t(pos), "VolumetricMeasure": t(np.full(len(pos),
                                                                   vol)),
                "NReal": len(pos)}

    body = mkstate(pos_b)
    cond = np.full(len(pos_b), WOOD_COND)
    for poly, k in ((EPDM_1, EPDM_COND), (EPDM_2, EPDM_COND),
                    (EPDM_3, EPDM_COND), (EPDM_4, EPDM_COND),
                    (PANEL, PANE_COND), (AC_1, AC1_COND), (AC_2, AC2_COND),
                    (AC_OPEN_1, AC1_OPEN_COND)):
        cond = np.where(_contains(poly, pos_b), k, cond)
    body["ThermalConductivity"] = t(cond)
    body["Phi"] = t(np.full(len(pos_b), INITIAL_T))
    body = gd.normal_direction_from_shape(body, frame_shape)

    air_in = mkstate(pos_i)
    conv = np.full(len(pos_i), CONV_I)
    for poly in (DECREASED_CONV_1, DECREASED_CONV_2):
        conv = np.where(_contains(poly, pos_i), CONV_I_DECREASED, conv)
    air_in["PhiConvection"] = t(conv)
    air_in["Phi"] = t(np.zeros(len(pos_i)))
    air_in = gd.normal_direction_from_shape(air_in, air_in_shape)

    air_ex = mkstate(pos_e)
    air_ex["PhiConvection"] = t(np.full(len(pos_e), CONV_E))
    air_ex["Phi"] = t(np.zeros(len(pos_e)))
    air_ex = gd.normal_direction_from_shape(air_ex, air_ex_shape)

    grid = grid_from_bounds(lo, hi, adaptation.cutoff)
    cutoff = adaptation.cutoff
    nb = body["NReal"]
    tb = build_cell_table(body["Position"], nb, grid, cell_cap)
    nl_inner = build_neighbor_list(body["Position"], nb, body["Position"], nb,
                                   tb, grid, cutoff, k_max=k_inner,
                                   include_self=False)
    lists = []
    for a in (air_in, air_ex):
        ta = build_cell_table(a["Position"], a["NReal"], grid, cell_cap)
        lists.append(build_neighbor_list(body["Position"], nb, a["Position"],
                                         a["NReal"], ta, grid, cutoff,
                                         k_max=k_contact, include_self=True))
    nl_in, nl_ex = lists
    if bool(nl_inner.overflow | nl_in.overflow | nl_ex.overflow):
        raise RuntimeError("windows_frame_diffusion_2d: a neighbour list "
                           "overflows")
    dt = dfn.diffusion_time_step(adaptation.h,
                                 dfn.IsotropicDiffusion(DIFF_MAX), 2)
    obs_idx, obs_w = observer_weights(pos_b, observation_points(),
                                      adaptation.kernel,
                                      np.full(len(pos_b), vol), cutoff)
    return WindowsFrameCase(dx=dx, adaptation=adaptation, dt=dt, body0=body,
                            air_in=air_in, air_ex=air_ex, nl_inner=nl_inner,
                            nl_in=nl_in, nl_ex=nl_ex,
                            obs_idx=torch.as_tensor(obs_idx, device=device),
                            obs_w=t(obs_w))


def init_sim(case: WindowsFrameCase) -> SimState:
    pos = case.body0["Position"]
    return SimState(body=dict(case.body0),
                    time=torch.zeros((), dtype=pos.dtype, device=pos.device),
                    n_steps=0)


def diffusion_step(case: WindowsFrameCase, body: dict) -> dict:
    """One RK2 step with the local conductivity and both Robin bodies."""
    robin = [(case.air_in, case.nl_in, T_INF_I),
             (case.air_ex, case.nl_ex, T_INF_E)]
    return dfn.diffusion_step_local_rk2(
        body, "Phi", case.nl_inner, case.kernel, 2,
        dfn.IsotropicDiffusion(DIFF_MAX), case.dt,
        local_diff="ThermalConductivity", robin_contacts=robin)


def make_advection_step(case: WindowsFrameCase):
    return lambda s: SimState(body=diffusion_step(case, s.body),
                              time=s.time + case.dt, n_steps=s.n_steps + 1)


def make_run_chunk(case: WindowsFrameCase):
    """run_chunk(sim, t_target): steps until sim.time >= t_target."""
    return chunk_runner(make_advection_step(case))


def observe_phi(case: WindowsFrameCase, s: SimState):
    """Phi at the five observers."""
    return torch.sum(s.body["Phi"][case.obs_idx] * case.obs_w, dim=1)
