"""Case-agnostic cell-block WCSPH engine (counterpart of
sphinxsys_tpu/engine/block_fluid.py):

  * `BlockEngine` — the static configuration;
  * `slot_fluid` — (re-)slot flat particle fields into fresh cell blocks;
  * `build_wall_blocks` / `wall_windows` — a wall-type contact body: a
    static wall, slotted once, or a moving one (an FSI solid seen as a
    wall), slotted every advection step and refreshed in its fixed slots
    (`refresh_wall_blocks`) every acoustic sub-step;
  * `advection_prep` — density summation (+ viscous force + transport-
    velocity correction, as configured);
  * `acoustic_first_half` / `acoustic_second_half` — the two half-step
    pressure/density relaxations.

`use_kernels=True` (the default) takes the pair sums through
ops/block_sweeps.py (the CUDA kernels on the card, their plain versions on
the CPU); False runs the `*_b` block forms, the float64 oracle.  The
grid's periodic axes give the sweeps their minimum-image box.  The JAX
engine's TPU workarounds (tile_c, window and wall chunking, wall
compaction, roll_y, the packed wall tensor of `make_wall_ctx`) have no
counterpart: the kernels read neighbour blocks through the window maps
directly, so the wall context is the wall's block state and its window
map, static or moving alike.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from sphinxsys_tpu_torch.core.state import FAR_AWAY
from sphinxsys_tpu_torch.neighbors.cell_blocks import (
    build_block_map, cross_neighbor_blocks, dense_cell_map, to_blocks,
)
from sphinxsys_tpu_torch.physics import fluid_blocks as fbops

# block-field fill values for padding slots: Vol = 0 keeps padding inert
BASE_FILLS = {"Position": FAR_AWAY, "Mass": 1.0, "VolumetricMeasure": 0.0}

FLUID_FIELDS = ("Position", "Velocity", "Density", "Mass",
                "VolumetricMeasure", "Pressure", "DensityChangeRate",
                "Force", "ForcePrior", "DensitySummation")

WALL_FIELDS = ("Position", "VolumetricMeasure", "AverageVelocity",
               "AverageAcceleration", "NormalDirection")

INT32_MAX = 2 ** 31 - 1


class WallCtx(NamedTuple):
    """A wall-type contact body as the fluid sweeps see it: its block state
    (None: no wall) and the (C_fluid, 3^dim) window rows into it."""

    wall_b: Any
    nbr_wall: Any


@dataclasses.dataclass(frozen=True)
class BlockEngine:
    """Static engine configuration."""

    grid: Any                 # CellGrid (shared by fluid and wall bodies)
    kernel: Any
    eos: Any
    riemann1: Any             # 1st-half (pressure) Riemann solver
    riemann2: Any             # 2nd-half (density) Riemann solver
    rho0: float
    sigma0: float
    h: float
    speed_ref: float
    dim: int = 2
    mu: float = 0.0           # Newtonian viscosity (0: no viscous force)
    tvc_coef: float = 0.0     # transport-velocity correction (0: off)
    tvc_limiter: float | None = None
    free_surface: bool = True
    cap: int = 12
    c_max: int = 0            # occupied-cell capacity
    cap_ac_dt: bool = False   # cap the acoustic dt by the advection dt
    wall_static: bool = False  # fixed walls: the sweeps drop the wall
                               # velocity/acceleration channels
    use_kernels: bool = True

    @property
    def box(self):
        return self.grid.periodic_lengths

    @property
    def fluid_fields(self):
        return FLUID_FIELDS + (("ViscousForcePrev",) if self.mu > 0.0 else ())

    @property
    def fills(self):
        return dict(BASE_FILLS, Density=self.rho0, OriginalID=INT32_MAX)


def _slot_mask_2d(bm):
    m = bm.slot_mask.reshape(bm.c_max, bm.cap)
    return torch.cat([m, torch.zeros((1, bm.cap), dtype=torch.bool,
                                     device=m.device)], dim=0)


def slot_fluid(eng: BlockEngine, flat: dict, valid, n_max: int | None = None):
    """(Re-)slot flat per-particle (or per-slot) arrays into fresh blocks.
    Returns (fb, bm): the block state with SlotMask, and the BlockMap.
    Pass n_max = the particle capacity when re-slotting slot arrays.

    The JAX package carries the field columns through the sort, cast to
    the float dtype; here every field is gathered through the slot
    permutation, which gives the same slotted values (and keeps
    OriginalID an exact integer at any size)."""
    bm = build_block_map(flat["Position"], valid, eng.grid, cap=eng.cap,
                         c_max=eng.c_max, n_max=n_max)
    fills = eng.fills
    fb = {k: to_blocks(bm, v, fill=fills.get(k, 0.0)) for k, v in flat.items()}
    fb["SlotMask"] = _slot_mask_2d(bm)
    return fb, bm


def build_wall_blocks(eng: BlockEngine, wall_state: dict, c_max_wall: int,
                      valid=None):
    """Slot a wall-type contact body into blocks on the engine grid.
    `valid`: a (N,) bool mask of the rows to slot (default: the first
    NReal).  Returns (wall_b, bm_wall, dense_map).  A moving wall-type
    body is slotted once per advection step, then refreshed in those
    slots by `refresh_wall_blocks` every acoustic sub-step."""
    if valid is None:
        valid = int(wall_state["NReal"])
    bm = build_block_map(wall_state["Position"], valid, eng.grid,
                         cap=eng.cap, c_max=c_max_wall)
    wall_b = {k: to_blocks(bm, wall_state[k], fill=BASE_FILLS.get(k, 0.0))
              for k in WALL_FIELDS}
    wall_b["SlotMask"] = _slot_mask_2d(bm)
    dm = dense_cell_map(bm.occ_cells, eng.grid.ncells, bm.c_max)
    return wall_b, bm, dm


def refresh_wall_blocks(bm_wall, wall_state: dict, wall_b: dict):
    """Re-gather a moving wall's changing channels (position, averaged
    kinematics, normals) into the fixed slots of its block map: the slots
    freeze per advection step, the kinematics change per acoustic
    sub-step."""
    out = dict(wall_b)
    for k in ("Position", "AverageVelocity", "AverageAcceleration",
              "NormalDirection"):
        out[k] = to_blocks(bm_wall, wall_state[k], fill=BASE_FILLS.get(k, 0.0))
    return out


def wall_windows(eng: BlockEngine, bm_fluid, bm_wall, wall_dense_map):
    """(C_fluid, 3^dim) window block rows into the wall body's blocks."""
    return cross_neighbor_blocks(bm_fluid.occ_cells, eng.grid, bm_wall,
                                 src_dense_map=wall_dense_map)


def advection_prep(eng: BlockEngine, fb, nbr_inner, wc: WallCtx):
    """Density summation, then the viscous force and the transport-velocity
    correction where configured — the per-advection-step prep stage of the
    dual-criteria loop."""
    if eng.use_kernels:
        fb = fbops.density_summation_p2(
            fb, nbr_inner, wc.wall_b, wc.nbr_wall, eng.kernel, eng.rho0,
            eng.sigma0, eng.dim, free_surface=eng.free_surface, box=eng.box)
        if eng.mu > 0.0 or eng.tvc_coef > 0.0:
            fb = fbops.visc_tvc_p2(
                fb, nbr_inner, wc.wall_b, wc.nbr_wall, eng.kernel, eng.dim,
                eng.mu, eng.h, tvc_coefficient=eng.tvc_coef,
                tvc_limiter_slope=eng.tvc_limiter, wall_static=eng.wall_static,
                box=eng.box)
        return fb
    fb = fbops.density_summation_b(
        fb, nbr_inner, eng.kernel, eng.dim, eng.rho0, eng.sigma0,
        wall_b=wc.wall_b, nbr_wall=wc.nbr_wall, free_surface=eng.free_surface,
        box=eng.box)
    if eng.mu > 0.0:
        fb = fbops.viscous_force_b(fb, nbr_inner, eng.kernel, eng.dim, eng.mu,
                                   eng.h, wall_b=wc.wall_b,
                                   nbr_wall=wc.nbr_wall, box=eng.box)
    if eng.tvc_coef > 0.0:
        fb = fbops.transport_velocity_correction_b(
            fb, nbr_inner, eng.kernel, eng.dim, eng.h,
            coefficient=eng.tvc_coef, limiter_slope=eng.tvc_limiter,
            wall_b=wc.wall_b, nbr_wall=wc.nbr_wall, box=eng.box)
    return fb


def advection_dt(eng: BlockEngine, fb):
    if eng.mu > 0.0:
        return fbops.advection_viscous_time_step_b(fb, eng.h, eng.speed_ref,
                                                   eng.rho0, eng.mu)
    return fbops.advection_time_step_b(fb, eng.h, eng.speed_ref)


def acoustic_dt(eng: BlockEngine, fb, dt_adv=None):
    dt = fbops.acoustic_time_step_b(fb, eng.eos, eng.h)
    if eng.cap_ac_dt and dt_adv is not None:
        dt = torch.minimum(dt, dt_adv)
    return dt


def acoustic_first_half(eng: BlockEngine, fb, nbr_inner, wc: WallCtx, dt):
    """1st half (pressure relaxation)."""
    if eng.use_kernels:
        return fbops.acoustic_step_1st_half_p2(
            fb, nbr_inner, wc.wall_b, wc.nbr_wall, eng.kernel, eng.eos,
            eng.riemann1, dt, eng.dim, wall_static=eng.wall_static, box=eng.box)
    return fbops.acoustic_step_1st_half_b(
        fb, nbr_inner, eng.kernel, eng.dim, eng.eos, eng.riemann1, dt,
        wall_b=wc.wall_b, nbr_wall=wc.nbr_wall, box=eng.box)


def acoustic_second_half(eng: BlockEngine, fb, nbr_inner, wc: WallCtx, dt):
    """2nd half (density relaxation)."""
    if eng.use_kernels:
        return fbops.acoustic_step_2nd_half_p2(
            fb, nbr_inner, wc.wall_b, wc.nbr_wall, eng.kernel, eng.riemann2,
            dt, eng.dim, wall_static=eng.wall_static, box=eng.box)
    return fbops.acoustic_step_2nd_half_b(
        fb, nbr_inner, eng.kernel, eng.dim, eng.riemann2, dt,
        wall_b=wc.wall_b, nbr_wall=wc.nbr_wall, box=eng.box)


def blocks_to_particles(eng: BlockEngine, fb, n: int) -> dict:
    """Recover per-particle arrays (by OriginalID) for IO and observation."""
    ids = fb["OriginalID"].reshape(-1).long()
    mask = fb["SlotMask"].reshape(-1)
    tgt = torch.where(mask, torch.clamp(ids, max=n - 1),
                      torch.full_like(ids, n))
    out = {}
    for k in eng.fluid_fields:
        flat = fb[k].reshape((-1,) + tuple(fb[k].shape[2:]))
        arr = torch.zeros((n + 1,) + tuple(flat.shape[1:]), dtype=flat.dtype,
                          device=flat.device)
        arr[tgt] = flat        # padding slots all land on the dropped row n
        out[k] = arr[:n]
    out["NReal"] = n
    return out


def round_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
