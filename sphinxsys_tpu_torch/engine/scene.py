"""The generic block-engine runner (counterpart of
sphinxsys_tpu/engine/scene.py) for static-wall free-surface scenes
(dambreak 2D/3D) and wall-less periodic scenes with viscosity and
transport-velocity correction (Taylor–Green).

The dual-criteria loop (SURVEY.md §3.2, reference Dambreak.cpp:166-220):
an outer advection step (advection dt, density summation + the viscous
force and transport-velocity correction where configured, re-slot) around
an inner acoustic loop (two half-steps) that runs while the relaxed time
is below the advection dt.  JAX runs both loops on the device as
`lax.while_loop`s; here they are Python loops, each iteration's condition
read back with one host sync (`bool()` of a 0-d tensor).  time, dt and the
relaxed time stay 0-d tensors in the state's dtype, so the step counts
follow the same float arithmetic as the JAX loops.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from sphinxsys_tpu_torch.device import resolve_device
from sphinxsys_tpu_torch.engine import block_fluid as eng_mod
from sphinxsys_tpu_torch.engine.block_fluid import BlockEngine, WallCtx
from sphinxsys_tpu_torch.neighbors.cell_list import wrap_positions


@dataclasses.dataclass
class BlockSim:
    fluid_b: dict
    nbr_inner: torch.Tensor
    nbr_wall: Any      # None when the scene has no wall body
    time: torch.Tensor
    n_adv: int
    n_ac: int
    overflow: torch.Tensor


@dataclasses.dataclass(frozen=True)
class BlockScene:
    """Scene -> block-engine binding, built by `standard_scene`."""

    base: Any                 # the case (geometry, materials, wall state)
    eng: BlockEngine
    n_fluid: int
    device: torch.device
    wall_b: Any = None        # static wall blocks (built once)
    bm_wall: Any = None
    wall_dense_map: Any = None

    @property
    def fields(self):
        return self.eng.fluid_fields + ("OriginalID",)


def standard_scene(base, *, rho0: float, speed_ref: float, device,
                   dim: int = 2, mu: float = 0.0, tvc_coef: float = 0.0,
                   tvc_limiter: float | None = None, free_surface: bool = True,
                   riemann2=None, wall=None, cap: int = 12,
                   c_max: int | None = None, c_max_multiple: int = 256,
                   use_kernels: bool = True,
                   cap_ac_dt: bool = False) -> BlockScene:
    """Bind a case to the block engine.  `base` provides adaptation, grid,
    eos, riemann and n_fluid; `wall` (a state dict) is slotted once as a
    static contact body, so the sweeps run their static-wall variants.
    `mu` > 0 adds the viscous force, `tvc_coef` > 0 the transport-velocity
    correction; `riemann2` (default: base.riemann) is the 2nd-half solver;
    `cap_ac_dt` caps the acoustic dt by the advection dt.  `c_max_multiple`
    rounds c_max as the JAX package rounds it to its tile width (256 in 2D,
    128 in 3D), so block shapes — and the integer maps — agree with it;
    the wall's c_max rounds to 32."""
    device = resolve_device(device)
    if c_max is None:
        # a free-surface flow occupies a fraction of the domain cells
        # (dambreak max ~n/6 through impact; /5 adds surge margin, guarded
        # by the overflow flag); a confined or periodic box occupies every
        # cell
        c_max = max(base.n_fluid // 5, 512) if free_surface \
            else base.grid.ncells
    c_max = eng_mod.round_to(c_max, c_max_multiple)
    eng = BlockEngine(
        grid=base.grid, kernel=base.kernel, eos=base.eos, riemann1=base.riemann,
        riemann2=base.riemann if riemann2 is None else riemann2,
        rho0=rho0, sigma0=base.adaptation.sigma0, h=base.adaptation.h,
        speed_ref=speed_ref, dim=dim, mu=mu, tvc_coef=tvc_coef,
        tvc_limiter=tvc_limiter, free_surface=free_surface, cap=cap,
        c_max=c_max, cap_ac_dt=cap_ac_dt, wall_static=wall is not None,
        use_kernels=use_kernels)

    wall_b = bm_wall = dm_w = None
    if wall is not None:
        cmw = eng_mod.round_to(max(int(wall["Position"].shape[0]) // 4, 256),
                               32)
        wall = {k: v.to(device) if torch.is_tensor(v) else v
                for k, v in wall.items()}
        wall_b, bm_wall, dm_w = eng_mod.build_wall_blocks(eng, wall, cmw)
    return BlockScene(base=base, eng=eng, n_fluid=base.n_fluid, device=device,
                      wall_b=wall_b, bm_wall=bm_wall, wall_dense_map=dm_w)


def _slot(scene: BlockScene, flat: dict, valid):
    """Re-slot the fluid (wrapped into the box first on its periodic axes)
    and rebuild the window maps."""
    eng = scene.eng
    flat = dict(flat, Position=wrap_positions(flat["Position"], eng.grid))
    fb, bm_f = eng_mod.slot_fluid(eng, flat, valid, n_max=scene.n_fluid)
    nbr_wall = None
    if scene.wall_b is not None:
        nbr_wall = eng_mod.wall_windows(eng, bm_f, scene.bm_wall,
                                        scene.wall_dense_map)
    return fb, bm_f, nbr_wall, bm_f.overflow


def init_sim(scene: BlockScene, fluid: dict, device=None) -> BlockSim:
    """Slot the initial fluid state (a zero ViscousForcePrev is seeded
    where the engine is viscous and the state has none).  `device` defaults
    to the device the scene was built on; another one raises."""
    device = scene.device if device is None else resolve_device(device)
    if device != scene.device:
        raise ValueError(f"scene lives on {scene.device}, not {device}")
    n = fluid["Position"].shape[0]
    flat = {k: fluid[k].to(device) for k in scene.eng.fluid_fields
            if k in fluid}
    if "ViscousForcePrev" in scene.eng.fluid_fields \
            and "ViscousForcePrev" not in flat:
        flat["ViscousForcePrev"] = torch.zeros_like(flat["Velocity"])
    flat["OriginalID"] = torch.arange(n, dtype=torch.int32, device=device)
    valid = torch.arange(n, device=device) < int(fluid["NReal"])
    fb, bm_f, nbr_wall, ovf = _slot(scene, flat, valid)
    dtype = fluid["Position"].dtype
    return BlockSim(fluid_b=fb, nbr_inner=bm_f.nbr_block, nbr_wall=nbr_wall,
                    time=torch.zeros((), dtype=dtype, device=device),
                    n_adv=0, n_ac=0, overflow=ovf)


def _wall_ctx(scene: BlockScene, s: BlockSim) -> WallCtx:
    return WallCtx(scene.wall_b, s.nbr_wall)


def _advection_step(scene: BlockScene, s: BlockSim) -> BlockSim:
    eng = scene.eng
    fb = s.fluid_b
    wc = _wall_ctx(scene, s)

    dt_adv = eng_mod.advection_dt(eng, fb)
    fb = eng_mod.advection_prep(eng, fb, s.nbr_inner, wc)

    relax_t = torch.zeros_like(dt_adv)
    n_ac = 0
    while bool(relax_t < dt_adv):          # one host sync per sub-step
        dt = eng_mod.acoustic_dt(eng, fb, dt_adv)
        fb = eng_mod.acoustic_first_half(eng, fb, s.nbr_inner, wc, dt)
        fb = eng_mod.acoustic_second_half(eng, fb, s.nbr_inner, wc, dt)
        relax_t = relax_t + dt
        n_ac += 1

    flat = {k: fb[k].reshape((-1,) + tuple(fb[k].shape[2:]))
            for k in scene.fields}
    valid = fb["SlotMask"].reshape(-1)
    fb2, bm_f, nbr_wall, ovf = _slot(scene, flat, valid)
    return BlockSim(fluid_b=fb2, nbr_inner=bm_f.nbr_block, nbr_wall=nbr_wall,
                    time=s.time + relax_t, n_adv=s.n_adv + 1,
                    n_ac=s.n_ac + n_ac, overflow=s.overflow | ovf)


def make_run_chunk(scene: BlockScene):
    """run_chunk(sim, t_target): advance by advection steps until
    sim.time >= t_target (compared in the time's dtype)."""
    def run_chunk(s: BlockSim, t_target) -> BlockSim:
        target = torch.as_tensor(t_target, dtype=s.time.dtype,
                                 device=s.time.device)
        while bool(s.time < target):
            s = _advection_step(scene, s)
        return s

    return run_chunk


def make_advection_step(scene: BlockScene):
    return lambda s: _advection_step(scene, s)


def blocks_to_particles(scene: BlockScene, s: BlockSim,
                        n: int | None = None) -> dict:
    return eng_mod.blocks_to_particles(scene.eng, s.fluid_b, n or scene.n_fluid)
