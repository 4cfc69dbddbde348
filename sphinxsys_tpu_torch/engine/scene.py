"""The generic block-engine runner (counterpart of
sphinxsys_tpu/engine/scene.py), for
  * static-wall free-surface scenes (dambreak 2D/3D),
  * wall-less periodic scenes with viscosity and transport-velocity
    correction (Taylor–Green),
  * moving-wall FSI scenes with solid sub-cycling (fsi2), through `Hooks`
    and a `wall_state_fn`: the wall-type contact body is derived from the
    case's `aux` state, re-slotted every advection step and refreshed in
    its slots every acoustic sub-step.

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
from typing import Any, Callable, NamedTuple

import torch

from sphinxsys_tpu_torch.device import resolve_device
from sphinxsys_tpu_torch.engine import block_fluid as eng_mod
from sphinxsys_tpu_torch.engine.block_fluid import BlockEngine, WallCtx
from sphinxsys_tpu_torch.neighbors.cell_list import wrap_positions
from sphinxsys_tpu_torch.solver import chunk_runner


class Hooks(NamedTuple):
    """Case-specific extension points of the loop, each optional:

    post_prep(fb, aux, time) -> (fb, aux)
        after the density / viscous / transport-velocity prep, once per
        advection step (fsi2: the viscous force on the solid, its normals).
    after_first_half(fb, aux, dt, t_now) -> (fb, aux)
        between the acoustic halves (fsi2: the pressure force on the
        solid, from the mid-step fluid).
    post_acoustic(fb, aux, dt, t_next) -> (fb, aux)
        after the 2nd half, once per acoustic sub-step (fsi2: the solid
        sub-cycling and the inflow).
    post_advection(flat, aux, time) -> (flat, aux)
        on the flat particle arrays just before the re-slot; a "_Valid"
        entry it adds replaces the slot mask.
    rebuild_aux(bm_f, aux) -> aux
        after each re-slot (fsi2: the solid's fluid block windows)."""

    post_prep: Callable | None = None
    after_first_half: Callable | None = None
    post_acoustic: Callable | None = None
    post_advection: Callable | None = None
    rebuild_aux: Callable | None = None


@dataclasses.dataclass
class BlockSim:
    fluid_b: dict
    nbr_inner: torch.Tensor
    nbr_wall: Any      # None when the scene has no wall body
    time: torch.Tensor
    n_adv: int
    n_ac: int
    overflow: torch.Tensor
    wall_bm: Any = None    # moving-wall scenes: the slots frozen this step
    wall_b0: Any = None    # moving-wall scenes: the wall blocks at the slot
    aux: Any = None        # the case's own state (coupled solid, counters)


@dataclasses.dataclass(frozen=True)
class BlockScene:
    """Scene -> block-engine binding, built by `standard_scene` (static or
    no wall) or `moving_wall_scene` (FSI)."""

    base: Any                 # the case (geometry, materials, wall state)
    eng: BlockEngine
    n_fluid: int
    device: torch.device
    wall_b: Any = None        # static wall blocks (built once)
    bm_wall: Any = None
    wall_dense_map: Any = None
    # moving wall, re-slotted every advection step from the aux state
    wall_state_fn: Callable | None = None    # aux -> wall state dict
    wall_valid: Any = None                   # (N_wall,) bool rows to slot
    c_max_wall: int = 0
    hooks: Hooks = Hooks()
    wrap: bool = False        # wrap positions into the periodic box on slot

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
    the wall's c_max rounds to 32.  Where the grid has periodic axes the
    positions are wrapped into the box at each re-slot."""
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
                      wall_b=wall_b, bm_wall=bm_wall, wall_dense_map=dm_w,
                      wrap=any(base.grid.periodic or ()))


def moving_wall_scene(base, *, eng: BlockEngine, device, wall_state_fn,
                      wall_valid, c_max_wall: int, hooks: Hooks,
                      wrap: bool = False) -> BlockScene:
    """FSI-style scenes: the wall-type contact body is derived from the aux
    state by `wall_state_fn` (static strips + moving solid), slotted every
    advection step (its rows `wall_valid`) and refreshed every acoustic
    sub-step."""
    device = resolve_device(device)
    return BlockScene(base=base, eng=eng, n_fluid=base.n_fluid, device=device,
                      wall_state_fn=wall_state_fn,
                      wall_valid=wall_valid.to(device), c_max_wall=c_max_wall,
                      hooks=hooks, wrap=wrap)


def _slot(scene: BlockScene, flat: dict, valid, aux):
    """Re-slot the fluid (wrapped into the box first where the scene wraps)
    and the moving wall, and rebuild the window maps.  Returns (fb, bm_f,
    nbr_wall, wall_bm, wall_b0, aux, overflow)."""
    eng = scene.eng
    if scene.wrap:
        flat = dict(flat, Position=wrap_positions(flat["Position"], eng.grid))
    fb, bm_f = eng_mod.slot_fluid(eng, flat, valid, n_max=scene.n_fluid)
    overflow = bm_f.overflow
    nbr_wall = wall_bm = wall_b0 = None
    if scene.wall_state_fn is not None:
        wall_b0, wall_bm, dm_w = eng_mod.build_wall_blocks(
            eng, scene.wall_state_fn(aux), scene.c_max_wall,
            valid=scene.wall_valid)
        nbr_wall = eng_mod.wall_windows(eng, bm_f, wall_bm, dm_w)
        overflow = overflow | wall_bm.overflow
    elif scene.wall_b is not None:
        nbr_wall = eng_mod.wall_windows(eng, bm_f, scene.bm_wall,
                                        scene.wall_dense_map)
    if scene.hooks.rebuild_aux is not None:
        aux = scene.hooks.rebuild_aux(bm_f, aux)
    return fb, bm_f, nbr_wall, wall_bm, wall_b0, aux, overflow


def init_sim(scene: BlockScene, fluid: dict, device=None,
             aux=None) -> BlockSim:
    """Slot the initial fluid state (a zero ViscousForcePrev is seeded
    where the engine is viscous and the state has none) and the moving
    wall from `aux`, the case's own state.  `device` defaults to the
    device the scene was built on; another one raises."""
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
    fb, bm_f, nbr_wall, wall_bm, wall_b0, aux, ovf = _slot(scene, flat, valid,
                                                           aux)
    dtype = fluid["Position"].dtype
    return BlockSim(fluid_b=fb, nbr_inner=bm_f.nbr_block, nbr_wall=nbr_wall,
                    time=torch.zeros((), dtype=dtype, device=device),
                    n_adv=0, n_ac=0, overflow=ovf, wall_bm=wall_bm,
                    wall_b0=wall_b0, aux=aux)


def _wall_ctx0(scene: BlockScene, s: BlockSim) -> WallCtx:
    """The wall as the advection step's prep sees it: the static wall, or
    the moving wall's blocks as slotted."""
    if scene.wall_state_fn is not None:
        return WallCtx(s.wall_b0, s.nbr_wall)
    return WallCtx(scene.wall_b, s.nbr_wall)


def _advection_step(scene: BlockScene, s: BlockSim) -> BlockSim:
    eng, hooks = scene.eng, scene.hooks
    fb, aux = s.fluid_b, s.aux
    wc0 = _wall_ctx0(scene, s)

    dt_adv = eng_mod.advection_dt(eng, fb)
    fb = eng_mod.advection_prep(eng, fb, s.nbr_inner, wc0)
    if hooks.post_prep is not None:
        fb, aux = hooks.post_prep(fb, aux, s.time)

    relax_t = torch.zeros_like(dt_adv)
    n_ac = 0
    while bool(relax_t < dt_adv):          # one host sync per sub-step
        t_now = s.time + relax_t
        wc = wc0
        if scene.wall_state_fn is not None:
            wc = WallCtx(eng_mod.refresh_wall_blocks(
                s.wall_bm, scene.wall_state_fn(aux), s.wall_b0), s.nbr_wall)
        dt = eng_mod.acoustic_dt(eng, fb, dt_adv)
        fb = eng_mod.acoustic_first_half(eng, fb, s.nbr_inner, wc, dt)
        if hooks.after_first_half is not None:
            fb, aux = hooks.after_first_half(fb, aux, dt, t_now)
        fb = eng_mod.acoustic_second_half(eng, fb, s.nbr_inner, wc, dt)
        if hooks.post_acoustic is not None:
            fb, aux = hooks.post_acoustic(fb, aux, dt, t_now + dt)
        relax_t = relax_t + dt
        n_ac += 1

    flat = {k: fb[k].reshape((-1,) + tuple(fb[k].shape[2:]))
            for k in scene.fields}
    valid = fb["SlotMask"].reshape(-1)
    if hooks.post_advection is not None:
        flat, aux = hooks.post_advection(flat, aux, s.time + relax_t)
        valid = flat.pop("_Valid", valid)
    fb2, bm_f, nbr_wall, wall_bm, wall_b0, aux, ovf = _slot(scene, flat,
                                                           valid, aux)
    return BlockSim(fluid_b=fb2, nbr_inner=bm_f.nbr_block, nbr_wall=nbr_wall,
                    time=s.time + relax_t, n_adv=s.n_adv + 1,
                    n_ac=s.n_ac + n_ac, overflow=s.overflow | ovf,
                    wall_bm=wall_bm, wall_b0=wall_b0, aux=aux)


def make_run_chunk(scene: BlockScene):
    """run_chunk(sim, t_target): advance by advection steps until
    sim.time >= t_target (compared in the time's dtype)."""
    return chunk_runner(lambda s: _advection_step(scene, s))


def make_advection_step(scene: BlockScene):
    return lambda s: _advection_step(scene, s)


def blocks_to_particles(scene: BlockScene, s: BlockSim,
                        n: int | None = None) -> dict:
    return eng_mod.blocks_to_particles(scene.eng, s.fluid_b, n or scene.n_fluid)
