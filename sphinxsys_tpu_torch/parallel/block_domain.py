"""The cell-block engine over a ring of ranks (counterpart of
sphinxsys_tpu/parallel/block_domain.py): the slab and halo semantics of
parallel/domain.py for any engine/block_fluid.BlockEngine case, each
rank's acoustic loop through the engine's sweeps (with use_kernels on a
CUDA device, the B1-B4 kernels of csrc/block_sweeps.cu, on that rank's
slab plus its ghost slots).

  * Migration and the first halo exchange run once per advection step on
    flat rows (domain.migrate_rows / band_exchange); then the local and
    ghost rows are slotted into blocks together.
  * The halo bands are frozen for the advection step (membership from the
    step-start positions), so the k-th band row is the same particle at
    every refresh inside the step, and a refresh is a value update in the
    block layout: the band rows' values are read from their slots
    (2 * halo_cap rows), shifted one rank each way, and written into the
    ghosts' frozen slots.  No re-slot inside the acoustic loop.
  * Ghost slots carry IsGhost = 1, which keeps them out of the time-step
    reductions: the local max over owned slots, then `pmax` over the ring,
    is the single-device max (max is order-free), so the distributed run
    takes the single-device run's time steps.
  * At step end the local rows come back from the blocks by one packed
    row gather (cell_blocks.from_blocks_packed); identity rides in
    OriginalID.

The wall is replicated: every rank holds the scene's static wall blocks.
Periodic grids are refused (their ghosts would need positions outside
the grid); the JAX package routes them through its halo cases too
(parallel/halo_cases.py).  The JAX package rounds each slab's occupied-
cell capacity up to its TPU tile width; here it is the budget itself.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from sphinxsys_tpu_torch.engine import block_fluid as engine
from sphinxsys_tpu_torch.neighbors.cell_blocks import (
    build_block_map, from_blocks_packed, to_blocks_packed,
)
from sphinxsys_tpu_torch.parallel.domain import (
    FAR, HaloShard, SlabDecomposition, _ring_any, band_exchange, distribute,
    migrate_rows,
)

HALO_FIELDS = ("Position", "Velocity", "Density", "DensityChangeRate",
               "VolumetricMeasure")


def default_c_max_loc(eng, n_dev: int) -> int:
    """A slab's occupied-cell capacity: 1/n_dev of the engine's budget plus
    the halo band's cell columns on each side."""
    shape = eng.grid.shape
    layers = int(math.ceil(eng.kernel.cutoff / eng.grid.spacing[0])) + 1
    cross = 1
    for s in shape[1:]:
        cross *= int(s)
    return eng.c_max // n_dev + 2 * layers * cross


def _first_rows(mask: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of mask's first k True rows, in order (then other rows:
    the caller masks them), k entries (JAX: nonzero(mask, size=k))."""
    order = torch.argsort((~mask).to(torch.uint8), stable=True)[:k]
    if order.shape[0] < k:
        order = torch.cat([order, order.new_zeros(k - order.shape[0])])
    return order


def make_distributed_engine_step(eng, ring, wall_b=None, bm_wall=None,
                                 wall_dense_map=None, halo_cap: int = 256,
                                 migrate_cap: int = 128,
                                 c_max_loc: int | None = None, probe=None):
    """The distributed advection step of any BlockEngine fluid case.

    `eng` is the case's single-device engine; the static wall's blocks
    (engine.build_wall_blocks: wall_b, bm_wall, wall_dense_map), if any,
    are shared by every rank.  The slabs are along the grid's axis 0.

    The step is the single-device scene step's: migration and a halo
    exchange per advection step, the frozen-band refresh after the prep
    and after each acoustic half, time steps reduced over the owned slots
    and the ring, and the halo, migration and capacity overflows folded
    into the step's overflow flag.

    `probe(rank, eng_loc, fb, nbr_inner, wall_ctx)`, if given, sees each
    rank's block state after the prep's refresh (the first acoustic
    sub-step's input): a kernel check reads its sweeps' inputs there."""
    if any(eng.grid.periodic or ()):
        raise ValueError("make_distributed_engine_step takes non-periodic "
                         "grids only (a periodic case runs through "
                         "parallel/halo_cases.py)")
    n_dev = ring.size
    decomp = SlabDecomposition(
        grid=eng.grid, n_dev=n_dev, cutoff=eng.kernel.cutoff,
        halo_cap=halo_cap, migrate_cap=migrate_cap, halo_fields=HALO_FIELDS)
    c_max = c_max_loc or default_c_max_loc(eng, n_dev)
    eng_loc = dataclasses.replace(eng, c_max=c_max)
    all_fields = tuple(eng.fluid_fields) + ("OriginalID",)
    n_ghost = 2 * halo_cap
    big = c_max * eng.cap
    oob = (c_max + 1) * eng.cap     # one past the flat blocks: dropped
    fills = dict(eng.fills, IsGhost=1.0)

    def local_step(fluid):
        idx = ring.index()
        my_lo, my_hi = decomp.slab(idx)
        right_edge, left_edge = idx == n_dev - 1, idx == 0

        # 1. migration in flat rows
        fluid, mig_ovf = migrate_rows(fluid, decomp, ring, my_lo, my_hi,
                                      right_edge, left_edge, all_fields)
        alive = fluid["Alive"]
        pos = fluid["Position"]
        n_loc = pos.shape[0]

        # 2. the frozen halo bands and the first exchange
        near_r = alive & (pos[:, 0] >= my_hi - decomp.cutoff)
        near_l = alive & (pos[:, 0] < my_lo + decomp.cutoff)
        ghost_l, ghost_r, halo_ovf = band_exchange(
            {k: fluid[k] for k in HALO_FIELDS}, near_r, near_l, decomp, ring,
            right_edge, left_edge)

        # combined rows: [local | ghosts from the left | from the right]
        comb = {}
        for k in all_fields:
            v = fluid[k]
            if k in HALO_FIELDS:
                comb[k] = torch.cat([v, ghost_l[k], ghost_r[k]], dim=0)
            else:
                pad = torch.full((n_ghost,) + tuple(v.shape[1:]),
                                 fills.get(k, 0), dtype=v.dtype,
                                 device=v.device)
                comb[k] = torch.cat([v, pad], dim=0)
        comb["IsGhost"] = torch.cat([pos.new_zeros((n_loc,)),
                                     pos.new_ones((n_ghost,))])
        comb_alive = torch.cat([alive, ghost_l["BandAlive"] > 0.5,
                                ghost_r["BandAlive"] > 0.5])

        # 3. into blocks, with the inverse map for the refresh and the end
        bm = build_block_map(comb["Position"], comb_alive, eng.grid,
                             cap=eng.cap, c_max=c_max, with_inverse=True)
        fb = to_blocks_packed(bm, comb, fills)
        fb["SlotMask"] = engine._slot_mask_2d(bm)
        nbr_inner = bm.nbr_block
        if wall_b is not None:
            wc = engine.WallCtx(wall_b, engine.wall_windows(
                eng_loc, bm, bm_wall, wall_dense_map))
        else:
            wc = engine.WallCtx(None, None)

        # the frozen refresh maps: band rows -> their slots, ghost slots
        slot = bm.particle_slot                      # (n_loc + n_ghost,)
        ar = torch.arange(halo_cap, device=pos.device)
        band_slots = []
        for near in (near_r, near_l):
            rows = _first_rows(near, halo_cap)
            valid = ar < torch.sum(near)
            band_slots.append(torch.where(valid, slot[rows],
                                          torch.full_like(rows, big,
                                                          dtype=slot.dtype)))
        band_slots_r, band_slots_l = band_slots
        tgts = []
        for g, gslot in ((ghost_l, slot[n_loc:n_loc + halo_cap]),
                         (ghost_r, slot[n_loc + halo_cap:])):
            ok = (g["BandAlive"] > 0.5) & (gslot < big)
            tgts.append(torch.where(ok, gslot, torch.full_like(gslot, oob))
                        .long())
        tgt_l, tgt_r = tgts

        def refresh(fb_now):
            flats = {k: fb_now[k].reshape((-1,) + tuple(fb_now[k].shape[2:]))
                     for k in HALO_FIELDS}
            last = oob - 1
            vals_r = [flats[k][torch.clamp(band_slots_r, max=last).long()]
                      for k in HALO_FIELDS]
            vals_l = [flats[k][torch.clamp(band_slots_l, max=last).long()]
                      for k in HALO_FIELDS]
            # band order on the wire is the frozen compaction order, so
            # band row j lands in ghost slot j
            recv_l, recv_r = ring.shift_both(vals_r, vals_l, decomp.periodic)
            out = dict(fb_now)
            for k, rl, rr in zip(HALO_FIELDS, recv_l, recv_r):
                buf = torch.cat([flats[k], flats[k][:1]], dim=0)
                buf[tgt_l] = rl
                buf[tgt_r] = rr
                out[k] = buf[:oob].reshape(fb_now[k].shape)
            return out

        mask_loc = fb["SlotMask"] & (fb["IsGhost"] < 0.5)

        def owned(f):
            return dict(f, SlotMask=mask_loc)

        # 4. the advection step's physics
        dt_adv = ring.pmin(engine.advection_dt(eng_loc, owned(fb)))
        fb = engine.advection_prep(eng_loc, fb, nbr_inner, wc)
        fb = refresh(fb)
        if probe is not None:
            probe(idx, eng_loc, fb, nbr_inner, wc)
        relax_t = torch.zeros_like(dt_adv)
        n_ac = 0
        while bool(relax_t < dt_adv):        # one host sync per sub-step
            dt = ring.pmin(engine.acoustic_dt(eng_loc, owned(fb), dt_adv))
            fb = engine.acoustic_step(eng_loc, fb, nbr_inner, wc, dt,
                                      between=refresh)
            fb = refresh(fb)
            relax_t = relax_t + dt
            n_ac += 1

        # 5. the local rows back out of the blocks (one packed gather)
        flat, slot_valid = from_blocks_packed(bm, fb, all_fields, n_loc)
        out = dict(fluid)
        for k in all_fields:
            keep = slot_valid.reshape((-1,) + (1,) * (flat[k].dim() - 1))
            out[k] = torch.where(keep, flat[k], fluid[k])
        out["Position"] = torch.where(alive[:, None], out["Position"],
                                      torch.full_like(out["Position"], FAR))
        out["Alive"] = alive
        overflow = _ring_any(ring, mig_ovf | halo_ovf | bm.overflow)
        return out, relax_t, n_ac, overflow

    def step(sim: HaloShard) -> HaloShard:
        outs = ring.run(local_step, sim.fluid)
        _, relax_t, n_ac, ovf = outs[0]
        return HaloShard(fluid=[o[0] for o in outs], time=sim.time + relax_t,
                         n_adv=sim.n_adv + 1, n_ac=sim.n_ac + n_ac,
                         overflow=sim.overflow | ovf, aux=sim.aux)

    return step


def distribute_block_engine(eng, fluid: dict, ring,
                            n_loc: int | None = None) -> HaloShard:
    """A flat fluid state's slab pieces for make_distributed_engine_step:
    the engine's fields (a viscous engine's ViscousForcePrev zero where
    the state has none, as scene.init_sim seeds it) and OriginalID, the
    row index."""
    decomp = SlabDecomposition(grid=eng.grid, n_dev=ring.size,
                               cutoff=eng.kernel.cutoff)
    n = fluid["Position"].shape[0]
    st = {k: fluid[k] for k in eng.fluid_fields if k in fluid}
    if "ViscousForcePrev" in eng.fluid_fields and "ViscousForcePrev" not in st:
        st["ViscousForcePrev"] = torch.zeros_like(fluid["Velocity"])
    missing = set(eng.fluid_fields) - set(st)
    if missing:
        raise KeyError(f"the fluid state lacks {sorted(missing)}")
    st["OriginalID"] = torch.arange(n, dtype=torch.int32,
                                    device=fluid["Position"].device)
    st["NReal"] = int(fluid.get("NReal", n))
    return distribute(st, ring, decomp, n_loc=n_loc)
