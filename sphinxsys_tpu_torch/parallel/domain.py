"""Case-agnostic domain decomposition: slabs and halo exchange over a
ring of ranks (counterpart of sphinxsys_tpu/parallel/domain.py).

  * The domain is split into equal slabs along one axis, one rank each.
  * A rank owns the particles inside its slab, at a fixed local capacity
    with an `Alive` mask, and sees its neighbours' boundary bands as
    read-only ghosts.
  * Each step: (1) boundary-crossing rows migrate one rank along the
    ring, (2) the halo bands are exchanged, (3) the case's physics runs
    on [local + ghost] rows; it re-exchanges the ghosts' values after a
    sub-step (`ctx.refresh`) and reduces its time steps over the ring
    (`ctx.pmax` / `ctx.pmin`).
  * A periodic axis closes the ring: a row crossing a domain end, and a
    ghost sent across one, is translated by the domain length.

The body of a step runs on each rank against a `HaloContext` and the
ring's communicator (parallel/mesh.py): JAX's `shard_map` body, with
`ppermute` / `pmax` / `pmin` / `psum` / `axis_index` as the ring's
`shift` / `pmax` / `pmin` / `psum` / `index()`.  A `HaloShard` holds the
rank pieces this process runs (all of them on a ThreadRing, its own on a
ProcessGroupRing) and the replicated counters.

One departure from the JAX package: the step's overflow flag is reduced
over the ring (`pmax`), so a migration, halo or capacity overflow on any
rank is seen by all; JAX returns one device's flag for the replicated
output.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

from sphinxsys_tpu_torch.neighbors.cell_list import CellGrid

FAR = 1.0e16
# the fill of a ghost row for a field the halo does not carry
NEUTRAL_ONE = ("Mass", "Density", "VolumetricMeasure")


@dataclasses.dataclass(frozen=True)
class SlabDecomposition:
    """Static description of a 1D slab decomposition."""

    grid: CellGrid            # global background grid (defines the domain)
    n_dev: int
    cutoff: float             # halo band width
    axis: int = 0             # spatial decomposition axis
    periodic: bool = False    # ring topology (wrap migration + halos)
    halo_cap: int = 512
    migrate_cap: int = 256
    halo_fields: Sequence[str] = ("Position", "Velocity", "Density",
                                  "DensityChangeRate", "VolumetricMeasure")
    # A total-Lagrangian solid decomposes over its reference configuration:
    # rows never change owners (migrate=False) and the halo bands are
    # keyed by `band_coord` (e.g. "InitialPosition"), so they are static.
    migrate: bool = True
    band_coord: str = "Position"

    @property
    def lo(self) -> float:
        return self.grid.lower[self.axis]

    @property
    def hi(self) -> float:
        return self.lo + self.grid.spacing[self.axis] * self.grid.shape[self.axis]

    @property
    def slab_width(self) -> float:
        return (self.hi - self.lo) / self.n_dev

    @property
    def length(self) -> float:
        return self.hi - self.lo

    def slab(self, idx: int) -> tuple:
        """(lower, upper) bound of rank idx's slab."""
        lo = self.lo + self.slab_width * idx
        return lo, lo + self.slab_width


def _dump_scatter(v: torch.Tensor, tgt: torch.Tensor, src: torch.Tensor):
    """v with rows tgt set to src; a target of len(v) is dropped (written
    to a spare row that is cut off, so duplicates there do not matter)."""
    buf = torch.cat([v, v[:1]], dim=0)
    buf[tgt.long()] = src.to(v.dtype)
    return buf[:v.shape[0]]


def _compact_band(fields: dict, mask: torch.Tensor, cap: int):
    """The masked rows packed into a band of `cap` rows with a BandAlive
    flag (a rank at a non-periodic end receives zeros, so validity rides
    as a channel of its own); (band, overflow: more than cap rows)."""
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    tgt = torch.where(mask & (rank < cap), rank, torch.full_like(rank, cap))
    out = {}
    for k, v in fields.items():
        fill = FAR if k in ("Position", "InitialPosition") else 0
        band = torch.full((cap + 1,) + tuple(v.shape[1:]), fill,
                          dtype=v.dtype, device=v.device)
        band[tgt] = v
        out[k] = band[:cap]
    flag_dtype = next((v.dtype for v in fields.values()
                       if v.is_floating_point()), torch.float32)
    flag = torch.zeros((cap + 1,), dtype=flag_dtype, device=mask.device)
    flag[tgt] = 1.0
    out["BandAlive"] = flag[:cap]
    return out, torch.sum(mask) > cap


def _merge_arrivals(fluid: dict, recv: dict, fields):
    """A received band's rows into the dead slots, in order (the k-th
    arrival to the k-th dead slot); (state, overflow: more arrivals than
    dead slots)."""
    alive = fluid["Alive"]
    n = alive.shape[0]
    arr_alive = recv["BandAlive"] > 0.5
    # dead slots first, each group in index order (JAX: nonzero(~alive))
    dead_slots = torch.argsort(alive.to(torch.uint8), stable=True)
    n_dead = torch.sum(~alive)
    arr_rank = torch.cumsum(arr_alive.to(torch.int64), 0) - 1
    ok = arr_alive & (arr_rank < n_dead)
    tgt = torch.where(ok, dead_slots[torch.clamp(arr_rank, 0, n - 1)],
                      torch.full_like(arr_rank, n))
    out = dict(fluid)
    for k in fields:
        out[k] = _dump_scatter(out[k], tgt, recv[k])
    out["Alive"] = _dump_scatter(alive, tgt, torch.ones_like(arr_alive))
    return out, torch.any(arr_alive & ~ok)


def migrate_rows(fluid: dict, decomp: SlabDecomposition, ring, my_lo, my_hi,
                 right_edge: bool, left_edge: bool, exchange_fields):
    """Move the rows that left the slab to the neighbour rank (one shift
    each way): they die here, and arrivals fill dead slots."""
    ax, periodic = decomp.axis, decomp.periodic
    alive = fluid["Alive"]
    pos = fluid["Position"]
    go_right = alive & (pos[:, ax] >= my_hi)
    go_left = alive & (pos[:, ax] < my_lo)
    if not periodic:
        go_right = go_right & (not right_edge)
        go_left = go_left & (not left_edge)
    fields = {k: fluid[k] for k in exchange_fields}
    if periodic:
        # wrap the coordinate of a row crossing a domain end
        zero = torch.zeros_like(pos[:, ax])
        shift = torch.where(go_right & right_edge, zero - decomp.length,
                            torch.where(go_left & left_edge,
                                        zero + decomp.length, zero))
        p = fields["Position"].clone()
        p[:, ax] = p[:, ax] + shift
        fields = dict(fields, Position=p)
    band_r, ovf_r = _compact_band(fields, go_right, decomp.migrate_cap)
    band_l, ovf_l = _compact_band(fields, go_left, decomp.migrate_cap)
    keys = list(band_r)
    got_l, got_r = ring.shift_both([band_r[k] for k in keys],
                                   [band_l[k] for k in keys], periodic)
    recv_l, recv_r = dict(zip(keys, got_l)), dict(zip(keys, got_r))
    gone = go_right | go_left
    fluid = dict(fluid)
    fluid["Alive"] = alive & ~gone
    fluid["Position"] = torch.where(gone[:, None],
                                    torch.full_like(pos, FAR), pos)
    fluid, movf_l = _merge_arrivals(fluid, recv_l, exchange_fields)
    fluid, movf_r = _merge_arrivals(fluid, recv_r, exchange_fields)
    return fluid, ovf_r | ovf_l | movf_l | movf_r


def band_exchange(fields: dict, near_r, near_l, decomp: SlabDecomposition,
                  ring, right_edge: bool, left_edge: bool):
    """Send the rows of the two boundary bands to the ring neighbours;
    (ghosts from the left, ghosts from the right, overflow).  A dead band
    slot's position comes back FAR, outside every grid."""
    ax, periodic = decomp.axis, decomp.periodic
    if periodic:
        # ghosts sent across a domain end carry wrapped coordinates
        zero = torch.zeros_like(fields["Position"][:, ax])
        pr = fields["Position"].clone()
        pl = fields["Position"].clone()
        pr[:, ax] += torch.where(near_r & right_edge, zero - decomp.length,
                                 zero)
        pl[:, ax] += torch.where(near_l & left_edge, zero + decomp.length,
                                 zero)
    else:
        pr = pl = fields["Position"]
    br, ovr = _compact_band(dict(fields, Position=pr), near_r, decomp.halo_cap)
    bl, ovl = _compact_band(dict(fields, Position=pl), near_l, decomp.halo_cap)
    keys = list(br)
    got_l, got_r = ring.shift_both([br[k] for k in keys],
                                   [bl[k] for k in keys], periodic)
    gl, gr = dict(zip(keys, got_l)), dict(zip(keys, got_r))
    for g in (gl, gr):
        live = (g["BandAlive"] > 0.5)[:, None]
        for pk in ("Position", "InitialPosition"):
            if pk in g:
                g[pk] = torch.where(live, g[pk], torch.full_like(g[pk], FAR))
    return gl, gr, ovr | ovl


class HaloContext(NamedTuple):
    """What the physics body gets on its rank."""

    n_loc: int                 # local rows (combined rows beyond are ghosts)
    n_ghost: int               # 2 * halo_cap
    comb_alive: Any            # (n_loc + n_ghost,) bool
    alive: Any                 # (n_loc,) bool, the local rows only
    refresh: Callable          # state -> state: re-exchange the halo values
    pmax: Callable             # max over the ring
    pmin: Callable
    psum: Callable


class HaloShard(NamedTuple):
    """The distributed carry: `fluid`, the rank pieces this process runs (a
    list of dicts of (n_loc, ...) tensors, rank order), and the replicated
    counters.  `aux` is a replicated structure the physics threads through
    the step (the elastic scheme's next dt, fsi2's solid)."""

    fluid: Any
    time: torch.Tensor
    n_adv: int
    n_ac: int
    overflow: torch.Tensor
    aux: Any = ()


def particle_fields(state: dict) -> list:
    """Every (N, ...) tensor field of a state (the exchange set), from the
    shapes: no hard-coded list."""
    n = state["Position"].shape[0]
    return [k for k, v in state.items()
            if k != "Alive" and torch.is_tensor(v) and v.dim() >= 1
            and v.shape[0] == n]


def _ring_any(ring, flag: torch.Tensor) -> torch.Tensor:
    return ring.pmax(flag.to(torch.int32)) > 0


def make_distributed_step(decomp: SlabDecomposition, ring, physics: Callable):
    """The distributed advection step.

    physics(ctx, comb, aux) -> (comb, aux, relax_t, n_ac, overflow) runs
    the case's whole advection step on the combined local + ghost state
    of one rank (its local rows are [:ctx.n_loc]); it calls ctx.refresh
    after each sub-step that moves local rows, and returns `aux`, a
    replicated carry, unchanged if it does not use it."""
    n_dev, ax, halo_cap = decomp.n_dev, decomp.axis, decomp.halo_cap
    if ring.size != n_dev:
        raise ValueError(f"decomposition of {n_dev} slabs on a ring of "
                         f"{ring.size}")

    def local_step(fluid, aux):
        idx = ring.index()
        my_lo, my_hi = decomp.slab(idx)
        exchange_fields = particle_fields(fluid)
        right_edge, left_edge = idx == n_dev - 1, idx == 0

        # 1. migration (none for reference-configuration slabs)
        if decomp.migrate:
            fluid, mig_overflow = migrate_rows(
                fluid, decomp, ring, my_lo, my_hi, right_edge, left_edge,
                exchange_fields)
        else:
            mig_overflow = torch.zeros((), dtype=torch.bool,
                                       device=fluid["Alive"].device)

        # 2. the halo bands, by `band_coord` (static for TL solids)
        alive = fluid["Alive"]
        pos = fluid["Position"]
        bc = fluid[decomp.band_coord][:, ax]
        near_r = alive & (bc >= my_hi - decomp.cutoff)
        near_l = alive & (bc < my_lo + decomp.cutoff)
        halo_fields = [k for k in decomp.halo_fields if k in fluid]

        def exchange(fluid_now):
            hf = {k: fluid_now[k] for k in halo_fields}
            return band_exchange(hf, near_r, near_l, decomp, ring,
                                 right_edge, left_edge)

        ghost_l, ghost_r, halo_overflow = exchange(fluid)
        n_loc = pos.shape[0]
        n_ghost = 2 * halo_cap

        # the combined state: the halo fields carry the ghosts' values,
        # the others a neutral fill
        comb = {}
        for k in exchange_fields:
            v = fluid[k]
            if k in halo_fields:
                comb[k] = torch.cat([v, ghost_l[k], ghost_r[k]], dim=0)
            else:
                fill = 1 if k in NEUTRAL_ONE else 0
                pad = torch.full((n_ghost,) + tuple(v.shape[1:]), fill,
                                 dtype=v.dtype, device=v.device)
                comb[k] = torch.cat([v, pad], dim=0)
        comb_alive = torch.cat([alive, ghost_l["BandAlive"] > 0.5,
                                ghost_r["BandAlive"] > 0.5])
        comb["NReal"] = n_loc + n_ghost
        comb["Alive"] = comb_alive

        def refresh(comb_now):
            fluid_now = {k: comb_now[k][:n_loc] for k in halo_fields}
            gl, gr, _ = exchange(fluid_now)
            out = dict(comb_now)
            for k in halo_fields:
                out[k] = torch.cat([comb_now[k][:n_loc], gl[k], gr[k]], dim=0)
            return out

        ctx = HaloContext(n_loc=n_loc, n_ghost=n_ghost, comb_alive=comb_alive,
                          alive=alive, refresh=refresh, pmax=ring.pmax,
                          pmin=ring.pmin, psum=ring.psum)
        comb, aux, relax_t, n_ac, phys_ovf = physics(ctx, comb, aux)

        out = dict(fluid)
        for k in exchange_fields:
            if k in comb:
                out[k] = comb[k][:n_loc]
        out["Alive"] = alive
        overflow = _ring_any(ring, mig_overflow | halo_overflow | phys_ovf)
        return out, aux, relax_t, n_ac, overflow

    def step(sim: HaloShard) -> HaloShard:
        outs = ring.run(lambda f: local_step(f, sim.aux), sim.fluid)
        _, aux, relax_t, n_ac, ovf = outs[0]
        return HaloShard(fluid=[o[0] for o in outs], time=sim.time + relax_t,
                         n_adv=sim.n_adv + 1, n_ac=sim.n_ac + n_ac,
                         overflow=sim.overflow | ovf, aux=aux)

    return step


def _fill_of(k: str):
    if k in ("Position", "InitialPosition"):
        return FAR
    return 1 if k in NEUTRAL_ONE else 0


def distribute(state: dict, ring, decomp: SlabDecomposition,
               n_loc: int | None = None, aux: Any = ()) -> HaloShard:
    """Partition a particle state into its slabs' rank pieces (on the
    ring's device; those of this process's ranks).  A row goes to the slab
    its `band_coord` lies in (clipped to the end slabs); each piece holds
    n_loc rows (default 1.5 x the fullest slab's, rounded up to 8), an
    `Alive` mask, and the rows past its own parked with neutral fills."""
    n_dev = decomp.n_dev
    coord = state.get(decomp.band_coord, state["Position"])
    pos = coord.detach().cpu().numpy()
    n_real = int(state.get("NReal", pos.shape[0]))
    slab = np.clip(((pos[:, decomp.axis] - decomp.lo)
                    // decomp.slab_width).astype(int), 0, n_dev - 1)
    counts = [int((slab[:n_real] == d).sum()) for d in range(n_dev)]
    n_loc = n_loc or int(1.5 * max(max(counts), 1))
    n_loc = ((n_loc + 7) // 8) * 8
    rows = [torch.as_tensor(np.nonzero(slab[:n_real] == d)[0][:n_loc])
            for d in range(n_dev)]
    pieces = []
    for d in ring.local_ranks():
        r = rows[d]
        piece = {}
        for k in particle_fields(state):
            v = state[k].detach().cpu()
            out = torch.full((n_loc,) + tuple(v.shape[1:]), _fill_of(k),
                             dtype=v.dtype)
            out[:len(r)] = v[r]
            piece[k] = out.to(ring.device)
        alive = torch.zeros((n_loc,), dtype=torch.bool)
        alive[:len(r)] = True
        piece["Alive"] = alive.to(ring.device)
        pieces.append(piece)
    dtype = state["Position"].dtype
    return HaloShard(fluid=pieces,
                     time=torch.zeros((), dtype=dtype, device=ring.device),
                     n_adv=0, n_ac=0,
                     overflow=torch.zeros((), dtype=torch.bool,
                                          device=ring.device), aux=aux)


def gather_by_id(sim: HaloShard, n: int, fields=("Position", "Velocity",
                                                  "Density")) -> dict:
    """The live rows of every piece this process holds, ordered by
    OriginalID into (n, ...) arrays (numpy; rows no piece holds stay 0),
    and "ids": the OriginalIDs found, in piece order."""
    out, ids_all = {}, []
    for piece in sim.fluid:
        alive = piece["Alive"].cpu().numpy()
        ids = piece["OriginalID"].cpu().numpy()[alive]
        ids_all.append(ids)
        for k in fields:
            v = piece[k].detach().cpu().numpy()
            if k not in out:
                out[k] = np.zeros((n,) + v.shape[1:], v.dtype)
            out[k][ids] = v[alive]
    out["ids"] = np.concatenate(ids_all) if ids_all else np.zeros(0, int)
    return out
