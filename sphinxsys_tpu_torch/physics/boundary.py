"""Open-boundary particle recycling: emitters and disposers (counterpart of
sphinxsys_tpu/physics/boundary.py; reference fluid_dynamics/
boundary_condition/fluid_boundary.h:48-246, EmitterInflowInjection and
DisposerOutflowDeletion).

A body has a fixed capacity and an "Alive" (N,) bool mask of its live
rows.  Deletion and injection are mask and scatter updates of fixed size,
with no host read:

  * deletion: Alive &= not in the disposer region; the deleted rows are
    parked at FAR_AWAY;
  * injection: a particle that has just crossed the emitter's downstream
    plane is moved back by the emitter's length, and a clone of its
    state before the move is made live in a dead slot — the k-th crosser
    (in index order) in the k-th dead slot.

  * the bidirectional buffer: deletion past the buffer's outer plane,
    and a clone one buffer length behind each particle that has just
    crossed its inner plane into the bulk.

The dead-slot table comes from a cumsum and a scatter of size N, not from
`torch.nonzero` (whose size depends on the data, so that it reads the
device), and the crossers past the last dead slot are dropped by a mask.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from sphinxsys_tpu_torch.core.state import FAR_AWAY, State, nreal_mask

# the fields a clone inherits; the rest keep the dead slot's old values,
# as in the JAX package
_PARTICLE_FIELDS_HINT = ("Position", "Velocity", "Density", "Mass",
                         "VolumetricMeasure", "Pressure", "DensityChangeRate",
                         "Force", "ForcePrior", "DensitySummation")


@dataclasses.dataclass(frozen=True)
class AlignedBoxRegion:
    """Axis-aligned box with a flow axis (BodyAlignedBoxByParticle)."""

    lower: Tuple[float, ...]
    upper: Tuple[float, ...]
    axis: int = 0

    def bounds(self, pos):
        """(lower, upper) as tensors in the positions' dtype."""
        return (torch.as_tensor(self.lower, dtype=pos.dtype, device=pos.device),
                torch.as_tensor(self.upper, dtype=pos.dtype, device=pos.device))

    def contains(self, pos):
        lo, hi = self.bounds(pos)
        return torch.all((pos >= lo) & (pos <= hi), dim=-1)


def ensure_alive_mask(state: State) -> State:
    """An NReal-prefix state with its explicit Alive mask."""
    if "Alive" in state:
        return state
    return dict(state, Alive=nreal_mask(state))


def disposer_outflow_deletion(state: State, region: AlignedBoxRegion) -> State:
    """Deactivate the live particles inside `region` and park them at
    FAR_AWAY (DisposerOutflowDeletion)."""
    out = ensure_alive_mask(state)
    pos = out["Position"]
    gone = out["Alive"] & region.contains(pos)
    out = dict(out, Alive=out["Alive"] & ~gone)
    out["Position"] = torch.where(gone[:, None],
                                  torch.full_like(pos, FAR_AWAY), pos)
    return out


def emitter_inflow_injection(state: State, region: AlignedBoxRegion,
                             fields=_PARTICLE_FIELDS_HINT, prev_pos=None,
                             crossing_band: float | None = None) -> State:
    """EmitterInflowInjection: live particles inside the emitter's
    transverse band whose `axis` coordinate just passed its downstream
    plane move back by the emitter's length, and a clone of each (its
    `fields` before the move) goes live in a dead slot.

    "Just passed": prev_pos <= plane < pos when `prev_pos` (the positions
    before this step's advection) is given; otherwise within
    `crossing_band` (default half the emitter's length) past the plane.
    More crossers than dead slots: every crosser still moves back, the
    ones past the last dead slot get no clone, and "_InjectionOverflow"
    (a 0-d bool tensor, or-ed into the state's own) is set."""
    out = ensure_alive_mask(state)
    pos = out["Position"]
    alive = out["Alive"]
    n, dim = pos.shape
    axis = region.axis
    hi = region.upper[axis]
    length = hi - region.lower[axis]
    band = crossing_band if crossing_band is not None else 0.5 * length

    lo_v, hi_v = region.bounds(pos)
    transverse = torch.ones(n, dtype=torch.bool, device=pos.device)
    for d in range(dim):
        if d != axis:
            transverse &= (pos[:, d] >= lo_v[d]) & (pos[:, d] <= hi_v[d])
    x = pos[:, axis]
    crossed = alive & transverse & (x > hi)
    if prev_pos is not None:
        crossed &= prev_pos[:, axis] <= hi
    else:
        crossed &= x <= hi + band

    out, _ = _clone_into_dead_slots(out, crossed, fields)

    # the crossers move back to the emitter's inlet
    p = out["Position"].clone()
    p[:, axis] -= crossed.to(p.dtype) * length
    out["Position"] = p
    return out


def _clone_into_dead_slots(out: State, crossed, fields):
    """The k-th crosser (in index order) cloned into the k-th dead slot:
    its `fields` copied there and the slot made live; the crossers past
    the last dead slot get no clone and set "_InjectionOverflow" (or-ed
    into the state's own).  Returns (state, cloned: (N,) bool of the
    slots filled)."""
    alive = out["Alive"]
    n = alive.shape[0]
    device = alive.device
    # the k-th dead slot of each rank k (fixed size: ranks of live rows go
    # to a dump entry n); the k-th crosser's target slot
    dead = ~alive
    arange = torch.arange(n, device=device)
    dead_rank = torch.cumsum(dead, dim=0) - 1
    slot_of_rank = torch.full((n + 1,), n - 1, dtype=torch.int64,
                              device=device)
    slot_of_rank.scatter_(0, torch.where(dead, dead_rank,
                                         torch.full_like(dead_rank, n)), arange)
    n_dead = dead_rank[-1] + 1
    cross_rank = torch.cumsum(crossed, dim=0) - 1
    can_clone = crossed & (cross_rank < n_dead)
    tgt = torch.where(can_clone,
                      slot_of_rank[torch.clamp(cross_rank, 0, n - 1)],
                      torch.full_like(cross_rank, n))
    # each target slot's source row (n: no clone there)
    src = torch.full((n + 1,), n, dtype=torch.int64, device=device)
    src.scatter_(0, tgt, arange)
    src = src[:n]
    cloned = src < n
    src = torch.clamp(src, max=n - 1)

    out = dict(out)
    for k in fields:
        if k not in out:
            continue
        v = out[k]
        m = cloned.view(-1, *([1] * (v.dim() - 1)))
        out[k] = torch.where(m, v[src], v)
    out["Alive"] = alive | cloned
    overflow = torch.sum(crossed) > n_dead
    prev = out.get("_InjectionOverflow")
    out["_InjectionOverflow"] = overflow if prev is None else prev | overflow
    return out, cloned


def bidirectional_buffer_exchange(state: State, region: AlignedBoxRegion,
                                  inward: int = +1,
                                  fields=_PARTICLE_FIELDS_HINT,
                                  prev_pos=None) -> State:
    """BidirectionalBuffer (extra_src/shared/pressure_boundary/
    bidirectional_buffer.h): a buffer at one end of the domain for flow in
    either direction.

      * a live particle past the buffer's outer plane (on the flow axis
        alone, bidirectional_buffer.h:157-169) is deleted and parked at
        FAR_AWAY;
      * a live particle in the buffer's transverse band that has just
        crossed its inner plane into the bulk keeps going, and a clone of
        it goes live in a dead slot one buffer length behind
        (`_clone_into_dead_slots`).

    ``inward`` = +1 where the bulk lies toward +axis of the buffer (an
    inlet), -1 toward -axis (an outlet).  With ``prev_pos`` (the positions
    before this step's advection) a crosser must also have been in the
    buffer before (the reference's buffer tag, bidirectional_buffer.h:
    110-112): a slot refilled this step keeps its stale prev position,
    which could otherwise pass the other buffer's test."""
    axis = region.axis
    out = dict(ensure_alive_mask(state))
    pos = out["Position"]
    lo_v, hi_v = region.bounds(pos)
    outer = pos[:, axis] < region.lower[axis] if inward > 0 \
        else pos[:, axis] > region.upper[axis]
    transverse = torch.ones(pos.shape[0], dtype=torch.bool,
                            device=pos.device)
    for d in range(pos.shape[1]):
        if d != axis:
            transverse &= (pos[:, d] >= lo_v[d]) & (pos[:, d] <= hi_v[d])
    gone = out["Alive"] & outer
    out["Alive"] = out["Alive"] & ~gone
    out["Position"] = torch.where(gone[:, None],
                                  torch.full_like(pos, FAR_AWAY), pos)

    pos = out["Position"]
    alive = out["Alive"]
    length = region.upper[axis] - region.lower[axis]
    x = pos[:, axis]
    if inward > 0:
        plane = region.upper[axis]
        crossed = alive & transverse & (x > plane)
        if prev_pos is not None:
            xp = prev_pos[:, axis]
            crossed &= (xp <= plane) & (xp >= region.lower[axis])
        shift = -length
    else:
        plane = region.lower[axis]
        crossed = alive & transverse & (x < plane)
        if prev_pos is not None:
            xp = prev_pos[:, axis]
            crossed &= (xp >= plane) & (xp <= region.upper[axis])
        shift = length

    out, cloned = _clone_into_dead_slots(out, crossed, fields)
    # the clone, not the crosser, moves one buffer length back
    p = out["Position"].clone()
    p[:, axis] = torch.where(cloned, p[:, axis] + shift, p[:, axis])
    out["Position"] = p
    return out
