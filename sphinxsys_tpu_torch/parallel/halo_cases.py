"""Distributed case bodies over parallel/domain.py (counterpart of
sphinxsys_tpu/parallel/halo_cases.py): four physics families through the
one slab-decomposition API.

  * dambreak: free-surface WCSPH with the static wall replicated on every
    rank, non-periodic slabs;
  * Taylor-Green: the doubly periodic vortex, periodic ring, viscous force
    and transport-velocity correction, no wall;
  * the oscillating beam: a total-Lagrangian solid decomposed over its
    reference configuration (owners and bands static);
  * fsi2: x-periodic fluid slabs and a replicated elastic insert, whose
    fluid forces are summed over the ring.

Each body is the case's own advection step written against the combined
local + ghost rows, through the port's physics/ functions and the cases'
own pieces (cases/fsi2.py's solid sub-cycling and inflow): ctx.refresh
after each pair sweep that moves local rows, ctx.pmax / ctx.pmin for the
time steps.  They run on the gather route (neighbour lists), as the JAX
package's do; the block engine's route is parallel/block_domain.py.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from sphinxsys_tpu_torch.neighbors.cell_list import CellGrid, build_cell_table
from sphinxsys_tpu_torch.neighbors.neighbor_list import (
    NeighborList, build_neighbor_list)
from sphinxsys_tpu_torch.parallel.domain import (
    HaloContext, SlabDecomposition, distribute, make_distributed_step)
from sphinxsys_tpu_torch.physics import fluid as fd

TINY = 1.0e-15


def _extended_grid(grid: CellGrid, axis: int, cutoff: float) -> CellGrid:
    """The build grid with one halo band more on each side of `axis`, that
    axis not periodic, so wrapped ghost coordinates bin into real cells."""
    extra = int(math.ceil(cutoff / grid.spacing[axis])) + 1
    lower = list(grid.lower)
    shape = list(grid.shape)
    lower[axis] -= extra * grid.spacing[axis]
    shape[axis] += 2 * extra
    periodic = list(grid.periodic or (False,) * grid.dim)
    periodic[axis] = False
    return dataclasses.replace(
        grid, lower=tuple(lower), shape=tuple(shape),
        periodic=tuple(periodic) if any(periodic) else None)


def _pad_nl(nl: NeighborList, extra: int, sentinel: int) -> NeighborList:
    """A list of the local rows padded with `extra` empty (ghost) rows."""
    pad_idx = torch.full((extra,) + tuple(nl.idx.shape[1:]), sentinel,
                         dtype=nl.idx.dtype, device=nl.idx.device)
    pad_cnt = torch.zeros((extra,), dtype=nl.count.dtype,
                          device=nl.count.device)
    return NeighborList(idx=torch.cat([nl.idx, pad_idx]),
                        count=torch.cat([nl.count, pad_cnt]),
                        overflow=nl.overflow)


def _inner_list(comb, grid, cutoff, cell_cap, k_max):
    table = build_cell_table(comb["Position"], comb["Alive"], grid, cell_cap)
    nl = build_neighbor_list(comb["Position"], comb["Alive"],
                             comb["Position"], comb["Alive"], table, grid,
                             cutoff, k_max=k_max, include_self=False)
    return table, nl


def _advection_reduce(ctx: HaloContext, comb, h: float):
    """The advection time step's masked max over the owned rows and the
    ring: max(|v|^2, 4 h |F + F_prior| / m)."""
    n = ctx.n_loc
    accel = 4.0 * h * torch.linalg.vector_norm(
        comb["Force"][:n] + comb["ForcePrior"][:n], dim=-1) / comb["Mass"][:n]
    v2 = torch.sum(comb["Velocity"][:n] ** 2, dim=-1)
    red = torch.where(ctx.alive, torch.maximum(v2, accel), torch.zeros_like(v2))
    return ctx.pmax(torch.max(red))


def _acoustic_reduce(ctx: HaloContext, sc, eos):
    c_eos = eos.sound_speed(sc["Pressure"], sc["Density"])
    speed = torch.linalg.vector_norm(sc["Velocity"], dim=-1)
    local = torch.where(sc["Alive"], c_eos + speed, torch.zeros_like(speed))
    return ctx.pmax(torch.max(local))


def _substeps(dt_adv, body, carry):
    """The acoustic loop: body(carry, relax_t) -> (carry, dt) while the
    relaxed time is below dt_adv; (carry, relax_t, count)."""
    relax_t = torch.zeros_like(dt_adv)
    n_ac = 0
    while bool(relax_t < dt_adv):          # one host sync per sub-step
        carry, dt = body(carry, relax_t)
        relax_t = relax_t + dt
        n_ac += 1
    return carry, relax_t, n_ac


def make_halo_dambreak_step(case, ring, halo_cap: int = 512,
                            migrate_cap: int = 256):
    """The distributed 2D dambreak (cases/dambreak_2d.py's gather step)."""
    from sphinxsys_tpu_torch.cases.dambreak_2d import RHO0_F, U_REF

    decomp = SlabDecomposition(grid=case.grid, n_dev=ring.size,
                               cutoff=case.adaptation.cutoff,
                               halo_cap=halo_cap, migrate_cap=migrate_cap)
    kernel, dim = case.kernel, 2
    h, sigma0 = case.adaptation.h, case.adaptation.sigma0
    wall, wall_table = case.wall, case.wall_table

    def physics(ctx: HaloContext, comb, aux):
        _, nl_inner = _inner_list(comb, case.grid, decomp.cutoff,
                                  case.cell_cap, case.k_inner)
        nl_wall_loc = build_neighbor_list(
            comb["Position"][:ctx.n_loc], ctx.alive, wall["Position"],
            wall["NReal"], wall_table, case.grid, decomp.cutoff,
            k_max=case.k_wall, include_self=True)
        nl_wall = _pad_nl(nl_wall_loc, ctx.n_ghost, case.n_wall)

        red = _advection_reduce(ctx, comb, h)
        dt_adv = 0.25 * h / (torch.clamp(torch.sqrt(red), min=U_REF) + TINY)
        comb = fd.density_summation(comb, nl_inner, kernel, dim, RHO0_F,
                                    sigma0, contacts=[(wall, nl_wall, RHO0_F)],
                                    free_surface=True)
        comb = ctx.refresh(comb)

        def body(sc, _):
            dt = 0.6 * h / (_acoustic_reduce(ctx, sc, case.eos) + TINY)
            sc = fd.acoustic_step_1st_half(sc, nl_inner, kernel, dim, case.eos,
                                           case.riemann, dt, wall=wall,
                                           nl_wall=nl_wall)
            sc = ctx.refresh(sc)
            sc = fd.acoustic_step_2nd_half(sc, nl_inner, kernel, dim,
                                           case.riemann, dt, wall=wall,
                                           nl_wall=nl_wall)
            return ctx.refresh(sc), dt

        comb, relax_t, n_ac = _substeps(dt_adv, body, comb)
        return (comb, aux, relax_t, n_ac,
                nl_inner.overflow | nl_wall_loc.overflow)

    return make_distributed_step(decomp, ring, physics)


def distribute_dambreak(case, fluid, ring, n_loc: int | None = None):
    decomp = SlabDecomposition(grid=case.grid, n_dev=ring.size,
                               cutoff=case.adaptation.cutoff)
    return distribute(fluid, ring, decomp, n_loc=n_loc)


def make_halo_taylor_green_step(case, ring, halo_cap: int = 512,
                                migrate_cap: int = 256):
    """The distributed Taylor-Green vortex: a periodic ring, the viscous
    force and transport-velocity correction, no wall."""
    from sphinxsys_tpu_torch.cases.taylor_green_2d import MU_F, RHO0_F, U_F

    decomp = SlabDecomposition(grid=case.grid, n_dev=ring.size,
                               cutoff=case.adaptation.cutoff, periodic=True,
                               halo_cap=halo_cap, migrate_cap=migrate_cap)
    kernel, dim = case.kernel, 2
    h, sigma0 = case.adaptation.h, case.adaptation.sigma0
    build_grid = _extended_grid(case.grid, decomp.axis, decomp.cutoff)
    # the pairs wrap only the axes not decomposed: wrapped ghosts stand for
    # the decomposed one
    box = tuple(0.0 if d == decomp.axis else length
                for d, length in enumerate(case.box))

    def physics(ctx: HaloContext, comb, aux):
        _, nl_inner = _inner_list(comb, build_grid, decomp.cutoff,
                                  case.cell_cap, case.k_inner)
        red = _advection_reduce(ctx, comb, h)
        visc_ref = MU_F / RHO0_F / h
        dt_adv = 0.25 * h / (torch.clamp(torch.clamp(torch.sqrt(red), min=U_F),
                                         min=visc_ref) + TINY)
        comb = fd.density_summation(comb, nl_inner, kernel, dim, RHO0_F,
                                    sigma0, free_surface=False, box=box)
        # a ghost sees half a support: its summed density and volume are
        # wrong until the owners' values come back
        comb = ctx.refresh(comb)
        comb = fd.viscous_force(comb, nl_inner, kernel, dim, MU_F, h, box=box)
        comb = fd.transport_velocity_correction(comb, nl_inner, kernel, dim,
                                                h, limiter_slope=100.0, box=box)
        comb = ctx.refresh(comb)

        def body(sc, _):
            dt = torch.minimum(0.6 * h / (_acoustic_reduce(ctx, sc, case.eos)
                                          + TINY), dt_adv)
            sc = fd.acoustic_step_1st_half(sc, nl_inner, kernel, dim, case.eos,
                                           case.riemann, dt, box=box)
            sc = ctx.refresh(sc)
            sc = fd.acoustic_step_2nd_half(sc, nl_inner, kernel, dim,
                                           case.no_riemann, dt, box=box)
            return ctx.refresh(sc), dt

        comb, relax_t, n_ac = _substeps(dt_adv, body, comb)
        # wrap the periodic axes not decomposed (the migration wraps the
        # decomposed one)
        pos = comb["Position"].clone()
        for d, length in enumerate(case.box):
            if length > 0 and d != decomp.axis:
                lo_d = case.grid.lower[d]
                pos[:, d] = lo_d + torch.remainder(pos[:, d] - lo_d, length)
        return dict(comb, Position=pos), aux, relax_t, n_ac, nl_inner.overflow

    return make_distributed_step(decomp, ring, physics)


def distribute_taylor_green(case, fluid, ring, n_loc: int | None = None):
    decomp = SlabDecomposition(grid=case.grid, n_dev=ring.size,
                               cutoff=case.adaptation.cutoff, periodic=True)
    return distribute(fluid, ring, decomp, n_loc=n_loc)


SOLID_HALO_FIELDS = ("Position", "Velocity", "InitialPosition",
                     "DeformationGradient", "DeformationRate", "Mass",
                     "VolumetricMeasure", "LinearGradientCorrectionMatrix",
                     "Constrained")


def _beam_decomp(case, n_dev: int, halo_cap: int) -> SlabDecomposition:
    return SlabDecomposition(grid=case.grid, n_dev=n_dev,
                             cutoff=case.adaptation.cutoff,
                             halo_cap=halo_cap, migrate_cap=8,
                             migrate=False, band_coord="InitialPosition",
                             halo_fields=SOLID_HALO_FIELDS)


def make_halo_beam_step(case, ring, halo_cap: int = 256):
    """The distributed total-Lagrangian oscillating beam
    (cases/oscillating_beam_2d.py's step), decomposed over the reference
    configuration: no migration, static bands, each rank's frozen pairs
    rebuilt from the local and ghost reference positions (the same every
    step).  The stress half needs no exchange (a ghost's stress is a
    local function of its refreshed state); one refresh comes before the
    deformation-rate half; the next step's dt (the reference computes it
    after the step) rides in the replicated `aux`."""
    from sphinxsys_tpu_torch.physics import solid as sd

    decomp = _beam_decomp(case, ring.size, halo_cap)
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    w0 = kernel.w0(dim)
    material = case.material
    c0 = material.sound_speed
    cfl = 0.6

    def physics(ctx: HaloContext, comb, aux):
        dt = aux
        ip = comb["InitialPosition"]
        table = build_cell_table(ip, comb["Alive"], case.grid, 32)
        nl = build_neighbor_list(ip, comb["Alive"], ip, comb["Alive"], table,
                                 case.grid, decomp.cutoff, k_max=64,
                                 include_self=False)
        rp = sd.freeze_reference_pairs(ip, nl, kernel, dim)

        comb = sd.integration_1st_half_pk2(comb, rp, material, dt, h, w0)
        comb = sd.fix_constraint(comb, comb["Constrained"] > 0.5)
        comb = ctx.refresh(comb)
        comb = sd.integration_2nd_half(comb, rp, dt)

        # AcousticTimeStep over the owned rows, min over the ring
        n = ctx.n_loc
        accel = torch.linalg.vector_norm(
            (comb["Force"][:n] + comb["ForcePrior"][:n])
            / comb["Mass"][:n, None], dim=-1)
        v = torch.linalg.vector_norm(comb["Velocity"][:n], dim=-1)
        per = torch.minimum(torch.sqrt(h / (accel + TINY)), h / (c0 + v))
        per = torch.where(ctx.alive, per, torch.full_like(per, math.inf))
        dt_next = cfl * ctx.pmin(torch.min(per))
        return comb, dt_next, dt_next, 1, nl.overflow

    return make_distributed_step(decomp, ring, physics)


def distribute_beam(case, solid, ring, halo_cap: int = 256,
                    n_loc: int | None = None):
    """The beam's slab pieces, with the Constrained channel, and dt = 0 for
    the first step in `aux` (as the single-device case starts)."""
    decomp = _beam_decomp(case, ring.size, halo_cap)
    state = dict(solid)
    dtype = state["Position"].dtype
    state["Constrained"] = case.base_mask.to(dtype)
    return distribute(state, ring, decomp, n_loc=n_loc,
                      aux=torch.zeros((), dtype=dtype, device=ring.device))


def _zero_ghost_volume(comb, n_loc: int):
    """The fluid with its ghost rows' volume 0: every fluid -> solid force
    term carries dW V_j, so each rank's sum over its own rows, summed over
    the ring, counts every fluid-solid pair once (on the fluid row's
    owner)."""
    vol = comb["VolumetricMeasure"]
    keep = torch.arange(vol.shape[0], device=vol.device) < n_loc
    return dict(comb, VolumetricMeasure=torch.where(keep, vol,
                                                    torch.zeros_like(vol)))


def _ring_force(ctx, so, so_new, name):
    """The solid with the force `name` of so_new summed over the ring, and
    ForcePrior moved by it against the previous one."""
    f = ctx.psum(so_new[name])
    prev = so.get("Previous" + name, torch.zeros_like(f))
    return dict(so, ForcePrior=so["ForcePrior"] + f - prev,
                **{name: f, "Previous" + name: f})


def make_halo_fsi2_step(case, ring, halo_cap: int = 512,
                        migrate_cap: int = 256):
    """The distributed fsi2 (cases/fsi2.py's gather step): x-periodic fluid
    slabs and the elastic insert replicated in `aux`.  Each rank computes
    the fluid -> solid forces from its own fluid rows (ghost volumes 0)
    and the ring sums them; then every rank sub-cycles the same solid, so
    the replicas stay identical."""
    from sphinxsys_tpu_torch.cases import fsi2 as fsi2_mod
    from sphinxsys_tpu_torch.cases.fsi2 import MU_F, RHO0_F, RHO0_S, U_F
    from sphinxsys_tpu_torch.physics import fsi

    decomp = SlabDecomposition(
        grid=case.grid_f, n_dev=ring.size, cutoff=case.adaptation.cutoff,
        periodic=True, halo_cap=halo_cap, migrate_cap=migrate_cap,
        halo_fields=("Position", "Velocity", "Density", "DensityChangeRate",
                     "VolumetricMeasure", "Pressure", "Mass", "ForcePrior"))
    kernel, dim = case.kernel, 2
    h, sigma0 = case.adaptation.h, case.adaptation.sigma0
    wall, wall_table = case.wall, case.wall_table
    build_grid = _extended_grid(case.grid_f, decomp.axis, decomp.cutoff)

    def physics(ctx: HaloContext, comb, aux):
        solid, n_s_total, t0 = aux
        cutoff, kc = decomp.cutoff, case.k_contact
        table, nl_ff = _inner_list(comb, build_grid, cutoff, case.cell_cap,
                                   case.k_inner)
        nl_fw_loc = build_neighbor_list(
            comb["Position"][:ctx.n_loc], ctx.alive, wall["Position"],
            wall["NReal"], wall_table, case.grid_s, cutoff, k_max=kc,
            include_self=True)
        nl_fw = _pad_nl(nl_fw_loc, ctx.n_ghost, case.n_wall)
        table_s = build_cell_table(solid["Position"], solid["NReal"],
                                   case.grid_s, case.cell_cap)
        nl_fs = build_neighbor_list(
            comb["Position"], comb["Alive"], solid["Position"],
            solid["NReal"], table_s, case.grid_s, cutoff, k_max=kc,
            include_self=True)
        nl_sf = build_neighbor_list(
            solid["Position"], solid["NReal"], comb["Position"],
            comb["Alive"], table, build_grid, cutoff, k_max=kc,
            include_self=True)
        walls = [(wall, nl_fw), (solid, nl_fs)]

        red = _advection_reduce(ctx, comb, h)
        visc_ref = MU_F / RHO0_F / h
        dt_adv = 0.25 * h / (torch.clamp(torch.clamp(torch.sqrt(red), min=U_F),
                                         min=visc_ref) + TINY)
        comb = fd.density_summation(comb, nl_ff, kernel, dim, RHO0_F, sigma0,
                                    contacts=[(wall, nl_fw, RHO0_F),
                                              (solid, nl_fs, RHO0_S)],
                                    free_surface=False)
        comb = ctx.refresh(comb)
        comb = fd.viscous_force(comb, nl_ff, kernel, dim, MU_F, h, walls=walls)
        comb = fd.transport_velocity_correction(comb, nl_ff, kernel, dim, h,
                                                coefficient=0.25, walls=walls)
        comb = ctx.refresh(comb)

        # the solid's prep: the viscous force from the owned fluid, summed
        # over the ring, then the normals
        so_v = fsi.viscous_force_from_fluid(
            solid, _zero_ghost_volume(comb, ctx.n_loc), nl_sf, kernel, dim,
            MU_F, h)
        vf = ctx.psum(so_v["ViscousForceFromFluid"])
        solid = dict(so_v, ForcePrior=so_v["ForcePrior"]
                     - so_v["ViscousForceFromFluid"] + vf,
                     ViscousForceFromFluid=vf, PreviousViscousForceFromFluid=vf)
        solid = fsi.update_elastic_normal_direction(solid)

        def body(carry, rt):
            sc, so, k_s = carry
            dt = torch.minimum(0.6 * h / (_acoustic_reduce(ctx, sc, case.eos)
                                          + TINY), dt_adv)
            walls_now = [(wall, nl_fw), (so, nl_fs)]
            sc = fd.acoustic_step_1st_half(sc, nl_ff, kernel, dim, case.eos,
                                           case.riemann, dt, walls=walls_now)
            sc = ctx.refresh(sc)
            so = _ring_force(ctx, so, fsi.pressure_force_from_fluid(
                so, _zero_ghost_volume(sc, ctx.n_loc), nl_sf, kernel, dim,
                case.riemann), "PressureForceFromFluid")
            sc = fd.acoustic_step_2nd_half(sc, nl_ff, kernel, dim,
                                           case.no_riemann, dt,
                                           walls=walls_now)
            sc = fsi2_mod.inflow_velocity(sc, t0 + rt + dt, case.dl_sponge)
            sc = ctx.refresh(sc)
            so, k_sub = fsi2_mod.solid_substeps(case, so, dt)
            return (sc, so, k_s + k_sub), dt

        (comb, solid, n_s_steps), relax_t, n_ac = _substeps(
            dt_adv, body, (comb, solid, 0))
        overflow = (nl_ff.overflow | nl_fw_loc.overflow | nl_fs.overflow
                    | nl_sf.overflow)
        return (comb, (solid, n_s_total + n_s_steps, t0 + relax_t), relax_t,
                n_ac, overflow)

    return make_distributed_step(decomp, ring, physics)


def distribute_fsi2(case, fluid, solid, ring, n_loc: int | None = None):
    """The fsi2 fluid in periodic x-slabs; the solid, its sub-step count
    and the time ride in the replicated `aux`."""
    decomp = SlabDecomposition(grid=case.grid_f, n_dev=ring.size,
                               cutoff=case.adaptation.cutoff, periodic=True)
    dtype = fluid["Position"].dtype
    solid = {k: v.to(ring.device) if torch.is_tensor(v) else v
             for k, v in solid.items()}
    return distribute(fluid, ring, decomp, n_loc=n_loc,
                      aux=(solid, 0, torch.zeros((), dtype=dtype,
                                                 device=ring.device)))
