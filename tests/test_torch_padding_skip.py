"""The property the lane-group kernels' slot skip rests on, held on the
plain versions in float64: a slot whose VolumetricMeasure is 0 (and, for
B1's fluid sum, whose SlotMask is False) adds exactly nothing to any
density_sweep / ac1_sweep / ac2_sweep / visc_tvc_sweep sum, and a packed
slot whose mask channel is 0 adds exactly nothing to any
ac1_inner_sweep / ac2_inner_sweep sum, whatever its VOL, wherever it sits
and whatever else it carries.

On the slotted initial state of the 2D and 3D dambreaks and the doubly
periodic Taylor–Green vortex (seeded noise on the real slots, a moving
wall where there is one: B4 takes the wall velocity as its moving wall),
every padding slot of the fluid and wall blocks is moved into the support
of a random real particle and given random pressure, density, velocity
and acceleration, its VOL and mask kept at 0; then the slots of every row
are permuted at random, so that padding sits mid-row.  Every real slot's
sums must equal those of the untouched blocks, through the permutation,
within 1e-12 relative.  The packed cases (cap 16) also give the padding a
random VOL, and cover the layout sweeps ac1_flat_sweep (B6) and
ac1_t_sweep (B7, through `prep_t`), whose kernels skip the same slots, and
the wall sweeps ac1_wall_sweep / ac2_wall_sweep (B5c / B5d), whose wall
padding (mask 0, random VOL) is moved into the support of real fluid
particles and mid-row, the fluid padding with it.
"""

import numpy as np
import pytest
import torch

from sphinxsys_tpu_torch.cases import dambreak_2d as tdb2, dambreak_3d as tdb3
from sphinxsys_tpu_torch.cases import taylor_green_2d as ttg
from sphinxsys_tpu_torch.engine import scene as sc
from sphinxsys_tpu_torch.ops import block_sweeps as bs
from sphinxsys_tpu_torch.ops import layout_sweeps as ls
from sphinxsys_tpu_torch.ops import packed_sweeps as ps
from sphinxsys_tpu_torch.physics import fluid_blocks as fbops

torch.set_num_threads(1)

F64 = torch.float64
CASES = {"2d": (tdb2, 0.1, {}), "3d": (tdb3, 0.1, {"cap": 32}),
         "tg": (ttg, 0.05, {}), "2d16": (tdb2, 0.1, {"cap": ps.CAP})}
SEEDS = {"2d": 0, "3d": 1, "tg": 2, "2d16": 3}


def _state(tag):
    """Block state, wall and window maps of a case, with seeded noise on the
    real slots and, for a wall, seeded wall kinematics."""
    mod, dx, kw = CASES[tag]
    scene, fluid = mod.build_block_case(dx=dx, dtype=F64, device="cpu", **kw)
    sim = sc.init_sim(scene, fluid)
    rng = np.random.default_rng(SEEDS[tag])
    fb = {k: v.clone() for k, v in sim.fluid_b.items()}
    m = fb["SlotMask"]
    n, dim = int(m.sum()), fb["Position"].shape[-1]

    def noise(shape, scale):
        return torch.as_tensor(rng.normal(0.0, scale, shape), dtype=F64)

    fb["Position"][m] += noise((n, dim), 0.1 * dx)
    fb["Velocity"][m] = noise((n, dim), 0.3)
    fb["Density"][m] = 1.0 + noise(n, 0.01)
    fb["Pressure"][m] = noise(n, 2.0)
    fb["ForcePrior"][m] = noise((n, dim), 0.05)
    wb = None
    if scene.wall_b is not None:
        wb = {k: v.clone() for k, v in scene.wall_b.items()}
        wm = wb["SlotMask"]
        nw = int(wm.sum())
        wb["AverageVelocity"][wm] = noise((nw, dim), 0.2)
        wb["AverageAcceleration"][wm] = noise((nw, dim), 1.0)
    return dict(scene=scene, fb=fb, wb=wb, nbr=sim.nbr_inner,
                nbr_wall=sim.nbr_wall, h=scene.eng.kernel.h)


@pytest.fixture(scope="module")
def states():
    return {}


def _get(states, tag):
    if tag not in states:
        states[tag] = _state(tag)
    return states[tag]


def _sweep(name, s, fb, wb):
    """One plain sweep on the given blocks, as the *_p2 forms call it."""
    eng = s["scene"].eng
    kern, dim = eng.kernel, eng.dim
    inv_h = 1.0 / kern.h
    common = dict(inv_h=inv_h, dw_scale=kern._factor_w(dim) * inv_h * 0.625,
                  box=eng.box)
    nw = s["nbr_wall"] if wb is not None else None
    wall = (lambda *k: (None,) * len(k)) if wb is None \
        else (lambda *k: tuple(wb[x] for x in k))
    if name == "density":
        return bs.density_sweep(fb["Position"], fb["SlotMask"], s["nbr"],
                                *wall("Position", "VolumetricMeasure"), nw,
                                inv_h=inv_h, factor_w=kern._factor_w(dim),
                                box=eng.box)
    if name == "visc_tvc":
        return bs.visc_tvc_sweep(fb["Position"], fb["Velocity"],
                                 fb["VolumetricMeasure"], s["nbr"],
                                 *wall("Position", "VolumetricMeasure",
                                       "AverageVelocity"), nw,
                                 eps_r=0.01 * eng.h, **common)
    if name == "ac1":
        acc = fb["ForcePrior"] / torch.clamp(fb["Mass"], min=1e-30)[..., None]
        return bs.ac1_sweep(fb["Position"], fb["Pressure"], fb["Density"], acc,
                            fb["VolumetricMeasure"], s["nbr"],
                            *wall("Position", "VolumetricMeasure",
                                  "AverageAcceleration"), nw,
                            inv_rho0c0=eng.riemann1.inv_rho0c0_ave, **common)
    return bs.ac2_sweep(fb["Position"], fb["Velocity"], fb["VolumetricMeasure"],
                        s["nbr"], *wall("Position", "VolumetricMeasure",
                                        "AverageVelocity", "NormalDirection"),
                        nw, rho0c0_geo=3.0, lim_scale=0.5, **common)


def _disturb(blocks, rng, h, keys, near=None):
    """Padding slots moved into the support of random real particles (of
    these blocks, or the positions `near`; jitter of up to h per axis) and
    given random values in `keys`, VOL kept 0 unless it is one of them;
    then every row's slots permuted at random.  Returns (blocks, perm) with
    new[r, k] = old[r, perm[r, k]]."""
    out = {k: v.clone() for k, v in blocks.items()}
    mask = out["SlotMask"]
    pad = ~mask
    n_pad = int(pad.sum())
    real_pos = out["Position"][mask] if near is None else near
    pick = torch.as_tensor(rng.integers(0, real_pos.shape[0], n_pad))
    jitter = torch.as_tensor(rng.uniform(-h, h, (n_pad, real_pos.shape[1])),
                             dtype=F64)
    out["Position"][pad] = real_pos[pick] + jitter
    for k in keys:
        shape = out[k][pad].shape
        out[k][pad] = torch.as_tensor(rng.normal(0.0, 1.0, shape), dtype=F64)
    assert "VolumetricMeasure" in keys or \
        bool((out["VolumetricMeasure"][pad] == 0).all())
    rows, cap = mask.shape
    perm = torch.as_tensor(np.argsort(rng.random((rows, cap)), axis=1))
    for k, v in out.items():
        if v.dim() >= 2 and v.shape[:2] == (rows, cap):
            idx = perm if v.dim() == 2 else perm[..., None].expand_as(v)
            out[k] = torch.gather(v, 1, idx)
    return out, perm


SWEEPS = ("ac1", "ac2", "density", "visc_tvc")


@pytest.mark.parametrize("name", SWEEPS)
@pytest.mark.parametrize("tag", ["2d", "3d", "tg"])
def test_padding_adds_nothing_f64(states, tag, name):
    s = _get(states, tag)
    fb, wb = s["fb"], s["wb"]
    rng = np.random.default_rng([SEEDS[tag], 1 + SWEEPS.index(name)])
    ref = _sweep(name, s, fb, wb)

    fb2, perm = _disturb(fb, rng, s["h"], ("Pressure", "Density", "Velocity",
                                            "ForcePrior"))
    wb2 = None
    if wb is not None:
        wb2, _ = _disturb(wb, rng, s["h"], ("AverageVelocity",
                                             "AverageAcceleration",
                                             "NormalDirection"))
    m2 = fb2["SlotMask"]
    assert bool(((~m2[:, :-1]) & m2[:, 1:]).any()), "no padding mid-row"
    got = _sweep(name, s, fb2, wb2)

    c = s["nbr"].shape[0]
    real = fb2["SlotMask"][:c]
    back = torch.gather(ref, 1, perm[:c, :, None].expand_as(ref))
    for ch in range(ref.shape[-1]):
        a, b = got[..., ch][real], back[..., ch][real]
        scale = float(b.abs().max())
        if name == "density" and ch == 1 and wb is None:
            assert scale == 0.0 and float(a.abs().max()) == 0.0, \
                f"{tag} density: a wall sum without a wall"
            continue
        assert scale > 0.0, f"{tag} {name} ch{ch}: all zero"
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12 * scale,
                                   err_msg=f"{tag} {name} ch{ch}")


PACKED_SWEEPS = ("ac1_inner", "ac2_inner", "ac1_flat", "ac1_t", "ac1_wall",
                 "ac2_wall")
WALL_DT = 1e-3   # the half-step the wall sweeps' i-side fields are taken at


def _packed_sweep(name, s, fb, wb):
    """One plain packed sweep on blocks `fb` (and wall blocks `wb`), packed
    as the packed halves pack them, with the engine's constants (B5b and
    B5d with the Acoustic solver's dissipation), as (C, 16, 3); B7 on
    `prep_t`'s input."""
    eng = s["scene"].eng
    r = eng.riemann1
    consts = dict(kernel_h=eng.kernel.h, factor_w=eng.kernel._factor_w(2))
    if name == "ac1_wall":
        pk_i = fbops.packed_ac1_inputs(fb, eng.eos, WALL_DT)[-1]
        force, rd = ps.ac1_wall_sweep_plain(
            pk_i, fbops.pack_wall_ac1(wb), s["nbr_wall"], **consts,
            inv_rho0c0_ave=r.inv_rho0c0_ave)
        return torch.cat([force, rd[..., None]], dim=-1)
    if name == "ac2_wall":
        pk_i = fbops.packed_ac2_inputs(fb, WALL_DT)[-1]
        dcr, pdiss = ps.ac2_wall_sweep_plain(
            pk_i, fbops.pack_wall_ac2(wb), s["nbr_wall"], **consts,
            rho0c0_geo=r.rho0c0_geo_ave, inv_c0=r.inv_c0_ave,
            limiter_coeff=r.limiter_coeff)
        return torch.cat([dcr[..., None], pdiss], dim=-1)
    packed = ps.pack_state_2d(fb["Position"], fb["Velocity"], fb["Pressure"],
                              fb["VolumetricMeasure"], fb["SlotMask"])
    layout = (1.0 / eng.kernel.h, eng.kernel._factor_w(2),
              eng.riemann1.inv_rho0c0_ave)
    if name == "ac1_flat":
        return torch.stack(ls.ac1_flat_sweep_plain(packed, s["nbr"], *layout),
                           dim=-1)
    if name == "ac1_t":
        out = ls.ac1_t_sweep_plain(*ls.prep_t(packed, s["nbr"]), *layout)
        return torch.stack(out, dim=-1).transpose(0, 1)
    if name == "ac1_inner":
        force, rd = ps.ac1_inner_sweep_plain(
            packed, s["nbr"], **consts,
            inv_rho0c0_ave=eng.riemann1.inv_rho0c0_ave)
        return torch.cat([force, rd[..., None]], dim=-1)
    dcr, pdiss = ps.ac2_inner_sweep_plain(
        packed, s["nbr"], **consts, rho0c0_geo=r.rho0c0_geo_ave,
        inv_c0=r.inv_c0_ave, limiter_coeff=r.limiter_coeff)
    return torch.cat([dcr[..., None], pdiss], dim=-1)


@pytest.mark.parametrize("name", PACKED_SWEEPS)
def test_packed_padding_adds_nothing_f64(states, name):
    s = _get(states, "2d16")
    fb, wb = s["fb"], s["wb"]
    wall = name.endswith("wall")
    rng = np.random.default_rng([SEEDS["2d16"], 1 + PACKED_SWEEPS.index(name)])
    ref = _packed_sweep(name, s, fb, wb)
    keys = ("Pressure", "Velocity", "VolumetricMeasure")
    fb2, perm = _disturb(fb, rng, s["h"],
                         keys + (("Density", "ForcePrior") if wall else ()))
    wb2 = wb
    if wall:
        wb2, _ = _disturb(wb, rng, s["h"], (
            "VolumetricMeasure", "AverageVelocity", "AverageAcceleration",
            "NormalDirection"), near=fb["Position"][fb["SlotMask"]])
    for blocks in (fb2, wb2) if wall else (fb2,):
        pad = ~blocks["SlotMask"]
        assert bool((blocks["VolumetricMeasure"][pad] != 0).all())
        assert bool(((~blocks["SlotMask"][:, :-1])
                     & blocks["SlotMask"][:, 1:]).any()), "no padding mid-row"
    got = _packed_sweep(name, s, fb2, wb2)

    c = s["nbr"].shape[0]
    real = fb2["SlotMask"][:c]
    back = torch.gather(ref, 1, perm[:c, :, None].expand_as(ref))
    for ch in range(ref.shape[-1]):
        a, b = got[..., ch][real], back[..., ch][real]
        scale = float(b.abs().max())
        assert scale > 0.0, f"{name} ch{ch}: all zero"
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12 * scale,
                                   err_msg=f"{name} ch{ch}")
