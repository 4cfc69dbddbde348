"""Parity of the port's first-generation packed acoustic sweeps (B5a-d,
ops/packed_sweeps.py) and the packed halves built on them with the JAX
package (ops/pallas_sweep.py, fluid_blocks.acoustic_step_*_pallas) on the
same inputs:

* (a) each plain sweep against JAX's Pallas kernel in interpret mode on
  five input sets — random particles whose padding carries VOL = 1, at
  1e9 (as tests/test_pallas_sweep.py builds them); moved inside the
  support of real particles, where the mask channel alone keeps it inert;
  that input with every row's slots permuted at random (padding mid-row,
  the self slot moved with its particle: the lane-group kernels compact
  the real slots and drop the self pair by slot index); real particles
  moved onto another real particle of their cell (pairs at r = 0 that are
  not the self pair); and the dambreak block state at dx = 0.1, cap 16,
  with seeded perturbations and a moving wall — at |port - JAX| <= 2e-5
  max|JAX| per channel on the real slots (the criterion of
  test_pallas_sweep.py); and a cell whose wall windows are all the
  sentinel gets exact zeros from both wall sweeps (the wall kernels'
  early exit);
* (b) the packed halves in float32 against JAX's Pallas halves (interpret)
  at rtol 2e-5 / atol 1e-5, with a static and a moving wall and the
  Acoustic, Dissipative and No solvers in the 2nd half;
* (c) the packed halves in float64 against the port's `*_b` forms at rtol
  1e-10, and the Dissipative solver's documented difference;
* (d) three acoustic sub-steps of both halves against JAX's (positions
  within 5e-5);
* (e) the Dissipative Riemann solver and the 2nd-half dispatch;
* (f) the dispatch rules of the sweeps and the halves' guards.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sphinxsys_tpu.cases import dambreak_2d as jdb2
from sphinxsys_tpu.core.adaptation import SPHAdaptation as JAdaptation
from sphinxsys_tpu.core.materials import WeaklyCompressibleFluid as JFluid
from sphinxsys_tpu.engine import scene as jsc
from sphinxsys_tpu.neighbors import grid_from_bounds
from sphinxsys_tpu.neighbors.cell_blocks import (
    build_block_map, cross_neighbor_blocks, to_blocks,
)
from sphinxsys_tpu.ops import pallas_sweep as ps
from sphinxsys_tpu.physics import fluid_blocks as jfb
from sphinxsys_tpu.physics import riemann as jrs
from sphinxsys_tpu_torch import convert
from sphinxsys_tpu_torch.cases import dambreak_2d as tdb2
from sphinxsys_tpu_torch.core.materials import WeaklyCompressibleFluid as TFluid
from sphinxsys_tpu_torch.ops import packed_sweeps as tps
from sphinxsys_tpu_torch.physics import fluid_blocks as tfb
from sphinxsys_tpu_torch.physics import riemann as trs

torch.set_num_threads(1)

TILE_C = 32
STATE_FIELDS = ("Position", "Velocity", "Density", "Pressure",
                "DensityChangeRate", "Force")
SWEEPS = ("ac1_inner", "ac2_inner", "ac1_wall", "ac2_wall")


def _t(a):
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def random_input():
    """600 random fluid and 150 random wall particles in the unit square
    (dx = 0.04) whose padding slots carry VOL = 1: packed tensors for all
    four sweeps with the padding at 1e9 ("random", the input of
    tests/test_pallas_sweep.py); with the padding moved into the square
    ("random_near"), where the mask channel alone keeps it inert; that
    input with every row's slots permuted ("random_holes"); and "random"
    with some real particles moved onto another real particle of their
    cell ("random_coincident")."""
    rng = np.random.default_rng(0)
    n, nw, dx = 600, 150, 0.04
    adaptation = JAdaptation(spacing=dx, dim=2)
    grid = grid_from_bounds((0, 0), (1, 1), adaptation.cutoff)
    c_max = TILE_C * ((grid.ncells + TILE_C - 1) // TILE_C)
    pos = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    wpos = rng.uniform(0, 1, (nw, 2)).astype(np.float32)
    bm = build_block_map(jnp.asarray(pos), jnp.int32(n), grid, cap=16,
                         c_max=c_max)
    bmw = build_block_map(jnp.asarray(wpos), jnp.int32(nw), grid, cap=16,
                          c_max=c_max)
    assert not bool(bm.overflow) and not bool(bmw.overflow)
    nbr_w = cross_neighbor_blocks(bm.occ_cells, grid, bmw)

    def blocks(b, arr, fill=1.0):
        return to_blocks(b, jnp.asarray(arr, jnp.float32), fill=fill)

    def mask(b):
        m = b.slot_mask.reshape(b.c_max, 16)
        return jnp.concatenate([m, jnp.zeros((1, 16), bool)], axis=0)

    m, mw = mask(bm), mask(bmw)
    p = rng.uniform(0, 1, n)
    vel = rng.normal(size=(n, 2))
    packed = ps.pack_state_2d(blocks(bm, pos, 1e9), blocks(bm, vel),
                              blocks(bm, p), blocks(bm, np.full(n, dx * dx)), m)
    fm = m.astype(jnp.float32)
    z = jnp.zeros_like(fm)
    rho = blocks(bm, 1.0 + rng.uniform(-0.01, 0.02, n))
    acc = blocks(bm, rng.normal(size=(n, 2)))
    packed_i1 = jnp.stack([packed[..., 0], packed[..., 1], packed[..., 4], rho,
                           acc[..., 0], acc[..., 1], fm, z], axis=-1)
    packed_i2 = jnp.stack([packed[..., 0], packed[..., 1], packed[..., 2],
                           packed[..., 3], fm, z, z, z], axis=-1)
    normal = rng.normal(size=(nw, 2))
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    wall_b = {"Position": blocks(bmw, wpos, 1e9),
              "VolumetricMeasure": blocks(bmw, np.full(nw, dx * dx)),
              "AverageAcceleration": blocks(bmw, rng.normal(size=(nw, 2))),
              "AverageVelocity": blocks(bmw, rng.normal(0.0, 0.3, (nw, 2))),
              "NormalDirection": blocks(bmw, normal), "SlotMask": mw}
    far = dict(packed=packed, nbr=bm.nbr_block, packed_i1=packed_i1,
               packed_i2=packed_i2, wall1=jfb.pack_wall_ac1(wall_b),
               wall2=jfb.pack_wall_ac2(wall_b), nbr_w=nbr_w,
               real=np.asarray(m[:c_max]), kernel=adaptation.kernel)

    def near(pk, mk):
        """Padding slots moved to random points of the square: within the
        support of real neighbours, so the mask is their only guard."""
        xy = jnp.asarray(rng.uniform(0, 1, pk.shape[:2] + (2,)), jnp.float32)
        return pk.at[..., :2].set(jnp.where(mk[..., None], pk[..., :2], xy))

    near_inp = dict(far, packed=near(packed, m), wall1=near(far["wall1"], mw),
                    wall2=near(far["wall2"], mw))

    def holes(inp):
        """Every row's slots permuted at random, fluid and wall rows (each
        side's packed tensors alike): padding sits mid-row and the self
        slot moves with its particle."""
        pf = np.argsort(rng.random(m.shape), axis=1)
        pw = np.argsort(rng.random(mw.shape), axis=1)

        def take(a, perm):
            return jnp.take_along_axis(a, jnp.asarray(perm)[..., None], axis=1)

        real = np.take_along_axis(np.asarray(m), pf, axis=1)[:c_max]
        assert np.any(~real[:, :-1] & real[:, 1:]), "no padding mid-row"
        return dict(inp, packed=take(inp["packed"], pf),
                    packed_i1=take(inp["packed_i1"], pf),
                    packed_i2=take(inp["packed_i2"], pf),
                    wall1=take(inp["wall1"], pw), wall2=take(inp["wall2"], pw),
                    real=real)

    def coincident(inp):
        """In half the rows with two real slots or more, slot 1's particle
        moved onto slot 0's position (fluid side): real pairs at r = 0."""
        mk = np.asarray(m)
        pick = mk[:, 0] & mk[:, 1] & (rng.random(mk.shape[0]) < 0.5)
        assert pick.sum() >= 10
        out = dict(inp)
        for k in ("packed", "packed_i1", "packed_i2"):
            a = np.array(inp[k])
            a[pick, 1, :2] = a[pick, 0, :2]
            out[k] = jnp.asarray(a)
        return out

    return {"random": far, "random_near": near_inp,
            "random_holes": holes(near_inp),
            "random_coincident": coincident(far)}


def _moving(wall, seed):
    """The wall with seeded non-zero velocity and acceleration."""
    w = dict(wall)
    rng = np.random.default_rng(seed)
    m = w["SlotMask"]
    shape = w["Position"][m].shape
    for k, s in (("AverageVelocity", 0.2), ("AverageAcceleration", 1.0)):
        w[k] = w[k].copy()
        w[k][m] = rng.normal(0.0, s, shape)
    return w


@pytest.fixture(scope="module")
def dambreak():
    """JAX's 2D dambreak block scene at dx = 0.1 with cap 16 (f32), its
    slotted initial state with seeded noise on the real slots, its wall
    (static and moving), and the port's scene."""
    jscene, jfluid = jdb2.build_block_case(dx=0.1, cap=16, tile_c=TILE_C)
    sim = jsc.init_sim(jscene, jfluid)
    fb = {k: np.array(v) for k, v in sim.fluid_b.items()}
    rng = np.random.default_rng(4)
    m = fb["SlotMask"]
    n = int(m.sum())
    fb["Position"][m] += rng.uniform(-0.02, 0.02, (n, 2))
    fb["Velocity"][m] = rng.normal(0.0, 0.3, (n, 2))
    fb["Density"][m] = 1.0 + rng.uniform(-0.01, 0.02, n)
    fb["Pressure"][m] = rng.normal(0.0, 2.0, n)
    fb["DensityChangeRate"][m] = rng.normal(0.0, 0.1, n)
    fb["Force"][m] = rng.normal(0.0, 0.05, (n, 2))
    fb["ForcePrior"][m] += rng.normal(0.0, 0.01, (n, 2))
    wall = {k: np.array(v) for k, v in jscene.wall_b.items()}
    tscene, _ = tdb2.build_block_case(dx=0.1, cap=16, device="cpu")
    return dict(jscene=jscene, tscene=tscene, fb=fb, static=wall,
                moving=_moving(wall, 3), nbr=np.asarray(sim.nbr_inner),
                nbr_wall=np.asarray(sim.nbr_wall))


def _dambreak_input(d):
    """The four sweeps' packed inputs from the perturbed dambreak state at
    the 1st half's half-step fields (dt = 5e-3), moving wall."""
    base = d["jscene"].base
    fb = {k: jnp.asarray(v) for k, v in d["fb"].items()}
    wall = {k: jnp.asarray(v) for k, v in d["moving"].items()}
    mask = fb["SlotMask"]
    rho = jnp.where(mask, fb["Density"] + fb["DensityChangeRate"] * 2.5e-3,
                    fb["Density"])
    p = base.eos.pressure(rho)
    pos = fb["Position"] + jnp.where(mask[..., None], fb["Velocity"] * 2.5e-3,
                                     0.0)
    vol = fb["VolumetricMeasure"]
    fm = mask.astype(p.dtype)
    z = jnp.zeros_like(p)
    acc = fb["ForcePrior"] / jnp.maximum(fb["Mass"], jfb.TINY)[..., None]
    c = d["nbr"].shape[0]
    return dict(
        packed=ps.pack_state_2d(pos, fb["Velocity"], p, vol, mask),
        nbr=jnp.asarray(d["nbr"]),
        packed_i1=jnp.stack([pos[..., 0], pos[..., 1], p, rho, acc[..., 0],
                             acc[..., 1], fm, z], axis=-1),
        packed_i2=jnp.stack([pos[..., 0], pos[..., 1], fb["Velocity"][..., 0],
                             fb["Velocity"][..., 1], fm, z, z, z], axis=-1),
        wall1=jfb.pack_wall_ac1(wall), wall2=jfb.pack_wall_ac2(wall),
        nbr_w=jnp.asarray(d["nbr_wall"]), real=np.asarray(mask[:c]),
        kernel=base.kernel, eos=base.eos)


def _sweep_args(inp, name, riemann):
    """(JAX call, port call) of one sweep on the same inputs and float
    constants."""
    k = inp["kernel"]
    consts = dict(kernel_h=k.h, factor_w=k._factor_w(2))
    if name.startswith("ac1"):
        consts["inv_rho0c0_ave"] = riemann.inv_rho0c0_ave
    else:
        consts.update(rho0c0_geo=riemann.rho0c0_geo_ave,
                      inv_c0=riemann.inv_c0_ave,
                      limiter_coeff=riemann.limiter_coeff)
    if name.endswith("inner"):
        arrays = (inp["packed"], inp["nbr"])
    else:
        i = inp["packed_i1"] if name.startswith("ac1") else inp["packed_i2"]
        w = inp["wall1"] if name.startswith("ac1") else inp["wall2"]
        arrays = (i, w, inp["nbr_w"])
    jout = getattr(ps, f"{name}_sweep")(*arrays, **consts, tile_c=TILE_C,
                                        interpret=True)
    tout = getattr(tps, f"{name}_sweep")(*(_t(a) for a in arrays), **consts)
    return jout, tout


def _channels(out):
    """A sweep's (a, b) outputs as a list of (C, 16) channels."""
    chans = []
    for a in out:
        a = np.asarray(a) if not torch.is_tensor(a) else a.numpy()
        chans += [a] if a.ndim == 2 else [a[..., k] for k in range(a.shape[-1])]
    return chans


# ---------------------------------------------------------------------------
# (a) each plain sweep against the Pallas kernel (interpret)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SWEEPS)
@pytest.mark.parametrize("which", ["random", "random_near", "random_holes",
                                   "random_coincident", "dambreak"])
def test_plain_sweep_matches_pallas_interpret(random_input, dambreak, which,
                                              name):
    if which != "dambreak":
        inp = random_input[which]
        eos = JFluid(rho0=1.0, c0=10.0)
    else:
        inp = _dambreak_input(dambreak)
        eos = inp["eos"]
    jout, tout = _sweep_args(inp, name, jrs.acoustic_riemann(eos))
    real = inp["real"]
    for ch, (a, b) in enumerate(zip(_channels(tout), _channels(jout))):
        scale = np.abs(b[real]).max() + 1e-9
        assert scale > 1e-6, f"{which} {name} ch{ch}: channel is all zero"
        np.testing.assert_allclose(a[real] / scale, b[real] / scale, atol=2e-5,
                                   err_msg=f"{which} {name} ch{ch}")
        # padding slots add nothing and receive nothing
        assert not np.any(a[~real]), f"{which} {name} ch{ch}: padding"


@pytest.mark.parametrize("name", ["ac1_wall", "ac2_wall"])
def test_wall_sweep_cells_without_wall_window_get_zeros(random_input, name):
    """The property B5c/B5d's early exit rests on: a cell whose wall windows
    are all the sentinel gets exact zeros in every slot, real ones included,
    from JAX's Pallas kernel (interpret) and from the plain version; every
    other cell keeps its sums exactly."""
    inp = random_input["random_near"]
    nbr_w = np.array(inp["nbr_w"])
    cw = inp["wall1"].shape[0] - 1
    cut = ((nbr_w < cw).any(axis=1) & inp["real"].any(axis=1)
           & (np.arange(nbr_w.shape[0]) % 2 == 0))
    assert cut.sum() >= 10
    nbr_cut = nbr_w.copy()
    nbr_cut[cut] = cw
    riemann = jrs.acoustic_riemann(JFluid(rho0=1.0, c0=10.0))
    jref, tref = _sweep_args(inp, name, riemann)
    jout, tout = _sweep_args(dict(inp, nbr_w=jnp.asarray(nbr_cut)), name,
                             riemann)
    for ch, (t, j, t0, j0) in enumerate(zip(_channels(tout), _channels(jout),
                                            _channels(tref), _channels(jref))):
        assert np.abs(t0[cut]).max() > 0.0, f"{name} ch{ch}: nothing to cut"
        assert not np.any(t[cut]) and not np.any(j[cut]), f"{name} ch{ch}"
        np.testing.assert_array_equal(t[~cut], t0[~cut], err_msg=f"ch{ch}")
        np.testing.assert_array_equal(j[~cut], j0[~cut], err_msg=f"ch{ch}")


# ---------------------------------------------------------------------------
# (b) the packed halves against JAX's Pallas halves, float32
# ---------------------------------------------------------------------------

def _solvers(kind, jeos, teos):
    make = {"acoustic": (jrs.acoustic_riemann, trs.acoustic_riemann),
            "dissipative": (jrs.dissipative_riemann, trs.dissipative_riemann),
            "no": (jrs.no_riemann, trs.no_riemann)}[kind]
    return make[0](jeos), make[1](teos)


def _both(d, dtype, wall):
    cast = lambda x: {k: (v.astype(dtype) if v.dtype.kind == "f" else v)
                      for k, v in x.items()}
    fb, wb = cast(d["fb"]), cast(wall)
    jin = ({k: jnp.asarray(v) for k, v in fb.items()},
           {k: jnp.asarray(v) for k, v in wb.items()})
    tin = (convert.block_state_from_numpy(fb),
           convert.block_state_from_numpy(wb))
    return jin, tin


def _assert_states(got, ref, mask, rtol, atol, what):
    for k in STATE_FIELDS:
        np.testing.assert_allclose(convert.to_numpy(got[k])[mask],
                                   np.asarray(ref[k])[mask], rtol=rtol,
                                   atol=atol, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("solver2", ["acoustic", "dissipative", "no"])
@pytest.mark.parametrize("wall", ["static", "moving"])
def test_packed_halves_match_pallas_interpret_f32(dambreak, wall, solver2):
    d = dambreak
    base, eng = d["jscene"].base, d["tscene"].eng
    (jf, jw), (tf, tw) = _both(d, np.float32, d[wall])
    jn, tn = jnp.asarray(d["nbr"]), _t(d["nbr"])
    jnw, tnw = jnp.asarray(d["nbr_wall"]), _t(d["nbr_wall"])
    jr2, tr2 = _solvers(solver2, base.eos, eng.eos)
    mask = d["fb"]["SlotMask"]
    tol = dict(rtol=2e-5, atol=1e-5)
    dt = jnp.asarray(5e-3, jnp.float32)
    tdt = torch.tensor(5e-3, dtype=torch.float32)

    ref1 = jfb.acoustic_step_1st_half_pallas(
        jf, jn, base.kernel, base.eos, base.riemann, dt,
        wall_packed=jfb.pack_wall_ac1(jw), nbr_wall=jnw, tile_c=TILE_C,
        interpret=True)
    got1 = tfb.acoustic_step_1st_half_packed(
        tf, tn, eng.kernel, eng.eos, eng.riemann1, tdt,
        wall_packed=tfb.pack_wall_ac1(tw), nbr_wall=tnw)
    _assert_states(got1, ref1, mask, **tol, what=f"1st half ({wall} wall)")
    ref2 = jfb.acoustic_step_2nd_half_pallas(
        ref1, jn, base.kernel, jr2, dt, wall_packed=jfb.pack_wall_ac2(jw),
        nbr_wall=jnw, tile_c=TILE_C, interpret=True)
    got2 = tfb.acoustic_step_2nd_half_packed(
        got1, tn, eng.kernel, tr2, tdt, wall_packed=tfb.pack_wall_ac2(tw),
        nbr_wall=tnw)
    _assert_states(got2, ref2, mask, **tol,
                   what=f"2nd half ({wall} wall, {solver2} solver)")


# ---------------------------------------------------------------------------
# (c) the packed halves against the `*_b` forms, float64
# ---------------------------------------------------------------------------

def _halves(tf, tw, tn, tnw, eng, solver2, dt, packed):
    if packed:
        one = tfb.acoustic_step_1st_half_packed(
            tf, tn, eng.kernel, eng.eos, eng.riemann1, dt,
            wall_packed=tfb.pack_wall_ac1(tw), nbr_wall=tnw)
        return one, tfb.acoustic_step_2nd_half_packed(
            one, tn, eng.kernel, solver2, dt,
            wall_packed=tfb.pack_wall_ac2(tw), nbr_wall=tnw)
    one = tfb.acoustic_step_1st_half_b(tf, tn, eng.kernel, 2, eng.eos,
                                       eng.riemann1, dt, wall_b=tw,
                                       nbr_wall=tnw)
    return one, tfb.acoustic_step_2nd_half_b(one, tn, eng.kernel, 2, solver2,
                                             dt, wall_b=tw, nbr_wall=tnw)


@pytest.mark.parametrize("solver2", ["acoustic", "no", "dissipative"])
def test_packed_halves_match_b_forms_f64(dambreak, solver2):
    """With the moving wall.  The Dissipative solver is the documented
    reference-side difference: the packed 2nd half passes it limiter 1e30,
    as JAX's Pallas path does, so min(1e30 inv_c0 max(u, 0), 1) drops the
    pairs with u <= 0, which its `*_b` form (limiter == 1) keeps as
    rho0c0_geo u.  The packed half then equals the `*_b` form of an
    acoustic solver with limiter_coeff 1e30, and differs from the
    Dissipative `*_b` form in the force only."""
    d = dambreak
    eng = d["tscene"].eng
    _, (tf, tw) = _both(d, np.float64, d["moving"])
    tn, tnw = _t(d["nbr"]), _t(d["nbr_wall"])
    mask = d["fb"]["SlotMask"]
    _, solver = _solvers(solver2, d["jscene"].base.eos, eng.eos)
    tol = dict(rtol=1e-10, atol=1e-12)
    got1, got2 = _halves(tf, tw, tn, tnw, eng, solver, 5e-3, True)
    if solver2 != "dissipative":
        ref1, ref2 = _halves(tf, tw, tn, tnw, eng, solver, 5e-3, False)
        _assert_states(got1, ref1, mask, **tol, what="1st half")
        _assert_states(got2, ref2, mask, **tol, what=f"2nd half ({solver2})")
        return
    cut = trs.AcousticRiemannSolver(
        rho0c0_i=solver.rho0c0_i, rho0c0_j=solver.rho0c0_j,
        inv_c0_ave=solver.inv_c0_ave, limiter_coeff=1.0e30)
    _, ref_cut = _halves(tf, tw, tn, tnw, eng, cut, 5e-3, False)
    _assert_states(got2, ref_cut, mask, **tol, what="2nd half (limiter 1e30)")
    _, ref_diss = _halves(tf, tw, tn, tnw, eng, solver, 5e-3, False)
    got_f = got2["Force"][mask].numpy()
    ref_f = ref_diss["Force"][mask].numpy()
    assert np.abs(got_f - ref_f).max() > 1e-3 * np.abs(ref_f).max()
    np.testing.assert_allclose(got2["DensityChangeRate"][mask].numpy(),
                               ref_diss["DensityChangeRate"][mask].numpy(),
                               **tol)


# ---------------------------------------------------------------------------
# (d) acoustic sub-steps against JAX's
# ---------------------------------------------------------------------------

def test_packed_substeps_match_jax(dambreak):
    """Three sub-steps of both halves from the perturbed state with the
    static wall, each side taking its own acoustic dt: equal dt within
    1e-6, positions within 5e-5 on the real slots."""
    d = dambreak
    base, eng = d["jscene"].base, d["tscene"].eng
    (jf, jw), (tf, tw) = _both(d, np.float32, d["static"])
    jn, tn = jnp.asarray(d["nbr"]), _t(d["nbr"])
    jnw, tnw = jnp.asarray(d["nbr_wall"]), _t(d["nbr_wall"])
    jw1, jw2 = jfb.pack_wall_ac1(jw), jfb.pack_wall_ac2(jw)
    tw1, tw2 = tfb.pack_wall_ac1(tw), tfb.pack_wall_ac2(tw)
    h = base.adaptation.h
    for _ in range(3):
        jdt = jfb.acoustic_time_step_b(jf, base.eos, h)
        tdt = tfb.acoustic_time_step_b(tf, eng.eos, eng.h)
        assert float(tdt) == pytest.approx(float(jdt), rel=1e-6)
        jf = jfb.acoustic_step_2nd_half_pallas(
            jfb.acoustic_step_1st_half_pallas(
                jf, jn, base.kernel, base.eos, base.riemann, jdt,
                wall_packed=jw1, nbr_wall=jnw, tile_c=TILE_C, interpret=True),
            jn, base.kernel, base.riemann, jdt, wall_packed=jw2, nbr_wall=jnw,
            tile_c=TILE_C, interpret=True)
        tf = tfb.acoustic_step_2nd_half_packed(
            tfb.acoustic_step_1st_half_packed(
                tf, tn, eng.kernel, eng.eos, eng.riemann1, tdt,
                wall_packed=tw1, nbr_wall=tnw),
            tn, eng.kernel, eng.riemann2, tdt, wall_packed=tw2, nbr_wall=tnw)
    mask = d["fb"]["SlotMask"]
    err = np.abs(tf["Position"][mask].numpy()
                 - np.asarray(jf["Position"])[mask]).max()
    assert err <= 5e-5


# ---------------------------------------------------------------------------
# (e) the Dissipative solver and the 2nd-half dispatch
# ---------------------------------------------------------------------------

def test_dissipative_solver_matches_jax():
    jeos = JFluid(rho0=1.0, c0=20.0)
    teos = TFluid(rho0=1.0, c0=20.0)
    j, t = jrs.dissipative_riemann(jeos), trs.dissipative_riemann(teos)
    assert isinstance(t, trs.AcousticRiemannSolver)
    for k in ("rho0c0_i", "rho0c0_j", "inv_c0_ave", "limiter_coeff",
              "inv_rho0c0_ave", "rho0c0_geo_ave"):
        assert getattr(t, k) == getattr(j, k), k
    u = np.linspace(-3.0, 3.0, 13)
    np.testing.assert_allclose(
        t.dissipative_p_jump(torch.as_tensor(u)).numpy(),
        np.asarray(j.dissipative_p_jump(jnp.asarray(u, jnp.float32))),
        rtol=1e-6)


@pytest.mark.parametrize("kind", ["acoustic", "dissipative", "no"])
def test_ac2_dispatch_matches_jax(kind):
    """`ac2_limiter` gives the (rho0c0_geo, limiter) of JAX's Pallas
    dispatch (fluid_blocks.py:383-388, :802-807): Dissipative is tested
    before its base class, so it gets 1e30 and not the Acoustic 3."""
    jeos = JFluid(rho0=1.0, c0=20.0)
    teos = TFluid(rho0=1.0, c0=20.0)
    j, t = _solvers(kind, jeos, teos)
    if isinstance(j, jrs.DissipativeRiemannSolver):
        want = (j.rho0c0_geo_ave, 1.0e30)
    elif isinstance(j, jrs.AcousticRiemannSolver):
        want = (j.rho0c0_geo_ave, j.limiter_coeff)
    else:
        want = (0.0, 1.0)
    assert tfb.ac2_limiter(t) == want
    assert tfb.ac2_dissipation(t) == (want[0], want[1] * t.inv_c0_ave)


# ---------------------------------------------------------------------------
# (f) dispatch and guards
# ---------------------------------------------------------------------------

def test_sweep_dispatch(dambreak):
    """CPU tensors run the plain version (no launch counted); another
    device raises."""
    inp = _dambreak_input(dambreak)
    tps.reset_launch_counts()
    packed, nbr = _t(inp["packed"]), _t(inp["nbr"])
    force, rd = tps.ac1_inner_sweep(packed, nbr, 0.1, 1.0, 1.0)
    assert force.shape == (nbr.shape[0], 16, 2) and rd.shape == (nbr.shape[0], 16)
    assert tps.LAUNCHES == dict.fromkeys(tps.LAUNCHES, 0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tps.ac2_wall_sweep(packed.to("meta"), packed.to("meta"),
                           nbr.to("meta"), 0.1, 1.0, 1.0, 1.0, 1.0)


@pytest.mark.parametrize("bad", ["dim", "cap", "box"])
def test_packed_halves_guard_their_case(dambreak, bad):
    """The packed halves are 2D, cap 16 and non-periodic only."""
    d = dambreak
    eng = d["tscene"].eng
    _, (tf, _) = _both(d, np.float32, d["static"])
    tn = _t(d["nbr"])
    kw = {}
    if bad == "dim":
        tf = dict(tf, Position=torch.cat([tf["Position"],
                                          tf["Position"][..., :1]], dim=-1))
    elif bad == "cap":
        tf = {k: v[:, :12] for k, v in tf.items()}
    else:
        kw["box"] = (1.0, 0.0)
    for half in (lambda: tfb.acoustic_step_1st_half_packed(
                     tf, tn, eng.kernel, eng.eos, eng.riemann1, 1e-3, **kw),
                 lambda: tfb.acoustic_step_2nd_half_packed(
                     tf, tn, eng.kernel, eng.riemann2, 1e-3, **kw)):
        with pytest.raises(ValueError, match="packed acoustic halves"):
            half()
