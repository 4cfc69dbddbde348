"""Parity of the port's neighbour-list fluid (physics/fluid.py), the two
neighbour-list FSI couplings (physics/fsi.py) and the Morton resort
(neighbors/cell_list.py) with the JAX package, on the CPU in float64.

Inputs, made from a seed with numpy and fed to both sides as the same
arrays, on three scenes at their test sizes:
  * "dambreak": the 2D dambreak at dx = 0.1, fluid and wall padded to a
    multiple of 256 rows (the fluid's 56 padding rows parked far away with
    a large velocity, so that an unmasked reduction shows), a static wall;
  * "fsi2": fsi2 at dx = 0.1, x-periodic, two walls (the strips and the
    elastic insert) with nonzero AverageVelocity and AverageAcceleration,
    a few insert normals zero (sign(0) = 0 on both sides);
  * "tg": Taylor–Green at dx = 0.05, doubly periodic, no wall.
Each state's positions are moved by up to 0.1 dx and its velocity,
density, density rate and forces perturbed.  The port's neighbour lists
equal JAX's; JAX's lists are carried across, so both sides sum the same
slots.  Every output field is held within 1e-12 of its max|ref| (float64
roundoff of the K-slot sums).  The Morton keys equal JAX's bit for bit and
the resort permutation index for index, with padding rows and tied keys.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sphinxsys_tpu.cases import dambreak_2d as jdb, fsi2 as jf, \
    taylor_green_2d as jtg
from sphinxsys_tpu.neighbors import cell_list as jcl
from sphinxsys_tpu.physics import fluid as jfd
from sphinxsys_tpu.physics import fsi as jfsi
from sphinxsys_tpu.physics import riemann as jrs
from sphinxsys_tpu_torch import convert
from sphinxsys_tpu_torch.cases import dambreak_2d as tdb, fsi2 as tf, \
    taylor_green_2d as ttg
from sphinxsys_tpu_torch.neighbors import cell_list as tcl
from sphinxsys_tpu_torch.neighbors.neighbor_list import NeighborList
from sphinxsys_tpu_torch.physics import fluid as tfd
from sphinxsys_tpu_torch.physics import fsi as tfsi
from sphinxsys_tpu_torch.physics import riemann as trs

torch.set_num_threads(1)

TOL = 1e-12
DT = 2e-3


def _close(got, ref, tol=TOL, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max()
    scale = np.abs(ref).max()
    assert err <= tol * max(scale, 1e-300), f"{what}: {err:.3e} vs {scale:.3e}"


def _np(state):
    return {k: np.array(v) for k, v in state.items()}   # writable copies


def _perturb(state, rng, dx, vel=0.5, n_real=None):
    """Positions moved by up to 0.1 dx; velocity, density, density rate,
    pressure and forces perturbed (real rows only; padding rows keep
    their far position and get a velocity of 100)."""
    s = _np(state)
    n = s["Position"].shape[0]
    n_real = n if n_real is None else n_real
    real = np.arange(n) < n_real
    shape = s["Position"].shape
    s["Position"] = np.where(real[:, None], s["Position"] + 0.1 * dx
                             * (rng.random(shape) - 0.5), s["Position"])
    s["Velocity"] = np.where(real[:, None], vel * rng.normal(size=shape),
                             100.0)
    for k, scale in (("Density", 0.01), ("DensityChangeRate", 0.1),
                     ("Pressure", 1.0)):
        if k in s:
            base = 1.0 if k == "Density" else 0.0
            s[k] = base + scale * rng.normal(size=n)
    for k in ("Force", "ForcePrior"):
        if k in s:
            s[k] = s[k] + 0.1 * rng.normal(size=shape) * s["Mass"][:, None]
    return s


def _wall_motion(state, rng):
    s = _np(state)
    shape = s["Position"].shape
    s["AverageVelocity"] = 0.3 * rng.normal(size=shape)
    s["AverageAcceleration"] = 2.0 * rng.normal(size=shape)
    return s


def _lists_equal(t_nl, j_nl):
    np.testing.assert_array_equal(t_nl.idx.numpy(), np.asarray(j_nl.idx))
    np.testing.assert_array_equal(t_nl.count.numpy(), np.asarray(j_nl.count))
    assert bool(t_nl.overflow) == bool(j_nl.overflow) is False


def _carried(j_nl):
    return NeighborList(idx=torch.as_tensor(np.asarray(j_nl.idx)),
                        count=torch.as_tensor(np.asarray(j_nl.count)),
                        overflow=torch.as_tensor(bool(j_nl.overflow)))


def _to_jax(s):
    return {k: (jnp.asarray(v, jnp.int32) if k == "NReal" else jnp.asarray(v))
            for k, v in s.items()}


@dataclasses.dataclass
class Scene:
    """One scene's inputs on both sides: "fluid", walls as (state, list)
    pairs, contacts as (state, list, rho0), the box and the constants."""

    j: dict
    t: dict
    kernel_j: object
    kernel_t: object
    dim: int
    box: tuple
    consts: dict


def _dambreak(rng):
    jcase, jfluid = jdb.build_case(dx=0.1, dtype=jnp.float64,
                                   capacity_multiple=256)
    n_real = int(jfluid["NReal"])
    fl = _perturb(jfluid, rng, 0.1, n_real=n_real)
    jwall = jcase.wall
    jin, jw = jdb.rebuild_relations(jcase, _to_jax(fl))
    tcase, _ = tdb.build_case(dx=0.1, dtype=torch.float64, device="cpu")
    tfl = convert.state_from_numpy(fl)
    twall = convert.state_from_numpy(_np(jwall))     # padded as JAX's
    tcase = dataclasses.replace(tcase, wall=twall, wall_table=(
        tcl.build_cell_table(twall["Position"], twall["NReal"], tcase.grid,
                             tcase.cell_cap)))
    tin, tw = tdb.rebuild_relations(tcase, tfl)
    _lists_equal(tin, jin)
    _lists_equal(tw, jw)
    assert n_real == 200 and fl["Position"].shape[0] == 256
    return Scene(
        j=dict(fluid=_to_jax(fl), inner=jin, walls=[(jwall, jw)],
               contacts=[(jwall, jw, 1.0)], eos=jcase.eos,
               riemann=jcase.riemann),
        t=dict(fluid=tfl, inner=_carried(jin), walls=[(twall, _carried(jw))],
               contacts=[(twall, _carried(jw), 1.0)], eos=tcase.eos,
               riemann=tcase.riemann),
        kernel_j=jcase.kernel, kernel_t=tcase.kernel, dim=2, box=None,
        consts=dict(h=jcase.adaptation.h, sigma0=jcase.adaptation.sigma0,
                    rho0=1.0, mu=0.0, free_surface=True))


def _fsi2(rng):
    jcase, jfluid, jsolid = jf.build_case(dx=0.1, dtype=jnp.float64)
    fl = _perturb(jfluid, rng, 0.1)
    so = _wall_motion(jsolid, rng)
    so["NormalDirection"][:5] = 0.0
    wl = _wall_motion(jcase.wall, rng)
    jcase = dataclasses.replace(jcase, wall=_to_jax(wl))
    pos_f, jff, jfw, jfs, jsf, _ = jf.rebuild_relations(jcase, _to_jax(fl),
                                                        _to_jax(so))
    fl["Position"] = np.asarray(pos_f)
    tcase, _, _ = tf.build_case(dx=0.1, dtype=torch.float64, device="cpu")
    twl = convert.state_from_numpy(wl)
    tcase = dataclasses.replace(tcase, wall=twl)
    tfl, tso = convert.state_from_numpy(fl), convert.state_from_numpy(so)
    tpos, tff, tfw, tfs, tsf, _ = tf.rebuild_relations(tcase, tfl, tso)
    np.testing.assert_array_equal(tpos.numpy(), fl["Position"])
    for t_nl, j_nl in ((tff, jff), (tfw, jfw), (tfs, jfs), (tsf, jsf)):
        _lists_equal(t_nl, j_nl)
    jso = _to_jax(so)
    return Scene(
        j=dict(fluid=_to_jax(fl), inner=jff, solid=jso, sf=jsf,
               walls=[(jcase.wall, jfw), (jso, jfs)],
               contacts=[(jcase.wall, jfw, 1.0), (jso, jfs, 10.0)],
               eos=jcase.eos, riemann=jcase.riemann,
               no_riemann=jcase.no_riemann),
        t=dict(fluid=tfl, inner=_carried(jff), solid=tso, sf=_carried(jsf),
               walls=[(twl, _carried(jfw)), (tso, _carried(jfs))],
               contacts=[(twl, _carried(jfw), 1.0), (tso, _carried(jfs), 10.0)],
               eos=tcase.eos, riemann=tcase.riemann,
               no_riemann=tcase.no_riemann),
        kernel_j=jcase.kernel, kernel_t=tcase.kernel, dim=2, box=jcase.box,
        consts=dict(h=jcase.adaptation.h, sigma0=jcase.adaptation.sigma0,
                    rho0=1.0, mu=jf.MU_F, free_surface=False))


def _tg(rng):
    jcase, jfluid = jtg.build_case(dx=0.05, dtype=jnp.float64)
    fl = _perturb(jfluid, rng, 0.05, vel=1.0)
    fl["ViscousForcePrev"] = 1e-3 * rng.normal(size=fl["Velocity"].shape)
    pos, jin = jtg.rebuild_inner(jcase, _to_jax(fl))
    fl["Position"] = np.asarray(pos)
    tcase, _ = ttg.build_case(dx=0.05, dtype=torch.float64, device="cpu")
    tfl = convert.state_from_numpy(fl)
    tpos, tin = ttg.rebuild_inner(tcase, tfl)
    np.testing.assert_array_equal(tpos.numpy(), fl["Position"])
    _lists_equal(tin, jin)
    return Scene(
        j=dict(fluid=_to_jax(fl), inner=jin, walls=[], contacts=[],
               eos=jcase.eos, riemann=jcase.riemann,
               no_riemann=jcase.no_riemann),
        t=dict(fluid=tfl, inner=_carried(jin), walls=[], contacts=[],
               eos=tcase.eos, riemann=tcase.riemann,
               no_riemann=tcase.no_riemann),
        kernel_j=jcase.kernel, kernel_t=tcase.kernel, dim=2, box=jcase.box,
        consts=dict(h=jcase.adaptation.h, sigma0=jcase.adaptation.sigma0,
                    rho0=1.0, mu=jtg.MU_F, free_surface=False))


@pytest.fixture(scope="module")
def scenes():
    return {name: fn(np.random.default_rng(seed)) for seed, (name, fn) in
            enumerate((("dambreak", _dambreak), ("fsi2", _fsi2), ("tg", _tg)))}


SCENES = ("dambreak", "fsi2", "tg")


def _both(sc, fn_j, fn_t, **kw):
    """Call the JAX function and the port's on the scene's inputs; `kw`
    maps an argument name to a callable (side dict -> value)."""
    j = fn_j(**{k: (v(sc.j) if callable(v) else v) for k, v in kw.items()})
    t = fn_t(**{k: (v(sc.t) if callable(v) else v) for k, v in kw.items()})
    return j, t


def _hold_state(t, j, what):
    for k, v in j.items():
        if k == "NReal":
            continue
        _close(t[k].numpy(), v, what=f"{what} {k}")


@pytest.mark.parametrize("name", SCENES)
def test_density_summation_matches_jax(scenes, name):
    sc = scenes[name]
    c = sc.consts
    for fn_j, fn_t in ((jfd.density_summation, tfd.density_summation),):
        j = fn_j(sc.j["fluid"], sc.j["inner"], sc.kernel_j, sc.dim, c["rho0"],
                 c["sigma0"], contacts=sc.j["contacts"],
                 free_surface=c["free_surface"], box=sc.box)
        t = fn_t(sc.t["fluid"], sc.t["inner"], sc.kernel_t, sc.dim, c["rho0"],
                 c["sigma0"], contacts=sc.t["contacts"],
                 free_surface=c["free_surface"], box=sc.box)
        _hold_state(t, j, f"{name} density_summation")


def _halves(sc, side, which, riemann_key, wall_kw, wall_riemann=None):
    d = sc.j if side == "j" else sc.t
    fd = jfd if side == "j" else tfd
    kernel = sc.kernel_j if side == "j" else sc.kernel_t
    kw = dict(box=sc.box, wall_riemann=wall_riemann)
    if wall_kw == "wall" and d["walls"]:
        kw.update(wall=d["walls"][0][0], nl_wall=d["walls"][0][1])
    else:
        kw.update(walls=d["walls"])
    if which == 1:
        return fd.acoustic_step_1st_half(d["fluid"], d["inner"], kernel,
                                         sc.dim, d["eos"], d[riemann_key],
                                         DT, **kw)
    return fd.acoustic_step_2nd_half(d["fluid"], d["inner"], kernel, sc.dim,
                                     d[riemann_key], DT, **kw)


HALVES = [   # (scene, half, solver, wall argument, Dissipative wall solver)
    ("dambreak", 1, "riemann", "wall", False),
    ("dambreak", 2, "riemann", "wall", False),
    ("dambreak", 1, "riemann", "walls", True),
    ("dambreak", 2, "riemann", "walls", True),
    ("fsi2", 1, "riemann", "walls", False),
    ("fsi2", 2, "riemann", "walls", False),
    ("fsi2", 2, "no_riemann", "walls", False),
    ("tg", 1, "riemann", "walls", False),
    ("tg", 2, "riemann", "walls", False),
    ("tg", 2, "no_riemann", "walls", False),
]


@pytest.mark.parametrize("name,which,riemann,wall_kw,dissipative_wall",
                         HALVES, ids=["-".join(map(str, h)) for h in HALVES])
def test_acoustic_halves_match_jax(scenes, name, which, riemann, wall_kw,
                                   dissipative_wall):
    """Both halves with a static wall (as `wall` and as `walls`, with a
    Dissipative wall solver), two moving walls in an x-periodic box, and
    the doubly periodic box; the Acoustic and No solvers."""
    sc = scenes[name]
    wr_j = wr_t = None
    if dissipative_wall:
        wr_j = jrs.dissipative_riemann(sc.j["eos"])
        wr_t = trs.dissipative_riemann(sc.t["eos"])
    j = _halves(sc, "j", which, riemann, wall_kw, wr_j)
    t = _halves(sc, "t", which, riemann, wall_kw, wr_t)
    _hold_state(t, j, f"{name} half {which}")


@pytest.mark.parametrize("name", SCENES)
def test_time_steps_match_jax(scenes, name):
    """The acoustic, advection and viscous advection time steps, over the
    real rows only (the dambreak's padding rows move at 100)."""
    sc = scenes[name]
    h = sc.consts["h"]
    pairs = [
        (jfd.acoustic_time_step(sc.j["fluid"], sc.j["eos"], h),
         tfd.acoustic_time_step(sc.t["fluid"], sc.t["eos"], h)),
        (jfd.advection_time_step(sc.j["fluid"], h, 2.0),
         tfd.advection_time_step(sc.t["fluid"], h, 2.0)),
        (jfd.advection_viscous_time_step(sc.j["fluid"], h, 1.0, 1.0, 0.5),
         tfd.advection_viscous_time_step(sc.t["fluid"], h, 1.0, 1.0, 0.5)),
    ]
    for j, t in pairs:
        assert t.dim() == 0
        assert float(t) == pytest.approx(float(j), rel=TOL)
    # the padding rows are masked: their speed would cut the step 100-fold
    assert float(pairs[0][1]) > 0.6 * h / 30.0


@pytest.mark.parametrize("name", SCENES)
def test_viscous_force_matches_jax(scenes, name):
    """Inner and wall terms into ForcePrior through the ViscousForcePrev
    bookkeeping (present, random, in "tg"; absent, read as zero, in the
    others)."""
    sc = scenes[name]
    c = sc.consts
    mu = c["mu"] or 0.05
    j = jfd.viscous_force(sc.j["fluid"], sc.j["inner"], sc.kernel_j, sc.dim,
                          mu, c["h"], box=sc.box, walls=sc.j["walls"])
    t = tfd.viscous_force(sc.t["fluid"], sc.t["inner"], sc.kernel_t, sc.dim,
                          mu, c["h"], box=sc.box, walls=sc.t["walls"])
    _hold_state(t, j, f"{name} viscous_force")


@pytest.mark.parametrize("name,coef,slope", [
    ("dambreak", 0.2, None), ("fsi2", 0.25, None), ("tg", 0.2, 100.0),
    ("tg", 0.2, 1e6)])
def test_transport_velocity_correction_matches_jax(scenes, name, coef, slope):
    sc = scenes[name]
    h = sc.consts["h"]
    j = jfd.transport_velocity_correction(
        sc.j["fluid"], sc.j["inner"], sc.kernel_j, sc.dim, h, coefficient=coef,
        limiter_slope=slope, box=sc.box, walls=sc.j["walls"])
    t = tfd.transport_velocity_correction(
        sc.t["fluid"], sc.t["inner"], sc.kernel_t, sc.dim, h, coefficient=coef,
        limiter_slope=slope, box=sc.box, walls=sc.t["walls"])
    _hold_state(t, j, f"{name} tvc")
    assert np.abs(t["Position"].numpy() - sc.t["fluid"]["Position"].numpy()
                  ).max() > 0


def test_fsi_couplings_match_jax(scenes):
    """The viscous and pressure forces on the insert from the fluid over
    its list of fluid particles, into its ForcePrior (the Acoustic solver;
    five insert normals are zero, so sign(e.n) = 0 there)."""
    sc = scenes["fsi2"]
    h = sc.consts["h"]
    # a fluid state with a pressure, as after the 1st half
    jfl = jfd.acoustic_step_1st_half(sc.j["fluid"], sc.j["inner"], sc.kernel_j,
                                     2, sc.j["eos"], sc.j["riemann"], DT,
                                     box=sc.box, walls=sc.j["walls"])
    tfl = tfd.acoustic_step_1st_half(sc.t["fluid"], sc.t["inner"], sc.kernel_t,
                                     2, sc.t["eos"], sc.t["riemann"], DT,
                                     box=sc.box, walls=sc.t["walls"])
    j = jfsi.viscous_force_from_fluid(sc.j["solid"], jfl, sc.j["sf"],
                                      sc.kernel_j, 2, jf.MU_F, h, box=sc.box)
    t = tfsi.viscous_force_from_fluid(sc.t["solid"], tfl, sc.t["sf"],
                                      sc.kernel_t, 2, jf.MU_F, h, box=sc.box)
    _hold_state(t, j, "viscous_force_from_fluid")
    j = jfsi.pressure_force_from_fluid(j, jfl, sc.j["sf"], sc.kernel_j, 2,
                                       sc.j["riemann"], box=sc.box)
    t = tfsi.pressure_force_from_fluid(t, tfl, sc.t["sf"], sc.kernel_t, 2,
                                       sc.t["riemann"], box=sc.box)
    _hold_state(t, j, "pressure_force_from_fluid")
    assert np.abs(t["PressureForceFromFluid"].numpy()).max() > 0


RAISES = [
    # ported: a shell contact reads the shell's state, and a shell state
    # without its fields fails loudly
    ("density_summation", dict(shell_contacts=[({}, None, None, 1.0)]),
     "Mass"),
    ("density_summation", dict(levelsets=[1]), "compute_kernel_integral"),
    # ported: a fluid-fluid contact reads the other phase's state, and a
    # contact state without positions fails loudly
    ("acoustic_step_1st_half", dict(contacts=[({}, None, None)]),
     "Position"),
    # ported: the correction reads B, and a state without one fails loudly
    ("acoustic_step_1st_half", dict(correction=True),
     "LinearGradientCorrectionMatrix"),
    ("acoustic_step_1st_half", dict(shell_walls=[({}, None, None)]),
     "VolumetricMeasure"),
    # ported: a level set is a LevelSetShape, and an entry without its
    # probes fails loudly
    ("acoustic_step_1st_half", dict(levelsets=[1]),
     "compute_kernel_gradient_integral"),
    # ported: the extra force is added to the (N, d) force, and one of
    # another width fails loudly
    ("acoustic_step_1st_half", dict(extra_force=torch.zeros(1, 3)),
     "size of tensor"),
    ("acoustic_step_2nd_half", dict(contacts=[({}, None, None)]),
     "Position"),
    ("acoustic_step_2nd_half", dict(shell_walls=[({}, None, None)]),
     "VolumetricMeasure"),
    ("acoustic_step_2nd_half", dict(levelsets=[1]),
     "compute_kernel_gradient_integral"),
    ("viscous_force", dict(contacts=[({}, None, None)]), "Position"),
    ("viscous_force", dict(shell_walls=[({}, None, None)]),
     "VolumetricMeasure"),
    ("transport_velocity_correction", dict(shell_walls=[({}, None, None)]),
     "VolumetricMeasure"),
    # ported: the projection reads the surface indication, and a state
    # without one fails loudly
    ("transport_velocity_correction", dict(surface_projection=True),
     "Indicator"),
]


@pytest.mark.parametrize("fn,kw,needs", RAISES,
                         ids=[f"{r[0]}-{next(iter(r[1]))}" for r in RAISES])
def test_unported_arguments_raise(scenes, fn, kw, needs):
    sc = scenes["tg"]
    d, k = sc.t, sc.kernel_t
    args = {
        "density_summation": (d["fluid"], d["inner"], k, 2, 1.0, 1.0),
        "acoustic_step_1st_half": (d["fluid"], d["inner"], k, 2, d["eos"],
                                   d["riemann"], DT),
        "acoustic_step_2nd_half": (d["fluid"], d["inner"], k, 2,
                                   d["riemann"], DT),
        "viscous_force": (d["fluid"], d["inner"], k, 2, 0.01, 0.1),
        "transport_velocity_correction": (d["fluid"], d["inner"], k, 2, 0.1),
    }[fn]
    error = KeyError if {"correction", "contacts", "surface_projection",
                         "shell_contacts", "shell_walls"} & set(kw) \
        else RuntimeError if "extra_force" in kw \
        else AttributeError if "levelsets" in kw else NotImplementedError
    with pytest.raises(error, match=needs):
        getattr(tfd, fn)(*args, **kw)


@pytest.mark.parametrize("fn", ["kernel_correction_matrix"])
def test_functions_off_the_routes_raise(scenes, fn):
    """The function that raised while no ported route called it is ported
    now (the kernel-corrected cases): on the periodic TG scene it matches
    JAX's (tests/test_torch_kernel_correction.py holds it on walls,
    deficient rows and both alphas)."""
    sc = scenes["tg"]
    j = getattr(jfd, fn)(sc.j["fluid"], sc.j["inner"], sc.kernel_j, sc.dim,
                         alpha=0.5, box=sc.box)
    t = getattr(tfd, fn)(sc.t["fluid"], sc.t["inner"], sc.kernel_t, sc.dim,
                         alpha=0.5, box=sc.box)
    _hold_state(t, j, fn)


# ---------------------------------------------------------------------------
# Morton keys and the resort permutation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim,top", [(2, 1 << 16), (3, 1 << 10)])
def test_morton_keys_match_jax_bit_for_bit(dim, top):
    """Random coords over the key's whole range and past it (the bits
    above are masked off), and the extremes."""
    rng = np.random.default_rng(dim)
    c = rng.integers(0, top, size=(4000, dim)).astype(np.int32)
    c[:3] = [[top - 1] * dim, [0] * dim, [top] * dim]
    c[3:50] = rng.integers(0, 4 * top, size=(47, dim))
    j = np.asarray(jcl.morton_key(jnp.asarray(c)))
    t = tcl.morton_key(torch.as_tensor(c)).numpy()
    assert j.dtype == np.uint32 and t.dtype == np.int64
    np.testing.assert_array_equal(t, j.astype(np.int64))
    assert t[0] == (1 << (16 * 2 if dim == 2 else 30)) - 1


@pytest.mark.parametrize("dim", [2, 3])
def test_spatial_sort_permutation_matches_jax(dim):
    """A grid of 5 cells an axis, 600 particles (many to a cell, so keys
    tie), 37 padding rows parked far away: the permutation equals JAX's
    index for index, the padding rows stay at the tail in index order."""
    rng = np.random.default_rng(10 + dim)
    grid_j = jcl.grid_from_bounds((0.0,) * dim, (1.0,) * dim, 0.2)
    grid_t = tcl.grid_from_bounds((0.0,) * dim, (1.0,) * dim, 0.2)
    pos = rng.random((600, dim))
    pos[-37:] = 1e16
    n_real = 600 - 37
    j = np.asarray(jcl.spatial_sort_permutation(jnp.asarray(pos),
                                                jnp.int32(n_real), grid_j))
    t = tcl.spatial_sort_permutation(torch.as_tensor(pos), n_real, grid_t)
    np.testing.assert_array_equal(t.numpy(), j)
    np.testing.assert_array_equal(t.numpy()[-37:], np.arange(n_real, 600))
    keys = tcl.morton_key(grid_t.cell_coords(torch.as_tensor(pos)))[:n_real]
    assert len(torch.unique(keys)) < n_real // 4          # ties
