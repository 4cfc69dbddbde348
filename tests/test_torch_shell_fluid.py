"""The port's shell contacts against the JAX package on the CPU, on seeded
scenes: a ring (2D) or a cylinder (3D) of shell particles around a block
of fluid particles, random velocities, pressures and wall kinematics.

* physics/shell_fluid.py: the curvature (and the circle's 1 / R), both
  pair builders with their dummy stacks (either normal orientation), the
  density, first-half and second-half terms and the pressure force on
  the shell;
* the six `shell_contacts` / `shell_walls` hooks of physics/fluid.py;
* physics/surface_contact.py: the solid, shell and self-contact pairs,
  the repulsion factor and both forces, on a ring squashed onto itself.

float64 at 1e-12 of each output's max, float32 at 2e-5; the lists are
JAX's, carried across."""

import math
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sphinxsys_tpu.core.adaptation import SPHAdaptation as JA
from sphinxsys_tpu.core.materials import WeaklyCompressibleFluid as JW
from sphinxsys_tpu.core.state import make_fluid_state as j_fluid
from sphinxsys_tpu.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_tpu.physics import fluid as jfd
from sphinxsys_tpu.physics import riemann as jrs
from sphinxsys_tpu.physics import shell as jsh
from sphinxsys_tpu.physics import shell_fluid as jsf
from sphinxsys_tpu.physics import surface_contact as jsc

from sphinxsys_tpu_torch import convert
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation as TA
from sphinxsys_tpu_torch.core.materials import WeaklyCompressibleFluid as TW
from sphinxsys_tpu_torch.physics import fluid as tfd
from sphinxsys_tpu_torch.physics import riemann as trs
from sphinxsys_tpu_torch.physics import shell as tsh
from sphinxsys_tpu_torch.physics import shell_fluid as tsf
from sphinxsys_tpu_torch.physics import surface_contact as tsc

torch.set_num_threads(1)

TOL = {torch.float64: 1e-12, torch.float32: 2e-5}
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}
DTYPES = (torch.float64, torch.float32)
R = 0.5
DX = 0.05


def close(got, ref, tol, what=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    assert np.isfinite(got).all(), what
    err = np.abs(got - ref).max(initial=0.0)
    assert err <= tol * max(np.abs(ref).max(initial=0.0), 1e-300), \
        (what, err, np.abs(ref).max(initial=0.0))


def hold(got, ref, tol, what=""):
    """Dicts and named tuples field by field, else one array."""
    if isinstance(ref, dict):
        for k, v in ref.items():
            if k != "NReal":
                hold(got[k], v, tol, (what, k))
    elif hasattr(ref, "_fields"):
        for k in ref._fields:
            v = getattr(ref, k)
            if np.asarray(v).dtype == bool:
                np.testing.assert_array_equal(getattr(got, k).numpy(),
                                              np.asarray(v))
            else:
                hold(getattr(got, k), v, tol, (what, k))
    elif isinstance(ref, tuple):
        for i, (g, r) in enumerate(zip(got, ref)):
            hold(g, r, tol, (what, i))
    elif np.asarray(ref).dtype.kind in "biu":
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    else:
        close(got, ref, tol, what)


def own_tolerance(ref, ref64):
    """2e-5, or twice the JAX package's own float32 error against its
    float64 on the same inputs where that is larger (ROADMAP C: the
    pressure's rho - rho0, a cylinder's k2)."""
    ref64 = np.asarray(ref64, np.float64)
    scale = max(np.abs(ref64).max(initial=0.0), 1e-300)
    own = np.abs(np.asarray(ref, np.float64) - ref64).max(initial=0.0)
    return max(TOL[torch.float32], 2.0 * own / scale)


def hold32(got, ref, ref64, what=""):
    """`hold` in float32, each leaf at its `own_tolerance`."""
    if isinstance(ref, dict):
        for k, v in ref.items():
            if k != "NReal":
                hold32(got[k], v, ref64[k], (what, k))
    elif isinstance(ref, tuple):
        for i, (g, r, r64) in enumerate(zip(got, ref, ref64)):
            hold32(g, r, r64, (what, i))
    elif np.asarray(ref).dtype.kind in "biu":
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    else:
        close(got, ref, own_tolerance(ref, ref64), what)


def to_port(tree):
    """JAX states, lists and arrays -> the port's CPU tensors."""
    if isinstance(tree, dict):
        return convert.state_from_numpy({k: np.asarray(v)
                                         for k, v in tree.items()})
    if hasattr(tree, "overflow"):
        return convert.neighbor_list_from_numpy(
            jax.tree_util.tree_map(np.asarray, tree))
    return torch.as_tensor(np.array(tree))


def shell_surface(dim, n_rows=4):
    """A ring of radius R (2D) or a cylinder about y (3D), outward
    normals, spacing DX."""
    n = int(2 * math.pi * R / DX)
    th = 2 * math.pi * np.arange(n) / n
    if dim == 2:
        nrm = np.stack([np.cos(th), np.sin(th)], -1)
        return R * nrm, nrm
    T, Y = np.meshgrid(th, DX * np.arange(n_rows), indexing="ij")
    nrm = np.stack([np.cos(T), np.zeros_like(T), np.sin(T)], -1).reshape(-1, 3)
    pos = np.stack([R * np.cos(T), Y, R * np.sin(T)], -1).reshape(-1, 3)
    return pos, nrm


def _lists(pos_q, pos_s, grid, cutoff, include_self, k=48):
    nq, ns = jnp.int32(len(pos_q)), jnp.int32(len(pos_s))
    table = build_cell_table(pos_s, ns, grid, cap=32)
    return build_neighbor_list(pos_q, nq, pos_s, ns, table, grid, cutoff,
                               k_max=k, include_self=include_self)


def scene(dim, dtype, seed=0):
    """JAX's shell and fluid (seeded fields), their four lists, the
    kernel; returned for JAX and (carried across) for the port."""
    rng = np.random.default_rng(seed + dim)
    jdt = JDT[dtype]
    spos, snrm = shell_surface(dim)
    shell = jsh.make_shell_state(spos, snrm, DX, 0.02,
                                 types.SimpleNamespace(rho0=2.0), dtype=jdt)
    ns = len(spos)
    shell["Velocity"] = jnp.asarray(0.1 * rng.standard_normal((ns, dim)), jdt)
    shell["AverageVelocity"] = jnp.asarray(
        0.1 * rng.standard_normal((ns, dim)), jdt)
    shell["AverageAcceleration"] = jnp.asarray(
        rng.standard_normal((ns, dim)), jdt)
    ax = np.arange(-R + DX, R - 0.5 * DX, DX)
    if dim == 2:
        fpos = np.stack(np.meshgrid(ax, ax, indexing="ij"), -1).reshape(-1, 2)
        fpos = fpos[np.linalg.norm(fpos, axis=1) < R - 0.5 * DX]
    else:
        ay = DX * np.arange(4)
        fpos = np.stack(np.meshgrid(ax, ay, ax, indexing="ij"),
                        -1).reshape(-1, 3)
        fpos = fpos[np.hypot(fpos[:, 0], fpos[:, 2]) < R - 0.5 * DX]
    fpos = fpos + 0.1 * DX * rng.standard_normal(fpos.shape)
    nf = len(fpos)
    fluid = j_fluid(fpos, DX ** dim, 1000.0, dtype=jdt)
    fluid["Velocity"] = jnp.asarray(rng.standard_normal((nf, dim)), jdt)
    fluid["Density"] = jnp.asarray(1000.0 + rng.standard_normal(nf), jdt)
    fluid["Pressure"] = jnp.asarray(100.0 * rng.standard_normal(nf), jdt)
    fluid["DensityChangeRate"] = jnp.asarray(rng.standard_normal(nf), jdt)
    fluid["ForcePrior"] = jnp.asarray(
        1e-3 * rng.standard_normal((nf, dim)), jdt)
    fluid["Indicator"] = jnp.asarray(rng.integers(0, 2, nf), jnp.int32)
    ad = JA(spacing=DX, dim=dim)
    lo, hi = (-R - 0.2,) * dim, (R + 0.2,) * dim
    grid = grid_from_bounds(lo, hi, ad.cutoff)
    sp, fp = shell["Position"], fluid["Position"]
    lists = dict(ss=_lists(sp, sp, grid, ad.cutoff, False),
                 fs=_lists(fp, sp, grid, ad.cutoff, True),
                 sf=_lists(sp, fp, grid, ad.cutoff, True, k=96),
                 ff=_lists(fp, fp, grid, ad.cutoff, False, k=96))
    for nl in lists.values():
        assert not bool(nl.overflow)
    j = dict(shell=shell, fluid=fluid, kernel=ad.kernel, **lists)
    t = {k: to_port(v) for k, v in j.items() if k != "kernel"}
    t["kernel"] = TA(spacing=DX, dim=dim).kernel
    return j, t


def curvatures(j, t, dim):
    jk = jax.jit(lambda s, nl: jsf.shell_curvature(
        s, nl, jsh.ReducedKernel(j["kernel"]), dim))(j["shell"], j["ss"])
    tk = tsf.shell_curvature(t["shell"], t["ss"],
                             tsh.ReducedKernel(t["kernel"]), dim)
    return jk, tk


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dim", [2, 3])
def test_curvature_matches_jax(dim, dtype):
    """float32 at 2e-5, or twice JAX's own float32 error against its
    float64 where that is larger: a cylinder's k2 = H - sqrt(H^2 - K) is
    roundoff of a zero (ROADMAP C)."""
    j, t = scene(dim, dtype)
    jk, tk = curvatures(j, t, dim)
    if dtype == torch.float64:
        hold(tk, jk, TOL[dtype], "k")
    else:
        j64, t64 = scene(dim, torch.float64)
        hold32(tk, jk, curvatures(j64, t64, dim)[0], "k")


def test_curvature_of_a_circle():
    """The JAX package's oracle (tests/test_shell_fluid.py): 128 particles
    on a circle of radius 1, outward normals: k1 = 1 / R within 5%,
    k2 = 0."""
    from sphinxsys_tpu_torch.neighbors.cell_list import (build_cell_table,
                                                        grid_from_bounds)
    from sphinxsys_tpu_torch.neighbors.neighbor_list import \
        build_neighbor_list

    n_part, radius = 128, 1.0
    dx = 2 * math.pi * radius / n_part
    th = np.linspace(0.0, 2 * math.pi, n_part, endpoint=False)
    nrm = np.stack([np.cos(th), np.sin(th)], -1)
    shell = tsh.make_shell_state(radius * nrm, nrm, dx, 0.05,
                                 types.SimpleNamespace(rho0=1.0),
                                 torch.float64, "cpu")
    ad = TA(spacing=dx, dim=2)
    grid = grid_from_bounds((-1.5, -1.5), (1.5, 1.5), ad.cutoff)
    p = shell["Position"]
    nl = build_neighbor_list(p, n_part, p, n_part,
                             build_cell_table(p, n_part, grid, 16), grid,
                             ad.cutoff, k_max=16, include_self=False)
    k1, k2 = tsf.shell_curvature(shell, nl, tsh.ReducedKernel(ad.kernel), 2)
    np.testing.assert_allclose(k1.numpy(), 1.0 / radius, rtol=0.05)
    np.testing.assert_allclose(k2.numpy(), 0.0, atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("corr", [False, True])
def test_pair_builders_match_jax(dim, dtype, corr):
    """Both builders and their dummy stacks; the dummies past the cutoff
    and the negative volume factors (an inward-curved stack) both
    masked."""
    j, t = scene(dim, dtype)
    jk, tk = curvatures(j, t, dim)
    kw = dict(normal_correction=corr)
    jp = jax.jit(lambda f, s, a, b, nl: jsf.shell_contact_pairs(
        f["Position"], s, a, b, nl, j["kernel"], dim, DX, **kw))(
        j["fluid"], j["shell"], *jk, j["fs"])
    tp = tsf.shell_contact_pairs(t["fluid"]["Position"], t["shell"], *tk,
                                 t["fs"], t["kernel"], dim, DX, **kw)
    hold(tp, jp, TOL[dtype], "shell_contact_pairs")
    jq = jax.jit(lambda s, a, b, f, nl: jsf.fluid_to_shell_pairs(
        s, a, b, f["Position"], nl, j["kernel"], dim, DX, **kw))(
        j["shell"], *jk, j["fluid"], j["sf"])
    tq = tsf.fluid_to_shell_pairs(t["shell"], *tk, t["fluid"]["Position"],
                                  t["sf"], t["kernel"], dim, DX, **kw)
    hold(tq, jq, TOL[dtype], "fluid_to_shell_pairs")
    assert tsf.n_dummy_static(t["kernel"], DX) == \
        jsf.n_dummy_static(j["kernel"], DX)


def pairs_both(j, t, dim, corr=True):
    jk, tk = curvatures(j, t, dim)
    jp = jsf.shell_contact_pairs(j["fluid"]["Position"], j["shell"], *jk,
                                 j["fs"], j["kernel"], dim, DX,
                                 normal_correction=corr)
    jq = jsf.fluid_to_shell_pairs(j["shell"], *jk, j["fluid"]["Position"],
                                  j["sf"], j["kernel"], dim, DX,
                                  normal_correction=corr)
    return (jp, jq), (convert.pairs_from_numpy(
        tsf.ShellContactPairs, jax.tree_util.tree_map(np.asarray, jp)),
        convert.pairs_from_numpy(tsf.ShellContactPairs,
                                 jax.tree_util.tree_map(np.asarray, jq)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dim", [2, 3])
def test_shell_terms_match_jax(dim, dtype):
    """The density term, both halves' wall terms and the pressure force on
    the shell, from the same frozen pairs."""
    j, t = scene(dim, dtype)
    (jp, jq), (tp, tq) = pairs_both(j, t, dim)
    jeos, teos = JW(rho0=1000.0, c0=10.0), TW(rho0=1000.0, c0=10.0)
    jr, tr = jrs.acoustic_riemann(jeos), trs.acoustic_riemann(teos)
    jf, tf = j["fluid"], t["fluid"]
    tol = TOL[dtype]
    hold(tsf.density_summation_shell_term(tf, t["shell"], tp, t["fs"],
                                          1000.0, 0.9, 2.0),
         jsf.density_summation_shell_term(jf, j["shell"], jp, j["fs"],
                                          1000.0, 0.9, 2.0), tol, "rho")
    hold(tsf.acoustic_1st_half_shell_term(
            tf["Pressure"], tf["Density"], tf, t["shell"], tp, t["fs"], tr),
         jax.jit(jsf.acoustic_1st_half_shell_term, static_argnums=6)(
            jf["Pressure"], jf["Density"], jf, j["shell"], jp, j["fs"], jr),
         tol, "1st")
    hold(tsf.acoustic_2nd_half_shell_term(tf["Velocity"], tf, t["shell"],
                                          tp, t["fs"], tr),
         jax.jit(jsf.acoustic_2nd_half_shell_term, static_argnums=5)(
            jf["Velocity"], jf, j["shell"], jp, j["fs"], jr), tol, "2nd")
    hold(tsf.pressure_force_from_fluid_on_shell(t["shell"], tf, tq, t["sf"],
                                                tr),
         jax.jit(jsf.pressure_force_from_fluid_on_shell, static_argnums=4)(
            j["shell"], jf, jq, j["sf"], jr), tol, "pressure force")


def hooks(dim, dtype):
    """The six hooks of physics/fluid.py and the free-stream summation on
    the scene, a shell wall beside the fluid's inner pairs: (JAX's
    results, the port's)."""
    j, t = scene(dim, dtype)
    (jp, _), (tp, _) = pairs_both(j, t, dim)
    jeos, teos = JW(rho0=1000.0, c0=10.0), TW(rho0=1000.0, c0=10.0)
    jr, tr = jrs.acoustic_riemann(jeos), trs.acoustic_riemann(teos)
    jk, tk = j["kernel"], t["kernel"]
    jsw = [(j["shell"], j["fs"], jp)]
    tsw = [(t["shell"], t["fs"], tp)]
    jsc_ = [(j["shell"], j["fs"], jp, 2.0)]
    tsc_ = [(t["shell"], t["fs"], tp, 2.0)]
    nl_j, nl_t = j["ff"], t["ff"]
    h, dt = 1.3 * DX, 1e-4
    cases = [
        (lambda f: jfd.density_summation(f, nl_j, jk, dim, 1000.0, 0.9,
                                         shell_contacts=jsc_),
         lambda f: tfd.density_summation(f, nl_t, tk, dim, 1000.0, 0.9,
                                         shell_contacts=tsc_)),
        (lambda f: jfd.acoustic_step_1st_half(f, nl_j, jk, dim, jeos, jr, dt,
                                              shell_walls=jsw),
         lambda f: tfd.acoustic_step_1st_half(f, nl_t, tk, dim, teos, tr, dt,
                                              shell_walls=tsw)),
        (lambda f: jfd.acoustic_step_2nd_half(f, nl_j, jk, dim, jr, dt,
                                              shell_walls=jsw),
         lambda f: tfd.acoustic_step_2nd_half(f, nl_t, tk, dim, tr, dt,
                                              shell_walls=tsw)),
        (lambda f: jfd.viscous_force(f, nl_j, jk, dim, 0.1, h,
                                     shell_walls=jsw),
         lambda f: tfd.viscous_force(f, nl_t, tk, dim, 0.1, h,
                                     shell_walls=tsw)),
        (lambda f: jfd.transport_velocity_correction(f, nl_j, jk, dim, h,
                                                     shell_walls=jsw),
         lambda f: tfd.transport_velocity_correction(f, nl_t, tk, dim, h,
                                                     shell_walls=tsw)),
        (lambda f: jfd.free_surface_indication(f, nl_j, jk, dim,
                                               shell_walls=jsw),
         lambda f: tfd.free_surface_indication(f, nl_t, tk, dim,
                                               shell_walls=tsw)),
        (lambda f: jfd.density_summation_freestream(
            f, nl_j, jk, dim, 1000.0, 0.9, shell_contacts=jsc_),
         lambda f: tfd.density_summation_freestream(
            f, nl_t, tk, dim, 1000.0, 0.9, shell_contacts=tsc_)),
    ]
    return ([jax.jit(jfn)(j["fluid"]) for jfn, _ in cases],
            [tfn(t["fluid"]) for _, tfn in cases])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dim", [2, 3])
def test_fluid_hooks_match_jax(dim, dtype):
    """The hooks' outputs, none raising; float32 leaf by leaf at
    `own_tolerance` (the first half's p = c0^2 (rho - rho0) of densities
    1000 +- 1)."""
    jres, tres = hooks(dim, dtype)
    if dtype == torch.float64:
        for i, (got, ref) in enumerate(zip(tres, jres)):
            hold(got, ref, TOL[dtype], i)
        return
    ref64 = hooks(dim, torch.float64)[0]
    for i, (got, ref, r64) in enumerate(zip(tres, jres, ref64)):
        hold32(got, ref, r64, i)


def test_hooks_left_only_levelsets_unported():
    """The level sets, the last hook left, are ported too
    (meshes/levelset.py): no argument of fluid.py raises as unported, and
    a level-set entry without its probes fails loudly."""
    from sphinxsys_tpu_torch.neighbors.neighbor_list import NeighborList

    assert not hasattr(tfd, "_NEEDS") and not hasattr(tfd, "_unported")
    one = NeighborList(idx=torch.zeros((1, 1), dtype=torch.int64),
                       count=torch.zeros(1, dtype=torch.int64),
                       overflow=torch.zeros((), dtype=torch.bool))
    fluid = {"Position": torch.zeros(1, 2, dtype=torch.float64),
             "Mass": torch.ones(1, dtype=torch.float64)}
    with pytest.raises(AttributeError, match="compute_kernel_integral"):
        tfd.density_summation(fluid, one, TA(spacing=0.1, dim=2).kernel, 2,
                              1.0, 1.0, levelsets=[1])


# ---------------------------------------------------------------------------
# surface contact
# ---------------------------------------------------------------------------

def contact_scene(dtype):
    """Two shell rings (a second one shifted to touch the first) and a
    solid disc, and a ring squashed onto itself (self contact), with the
    JAX lists; JAX's and the port's."""
    j, t = scene(2, dtype, seed=5)
    jdt = JDT[dtype]
    shell = dict(j["shell"])
    p0 = np.asarray(shell["Position"], np.float64)
    # the current shape: an ellipse whose flanks come within the cutoff
    squashed = p0 * np.asarray([1.0, 0.12])
    shell["Position"] = jnp.asarray(squashed, jdt)
    other = dict(j["shell"])
    other["Position"] = jnp.asarray(p0 + np.asarray([0.9, 0.1]), jdt)
    solid = dict(j["fluid"])
    ad = JA(spacing=DX, dim=2)
    grid = grid_from_bounds((-R - 0.3, -R - 0.3), (2 * R + 0.3, R + 0.3),
                            ad.cutoff)
    sp, op, fp = shell["Position"], other["Position"], solid["Position"]
    jl = dict(self=_lists(sp, sp, grid, ad.cutoff, True),
              so=_lists(op, j["shell"]["Position"], grid, ad.cutoff, True),
              sf=_lists(j["shell"]["Position"], fp, grid, ad.cutoff, True,
                        k=96))
    jj = dict(shell=shell, other=other, base=j["shell"], solid=solid, **jl)
    tt = {k: to_port(v) for k, v in jj.items()}
    return jj, tt, j["kernel"], t["kernel"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_surface_contact_matches_jax(dtype):
    jj, tt, jk, tk = contact_scene(dtype)
    tol = TOL[dtype]
    rk_j, rk_t = jsh.ReducedKernel(jk), tsh.ReducedKernel(tk)
    k1 = jsf.shell_curvature(jj["base"], jj["self"], rk_j, 2)
    k1t = tsf.shell_curvature(tt["base"], tt["self"], rk_t, 2)
    hold(k1t, k1, tol, "k")
    # the squashed ring's self contact (far in the initial configuration)
    jself = jax.jit(lambda s, a, b, nl: jsc.shell_self_pairs(
        s, a, b, nl, jk, 2, DX))(jj["shell"], *k1, jj["self"])
    tself = tsc.shell_self_pairs(tt["shell"], *k1t, tt["self"], tk, 2, DX)
    hold(tself, jself, tol, "self")
    assert bool(tself.mask.any())
    # another ring against the base ring, and the base ring against a
    # solid
    jso = jax.jit(lambda p, s, a, b, nl: jsc.shell_surface_pairs(
        p, s, a, b, nl, jk, 2, DX, normal_correction=True))(
        jj["other"]["Position"], jj["base"], *k1, jj["so"])
    tso = tsc.shell_surface_pairs(tt["other"]["Position"], tt["base"], *k1t,
                                  tt["so"], tk, 2, DX, normal_correction=True)
    hold(tso, jso, tol, "shell pairs")
    jsol = jax.jit(lambda p, s, nl: jsc.solid_surface_pairs(
        p, s, nl, jk, 2, DX, DX))(jj["base"]["Position"], jj["solid"],
                                  jj["sf"])
    tsol = tsc.solid_surface_pairs(tt["base"]["Position"], tt["solid"],
                                   tt["sf"], tk, 2, DX, DX)
    hold(tsol, jsol, tol, "solid pairs")
    # the factors and the forces
    js_b = jsc.repulsion_factor([jsol])
    ts_b = tsc.repulsion_factor([tsol])
    hold(ts_b, js_b, tol, "sigma")
    js_o = jsc.repulsion_factor([jso])
    ts_o = tsc.repulsion_factor([tso])
    pv_j = jj["base"]["VolumetricMeasure"] * jj["base"]["Thickness"]
    pv_t = tt["base"]["VolumetricMeasure"] * tt["base"]["Thickness"]
    ref = jsc.repulsion_force(jj["other"], js_o,
                              [(jso, js_b, 3.0), (jso, js_o, 1.5)],
                              particle_volume=pv_j)
    got = tsc.repulsion_force(tt["other"], ts_o,
                              [(tso, ts_b, 3.0), (tso, ts_o, 1.5)],
                              particle_volume=pv_t)
    hold(got, ref, tol, "force")
    hold(tsc.repulsion_force(tt["other"], ts_o, [(tso, ts_b, 3.0)]),
         jsc.repulsion_force(jj["other"], js_o, [(jso, js_b, 3.0)]), tol,
         "force, the measure")
    jsig = jsc.repulsion_factor([jself])
    tsig = tsc.repulsion_factor([tself])
    hold(tsc.self_repulsion_force(tt["shell"], tsig, tself, 2.0, 0.5, pv_t),
         jsc.self_repulsion_force(jj["shell"], jsig, jself, 2.0, 0.5, pv_j),
         tol, "self force")
    assert tsc.surface_kernel(0.1, 0.3).h == pytest.approx(
        jsc.surface_kernel(0.1, 0.3).h)
