"""Parity of the port's multi-phase terms with the JAX package, on the CPU
in float64: the fluid-fluid `contacts=` terms of both acoustic halves and
of `viscous_force` (physics/fluid.py), and every function of
physics/surface_tension.py; then the 3D case that runs them,
cubic_droplet_3d, as tests/test_torch_multiphase_cases.py holds the 2D
ones.

Inputs, made from a seed with numpy and fed to both sides as the same
arrays:
  * "2d": the square droplet's build at dx = 0.1, both phases' positions
    moved by up to 0.1 dx, their velocities, densities, pressures,
    density rates, forces and surface-tension fields perturbed (a few
    normals zero), JAX's lists of the moved positions carried across;
  * "3d": the cubic droplet's state after JAX's run of two advection
    steps at dx = 0.2, with its lists.
The water's contact solver is (water, air), the air's (air, water); both
orientations are run, and the swapped one is shown to differ.  Every
output field is held within 1e-12 of its max|ref|.
"""

import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sphinxsys_tpu.cases import square_droplet_2d as jsq
from sphinxsys_tpu.cases import two_phase_dambreak_2d as jtp
from sphinxsys_tpu.physics import fluid as jfd
from sphinxsys_tpu.physics import surface_tension as jst
from sphinxsys_tpu_torch import convert
from sphinxsys_tpu_torch.cases import square_droplet_2d as tsq
from sphinxsys_tpu_torch.cases import two_phase_dambreak_2d as ttp
from sphinxsys_tpu_torch.physics import fluid as tfd
from sphinxsys_tpu_torch.physics import surface_tension as tst

from test_torch_corrected_cases import (POS_TOL, RUNS, TOL, cli_runs, close,
                                        continue_one_step, hold_build,
                                        hold_sims, runs)

torch.set_num_threads(1)

DT = 1.0e-3
RUNS["cubic_droplet_3d"] = (dict(dx=0.2), 0.025)


def _np(state):
    return {k: np.array(v) for k, v in state.items()}


def _to_jax(s):
    return {k: (jnp.asarray(v, jnp.int32) if k == "NReal" else jnp.asarray(v))
            for k, v in s.items()}


def _perturb(state, rng, dx, rho0):
    s = _np(state)
    n, dim = s["Position"].shape
    s["Position"] = s["Position"] + 0.1 * dx * (rng.random((n, dim)) - 0.5)
    s["Velocity"] = 0.3 * rng.normal(size=(n, dim))
    s["Density"] = rho0 * (1.0 + 0.01 * rng.normal(size=n))
    s["Pressure"] = 0.5 * rho0 * rng.normal(size=n)
    s["DensityChangeRate"] = 0.1 * rho0 * rng.normal(size=n)
    for k in ("Force", "ForcePrior", "SurfaceTensionForcePrev",
              "ViscousForcePrev"):
        s[k] = rho0 * 0.01 * rng.normal(size=(n, dim))
    s["VolumetricMeasure"] = s["Mass"] / s["Density"]
    s["ColorGradient"] = rng.normal(size=(n, dim))
    nd = rng.normal(size=(n, dim))
    nd /= np.linalg.norm(nd, axis=-1, keepdims=True)
    nd[::7] = 0.0                       # rows far from the interface
    s["NormDirection"] = nd
    S = rng.normal(size=(n, dim, dim))
    s["SurfaceTensionStress"] = 0.5 * (S + S.transpose(0, 2, 1))
    return s


@dataclasses.dataclass
class Scene:
    """Both phases and the wall on both sides; the lists (JAX's and their
    carried copies) by name."""

    jc: object
    tc: object
    j: dict
    t: dict
    jnl: dict
    tnl: dict
    dim: int


NL_NAMES = ("nl_ww", "nl_wa", "nl_wb", "nl_aa", "nl_aw", "nl_ab")


def _lists(j_nls):
    jnl = dict(zip(NL_NAMES, j_nls))
    tnl = {k: convert.neighbor_list_from_numpy(jax.tree.map(np.asarray, v))
           for k, v in jnl.items()}
    return jnl, tnl


@pytest.fixture(scope="module")
def scenes():
    rng = np.random.default_rng(18)
    jc, jw, ja = jsq.build_case(dx=0.1, dtype=jnp.float64)
    tc, _, _ = tsq.build_case(dx=0.1, dtype=torch.float64, device="cpu")
    w = _perturb(jw, rng, 0.1, jsq.RHO0_F)
    a = _perturb(ja, rng, 0.1, jsq.RHO0_A)
    jw, ja = _to_jax(w), _to_jax(a)
    jnl, tnl = _lists(
        jax.jit(lambda w, a: jsq.rebuild(jc, w, a))(jw, ja)[:-1])
    assert not any(bool(v.overflow) for v in jnl.values())
    return {"2d": Scene(jc, tc, {"water": jw, "air": ja},
                        {"water": convert.state_from_numpy(w),
                         "air": convert.state_from_numpy(a)}, jnl, tnl, 2)}


@functools.lru_cache(maxsize=None)
def _cubic_scene():
    """The 3D scene, built by the first test that asks for it."""
    _, _, jc, tc, _, _, js, _, _ = runs("cubic_droplet_3d")
    jnl, tnl = _lists([getattr(js, k) for k in NL_NAMES])
    return Scene(jc, tc, {"water": js.water, "air": js.air},
                 {p: convert.state_from_numpy(_np(getattr(js, p)))
                  for p in ("water", "air")}, jnl, tnl, 3)


def _scene(scenes, name):
    return _cubic_scene() if name == "3d" else scenes[name]


def _hold(t_out, j_out, keys=None, tol=TOL):
    for k in keys or j_out:
        if k != "NReal":
            close(t_out[k], j_out[k], tol, what=k)


# phase -> (its lists: inner, to the other phase, to the wall; the other
# phase; the contact solver's name; its mu and rho0)
PHASES = {"water": ("nl_ww", "nl_wa", "nl_wb", "air", "rs_wa", "eos_w",
                    "rs_w", jsq.MU_F),
          "air": ("nl_aa", "nl_aw", "nl_ab", "water", "rs_aw", "eos_a",
                  "rs_a", jsq.MU_A)}


def _call(pkg, fn, *args, **kw):
    """The port's function, or JAX's compiled as one program (its eager
    ops compile one by one)."""
    if pkg == "t":
        return fn(*args, **kw)
    return jax.jit(lambda: fn(*args, **kw))()


def _first_half(pkg, sc, side, phase, solver=None, contacts=True):
    inner, cross, wall, other, crs, eos, rs_inner, _ = PHASES[phase]
    case, st, nl = (sc.jc, sc.j, sc.jnl) if pkg == "j" else \
        (sc.tc, sc.t, sc.tnl)
    fd = jfd if pkg == "j" else tfd
    c = [(st[other], nl[cross], getattr(case, solver or crs))] \
        if contacts else []
    return _call(pkg, fd.acoustic_step_1st_half,
                 st[phase], nl[inner], case.kernel, sc.dim,
                 getattr(case, eos), getattr(case, rs_inner), DT,
                 walls=[(case.wall, nl[wall])], contacts=c)


def _second_half(pkg, sc, side, phase, solver=None, contacts=True):
    inner, cross, wall, other, crs, _, rs_inner, _ = PHASES[phase]
    case, st, nl = (sc.jc, sc.j, sc.jnl) if pkg == "j" else \
        (sc.tc, sc.t, sc.tnl)
    fd = jfd if pkg == "j" else tfd
    c = [(st[other], nl[cross], getattr(case, solver or crs))] \
        if contacts else []
    return _call(pkg, fd.acoustic_step_2nd_half,
                 st[phase], nl[inner], case.kernel, sc.dim,
                 getattr(case, rs_inner), DT, walls=[(case.wall, nl[wall])],
                 contacts=c)


def _viscous(pkg, sc, side, phase, solver=None, contacts=True):
    inner, cross, wall, other, _, _, _, mu = PHASES[phase]
    case, st, nl = (sc.jc, sc.j, sc.jnl) if pkg == "j" else \
        (sc.tc, sc.t, sc.tnl)
    fd = jfd if pkg == "j" else tfd
    c = [(st[other], nl[cross], jsq.MU_WA)] if contacts else []
    return _call(pkg, fd.viscous_force, st[phase], nl[inner], case.kernel,
                 sc.dim, mu, case.adaptation.h, walls=[(case.wall, nl[wall])],
                 contacts=c)


TERMS = {"acoustic_step_1st_half": _first_half,
         "acoustic_step_2nd_half": _second_half,
         "viscous_force": _viscous}


@pytest.mark.parametrize("phase", ["water", "air"])
@pytest.mark.parametrize("term", sorted(TERMS))
def test_contact_terms_match_jax(scenes, term, phase):
    sc = scenes["2d"]
    fn = TERMS[term]
    _hold(fn("t", sc, "t", phase), fn("j", sc, "j", phase))


@pytest.mark.parametrize("term", ["acoustic_step_1st_half",
                                  "acoustic_step_2nd_half"])
def test_contact_solver_orientation(scenes, term):
    """Each phase with the other's orientation matches JAX run alike, and
    differs from the phase's own by far more than roundoff: the
    orientation is seen."""
    sc = scenes["2d"]
    fn = TERMS[term]
    for phase, wrong in (("water", "rs_aw"), ("air", "rs_wa")):
        t_wrong = fn("t", sc, "t", phase, solver=wrong)
        _hold(t_wrong, fn("j", sc, "j", phase, solver=wrong))
        t_right = fn("t", sc, "t", phase)
        key = "DensityChangeRate" if term.endswith("2nd_half") else "Force"
        gap = float((t_wrong[key] - t_right[key]).abs().max())
        assert gap > 1e-6 * float(t_right[key].abs().max()), (phase, gap)


@pytest.mark.parametrize("term", sorted(TERMS))
def test_rows_without_contact_neighbour(scenes, term):
    """Rows with no neighbour of the other phase: the contact adds
    exactly nothing there; rows with some get a term."""
    sc = scenes["2d"]
    fn = TERMS[term]
    for phase in ("water", "air"):
        cross = PHASES[phase][1]
        lone = sc.tnl[cross].count == 0
        assert bool(lone.any()) and bool((~lone).any()), phase
        with_c = fn("t", sc, "t", phase)
        without = fn("t", sc, "t", phase, contacts=False)
        key = "ViscousForce" if term == "viscous_force" else "Force"
        assert torch.equal(with_c[key][lone], without[key][lone])
        assert float((with_c[key][~lone] - without[key][~lone])
                     .abs().max()) > 0.0


def test_first_substep_reads_the_built_pressure():
    """The two-phase dambreak's first acoustic sub-step from its build:
    each first half reads the other phase's stored Pressure (the build's,
    zero) and its state before the sub-step, the second halves the first
    halves'.  Held to JAX's four halves."""
    jc, jw, ja = jtp.build_case(dx=0.1, dtype=jnp.float64)
    tc, _, _ = ttp.build_case(dx=0.1, dtype=torch.float64, device="cpu")
    js = jtp.init_sim(jc, jw, ja)
    ts = convert.sim_from_numpy(ttp.SimState,
                                jax.tree_util.tree_map(np.asarray, js))
    assert float(np.abs(np.asarray(ja["Pressure"])).max()) == 0.0
    h = jc.adaptation.h
    dt = jnp.minimum(jfd.acoustic_time_step(jw, jc.eos_w, h),
                     jfd.acoustic_time_step(ja, jc.eos_a, h))
    w2, a2 = _call("j", _jax_substep, jc, js, jw, ja, dt, 2)
    tw2, ta2 = ttp.acoustic_substep(tc, ts, ts.water, ts.air,
                                    torch.as_tensor(float(dt),
                                                    dtype=torch.float64))
    _hold(tw2, w2)
    _hold(ta2, a2)


def _jax_substep(jc, nl, w, a, dt, dim):
    """JAX's four halves of one two-phase sub-step (the cases' order)."""
    k = jc.kernel
    w1 = jfd.acoustic_step_1st_half(w, nl.nl_ww, k, dim, jc.eos_w, jc.rs_w,
                                    dt, walls=[(jc.wall, nl.nl_wb)],
                                    contacts=[(a, nl.nl_wa, jc.rs_wa)])
    a1 = jfd.acoustic_step_1st_half(a, nl.nl_aa, k, dim, jc.eos_a, jc.rs_a,
                                    dt, walls=[(jc.wall, nl.nl_ab)],
                                    contacts=[(w, nl.nl_aw, jc.rs_aw)])
    w2 = jfd.acoustic_step_2nd_half(w1, nl.nl_ww, k, dim, jc.rs_w, dt,
                                    walls=[(jc.wall, nl.nl_wb)],
                                    contacts=[(a1, nl.nl_wa, jc.rs_wa)])
    a2 = jfd.acoustic_step_2nd_half(a1, nl.nl_aa, k, dim, jc.rs_a, dt,
                                    walls=[(jc.wall, nl.nl_ab)],
                                    contacts=[(w1, nl.nl_aw, jc.rs_aw)])
    return w2, a2


def test_phases_advance_together(scenes):
    """On the perturbed scene, whose stored pressures are not the EoS's
    of their densities: the port's sub-step equals JAX's, and feeding
    the water's first-half state to the air's first half (a phase by
    phase order) parts from it."""
    sc = scenes["2d"]
    jnl = types.SimpleNamespace(**sc.jnl)
    tnl = types.SimpleNamespace(**sc.tnl)
    w2, a2 = _call("j", _jax_substep, sc.jc, jnl, sc.j["water"],
                   sc.j["air"], DT, 2)
    tw2, ta2 = ttp.acoustic_substep(sc.tc, tnl, sc.t["water"], sc.t["air"],
                                    DT)
    _hold(tw2, w2)
    _hold(ta2, a2)
    tc = sc.tc
    tw1 = _first_half("t", sc, "t", "water")
    ta1_seq = tfd.acoustic_step_1st_half(
        sc.t["air"], tnl.nl_aa, tc.kernel, 2, tc.eos_a, tc.rs_a, DT,
        walls=[(tc.wall, tnl.nl_ab)], contacts=[(tw1, tnl.nl_aw, tc.rs_aw)])
    ta1 = _first_half("t", sc, "t", "air")
    gap = float((ta1_seq["Velocity"] - ta1["Velocity"]).abs().max())
    assert gap > 1e-6 * float(ta1["Velocity"].abs().max())


# ---------------------------------------------------------------------------
# physics/surface_tension.py
# ---------------------------------------------------------------------------

SCENE_PHASES = [(d, p) for d in ("2d", "3d") for p in ("water", "air")]
IDS = [f"{d}-{p}" for d, p in SCENE_PHASES]


def _frac(phase):
    return jsq.FRAC_W if phase == "water" else jsq.FRAC_A


@pytest.mark.parametrize("dim_name,phase", SCENE_PHASES, ids=IDS)
def test_surface_tension_stress_matches_jax(scenes, dim_name, phase):
    sc = _scene(scenes, dim_name)
    _, cross, _, other, *_ = PHASES[phase]
    j = _call("j", jst.surface_tension_stress, sc.j[phase],
              [(sc.j[other], sc.jnl[cross], _frac(phase))], sc.jc.kernel,
              sc.dim, jsq.SIGMA)
    t = tst.surface_tension_stress(sc.t[phase], [(sc.t[other], sc.tnl[cross],
                                                   _frac(phase))],
                                   sc.tc.kernel, sc.dim, jsq.SIGMA)
    _hold(t, j, ("ColorGradient", "NormDirection", "SurfaceTensionStress"))
    # the rows with no neighbour of the other phase (2D: the droplet's
    # core and the far air): zero stress
    lone = sc.tnl[cross].count == 0
    assert bool(lone.any()) or dim_name == "3d"
    assert float(t["SurfaceTensionStress"][lone].abs().sum()) == 0.0


@pytest.mark.parametrize("dim_name,phase", SCENE_PHASES, ids=IDS)
def test_surface_stress_force_matches_jax(scenes, dim_name, phase):
    sc = _scene(scenes, dim_name)
    inner, cross, _, other, *_ = PHASES[phase]
    j = _call("j", jst.surface_stress_force, sc.j[phase], sc.jnl[inner],
              [(sc.j[other], sc.jnl[cross], _frac(phase))], sc.jc.kernel,
              sc.dim, jsq.SIGMA)
    t = tst.surface_stress_force(sc.t[phase], sc.tnl[inner],
                                 [(sc.t[other], sc.tnl[cross], _frac(phase))],
                                 sc.tc.kernel, sc.dim, jsq.SIGMA)
    _hold(t, j, ("SurfaceTensionForce", "ForcePrior",
                 "SurfaceTensionForcePrev"))
    # no Prev on the state: the bookkeeping starts from zero
    st = {k: v for k, v in sc.t[phase].items()
          if k != "SurfaceTensionForcePrev"}
    t0 = tst.surface_stress_force(st, sc.tnl[inner],
                                  [(sc.t[other], sc.tnl[cross],
                                    _frac(phase))],
                                  sc.tc.kernel, sc.dim, jsq.SIGMA)
    close(t0["ForcePrior"] - sc.t[phase]["ForcePrior"],
          t["SurfaceTensionForce"].numpy())


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("identity", [False, True])
def test_mismatch_matches_jax(dim, identity):
    rng = np.random.default_rng(dim + 2 * identity)
    cg = rng.normal(size=(40, 6, dim))
    e = rng.normal(size=(40, 6, dim))
    r = rng.random((40, 6))
    r[0] = 0.0                               # M = 0: sqrt(TINY) floors |M|
    eye_j = jnp.eye(dim) if identity else 0.0
    eye_t = torch.eye(dim, dtype=torch.float64) if identity else 0.0
    j = jst._mismatch(jnp.asarray(cg), jnp.asarray(e), jnp.asarray(r), eye_j)
    t = tst._mismatch(torch.as_tensor(cg), torch.as_tensor(e),
                      torch.as_tensor(r), eye_t)
    close(t, j)


@pytest.mark.parametrize("sigma", [jsq.SIGMA, 100.0])
@pytest.mark.parametrize("phase", ["water", "air"])
def test_surface_tension_time_step_matches_jax(scenes, phase, sigma):
    """sigma = 100 lifts the capillary speed above c + |v|: the floor
    binds."""
    sc = scenes["2d"]
    eos, rho0 = PHASES[phase][5], (jsq.RHO0_F if phase == "water"
                                   else jsq.RHO0_A)
    h = sc.jc.adaptation.h
    j = jst.surface_tension_time_step(sc.j[phase], getattr(sc.jc, eos), h,
                                      rho0, sigma)
    t = tst.surface_tension_time_step(sc.t[phase], getattr(sc.tc, eos), h,
                                      rho0, sigma)
    assert t.dim() == 0
    close(t, j)


def test_contact_fraction():
    for a, b in ((1.0, 0.001), (0.001, 1.0), (1000.0, 1.0)):
        assert tst.contact_fraction(a, b) == jst.contact_fraction(a, b)


def test_flat_interface_stress_is_tangential():
    """tests/test_surface_tension.py's check on the port's build at
    dx = 0.08: along the droplet's top edge the colour gradient points
    into the water (-y), S n = 0 and trace(S) = sigma |grad C|."""
    case, water, air = tsq.build_case(dx=0.08, dtype=torch.float64,
                                      device="cpu")
    s = tsq.init_sim(case, water, air)
    w = tst.surface_tension_stress(s.water, [(s.air, s.nl_wa, tsq.FRAC_W)],
                                   case.kernel, 2, tsq.SIGMA)
    pos, cg = w["Position"].numpy(), w["ColorGradient"].numpy()
    S, nd = w["SurfaceTensionStress"].numpy(), w["NormDirection"].numpy()
    sel = (np.abs(pos[:, 0]) < 0.3) & (pos[:, 1] > 0.5 - 0.1)
    sel &= np.linalg.norm(cg, axis=-1) > 0.5 * np.abs(cg[sel][:, 1]).max()
    assert sel.sum() >= 3
    assert (cg[sel][:, 1] < 0).all()
    assert (np.abs(cg[sel][:, 0]) < 0.2 * np.abs(cg[sel][:, 1])).all()
    Sn = np.einsum("nij,nj->ni", S[sel], nd[sel])
    assert np.abs(Sn).max() < 1e-5 * np.abs(S[sel]).max()
    np.testing.assert_allclose(S[sel][:, 0, 0] + S[sel][:, 1, 1],
                               tsq.SIGMA * np.linalg.norm(cg[sel], axis=-1),
                               rtol=1e-5)
    # the capillary floor of the time step at rest
    h = case.adaptation.h
    dt = float(tst.surface_tension_time_step(water, case.eos_w, h,
                                             tsq.RHO0_F, tsq.SIGMA))
    cap = np.sqrt(2 * np.pi * tsq.SIGMA / (tsq.RHO0_F * h))
    np.testing.assert_allclose(dt, 0.6 * h / max(tsq.C_F, cap), rtol=1e-12)


# ---------------------------------------------------------------------------
# cubic_droplet_3d, the 3D case (the 2D cases: test_torch_multiphase_cases)
# ---------------------------------------------------------------------------

CUBIC_BODIES = ("WaterBody", "AirBody", "Wall")


def test_cubic_droplet_build_and_run_match_jax():
    jm, tm, jc, tc, jst_, tst_, js, ts, _ = runs("cubic_droplet_3d")
    hold_build(jst_, tst_)
    assert (tc.n_water, tc.n_air) == (jc.n_water, jc.n_air)
    for k in ("Position", "NormalDirection"):
        close(tc.wall[k], jc.wall[k], what=k)
    assert ts.n_adv >= 2
    hold_sims(("water", "air"), js, ts)
    for body in ("water", "air"):
        for k in ("ColorGradient", "SurfaceTensionStress",
                  "SurfaceTensionForce"):
            close(getattr(ts, body)[k], getattr(js, body)[k], POS_TOL,
                  (body, k))
    close(tm.water_kinetic_energy(ts), jm.water_kinetic_energy(js), POS_TOL)
    close(tm.water_max_radius(ts), jm.water_max_radius(js), POS_TOL)


def test_cubic_droplet_continues_jax_state():
    jm, tm, jc, tc, _, _, js, ts, jrun = runs("cubic_droplet_3d")
    js1, ts1 = continue_one_step(jm, tm, js, ts, jrun, tc)
    hold_sims(("water", "air"), js1, ts1)


def test_cubic_droplet_cli_entry_runs_on_the_cpu(tmp_path, caplog):
    _, _, _, tc, _, tst_, _, _, _ = runs("cubic_droplet_3d")
    n_real = dict(zip(CUBIC_BODIES, (tst_[0]["NReal"], tst_[1]["NReal"],
                                     tc.wall["NReal"])))
    cli_runs("cubic_droplet_3d", ("dx=0.2", "t_end=0.002"), CUBIC_BODIES,
             tmp_path, caplog, n_real)
