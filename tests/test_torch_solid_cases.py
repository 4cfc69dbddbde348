"""Parity of the port's six solid cases of this slice with the JAX package,
on the CPU in float64 (oscillating_beam_2d and its Cauchy integrator,
self_contact_2d, passive_cantilever_3d, muscle_activation_3d,
anisotropic_beam_2d), at reduced widths.

For each case, as tests/test_torch_corrected_cases.py does for the fluid
(whose helpers these are): the builds held to each other (1e-12); a few
steps with equal counts, positions, velocities, deformation gradients
(and the muscle's active stress) within 1e-9 of their max and the case's
observer; one more step from JAX's carried state; the CLI entry with
`--set device=cpu`.  Beside: the self-contact list filtered at rest is
empty and its force zero; the anisotropic beam's frozen pairs equal
JAX's; the activated cube's holder stays put in x.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_corrected_cases import (POS_TOL, RUNS, cli_runs, close,
                                        continue_one_step, hold_build,
                                        hold_sims, runs)

torch.set_num_threads(1)

# case -> (build keywords of both packages, run end time, CLI sets, the
# sim's bodies, the CLI's body names)
CASES = {
    "oscillating_beam_2d": (dict(dx=0.004), 0.001, ("dx=0.004",
                                                     "t_end=0.0005"),
                            ("solid",), ("BeamBody",)),
    "oscillating_beam_cauchy_2d": (dict(dx=0.004), 0.001,
                                   ("dx=0.004", "t_end=0.0005"), ("solid",),
                                   ("BeamBody",)),
    "self_contact_2d": (dict(dx=0.002), 0.001, ("dx=0.002", "t_end=0.0005"),
                        ("beam",), ("BeamBody",)),
    "passive_cantilever_3d": (dict(dx=0.25), 0.005, ("dx=0.25",
                                                      "t_end=0.002"),
                              ("body",), ("CantileverBody",)),
    "muscle_activation_3d": (dict(dx=0.1), 0.02, ("dx=0.1", "t_end=0.01"),
                             ("body",), ("MyocardiumMuscleBody",)),
    "anisotropic_beam_2d": (dict(dy=0.004), 0.001, ("dy=0.004",
                                                    "t_end=0.0005"),
                            ("solid",), ("BeamBody",)),
}
RUNS.update({name: v[:2] for name, v in CASES.items()})


def _observable(name, mod, case, sim, built):
    if name in ("oscillating_beam_2d", "oscillating_beam_cauchy_2d",
                "anisotropic_beam_2d"):
        return mod.tip_displacement(case, sim)
    if name == "self_contact_2d":
        return mod.observe_tip(sim, *mod.tip_observer(case, built))
    if name == "passive_cantilever_3d":
        return mod.observe_corner(sim, *mod.corner_observer(case, built))
    return mod.free_end_x(sim)


def _body(states):
    s = states[0]
    return s if isinstance(s, dict) else s.solid


@pytest.mark.parametrize("name", sorted(CASES))
def test_build_matches_jax(name):
    _, _, jc, tc, jst, tst, _, _, _ = runs(name)
    hold_build(jst, tst)
    for k in ("n", "n_solid"):
        if hasattr(jc, k):
            assert getattr(tc, k) == getattr(jc, k), k
    for k in ("base_mask", "holder_mask"):
        if hasattr(jc, k):
            np.testing.assert_array_equal(getattr(tc, k).numpy(),
                                          np.asarray(getattr(jc, k)))
    np.testing.assert_array_equal(tc.rp.idx.numpy(), np.asarray(jc.rp.idx))
    for k in ("W", "dW", "r", "e"):
        close(getattr(tc.rp, k), getattr(jc.rp, k), what=("rp", k))


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_matches_jax(name):
    jm, tm, jc, tc, jst, tst, js, ts, _ = runs(name)
    assert ts.n_steps >= 3
    hold_sims(CASES[name][3], js, ts)
    close(_observable(name, tm, tc, ts, _body(tst)),
          _observable(name, jm, jc, js, _body(jst)), POS_TOL, "observable")


@pytest.mark.parametrize("name", sorted(CASES))
def test_continues_jax_state(name):
    jm, tm, jc, tc, _, _, js, ts, jrun = runs(name)
    js1, ts1 = continue_one_step(jm, tm, js, ts, jrun, tc)
    hold_sims(CASES[name][3], js1, ts1)


@pytest.mark.parametrize("name", sorted(CASES))
def test_cli_entry_runs_on_the_cpu(name, tmp_path, caplog):
    _, _, _, _, _, tst, _, _, _ = runs(name)
    bodies = CASES[name][4]
    cli_runs(name, CASES[name][2], bodies, tmp_path, caplog,
             {bodies[0]: _body(tst)["NReal"]})


def test_self_contact_list_at_rest_is_empty():
    """NeighborBuilderSelfContact keeps only pairs whose initial distance
    exceeds the cutoff: on the undeformed beam none, so the factor and the
    force are zero; the list itself equals JAX's."""
    from sphinxsys_tpu.cases import self_contact_2d as jsc
    from sphinxsys_tpu.neighbors import build_cell_table, build_neighbor_list
    from sphinxsys_tpu.physics import contact as jct

    _, tm, jc, tc, jst, tst, _, _, _ = runs("self_contact_2d")
    beam = tst[0]
    nl, nl_self = tm.self_contact_list(tc, beam)
    assert int(nl_self.count.sum()) == 0 and int(nl.count.sum()) > 0
    force = tm.self_contact_force(tc, beam, nl_self)
    assert float(force["RepulsionForce"].abs().max()) == 0.0
    jb = jst[0]
    table = build_cell_table(jb["Position"], jb["NReal"], jc.grid,
                             cap=jc.cell_cap)
    jnl = build_neighbor_list(jb["Position"], jb["NReal"], jb["Position"],
                              jb["NReal"], table, jc.grid,
                              jc.adaptation.cutoff, k_max=jc.k_contact,
                              include_self=False)
    np.testing.assert_array_equal(nl.idx.numpy(), np.asarray(jnl.idx))
    jself = jct.filter_self_contact_pairs(jnl, jb["InitialPosition"],
                                          jc.adaptation.cutoff)
    assert int(jnp.sum(jself.count)) == 0
    assert jsc.PL == tm.PL


def test_self_contact_filter_keeps_folded_pairs():
    """A beam folded onto itself (the tip moved next to the clamp's side):
    the filtered list holds the new contacts, both sides alike."""
    from sphinxsys_tpu.neighbors import build_cell_table, build_neighbor_list
    from sphinxsys_tpu.physics import contact as jct
    from sphinxsys_tpu_torch import convert

    _, tm, jc, tc, jst, tst, _, _, _ = runs("self_contact_2d")
    pos = tst[0]["Position"].numpy().copy()
    tip = pos[:, 0] > 0.15
    pos[tip, 0] = -pos[tip, 0] + 0.2
    pos[tip, 1] += 0.5 * tc.dx + 0.01
    beam = dict(tst[0], Position=torch.as_tensor(pos))
    nl, nl_self = tm.self_contact_list(tc, beam)
    assert int(nl_self.count.sum()) > 0
    jp = jnp.asarray(pos)
    n = jst[0]["NReal"]
    table = build_cell_table(jp, n, jc.grid, cap=jc.cell_cap)
    jnl = build_neighbor_list(jp, n, jp, n, table, jc.grid,
                              jc.adaptation.cutoff, k_max=jc.k_contact,
                              include_self=False)
    jself = jct.filter_self_contact_pairs(jnl, jst[0]["InitialPosition"],
                                          jc.adaptation.cutoff)
    np.testing.assert_array_equal(nl_self.idx.numpy(), np.asarray(jself.idx))
    got = tm.self_contact_force(tc, beam, nl_self)
    ref = jct.repulsion_force_self(
        {k: jnp.asarray(v) for k, v in convert.to_numpy(beam).items()},
        jself, jc.kernel, 2,
        jct.repulsion_factor_self(
            {k: jnp.asarray(v) for k, v in convert.to_numpy(beam).items()},
            jself, jc.kernel, 2, jc.dx),
        tm.RHO0, jct.contact_stiffness(jc.material))
    close(got["RepulsionForce"], ref["RepulsionForce"], what="repulsion")


def test_muscle_holder_fixed_in_x_and_active_stress():
    _, tm, _, tc, _, _, js, ts, _ = runs("muscle_activation_3d")
    hm = tc.holder_mask
    b = ts.body
    assert float((b["Position"][hm, 0] - b["InitialPosition"][hm, 0])
                 .abs().max()) < 1e-12
    assert float(b["ActiveContractionStress"].min()) < 0.0
    close(b["ActiveContractionStress"], js.body["ActiveContractionStress"],
          POS_TOL, "Ta")
