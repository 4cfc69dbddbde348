"""Parity of the port's three 2D multi-phase cases with the JAX package,
on the CPU in float64 (two_phase_dambreak_2d, square_droplet_2d,
droplet_impact_2d), at reduced widths; the 3D one, cubic_droplet_3d, is
held in tests/test_torch_multiphase.py beside the 3D surface tension.

For each case, as tests/test_torch_corrected_cases.py does (whose
helpers these are): the builds held to each other (1e-12); a few
advection steps with equal counts, both phases' positions, velocities,
densities and pressures within 1e-9 of their max, and the case's
observable; one more step from JAX's carried state; the CLI entry with
`--set device=cpu`.  Beside: the port's counterparts of the JAX tests'
build checks (the droplet's initial kinetic energy and corner radius,
the air's mass).
"""

import numpy as np
import pytest
import torch

from test_torch_corrected_cases import (POS_TOL, RUNS, cli_runs, close,
                                        continue_one_step, hold_build,
                                        hold_sims, runs)

torch.set_num_threads(1)

BODIES = ("water", "air")
# case -> (build keywords of both packages, run end time, CLI sets, the
# CLI's body names)
CASES = {
    "two_phase_dambreak_2d": (dict(dx=0.1), 0.05, ("dx=0.1", "t_end=0.02"),
                              ("WaterBody", "AirBody", "Wall")),
    "square_droplet_2d": (dict(dx=0.1), 0.01, ("dx=0.1", "t_end=0.005"),
                          ("WaterBody", "AirBody", "Wall")),
    "droplet_impact_2d": (dict(dx=0.05), 0.002, ("dx=0.05",
                                                  "t_end=0.0005"),
                          ("WaterBody", "AirBody", "WallBoundary")),
}
RUNS.update({name: v[:2] for name, v in CASES.items()})


def _observable(name, mod, sim):
    """The surge front (tests/test_two_phase.py's) or the water's kinetic
    energy."""
    if name == "two_phase_dambreak_2d":
        x = sim.water["Position"][:, 0]
        return float(np.max(x.numpy() if torch.is_tensor(x) else
                            np.asarray(x)))
    return mod.water_kinetic_energy(sim)


@pytest.mark.parametrize("name", sorted(CASES))
def test_build_matches_jax(name):
    _, _, jc, tc, jst, tst, _, _, _ = runs(name)
    hold_build(jst, tst)
    for k in ("n_water", "n_air"):
        assert getattr(tc, k) == getattr(jc, k), k
    for k in ("Position", "NormalDirection", "VolumetricMeasure", "Mass"):
        close(tc.wall[k], jc.wall[k], what=("wall", k))
    # the two-phase solvers, both orientations
    for k in ("rs_w", "rs_a", "rs_wa", "rs_aw"):
        j, t = getattr(jc, k), getattr(tc, k)
        for f in ("rho0c0_i", "rho0c0_j", "inv_c0_ave", "limiter_coeff"):
            assert getattr(t, f) == getattr(j, f), (k, f)


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_matches_jax(name):
    jm, tm, jc, tc, _, _, js, ts, _ = runs(name)
    assert ts.n_adv >= 2 and ts.n_ac > ts.n_adv
    hold_sims(BODIES, js, ts)
    close(_observable(name, tm, ts), _observable(name, jm, js), POS_TOL,
          "observable")
    if name != "two_phase_dambreak_2d":
        for body in BODIES:
            for k in ("ColorGradient", "SurfaceTensionStress",
                      "SurfaceTensionForce", "ViscousForce"):
                close(getattr(ts, body)[k], getattr(js, body)[k], POS_TOL,
                      (body, k))


@pytest.mark.parametrize("name", sorted(CASES))
def test_continues_jax_state(name):
    jm, tm, jc, tc, _, _, js, ts, jrun = runs(name)
    js1, ts1 = continue_one_step(jm, tm, js, ts, jrun, tc)
    hold_sims(BODIES, js1, ts1)


@pytest.mark.parametrize("name", sorted(CASES))
def test_cli_entry_runs_on_the_cpu(name, tmp_path, caplog):
    _, _, _, tc, _, tst, _, _, _ = runs(name)
    bodies = CASES[name][3]
    n_real = dict(zip(bodies, (tst[0]["NReal"], tst[1]["NReal"],
                               tc.wall["NReal"])))
    cli_runs(name, CASES[name][2], bodies, tmp_path, caplog, n_real)


def test_droplet_builds_hold_the_jax_tests_checks():
    """tests/test_droplet_impact.py's KE(0) = 1/2 rho V N U^2 of the
    lattice inside the ball, tests/test_surface_tension.py's corner
    radius (> 0.6 at dx = 0.08: here 0.1) and tests/test_two_phase.py's
    air mass, on the port's builds."""
    _, tm, _, tc, _, tst, _, _, _ = runs("droplet_impact_2d")
    sim = tm.init_sim(tc, *tst)
    ke0 = 0.5 * tm.RHO0_F * tc.dx ** 2 * tc.n_water * tm.U_REF ** 2
    assert tm.water_kinetic_energy(sim) == pytest.approx(ke0, rel=1e-12)
    _, tm, _, tc, _, tst, _, _, _ = runs("square_droplet_2d")
    assert tm.water_max_radius(tm.init_sim(tc, *tst)) > 0.6
    _, tm, _, tc, _, _, _, ts, _ = runs("two_phase_dambreak_2d")
    m_air = float(torch.sum(ts.air["Mass"]))
    assert m_air == pytest.approx(tc.n_air * tm.RHO0_A * tc.dx ** 2,
                                  rel=1e-12)
