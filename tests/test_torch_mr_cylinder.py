"""Parity of the port's mr_cylinder_2d with the JAX package's on the CPU,
float64, at dx = 0.8 (the open boundaries, the cylinder walls and the
multi-level list): the case built from the same body-fitted start in both
packages (`relaxed=`; a seeded jitter of the lattices near the cylinder
stands in for the relaxation, which tests/test_torch_mr_cylinder_relax.py
holds) equal to JAX's (lists exactly, fields within 1e-12), and run a few
advection steps (equal counts and overflow flags, every field and the
cylinder forces within 1e-9 of max |JAX|); the disposer and emitter on
a state pushed across both planes.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_mr_cases import F64, RUN_TOL, same_list, same_state
from test_torch_viscosity import close

from sphinxsys_tpu.cases import mr_cylinder_2d as jmc
from sphinxsys_tpu_torch.cases import mr_cylinder_2d as tmc

torch.set_num_threads(1)

MC_DX = 0.8


# --------------------------------------------------------------------------

def jittered_start(seed=0):
    """(pos_f, pos_w) as a relaxation leaves them: the fine lattice moved
    by up to a tenth of its spacing inside the relaxed region, the
    cylinder's lattice by up to a tenth of its own (both stay on their
    side of the surface)."""
    _, pos_f, pos_w = tmc.lattices(MC_DX)
    rng = np.random.default_rng(seed)
    region = np.hypot(pos_f[:, 0] - tmc.CX, pos_f[:, 1] - tmc.CY) \
        < tmc.R_REGION
    pos_f = pos_f.copy()
    pos_f[region] += 0.1 * (MC_DX / 2) * rng.uniform(
        -1.0, 1.0, (int(region.sum()), 2))
    pos_w = pos_w + 0.1 * (MC_DX / 4) * rng.uniform(-1.0, 1.0, pos_w.shape)
    return pos_f, pos_w


@functools.lru_cache(maxsize=None)
def mc_runs():
    pos_f_rel, pos_w_rel = jittered_start()
    orig = jmc._relax_near_cylinder
    jmc._relax_near_cylinder = lambda *a, **k: (pos_f_rel, pos_w_rel)
    try:
        jc, jf = jmc.build_case(dx=MC_DX, dtype=jnp.float64)
    finally:
        jmc._relax_near_cylinder = orig
    tc, tf = tmc.build_case(dx=MC_DX, relaxed=(pos_f_rel, pos_w_rel), **F64)
    js0, ts0 = jmc.init_sim(jc, jf), tmc.init_sim(tc, tf)
    js = jmc.make_run_chunk(jc)(js0, jnp.asarray(0.5, jnp.float64))
    ts = tmc.make_run_chunk(tc)(ts0, 0.5)
    return jc, tc, jf, tf, js0, ts0, js, ts


def test_mr_cylinder_build_matches_jax():
    jc, tc, jf, tf, js0, ts0, *_ = mc_runs()
    assert (tc.n_fluid, tc.n_cyl) == (jc.n_fluid, jc.n_cyl)
    assert set(tf) == set(jf)
    same_state(tf, jf, 1e-12, "fluid")
    same_state(tc.cylinder, jc.cylinder, 1e-12, "cylinder")
    np.testing.assert_array_equal(tc.wall_table.table.numpy(),
                                  np.asarray(jc.wall_table.table))
    for k in ("nl_ff", "nl_fw", "nl_wf"):
        same_list(getattr(ts0, k), getattr(js0, k), k)


def test_mr_cylinder_run_matches_jax():
    jc, tc, *_, js, ts = mc_runs()
    assert (ts.n_adv, ts.n_ac) == (int(js.n_adv), int(js.n_ac))
    assert ts.n_adv >= 3
    assert bool(ts.overflow) == bool(js.overflow) is False
    assert float(ts.time) == pytest.approx(float(js.time), rel=1e-12)
    same_state(ts.fluid, js.fluid, RUN_TOL, "run")
    for k in ("nl_ff", "nl_fw", "nl_wf"):
        same_list(getattr(ts, k), getattr(js, k), k)
    for g, r in zip(tmc.cylinder_forces(tc, ts), jmc.cylinder_forces(jc, js)):
        close(g, r, RUN_TOL, "forces")


def test_mr_cylinder_recycles_like_jax():
    """From JAX's run's state, steps that cross the startup ramp's first
    second recycle the same particles: the alive mask and the fields
    after the disposer and the emitter equal JAX's."""
    jc, tc, *_, js, ts = mc_runs()
    fluid = {k: torch.as_tensor(np.asarray(v)) if hasattr(v, "shape")
             and np.asarray(v).ndim else v for k, v in js.fluid.items()}
    fluid["NReal"] = int(js.fluid["NReal"])
    # push the sponge's front columns past the emitter's plane and the
    # last columns past the outlet
    shift = np.zeros_like(np.asarray(js.fluid["Position"]))
    x = np.asarray(js.fluid["Position"])[:, 0]
    shift[(x > -tmc.DL_SPONGE + tmc.BW - 0.5) & (x < -tmc.DL_SPONGE + tmc.BW)
          & np.asarray(js.fluid["Alive"]), 0] = 0.6
    shift[(x > tmc.DL - 0.5) & (x < tmc.DL), 0] = 0.6
    jpos_prev = js.fluid["Position"]
    jmoved = dict(js.fluid, Position=js.fluid["Position"] + shift)
    tmoved = dict(fluid, Position=fluid["Position"] + torch.as_tensor(shift))
    from sphinxsys_tpu.physics import boundary as jbd
    jout = jbd.disposer_outflow_deletion(jmoved, jc.disposer)
    jout = jbd.emitter_inflow_injection(
        jout, jc.emitter, fields=tuple(tmc.CLONE_FIELDS), prev_pos=jpos_prev)
    jinj = jout.pop("_InjectionOverflow")
    tout, tinj = tmc.open_boundaries(tc, tmoved,
                                     torch.as_tensor(np.asarray(jpos_prev)))
    assert bool(tinj) == bool(jinj)
    assert int(tout["Alive"].sum()) != int(np.asarray(js.fluid["Alive"]).sum()) \
        or int(torch.sum(tout["Alive"] != torch.as_tensor(
            np.asarray(js.fluid["Alive"])))) > 0
    same_state(tout, jout, 1e-15, "recycled")
