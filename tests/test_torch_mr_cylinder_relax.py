"""The port's mr_cylinder_2d build against the JAX package's on the CPU,
float64, at dx = 0.8: its lattices; `relax_annulus`, the deterministic
half of the body-fitted start `_relax_near_cylinder`, held over a few
iterations from JAX's own jittered cylinder (the jitter is each package's
own generator); the CLI entry on the CPU.  The built case and its run are
held in tests/test_torch_mr_cylinder.py.
"""

import functools

import numpy as np
import torch

import jax.numpy as jnp

from test_torch_corrected_cases import cli_runs
from test_torch_mr_cases import F64

from sphinxsys_tpu.cases import mr_cylinder_2d as jmc
from sphinxsys_tpu_torch.cases import mr_cylinder_2d as tmc

torch.set_num_threads(1)

MC_DX = 0.8


# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_relaxed(n_cyl=3, n_f=4):
    """JAX's relaxed (pos_f, pos_w) at MC_DX with a few iterations, and its
    jittered cylinder's own relaxation (pos_w_rel) for the annulus."""
    pos_c, pos_f, pos_w = tmc.lattices(MC_DX)
    pos_f_rel, pos_w_rel = jmc._relax_near_cylinder(pos_f, pos_w, MC_DX,
                                                    n_iter_cyl=n_cyl,
                                                    n_iter_f=n_f)
    return pos_f, np.asarray(pos_f_rel), np.asarray(pos_w_rel)


def test_lattices_are_jax_build():
    """The port's lattices are the JAX build's (relax_ic off)."""
    jc, jf = jmc.build_case(dx=MC_DX, dtype=jnp.float64, relax_ic=False)
    pos_c, pos_f, pos_w = tmc.lattices(MC_DX)
    n_real = int(jf["NReal"])
    np.testing.assert_array_equal(
        np.concatenate([pos_c, pos_f]), np.asarray(jf["Position"])[:n_real])
    np.testing.assert_array_equal(pos_w, np.asarray(jc.cylinder["Position"]))


def test_relax_annulus_matches_jax():
    pos_f, pos_f_rel, pos_w_rel = jax_relaxed()
    got = tmc.relax_annulus(pos_f, pos_w_rel, MC_DX, n_iter=4,
                            device="cpu")
    moved = np.abs(pos_f_rel - pos_f).max()
    assert moved > 1e-3
    assert np.abs(got - pos_f_rel).max() <= 1e-12 * np.abs(pos_f_rel).max()


def test_mr_cylinder_cli_entry_runs_on_the_cpu(tmp_path, caplog):
    tc, tf = tmc.build_case(dx=MC_DX, relax_ic=False, **F64)
    cli_runs("mr_cylinder_2d", ("dx=0.8", "relax_ic=false", "t_end=0.1"),
             ("WaterBody", "Cylinder"), tmp_path, caplog,
             {"WaterBody": int(tf["NReal"]), "Cylinder": tc.n_cyl})
