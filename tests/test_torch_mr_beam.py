"""Parity of the port's mr_cantilever_beam_2d with the JAX package's on
the CPU, float64, at dx = PH / 4 (the adaptive pairs frozen once): the
build equal to JAX's (the frozen pairs exactly, fields within 1e-12) and
a few steps with equal counts and every field within 1e-9 of its max
|JAX|.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_mr_cases import F64, RUN_TOL, same_state
from test_torch_viscosity import close

from sphinxsys_tpu.cases import mr_cantilever_beam_2d as jmb
from sphinxsys_tpu_torch.cases import mr_cantilever_beam_2d as tmb

torch.set_num_threads(1)


def test_mr_beam_matches_jax():
    dx = tmb.PH / 4.0
    jc, js = jmb.build_case(dx=dx, dtype=jnp.float64)
    tc, ts = tmb.build_case(dx=dx, **F64)
    assert tc.n_solid == jc.n_solid
    np.testing.assert_array_equal(tc.base_mask.numpy(),
                                  np.asarray(jc.base_mask))
    np.testing.assert_array_equal(tc.rp.idx.numpy(), np.asarray(jc.rp.idx))
    for k in ("W", "dW", "r", "e"):
        close(getattr(tc.rp, k), getattr(jc.rp, k), 1e-12, k)
    same_state(ts.solid, js.solid, 1e-12, "build")
    js = jmb.make_run_chunk(jc)(js, jnp.asarray(4e-4, jnp.float64))
    ts = tmb.make_run_chunk(tc)(ts, 4e-4)
    assert ts.n_steps == int(js.n_steps) >= 5
    assert float(ts.time) == pytest.approx(float(js.time), rel=1e-12)
    same_state(ts.solid, js.solid, RUN_TOL, "run")
    assert tmb.tip_displacement(tc, ts) == pytest.approx(
        jmb.tip_displacement(jc, js), rel=1e-9)
