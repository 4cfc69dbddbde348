"""The port's distributed cell-block engine in 3D
(parallel/block_domain.py) on a ThreadRing of 8 ranks against the port's
single-device block engine, on the CPU in float64: the 3D dambreak at
dx = 0.1 of tests/test_domain.py:205, at its tolerances (positions 1e-3
of max|x|, velocities 2e-3), with equal acoustic sub-step counts, the
times to rtol 1e-12 and every OriginalID present once.

The plain 3D sweeps take ~12 s an advection step here at the case's cap
of 40, so the quick test runs 2 steps at cap 28 (the lattice's 27 a cell
fit); JAX's 5 steps at cap 40 are the slow test (~2 min)."""

import numpy as np
import pytest
import torch

from sphinxsys_tpu_torch.cases import dambreak_3d as db3

from test_torch_block_domain import F64, _distributed, _hold, _single

torch.set_num_threads(1)


@pytest.mark.parametrize("cap,n_steps", [
    (28, 2), pytest.param(40, 5, marks=pytest.mark.slow)])
def test_block_engine_generic_distributed_3d(cap, n_steps):
    scene, fluid = db3.build_block_case(dx=0.1, cap=cap, **F64)
    n = int(fluid["NReal"])
    s, ref = _single(scene, fluid, n_steps)
    h = _distributed(scene, fluid, n_steps, 160, 64)
    scale = np.abs(ref["Position"][:n].numpy()).max()
    _hold(h, s, ref, n, 3, scale)
