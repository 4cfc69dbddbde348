"""Parity of the port's PK2 lattice first half
(physics/solid_lattice.py `integration_1st_half_pk2_lattice`) with the
JAX package's, on tests/test_solid_lattice.py's 14 x 6 x 6 box at
dx = 0.1 in float64, full and notched (the notch's sites NaN-poisoned):
every output within 1e-12 of max|JAX| (float64 roundoff after the ~80
taps), NaN where JAX has NaN; and the JAX test it mirrors
(tests/test_solid_lattice.py:103-112): the force within 1e-10 and the
velocity within 1e-12 of the port's gather first half on the valid
sites."""

import numpy as np
import pytest
import torch

from sphinxsys_tpu.core import materials as JM
from sphinxsys_tpu.core.adaptation import SPHAdaptation as JAdaptation
from sphinxsys_tpu.physics import solid_lattice as jsl
from sphinxsys_tpu_torch.core import materials as TM
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation as TAdaptation
from sphinxsys_tpu_torch.neighbors.cell_list import (
    build_cell_table as t_table, grid_from_bounds as t_grid)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (
    build_neighbor_list as t_list)
from sphinxsys_tpu_torch.physics import solid as tsd
from sphinxsys_tpu_torch.physics import solid_lattice as tsl

from test_torch_solid_lattice import (DT, DX, MATERIAL, _box, _close,
                                      _jax_state, _port_lattice, _torch_state)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------

def _gather_pairs(state, valid):
    """The port's frozen pairs of the box (invalid sites parked far away),
    as tests/test_solid_lattice.py builds JAX's."""
    pos = state["Position"].copy()
    n = len(pos)
    park = 1.0e6 + np.arange(n)[:, None] * np.asarray([DX, 0.0, 0.0])
    pos[~valid] = park[~valid]
    ad = TAdaptation(spacing=DX, dim=3)
    grid = t_grid((-4 * DX,) * 3, (18 * DX,) * 3, ad.cutoff)
    tp, vm = torch.as_tensor(pos), torch.as_tensor(valid)
    nl = t_list(tp, vm, tp, vm, t_table(tp, vm, grid, 64), grid, ad.cutoff,
                k_max=96, include_self=False)
    assert not bool(nl.overflow)
    return tsd.freeze_reference_pairs(tp, nl, ad.kernel, 3), torch.as_tensor(pos)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "notch"])
def test_pk2_lattice_first_half(masked):
    """Against JAX's stencil (1e-12, every output, NaN where JAX has NaN),
    and tests/test_solid_lattice.py:103-112: against the port's gather
    first half on the valid sites, the force within 1e-10 and the
    velocity within 1e-12 of max|.|."""
    state, jlat = _box(masked)
    h = JAdaptation(spacing=DX, dim=3).h
    ref = jsl.integration_1st_half_pk2_lattice(
        _jax_state(state), jlat, JM.NeoHookeanSolid(**MATERIAL), DT, h)
    tmat = TM.NeoHookeanSolid(**MATERIAL)
    dt = torch.tensor(DT, dtype=torch.float64)
    got = tsl.integration_1st_half_pk2_lattice(_torch_state(state),
                                               _port_lattice(), tmat, dt, h)
    assert set(got) == set(ref)
    for k in ("Position", "DeformationGradient", "Density",
              "StressPK1OnParticle", "Force", "Velocity"):
        _close(got[k].numpy(), ref[k], 1e-12, k)

    valid = state["LatticeValid"]
    rp, parked = _gather_pairs(state, valid)
    clean = {k: np.where(valid.reshape((-1,) + (1,) * (v.ndim - 1)), v,
                         np.eye(3) if v.ndim == 3 else 0.0)
             if k != "LatticeValid" else v for k, v in state.items()}
    clean["Position"] = parked.numpy()
    ts = _torch_state(clean)
    ts["VolumetricMeasure"] = ts["VolumetricMeasure"] * torch.as_tensor(valid)
    gather = tsd.integration_1st_half_pk2(ts, rp, tmat, dt, h,
                                          TAdaptation(spacing=DX, dim=3).kernel.w0(3))
    lat = tsl.integration_1st_half_pk2_lattice(ts, _port_lattice(), tmat, dt, h)
    f_ref, f_lat = gather["Force"].numpy()[valid], lat["Force"].numpy()[valid]
    assert np.abs(f_ref - f_lat).max() < 1e-10 * (np.abs(f_ref).max() + 1e-30)
    v_ref, v_lat = gather["Velocity"].numpy()[valid], lat["Velocity"].numpy()[valid]
    assert np.abs(v_ref - v_lat).max() < 1e-12 * (np.abs(v_ref).max() + 1e-30)


