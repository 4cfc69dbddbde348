"""Parity of the port's compressible FVM path (sphinxsys_tpu_torch/fvm/
dynamics.py: the ideal-gas ghosts, time step and HLLC step, and the MUSCL
reconstruction) with the JAX package's on the CPU, on the meshes of
tests/test_torch_fvm.py and the seeded random gas states of
tests/test_torch_fvm_dynamics.py: within 1e-12 of max |JAX| in float64
and 2e-5 in float32; the far field entered on some faces and left on
others; a ghost override of the double Mach reflection's kind; the
Barth-Jespersen limiter with both of its branches taken (checked); MUSCL
refusing a 3D mesh.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_fvm_dynamics import far, gas_state, hold, meshes
from test_torch_viscosity import DTYPES, TOL, close

from sphinxsys_tpu.core.materials import CompressibleFluid as JGas
from sphinxsys_tpu.fvm import dynamics as jfv
from sphinxsys_tpu_torch.core.materials import CompressibleFluid as TGas
from sphinxsys_tpu_torch.fvm import dynamics as tfv

torch.set_num_threads(1)

DT = 1.0e-3


def _override_j(l, r, dm, t):
    """A ghost override of the double Mach reflection's kind: the faces
    left of a moving plane take a fixed state, the others the owner's."""
    sel = ~dm.interior & (dm.midpoint[:, 0] < 0.5 + t)
    vel = jnp.asarray([0.4, -0.1], l[1].dtype)
    return (jnp.where(sel, 2.0, l[0]), jnp.where(sel[:, None], vel, l[1]),
            jnp.where(sel, 3.0, l[2]), jnp.where(sel, 7.0, l[3]))


def _override_t(l, r, dm, t):
    sel = ~dm.interior & (dm.midpoint[:, 0] < 0.5 + t)
    vel = torch.as_tensor([0.4, -0.1], dtype=l[1].dtype)
    return (torch.where(sel, 2.0, l[0]), torch.where(sel[:, None], vel, l[1]),
            torch.where(sel, 3.0, l[2]), torch.where(sel, 7.0, l[3]))


@pytest.mark.parametrize("name,override", (
    ("rect_codes", False), ("rect_codes", True), ("hex", False),
    ("tet", False)), ids=("rect", "rect_override", "hex", "tet"))
@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
def test_compressible_step_matches_jax(dtype, name, override):
    jdm, tdm = meshes(name, dtype)
    dim = tdm.dim
    js, ts = gas_state(tdm.n_cells, dim, dtype)
    # a far-field velocity that enters some far faces and leaves others
    jf, tf_ = far(dim, vel=(1.3, 0.6, -0.5))
    jgas, tgas = JGas(gamma=1.4), TGas(gamma=1.4)
    jghosts, jdt = jax.jit(lambda s: (
        jfv.compressible_face_states(s, jdm, jf, jgas),
        jfv.compressible_time_step_fvm(s, jgas, jdm)))(js)
    hold(tfv.compressible_face_states(ts, tdm, tf_, tgas), jghosts, dtype,
         "ghosts")
    close(tfv.compressible_time_step_fvm(ts, tgas, tdm), jdt, TOL[dtype],
          "dt")
    kw_j = dict(ghost_override=_override_j, t=0.25) if override else {}
    kw_t = dict(ghost_override=_override_t,
                t=torch.tensor(0.25, dtype=tdm.area.dtype)) if override \
        else {}
    ref = jax.jit(lambda s: jfv.compressible_step(s, jdm, jgas, jf, DT,
                                                  **kw_j))(js)
    got = tfv.compressible_step(ts, tdm, tgas, tf_, DT, **kw_t)
    hold(got, ref, dtype, "compressible_step")


@pytest.mark.parametrize("name", ("rect_codes", "ogrid", "hex"))
@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
def test_muscl_parts_match_jax(dtype, name):
    """The gradient, the neighbour min / max and the limiter; the limiter
    takes both branches (dq > 0 and dq < 0, capped below 1) here."""
    jdm, tdm = meshes(name, dtype)
    rng = np.random.default_rng(5)
    q = rng.normal(size=tdm.n_cells)
    jq, tq = jnp.asarray(q, dtype), torch.as_tensor(q.astype(dtype))

    @jax.jit
    def parts(q):
        grad = jfv.green_gauss_gradient(q, jdm)
        faces = (jfv.muscl_face_values(q, jdm) if tdm.dim == 2 else None)
        return (grad, jfv._neighbor_minmax(q, jdm),
                jfv.barth_jespersen_limiter(q, grad, jdm), faces)

    jgrad, jminmax, jpsi, jfaces = parts(jq)
    tgrad = tfv.green_gauss_gradient(tq, tdm)
    close(tgrad, jgrad, TOL[dtype], "gradient")
    hold(tfv._neighbor_minmax(tq, tdm), jminmax, dtype, "minmax")
    tpsi = tfv.barth_jespersen_limiter(tq, tgrad, tdm)
    close(tpsi, jpsi, TOL[dtype], "psi")
    # both branches and an active limit, on the port's own values
    f = tdm.cell_faces
    dq = torch.sum(tgrad[:, None, :] * (tdm.midpoint[f]
                                        - tdm.centroids[:, None, :]), -1)
    real = f < tdm.n_faces
    assert bool((dq[real] > 0).any()) and bool((dq[real] < 0).any())
    assert bool((tpsi < 1.0).any()) and bool((tpsi > 0.0).any())
    if tdm.dim == 2:
        hold(tfv.muscl_face_values(tq, tdm), jfaces, dtype, "faces")


@pytest.mark.parametrize("override", (False, True), ids=("ghosts", "override"))
@pytest.mark.parametrize("name", ("rect_codes", "ogrid"))
@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
def test_muscl_step_matches_jax(dtype, name, override):
    jdm, tdm = meshes(name, dtype)
    js, ts = gas_state(tdm.n_cells, 2, dtype)
    jf, tf_ = far(2, vel=(1.3, 0.6))
    jgas, tgas = JGas(gamma=1.4), TGas(gamma=1.4)
    kw_j = dict(ghost_override=_override_j, t=0.25) if override else {}
    kw_t = dict(ghost_override=_override_t,
                t=torch.tensor(0.25, dtype=tdm.area.dtype)) if override \
        else {}
    ref = jax.jit(lambda s: jfv.compressible_step_muscl(s, jdm, jgas, jf, DT,
                                                        **kw_j))(js)
    got = tfv.compressible_step_muscl(ts, tdm, tgas, tf_, DT, **kw_t)
    hold(got, ref, dtype, "muscl_step")


def test_muscl_step_raises_in_3d():
    _, tdm = meshes("hex", np.float64)
    _, ts = gas_state(tdm.n_cells, 3, np.float64)
    with pytest.raises(ValueError, match="2D only"):
        tfv.compressible_step_muscl(ts, tdm, TGas(gamma=1.4), far(3)[1], DT)
