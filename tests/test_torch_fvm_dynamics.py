"""Parity of the port's FVM dynamics (sphinxsys_tpu_torch/fvm/dynamics.py)
with the JAX package's on the CPU, on the meshes of tests/test_torch_fvm.py
and seeded random states (numpy, default_rng), the boundary faces carrying
every Fluent code the solver reads (3, 4, 5, 7, 9, 10, 36): each function
within 1e-12 of max |JAX| in float64 and 2e-5 in float32 (both packages'
float32 from the same inputs); the ghost states under each BCSpec field;
the weakly-compressible step and the boundary forces.  The compressible
path and MUSCL are held in tests/test_torch_fvm_muscl.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_fvm import BC_CODES, RAWS, with_codes
from test_torch_viscosity import DTYPES, TOL, close

from sphinxsys_tpu.core.materials import CompressibleFluid as JGas
from sphinxsys_tpu.core.materials import WeaklyCompressibleFluid as JEos
from sphinxsys_tpu.fvm import dynamics as jfv
from sphinxsys_tpu.fvm import mesh as jm
from sphinxsys_tpu.physics import riemann as jrs
from sphinxsys_tpu_torch.core.materials import CompressibleFluid as TGas
from sphinxsys_tpu_torch.core.materials import WeaklyCompressibleFluid as TEos
from sphinxsys_tpu_torch.fvm import dynamics as tfv
from sphinxsys_tpu_torch.physics import riemann as trs

torch.set_num_threads(1)

DT = 1.0e-3

def meshes(name, dtype):
    mesh = jm.compile_mesh(with_codes(RAWS[name]()))
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    return jfv.to_device(mesh, dtype), tfv.to_device(mesh, tdt, "cpu")


def wc_state(C, dim, dtype, seed=0):
    rng = np.random.default_rng(seed)
    st = {"Density": 1.0 + 0.05 * rng.normal(size=C),
          "Velocity": rng.normal(size=(C, dim)),
          "Pressure": 3.0 * rng.normal(size=C)}
    return ({k: jnp.asarray(v, dtype) for k, v in st.items()},
            {k: torch.as_tensor(np.asarray(v, dtype)) for k, v in st.items()})


def gas_state(C, dim, dtype, seed=1):
    rng = np.random.default_rng(seed)
    rho = 0.5 + rng.random(C)
    vel = 1.5 * rng.normal(size=(C, dim))
    p = 0.2 + rng.random(C)
    E = p / 0.4 + 0.5 * rho * (vel ** 2).sum(-1) + 0.1 * rng.random(C)
    st = {"Density": rho, "Velocity": vel, "Pressure": p,
          "TotalEnergyDensity": E}
    return ({k: jnp.asarray(v, dtype) for k, v in st.items()},
            {k: torch.as_tensor(np.asarray(v, dtype)) for k, v in st.items()})


def far(dim, vel=(0.7, -0.4, 0.2)):
    args = dict(rho=1.2, vel=tuple(vel[:dim]), p=0.9)
    return jfv.FarField(**args), tfv.FarField(**args)


BCS = {
    "default": {},
    "slip": dict(wall_slip=True),
    "inlet": dict(inlet_vel=(1.1, 0.2, -0.3)),
    "outlet": dict(outlet_p=0.35),
    "all": dict(wall_slip=True, inlet_vel=(1.1, 0.2, -0.3), outlet_p=0.35),
}


def bcspec(name, dim):
    kw = dict(BCS[name])
    if "inlet_vel" in kw:
        kw["inlet_vel"] = kw["inlet_vel"][:dim]
    return jfv.BCSpec(**kw), tfv.BCSpec(**kw)


def hold(got, ref, dtype, what):
    if isinstance(ref, (tuple, list)):
        for i, (g, r) in enumerate(zip(got, ref)):
            hold(g, r, dtype, f"{what}[{i}]")
        return
    if isinstance(ref, dict):
        assert set(got) == set(ref), what
        for k in ref:
            hold(got[k], ref[k], dtype, f"{what}.{k}")
        return
    close(got, ref, TOL[dtype], what)


@pytest.mark.parametrize("bc", sorted(BCS))
@pytest.mark.parametrize("name", ("rect_codes", "hex"))
@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
def test_face_states_and_viscous_force(dtype, name, bc):
    jdm, tdm = meshes(name, dtype)
    dim = tdm.dim
    js, ts = wc_state(tdm.n_cells, dim, dtype)
    jf, tf_ = far(dim)
    jbc, tbc = bcspec(bc, dim)
    jstates, jvisc = jax.jit(lambda s: (
        jfv.face_states(s, jdm, jf, jbc),
        jfv.viscous_force(s, jdm, jf, 0.03, jbc)))(js)
    hold(tfv.face_states(ts, tdm, tf_, tbc), jstates, dtype, "face_states")
    hold(tfv.viscous_force(ts, tdm, tf_, 0.03, tbc), jvisc, dtype,
         "viscous_force")


@pytest.mark.parametrize("mu", (0.0, 0.02), ids=("inviscid", "viscous"))
@pytest.mark.parametrize("bc", ("default", "all"))
@pytest.mark.parametrize("name", ("rect_codes", "hex", "tet"))
@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
def test_wc_step_matches_jax(dtype, name, bc, mu):
    jdm, tdm = meshes(name, dtype)
    dim = tdm.dim
    js, ts = wc_state(tdm.n_cells, dim, dtype)
    jf, tf_ = far(dim)
    jbc, tbc = bcspec(bc, dim)
    jeos, teos = JEos(rho0=1.0, c0=10.0), TEos(rho0=1.0, c0=10.0)
    jrm = jrs.acoustic_riemann(jeos, limiter_coeff=200.0)
    trm = trs.acoustic_riemann(teos, limiter_coeff=200.0)
    jdt, ref, jforces = jax.jit(lambda s: (
        jfv.wc_acoustic_dt(s, jeos, jdm),
        jfv.wc_integration_step(s, jdm, jeos, jrm, jf, DT, mu=mu, bc=jbc),
        [jfv.force_on_boundary(s, jdm, jrm, jf, 0.02, boundary=b)
         for b in (3, 9, 10)]))(js)
    close(tfv.wc_acoustic_dt(ts, teos, tdm), jdt, TOL[dtype], "dt")
    got = tfv.wc_integration_step(ts, tdm, teos, trm, tf_,
                                  torch.tensor(DT, dtype=tdm.area.dtype),
                                  mu=mu, bc=tbc)
    hold(got, ref, dtype, "wc_step")
    for b, jforce in zip((3, 9, 10), jforces):
        hold(tfv.force_on_boundary(ts, tdm, trm, tf_, 0.02, boundary=b),
             jforce, dtype, f"force_on_boundary {b}")


@pytest.mark.parametrize("name", ("rect_codes", "hex"))
@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
def test_state_constructors_match_jax(dtype, name):
    jdm, tdm = meshes(name, dtype)
    dim = tdm.dim
    vel = (0.3, -0.2, 0.1)[:dim]
    hold(tfv.make_fvm_state(tdm, 1.1, vel, 0.4),
         jfv.make_fvm_state(jdm, 1.1, vel, 0.4, dtype), dtype, "wc")
    hold(tfv.make_compressible_fvm_state(tdm, TGas(gamma=1.4), 1.1, vel, 0.4),
         jfv.make_compressible_fvm_state(jdm, JGas(gamma=1.4), 1.1, vel, 0.4,
                                         dtype), dtype, "gas")


def test_every_code_present():
    """The dynamics meshes carry every bc code the ghosts read."""
    for name in ("rect_codes", "hex"):
        _, tdm = meshes(name, np.float64)
        bnd = tdm.btype[~tdm.interior]
        assert set(BC_CODES) <= set(bnd.tolist()), name
