"""Parity of the port's gather total-Lagrangian solid (physics/pair.py,
physics/solid.py, core/materials.py `SaintVenantKirchhoffSolid`, and
cases/twisting_column_3d.py with engine="gather") with the JAX package,
on the CPU in float64.

Inputs, made from a seed with numpy: a 2D (14 x 6) and a 3D (8 x 5 x 5)
lattice at dx = 0.1 with its positions moved by up to 0.1 dx, so that the
frozen lists are ragged; on it a perturbed state (F = I + 0.05 N(0, 1),
dF/dt, v, ForcePrior), fed to both sides as the same arrays.  The frozen
pairs, the correction matrix and every half step are held within 1e-12 of
max|ref| (float64 roundoff after the K-slot sums and the closed-form
cofactors, where JAX uses LU); the dx = 0.1 column, 29 steps to
t = 0.004, within 1e-10 of JAX's gather engine and 1e-8 of the port's
lattice engine (the tolerance tests/test_solid_lattice.py:143-160 holds
JAX's two engines to)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sphinxsys_tpu.cases import twisting_column_3d as jtc
from sphinxsys_tpu.core.adaptation import SPHAdaptation as JAdaptation
from sphinxsys_tpu.core import materials as jmat
from sphinxsys_tpu.neighbors import cell_list as jcl
from sphinxsys_tpu.neighbors import neighbor_list as jnl
from sphinxsys_tpu.physics import solid as jsd
from sphinxsys_tpu_torch import convert
from sphinxsys_tpu_torch.cases import twisting_column_3d as ttc
from sphinxsys_tpu_torch.core import materials as tmat
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation as TAdaptation
from sphinxsys_tpu_torch.neighbors import cell_list as tcl
from sphinxsys_tpu_torch.neighbors import neighbor_list as tnl
from sphinxsys_tpu_torch.physics import solid as tsd

torch.set_num_threads(1)

DX = 0.1
DT = 1e-5
SHAPES = {2: (14, 6), 3: (8, 5, 5)}
CAPS = {2: (24, 64), 3: (36, 96)}    # (cell cap, k_max), fsi2's and the column's
NEO = dict(rho0=1100.0, youngs_modulus=1.7e7, poisson_ratio=0.45)
SVK = dict(rho0=10.0, youngs_modulus=1.4e3, poisson_ratio=0.4)


def _close(got, ref, tol, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max()
    scale = np.abs(ref).max()
    assert err <= tol * max(scale, 1e-300), f"{what}: {err:.3e} vs {scale:.3e}"


def _lattice(dim):
    rng = np.random.default_rng(dim)
    axes = [np.arange(n) * DX for n in SHAPES[dim]]
    pos = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, dim)
    return pos + 0.1 * DX * (rng.random(pos.shape) - 0.5)


@pytest.fixture(scope="module", params=[2, 3], ids=["2d", "3d"])
def body(request):
    """(dim, JAX pairs, port pairs, JAX state, port state, JAX kernel,
    port kernel): the frozen topology and a perturbed state, the state
    carried across from JAX's with convert.state_from_numpy."""
    dim = request.param
    pos = _lattice(dim)
    n = len(pos)
    ja, ta = JAdaptation(spacing=DX, dim=dim), TAdaptation(spacing=DX, dim=dim)
    lo, hi = pos.min(0) - DX, pos.max(0) + DX
    jg = jcl.grid_from_bounds(lo, hi, ja.cutoff)
    tg = tcl.grid_from_bounds(lo, hi, ta.cutoff)
    jp, tp = jnp.asarray(pos), torch.as_tensor(pos)
    cap, k_max = CAPS[dim]
    jt = jcl.build_cell_table(jp, jnp.int32(n), jg, cap)
    jl = jnl.build_neighbor_list(jp, jnp.int32(n), jp, jnp.int32(n), jt, jg,
                                 ja.cutoff, k_max, False)
    tt = tcl.build_cell_table(tp, n, tg, cap)
    tl = tnl.build_neighbor_list(tp, n, tp, n, tt, tg, ta.cutoff, k_max, False)
    assert not bool(jl.overflow) and not bool(tl.overflow)
    jrp = jsd.freeze_reference_pairs(jp, jl, ja.kernel, dim)
    trp = tsd.freeze_reference_pairs(tp, tl, ta.kernel, dim)

    rng = np.random.default_rng(10 + dim)
    js = dict(jsd.make_elastic_solid_state(pos, DX ** dim,
                                           jmat.NeoHookeanSolid(**NEO),
                                           dtype=jnp.float64))
    eye = np.eye(dim)
    js.update({
        "Velocity": jnp.asarray(0.3 * rng.normal(size=(n, dim))),
        "DeformationGradient": jnp.asarray(eye + 0.05 * rng.normal(size=(n, dim, dim))),
        "DeformationRate": jnp.asarray(0.5 * rng.normal(size=(n, dim, dim))),
        "ForcePrior": jnp.asarray(1e-3 * rng.normal(size=(n, dim))),
        "LinearGradientCorrectionMatrix": jsd.linear_gradient_correction_matrix(
            jrp, js["VolumetricMeasure"]),
    })
    ts = convert.state_from_numpy({k: np.asarray(v) for k, v in js.items()})
    return dim, jrp, trp, js, ts, ja.kernel, ta.kernel


def test_reference_pairs_match(body):
    dim, jrp, trp, *_ = body
    np.testing.assert_array_equal(trp.idx.numpy(), np.asarray(jrp.idx))
    np.testing.assert_array_equal(trp.mask.numpy(), np.asarray(jrp.mask))
    for k in ("W", "dW", "r", "e"):
        _close(getattr(trp, k).numpy(), getattr(jrp, k), 1e-12, k)
    assert int(trp.mask.sum(1).min()) < int(trp.mask.sum(1).max())  # ragged


def test_correction_matrix_matches(body):
    _, jrp, trp, js, ts, *_ = body
    B = tsd.linear_gradient_correction_matrix(trp, ts["VolumetricMeasure"])
    _close(B.numpy(), js["LinearGradientCorrectionMatrix"], 1e-12, "B")


def _hold(tout, jout, keys):
    for k in keys:
        _close(tout[k].numpy(), jout[k], 1e-12, k)


def test_decomposed_first_half_matches(body):
    dim, jrp, trp, js, ts, jk, tk = body
    h = 1.3 * DX
    jout = jsd.decomposed_integration_1st_half(
        dict(js), jrp, jmat.NeoHookeanSolid(**NEO), DT, h)
    tout = tsd.decomposed_integration_1st_half(
        dict(ts), trp, tmat.NeoHookeanSolid(**NEO), DT, h)
    _hold(tout, jout, ("Position", "DeformationGradient", "Density", "Force",
                       "Velocity"))


def test_pk2_first_half_matches(body):
    """Integration1stHalfPK2 with the St. Venant-Kirchhoff stress, the
    pair damping weighted by W / w0."""
    dim, jrp, trp, js, ts, jk, tk = body
    h = 1.3 * DX
    jout = jsd.integration_1st_half_pk2(
        dict(js), jrp, jmat.SaintVenantKirchhoffSolid(**SVK), DT, h,
        jk.w0(dim))
    tout = tsd.integration_1st_half_pk2(
        dict(ts), trp, tmat.SaintVenantKirchhoffSolid(**SVK), DT, h,
        tk.w0(dim))
    _hold(tout, jout, ("Position", "DeformationGradient", "Density",
                       "StressPK1OnParticle", "Force", "Velocity"))


def test_second_half_matches(body):
    _, jrp, trp, js, ts, *_ = body
    jout = jsd.integration_2nd_half(dict(js), jrp, DT)
    tout = tsd.integration_2nd_half(dict(ts), trp, DT)
    _hold(tout, jout, ("Position", "DeformationRate", "DeformationGradient"))


def test_pk2_hooks_are_not_ported(body):
    """Both hooks are ported and match JAX's: the active-stress hook (its
    first caller is muscle_activation_3d; tests/test_torch_solid_laws.py
    holds the muscle's own) with S_active(F) = F, added to the PK2, and
    the PK1 hook (the fish's composite law, tests/test_torch_fish.py) with
    P(F) = F (1 + |F|^2)."""
    dim, jrp, trp, js, ts, jk, tk = body
    h = 1.3 * DX
    tout = tsd.integration_1st_half_pk2(
        dict(ts), trp, tmat.SaintVenantKirchhoffSolid(**SVK), DT, h,
        tk.w0(dim), active_stress_fn=lambda s, F: F)
    jout = jsd.integration_1st_half_pk2(
        dict(js), jrp, jmat.SaintVenantKirchhoffSolid(**SVK), DT, h,
        jk.w0(dim), active_stress_fn=lambda s, F: F)
    _hold(tout, jout, ("Position", "StressPK1OnParticle", "Force",
                       "Velocity"))
    tout = tsd.integration_1st_half_pk2(
        dict(ts), trp, tmat.SaintVenantKirchhoffSolid(**SVK), DT, h,
        tk.w0(dim), pk1_fn=lambda s, F: F * (1 + (F * F).sum((-2, -1)))[
            :, None, None])
    jout = jsd.integration_1st_half_pk2(
        dict(js), jrp, jmat.SaintVenantKirchhoffSolid(**SVK), DT, h,
        jk.w0(dim), pk1_fn=lambda s, F: F * (1 + (F * F).sum((-2, -1)))[
            :, None, None])
    _hold(tout, jout, ("Position", "StressPK1OnParticle", "Force",
                       "Velocity"))


@pytest.fixture(scope="module")
def columns():
    """The dx = 0.1 twisting column (6,100 sites) on the gather engine, JAX
    and port, float64, with their runs to t = 0.004."""
    jcase, jcol = jtc.build_case(dx=DX, dtype=jnp.float64)
    tcase, tcol = ttc.build_case(dx=DX, dtype=torch.float64, device="cpu")
    js = jtc.make_run_chunk(jcase)(jtc.init_sim(jcase, jcol),
                                   jnp.asarray(0.004, jnp.float64))
    ts = ttc.make_run_chunk(tcase)(ttc.init_sim(tcase, tcol), 0.004)
    return jcase, jcol, js, tcase, tcol, ts


def test_column_gather_build_matches_jax(columns):
    jcase, jcol, _, tcase, tcol, _ = columns
    assert tcase.engine == jcase.engine == "gather"
    np.testing.assert_array_equal(tcase.rp.idx.numpy(), np.asarray(jcase.rp.idx))
    _close(tcol["LinearGradientCorrectionMatrix"].numpy(),
           jcol["LinearGradientCorrectionMatrix"], 1e-12, "B")


def test_column_gather_run_matches_jax(columns):
    """To t = 0.004 (29 steps): equal step counts, positions and the tip
    within 1e-10."""
    jcase, jcol, js, tcase, tcol, ts = columns
    assert ts.n_steps == int(js.n_steps) == 29
    assert float(ts.time) == pytest.approx(float(js.time), rel=1e-12)
    dp = np.abs(ts.column["Position"].numpy() - np.asarray(js.column["Position"]))
    assert dp.max() < 1e-10
    for k in ("Velocity", "DeformationGradient", "DeformationRate"):
        _close(ts.column[k].numpy(), js.column[k], 1e-10, k)
    tip_t = ttc.observe_tip(ts, *ttc.tip_observer(tcase, tcol))
    tip_j = jtc.observe_tip(js, *jtc.tip_observer(jcase, jcol))
    assert np.abs(tip_t - tip_j).max() < 1e-10


def test_column_gather_matches_lattice_engine(columns):
    """The port's two engines step for step (the same dt sequence), as
    tests/test_solid_lattice.py:143-160 holds JAX's: positions within
    1e-8."""
    *_, ts = columns
    lcase, lcol = ttc.build_case(dx=DX, dtype=torch.float64, device="cpu",
                                 engine="lattice")
    ls = ttc.make_run_chunk(lcase)(ttc.init_sim(lcase, lcol), 0.004)
    assert ls.n_steps == ts.n_steps
    dp = (ls.column["Position"] - ts.column["Position"]).abs().max()
    assert float(dp) < 1e-8
