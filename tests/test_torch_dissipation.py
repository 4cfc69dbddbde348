"""Parity of the port's physics/dissipation.py with the JAX package, on the
CPU in float64: `damping_pairwise`, `damping_pairwise_wall` (with and
without the wall's field), `damping_projection` and
`damping_implicit_cg` on a 2D lattice with padding rows past NReal,
random capacities, and a vector and a scalar field; each in a shallow
regime and in a deep one where the overshoot limiter acts.  Both sides
take the same neighbour lists (JAX's, carried across); every output is
held within 1e-12 of its max |ref|.  The CG solve's iteration count is
held equal to JAX's (`jax.scipy.sparse.linalg.cg`, read by bisecting its
`maxiter` for the first value whose result no longer changes), for a
converging solve and for one stopped by `max_iter`.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sphinxsys_tpu.core.adaptation import SPHAdaptation
from sphinxsys_tpu.core.state import make_fluid_state, make_solid_state
from sphinxsys_tpu.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_tpu.physics import dissipation as jdp
from sphinxsys_tpu_torch import convert
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation as TSPHAdaptation
from sphinxsys_tpu_torch.physics import dissipation as tdp

torch.set_num_threads(1)

TOL = 1e-12
DX = 0.1
N_PAD = 7
# regime -> (eta, dt): the shallow one leaves the limiter off, the deep one
# saturates it (a_i > 1 in the interior)
REGIMES = {"shallow": (1.0e-3, 1.0e-3), "deep": (50.0, 1.0e-2)}


def close(got, ref, tol=TOL, what=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-300), (what, err)


@functools.lru_cache(maxsize=None)
def lattice():
    """(JAX state, wall, inner list, wall list, kernel): 14 x 14 particles
    on [0, 1.4]^2 with N_PAD padding rows, seeded velocities, a scalar
    field and masses within 30% of rho dx^2; a moving wall of two rows
    under the floor."""
    ad = SPHAdaptation(spacing=DX, dim=2)
    xs = np.arange(DX / 2, 1.4, DX)
    pos = np.stack(np.meshgrid(xs, xs, indexing="ij"), -1).reshape(-1, 2)
    n = len(pos)
    rng = np.random.default_rng(7)
    st = dict(make_fluid_state(pos, DX * DX, 1.0, capacity=n + N_PAD,
                               dtype=jnp.float64))
    cap = n + N_PAD
    st["Velocity"] = jnp.asarray(rng.normal(size=(cap, 2)))
    st["Phi"] = jnp.asarray(rng.normal(size=cap))
    st["Mass"] = st["Mass"] * jnp.asarray(rng.uniform(0.7, 1.3, cap))
    wx = np.arange(-3 * DX, 1.7, DX) + DX / 2
    wpos = np.stack([np.concatenate([wx, wx]),
                     np.concatenate([np.full_like(wx, -DX / 2),
                                     np.full_like(wx, -3 * DX / 2)])], -1)
    wall = dict(make_solid_state(wpos, DX * DX, 1.0, dtype=jnp.float64))
    wall["AverageVelocity"] = jnp.asarray(rng.normal(size=(len(wpos), 2)))
    wall["Phi"] = jnp.asarray(rng.normal(size=len(wpos)))
    grid = grid_from_bounds((-6 * DX, -6 * DX), (2.0, 2.0), ad.cutoff)
    table = build_cell_table(st["Position"], st["NReal"], grid, cap=24)
    nl = build_neighbor_list(st["Position"], st["NReal"], st["Position"],
                             st["NReal"], table, grid, ad.cutoff, k_max=32,
                             include_self=False)
    wtable = build_cell_table(wall["Position"], wall["NReal"], grid, cap=24)
    nlw = build_neighbor_list(st["Position"], st["NReal"], wall["Position"],
                              wall["NReal"], wtable, grid, ad.cutoff,
                              k_max=32, include_self=True)
    assert not bool(nl.overflow) and not bool(nlw.overflow)
    assert int(jnp.sum(nlw.count)) > 0
    return st, wall, nl, nlw, ad.kernel


def both():
    st, wall, nl, nlw, kernel = lattice()
    tst = convert.state_from_numpy({k: np.asarray(v) for k, v in st.items()})
    twall = convert.state_from_numpy({k: np.asarray(v)
                                      for k, v in wall.items()})
    return ((dict(st), wall, nl, nlw, kernel),
            (tst, twall, convert.neighbor_list_from_numpy(nl),
             convert.neighbor_list_from_numpy(nlw),
             TSPHAdaptation(spacing=DX, dim=2).kernel))


FIELDS = ["Velocity", "Phi"]


@pytest.mark.parametrize("regime", sorted(REGIMES))
@pytest.mark.parametrize("field", FIELDS)
def test_damping_pairwise(field, regime):
    (js, _, jnl, _, jk), (ts, _, tnl, _, tk) = both()
    eta, dt = REGIMES[regime]
    ref = jdp.damping_pairwise(js, field, jnl, jk, 2, eta, dt)
    got = tdp.damping_pairwise(ts, field, tnl, tk, 2, eta, dt)
    close(got[field], ref[field], what=field)
    # the padding rows keep their values
    n = ts["NReal"]
    assert torch.equal(got[field][n:], ts[field][n:])


def test_damping_pairwise_limiter_acts_and_conserves_momentum():
    """The deep regime's pair weights sum past 1 somewhere (the limiter
    scales them), and the sweeps conserve the momentum."""
    _, (ts, _, tnl, _, tk) = both()
    eta, dt = REGIMES["deep"]
    w, _ = tdp._pair_weight(ts, ts, tnl, tk, 2)
    b = eta * w * dt
    cap = ts["Mass"]
    cap_j = cap[tnl.idx.clamp(max=cap.shape[0] - 1).long()]
    a = torch.sum(-b * cap_j / (cap[:, None] * cap_j
                                - b * (cap[:, None] + cap_j)), dim=1)
    assert float(a.max()) > 1.0
    out = tdp.damping_pairwise(ts, "Velocity", tnl, tk, 2, eta, dt)
    n = ts["NReal"]
    p0 = (cap[:n, None] * ts["Velocity"][:n]).sum(0)
    p1 = (cap[:n, None] * out["Velocity"][:n]).sum(0)
    assert float((p1 - p0).abs().max()) < 1e-12 * float(p0.abs().max() + 1)


@pytest.mark.parametrize("wall_field", [None, "AverageVelocity"])
@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_damping_pairwise_wall_vector(regime, wall_field):
    (js, jw, _, jnlw, jk), (ts, tw, _, tnlw, tk) = both()
    eta, dt = REGIMES[regime]
    ref = jdp.damping_pairwise_wall(js, "Velocity", jw, jnlw, jk, 2, eta,
                                    dt, wall_field=wall_field)
    got = tdp.damping_pairwise_wall(ts, "Velocity", tw, tnlw, tk, 2, eta,
                                    dt, wall_field=wall_field)
    close(got["Velocity"], ref["Velocity"])


@pytest.mark.parametrize("wall_field", [None, "Phi"])
def test_damping_pairwise_wall_scalar(wall_field):
    (js, jw, _, jnlw, jk), (ts, tw, _, tnlw, tk) = both()
    eta, dt = REGIMES["deep"]
    ref = jdp.damping_pairwise_wall(js, "Phi", jw, jnlw, jk, 2, eta, dt,
                                    wall_field=wall_field, n_sweeps=3)
    got = tdp.damping_pairwise_wall(ts, "Phi", tw, tnlw, tk, 2, eta, dt,
                                    wall_field=wall_field, n_sweeps=3)
    close(got["Phi"], ref["Phi"])


@pytest.mark.parametrize("regime", sorted(REGIMES))
@pytest.mark.parametrize("field", FIELDS)
def test_damping_projection(field, regime):
    (js, _, jnl, _, jk), (ts, _, tnl, _, tk) = both()
    eta, dt = REGIMES[regime]
    ref = jdp.damping_projection(js, field, jnl, jk, 2, eta, dt)
    got = tdp.damping_projection(ts, field, tnl, tk, 2, eta, dt)
    close(got[field], ref[field], what=field)


def jax_cg_iterations(js, field, jnl, kernel, eta, dt, walls, tol,
                      max_iter):
    """JAX's iteration count: the least maxiter whose result equals the
    one at max_iter (the loop stops at the count; bisection)."""
    def solve(k):
        return np.asarray(jdp.damping_implicit_cg(
            dict(js), field, jnl, kernel, 2, eta, dt, walls=walls, tol=tol,
            max_iter=k)[field])

    full = solve(max_iter)
    lo, hi = 0, max_iter
    while lo < hi:
        mid = (lo + hi) // 2
        if np.array_equal(solve(mid), full):
            hi = mid
        else:
            lo = mid + 1
    return lo, full


# solve -> (field, regime, walls' fields, tol, max_iter)
CG_SOLVES = {
    "converging_vector": ("Velocity", "deep", ("AverageVelocity",), 1e-10,
                          60),
    "converging_scalar": ("Phi", "deep", (None,), 1e-8, 60),
    "shallow_no_wall": ("Velocity", "shallow", (), 1e-10, 60),
    "max_iter_bound": ("Velocity", "deep", ("AverageVelocity",), 1e-14, 4),
}


@pytest.mark.parametrize("solve", sorted(CG_SOLVES))
def test_damping_implicit_cg(solve):
    field, regime, wall_fields, tol, max_iter = CG_SOLVES[solve]
    (js, jw, jnl, jnlw, jk), (ts, tw, tnl, tnlw, tk) = both()
    eta, dt = REGIMES[regime]
    jwalls = tuple((jw, jnlw, f) for f in wall_fields)
    twalls = tuple((tw, tnlw, f) for f in wall_fields)
    k_jax, ref = jax_cg_iterations(js, field, jnl, jk, eta, dt, jwalls,
                                   tol, max_iter)
    got = tdp.damping_implicit_cg(ts, field, tnl, tk, 2, eta, dt,
                                  walls=twalls, tol=tol, max_iter=max_iter)
    close(got[field], ref, what=field)
    matvec, rhs, pre = tdp.implicit_cg_system(ts, field, tnl, tk, 2, eta,
                                              dt, walls=twalls)
    x, k = tdp.conjugate_gradient(matvec, rhs, ts[field], pre, tol, max_iter)
    assert int(k) == k_jax
    assert torch.equal(x, got[field])
    if solve == "max_iter_bound":
        assert k_jax == max_iter
    else:
        assert 1 < k_jax < max_iter


def test_cg_frozen_after_convergence_stays_finite():
    """A solve whose residual reaches exactly zero (a uniform field on a
    system with no wall: A phi = 0, so b = M phi0 = matvec(phi0)) takes no
    iteration; the 0/0 of the skipped ones never reaches x."""
    _, (ts, _, tnl, _, tk) = both()
    ts = dict(ts)
    ts["Velocity"] = torch.ones_like(ts["Velocity"])
    matvec, rhs, pre = tdp.implicit_cg_system(ts, "Velocity", tnl, tk, 2,
                                              50.0, 1e-2)
    x, k = tdp.conjugate_gradient(matvec, rhs, ts["Velocity"], pre, 1e-6, 60)
    assert int(k) == 0
    assert torch.equal(x, ts["Velocity"])
