"""Parity of the port's target-driven optimization
(physics/optimization.py) with the JAX package's, on the CPU in float64,
and the JAX tests it mirrors (tests/test_optimization.py:28,46): the
gradient through the relaxation loop is finite and informative, and the
uniform diffusivity is recovered.

The port differentiates by torch.autograd where JAX uses jax.grad, and
runs Adam with optax.adam's constants: the steady solve and the
gradient agree with JAX's within 1e-12 of max|.| (float64 roundoff
through 50 relaxation steps and their adjoint); the 40 Adam steps of the
recovery within 1e-9 in the losses and the diffusivity (Adam divides by
sqrt(v), so the roundoff of the gradient grows where it is small)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sphinxsys_tpu.core.adaptation import SPHAdaptation as JAdaptation
from sphinxsys_tpu.neighbors import (build_cell_table as j_table,
                                     build_neighbor_list as j_list,
                                     grid_from_bounds as j_grid)
from sphinxsys_tpu.physics import optimization as jop
from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation as TAdaptation
from sphinxsys_tpu_torch.neighbors.cell_list import (
    build_cell_table as t_table, grid_from_bounds as t_grid)
from sphinxsys_tpu_torch.neighbors.neighbor_list import (
    build_neighbor_list as t_list)
from sphinxsys_tpu_torch.physics import optimization as top

torch.set_num_threads(1)


def _setup(dx):
    """tests/test_optimization.py's unit square lattice, both packages'
    lists (equal), the Dirichlet columns and values."""
    xs = (np.arange(int(round(1 / dx))) + 0.5) * dx
    pos = np.stack(np.meshgrid(xs, xs, indexing="ij"), -1).reshape(-1, 2)
    n = len(pos)
    jad, tad = JAdaptation(spacing=dx, dim=2), TAdaptation(spacing=dx, dim=2)
    jg, tg = j_grid((0, 0), (1, 1), jad.cutoff), t_grid((0, 0), (1, 1), tad.cutoff)
    jp, tp = jnp.asarray(pos), torch.as_tensor(pos)
    jnl = j_list(jp, jnp.int32(n), jp, jnp.int32(n),
                 j_table(jp, jnp.int32(n), jg, cap=32), jg, jad.cutoff,
                 k_max=48, include_self=False)
    tnl = t_list(tp, n, tp, n, t_table(tp, n, tg, 32), tg, tad.cutoff,
                 k_max=48, include_self=False)
    np.testing.assert_array_equal(tnl.idx.numpy(), np.asarray(jnl.idx))
    dirichlet = (pos[:, 0] < 0.08) | (pos[:, 0] > 0.92)
    values = np.where(pos[:, 0] < 0.08, 1.0, 0.0)
    vol = np.full(n, dx * dx)
    jax_side = (jp, jnp.asarray(vol), jnl, jad.kernel, jnp.asarray(dirichlet),
                jnp.asarray(values))
    port_side = (tp, torch.as_tensor(vol), tnl, tad.kernel,
                 torch.as_tensor(dirichlet), torch.as_tensor(values))
    return pos, jax_side, port_side


def close(got, ref, tol, what=""):
    got, ref = got.detach().numpy(), np.asarray(ref)
    scale = float(np.abs(ref).max())
    assert float(np.abs(got - ref).max()) <= tol * scale, what


def test_gradient_through_solver_matches_jax():
    """tests/test_optimization.py:28: the gradient of the mismatch after 50
    relaxation steps is finite and not zero, and equals JAX's."""
    pos, (jp, jvol, jnl, jk, jdir, jval), (tp, tvol, tnl, tk, tdir, tval) = \
        _setup(0.05)
    n = len(pos)
    target = 1.0 - pos[:, 0]

    def jloss(log_d):
        T = jop.solve_steady_temperature(jnp.exp(log_d), jp, jvol, jnl, jk, 2,
                                         jdir, jval, jnp.zeros(n), 1e-4, 50)
        return jnp.mean((T - jnp.asarray(target)) ** 2)

    log_d0 = 0.3 * np.sin(7.0 * pos[:, 1])       # a non-uniform start
    jg = jax.grad(jloss)(jnp.asarray(log_d0))
    x = torch.as_tensor(log_d0).requires_grad_(True)
    T = top.solve_steady_temperature(torch.exp(x), tp, tvol, tnl, tk, 2, tdir,
                                     tval, torch.zeros(n, dtype=torch.float64),
                                     1e-4, 50)
    loss = torch.mean((T - torch.as_tensor(target)) ** 2)
    (g,) = torch.autograd.grad(loss, x)
    assert np.isfinite(g.numpy()).all()
    assert float(g.abs().max()) > 0.0
    close(g, jg, 1e-12, "gradient")
    close(T.detach(), jop.solve_steady_temperature(
        jnp.exp(jnp.asarray(log_d0)), jp, jvol, jnl, jk, 2, jdir, jval,
        jnp.zeros(n), 1e-4, 50), 1e-12, "temperature")


def test_recover_uniform_diffusivity_matches_jax():
    """tests/test_optimization.py:46: from a seeded wrong diffusivity, 40
    Adam steps drive the mismatch down 20x and more; the losses and the
    diffusivity equal JAX's (optax) within 1e-9."""
    pos, (jp, jvol, jnl, jk, jdir, jval), (tp, tvol, tnl, tk, tdir, tval) = \
        _setup(0.0625)
    n = len(pos)
    dt = 1e-4
    target = top.solve_steady_temperature(
        torch.ones(n, dtype=torch.float64), tp, tvol, tnl, tk, 2, tdir, tval,
        torch.zeros(n, dtype=torch.float64), dt, 400)
    d0 = np.exp(np.random.default_rng(0).normal(0.5, 0.3, n))
    res = top.optimize_diffusivity(tp, tvol, tnl, tk, 2, tdir, tval, target,
                                   torch.as_tensor(d0), dt, n_solver_steps=400,
                                   n_opt_steps=40, lr=0.15)
    losses = res.losses.numpy()
    assert losses[-1] < 0.05 * losses[0]
    assert np.isfinite(res.diffusivity.numpy()).all()
    ref = jop.optimize_diffusivity(jp, jvol, jnl, jk, 2, jdir, jval,
                                   jnp.asarray(target.numpy()), jnp.asarray(d0),
                                   dt, n_solver_steps=400, n_opt_steps=40,
                                   lr=0.15)
    close(res.losses, ref.losses, 1e-9, "losses")
    close(res.diffusivity, ref.diffusivity, 1e-9, "diffusivity")
