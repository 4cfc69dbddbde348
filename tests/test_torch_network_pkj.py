"""Parity of the port's core/network.py and the Purkinje-driven ventricle
(pkj_lv_electrocontraction_3d) with the JAX package on the CPU, float64.

The tree: `generate_network` grown over the ventricle's inner ellipsoid
with the case's arguments, and over a ball with fascicles, node for node:
positions within 1e-12 of their max, every branch's id, parent,
children, particles and termination, the edges and the adjacency equal;
`convert.network_from_numpy` carries JAX's tree across unchanged.  (The
JAX package evaluates the shape through `host_eval`; under float32, as
its CLI runs, the ventricle's tree has the same topology and positions
within 1e-7 of float64's: ROADMAP C.)

The case at dx = 0.24 (201 particles, the tree's 67): the build (every
field at 1e-12, the tree's list, the leaves' map and mask, the sub-step
counts), a run of seven steps (equal counts, every field within 1e-9 of
its max), one step from JAX's own state carried across, the CLI entry.
JAX grows its tree through ~3,000 jitted shape queries (~30 s); its
`generate_network` is memoised here so the file grows each tree once.
The case's activation and contraction gate to t = 10 runs on the card:
sphinxsys_tpu_torch/benchmarks/a7i_diffusion_eulerian_long.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_corrected_cases import cli_runs, close

from sphinxsys_tpu.cases import pkj_lv_electrocontraction_3d as jpkj
from sphinxsys_tpu.core import geometry as jg
from sphinxsys_tpu.core import network as jnet
from sphinxsys_tpu_torch import convert
from sphinxsys_tpu_torch.cases import pkj_lv_electrocontraction_3d as tpkj
from sphinxsys_tpu_torch.core import geometry as tg
from sphinxsys_tpu_torch.core import network as tnet

torch.set_num_threads(1)

jax_network = functools.lru_cache(maxsize=None)(jnet.generate_network)

# name -> (the shape from a geometry module, the keywords in the order the
# JAX case passes them, so that its build hits the memo)
TREES = {
    "ventricle": (lambda pkg: pkg.Ellipsoid(center=(0.0, 0.0, 0.0),
                                            semi_axes=jpkj.INNER),
                  dict(starting_point=(0.0, -0.699, 0.35),
                       second_point=(0.0, -0.69, 0.25), iterations=5,
                       segment_length=jpkj.SEG, segments_per_branch=4,
                       angle=0.4, repulsivity=0.3, seed=3)),
    "ball_fascicles": (lambda pkg: pkg.Ball(center=(0.0, 0.0, 0.0),
                                            radius=1.0),
                       dict(starting_point=(0.0, -1.0, 0.0),
                            second_point=(0.0, -0.99, -0.1), iterations=1,
                            segment_length=0.15, segments_per_branch=3,
                            angle=0.5, repulsivity=0.4, fascicles=True,
                            fascicle_ratio=1.0, seed=7)),
}


def _trees(name):
    shape, kw = TREES[name]
    return jax_network(shape(jg), **kw), tnet.generate_network(shape(tg),
                                                               **kw)


def _same_tree(got, ref):
    assert got.n_particles == ref.n_particles
    close(got.positions, ref.positions, 1e-12, "positions")
    np.testing.assert_array_equal(got.branch_id, ref.branch_id)
    assert len(got.branches) == len(ref.branches)
    for b, r in zip(got.branches, ref.branches):
        assert (b.id, b.parent, b.particles, b.children, b.is_terminated) \
            == (r.id, r.parent, r.particles, r.children, r.is_terminated)
        close(b.end_direction, r.end_direction, 1e-12, "end direction")
    np.testing.assert_array_equal(got.edges(), ref.edges())
    np.testing.assert_array_equal(got.adjacency(4), ref.adjacency(4))


@pytest.mark.parametrize("name", sorted(TREES))
def test_network_matches_jax_node_for_node(name):
    ref, got = _trees(name)
    _same_tree(got, ref)
    assert got.n_particles > 10 and len(got.branches) > 3
    if name == "ball_fascicles":       # the two fascicles off the trunk
        assert got.branches[1].children[:2] == [2, 3]


def test_network_conversion_and_adjacency():
    ref, got = _trees("ventricle")
    carried = convert.network_from_numpy(ref)
    _same_tree(carried, ref)
    # the adjacency is the edges both ways, padded with N
    adj, n = got.adjacency(4), got.n_particles
    pairs = {(int(a), int(b)) for a, b in got.edges()}
    pairs |= {(b, a) for a, b in pairs}
    rows = {(i, int(j)) for i in range(n) for j in adj[i] if j < n}
    assert rows == pairs
    with pytest.raises(ValueError):
        got.adjacency(1)


# ---------------------------------------------------------------------------
# the case
# ---------------------------------------------------------------------------

DX = 0.24
T_END = 2.0
FIELDS = ("Position", "Velocity", "Voltage", "GateVariable",
          "ActiveContractionStress", "DeformationGradient",
          "DeformationRate")


@functools.lru_cache(maxsize=None)
def runs():
    # JAX's build grows its tree through the memo (the same function)
    jpkj.generate_network = jax_network
    try:
        jc, js0 = jpkj.build_case(dx=DX, dtype=jnp.float64)
    finally:
        jpkj.generate_network = jnet.generate_network
    tc, ts0 = tpkj.build_case(dx=DX, dtype=torch.float64, device="cpu")
    jrun = jpkj.make_run_chunk(jc)
    js = jrun(js0, jnp.asarray(T_END, jnp.float64))
    ts = tpkj.make_run_chunk(tc)(ts0, T_END)
    return jc, tc, js0, ts0, js, ts, jrun


def test_pkj_build_matches_jax():
    jc, tc, js0, ts0, *_ = runs()
    assert (tc.n_myo, tc.n_pkj, tc.n_pkj_sub, tc.n_mech_sub, tc.dt_d) == (
        jc.n_myo, jc.n_pkj, jc.n_pkj_sub, jc.n_mech_sub, jc.dt_d)
    for k in js0.myo:
        if k != "NReal":
            close(ts0.myo[k], js0.myo[k], 1e-12, k)
    close(tc.pkj_pos, jc.pkj_pos, 1e-12, "tree")
    for name in ("leaf_nearest", "leaf_mask", "base_mask"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)))
    np.testing.assert_array_equal(tc.nl_pkj.idx.numpy(),
                                  np.asarray(jc.nl_pkj.idx))
    np.testing.assert_array_equal(tc.nl_myo.idx.numpy(),
                                  np.asarray(jc.nl_myo.idx))
    close(ts0.pkj_v, js0.pkj_v, 0.0, "stimulus")


def test_pkj_run_matches_jax():
    *_, js, ts, _ = runs()
    assert ts.n_steps == int(js.n_steps) == 7
    for k in FIELDS:
        close(ts.myo[k], js.myo[k], 1e-9, k)
    close(ts.pkj_v, js.pkj_v, 1e-9, "tree voltage")
    close(ts.pkj_w, js.pkj_w, 1e-9, "tree gate")
    jc, tc = runs()[:2]
    assert tpkj.apex_voltage(tc, ts) == pytest.approx(
        jpkj.apex_voltage(jc, js), rel=1e-9)
    assert tpkj.midwall_ring_radius(tc, ts) == pytest.approx(
        jpkj.midwall_ring_radius(jc, js), rel=1e-12)
    # the tree ignited and carried the wave past its root
    assert float(ts.pkj_v.max()) > 0.9 and float(ts.myo["Voltage"].max()) \
        > 0.3


def test_pkj_continues_jax_state():
    jc, tc, _, _, js, _, jrun = runs()
    js2 = jrun(js, jnp.asarray(float(js.time) + 0.1, jnp.float64))
    own = convert.sim_from_numpy(tpkj.Sim, jax.tree_util.tree_map(
        np.asarray, js))
    ts2 = tpkj.make_run_chunk(tc)(own, float(js.time) + 0.1)
    assert ts2.n_steps == int(js2.n_steps)
    for k in FIELDS:
        close(ts2.myo[k], js2.myo[k], 1e-11, k)
    close(ts2.pkj_v, js2.pkj_v, 1e-12, "tree voltage")


def test_pkj_cli_entry_runs_on_the_cpu(tmp_path, caplog):
    cli_runs("pkj_lv_electrocontraction_3d", ("dx=0.24", "t_end=0.3"),
             ("Myocardium",), tmp_path, caplog, {"Myocardium": 201})


def write_jax_f32():
    """The JAX package's float32 CPU run of the long script's protocol (the
    default width to t = 6, the gate, then to t = 10) ->
    tests/golden_torch/pkj_lv_electrocontraction_3d/jax_f32.json."""
    import json
    import os

    from sphinxsys_tpu_torch.benchmarks import \
        a7i_diffusion_eulerian_long as long

    jax.config.update("jax_enable_x64", False)
    case, s = jpkj.build_case()
    r_tree = np.linalg.norm(np.asarray(case.pkj_pos) / np.asarray(jpkj.INNER),
                            axis=1)
    r0 = jpkj.midwall_ring_radius(case, s)
    run = jpkj.make_run_chunk(case)
    out = dict(n_pkj=case.n_pkj, n_myo=case.n_myo, ring0=r0,
               tree_dev=float(np.abs(r_tree - 1.0).max()))
    for t in (long.PKJ_GATE_T, long.PKJ_END_T):
        s = run(s, jnp.asarray(t, s.time.dtype))
        v = np.asarray(s.myo["Voltage"])
        out[str(t)] = dict(
            t=float(s.time), n_steps=int(s.n_steps),
            apex=jpkj.apex_voltage(case, s), active=float((v > 0.5).mean()),
            ta_max=float(np.asarray(s.myo["ActiveContractionStress"]).max()),
            ring=jpkj.midwall_ring_radius(case, s),
            v_finite=bool(np.isfinite(v).all()
                          and np.isfinite(np.asarray(s.pkj_v)).all()),
            vel_finite=bool(np.isfinite(np.asarray(s.myo["Velocity"])).all()))
        print(out[str(t)], flush=True)
    g = out[str(long.PKJ_GATE_T)]
    out["gates"] = long.pkj_gates(case.n_pkj, out["tree_dev"], g["v_finite"],
                                  g["apex"], g["active"], g["ta_max"], r0,
                                  g["ring"], g["vel_finite"])
    path = os.path.join(long.GOLDEN_TORCH, "pkj_lv_electrocontraction_3d",
                        "jax_f32.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    write_jax_f32()
