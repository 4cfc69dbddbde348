"""Parity of the port's layout sweeps (B6 and B7, ops/layout_sweeps.py)
and their drivers (sphinxsys_tpu_torch/benchmarks/exp_layout*.py) with
the JAX package's layout experiments (benchmarks/exp_layout.py,
benchmarks/exp_layout2.py) on the same inputs:

* (a) the plain B6 / B7 in float32 against JAX's B6 / B7 Pallas kernels in
  interpret mode, |port - JAX| <= 2e-5 max|JAX| per channel on the real
  slots (the bound tests/test_torch_packed_sweeps.py holds B5a-d to), on
  four inputs: random particles whose padding carries VOL = 1, parked at
  1e9 ("random") and moved inside the support of real particles, where
  the mask channel alone keeps it inert ("random_near"), the random
  particles with the 16 slots of every row permuted at random, so that
  padding sits mid-row ("random_holes": the kernels skip padding by its
  mask, not by its place in the row), and the JAX dambreak block state at
  dx = 0.1, cap 16, with seeded noise, packed on both sides through
  `convert` ("dambreak");
* (b) the plain versions in float64 against `ac1_flat_jnp` /
  `ac1_transposed_jnp` in float64, within 1e-10 max|JAX| per channel;
* (c) the plain B6, the transposed plain B7 and the plain B5a against each
  other in float64, within 1e-12 max|B6| per channel (one function, three
  layouts);
* (d) `prep_t` against exp_layout2's `prep` (its lines 156-159), exactly;
* (e) both drivers at dx = 0.1 on the CPU, their cross-checks agreeing,
  also on a state built beforehand and passed in;
* (f) the dispatch: the drivers default to the card and raise without
  one; the wrappers run their plain versions on CPU tensors without
  counting a launch, and raise on any other device.

The JAX scripts import a module the engine work has since removed
(sphinxsys_tpu.cases.dambreak_2d_block) and their pallas_calls take no
`interpret` flag.  They are loaded here, unchanged, with a stub module in
the removed one's place and a `pl` whose pallas_call runs in interpret
mode.
"""

import functools
import importlib.util
import inspect
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

import sphinxsys_tpu.cases as jcases
from sphinxsys_tpu.cases import dambreak_2d as jdb2
from sphinxsys_tpu.core.adaptation import SPHAdaptation as JAdaptation
from sphinxsys_tpu.core.materials import WeaklyCompressibleFluid as JFluid
from sphinxsys_tpu.engine import scene as jsc
from sphinxsys_tpu.neighbors import grid_from_bounds
from sphinxsys_tpu.neighbors.cell_blocks import build_block_map, to_blocks
from sphinxsys_tpu.ops import pallas_sweep as jps
from sphinxsys_tpu.physics import riemann as jrs
from sphinxsys_tpu_torch import convert
from sphinxsys_tpu_torch.benchmarks import exp_layout, exp_layout2, layout_state
from sphinxsys_tpu_torch.ops import layout_sweeps as tls
from sphinxsys_tpu_torch.ops import packed_sweeps as tps

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TILE_B6 = 64        # divides every C below
TILE_B7 = 128
SWEEPS = ("b6", "b7")


def _t(a):
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------------------
# the JAX scripts, loaded through a stub
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_layout():
    """(exp_layout, exp_layout2) of the JAX package, loaded from their
    files with a stub for the removed case module, pallas_call in
    interpret mode."""
    stub_name = "sphinxsys_tpu.cases.dambreak_2d_block"
    interpret_pl = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec)
    mods = []
    with pytest.MonkeyPatch.context() as mp:
        stub = types.ModuleType(stub_name)
        mp.setitem(sys.modules, stub_name, stub)
        mp.setattr(jcases, "dambreak_2d_block", stub, raising=False)
        for name in ("exp_layout", "exp_layout2"):
            spec = importlib.util.spec_from_file_location(
                f"_jax_{name}", ROOT / "benchmarks" / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            mod.pl = interpret_pl
            mods.append(mod)
    return tuple(mods)


# ---------------------------------------------------------------------------
# inputs: packed (C+1, 16, 8) float32, nbr (C, 9), real (C, 16), constants
# ---------------------------------------------------------------------------

def _consts(kernel, eos):
    return (1.0 / kernel.h, kernel._factor_w(2),
            jrs.acoustic_riemann(eos).inv_rho0c0_ave)


@pytest.fixture(scope="module")
def inputs():
    """The three input sets of (a)."""
    rng = np.random.default_rng(0)
    n, dx = 600, 0.04
    adaptation = JAdaptation(spacing=dx, dim=2)
    grid = grid_from_bounds((0, 0), (1, 1), adaptation.cutoff)
    c_max = TILE_B7 * ((grid.ncells + TILE_B7 - 1) // TILE_B7)
    pos = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    bm = build_block_map(jnp.asarray(pos), jnp.int32(n), grid, cap=16,
                         c_max=c_max)
    assert not bool(bm.overflow)

    def blocks(arr, fill=1.0):   # padding VOL = 1
        return to_blocks(bm, jnp.asarray(arr, jnp.float32), fill=fill)

    m = jnp.concatenate([bm.slot_mask.reshape(c_max, 16),
                         jnp.zeros((1, 16), bool)], axis=0)
    packed = np.array(jps.pack_state_2d(
        blocks(pos, 1e9), blocks(rng.normal(size=(n, 2))),
        blocks(rng.uniform(0, 1, n)), blocks(np.full(n, dx * dx)), m))
    near = packed.copy()
    pad = ~np.asarray(m)
    near[pad, :2] = rng.uniform(0, 1, (int(pad.sum()), 2))
    random = dict(packed=packed, nbr=np.asarray(bm.nbr_block),
                  real=np.asarray(m[:c_max]),
                  consts=_consts(adaptation.kernel, JFluid(rho0=1.0, c0=10.0)))
    perm = np.argsort(rng.random(packed.shape[:2]), axis=1)
    holes = dict(random,
                 packed=np.take_along_axis(packed, perm[..., None], axis=1),
                 real=np.take_along_axis(np.asarray(m), perm, axis=1)[:c_max])
    assert np.any(~holes["real"][:, :-1] & holes["real"][:, 1:]), \
        "no padding mid-row"

    jscene, jfluid = jdb2.build_block_case(dx=0.1, cap=16)
    sim = jsc.init_sim(jscene, jfluid)
    fb = {k: np.array(v) for k, v in sim.fluid_b.items()}
    rng = np.random.default_rng(4)
    mk = fb["SlotMask"]
    nr = int(mk.sum())
    fb["Position"][mk] += rng.uniform(-0.02, 0.02, (nr, 2))
    fb["Velocity"][mk] = rng.normal(0.0, 0.3, (nr, 2))
    fb["Pressure"][mk] = rng.normal(0.0, 2.0, nr)
    keys = ("Position", "Velocity", "Pressure", "VolumetricMeasure",
            "SlotMask")
    jpacked = np.array(jps.pack_state_2d(*(jnp.asarray(fb[k]) for k in keys)))
    tfb = convert.block_state_from_numpy(fb)
    tpacked = tps.pack_state_2d(*(tfb[k] for k in keys)).numpy()
    assert tpacked.dtype == np.float32
    np.testing.assert_array_equal(tpacked, jpacked)
    nbr = np.asarray(sim.nbr_inner)
    base = jscene.base
    dambreak = dict(packed=tpacked, nbr=nbr, real=mk[:nbr.shape[0]],
                    consts=_consts(base.kernel, base.eos))
    return {"random": random, "random_near": dict(random, packed=near),
            "random_holes": holes, "dambreak": dambreak}


def _jax_prep(packed, nbr):
    """exp_layout2.py:156-159."""
    c = nbr.shape[0]
    return packed[:c].transpose(2, 1, 0), packed[nbr].transpose(1, 3, 2, 0)


def _port(name, inp, dtype, plain=False):
    """The port's sweep on the input in `dtype`: (fx, fy, rd) as numpy, B7's
    transposed back to (C, 16) when `plain` (the wrappers run their plain
    versions on CPU tensors)."""
    packed, nbr = _t(inp["packed"].astype(dtype)), _t(inp["nbr"])
    if name == "b6":
        out = tls.ac1_flat_sweep(packed, nbr, *inp["consts"])
    else:
        out = tls.ac1_t_sweep(*tls.prep_t(packed, nbr), *inp["consts"])
        if plain:
            out = tuple(a.t() for a in out)
    return [a.numpy() for a in out]


def _assert_rel(got, ref, tol, what, mask=None):
    for ch, (a, b) in enumerate(zip(got, ref)):
        a, b = np.asarray(a), np.asarray(b)
        if mask is not None:
            a, b = a[mask], b[mask]
        scale = np.abs(b).max()
        assert scale > 1e-6, f"{what} ch{ch}: channel is all zero"
        err = np.abs(a - b).max() / scale
        assert err <= tol, f"{what} ch{ch}: {err:.3e} of max|ref| > {tol:g}"


# ---------------------------------------------------------------------------
# (a) float32 against the Pallas kernels (interpret)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["random", "random_near", "random_holes",
                                   "dambreak"])
@pytest.mark.parametrize("name", SWEEPS)
def test_plain_matches_pallas_interpret(jax_layout, inputs, name, which):
    jl, jl2 = jax_layout
    inp = inputs[which]
    packed = jnp.asarray(inp["packed"], jnp.float32)
    nbr = jnp.asarray(inp["nbr"], jnp.int32)
    if name == "b6":
        jout = jl.ac1_flat_pallas(packed, nbr, *inp["consts"], tile_c=TILE_B6)
        real = inp["real"]
    else:
        jout = jl2.ac1_t_pallas(*_jax_prep(packed, nbr), *inp["consts"],
                                tile_c=TILE_B7)
        real = inp["real"].T
    got = _port(name, inp, np.float32)
    _assert_rel(got, jout, 2e-5, f"{which} {name}", mask=real)
    for ch, a in enumerate(got):   # padding slots receive nothing
        assert not np.any(a[~real]), f"{which} {name} ch{ch}: padding"


# ---------------------------------------------------------------------------
# (b) float64 against the jnp forms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["random", "dambreak"])
@pytest.mark.parametrize("name", SWEEPS)
def test_plain_matches_jnp_f64(jax_layout, inputs, name, which):
    jl, jl2 = jax_layout
    inp = inputs[which]
    packed = jnp.asarray(inp["packed"], jnp.float64)
    nbr = jnp.asarray(inp["nbr"])
    if name == "b6":
        jout = jl.ac1_flat_jnp(packed, nbr, *inp["consts"])
    else:
        jout = jl2.ac1_transposed_jnp(*_jax_prep(packed, nbr), *inp["consts"])
    _assert_rel(_port(name, inp, np.float64), jout, 1e-10, f"{which} {name}")


# ---------------------------------------------------------------------------
# (c) three layouts of one function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["random", "random_near", "dambreak"])
def test_layouts_agree_f64(inputs, which):
    inp = inputs[which]
    b6 = _port("b6", inp, np.float64)
    b7 = _port("b7", inp, np.float64, plain=True)
    inv_h, factor_w, inv_rc = inp["consts"]
    force, rd = tps.ac1_inner_sweep(_t(inp["packed"].astype(np.float64)),
                                    _t(inp["nbr"]), 1.0 / inv_h, factor_w,
                                    inv_rc)
    b5a = [force[..., 0].numpy(), force[..., 1].numpy(), rd.numpy()]
    _assert_rel(b7, b6, 1e-12, f"{which} B7 vs B6")
    _assert_rel(b5a, b6, 1e-12, f"{which} B5a vs B6")


# ---------------------------------------------------------------------------
# (d) B7's input
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["random", "dambreak"])
def test_prep_t_matches_prep(inputs, which):
    inp = inputs[which]
    want = _jax_prep(jnp.asarray(inp["packed"]), jnp.asarray(inp["nbr"]))
    got = tls.prep_t(_t(inp["packed"]), _t(inp["nbr"]))
    for g, w in zip(got, want):
        assert g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# (e) the drivers on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("driver", [exp_layout, exp_layout2],
                         ids=["exp_layout", "exp_layout2"])
def test_driver_runs_on_cpu(driver, capsys):
    out = driver.run(dx=0.1, device="cpu", k=1)
    assert out["device"] == "cpu" and out["c_max"] == 512
    assert out["agree"]
    assert all(0.0 <= e <= out["tolerance"] for e in out["cross_check"].values())
    assert len(out["ms"]) == (4 if driver is exp_layout else 6)
    assert all(np.isfinite(t) and t > 0.0 for t in out["ms"].values())
    assert "agree" in capsys.readouterr().out


@pytest.mark.parametrize("driver", [exp_layout, exp_layout2],
                         ids=["exp_layout", "exp_layout2"])
def test_driver_takes_a_prebuilt_state(driver):
    """A state passed in (as chip_smoke.py shares one between both
    drivers) gives the run that builds its own, cross-checks alike."""
    st = layout_state(0.1, "cpu")
    out = driver.run(dx=0.1, device="cpu", k=1, state=st)
    ref = driver.run(dx=0.1, device="cpu", k=1)
    assert out["c_max"] == ref["c_max"] and out["agree"]
    assert out["cross_check"] == ref["cross_check"]


# ---------------------------------------------------------------------------
# (f) dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("driver", [exp_layout, exp_layout2],
                         ids=["exp_layout", "exp_layout2"])
def test_driver_defaults_to_the_card(driver, monkeypatch):
    """The drivers run on the card unless asked for the CPU: with no
    device given they ask for "cuda", and raise where there is none."""
    assert inspect.signature(driver.run).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        driver.run(dx=0.1, k=1)


def test_sweep_dispatch(inputs):
    """CPU tensors run the plain version (no launch counted); another
    device raises."""
    inp = inputs["dambreak"]
    packed, nbr = _t(inp["packed"]), _t(inp["nbr"])
    c = nbr.shape[0]
    tls.reset_launch_counts()
    fx, fy, rd = tls.ac1_flat_sweep(packed, nbr, *inp["consts"])
    assert fx.shape == fy.shape == rd.shape == (c, 16)
    xi_t, xj_t = tls.prep_t(packed, nbr)
    assert xi_t.shape == (8, 16, c) and xj_t.shape == (9, 8, 16, c)
    fx, fy, rd = tls.ac1_t_sweep(xi_t, xj_t, *inp["consts"])
    assert fx.shape == fy.shape == rd.shape == (16, c)
    assert tls.LAUNCHES == dict.fromkeys(tls.LAUNCHES, 0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tls.ac1_flat_sweep(packed.to("meta"), nbr.to("meta"), 0.1, 1.0, 1.0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tls.ac1_t_sweep(xi_t.to("meta"), xj_t.to("meta"), 0.1, 1.0, 1.0)
