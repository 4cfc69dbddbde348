"""The build A/B tool (sphinxsys_tpu_torch/benchmarks/ab_sweeps.py) on the
CPU: its launchers need the card, but what it allocates and compares does
not.  On the 2D dambreak at dx = 0.1 (B1-B4) and at cap 16 (B5a-d, B6,
B7), `state_inputs` gives every sweep its wrapper's arguments, `out_shape`
is the shape of what the sweep writes (the wrapper's output here, the
plain version on CPU tensors), and `per_slot` turns it into (C, cap, k)
for the comparison on real slots.
"""

import pytest
import torch

from sphinxsys_tpu_torch.benchmarks import ab_sweeps as ab
from sphinxsys_tpu_torch.cases import dambreak_2d as db
from sphinxsys_tpu_torch.engine import scene as sc
from sphinxsys_tpu_torch.ops import block_sweeps as bs
from sphinxsys_tpu_torch.ops import layout_sweeps as ls
from sphinxsys_tpu_torch.ops import packed_sweeps as ps

torch.set_num_threads(1)

STATES = {"2d": ({}, ab.ALL), "2d16": ({"cap": ps.CAP}, ab.PACKED + ab.LAYOUT)}


def _written(name, out):
    """A wrapper's output as one tensor in the layout its kernel writes."""
    if name in ab.LAYOUT:
        return torch.stack(out)
    if name in ab.PACKED:
        return torch.cat([a if a.dim() == 3 else a[..., None] for a in out],
                         dim=-1)
    return out


@pytest.mark.parametrize("tag", sorted(STATES))
def test_out_shapes_match_the_sweeps(tag):
    kw, sweeps = STATES[tag]
    scene, fluid = db.build_block_case(dx=0.1, device="cpu", **kw)
    sim = sc.make_advection_step(scene)(sc.init_sim(scene, fluid))
    c, cap = sim.fluid_b["SlotMask"][:sim.nbr_inner.shape[0]].shape
    inputs = ab.state_inputs(scene, sim, sweeps)
    assert set(inputs) >= set(sweeps)
    for name in sweeps:
        args, kwargs = inputs[name]
        module = ls if name in ab.LAYOUT else ps if name in ab.PACKED else bs
        out = _written(name, getattr(module, name)(*args, **kwargs))
        assert tuple(out.shape) == ab.out_shape(name, ab.launch_args(name,
                                                                     args)), name
        assert ab.per_slot(name, out).shape[:2] == (c, cap), name
