"""2D oscillating beam with the Cauchy-stress integrator (counterpart of
sphinxsys_tpu/cases/oscillating_beam_cauchy_2d.py; reference tests/
2d_examples/test_2d_oscillating_beam_cauchy/cauchy_oscillating_beam.cpp):
oscillating_beam_2d's scene and constants, the first half's PK1 taken
from the Cauchy stress of the Almansi strain (Integration1stHalfCauchy,
elastic_dynamics.cpp:148-160).  For St. Venant-Kirchhoff at moderate
strain the two discretisations track each other closely.

    case, sim = build_case(device="cpu")
    sim = make_run_chunk(case)(sim, 0.01)
"""

from __future__ import annotations

from functools import partial

from sphinxsys_tpu_torch.cases import oscillating_beam_2d as base

T0 = 1.0

build_case = partial(base.build_case, integrator="cauchy")
make_run_chunk = base.make_run_chunk
make_step = base.make_step
tip_displacement = base.tip_displacement
BeamSim = base.BeamSim
BeamCase = base.BeamCase
