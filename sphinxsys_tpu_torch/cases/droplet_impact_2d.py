"""2D droplet impacting a floor (counterpart of
sphinxsys_tpu/cases/droplet_impact_2d.py; reference tests/2d_examples/
test_2d_droplet_impact/2d_droplet_impact.{h,cpp}): a water droplet of
radius 0.5 (rho0 = 1) tangent to the floor of a 5 x 1.5 tank full of air
1000 times lighter falls at U_ref = 5 and spreads (Re = 1000, We = 250).
Wetting comes from the multi-phase momentum exchange alone: the walls
enter through the usual wall terms, surface tension acts on the
water-air interface only (2d_droplet_impact.cpp:131-134).

The step is the square droplet's (cases/square_droplet_2d.py) with this
case's constants (2d_droplet_impact.h:12-30): c = 10 U_ref = 50,
mu_w = 5e-3, mu_a = 5e-5, sigma = 0.1, the droplet's initial velocity
(0, -U_ref).  The regression quantity is the water's total kinetic
energy (51 snapshots to t = 0.2).

    case, water, air = build_case(dx=0.05, device="cpu")
    sim = make_run_chunk(case)(init_sim(case, water, air), 0.004)
    print(water_kinetic_energy(sim))
"""

from __future__ import annotations

# the square droplet's step and observable serve this case as they are
from sphinxsys_tpu_torch.cases.square_droplet_2d import (  # noqa: F401
    Materials, SimState, build_droplet_case, init_sim, make_advection_step,
    make_run_chunk, water_kinetic_energy)
from sphinxsys_tpu_torch.core import geometry as G
from sphinxsys_tpu_torch.device import PRODUCTION_DTYPE
from sphinxsys_tpu_torch.physics import surface_tension as st

# 2d_droplet_impact.h:12-30
RADIUS = 0.5
DL = 10.0 * RADIUS
DH = 3.0 * RADIUS
RHO0_F = 1.0
RHO0_A = 1.0e-3
U_REF = 5.0
C_F = 10.0 * U_REF
MU_F = 5.0e-3
MU_A = 5.0e-5
SIGMA = 0.1
MU_WA = 2.0 * MU_F * MU_A / (MU_F + MU_A)
FRAC_W = st.contact_fraction(RHO0_F, RHO0_A)
FRAC_A = st.contact_fraction(RHO0_A, RHO0_F)
END_TIME = 0.2
MATERIALS = Materials(rho0_f=RHO0_F, rho0_a=RHO0_A, u_ref=U_REF, mu_f=MU_F,
                      mu_a=MU_A, sigma=SIGMA)


def build_case(dx: float = RADIUS / 20.0, dtype=PRODUCTION_DTYPE,
               cell_cap: int = 24, k_inner: int = 48, k_contact: int = 32,
               device="cuda"):
    """The droplet, the air and the tank wall; the droplet moving down
    at U_ref (InitialCondition, 2d_droplet_impact.h:81-93).  Returns
    (case, water, air)."""
    bw = 4 * dx
    box = lambda half: G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                             halfsize=half)
    return build_droplet_case(
        dx, 2, MATERIALS, G.Ball(center=(DL / 2.0, RADIUS), radius=RADIUS),
        box((DL / 2, DH / 2)), box((DL / 2 + bw, DH / 2 + bw)), (-bw, -bw),
        (DL + bw, DH + bw), dtype, device, cell_cap, k_inner, k_contact,
        water_velocity=(0.0, -U_REF))
