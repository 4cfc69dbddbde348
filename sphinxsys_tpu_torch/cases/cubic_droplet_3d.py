"""3D cubic droplet rounding toward a sphere under surface tension
(counterpart of sphinxsys_tpu/cases/cubic_droplet_3d.py; reference
tests/3d_examples/test_3d_cubic_droplet/3d_cubic_droplet.cpp): a 1^3
water cube (rho0 = 1) in air 1000 times lighter inside a closed 2^3 box
(dx = 2/30, mu_f = 5e-2, mu_a = 5e-4, sigma = 1).  The step is the
square droplet's (cases/square_droplet_2d.py), in 3D: the per-pair
surface-tension tensors are (N, K, 3, 3).

    case, water, air = build_case(dx=0.2, device="cpu")
    sim = make_run_chunk(case)(init_sim(case, water, air), 0.01)
"""

from __future__ import annotations

# the square droplet's step and observables serve this case as they are
from sphinxsys_tpu_torch.cases.square_droplet_2d import (  # noqa: F401
    Materials, SimState, build_droplet_case, centred_box, init_sim,
    make_advection_step, make_run_chunk, water_kinetic_energy,
    water_max_radius)
from sphinxsys_tpu_torch.device import PRODUCTION_DTYPE
from sphinxsys_tpu_torch.physics import surface_tension as st

# 3d_cubic_droplet.cpp:14-31
DL = 2.0
LL = 1.0
RHO0_F = 1.0
RHO0_A = 0.001
U_REF = 1.0
C_F = 10.0 * U_REF
MU_F = 5.0e-2
MU_A = 5.0e-4
SIGMA = 1.0
MU_WA = 2.0 * MU_F * MU_A / (MU_F + MU_A)
FRAC_W = st.contact_fraction(RHO0_F, RHO0_A)
FRAC_A = st.contact_fraction(RHO0_A, RHO0_F)
MATERIALS = Materials(rho0_f=RHO0_F, rho0_a=RHO0_A, u_ref=U_REF, mu_f=MU_F,
                      mu_a=MU_A, sigma=SIGMA)


def build_case(dx: float = DL / 30.0, dtype=PRODUCTION_DTYPE,
               cell_cap: int = 40, k_inner: int = 96, k_contact: int = 64,
               device="cuda"):
    """The cube, the air and the wall, centred at the origin.  Returns
    (case, water, air)."""
    bw = 4 * dx
    return build_droplet_case(
        dx, 3, MATERIALS, centred_box(3, LL / 2), centred_box(3, DL / 2),
        centred_box(3, DL / 2 + bw), (-DL / 2 - bw,) * 3, (DL / 2 + bw,) * 3,
        dtype, device, cell_cap, k_inner, k_contact)
