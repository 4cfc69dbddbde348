"""Low-dissipation acoustic Riemann solver (counterpart of
sphinxsys_tpu/physics/riemann.py; reference riemann_solver.h:55-124):
    DissipativePJump(du) = rho0c0_geo * du * min(coeff * inv_c0_ave * max(du, 0), 1)
    DissipativeUJump(dp) = dp * inv_rho0c0_ave
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class AcousticRiemannSolver:
    """BaseAcousticRiemannSolver<TruncatedLinear>."""

    rho0c0_i: float
    rho0c0_j: float
    inv_c0_ave: float = 0.0
    limiter_coeff: float = 3.0

    @property
    def inv_rho0c0_sum(self) -> float:
        return 1.0 / (self.rho0c0_i + self.rho0c0_j)

    @property
    def inv_rho0c0_ave(self) -> float:
        return (self.rho0c0_i + self.rho0c0_j) / (self.rho0c0_i ** 2
                                                  + self.rho0c0_j ** 2)

    @property
    def rho0c0_geo_ave(self) -> float:
        return 2.0 * self.rho0c0_i * self.rho0c0_j * self.inv_rho0c0_sum

    def dissipative_p_jump(self, u_jump):
        lim = torch.clamp(self.limiter_coeff * (
            self.inv_c0_ave * torch.clamp(u_jump, min=0.0)), max=1.0)
        return self.rho0c0_geo_ave * u_jump * lim

    def dissipative_u_jump(self, p_jump):
        return p_jump * self.inv_rho0c0_ave


def acoustic_riemann(fluid_i, fluid_j=None,
                     limiter_coeff: float = 3.0) -> AcousticRiemannSolver:
    """Build from WeaklyCompressibleFluid materials."""
    fluid_j = fluid_j or fluid_i
    rc_i, rc_j = fluid_i.rho0 * fluid_i.c0, fluid_j.rho0 * fluid_j.c0
    inv_rho0c0_ave = (rc_i + rc_j) / (rc_i ** 2 + rc_j ** 2)
    return AcousticRiemannSolver(
        rho0c0_i=rc_i, rho0c0_j=rc_j,
        inv_c0_ave=0.5 * (fluid_i.rho0 + fluid_j.rho0) * inv_rho0c0_ave,
        limiter_coeff=limiter_coeff)
