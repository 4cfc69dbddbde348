"""Riemann solvers for the pairwise WCSPH dissipation (counterpart of
sphinxsys_tpu/physics/riemann.py; reference riemann_solver.h:55-124):
    No:          no dissipation (the central scheme)
    Acoustic:    DissipativePJump(du) = rho0c0_geo * du * min(coeff * inv_c0_ave * max(du, 0), 1)
                 DissipativeUJump(dp) = dp * inv_rho0c0_ave
    Dissipative: the Acoustic jumps with the limiter == 1
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class NoRiemannSolver:
    """Central scheme: no dissipation (riemann_solver.h:55).  It keeps the
    averaged constants of its subclass; callers that pass them to a sweep
    must check the solver's type first."""

    rho0c0_i: float
    rho0c0_j: float
    inv_c0_ave: float = 0.0

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
        return torch.zeros_like(u_jump)

    def dissipative_u_jump(self, p_jump):
        return torch.zeros_like(p_jump)


@dataclasses.dataclass(frozen=True)
class AcousticRiemannSolver(NoRiemannSolver):
    """BaseAcousticRiemannSolver<TruncatedLinear>."""

    limiter_coeff: float = 3.0

    def _limiter(self, x):
        return torch.clamp(self.limiter_coeff * x, max=1.0)

    def dissipative_p_jump(self, u_jump):
        lim = self._limiter(self.inv_c0_ave * torch.clamp(u_jump, min=0.0))
        return self.rho0c0_geo_ave * u_jump * lim

    def dissipative_u_jump(self, p_jump):
        return p_jump * self.inv_rho0c0_ave


@dataclasses.dataclass(frozen=True)
class DissipativeRiemannSolver(AcousticRiemannSolver):
    """BaseAcousticRiemannSolver<NoLimiter>: limiter == 1."""

    def _limiter(self, x):
        return torch.ones_like(x)


def _rho0c0_pair(fluid_i, fluid_j):
    """(rho0c0_i, rho0c0_j, inv_c0_ave) from WeaklyCompressibleFluid materials."""
    rc_i, rc_j = fluid_i.rho0 * fluid_i.c0, fluid_j.rho0 * fluid_j.c0
    inv_rho0c0_ave = (rc_i + rc_j) / (rc_i ** 2 + rc_j ** 2)
    return rc_i, rc_j, 0.5 * (fluid_i.rho0 + fluid_j.rho0) * inv_rho0c0_ave


def acoustic_riemann(fluid_i, fluid_j=None,
                     limiter_coeff: float = 3.0) -> AcousticRiemannSolver:
    rc_i, rc_j, inv_c0 = _rho0c0_pair(fluid_i, fluid_j or fluid_i)
    return AcousticRiemannSolver(rho0c0_i=rc_i, rho0c0_j=rc_j,
                                 inv_c0_ave=inv_c0, limiter_coeff=limiter_coeff)


def dissipative_riemann(fluid_i, fluid_j=None) -> DissipativeRiemannSolver:
    rc_i, rc_j, inv_c0 = _rho0c0_pair(fluid_i, fluid_j or fluid_i)
    return DissipativeRiemannSolver(rho0c0_i=rc_i, rho0c0_j=rc_j,
                                    inv_c0_ave=inv_c0)


def no_riemann(fluid_i, fluid_j=None) -> NoRiemannSolver:
    rc_i, rc_j, inv_c0 = _rho0c0_pair(fluid_i, fluid_j or fluid_i)
    return NoRiemannSolver(rho0c0_i=rc_i, rho0c0_j=rc_j, inv_c0_ave=inv_c0)
