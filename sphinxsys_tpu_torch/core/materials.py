"""Materials (counterpart of sphinxsys_tpu/core/materials.py): the
weakly-compressible fluid only."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class WeaklyCompressibleFluid:
    """Linear-EoS weakly-compressible fluid
    (materials/weakly_compressible_fluid.cpp:17-30):
        p = rho0 c0^2 (rho/rho0 - 1),   c = c0."""

    rho0: float = 1.0
    c0: float = 1.0

    @property
    def p0(self) -> float:
        return self.rho0 * self.c0 * self.c0

    def pressure(self, rho):
        return self.p0 * (rho / self.rho0 - 1.0)

    def sound_speed(self, p=None, rho=None):
        return self.c0
