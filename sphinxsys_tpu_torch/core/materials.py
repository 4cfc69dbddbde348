"""Materials (counterpart of sphinxsys_tpu/core/materials.py): the
weakly-compressible fluid and the linear, Neo-Hookean and St.
Venant-Kirchhoff elastic solids."""

from __future__ import annotations

import dataclasses
import math

import torch


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


@dataclasses.dataclass(frozen=True)
class ElasticSolid:
    """Linear-elastic solid parameterized by (rho0, E, nu)
    (materials/elastic_solid.h:46-341)."""

    rho0: float = 1.0
    youngs_modulus: float = 1.0
    poisson_ratio: float = 0.3

    @property
    def shear_modulus(self) -> float:  # G
        return 0.5 * self.youngs_modulus / (1.0 + self.poisson_ratio)

    @property
    def bulk_modulus(self) -> float:  # K
        return self.youngs_modulus / (3.0 * (1.0 - 2.0 * self.poisson_ratio))

    @property
    def lambda0(self) -> float:  # Lame first parameter
        nu, E = self.poisson_ratio, self.youngs_modulus
        return nu * E / ((1.0 + nu) * (1.0 - 2.0 * nu))

    @property
    def sound_speed(self) -> float:
        """c0 = sqrt(K/rho0), the elastic acoustic time step's speed
        (materials/elastic_solid.cpp setSoundSpeeds)."""
        return math.sqrt(self.bulk_modulus / self.rho0)

    @property
    def shear_wave_speed(self) -> float:
        """cs0 = sqrt(G/rho0) (elastic_solid.cpp setSoundSpeeds)."""
        return math.sqrt(self.shear_modulus / self.rho0)

    def volumetric_kirchhoff(self, J):
        """Volumetric Kirchhoff stress scalar of the decomposed shear /
        volumetric split (elastic_solid.cpp:98): K J (J - 1)."""
        return self.bulk_modulus * J * (J - 1.0)


@dataclasses.dataclass(frozen=True)
class NeoHookeanSolid(ElasticSolid):
    """Compressible Neo-Hookean solid (elastic_solid.h NeoHookeanSolid)."""

    def volumetric_kirchhoff(self, J):
        """elastic_solid.cpp:129: 0.5 K (J^2 - 1)."""
        return 0.5 * self.bulk_modulus * (J * J - 1.0)


@dataclasses.dataclass(frozen=True)
class SaintVenantKirchhoffSolid(ElasticSolid):
    """St. Venant-Kirchhoff: S = lambda tr(E) I + 2 G E (finite strain)."""

    def stress_PK2(self, F):
        """Second Piola-Kirchhoff stress of (..., d, d) deformation
        gradients: linear elasticity on the Green-Lagrange strain,
        S = lambda tr(E) I + 2 G E, E = (F^T F - I)/2 (the product a
        broadcast sum, as in physics/solid.py)."""
        dim = F.shape[-1]
        eye = torch.eye(dim, dtype=F.dtype, device=F.device)
        FtF = (F.transpose(-1, -2)[..., :, :, None] * F[..., None, :, :]).sum(-2)
        E = 0.5 * (FtF - eye)
        tr = torch.diagonal(E, dim1=-2, dim2=-1).sum(-1)
        return self.lambda0 * tr[..., None, None] * eye \
            + 2.0 * self.shear_modulus * E
