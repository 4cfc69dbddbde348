"""Materials (counterpart of sphinxsys_tpu/core/materials.py): the
weakly-compressible fluid, the ideal gas, the linear, Neo-Hookean, FENE
Neo-Hookean, orthotropic and St. Venant-Kirchhoff elastic solids with
their Cauchy stresses, the Holzapfel-Ogden muscle (also with
per-particle directions), the composite solid, and the J2-plastic solids
with linear and saturation hardening and the viscoplastic one.
Determinants, inverses and products of the per-particle matrices are
the closed forms of core/linalg.py.  The JAX package's `Material` /
`Solid` bases have no counterpart: each class here carries its own
reference density, and every solid derives from `ElasticSolid`."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sphinxsys_tpu_torch.core.linalg import det, inv, mm, mv


@dataclasses.dataclass(frozen=True)
class WeaklyCompressibleFluid:
    """Linear-EoS weakly-compressible fluid
    (materials/weakly_compressible_fluid.cpp:17-30):
        p = rho0 c0^2 (rho/rho0 - 1),   c = c0;
    `density_from_pressure` is its inverse."""

    rho0: float = 1.0
    c0: float = 1.0

    @property
    def p0(self) -> float:
        return self.rho0 * self.c0 * self.c0

    def pressure(self, rho):
        return self.p0 * (rho / self.rho0 - 1.0)

    def density_from_pressure(self, p):
        return self.rho0 * (p / self.p0 + 1.0)

    def sound_speed(self, p=None, rho=None):
        return self.c0


@dataclasses.dataclass(frozen=True)
class CompressibleFluid:
    """Ideal-gas compressible fluid (materials/compressible_fluid.cpp):
        p = (gamma - 1) rho e,   c = sqrt(gamma p / rho)."""

    rho0: float = 1.0
    gamma: float = 1.4

    def pressure(self, rho, e):
        return (self.gamma - 1.0) * rho * e

    def internal_energy(self, p, rho):
        return p / (rho * (self.gamma - 1.0))

    def sound_speed(self, p, rho):
        return torch.sqrt(self.gamma * p / rho)


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

    def stress_PK2(self, F):
        """Second Piola-Kirchhoff stress of (..., d, d) deformation
        gradients: linear elasticity on the Green-Lagrange strain,
        S = lambda tr(E) I + 2 G E, E = (F^T F - I)/2."""
        dim = F.shape[-1]
        eye = torch.eye(dim, dtype=F.dtype, device=F.device)
        E = 0.5 * (mm(F.transpose(-1, -2), F) - eye)
        tr = torch.diagonal(E, dim1=-2, dim2=-1).sum(-1)
        return self.lambda0 * tr[..., None, None] * eye \
            + 2.0 * self.shear_modulus * E

    def volumetric_kirchhoff(self, J):
        """Volumetric Kirchhoff stress scalar of the decomposed shear /
        volumetric split (elastic_solid.cpp:98): K J (J - 1)."""
        return self.bulk_modulus * J * (J - 1.0)

    def stress_cauchy(self, almansi_strain):
        """Cauchy stress of the Almansi strain (elastic_solid.cpp:93-96,
        the linear form): sigma = lambda tr(eps) I + 2 G eps; read by the
        Cauchy integrator through P = J sigma F^-T."""
        dim = almansi_strain.shape[-1]
        eye = torch.eye(dim, dtype=almansi_strain.dtype,
                        device=almansi_strain.device)
        tr = torch.diagonal(almansi_strain, dim1=-2, dim2=-1).sum(-1)
        return self.lambda0 * tr[..., None, None] * eye \
            + 2.0 * self.shear_modulus * almansi_strain


@dataclasses.dataclass(frozen=True)
class LinearElasticSolid(ElasticSolid):
    """The reference's name for the linear-elastic solid
    (elastic_solid.h:46)."""


@dataclasses.dataclass(frozen=True)
class Muscle(ElasticSolid):
    """Holzapfel-Ogden-type anisotropic muscle (elastic_solid.cpp
    Muscle::StressPK2): an exponential isotropic term, fibre, sheet and
    fibre-sheet invariant terms over the reference directions f0 / s0 (2-
    or 3-vectors, the deformation's dimension), and a volumetric penalty
    with lambda = bulk_modulus_param.  a0 / b0: (iso, fibre, sheet,
    fibre-sheet)."""

    bulk_modulus_param: float = 1.0
    f0: tuple = (1.0, 0.0)
    s0: tuple = (0.0, 1.0)
    a0: tuple = (1.0, 0.0, 0.0, 0.0)
    b0: tuple = (1.0, 0.0, 0.0, 0.0)

    @property
    def lambda0(self) -> float:
        return self.bulk_modulus_param

    @property
    def sound_speed(self) -> float:
        return math.sqrt(self.bulk_modulus_param / self.rho0)

    def stress_PK2(self, F):
        f0 = torch.as_tensor(self.f0, dtype=F.dtype, device=F.device)
        s0 = torch.as_tensor(self.s0, dtype=F.dtype, device=F.device)
        return self._holzapfel_pk2(F, f0, s0)

    def _holzapfel_pk2(self, F, f0, s0):
        """S = a0 e^(b0 I_1) I + (lambda (J - 1) - a0) J C^-1
        + 2 a1 I_ff e^(b1 I_ff^2) f0 f0 + 2 a2 I_ss e^(b2 I_ss^2) s0 s0
        + a3 I_fs e^(b3 I_fs^2) (f0 s0 + s0 f0), with C = F^T F,
        I_1 = tr C - dim, I_ff = f0.C f0 - 1, I_ss = s0.C s0 - 1,
        I_fs = f0.C s0; f0 / s0 are (d,) or per particle (..., d)."""
        dim = F.shape[-1]
        eye = torch.eye(dim, dtype=F.dtype, device=F.device)
        C = mm(F.transpose(-1, -2), F)
        f0f0 = f0[..., :, None] * f0[..., None, :]
        s0s0 = s0[..., :, None] * s0[..., None, :]
        f0s0 = f0[..., :, None] * s0[..., None, :] \
            + s0[..., :, None] * f0[..., None, :]
        Cf, Cs = mv(C, f0), mv(C, s0)
        I_ff = (Cf * f0).sum(-1) - 1.0
        I_ss = (Cs * s0).sum(-1) - 1.0
        I_fs = (Cs * f0).sum(-1)
        I_1 = torch.diagonal(C, dim1=-2, dim2=-1).sum(-1) - dim
        J = det(F)
        Cinv = inv(C)
        a, b = self.a0, self.b0
        lam = self.lambda0
        return (a[0] * torch.exp(b[0] * I_1))[..., None, None] * eye + \
            ((lam * (J - 1.0) - a[0]) * J)[..., None, None] * Cinv + \
            (2.0 * a[1] * I_ff * torch.exp(b[1] * I_ff * I_ff))[..., None, None] \
            * f0f0 + \
            (2.0 * a[2] * I_ss * torch.exp(b[2] * I_ss * I_ss))[..., None, None] \
            * s0s0 + \
            (a[3] * I_fs * torch.exp(b[3] * I_fs * I_fs))[..., None, None] * f0s0


@dataclasses.dataclass(frozen=True)
class LocallyOrthotropicMuscle(Muscle):
    """The muscle with per-particle fiber and sheet directions
    (elastic_solid.h:334-372, LocallyOrthotropicMuscle::StressPK2): the
    same terms, the directions read from the state's (N, d) fields."""

    def stress_PK2_local(self, F, f0_local, s0_local):
        return self._holzapfel_pk2(F, f0_local, s0_local)


@dataclasses.dataclass(frozen=True)
class NeoHookeanSolid(ElasticSolid):
    """Compressible Neo-Hookean solid (elastic_solid.h NeoHookeanSolid)."""

    def stress_PK2(self, F):
        """S = G J^(-2/3) (I - tr(C)/dim C^-1) + K J (J - 1) C^-1 with
        C = F^T F and J = det(F), of (..., d, d) deformation gradients."""
        dim = F.shape[-1]
        eye = torch.eye(dim, dtype=F.dtype, device=F.device)
        C = mm(F.transpose(-1, -2), F)
        J = det(F)
        Cinv = inv(C)
        trC = torch.diagonal(C, dim1=-2, dim2=-1).sum(-1)
        G, K = self.shear_modulus, self.bulk_modulus
        Jm23 = J ** (-2.0 / 3.0)
        dev = Jm23[..., None, None] * (eye - (trC / dim)[..., None, None] * Cinv)
        vol = (K * J * (J - 1.0))[..., None, None] * Cinv
        return G * dev + vol

    def volumetric_kirchhoff(self, J):
        """elastic_solid.cpp:129: 0.5 K (J^2 - 1)."""
        return 0.5 * self.bulk_modulus * (J * J - 1.0)

    def stress_cauchy(self, almansi_strain):
        """elastic_solid.cpp:119-126: with B = (I - 2 eps)^-1 and
        J = sqrt(det B), sigma = K/2 (J - 1/J) I + G J^(-2/d - 1) dev(B)."""
        dim = almansi_strain.shape[-1]
        eye = torch.eye(dim, dtype=almansi_strain.dtype,
                        device=almansi_strain.device)
        B = inv(eye - 2.0 * almansi_strain)
        J = torch.sqrt(det(B))
        trB = torch.diagonal(B, dim1=-2, dim2=-1).sum(-1)
        G, K = self.shear_modulus, self.bulk_modulus
        dev = B - (trB / dim)[..., None, None] * eye
        return (0.5 * K * (J - 1.0 / J))[..., None, None] * eye \
            + G * (J ** (-2.0 / dim - 1.0))[..., None, None] * dev


@dataclasses.dataclass(frozen=True)
class FeneNeoHookeanSolid(ElasticSolid):
    """Neo-Hookean with finite extensibility (elastic_solid.cpp:200-207):
        S = G / (1 - 2 tr(E)/J1m) I + (lambda (J - 1) - G) J C^-1,
    E the Green-Lagrange strain, J1m the reference extension."""

    j1_m: float = 1.0

    def stress_PK2(self, F):
        dim = F.shape[-1]
        eye = torch.eye(dim, dtype=F.dtype, device=F.device)
        C = mm(F.transpose(-1, -2), F)
        strain_tr = 0.5 * (torch.diagonal(C, dim1=-2, dim2=-1).sum(-1) - dim)
        J = det(F)
        G, lam = self.shear_modulus, self.lambda0
        return (G / (1.0 - 2.0 * strain_tr / self.j1_m))[..., None, None] * eye \
            + ((lam * (J - 1.0) - G) * J)[..., None, None] * inv(C)


@dataclasses.dataclass(frozen=True)
class OrthotropicSolid(ElasticSolid):
    """Orthotropic elasticity over three principal directions a_i
    (elastic_solid.h:248-282, elastic_solid.cpp:154-198,
    elastic_solid_3d.cpp:7-35; 3D only, as the reference).  The shear
    combination Mu_i = 1/G_i + 1/G_k - 1/G_j is the reference's
    (elastic_solid_3d.cpp:10-12); the base class's (E, nu) are the maxima,
    which set the sound speed as in the reference's constructor."""

    a: tuple = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))
    E: tuple = (1.0, 1.0, 1.0)
    G: tuple = (0.5, 0.5, 0.5)
    poisson: tuple = (0.3, 0.3, 0.3)

    def __post_init__(self):
        object.__setattr__(self, "youngs_modulus", max(self.E))
        object.__setattr__(self, "poisson_ratio", max(self.poisson))

    def _params(self):
        """(Mu (3,), Lambda (3, 3), A_i = a_i a_i^T (3, 3, 3)) in float64."""
        E, nu, G = self.E, self.poisson, self.G
        mu = np.asarray([1 / G[0] + 1 / G[2] - 1 / G[1],
                         1 / G[1] + 1 / G[0] - 1 / G[2],
                         1 / G[2] + 1 / G[1] - 1 / G[0]])
        compliance = np.asarray([
            [1 / E[0], -nu[0] / E[0], -nu[1] / E[0]],
            [-nu[0] / E[1], 1 / E[1], -nu[2] / E[1]],
            [-nu[1] / E[2], -nu[2] / E[1], 1 / E[2]]]).T
        cinv = np.linalg.inv(compliance)
        lam = cinv.copy()
        for i in range(3):
            lam[i, i] = cinv[i, i] - 2 * mu[i]
        A = np.asarray([np.outer(self.a[i], self.a[i]) for i in range(3)])
        return mu, lam, A

    def stress_PK2(self, F):
        mu, lam, A64 = self._params()
        A = torch.as_tensor(A64, dtype=F.dtype, device=F.device)
        eye = torch.eye(3, dtype=F.dtype, device=F.device)
        strain = 0.5 * (mm(F.transpose(-1, -2), F) - eye)
        stress = torch.zeros_like(strain)
        bidot = [torch.sum(A[i] * strain, dim=(-2, -1)) for i in range(3)]
        for i in range(3):
            summa = torch.zeros_like(strain)
            for j in range(3):
                summa = summa + float(lam[i, j]) * (
                    bidot[i][..., None, None] * A[j]
                    + bidot[j][..., None, None] * A[i])
            stress = stress + float(mu[i]) * (mm(A[i].expand_as(strain), strain)
                                              + mm(strain, A[i].expand_as(strain))
                                              + 0.5 * summa)
        return stress


@dataclasses.dataclass(frozen=True)
class CompositeSolid(ElasticSolid):
    """Per-particle material dispatch (complex_solid.h:59-96): a particle's
    material id selects one of `materials`; every material's stress is
    evaluated and the id's taken by mask.  The sound speed, for the time
    step, is the largest of the materials', as in the reference's
    constructor."""

    materials: tuple = ()

    def __post_init__(self):
        if self.materials:
            object.__setattr__(self, "youngs_modulus",
                               self.sound_speed ** 2 * self.rho0 * 3.0
                               * (1.0 - 2.0 * self.poisson_ratio))

    @property
    def sound_speed(self) -> float:
        return max(m.sound_speed for m in self.materials)

    def stress_PK2_composite(self, F, material_id):
        out = None
        for k, m in enumerate(self.materials):
            s = m.stress_PK2(F)
            out = s if out is None else torch.where(
                (material_id == k)[..., None, None], s, out)
        return out

    def composite_density(self, material_id, dtype=torch.float32):
        """CompositeDensity: each particle's rho0 of its material (JAX's
        is float32 whatever the state's dtype; `dtype` chooses here)."""
        rho = torch.zeros(material_id.shape, dtype=dtype,
                          device=material_id.device)
        for k, m in enumerate(self.materials):
            rho = torch.where(material_id == k, torch.full_like(rho, m.rho0),
                              rho)
        return rho


@dataclasses.dataclass(frozen=True)
class SaintVenantKirchhoffSolid(ElasticSolid):
    """St. Venant-Kirchhoff: S = lambda tr(E) I + 2 G E (finite strain),
    the base class's stress_PK2."""


def _tr(M):
    return torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)


def _frobenius(M):
    return torch.sqrt(torch.sum(M * M, dim=(-2, -1)))


@dataclasses.dataclass(frozen=True)
class HardeningPlasticSolid(ElasticSolid):
    """J2 plasticity with linear isotropic hardening by radial return on
    the normalised elastic left Cauchy-Green tensor (inelastic_solid.h:
    60-100, inelastic_solid.cpp:31-54).  Each particle carries its plastic
    state (InversePlasticStrain (.., d, d), HardeningParameter (..,))
    through `elastic_left_cauchy`."""

    yield_stress: float = 1.0
    hardening_modulus: float = 0.0

    def initial_plastic_state(self, n: int, dim: int, dtype, device):
        """(InversePlasticStrain = I, HardeningParameter = 0) of n rows."""
        eye = torch.eye(dim, dtype=dtype, device=device).expand(n, dim, dim)
        return eye.contiguous(), torch.zeros((n,), dtype=dtype, device=device)

    def _trial(self, be):
        """The trial state of be: (be det(be)^(-1/d), tr/d, the deviatoric
        Kirchhoff stress G dev, its Frobenius norm)."""
        dim = be.shape[-1]
        nbe = be * (det(be) ** (-1.0 / dim))[..., None, None]
        iso = _tr(nbe) / dim
        eye = torch.eye(dim, dtype=be.dtype, device=be.device)
        dev_kirchhoff = self.shear_modulus * (nbe - iso[..., None, None] * eye)
        return nbe, iso, dev_kirchhoff, _frobenius(dev_kirchhoff)

    def _flow_stress(self, kappa):
        return self.hardening_modulus * kappa + self.yield_stress

    def _return(self, F_inv, dev_k, dk_norm, iso, nbe, Gr, relax, yielded):
        """The relaxed state of a return increment: (normalised be, the new
        inverse plastic strain F^-1 be F^-T)."""
        dim = nbe.shape[-1]
        eye = torch.eye(dim, dtype=nbe.dtype, device=nbe.device)
        dev_relaxed = dev_k - (2.0 * Gr * relax
                               / torch.clamp(dk_norm, min=1e-15)
                               )[..., None, None] * dev_k
        relaxed_be = dev_relaxed / self.shear_modulus \
            + iso[..., None, None] * eye
        nbe_new = relaxed_be * (det(relaxed_be)
                                ** (-1.0 / dim))[..., None, None]
        nbe_out = torch.where(yielded[..., None, None], nbe_new, nbe)
        return nbe_out, mm(mm(F_inv, nbe_out), F_inv.transpose(-1, -2))

    def elastic_left_cauchy(self, F, inv_plastic_strain, kappa):
        """The radial-return update: (normalised be, inverse plastic
        strain, hardening parameter) after the step."""
        sqrt23 = math.sqrt(2.0 / 3.0)
        be = mm(mm(F, inv_plastic_strain), F.transpose(-1, -2))
        nbe, iso, dev_k, dk_norm = self._trial(be)
        trial = dk_norm - sqrt23 * self._flow_stress(kappa)
        Gr = iso * self.shear_modulus
        relax = torch.clamp(trial, min=0.0) * 0.5 \
            / (Gr + self.hardening_modulus / 3.0)
        yielded = trial > 0.0
        nbe_out, inv_ps = self._return(inv(F), dev_k, dk_norm, iso, nbe, Gr,
                                       relax, yielded)
        return nbe_out, inv_ps, torch.where(yielded, kappa + sqrt23 * relax,
                                            kappa)

    def kirchhoff_stress(self, normalized_be, J):
        """tau = G dev(be_n) + K J (J - 1) I (DeviatoricKirchhoff +
        LinearElasticSolid::VolumetricKirchhoff)."""
        dim = normalized_be.shape[-1]
        eye = torch.eye(dim, dtype=normalized_be.dtype,
                        device=normalized_be.device)
        iso = _tr(normalized_be) / dim
        dev = self.shear_modulus * (normalized_be - iso[..., None, None] * eye)
        return dev + (self.bulk_modulus * J * (J - 1.0))[..., None, None] * eye


@dataclasses.dataclass(frozen=True)
class NonLinearHardeningPlasticSolid(HardeningPlasticSolid):
    """Saturation hardening (inelastic_solid.h:103-136,
    inelastic_solid.cpp:56-80): the flow stress
      sigma_y(k) = H k + sigma_0 + (sigma_inf - sigma_0)(1 - e^(-n k)),
    the return increment by eight fixed Newton iterations."""

    saturation_flow_stress: float = 1.0
    saturation_exponent: float = 1.0

    def _flow_stress(self, kappa):
        return (self.hardening_modulus * kappa + self.yield_stress
                + (self.saturation_flow_stress - self.yield_stress)
                * (1.0 - torch.exp(-self.saturation_exponent * kappa)))

    def _flow_stress_derivative(self, kappa):
        return (self.hardening_modulus + self.saturation_exponent
                * (self.saturation_flow_stress - self.yield_stress)
                * torch.exp(-self.saturation_exponent * kappa))

    def elastic_left_cauchy(self, F, inv_plastic_strain, kappa):
        sqrt23 = math.sqrt(2.0 / 3.0)
        dim = F.shape[-1]
        nF = F * (det(F) ** (-1.0 / dim))[..., None, None]
        be = mm(mm(nF, inv_plastic_strain), nF.transpose(-1, -2))
        nbe, iso, dev_k, dk_norm = self._trial(be)
        trial0 = dk_norm - sqrt23 * self._flow_stress(kappa)
        Gr = iso * self.shear_modulus
        relax = torch.zeros_like(kappa)
        for _ in range(8):            # fixed Newton iterations
            k_try = kappa + sqrt23 * relax
            f = dk_norm - sqrt23 * self._flow_stress(k_try) - 2.0 * Gr * relax
            df = -2.0 * Gr * (1.0 + self._flow_stress_derivative(k_try)
                              / (3.0 * Gr))
            relax = relax - f / df
        relax = torch.clamp(relax, min=0.0)
        yielded = trial0 > 0.0
        nbe_out, inv_ps = self._return(inv(nF), dev_k, dk_norm, iso, nbe, Gr,
                                       relax, yielded)
        return nbe_out, inv_ps, torch.where(yielded, kappa + sqrt23 * relax,
                                            kappa)


@dataclasses.dataclass(frozen=True)
class ViscousPlasticSolid(HardeningPlasticSolid):
    """Perzyna viscoplasticity with a Herschel-Bulkley overstress law
    (inelastic_solid.h:108-136, inelastic_solid.cpp
    ViscousPlasticSolid::ElasticLeftCauchy): past yield, the deviatoric
    Kirchhoff norm relaxes to the root of
        eta^(1/n) (s - s_trial) + 2 G~ dt (s - sqrt(2/3) sy)^(1/n),
    found as the JAX package finds it, by 40 bisections of
    [sqrt(2/3) sy, s_trial]."""

    viscous_modulus: float = 1.0
    herschel_bulkley_power: float = 1.0

    def elastic_left_cauchy(self, F, inv_plastic_strain, kappa, dt=0.0):
        """(normalised be, inverse plastic strain, kappa): kappa passes
        through unchanged (the viscous model has no hardening)."""
        sqrt23 = math.sqrt(2.0 / 3.0)
        dim = F.shape[-1]
        be = mm(mm(F, inv_plastic_strain), F.transpose(-1, -2))
        nbe, iso, dev_k, dk_norm = self._trial(be)
        s_yield = sqrt23 * self.yield_stress
        trial = dk_norm - s_yield
        Gr = iso * self.shear_modulus
        inv_n = 1.0 / self.herschel_bulkley_power
        eta_pow = self.viscous_modulus ** inv_n
        lo = torch.full_like(dk_norm, s_yield)
        hi = dk_norm
        for _ in range(40):
            mid = 0.5 * (lo + hi)
            f = eta_pow * (mid - dk_norm) + 2.0 * Gr * dt * torch.clamp(
                mid - s_yield, min=0.0) ** inv_n
            neg = f < 0.0
            lo, hi = torch.where(neg, mid, lo), torch.where(neg, hi, mid)
        s_new = 0.5 * (lo + hi)
        eye = torch.eye(dim, dtype=F.dtype, device=F.device)
        dev_relaxed = (s_new / torch.clamp(dk_norm, min=1e-15)
                       )[..., None, None] * dev_k
        relaxed_be = dev_relaxed / self.shear_modulus \
            + iso[..., None, None] * eye
        nbe_new = relaxed_be * (det(relaxed_be)
                                ** (-1.0 / dim))[..., None, None]
        nbe_out = torch.where((trial > 0.0)[..., None, None], nbe_new, nbe)
        F_inv = inv(F)
        return nbe_out, mm(mm(F_inv, nbe_out), F_inv.transpose(-1, -2)), kappa
