"""Resolution policy (counterpart of sphinxsys_tpu/core/adaptation.py):
h/dx = 1.3, Wendland C2 with cutoff 2h (reference adaptation.h:71,
adaptation.cpp:16) unless `kernel_cls` names another kernel."""

from __future__ import annotations

import dataclasses

from sphinxsys_tpu_torch.core import kernels as K


@dataclasses.dataclass(frozen=True)
class SPHAdaptation:
    spacing: float
    dim: int
    h_spacing_ratio: float = 1.3
    kernel_cls: type = K.WendlandC2

    @property
    def h(self) -> float:
        return self.h_spacing_ratio * self.spacing

    @property
    def kernel(self) -> K.SmoothingKernel:
        return self.kernel_cls(h=self.h)

    @property
    def cutoff(self) -> float:
        return self.kernel.cutoff

    @property
    def sigma0(self) -> float:
        """Reference (lattice) number density."""
        return K.lattice_number_density(self.kernel, self.spacing, self.dim)
