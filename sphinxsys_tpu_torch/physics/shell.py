"""Thin-structure (shell) dynamics (counterpart of
sphinxsys_tpu/physics/shell.py; reference particle_dynamics/
solid_dynamics/thin_structure_dynamics.{h,cpp}).  It holds, so far, the
linear Cauchy stress of the Almansi strain that the slender bar
(physics/bar.py) integrates over its cross-section; the shell family of
ROADMAP A item 4 extends this module with the shell's own state, stress
relaxation and contact."""

from __future__ import annotations

import torch


def _stress_cauchy_linear(almansi, lambda0, G0):
    """sigma = lambda0 tr(eps) I + 2 G0 eps of (..., d, d) Almansi strains."""
    eye = torch.eye(almansi.shape[-1], dtype=almansi.dtype,
                    device=almansi.device)
    tr = torch.diagonal(almansi, dim1=-2, dim2=-1).sum(-1)
    return lambda0 * tr[..., None, None] * eye + 2.0 * G0 * almansi
