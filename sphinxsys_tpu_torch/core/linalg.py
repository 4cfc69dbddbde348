"""Per-particle 2x2 / 3x3 linear algebra in closed form: cofactors,
determinants, inverses, Cholesky factors and lower-triangular inverses,
and products as broadcast sums.  torch.linalg.inv / det / cholesky on
the card check an info flag and wait for the host on every call, and
cuBLAS splits million-particle batches of tiny products into many
launches; these forms launch a few elementwise kernels and read nothing
back.  At F ~ I they agree with JAX's LU forms to float64 roundoff."""

from __future__ import annotations

import torch


def cofactors(M: torch.Tensor) -> torch.Tensor:
    """Cofactor matrices of (..., d, d), d = 2 or 3: inv(M) = C^T / det(M)."""
    if M.shape[-1] == 2:
        a, b, c, d = M[..., 0, 0], M[..., 0, 1], M[..., 1, 0], M[..., 1, 1]
        return torch.stack([torch.stack([d, -c], dim=-1),
                            torch.stack([-b, a], dim=-1)], dim=-2)
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return torch.stack([
        torch.stack([e * i - f * h, f * g - d * i, d * h - e * g], dim=-1),
        torch.stack([c * h - b * i, a * i - c * g, b * g - a * h], dim=-1),
        torch.stack([b * f - c * e, c * d - a * f, a * e - b * d], dim=-1),
    ], dim=-2)


def det(M: torch.Tensor, C: torch.Tensor | None = None) -> torch.Tensor:
    """det(M) from its cofactors (expansion along the first row)."""
    C = cofactors(M) if C is None else C
    out = M[..., 0, 0] * C[..., 0, 0]
    for k in range(1, M.shape[-1]):
        out = out + M[..., 0, k] * C[..., 0, k]
    return out


def inv(M: torch.Tensor) -> torch.Tensor:
    C = cofactors(M)
    return C.transpose(-1, -2) / det(M, C)[..., None, None]


def cholesky(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of symmetric positive-definite (..., d, d),
    d = 2 or 3, in closed form, from the symmetrised input as
    `jnp.linalg.cholesky` takes it:
        l11 = sqrt(a11), l21 = a21 / l11, l22 = sqrt(a22 - l21^2),
        l31 = a31 / l11, l32 = (a32 - l31 l21) / l22,
        l33 = sqrt(a33 - l31^2 - l32^2).
    torch.linalg.cholesky on the card checks its info flag, a host read
    at every call (the fish's solid sub-steps call it ~120,000 times; the
    heart's fiber rate factors every particle's D each Euler step)."""
    d = M.shape[-1]
    if d not in (2, 3):
        raise ValueError(f"cholesky: 2 x 2 or 3 x 3 only, got {d} x {d}")
    S = 0.5 * (M + M.transpose(-1, -2))
    zero = torch.zeros_like(S[..., 0, 0])
    l11 = torch.sqrt(S[..., 0, 0])
    l21 = S[..., 1, 0] / l11
    l22 = torch.sqrt(S[..., 1, 1] - l21 * l21)
    if d == 2:
        return torch.stack([torch.stack([l11, zero], dim=-1),
                            torch.stack([l21, l22], dim=-1)], dim=-2)
    l31 = S[..., 2, 0] / l11
    l32 = (S[..., 2, 1] - l31 * l21) / l22
    l33 = torch.sqrt(S[..., 2, 2] - l31 * l31 - l32 * l32)
    return torch.stack([torch.stack([l11, zero, zero], dim=-1),
                        torch.stack([l21, l22, zero], dim=-1),
                        torch.stack([l31, l32, l33], dim=-1)], dim=-2)


def lower_triangular_inverse(L: torch.Tensor) -> torch.Tensor:
    """Inverse of lower-triangular (..., d, d), d = 2 or 3, by forward
    substitution on the identity's columns (what
    `jax.scipy.linalg.solve_triangular(L, I, lower=True)` computes):
    t_kk = 1 / l_kk, t_ik = -(sum_{k<=j<i} l_ij t_jk) / l_ii."""
    d = L.shape[-1]
    if d not in (2, 3):
        raise ValueError(f"lower_triangular_inverse: 2 x 2 or 3 x 3 only, "
                         f"got {d} x {d}")
    zero = torch.zeros_like(L[..., 0, 0])
    t11 = 1.0 / L[..., 0, 0]
    t22 = 1.0 / L[..., 1, 1]
    t21 = -(L[..., 1, 0] * t11) / L[..., 1, 1]
    if d == 2:
        return torch.stack([torch.stack([t11, zero], dim=-1),
                            torch.stack([t21, t22], dim=-1)], dim=-2)
    t33 = 1.0 / L[..., 2, 2]
    t31 = -(L[..., 2, 0] * t11 + L[..., 2, 1] * t21) / L[..., 2, 2]
    t32 = -(L[..., 2, 1] * t22) / L[..., 2, 2]
    return torch.stack([torch.stack([t11, zero, zero], dim=-1),
                        torch.stack([t21, t22, zero], dim=-1),
                        torch.stack([t31, t32, t33], dim=-1)], dim=-2)


def mm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Per-particle matrix products of (..., d, d) stacks."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(dim=-2)


def mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., d, d) @ (..., d) -> (..., d)."""
    return (A * v[..., None, :]).sum(dim=-1)


def outer_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_k a_k outer b_k over the slot axis: (N, K, d) x (N, K, d) ->
    (N, d, d) (JAX's einsum "nki,nkj->nij")."""
    return (a[..., :, None] * b[..., None, :]).sum(dim=1)
