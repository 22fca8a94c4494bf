"""Batched small SPD inverse (port of booster_gym_tpu/physics/linalg.py).

Same algorithm as the JAX package: Cholesky with a reciprocal square root
per pivot, forward substitution for L^-1, then M^-1 = L^-T L^-1.  The
recurrences run over columns with the batch and the remaining rows
vectorized.
"""

import torch


def spd_inverse(M):
    """Inverse of a batched SPD matrix M [B, n, n]."""
    n = M.shape[-1]
    L = torch.zeros_like(M)
    inv_diag = []
    for i in range(n):
        s = M[:, i, i] - torch.sum(L[:, i, :i] * L[:, i, :i], dim=-1)
        d = torch.rsqrt(s)
        inv_diag.append(d)
        if i + 1 < n:
            t = M[:, i + 1:, i] - torch.einsum("bjk,bk->bj", L[:, i + 1:, :i], L[:, i, :i])
            L[:, i + 1:, i] = t * d[:, None]
    # rows of L^-1 by forward substitution: Linv[j] = (e_j - L[j,:j] Linv[:j]) / L_jj
    Linv = torch.zeros_like(M)
    for j in range(n):
        row = -torch.einsum("bk,bki->bi", L[:, j, :j], Linv[:, :j, :])
        row[:, j] = row[:, j] + 1.0
        Linv[:, j, :] = row * inv_diag[j][:, None]
    return Linv.transpose(1, 2) @ Linv
