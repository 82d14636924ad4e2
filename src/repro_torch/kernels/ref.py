"""Plain PyTorch versions of the hand-written kernels (twin of
``repro.kernels.ref``).

Each function states the semantics its CUDA kernel must reproduce. The
kernel wrappers run these on CPU tensors (the CPU tests), ``chip_smoke.py``
holds each kernel against them on the card, and nothing on the main path
calls them when a card is present.
"""
from __future__ import annotations

import torch


def kernel_rows2(X: torch.Tensor, sq_norms: torch.Tensor, z2: torch.Tensor,
                 inv_2s2: float) -> torch.Tensor:
    """RBF rows for two query points: out[i, j] = K(z2[j], X[i]). (N, 2)."""
    prods = X @ z2.T
    zn = torch.sum(z2 * z2, dim=-1)
    d2 = sq_norms[:, None] - 2.0 * prods + zn[None, :]
    return torch.exp(-torch.clamp(d2, min=0.0) * inv_2s2)


def gamma_update(X: torch.Tensor, sq_norms: torch.Tensor, gamma: torch.Tensor,
                 z2: torch.Tensor, coef2: torch.Tensor,
                 inv_2s2: float) -> torch.Tensor:
    """Fused Eq. 6: gamma + coef2[0]*K(z_up, X) + coef2[1]*K(z_low, X)."""
    k = kernel_rows2(X, sq_norms, z2, inv_2s2)
    return gamma + k @ coef2


def rbf_accumulate(X: torch.Tensor, sq_norms: torch.Tensor,
                   coef: torch.Tensor, Z: torch.Tensor,
                   inv_2s2: float) -> torch.Tensor:
    """Serve-time decision sum: out[j] = sum_i coef[i] * K(Z[j], X[i]).

    Kernel values in fp32, the contraction over the M support vectors in
    fp64 (as the CUDA kernel does): a decision value is a sum of M signed
    terms that mostly cancel, and an fp32 contraction of the full-size
    a9a model (17,063 SVs) is off by ~1e-3 of max |score|. Materializes the
    (B, M) kernel matrix, which the kernel never does. Padding SV rows
    carry coef 0, so they contribute exactly 0.
    """
    qn = torch.sum(Z * Z, dim=-1)
    d2 = qn[:, None] - 2.0 * (Z @ X.T) + sq_norms[None, :]
    k = torch.exp(-torch.clamp(d2, min=0.0) * inv_2s2)
    return (k.double() @ coef.double()).float()


# -- block-ELL storage: vals/cols (N, K) padded with (0.0, 0) slots --------

def ell_dots(vals: torch.Tensor, cols: torch.Tensor,
             Z: torch.Tensor) -> torch.Tensor:
    """<x_i, Z_j> for ELL rows x_i and dense queries Z (q, d) -> (q, N).

    Batch-major (gather per query, reduce over K) so every query runs the
    same reduction over the same shapes: the columns of a two-query call
    are position-symmetric, as ``ell_kernel_rows2`` requires. Padding
    slots add exactly 0."""
    zg = Z[:, cols.to(torch.int64)]                   # (q, N, K)
    return torch.sum(vals[None, :, :] * zg, dim=-1)


def ell_kernel_row(vals: torch.Tensor, cols: torch.Tensor,
                   sq_norms: torch.Tensor, z: torch.Tensor,
                   inv_2s2: float) -> torch.Tensor:
    """RBF row K(z, x_i) over ELL rows: exp(-(|x_i|^2 - 2<x_i, z> + |z|^2)
    * inv_2s2), distance clamped at 0. (N,)."""
    dots = ell_dots(vals, cols, z[None, :])[0]
    d2 = sq_norms - 2.0 * dots + torch.dot(z, z)
    return torch.exp(-torch.clamp(d2, min=0.0) * inv_2s2)


def ell_kernel_rows2(vals: torch.Tensor, cols: torch.Tensor,
                     sq_norms: torch.Tensor, z2: torch.Tensor,
                     inv_2s2: float) -> torch.Tensor:
    """RBF rows for two queries over ELL rows: out[i, j] = K(z2[j], x_i).
    (N, 2), columns position-symmetric."""
    dots = ell_dots(vals, cols, z2).T                 # (N, 2)
    zn = torch.sum(z2 * z2, dim=-1)
    d2 = sq_norms[:, None] - 2.0 * dots + zn[None, :]
    return torch.exp(-torch.clamp(d2, min=0.0) * inv_2s2)


def ell_gamma_update(vals: torch.Tensor, cols: torch.Tensor,
                     sq_norms: torch.Tensor, gamma: torch.Tensor,
                     z2: torch.Tensor, coef2: torch.Tensor,
                     inv_2s2: float) -> torch.Tensor:
    """Fused Eq. 6 on ELL storage: gamma + coef2[0]*K(z_up, x_i) +
    coef2[1]*K(z_low, x_i). Padding rows carry gamma = +inf and keep it."""
    k = ell_kernel_rows2(vals, cols, sq_norms, z2, inv_2s2)
    return gamma + k @ coef2


def ell_rbf_accumulate(vals: torch.Tensor, cols: torch.Tensor,
                       sq_norms: torch.Tensor, coef: torch.Tensor,
                       Z: torch.Tensor, inv_2s2: float,
                       max_gather: int = 1 << 24) -> torch.Tensor:
    """Serve-time decision sum over ELL support vectors: out[j] =
    sum_i coef[i] * K(Z[j], x_i). (B,).

    Kernel values in fp32, the contraction in fp64 (as
    :func:`rbf_accumulate` and the CUDA kernel). The (B, M, K) gather is
    taken in SV blocks of at most ``max_gather`` elements; the block
    partials add in fp64. Padding SV rows carry coef 0 and add exactly 0.
    """
    B = Z.shape[0]
    M, K = vals.shape
    qn = torch.sum(Z * Z, dim=-1)
    out = torch.zeros((B,), dtype=torch.float64, device=Z.device)
    blk = max(1, min(max(M, 1), max_gather // max(B * K, 1)))
    for s in range(0, M, blk):
        dots = ell_dots(vals[s: s + blk], cols[s: s + blk], Z)    # (B, blk)
        d2 = qn[:, None] - 2.0 * dots + sq_norms[None, s: s + blk]
        k = torch.exp(-torch.clamp(d2, min=0.0) * inv_2s2)
        out += k.double() @ coef[s: s + blk].double()
    return out.float()
