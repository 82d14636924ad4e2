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
