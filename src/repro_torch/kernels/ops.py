"""Public kernel wrappers of the dense path (twin of ``repro.kernels.ops``).

Dispatch is by the device of the tensors given: a CPU tensor runs the
plain PyTorch version (``ref``), a CUDA tensor launches the hand-written
kernel — and a launch that fails raises; nothing falls back. Non-RBF
kernels use the plain rows (the CUDA kernels are RBF-only), as in the
reference. Unlike the TPU wrappers there is no padding of N or d to a
block grid: the CUDA kernels mask their ragged edges themselves.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref


def kernel_rows2(kernel: str, X: torch.Tensor, sq_norms: torch.Tensor,
                 z2: torch.Tensor, inv_2s2: float) -> torch.Tensor:
    """(N, 2) kernel rows; the CUDA kernel for RBF on the card."""
    if kernel != "rbf":
        from repro_torch.core import kernel_fns
        return kernel_fns.get_rows2(kernel)(X, sq_norms, z2, inv_2s2)
    if X.device.type == "cpu":
        return ref.kernel_rows2(X, sq_norms, z2, inv_2s2)
    from repro_torch.kernels import rbf_row
    return rbf_row.rbf_rows2(X, sq_norms, z2, inv_2s2)


def fused_gamma_update(kernel: str, X: torch.Tensor, sq_norms: torch.Tensor,
                       gamma: torch.Tensor, z2: torch.Tensor,
                       coef2: torch.Tensor, inv_2s2: float) -> torch.Tensor:
    """gamma + coef2[0]*K(z_up, X) + coef2[1]*K(z_low, X), one pass over X
    on the card."""
    if kernel != "rbf":
        from repro_torch.core import kernel_fns
        rows = kernel_fns.get_rows2(kernel)(X, sq_norms, z2, inv_2s2)
        return gamma + rows @ coef2
    if X.device.type == "cpu":
        return ref.gamma_update(X, sq_norms, gamma, z2, coef2, inv_2s2)
    from repro_torch.kernels import gamma_update
    return gamma_update.gamma_update(X, sq_norms, gamma, z2, coef2, inv_2s2)


def gamma_from_rows(gamma: torch.Tensor, rows: torch.Tensor,
                    coef2: torch.Tensor) -> torch.Tensor:
    """Eq. 6 epilogue from already-produced rows: gamma + rows @ coef2.
    A plain expression on purpose, as in the reference: the (M, 2) rows are
    already in memory and a kernel would only add a launch."""
    return gamma + rows @ coef2


def rbf_accumulate(X: torch.Tensor, sq_norms: torch.Tensor,
                   coef: torch.Tensor, Z: torch.Tensor,
                   inv_2s2: float) -> torch.Tensor:
    """(B,) fused decision partials sum_i coef[i]*K(Z_j, X_i)."""
    if X.device.type == "cpu":
        return ref.rbf_accumulate(X, sq_norms, coef, Z, inv_2s2)
    from repro_torch.kernels import rbf_row
    return rbf_row.rbf_accumulate(X, sq_norms, coef, Z, inv_2s2)
