"""Public kernel wrappers (twin of ``repro.kernels.ops``): dense and
block-ELL.

Dispatch is by the device of the tensors given: a CPU tensor runs the
plain PyTorch version (``ref``), a CUDA tensor launches the hand-written
kernel — and a launch that fails raises; nothing falls back. Non-RBF
kernels use the plain rows (the CUDA kernels are RBF-only), as in the
reference. Unlike the TPU wrappers there is no padding of N or d to a
block grid (``_pad_cols``) and no block picking for VMEM: the CUDA kernels
mask their ragged edges themselves.
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


# -- block-ELL storage (twin of ``repro.kernels.ops`` ELL wrappers) --------

def ell_kernel_row(vals: torch.Tensor, cols: torch.Tensor,
                   sq_norms: torch.Tensor, z: torch.Tensor,
                   inv_2s2: float) -> torch.Tensor:
    """(N,) RBF row over ELL rows; the CUDA kernel on the card."""
    if vals.device.type == "cpu":
        return ref.ell_kernel_row(vals, cols, sq_norms, z, inv_2s2)
    from repro_torch.kernels import sparse_ell
    return sparse_ell.ell_kernel_row(vals, cols, sq_norms, z, inv_2s2)


def ell_kernel_rows2(vals: torch.Tensor, cols: torch.Tensor,
                     sq_norms: torch.Tensor, z2: torch.Tensor,
                     inv_2s2: float) -> torch.Tensor:
    """(N, 2) RBF rows over ELL rows; the CUDA kernel on the card."""
    if vals.device.type == "cpu":
        return ref.ell_kernel_rows2(vals, cols, sq_norms, z2, inv_2s2)
    from repro_torch.kernels import sparse_ell
    return sparse_ell.ell_kernel_rows2(vals, cols, sq_norms, z2, inv_2s2)


def ell_fused_gamma_update(kernel: str, vals: torch.Tensor,
                           cols: torch.Tensor, sq_norms: torch.Tensor,
                           gamma: torch.Tensor, z2: torch.Tensor,
                           coef2: torch.Tensor,
                           inv_2s2: float) -> torch.Tensor:
    """Fused Eq. 6 on ELL storage, one pass over (vals, cols) on the card;
    non-RBF kernels use the plain rows, as in the reference."""
    if kernel != "rbf":
        from repro_torch.core import kernel_fns
        rows = kernel_fns.get_ell_rows2(kernel)(vals, cols, sq_norms, z2,
                                                inv_2s2)
        return gamma + rows @ coef2
    if vals.device.type == "cpu":
        return ref.ell_gamma_update(vals, cols, sq_norms, gamma, z2, coef2,
                                    inv_2s2)
    from repro_torch.kernels import sparse_ell
    return sparse_ell.ell_gamma_update(vals, cols, sq_norms, gamma, z2,
                                       coef2, inv_2s2)


def ell_rbf_accumulate(vals: torch.Tensor, cols: torch.Tensor,
                       sq_norms: torch.Tensor, coef: torch.Tensor,
                       Z: torch.Tensor, inv_2s2: float) -> torch.Tensor:
    """(B,) fused decision partials over ELL SVs."""
    if vals.device.type == "cpu":
        return ref.ell_rbf_accumulate(vals, cols, sq_norms, coef, Z, inv_2s2)
    from repro_torch.kernels import rbf_row
    return rbf_row.ell_rbf_accumulate(vals, cols, sq_norms, coef, Z, inv_2s2)
