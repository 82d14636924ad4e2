"""Launcher of the fused Eq. 6 gamma-update CUDA kernel
(``csrc/rbf_rows.cu``; replaces ``repro.kernels.gamma_update``).

CUDA tensors only: the dispatch between this kernel and its plain version
(``ref.gamma_update``) is ``ops.fused_gamma_update``'s, by tensor device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, ctypes.c_float, _P, _I, _I, _P]


def gamma_update(X: torch.Tensor, sq_norms: torch.Tensor, gamma: torch.Tensor,
                 z2: torch.Tensor, coef2: torch.Tensor,
                 inv_2s2: float) -> torch.Tensor:
    """gamma + coef2[0]*K(z2[0], X) + coef2[1]*K(z2[1], X) in one pass over
    X; returns a new (N,) tensor. Any N and d (no padding needed)."""
    n, d = X.shape
    cuda.check(X, "X", (n, d))
    cuda.check(sq_norms, "sq_norms", (n,))
    cuda.check(gamma, "gamma", (n,))
    cuda.check(z2, "z2", (2, d))
    cuda.check(coef2, "coef2", (2,))
    out = torch.empty_like(gamma)
    rc = cuda.entry("gamma_update", _ARGS)(
        cuda.ptr(X), cuda.ptr(sq_norms), cuda.ptr(gamma), cuda.ptr(z2),
        cuda.ptr(coef2), float(inv_2s2), cuda.ptr(out), n, d, cuda.stream(X))
    cuda.raise_on(rc, "gamma_update")
    cuda.launches["gamma_update"] += 1
    return out
