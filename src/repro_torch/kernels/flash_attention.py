"""Launcher of the flash-attention forward CUDA kernel
(``csrc/flash_attention.cu``; replaces ``repro.kernels.flash_attention``).

CUDA tensors only: the dispatch between this kernel and its plain version
(``ref.flash_attention``) is ``ops.flash_attention``'s, by tensor device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]
HEAD_DIMS = (16, 32, 64, 128)    # the kernel's Dh instances


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Attention of q (B, H, Lq, Dh) over k / v (B, Hkv, Lk, Dh), all fp32
    or all bf16, contiguous, on the card; returns a new (B, H, Lq, Dh)
    tensor of q's type. bf16 runs on the tensor cores (wgmma, K / V by
    TMA; operands 16-byte aligned), fp32 on FMAs. Any Lq, Lk (ragged edges
    masked in the kernel); Dh in ``HEAD_DIMS``. The causal mask is the TPU
    kernel's row >= col; ``ops.flash_attention`` refuses causal calls with
    Lq != Lk."""
    if not isinstance(q, torch.Tensor) or q.dim() != 4:
        raise ValueError(f"q: expected a (B, H, Lq, Dh) tensor, got "
                         f"{tuple(getattr(q, 'shape', ()))}")
    B, H, Lq, Dh = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q: expected float32 or bfloat16, got {q.dtype}")
    if k.dim() != 4:
        raise ValueError(f"k: expected a (B, Hkv, Lk, Dh) tensor, got "
                         f"{tuple(k.shape)}")
    Hkv, Lk = k.shape[1], k.shape[2]
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head dim {Dh} not supported (kernel instances: "
                         f"{HEAD_DIMS})")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"{H} query heads are not a multiple of {Hkv} kv "
                         "heads")
    cuda.check(q, "q", (B, H, Lq, Dh), q.dtype)
    cuda.check(k, "k", (B, Hkv, Lk, Dh), q.dtype)
    cuda.check(v, "v", (B, Hkv, Lk, Dh), q.dtype)
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("bf16 q, k, v must start 16-byte aligned (the "
                         "kernel reads them by TMA)")
    out = torch.empty_like(q)
    rc = cuda.entry("flash_attention", _ARGS)(
        cuda.ptr(q), cuda.ptr(k), cuda.ptr(v), cuda.ptr(out), B, H, Hkv, Lq,
        Lk, Dh, int(causal), int(q.dtype == torch.bfloat16), cuda.stream(q))
    cuda.raise_on(rc, "flash_attention")
    cuda.launches["flash_attention"] += 1
    return out
