"""bf16 storage of support-vector values, without ``ml_dtypes``.

The reference stores bf16 SVs as ``ml_dtypes.bfloat16`` numpy arrays; the
port holds them as host ``torch.bfloat16`` tensors, and reads a reference
array through its ``uint16`` view (its dtype is recognised by name, so
nothing here imports ``ml_dtypes``). Rounding is to nearest even, as
``ml_dtypes`` rounds, so both packages store the same bits. A bf16 value
is the top half of an fp32 one: widening is exact.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["is_bf16", "round_bf16", "widen", "bits", "storage_dtype"]


def is_bf16(a) -> bool:
    """Whether ``a`` holds bf16 values (a ``torch.bfloat16`` tensor or an
    ``ml_dtypes.bfloat16`` array)."""
    if isinstance(a, torch.Tensor):
        return a.dtype == torch.bfloat16
    return getattr(getattr(a, "dtype", None), "name", None) == "bfloat16"


def round_bf16(a) -> torch.Tensor:
    """The bf16 values of ``a`` as a contiguous host ``torch.bfloat16``
    tensor: fp32 values round to nearest even; bf16 values keep their
    bits."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu").to(torch.bfloat16).contiguous()
    a = np.ascontiguousarray(a)
    if is_bf16(a):
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def widen(a) -> np.ndarray:
    """fp32 numpy values of stored SVs: bf16 storage widened exactly, fp32
    as it is."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().float().numpy()
    a = np.asarray(a)
    if is_bf16(a):
        u = np.ascontiguousarray(a).view(np.uint16).astype(np.uint32)
        return (u << 16).view(np.float32)
    return np.asarray(a, np.float32)


def bits(a) -> np.ndarray:
    """The ``uint16`` bit patterns of bf16 storage (either kind)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().contiguous().view(torch.int16).numpy() \
            .view(np.uint16)
    return np.ascontiguousarray(a).view(np.uint16)


def storage_dtype(dtype: "str | None", stored=None) -> str:
    """The SV storage type a request names: ``'float32'`` or
    ``'bfloat16'``; ``None`` takes the type of ``stored``."""
    if dtype is None:
        return "bfloat16" if is_bf16(stored) else "float32"
    if dtype in ("bf16", "bfloat16"):
        return "bfloat16"
    if dtype in ("float32", "fp32", "f32"):
        return "float32"
    raise ValueError(f"unsupported SV storage dtype {dtype!r}")
