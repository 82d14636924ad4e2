"""Device resolution for the port's entry points.

Every entry point takes ``device=`` (default ``"cuda"``). A CUDA request on
a machine without a card raises — the port never falls back to the CPU
silently; the tests ask for ``device="cpu"`` explicitly.
"""
from __future__ import annotations

import torch


def resolve(device: "str | torch.device | None" = "cuda") -> torch.device:
    """The torch device for ``device`` (None means ``"cuda"``).

    Also pins fp32 matmuls and convolutions to full precision: the RBF
    distance ``|x|^2 - 2<x,z> + |z|^2`` cancels badly for nearby points,
    and TF32's ~10-bit mantissa would break the fp32 kernel-vs-oracle and
    port-vs-reference contracts (rtol 1e-5 on kernel rows).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (want cuda or cpu)")
    return dev
