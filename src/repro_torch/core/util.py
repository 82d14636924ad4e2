"""Small shared numeric utilities (twin of ``repro.core.util``).

Power-of-two bucketing keeps buffer/block shapes to O(log N) distinct
sizes. The ``*_device`` twins evaluate the same rules on int tensors inside
the fused epoch runner (the compaction predicate ``need_compact``) without
a host sync; they must agree with the host functions on every int32 input,
or a fused epoch stops at a different boundary than the one-segment oracle.
"""
from __future__ import annotations

import torch


def next_pow2(n: int) -> int:
    """Smallest power of two >= ``n`` (1 for n <= 1)."""
    return 1 << max(0, int(n) - 1).bit_length()


def bucket_pow2(n: int, lo: int, hi: int = 1 << 30) -> int:
    """Power-of-two bucket of ``n`` clamped to [``lo``, ``hi``]; ``n <= 0``
    returns ``lo``. The clamp applies after rounding."""
    if n <= 0:
        return lo
    return min(max(lo, next_pow2(n)), hi)


def next_pow2_device(n: torch.Tensor) -> torch.Tensor:
    """Tensor twin of :func:`next_pow2` (bit-smear cascade — exact integer
    arithmetic). Valid for n < 2**30."""
    v = torch.clamp(n.to(torch.int64), min=1) - 1
    for sh in (1, 2, 4, 8, 16):
        v = v | (v >> sh)
    return v + 1


def bucket_pow2_device(n: torch.Tensor, lo: "int | torch.Tensor",
                       hi: int = 1 << 30) -> torch.Tensor:
    """Tensor twin of :func:`bucket_pow2`; same clamp semantics."""
    p2 = next_pow2_device(n)
    lo_t = torch.as_tensor(lo, dtype=torch.int64, device=p2.device)
    return torch.where(n <= 0, lo_t,
                       torch.clamp(torch.maximum(lo_t, p2), max=hi))
