"""Gradient compression for cross-pod data parallelism (twin of
``repro.optim.compress``; DESIGN.md §6).

Two codecs for the DP all-reduce:

  bf16   gradients rounded to bf16 before the reduction.
  int8   per-tensor max-abs scaling with error feedback (the residual is
         carried beside the optimizer state). Targets the pod axis: 4x
         fewer bytes than fp32, 2x fewer than bf16.

``launch.train_lib.make_train_step(..., grad_compress=)`` applies the
codecs per pod on a mesh with a 'pod' axis, as the reference's step does.
:func:`psum_compressed` is the reference's all-reduce over one group (the
reference calls it nowhere; it is ported with its own test).
"""
from __future__ import annotations

import torch

from repro_torch.launch import dist


def quantize_int8(x: torch.Tensor) -> tuple:
    """Returns (q int8, scale fp32 0-d). Symmetric per-tensor;
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def psum_compressed(grads: list, group=None, method: "str | None" = "int8",
                    residuals: "list | None" = None) -> tuple:
    """All-reduce a list of gradients over ``group`` with compression.
    Returns (mean grads, new residuals).

    int8 uses error feedback: e' = g + e - dequant(quant(g + e)); the
    residual is added before quantization next step, making the compression
    unbiased over time (Karimireddy et al., 2019). The reduction runs on
    the dequantized values in bf16 (an int8 sum would overflow), as in the
    reference."""
    n = dist.world(group)
    if method == "bf16":
        return [dist.all_reduce(g.to(torch.bfloat16), "sum", group).float()
                / n for g in grads], residuals
    if method == "int8":
        if residuals is None:
            residuals = [torch.zeros(g.shape, dtype=torch.float32,
                                     device=g.device) for g in grads]
        red, new_e = [], []
        for g, e in zip(grads, residuals):
            x = g.float() + e
            deq = dequantize_int8(*quantize_int8(x))
            new_e.append(x - deq)
            red.append(dist.all_reduce(deq.to(torch.bfloat16), "sum",
                                       group).float() / n)
        return red, new_e
    if method is not None:
        raise ValueError(f"unknown gradient codec {method!r}")
    return [dist.all_reduce(g, "sum", group) / n for g in grads], residuals
