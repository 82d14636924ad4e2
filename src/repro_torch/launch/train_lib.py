"""Step builders (twin of ``repro.launch.train_lib``), serving half: the
prefill step and the greedy decode step. The training half (loss, train
step, shardings) comes with the training slice. PyTorch runs eagerly, so
each builder returns a plain function (the reference returns what it
jit-compiles)."""
from __future__ import annotations

import torch

from repro_torch.models.api import ModelConfig, build


def make_prefill_step(cfg: ModelConfig):
    """Prefill: forward over the prompt; returns the last position's greedy
    next token (B,). Given an empty cache (``init_cache``), the same pass
    also fills it (the prompt's K / V; the recurrent families' end
    states), so decoding goes on from position L (the reference's step
    leaves the cache to the caller)."""
    model = build(cfg)

    def prefill_step(params: dict, batch: dict,
                     cache: "dict | None" = None) -> torch.Tensor:
        logits, _ = model.forward(params, cfg, batch, cache=cache)
        return torch.argmax(logits[:, -1, :], dim=-1)

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One greedy decode step against the cache: (next token (B,), cache)."""
    model = build(cfg)

    def serve_step(params: dict, cache: dict, batch: dict) -> tuple:
        logits, cache = model.decode(params, cfg, cache, batch)
        return torch.argmax(logits[:, -1, :], dim=-1), cache

    return serve_step
