"""The assigned input-shape set (twin of ``repro.configs.shapes``): one
per arch x shape dry-run cell.

``decode_*`` / ``long_*`` price serve_step (one token against a seq_len
KV cache/state), not train_step. ``long_500k`` requires sub-quadratic
sequence mixing and is only applicable to the SSM/hybrid archs (DESIGN.md
§5).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.api import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {s.name: s for s in [
    ShapeSpec("train_4k", "train", 4096, 256),
    ShapeSpec("prefill_32k", "prefill", 32768, 32),
    ShapeSpec("decode_32k", "decode", 32768, 128),
    ShapeSpec("long_500k", "decode", 524288, 1),
]}


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason-if-skipped)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention arch: 500k dense KV decode is "
                       "quadratic-regime; skipped per DESIGN.md §5")
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Stand-ins for every model input on the ``meta`` device: the
    reference's ``ShapeDtypeStruct`` shapes and dtypes, no allocation."""
    B, L = shape.global_batch, shape.seq_len
    meta = lambda s, t: torch.empty(s, dtype=t, device="meta")
    i32, act = torch.int32, _DTYPES[cfg.dtype]
    if shape.kind == "decode":
        L = 1      # one new token; the cache comes from init_cache on meta
    out = ({"embeds": meta((B, L, cfg.d_model), act)}
           if cfg.frontend == "embeds" else {"tokens": meta((B, L), i32)})
    if shape.kind == "train":
        out["targets"] = meta((B, L), i32)
    return out
