"""Decoder-only transformer of the dense / VLM / audio archs (twin of
``repro.models.transformer``): GQA + RoPE + RMSNorm + SwiGLU, optional
QKV bias (qwen), optional stub frontend (precomputed embeddings instead of
a token lookup). Mixture-of-experts layers come with a later slice
(``api.build`` refuses MoE configs).

The parameter tree is the reference's: per-layer weights stacked on a
leading ``n_layers`` axis under ``layers``, plus ``ln_f``, ``unembed`` and
(tokens frontend) ``embed``. Layers run in a Python loop. Two differences
from the reference, neither changing the function:

* K and V are projected to the Hkv kv heads and the attention's GQA index
  shares them among query heads; the reference repeats ``wk`` / ``wv`` to
  H heads first, only so that GSPMD can shard heads (a quarter of the K/V
  bytes here at llama3-8b's 32 / 8 heads).
* ``decode`` writes the KV cache in place (the reference re-stacks it
  every step) and attends over the ``pos + 1`` filled rows rather than
  masking the rest (masked rows add exactly 0 there). ``forward`` can fill
  the cache for the prompt in the same pass (``cache=``), which is how the
  serving path prefills.
"""
from __future__ import annotations

import torch

from repro_torch.models import common
from repro_torch.models.api import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ----------------------------------------------------------------- params
def init(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Random parameters in ``cfg.dtype`` (the reference's scales), drawn
    from ``generator`` one layer at a time (a full-width stacked weight is
    never materialised in fp32), on the generator's device."""
    d, hd, H, Hkv, ff = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads, \
        cfg.d_ff
    dt = dtype_of(cfg)
    dev = generator.device
    n = cfg.n_layers
    normal = {  # name -> (per-layer shape, scale)
        "wq": ((d, H, hd), d ** -0.5),
        "wk": ((d, Hkv, hd), d ** -0.5),
        "wv": ((d, Hkv, hd), d ** -0.5),
        "wo": ((H, hd, d), (H * hd) ** -0.5),
        "w_gate": ((d, ff), d ** -0.5),
        "w_up": ((d, ff), d ** -0.5),
        "w_down": ((ff, d), ff ** -0.5),
    }
    layers = {"ln1": torch.ones((n, d), dtype=dt, device=dev),
              "ln2": torch.ones((n, d), dtype=dt, device=dev)}
    for name, (shape, _) in normal.items():
        layers[name] = torch.empty((n, *shape), dtype=dt, device=dev)
    for i in range(n):
        for name, (shape, scale) in normal.items():
            layers[name][i] = common._normal(generator, shape, dt, scale)
    if cfg.qkv_bias:
        layers["bq"] = torch.zeros((n, H, hd), dtype=dt, device=dev)
        layers["bk"] = torch.zeros((n, Hkv, hd), dtype=dt, device=dev)
        layers["bv"] = torch.zeros((n, Hkv, hd), dtype=dt, device=dev)
    p = {"layers": layers,
         "ln_f": torch.ones((d,), dtype=dt, device=dev),
         "unembed": common._normal(generator, (d, cfg.vocab_size), dt,
                                   d ** -0.5)}
    if cfg.frontend == "tokens":
        p["embed"] = common._normal(generator, (cfg.vocab_size, d), dt, 1.0)
    return p


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s weights (views into the stacked tree)."""
    return {k: w[i] for k, w in params["layers"].items()}


# ------------------------------------------------------------------ layer
def _qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, positions):
    q = torch.einsum("bld,dhk->blhk", x, p["wq"])
    kk = torch.einsum("bld,dhk->blhk", x, p["wk"])
    v = torch.einsum("bld,dhk->blhk", x, p["wv"])
    if cfg.qkv_bias:
        q, kk, v = q + p["bq"], kk + p["bk"], v + p["bv"]
    q = common.apply_rope(q, positions, cfg.rope_theta)
    kk = common.apply_rope(kk, positions, cfg.rope_theta)
    return q, kk, v


def _ffn(p: dict, h: torch.Tensor) -> torch.Tensor:
    x = common.rms_norm(h, p["ln2"])
    return h + common.swiglu(x, p["w_gate"], p["w_up"], p["w_down"])


def _layer(cfg: ModelConfig, p: dict, h: torch.Tensor,
           positions: torch.Tensor, kv_out=None) -> torch.Tensor:
    x = common.rms_norm(h, p["ln1"])
    q, kk, v = _qkv(cfg, p, x, positions)
    if kv_out is not None:                       # prefill fills the cache
        kc, vc = kv_out
        kc[:, : kk.shape[1]] = kk
        vc[:, : v.shape[1]] = v
    attn = common.attention(q, kk, v, causal=True)
    h = h + torch.einsum("blhk,hkd->bld", attn, p["wo"])
    return _ffn(p, h)


def _embed_in(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    if cfg.frontend == "tokens":
        return params["embed"][batch["tokens"].long()]
    return batch["embeds"].to(dtype_of(cfg))


def _logits(params: dict, h: torch.Tensor) -> torch.Tensor:
    h = common.rms_norm(h, params["ln_f"])
    return torch.einsum("bld,dv->blv", h, params["unembed"])


def forward(params: dict, cfg: ModelConfig, batch: dict,
            cache: "dict | None" = None) -> tuple:
    """batch: {'tokens': (B, L)} or {'embeds': (B, L, d)}. Returns
    (logits (B, L, V), aux_loss 0-d tensor: 0 for dense layers). With
    ``cache`` (from ``init_cache``, position 0), each layer's K / V are
    also written to its first L rows and the cache's position becomes L."""
    h = _embed_in(params, cfg, batch)
    L = h.shape[1]
    positions = torch.arange(L, dtype=torch.int32, device=h.device)[None]
    if cache is not None:
        if cache["pos"] != 0 or cache["k"].shape[2] < L:
            raise ValueError(f"prefill needs an empty cache of >= {L} rows, "
                             f"got pos {cache['pos']} of "
                             f"{cache['k'].shape[2]}")
    for i in range(cfg.n_layers):
        kv = None if cache is None else (cache["k"][i], cache["v"][i])
        h = _layer(cfg, layer_params(params, i), h, positions, kv)
    if cache is not None:
        cache["pos"] = L
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return _logits(params, h), aux


# ----------------------------------------------------------------- decode
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: "torch.device | str" = "cuda") -> dict:
    """KV cache (n_layers, B, max_len, Hkv, hd) in ``cfg.dtype``; ``pos``
    (a Python int) is the number of rows filled."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    dt = dtype_of(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "pos": 0}


def _decode_attention(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                      pos: int) -> torch.Tensor:
    """q: (B, 1, H, hd); kc/vc: (B, L, Hkv, hd); keys > pos do not count
    (the rows past ``pos`` are not read). Cache operands, products
    accumulated in fp32 (upcast, exact), probabilities rounded to the
    cache's type before the second product, as in the reference."""
    B, _, Hkv, hd = kc.shape
    H = q.shape[2]
    g = H // Hkv
    qg = q.reshape(B, 1, Hkv, g, hd)
    k, v = kc[:, : pos + 1], vc[:, : pos + 1]
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    logits = logits * hd ** -0.5
    pr = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", pr.to(vc.dtype).float(),
                       v.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def _decode_layer(cfg: ModelConfig, p: dict, kc: torch.Tensor,
                  vc: torch.Tensor, h: torch.Tensor, pos: int) -> torch.Tensor:
    x = common.rms_norm(h, p["ln1"])
    posv = torch.full((1, 1), pos, dtype=torch.int32, device=h.device)
    q, kk, v = _qkv(cfg, p, x, posv)
    kc[:, pos] = kk[:, 0]                          # in place
    vc[:, pos] = v[:, 0]
    attn = _decode_attention(q, kc, vc, pos)
    h = h + torch.einsum("blhk,hkd->bld", attn, p["wo"])
    return _ffn(p, h)


def decode(params: dict, cfg: ModelConfig, cache: dict, batch: dict):
    """One decode step. batch: {'tokens': (B, 1)} or {'embeds': (B, 1, d)}.
    Returns (logits (B, 1, V), cache): the same K / V tensors, written in
    place at row ``pos``, with ``pos + 1``."""
    h = _embed_in(params, cfg, batch)
    pos = cache["pos"]
    if pos >= cache["k"].shape[2]:
        raise ValueError(f"KV cache full ({pos} rows)")
    for i in range(cfg.n_layers):
        h = _decode_layer(cfg, layer_params(params, i), cache["k"][i],
                          cache["v"][i], h, pos)
    return _logits(params, h), {"k": cache["k"], "v": cache["v"],
                                "pos": pos + 1}
