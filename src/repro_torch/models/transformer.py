"""Decoder-only transformer of the dense / MoE / VLM / audio archs (twin
of ``repro.models.transformer``): GQA + RoPE + RMSNorm + SwiGLU, optional
QKV bias (qwen), optional mixture-of-experts FFN (top-k softmax router,
capacity-bounded dispatch per sequence, both of the reference's dispatch
implementations), optional stub frontend (precomputed embeddings instead
of a token lookup).

The parameter tree is the reference's: per-layer weights stacked on a
leading ``n_layers`` axis under ``layers``, plus ``ln_f``, ``unembed`` and
(tokens frontend) ``embed``. Layers run in a Python loop.

Inside ``common.model_parallel`` (the sharded step's 'model' axis under
the tp layout) a layer gets this rank's block of the leaves that the
context names (``common.split_role``): attention by heads (``wq`` / ``wo``
over H; K and V over Hkv, or over head_dim and then gathered) or by
head_dim (q, k and v gathered, the attention whole, ``wo`` by rows of its
head_dim), the FFN by its width, the experts, and the embedding and
unembedding by vocabulary. Each split block ends in one reduce over
'model'; with nothing split, each collective is the identity and the ops
are those of the unsharded model. The FFN's reduce comes after the remat
block, so a recompute does not repeat it. A decode step does the same,
and a KV cache holds this rank's block of it (``launch.sharding``'s
``cache_specs``: its kv heads, or its slice of head_dim, whose attention
logits are partial sums over 'model', summed before the softmax; zamba2's
shared cache at a batch that does not split, its block of the positions
over the batch axes, whose softmax is combined over them).

With ``seq_parallel`` in the context (the reference's ``constrain_hidden``
with L over 'model') the residual stream between the products is this
rank's block of L: the norms run on the block, a split product's input is
gathered over L and its output reduce-scattered over L (``common.seq_in``
/ ``seq_out``); the MoE router runs on the gathered whole, as unsharded.

Inside ``common.fsdp_blocks`` (the sharded step, as the reference's GSPMD
gathers FSDP blocks inside its layer scan) ``params`` hold this rank's
blocks: a layer gathers its weights inside its remat block (again in the
recompute), ``embed`` for the lookup alone, ``ln_f`` and ``unembed`` for
the logits. Two differences from the reference, neither changing the
function:

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
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.models.api import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the stacks of per-layer weights: name -> (stacked leading dims, whether a
# layer runs under common.remat); the sharded step gathers a layer at a time
STACKS = {"layers": (1, True)}
# the cache's leaves: name -> (the dim of the batch's rows, the leaf whose
# 'model' split the cache's computation follows); the sharded serving step
# reads it
CACHE = {"k": (1, "wo"), "v": (1, "wo")}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ----------------------------------------------------------------- params
def _init_layer(cfg: ModelConfig, generator: torch.Generator):
    """One layer's (name, tensor) pairs, each drawn when it is reached (an
    MoE layer's expert weights are ~2.5 GB a layer at phi3.5-moe's
    width)."""
    d, hd, H, Hkv, ff = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads, \
        cfg.d_ff
    dt = dtype_of(cfg)
    dev = generator.device
    nrm = lambda shape, scale, t=dt: common._normal(generator, shape, t,
                                                    scale)
    yield "ln1", torch.ones((d,), dtype=dt, device=dev)
    yield "ln2", torch.ones((d,), dtype=dt, device=dev)
    yield "wq", nrm((d, H, hd), d ** -0.5)
    yield "wk", nrm((d, Hkv, hd), d ** -0.5)
    yield "wv", nrm((d, Hkv, hd), d ** -0.5)
    yield "wo", nrm((H, hd, d), (H * hd) ** -0.5)
    if cfg.is_moe:
        E = cfg.n_experts
        yield "router", nrm((d, E), d ** -0.5, torch.float32)
        yield "we_gate", nrm((E, d, ff), d ** -0.5)
        yield "we_up", nrm((E, d, ff), d ** -0.5)
        yield "we_down", nrm((E, ff, d), ff ** -0.5)
    else:
        yield "w_gate", nrm((d, ff), d ** -0.5)
        yield "w_up", nrm((d, ff), d ** -0.5)
        yield "w_down", nrm((ff, d), ff ** -0.5)
    if cfg.qkv_bias:
        yield "bq", torch.zeros((H, hd), dtype=dt, device=dev)
        yield "bk", torch.zeros((Hkv, hd), dtype=dt, device=dev)
        yield "bv", torch.zeros((Hkv, hd), dtype=dt, device=dev)


def init(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Random parameters in ``cfg.dtype`` (the reference's scales; an MoE
    layer's ``router`` in fp32, as there), drawn from ``generator`` one
    layer at a time (a full-width stacked weight is never materialised in
    fp32), on the generator's device."""
    d, dt = cfg.d_model, dtype_of(cfg)
    p = {"layers": common.stacked((cfg.n_layers,),
                                  lambda: _init_layer(cfg, generator)),
         "ln_f": torch.ones((d,), dtype=dt, device=generator.device),
         "unembed": common._normal(generator, (d, cfg.vocab_size), dt,
                                   d ** -0.5)}
    if cfg.frontend == "tokens":
        p["embed"] = common._normal(generator, (cfg.vocab_size, d), dt, 1.0)
    return p


# ------------------------------------------------------------------ layer
def _qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, positions):
    """q, k and v of x, RoPE on q and k. Inside ``common.model_parallel``
    with attention split: this rank's query heads, and its kv heads, or
    all of them where k and v are split by head_dim (:func:`_attn_kv`
    picks the ones its query heads read); a leaf split by head_dim gives
    its head_dim slice, gathered over 'model' before RoPE (which pairs the
    two halves of head_dim)."""
    x = common.seq_in(x, "wq")
    out = []
    for n in "qkv":
        t = torch.einsum("bld,dhk->blhk", x, p["w" + n])
        if cfg.qkv_bias:
            t = t + p["b" + n]
        if common.split_role("w" + n) == "head_dim":
            t = common.gather_model(t, -1)
        out.append(t)
    q, kk, v = out
    q = common.apply_rope(q, positions, cfg.rope_theta)
    kk = common.apply_rope(kk, positions, cfg.rope_theta)
    return q, kk, v


def _attn_kv(cfg: ModelConfig, q: torch.Tensor, kk: torch.Tensor,
             v: torch.Tensor) -> tuple:
    """The k and v that q's heads attend: where this rank's query heads
    are a block and k and v (split by head_dim, gathered) hold every kv
    head, the heads of their GQA groups; else k and v."""
    if common.split_role("wq") == "heads" and \
            common.split_role("wk") == "head_dim":
        return _kv_heads(cfg, kk, q.shape[2]), _kv_heads(cfg, v, q.shape[2])
    return kk, v


def _cache_part(t: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """This rank's block of ``t`` (B, L, kv heads, head_dim) as the cache
    block ``c`` (B, S, Hkv or its block, head_dim or its slice) holds it:
    where ``t`` has every kv head and ``c`` a block of them, or ``t`` the
    whole head_dim and ``c`` a slice, this rank's over 'model' (the
    blocks of ``launch.sharding.cache_specs``); else ``t``."""
    for dim in (2, 3):
        if t.shape[dim] != c.shape[dim]:
            t = common.model_block(t, dim)
    return t


def _put_rows(c: torch.Tensor, t: torch.Tensor, at: int) -> None:
    """Write ``t`` (B, n, ...) at positions ``at`` .. ``at + n - 1`` of the
    cache block ``c`` (B, S, ...) in place: where the cache's positions
    split over the batch axes (``common.seq_start``), the part of them
    that falls in this rank's block."""
    s0 = common.seq_start(c.shape[1])
    if s0 is None:
        c[:, at: at + t.shape[1]] = t
        return
    lo, hi = max(at, s0), min(at + t.shape[1], s0 + c.shape[1])
    if lo < hi:
        c[:, lo - s0: hi - s0] = t[:, lo - at: hi - at]


def _kv_heads(cfg: ModelConfig, t: torch.Tensor, h_loc: int) -> torch.Tensor:
    """The kv heads that this rank's ``h_loc`` query heads read, out of
    all Hkv of ``t`` (B, L, Hkv, hd): heads split contiguously, so they
    are the GQA groups of the rank's heads."""
    g = cfg.n_heads // cfg.n_kv_heads
    r = common.model_rank()
    lo = r * h_loc // g
    hi = ((r + 1) * h_loc - 1) // g + 1
    return t[:, :, lo:hi]


# ------------------------------------------------------------------- MoE
def _route(x: torch.Tensor, p: dict, cfg: ModelConfig) -> tuple:
    """Top-k routing and in-expert positions, shared by both dispatch
    implementations. x: (B, L, d). Capacity ``cap`` per sequence; a
    (token, slot) pair's position in its expert counts the pairs before it
    in the flattened (L·k) order (slots in descending gate order, as
    ``lax.top_k`` gives them), and the pair is kept when it is below
    ``cap``. Returns (gi, gv, pos, keep, onehot, cap, aux): the Switch
    load-balance term over the first choice, its two batch means taken
    over the whole batch on a sharded step (``common.batch_means``)."""
    B, L, _ = x.shape
    E, k = cfg.n_experts, cfg.top_k
    cap = max(1, int(cfg.capacity_factor * L * k / E))
    logits = x.float() @ p["router"]                        # (B, L, E)
    probs = torch.softmax(logits, dim=-1)
    gv, gi = torch.topk(probs, k, dim=-1, sorted=True)      # (B, L, k)
    gv = gv / torch.clamp(gv.sum(-1, keepdim=True), min=1e-9)
    onehot = F.one_hot(gi, E).float()                       # (B, L, k, E)
    flat = onehot.reshape(B, L * k, E)
    pos = torch.cumsum(flat, dim=1) - flat                  # (B, L*k, E)
    pos = (pos * flat).sum(-1).reshape(B, L, k).to(torch.int32)
    keep = pos < cap
    frac, mean_p = common.batch_means(torch.stack(
        [onehot[..., 0, :].mean(dim=(0, 1)), probs.mean(dim=(0, 1))]))
    aux = E * (frac * mean_p).sum()
    return gi, gv, pos, keep, onehot, cap, aux


def _experts(xin: torch.Tensor, p: dict) -> torch.Tensor:
    """xin: (E, B, cap, d) -> (E, B, cap, d): each expert's SwiGLU."""
    h = F.silu(torch.einsum("ebcd,edf->ebcf", xin, p["we_gate"])) \
        * torch.einsum("ebcd,edf->ebcf", xin, p["we_up"])
    return torch.einsum("ebcf,efd->ebcd", h, p["we_down"])


def _moe_ffn(x: torch.Tensor, p: dict, cfg: ModelConfig) -> tuple:
    """Capacity-bounded top-k MoE over x (B, L, d); each sequence is a
    dispatch group. ``cfg.moe_impl`` picks the reference's dispatch:
    'einsum' (GShard one-hot dispatch and combine products) or 'scatter'
    (tokens added into (B, E·cap + 1, d) slots, the last a sentinel that
    takes the dropped pairs and is sliced away, then gathered back). The
    combine runs in x's type, gates rounded to it first. Returns (y, aux).

    With the experts split over 'model' (``p['we_*']`` hold E / n of
    them) the routing is the same on every rank, each rank runs its
    experts on all the tokens, and ``y`` is this rank's partial, which
    :func:`_ffn_reduce` sums; the gates and the dispatched tokens take
    their gradients from every rank. Under ``common.seq_parallel`` ``x``
    is this rank's block of L: it is gathered first, and routed whole."""
    sp = common.seq_parallel()
    if sp:
        x = common.seq_in(x, "we_gate")
    B, L, d = x.shape
    gi, gv, pos, keep, onehot, cap, aux = _route(common.own_rows(x), p, cfg)
    E = p["we_gate"].shape[0]
    split = common.split_role("we_gate") is not None
    if split:
        gv = common.to_model(gv, "we_gate")
        x = x if sp else common.to_model(x, "we_gate")
        e0 = common.model_rank() * E

    if cfg.moe_impl == "einsum":
        kept = onehot * keep.float()[..., None]
        if split:
            kept = kept[..., e0: e0 + E]
        # one_hot of a position >= cap is all zeros, as jax.nn.one_hot's
        disp_pos = (pos[..., None].long() == torch.arange(
            cap, device=x.device)).float()                  # (B, L, k, cap)
        dmat = torch.einsum("blke,blkc->blec", kept, disp_pos).to(x.dtype)
        comb = torch.einsum("blke,blkc,blk->blec", kept, disp_pos,
                            gv).to(x.dtype)
        xin = torch.einsum("blec,bld->ebcd", dmat, x)
        out_e = _experts(xin, p)
        return torch.einsum("blec,ebcd->bld", comb, out_e), aux

    k = cfg.top_k
    if split:                               # another rank's experts: dropped
        keep = keep & (gi >= e0) & (gi < e0 + E)
        gi = gi - e0
    slot = torch.where(keep, gi * cap + pos, E * cap)       # (B, L, k)
    bidx = torch.arange(B, device=x.device)[:, None, None].expand(B, L, k)
    buf = torch.zeros((B, E * cap + 1, d), dtype=x.dtype, device=x.device)
    buf.index_put_((bidx, slot), x[:, :, None, :].expand(B, L, k, d),
                   accumulate=True)
    xin = buf[:, :-1].reshape(B, E, cap, d).permute(1, 0, 2, 3)
    out_e = _experts(xin, p)                                # (E, B, cap, d)
    out_b = torch.cat([out_e.permute(1, 0, 2, 3).reshape(B, E * cap, d),
                       torch.zeros((B, 1, d), dtype=x.dtype,
                                   device=x.device)], dim=1)  # dropped -> 0
    gathered = out_b[bidx, slot]                            # (B, L, k, d)
    return torch.einsum("blkd,blk->bld", gathered, gv.to(x.dtype)), aux


# ------------------------------------------------------------------ layer
def _block(cfg: ModelConfig, p: dict, h: torch.Tensor,
           positions: torch.Tensor, kv_out=None, unit=None) -> tuple:
    """A layer as :func:`forward` runs it under remat: (h + attention(
    norm(h)), FFN(norm(that)) before its 'model' reduce
    (:func:`_ffn_reduce`), the MoE aux term: a 0-d fp32 zero for a dense
    layer). Attention split by head_dim attends with all heads and keeps
    this rank's head_dim slice for its rows of ``wo``. Given its ``unit``
    (path and layer index), ``p`` are the layer's blocks, gathered here
    (``common.weights``), inside the remat; else its weights. Prefill
    writes this rank's block of the prompt's K / V into ``kv_out``."""
    if unit is not None:
        p = common.weights(p, *unit)
    x = common.rms_norm(h, p["ln1"])
    q, kk, v = _qkv(cfg, p, x, positions)
    if kv_out is not None:                       # prefill fills the cache
        kc, vc = kv_out
        _put_rows(kc, _cache_part(kk, kc), 0)
        _put_rows(vc, _cache_part(v, vc), 0)
    attn = common.attention(q, *_attn_kv(cfg, q, kk, v), causal=True)
    if common.split_role("wo") == "head_dim":
        attn = common.model_block(attn, 3)
    h = h + common.seq_out(torch.einsum("blhk,hkd->bld", attn, p["wo"]),
                           "wo")
    return (h,) + _ffn_out(cfg, p, h)


def _ffn_out(cfg: ModelConfig, p: dict, h: torch.Tensor) -> tuple:
    """(FFN(norm(h)), aux); an FFN split over 'model' (its width, or the
    experts) gives this rank's partial, which :func:`_ffn_reduce` sums."""
    x = common.rms_norm(h, p["ln2"])
    if cfg.is_moe:
        return _moe_ffn(x, p, cfg)
    y = common.swiglu(common.seq_in(x, "w_gate"), p["w_gate"], p["w_up"],
                      p["w_down"])
    return y, torch.zeros((), dtype=torch.float32, device=h.device)


def _ffn_reduce(cfg: ModelConfig, y: torch.Tensor) -> torch.Tensor:
    """The FFN's output out of 'model' (under seq_parallel, this rank's
    block of L of it): outside the remat block, so that a recompute does
    not repeat it."""
    return common.seq_out(y, "we_gate" if cfg.is_moe else "w_gate")


def _embed_in(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """The input embeddings: a lookup in ``embed``, gathered for it alone
    (the lookup saves no table for the backward), or the batch's
    ``embeds`` (under seq_parallel this rank's block of L of either)."""
    if cfg.frontend == "tokens":
        table = common.weights({"embed": params["embed"]})["embed"]
        return common.embed_lookup(table, batch["tokens"].long())
    return common.seq_block(batch["embeds"].to(dtype_of(cfg)))


def _logits(params: dict, h: torch.Tensor) -> torch.Tensor:
    """Logits; this rank's block of the vocabulary where ``unembed`` is
    split over 'model' (``common.cross_entropy`` takes them so). Under
    seq_parallel the norm runs on this rank's block of L, which is then
    gathered."""
    w = common.weights({k: params[k] for k in ("ln_f", "unembed")})
    h = common.rms_norm(h, w["ln_f"])
    return torch.einsum("bld,dv->blv", common.seq_in(h, "unembed"),
                        w["unembed"])


def forward(params: dict, cfg: ModelConfig, batch: dict,
            cache: "dict | None" = None) -> tuple:
    """batch: {'tokens': (B, L)} or {'embeds': (B, L, d)}. Returns
    (logits (B, L, V), aux_loss 0-d fp32 tensor: the MoE layers' aux terms
    summed, 0 for dense layers). Each layer runs under ``common.remat``
    (checkpointed when ``cfg.remat == "full"`` and autograd records), and
    gathers its weights from ``params``' blocks inside it. With
    ``cache`` (from ``init_cache``, position 0), each layer's K / V are
    also written to its first L rows and the cache's position becomes L."""
    h = _embed_in(params, cfg, batch)
    L = next(iter(batch.values())).shape[1]
    positions = torch.arange(L, dtype=torch.int32, device=h.device)[None]
    if cache is not None:
        if cache["pos"] != 0 or cache["k"].shape[2] < L:
            raise ValueError(f"prefill needs an empty cache of >= {L} rows, "
                             f"got pos {cache['pos']} of "
                             f"{cache['k'].shape[2]}")
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(cfg.n_layers):
        kv = None if cache is None else (cache["k"][i], cache["v"][i])
        lp = common.at(params["layers"], i)
        h, y, a = common.remat(cfg, _block, cfg, lp, h, positions, kv,
                               ("layers", i))
        h = h + _ffn_reduce(cfg, y)
        aux = aux + a
    if cache is not None:
        cache["pos"] = L
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


def _softmax_v(logits: torch.Tensor, v: torch.Tensor, dtype: torch.dtype,
               seq: bool = False) -> torch.Tensor:
    """softmax(``logits`` (B, Hkv, g, 1, n)) times ``v`` (B, n, Hkv, d),
    in fp32 (fp64 where they are), the probabilities rounded to the
    cache's ``dtype`` first, as in the reference. With ``seq`` the n keys
    are this rank's block of the cache's positions (``common.seq_start``):
    each rank's maxima, sums of exponentials and exponential-weighted v
    are combined over the batch axes, as an online softmax does (one max
    and one sum all-reduce; the probabilities are not rounded, as no rank
    has them)."""
    if not seq:
        pr = torch.softmax(logits, dim=-1)
        return torch.einsum("bhgqk,bkhd->bqhgd",
                            common.upcast(pr.to(dtype)), common.upcast(v))
    if logits.shape[-1]:
        mx = logits.amax(dim=-1)
    else:                                         # no key of this block
        mx = torch.full(logits.shape[:-1], float("-inf"),
                        dtype=logits.dtype, device=logits.device)
    mx = common.seq_reduce(mx, "max")
    e = torch.exp(logits - mx[..., None])
    o = torch.einsum("bhgqk,bkhd->bqhgd", e, common.upcast(v))
    s = e.sum(-1).permute(0, 3, 1, 2)[..., None]           # (B, 1, Hkv, g, 1)
    both = common.seq_reduce(torch.cat([o, s], dim=-1), "sum")
    return both[..., :-1] / both[..., -1:]


def _decode_attention(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                      pos: int, seq: bool = False) -> torch.Tensor:
    """q: (B, 1, H, hd); kc/vc: (B, L, Hkv, hd); keys > pos do not count
    (the rows past ``pos`` are not read). Cache operands, products
    accumulated in fp32 (upcast, exact), probabilities rounded to the
    cache's type before the second product, as in the reference; with
    ``seq`` the cache block is this rank's block of the positions
    (:func:`_softmax_v`)."""
    B, _, Hkv, hd = kc.shape
    H = q.shape[2]
    g = H // Hkv
    qg = q.reshape(B, 1, Hkv, g, hd)
    k, v = kc[:, : pos + 1], vc[:, : pos + 1]
    logits = torch.einsum("bqhgd,bkhd->bhgqk", common.upcast(qg),
                          common.upcast(k))
    logits = logits * hd ** -0.5
    out = _softmax_v(logits, v, vc.dtype, seq)
    return out.reshape(B, 1, H, hd).to(q.dtype)


def _decode_attention_part(cfg: ModelConfig, q: torch.Tensor,
                           kc: torch.Tensor, vc: torch.Tensor,
                           pos: int) -> torch.Tensor:
    """:func:`_decode_attention` from this rank's head_dim slice of the
    cache (kc / vc: (B, S, Hkv, hd / n)): every rank scores every query
    head (q gathered over 'model' where it holds its heads) against its
    slice, the partial logits are summed over 'model' before the scale and
    the softmax, and each rank weights its slice of v. Returns what ``wo``
    takes: this rank's head_dim slice of every head where ``wo`` is split
    by head_dim, else the slices gathered (this rank's heads of them where
    ``wo`` is split by heads)."""
    if q.shape[2] < cfg.n_heads:
        q = common.join_model(q, 2)
    B, _, Hkv, dc = kc.shape
    H = q.shape[2]
    qg = common.model_block(q, 3).reshape(B, 1, Hkv, H // Hkv, dc)
    k, v = kc[:, : pos + 1], vc[:, : pos + 1]
    logits = common.sum_model(torch.einsum(
        "bqhgd,bkhd->bhgqk", common.upcast(qg), common.upcast(k)))
    logits = logits * cfg.hd ** -0.5
    out = _softmax_v(logits, v, vc.dtype)
    out = out.reshape(B, 1, H, dc).to(q.dtype)
    if common.split_role("wo") == "head_dim":
        return out
    out = common.join_model(out, 3)
    return common.model_block(out, 2) if common.split_role("wo") == "heads" \
        else out


def _decode_layer(cfg: ModelConfig, p: dict, kc: torch.Tensor,
                  vc: torch.Tensor, h: torch.Tensor, pos: int,
                  unit=None) -> torch.Tensor:
    """One layer of a decode step, K / V written into the cache block in
    place at row ``pos``; its products split and joined over 'model' as
    :func:`_block`'s. Given its ``unit``, ``p`` are the layer's blocks,
    gathered here."""
    if unit is not None:
        p = common.weights(p, *unit)
    x = common.rms_norm(h, p["ln1"])
    posv = torch.full((1, 1), pos, dtype=torch.int32, device=h.device)
    q, kk, v = _qkv(cfg, p, x, posv)
    _put_rows(kc, _cache_part(kk, kc), pos)       # in place
    _put_rows(vc, _cache_part(v, vc), pos)
    s0 = common.seq_start(kc.shape[1])
    if s0 is not None:                             # this rank's positions
        n = min(max(pos + 1 - s0, 0), kc.shape[1])
        attn = _decode_attention(q, kc, vc, n - 1, seq=True)
    elif kc.shape[3] < q.shape[3]:                 # a head_dim slice
        attn = _decode_attention_part(cfg, q, kc, vc, pos)
    else:
        attn = _decode_attention(q, kc, vc, pos)
    h = h + common.from_model(torch.einsum("blhk,hkd->bld", attn, p["wo"]),
                              "wo")
    return h + _ffn_reduce(cfg, _ffn_out(cfg, p, h)[0])


def decode(params: dict, cfg: ModelConfig, cache: dict, batch: dict):
    """One decode step. batch: {'tokens': (B, 1)} or {'embeds': (B, 1, d)}.
    Returns (logits (B, 1, V), cache): the same K / V tensors, written in
    place at row ``pos``, with ``pos + 1``. Inside ``common.fsdp_blocks``
    each layer gathers its weights as :func:`forward`'s do."""
    h = _embed_in(params, cfg, batch)
    pos = cache["pos"]
    if pos >= cache["k"].shape[2]:
        raise ValueError(f"KV cache full ({pos} rows)")
    for i in range(cfg.n_layers):
        h = _decode_layer(cfg, common.at(params["layers"], i), cache["k"][i],
                          cache["v"][i], h, pos, ("layers", i))
    return _logits(params, h), dict(cache, pos=pos + 1)
