"""Zamba2-style hybrid (twin of ``repro.models.zamba``, arXiv:2411.15242):
a Mamba2 (SSD) backbone with one *shared* attention + MLP block invoked
after every ``attn_every`` Mamba layers (one set of weights; each
invocation keeps its own KV cache).

Mamba2 / SSD runs chunkwise over a prompt (exact): inside a chunk the
scalar-decay matrix exp(b_i - b_j) gates a (c x c) C·Bᵀ product; across
chunks an (N x P) state per head carries. Decode is the O(N·P) recurrence.
The chunk scan runs over the batch and head axes at once (leading dims)
and returns its end state too, so ``forward`` can fill a decode cache in
the prefill pass (``cache=``): each shared-attention invocation's K / V,
and each Mamba layer's conv state (its last K - 1 conv inputs, before the
activation) and end SSD state.

The parameter tree is the reference's: ``groups`` (G, every, ...),
``tail`` (tail, ...), ``shared_attn``, ``embed``, ``unembed``, ``ln_f``.
The shared block is the transformer's dense layer (its ``_init_layer``,
``_layer`` in the prefill, ``_decode_layer`` in decode): the reference's
block is that layer, without QKV bias or experts, which no hybrid config
sets.
Prefill attention goes through ``common.attention`` (the flash kernel on
the card). Caches are written in place, as the transformer's are.

On a mesh (``launch.train_lib.MeshServe``) a cache leaf is this rank's
block: a Mamba layer's SSD state its heads', its conv state its 'model'
block of the channels (gathered for the convolution; the block of the
new state comes from the gathered in-projection's whole row), the shared
cache its kv heads, or at a batch that does not split its block of the
positions (``transformer._decode_layer``); a state that holds every row
of a split batch is read at this rank's rows and written from every
rank's (``common.state_rows`` / ``put_state``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common, transformer
from repro_torch.models.api import ModelConfig

# the stacks of Mamba layers: name -> (stacked leading dims, whether a layer
# runs under common.remat); the sharded step gathers a layer at a time
STACKS = {"groups": (2, True), "tail": (1, True)}
# the cache's leaves: name -> (the dim of the batch's rows, the leaf whose
# 'model' split the state's computation follows: the SSD state a Mamba2
# layer's heads, the shared cache the attention; the conv state none, as
# a layer gathers its 'model' blocks); the sharded serving step reads it
CACHE = {"ak": (1, "wo"), "av": (1, "wo"), "g_conv": (2, None),
         "g_ssm": (2, "w_in"), "t_conv": (1, None), "t_ssm": (1, "w_in")}


def _dims(cfg: ModelConfig) -> tuple:
    """(inner width di, state N, heads H, head dim P, conv channels)."""
    di = cfg.ssm_expand * cfg.d_model
    N = cfg.ssm_state
    return di, N, di // cfg.ssm_head_dim, cfg.ssm_head_dim, di + 2 * N


# ------------------------------------------------------------- SSD core
def _segsum(la: torch.Tensor) -> torch.Tensor:
    """(..., c) -> (..., c, c): la_{j+1} + ... + la_i for j <= i (0 on the
    diagonal), -inf above it. The reference takes b_i - b_j of one running
    sum b; each entry here sums its own terms, which keeps the decays of
    a fast head exact to a few ulps where the difference loses |b|·eps
    (b reaches ~-2,000 in a 256-chunk of zamba2-1.2b's A = -64 head)."""
    c = la.shape[-1]
    strict = torch.ones(c, c, dtype=torch.bool, device=la.device).tril(-1)
    x = la[..., :, None].expand(*la.shape, c).masked_fill(~strict, 0.0)
    return torch.cumsum(x, dim=-2).masked_fill(
        ~strict.logical_or(torch.eye(c, dtype=torch.bool, device=la.device)),
        float("-inf"))


def _ssd_chunk_scan(xdt: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor,
                    la: torch.Tensor, chunk: int) -> tuple:
    """xdt: (..., L, P) inputs pre-scaled by dt; B_, C_: (..., L, N), which
    broadcast against xdt's leading dims (one per batch row, shared by its
    heads); la: (..., L) log decay (= dt·A, <= 0). L must be a multiple
    of ``chunk``. Returns y (..., L, P) and the end state S (..., N, P).
    The reference's function; its decays are sums of their own terms
    (``_segsum``, and the decay to a chunk's end as a suffix sum)."""
    *lead, L, P = xdt.shape
    N = B_.shape[-1]
    S = torch.zeros((*lead, N, P), dtype=xdt.dtype, device=xdt.device)
    ys = []
    for s in range(0, L, chunk):
        x_c = xdt[..., s: s + chunk, :]
        B_c = B_[..., s: s + chunk, :]
        C_c = C_[..., s: s + chunk, :]
        la_c = la[..., s: s + chunk]
        b = torch.cumsum(la_c, dim=-1)                  # chunk start -> i
        t = b[..., -1:]                                 # the whole chunk
        # i -> chunk end: la_{i+1} + ... + la_c
        after = torch.flip(torch.cumsum(torch.flip(la_c, [-1]), -1), [-1])
        after = torch.cat([after[..., 1:], torch.zeros_like(t)], dim=-1)
        # L_ij = exp(la_{j+1} + ... + la_i) for j <= i
        G = (C_c @ B_c.transpose(-1, -2)) * torch.exp(_segsum(la_c))
        y = G @ x_c                                     # intra
        y = y + torch.exp(b)[..., None] * (C_c @ S)     # inter
        S = torch.exp(t)[..., None] * S \
            + (B_c * torch.exp(after)[..., None]).transpose(-1, -2) @ x_c
        ys.append(y)
    return torch.cat(ys, dim=-2), S


def _conv_tail(state: "torch.Tensor | None", x: torch.Tensor,
               K: int) -> "torch.Tensor | None":
    """The conv state after x (B, L, C): its last K - 1 inputs, from the
    inputs before it (``state``, zeros when None); None where K is 1."""
    if K == 1:
        return None
    L = x.shape[1]
    if L >= K - 1:
        return x[:, L - (K - 1):]
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    return torch.cat([state[:, L:], x], dim=1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: "torch.Tensor | None" = None) -> torch.Tensor:
    """Depthwise causal conv. x: (B, L, C); w: (K, C); state: (B, K-1, C),
    the inputs before x (zeros when None); the state after x is
    :func:`_conv_tail`'s."""
    K = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state, x], dim=1)
    return sum(xp[:, i: i + x.shape[1], :] * w[i] for i in range(K))


# ------------------------------------------------------------ mamba block
def _init_mamba(cfg: ModelConfig, generator: torch.Generator) -> dict:
    d = cfg.d_model
    di, N, H, _, conv_ch = _dims(cfg)
    dt = transformer.dtype_of(cfg)
    dev = generator.device
    return {
        "ln": torch.ones((d,), dtype=dt, device=dev),
        # in_proj -> [z (di) | x (di) | B (N) | C (N) | dt (H)]
        "w_in": common._normal(generator, (d, 2 * di + 2 * N + H), dt,
                               d ** -0.5),
        "conv_w": common._normal(generator, (cfg.ssm_conv, conv_ch), dt,
                                 cfg.ssm_conv ** -0.5),
        "a_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                        device=dev)),
        "dt_bias": torch.full((H,), -2.0, dtype=torch.float32, device=dev),
        "ln_h": torch.ones((di,), dtype=dt, device=dev),
        "w_out": common._normal(generator, (di, d), dt, di ** -0.5),
    }


def _mamba_split(cfg: ModelConfig, p: dict, h: torch.Tensor) -> tuple:
    """(z, dt, the conv input [x | B | C]) of the in-projection of
    norm(h). Where ``w_in`` is split over 'model' its blocks of columns do
    not fall on heads: each rank takes its block of the product, the
    blocks are gathered, and it keeps its heads' z and dt (the heads of
    its ``a_log`` block) and the whole conv input."""
    di, N, H, P, _ = _dims(cfg)
    x = common.rms_norm(h, p["ln"])
    if common.split_role("w_in") is None:
        zx, h0, hn = x @ p["w_in"], 0, H
    else:
        zx = common.gather_model(common.to_model(x, "w_in") @ p["w_in"], -1)
        hn = p["a_log"].shape[0]
        h0 = common.model_rank() * hn
    dt0 = 2 * di + 2 * N + h0
    return (zx[..., h0 * P: (h0 + hn) * P], zx[..., dt0: dt0 + hn],
            zx[..., di: 2 * di + 2 * N])


def _mamba_block(cfg: ModelConfig, p: dict, h: torch.Tensor,
                 conv_state: "torch.Tensor | None" = None,
                 ssm_state: "torch.Tensor | None" = None,
                 single_step: bool = False, unit=None) -> tuple:
    """One Mamba2 layer over h (B, L, d): chunkwise over L, or one step
    from (``conv_state`` (B, K - 1, conv channels, or this rank's 'model'
    block of them: gathered), ``ssm_state`` (B, H, N, P)) with
    ``single_step``. Returns (block(h) before its 'model' reduce, the
    conv state after h over every channel, end SSD state): the caller
    adds ``common.from_model(out, 'w_out')`` to h, outside the remat
    block, so that a recompute does not repeat the reduce.
    Given its ``unit`` (path and layer index), ``p`` are the layer's
    blocks, gathered here (``common.weights``), inside the remat.

    Split over 'model' (``common.split_role('w_in')``), a rank runs its
    heads: the conv of their x channels and of the whole B and C (with
    ``conv_w`` gathered whole), their SSD, the gated norm over the whole
    inner width (``common.rms_norm_model``) and their rows of ``w_out``,
    a partial product."""
    if unit is not None:
        p = common.weights(p, *unit)
    B, L, _ = h.shape
    di_all, N, _, P, _ = _dims(cfg)
    z, dtr, xbc = _mamba_split(cfg, p, h)
    di = z.shape[-1]                           # this rank's heads' width
    H = di // P
    split = common.split_role("w_in") is not None
    if conv_state is not None and conv_state.shape[-1] < xbc.shape[-1]:
        conv_state = common.join_model(conv_state, -1)
    new_conv = _conv_tail(conv_state, xbc, cfg.ssm_conv)
    # the channels this rank convolves: its heads' x and the whole B and C
    mine = lambda t: t
    ln_h = p["ln_h"]
    if split:
        lo = common.model_rank() * di
        mine = lambda t: torch.cat([t[..., lo: lo + di], t[..., di_all:]],
                                   -1)
        ln_h = common.model_block(ln_h, 0)
    conv_out = _causal_conv(mine(xbc), mine(p["conv_w"]),
                            None if conv_state is None else mine(conv_state))
    conv_out = F.silu(conv_out)
    xin = conv_out[..., :di]
    Bc = common.upcast(conv_out[..., di: di + N])
    Cc = common.upcast(conv_out[..., di + N:])

    dt_ = F.softplus(common.upcast(dtr) + p["dt_bias"])         # (B, L, H)
    la = dt_ * -torch.exp(p["a_log"])                           # log decay
    xdt = common.upcast(xin).reshape(B, L, H, P) * dt_[..., None]

    if single_step:
        # recurrent: S' = exp(la) S + dt * B x^T ; y = C S'
        S = torch.exp(la[:, 0])[:, :, None, None] * ssm_state \
            + torch.einsum("bn,bhp->bhnp", Bc[:, 0], xdt[:, 0])
        y = torch.einsum("bn,bhnp->bhp", Cc[:, 0], S).reshape(B, 1, di)
    else:
        chunk = common.scan_chunk(cfg.chunk, L)
        y, S = _ssd_chunk_scan(xdt.transpose(1, 2), Bc[:, None],
                               Cc[:, None], la.transpose(1, 2), chunk)
        y = y.transpose(1, 2).reshape(B, L, di)
    y = y.to(h.dtype) * F.silu(z)
    y = common.rms_norm_model(y, ln_h) if split \
        else common.rms_norm(y, ln_h)
    return y @ p["w_out"], new_conv, S


# ------------------------------------------------------------- full model
def _group_struct(cfg: ModelConfig) -> tuple:
    every = cfg.attn_every or (cfg.n_layers + 1)
    G = cfg.n_layers // every
    return G, every, cfg.n_layers - G * every


def init(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Random parameters (the reference's scales; ``a_log`` / ``dt_bias``
    fp32), one layer at a time, on the generator's device."""
    dt = transformer.dtype_of(cfg)
    G, every, tail = _group_struct(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    p = {"ln_f": torch.ones((d,), dtype=dt, device=generator.device),
         "embed": common._normal(generator, (V, d), dt, 1.0),
         "unembed": common._normal(generator, (d, V), dt, d ** -0.5),
         "shared_attn": dict(transformer._init_layer(cfg, generator))}
    draw = lambda: _init_mamba(cfg, generator).items()
    if G:
        p["groups"] = common.stacked((G, every), draw)
    if tail:
        p["tail"] = common.stacked((tail,), draw)
    return p


def _schedule(cfg: ModelConfig, params: dict) -> list:
    """The layers in order: each Mamba layer as (weights, (conv cache key,
    SSD cache key, index), its unit for ``common.weights``), and after
    each group's last Mamba layer the group's index, where the shared
    block runs with that group's KV cache."""
    G, every, tail = _group_struct(cfg)
    out = []
    for g in range(G):
        for j in range(every):
            out.append((common.at(params["groups"], g, j),
                        ("g_conv", "g_ssm", (g, j)), ("groups", g, j)))
        out.append(g)
    for j in range(tail):
        out.append((common.at(params["tail"], j), ("t_conv", "t_ssm", (j,)),
                    ("tail", j)))
    return out


def forward(params: dict, cfg: ModelConfig, batch: dict,
            cache: "dict | None" = None) -> tuple:
    """batch: {'tokens': (B, L)}, L a multiple of ``min(cfg.chunk, L)``.
    Returns (logits (B, L, V), aux 0-d fp32 zero). With ``cache`` (from
    ``init_cache``, position 0), the same pass fills it: each shared-block
    invocation's K / V rows 0..L-1, each Mamba layer's conv and SSD
    states; its position becomes L. Each Mamba layer gathers its weights
    from ``params``' blocks inside its remat block; the shared block's are
    gathered at its first invocation and held for the others
    (``common.weights``)."""
    table = common.weights({"embed": params["embed"]})["embed"]
    h = common.embed_lookup(table, batch["tokens"].long())
    del table
    shared = None
    L = h.shape[1]
    positions = torch.arange(L, dtype=torch.int32, device=h.device)[None]
    if cache is not None and (cache["pos"] != 0 or (
            "ak" in cache and common.seq_len(cache["ak"].shape[2]) < L)):
        raise ValueError(f"prefill needs an empty cache of >= {L} rows, "
                         f"got pos {cache['pos']}")
    for item in _schedule(cfg, params):
        if isinstance(item, int):                    # the shared block
            kv = None if cache is None else (cache["ak"][item],
                                             cache["av"][item])
            if shared is None:
                shared = common.weights(params["shared_attn"], "shared_attn")
            h, y, _ = transformer._block(cfg, shared, h, positions, kv)
            h = h + transformer._ffn_reduce(cfg, y)
            continue
        lp, (kc, ks, idx), unit = item
        out, conv, S = common.remat(cfg, _mamba_block, cfg, lp, h, None,
                                    None, False, unit)
        h = h + common.from_model(out, "w_out")
        if cache is not None:
            if conv is not None:
                common.put_state(cache[kc][idx], conv)
            common.put_state(cache[ks][idx], S)
    if cache is not None:
        cache["pos"] = L
    return transformer._logits(params, h), torch.zeros(
        (), dtype=torch.float32, device=h.device)


# ----------------------------------------------------------------- decode
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: "torch.device | str" = "cuda") -> dict:
    """The reference's cache: one KV cache (G, B, max_len, Hkv, hd) per
    shared-block invocation (the only L-sized state), each Mamba layer's
    conv state in ``cfg.dtype`` and SSD state in fp32; ``pos`` (a Python
    int) is the number of positions seen."""
    G, every, tail = _group_struct(cfg)
    _, N, H, P, conv_ch = _dims(cfg)
    K = cfg.ssm_conv
    dt = transformer.dtype_of(cfg)
    z = lambda shape, t: torch.zeros(shape, dtype=t, device=device)
    cache = {"pos": 0}
    if G:
        kv = (G, batch, max_len, cfg.n_kv_heads, cfg.hd)
        cache["ak"], cache["av"] = z(kv, dt), z(kv, dt)
        cache["g_conv"] = z((G, every, batch, K - 1, conv_ch), dt)
        cache["g_ssm"] = z((G, every, batch, H, N, P), torch.float32)
    if tail:
        cache["t_conv"] = z((tail, batch, K - 1, conv_ch), dt)
        cache["t_ssm"] = z((tail, batch, H, N, P), torch.float32)
    return cache


def decode(params: dict, cfg: ModelConfig, cache: dict, batch: dict):
    """One decode step. batch: {'tokens': (B, 1)}. Returns (logits (B, 1,
    V), cache): the same tensors, written in place, with ``pos + 1``.
    Its weights come as :func:`forward`'s do (``common.weights``); a
    Mamba layer's states are read at this rank's rows and written back
    into the cache's blocks (``common.state_rows``, ``common.put_state``).
    """
    h = transformer._embed_in(params, cfg, batch)
    pos = cache["pos"]
    if "ak" in cache and pos >= common.seq_len(cache["ak"].shape[2]):
        raise ValueError(f"KV cache full ({pos} rows)")
    shared = None
    for item in _schedule(cfg, params):
        if isinstance(item, int):
            if shared is None:
                shared = common.weights(params["shared_attn"], "shared_attn")
            h = transformer._decode_layer(cfg, shared, cache["ak"][item],
                                          cache["av"][item], h, pos)
            continue
        lp, (kc, ks, idx), unit = item
        conv, ssm = cache[kc][idx], cache[ks][idx]
        out, new_conv, S = _mamba_block(
            cfg, lp, h, common.state_rows(conv, h.shape[0]),
            common.state_rows(ssm, h.shape[0]), True, unit)
        h = h + common.from_model(out, "w_out")
        if new_conv is not None:
            common.put_state(conv, new_conv)
        common.put_state(ssm, S)
    return transformer._logits(params, h), dict(cache, pos=pos + 1)
