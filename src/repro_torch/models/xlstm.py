"""xLSTM (twin of ``repro.models.xlstm``, arXiv:2405.04517): mLSTM
(matrix memory, chunkwise-parallel) and sLSTM (scalar memory, recurrent)
blocks.

Layout: groups of (slstm_every - 1) mLSTM blocks followed by one sLSTM
block, then a tail of mLSTM blocks; the blocks are gated up / down
projections (mLSTM pf = 2, sLSTM pf = 4/3), no separate FFN (d_ff = 0).

The mLSTM runs a prompt in the reference's chunkwise form (exact,
stabilized): within a chunk D_ij = b_i - b_j + ig_j gives an
attention-like (c x c) product; across chunks a (dh x dh) matrix memory C,
normalizer n and log-space stabilizer m carry. Decode is the single-step
recurrence on (C, n, m). The two forms keep (C, n) scaled by exp(-m) for
different m, so a prefill-filled state and a decode-built one agree in
C·exp(m) and n·exp(m), not in raw C. The chunk scan runs over the batch
and head axes at once and returns its end state, so ``forward`` fills a
decode cache in the prefill pass (``cache=``): each mLSTM layer's end
(C, n, m) and each sLSTM layer's end (c, n, h, m). On a mesh
(``launch.train_lib.MeshServe``) a state is this rank's block: its heads',
or an mLSTM memory's rows of dhk where 'model' does not divide the heads
(its readout summed over 'model', :func:`_mlstm_decode_step`); a state
that holds every row of a split batch is read at this rank's rows and
written from every rank's (``common.state_rows`` / ``put_state``).

The parameter tree is the reference's: ``m_groups`` (G, M, ...),
``s_groups`` (G, ...), ``m_tail`` (tail, ...), ``embed``, ``unembed``,
``ln_f``; the gate weights (``w_gates``, ``b_gates``, ``wx``, ``r``,
``bias``) are fp32 in every config.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common, transformer
from repro_torch.models.api import ModelConfig

_NEG = -1e30
# the stacks of blocks: name -> (stacked leading dims, whether a block runs
# under common.remat); the sharded step gathers a block at a time
STACKS = {"m_groups": (2, True), "s_groups": (1, False),
          "m_tail": (1, True)}
# the scope of each stack's leaf names in the roles of the 'model' axis
# (common.split_role): ``w_up`` / ``w_down`` are the fused [x | z] and down
# projections of an mLSTM block, and an sLSTM block's FFN
ROLE_SCOPES = {"m_groups": "mlstm", "m_tail": "mlstm", "s_groups": "slstm"}
# the cache's leaves: name -> (the dim of the batch's rows, the leaf whose
# 'model' split the state's computation follows: an mLSTM block's or an
# sLSTM block's heads); the sharded serving step reads it
CACHE = {"m_C": (2, "mlstm.wq"), "m_n": (2, "mlstm.wq"),
         "m_m": (2, "mlstm.wq"), "s_state": (1, "slstm.wx"),
         "t_C": (1, "mlstm.wq"), "t_n": (1, "mlstm.wq"),
         "t_m": (1, "mlstm.wq")}


# ----------------------------------------------------------- mLSTM core
def _mlstm_chunk_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      ig: torch.Tensor, lf: torch.Tensor, chunk: int
                      ) -> tuple:
    """q, k: (..., L, dhk); v: (..., L, dhv); ig / lf: (..., L) raw input
    gate and log-sigmoid forget gate. L must be a multiple of ``chunk``.
    Returns h (..., L, dhv) and the end state (C (..., dhk, dhv),
    n (..., dhk), m (...)), one stabilizer per chunk as in the reference."""
    *lead, L, dhk = q.shape
    dhv = v.shape[-1]
    scale = dhk ** -0.5
    dev = q.device
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=dev).tril()
    C = torch.zeros((*lead, dhk, dhv), dtype=q.dtype, device=dev)
    n = torch.zeros((*lead, dhk), dtype=q.dtype, device=dev)
    m = torch.zeros(lead, dtype=q.dtype, device=dev)
    hs = []
    for s in range(0, L, chunk):
        q_c = q[..., s: s + chunk, :]
        k_c = k[..., s: s + chunk, :]
        v_c = v[..., s: s + chunk, :]
        ig_c = ig[..., s: s + chunk]
        b = torch.cumsum(lf[..., s: s + chunk], dim=-1)       # (..., c)
        tot = b[..., -1]
        # D_ij = (b_i - b_j) + ig_j  for j <= i
        D = (b[..., :, None] - b[..., None, :]
             + ig_c[..., None, :]).masked_fill(~tri, _NEG)
        inter = m[..., None] + b                              # (..., c)
        m_c = torch.maximum(D.amax(dim=(-2, -1)), inter.amax(dim=-1))
        S = (q_c @ k_c.transpose(-1, -2)) * scale \
            * torch.exp(D - m_c[..., None, None])             # (..., c, c)
        w_int = torch.exp(inter - m_c[..., None])             # (..., c)
        num = S @ v_c + w_int[..., None] * ((q_c @ C) * scale)
        den = S.sum(-1) + (w_int * (q_c @ n[..., None])[..., 0]) * scale
        den = torch.maximum(den.abs(), torch.exp(-m_c)[..., None])
        hs.append(num / den[..., None])
        # state to the chunk's end
        m_new = torch.maximum(m + tot,
                              (tot[..., None] - b + ig_c).amax(dim=-1))
        dk = torch.exp(tot[..., None] - b + ig_c - m_new[..., None])
        decay = torch.exp(m + tot - m_new)
        kd = k_c * dk[..., None]
        C = decay[..., None, None] * C + kd.transpose(-1, -2) @ v_c
        n = decay[..., None] * n + kd.sum(dim=-2)
        m = m_new
    return torch.cat(hs, dim=-2), (C, n, m)


def _mlstm_decode_step(C, n, m_prev, q, k, v, ig, lf) -> tuple:
    """One-token mLSTM recurrence over leading dims: C (..., dhk, dhv),
    n / q / k (..., dhk), v (..., dhv), m_prev / ig / lf (...). Returns
    (C, n, m, h (..., dhv)). Where C is this rank's 'model' block of dhk
    (its rows of the memory), its rows are updated from its slice of k
    and the readout q·C is summed over 'model' before the denominator (n
    and m whole)."""
    scale = q.shape[-1] ** -0.5
    m_new = torch.maximum(lf + m_prev, ig)
    fp = torch.exp(lf + m_prev - m_new)
    ip = torch.exp(ig - m_new)
    part = C.shape[-2] < k.shape[-1]
    qc, kc = (common.model_block(q, -1), common.model_block(k, -1)) \
        if part else (q, k)
    C = fp[..., None, None] * C + ip[..., None, None] * (
        kc[..., :, None] * v[..., None, :])
    n = fp[..., None] * n + ip[..., None] * k
    num = (qc[..., None, :] @ C)[..., 0, :]
    num = (common.sum_model(num) if part else num) * scale
    den = torch.maximum((q * n).sum(-1).abs() * scale, torch.exp(-m_new))
    return C, n, m_new, num / den[..., None]


# ---------------------------------------------------------- mLSTM block
def _init_mlstm(cfg: ModelConfig, generator: torch.Generator) -> dict:
    d = cfg.d_model
    di = 2 * d                     # pf = 2 up-projection
    H = cfg.n_heads
    dh = di // H
    dt = transformer.dtype_of(cfg)
    dev = generator.device
    nrm = lambda shape, t, scale: common._normal(generator, shape, t, scale)
    return {
        "ln": torch.ones((d,), dtype=dt, device=dev),
        "w_up": nrm((d, 2 * di), dt, d ** -0.5),              # x | z
        "wq": nrm((di, H, dh), dt, di ** -0.5),
        "wk": nrm((di, H, dh), dt, di ** -0.5),
        "wv": nrm((di, H, dh), dt, di ** -0.5),
        "w_gates": nrm((di, 2, H), torch.float32, di ** -0.5),
        "b_gates": torch.tensor([0.0, 3.0], device=dev)[:, None].expand(
            2, H).contiguous(),                               # i, f bias
        "ln_h": torch.ones((di,), dtype=dt, device=dev),
        "w_down": nrm((di, d), dt, di ** -0.5),
    }


def _mlstm_in(p: dict, h: torch.Tensor, eq: str) -> tuple:
    """The block's projections: (q, k, v fp32 by ``eq``, ig, lf, z). Where
    ``w_up`` is split over 'model' (its blocks of [x | z] columns do not
    fall on heads) each rank takes its block of the product and the
    blocks are gathered: x whole for its heads' q, k and v, z of its
    heads' channels; the gates of its heads."""
    x = common.rms_norm(h, p["ln"])
    w_gates = p["w_gates"]
    if common.split_role("mlstm.w_up") is None:
        xm, z = torch.chunk(x @ p["w_up"], 2, dim=-1)         # (B, L, di)
    else:
        xz = common.gather_model(
            common.to_model(x, "mlstm.w_up") @ p["w_up"], -1)
        di, n = xz.shape[-1] // 2, p["wq"].shape[1] * p["wq"].shape[2]
        lo = common.model_rank() * n
        xm, z = xz[..., :di], xz[..., di + lo: di + lo + n]
        w_gates = common.model_block(w_gates, 2)
    q, k, v = (common.upcast(torch.einsum(eq, xm, p[w]))
               for w in ("wq", "wk", "wv"))
    gates = torch.einsum("bld,dgh->bghl", common.upcast(xm), w_gates) \
        + p["b_gates"][None, :, :, None]                      # (B, 2, H, L)
    return q, k, v, gates[:, 0], F.logsigmoid(gates[:, 1]), z


def _mlstm_out(p: dict, h: torch.Tensor, hh: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    """hh (B, H, L, dh) fp32 -> down(norm(hh) * silu(z)), the block's
    output before its 'model' reduce; split over 'model', of this rank's
    heads: the norm over the whole width, the partial product of its rows
    of ``w_down``."""
    B, _, L, _ = hh.shape
    hh = hh.transpose(1, 2).reshape(B, L, -1).to(h.dtype)
    if common.split_role("mlstm.w_up") is None:
        hh = common.rms_norm(hh, p["ln_h"])
    else:
        hh = common.rms_norm_model(hh, common.model_block(p["ln_h"], 0))
    return (hh * F.silu(z)) @ p["w_down"]


def _mlstm_block(cfg: ModelConfig, p: dict, h: torch.Tensor,
                 unit=None) -> tuple:
    """Chunkwise mLSTM over h (B, L, d); returns (the block's output
    before its 'model' reduce, end (C, n, m)): the caller adds
    ``common.from_model(out, 'mlstm.w_down')`` to h, outside the remat
    block, so that a recompute does not repeat the reduce. Given its
    ``unit`` (path and block index), ``p`` are the block's blocks of
    weights, gathered here (``common.weights``), inside the remat."""
    if unit is not None:
        p = common.weights(p, *unit)
    q, k, v, ig, lf, z = _mlstm_in(p, h, "bld,dhk->bhlk")
    chunk = common.scan_chunk(cfg.chunk, h.shape[1])
    hh, state = _mlstm_chunk_scan(q, k, v, ig, lf, chunk)    # (B, H, L, dh)
    return _mlstm_out(p, h, hh, z), state


def _mlstm_decode_block(cfg: ModelConfig, p: dict, h: torch.Tensor,
                        C, n, m, unit=None) -> tuple:
    """One token h (B, 1, d) from (C (B, H, dh, dh), n, m); returns (the
    block's output before its 'model' reduce, the new (C, n, m)), as
    :func:`_mlstm_block` does."""
    if unit is not None:
        p = common.weights(p, *unit)
    q, k, v, ig, lf, z = _mlstm_in(p, h, "bld,dhk->bhk")
    C, n, m, hh = _mlstm_decode_step(C, n, m, q, k, v, ig[..., 0],
                                     lf[..., 0])
    return _mlstm_out(p, h, hh[:, :, None], z), (C, n, m)


# ---------------------------------------------------------- sLSTM block
def _init_slstm(cfg: ModelConfig, generator: torch.Generator) -> dict:
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    ff = max(1, (4 * d) // 3)      # pf = 4/3 post-block MLP
    dt = transformer.dtype_of(cfg)
    dev = generator.device
    nrm = lambda shape, t, scale: common._normal(generator, shape, t, scale)
    bias = torch.zeros((4, H, dh), dtype=torch.float32, device=dev)
    bias[1] = 3.0                  # forget-gate bias
    return {
        "ln": torch.ones((d,), dtype=dt, device=dev),
        "wx": nrm((d, 4, H, dh), torch.float32, d ** -0.5),
        "r": nrm((4, H, dh, dh), torch.float32, dh ** -0.5),
        "bias": bias,
        "ln_h": torch.ones((d,), dtype=dt, device=dev),
        "w_up": nrm((d, ff), dt, d ** -0.5),
        "w_gate": nrm((d, ff), dt, d ** -0.5),
        "w_down": nrm((ff, d), dt, ff ** -0.5),
    }


def _slstm_scan(p: dict, x: torch.Tensor, state: tuple) -> tuple:
    """x: (B, L, 4, H, dh) preactivations, recurrent over L from state
    (c, n, h, m), each (B, H, dh), through ``p['r']`` and ``p['bias']``.
    Returns (h (B, L, H, dh), end state)."""
    c, n, hs, m = state
    out = []
    for t in range(x.shape[1]):
        pre = x[:, t] + torch.einsum("bhk,ghkj->bghj", hs, p["r"]) \
            + p["bias"]
        # gate order: z, f, i, o
        zt = torch.tanh(pre[:, 0])
        lf = F.logsigmoid(pre[:, 1])
        it = pre[:, 2]
        ot = torch.sigmoid(pre[:, 3])
        m_new = torch.maximum(lf + m, it)
        fp = torch.exp(lf + m - m_new)
        ip = torch.exp(it - m_new)
        c = fp * c + ip * zt
        n = fp * n + ip
        hs = ot * c / torch.clamp(n, min=1e-6)
        m = m_new
        out.append(hs)
    return torch.stack(out, dim=1), (c, n, hs, m)


def _slstm_block(cfg: ModelConfig, p: dict, h: torch.Tensor,
                 state: "tuple | None" = None, unit=None) -> tuple:
    """One sLSTM block over h (B, L, d) from ``state`` (zeros when None);
    returns (h, end (c, n, h, m)). Given its ``unit``, ``p`` are its
    blocks of weights, gathered here (``common.weights``).

    Split over 'model' (``common.split_role('slstm.wx')``), a rank runs
    the recurrence of its heads (``bias`` gathered whole, its heads
    taken), norms their outputs over the whole width and gathers them for
    the residual; the FFN splits by its width on its own."""
    if unit is not None:
        p = common.weights(p, *unit)
    B, L, _ = h.shape
    x = common.rms_norm(h, p["ln"])
    split = common.split_role("slstm.wx") is not None
    bias, ln_h = p["bias"], p["ln_h"]
    if split:
        x = common.to_model(x, "slstm.wx")
        bias = common.model_block(bias, 1)
        ln_h = common.model_block(ln_h, 0)
    pre = torch.einsum("bld,dghk->blghk", common.upcast(x), p["wx"])
    H, dh = pre.shape[3], pre.shape[4]
    if state is None:
        z = torch.zeros((B, H, dh), dtype=pre.dtype, device=h.device)
        state = (z, z, z, z)
    hseq, state = _slstm_scan({"r": p["r"], "bias": bias}, pre, state)
    hh = hseq.reshape(B, L, H * dh).to(h.dtype)
    if split:
        hh = common.join_model(common.rms_norm_model(hh, ln_h), -1)
    else:
        hh = common.rms_norm(hh, ln_h)
    h = h + hh
    x2 = common.to_model(h, "slstm.w_gate")
    x2 = F.silu(x2 @ p["w_gate"]) * (x2 @ p["w_up"])
    return h + common.from_model(x2 @ p["w_down"], "slstm.w_gate"), state


# ------------------------------------------------------------- full model
def _group_struct(cfg: ModelConfig) -> tuple:
    every = cfg.slstm_every or (cfg.n_layers + 1)
    G = cfg.n_layers // every
    return G, every - 1, cfg.n_layers - G * every


def init(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Random parameters (the reference's scales; gate weights fp32), one
    layer at a time, on the generator's device."""
    dt = transformer.dtype_of(cfg)
    G, M, tail = _group_struct(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    p = {"ln_f": torch.ones((d,), dtype=dt, device=generator.device),
         "embed": common._normal(generator, (V, d), dt, 1.0),
         "unembed": common._normal(generator, (d, V), dt, d ** -0.5)}
    m_draw = lambda: _init_mlstm(cfg, generator).items()
    if G:
        p["m_groups"] = common.stacked((G, M), m_draw)
        p["s_groups"] = common.stacked(
            (G,), lambda: _init_slstm(cfg, generator).items())
    if tail:
        p["m_tail"] = common.stacked((tail,), m_draw)
    return p


def _schedule(cfg: ModelConfig, params: dict) -> list:
    """The blocks in order, each as (kind "m" / "s", weights, its state's
    cache keys (None: ``s_state``), index into those caches, its unit for
    ``common.weights``)."""
    G, M, tail = _group_struct(cfg)
    out = []
    for g in range(G):
        out += [("m", common.at(params["m_groups"], g, j),
                 ("m_C", "m_n", "m_m"), (g, j), ("m_groups", g, j))
                for j in range(M)]
        out.append(("s", common.at(params["s_groups"], g), None, g,
                    ("s_groups", g)))
    out += [("m", common.at(params["m_tail"], j), ("t_C", "t_n", "t_m"), (j,),
             ("m_tail", j)) for j in range(tail)]
    return out


def _bufs(cache: dict, keys) -> tuple:
    """The cache tensors of one block's state, in the state's order."""
    return cache["s_state"] if keys is None else tuple(cache[k] for k in keys)


def forward(params: dict, cfg: ModelConfig, batch: dict,
            cache: "dict | None" = None) -> tuple:
    """batch: {'tokens': (B, L)}, L a multiple of ``min(cfg.chunk, L)``.
    Returns (logits (B, L, V), aux 0-d fp32 zero). With ``cache`` (from
    ``init_cache``, position 0), the same pass writes each block's end
    state into it; its position becomes L. Each block gathers its weights
    from ``params``' blocks (``common.weights``), an mLSTM block inside
    its remat."""
    table = common.weights({"embed": params["embed"]})["embed"]
    h = common.embed_lookup(table, batch["tokens"].long())
    del table
    if cache is not None and cache["pos"] != 0:
        raise ValueError(f"prefill needs an empty cache, got pos "
                         f"{cache['pos']}")
    for kind, lp, keys, idx, unit in _schedule(cfg, params):
        if kind == "s":
            h, state = _slstm_block(cfg, lp, h, None, unit)
        else:                              # the reference remats mLSTM only
            out, state = common.remat(cfg, _mlstm_block, cfg, lp, h, unit)
            h = h + common.from_model(out, "mlstm.w_down")
        if cache is not None:
            for b, st in zip(_bufs(cache, keys), state):
                common.put_state(b[idx], st)
    if cache is not None:
        cache["pos"] = h.shape[1]
    return transformer._logits(params, h), torch.zeros(
        (), dtype=torch.float32, device=h.device)


# ----------------------------------------------------------------- decode
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: "torch.device | str" = "cuda") -> dict:
    """The reference's constant-size state, fp32: each mLSTM block's (C,
    n, m) and each sLSTM block's (c, n, h, m) (``s_state``, a tuple);
    ``max_len`` is kept for the interface. ``pos`` (a Python int) is the
    number of positions seen."""
    G, M, tail = _group_struct(cfg)
    H = cfg.n_heads
    dh_m = 2 * cfg.d_model // H
    dh_s = cfg.d_model // H
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    cache = {"pos": 0}
    if G:
        cache["m_C"] = z(G, M, batch, H, dh_m, dh_m)
        cache["m_n"] = z(G, M, batch, H, dh_m)
        cache["m_m"] = z(G, M, batch, H)
        cache["s_state"] = tuple(z(G, batch, H, dh_s) for _ in range(4))
    if tail:
        cache["t_C"] = z(tail, batch, H, dh_m, dh_m)
        cache["t_n"] = z(tail, batch, H, dh_m)
        cache["t_m"] = z(tail, batch, H)
    return cache


def decode(params: dict, cfg: ModelConfig, cache: dict, batch: dict):
    """One decode step. batch: {'tokens': (B, 1)}. Returns (logits (B, 1,
    V), cache): the same tensors, written in place, with ``pos + 1``.
    Its weights come as :func:`forward`'s do (``common.weights``); a
    block's state is read at this rank's rows and written back into the
    cache's blocks (``common.state_rows``, ``common.put_state``)."""
    h = transformer._embed_in(params, cfg, batch)
    for kind, lp, keys, idx, unit in _schedule(cfg, params):
        bufs = tuple(b[idx] for b in _bufs(cache, keys))
        state = tuple(common.state_rows(b, h.shape[0]) for b in bufs)
        if kind == "s":
            h, state = _slstm_block(cfg, lp, h, state, unit)
        else:
            out, state = _mlstm_decode_block(cfg, lp, h, *state, unit=unit)
            h = h + common.from_model(out, "mlstm.w_down")
        for b, st in zip(bufs, state):
            common.put_state(b, st)
    return transformer._logits(params, h), dict(cache, pos=cache["pos"] + 1)
