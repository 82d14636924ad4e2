"""Shared building blocks of the port's LM substrate (twin of
``repro.models.common``): norms, RoPE, attention (GQA), the gated MLP,
parameter init helpers, activation checkpointing and the loss.

Functional like the reference: params are plain nested dicts of tensors.
The reference's sharding helpers (``constrain_*``, ``exclude_batch_axes``,
``repeat_kv``) only place activations under GSPMD and are left out; the
one batch statistic that crosses ranks (the MoE router's) goes through
:func:`batch_means` instead, and the products split over the 'model' axis
(the reference's ``constrain_heads`` / ``constrain_logits``) through
:func:`model_parallel` and its collectives. Where GSPMD gathers a layer's
FSDP blocks inside the layer scan, the model asks :func:`weights` for a
layer's weights (a gather inside :func:`fsdp_blocks`, else the tree
itself). ``scan_or_unroll`` is left out too (a Python loop over layers
does its job).
"""
from __future__ import annotations

import contextlib
import itertools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


# ---------------------------------------------------------------- init utils
class MetaDraw:
    """Stands in for a generator on the ``meta`` device, which torch lacks:
    ``model.init(cfg, MetaDraw())`` gives the parameter tree's shapes and
    dtypes with no allocation and no draw (the reference's
    ``jax.eval_shape(model.init)``)."""
    device = torch.device("meta")


def _normal(generator: torch.Generator, shape, dtype: torch.dtype,
            scale: float) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in fp32 on the generator's device, then
    cast to ``dtype``; an empty meta tensor for a :class:`MetaDraw`."""
    if generator.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (x * scale).to(dtype)


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype, scale: "float | None" = None
               ) -> torch.Tensor:
    scale = scale if scale is not None else d_in ** -0.5
    return _normal(generator, (d_in, d_out), dtype, scale)


def stacked(lead: tuple, draw) -> dict:
    """Per-layer parameters stacked on the leading dims ``lead`` (e.g.
    ``(G, every)``): ``draw()`` gives one layer's (name, tensor) pairs,
    layer after layer, and each tensor is written into its stacked tensor
    (allocated at the first layer) as it comes, so a lazy ``draw`` holds
    one layer tensor beside the stack at a time."""
    out = {}
    for idx in itertools.product(*map(range, lead)):
        for k, v in draw():
            if k not in out:
                out[k] = torch.empty((*lead, *v.shape), dtype=v.dtype,
                                     device=v.device)
            out[k][idx] = v
    return out


def at(tree: dict, *idx) -> dict:
    """One layer's weights (views) from a stacked dict."""
    return {k: w[idx] for k, w in tree.items()}


def _records_grad(args) -> bool:
    """Whether autograd records a call on ``args`` (tensors and dicts of
    tensors): grad mode is on and some tensor requires grad."""
    ts = [t for a in args for t in (a.values() if isinstance(a, dict)
                                    else (a,))
          if isinstance(t, torch.Tensor)]
    return torch.is_grad_enabled() and (
        _GATHER is not None or any(t.requires_grad for t in ts))


def remat(cfg, fn, *args):
    """``fn(*args)``, under activation checkpointing when ``cfg.remat`` is
    ``"full"`` and autograd records the call (inside :func:`fsdp_blocks`
    it always does: the weights come from a gather there): the block keeps
    only its inputs and runs again in the backward (the reference's
    ``jax.checkpoint(..., nothing_saveable)``). Otherwise (``"none"``, or
    serving, whose weights need no grad) a plain call."""
    if cfg.remat == "full" and _records_grad(args):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ------------------------------------------------------ the FSDP blocks
_GATHER = None           # fetch(blocks, path, idx) inside fsdp_blocks


@contextlib.contextmanager
def fsdp_blocks(fetch):
    """Within: the parameter tree the model gets holds this rank's blocks
    of each leaf, split over the batch axes (the reference's FSDP), and
    :func:`weights` turns a unit's blocks (one layer of a stack, zamba2's
    shared block, the top-level leaves) into the weights the forward uses
    with ``fetch(blocks, path, idx)``: the sharded step's differentiable
    gather, whose backward reduces the unit's gradient to its block
    (``launch.train_lib.MeshStep``). A layer gathers inside the function
    that :func:`remat` checkpoints, so its recompute gathers again and no
    layer's gathered weights outlive its forward. The backward (and a
    remat recompute) must run inside too."""
    global _GATHER
    old = _GATHER
    _GATHER = fetch
    try:
        yield
    finally:
        _GATHER = old


def weights(tree: dict, path: str = "", *idx) -> dict:
    """The weights the forward uses of ``tree``: the blocks at ``path`` in
    the parameter tree ('' the top level), layer ``idx`` of its stack
    (:func:`at`'s index; none for an unstacked unit). Inside
    :func:`fsdp_blocks` each is gathered over the batch axes (a leaf split
    over 'model' keeps its 'model' block); outside, ``tree`` itself."""
    return tree if _GATHER is None else _GATHER(tree, path, idx)


# --------------------------------------------------------- sharded batch
_BATCH_GROUP = None      # (process group, ranks) inside sharded_batch


@contextlib.contextmanager
def sharded_batch(group, n: int):
    """Within: the model sees one rank's block of a batch split evenly over
    the ``n`` ranks of ``group``, so :func:`batch_means` reduces over them,
    as the reference's GSPMD computes a batch mean over the global batch
    (the role of its ``exclude_batch_axes`` / ``constrain_*`` context).
    The backward (and a remat recompute) must run inside too."""
    global _BATCH_GROUP
    old = _BATCH_GROUP
    _BATCH_GROUP = (group, n)
    try:
        yield
    finally:
        _BATCH_GROUP = old


def batch_means(t: torch.Tensor) -> torch.Tensor:
    """``t``, means over this rank's rows, as means over the whole batch
    (differentiably: one all-reduce forward, one backward); unchanged
    outside :func:`sharded_batch`."""
    if _BATCH_GROUP is None:
        return t
    from repro_torch.launch import dist
    group, n = _BATCH_GROUP
    return dist.all_reduce_grad(t, group) / n


# ------------------------------------------------------- the 'model' axis
_MODEL_AXIS = None       # (process group or None, size, rank, roles,
                         # seq) inside model_parallel


@contextlib.contextmanager
def model_parallel(group, size: int, rank: int, roles: dict,
                   seq: bool = False):
    """Within: the model gets this rank's 'model' block of each leaf named
    in ``roles`` (leaf name, or ``scope.name`` where a family's name means
    two things -> the role of the dim split over the ``size`` ranks of
    ``group``, this one ``rank`` among them: 'heads', 'head_dim', 'ffn',
    'experts', 'vocab', or 'columns' (a product whose blocks of columns
    do not fall on heads: it is gathered), or 'part' for a leaf it gets
    whole and uses in part), computes its block of each such product and
    joins them with the collectives below. With ``seq`` (the reference's
    ``seq_parallel``) the transformer's residual stream between its
    products is this rank's block of L (:func:`seq_in`, :func:`seq_out`).
    With ``group`` None the collectives only give their results' shapes
    and communicate nothing (the dry-run's meta pass). The backward (and a
    remat recompute) must run inside too."""
    global _MODEL_AXIS
    old = _MODEL_AXIS
    _MODEL_AXIS = (group, size, rank, dict(roles), seq)
    try:
        yield
    finally:
        _MODEL_AXIS = old


def split_role(name: str) -> "str | None":
    """The role of the dim of leaf ``name`` that this rank holds a 'model'
    block of; None where the leaf is whole (always, outside
    :func:`model_parallel`)."""
    return None if _MODEL_AXIS is None else _MODEL_AXIS[3].get(name)


def model_rank() -> int:
    """This rank's place on the 'model' axis (0 outside
    :func:`model_parallel`)."""
    return 0 if _MODEL_AXIS is None else _MODEL_AXIS[2]


def to_model(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x``, replicated, into the product of leaf ``name``: where that is
    split, the gradient of ``x`` is summed over the 'model' ranks in the
    backward; else ``x`` itself."""
    from repro_torch.launch import dist
    if split_role(name) is None or _MODEL_AXIS[0] is None:
        return x
    return dist.copy_to_group(x, _MODEL_AXIS[0])


def from_model(x: torch.Tensor, name: str) -> torch.Tensor:
    """Out of the product of leaf ``name``: where that is split, the sum
    of every 'model' rank's partial ``x``, replicated; else ``x``."""
    from repro_torch.launch import dist
    if split_role(name) is None or _MODEL_AXIS[0] is None:
        return x
    return dist.reduce_from_group(x, _MODEL_AXIS[0])


def gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every 'model' rank's block of ``x`` joined along ``dim``, for a rank
    that uses the whole only in part (the backward reduce-scatters)."""
    from repro_torch.launch import dist
    group, size = _MODEL_AXIS[:2]
    if group is None:
        return torch.cat([x] * size, dim)
    return dist.all_gather_grad(x, dim, group)


def join_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every 'model' rank's block of ``x`` joined along ``dim``, for a
    rank that uses the whole in full, as every rank does (the backward
    takes this rank's block of the gradient)."""
    from repro_torch.launch import dist
    group, size = _MODEL_AXIS[:2]
    if group is None:
        return torch.cat([x] * size, dim)
    return dist.all_gather_whole(x, dim, group)


def sum_model(x: torch.Tensor) -> torch.Tensor:
    """The sum over the 'model' ranks of their partial ``x``, where each
    rank's use of the sum differs (the backward sums the ranks' gradients
    too: Megatron's identity backward would lose the others')."""
    from repro_torch.launch import dist
    group = _MODEL_AXIS[0]
    return x if group is None else dist.all_reduce_grad(x, group)


def model_block(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's block of the whole ``x`` along ``dim`` (a view)."""
    n = x.shape[dim] // _MODEL_AXIS[1]
    return x.narrow(dim, model_rank() * n, n)


# ------------------------------------------- the serving cache's batch axes
_CACHE_AXES = None       # (process group or None, size, index, seq) inside
                         # cache_axes


@contextlib.contextmanager
def cache_axes(group, size: int, index: int, seq: bool = False):
    """Within: a serving step on a mesh whose batch axes are the ``size``
    ranks of ``group``, this one ``index`` among them. A state leaf whose
    block holds every row of a batch that splits over them is read at this
    rank's rows (:func:`state_rows`) and written from every rank's
    (:func:`put_state`); with ``seq`` (a batch that does not split) the
    shared attention cache's positions split over them instead
    (:func:`seq_start`). With ``group`` None the collectives only give
    their results' shapes (the dry-run's meta pass)."""
    global _CACHE_AXES
    old = _CACHE_AXES
    _CACHE_AXES = (group, size, index, seq)
    try:
        yield
    finally:
        _CACHE_AXES = old


def state_rows(c: torch.Tensor, rows: int) -> torch.Tensor:
    """The state a layer computes from, of this rank's ``rows`` rows (dim
    0), out of its cache block ``c``: ``c`` itself where it holds just
    those, else (``c`` holds every row of the batch, which splits over
    :func:`cache_axes`) this rank's block of them (a view)."""
    if c.shape[0] == rows:
        return c
    return c.narrow(0, _CACHE_AXES[2] * rows, rows)


def put_state(c: torch.Tensor, x: torch.Tensor) -> None:
    """Write a layer's new state ``x`` as it was computed (this rank's rows
    on dim 0; its 'model' block of a dim, or all of it) into its cache
    block ``c`` in place: of a dim that ``c`` holds a 'model' block of and
    ``x`` whole, this rank's block; rows that ``c`` holds whole while the
    batch splits, every rank's, gathered over :func:`cache_axes`."""
    for d in range(1, x.dim()):
        if c.shape[d] < x.shape[d]:
            x = model_block(x, d)
    if c.shape[0] > x.shape[0]:
        group, size = _CACHE_AXES[:2]
        if group is None:
            x = torch.cat([x] * size, 0)
        else:
            from repro_torch.launch import dist
            x = dist.all_gather_rows(x.contiguous(), 0, group)
    c.copy_(x)


def seq_start(n: int) -> "int | None":
    """The first position of this rank's block (of ``n`` positions) of the
    shared attention cache where :func:`cache_axes` splits its positions,
    else None."""
    if _CACHE_AXES is None or not _CACHE_AXES[3]:
        return None
    return _CACHE_AXES[2] * n


def seq_len(n: int) -> int:
    """The positions of the whole attention cache whose block on this rank
    holds ``n``."""
    return n if seq_start(n) is None else n * _CACHE_AXES[1]


def seq_reduce(x: torch.Tensor, op: str) -> torch.Tensor:
    """``x`` reduced (``op`` 'sum' or 'max') over the ranks that split the
    attention cache's positions (:func:`cache_axes`)."""
    group = _CACHE_AXES[0]
    if group is None:
        return x
    from repro_torch.launch import dist
    return dist.all_reduce(x, op, group)


def seq_parallel() -> bool:
    """Whether the residual stream is this rank's block of L over 'model'
    (inside :func:`model_parallel` with ``seq``)."""
    return _MODEL_AXIS is not None and _MODEL_AXIS[4]


def seq_block(x: torch.Tensor) -> torch.Tensor:
    """``x`` (B, L, ...), whole, into the residual stream: this rank's
    block of L under :func:`seq_parallel`, else ``x``."""
    return model_block(x, 1) if seq_parallel() else x


def seq_in(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x``, of the residual stream, into the product of leaf ``name``:
    under :func:`seq_parallel` every rank's block of L, gathered (a split
    product's backward reduce-scatters the ranks' partial gradients of
    the whole; a whole product's, which every rank computes alike, takes
    this rank's block); else :func:`to_model`."""
    if not seq_parallel():
        return to_model(x, name)
    if split_role(name) is None:
        return join_model(x, 1)
    return gather_model(x, 1)


def seq_out(y: torch.Tensor, name: str) -> torch.Tensor:
    """Out of the product of leaf ``name``, split over 'model', into the
    residual stream: under :func:`seq_parallel` this rank's block of L of
    the sum of every rank's partial ``y`` (one reduce-scatter; the
    backward all-gathers); else :func:`from_model`."""
    if not seq_parallel():
        return from_model(y, name)
    from repro_torch.launch import dist
    group = _MODEL_AXIS[0]
    if group is None:
        return model_block(y, 1)
    return dist.reduce_scatter_grad(y, 1, group)


class _OwnRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[1] // _MODEL_AXIS[1]
        keep = torch.zeros_like(g)
        lo = model_rank() * n
        keep[:, lo: lo + n] = g[:, lo: lo + n]
        return keep


def own_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` (B, L, ...), gathered over L by :func:`seq_in`, into a
    consumer that every rank computes alike (the MoE router): under
    :func:`seq_parallel` the backward keeps this rank's block of L of the
    gradient and zeroes the rest, so that the gather's reduce-scatter
    counts the consumer's gradient once; else ``x``."""
    return _OwnRows.apply(x) if seq_parallel() else x


def rms_norm_model(x: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """:func:`rms_norm` of whole rows from this rank's block ``x`` of
    their last dim (and ``weight``'s block): the sum of squares is summed
    over 'model' (:func:`sum_model`)."""
    dt = x.dtype
    xf = upcast(x)
    ss = sum_model(torch.sum(xf * xf, dim=-1, keepdim=True))
    var = ss / (x.shape[-1] * _MODEL_AXIS[1])
    return (xf * torch.rsqrt(var + eps)).to(dt) * weight


def _max_model(x: torch.Tensor) -> torch.Tensor:
    from repro_torch.launch import dist
    group = _MODEL_AXIS[0]
    return x if group is None else dist.all_reduce(x, "max", group)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``; where ``table`` is this rank's block of the
    vocabulary rows over 'model', each rank looks up the ids in its rows,
    writes zero for the others, and the blocks are summed (exact: one term
    of each sum is not zero); under :func:`seq_parallel` each rank keeps
    its block of L of the sum (a reduce-scatter), or of ``table[ids]``."""
    if split_role("embed") in (None, "part"):
        return seq_block(table[ids])
    n = table.shape[0]
    loc = ids - model_rank() * n
    inside = (loc >= 0) & (loc < n)
    rows = table[loc.clamp(0, n - 1)]
    return seq_out(torch.where(inside[..., None], rows,
                               torch.zeros((), dtype=rows.dtype,
                                           device=rows.device)), "embed")


def scan_chunk(chunk: int, L: int) -> int:
    """The chunk of a chunkwise scan over L positions, ``min(chunk, L)``
    as in the reference, whose reshape needs L to be a multiple of it;
    raises ``ValueError`` otherwise (padding would change the function)."""
    c = min(chunk, L)
    if L % c:
        raise ValueError(f"sequence length {L} is not a multiple of the "
                         f"scan chunk {c} (cfg.chunk = {chunk})")
    return c


# ------------------------------------------------------------------ norms
def upcast(x: torch.Tensor) -> torch.Tensor:
    """``x`` in fp32, for a product or a statistic the models accumulate
    in fp32 (the reference's ``astype(float32)``), or in fp64 where it
    already is: an fp64 copy of a step's state runs the same function at
    fp64 throughout (the exact value an fp32 step is held to where fp32
    rounding is amplified, ``chip_smoke.py``'s ``[train-lm-tp]``)."""
    return x if x.dtype == torch.float64 else x.float()


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = upcast(x)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * weight


# ------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float = 1e4,
               device: "torch.device | str" = "cpu",
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=dtype,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, L, H, Dh); positions: (B, L) or (L,)."""
    dh = x.shape[-1]
    xf = upcast(x)
    freqs = rope_freqs(dh, theta, x.device, xf.dtype)    # (dh/2,)
    ang = positions[..., None].to(xf.dtype) * freqs      # (B?, L, dh/2)
    if ang.dim() == 2:                                   # (L, dh/2)
        ang = ang[None]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(xf, 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- attention
def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        block_q: int = 512) -> torch.Tensor:
    """Causal GQA attention over q blocks of ``block_q`` rows: peak logits
    memory is (B, bq, H, Lk) instead of (B, Lq, H, Lk). Exact. Operands in
    their own type, products accumulated in fp32 (the reference's
    ``preferred_element_type``: the operands are upcast, which is exact),
    the probabilities rounded to v's type before the second product, as
    there."""
    B, L, H, Dh = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    scale = Dh ** -0.5
    kf, vf = upcast(k), upcast(v)
    cols = torch.arange(L, device=q.device)
    out = []
    for s in range(0, L, block_q):
        qg = q[:, s: s + block_q].reshape(B, block_q, Hkv, g, Dh)
        logits = torch.einsum("bqhgd,bkhd->bqhgk", upcast(qg), kf) * scale
        rows = s + torch.arange(block_q, device=q.device)
        mask = rows[:, None] >= cols[None, :]
        logits = logits.masked_fill(~mask[None, :, None, None, :],
                                    float("-inf"))
        p = torch.softmax(logits, dim=-1)
        o = torch.einsum("bqhgk,bkhd->bqhgd", upcast(p.to(v.dtype)), vf)
        out.append(o.reshape(B, block_q, H, Dh))
    return torch.cat(out, dim=1).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """GQA attention. q: (B, Lq, H, Dh), k/v: (B, Lk, Hkv, Dh). More than
    one query row goes through ``ops.flash_attention``, which launches the
    kernel on a CUDA tensor and runs its plain version on a CPU tensor;
    one row through ``ref.mha``. There is no option to choose the plain
    path on the card (the reference's ``use_flash``): ``blockwise_attention``
    and ``ref.mha`` stay as references that tests call directly."""
    if q.shape[1] > 1:
        from repro_torch.kernels import ops as kops
        o = kops.flash_attention(q.transpose(1, 2).contiguous(),
                                 k.transpose(1, 2).contiguous(),
                                 v.transpose(1, 2).contiguous(), causal)
        return o.transpose(1, 2)
    from repro_torch.kernels import ref
    return ref.mha(q, k, v, causal=causal)


# ------------------------------------------------------------------ MLPs
def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


# ------------------------------------------------------------------- loss
def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  z_loss: float = 1e-4,
                  count: "torch.Tensor | None" = None) -> tuple:
    """Stable CE in fp32; targets < 0 are masked. Returns (loss, {'ce'}):
    sums over the unmasked positions divided by their number, or by
    ``count`` (a sharded step passes the whole batch's, so that its
    ranks' losses add up to the batch's mean).

    The target logit is taken with ``gather``: the reference's iota ==
    target masked sum (which keeps vocab-sharded logits sharded under
    GSPMD) adds exact zeros, so it is the same number, and a (B, L, V)
    mask would be GBs at a 128K vocab.

    Where ``unembed`` is split over 'model' (:func:`model_parallel`),
    ``logits`` are this rank's block of the vocabulary, as the reference
    keeps them (``constrain_logits``): the max and the sum of exponentials
    are all-reduced over 'model', and the target's logit comes from the
    rank that holds it (zero from the others, summed)."""
    lg = upcast(logits)
    if split_role("unembed") is not None:
        lse, tgt = _split_lse_target(lg, targets)
    else:
        lse = torch.logsumexp(lg, dim=-1)
        tgt = torch.gather(lg, -1,
                           targets.clamp(min=0).long()[..., None])[..., 0]
    nll = lse - tgt
    if z_loss:
        nll = nll + z_loss * lse ** 2
    mask = (targets >= 0).float()
    n = torch.clamp(mask.sum() if count is None else count, min=1.0)
    loss = (nll * mask).sum() / n
    ce = torch.where(mask > 0, lse - tgt, 0.0).sum() / n
    return loss, {"ce": ce}


def _split_lse_target(lg: torch.Tensor, targets: torch.Tensor) -> tuple:
    """(logsumexp, target logit) over the whole vocabulary from this rank's
    block ``lg`` of it: one max all-reduce (no gradient: it only shifts
    the exponentials) and one sum all-reduce of the stacked partial sum of
    exponentials and target logit."""
    n = lg.shape[-1]
    mx = _max_model(lg.detach().amax(dim=-1))
    loc = targets.long() - model_rank() * n
    inside = (loc >= 0) & (loc < n)
    tgt = torch.gather(lg, -1, loc.clamp(0, n - 1)[..., None])[..., 0]
    tgt = torch.where(inside, tgt, 0.0)
    sums = from_model(torch.stack(
        [torch.exp(lg - mx[..., None]).sum(-1), tgt]), "unembed")
    return mx + torch.log(sums[0]), sums[1]
