"""Process groups of the multi-device solver (the role of
``repro.launch.mesh`` in the reference): one process per device, NCCL
between cards, gloo between CPU processes.

    from repro_torch.launch import dist
    dev = dist.init()                 # under torchrun: RANK, WORLD_SIZE,
                                      # LOCAL_RANK (and MASTER_ADDR/PORT)
    dev = dist.init(device="cpu", init_method="file:///tmp/pg",
                    rank=r, world=4)  # explicit, e.g. gloo in tests

Every collective of the port goes through one helper here —
:func:`all_gather`, :func:`all_reduce`, :func:`reduce_scatter` and
:func:`ring_shift`, and the ones autograd differentiates, built on them:
:func:`all_reduce_grad`, and the pairs of a product split over a group
(:func:`copy_to_group`, :func:`reduce_from_group`,
:func:`all_gather_grad`, :func:`reduce_scatter_grad`), and the sharded
step's gather of a parameter
block with its fp32 reduce in the backward (:func:`gather_block`) — each of
which calls whichever name the installed torch provides without a
deprecation warning, and counts its calls in :data:`calls` (by helper;
the chip smoke reads collectives per SMO iteration from it). A group
always has a ``timeout``: a rank that diverges from the others (a
different collective, a different shape) raises after it instead of
hanging, and nothing carries on past a failed collective.
"""
from __future__ import annotations

import collections
import datetime
import os
from typing import Optional

import torch
import torch.distributed as tdist

from repro_torch import device as devmod

TIMEOUT = datetime.timedelta(seconds=300)

_device: Optional[torch.device] = None
calls: collections.Counter = collections.Counter()


def init(device: str = "cuda", init_method: "str | None" = None,
         rank: "int | None" = None, world: "int | None" = None,
         timeout: datetime.timedelta = TIMEOUT,
         backend: "str | None" = None) -> torch.device:
    """Join the default process group and return this rank's device:
    ``cuda:{LOCAL_RANK}`` (set as the current card) with NCCL, or the CPU
    with gloo. ``rank`` / ``world`` default to torchrun's ``RANK`` /
    ``WORLD_SIZE``, ``init_method`` to ``env://``. ``backend`` names
    another backend for the device (gloo between processes that share one
    card, which NCCL refuses); its collectives then take the device's
    tensors or raise. A CUDA request without a card raises, as
    ``device.resolve`` does."""
    global _device
    dev = devmod.resolve(device)
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    world = int(os.environ["WORLD_SIZE"]) if world is None else int(world)
    kw = {}
    if dev.type == "cuda":
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK",
                                       rank % torch.cuda.device_count()))
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        if backend in (None, "nccl"):
            kw["device_id"] = dev
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    tdist.init_process_group(backend,
                             init_method=init_method or "env://",
                             rank=rank, world_size=world, timeout=timeout,
                             **kw)
    _device = dev
    return dev


def initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def rank(group=None) -> int:
    return tdist.get_rank(group) if initialized() else 0


def world(group=None) -> int:
    return tdist.get_world_size(group) if initialized() else 1


def device() -> torch.device:
    """The device :func:`init` bound this rank to."""
    if _device is None:
        raise RuntimeError("no process group: call repro_torch.launch.dist"
                           ".init() first")
    return _device


def destroy() -> None:
    global _device
    if initialized():
        tdist.destroy_process_group()
    _device = None


# bool tensors travel as bytes: not every backend reduces or gathers bool
def _wire(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.uint8) if t.dtype == torch.bool else t


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """(p, *t.shape): every rank's ``t`` stacked in rank order, gathered as
    one flat payload. A bit copy, so int32 ids bitcast into float lanes
    survive it."""
    p = world(group)
    calls["all_gather"] += 1
    src = _wire(t).reshape(-1).contiguous()
    out = torch.empty((p * src.numel(),), dtype=src.dtype, device=src.device)
    gather = getattr(tdist, "all_gather_single", None) \
        or tdist.all_gather_into_tensor
    gather(out, src, group=group)
    out = out.reshape((p,) + tuple(t.shape))
    return out.to(torch.bool) if t.dtype == torch.bool else out


def all_gather_rows(t: torch.Tensor, dim: int = 0, group=None):
    """Every rank's block of ``t`` concatenated along ``dim`` in rank
    order — the global array of a tensor dealt in contiguous blocks."""
    if dim == 0:
        g = all_gather(t, group)
        return g.reshape((-1,) + tuple(t.shape[1:]))
    return all_gather_rows(t.movedim(dim, 0).contiguous(), 0,
                           group).movedim(0, dim).contiguous()


def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """A reduced copy of ``t`` over the group (``op`` 'sum' or 'max')."""
    red = {"sum": tdist.ReduceOp.SUM, "max": tdist.ReduceOp.MAX}[op]
    calls["all_reduce"] += 1
    out = _wire(t).clone()
    tdist.all_reduce(out, op=red, group=group)
    return out.to(torch.bool) if t.dtype == torch.bool else out


def reduce_scatter(t: torch.Tensor, dim: int = 0,
                   group=None) -> torch.Tensor:
    """The sum of every rank's ``t``, split along ``dim`` into one block a
    rank in rank order: this rank's block."""
    p = world(group)
    if t.shape[dim] % p:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"over {p} ranks")
    calls["reduce_scatter"] += 1
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // p,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    scatter = getattr(tdist, "reduce_scatter_single", None) \
        or tdist.reduce_scatter_tensor
    scatter(out, src, op=tdist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim).contiguous()


class _AllReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce(t, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), "sum", ctx.group), None


def all_reduce_grad(t: torch.Tensor, group=None) -> torch.Tensor:
    """:func:`all_reduce` (sum) that autograd differentiates: the gradient
    of a rank's ``t`` is the sum of every rank's gradient of the result
    (one more all-reduce in the backward)."""
    return _AllReduceGrad.apply(t, group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), "sum", ctx.group), None


def copy_to_group(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` itself, into a product split over ``group``: each rank's
    gradient of it is the part its own block reaches, so the backward sums
    them (one :func:`all_reduce`)."""
    return _CopyToGroup.apply(t, group)


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(t, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_from_group(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of every rank's partial ``t`` (one
    :func:`all_reduce`), out of a product split over it: the result is
    replicated, so each rank's gradient of its ``t`` is the result's."""
    return _ReduceFromGroup.apply(t, group)


class _AllGatherGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_rows(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


def all_gather_grad(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """:func:`all_gather_rows` along ``dim`` that autograd differentiates,
    for a gathered tensor that each rank uses only in part: the gradient of
    a rank's block is its block of the sum of every rank's gradient of the
    whole (one :func:`reduce_scatter`)."""
    return _AllGatherGrad.apply(t, dim % t.dim(), group)


class _ReduceScatterGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_rows(g.contiguous(), ctx.dim, ctx.group), None, \
            None


def reduce_scatter_grad(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """:func:`reduce_scatter` along ``dim`` that autograd differentiates,
    out of a product split over ``group`` into a tensor held in blocks
    (the sequence-parallel residual stream): every rank's partial ``t``
    reaches every block, so its gradient is every rank's block of the
    result's gradient, gathered (one :func:`all_gather_rows`)."""
    return _ReduceScatterGrad.apply(t, dim % t.dim(), group)


class _AllGatherWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.lo, ctx.n = dim, rank(group) * t.shape[dim], t.shape[dim]
        return all_gather_rows(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.lo, ctx.n), None, None


def all_gather_whole(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """:func:`all_gather_rows` along ``dim`` that autograd differentiates,
    for a gathered tensor that every rank uses whole, as the others do
    (a replicated activation): the gradient of the whole is then the same
    on every rank, and a rank's block takes its block of it (no
    collective in the backward)."""
    return _AllGatherWhole.apply(t, dim % t.dim(), group)


class _GatherBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, token, b, gather, reduce, sink):
        ctx.reduce, ctx.sink = reduce, sink
        return gather(b)

    @staticmethod
    def backward(ctx, g):
        ctx.sink(ctx.reduce(g))
        return torch.zeros((), dtype=torch.float32, device=g.device), \
            None, None, None, None


def gather_block(b: torch.Tensor, gather, reduce, sink,
                 token: torch.Tensor) -> torch.Tensor:
    """``gather(b)``, the weight a rank's forward uses from its block ``b``
    of a parameter (``sharding.gather``: :func:`all_gather_rows` along each
    split dim), which autograd differentiates as :func:`all_gather_grad`
    does, but in fp32. Autograd casts the gradient a Function returns to
    its input's dtype, so a bf16 block given its summed gradient would get
    it rounded to bf16. The backward therefore returns none for ``b``:
    ``reduce`` turns the gradient of the whole into this rank's fp32 block
    of its sum (cast to fp32 first, reduce-scattered over the dims whose
    axes split the batch, all-reduced over the batch axes the block does
    not name) and ``sink`` takes that block into fp32 buffers the caller
    owns. ``token``, a 0-d tensor that requires grad and is shared by every
    gather of one forward, carries autograd to each backward: differentiate
    the loss with respect to it (its gradient is zero)."""
    return _GatherBlock.apply(token, b, gather, reduce, sink)


def max_int(v: int, group=None, device=None) -> int:
    """The largest of every rank's int ``v`` (an agreed flag or count)."""
    t = torch.tensor([int(v)], dtype=torch.int64, device=device)
    return int(all_reduce(t, "max", group)[0])


def rank0_int(v: int, group=None, device=None) -> int:
    """Rank 0's int ``v`` on every rank."""
    t = torch.tensor([int(v)], dtype=torch.int64, device=device)
    return int(all_gather(t, group)[0, 0])


def ring_shift(t: torch.Tensor, group=None) -> torch.Tensor:
    """Send ``t`` to the next rank and receive the previous rank's (one
    step of the Alg. 6 ring). Every rank's ``t`` must have one shape."""
    p = world(group)
    if p == 1:
        return t
    calls["ring_shift"] += 1
    r = rank(group)
    src = t.contiguous()
    out = torch.empty_like(src)
    nxt, prv = (r + 1) % p, (r - 1) % p
    if group is not None:
        nxt = tdist.get_global_rank(group, nxt)
        prv = tdist.get_global_rank(group, prv)
    ops = [tdist.P2POp(tdist.isend, src, nxt, group),
           tdist.P2POp(tdist.irecv, out, prv, group)]
    for w in tdist.batch_isend_irecv(ops):
        w.wait()
    return out
