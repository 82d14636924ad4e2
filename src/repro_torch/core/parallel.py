"""Distributed SMO — the paper's Algorithms 3/4 on a ``torch.distributed``
process group (twin of ``repro.core.parallel``; dense or block-ELL, with or
without the kernel-row cache), and the process-group hooks of the batched
multi-problem runner (``GroupExchange``, ``make_parallel_multi_runner``).

The outer Alg. 5 control flow (shrink -> compact -> reconstruct ->
un-shrink -> re-optimize) is not here: it lives in :mod:`core.driver` and
is shared with the single-device solver. This module provides the hooks
that driver calls — the chunk runner, the Alg. 6 ring, the cache rewarm
and the placement of a buffer's shards.

Process model: one process per device (``launch.dist``), NCCL between
cards, gloo between CPU processes. Every rank holds the same ``(X, y)`` on
the host, as the reference's single controller does, and a contiguous
balanced block of the buffer on its device — the reference's mesh layout
(``dataplane.deal``). Mapping from the paper's MPI design:

  * MPI_Bcast of (x_up, x_low) and MPI_Allreduce of (beta_up, beta_low) ->
    ONE all-gather of every rank's candidate payload [beta_up, beta_low,
    alpha_up, y_up, alpha_low, y_low, (gid_up, gid_low), x_up, x_low]
    ((p, 6 [+ 2] + 2d) floats) and a replicated argmin / argmax over ranks,
    ties to the lowest rank — shards are contiguous, so that is the single
    solver's lowest global index;
  * the shrink counter's allreduce (Alg. 4) -> one all-reduce of the
    local active counts;
  * the gamma update (Eq. 6) runs rank-locally, through the same provider
    kernels as the single runner at ``m_per`` rows, with no communication.

So wss1 costs one all-gather and (with shrinking) one all-reduce an
iteration; wss2 one more all-gather, which elects i_low. A segment enqueues
exactly ``chunk_iters`` iterations gated by a device ``run`` flag (see
``core/smo.py``), so every rank enqueues the same collectives by
construction and the host never waits inside a dispatch; the epoch summary
is built from collectives, so it is the same on every rank.

Gradient reconstruction (Alg. 6) is a ring: every rank packs its block's
support vectors (rows, squared norms, coef), and the packs rotate one
rank a step for p steps while each rank adds ``kernel_fns.recon_block``
partials for its own stale rows, over the single solver's block plan. At
one rank that is the single solver's computation, bit for bit; the host
(``mirror='host'``) and device-mirror backends feed it the same bits.

Checkpoints (``SVMConfig(checkpoint_dir=...)``, ``core/driver.py``): every
rank reaches every save and dispatch boundary with the same host state and
the same chaos counters; rank 0 writes the step (the (n,) masters are whole
on every rank) and every rank learns whether the write failed; on resume
rank 0 picks the newest complete step and every rank restores it; the
straggler watchdog's flag is all-reduced (max) before it is used.
``ParallelSMOSolver(devices=m)`` trains on the first m ranks of the group
(a subgroup made collectively) and hands rank 0's model to the others: an
elastic rescale is a restart at another world size, re-dealt from the
step's masters.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

from repro_torch.core import dataplane, kernel_fns
from repro_torch.core import mirror as mirror_mod
from repro_torch.core import multi
from repro_torch.core import reconstruct, rowcache, smo, solver, util
from repro_torch.data import sparse as spfmt
from repro_torch.kernels import ops
from repro_torch.launch import dist


def make_parallel_chunk_runner(kernel: str, C: float, inv_2s2: float,
                               shrink_interval: int, selection: str = "wss1",
                               fmt: str = "dense", cache_slots: int = 0,
                               cache_policy: str = "lru", group=None):
    """The distributed twin of ``smo.make_chunk_runner``, with its
    signature::

        state, cache, summary = run_epoch(data, y, state, cache, tol, k,
                                          chunk_iters, max_iters,
                                          compact_lt, mper_lo)

    where ``data``, ``y``, ``state``'s (m_per,) arrays and the cache's
    value table (slots, m_per) are this rank's shard, and the scalars, the
    cache's tags, stamps and counters and ``summary`` are the same on every
    rank. ``compact_lt`` is over the whole buffer. ``summary``'s last p
    entries are the per-shard surviving ELL extents (zeros on dense
    buffers).

    wss1 elects the pair from the fused candidate all-gather. wss2 takes
    i_up and the betas from it, then produces the i_up row rank-locally,
    scores its rows and elects i_low by a second all-gather of (score,
    gamma, alpha, y, K(up, cand)[, gid], x_cand) — the update prices the
    pair with the kernel value it was scored by, as the single runner does.
    ELL candidate rows are densified before the gather. With the cache on,
    lookups key on global ids, which ride the payloads bitcast into float
    lanes, so every rank takes the same hit/miss branches and each writes
    its own segment of the rows.
    """
    if selection not in ("wss1", "wss2"):
        raise ValueError(f"unknown selection {selection!r}")
    if cache_policy not in rowcache.POLICIES:
        raise ValueError(f"unknown row_cache_policy {cache_policy!r}; "
                         f"known: {rowcache.POLICIES}")
    row1 = kernel_fns.get_row(kernel)
    kself = kernel_fns.self_kernel(kernel)
    provider = kernel_fns.make_provider(kernel, fmt, True, inv_2s2)
    cached = cache_slots > 0
    gl = 2 if cached else 0               # gid lanes in the candidate payload
    thr0, thr1 = smo.bounds(C)
    Cf = smo.f32(C)
    p, me = dist.world(group), dist.rank(group)

    def pick(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
        return t.index_select(0, i.view(1))[0]

    def run_epoch(data, y: torch.Tensor, state: smo.SMOState, cache,
                  tol: float, k: int, chunk_iters: int, max_iters: int,
                  compact_lt: int, mper_lo: int):
        dev = y.device
        m = data.m
        pos = y > 0
        tol = smo.f32(tol)
        kdiag = provider.diag(data) if selection == "wss2" else None
        get_row1, get_rows2 = rowcache.make_accessors(provider, data, cached,
                                                      cache_policy)
        gid32 = data.gids.to(torch.int32) if cached else None

        def lanes(idx):    # global ids of local rows idx, bitcast to f32
            return gid32.index_select(0, idx).view(torch.float32)

        def gid_of(lane):  # a (1,) f32 lane back to a (1,) i64 global id
            return lane.view(torch.int32).to(torch.int64)

        def gather_select(gamma, alpha, active):
            """Local Eq. 8 and the fused candidate exchange: the replicated
            winners, and this rank's local candidate indices."""
            b_up, j_up, b_low, j_low = smo._select(gamma, alpha, pos, active,
                                                   thr0, thr1)
            j2 = torch.stack([j_up, j_low])
            a2, y2 = alpha.index_select(0, j2), y.index_select(0, j2)
            parts = [torch.stack([b_up, b_low, a2[0], y2[0], a2[1], y2[1]])]
            if cached:
                parts.append(lanes(j2))
            parts.append(data.dense_rows(j2).reshape(-1))
            pays = dist.all_gather(torch.cat(parts), group)
            k_up = torch.argmin(pays[:, 0])
            k_low = torch.argmax(pays[:, 1])
            up, low = pick(pays, k_up), pick(pays, k_low)
            off = 6 + gl
            d = (pays.shape[1] - off) // 2
            sel = dict(b_up=up[0], b_low=low[1], a_up=up[2], y_up=up[3],
                       a_low=low[4], y_low=low[5], x_up=up[off: off + d],
                       x_low=low[off + d:], k_up=k_up, k_low=k_low,
                       j_up=j_up, j_low=j_low)
            if cached:
                sel["gid_up"] = gid_of(up[6:7])
                sel["gid_low"] = gid_of(low[7:8])
            return sel

        def owner_write(alpha, j, owner, v):
            """alpha[j] = v on the rank that owns the elected row."""
            jv = j.view(1)
            keep = alpha.index_select(0, jv)
            alpha.index_put_((jv,), torch.where(owner == me, v.view(1), keep))

        def body(s: smo.SMOState, sel: dict, c, run: torch.Tensor):
            x_up = sel["x_up"]
            gid_low = sel.get("gid_low")
            if selection == "wss2":
                k_uu = kself(x_up[None], inv_2s2)[0]
                row_up, c = get_row1(c, sel.get("gid_up"), x_up, run)
                scores = smo._wss2(s.gamma, s.alpha, pos, s.active, thr0,
                                   thr1, s.beta_up, row_up, kdiag, k_uu)
                j2 = torch.argmax(scores).view(1)
                parts = [torch.cat([t.index_select(0, j2) for t in
                                    (scores, s.gamma, s.alpha, y, row_up)])]
                if cached:
                    parts.append(lanes(j2))
                parts.append(data.dense_rows(j2).reshape(-1))
                pays2 = dist.all_gather(torch.cat(parts), group)
                k_low = torch.argmax(pays2[:, 0])
                low = pick(pays2, k_low)
                g_low, a_low, y_low, k_ul = low[1], low[2], low[3], low[4]
                x_low = low[5 + (1 if cached else 0):]
                if cached:
                    gid_low = gid_of(low[5:6])
                j_low = j2[0]
            else:
                g_low = sel["b_low"]
                a_low, y_low, x_low = sel["a_low"], sel["y_low"], sel["x_low"]
                k_low, j_low = sel["k_low"], sel["j_low"]
                k_ul = row1(x_low[None], torch.sum(x_low * x_low)[None],
                            x_up, inv_2s2)[0]
            z2 = torch.stack([x_up, x_low])
            ks = kself(z2, inv_2s2)
            y2 = torch.stack([sel["y_up"], y_low])
            a2 = torch.stack([sel["a_up"], a_low])
            a_up_new, a_low_new = smo.pair_update(
                a2[0], a2[1], y2[0], y2[1], s.beta_up, g_low, k_ul, ks[0],
                ks[1], Cf)
            new2 = torch.where(run, torch.stack([a_up_new, a_low_new]), a2)
            delta = new2 - a2
            stalled = s.stalled | (run & torch.all(torch.abs(delta)
                                                   < smo._TAU))
            alpha = s.alpha
            owner_write(alpha, sel["j_up"], sel["k_up"], new2[0])
            owner_write(alpha, j_low, k_low, new2[1])
            coef2 = y2 * delta                       # zero unless run
            if selection == "wss2":
                row_low, c = get_row1(c, gid_low, x_low, run)
                gamma = s.gamma + coef2[0] * row_up + coef2[1] * row_low
            elif cached:
                rows, c = get_rows2(c, torch.cat([sel["gid_up"], gid_low]),
                                    z2, run)
                gamma = ops.gamma_from_rows(s.gamma, rows, coef2)
            else:
                gamma = provider.gamma_update(data, s.gamma, z2, coef2)
            gamma = torch.where(run, gamma, s.gamma)

            step1 = s.step + run
            active, next_shrink, n_shrinks = (s.active, s.next_shrink,
                                              s.n_shrinks)
            if shrink_interval > 0:
                do_shrink = run & (step1 >= s.next_shrink)
                active = torch.where(
                    do_shrink, smo._shrink(gamma, alpha, pos, s.active,
                                           s.beta_up, s.beta_low, thr0,
                                           thr1), s.active)
                # Alg. 4 line 12: the allreduce of the local active counts
                n_act = dist.all_reduce(active.sum(), "sum", group)
                interval = torch.clamp(
                    torch.clamp(n_act, max=shrink_interval), min=1)
                next_shrink = torch.where(do_shrink, step1 + interval,
                                          s.next_shrink)
                n_shrinks = s.n_shrinks + do_shrink
            sel = gather_select(gamma, alpha, active)
            return smo.SMOState(
                alpha, gamma, active, sel["b_up"], sel["b_low"], sel["j_up"],
                sel["j_low"], step1, next_shrink, n_shrinks,
                sel["b_up"] + tol >= sel["b_low"], stalled), sel, c

        def run_segment(s: smo.SMOState, c, live: torch.Tensor):
            # segment entry: re-elect the global working set and clear the
            # stall latch (masked when the epoch is already done)
            sel = gather_select(s.gamma, s.alpha, s.active)
            s = s.replace(
                beta_up=torch.where(live, sel["b_up"], s.beta_up),
                beta_low=torch.where(live, sel["b_low"], s.beta_low),
                converged=torch.where(live, sel["b_up"] + tol >= sel["b_low"],
                                      s.converged),
                stalled=s.stalled & ~live)
            end = s.step + torch.clamp(
                torch.clamp(max_iters - s.step, min=1), max=chunk_iters)
            for _ in range(chunk_iters):
                run = live & ~s.converged & ~s.stalled & (s.step < end)
                s, sel, c = body(s, sel, c, run)
            return s, c

        s, c = state, cache
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        segs, n_act, need_c = zero, zero, torch.zeros((), dtype=torch.bool,
                                                      device=dev)
        min_act = torch.full((), np.iinfo(np.int32).max, dtype=torch.int64,
                             device=dev)
        done = need_c
        for _ in range(max(1, int(k))):
            live = ~done
            s, c = run_segment(s, c, live)
            n_seg = dist.all_reduce(s.active.sum(), "sum", group)
            min_act = torch.where(live, torch.minimum(min_act, n_seg),
                                  min_act)
            hard = s.converged | s.stalled | (s.step >= max_iters)
            if shrink_interval > 0:
                # the compaction predicate over the whole buffer (exact
                # integers): n_active below ceil(compact_ratio * m * p),
                # and the rebuilt buffer smaller after pow2 bucketing
                m_per_new = util.bucket_pow2_device(
                    torch.div(n_seg + p - 1, p, rounding_mode="floor"),
                    mper_lo)
                nc = ~hard & (n_seg < compact_lt) & (m_per_new < m)
            else:
                nc = torch.zeros((), dtype=torch.bool, device=dev)
            need_c = torch.where(live, nc, need_c)
            n_act = torch.where(live, n_seg, n_act)
            segs = segs + live
            done = done | hard | nc
        if fmt == "ell" and shrink_interval > 0:
            # each rank's survivors' extents by the shard the re-layout
            # deals them to, then the maximum over ranks (exact integers)
            counts = dist.all_gather(s.active.sum().view(1), group)
            ext = dataplane.ell_shard_extents_dyn(
                data.vals, s.active, n_act, p, counts[:me].sum())
            shard_ext = torch.where(need_c, dist.all_reduce(ext, "max", group),
                                    0)
        else:
            shard_ext = torch.zeros((p,), dtype=torch.int64, device=dev)
        hits, misses = (c.hits, c.misses) if cached else (zero, zero)
        summary = torch.cat([
            torch.stack([s.step, segs, n_act, min_act, s.n_shrinks,
                         s.converged.to(torch.int64),
                         s.stalled.to(torch.int64),
                         need_c.to(torch.int64), hits, misses]), shard_ext])
        return s, c, summary

    return run_epoch


# -- batched multi-problem training ----------------------------------------

class GroupExchange:
    """The process-group twin of ``core.multi.LocalExchange``: the hooks
    that make the batched multi-problem runner sharded. Per joint
    iteration, selection is ONE all-gather of every rank's (K, 6 + 2d)
    candidate payloads [beta_up, beta_low, alpha_up, y_up, alpha_low,
    y_low, x_up, x_low] with a (K,) argmin / argmax over ranks (ties to the
    lowest rank, so to the lowest global index); the elected rows' owners
    write the new alphas; counts are all-reduced."""

    def __init__(self, group=None):
        self.group = group
        self.me = dist.rank(group)

    def select(self, data, ystk, gamma, alpha, active, thr0, thr1):
        take = multi.take
        b_up, j_up, b_low, j_low = smo.select_pair_multi(
            gamma, alpha, ystk, active, thr0, thr1)
        pay = torch.cat([
            torch.stack([b_up, b_low, take(alpha, j_up), take(ystk, j_up),
                         take(alpha, j_low), take(ystk, j_low)], 1),
            data.dense_rows(j_up), data.dense_rows(j_low)], 1)
        pays = dist.all_gather(pay, self.group)              # (p, K, 6+2d)
        kk = torch.arange(pay.shape[0], device=pay.device)
        k_up = torch.argmin(pays[:, :, 0], 0)
        k_low = torch.argmax(pays[:, :, 1], 0)
        up, low = pays[k_up, kk], pays[k_low, kk]
        d = (pay.shape[1] - 6) // 2
        return multi.Sel(up[:, 0], low[:, 1], j_up, j_low, up[:, 2], up[:, 3],
                   low[:, 4], low[:, 5], up[:, 6: 6 + d].contiguous(),
                   low[:, 6 + d:].contiguous(), k_up, k_low)

    def write(self, alpha, kk, j, owner, v):
        """alpha[k, j[k]] = v[k] on the rank that owns the elected row of
        problem k."""
        alpha.index_put_((kk, j), torch.where(owner == self.me, v,
                                              multi.take(alpha, j)))

    def count(self, t: torch.Tensor) -> torch.Tensor:
        return dist.all_reduce(t, "sum", self.group)


def make_parallel_multi_runner(kernel: str, inv_2s2: float,
                               shrink_interval: int, fmt: str = "dense",
                               group=None):
    """The batched multi-problem runner (``core.multi.make_multi_runner``,
    wss1, cache off) on the process group ``group``, through
    :class:`GroupExchange`. ``data``, ``ystk`` and the state's (K, m_per)
    arrays are this rank's shard of the buffer; the state's (K,) vectors,
    ``lanes`` and the summary are the same on every rank. Each rank updates
    its rows' gamma with the same per-problem kernel calls as the
    single-device runner. Shrinking is logical only: the driver keeps the
    buffer whole (it passes ``compact_lt`` 0), as in the reference."""
    return multi.make_multi_runner(kernel, inv_2s2, shrink_interval,
                                   fmt=fmt, exchange=GroupExchange(group))


# -- Alg. 6: the ring ------------------------------------------------------

def _pack(sv_data, coef: torch.Tensor) -> torch.Tensor:
    """One f32 (rows, w) block of SV rows, squared norms and coef — the
    ring's payload (ELL column ids bitcast into float lanes)."""
    if isinstance(sv_data, dataplane.ELLData):
        rows = [sv_data.vals, sv_data.cols.view(torch.float32)]
    else:
        rows = [sv_data.X]
    return torch.cat(rows + [sv_data.sq_norms[:, None], coef[:, None]], 1)


def _unpack(block: torch.Tensor, fmt: str, n_features: int) -> tuple:
    """(SV data, coef) of a payload block (inverse of :func:`_pack`)."""
    sq, coef = block[:, -2].contiguous(), block[:, -1].contiguous()
    if fmt == "ell":
        K = (block.shape[1] - 2) // 2
        return dataplane.ELLData(
            block[:, :K].contiguous(),
            block[:, K: 2 * K].contiguous().view(torch.int32), sq,
            n_features), coef
    return dataplane.DenseData(block[:, :-2].contiguous(), sq), coef


def make_ring_reconstructor(kernel: str, inv_2s2: float, fmt: str,
                            n_features: int, recon_block: int, group=None):
    """Distributed Alg. 6 (twin of the reference's ppermute ring)::

        acc = ring(own, counts, query, n_query)

    ``own`` is this rank's payload (:func:`_pack` of its support vectors,
    zero rows past them, one row count on every rank), ``counts`` every
    rank's SV count (host ints), ``query(s)`` the s-th dense (row_blk, d)
    block of this rank's stale rows and ``n_query`` their number. For p
    steps each rank adds ``kernel_fns.recon_block`` partials of the
    payload it holds — that block's SVs in the single solver's SV blocks,
    its stale rows in the single solver's row blocks, in the same order —
    then passes the payload to the next rank. Returns the stale rows'
    fp64 sums (the caller subtracts y). The blocks are plain PyTorch, as
    the reference computes them outside any kernel."""
    provider = kernel_fns.make_provider(kernel, fmt, False, inv_2s2)
    p, me = dist.world(group), dist.rank(group)

    def ring(own: torch.Tensor, counts: list, query, n_query: int):
        row_blk, nrb = reconstruct.plan_blocks(n_query, recon_block)
        acc = torch.zeros((nrb * row_blk,), dtype=torch.float64,
                          device=own.device)
        held = own
        for t in range(p):
            n_src = counts[(me - t) % p]
            if n_src and n_query:
                sv_blk, nsb = reconstruct.plan_blocks(n_src, recon_block)
                for b in range(nsb):
                    svd, coef = _unpack(held[b * sv_blk: (b + 1) * sv_blk],
                                        fmt, n_features)
                    for s in range(nrb):
                        acc[s * row_blk: (s + 1) * row_blk] += \
                            kernel_fns.recon_block(provider, svd, query(s),
                                                   coef)
            if t < p - 1:
                held = dist.ring_shift(held, group)
        return acc[:n_query]

    return ring


def _payload_rows(counts: list, recon_block: int) -> int:
    """Rows of every rank's ring payload: room for the largest SV block
    plan (zero rows past each rank's SVs)."""
    rows = [b * n for b, n in (reconstruct.plan_blocks(c, recon_block)
                               for c in counts if c)]
    return max(rows, default=1)


# -- row cache rewarm --------------------------------------------------------

def make_cache_warmer(kernel: str, inv_2s2: float, fmt: str, pairs: bool,
                      group=None):
    """Rewarm of the sharded cache value table across un-shrink growth
    (twin of the reference's ``make_cache_warmer``)::

        vals = warm(data, tags, n)

    The tags' query rows are gathered once — each rank contributes the
    rows its shard holds, and every rank takes each tag's row from the rank
    that holds it (a bit copy) — then each rank recomputes its own
    (slots, m_per) segment with the in-loop kernels
    (``rowcache.warm_vals``), so later hits serve the bits an in-loop miss
    on that rank would have produced."""
    provider = kernel_fns.make_provider(kernel, fmt, True, inv_2s2)

    def warm(data, tags: torch.Tensor, n: int) -> torch.Tensor:
        gids = data.gids
        inv = torch.full((n + 1,), -1, dtype=torch.int64, device=gids.device)
        inv.scatter_(0, torch.where(gids >= 0, gids, n),
                     torch.arange(gids.shape[0], device=gids.device))
        here = (inv.index_select(0, torch.clamp(tags, 0, n)) >= 0) \
            & (tags >= 0)
        zq_all = dist.all_gather(rowcache.tag_queries(data, tags, n), group)
        owner = torch.argmax(dist.all_gather(here, group).to(torch.int32), 0)
        zq = zq_all[owner, torch.arange(tags.shape[0], device=tags.device)]
        return rowcache.warm_vals(provider, data, zq, tags, pairs)

    return warm


# -- the solver --------------------------------------------------------------

class ParallelSMOSolver(solver.SMOSolver):
    """Multi-device SMO with adaptive shrinking on a process group, trained
    through the same :class:`core.driver.EpochDriver` as the single-device
    solver: this class swaps the hook surface — the chunk runner
    (``_runner``), the shards' placement (``_put`` / ``_gather`` /
    ``_shard``; the (n,) masters stay whole on every rank, ``_put_full``),
    the Alg. 6 ring (``_reconstruct`` / ``_reconstruct_mirror``) and the
    cache rewarm (``_regrow_cache``).

    Every rank of ``group`` (the default group when None; see
    ``launch.dist.init``) calls ``fit`` with the same ``(X, y)`` and gets
    the same ``SVMModel``. ``config.device`` 'cuda' trains on the rank's
    card (NCCL), 'cpu' on the CPU (gloo)."""

    def __init__(self, config: solver.SVMConfig, group=None,
                 devices: "int | None" = None):
        """``devices``: train on the first ``devices`` ranks of ``group``
        (an elastic rescale target: a resumed checkpoint is re-dealt for
        this many shards, whatever world size saved it). Every rank of
        ``group`` builds the solver (the subgroup is made collectively) and
        calls ``fit``; ranks past ``devices`` take no part in training and
        receive rank 0's model."""
        if not dist.initialized():
            raise RuntimeError(
                "ParallelSMOSolver needs a process group: call "
                "repro_torch.launch.dist.init() in every rank first")
        super().__init__(config)
        self.parent = group
        self.member = True
        if devices is not None:
            world = dist.world(group)
            if not 1 <= int(devices) <= world:
                raise ValueError(
                    f"ParallelSMOSolver(devices={devices!r}) on a group of "
                    f"{world} ranks: want 1 <= devices <= {world}")
            ranks = [torch.distributed.get_global_rank(group, r)
                     if group is not None else r for r in range(devices)]
            self.member = dist.rank(group) < int(devices)
            sub = torch.distributed.new_group(ranks=ranks,
                                              timeout=dist.TIMEOUT)
            group = sub if devices < world else group
        self.group = group
        self.p, self.rank = ((dist.world(group), dist.rank(group))
                             if self.member else (int(devices), -1))
        backend = torch.distributed.get_backend(self.parent)
        want = "nccl" if self.device.type == "cuda" else "gloo"
        if backend != want:
            raise ValueError(f"device {config.device!r} needs a {want} "
                             f"process group, not {backend}")
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())

    # -- checkpoint hooks: rank 0 writes, every verdict is agreed ----------
    def _is_writer(self) -> bool:
        return self.rank == 0

    def _agree_max(self, v: int) -> int:
        return dist.max_int(v, self.group, self.device)

    def _from_writer(self, v: int) -> int:
        return dist.rank0_int(v, self.group, self.device)

    # -- placement of the buffer's shards ----------------------------------
    def _nshards(self) -> int:
        return self.p

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        """This rank's block of a global buffer array."""
        m = arr.shape[0] // self.p
        return super()._put(arr[self.rank * m: (self.rank + 1) * m])

    def _gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return dist.all_gather_rows(t, dim, self.group)

    def _shard(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        m = t.shape[dim] // self.p
        return t.narrow(dim, self.rank * m, m).clone(
            memory_format=torch.contiguous_format)

    def _runner(self, cfg: solver.SVMConfig, interval: int):
        slots = self._cache_slots()
        policy = cfg.row_cache_policy if slots else "lru"
        key = (interval, slots, policy)
        if key not in self._runners:
            self._runners[key] = make_parallel_chunk_runner(
                cfg.kernel, cfg.C, cfg.inv_2s2, interval,
                selection=cfg.selection, fmt=cfg.format, cache_slots=slots,
                cache_policy=policy, group=self.group)
        return self._runners[key]

    def _regrow_cache(self, cache, data, pairs: bool, n: int):
        if cache is None:
            return None
        key = ("warm", pairs)
        if key not in self._runners:
            self._runners[key] = make_cache_warmer(
                self.cfg.kernel, self.cfg.inv_2s2, self._store.fmt, pairs,
                self.group)
        return cache.replace(vals=self._runners[key](data, cache.tags, n))

    # -- Alg. 6 ---------------------------------------------------------------
    def _ring(self):
        store = self._store
        key = ("ring", store.fmt, store.n_features)
        if key not in self._runners:
            self._runners[key] = make_ring_reconstructor(
                self.cfg.kernel, self.cfg.inv_2s2, store.fmt,
                store.n_features, self.cfg.recon_block, self.group)
        return self._runners[key]

    def _split(self, rows: np.ndarray, m_per: int, pos_of: np.ndarray):
        """Global ``rows`` by the rank whose block holds them: a list of
        index arrays into ``rows`` (order kept), one per rank."""
        rank_of = pos_of[rows] // m_per
        return [np.flatnonzero(rank_of == q) for q in range(self.p)]

    def _collect(self, mine: torch.Tensor, parts: list, total: int):
        """Every rank's fp64 results (``mine`` here, at ``parts[q]`` of a
        ``total``-long output) assembled on every rank, in order."""
        width = max(1, max(len(x) for x in parts))
        buf = torch.zeros((width,), dtype=torch.float64, device=mine.device)
        buf[: mine.shape[0]] = mine
        got = dist.all_gather(buf, self.group)
        out = torch.empty((total,), dtype=torch.float64, device=mine.device)
        for q, at in enumerate(parts):
            if len(at):
                out[torch.as_tensor(at, device=mine.device)] = \
                    got[q, : len(at)]
        return out

    def _sv_plan(self, sv: np.ndarray, m_per: int, pos_of: np.ndarray):
        """(per-rank SV ids, their counts, payload rows, ELL K_sv)."""
        store = self._store
        sv_by = [sv[at] for at in self._split(sv, m_per, pos_of)]
        counts = [int(a.size) for a in sv_by]
        K_sv = (reconstruct.sv_lane_budget(store, sv, self.cfg.ell_adaptive)
                if store.fmt == "ell" else None)
        return sv_by, counts, _payload_rows(counts, self.cfg.recon_block), \
            K_sv

    def _reconstruct(self, y, alpha, stale):
        """Distributed Alg. 6, host-streaming backend (``mirror='host'``):
        each rank builds its payload and its stale rows' query blocks from
        the host store, in the full set's buffer layout (the mirror's), and
        runs the ring. Returns ``stale``'s gamma in host fp64 on every
        rank."""
        store, cfg = self._store, self.cfg
        n = store.n
        stale = np.asarray(stale)
        sv = np.flatnonzero(alpha > 0.0)
        if sv.size == 0:
            return (-y[stale]).astype(np.float64)
        m_per = mirror_mod.full_m_per(n, self.p, cfg.min_buffer)
        _, pos_of = dataplane.full_layout(np.arange(n), self.p, m_per)
        sv_by, counts, rows, K_sv = self._sv_plan(sv, m_per, pos_of)
        mine = sv_by[self.rank]
        buf = store.alloc(rows, K_sv)
        store.fill(buf, slice(0, mine.size), mine)
        sq = np.zeros((rows,), np.float32)
        sq[: mine.size] = store.sq_rows(mine)
        coef = np.zeros((rows,), np.float32)
        coef[: mine.size] = (alpha[mine] * y[mine]).astype(np.float32)
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device)
        own = _pack(store.to_device(buf, put, sq=sq), put(coef))
        parts = self._split(stale, m_per, pos_of)
        q_rows = stale[parts[self.rank]]
        row_blk, _ = reconstruct.plan_blocks(q_rows.size, cfg.recon_block)

        def query(s):
            blk = q_rows[s * row_blk: (s + 1) * row_blk]
            Zi = np.zeros((row_blk, store.n_features), np.float32)
            Zi[: blk.size] = store.dense_rows(blk)
            return put(Zi)

        acc = self._ring()(own, counts, query, q_rows.size)
        g = acc - put(y[q_rows]).double()
        return self._collect(g, parts, stale.size).cpu().numpy()

    def _reconstruct_mirror(self, mir, alpha_d, gamma_d, sv_rows, stale):
        """Distributed Alg. 6 over the sharded mirror: the same ring as
        :meth:`_reconstruct`, every input derived on the device from this
        rank's mirror block and the (n,) masters. Writes the stale rows'
        gamma, rounded once to f32, into the master on every rank; returns
        it and their fp64 gamma."""
        cfg = self.cfg
        data = mir.data
        dev = gamma_d.device
        off = self.rank * mir.m_per
        sv_by, counts, rows, K_sv = self._sv_plan(sv_rows, mir.m_per,
                                                  mir.pos_of)
        sv_pos = mirror_mod.pad_pos(
            mir.pos_of[sv_by[self.rank]] - off, rows)
        svd, valid, safe = mirror_mod._sv_block(
            data, torch.as_tensor(sv_pos, device=dev), K_sv)
        gid = torch.where(valid, data.gids[safe], 0)
        coef = torch.where(valid, alpha_d[gid] * mir.y[safe], 0.0)
        own = _pack(svd, coef)
        parts = self._split(stale, mir.m_per, mir.pos_of)
        q_rows = stale[parts[self.rank]]
        row_blk, nrb = reconstruct.plan_blocks(q_rows.size, cfg.recon_block)
        q_pos = torch.as_tensor(mirror_mod.pad_pos(
            mir.pos_of[q_rows] - off, nrb * row_blk), device=dev)
        query = lambda s: mirror_mod._dense_block(
            data, q_pos[s * row_blk: (s + 1) * row_blk])
        acc = self._ring()(own, counts, query, q_rows.size)
        q_safe = torch.clamp(q_pos[: q_rows.size], min=0)
        g64 = self._collect(acc - mir.y[q_safe].double(), parts, stale.size)
        gamma_d[torch.as_tensor(stale, device=dev)] = g64.float()
        return gamma_d, g64

    # -- main ---------------------------------------------------------------
    def _fingerprint(self, X, y) -> list:
        """[n, d, crc32 of y, crc32 of X's values] — the input every rank
        must share."""
        if spfmt.is_csr_like(X):
            csr = spfmt.as_csr(X)
            parts, shape = (csr.data, csr.indices, csr.indptr), csr.shape
        else:
            X = np.ascontiguousarray(X, np.float32)
            parts, shape = (X,), X.shape
        crc = 0
        for a in parts:
            crc = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)
        yb = np.ascontiguousarray(y, np.float32).tobytes()
        return [int(shape[0]), int(shape[1]), zlib.crc32(yb), crc]

    def _agree(self, what: str, values: torch.Tensor) -> None:
        """Raise unless every rank holds the same ``values``."""
        got = dist.all_gather(values, self.group)
        if not bool((got == got[0]).all()):
            raise RuntimeError(f"ranks disagree on {what}")

    def fit(self, X, y: np.ndarray) -> solver.SVMModel:
        """Train on ``(X, y)`` on every rank of the group (each passes the
        same arrays); returns the same model on every rank. With
        ``devices`` below the group's size the first ``devices`` ranks
        train and the others receive rank 0's model."""
        model = None
        if self.member:
            self._agree("the training input (n, d, crc32 of y and X)",
                        torch.tensor(self._fingerprint(X, y),
                                     dtype=torch.int64, device=self.device))
            model = super().fit(X, y)
            self._agree("the trained alpha", torch.as_tensor(
                model.alpha.view(np.int32), device=self.device))
        if self.group is not self.parent:
            box = [model if dist.rank(self.parent) == 0 else None]
            torch.distributed.broadcast_object_list(
                box, src=(torch.distributed.get_global_rank(self.parent, 0)
                          if self.parent is not None else 0),
                group=self.parent)
            model = model if self.member else box[0]
        return model
