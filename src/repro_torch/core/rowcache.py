"""Device-resident LRU/SLRU cache of kernel rows (twin of
``repro.core.rowcache``).

The paper recomputes every kernel row each iteration (Sec. 3.1.1, "no
kernel cache"). Near convergence SMO's working set collapses onto a few
hot samples, and the same rows K(x_g, buffer) are asked for again and
again. This module puts a fixed-slot cache of those rows in front of the
row providers (``kernel_fns``), for dense and block-ELL buffers alike.

Layout
------
``RowCache`` holds tensors on the buffer's device:

  * ``tags``  (S,)  i64 — **global** sample id cached in each slot, -1 empty;
  * ``vals``  (S, M) f32 — the cached rows K(x_tag, buffer) over the
    current buffer's M positions;
  * ``stamp`` (S,)  i64 — last-use tick per slot (recency eviction order);
  * ``seg``   (S,)  i64 — SLRU segment per slot (0 probationary /
    1 protected; identically 0 under plain LRU);
  * ``tick`` / ``hits`` / ``misses`` — 0-d i64.

The solver buckets the slot count S to a power of two
(``SVMConfig.row_cache_slots``, :func:`bucket_slots`), as the reference
does. The value table is written in place: the chunk runner owns the
cache it is given, as the reference's donates it.

Eviction policies
-----------------
``policy='lru'`` (default) evicts the least-recently-used slot. LRU has a
known pathology on cyclic access patterns: when the working set exceeds
the slot count, every access evicts the row needed furthest in the future
and the hit rate collapses. ``policy='slru'`` (segmented LRU) splits the
slots into a probationary and a protected segment (protected capacity
S // 2): rows enter probationary on a miss, are *promoted* to protected on
their first hit, and only probationary slots are eviction victims, so a
one-shot scan churns only the probationary half. Promotion past the
protected capacity demotes the protected LRU slot back to probationary
(its value and stamp survive). Both policies only change *which* rows stay
cached; cached values are exact either way.

Hits without a host branch
--------------------------
The reference's ``lax.cond(hit, cached rows, compute)`` has no eager
counterpart that does not wait for the card, and the segment never waits
(``core/smo.py``). So an access launches the cached entry of the two-row
kernel in every case (``rbf_rows2_cached`` / ``ell_kernel_rows2_cached``,
through the provider's ``rows2_cached``): it reads the device hit flag and
on a hit copies the two table rows into its output and does nothing else;
on a miss it computes as ``rows2`` does, with the same bits. The tag,
stamp and segment writes are unconditional, on device indices, as in the
reference. No step reads a device value on the host.

No-op iterations
----------------
The port's segment runs a fixed number of iterations; those past
convergence, a stall or the limit are no-ops with ``run`` False. Every
access takes ``live=run``, and an access that is not live leaves the cache
exactly as it found it: tick, tags, stamps, segments, values and counters
(its kernel launch serves the rows of the slots it would write, and writes
them back). The reference's ``live`` gates only the counters: there it
marks the idle repeats of a batched fit's retired problems. Here a no-op
iteration stands for one the reference's loop never ran, and letting it
write would move the eviction order and the counters off the reference's.

Exactness
---------
Cached rows are exact values produced by the *same* provider kernels the
cache-off path runs, and the hit policy for the fused two-row access is
pairwise (serve from the table only when **both** rows are present, else
recompute both rows in one pass as the cache-off path would): cache-on and
cache-off therefore produce bit-identical alpha/iteration trajectories
wherever the cache-off path computes its rows with the same kernel. That
holds for wss2 everywhere and for wss1 on the CPU; on the card the
cache-off wss1 path runs the fused ``gamma_update`` instead of rows and an
epilogue (the reference's Pallas path has the same split).

Invalidation-by-remap contract
------------------------------
A cached entry is a row over *buffer positions*, while its tag is a
*global* id, which survives compaction:

  * **compaction** (the new buffer's rows are a subset of the old):
    cached rows are *re-gathered* column-wise into the new geometry
    (:func:`remap_cache_device` on the device plan, :func:`remap_cache` on
    the host backend's ``idx_buf`` arrays); new padding columns are zeroed
    (padding rows are never active). A row's bits do not depend on its
    place in the buffer, nor, on ELL, on the lane budget K.
  * **reconstruction / un-shrink** (the buffer grows back): re-added
    positions have no cached values, so every tagged slot's row is
    recomputed over the grown buffer with the in-loop kernels
    (:func:`regrow_cache`); tags, recency and counters carry across and the
    first accesses after growth hit. (:func:`remap_cache` drops the cache
    wholesale for callers that cannot rewarm.)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import kernel_fns

POLICIES = ("lru", "slru")
_STAMP_MAX = 2**31 - 1   # the reference's i32 maximum: never a real stamp


@dataclasses.dataclass
class RowCache:
    """Fixed-slot LRU/SLRU kernel-row cache (see module docstring)."""
    tags: torch.Tensor     # (S,) i64 global sample ids, -1 = empty slot
    vals: torch.Tensor     # (S, M) f32 cached rows over buffer positions
    stamp: torch.Tensor    # (S,) i64 last-use tick
    seg: torch.Tensor      # (S,) i64 SLRU segment (0 prob / 1 prot)
    tick: torch.Tensor     # i64 — bumped once per live access
    hits: torch.Tensor     # i64 — rows served from the value table
    misses: torch.Tensor   # i64 — rows (re)computed by the provider

    def replace(self, **kw) -> "RowCache":
        return dataclasses.replace(self, **kw)


def init_cache(slots: int, m: int, device=None) -> RowCache:
    """Empty cache for a buffer of M positions, on ``device``."""
    i64 = dict(dtype=torch.int64, device=device)
    return RowCache(
        tags=torch.full((slots,), -1, **i64),
        vals=torch.zeros((slots, m), dtype=torch.float32, device=device),
        stamp=torch.zeros((slots,), **i64),
        seg=torch.zeros((slots,), **i64),
        tick=torch.zeros((), **i64),
        hits=torch.zeros((), **i64),
        misses=torch.zeros((), **i64))


def bucket_slots(slots: int) -> int:
    """Power-of-two slot bucketing (>= 2), as the reference buckets them."""
    s = max(2, int(slots))
    return 1 << (s - 1).bit_length()


def _find(tags: torch.Tensor, gid: torch.Tensor):
    """(slot, present) of each global id in ``gid`` (shape (k,)): its first
    slot (the reference's argmax) and whether any slot holds it."""
    present = tags.view(-1, 1) == gid.view(1, -1)
    return present.to(torch.int32).argmax(0), present.any(0)


def _write(tags, stamp, seg, gid, present, slot_e, tick, policy: str):
    """Tag ``gid`` in its existing slot ``slot_e`` when ``present``, else
    in the policy's eviction victim, stamped ``tick``. Returns new
    (tags, stamp, seg, slot); the caller writes the value row.

    ``lru``: victim = least-recently-used slot; ``seg`` untouched (all 0).
    ``slru``: victim = least-recently-used *probationary* slot (protected
    slots are never evicted by an insert); a hit promotes its slot to
    protected, demoting the protected LRU back to probationary when the
    protected segment is at capacity (S // 2). |protected| <= S // 2 < S,
    so a probationary victim always exists.
    """
    if policy == "lru":
        slot = torch.where(present, slot_e, torch.argmin(stamp))
    else:
        prot = seg == 1
        victim = torch.argmin(torch.where(prot, _STAMP_MAX, stamp))
        slot = torch.where(present, slot_e, victim)
        need_demote = present & (seg.gather(0, slot.view(1))[0] == 0) \
            & (prot.sum() >= tags.shape[0] // 2)
        dslot = torch.argmin(torch.where(prot, stamp, _STAMP_MAX)).view(1)
        seg = seg.scatter(0, dslot, torch.where(need_demote, 0,
                                                seg.gather(0, dslot)))
        seg = seg.scatter(0, slot.view(1), present.to(seg.dtype).view(1))
    s1 = slot.view(1)
    return (tags.scatter(0, s1, gid.view(1)),
            stamp.scatter(0, s1, tick.view(1)), seg, slot)


def _commit(c: RowCache, tags, stamp, seg, tick, hit_rows, miss_rows,
            live) -> RowCache:
    """The cache after an access: the new tags/stamps/segments and the
    counters moved by ``hit_rows`` / ``miss_rows`` where ``live`` (None:
    always), else the cache as it was."""
    if live is not None:
        tags = torch.where(live, tags, c.tags)
        stamp = torch.where(live, stamp, c.stamp)
        seg = torch.where(live, seg, c.seg)
        hit_rows, miss_rows = hit_rows * live, miss_rows * live
    return c.replace(tags=tags, stamp=stamp, seg=seg, tick=tick,
                     hits=c.hits + hit_rows, misses=c.misses + miss_rows)


def _tick(c: RowCache, live):
    return c.tick + (1 if live is None else live.to(torch.int64))


def get_row(cache: RowCache, gid: torch.Tensor,
            row_at: Callable[..., torch.Tensor], policy: str = "lru",
            live: Optional[torch.Tensor] = None):
    """One row by global id ``gid`` (0-d or (1,)): ``row_at(vals, slot,
    hit)`` must return the table row ``slot`` (0-d i32) where the device
    flag ``hit`` (0-d i32) is set, else the row computed (the cached kernel
    entry: ``kernel_fns.row_via_rows2_cached``). Returns (row, cache);
    the value table is written in place. ``live`` (0-d bool, None =
    always): see the module docstring."""
    tick = _tick(cache, live)
    slot_e, present = _find(cache.tags, gid)
    slot_e, present = slot_e[0], present[0]
    tags, stamp, seg, slot = _write(cache.tags, cache.stamp, cache.seg, gid,
                                    present, slot_e, tick, policy)
    hit = present
    if live is not None:
        # not live: serve and write back the row of the slot the access
        # would write, so the table keeps its bits
        slot_e, hit = torch.where(live, slot_e, slot), present | ~live
    row = row_at(cache.vals, slot_e.to(torch.int32), hit.to(torch.int32))
    cache.vals.index_copy_(0, slot.view(1), row.view(1, -1))
    one = present.to(torch.int64)
    return row, _commit(cache, tags, stamp, seg, tick, one, 1 - one, live)


def get_pair(cache: RowCache, gid2: torch.Tensor,
             rows_at: Callable[..., torch.Tensor], policy: str = "lru",
             live: Optional[torch.Tensor] = None):
    """The fused two-row access of Eq. 6: returns ((M, 2) rows, cache).
    ``rows_at(vals, slot2, hit)`` must return the table rows at ``slot2``
    ((2,) i32) where the device flag ``hit`` (0-d i32) is set, else the two
    rows computed in one pass (the cached kernel entry).

    Pairwise hit policy: the value table serves only when *both* global
    ids are present; any miss recomputes both rows with the two-row kernel
    (exactly the cache-off path's rows) and inserts each row separately,
    so later pairs can hit on rows that were produced by different
    iterations. ``live`` as in :func:`get_row`.
    """
    tick = _tick(cache, live)
    slot2, present2 = _find(cache.tags, gid2)
    both = present2.all()
    tags, stamp, seg, s0 = _write(cache.tags, cache.stamp, cache.seg,
                                  gid2[0], present2[0], slot2[0], tick,
                                  policy)
    # re-probe against the updated tags so gid2[1] == gid2[0] (or a fresh
    # insert colliding with slot2[1]) resolves to the right slot
    s1e, p1 = _find(tags, gid2[1])
    tags, stamp, seg, s1 = _write(tags, stamp, seg, gid2[1], p1[0], s1e[0],
                                  tick, policy)
    hit = both
    if live is not None:
        # not live: serve and write back the rows of the slots the access
        # would write, so the table keeps its bits
        slot2 = torch.where(live, slot2, torch.stack([s0, s1]))
        hit = both | ~live
    rows = rows_at(cache.vals, slot2.to(torch.int32), hit.to(torch.int32))
    # in order: the second row wins a slot both writes chose
    cache.vals.index_copy_(0, s0.view(1), rows[:, 0].view(1, -1))
    cache.vals.index_copy_(0, s1.view(1), rows[:, 1].view(1, -1))
    two = 2 * both.to(torch.int64)
    return rows, _commit(cache, tags, stamp, seg, tick, two, 2 - two, live)


def make_accessors(provider, data, cached: bool, policy: str = "lru"):
    """The runners' row-access functions, cached and uncached, over the
    device buffer ``data``: ``(get_row1(cache, gid, z, live),
    get_rows2(cache, gid2, z2, live))``, each giving ``(rows, cache)``.
    Uncached, they are the provider's rows and leave ``cache`` (None) as
    it is. Single rows go through the duplicated-query two-row kernel
    (``kernel_fns.row_via_rows2``) either way, so a row made for wss2
    selection has the bits of the same row made in either slot of a pair;
    the rewarm (:func:`warm_vals`) relies on it."""

    def get_row1(c, gid, z, live=None):
        if not cached:
            return kernel_fns.row_via_rows2(provider, data, z), c
        row_at = lambda t, s, h: kernel_fns.row_via_rows2_cached(
            provider, data, z, t, s, h)
        return get_row(c, gid, row_at, policy, live)

    def get_rows2(c, gid2, z2, live=None):
        if not cached:
            return provider.rows2(data, z2), c
        rows_at = lambda t, s, h: provider.rows2_cached(data, z2, t, s, h)
        return get_pair(c, gid2, rows_at, policy, live)

    return get_row1, get_rows2


def tag_queries(data, tags: torch.Tensor, n: int) -> torch.Tensor:
    """Dense (S, d) query rows of the cached tags, gathered from the
    buffer by global id. Every tag must be resident in ``data`` — true at
    un-shrink, where the buffer is the full set; untagged slots get some
    row (:func:`warm_vals` zeroes them). Bits equal the in-loop
    ``data.dense_rows`` queries (the ELL scatter-add is exact)."""
    gids = data.gids
    inv = torch.zeros((n + 1,), dtype=torch.int64, device=gids.device)
    inv.scatter_(0, torch.where(gids >= 0, gids, n),
                 torch.arange(gids.shape[0], device=gids.device))
    return data.dense_rows(inv.index_select(0, torch.clamp(tags, 0, n)))


def warm_vals(provider, data, zq: torch.Tensor, tags: torch.Tensor,
              pairs: bool) -> torch.Tensor:
    """The (S, M) value table over ``data`` for the tagged slots, from
    their queries ``zq`` (S, d), recomputed with the kernels of the
    in-loop miss path, so that a later hit serves the bits an in-loop miss
    would have produced. ``pairs`` (wss1, whose rows come from the two-row
    access): slots in pairs (0,1), (2,3), ... through ``rows2`` — a
    column's bits do not depend on its partner query; else (wss2) one
    slot at a time through ``kernel_fns.row_via_rows2``. Untagged slots
    are zeroed."""
    S = tags.shape[0]
    if pairs:
        rows = [provider.rows2(data, zq[s: s + 2]).T for s in range(0, S, 2)]
    else:
        rows = [kernel_fns.row_via_rows2(provider, data, zq[s])[None]
                for s in range(S)]
    return torch.where((tags >= 0)[:, None], torch.cat(rows, 0), 0.0)


def regrow_cache(cache: Optional[RowCache], data, provider, pairs: bool,
                 n: int) -> Optional[RowCache]:
    """Cache carry-over across un-shrink growth: rewarm every tagged slot
    against the grown (full-set) buffer (:func:`warm_vals`); tags, stamps,
    segments and counters are kept."""
    if cache is None:
        return None
    zq = tag_queries(data, cache.tags, n)
    return cache.replace(vals=warm_vals(provider, data, zq, cache.tags,
                                        pairs))


def remap_cache_device(cache: Optional[RowCache], src: torch.Tensor,
                       valid: torch.Tensor) -> Optional[RowCache]:
    """Cache carry-over across a *physical compaction*, on the device:
    ``src`` / ``valid`` are the compaction's gather plan
    (``dataplane.compact_plan``). The new buffer is a subset of the old, so
    every cached row survives by a column re-gather; tags, stamps,
    segments and counters are untouched; new padding columns are zeroed
    (padding rows are never active)."""
    if cache is None:
        return None
    return cache.replace(vals=torch.where(
        valid[None, :], cache.vals.index_select(1, src), 0.0))


def remap_cache(cache: Optional[RowCache], old_idx: np.ndarray,
                new_idx: np.ndarray) -> Optional[RowCache]:
    """Cache carry-over across a buffer rebuild from the host's
    ``idx_buf`` arrays (buffer position -> global id, -1 on padding): value
    columns re-gathered when the new buffer is a subset of the old one
    (compaction under ``compact_backend='host'``), the cache emptied when
    it is not (growth re-adds rows with no cached values). Tick and
    counters carry over either way."""
    if cache is None:
        return None
    slots, dev = int(cache.tags.shape[0]), cache.vals.device
    old_idx = np.asarray(old_idx, np.int64)
    new_idx = np.asarray(new_idx, np.int64)
    new_real, old_real = new_idx >= 0, old_idx >= 0
    fresh = init_cache(slots, int(new_idx.size), dev).replace(
        hits=cache.hits, misses=cache.misses, tick=cache.tick)
    # the tags are O(slots): read them before touching the value table
    if not new_real.any() or not old_real.any() \
            or bool((cache.tags == -1).all()):
        return fresh
    hi = int(max(old_idx.max(), new_idx.max())) + 1
    pos = np.full((hi,), -1, np.int64)
    pos[old_idx[old_real]] = np.flatnonzero(old_real)
    src = pos[new_idx[new_real]]
    if (src < 0).any():
        return fresh
    put = lambda a: torch.as_tensor(a, device=dev)
    vals = fresh.vals
    vals[:, put(np.flatnonzero(new_real))] = cache.vals.index_select(
        1, put(src))
    return cache.replace(vals=vals)
