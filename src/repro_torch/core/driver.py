"""Epoch driver — the paper's Algorithm 5 control flow (twin of
``repro.core.driver``; single device, dense or block-ELL storage).

Phases (faithful to Alg. 5):

  shrink stage    run fused SMO epochs with in-loop shrinking until
                  beta_up + 20*eps >= beta_low on the active set;
                  physically compact the buffer between epochs when enough
                  samples have been shrunk;
  reconstruct     Alg. 6 for every sample (the paper: every non-active
                  one; see the note at the call), then un-shrink and
                  re-check optimality over ALL samples;
  re-optimize     Single: shrinking disabled, run to 2*eps.
                  Multi:  shrinking re-enabled (counter reset), run to
                          2*eps on the active set, reconstruct again,
                          repeat until Eq. 9 holds over all samples.

"Original" (Alg. 3, no shrinking) is the same driver with shrink interval
0 and no reconstruction, run straight to 2*eps.

Every verdict is taken on recomputed gamma: a phase that ends without a
reconstruction (original, a Single re-optimisation, a spent budget)
recomputes every sample's gamma once and rechecks Eq. 9 on it; if that
fails, optimisation goes on from the recomputed values.

The hot loop dispatches fused epochs (``smo.make_chunk_runner``) of up to
``fuse_iters`` segments and reads back one ``smo.EpochSummary`` per
dispatch; host decisions — hard exit, compaction geometry, reconstruction
— happen only at dispatch boundaries, on summary fields.

Physical compaction runs on the device by default (``compact_backend=
'device'``: a gather of the surviving rows plus a scatter of the outgoing
buffer's alpha/gamma into the (n,) device masters); ``'host'`` rebuilds the
buffer from the host store and is the bitwise parity oracle. Alg. 6 and
un-shrink growth go through the device-resident full-set mirror
(``mirror='auto'|'device'``) or the host-streaming oracle (``'host'``),
bitwise equal as well.

On block-ELL buffers the lane budget K is adaptive: every buffer build
takes the bucketed max extent of exactly its rows
(``_buffer_geometry``), and a device compaction takes it from the
per-shard surviving extents the epoch summary carries (``shard_ext``), so
eliminating samples shrinks both dimensions of the gamma pass
(``FitStats.buffer_K`` / ``shard_K`` record the trajectory).

The kernel-row cache (``SVMConfig(row_cache=True)``, ``core/rowcache.py``)
rides the fused epochs: a device compaction re-gathers its value table by
the buffer's gather plan, the host backend by the old and new ``idx_buf``,
and an un-shrink rewarms every tagged slot over the grown buffer, so its
tags, recency and counters carry across every rebuild.

Fault tolerance (``SVMConfig(checkpoint_dir=..., resume=...,
watchdog_threshold=...)``): the driver saves atomic step dirs of the host
(n,) masters, the active and buffer-membership masks and the phase state
at dispatch boundaries (``ckpt.checkpoint``), resumes from the newest
complete one, forces a save when ``launch.elastic.StragglerWatchdog`` flags
a dispatch, and calls the chaos hooks (``launch.chaos``) at its two fault
boundaries; see "fault tolerance" below.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch.core import dataplane, heuristics, mirror, rowcache, smo
from repro_torch.data import sparse as spfmt
from repro_torch.launch import chaos

@dataclasses.dataclass
class FitStats:
    iterations: int = 0
    n_sv: int = 0
    n_bound_sv: int = 0
    reconstructions: int = 0
    eq9_rechecks: int = 0        # gamma recomputations outside Alg. 6 that
                                 # recheck a verdict the epochs took
    shrink_events: int = 0
    compactions: int = 0
    min_active: int = 0
    dispatches: int = 0          # fused-epoch runner calls; each reads back
                                 # ONE EpochSummary and nothing else
    dispatch_times: list = dataclasses.field(default_factory=list)
                                 # wall seconds per dispatch (len ==
                                 # dispatches)
    train_time: float = 0.0
    recon_time: float = 0.0
    compact_time: float = 0.0
    total_time: float = 0.0
    converged: bool = False
    stalled: bool = False
    final_gap: float = 0.0
    buffer_sizes: list = dataclasses.field(default_factory=list)
    buffer_K: list = dataclasses.field(default_factory=list)
    # per-buffer ELL lane budget (the adaptive K trajectory); empty for dense
    shard_K: list = dataclasses.field(default_factory=list)
    # per-buffer tuple of each shard's lane-rounded K
    mirror: str = ""             # resolved full-set mirror mode of this fit
    flops_est: float = 0.0       # model FLOPs of the gamma-update hot loop,
                                 # by the reference's rule: production plus
                                 # epilogue
    flops_production: float = 0.0   # kernel-row passes: one per row
                                 # computed (2 an iteration without the row
                                 # cache, its misses with it),
                                 # flops_row_pass per buffer row
    flops_epilogue: float = 0.0  # O(M) Eq. 6 FMA (4 flops a buffer row; 12
                                 # under wss2, the selection sweep added)
    cache_hits: int = 0          # kernel rows served from the row cache
    cache_misses: int = 0        # kernel rows (re)computed by the provider
    cache_hit_rate: float = 0.0  # hits / (hits + misses); 0 when cache off
    n_problems: int = 1          # problems sharing this fit (K of a batched
                                 # core.multi fit; 1 for ordinary fits)
    per_problem: list = dataclasses.field(default_factory=list)
                                 # one record per problem of a multi fit
                                 # (iterations, converged, stalled,
                                 # shrink_events, reconstructions, n_sv, ...)
    joint_iters: int = 0         # joint iterations of a batched multi fit:
                                 # iterations in which any problem ran
    straggle_events: int = 0     # dispatches the StragglerWatchdog flagged
    ckpt_retries: int = 0        # transient-I/O retries spent on checkpoint
                                 # writes (bounded by cfg.ckpt_retries)
    resumed_from: int = -1       # checkpoint step this fit restored from;
                                 # -1 for a fresh start


def betas(gamma, alpha, y, C: float) -> tuple:
    """Eq. 8 bounds over all samples in one reduction and one (2,) sync.
    Accepts numpy arrays or tensors (on any device)."""
    t = lambda a: torch.as_tensor(a)
    gamma, alpha, y = t(gamma), t(alpha), t(y).to(t(gamma).device)
    thr0, thr1 = smo.bounds(C)
    in_up, in_low = smo._sets(alpha, y > 0, torch.ones_like(y, dtype=bool),
                              thr0, thr1)
    b = torch.stack([torch.min(torch.where(in_up, gamma, float("inf"))),
                     torch.max(torch.where(in_low, gamma, float("-inf")))])
    b_up, b_low = b.cpu().tolist()
    return b_up, b_low


class Phase:
    """One problem's phase-end policy (Alg. 5 l. 26-33 and the port's fp64
    recheck). :meth:`EpochDriver.fit` keeps one; the batched multi driver
    keeps one a problem lane, so each lane ends its phases as the single
    driver would."""

    def __init__(self, cfg, policy: str):
        self.shrink_on = policy != "none"
        self.single = policy == "single"
        self.max_recon = cfg.max_reconstructions
        self.tol20 = smo.f32(cfg.recon_eps_factor * cfg.eps)
        self.tol2 = smo.f32(2.0 * cfg.eps)
        self._tol2_cut = smo.f32(2.0 * cfg.eps * (1.0 - 1e-3))
        self.recon_count = 0
        self.eq9_rechecks = 0
        self.recheck_step = -1

    @property
    def cut(self) -> bool:
        """Whether tol2 was cut to 0.1% below 2*eps."""
        return self.tol2 == self._tol2_cut

    def snapshot(self) -> dict:
        """The phase state a checkpoint carries: the reference's
        ``recon_count`` / ``shrink_on`` and the port's own three."""
        return {"recon_count": self.recon_count, "shrink_on": self.shrink_on,
                "tol2_cut": self.cut, "recheck_step": self.recheck_step,
                "eq9_rechecks": self.eq9_rechecks}

    def load(self, meta: dict) -> None:
        """Restore :meth:`snapshot`'s fields from a checkpoint's meta; the
        port's own default when a reference checkpoint lacks them."""
        self.recon_count = int(meta.get("recon_count", 0))
        self.shrink_on = bool(meta.get("shrink_on", self.shrink_on))
        if meta.get("tol2_cut", False):
            self.tol2 = self._tol2_cut
        self.recheck_step = int(meta.get("recheck_step", -1))
        self.eq9_rechecks = int(meta.get("eq9_rechecks", 0))

    def tol(self) -> float:
        """The tolerance of the next phase: 20*eps until the first
        reconstruction of a shrinking fit, then 2*eps."""
        return (self.tol20 if self.shrink_on and self.recon_count == 0
                else self.tol2)

    def end(self, eq9, tol: float, step: int, spent: bool,
            stalled: bool) -> bool:
        """End the phase that ran at ``tol`` and stopped at ``step``.
        ``eq9()`` recomputes every sample's gamma and returns whether Eq. 9
        holds on its fp64 values. True: the problem is done. False: the
        caller un-shrinks (rebuilds the full buffer) and optimises on,
        shrinking only while :attr:`shrink_on`, its countdown re-armed."""
        if self.shrink_on and self.recon_count < self.max_recon \
                and not spent:
            # gradient reconstruction + un-shrink
            self.recon_count += 1
            if eq9():
                return True
        else:
            # No reconstruction is due (original, a Single re-optimisation,
            # a spent budget), so the epochs' verdict stands on gamma they
            # updated in fp32: recheck it on recomputed gamma, and optimise
            # on from there if it fails.
            self.eq9_rechecks += 1
            if eq9() or self.shrink_on or spent or stalled \
                    or step == self.recheck_step:
                return True
            self.recheck_step = step
        if tol == self.tol2:
            # Eq. 9 on fp64 gamma refuted epochs that stopped at 2*eps.
            # Rebuilt from those values, their f32 gamma sits within ~1e-7
            # of them; aim 0.1% below 2*eps so that they cannot stop again
            # at once on a rounding.
            self.tol2 = self._tol2_cut
        if self.single:
            self.shrink_on = False     # Single disables shrinking
        return False


def _scatter_full(alpha_d, gamma_d, alpha_buf, gamma_buf, gids):
    """Write a buffer's alpha/gamma into the (n,) device masters in place,
    keyed by global id (padding rows, gid -1, are skipped) — the one
    master-writeback rule of the epoch writeback and the compaction step."""
    real = gids >= 0
    g = gids[real]
    alpha_d[g] = alpha_buf[real]
    gamma_d[g] = gamma_buf[real]
    return alpha_d, gamma_d


def _compact_step(data, yb, state: smo.SMOState, cache, alpha_d, gamma_d,
                  n_active: int, interval: int, p: int, m_per: int,
                  K_new: "int | None" = None):
    """One device-side physical compaction: master writeback for the
    outgoing buffer, the balanced gather plan, the row/vector/cache gathers
    (ELL rows truncated to ``K_new``) and the fresh state (step counters
    carried)."""
    alpha_d, gamma_d = _scatter_full(alpha_d, gamma_d, state.alpha,
                                     state.gamma, data.gids)
    src, valid = dataplane.compact_plan(state.active, n_active, p, m_per)
    data2 = dataplane.gather_rows(data, src, valid, K_new)
    yb2 = torch.where(valid, yb[src], 1.0)     # padding: y=+1, alpha=0 -> I1
    alpha2 = torch.where(valid, state.alpha[src], 0.0)
    gamma2 = torch.where(valid, state.gamma[src], float("inf"))
    state2 = smo.init_state(alpha2, gamma2, valid).replace(
        step=state.step,
        next_shrink=state.step + max(1, min(interval, n_active)),
        n_shrinks=state.n_shrinks)
    # the cached rows keep their bits in the new geometry: a row's bits do
    # not depend on its place in the buffer, and on ELL not on the lane
    # budget either (the kernels' K-independent order), so columns gathered
    # from rows made at the old K equal rows made at K_new
    cache2 = rowcache.remap_cache_device(cache, src, valid)
    return data2, yb2, state2, cache2, alpha_d, gamma_d


class EpochDriver:
    """The Alg. 5 state machine around a solver's hook surface: device
    placement (``_put`` / ``_put_full``), the buffer's shards
    (``_nshards`` / ``_gather`` / ``_shard``), runner construction
    (``_runner``), the row cache (``_new_cache`` / ``_regrow_cache``) and
    Alg. 6 (``_reconstruct`` / ``_reconstruct_mirror``). One instance
    drives one ``fit``; mutable run state lives on the instance.

    On several devices (``core.parallel.ParallelSMOSolver``) each process
    holds its shard of the buffer, of the mirror and of the row cache's
    value table, while host arrays, the (n,) device masters and the epoch
    summary are the same on every rank, so every host decision takes the
    same branch everywhere. Rows cross shards only at dispatch boundaries:
    the master writeback and a compaction gather the buffer's shards
    (``_gathered``) and deal the result back (``_sharded``)."""

    def __init__(self, solver):
        self.s = solver
        self.cfg = solver.cfg
        self.h = solver.h
        self.mirror: Optional[mirror.Mirror] = None
        self.idx: Optional[np.ndarray] = None   # host copy of data.gids;
                                                # None = stale after a
                                                # device compaction
        self._last_shard_K: tuple = ()

    # -- buffer plumbing ---------------------------------------------------
    def _gathered(self):
        """(data, y_buf, state, cache) as global arrays: every shard's
        block gathered (on one device, the buffer itself)."""
        g = self.s._gather
        st = self.state.replace(alpha=g(self.state.alpha),
                                gamma=g(self.state.gamma),
                                active=g(self.state.active))
        cache = (None if self.cache is None
                 else self.cache.replace(vals=g(self.cache.vals, 1)))
        return dataplane.map_rows(self.data, g), g(self.yb), st, cache

    def _sharded(self, data, yb, state, cache):
        """This shard's block of global (data, y_buf, state, cache)."""
        f = self.s._shard
        st = state.replace(alpha=f(state.alpha), gamma=f(state.gamma),
                           active=f(state.active))
        cache = (None if cache is None
                 else cache.replace(vals=f(cache.vals, 1)))
        return dataplane.map_rows(data, f), f(yb), st, cache

    def _make_buffer(self, y, alpha, gamma, idx):
        """Gather rows ``idx`` from the host store into a padded buffer of
        p balanced shards. Returns (data, y_buf, fresh state, idx_buf),
        idx_buf mapping buffer row -> global id (-1 on padding)."""
        sv = self.s
        store = sv._store
        p = sv._nshards()
        m_per, K_buf = self._buffer_geometry(idx, p)
        m = m_per * p
        buf = store.alloc(m, K_buf)
        yb = np.ones((m,), np.float32)          # padding: y=+1, alpha=0 -> I1
        ab = np.zeros((m,), np.float32)
        gb = np.full((m,), np.inf, np.float32)  # padding gamma never selected
        sqb = np.zeros((m,), np.float32)
        valid = np.zeros((m,), bool)
        idx_buf = np.full((m,), -1, np.int64)
        for sl, sub in dataplane.deal(idx, p, m_per):
            store.fill(buf, sl, sub)
            yb[sl] = y[sub]
            ab[sl] = alpha[sub]
            gb[sl] = gamma[sub]
            sqb[sl] = store.sq_rows(sub)        # one store-level provenance
            valid[sl] = True
            idx_buf[sl] = sub
        data = store.to_device(buf, sv._put, gids=idx_buf, sq=sqb)
        state = smo.init_state(sv._put(ab), sv._put(gb), sv._put(valid))
        return data, sv._put(yb), state, idx_buf

    def _buffer_geometry(self, idx: np.ndarray, p: int):
        """The one buffer-shape rule: per-shard slots (pow2 bucketed) and,
        for ELL stores, the adaptive lane budget of exactly ``idx`` (its
        bucketed max extent, capped at the store budget; the store budget
        itself with ``ell_adaptive=False``). Records each shard's
        lane-rounded K for ``FitStats.shard_K``."""
        cfg, store = self.cfg, self.s._store
        m_per = mirror.full_m_per(idx.size, p, cfg.min_buffer)
        K_buf = None
        if store.fmt == "ell":
            K_buf = (spfmt.bucket_lanes(store.buffer_K(idx), cfg.ell_lane,
                                        cap=store.K)
                     if cfg.ell_adaptive else store.K)
            self._last_shard_K = tuple(
                store.buffer_K(sub)
                for _, sub in dataplane.deal(idx, p, m_per))
        else:
            self._last_shard_K = ()
        return m_per, K_buf

    def _mirror_build(self, rows: np.ndarray):
        """Buffer build for global ``rows`` as a device gather from the
        mirror and the (n,) masters — same geometry, layout and bits as
        :meth:`_make_buffer`; only the keep mask goes up. Each shard
        gathers from its own mirror block: the driver rebuilds only the
        full set, whose layout is the mirror's, so no row crosses shards."""
        sv, mir = self.s, self.mirror
        p = mir.p
        m_per, K_new = self._buffer_geometry(rows, p)
        keep = np.zeros((mir.idx.size,), bool)
        keep[mir.pos_of[rows]] = True
        base, extra = divmod(rows.size, p)
        if m_per != mir.m_per or not np.array_equal(
                keep.reshape(p, m_per).sum(1),
                base + (np.arange(p) < extra)):
            raise ValueError("a mirror build takes rows laid out as the "
                             "mirror's blocks (the full set)")
        mine = sv._shard(torch.as_tensor(keep))
        data, yb, state = mirror.grow_step(
            mir.data, mir.y, self.alpha_d, self.gamma_d,
            mine.to(mir.y.device), int(mine.sum()), 1, m_per, K_new)
        idx_buf, _ = dataplane.full_layout(rows, p, m_per)
        return data, yb, state, idx_buf

    def _build_buffer(self, rows: np.ndarray):
        """Device gather from the mirror when one is resident, host store
        fill otherwise (then the masters are refreshed, so both modes
        leave buffer and masters in the same bitwise state)."""
        if self.mirror is not None:
            return self._mirror_build(rows)
        out = self._make_buffer(self.y, self.alpha, self.gamma, rows)
        self._refresh_masters()
        return out

    def _host_idx(self) -> np.ndarray:
        if self.idx is None:
            self.idx = self.s._gather(self.data.gids).cpu().numpy() \
                .astype(np.int64)
        return self.idx

    def _note_buffer(self):
        """Record the buffer's geometry: its size (over every shard), and
        on ELL its lane budget and per-shard K."""
        self.stats.buffer_sizes.append(self.data.m * self.s._nshards())
        if isinstance(self.data, dataplane.ELLData):
            self.stats.buffer_K.append(self.data.K)
            self.stats.shard_K.append(self._last_shard_K)

    # -- writeback ---------------------------------------------------------
    def _writeback_masters(self):
        g = self.s._gather
        self.alpha_d, self.gamma_d = _scatter_full(
            self.alpha_d, self.gamma_d, g(self.state.alpha),
            g(self.state.gamma), g(self.data.gids))

    def _writeback(self):
        """Master writeback + host copies of alpha/gamma."""
        self._writeback_masters()
        self.alpha = self.alpha_d.cpu().numpy().copy()
        self.gamma = self.gamma_d.cpu().numpy().copy()

    def _refresh_masters(self):
        self.alpha_d = self.s._put_full(self.alpha)
        self.gamma_d = self.s._put_full(self.gamma)

    # -- gradient reconstruction (Alg. 6) ---------------------------------
    def _reconstruct_step(self, rows: np.ndarray):
        """Reconstruct gamma for the global ``rows``: into the device gamma
        master (mirror mode) or host gamma (streaming oracle), rounded once
        to f32. Returns the rows' fp64 gamma (a device tensor in mirror
        mode, host numpy otherwise)."""
        sv, y = self.s, self.y
        sv_rows = np.flatnonzero(self.alpha > 0.0)
        if self.mirror is not None:
            if sv_rows.size:
                self.gamma_d, g64 = sv._reconstruct_mirror(
                    self.mirror, self.alpha_d, self.gamma_d, sv_rows, rows)
            else:   # no support vectors: Alg. 6 degenerates to gamma = -y
                r = sv._put_full(rows)
                self.gamma_d[r] = -self.y_d[r]
                g64 = -self.y_d[r].double()
            return g64
        g64 = ((-y[rows]).astype(np.float64) if sv_rows.size == 0
               else sv._reconstruct(y, self.alpha, rows))
        self.gamma[rows] = g64
        return g64

    def _eq9_on_recomputed_gamma(self) -> bool:
        """Recompute every sample's gamma, then test optimality over ALL
        samples (Eq. 9) on its fp64 values — one (2,) sync. Sets the fit's
        verdict (``stats.converged`` / ``final_gap``).

        Alg. 6 recomputes the shrunk rows only; the port recomputes the
        active rows too. Their gamma was updated once per iteration in fp32
        and drifts from the exact sum by ~1e-5 (measured at a9a scale 0.2
        on an H100: fp64 Eq. 9 gap 2.013e-3 after a converged fit), enough
        to put the true gap over 2*eps when the verdict is taken on drifted
        values."""
        cfg = self.cfg
        g64 = self._reconstruct_step(np.arange(self.y.size))
        if self.mirror is not None:
            b_up, b_low = betas(g64, self.alpha_d, self.y_d, cfg.C)
        else:
            b_up, b_low = betas(g64, self.alpha, self.y, cfg.C)
        self.stats.final_gap = b_low - b_up
        self.stats.converged = b_up + 2.0 * cfg.eps >= b_low
        return self.stats.converged

    # -- physical compaction ----------------------------------------------
    def _compact(self, n_active: int, p: int, m_per: int,
                 shard_ext: tuple):
        """One physical compaction — device backend by default, host
        backend (store rebuild) as the parity oracle. On ELL buffers
        ``shard_ext`` is the (p,) per-shard surviving extents the epoch
        summary carried; their bucketed max is the new lane budget,
        exactly as the host rebuild buckets ``store.buffer_K``."""
        cfg = self.cfg
        t0 = time.perf_counter()
        if cfg.compact_backend == "device":
            K_new = None
            if isinstance(self.data, dataplane.ELLData):
                store = self.s._store
                self._last_shard_K = tuple(
                    spfmt.round_lanes(int(e), store.lane) for e in shard_ext)
                K_new = (spfmt.bucket_lanes(max(shard_ext), store.lane,
                                            cap=store.K)
                         if cfg.ell_adaptive else self.data.K)
            data, yb, state, cache = self._gathered()
            data, yb, state, cache, self.alpha_d, self.gamma_d = \
                _compact_step(data, yb, state, cache, self.alpha_d,
                              self.gamma_d, n_active, self._interval, p,
                              m_per, K_new)
            self.data, self.yb, self.state, self.cache = self._sharded(
                data, yb, state, cache)
            self.idx = None
        else:
            self._writeback()
            idx = self._host_idx()
            active = self.s._gather(self.state.active).cpu().numpy()
            keep = idx[(idx >= 0) & active]
            step, nshr = self.state.step, self.state.n_shrinks
            cache = (None if self.cache is None else self.cache.replace(
                vals=self.s._gather(self.cache.vals, 1)))
            self.data, self.yb, state2, self.idx = self._make_buffer(
                self.y, self.alpha, self.gamma, keep)
            # survivors keep their global ids: cached rows are re-gathered
            # into the compacted geometry, not dropped
            cache = rowcache.remap_cache(cache, idx, self.idx)
            if cache is not None:
                cache = cache.replace(vals=self.s._shard(cache.vals, 1))
            self.cache = cache
            self.state = state2.replace(
                step=step,
                next_shrink=step + max(1, min(self._interval, keep.size)),
                n_shrinks=nshr)
        if self.state.alpha.is_cuda:
            torch.cuda.synchronize(self.state.alpha.device)
        self.stats.compactions += 1
        self.stats.compact_time += time.perf_counter() - t0
        self._note_buffer()

    # -- fault tolerance ---------------------------------------------------
    # Save boundary == dispatch boundary == restore boundary:
    #
    #   dispatch #i -> EpochSummary -> [cadence or straggle?]
    #                                     | yes: master writeback, one
    #                                     v      atomic step_{N} save
    #                   checkpoint_dir/step_{N}/ (host (n,) alpha, gamma,
    #                   active, in_buffer + meta and phase state; no device
    #                   or layout state: buffers are rebuilt, not saved)
    #   crash / rescale -> restart with resume=True -> newest COMPLETE step
    #   (torn or corrupt ones skipped) -> re-deal the saved membership for
    #   the CURRENT world size, restore each row's active flag, the shrink
    #   anchor and the phase, rebuild the row cache empty, and re-enter the
    #   loop at the saved step.
    #
    # A save at a dispatch that ends in a compaction is taken after the
    # compaction, so the saved membership is the geometry the next dispatch
    # runs on: a resume at the same world size then replays the same
    # segments bit for bit. The saved membership (not only the active set)
    # is what reproduces the geometry; at another world size the same rows
    # are dealt p' ways. On a process group every rank reaches every
    # boundary with the same host state; the writer (rank 0) writes, and
    # the others wait for it.
    def _ckpt_meta(self, n: int) -> dict:
        """Config fingerprint saved with (and checked against) every step;
        the world size, buffer geometry, eps and iteration budgets are free
        to change across a restore."""
        cfg = self.cfg
        return {"n": int(n), "format": cfg.format, "C": float(cfg.C),
                "sigma2": float(cfg.sigma2), "selection": cfg.selection,
                "heuristic": self.h.name}

    def _validate_meta(self, meta: dict, n: int, d: str):
        for k, v in self._ckpt_meta(n).items():
            if k in meta and meta[k] != v:
                raise ValueError(
                    f"checkpoint {d} was saved with {k}={meta[k]!r} but "
                    f"this fit has {k}={v!r}: refusing to resume a "
                    "different problem or configuration")

    def _save_ckpt(self, act_full: np.ndarray, in_buf: np.ndarray,
                   meta: dict):
        """Write one step dir (the writer only); every process learns
        whether it failed."""
        from repro_torch.ckpt import checkpoint as ck
        sv = self.s
        meta = dict(meta, **self._ckpt_meta(self.alpha.size))
        d = os.path.join(self.cfg.checkpoint_dir, f"step_{meta['step']}")
        err = None
        if sv._is_writer():
            try:
                _, retries = ck.with_retries(
                    lambda: ck.save(
                        d, meta["step"],
                        {"svm": {"alpha": self.alpha, "gamma": self.gamma,
                                 "active": act_full.astype(np.int8),
                                 "in_buffer": in_buf.astype(np.int8)}},
                        extra=meta),
                    attempts=max(1, self.cfg.ckpt_retries),
                    what=f"checkpoint save {d}")
                self.stats.ckpt_retries += retries
            except IOError as e:
                err = e
        if sv._agree_max(int(err is not None)):
            raise err or IOError(f"checkpoint save {d} failed on the writer")

    def _pick_step(self, n: int, like: dict):
        """The writer's walk: the newest COMPLETE step that validates and
        restores, as (step, groups, meta), or None. A config mismatch
        raises: that is a caller error, not a disk fault."""
        from repro_torch.ckpt import checkpoint as ck
        base = self.cfg.checkpoint_dir
        for step in reversed(ck.complete_steps(base)):
            d = os.path.join(base, f"step_{step}")
            try:
                meta = ck.load_manifest(d).get("extra", {})
            except (OSError, ValueError):
                continue
            self._validate_meta(meta, n, d)
            try:
                g = ck.restore(d, "svm", like)
            except (IOError, KeyError) as e:
                warnings.warn(f"skipping corrupt checkpoint {d}: {e}")
                continue
            return step, g, meta
        return None

    def _load_ckpt(self, n: int):
        """Restore the newest COMPLETE step: the writer picks it, walking
        past torn or corrupt step dirs, and every process restores that
        step. Returns (groups, meta), or None when there is none."""
        from repro_torch.ckpt import checkpoint as ck
        sv = self.s
        like = {"alpha": np.zeros(n, np.float32),
                "gamma": np.zeros(n, np.float32),
                "active": np.zeros(n, np.int8),
                "in_buffer": np.zeros(n, np.int8)}
        got, err, step = None, None, -1
        if sv._is_writer():
            try:
                got = self._pick_step(n, like)
                step = -1 if got is None else got[0]
            except ValueError as e:
                err, step = e, -2
        step = sv._from_writer(step)
        if step == -2:
            raise err or ValueError(
                "the checkpoint's configuration differs from this fit's "
                "(see the writer's error)")
        if step < 0:
            return None
        if got is None:
            d = os.path.join(self.cfg.checkpoint_dir, f"step_{step}")
            meta = ck.load_manifest(d).get("extra", {})
            self._validate_meta(meta, n, d)
            got = (step, ck.restore(d, "svm", like), meta)
        sv._agree_max(0)    # a barrier: every process has read it before
                            # any save can replace it
        self.stats.resumed_from = int(step)
        return {k: np.array(v) for k, v in got[1].items()}, got[2]

    def _checkpoint_now(self, n: int, step: int, nshr: int, ph: Phase):
        """Sync the masters to the host and write one step dir at the
        CURRENT dispatch boundary (the cadence and the watchdog's forced
        save share it). Besides masters and active mask the step records
        buffer MEMBERSHIP (``in_buffer``: the rows the buffer holds, active
        or shrunk but not yet compacted away), the shrink anchor
        ``next_shrink`` and the phase state (:meth:`Phase.snapshot`)."""
        chaos.on_save(self._saves)
        self._saves += 1
        self._writeback()
        idx = self._host_idx()
        active = self.s._gather(self.state.active).cpu().numpy()
        valid = idx >= 0
        act_full = np.zeros((n,), bool)
        act_full[idx[valid & active]] = True
        in_buf = np.zeros((n,), bool)
        in_buf[idx[valid]] = True
        self._save_ckpt(act_full, in_buf, dict(
            step=int(step), shrink_events=int(nshr),
            next_shrink=int(self.state.next_shrink), **ph.snapshot()))

    # -- main --------------------------------------------------------------
    def fit(self, X, y: np.ndarray):
        """Run Alg. 5 on ``(X, y)``; returns ``(alpha, gamma, y, stats)``
        (host numpy) for the solver's finalize. ``X`` is a dense (n, d)
        matrix or, with ``format='ell'``, CSR input, which streams CSR->ELL
        buffers and never allocates a dense X on the host."""
        cfg, h, sv = self.cfg, self.h, self.s
        if cfg.compact_backend not in ("device", "host"):
            raise ValueError(
                f"unknown compact_backend {cfg.compact_backend!r} "
                "(want 'device' or 'host')")
        if cfg.row_cache_policy not in rowcache.POLICIES:
            raise ValueError(
                f"unknown row_cache_policy {cfg.row_cache_policy!r}; "
                f"known: {rowcache.POLICIES}")
        t0 = time.perf_counter()
        if spfmt.is_csr_like(X):
            X = spfmt.as_csr(X)      # normalizes scipy-like / tuple forms
        else:
            X = np.ascontiguousarray(X, np.float32)
        y = np.ascontiguousarray(y, np.float32)
        n = int(X.shape[0])
        if not set(np.unique(y).tolist()) <= {-1.0, 1.0}:
            raise ValueError("labels must be +-1")
        sv._store = dataplane.make_store(X, cfg.format, cfg.ell_K,
                                         cfg.ell_lane)
        del X                                  # train from the store only

        self.y = y
        self.alpha = np.zeros((n,), np.float32)
        self.gamma = (-y).astype(np.float32)
        self.stats = stats = FitStats(min_active=n)

        interval = self._interval = h.interval(n)
        ph = Phase(cfg, h.policy)
        t_train = 0.0
        t_recon = 0.0
        stalled = False
        p = sv._nshards()
        self._saves = 0
        step0, nshr0, ns0, act0, inb0 = 0, 0, None, None, None
        if cfg.resume and cfg.checkpoint_dir:
            got = self._load_ckpt(n)
            if got is not None:
                g, meta = got
                self.alpha, self.gamma = g["alpha"], g["gamma"]
                act0 = g["active"].astype(bool)
                inb0 = g["in_buffer"].astype(bool)
                step0 = int(meta["step"])
                nshr0 = int(meta.get("shrink_events", 0))
                ns0 = meta.get("next_shrink")
                ph.load(meta)
        shrink_on = ph.shrink_on
        # the runner and the mirror are built after a possible restore: a
        # Single-policy step taken after its reconstruction carries
        # shrink_on=False, and a runner built with the interval would switch
        # shrinking back on
        runner = sv._runner(cfg, interval if shrink_on else 0)

        mode, mir_m_per, mir_K, _ = mirror.resolve(cfg, sv._store, p,
                                                   shrink_on, sv.device)
        stats.mirror = mode
        self.mirror = (mirror.build(sv._store, y, sv._put, p, mir_m_per,
                                    mir_K)
                       if mode == "device" else None)
        if self.mirror is not None:
            self._refresh_masters()     # the mirror build gathers alpha/gamma
            self.y_d = sv._put_full(y)  # from the masters; Eq. 9 reads y_d

        resumed = act0 is not None and shrink_on
        # a resume rebuilds the saved membership, not only the active set:
        # at the same world size that is the saved geometry
        rows = np.flatnonzero(inb0) if resumed else np.arange(n)
        if self.mirror is not None and rows.size < n:
            # a compacted membership is filled from the host store (bitwise
            # the device compaction's buffer); the masters are the restored
            # arrays already
            self.data, self.yb, self.state, self.idx = self._make_buffer(
                y, self.alpha, self.gamma, rows)
        else:
            self.data, self.yb, self.state, self.idx = self._build_buffer(
                rows)
        if resumed:
            # a fresh build marks every row active: restore the saved flags
            ib = self.idx
            actb = np.where(ib >= 0, act0[np.maximum(ib, 0)], False)
            self.state = self.state.replace(active=sv._put(actb))
        self._note_buffer()
        i64 = lambda v: torch.tensor(int(v), dtype=torch.int64,
                                     device=self.state.step.device)
        self.state = self.state.replace(step=i64(step0), n_shrinks=i64(nshr0))
        if shrink_on:
            # the shrink schedule is anchored at the last shrink or
            # compaction, not at the save: a resume takes the saved anchor
            self.state = self.state.replace(next_shrink=i64(
                step0 + interval if ns0 is None else ns0))
        # the kernel-row cache (None when off) is never saved: its rows are
        # exact, so an empty one is trajectory-neutral. miss_seen follows
        # its cumulative miss counter, so each dispatch bills the rows it
        # actually recomputed
        self.cache = sv._new_cache(self.data.m)
        miss_seen = 0
        fuse = max(1, int(cfg.fuse_iters))
        mper_lo = max(cfg.min_buffer // p, 8)   # full_m_per's clamp floor
        step_host = step0
        ckpt_count = 0
        # the straggler watchdog (off unless watchdog_threshold > 0) reads
        # each dispatch's wall time; a flagged dispatch forces a save at its
        # boundary and halves the segment budget. On a process group the
        # flag is agreed (max over ranks) before anything uses it
        watchdog = None
        if cfg.watchdog_threshold > 0:
            from repro_torch.launch.elastic import StragglerWatchdog
            watchdog = StragglerWatchdog(
                threshold=cfg.watchdog_threshold,
                window=cfg.watchdog_window, warmup=cfg.watchdog_warmup)

        while True:
            tol = ph.tol()
            # ---- inner optimization at the current tolerance ------------
            while True:
                if watchdog is not None:
                    watchdog.start_step()
                tc = time.perf_counter()
                # inside the timed region: an injected delay inflates this
                # dispatch's wall time as a real straggler would; a kill
                # fires before the runner launches
                chaos.on_dispatch(stats.dispatches)
                step_before = step_host
                # the segment budget stops where the k == 1 oracle saves
                k_eff = (heuristics.fuse_budget(fuse, ckpt_count,
                                                cfg.checkpoint_every)
                         if cfg.checkpoint_dir else fuse)
                # integer-exact host twin of the compaction trigger
                compact_lt = (math.ceil(cfg.compact_ratio * (self.data.m * p))
                              if ph.shrink_on else 0)
                self.state, self.cache, summ_d = runner(
                    self.data, self.yb, self.state, self.cache, tol, k_eff,
                    cfg.chunk_iters, cfg.max_iters, compact_lt, mper_lo)
                summ = smo.EpochSummary.from_tensor(summ_d.cpu())  # one sync
                dt = time.perf_counter() - tc
                t_train += dt
                stats.dispatches += 1
                stats.dispatch_times.append(dt)
                step_host = summ.step
                # model FLOPs by the reference's rule: one kernel-row pass
                # per row computed (2 an iteration without the cache, the
                # misses with it), and the O(M) epilogue every iteration
                iters_done = step_host - step_before
                if self.cache is not None:
                    rows_new = summ.cache_misses - miss_seen
                    miss_seen = summ.cache_misses
                else:
                    rows_new = 2 * iters_done
                m_all = float(self.data.m * p)
                prod = rows_new * self.data.flops_row_pass() * m_all
                epi = iters_done * (12.0 if cfg.selection == "wss2"
                                    else 4.0) * m_all
                stats.flops_production += prod
                stats.flops_epilogue += epi
                stats.flops_est += prod + epi
                stats.min_active = min(stats.min_active, summ.min_active)
                straggled = False
                if watchdog is not None:
                    straggled = bool(sv._agree_max(int(watchdog.end_step())))
                if straggled:
                    stats.straggle_events += 1
                    fuse = max(1, fuse // 2)
                save = False
                if cfg.checkpoint_dir:
                    ckpt_count += summ.segs
                    save = straggled or (cfg.checkpoint_every > 0 and
                                         ckpt_count % cfg.checkpoint_every
                                         == 0)
                if summ.converged or summ.stalled \
                        or step_host >= cfg.max_iters:
                    if save:
                        self._checkpoint_now(n, step_host, summ.n_shrinks,
                                             ph)
                    break
                if summ.need_compact:
                    m_per = mirror.full_m_per(summ.n_active, p,
                                              cfg.min_buffer)
                    self._compact(summ.n_active, p, m_per, summ.shard_ext)
                if save:
                    self._checkpoint_now(n, step_host, summ.n_shrinks, ph)
            stalled = stalled or summ.stalled
            stats.shrink_events = summ.n_shrinks
            if self.mirror is not None:
                # device mode: masters hold the truth; host alpha picks the
                # SV set for reconstruction, host gamma syncs at fit exit
                self._writeback_masters()
                self.alpha = self.alpha_d.cpu().numpy().copy()
            else:
                self._writeback()

            tr = time.perf_counter()
            done = ph.end(self._eq9_on_recomputed_gamma, tol, step_host,
                          step_host >= cfg.max_iters, summ.stalled)
            t_recon += time.perf_counter() - tr
            if done:
                break
            # un-shrink: rebuild the full buffer; Single disables shrinking
            step_t, nshr_t = self.state.step, self.state.n_shrinks
            self.data, self.yb, self.state, self.idx = self._build_buffer(
                np.arange(n))
            # the cache survives the growth: every tagged slot is rewarmed
            # over the grown buffer with the in-loop kernels (wss1 the
            # two-row pass, wss2 the duplicated-query single row), so a
            # later hit serves the bits a miss would compute
            self.cache = sv._regrow_cache(
                self.cache, self.data, cfg.selection != "wss2", n)
            self._note_buffer()
            if not ph.shrink_on:
                runner = sv._runner(cfg, 0)
                next_shrink = self.state.next_shrink
            else:
                runner = sv._runner(cfg, interval)
                next_shrink = step_t + interval
            self.state = self.state.replace(step=step_t, n_shrinks=nshr_t,
                                            next_shrink=next_shrink)

        # ---- account ----------------------------------------------------
        if self.mirror is not None:
            self.gamma = self.gamma_d.cpu().numpy().copy()
        stats.iterations = step_host
        stats.reconstructions = ph.recon_count
        stats.eq9_rechecks = ph.eq9_rechecks
        stats.train_time = t_train
        stats.recon_time = t_recon
        stats.stalled = stalled
        if self.cache is not None:
            stats.cache_hits = int(self.cache.hits)
            stats.cache_misses = int(self.cache.misses)
            looked = stats.cache_hits + stats.cache_misses
            stats.cache_hit_rate = (stats.cache_hits / looked
                                    if looked else 0.0)
        stats.total_time = time.perf_counter() - t0
        return self.alpha, self.gamma, y, stats
