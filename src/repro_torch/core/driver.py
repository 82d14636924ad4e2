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

Checkpoints, elastic resume, the straggler watchdog, chaos hooks and the
row cache are later slices of the port; ``SVMConfig`` refuses them.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import dataplane, mirror, smo
from repro_torch.data import sparse as spfmt

_P = 1   # shards a buffer is dealt over: one device (the dataplane layouts
         # take p, which the multi-GPU slice will set to the device count)


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
    # per-buffer tuple of each shard's lane-rounded K (one shard here)
    mirror: str = ""             # resolved full-set mirror mode of this fit
    flops_est: float = 0.0       # model FLOPs of the gamma-update hot loop,
                                 # by the reference's rule: production plus
                                 # epilogue
    flops_production: float = 0.0   # kernel-row passes: 2 an iteration (no
                                 # row cache), flops_row_pass per buffer row
    flops_epilogue: float = 0.0  # O(M) Eq. 6 FMA (4 flops a buffer row; 12
                                 # under wss2, the selection sweep added)


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


def _scatter_full(alpha_d, gamma_d, alpha_buf, gamma_buf, gids):
    """Write a buffer's alpha/gamma into the (n,) device masters in place,
    keyed by global id (padding rows, gid -1, are skipped) — the one
    master-writeback rule of the epoch writeback and the compaction step."""
    real = gids >= 0
    g = gids[real]
    alpha_d[g] = alpha_buf[real]
    gamma_d[g] = gamma_buf[real]
    return alpha_d, gamma_d


def _compact_step(data, yb, state: smo.SMOState, alpha_d, gamma_d,
                  n_active: int, interval: int, p: int, m_per: int,
                  K_new: "int | None" = None):
    """One device-side physical compaction: master writeback for the
    outgoing buffer, the balanced gather plan, the row/vector gathers (ELL
    rows truncated to ``K_new``) and the fresh state (step counters
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
    return data2, yb2, state2, alpha_d, gamma_d


class EpochDriver:
    """The Alg. 5 state machine around a solver's hook surface: device
    placement (``_put`` / ``_put_full``), runner construction
    (``_runner``) and Alg. 6
    (``_reconstruct`` / ``_reconstruct_mirror``). One instance drives one
    ``fit``; mutable run state lives on the instance."""

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
    def _make_buffer(self, y, alpha, gamma, idx):
        """Gather rows ``idx`` from the host store into a padded buffer of
        p balanced shards. Returns (data, y_buf, fresh state, idx_buf),
        idx_buf mapping buffer row -> global id (-1 on padding)."""
        sv = self.s
        store = sv._store
        p = _P
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
        :meth:`_make_buffer`; only the keep mask goes up."""
        sv, mir = self.s, self.mirror
        p = mir.p
        m_per, K_new = self._buffer_geometry(rows, p)
        keep = np.zeros((mir.idx.size,), bool)
        keep[mir.pos_of[rows]] = True
        data, yb, state = mirror.grow_step(
            mir.data, mir.y, self.alpha_d, self.gamma_d, sv._put(keep),
            rows.size, p, m_per, K_new)
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
            self.idx = self.data.gids.cpu().numpy().astype(np.int64)
        return self.idx

    def _note_buffer(self):
        """Record the buffer's geometry: its size, and on ELL its lane
        budget and per-shard K."""
        self.stats.buffer_sizes.append(self.data.m)
        if isinstance(self.data, dataplane.ELLData):
            self.stats.buffer_K.append(self.data.K)
            self.stats.shard_K.append(self._last_shard_K)

    # -- writeback ---------------------------------------------------------
    def _writeback_masters(self):
        self.alpha_d, self.gamma_d = _scatter_full(
            self.alpha_d, self.gamma_d, self.state.alpha, self.state.gamma,
            self.data.gids)

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
                r = sv._put(rows)
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
            (self.data, self.yb, self.state, self.alpha_d,
             self.gamma_d) = _compact_step(
                self.data, self.yb, self.state, self.alpha_d, self.gamma_d,
                n_active, self._interval, p, m_per, K_new)
            self.idx = None
        else:
            self._writeback()
            idx = self._host_idx()
            keep = idx[(idx >= 0) & self.state.active.cpu().numpy()]
            step, nshr = self.state.step, self.state.n_shrinks
            self.data, self.yb, state2, self.idx = self._make_buffer(
                self.y, self.alpha, self.gamma, keep)
            self.state = state2.replace(
                step=step,
                next_shrink=step + max(1, min(self._interval, keep.size)),
                n_shrinks=nshr)
        if self.state.alpha.is_cuda:
            torch.cuda.synchronize(self.state.alpha.device)
        self.stats.compactions += 1
        self.stats.compact_time += time.perf_counter() - t0
        self._note_buffer()

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
        tol20 = smo.f32(cfg.recon_eps_factor * cfg.eps)
        tol2 = smo.f32(2.0 * cfg.eps)
        shrink_on = h.policy != "none"
        recon_count = 0
        t_train = 0.0
        t_recon = 0.0
        stalled = False
        runner = sv._runner(cfg, interval if shrink_on else 0)
        p = _P

        mode, mir_m_per, mir_K, _ = mirror.resolve(cfg, sv._store, p,
                                                   shrink_on, sv.device)
        stats.mirror = mode
        self.mirror = (mirror.build(sv._store, y, sv._put, p, mir_m_per,
                                    mir_K)
                       if mode == "device" else None)
        if self.mirror is not None:
            self._refresh_masters()     # the mirror build gathers alpha/gamma
            self.y_d = sv._put_full(y)  # from the masters; Eq. 9 reads y_d

        self.data, self.yb, self.state, self.idx = self._build_buffer(
            np.arange(n))
        self._note_buffer()
        if shrink_on:
            self.state = self.state.replace(
                next_shrink=self.state.step + interval)
        fuse = max(1, int(cfg.fuse_iters))
        mper_lo = max(cfg.min_buffer // p, 8)   # full_m_per's clamp floor
        step_host = 0
        recheck_step = -1

        while True:
            tol = tol20 if (shrink_on and recon_count == 0) else tol2
            # ---- inner optimization at the current tolerance ------------
            while True:
                tc = time.perf_counter()
                step_before = step_host
                # integer-exact host twin of the compaction trigger
                compact_lt = (math.ceil(cfg.compact_ratio * self.data.m)
                              if shrink_on else 0)
                self.state, summ_d = runner(
                    self.data, self.yb, self.state, tol, fuse,
                    cfg.chunk_iters, cfg.max_iters, compact_lt, mper_lo)
                summ = smo.EpochSummary.from_tensor(summ_d.cpu())  # one sync
                dt = time.perf_counter() - tc
                t_train += dt
                stats.dispatches += 1
                stats.dispatch_times.append(dt)
                step_host = summ.step
                # model FLOPs by the reference's rule: no row cache, so two
                # kernel-row passes an iteration, and the O(M) epilogue
                iters_done = step_host - step_before
                prod = 2.0 * iters_done * self.data.flops_row_pass() \
                    * float(self.data.m)
                epi = iters_done * (12.0 if cfg.selection == "wss2"
                                    else 4.0) * float(self.data.m)
                stats.flops_production += prod
                stats.flops_epilogue += epi
                stats.flops_est += prod + epi
                stats.min_active = min(stats.min_active, summ.min_active)
                if summ.converged or summ.stalled \
                        or step_host >= cfg.max_iters:
                    break
                if summ.need_compact:
                    m_per = mirror.full_m_per(summ.n_active, p,
                                              cfg.min_buffer)
                    self._compact(summ.n_active, p, m_per, summ.shard_ext)
            stalled = stalled or summ.stalled
            stats.shrink_events = summ.n_shrinks
            if self.mirror is not None:
                # device mode: masters hold the truth; host alpha picks the
                # SV set for reconstruction, host gamma syncs at fit exit
                self._writeback_masters()
                self.alpha = self.alpha_d.cpu().numpy().copy()
            else:
                self._writeback()

            spent = step_host >= cfg.max_iters
            tr = time.perf_counter()
            if shrink_on and recon_count < cfg.max_reconstructions \
                    and not spent:
                # ---- gradient reconstruction + un-shrink (Alg. 5 l. 26-33)
                recon_count += 1
                ok = self._eq9_on_recomputed_gamma()
                t_recon += time.perf_counter() - tr
                if ok:
                    break
            else:
                # No reconstruction is due (original, a Single
                # re-optimisation, a spent budget), so the epochs' verdict
                # stands on gamma they updated in fp32: recheck it on
                # recomputed gamma, and optimise on from there if it fails.
                stats.eq9_rechecks += 1
                ok = self._eq9_on_recomputed_gamma()
                t_recon += time.perf_counter() - tr
                if ok or shrink_on or spent or summ.stalled \
                        or step_host == recheck_step:
                    break
                recheck_step = step_host
            if tol == tol2:
                # Eq. 9 on fp64 gamma refuted epochs that stopped at 2*eps.
                # Rebuilt from those values, their f32 gamma sits within
                # ~1e-7 of them; aim 0.1% below 2*eps so that they cannot
                # stop again at once on a rounding.
                tol2 = smo.f32(2.0 * cfg.eps * (1.0 - 1e-3))
            # un-shrink: rebuild the full buffer; Single disables shrinking
            step_t, nshr_t = self.state.step, self.state.n_shrinks
            self.data, self.yb, self.state, self.idx = self._build_buffer(
                np.arange(n))
            self._note_buffer()
            if not shrink_on or h.policy == "single":
                shrink_on = False
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
        stats.reconstructions = recon_count
        stats.train_time = t_train
        stats.recon_time = t_recon
        stats.stalled = stalled
        stats.total_time = time.perf_counter() - t0
        return self.alpha, self.gamma, y, stats
