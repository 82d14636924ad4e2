"""SMO (Keerthi Modification-2) fused-epoch inner loop with in-loop
adaptive shrinking (twin of ``repro.core.smo``; dense or block-ELL
storage, with or without the kernel-row cache).

One iteration of the paper's Algorithm 1:

  1. working-set selection (Eq. 8): worst KKT violators over the active set,
  2. analytic pair update (Eq. 11/12) with joint box clipping (Eq. 2),
  3. gradient (gamma) update (Eq. 6) for every sample in the buffer,
  4. shrink rule (Eq. 10) when the heuristic counter fires (Alg. 4),
  5. optimality test (Eq. 9).

Fused epochs without a while loop
---------------------------------
The reference runs segments as ``lax.while_loop``s on the device. Eager
PyTorch has no device-side loop, so a segment here is a Python loop of
exactly ``chunk_iters`` iterations that only *enqueues* device work: no
``.item()``, ``int()``, ``bool()`` or Python ``if`` on a device value, so
the host never waits for the card inside a dispatch. Each iteration
carries a device flag ``run`` (not converged, not stalled, within the
segment's iteration limit, epoch not yet done); every state write is
gated by it with ``torch.where``, so iterations after convergence, a stall
or the limit are exact no-ops and the state ends where the reference's
loop stops. ``lax.cond(do_shrink, ...)`` becomes an unconditional
``shrink_rule`` followed by a ``torch.where``. Between segments the
compaction predicate and the hard exits are evaluated on device, and the
host reads ONE fixed-size :class:`EpochSummary` per dispatch.

Ties in selection break to the lowest index (``torch.min``/``torch.max``
along a dim return the first extremal index, like ``jnp.argmin``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import dataplane, kernel_fns, rowcache, util
from repro_torch.kernels import ops

_INF = float("inf")
_TAU = 1e-12  # libsvm-style guard for non-PD pair curvature
_BND = 1e-6   # relative tolerance for at-bound classification: a sample
              # whose alpha lands within C*_BND of a bound is treated as AT
              # the bound (Eq. 7 sets), else a float-boundary sample can be
              # selected as a worst violator with no room to move -> stall


def f32(x: float) -> float:
    """``x`` rounded once to float32 (the reference's weak-typed constants
    round f64 products to f32 exactly once at the compare)."""
    return float(np.float32(x))


def bounds(C: float) -> tuple:
    """(thr0, thr1): f32(C*_BND) and f32(C*(1-_BND)), the at-bound cuts."""
    return f32(C * _BND), f32(C * (1.0 - _BND))


@dataclasses.dataclass
class SMOState:
    """Solver state over the (possibly compacted) buffer; every field is a
    tensor on the buffer's device (scalars are 0-d)."""
    alpha: torch.Tensor        # (M,) f32
    gamma: torch.Tensor        # (M,) f32 — Eq. 5
    active: torch.Tensor       # (M,) bool — False for shrunk + padding rows
    beta_up: torch.Tensor      # f32
    beta_low: torch.Tensor     # f32
    i_up: torch.Tensor         # i64 index into buffer
    i_low: torch.Tensor        # i64
    step: torch.Tensor         # i64, global iteration counter
    next_shrink: torch.Tensor  # i64, iteration of next shrink-rule application
    n_shrinks: torch.Tensor    # i64, shrink events so far
    converged: torch.Tensor    # bool — Eq. 9 at the dispatch tolerance
    stalled: torch.Tensor      # bool — progress guard tripped

    def replace(self, **kw) -> "SMOState":
        return dataclasses.replace(self, **kw)


class EpochSummary(NamedTuple):
    """The per-dispatch readback of the fused epoch runner (host ints) —
    the only host<->device traffic of the optimization hot loop."""
    step: int          # global iteration counter after the epoch
    segs: int          # segments actually run (<= k)
    n_active: int      # active count after the last segment
    min_active: int    # min of the per-segment active counts
    n_shrinks: int     # cumulative shrink events
    converged: bool    # Eq. 9 at the dispatch tolerance
    stalled: bool      # progress guard tripped
    need_compact: bool  # device-evaluated compaction predicate
    cache_hits: int     # cumulative row-cache hits (0: cache off)
    cache_misses: int   # cumulative row-cache misses
    shard_ext: tuple    # (p,) per-shard surviving ELL extents when
                        # need_compact fired on an ELL buffer, else zeros

    @classmethod
    def from_tensor(cls, t: torch.Tensor) -> "EpochSummary":
        v = t.tolist()
        return cls(int(v[0]), int(v[1]), int(v[2]), int(v[3]), int(v[4]),
                   bool(v[5]), bool(v[6]), bool(v[7]), int(v[8]), int(v[9]),
                   tuple(int(e) for e in v[10:]))


def _sets(alpha, pos, active, thr0, thr1):
    """(I_up, I_low) masks of Eq. 7. With the at-bound cuts disjoint,
    I_up = I0 u I1 u I2 is "below C" for y=+1 and "above 0" for y=-1, and
    I_low the mirror image."""
    below_c = alpha < thr1
    above_0 = alpha > thr0
    in_up = active & torch.where(pos, below_c, above_0)
    in_low = active & torch.where(pos, above_0, below_c)
    return in_up, in_low


def _select(gamma, alpha, pos, active, thr0, thr1, dim: int = 0):
    in_up, in_low = _sets(alpha, pos, active, thr0, thr1)
    b_up, i_up = torch.min(torch.where(in_up, gamma, _INF), dim)
    b_low, i_low = torch.max(torch.where(in_low, gamma, -_INF), dim)
    return b_up, i_up, b_low, i_low


def select_pair(gamma: torch.Tensor, alpha: torch.Tensor, y: torch.Tensor,
                active: torch.Tensor, C: float):
    """Working-set selection, Eq. 8 over index sets Eq. 7:
    I_up = I0 u I1 u I2, I_low = I0 u I3 u I4. Returns
    (beta_up, i_up, beta_low, i_low); ties break to the lowest index."""
    thr0, thr1 = bounds(C)
    return _select(gamma, alpha, y > 0, active, thr0, thr1)


def _shrink(gamma, alpha, pos, active, beta_up, beta_low, thr0, thr1):
    at_zero = alpha <= thr0
    at_c = alpha >= thr1
    i12 = torch.where(pos, at_zero, at_c)
    i34 = torch.where(pos, at_c, at_zero)
    drop = (i34 & (gamma < beta_up)) | (i12 & (gamma > beta_low))
    return active & ~drop


def shrink_rule(gamma: torch.Tensor, alpha: torch.Tensor, y: torch.Tensor,
                active: torch.Tensor, beta_up: torch.Tensor,
                beta_low: torch.Tensor, C: float) -> torch.Tensor:
    """Eq. 10: drop bound samples that cannot re-enter the working set —
    i in I3 u I4 with gamma_i < beta_up, i in I1 u I2 with
    gamma_i > beta_low."""
    thr0, thr1 = bounds(C)
    return _shrink(gamma, alpha, y > 0, active, beta_up, beta_low, thr0,
                   thr1)


def pair_update(alpha_up, alpha_low, y_up, y_low, g_up, g_low, k_ul, k_uu,
                k_ll, C: float):
    """Analytic two-variable solve, Eq. 11/12, with joint L/H clipping that
    preserves sum(alpha*y) and keeps both alphas in [0, C]. Arguments are
    0-d f32 tensors (``C`` a float); returns (a_up_new, a_low_new)."""
    return _pair_update(alpha_up, alpha_low, y_up, y_low, g_up, g_low, k_ul,
                        k_uu, k_ll, f32(C))


def _pair_update(alpha_up, alpha_low, y_up, y_low, g_up, g_low, k_ul, k_uu,
                 k_ll, C):
    # C is an f32-exact float or an f32 tensor of the arguments' shape
    rho = 2.0 * k_ul - k_uu - k_ll          # Eq. 12 (== -eta, negative for PD)
    rho = torch.clamp(rho, max=-_TAU)
    a_low_unc = alpha_low - y_low * (g_up - g_low) / rho
    s = y_up * y_low
    same = s > 0
    lo = torch.where(same, torch.clamp(alpha_up + alpha_low - C, min=0.0),
                     torch.clamp(alpha_low - alpha_up, min=0.0))
    hi = torch.where(same, torch.clamp(alpha_up + alpha_low, max=C),
                     torch.clamp(C + alpha_low - alpha_up, max=C))
    a_low_new = torch.minimum(torch.maximum(a_low_unc, lo), hi)
    a_up_new = alpha_up + s * (alpha_low - a_low_new)
    # exact box (guards fp drift); a tensor bound needs a tensor minimum
    lo0 = 0.0 if not torch.is_tensor(C) else torch.zeros_like(C)
    a_up_new = torch.clamp(a_up_new, lo0, C)
    return a_up_new, a_low_new


def wss2_scores(gamma, alpha, y, active, C, g_up, row_up, kdiag, k_uu):
    """Second-order selection scores for i_low (Fan-Chen-Lin WSS2): among
    j in I_low with gamma_j > gamma_up, b^2/a with b = gamma_j - gamma_up
    and a = K_uu + K_jj - 2 K_uj; -inf elsewhere. (M,)."""
    thr0, thr1 = bounds(C)
    return _wss2(gamma, alpha, y > 0, active, thr0, thr1, g_up, row_up,
                 kdiag, k_uu)


def _wss2(gamma, alpha, pos, active, thr0, thr1, g_up, row_up, kdiag, k_uu):
    _, in_low = _sets(alpha, pos, active, thr0, thr1)
    b = gamma - g_up
    a = torch.clamp(k_uu + kdiag - 2.0 * row_up, min=_TAU)
    return torch.where(in_low & (b > 0), b * b / a, -_INF)


# -- the multi-problem twins ---------------------------------------------
# K problems over one buffer: (K, M) state, (K,) box constants and scalars.
# Each is the 1-D function's elementwise ops on a problem axis, and the
# (K, M) reductions break ties to the lowest index along dim 1, so every
# problem's lane has the bits the 1-D function gives it alone. Eager torch
# rounds every op on its own, so unlike the reference (which unrolls the
# pair update per problem to pin XLA's FMA contraction) the (K,) update is
# vectorized.

def box_thresholds(Cs):
    """Per-problem (thr0, thr1, Cv) as (K,) f32 numpy arrays: each lane's
    ``bounds(C_k)`` and ``f32(C_k)`` (products in f64, rounded once)."""
    Cs = np.asarray(Cs, np.float64).reshape(-1)
    return (np.asarray(Cs * _BND, np.float32),
            np.asarray(Cs * (1.0 - _BND), np.float32),
            np.asarray(Cs, np.float32))


def select_pair_multi(gamma, alpha, y, active, thr0, thr1):
    """Eq. 8 for K problems: (K, M) state and (K,) cuts -> (beta_up, i_up,
    beta_low, i_low), each (K,); ties to the lowest index per problem."""
    return _select(gamma, alpha, y > 0, active, thr0[:, None],
                   thr1[:, None], dim=1)


def shrink_rule_multi(gamma, alpha, y, active, beta_up, beta_low, thr0,
                      thr1):
    """Eq. 10 for K problems: the (K, M) active masks after the rule."""
    return _shrink(gamma, alpha, y > 0, active, beta_up[:, None],
                   beta_low[:, None], thr0[:, None], thr1[:, None])


def pair_update_multi(alpha_up, alpha_low, y_up, y_low, g_up, g_low, k_ul,
                      k_uu, k_ll, Cv):
    """Eq. 11/12 for K problems: (K,) f32 tensors and the (K,) f32 box
    ``Cv``; returns (a_up_new, a_low_new), each (K,)."""
    return _pair_update(alpha_up, alpha_low, y_up, y_low, g_up, g_low, k_ul,
                        k_uu, k_ll, Cv)


def wss2_scores_multi(gamma, alpha, y, active, thr0, thr1, g_up, rows_up,
                      kdiag, k_uu):
    """Second-order i_low scores for K problems: (K, M) state, each
    problem's i_up row ``rows_up`` (K, M), (K,) ``g_up`` / ``k_uu`` and the
    buffer's (M,) ``kdiag`` -> (K, M) scores."""
    return _wss2(gamma, alpha, y > 0, active, thr0[:, None], thr1[:, None],
                 g_up[:, None], rows_up, kdiag, k_uu[:, None])


def make_chunk_runner(kernel: str, C: float, inv_2s2: float,
                      shrink_interval: int, selection: str = "wss1",
                      fmt: str = "dense", cache_slots: int = 0,
                      cache_policy: str = "lru"):
    """Build the fused-epoch runner::

        state, cache, summary = run_epoch(data, y, state, cache, tol, k,
                                          chunk_iters, max_iters,
                                          compact_lt, mper_lo)

    which enqueues up to ``k`` segments of ``chunk_iters`` SMO iterations
    each — a segment's iterations stop (become no-ops) on Eq. 9
    convergence over the active set, the stall guard or the iteration
    limit, and the epoch's segments stop on any hard exit or the moment the
    compaction predicate fires. ``summary`` is an (11,) int64 device tensor
    (:meth:`EpochSummary.from_tensor` reads it in one sync); its last
    entry is the (p = 1,) ``shard_ext`` lane.

    ``state.alpha`` is updated in place (the reference donates the state),
    which saves an (M,) copy per iteration; the other fields are replaced.

    ``shrink_interval`` <= 0 disables in-loop shrinking (the paper's
    "Original", Alg. 3); otherwise the next shrink fires after
    min(shrink_interval, n_active) further iterations (Sec. 3.3.1).
    ``selection``: 'wss1' = maximal violating pair (Eq. 8), with the fused
    ``gamma_update`` kernel for Eq. 6; 'wss2' = second-order pair
    selection, two single-row passes per iteration through ``rows2``.

    ``fmt`` is the buffer's storage: 'dense' (``DenseData``) or 'ell'
    (``ELLData``, the paper's sparse storage, Sec. 2.2). Working-set rows
    travel dense either way (``data.dense_rows``); the M-row passes stay in
    the buffer's format, through the provider of (kernel, fmt) — on ELL
    the fused ``ell_gamma_update`` (wss1) and ``ell_kernel_rows2`` (wss2).

    ``cache_slots`` > 0 threads a kernel-row cache (``core/rowcache.py``,
    a ``RowCache`` of that many slots, ``cache_policy`` 'lru' | 'slru')
    through the loop: rows are served from it on a hit and recomputed by
    the cache-off path's kernels on a miss, and wss1 then takes its rows
    and the Eq. 6 epilogue (``ops.gamma_from_rows``) instead of the fused
    ``gamma_update``, as the reference's Pallas path does. With
    ``cache_slots == 0`` the cache is passed as None and returned as it is.
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
    thr0, thr1 = bounds(C)
    Cf = f32(C)

    def run_epoch(data, y: torch.Tensor, state: SMOState, cache, tol: float,
                  k: int, chunk_iters: int, max_iters: int, compact_lt: int,
                  mper_lo: int):
        dev = y.device
        m = data.m
        pos = y > 0
        tol = f32(tol)
        kdiag = provider.diag(data) if selection == "wss2" else None
        get_row1, get_rows2 = rowcache.make_accessors(provider, data, cached,
                                                      cache_policy)

        def gids(idx):   # the cache's tags of buffer rows idx (k,)
            return data.gids.index_select(0, idx) if cached else None

        def body(s: SMOState, c, run: torch.Tensor):
            if selection == "wss2":
                x_up = data.dense_rows(s.i_up.view(1))[0]
                k_uu = kself(x_up[None], inv_2s2)[0]
                row_up, c = get_row1(c, gids(s.i_up.view(1)), x_up, run)
                scores = _wss2(s.gamma, s.alpha, pos, s.active, thr0, thr1,
                               s.beta_up, row_up, kdiag, k_uu)
                il = torch.argmax(scores)
                idx2 = torch.stack([s.i_up, il])
                z2 = data.dense_rows(idx2)
                g_low = s.gamma.index_select(0, il.view(1))[0]
                # K(x_up, x_low) is the i_low entry of the selection row:
                # the update prices the pair with the value it was scored by
                k_ul = row_up.index_select(0, il.view(1))[0]
            else:
                idx2 = torch.stack([s.i_up, s.i_low])
                z2 = data.dense_rows(idx2)
                g_low = s.beta_low
                xu, xl = z2[0], z2[1]
                k_ul = row1(xl[None], torch.sum(xl * xl)[None], xu,
                            inv_2s2)[0]
            ks = kself(z2, inv_2s2)
            y2 = y.index_select(0, idx2)
            a2 = s.alpha.index_select(0, idx2)
            a_up_new, a_low_new = pair_update(
                a2[0], a2[1], y2[0], y2[1], s.beta_up, g_low, k_ul,
                ks[0], ks[1], Cf)
            new2 = torch.where(run, torch.stack([a_up_new, a_low_new]), a2)
            delta = new2 - a2
            stalled = s.stalled | (run & torch.all(torch.abs(delta) < _TAU))
            alpha = s.alpha.index_put_((idx2,), new2)
            coef2 = y2 * delta                       # zero unless run
            if selection == "wss2":
                row_low, c = get_row1(c, gids(il.view(1)), z2[1], run)
                gamma = s.gamma + coef2[0] * row_up + coef2[1] * row_low
            elif cached:
                rows, c = get_rows2(c, gids(idx2), z2, run)
                gamma = ops.gamma_from_rows(s.gamma, rows, coef2)
            else:
                gamma = provider.gamma_update(data, s.gamma, z2, coef2)
            gamma = torch.where(run, gamma, s.gamma)

            step1 = s.step + run
            active, next_shrink, n_shrinks = (s.active, s.next_shrink,
                                              s.n_shrinks)
            if shrink_interval > 0:
                # Alg. 4 / Sec. 3.3.1: apply Eq. 10 when the counter fires
                do_shrink = run & (step1 >= s.next_shrink)
                active = torch.where(
                    do_shrink, _shrink(gamma, alpha, pos, s.active,
                                       s.beta_up, s.beta_low, thr0, thr1),
                    s.active)
                interval = torch.clamp(
                    torch.clamp(active.sum(), max=shrink_interval), min=1)
                next_shrink = torch.where(do_shrink, step1 + interval,
                                          s.next_shrink)
                n_shrinks = s.n_shrinks + do_shrink
            # with run False, gamma/alpha/active are unchanged, so selection
            # reproduces the current scalars exactly: no masking needed
            b_up, i_up, b_low, i_low = _select(gamma, alpha, pos, active,
                                               thr0, thr1)
            return SMOState(alpha, gamma, active, b_up, b_low, i_up, i_low,
                            step1, next_shrink, n_shrinks,
                            b_up + tol >= b_low, stalled), c

        def run_segment(s: SMOState, c, live: torch.Tensor):
            # segment entry: (re)establish selection/convergence for the
            # current buffer and clear the stall latch (masked when the
            # epoch is already done)
            b_up, i_up, b_low, i_low = _select(s.gamma, s.alpha, pos,
                                               s.active, thr0, thr1)
            s = s.replace(
                beta_up=torch.where(live, b_up, s.beta_up),
                beta_low=torch.where(live, b_low, s.beta_low),
                i_up=torch.where(live, i_up, s.i_up),
                i_low=torch.where(live, i_low, s.i_low),
                converged=torch.where(live, b_up + tol >= b_low,
                                      s.converged),
                stalled=s.stalled & ~live)
            # the reference's min(chunk_iters, max(1, max_iters - start))
            end = s.step + torch.clamp(
                torch.clamp(max_iters - s.step, min=1), max=chunk_iters)
            for _ in range(chunk_iters):
                run = live & ~s.converged & ~s.stalled & (s.step < end)
                s, c = body(s, c, run)
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
            n_seg = s.active.sum()
            min_act = torch.where(live, torch.minimum(min_act, n_seg),
                                  min_act)
            hard = s.converged | s.stalled | (s.step >= max_iters)
            if shrink_interval > 0:
                # device twin of the host compaction test: n_active below
                # ceil(compact_ratio * m) AND the rebuilt buffer would be
                # smaller after pow2 bucketing (exact integers)
                nc = ~hard & (n_seg < compact_lt) & (
                    util.bucket_pow2_device(n_seg, mper_lo) < m)
            else:
                nc = torch.zeros((), dtype=torch.bool, device=dev)
            need_c = torch.where(live, nc, need_c)
            n_act = torch.where(live, n_seg, n_act)
            segs = segs + live
            done = done | hard | nc
        if fmt == "ell" and shrink_interval > 0:
            # (p,) surviving extents ride the summary, so an ELL compaction
            # needs no extra readback. The reference computes them under a
            # lax.cond on need_compact; eager PyTorch cannot branch on a
            # device flag without a sync, so they are computed once per
            # dispatch and masked — the same values.
            shard_ext = torch.where(
                need_c, dataplane.ell_shard_extents_dyn(
                    data.vals, s.active, n_act, 1), 0)
        else:
            shard_ext = torch.zeros((1,), dtype=torch.int64, device=dev)
        hits, misses = (c.hits, c.misses) if cached else (zero, zero)
        summary = torch.cat([
            torch.stack([s.step, segs, n_act, min_act, s.n_shrinks,
                         s.converged.to(torch.int64),
                         s.stalled.to(torch.int64),
                         need_c.to(torch.int64), hits, misses]), shard_ext])
        return s, c, summary

    return run_epoch


def init_state(alpha: torch.Tensor, gamma: torch.Tensor,
               active: torch.Tensor) -> SMOState:
    """Fresh state around the given buffer arrays (Alg. 1 lines 1-3 are
    alpha = 0, gamma = -y on the initial buffer). Selection scalars are
    (re)established by the runner before its first iteration."""
    dev = alpha.device

    def i64(v):
        return torch.tensor(v, dtype=torch.int64, device=dev)

    false = torch.tensor(False, device=dev)
    return SMOState(alpha=alpha, gamma=gamma, active=active,
                    beta_up=torch.tensor(-1.0, device=dev),
                    beta_low=torch.tensor(1.0, device=dev),
                    i_up=i64(0), i_low=i64(0), step=i64(0),
                    next_shrink=i64(0), n_shrinks=i64(0),
                    converged=false, stalled=false.clone())
