"""Batched multi-problem SMO training: K binary problems over ONE resident
buffer (twin of ``repro.core.multi``; dense or block-ELL, with or without
the kernel-row cache).

One-vs-rest classes and (C, sigma2) grids train many binary problems on
the same X, and the kernel rows K(i, .) depend only on X. This module
trains K such problems as one batched program over a single data buffer:

  * per-problem state is stacked on a leading problem axis — alpha/gamma/
    active are (K, M), the selection scalars (K,) (:class:`MultiSMOState`);
  * selection, the pair update and the shrink rule run as the
    ``smo.*_multi`` twins of the single-problem functions, so each
    problem's lane has the bits it would have alone;
  * rows are produced per problem by the hand-written kernels, the calls
    the single runner makes: cache off, wss1 one fused ``gamma_update`` /
    ``ell_gamma_update`` per problem and joint iteration; cache on, every
    problem's pair through ONE shared ``rowcache.RowCache`` (in problem
    order, ``live`` = the problem's run flag), so a row one problem made
    serves every other problem's hit; wss2 the duplicated-query single
    row per problem (the reference's stacked (M, 2K) product is its plain
    provider's path, not its kernel path);
  * shrinking stays per problem (the (K, M) active masks); a physical
    compaction keeps the union of the live problems' active rows.

:class:`MultiProblemDriver` runs the host control flow: each problem lane
follows the port's ``driver.EpochDriver.fit`` — its own tolerance
schedule, reconstruction count, Eq. 9 rechecks on recomputed fp64 gamma
and shrink state — so ``backend='batched'`` equals ``backend='loop'`` (the
K problems through ``SMOSolver`` one after another) bit for bit per
problem. Finished problems retire: the host stops issuing their launches
at the next dispatch.

Fused epochs follow ``core/smo.py``: a segment enqueues ``chunk_iters``
joint iterations gated by a per-problem device flag ``run``, no host sync
inside a dispatch, and the host reads ONE fixed-size summary per dispatch.

Checkpoints (``SVMConfig(checkpoint_dir=..., resume=...)``): the batched
backend saves its (K, n) masters, control flags and each lane's phase
state as one self-validating ``multi_masters.npz`` with one older
generation beside it (the reference's format, plus the port's own state
as extra arrays); the loop backend gives each problem its own step-dir
tree ``p{k}``. A resumed batched fit equals the uncut one bit for bit per
problem.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import os
import time
import warnings
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.core import (bf16, dataplane, driver, kernel_fns, mirror,
                               reconstruct, rowcache, smo, util)
from repro_torch.core import heuristics as H
from repro_torch.core.solver import SVMConfig, SVMModel, SMOSolver
from repro_torch.data import sparse as spfmt
from repro_torch.kernels import ops
from repro_torch.launch import chaos

__all__ = ["MultiSMOState", "MultiEpochSummary", "init_multi_state",
           "make_multi_runner", "MultiProblemDriver", "OvRSVMModel",
           "ovr_tasks", "train_ovr"]

_INT32_MAX = 2**31 - 1   # per-problem next_shrink sentinel: shrinking off


@dataclasses.dataclass
class MultiSMOState:
    """K stacked problem states over one shared buffer of M rows; every
    field is a tensor on the buffer's device."""
    alpha: torch.Tensor        # (K, M) f32
    gamma: torch.Tensor        # (K, M) f32
    active: torch.Tensor       # (K, M) bool — per-problem shrink mask
    beta_up: torch.Tensor      # (K,) f32
    beta_low: torch.Tensor     # (K,) f32
    i_up: torch.Tensor         # (K,) i64
    i_low: torch.Tensor        # (K,) i64
    step: torch.Tensor         # (K,) i64 per-problem iteration counters
    next_shrink: torch.Tensor  # (K,) i64 (_INT32_MAX: shrinking off)
    n_shrinks: torch.Tensor    # (K,) i64
    converged: torch.Tensor    # (K,) bool
    stalled: torch.Tensor      # (K,) bool
    live: torch.Tensor         # (K,) bool — False once the driver retires
                               # the problem

    def replace(self, **kw) -> "MultiSMOState":
        return dataclasses.replace(self, **kw)


class MultiEpochSummary(NamedTuple):
    """The per-dispatch readback of the batched runner: (K,) numpy lanes
    where ``smo.EpochSummary`` has scalars."""
    step: np.ndarray           # (K,) per-problem iteration counters
    n_active: np.ndarray       # (K,) per-problem active counts
    n_shrinks: np.ndarray      # (K,)
    converged: np.ndarray      # (K,) bool
    stalled: np.ndarray        # (K,) bool
    segs: int                  # segments actually run
    joint_iters: int           # joint iterations in which any problem ran
    n_active_union: int        # rows active for >= 1 live problem
    need_compact: bool         # the union compaction predicate
    cache_hits: int            # cumulative (0: cache off)
    cache_misses: int

    @classmethod
    def from_tensor(cls, t: torch.Tensor, Kp: int) -> "MultiEpochSummary":
        v = t.numpy()
        lane = lambda j: v[j * Kp: (j + 1) * Kp].copy()
        s = v[5 * Kp:].tolist()
        return cls(lane(0), lane(1), lane(2), lane(3).astype(bool),
                   lane(4).astype(bool), int(s[0]), int(s[1]), int(s[2]),
                   bool(s[3]), int(s[4]), int(s[5]))


def init_multi_state(alpha, gamma, active, step, next_shrink, n_shrinks,
                     live) -> MultiSMOState:
    """Fresh batched state around (K, M) buffer tensors; the (K,) counters
    and ``live`` come from the host. Selection lanes are (re)established by
    the runner before its first iteration."""
    dev = alpha.device
    Kp = alpha.shape[0]
    i64 = lambda a: torch.tensor(np.asarray(a, np.int64), device=dev)
    false = torch.zeros((Kp,), dtype=torch.bool, device=dev)
    return MultiSMOState(
        alpha=alpha, gamma=gamma, active=active,
        beta_up=torch.full((Kp,), -1.0, device=dev),
        beta_low=torch.full((Kp,), 1.0, device=dev),
        i_up=torch.zeros((Kp,), dtype=torch.int64, device=dev),
        i_low=torch.zeros((Kp,), dtype=torch.int64, device=dev),
        step=i64(step), next_shrink=i64(next_shrink),
        n_shrinks=i64(n_shrinks), converged=false, stalled=false.clone(),
        live=torch.tensor(np.asarray(live, bool), device=dev))


def lane_k_ul(row1, x_up, x_low, lanes, inv_2s2):
    """(K,) K(x_up, x_low) per problem, each lane the single runner's
    O(d) call on its own rows (a batched reduction would sum in another
    order); 0 on lanes not issued."""
    out = [None] * x_up.shape[0]
    for i in lanes:
        xu, xl = x_up[i], x_low[i]
        out[i] = row1(xl[None], torch.sum(xl * xl)[None], xu, inv_2s2)[0]
    return _stack(out, x_up.new_zeros(()))


def lane_kself(kernel: str, kself, Z, lanes, inv_2s2):
    """(K, n) K(z, z) of each problem's (n, d) query rows ``Z`` (K, n, d),
    each lane computed on its own block as the single runner does (RBF:
    identically 1)."""
    if kernel == "rbf":
        return torch.ones(Z.shape[:2], dtype=Z.dtype, device=Z.device)
    zero = Z.new_zeros(Z.shape[1:2])
    return _stack([kself(Z[i], inv_2s2) if i in lanes else zero
                   for i in range(Z.shape[0])], zero)


def _stack(rows: list, fill: torch.Tensor) -> torch.Tensor:
    """Stack per-problem tensors; lanes not issued (None) take ``fill``."""
    return torch.stack([fill if r is None else r for r in rows])


def lane_update(a_up, a_low, y_up, y_low, g_up, g_low, k_ul, k_uu, k_ll, Cv,
                run, stalled):
    """The pair update of every lane (Eq. 11/12), gated by ``run``:
    returns (new_up, new_low, coef2 (K, 2), stalled)."""
    u, l = smo.pair_update_multi(a_up, a_low, y_up, y_low, g_up, g_low, k_ul,
                                 k_uu, k_ll, Cv)
    new_up = torch.where(run, u, a_up)
    new_low = torch.where(run, l, a_low)
    d_up, d_low = new_up - a_up, new_low - a_low
    stalled = stalled | (run & (torch.abs(d_up) < smo._TAU)
                         & (torch.abs(d_low) < smo._TAU))
    coef2 = torch.stack([y_up * d_up, y_low * d_low], 1)   # zero unless run
    return new_up, new_low, coef2, stalled


def take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(K,) entries t[k, idx[k]] of a (K, M) tensor."""
    return t.gather(1, idx[:, None])[:, 0]


class Sel(NamedTuple):
    """Every problem's elected pair (Eq. 8): the (K,) bounds, the rows'
    indices in this buffer (shard), their alphas, labels and dense rows,
    and the ranks that own them (None on one device)."""
    b_up: torch.Tensor
    b_low: torch.Tensor
    j_up: torch.Tensor
    j_low: torch.Tensor
    a_up: torch.Tensor
    y_up: torch.Tensor
    a_low: torch.Tensor
    y_low: torch.Tensor
    x_up: torch.Tensor         # (K, d)
    x_low: torch.Tensor        # (K, d)
    own_up: "torch.Tensor | None"
    own_low: "torch.Tensor | None"


class LocalExchange:
    """The batched runner's one-device hooks: selection over the whole
    buffer, plain alpha writes, counts as they are.
    ``core.parallel.GroupExchange`` is their process-group twin."""

    def select(self, data, ystk, gamma, alpha, active, thr0, thr1) -> Sel:
        b_up, j_up, b_low, j_low = smo.select_pair_multi(
            gamma, alpha, ystk, active, thr0, thr1)
        return Sel(b_up, b_low, j_up, j_low, take(alpha, j_up),
                   take(ystk, j_up), take(alpha, j_low), take(ystk, j_low),
                   data.dense_rows(j_up), data.dense_rows(j_low), None, None)

    def write(self, alpha, kk, j, owner, v):
        """alpha[k, j[k]] = v[k] for k in ``kk`` (every problem), in
        place."""
        alpha.index_put_((kk, j), v)

    def count(self, t: torch.Tensor) -> torch.Tensor:
        """A count over the buffer, from this buffer's (shard's) count."""
        return t


def make_multi_runner(kernel: str, inv_2s2: float, shrink_interval: int,
                      selection: str = "wss1", fmt: str = "dense",
                      cache_slots: int = 0, cache_policy: str = "lru",
                      exchange: "LocalExchange | None" = None):
    """Build the batched fused-epoch runner::

        state, cache, summary = run_epoch(data, ystk, state, cache, thr0,
                                          thr1, Cv, tol, k, chunk_iters,
                                          max_iters, compact_lt, mper_lo,
                                          lanes)

    ``ystk`` is the (K, M) label stack, ``thr0`` / ``thr1`` / ``Cv`` the
    (K,) box constants (``smo.box_thresholds``) and ``tol`` the (K,)
    tolerances, all f32 tensors on the buffer's device; ``lanes`` lists the
    problems that are still live on the host (the runner issues launches
    for those only: a retired lane's state and the cache stay as they
    are). ``summary`` is a (5K + 6,) int64 tensor
    (:meth:`MultiEpochSummary.from_tensor`).

    Each joint iteration runs every issued lane's single-runner iteration,
    gated by its ``run`` flag: live, not converged, not stalled and inside
    its segment limit. A segment's limit is per lane, ``min(chunk_iters,
    max(1, max_iters - step))``; the epoch's segments stop when every lane
    is done or the union compaction predicate fires (``need_compact``:
    the rows active for at least one live problem fit a smaller pow2
    buffer and number fewer than ``compact_lt``; ``compact_lt`` 0 turns it
    off).

    ``exchange`` supplies selection, alpha writes and counts
    (:class:`LocalExchange` by default); ``core.parallel`` passes its
    process-group twin, under which ``data``, ``ystk`` and the state's
    (K, M) arrays are this rank's shard.
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
    wss2 = selection == "wss2"
    ex = exchange if exchange is not None else LocalExchange()

    def run_epoch(data, ystk: torch.Tensor, state: MultiSMOState, cache,
                  thr0, thr1, Cv, tol, k: int, chunk_iters: int,
                  max_iters: int, compact_lt: int, mper_lo: int,
                  lanes):
        dev = ystk.device
        Kp, m = ystk.shape
        lanes = [int(i) for i in lanes]
        kdiag = provider.diag(data) if wss2 else None
        get_row1, get_rows2 = rowcache.make_accessors(provider, data, cached,
                                                      cache_policy)
        zero_row = torch.zeros((m,), device=dev)
        kk = torch.arange(Kp, device=dev)

        def gids(idx):    # the cache's tags of buffer rows idx
            return data.gids.index_select(0, idx.reshape(-1)) \
                .view(idx.shape) if cached else None

        def select(gamma, alpha, active):
            return ex.select(data, ystk, gamma, alpha, active, thr0, thr1)

        def body(s: MultiSMOState, sel: Sel, c, run: torch.Tensor):
            iu, x_up = sel.j_up, sel.x_up
            if wss2:
                g_up = gids(iu[:, None])
                k_uu = lane_kself(kernel, kself, x_up[:, None], lanes,
                                  inv_2s2)[:, 0]
                ru = [None] * Kp
                for i in lanes:
                    ru[i], c = get_row1(c, None if g_up is None else g_up[i],
                                        x_up[i], run[i])
                row_up = _stack(ru, zero_row)
                scores = smo.wss2_scores_multi(
                    s.gamma, s.alpha, ystk, s.active, thr0, thr1, s.beta_up,
                    row_up, kdiag, k_uu)
                il = torch.argmax(scores, 1)
                g_low = take(s.gamma, il)
                # the update prices the pair with the value it was scored by
                k_ul = take(row_up, il)
                x_low = data.dense_rows(il)
                a_low, y_low, own_low = take(s.alpha, il), take(ystk, il), None
            else:
                il, x_low = sel.j_low, sel.x_low
                g_low = s.beta_low
                k_ul = lane_k_ul(row1, x_up, x_low, lanes, inv_2s2)
                a_low, y_low, own_low = sel.a_low, sel.y_low, sel.own_low
            Z2 = torch.stack([x_up, x_low], 1)                # (K, 2, d)
            ks = lane_kself(kernel, kself, Z2, lanes, inv_2s2)
            new_up, new_low, coef2, stalled = lane_update(
                sel.a_up, a_low, sel.y_up, y_low, s.beta_up, g_low, k_ul,
                ks[:, 0], ks[:, 1], Cv, run, s.stalled)
            alpha = s.alpha
            ex.write(alpha, kk, iu, sel.own_up, new_up)
            ex.write(alpha, kk, il, own_low, new_low)
            if wss2:
                g_low_id = gids(il[:, None])
                rl = [None] * Kp
                for i in lanes:
                    rl[i], c = get_row1(
                        c, None if g_low_id is None else g_low_id[i],
                        x_low[i], run[i])
                row_low = _stack(rl, zero_row)
                gamma = (s.gamma + coef2[:, :1] * row_up
                         + coef2[:, 1:] * row_low)
            else:
                g2 = gids(torch.stack([iu, il], 1))
                gn = [None] * Kp
                for i in lanes:
                    if cached:
                        rows, c = get_rows2(c, g2[i], Z2[i], run[i])
                        gn[i] = ops.gamma_from_rows(s.gamma[i], rows,
                                                    coef2[i])
                    else:
                        gn[i] = provider.gamma_update(data, s.gamma[i], Z2[i],
                                                      coef2[i])
                gamma = torch.stack([s.gamma[i] if g is None else g
                                     for i, g in enumerate(gn)])
            gamma = torch.where(run[:, None], gamma, s.gamma)

            step1 = s.step + run
            active, next_shrink, n_shrinks = (s.active, s.next_shrink,
                                              s.n_shrinks)
            if shrink_interval > 0:
                do_shrink = run & (step1 >= s.next_shrink)
                active = torch.where(
                    do_shrink[:, None], smo.shrink_rule_multi(
                        gamma, alpha, ystk, s.active, s.beta_up, s.beta_low,
                        thr0, thr1), s.active)
                # Alg. 4 line 12, K lanes in one count
                interval = torch.clamp(
                    torch.clamp(ex.count(active.sum(1)),
                                max=shrink_interval), min=1)
                next_shrink = torch.where(do_shrink, step1 + interval,
                                          s.next_shrink)
                n_shrinks = s.n_shrinks + do_shrink
            # a lane with run False keeps its state, so its selection
            # reproduces its current pair: no masking needed
            sel = select(gamma, alpha, active)
            return MultiSMOState(alpha, gamma, active, sel.b_up, sel.b_low,
                                 sel.j_up, sel.j_low, step1, next_shrink,
                                 n_shrinks, sel.b_up + tol >= sel.b_low,
                                 stalled, s.live), sel, c

        def run_segment(s: MultiSMOState, c, seg_live, jiters):
            # segment entry: (re)establish selection and convergence, clear
            # the stall latches (masked once the epoch is done)
            sel = select(s.gamma, s.alpha, s.active)
            s = s.replace(
                beta_up=torch.where(seg_live, sel.b_up, s.beta_up),
                beta_low=torch.where(seg_live, sel.b_low, s.beta_low),
                i_up=torch.where(seg_live, sel.j_up, s.i_up),
                i_low=torch.where(seg_live, sel.j_low, s.i_low),
                converged=torch.where(seg_live, sel.b_up + tol >= sel.b_low,
                                      s.converged),
                stalled=s.stalled & ~seg_live)
            end = s.step + torch.clamp(
                torch.clamp(max_iters - s.step, min=1), max=chunk_iters)
            for _ in range(chunk_iters):
                run = (s.live & seg_live & ~s.converged & ~s.stalled
                       & (s.step < end))
                s, sel, c = body(s, sel, c, run)
                jiters = jiters + run.any()
            return s, c, jiters

        def union(s):     # rows active for at least one live problem
            return ex.count(torch.any(s.active & s.live[:, None], 0).sum())

        s, c = state, cache
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        segs, jiters = zero, zero
        need_c = torch.zeros((), dtype=torch.bool, device=dev)
        done = need_c
        for _ in range(max(1, int(k))):
            seg_live = ~done
            s, c, jiters = run_segment(s, c, seg_live, jiters)
            hard = ~torch.any(s.live & ~s.converged & ~s.stalled
                              & (s.step < max_iters))
            if shrink_interval > 0 and compact_lt > 0:
                n_union = union(s)
                nc = ~hard & (n_union < compact_lt) & (
                    util.bucket_pow2_device(n_union, mper_lo) < m)
            else:
                nc = torch.zeros((), dtype=torch.bool, device=dev)
            need_c = torch.where(seg_live, nc, need_c)
            segs = segs + seg_live
            done = done | hard | nc
        hits, misses = (c.hits, c.misses) if cached else (zero, zero)
        summary = torch.cat([
            s.step, ex.count(s.active.sum(1)), s.n_shrinks,
            s.converged.to(torch.int64), s.stalled.to(torch.int64),
            torch.stack([segs, jiters, union(s), need_c.to(torch.int64),
                         hits, misses])])
        return s, c, summary

    return run_epoch


def ovr_tasks(y):
    """One-vs-rest tasks: multi-class labels -> (classes, (K, n) +-1 label
    matrix), one binary problem per class in sorted class order."""
    y = np.asarray(y)
    classes = np.unique(y)
    Y = np.where(y[None, :] == classes[:, None], 1.0, -1.0).astype(np.float32)
    return classes, Y


@dataclasses.dataclass
class OvRSVMModel:
    """One-vs-rest multi-class model: K binary models and argmax voting.

    ``predict`` scores through ONE union serving engine (``_union``): the
    union of the models' support vectors with a (n_sv, K) coefficient
    table (0 where a row is not an SV of problem k), so a query bucket is
    one engine call for all K problems (``core.serve.ServeEngine``'s
    multi-coef path). ``decision_matrix_host`` is the per-model oracle."""
    classes: np.ndarray
    models: list
    stats: driver.FitStats
    _union: "SVMModel | None" = None

    def union_engine(self, **kw):
        if self._union is None:
            raise ValueError("model was built without a union SV set")
        return self._union.serve_engine(**kw)

    def decision_matrix(self, Z) -> np.ndarray:
        """(B, K) decision scores, one column per class."""
        if self._union is not None:
            return self.union_engine().decision_function(Z)
        return self.decision_matrix_host(Z)

    def decision_matrix_host(self, Z) -> np.ndarray:
        """The per-model scoring oracle: each model's host block loop
        (``SVMModel.decision_function_host``), column by column."""
        return np.stack([m.decision_function_host(Z) for m in self.models],
                        axis=1)

    def predict(self, Z) -> np.ndarray:
        return self.classes[np.argmax(self.decision_matrix(Z), axis=1)]


class MultiProblemDriver:
    """K binary SMO problems over one resident buffer.

    ``backend='batched'`` runs :func:`make_multi_runner` (or, with
    ``parallel=True``, ``core.parallel.make_parallel_multi_runner`` on the
    process group ``group``); ``backend='loop'`` trains the K problems one
    after another through :class:`SMOSolver` — the parity oracle.

    Each problem lane follows the port's ``driver.EpochDriver.fit``: the
    shrink phase at 20*eps, then at every phase end either a
    reconstruction (Alg. 6 of every sample, Eq. 9 on its fp64 gamma) or,
    where none is due, an Eq. 9 recheck on recomputed gamma; a refuted
    lane un-shrinks (Single: shrinking off through the ``_INT32_MAX``
    sentinel; Multi: the counter re-armed) and optimises on, a refuted
    2*eps phase with its tolerance cut to 0.1% below 2*eps; a confirmed or
    spent lane retires. Buffer rebuilds (un-shrink, union compaction) come
    from the (K, n) host masters.

    All problems share the kernel, ``sigma2``, format and selection;
    ``C`` may differ per problem. :meth:`fit_grid` splits a (C, sigma2)
    grid into one batch per sigma2.
    """

    def __init__(self, config: SVMConfig, backend: str = "batched",
                 parallel: bool = False, group=None):
        if backend not in ("batched", "loop"):
            raise ValueError(f"unknown multi backend {backend!r} "
                             "(want 'batched' or 'loop')")
        self.cfg = config
        self.backend = backend
        self.h = H.get(config.heuristic)
        self.device = devmod.resolve(config.device)
        self.parallel = bool(parallel)
        self.group = group
        if self.parallel:
            if backend != "batched":
                raise ValueError("parallel=True requires backend='batched'")
            if config.selection != "wss1":
                raise NotImplementedError(
                    "parallel batched training is wss1-only")
            if config.row_cache:
                raise NotImplementedError(
                    "parallel batched training runs with the row cache off")
            from repro_torch.launch import dist
            if not dist.initialized():
                raise RuntimeError(
                    "MultiProblemDriver(parallel=True) needs a process "
                    "group: call repro_torch.launch.dist.init() in every "
                    "rank first")
            self.p, self.rank = dist.world(group), dist.rank(group)
            if self.device.type == "cuda" and self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
        else:
            self.p, self.rank = 1, 0

    # -- public entry points ----------------------------------------------
    def fit_tasks(self, X, Y: np.ndarray, C=None) -> list:
        """Train K binary problems on shared data: ``Y`` is (K, n) in
        {-1, +1}, ``C`` a scalar or (K,) per-problem box. Returns K
        :class:`SVMModel`s (the aggregate stats attached to each)."""
        Y = np.ascontiguousarray(Y, np.float32)
        if Y.ndim != 2:
            raise ValueError(f"Y must be (K, n), got shape {Y.shape}")
        Kp = Y.shape[0]
        Cs = np.full((Kp,), self.cfg.C, np.float64) if C is None \
            else np.broadcast_to(np.asarray(C, np.float64), (Kp,)).copy()
        if self.backend == "loop":
            return self._fit_loop(X, Y, Cs)
        return self._fit_batched(X, Y, Cs)

    def fit_ovr(self, X, y: np.ndarray) -> OvRSVMModel:
        """One-vs-rest fit: K = n_classes problems over one resident
        buffer, argmax voting through the union serving engine."""
        classes, Y = ovr_tasks(y)
        models = self.fit_tasks(X, Y)
        return OvRSVMModel(classes, models, models[0].stats,
                           _union_model(models))

    def fit_grid(self, X, y: np.ndarray, Cs, sigma2s=None) -> list:
        """Hyperparameter sweep, one problem per grid point. The points
        that share a sigma2 train as ONE batched fit (C per problem);
        distinct sigma2 values train as separate batches. Returns the
        models in grid order."""
        y = np.ascontiguousarray(y, np.float32)
        Cs = np.asarray(Cs, np.float64).reshape(-1)
        if sigma2s is None:
            return self.fit_tasks(X, np.broadcast_to(y, (Cs.size, y.size)),
                                  C=Cs)
        sigma2s = np.asarray(sigma2s, np.float64).reshape(-1)
        if sigma2s.size != Cs.size:
            raise ValueError("Cs and sigma2s must align")
        out: list = [None] * Cs.size
        for s2 in np.unique(sigma2s):
            sel = np.flatnonzero(sigma2s == s2)
            cfg = dataclasses.replace(self.cfg, sigma2=float(s2))
            if cfg.checkpoint_dir:      # one checkpoint a batch
                cfg = dataclasses.replace(cfg, checkpoint_dir=os.path.join(
                    cfg.checkpoint_dir, f"sigma2_{float(s2)!r}"))
            drv = MultiProblemDriver(cfg, backend=self.backend,
                                     parallel=self.parallel,
                                     group=self.group)
            ms = drv.fit_tasks(X, np.broadcast_to(y, (sel.size, y.size)),
                               C=Cs[sel])
            for j, k in enumerate(sel):
                out[k] = ms[j]
        return out

    # -- loop oracle -------------------------------------------------------
    def _fit_loop(self, X, Y, Cs) -> list:
        models = []
        for k in range(Y.shape[0]):
            ck = dataclasses.replace(self.cfg, C=float(Cs[k]))
            if ck.checkpoint_dir:       # one step-dir tree a problem
                ck = dataclasses.replace(
                    ck, checkpoint_dir=os.path.join(ck.checkpoint_dir,
                                                    f"p{k}"))
            models.append(SMOSolver(ck).fit(X, Y[k]))
        _aggregate_loop_stats(models)
        return models

    # -- placement (one device, or this rank's block of the buffer) ------
    def _put(self, a: np.ndarray, axis: int = 0) -> torch.Tensor:
        if self.p > 1:
            m = a.shape[axis] // self.p
            a = np.take(a, np.arange(self.rank * m, (self.rank + 1) * m),
                        axis=axis)
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def _gather(self, t: torch.Tensor) -> np.ndarray:
        """The whole (K, m) buffer stack of a (K, m_per) shard, on the
        host."""
        if self.p > 1:
            from repro_torch.launch import dist
            t = dist.all_gather_rows(t, 1, self.group)
        return t.cpu().numpy()

    # -- batched backend ---------------------------------------------------
    def _fit_batched(self, X, Y, Cs) -> list:
        cfg, h = self.cfg, self.h
        t0 = time.perf_counter()
        if spfmt.is_csr_like(X):
            X = spfmt.as_csr(X)
        else:
            X = np.ascontiguousarray(X, np.float32)
        store = self.store = dataplane.make_store(X, cfg.format, cfg.ell_K,
                                                  cfg.ell_lane)
        del X
        n, Kp = store.n, Y.shape[0]
        if Y.shape[1] != n:
            raise ValueError(f"Y has {Y.shape[1]} columns for {n} samples")
        if not set(np.unique(Y).tolist()) <= {-1.0, 1.0}:
            raise ValueError("labels must be +-1")
        self.Y, self.Cs = Y, Cs
        put = lambda a: torch.as_tensor(a, device=self.device)
        self._thr = tuple(put(a) for a in smo.box_thresholds(Cs))

        stats = self.stats = driver.FitStats(min_active=n, n_problems=Kp,
                                             mirror="host")
        interval = h.interval(n)
        shrink_on = h.policy != "none"
        # each lane's phase-end policy is the single driver's own
        phases = [driver.Phase(cfg, h.policy) for _ in range(Kp)]

        # (K, n) host masters and the per-problem control state
        self.alpha_m = np.zeros((Kp, n), np.float32)
        self.gamma_m = (-Y).astype(np.float32)
        self.act_m = np.ones((Kp, n), bool)
        live = np.ones((Kp,), bool)
        self._conv = np.zeros((Kp,), bool)
        self._stall = np.zeros((Kp,), bool)
        self._gap = np.zeros((Kp,), np.float64)
        steps = np.zeros((Kp,), np.int64)
        nshr = np.zeros((Kp,), np.int64)
        retired: list = [None] * Kp

        cache_slots = (rowcache.bucket_slots(cfg.row_cache_slots)
                       if cfg.row_cache else 0)
        if self.parallel:
            from repro_torch.core import parallel as par
            runner = par.make_parallel_multi_runner(
                cfg.kernel, cfg.inv_2s2, interval if shrink_on else 0,
                fmt=cfg.format, group=self.group)
        else:
            policy = cfg.row_cache_policy if cache_slots else "lru"
            runner = make_multi_runner(
                cfg.kernel, cfg.inv_2s2, interval if shrink_on else 0,
                selection=cfg.selection, fmt=cfg.format,
                cache_slots=cache_slots, cache_policy=policy)

        next_shrink = np.full((Kp,), interval if shrink_on else _INT32_MAX,
                              np.int64)
        rows = np.arange(n)
        self._saves = 0
        if cfg.resume and cfg.checkpoint_dir:
            got = self._load_ckpt(n, Kp)
            if got is not None:
                rows, next_shrink, steps, nshr, live = self._resume(
                    got, phases, interval)
                stats.resumed_from = int(steps.sum())
        self._build(rows, steps, next_shrink, nshr, live)
        self.cache = (rowcache.init_cache(cache_slots, self.data.m,
                                          self.device)
                      if cache_slots else None)
        self._note_buffer()

        miss_seen = 0
        fuse = max(1, int(cfg.fuse_iters))
        mper_lo = max(cfg.min_buffer, 8)
        epilogue = 12.0 if cfg.selection == "wss2" else 4.0
        t_train = t_recon = 0.0

        def retire(k):
            live[k] = False
            retired[k] = self._record(k, steps, nshr, phases[k])

        while live.any():
            tol_vec = np.array([ph.tol() for ph in phases], np.float32)
            # the sharded runner keeps the buffer whole (shrinking is
            # logical only there)
            compact_lt = (math.ceil(cfg.compact_ratio * self.data.m)
                          if shrink_on and not self.parallel else 0)
            lanes = np.flatnonzero(live)
            tc = time.perf_counter()
            chaos.on_dispatch(stats.dispatches)
            steps_before = steps.copy()
            self.state, self.cache, summ_d = runner(
                self.data, self.ystk, self.state, self.cache, *self._thr,
                put(tol_vec), fuse, cfg.chunk_iters, cfg.max_iters,
                compact_lt, mper_lo, lanes)
            summ = MultiEpochSummary.from_tensor(summ_d.cpu(), Kp)  # 1 sync
            dt = time.perf_counter() - tc
            t_train += dt
            stats.dispatches += 1
            stats.dispatch_times.append(dt)

            steps = summ.step.astype(np.int64)
            nshr = summ.n_shrinks.astype(np.int64)
            conv, stall = summ.converged, summ.stalled
            iters_done = int((steps - steps_before).sum())
            stats.joint_iters += summ.joint_iters
            stats.min_active = min(stats.min_active, summ.n_active_union)
            # model FLOPs, the reference's multi-problem rule: production
            # once per row physically produced (the cache's misses, else
            # two rows per issued lane and joint iteration), the O(M)
            # epilogue once per problem-iteration
            if self.cache is not None:
                rows_new = summ.cache_misses - miss_seen
                miss_seen = summ.cache_misses
            else:
                rows_new = 2 * lanes.size * summ.joint_iters
            m_all = float(self.data.m * self.p)
            prod = rows_new * self.data.flops_row_pass() * m_all
            epi = iters_done * epilogue * m_all
            stats.flops_production += prod
            stats.flops_epilogue += epi
            stats.flops_est += prod + epi

            budget = steps >= cfg.max_iters
            done = live & (conv | stall | budget)
            # ONE device -> master writeback per dispatch, of the live lanes
            # and BEFORE any reconstruction: a later one would put the
            # buffer's fp32-updated gamma back over the recomputed values
            # (a retired lane's masters already hold its final state)
            if done.any() or summ.need_compact:
                self._writeback(live)
            unshrink = []
            tr = time.perf_counter()
            for k in np.flatnonzero(done):
                self._stall[k] |= bool(stall[k])
                if phases[k].end(lambda: self._eq9_on_recomputed_gamma(k),
                                 float(tol_vec[k]), int(steps[k]),
                                 bool(budget[k]), bool(stall[k])):
                    retire(k)
                else:
                    unshrink.append(int(k))
            t_recon += time.perf_counter() - tr
            if not live.any():
                break

            if unshrink:
                # un-shrink: these lanes re-activate every sample, so the
                # buffer goes back to the full set; the other lanes keep
                # their masks and their shrink countdowns
                next_shrink = self.state.next_shrink.cpu().numpy().copy()
                for k in unshrink:
                    self.act_m[k] = True
                    next_shrink[k] = (steps[k] + interval
                                      if phases[k].shrink_on else _INT32_MAX)
                self._rebuild(np.arange(n), steps, next_shrink, nshr, live)
            elif summ.need_compact:
                # union compaction: every live shrinking lane takes the
                # single driver's compaction reset of its countdown
                next_shrink = self.state.next_shrink.cpu().numpy().copy()
                per_act = self.act_m.sum(axis=1)
                shrink_act = np.array([ph.shrink_on for ph in phases])
                next_shrink = np.where(
                    live & shrink_act,
                    steps + np.maximum(1, np.minimum(interval, per_act)),
                    next_shrink)
                keep = np.flatnonzero(self.act_m[live].any(axis=0))
                t_c = time.perf_counter()
                self._rebuild(keep, steps, next_shrink, nshr, live)
                stats.compactions += 1
                stats.compact_time += time.perf_counter() - t_c
            elif done.any():
                # no geometry change: retire the lanes on the device
                self.state = self.state.replace(
                    live=torch.tensor(live, device=self.device))
            if cfg.checkpoint_dir and stats.dispatches % max(
                    1, cfg.checkpoint_every) == 0:
                if not (unshrink or summ.need_compact):
                    # a rebuild reads the masters, so they are current
                    # after one; without one the live lanes are synced
                    # here (masters are only read right after a sync)
                    self._writeback(live)
                self._save_ckpt(steps, live, nshr, phases)

        stats.iterations = int(steps.sum())
        stats.reconstructions = sum(ph.recon_count for ph in phases)
        stats.eq9_rechecks = sum(ph.eq9_rechecks for ph in phases)
        stats.shrink_events = int(nshr.sum())
        stats.train_time = t_train
        stats.recon_time = t_recon
        stats.stalled = bool(self._stall.any())
        stats.converged = bool(self._conv.all())
        if self.cache is not None:
            stats.cache_hits = int(self.cache.hits)
            stats.cache_misses = int(self.cache.misses)
            looked = stats.cache_hits + stats.cache_misses
            stats.cache_hit_rate = (stats.cache_hits / looked
                                    if looked else 0.0)
        stats.per_problem = [r if r is not None else
                             self._record(k, steps, nshr, phases[k])
                             for k, r in enumerate(retired)]
        stats.total_time = time.perf_counter() - t0
        return self._finalize(stats)

    # -- batched internals -------------------------------------------------
    def _record(self, k, steps, nshr, phase) -> dict:
        return {"problem": int(k), "iterations": int(steps[k]),
                "converged": bool(self._conv[k]),
                "stalled": bool(self._stall[k]),
                "shrink_events": int(nshr[k]),
                "reconstructions": phase.recon_count,
                "eq9_rechecks": phase.eq9_rechecks,
                "n_sv": int(np.sum(self.alpha_m[k] > 0.0))}

    def _build(self, rows, steps, next_shrink, nshr, live):
        """Host store -> one shared buffer of ``rows`` (this rank's block
        of it under ``parallel``) and the stacked (K, M) state, from the
        masters."""
        cfg, store = self.cfg, self.store
        Kp, p = self.Y.shape[0], self.p
        m_per = mirror.full_m_per(rows.size, p, cfg.min_buffer)
        m = m_per * p
        K_buf = None
        if store.fmt == "ell":
            K_buf = (spfmt.bucket_lanes(store.buffer_K(rows), cfg.ell_lane,
                                        cap=store.K)
                     if cfg.ell_adaptive else store.K)
        buf = store.alloc(m, K_buf)
        sqb = np.zeros((m,), np.float32)
        idx_buf = np.full((m,), -1, np.int64)
        ystk = np.ones((Kp, m), np.float32)     # padding: y=+1, alpha=0 -> I1
        ab = np.zeros((Kp, m), np.float32)
        gb = np.full((Kp, m), np.inf, np.float32)   # never selected
        actb = np.zeros((Kp, m), bool)
        for sl, sub in dataplane.deal(rows, p, m_per):
            store.fill(buf, sl, sub)
            sqb[sl] = store.sq_rows(sub)
            idx_buf[sl] = sub
            ystk[:, sl] = self.Y[:, sub]
            ab[:, sl] = self.alpha_m[:, sub]
            gb[:, sl] = self.gamma_m[:, sub]
            actb[:, sl] = self.act_m[:, sub]
        self.data = store.to_device(buf, self._put, gids=idx_buf, sq=sqb)
        self.ystk = self._put(ystk, 1)
        self.idx = idx_buf
        self.state = init_multi_state(
            self._put(ab, 1), self._put(gb, 1), self._put(actb, 1), steps,
            next_shrink, nshr, live)

    def _rebuild(self, rows, steps, next_shrink, nshr, live):
        """Buffer rebuild (union compaction or un-shrink growth) from the
        masters, which the dispatch's writeback has already refreshed; the
        row cache carries across by global id (columns re-gathered on a
        compaction, emptied on growth; its rows are exact, so neither
        changes a trajectory). ``next_shrink`` is per lane: a lane's
        countdown is not moved by another lane's un-shrink."""
        idx_old = self.idx
        self._build(rows, steps, next_shrink, nshr, live)
        self.cache = rowcache.remap_cache(self.cache, idx_old, self.idx)
        self._note_buffer()

    # -- checkpoints -------------------------------------------------------
    # The (K, n) masters travel as ONE self-validating .npz (the
    # reference's format): the payload's content checksum and the config
    # fingerprint ride inside the file. A save is atomic (tmp +
    # os.replace) and first rotates the previous file to
    # multi_masters.prev.npz, so a resume always has one known-good
    # generation to fall back to. The reference checks only _CKPT_KEYS;
    # the port adds its own state as extra arrays (the buffer membership,
    # each lane's shrink anchor and phase state, C, sigma2 and the
    # heuristic), covered by a second checksum, so the file stays readable
    # by both.
    # On a process group rank 0 writes and every rank agrees on the
    # outcome; on resume rank 0 picks the generation.
    _CKPT_KEYS = ("alpha", "gamma", "active", "live", "converged",
                  "stalled", "recon_count", "shrink_act", "step",
                  "n_shrinks")
    _EXTRA_KEYS = ("in_buffer", "next_shrink", "tol2_cut", "recheck_step",
                   "eq9_rechecks", "final_gap", "C", "sigma2", "heuristic")

    def _ckpt_path(self) -> str:
        return os.path.join(self.cfg.checkpoint_dir, "multi_masters.npz")

    def _ckpt_prev_path(self) -> str:
        return os.path.join(self.cfg.checkpoint_dir,
                            "multi_masters.prev.npz")

    @staticmethod
    def _ckpt_checksum(payload: dict, keys: tuple) -> str:
        from repro_torch.ckpt import checkpoint as ck
        joined = "\n".join(f"{k}:{ck.array_sha(np.asarray(payload[k]))}"
                           for k in keys)
        return hashlib.sha256(joined.encode()).hexdigest()

    def _agree_max(self, v: int) -> int:
        """The largest ``v`` over the group's ranks (``v`` alone)."""
        if not self.parallel:
            return v
        from repro_torch.launch import dist
        return dist.max_int(v, self.group, self.device)

    def _from_writer(self, v: int) -> int:
        """Rank 0's ``v`` on every rank."""
        if not self.parallel:
            return v
        from repro_torch.launch import dist
        return dist.rank0_int(v, self.group, self.device)

    def _save_ckpt(self, steps, live, nshr, phases):
        from repro_torch.ckpt import checkpoint as ck
        chaos.on_save(self._saves)
        self._saves += 1
        lane = lambda f, dt: np.array([f(ph) for ph in phases], dt)
        in_buf = np.zeros((self.Y.shape[1],), np.int8)
        in_buf[self.idx[self.idx >= 0]] = 1
        payload = dict(
            alpha=self.alpha_m, gamma=self.gamma_m,
            active=self.act_m.astype(np.int8), live=live.astype(np.int8),
            converged=self._conv.astype(np.int8),
            stalled=self._stall.astype(np.int8),
            recon_count=lane(lambda ph: ph.recon_count, np.int64),
            shrink_act=lane(lambda ph: ph.shrink_on, np.int8),
            step=np.asarray(steps, np.int64),
            n_shrinks=np.asarray(nshr, np.int64))
        extra = dict(
            in_buffer=in_buf,
            next_shrink=self.state.next_shrink.cpu().numpy().astype(
                np.int64),
            tol2_cut=lane(lambda ph: ph.cut, np.int8),
            recheck_step=lane(lambda ph: ph.recheck_step, np.int64),
            eq9_rechecks=lane(lambda ph: ph.eq9_rechecks, np.int64),
            final_gap=self._gap.astype(np.float64),
            C=np.asarray(self.Cs, np.float64),
            sigma2=np.float64(self.cfg.sigma2),
            heuristic=np.str_(self.h.name))
        meta = dict(
            checksum=np.str_(self._ckpt_checksum(payload, self._CKPT_KEYS)),
            extra_checksum=np.str_(self._ckpt_checksum(extra,
                                                       self._EXTRA_KEYS)),
            format=np.str_(self.cfg.format))
        path, prev = self._ckpt_path(), self._ckpt_prev_path()

        def _write():
            os.makedirs(self.cfg.checkpoint_dir, exist_ok=True)
            tmp = path + ".tmp.npz"
            np.savez(tmp, **payload, **extra, **meta)
            if os.path.exists(path):
                os.replace(path, prev)
            os.replace(tmp, path)

        err = None
        if self.rank == 0:
            try:
                _, retries = ck.with_retries(
                    _write, attempts=max(1, self.cfg.ckpt_retries),
                    what=f"checkpoint save {path}")
                self.stats.ckpt_retries += retries
            except IOError as e:
                err = e
        if self._agree_max(int(err is not None)):
            raise err or IOError(f"checkpoint save {path} failed on rank 0")

    def _read_ckpt(self, path: str, n: int, Kp: int) -> dict:
        """Load and validate ONE generation. IOError: corrupt (the caller
        falls back); ValueError: a config mismatch (a caller error, never
        remapped)."""
        try:
            with np.load(path) as z:
                data = {k: np.array(z[k]) for k in z.files}
        except Exception as e:          # torn zip / short read / bad CRC
            raise IOError(f"unreadable checkpoint {path}: {e}") from e
        missing = [k for k in self._CKPT_KEYS if k not in data]
        if missing:
            raise IOError(f"checkpoint {path} is missing {missing}")
        if "checksum" in data and str(data["checksum"]) \
                != self._ckpt_checksum(data, self._CKPT_KEYS):
            raise IOError(f"checkpoint {path} content checksum mismatch")
        if "extra_checksum" in data and (
                any(k not in data for k in self._EXTRA_KEYS)
                or str(data["extra_checksum"])
                != self._ckpt_checksum(data, self._EXTRA_KEYS)):
            raise IOError(f"checkpoint {path} extra checksum mismatch")
        if data["alpha"].shape != (Kp, n):
            raise ValueError(
                f"checkpoint shape {data['alpha'].shape} does not match "
                f"the requested (K, n) = {(Kp, n)}")
        for key, want in (("format", self.cfg.format),
                          ("heuristic", self.h.name)):
            if key in data and str(data[key]) != want:
                raise ValueError(
                    f"checkpoint {path} was saved with {key}="
                    f"{str(data[key])!r} but this fit has {key}={want!r}")
        for key, want in (("C", np.asarray(self.Cs, np.float64)),
                          ("sigma2", np.float64(self.cfg.sigma2))):
            if key in data and not np.array_equal(data[key], want):
                raise ValueError(
                    f"checkpoint {path} was saved with {key}="
                    f"{data[key].tolist()} but this fit has {key}="
                    f"{want.tolist()}")
        return data

    def _load_ckpt(self, n: int, Kp: int):
        """Newest-first resume with a one-generation fallback: a torn or
        corrupt multi_masters.npz falls back to the rotated .prev one;
        when no generation is readable the fit starts fresh (with a
        warning). Rank 0 picks the generation on a process group."""
        paths = (self._ckpt_path(), self._ckpt_prev_path())
        pick, err, got = -1, None, None
        if self.rank == 0:
            tried = False
            for i, path in enumerate(paths):
                if not os.path.exists(path):
                    continue
                tried = True
                try:
                    got, pick = self._read_ckpt(path, n, Kp), i
                    break
                except IOError as e:
                    warnings.warn(f"skipping corrupt checkpoint: {e}")
                except ValueError as e:
                    err, pick = e, -2
                    break
            if tried and pick == -1:
                warnings.warn("no readable multi-problem checkpoint "
                              "generation; starting fresh")
        pick = self._from_writer(pick)
        if pick == -2:
            raise err or ValueError("the checkpoint's configuration "
                                    "differs from this fit's (see rank 0)")
        if pick < 0:
            return None
        if got is None:
            got = self._read_ckpt(paths[pick], n, Kp)
        self._agree_max(0)       # every rank has read it before any save
        return got

    def _resume(self, data: dict, phases: list, interval: int) -> tuple:
        """Restore the masters, the per-problem verdicts and each lane's
        phase from a checkpoint; returns (buffer rows, next_shrink, steps,
        n_shrinks, live). A reference file lacks the port's extra arrays:
        its buffer is the union of the live lanes' active rows and each
        shrinking lane's countdown restarts one interval on."""
        self.alpha_m = data["alpha"].astype(np.float32)
        self.gamma_m = data["gamma"].astype(np.float32)
        self.act_m = data["active"].astype(bool)
        live = data["live"].astype(bool)
        self._conv = data["converged"].astype(bool)
        self._stall = data["stalled"].astype(bool)
        steps = data["step"].astype(np.int64)
        nshr = data["n_shrinks"].astype(np.int64)
        ext = "in_buffer" in data
        if ext:
            self._gap = data["final_gap"].astype(np.float64)
        for k, ph in enumerate(phases):
            ph.load({"recon_count": int(data["recon_count"][k]),
                     "shrink_on": bool(data["shrink_act"][k]),
                     **({"tol2_cut": bool(data["tol2_cut"][k]),
                         "recheck_step": int(data["recheck_step"][k]),
                         "eq9_rechecks": int(data["eq9_rechecks"][k])}
                        if ext else {})})
        n = self.alpha_m.shape[1]
        shrink = np.array([ph.shrink_on for ph in phases])
        if ext:
            rows = np.flatnonzero(data["in_buffer"])
            next_shrink = data["next_shrink"].astype(np.int64)
        else:
            rows = (np.flatnonzero(self.act_m[live].any(axis=0))
                    if shrink.any() and live.any() else np.arange(n))
            next_shrink = np.where(shrink, steps + interval, _INT32_MAX)
        return rows, next_shrink, steps, nshr, live

    def _writeback(self, lanes: np.ndarray):
        """Buffer -> (K, n) masters for the problems ``lanes`` (a mask)."""
        pos = np.flatnonzero(self.idx >= 0)[None, :]
        cols = self.idx[pos]
        sel = np.flatnonzero(lanes)[:, None]
        for master, t in ((self.alpha_m, self.state.alpha),
                          (self.gamma_m, self.state.gamma),
                          (self.act_m, self.state.active)):
            master[sel, cols] = self._gather(t)[sel, pos]

    def _eq9_on_recomputed_gamma(self, k: int) -> bool:
        """Recompute every sample's gamma of problem k (Alg. 6, host
        streaming backend), round it once into the master, and test Eq. 9
        over all samples on its fp64 values — the single driver's verdict
        (``driver.EpochDriver._eq9_on_recomputed_gamma``)."""
        cfg, y = self.cfg, self.Y[k]
        g64 = reconstruct.reconstruct_gamma_store(
            cfg.kernel, self.store, y, self.alpha_m[k], np.arange(y.size),
            cfg.inv_2s2, self.device, row_block=cfg.recon_block,
            sv_block=cfg.recon_block, ell_adaptive=cfg.ell_adaptive)
        self.gamma_m[k] = g64
        b_up, b_low = driver.betas(g64, self.alpha_m[k], y,
                                   float(self.Cs[k]))
        self._gap[k] = b_low - b_up
        self._conv[k] = b_up + 2.0 * cfg.eps >= b_low
        return bool(self._conv[k])

    def _note_buffer(self):
        self.stats.buffer_sizes.append(self.data.m * self.p)
        if isinstance(self.data, dataplane.ELLData):
            self.stats.buffer_K.append(self.data.K)

    # -- finalize ----------------------------------------------------------
    def _finalize(self, stats) -> list:
        """Per-problem models, as ``SMOSolver.fit`` finalizes one."""
        cfg, store, Y, Cs = self.cfg, self.store, self.Y, self.Cs
        models = []
        for k in range(Y.shape[0]):
            alpha, gamma, Ck = self.alpha_m[k], self.gamma_m[k], float(Cs[k])
            b_up, b_low = driver.betas(gamma, alpha, Y[k], Ck)
            bnd = Ck * smo._BND
            i0 = (alpha > bnd) & (alpha < Ck - bnd)
            beta = (float(gamma[i0].mean()) if i0.any()
                    else float((b_low + b_up) / 2))
            sv = np.flatnonzero(alpha > 0)
            coef = (alpha[sv] * Y[k, sv]).astype(np.float32)
            rec = stats.per_problem[k]
            rec.update(final_gap=float(self._gap[k]), beta=beta,
                       n_bound_sv=int(np.sum(alpha >= Ck)))
            cfg_k = dataclasses.replace(cfg, C=Ck)
            if store.fmt == "ell":
                sv_vals, sv_cols = store.ell_rows(sv)
                models.append(SVMModel(cfg_k, None, coef, beta, alpha.copy(),
                                       stats, sv_vals=sv_vals,
                                       sv_cols=sv_cols,
                                       n_features=store.n_features))
            else:
                models.append(SVMModel(cfg_k, store.X[sv].copy(), coef, beta,
                                       alpha.copy(), stats))
        stats.n_sv = int(sum(r["n_sv"] for r in stats.per_problem))
        stats.n_bound_sv = int(sum(r["n_bound_sv"]
                                   for r in stats.per_problem))
        stats.final_gap = float(max(r["final_gap"]
                                    for r in stats.per_problem))
        return models


def _aggregate_loop_stats(models: list) -> None:
    """Fold the per-model stats of a loop fit into the batched backend's
    view, on the FIRST model's stats (which callers read as the run's)."""
    if not models:
        return
    agg = models[0].stats
    agg.n_problems = len(models)
    agg.per_problem = [
        {"problem": k, "iterations": m.stats.iterations,
         "converged": m.stats.converged, "stalled": m.stats.stalled,
         "shrink_events": m.stats.shrink_events,
         "reconstructions": m.stats.reconstructions,
         "eq9_rechecks": m.stats.eq9_rechecks,
         "n_sv": m.stats.n_sv, "final_gap": m.stats.final_gap,
         "beta": m.beta}
        for k, m in enumerate(models)]


def _union_model(models: list) -> "SVMModel | None":
    """The union SV set, a (n_sv_union, K) coefficient table and (K,)
    beta — the one-engine OvR serving model. Rows are keyed by global
    sample id (every model's ``alpha`` is the full (n,) vector); coef is 0
    where a row is not an SV of problem k, an exact pad."""
    if not models:
        return None
    Kp = len(models)
    n = models[0].alpha.shape[0]
    union = np.flatnonzero(
        np.any(np.stack([m.alpha > 0.0 for m in models]), axis=0))
    if union.size == 0:
        return None
    coef = np.zeros((union.size, Kp), np.float32)
    for k, mdl in enumerate(models):
        # y on the union rows from each model's own SV coef signs; rows
        # that are not SVs of problem k keep coef 0
        pos = np.flatnonzero(mdl.alpha > 0.0)
        yk = np.zeros((n,), np.float32)
        yk[pos] = np.sign(mdl.sv_coef)
        coef[:, k] = mdl.alpha[union] * yk[union]
    beta = np.asarray([m.beta for m in models], np.float32)
    m0 = models[0]
    if m0.sv_vals is not None:
        return _union_from_ell(models, union, coef, beta)
    sv_x = np.zeros((union.size, m0.sv_x.shape[1]), np.float32)
    for mdl in models:
        sv_x[np.searchsorted(union, np.flatnonzero(mdl.alpha > 0.0))] = \
            bf16.widen(mdl.sv_x)
    return SVMModel(m0.config, sv_x, coef, beta, m0.alpha, m0.stats)


def _union_from_ell(models: list, union, coef, beta) -> "SVMModel":
    """ELL union model: each model's SV rows scattered into the union
    layout at the largest lane budget among them."""
    m0 = models[0]
    Kl = max(1, max(int(m.sv_vals.shape[1]) if m.sv_vals.size else 0
                    for m in models))
    vals = np.zeros((union.size, Kl), np.float32)
    cols = np.zeros((union.size, Kl), np.int32)
    for mdl in models:
        sel = np.searchsorted(union, np.flatnonzero(mdl.alpha > 0.0))
        k = mdl.sv_vals.shape[1]
        vals[sel, :k] = bf16.widen(mdl.sv_vals)
        cols[sel, :k] = mdl.sv_cols
    return SVMModel(m0.config, None, coef, beta, m0.alpha, m0.stats,
                    sv_vals=vals, sv_cols=cols, n_features=m0.n_features)


def train_ovr(X, y, **kw) -> OvRSVMModel:
    """One-vs-rest training over one resident buffer: ``train_ovr(X, y,
    C=..., sigma2=..., device=...)``; ``backend`` (default 'batched')
    picks the batched program or the loop oracle."""
    backend = kw.pop("backend", "batched")
    return MultiProblemDriver(SVMConfig(**kw), backend=backend).fit_ovr(X, y)
