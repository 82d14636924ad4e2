"""Single-device SMO solver — public API and the epoch-driver hook surface
(twin of ``repro.core.solver``).

* :class:`SVMConfig` / :class:`SVMModel` — the configuration and the
  trained model (``predict`` / ``decision_function`` /
  ``decision_function_host`` / ``dual_objective`` / ``compact``);
* :class:`SMOSolver` — the hooks ``core.driver.EpochDriver`` calls (runner
  construction, device placement, Alg. 6 in both backends, and the
  checkpoint hooks: who writes, barriers, agreed flags) and the model
  finalize (beta, support vectors in the store's native format — dense
  rows, or ELL rows at the SVs' own lane budget; the Eq. 9 verdict over
  all samples is the driver's, taken on recomputed fp64 gamma).

``device`` (default ``"cuda"``) picks where training and scoring run; a
CUDA request without a card raises.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.core import (bf16, dataplane, driver, kernel_fns,
                               reconstruct, rowcache, smo)
from repro_torch.core import heuristics as H
from repro_torch.core import mirror as mirror_mod
from repro_torch.core.driver import FitStats

__all__ = ["SVMConfig", "SVMModel", "SMOSolver", "FitStats", "train"]

@dataclasses.dataclass
class SVMConfig:
    C: float = 1.0
    kernel: str = "rbf"
    sigma2: float = 1.0          # K = exp(-|x-z|^2 / (2 sigma^2))
    eps: float = 1e-3            # user tolerance (Eq. 9 uses 2*eps)
    heuristic: "str | H.ShrinkHeuristic" = "original"
    selection: str = "wss1"      # 'wss2': second-order pair selection
    format: str = "dense"        # sample storage: 'dense' | 'ell' (block-ELL
                                 # sparse, paper Sec. 2.2; CSR input too)
    ell_K: "int | None" = None   # ELL nonzero budget per row; default = max
                                 # row nnz rounded up to ``ell_lane``
    ell_lane: int = 128          # the lane multiple K is rounded to
    ell_adaptive: bool = True    # recompute K from the surviving rows at
                                 # every buffer build / compaction
    compact_backend: str = "device"  # 'device' gather | 'host' rebuild
                                 # (the parity oracle)
    mirror: str = "auto"         # full-set device mirror: 'device' | 'host'
                                 # (streaming oracle) | 'auto' (device when
                                 # it fits the budget)
    mirror_budget_bytes: "int | None" = None
    recon_block: int = 8192      # Alg. 6 SV/query block edge
    max_iters: int = 4_000_000
    chunk_iters: int = 256       # SMO iterations per fused segment
    fuse_iters: int = 1          # segments per dispatch (1 = the oracle)
    compact_ratio: float = 0.55  # compact when active fraction < this
    min_buffer: int = 256
    recon_eps_factor: float = 20.0  # Alg. 5 line 7 first-reconstruction gate
    max_reconstructions: int = 64   # safety bound for Multi
    device: str = "cuda"
    row_cache: bool = False      # kernel-row cache in front of the row
                                 # providers (core/rowcache.py)
    row_cache_slots: int = 64    # its capacity in rows (bucketed to a power
                                 # of two)
    row_cache_policy: str = "lru"   # eviction: 'lru' | 'slru' (segmented,
                                 # scan-resistant)
    # -- fault tolerance (core/driver.py, ckpt/, launch/elastic.py) -------
    checkpoint_dir: "str | None" = None   # step dirs go here (None: off)
    checkpoint_every: int = 1    # save every N fused segments
    resume: bool = False         # restore the newest complete step first
    ckpt_retries: int = 3        # attempts per checkpoint write
    watchdog_threshold: float = 0.0  # >0: flag a dispatch slower than this
                                 # many times the running median, then save
                                 # at once and halve the segment budget
    watchdog_window: int = 32    # dispatches in the running median
    watchdog_warmup: int = 3     # dispatches before the watchdog arms

    @property
    def inv_2s2(self) -> float:
        return 1.0 / (2.0 * self.sigma2)


@dataclasses.dataclass
class SVMModel:
    config: SVMConfig
    sv_x: "np.ndarray | torch.Tensor | None"   # (n_sv, d); None when SVs
                                 # are stored ELL; bf16 storage is a host
                                 # torch.bfloat16 tensor (core.bf16)
    sv_coef: np.ndarray          # (n_sv,)  alpha_i * y_i
    beta: float
    alpha: np.ndarray            # (N,) full multipliers (diagnostics)
    stats: FitStats
    sv_vals: "np.ndarray | torch.Tensor | None" = None   # (n_sv, K) ELL
                                          # support vectors (f32 or bf16)
    sv_cols: "np.ndarray | None" = None   # (n_sv, K) int32
    n_features: "int | None" = None       # d (set for ELL models)

    def _sv_data(self, dev: torch.device):
        """The SVs as a device buffer in their storage format."""
        put = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a, dt),
                                            device=dev)
        if self.sv_vals is not None:
            vals = put(bf16.widen(self.sv_vals), np.float32)
            return dataplane.ELLData(vals, put(self.sv_cols, np.int32),
                                     torch.sum(vals * vals, dim=-1),
                                     int(self.n_features)), "ell"
        svx = put(bf16.widen(self.sv_x), np.float32)
        return dataplane.DenseData(svx, torch.sum(svx * svx, dim=-1)), \
            "dense"

    def _sv_dense(self) -> np.ndarray:
        """Support vectors as a dense (n_sv, d) block."""
        if self.sv_vals is None:
            return bf16.widen(self.sv_x)
        store = dataplane.ELLStore(bf16.widen(self.sv_vals), self.sv_cols,
                                   self.n_features)
        return store.dense_rows(np.arange(self.sv_vals.shape[0]))

    def serve_engine(self, **kw):
        """The model's scoring engine (``core.serve.ServeEngine``), built
        lazily and cached per keyword spec."""
        from repro_torch.core import serve
        key = tuple(sorted(kw.items()))
        cache = self.__dict__.setdefault("_engines", {})
        if key not in cache:
            cache[key] = serve.ServeEngine(self, **kw)
        return cache[key]

    def decision_function(self, Z) -> np.ndarray:
        """Decision scores through the serving engine (device-resident SVs,
        pow2 buckets, one accumulate launch per bucket on the card —
        ``rbf_accumulate`` or ``ell_rbf_accumulate``); dense (n, d) or
        CSR-like queries."""
        return self.serve_engine().decision_function(Z)

    def decision_function_host(self, Z, block: int = 8192) -> np.ndarray:
        """Block-loop scoring oracle: forms K(z_block, SV) with plain
        PyTorch ops (the SVs in their storage format) and contracts it with
        the coefficients in fp64 (the terms cancel; see
        ``kernels.ref.rbf_accumulate``), one fixed-size block at a time, on
        the model's device. Dense or CSR-like queries. The serve plane is
        tested against it."""
        from repro_torch.data import sparse as spfmt
        dev = devmod.resolve(self.config.device)
        if spfmt.is_csr_like(Z):
            Z = spfmt.as_csr(Z).to_dense()
        Z = np.asarray(Z, np.float32)
        coef = torch.as_tensor(np.asarray(self.sv_coef, np.float64),
                               device=dev)
        data, fmt = self._sv_data(dev)
        provider = kernel_fns.make_provider(self.config.kernel, fmt, False,
                                            self.config.inv_2s2)
        out = np.empty((Z.shape[0],), np.float32)
        for s in range(0, Z.shape[0], block):
            zb = torch.as_tensor(Z[s: s + block], device=dev)
            k = provider.matrix(data, zb)
            f = (k.double() @ coef).float() - smo.f32(self.beta)
            out[s: s + zb.shape[0]] = f.cpu().numpy()
        return out

    def predict(self, Z) -> np.ndarray:
        return np.where(self.decision_function(Z) >= 0.0, 1.0, -1.0)

    def compact(self, dedup: bool = True,
                dtype: "str | None" = None) -> "SVMModel":
        """Deployment-artifact shrink: drop zero-coef SVs and optionally
        merge bitwise-duplicate SV rows (coefs add — exact, their kernel
        rows are equal); ELL models compare (vals, cols) rows. ``dtype``
        stores the SV values as ``'float32'`` (``None``, as in the
        reference) or ``'bfloat16'`` (rounded to nearest even, the bits the
        reference stores: half the resident value bytes, and scores one
        storage rounding of the SVs away from fp32)."""
        store_dt = bf16.storage_dtype(dtype or "float32")
        coef = np.asarray(self.sv_coef, np.float32).copy()
        if self.sv_vals is not None:
            vals = bf16.widen(self.sv_vals)
            rows = np.ascontiguousarray(np.concatenate(
                [vals, np.asarray(self.sv_cols, np.int32).view(np.float32)],
                axis=1))
        else:
            rows = np.ascontiguousarray(bf16.widen(self.sv_x))
        if dedup and rows.shape[0]:
            view = rows.view(np.uint32).reshape(rows.shape[0], -1)
            _, first, inv = np.unique(view, axis=0, return_index=True,
                                      return_inverse=True)
            merged = np.zeros((first.size,), np.float32)
            np.add.at(merged, inv.reshape(-1), coef)
            keep_rows = np.sort(first)
            coef = merged[np.argsort(first, kind="stable")]
        else:
            keep_rows = np.arange(rows.shape[0])
        nz = coef != 0.0
        keep_rows, coef = keep_rows[nz], coef[nz]
        stored = ((lambda a: a) if store_dt == "float32" else bf16.round_bf16)
        if self.sv_vals is not None:
            return SVMModel(
                self.config, None, coef, self.beta, self.alpha, self.stats,
                sv_vals=stored(vals[keep_rows]),
                sv_cols=np.asarray(self.sv_cols, np.int32)[keep_rows],
                n_features=self.n_features)
        return SVMModel(self.config, stored(rows[keep_rows]), coef,
                        self.beta, self.alpha, self.stats)

    def dual_objective(self) -> float:
        """L_D (Eq. 1) over the support set."""
        dev = devmod.resolve(self.config.device)
        data, fmt = self._sv_data(dev)
        provider = kernel_fns.make_provider(self.config.kernel, fmt, False,
                                            self.config.inv_2s2)
        Z = torch.as_tensor(self._sv_dense(), device=dev)
        K = provider.matrix(data, Z).cpu().numpy()
        a = np.abs(self.sv_coef)           # alpha (coef = alpha*y)
        return float(a.sum() - 0.5 * self.sv_coef @ K @ self.sv_coef)


class SMOSolver:
    """Single-device SMO with adaptive shrinking, trained through
    :class:`repro_torch.core.driver.EpochDriver`."""

    def __init__(self, config: SVMConfig):
        self.cfg = config
        self.h = H.get(config.heuristic)
        self.device = devmod.resolve(config.device)
        self._runners: dict = {}

    # -- driver hooks -----------------------------------------------------
    def _nshards(self) -> int:
        """Shards a buffer is dealt over (one: this solver's one device)."""
        return 1

    def _gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The global array of a buffer tensor dealt over the shards along
        ``dim`` (on one device, the tensor itself)."""
        return t

    def _shard(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This shard's block of a global buffer tensor along ``dim`` (on
        one device, the tensor itself)."""
        return t

    def _cache_slots(self) -> int:
        """Row-cache capacity: 0 when disabled, else power-of-two
        bucketed, as the reference buckets it."""
        if not self.cfg.row_cache:
            return 0
        return rowcache.bucket_slots(self.cfg.row_cache_slots)

    def _new_cache(self, m: int):
        """An empty row cache for a buffer of ``m`` rows, or None (off)."""
        slots = self._cache_slots()
        if slots == 0:
            return None
        return rowcache.init_cache(slots, m, self.device)

    def _regrow_cache(self, cache, data, pairs: bool, n: int):
        """Rewarm the row cache across un-shrink growth
        (``rowcache.regrow_cache``) with the chunk runner's own provider,
        so warmed bits equal in-loop miss bits."""
        provider = kernel_fns.make_provider(self.cfg.kernel, self._store.fmt,
                                            True, self.cfg.inv_2s2)
        return rowcache.regrow_cache(cache, data, provider, pairs, n)

    def _runner(self, cfg: SVMConfig, interval: int):
        # the eviction policy is dead code in a cache-off runner: pinned in
        # the key, as the reference pins it
        slots = self._cache_slots()
        policy = cfg.row_cache_policy if slots else "lru"
        key = (interval, slots, policy)
        if key not in self._runners:
            self._runners[key] = smo.make_chunk_runner(
                cfg.kernel, cfg.C, cfg.inv_2s2, interval,
                selection=cfg.selection, fmt=cfg.format, cache_slots=slots,
                cache_policy=policy)
        return self._runners[key]

    def _reconstruct(self, y, alpha, stale):
        """Alg. 6, host-streaming backend (``mirror='host'`` oracle)."""
        return reconstruct.reconstruct_gamma_store(
            self.cfg.kernel, self._store, y, alpha, stale, self.cfg.inv_2s2,
            self.device, row_block=self.cfg.recon_block,
            sv_block=self.cfg.recon_block,
            ell_adaptive=self.cfg.ell_adaptive)

    def _reconstruct_mirror(self, mir, alpha_d, gamma_d, sv_rows, stale):
        """Alg. 6 over the device mirror with the host oracle's block plan
        (and, on ELL, its SV lane budget); returns the updated gamma master
        and the stale rows' fp64 gamma."""
        cfg, store = self.cfg, self._store
        provider = kernel_fns.make_provider(cfg.kernel, store.fmt, False,
                                            cfg.inv_2s2)
        K_sv = (reconstruct.sv_lane_budget(store, sv_rows, cfg.ell_adaptive)
                if store.fmt == "ell" else None)
        sv_blk, nsb = reconstruct.plan_blocks(sv_rows.size, cfg.recon_block)
        row_blk, nrb = reconstruct.plan_blocks(stale.size, cfg.recon_block)
        sv_pos = mirror_mod.pad_pos(mir.pos_of[sv_rows], nsb * sv_blk)
        stale_pos = mirror_mod.pad_pos(mir.pos_of[stale], nrb * row_blk)
        return mirror_mod.reconstruct_device(
            provider, mir, alpha_d, gamma_d, self._put(sv_pos),
            self._put(stale_pos), sv_blk, row_blk, nsb, nrb, K_sv)

    # -- checkpoint hooks (one process: the identity) --------------------
    def _is_writer(self) -> bool:
        """Whether this process writes the checkpoint files."""
        return True

    def _agree_max(self, v: int) -> int:
        """The largest ``v`` over the processes (also a barrier)."""
        return v

    def _from_writer(self, v: int) -> int:
        """The writer's ``v`` on every process."""
        return v

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        """Placement of a global buffer array (host layout of p shards):
        this device holds all of it."""
        return torch.as_tensor(np.ascontiguousarray(arr), device=self.device)

    def _put_full(self, arr: np.ndarray) -> torch.Tensor:
        """Placement of the (n,) alpha/gamma device masters (a copy: the
        driver writes them in place)."""
        return torch.tensor(np.asarray(arr), device=self.device)

    # -- main -------------------------------------------------------------
    def fit(self, X, y: np.ndarray) -> SVMModel:
        """Train on ``(X, y)``. ``X`` is a dense (n, d) matrix or, with
        ``format='ell'``, CSR input (``data.sparse.CSRMatrix``, a
        scipy-like csr object or a ``(data, indices, indptr, shape)``
        tuple), which never becomes a dense host matrix."""
        cfg = self.cfg
        alpha, gamma, y, stats = driver.EpochDriver(self).fit(X, y)
        b_up, b_low = driver.betas(gamma, alpha, y, cfg.C)
        bnd = cfg.C * smo._BND
        i0 = (alpha > bnd) & (alpha < cfg.C - bnd)
        beta = (float(gamma[i0].mean()) if i0.any()
                else float((b_low + b_up) / 2))
        sv = np.flatnonzero(alpha > 0)
        stats.n_sv = int(sv.size)
        stats.n_bound_sv = int(np.sum(alpha >= cfg.C))
        coef = (alpha[sv] * y[sv]).astype(np.float32)
        if self._store.fmt == "ell":
            # SVs at their own adaptive K (the lane-rounded max extent over
            # the support set): serving memory tracks the model, not the
            # ingest budget
            sv_vals, sv_cols = self._store.ell_rows(sv)
            return SVMModel(cfg, None, coef, beta, alpha, stats,
                            sv_vals=sv_vals, sv_cols=sv_cols,
                            n_features=self._store.n_features)
        return SVMModel(cfg, self._store.X[sv].copy(), coef, beta, alpha,
                        stats)


def train(X, y: np.ndarray, **kw) -> SVMModel:
    """``train(X, y, C=..., sigma2=..., device=...)`` — the library entry
    point (``device`` defaults to ``"cuda"``); ``X`` dense, or CSR with
    ``format='ell'``."""
    return SMOSolver(SVMConfig(**kw)).fit(X, y)
