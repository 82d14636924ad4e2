"""Single-device SMO solver — public API and the epoch-driver hook surface
(twin of ``repro.core.solver``).

* :class:`SVMConfig` / :class:`SVMModel` — the configuration and the
  trained model (``predict`` / ``decision_function`` /
  ``decision_function_host`` / ``dual_objective`` / ``compact``);
* :class:`SMOSolver` — the hooks ``core.driver.EpochDriver`` calls (runner
  construction, device placement, Alg. 6 in both backends) and the model
  finalize (beta, support vectors; the Eq. 9 verdict over all samples is
  the driver's, taken on recomputed fp64 gamma).

``device`` (default ``"cuda"``) picks where training and scoring run; a
CUDA request without a card raises.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.core import driver, kernel_fns, reconstruct, smo
from repro_torch.core import heuristics as H
from repro_torch.core import mirror as mirror_mod
from repro_torch.core.driver import FitStats

__all__ = ["SVMConfig", "SVMModel", "SMOSolver", "FitStats", "train"]

# Fields of the reference config whose features later slices of the port
# bring; a value other than the default raises instead of being ignored.
_LATER = {
    "format": ("dense", "the ELL/CSR slice"),
    "ell_K": (None, "the ELL/CSR slice"),
    "ell_lane": (128, "the ELL/CSR slice"),
    "ell_adaptive": (True, "the ELL/CSR slice"),
    "row_cache": (False, "the row-cache slice"),
    "row_cache_slots": (64, "the row-cache slice"),
    "row_cache_policy": ("lru", "the row-cache slice"),
    "checkpoint_dir": (None, "the checkpoint/elastic slice"),
    "checkpoint_every": (1, "the checkpoint/elastic slice"),
    "resume": (False, "the checkpoint/elastic slice"),
    "ckpt_retries": (3, "the checkpoint/elastic slice"),
    "watchdog_threshold": (0.0, "the checkpoint/elastic slice"),
    "watchdog_window": (32, "the checkpoint/elastic slice"),
    "watchdog_warmup": (3, "the checkpoint/elastic slice"),
}


@dataclasses.dataclass
class SVMConfig:
    C: float = 1.0
    kernel: str = "rbf"
    sigma2: float = 1.0          # K = exp(-|x-z|^2 / (2 sigma^2))
    eps: float = 1e-3            # user tolerance (Eq. 9 uses 2*eps)
    heuristic: "str | H.ShrinkHeuristic" = "original"
    selection: str = "wss1"      # 'wss2': second-order pair selection
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
    # -- refused until their slice lands (see _LATER) --------------------
    format: str = "dense"
    ell_K: "int | None" = None
    ell_lane: int = 128
    ell_adaptive: bool = True
    row_cache: bool = False
    row_cache_slots: int = 64
    row_cache_policy: str = "lru"
    checkpoint_dir: "str | None" = None
    checkpoint_every: int = 1
    resume: bool = False
    ckpt_retries: int = 3
    watchdog_threshold: float = 0.0
    watchdog_window: int = 32
    watchdog_warmup: int = 3

    def __post_init__(self):
        for name, (default, where) in _LATER.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"SVMConfig({name}={getattr(self, name)!r}) is not in "
                    f"this port yet; it arrives with {where}")

    @property
    def inv_2s2(self) -> float:
        return 1.0 / (2.0 * self.sigma2)


@dataclasses.dataclass
class SVMModel:
    config: SVMConfig
    sv_x: np.ndarray             # (n_sv, d)
    sv_coef: np.ndarray          # (n_sv,)  alpha_i * y_i
    beta: float
    alpha: np.ndarray            # (N,) full multipliers (diagnostics)
    stats: FitStats

    def serve_engine(self, **kw):
        """The model's scoring engine (``core.serve.ServeEngine``), built
        lazily and cached per keyword spec."""
        from repro_torch.core import serve
        key = tuple(sorted(kw.items()))
        cache = self.__dict__.setdefault("_engines", {})
        if key not in cache:
            cache[key] = serve.ServeEngine(self, **kw)
        return cache[key]

    def decision_function(self, Z: np.ndarray) -> np.ndarray:
        """Decision scores through the serving engine (device-resident SVs,
        pow2 buckets, one ``rbf_accumulate`` launch per bucket on the
        card)."""
        return self.serve_engine().decision_function(Z)

    def decision_function_host(self, Z: np.ndarray,
                               block: int = 8192) -> np.ndarray:
        """Block-loop scoring oracle: forms K(z_block, SV) with plain
        PyTorch ops and contracts it with the coefficients in fp64 (the
        terms cancel; see ``kernels.ref.rbf_accumulate``), one fixed-size
        block at a time, on the model's device. The serve plane is tested
        against it."""
        dev = devmod.resolve(self.config.device)
        Z = np.asarray(Z, np.float32)
        svx = torch.as_tensor(np.asarray(self.sv_x, np.float32), device=dev)
        coef = torch.as_tensor(np.asarray(self.sv_coef, np.float64),
                               device=dev)
        provider = kernel_fns.make_provider(self.config.kernel, False,
                                            self.config.inv_2s2)
        from repro_torch.core.dataplane import DenseData
        data = DenseData(svx, torch.sum(svx * svx, dim=-1))
        out = np.empty((Z.shape[0],), np.float32)
        for s in range(0, Z.shape[0], block):
            zb = Z[s: s + block]
            take = zb.shape[0]
            if take < block:
                zb = np.pad(zb, ((0, block - take), (0, 0)))
            k = provider.matrix(data, torch.as_tensor(zb, device=dev))
            f = (k.double() @ coef).float() - smo.f32(self.beta)
            out[s: s + take] = f.cpu().numpy()[:take]
        return out

    def predict(self, Z: np.ndarray) -> np.ndarray:
        return np.where(self.decision_function(Z) >= 0.0, 1.0, -1.0)

    def compact(self, dedup: bool = True,
                dtype: "str | None" = None) -> "SVMModel":
        """Deployment-artifact shrink: drop zero-coef SVs and optionally
        merge bitwise-duplicate SV rows (coefs add — exact, their kernel
        rows are equal). fp32 only in this slice."""
        if dtype not in (None, "float32", "fp32", "f32"):
            raise NotImplementedError(
                f"SV storage dtype {dtype!r}: bf16 serving arrives with a "
                "later slice of the port (fp32 only)")
        coef = np.asarray(self.sv_coef, np.float32).copy()
        rows = np.ascontiguousarray(np.asarray(self.sv_x, np.float32))
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
        return SVMModel(self.config, rows[keep_rows], coef, self.beta,
                        self.alpha, self.stats)

    def dual_objective(self) -> float:
        """L_D (Eq. 1) over the support set."""
        dev = devmod.resolve(self.config.device)
        svx = torch.as_tensor(np.asarray(self.sv_x, np.float32), device=dev)
        K = kernel_fns.full_kernel_matrix(self.config.kernel, svx, svx,
                                          self.config.inv_2s2)
        K = K.cpu().numpy()
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
    def _runner(self, cfg: SVMConfig, interval: int):
        if interval not in self._runners:
            self._runners[interval] = smo.make_chunk_runner(
                cfg.kernel, cfg.C, cfg.inv_2s2, interval,
                selection=cfg.selection)
        return self._runners[interval]

    def _reconstruct(self, y, alpha, stale):
        """Alg. 6, host-streaming backend (``mirror='host'`` oracle)."""
        return reconstruct.reconstruct_gamma_store(
            self.cfg.kernel, self._store, y, alpha, stale, self.cfg.inv_2s2,
            self.device, row_block=self.cfg.recon_block,
            sv_block=self.cfg.recon_block)

    def _reconstruct_mirror(self, mir, alpha_d, gamma_d, sv_rows, stale):
        """Alg. 6 over the device mirror with the host oracle's block plan;
        returns the updated gamma master and the stale rows' fp64 gamma."""
        cfg = self.cfg
        provider = kernel_fns.make_provider(cfg.kernel, False, cfg.inv_2s2)
        sv_blk, nsb = reconstruct.plan_blocks(sv_rows.size, cfg.recon_block)
        row_blk, nrb = reconstruct.plan_blocks(stale.size, cfg.recon_block)
        sv_pos = mirror_mod.pad_pos(mir.pos_of[sv_rows], nsb * sv_blk)
        stale_pos = mirror_mod.pad_pos(mir.pos_of[stale], nrb * row_blk)
        return mirror_mod.reconstruct_device(
            provider, mir, alpha_d, gamma_d, self._put(sv_pos),
            self._put(stale_pos), sv_blk, row_blk, nsb, nrb)

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(arr), device=self.device)

    def _put_full(self, arr: np.ndarray) -> torch.Tensor:
        """Placement of the (n,) alpha/gamma device masters (a copy: the
        driver writes them in place)."""
        return torch.tensor(np.asarray(arr), device=self.device)

    # -- main -------------------------------------------------------------
    def fit(self, X, y: np.ndarray) -> SVMModel:
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
        return SVMModel(cfg, self._store.X[sv].copy(), coef, beta, alpha,
                        stats)


def train(X: np.ndarray, y: np.ndarray, **kw) -> SVMModel:
    """``train(X, y, C=..., sigma2=..., device=...)`` — the library entry
    point (``device`` defaults to ``"cuda"``)."""
    return SMOSolver(SVMConfig(**kw)).fit(X, y)
