"""Inference plane: batched, low-latency SVM scoring on one device (twin of
``repro.core.serve``; dense or block-ELL SVs, fp32).

A :class:`ServeEngine` holds a trained model's support vectors resident on
the device (dense rows, or ELL (vals, cols) rows at the model's own lane
budget), takes dense or CSR query batches, pads every request to a
power-of-two microbatch bucket (``min_bucket..max_bucket``; large requests
stream ``max_bucket`` chunks) and scores each bucket with ONE
``provider.accumulate`` call — f(Z) = K(Z, SV) @ (alpha*y) - beta, which
on the card is one launch of the hand-written ``rbf_accumulate`` or
``ell_rbf_accumulate`` kernel, never forming the (B, M) kernel matrix. CSR
queries are densified per bucket on the host (queries travel dense into
the kernels either way, so the ingest format never changes a score). The
SV set is padded to a multiple of 128 rows with coef-0 rows, and dense SV
rows and query buckets to a multiple of 4 features with zero columns (the
kernel then stages 16-byte rows); both pads are exact.
bf16 SV storage and sharding over several cards are later slices of the
port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.core import dataplane, kernel_fns, smo, util
from repro_torch.data import sparse as sp

__all__ = ["ServeEngine", "row_width"]

_LANE = 128          # SV padding multiple


def row_width(n_features: int) -> int:
    """Features a dense serving row holds on the device: ``n_features``
    rounded up to a multiple of 4 (zero columns, an exact pad)."""
    return 4 * max(1, -(-n_features // 4))


def _csr_dense_block(csr: "sp.CSRMatrix", lo: int, hi: int,
                     out: np.ndarray) -> None:
    """Densify CSR rows [lo, hi) into the zeroed prefix of ``out``."""
    base = int(csr.indptr[lo])
    idx = np.arange(base, int(csr.indptr[hi]))
    counts = np.diff(csr.indptr[lo: hi + 1]).astype(np.int64)
    rows = np.repeat(np.arange(hi - lo), counts)
    out[rows, csr.indices[idx]] = csr.data[idx]


class ServeEngine:
    """Device-resident scoring engine for a trained ``SVMModel``.

    ``device`` defaults to the model's. Buckets are scored by the
    hand-written kernel on CUDA tensors, its plain version on CPU tensors.
    ``min_bucket`` / ``max_bucket`` clamp the pow2 query
    buckets, so at most log2(max/min)+1 bucket shapes exist. ``shards=None``
    means every device (the card count on CUDA, 1 on the CPU); a count
    above 1 is refused until the multi-GPU slice.
    """

    def __init__(self, model, *, device: "str | None" = None,
                 min_bucket: int = 64, max_bucket: int = 4096,
                 shards: "int | None" = 1, dtype: "str | None" = None):
        cfg = model.config
        self.device = devmod.resolve(cfg.device if device is None else device)
        if shards is None:        # every device, as in the reference
            shards = (torch.cuda.device_count()
                      if self.device.type == "cuda" else 1)
        if shards != 1:
            raise NotImplementedError(
                f"shards={shards}: sharded serving arrives with the port's "
                "multi-GPU slice (ROADMAP queue 1, item 10)")
        if dtype not in (None, "float32", "fp32", "f32"):
            raise NotImplementedError(
                f"SV storage dtype {dtype!r}: bf16 serving arrives with a "
                "later slice of the port (fp32 only)")
        if min_bucket <= 0 or max_bucket < min_bucket:
            raise ValueError(f"bad bucket range [{min_bucket}, {max_bucket}]")
        self.min_bucket = int(min_bucket)
        self.max_bucket = int(max_bucket)
        self.beta = smo.f32(model.beta)
        self.fmt = "ell" if getattr(model, "sv_vals", None) is not None \
            else "dense"
        self._provider = kernel_fns.make_provider(cfg.kernel, self.fmt, True,
                                                  cfg.inv_2s2)
        coef = np.asarray(model.sv_coef, np.float32).reshape(-1)
        self.n_sv = int(coef.shape[0])
        self.m_pad = _LANE * max(1, -(-self.n_sv // _LANE))
        coef_p = np.zeros((self.m_pad,), np.float32)
        coef_p[: self.n_sv] = coef
        put = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                        device=self.device)
        if self.fmt == "dense":
            sv = np.asarray(model.sv_x, np.float32)
            self.n_features = int(sv.shape[1])
            self.width = row_width(self.n_features)
            self.K = 0
            x_p = np.zeros((self.m_pad, self.width), np.float32)
            x_p[: self.n_sv, : self.n_features] = sv
            self._data = dataplane.DenseData(put(x_p),
                                             put((x_p * x_p).sum(axis=1)))
        else:
            vals = np.asarray(model.sv_vals, np.float32)
            self.n_features = self.width = int(model.n_features)
            self.K = int(vals.shape[1])
            v_p = np.zeros((self.m_pad, self.K), np.float32)
            c_p = np.zeros((self.m_pad, self.K), np.int32)
            v_p[: self.n_sv] = vals
            c_p[: self.n_sv] = np.asarray(model.sv_cols, np.int32)
            self._data = dataplane.ELLData(put(v_p), put(c_p),
                                           put((v_p * v_p).sum(axis=1)),
                                           self.n_features)
        self._coef = put(coef_p)
        self._buckets: set = set()

    def _bucket_of(self, remaining: int) -> int:
        return util.bucket_pow2(min(remaining, self.max_bucket),
                                self.min_bucket, self.max_bucket)

    def score_bucket(self, zb: torch.Tensor) -> torch.Tensor:
        """Scores of one padded (b, width) query bucket already on the
        device — one ``accumulate`` call. ``width`` is the features the
        device rows hold (``n_features``; dense, ``row_width`` of it)."""
        if zb.ndim != 2 or zb.shape[1] != self.width:
            raise ValueError(f"bucket shape {tuple(zb.shape)}: needs "
                             f"(b, {self.width}) (the engine's width)")
        self._buckets.add(int(zb.shape[0]))
        return self._provider.accumulate(self._data, zb, self._coef) \
            - self.beta

    def decision_function(self, Z) -> np.ndarray:
        """Scores for a dense (n, d) batch or CSR-like queries (a
        ``data.sparse.CSRMatrix``, a scipy-like csr object or a
        ``(data, indices, indptr, shape)`` tuple): chopped into pow2
        buckets, CSR densified per bucket, one device call per bucket."""
        csr = sp.as_csr(Z) if sp.is_csr_like(Z) else None
        if csr is not None:
            n, d = csr.shape
        else:
            Z = np.asarray(Z, np.float32)
            if Z.ndim == 1:
                Z = Z[None, :]
            n, d = Z.shape
        if d != self.n_features:
            raise ValueError(f"query dim {d} != model dim {self.n_features}")
        out = np.empty((n,), np.float32)
        s = 0
        while s < n:
            b = self._bucket_of(n - s)
            take = min(n - s, b)
            zb = np.zeros((b, self.width), np.float32)
            if csr is not None:
                _csr_dense_block(csr, s, s + take, zb)
            else:
                zb[:take, :d] = Z[s: s + take]
            f = self.score_bucket(torch.as_tensor(zb, device=self.device))
            out[s: s + take] = f.cpu().numpy()[:take]
            s += take
        return out

    def predict(self, Z) -> np.ndarray:
        return np.where(self.decision_function(Z) >= 0.0, 1.0,
                        -1.0).astype(np.float32)

    def memory_bytes(self) -> int:
        """Resident SV bytes on the device (rows or (vals, cols), sq and
        coef)."""
        d = self._data
        arrays = (d.X,) if self.fmt == "dense" else (d.vals, d.cols)
        return int(sum(a.numel() * a.element_size()
                       for a in (*arrays, d.sq_norms, self._coef)))

    def describe(self) -> dict:
        return {"fmt": self.fmt, "dtype": "float32", "shards": 1,
                "n_sv": self.n_sv, "m_pad": self.m_pad, "K": self.K,
                "n_features": self.n_features, "device": str(self.device),
                "buckets": sorted(self._buckets),
                "memory_bytes": self.memory_bytes()}
