"""Inference plane: batched, low-latency SVM scoring on one device (twin of
``repro.core.serve``; dense SVs, fp32).

A :class:`ServeEngine` holds a trained model's support vectors resident on
the device, pads every request to a power-of-two microbatch bucket
(``min_bucket..max_bucket``; large requests stream ``max_bucket`` chunks)
and scores each bucket with ONE ``provider.accumulate`` call —
f(Z) = K(Z, SV) @ (alpha*y) - beta, which on the card is one launch of the
hand-written ``rbf_accumulate`` kernel, never forming the (B, M) kernel
matrix. The SV set is padded to a multiple of 128 rows with coef-0 rows, an
exact pad. bf16 SV storage, CSR queries and sharding over several cards
are later slices of the port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.core import dataplane, kernel_fns, smo, util

__all__ = ["ServeEngine"]

_LANE = 128          # SV padding multiple


class ServeEngine:
    """Device-resident scoring engine for a trained ``SVMModel``.

    ``device`` defaults to the model's. Buckets are scored by the
    hand-written kernel on CUDA tensors, its plain version on CPU tensors.
    ``min_bucket`` / ``max_bucket`` clamp the pow2 query
    buckets, so at most log2(max/min)+1 bucket shapes exist.
    """

    def __init__(self, model, *, device: "str | None" = None,
                 min_bucket: int = 64, max_bucket: int = 4096, shards: int = 1,
                 dtype: "str | None" = None):
        if shards != 1:
            raise NotImplementedError(
                "sharded serving arrives with the port's multi-GPU slice")
        if dtype not in (None, "float32", "fp32", "f32"):
            raise NotImplementedError(
                f"SV storage dtype {dtype!r}: bf16 serving arrives with a "
                "later slice of the port (fp32 only)")
        if min_bucket <= 0 or max_bucket < min_bucket:
            raise ValueError(f"bad bucket range [{min_bucket}, {max_bucket}]")
        cfg = model.config
        self.device = devmod.resolve(cfg.device if device is None else device)
        self.min_bucket = int(min_bucket)
        self.max_bucket = int(max_bucket)
        self.beta = smo.f32(model.beta)
        self._provider = kernel_fns.make_provider(cfg.kernel, True,
                                                  cfg.inv_2s2)
        coef = np.asarray(model.sv_coef, np.float32).reshape(-1)
        sv = np.asarray(model.sv_x, np.float32)
        self.n_sv = int(coef.shape[0])
        self.n_features = int(sv.shape[1])
        self.m_pad = _LANE * max(1, -(-self.n_sv // _LANE))
        x_p = np.zeros((self.m_pad, self.n_features), np.float32)
        x_p[: self.n_sv] = sv
        coef_p = np.zeros((self.m_pad,), np.float32)
        coef_p[: self.n_sv] = coef
        put = lambda a: torch.as_tensor(a, device=self.device)
        self._data = dataplane.DenseData(put(x_p),
                                         put((x_p * x_p).sum(axis=1)))
        self._coef = put(coef_p)

    def _bucket_of(self, remaining: int) -> int:
        return util.bucket_pow2(min(remaining, self.max_bucket),
                                self.min_bucket, self.max_bucket)

    def score_bucket(self, zb: torch.Tensor) -> torch.Tensor:
        """Scores of one padded (b, d) query bucket already on the device —
        one ``accumulate`` call."""
        return self._provider.accumulate(self._data, zb, self._coef) \
            - self.beta

    def decision_function(self, Z) -> np.ndarray:
        """Scores for a dense (n, d) batch: chopped into pow2 buckets, one
        device call per bucket."""
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
            zb = np.zeros((b, d), np.float32)
            zb[:take] = Z[s: s + take]
            f = self.score_bucket(torch.as_tensor(zb, device=self.device))
            out[s: s + take] = f.cpu().numpy()[:take]
            s += take
        return out

    def predict(self, Z) -> np.ndarray:
        return np.where(self.decision_function(Z) >= 0.0, 1.0,
                        -1.0).astype(np.float32)
