"""Inference plane: batched, low-latency SVM scoring on one device (twin of
``repro.core.serve``; dense or block-ELL SVs, stored in fp32 or bf16).

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

Sharded serving (``shards=p`` under a process group of p ranks, see
``launch.dist``): each rank holds a contiguous balanced block of the SVs,
padded on its own to whole chunks of 128 with coef-0 rows, scores every
bucket against its block, and the ranks all-reduce the partial sums in
fp64 before beta is subtracted once — the reference's psum over the mesh.
Every rank then calls ``decision_function`` with the same queries.

bf16 SV storage (``dtype='bfloat16'``, or a ``model.compact(dtype=
'bfloat16')`` artifact; ``core.bf16``): the SV values stay bf16 on the
device, half the value bytes; the squared norms are taken in fp32 from the
rounded values, as the reference takes them. On the card the accumulate
kernels load the bf16 values themselves and widen them exactly, so a bf16
engine's scores are bitwise those of an fp32 engine over the rounded SVs,
and one storage rounding of the SVs is all that separates them from the
fp32 model's. Other kernels than RBF score through the provider's
``matrix @ coef`` on widened values.

Multi-coef engines (the one-vs-rest union model of ``core.multi``): a
model whose ``beta`` is a (K,) array, or whose ``sv_coef`` is an
(n_sv, K) table, scores K problems over one resident SV set —
``decision_function`` returns (B, K). On the card each bucket launches the
accumulate kernel once per coefficient column (the reference's Pallas
path); a coef-0 row adds exactly 0, so column k scores problem k's SVs
alone. Sharded, the ranks all-reduce the (B, K) fp64 partials.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.core import bf16, dataplane, kernel_fns, smo, util
from repro_torch.data import sparse as sp
from repro_torch.launch import dist

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
    buckets, so at most log2(max/min)+1 bucket shapes exist. ``dtype`` is
    the SV values' storage, ``'float32'`` or ``'bfloat16'``; ``None``
    takes the model's own (see the module docstring). ``shards=1``
    (the default) holds every SV on this device, group or not; ``None``
    means the process group's size (1 without a group), and any count
    other than 1 must be that size: the SVs are then dealt over the
    group's ranks (see the module docstring).
    """

    def __init__(self, model, *, device: "str | None" = None,
                 min_bucket: int = 64, max_bucket: int = 4096,
                 shards: "int | None" = 1, dtype: "str | None" = None):
        cfg = model.config
        self.device = devmod.resolve(cfg.device if device is None else device)
        ranks = dist.world()
        if shards is None:        # every rank of the group
            shards, self._grouped = ranks, dist.initialized()
        else:
            self._grouped = shards > 1
        if shards not in (1, ranks):
            raise ValueError(
                f"shards={shards}, but the process group has {ranks} "
                "rank(s): sharded serving holds one SV block per rank "
                "(launch.dist.init)")
        self.shards = int(shards) if self._grouped else 1
        if min_bucket <= 0 or max_bucket < min_bucket:
            raise ValueError(f"bad bucket range [{min_bucket}, {max_bucket}]")
        self.min_bucket = int(min_bucket)
        self.max_bucket = int(max_bucket)
        # a (K,) beta or an (n_sv, K) coef table: the multi-coef engine
        beta = np.asarray(model.beta, np.float32).reshape(-1)
        coef = np.asarray(model.sv_coef, np.float32)
        self.multi = beta.size > 1 or coef.ndim == 2
        self.n_out = int(beta.size)
        self.beta = beta if self.multi else smo.f32(beta[0])
        self.fmt = "ell" if getattr(model, "sv_vals", None) is not None \
            else "dense"
        stored = model.sv_vals if self.fmt == "ell" else model.sv_x
        self.dtype = bf16.storage_dtype(dtype, stored)
        # the SV values as fp32, rounded to bf16 first for bf16 storage:
        # the norms are taken from the values the device holds
        store = bf16.widen(stored)
        if self.dtype == "bfloat16":
            store = bf16.widen(bf16.round_bf16(store))
        self._provider = kernel_fns.make_provider(cfg.kernel, self.fmt, True,
                                                  cfg.inv_2s2)
        coef = coef.reshape(coef.shape[0], -1) if self.multi \
            else coef.reshape(-1)
        if self.multi and coef.shape[1] != self.n_out:
            raise ValueError(f"coef table has {coef.shape[1]} columns for "
                             f"{self.n_out} betas")
        self.n_sv = int(coef.shape[0])
        # this rank's SV block (the deal of the SVs over the ranks)
        base, extra = divmod(self.n_sv, self.shards)
        r = dist.rank() if self._grouped else 0
        lo = r * base + min(r, extra)
        blk = slice(lo, lo + base + (1 if r < extra else 0))
        coef = coef[blk]
        n_blk = int(coef.shape[0])
        self.m_pad = _LANE * max(1, -(-n_blk // _LANE))
        coef_p = np.zeros((self.m_pad,) + coef.shape[1:], np.float32)
        coef_p[: n_blk] = coef
        if self.multi:      # one contiguous (m_pad,) row per column
            coef_p = coef_p.T
        put = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                        device=self.device)
        # SV values in their storage type (exact: they are bf16 values)
        put_sv = put if self.dtype == "float32" else \
            lambda a: bf16.round_bf16(a).to(self.device)
        if self.fmt == "dense":
            self.n_features = int(store.shape[1])
            self.width = row_width(self.n_features)
            self.K = 0
            x_p = np.zeros((self.m_pad, self.width), np.float32)
            x_p[: n_blk, : self.n_features] = store[blk]
            self._data = dataplane.DenseData(put_sv(x_p),
                                             put((x_p * x_p).sum(axis=1)))
        else:
            self.n_features = self.width = int(model.n_features)
            self.K = int(store.shape[1])
            v_p = np.zeros((self.m_pad, self.K), np.float32)
            c_p = np.zeros((self.m_pad, self.K), np.int32)
            v_p[: n_blk] = store[blk]
            c_p[: n_blk] = np.asarray(model.sv_cols, np.int32)[blk]
            self.nnz = int(np.count_nonzero(v_p))   # priced by roofline
            self._data = dataplane.ELLData(put_sv(v_p), put(c_p),
                                           put((v_p * v_p).sum(axis=1)),
                                           self.n_features)
        self._coef = put(coef_p)
        self._beta = put(self.beta) if self.multi else self.beta
        self._buckets: set = set()

    def _bucket_of(self, remaining: int) -> int:
        return util.bucket_pow2(min(remaining, self.max_bucket),
                                self.min_bucket, self.max_bucket)

    def score_bucket(self, zb: torch.Tensor) -> torch.Tensor:
        """Scores of one padded (b, width) query bucket already on the
        device — one ``accumulate`` call, (b,); on a multi-coef engine one
        call a column, (b, K). ``width`` is the features the device rows
        hold (``n_features``; dense, ``row_width`` of it)."""
        if zb.ndim != 2 or zb.shape[1] != self.width:
            raise ValueError(f"bucket shape {tuple(zb.shape)}: needs "
                             f"(b, {self.width}) (the engine's width)")
        self._buckets.add(int(zb.shape[0]))
        data = self._data
        if self.dtype == "bfloat16" and self._provider.kernel != "rbf":
            # matrix @ coef on the widened values (the accumulate kernels,
            # RBF only, widen bf16 themselves)
            data = (dataplane.DenseData(data.X.float(), data.sq_norms)
                    if self.fmt == "dense" else
                    dataplane.ELLData(data.vals.float(), data.cols,
                                      data.sq_norms, data.n_features))
        if self.multi:        # one accumulate launch per column: (b, K)
            f = torch.stack([self._provider.accumulate(data, zb, c)
                             for c in self._coef], 1)
        else:
            f = self._provider.accumulate(data, zb, self._coef)
        if self._grouped:     # the ranks' partial sums, added in fp64
            f = dist.all_reduce(f.double(), "sum").float()
        return f - self._beta

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
        out = np.empty((n, self.n_out) if self.multi else (n,), np.float32)
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
        if self.multi:
            raise ValueError(
                "a multi-coef engine scores K problems; vote at the model "
                "level (OvRSVMModel.predict takes the argmax of "
                "decision_function)")
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
        return {"fmt": self.fmt, "dtype": self.dtype, "shards": self.shards,
                "n_sv": self.n_sv, "n_out": self.n_out, "m_pad": self.m_pad,
                "K": self.K,
                "n_features": self.n_features, "device": str(self.device),
                "buckets": sorted(self._buckets),
                "memory_bytes": self.memory_bytes()}

    # -- pricing -----------------------------------------------------------

    def model_flops(self, b: int) -> float:
        """Model FLOPs of one bucket: a kernel-row pass over the padded SV
        set per query plus the coef FMA epilogue, over every shard — the
        reference's count, its padding (each of the ``shards`` blocks
        rounded up to whole chunks of 128 rows) included."""
        row_pass = (2.0 * self.n_features + 5.0 if self.fmt == "dense"
                    else 4.0 * self.K + 5.0)
        per = _LANE * max(1, -(-max(1, -(-self.n_sv // self.shards))
                               // _LANE))
        return float(b) * self.shards * per * (row_pass + 2.0 * self.n_out)

    def roofline(self, b: "int | None" = None):
        """Price one bucket of ``b`` queries (default ``max_bucket``)
        against the card's peaks (``launch.roofline``), from shapes, over
        every shard. The reference prices its compiled program; here the
        terms are the accumulate kernels' own:

        * flops: 2·B·M·d + 6·B·M a coefficient column (dense, M the padded
          SVs, d the row width), or 2·B·nnz + 10·B·M + 2·B·d (ELL, nnz the
          stored nonzeros);
        * bytes: the SV values at their stored width (ELL: every value,
          the cols of the nonzeros only), sq, coef, the queries, the fp64
          partials (written, then read) and the output;
        * the collective: the fp64 all-reduce of a sharded engine's (B,
          K) partial sums, by the ring rule.

        ``t_compute`` takes the fp32 peak for either storage type: the
        math is fp32 on the CUDA cores."""
        from repro_torch.launch import roofline as rl
        b = self.max_bucket if b is None else int(b)
        p, k = self.shards, self.n_out
        M, d = self.m_pad, self.width
        sv = self._data.X if self.fmt == "dense" else self._data.vals
        elt = sv.element_size()
        chunks = M // _LANE      # the kernels' SV chunks: 128 rows each
        if self.fmt == "dense":
            flops = k * (2.0 * b * M * d + 6.0 * b * M)
            sv_bytes = float(M) * d * elt
        else:
            flops = k * (2.0 * b * self.nnz + 10.0 * b * M + 2.0 * b * d)
            sv_bytes = float(M) * self.K * elt + 4.0 * self.nnz
        call = 4.0 * b * d + k * (8.0 * chunks * b + 4.0 * b)  # Z, part, out
        moved = sv_bytes + 4.0 * M * (1 + k) + call + k * 8.0 * chunks * b
        link = 2.0 * (p - 1) / p * 8.0 * b * k
        coll = ({"counts": {"all-reduce": 1}, "bytes": {"all-reduce":
                                                        8.0 * b * k}}
                if p > 1 else {"counts": {}, "bytes": {}})
        return rl.analyze(flops * p, moved * p, link, p, self.model_flops(b),
                          collectives=coll,
                          bytes_per_device=self.memory_bytes() + call)
