"""Training-time sample storage, dense half (twin of
``repro.core.dataplane``).

* device side — :class:`DenseData` (X, sq_norms, gids): the tensors the
  fused epoch runner consumes;
* host side — :class:`DenseStore`: owns the full training set in numpy and
  gathers row subsets into padded device buffers.

Physical compaction between dispatches gathers the surviving rows on the
device (:func:`compact_plan` + :func:`gather_rows`); the host rebuild
(:func:`deal` over the store) is the parity oracle. Both lay rows out in
the same balanced contiguous p-shard layout, and squared norms always come
from the one store-level ``sq_rows`` array, so the two paths produce the
same bits. Block-ELL/CSR storage is a later slice of the port.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DenseData:
    """Device buffer, dense layout.

    ``gids`` maps buffer position -> global sample id (-1 on padding
    rows); the epoch driver always sets it (the master writeback of
    device compaction keys on it). It is optional only for buffers outside
    the driver (SV blocks in predict/reconstruction).
    """
    X: torch.Tensor                        # (M, d) f32
    sq_norms: torch.Tensor                 # (M,) f32 — precomputed |x_i|^2
    gids: "torch.Tensor | None" = None     # (M,) i64 global row ids

    @property
    def m(self) -> int:
        return int(self.X.shape[0])

    @property
    def n_features(self) -> int:
        return int(self.X.shape[1])

    def dense_rows(self, idx: torch.Tensor) -> torch.Tensor:
        """Rows ``idx`` (k,) as a dense (k, d) block — the working-set rows."""
        return self.X.index_select(0, idx)


class DenseStore:
    """Host-side dense training set; gathers row subsets into buffers."""

    def __init__(self, X: np.ndarray):
        self.X = np.ascontiguousarray(X, np.float32)
        self._sq: "np.ndarray | None" = None

    @property
    def n(self) -> int:
        return self.X.shape[0]

    @property
    def n_features(self) -> int:
        return self.X.shape[1]

    def sq_rows(self, rows: np.ndarray) -> np.ndarray:
        """|x_i|^2 for ``rows``, gathered from ONE store-level array computed
        once at ingest — every buffer build, regrow, mirror and
        reconstruction block gathers these bits instead of re-summing, so
        device gathers equal host rebuilds bitwise by construction."""
        if self._sq is None:
            sq = np.empty((self.n,), np.float32)
            for s in range(0, self.n, 8192):
                b = self.X[s: s + 8192]
                sq[s: s + b.shape[0]] = (b * b).sum(axis=1)
            self._sq = sq
        return self._sq[rows]

    def alloc(self, m: int) -> np.ndarray:
        return np.zeros((m, self.n_features), np.float32)

    def fill(self, buf: np.ndarray, sl, rows: np.ndarray) -> None:
        buf[sl] = self.X[rows]

    def to_device(self, buf: np.ndarray, put, sq: np.ndarray,
                  gids: "np.ndarray | None" = None) -> DenseData:
        """Device buffer from a filled host buffer; ``sq`` always comes
        from :meth:`sq_rows` (never re-summed)."""
        g = None if gids is None else put(np.ascontiguousarray(gids, np.int64))
        return DenseData(put(buf), put(np.ascontiguousarray(sq, np.float32)),
                         g)

    def dense_rows(self, rows: np.ndarray) -> np.ndarray:
        return self.X[rows]


def deal(idx: np.ndarray, p: int, m_per: int):
    """Balanced contiguous dealing of rows ``idx`` over ``p`` shards of
    ``m_per`` slots: yields ``(buffer_slice, rows)`` per shard
    (``base + (q < extra)`` rows each). :func:`compact_plan` is its device
    twin; the two must stay interchangeable bit for bit."""
    base, extra = divmod(int(idx.size), p)
    off = 0
    for q in range(p):
        cnt = base + (1 if q < extra else 0)
        yield slice(q * m_per, q * m_per + cnt), idx[off: off + cnt]
        off += cnt


def full_layout(rows: np.ndarray, p: int, m_per: int):
    """Materialize the :func:`deal` layout: ``(idx, pos_of)`` with ``idx``
    (p*m_per,) mapping buffer position -> global id (-1 on padding tails)
    and ``pos_of`` (max_id+1,) the inverse (-1 where absent)."""
    idx = np.full((p * m_per,), -1, np.int64)
    for sl, sub in deal(rows, p, m_per):
        idx[sl] = sub
    n = int(rows.max()) + 1 if rows.size else 0
    pos_of = np.full((n,), -1, np.int64)
    real = idx >= 0
    pos_of[idx[real]] = np.flatnonzero(real)
    return idx, pos_of


def compact_plan(keep: torch.Tensor, n_active: int, p: int, m_per: int):
    """Gather plan for the balanced contiguous re-layout, on the device.

    ``keep`` (M_old,) bool marks surviving buffer rows; ``n_active`` is
    their count (the host already read it from the epoch summary — it
    fixes the output shape). Survivors are enumerated in buffer-position
    order and dealt to ``p`` contiguous shards of ``base + (q < extra)``
    rows: the host rebuild's layout. Returns ``(src, valid)``: ``src``
    (p*m_per,) old positions to gather (0 on padding), ``valid`` False on
    the per-shard padding tails.
    """
    M = keep.shape[0]
    dev = keep.device
    rank = torch.cumsum(keep.to(torch.int64), 0) - 1
    # survivor rank -> old position; non-survivors land in the spare slot M
    surv = torch.zeros((M + 1,), dtype=torch.int64, device=dev)
    surv.scatter_(0, torch.where(keep, rank, M),
                  torch.arange(M, dtype=torch.int64, device=dev))
    base, extra = divmod(int(n_active), p)
    j = torch.arange(p * m_per, dtype=torch.int64, device=dev)
    q = j // m_per
    r = j % m_per
    valid = r < base + (q < extra).to(torch.int64)
    k = q * base + torch.clamp(q, max=extra) + r
    src = surv[:M][torch.where(valid, k, 0)] if M else torch.zeros_like(j)
    return src, valid


def gather_rows(data: DenseData, src: torch.Tensor,
                valid: torch.Tensor) -> DenseData:
    """Gather surviving rows into a fresh device buffer; padding rows are
    zeroed (gids -1) to match the host ``alloc`` layout bit for bit."""
    gids = None
    if data.gids is not None:
        gids = torch.where(valid, data.gids[src], -1)
    sq = torch.where(valid, data.sq_norms[src], 0.0)
    X = torch.where(valid[:, None], data.X[src], 0.0)
    return DenseData(X, sq, gids)


def make_store(X, fmt: str) -> DenseStore:
    """Host store for ``fmt`` ('dense'; 'ell' is a later slice)."""
    if fmt == "dense":
        return DenseStore(np.asarray(X))
    if fmt == "ell":
        raise NotImplementedError(
            "format='ell' (block-ELL/CSR storage) arrives with the port's "
            "ELL/CSR slice")
    raise ValueError(f"unknown data format {fmt!r} (want 'dense' or 'ell')")
