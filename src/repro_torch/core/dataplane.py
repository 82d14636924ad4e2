"""Training-time sample storage: the dense vs block-ELL data plane (twin
of ``repro.core.dataplane``).

The paper stores training samples in CSR so large sparse datasets fit in
memory (Sec. 2.2, Fig. 1b). Like the reference, the device side uses
block-ELL: every row is padded to a nonzero budget K so the ELL kernels
stream (vals, cols) rows with a gather of the dense query per slot.

* device side — :class:`DenseData` (X, sq_norms, gids) and
  :class:`ELLData` (vals, cols, sq_norms, n_features, gids): the tensors
  the fused epoch runner consumes. Working-set rows travel dense
  (``dense_rows``: O(d) per iteration against O(M*K) for the gamma pass).
* host side — :class:`DenseStore` / :class:`ELLStore` / :class:`CSRStore`:
  own the full training set in numpy and gather row subsets into padded
  device buffers. ``CSRStore`` keeps the paper's CSR layout (Fig. 1c) on
  the host and streams CSR->ELL on every buffer fill, so a
  ``format='ell'`` fit never materializes a dense X on the host.

The ELL lane budget K is adaptive: stores report ``buffer_K(rows)`` (the
lane-rounded max occupied extent over exactly the rows gathered) and the
driver re-derives K at every physical compaction, bucketed to a
power-of-two number of lanes (``data.sparse.bucket_lanes``).

Physical compaction between dispatches gathers the surviving rows on the
device (:func:`compact_plan` + :func:`gather_rows`, ELL rows truncated
exactly to the new budget); the host rebuild (:func:`deal` over the store)
is the parity oracle. Both lay rows out in the same balanced contiguous
p-shard layout, and squared norms always come from the one store-level
``sq_rows`` array, so the two paths produce the same bits.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.data import sparse as sp


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

    def flops_row_pass(self) -> float:
        """Model FLOPs of ONE kernel-row pass, per buffer row."""
        return 2.0 * self.n_features + 5.0


@dataclasses.dataclass(frozen=True)
class ELLData:
    """Device buffer, block-ELL layout.

    Padding slots hold (val 0, col 0) and contribute exactly 0 to every
    gather-FMA; padding rows are all padding (sq_norm 0). ``cols`` stays
    int32 on the device, as in the reference. ``gids`` as for
    :class:`DenseData`.
    """
    vals: torch.Tensor                     # (M, K) f32
    cols: torch.Tensor                     # (M, K) i32
    sq_norms: torch.Tensor                 # (M,) f32
    n_features: int                        # d of the dense queries
    gids: "torch.Tensor | None" = None     # (M,) i64 global row ids

    @property
    def m(self) -> int:
        return int(self.vals.shape[0])

    @property
    def K(self) -> int:
        return int(self.vals.shape[1])

    def dense_rows(self, idx: torch.Tensor) -> torch.Tensor:
        """Rows ``idx`` (k,) scattered to a dense (k, d) block. Exact: each
        real column appears once per row and padding slots add 0.0 to
        column 0, so the order of the adds cannot matter."""
        v = self.vals.index_select(0, idx)
        c = self.cols.index_select(0, idx).to(torch.int64)
        out = torch.zeros((idx.shape[0], self.n_features),
                          dtype=torch.float32, device=v.device)
        return out.scatter_add_(1, c, v)

    def flops_row_pass(self) -> float:
        """Model FLOPs of ONE gather-FMA kernel-row pass, per buffer row."""
        return 4.0 * self.K + 5.0


class DenseStore:
    """Host-side dense training set; gathers row subsets into buffers."""
    fmt = "dense"

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

    def buffer_K(self, rows: np.ndarray) -> int:
        """Dense buffers have no lane budget (protocol uniformity)."""
        return 0

    def alloc(self, m: int, K: "int | None" = None) -> np.ndarray:
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


class _EllFamilyStore:
    """Shared buffer contract of the stores that fill block-ELL device
    buffers. Subclasses provide ``lane``, ``row_extent`` (per-row occupied
    slots), ``n``, ``n_features``, ``K`` (the store-wide lane budget) and
    ``fill``; the buffer shape and its device form live here, so the ELL
    and CSR host layouts cannot drift apart. ``fill(buf, sl, rows)``
    accepts ``sl`` as a slice or a row-index array."""
    fmt = "ell"

    def buffer_K(self, rows: np.ndarray) -> int:
        """Lane-rounded max occupied extent over exactly ``rows``."""
        k = int(self.row_extent[rows].max()) if rows.size else 0
        return sp.round_lanes(k, self.lane)

    def sq_rows(self, rows: np.ndarray) -> np.ndarray:
        """|x_i|^2 gathered from one store-level (n,) array (see
        :meth:`DenseStore.sq_rows`), computed once by streaming store-K ELL
        blocks, so ``ELLStore`` and ``CSRStore`` give the same bits for the
        same matrix."""
        if getattr(self, "_sq", None) is None:
            sq = np.empty((self.n,), np.float32)
            for s in range(0, self.n, 8192):
                rs = np.arange(s, min(s + 8192, self.n))
                vb, _ = self.ell_rows(rs, self.K)
                sq[s: s + rs.size] = (vb * vb).sum(axis=1)
            self._sq = sq
        return self._sq[rows]

    def alloc(self, m: int, K: "int | None" = None):
        K = self.K if K is None else int(K)
        return (np.zeros((m, K), np.float32), np.zeros((m, K), np.int32))

    def to_device(self, buf, put, sq: np.ndarray,
                  gids: "np.ndarray | None" = None) -> ELLData:
        """Device buffer from a filled host buffer; ``sq`` comes from
        :meth:`sq_rows`."""
        vb, cb = buf
        g = None if gids is None else put(np.ascontiguousarray(gids, np.int64))
        return ELLData(put(np.ascontiguousarray(vb, np.float32)),
                       put(np.ascontiguousarray(cb, np.int32)),
                       put(np.ascontiguousarray(sq, np.float32)),
                       self.n_features, g)

    def ell_rows(self, rows: np.ndarray, K: "int | None" = None):
        """(vals, cols) for ``rows`` at lane budget K (default: their own
        lane-rounded max extent) — SV extraction."""
        if K is None:
            K = self.buffer_K(rows)
        buf = self.alloc(rows.size, K)
        self.fill(buf, slice(0, rows.size), rows)
        return buf

    def dense_rows(self, rows: np.ndarray) -> np.ndarray:
        """Densify a row subset through a bounded ELL scratch block, so
        sparse storage never forces a full dense materialization."""
        rows = np.asarray(rows).reshape(-1)
        vals, cols = self.ell_rows(rows)
        out = np.zeros((rows.size, self.n_features), np.float32)
        r = np.repeat(np.arange(rows.size), vals.shape[1])
        np.add.at(out, (r, cols.reshape(-1)), vals.reshape(-1))
        return out


class ELLStore(_EllFamilyStore):
    """Host-side block-ELL training set (vals, cols padded to K nonzeros).
    Rows pack their nonzeros into a slot prefix, so a subset whose max
    extent is k fills a buffer of any K >= k by plain ``[:, :K]``
    truncation."""

    def __init__(self, vals: np.ndarray, cols: np.ndarray, n_features: int,
                 lane: int = 128):
        self.vals = np.ascontiguousarray(vals, np.float32)
        self.cols = np.ascontiguousarray(cols, np.int32)
        self._n_features = int(n_features)
        self.lane = int(lane)
        self.row_extent = sp.ell_row_extent(self.vals)

    @property
    def n(self) -> int:
        return self.vals.shape[0]

    @property
    def n_features(self) -> int:
        return self._n_features

    @property
    def K(self) -> int:
        return self.vals.shape[1]

    def fill(self, buf, sl, rows: np.ndarray) -> None:
        vb, cb = buf
        K = vb.shape[1]
        if rows.size and int(self.row_extent[rows].max()) > K:
            raise ValueError(
                f"row extent {int(self.row_extent[rows].max())} exceeds "
                f"buffer K={K}")
        k = min(K, self.K)
        vb[sl, :k] = self.vals[rows, :k]
        cb[sl, :k] = self.cols[rows, :k]
        vb[sl, k:] = 0.0
        cb[sl, k:] = 0


class CSRStore(_EllFamilyStore):
    """Host-side CSR training set that fills block-ELL device buffers: the
    paper's storage format (Sec. 2.2, Fig. 1c) kept as it is on the host,
    streamed into (vals, cols) on every fill. The host cost is the CSR
    arrays plus one (m, K) buffer, never N*d. ``K`` pins the store-wide
    budget (dense ingest's ``ell_K``); adaptive per-buffer K still
    contracts below it."""

    def __init__(self, csr: "sp.CSRMatrix", lane: int = 128,
                 K: "int | None" = None):
        self.csr = sp.as_csr(csr)
        self.lane = int(lane)
        # trailing-NONZERO extent, not the stored-entry count: explicitly
        # stored zeros must not inflate K, and device compaction measures
        # extents from the buffer values — the two must agree
        self.row_extent = sp.csr_row_extent(self.csr)
        self._K_pin = None if K is None else sp.round_lanes(K, self.lane)

    @property
    def n(self) -> int:
        return self.csr.shape[0]

    @property
    def n_features(self) -> int:
        return self.csr.shape[1]

    @property
    def K(self) -> int:
        if self._K_pin is not None:
            return self._K_pin
        k = int(self.row_extent.max()) if self.n else 0
        return sp.round_lanes(k, self.lane)

    def memory_bytes(self) -> int:
        return self.csr.memory_bytes()

    def fill(self, buf, sl, rows: np.ndarray) -> None:
        """Vectorized CSR->ELL gather of ``rows`` into the buffer slice."""
        vb, cb = buf
        if rows.size == 0:
            return
        K = vb.shape[1]
        nnz = self.row_extent[rows]
        if int(nnz.max()) > K:
            raise ValueError(f"row with {int(nnz.max())} nnz exceeds "
                             f"buffer K={K}")
        if self.csr.nnz == 0:        # all-padding rows; nothing to gather
            vb[sl] = 0.0
            cb[sl] = 0
            return
        take = self.csr.indptr[rows][:, None] + np.arange(K)[None, :]
        mask = np.arange(K)[None, :] < nnz[:, None]
        take = np.where(mask, take, 0)
        vb[sl] = self.csr.data[take] * mask
        cb[sl] = self.csr.indices[take] * mask


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


def ell_extents(vals: torch.Tensor) -> torch.Tensor:
    """Device analogue of ``data.sparse.ell_row_extent``: per-row occupied
    slot count (last nonzero slot + 1; 0 for all-padding rows). (M,) i64."""
    M, K = vals.shape
    if K == 0:
        return torch.zeros((M,), dtype=torch.int64, device=vals.device)
    slot = torch.arange(1, K + 1, dtype=torch.int64, device=vals.device)
    return torch.where(vals != 0.0, slot, 0).amax(dim=1)


def ell_shard_extents(vals: torch.Tensor, keep: torch.Tensor, n_active: int,
                      p: int, m_per: int) -> torch.Tensor:
    """Per-shard max occupied extent of the surviving rows under the
    compaction re-layout with ``m_per`` slots per shard — the
    shape-explicit oracle of :func:`ell_shard_extents_dyn`. (p,) i64."""
    src, valid = compact_plan(keep, n_active, p, m_per)
    ext = torch.where(valid, ell_extents(vals)[src], 0)
    return ext.reshape(p, m_per).amax(dim=1)


def ell_shard_extents_dyn(vals: torch.Tensor, keep: torch.Tensor,
                          n_active: torch.Tensor, p: int,
                          offset: "int | torch.Tensor" = 0) -> torch.Tensor:
    """Per-shard max surviving extent without ``m_per``, from a device
    ``n_active`` — runs inside the fused epoch dispatch (no host sync),
    whose summary carries the (p,) result to the driver. ``vals`` may be
    one shard of the buffer: ``offset`` is then the survivors of the
    shards before it, and the (p,) result covers this shard's rows only
    (the maximum over shards is the buffer's).

    Shard ``q`` owns survivor ranks ``[q*base + min(q, extra), ...)`` with
    ``base, extra = divmod(n_active, p)``, whatever the per-shard padding,
    so a segment-max over the rank -> shard map gives the values of
    :func:`ell_shard_extents`. Integer arithmetic only: exact."""
    ext = torch.where(keep, ell_extents(vals), 0)
    rank = torch.cumsum(keep.to(torch.int64), 0) - 1 + offset
    n_active = torch.as_tensor(n_active, dtype=torch.int64,
                               device=vals.device)
    base = n_active // p
    extra = n_active - base * p
    cut = extra * (base + 1)
    q = torch.where(rank < cut, torch.div(rank, base + 1,
                                          rounding_mode="floor"),
                    extra + torch.div(rank - cut, torch.clamp(base, min=1),
                                      rounding_mode="floor"))
    q = torch.where(keep, q, p)                        # drop non-survivors
    out = torch.zeros((p + 1,), dtype=torch.int64, device=vals.device)
    return out.scatter_reduce_(0, q, ext, reduce="amax")[:p]


def gather_rows(data, src: torch.Tensor, valid: torch.Tensor,
                K_new: "int | None" = None):
    """Gather surviving rows into a fresh device buffer; padding rows are
    zeroed (gids -1) to match the host ``alloc`` layout bit for bit. ELL
    rows are truncated to the lane budget ``K_new`` (<= the current K;
    exact, since nonzeros pack a slot prefix)."""
    gids = None
    if data.gids is not None:
        gids = torch.where(valid, data.gids[src], -1)
    sq = torch.where(valid, data.sq_norms[src], 0.0)
    if isinstance(data, DenseData):
        X = torch.where(valid[:, None], data.X[src], 0.0)
        return DenseData(X, sq, gids)
    K = data.K if K_new is None else int(K_new)
    vals = torch.where(valid[:, None],
                       data.vals[:, :K].index_select(0, src), 0.0)
    cols = torch.where(valid[:, None],
                       data.cols[:, :K].index_select(0, src), 0)
    return ELLData(vals, cols, sq, data.n_features, gids)


def map_rows(data, f):
    """The buffer with ``f`` applied to each of its per-row tensors (rows,
    squared norms, gids) — how the multi-device driver gathers a buffer's
    shards into one array or takes its own shard of one."""
    gids = None if data.gids is None else f(data.gids)
    if isinstance(data, DenseData):
        return DenseData(f(data.X), f(data.sq_norms), gids)
    return ELLData(f(data.vals), f(data.cols), f(data.sq_norms),
                   data.n_features, gids)


def make_store(X, fmt: str, ell_K: "int | None" = None,
               ell_lane: int = 128):
    """Host store for ``fmt``. ``X`` is a dense (n, d) matrix or, for
    ``fmt='ell'``, CSR input (a ``data.sparse.CSRMatrix``, a scipy-like
    csr object or a ``(data, indices, indptr, shape)`` tuple), which builds
    a :class:`CSRStore` without a dense host matrix. An explicit ``ell_K``
    is rounded up to a whole number of ``ell_lane`` lanes."""
    if fmt == "dense":
        if sp.is_csr_like(X):
            X = sp.as_csr(X).to_dense()
        return DenseStore(np.asarray(X))
    if fmt == "ell":
        if ell_K is not None:
            if ell_K <= 0:
                raise ValueError(f"ell_K must be positive, got {ell_K}")
            ell_K = sp.round_lanes(ell_K, ell_lane)
        if sp.is_csr_like(X):
            store = CSRStore(sp.as_csr(X), lane=ell_lane, K=ell_K)
            if ell_K is not None and store.n and \
                    int(store.row_extent.max()) > ell_K:
                raise ValueError(
                    f"row with {int(store.row_extent.max())} nnz exceeds "
                    f"explicit ell_K={ell_K}")
            return store
        X = np.asarray(X, np.float32)
        ell = sp.to_ell(X, K=ell_K, lane=ell_lane)
        return ELLStore(ell.vals, ell.cols, X.shape[1], lane=ell_lane)
    raise ValueError(f"unknown data format {fmt!r} (want 'dense' or 'ell')")
