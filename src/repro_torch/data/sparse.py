"""Sparse sample storage: CSR (the paper's format) and block-ELL (copy of
``repro.data.sparse``; numpy only, outputs byte-equal to the reference).

CSR here is the classic three-array layout (Fig. 1b/1c of the paper, minus
the co-located alpha/y/gamma cells — those live in the solver state). ELL
pads every row to a fixed nonzero budget K (a multiple of ``lane``) so the
ELL kernels stream (vals, cols) rows; the lane multiple is kept from the
reference so both packages pick the same budgets.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRMatrix:
    data: np.ndarray      # (nnz,) f32
    indices: np.ndarray   # (nnz,) i32 column ids
    indptr: np.ndarray    # (N+1,) i64 row pointers (the paper's psi)
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.data.size)

    def row_nnz(self) -> np.ndarray:
        """Per-row nonzero counts (N,) — the quantity adaptive K tracks."""
        return np.diff(self.indptr).astype(np.int64)

    def row(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        lo, hi = self.indptr[i], self.indptr[i + 1]
        return self.data[lo:hi], self.indices[lo:hi]

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, np.float32)
        rows = np.repeat(np.arange(self.shape[0]), self.row_nnz())
        out[rows, self.indices] = self.data
        return out

    def memory_bytes(self) -> int:
        return self.data.nbytes + self.indices.nbytes + self.indptr.nbytes


@dataclasses.dataclass
class ELLMatrix:
    vals: np.ndarray      # (N, K) f32, zero-padded
    cols: np.ndarray      # (N, K) i32, zero-padded (val 0 makes it inert)
    shape: tuple[int, int]

    @property
    def K(self) -> int:
        return int(self.vals.shape[1])

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, np.float32)
        n = self.shape[0]
        rows = np.repeat(np.arange(n), self.K)
        np.add.at(out, (rows, self.cols.reshape(-1)), self.vals.reshape(-1))
        return out

    def memory_bytes(self) -> int:
        return self.vals.nbytes + self.cols.nbytes

    def sq_norms(self) -> np.ndarray:
        return (self.vals ** 2).sum(axis=1).astype(np.float32)


def as_csr(obj) -> CSRMatrix:
    """Coerce CSR-like input to :class:`CSRMatrix` without densifying.

    Accepts a ``CSRMatrix``, any scipy-style object exposing
    ``data``/``indices``/``indptr``/``shape``, or a ``(data, indices,
    indptr, shape)`` tuple. Arrays are cast (f32 values, i32 columns,
    i64 row pointers) but never expanded to dense.
    """
    if isinstance(obj, CSRMatrix):
        src = obj
    elif all(hasattr(obj, a) for a in ("data", "indices", "indptr", "shape")):
        # CSC/BSR expose the same three arrays with different semantics —
        # reading them row-wise silently trains on the wrong matrix.
        fmt = getattr(obj, "format", "csr")
        if fmt != "csr":
            raise TypeError(
                f"expected CSR input, got scipy format {fmt!r}; convert "
                "with .tocsr() first")
        src = obj
    elif isinstance(obj, (tuple, list)) and len(obj) == 4:
        data, indices, indptr, shape = obj
        src = CSRMatrix(np.asarray(data), np.asarray(indices),
                        np.asarray(indptr), tuple(shape))
    else:
        raise TypeError(
            f"cannot interpret {type(obj).__name__} as CSR; want CSRMatrix, "
            "a scipy-like csr object, or (data, indices, indptr, shape)")
    data = np.ascontiguousarray(src.data, np.float32)
    indices = np.ascontiguousarray(src.indices, np.int32)
    indptr = np.ascontiguousarray(src.indptr, np.int64)
    n, d = (int(s) for s in src.shape)
    if indptr.shape != (n + 1,) or int(indptr[-1]) != data.size:
        raise ValueError(f"inconsistent CSR: indptr {indptr.shape} vs "
                         f"shape {(n, d)}, nnz {data.size}")
    if data.size and not (0 <= int(indices.min())
                          and int(indices.max()) < d):
        raise ValueError(
            f"CSR column ids outside [0, {d}): "
            f"[{int(indices.min())}, {int(indices.max())}]")
    return CSRMatrix(data, indices, indptr, (n, d))


def is_csr_like(obj) -> bool:
    """True when ``obj`` carries CSR arrays (used by store/solver ingest).

    Matches everything :func:`as_csr` accepts: ``CSRMatrix``, scipy-like
    attr objects, and the ``(data, indices, indptr, shape)`` tuple form —
    the tuple is recognized by its 1-D leading arrays and 2-tuple shape so
    a 4-row dense matrix passed as a list of lists is not misread as CSR.
    """
    if isinstance(obj, CSRMatrix) or \
            all(hasattr(obj, a) for a in ("data", "indices", "indptr",
                                          "shape")):
        return True
    if isinstance(obj, (tuple, list)) and len(obj) == 4:
        data, indices, indptr, shape = obj
        try:
            return (np.ndim(data) == 1 and np.ndim(indices) == 1 and
                    np.ndim(indptr) == 1 and len(shape) == 2)
        except TypeError:
            return False
    return False


def to_csr(X: np.ndarray) -> CSRMatrix:
    n, d = X.shape
    mask = X != 0
    counts = mask.sum(axis=1)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    cols = np.nonzero(mask)[1].astype(np.int32)
    data = X[mask].astype(np.float32)
    return CSRMatrix(data, cols, indptr, (n, d))


def to_ell(X: np.ndarray, K: int | None = None, lane: int = 128) -> ELLMatrix:
    """Pad rows to K nonzeros (default: max row nnz rounded up to ``lane``)."""
    n, d = X.shape
    mask = X != 0
    counts = mask.sum(axis=1)
    kmax = int(counts.max()) if n else 0
    if K is None:
        K = max(lane, -(-kmax // lane) * lane)
    if kmax > K:
        raise ValueError(f"row with {kmax} nnz exceeds K={K}")
    # stable argsort of ~mask packs each row's nonzero columns (in order)
    # into the first slots; the padding tail is masked to (val=0, col=0)
    order = np.argsort(~mask, axis=1, kind="stable")[:, :K]
    taken = np.take_along_axis(mask, order, axis=1)
    vals = np.take_along_axis(X, order, axis=1).astype(np.float32) * taken
    cols = (order * taken).astype(np.int32)
    return ELLMatrix(vals, cols, (n, d))


def csr_row_extent(csr: CSRMatrix) -> np.ndarray:
    """Per-row trailing-nonzero extent of the CSR->ELL packed layout: the
    in-row position of the last *nonzero* stored entry + 1 (0 for
    empty/all-zero rows). This — not ``row_nnz`` — is the smallest K a row
    survives truncation to, and it matches :func:`ell_row_extent` on the
    filled ELL buffer exactly, so host- and device-side adaptive-K
    compaction agree even when the CSR input carries explicitly stored
    zeros (thresholded matrices without ``eliminate_zeros()``)."""
    n = csr.shape[0]
    rows = np.repeat(np.arange(n), csr.row_nnz())
    pos = np.arange(csr.nnz, dtype=np.int64) - csr.indptr[rows]
    mask = csr.data != 0
    ext = np.zeros(n, np.int64)
    np.maximum.at(ext, rows[mask], pos[mask] + 1)
    return ext


def ell_row_extent(vals: np.ndarray) -> np.ndarray:
    """Per-row occupied-slot count of an ELL block: last nonzero slot + 1
    (0 for all-padding rows). ``to_ell`` packs nonzeros into a prefix, so
    this is the smallest K each row survives truncation to — what adaptive
    K recompaction measures on the surviving rows."""
    nz = vals != 0
    K = vals.shape[1]
    return np.where(nz.any(axis=1), K - np.argmax(nz[:, ::-1], axis=1),
                    0).astype(np.int64)


def round_lanes(k: int, lane: int) -> int:
    """Round a nonzero budget up to a whole number of lanes (min 1)."""
    return max(lane, -(-int(k) // lane) * lane)


def bucket_lanes(k: int, lane: int, cap: "int | None" = None) -> int:
    """Lane-round ``k``, then round up to a power-of-two number of lanes.

    Adaptive K makes the ELL lane budget a fresh trace dimension at every
    physical compaction; bucketing to {1, 2, 4, ...} lanes bounds the jit
    cache to O(log(K_max / lane)) distinct entries per runner instead of
    one per compaction. ``cap`` (the store-wide K) keeps the first buffer
    from over-padding past what ingest ever needs.
    """
    lanes = -(-round_lanes(k, lane) // lane)
    k = lane * (1 << (lanes - 1).bit_length())
    if cap is not None:
        k = min(k, round_lanes(cap, lane))
    return k


def csr_space_report(X: np.ndarray) -> dict:
    """Fig. 1b: memory conserved by sparse formats vs dense."""
    dense = X.nbytes
    csr = to_csr(X).memory_bytes()
    ell = to_ell(X).memory_bytes()
    return {
        "dense_bytes": dense,
        "csr_bytes": csr,
        "ell_bytes": ell,
        "csr_saving_pct": 100.0 * (1 - csr / dense),
        "ell_saving_pct": 100.0 * (1 - ell / dense),
        "density": float(np.count_nonzero(X)) / X.size,
    }
