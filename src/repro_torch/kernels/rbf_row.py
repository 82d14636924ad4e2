"""Launchers of the two-row RBF kernel and the serve-time RBF accumulates
(``csrc/rbf_rows.cu``, ``csrc/rbf_accumulate.cu``,
``csrc/ell_accumulate.cu``; replace ``repro.kernels.rbf_row.rbf_rows2`` /
``rbf_accumulate`` / ``ell_rbf_accumulate``).

CUDA tensors only: ``ops.kernel_rows2`` / ``ops.rbf_accumulate`` /
``ops.ell_rbf_accumulate`` dispatch between these kernels and their plain
versions by tensor device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda

_P, _I = ctypes.c_void_p, ctypes.c_int
_ROWS2_ARGS = [_P, _P, _P, ctypes.c_float, _P, _I, _I, _P]
_ACCUM_ARGS = [_P, _P, _P, _P, ctypes.c_float, _P, _P, _I, _I, _I, _P]


def rbf_rows2(X: torch.Tensor, sq_norms: torch.Tensor, z2: torch.Tensor,
              inv_2s2: float) -> torch.Tensor:
    """(N, 2) RBF rows K(z2[j], X[i]); columns are computed by identical
    code, so ``rbf_rows2(X, sq, stack([z, z]))`` has bitwise equal
    columns. Any N and d (no padding needed)."""
    n, d = X.shape
    cuda.check(X, "X", (n, d))
    cuda.check(sq_norms, "sq_norms", (n,))
    cuda.check(z2, "z2", (2, d))
    out = torch.empty((n, 2), dtype=torch.float32, device=X.device)
    rc = cuda.entry("rbf_rows2", _ROWS2_ARGS)(
        cuda.ptr(X), cuda.ptr(sq_norms), cuda.ptr(z2), float(inv_2s2),
        cuda.ptr(out), n, d, cuda.stream(X))
    cuda.raise_on(rc, "rbf_rows2")
    cuda.launches["rbf_rows2"] += 1
    return out


def _partials(kernel: str, m: int, b: int, device) -> torch.Tensor:
    """The fp64 scratch of a split accumulate: one partial per (SV chunk,
    query), (ceil(m / chunk rows), b); the chunk size is a constant of the
    kernel's source."""
    rows = cuda.constant(kernel, "chunk_rows")
    return torch.empty(((m + rows - 1) // rows, b), dtype=torch.float64,
                       device=device)


def rbf_accumulate(X: torch.Tensor, sq_norms: torch.Tensor,
                   coef: torch.Tensor, Z: torch.Tensor,
                   inv_2s2: float) -> torch.Tensor:
    """(B,) decision partials sum_i coef[i] * K(Z[j], X[i]) over SVs X
    (M, d), never forming the (B, M) kernel matrix: a kernel over (SV
    chunk, query tile) blocks writes fp64 partials, a second one adds them
    in chunk order (one wrapper call, one counted launch). Deterministic,
    and a query's bits do not depend on B or its place in the bucket; rows
    with coef 0 contribute exactly 0."""
    m, d = X.shape
    b = Z.shape[0]
    cuda.check(X, "X", (m, d))
    cuda.check(sq_norms, "sq_norms", (m,))
    cuda.check(coef, "coef", (m,))
    cuda.check(Z, "Z", (b, d))
    out = torch.empty((b,), dtype=torch.float32, device=X.device)
    part = _partials("rbf_accumulate", m, b, X.device)
    rc = cuda.entry("rbf_accumulate", _ACCUM_ARGS)(
        cuda.ptr(X), cuda.ptr(sq_norms), cuda.ptr(coef), cuda.ptr(Z),
        float(inv_2s2), cuda.ptr(out), cuda.ptr(part), m, b, d,
        cuda.stream(X))
    cuda.raise_on(rc, "rbf_accumulate")
    cuda.launches["rbf_accumulate"] += 1
    return out


_ELL_ACCUM_ARGS = [_P, _P, _P, _P, _P, ctypes.c_float, _P, _P, _I, _I, _I,
                   _I, _P]


def ell_rbf_accumulate(vals: torch.Tensor, cols: torch.Tensor,
                       sq_norms: torch.Tensor, coef: torch.Tensor,
                       Z: torch.Tensor, inv_2s2: float) -> torch.Tensor:
    """(B,) decision partials sum_i coef[i] * K(Z[j], x_i) over block-ELL
    SVs (``csrc/ell_accumulate.cu``; replaces
    ``repro.kernels.rbf_row.ell_rbf_accumulate``). vals (M, K) f32, cols
    (M, K) int32 in [0, d), Z (B, d). Split over SV chunks as
    :func:`rbf_accumulate`. Deterministic; a query's bits depend neither
    on B, its place in the bucket nor K; rows with coef 0 contribute
    exactly 0."""
    m, K = cuda.check_ell(vals, cols, sq_norms)
    b, d = Z.shape
    cuda.check(coef, "coef", (m,))
    cuda.check(Z, "Z", (b, d))
    out = torch.empty((b,), dtype=torch.float32, device=vals.device)
    part = _partials("ell_rbf_accumulate", m, b, vals.device)
    rc = cuda.entry("ell_rbf_accumulate", _ELL_ACCUM_ARGS)(
        cuda.ptr(vals), cuda.ptr(cols), cuda.ptr(sq_norms), cuda.ptr(coef),
        cuda.ptr(Z), float(inv_2s2), cuda.ptr(out), cuda.ptr(part), m, K, b,
        d, cuda.stream(vals))
    cuda.raise_on(rc, "ell_rbf_accumulate")
    cuda.launches["ell_rbf_accumulate"] += 1
    return out
