"""Launchers of the block-ELL RBF row kernels (``csrc/ell_rows.cu``; twin
of ``repro.kernels.sparse_ell``): ``ell_kernel_row``, ``ell_kernel_rows2``
(and its row-cache entry ``ell_kernel_rows2_cached``) and the fused Eq. 6
``ell_gamma_update``.

CUDA tensors only: ``ops.ell_*`` dispatch between these kernels and their
plain versions (``ref.ell_*``) by tensor device. ``vals`` is f32 and
``cols`` int32, both (N, K) with padding slots (0.0, 0) and every column
id in [0, d); any N, K and d (no padding needed).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ROW_ARGS = [_P, _P, _P, _P, _F, _P, _I, _I, _I, _P]
_GAMMA_ARGS = [_P, _P, _P, _P, _P, _P, _F, _P, _I, _I, _I, _P]
_ROWS2_CACHED_ARGS = [_P, _P, _P, _P, _F, _P, _P, _P, _I, _P, _I, _I, _I, _P]


def ell_kernel_row(vals: torch.Tensor, cols: torch.Tensor,
                   sq_norms: torch.Tensor, z: torch.Tensor,
                   inv_2s2: float) -> torch.Tensor:
    """(N,) RBF row K(z, x_i) over ELL rows."""
    n, K = cuda.check_ell(vals, cols, sq_norms)
    d = z.shape[0]
    cuda.check(z, "z", (d,))
    out = torch.empty((n,), dtype=torch.float32, device=vals.device)
    rc = cuda.entry("ell_kernel_row", _ROW_ARGS)(
        cuda.ptr(vals), cuda.ptr(cols), cuda.ptr(sq_norms), cuda.ptr(z),
        float(inv_2s2), cuda.ptr(out), n, K, d, cuda.stream(vals))
    cuda.raise_on(rc, "ell_kernel_row")
    cuda.launches["ell_kernel_row"] += 1
    return out


def ell_kernel_rows2(vals: torch.Tensor, cols: torch.Tensor,
                     sq_norms: torch.Tensor, z2: torch.Tensor,
                     inv_2s2: float) -> torch.Tensor:
    """(N, 2) RBF rows K(z2[j], x_i) over ELL rows; the two columns run
    identical code, so ``rows2(stack([z, z]))`` has bitwise equal
    columns."""
    n, K = cuda.check_ell(vals, cols, sq_norms)
    d = z2.shape[-1]
    cuda.check(z2, "z2", (2, d))
    out = torch.empty((n, 2), dtype=torch.float32, device=vals.device)
    rc = cuda.entry("ell_kernel_rows2", _ROW_ARGS)(
        cuda.ptr(vals), cuda.ptr(cols), cuda.ptr(sq_norms), cuda.ptr(z2),
        float(inv_2s2), cuda.ptr(out), n, K, d, cuda.stream(vals))
    cuda.raise_on(rc, "ell_kernel_rows2")
    cuda.launches["ell_kernel_rows2"] += 1
    return out


def ell_kernel_rows2_cached(vals: torch.Tensor, cols: torch.Tensor,
                            sq_norms: torch.Tensor, z2: torch.Tensor,
                            table: torch.Tensor, slot2: torch.Tensor,
                            hit: torch.Tensor, inv_2s2: float) -> torch.Tensor:
    """:func:`ell_kernel_rows2` behind the row cache, in one launch
    whatever the flag says: where the device flag ``hit`` is set, the two
    rows of the cache's value table ``table`` (S, N) at ``slot2`` (as the
    (N, 2) columns); else ``ell_kernel_rows2``'s rows, bit for bit. Counted
    as an ``ell_kernel_rows2`` launch."""
    n, K = cuda.check_ell(vals, cols, sq_norms)
    d = z2.shape[-1]
    cuda.check(z2, "z2", (2, d))
    cuda.check_table(table, slot2, hit, n)
    out = torch.empty((n, 2), dtype=torch.float32, device=vals.device)
    rc = cuda.entry("ell_kernel_rows2", _ROWS2_CACHED_ARGS,
                    "ell_kernel_rows2_cached")(
        cuda.ptr(vals), cuda.ptr(cols), cuda.ptr(sq_norms), cuda.ptr(z2),
        float(inv_2s2), cuda.ptr(table), cuda.ptr(slot2), cuda.ptr(hit), n,
        cuda.ptr(out), n, K, d, cuda.stream(vals))
    cuda.raise_on(rc, "ell_kernel_rows2_cached")
    cuda.launches["ell_kernel_rows2"] += 1
    return out


def ell_gamma_update(vals: torch.Tensor, cols: torch.Tensor,
                     sq_norms: torch.Tensor, gamma: torch.Tensor,
                     z2: torch.Tensor, coef2: torch.Tensor,
                     inv_2s2: float) -> torch.Tensor:
    """gamma + coef2[0]*K(z2[0], x_i) + coef2[1]*K(z2[1], x_i) in one pass
    over the ELL rows; returns a new (N,) tensor."""
    n, K = cuda.check_ell(vals, cols, sq_norms)
    d = z2.shape[-1]
    cuda.check(gamma, "gamma", (n,))
    cuda.check(z2, "z2", (2, d))
    cuda.check(coef2, "coef2", (2,))
    out = torch.empty_like(gamma)
    rc = cuda.entry("ell_gamma_update", _GAMMA_ARGS)(
        cuda.ptr(vals), cuda.ptr(cols), cuda.ptr(sq_norms), cuda.ptr(gamma),
        cuda.ptr(z2), cuda.ptr(coef2), float(inv_2s2), cuda.ptr(out), n, K,
        d, cuda.stream(vals))
    cuda.raise_on(rc, "ell_gamma_update")
    cuda.launches["ell_gamma_update"] += 1
    return out
