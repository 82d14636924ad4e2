"""Gradient reconstruction — the paper's Algorithm 6, host-streaming
backend (twin of ``repro.core.reconstruct``; dense, block-ELL and CSR
stores).

Recomputes gamma_i = sum_{j: alpha_j > 0} alpha_j y_j K(x_i, x_j) - y_i
for the samples whose gamma went stale while shrunk. This backend builds
every SV and stale-row block in host numpy and ships it to the device per
block; it is the ``mirror='host'`` parity oracle and the ``'auto'``
fallback when the full-set mirror does not fit. The device-mirror backend
(``mirror.reconstruct_device``) walks the identical uniform block plan
(:func:`plan_blocks`) through the same block computation
(``kernel_fns.recon_block``) in the same order, so the two are bitwise
equal. SV blocks keep the store's native format — ELL-family stores ship
ELL blocks at the SV set's lane budget (:func:`sv_lane_budget`), so the
support-vector side never densifies; only the (row_block, d) stale-row
query blocks travel dense.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import kernel_fns, util
from repro_torch.data import sparse as spfmt


def plan_blocks(count: int, cap: int, lo: int = 128) -> tuple:
    """Uniform block decomposition of ``count`` items: ``(blk, n_blocks)``
    with ``blk`` a power-of-two bucket (<= ``cap``) and ``count`` padded up
    to ``blk * n_blocks``."""
    blk = min(int(cap), util.bucket_pow2(count, lo))
    return blk, max(1, -(-int(count) // blk))


def sv_lane_budget(store, sv_idx: np.ndarray, adaptive: bool = True) -> int:
    """The SV blocks' shared ELL lane budget: the SV set's own lane-rounded
    max extent, power-of-two bucketed and capped at the store budget
    (``ell_adaptive=False`` pins it to the store budget). One value for
    every SV block of a reconstruction, shared by both backends."""
    if not adaptive:
        return store.K
    return spfmt.bucket_lanes(store.buffer_K(sv_idx), store.lane,
                              cap=store.K)


def reconstruct_gamma_store(kernel: str, store, y: np.ndarray,
                            alpha: np.ndarray, rows: np.ndarray,
                            inv_2s2: float, device: torch.device,
                            row_block: int = 8192, sv_block: int = 8192,
                            ell_adaptive: bool = True) -> np.ndarray:
    """Alg. 6 over a data-plane store (dense, block-ELL or CSR) for global
    rows ``rows``; returns their new gamma in host fp64 (the caller rounds
    it once to f32). SV blocks are the outer loop, so at most one SV
    device block is live; the (nrb*row_blk,) fp64 accumulator adds block
    partials in the same order as the device mirror."""
    if rows.size == 0:
        return np.zeros((0,), np.float64)
    sv_idx = np.flatnonzero(alpha > 0.0)
    if sv_idx.size == 0:
        return (-y[rows]).astype(np.float64)
    provider = kernel_fns.make_provider(kernel, store.fmt, use_kernels=False,
                                        inv_2s2=inv_2s2)
    d = store.n_features
    K_sv = (sv_lane_budget(store, sv_idx, ell_adaptive)
            if store.fmt == "ell" else None)
    sv_blk, nsb = plan_blocks(sv_idx.size, sv_block)
    row_blk, nrb = plan_blocks(rows.size, row_block)
    put = lambda a: torch.from_numpy(a).to(device)
    acc = torch.zeros((nrb * row_blk,), dtype=torch.float64, device=device)
    for t in range(nsb):
        sub = sv_idx[t * sv_blk: (t + 1) * sv_blk]
        buf = store.alloc(sv_blk, K_sv)
        store.fill(buf, slice(0, sub.size), sub)
        sq = np.zeros((sv_blk,), np.float32)
        sq[: sub.size] = store.sq_rows(sub)
        coef = np.zeros((sv_blk,), np.float32)
        coef[: sub.size] = (alpha[sub] * y[sub]).astype(np.float32)
        sv_data = store.to_device(buf, put, sq=sq)
        coef_d = put(coef)
        for s in range(nrb):
            blk = rows[s * row_blk: (s + 1) * row_blk]
            Zi = np.zeros((row_blk, d), np.float32)
            Zi[: blk.size] = store.dense_rows(blk)
            g = kernel_fns.recon_block(provider, sv_data, put(Zi), coef_d)
            acc[s * row_blk: (s + 1) * row_blk] += g
    return acc.cpu().numpy()[: rows.size] - y[rows]
