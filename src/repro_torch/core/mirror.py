"""Device-resident full-set mirror of the training data (twin of
``repro.core.mirror``; dense or block-ELL, single device).

One fill of the store at fit time into the exact balanced buffer layout
the driver would build for the full set (ELL at the full set's adaptive
lane budget); afterwards

* buffer (re)builds — the initial buffer and un-shrink growth — are one
  device gather (:func:`grow_step`): ``dataplane.compact_plan`` /
  ``gather_rows`` over the mirror, alpha/gamma from the device (n,)
  masters;
* Alg. 6 reconstruction (:func:`reconstruct_device`) walks the
  host-streaming path's block plan over mirror blocks through the same
  ``kernel_fns.recon_block`` and scatters into the (n,) gamma master; SV
  blocks keep the mirror's format (ELL truncated to the SV set's lane
  budget), query rows are densified.

``mirror='host'`` keeps the host-streaming paths as the parity oracle; the
two are bitwise equal because mirror rows are copies of store rows, squared
norms always come from the store's one ``sq_rows`` array, and the block
computation and its order are shared.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import dataplane, kernel_fns, smo, util
from repro_torch.data import sparse as spfmt

# Fraction of free device memory the mirror may claim: it shares the card
# with the training buffer (~mirror-sized at the first epoch) and scratch.
_BUDGET_FRACTION = 0.4


@dataclasses.dataclass
class Mirror:
    """Device-resident full training set in driver buffer layout."""
    data: "dataplane.DenseData | dataplane.ELLData"   # m = p * m_per rows
    y: torch.Tensor             # (m,) f32 labels by mirror position (+1 pad)
    idx: np.ndarray             # (m,) i64 position -> global id (-1 pad)
    pos_of: np.ndarray          # (n,) i64 global id -> position
    p: int
    m_per: int
    K: Optional[int]            # full-set ELL lane budget (None for dense)
    n: int
    nbytes: int


def full_m_per(count: int, p: int, min_buffer: int) -> int:
    """Per-shard slot count for a ``count``-row buffer — the one rounding
    rule shared by buffer builds, compaction scheduling and the mirror."""
    return util.bucket_pow2(-(-count // p), max(min_buffer // p, 8))


def mirror_nbytes(store, p: int, m_per: int, K: Optional[int]) -> int:
    """Device bytes of the full-set mirror (rows + sq_norms + gids + y):
    an ELL row is K*8 bytes of (vals, cols), a dense one d*4."""
    row = int(K) * 8 if store.fmt == "ell" else store.n_features * 4
    return p * m_per * (row + 16)


def budget_bytes(cfg, device: torch.device) -> Optional[int]:
    """The mirror's byte cap: the explicit config cap, else a fraction of
    the card's free memory (``torch.cuda.mem_get_info``), else None (CPU:
    host RAM, assumed to fit)."""
    if cfg.mirror_budget_bytes is not None:
        return int(cfg.mirror_budget_bytes)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return int(_BUDGET_FRACTION * free)
    return None


def resolve(cfg, store, p: int, shrink_on: bool,
            device: torch.device) -> tuple:
    """Decide the mirror mode at fit time: ``(mode, m_per, K, nbytes)``
    with ``mode`` 'device' or 'host' and ``K`` the full set's ELL lane
    budget (None for dense). Shrink-free runs never reconstruct or grow,
    so they resolve to 'host'. ``mirror='device'`` over budget raises;
    ``'auto'`` falls back to 'host'."""
    if cfg.mirror not in ("auto", "device", "host"):
        raise ValueError(f"unknown mirror {cfg.mirror!r} "
                         "(want 'auto', 'device' or 'host')")
    m_per = full_m_per(store.n, p, cfg.min_buffer)
    if cfg.mirror == "host" or not shrink_on:
        return "host", m_per, None, 0
    K = None
    if store.fmt == "ell":
        K = (spfmt.bucket_lanes(store.buffer_K(np.arange(store.n)),
                                store.lane, cap=store.K)
             if cfg.ell_adaptive else store.K)
    need = mirror_nbytes(store, p, m_per, K) // p
    cap = budget_bytes(cfg, device)
    if cap is not None and need > cap:
        if cfg.mirror == "device":
            raise ValueError(
                f"mirror='device' needs {need} bytes (n={store.n}, "
                f"fmt={store.fmt}"
                + (f", ELL lane budget K={K}" if K is not None else "")
                + f", d={store.n_features}) but the device-memory cap is "
                f"{cap} bytes; use mirror='auto' (host-streaming fallback) "
                "or raise mirror_budget_bytes")
        return "host", m_per, K, need
    return "device", m_per, K, need


def build(store, y: np.ndarray, put, p: int, m_per: int,
          K: Optional[int]) -> Mirror:
    """One host fill of the full set into the balanced buffer layout — the
    only host->device row traffic of a mirrored fit."""
    n = store.n
    m = p * m_per
    buf = store.alloc(m, K)
    yb = np.ones((m,), np.float32)
    sqb = np.zeros((m,), np.float32)
    idx, pos_of = dataplane.full_layout(np.arange(n), p, m_per)
    for sl, sub in dataplane.deal(np.arange(n), p, m_per):
        store.fill(buf, sl, sub)
        yb[sl] = y[sub]
        sqb[sl] = store.sq_rows(sub)
    data = store.to_device(buf, put, gids=idx, sq=sqb)
    return Mirror(data=data, y=put(yb), idx=idx, pos_of=pos_of, p=p,
                  m_per=m_per, K=K, n=n,
                  nbytes=mirror_nbytes(store, p, m_per, K))


def grow_step(data, y_m: torch.Tensor, alpha_d: torch.Tensor,
              gamma_d: torch.Tensor, keep_pos: torch.Tensor, n_sel: int,
              p: int, m_per: int, K_new: Optional[int] = None):
    """Gather a fresh training buffer for the rows marked in ``keep_pos``
    ((m_mirror,) bool by mirror position) out of the mirror: rows, gids and
    sq_norms by the device-compaction machinery (ELL rows truncated to the
    lane budget ``K_new``), alpha/gamma from the (n,) masters. Returns
    ``(data, y_buf, fresh state)``."""
    src, valid = dataplane.compact_plan(keep_pos, n_sel, p, m_per)
    data2 = dataplane.gather_rows(data, src, valid, K_new)
    yb2 = torch.where(valid, y_m[src], 1.0)    # padding: y=+1, alpha=0 -> I1
    gid = torch.where(valid, data2.gids, 0)
    alpha2 = torch.where(valid, alpha_d[gid], 0.0)
    gamma2 = torch.where(valid, gamma_d[gid], float("inf"))
    return data2, yb2, smo.init_state(alpha2, gamma2, valid)


def _sv_block(data, pos: torch.Tensor, K_sv: Optional[int]):
    """SV block at mirror positions ``pos`` (-1 pads give zero rows) in
    the mirror's format — ELL truncated exactly to the SV lane budget
    ``K_sv`` — the device analogue of ``store.alloc`` + ``fill``. Returns
    ``(block, valid, safe)``."""
    valid = pos >= 0
    safe = torch.where(valid, pos, 0)
    sq = torch.where(valid, data.sq_norms[safe], 0.0)
    if isinstance(data, dataplane.DenseData):
        X = torch.where(valid[:, None], data.X[safe], 0.0)
        return dataplane.DenseData(X, sq), valid, safe
    vals = torch.where(valid[:, None],
                       data.vals[:, :K_sv].index_select(0, safe), 0.0)
    cols = torch.where(valid[:, None],
                       data.cols[:, :K_sv].index_select(0, safe), 0)
    return dataplane.ELLData(vals, cols, sq, data.n_features), valid, safe


def _dense_block(data, pos: torch.Tensor) -> torch.Tensor:
    """Query rows at mirror positions ``pos`` as a dense block (-1 pads
    give zero rows) — the device analogue of ``store.dense_rows``."""
    valid = pos >= 0
    safe = torch.where(valid, pos, 0)
    rows = data.dense_rows(safe)
    return torch.where(valid[:, None], rows, 0.0)


def reconstruct_device(provider, mir: Mirror, alpha_d: torch.Tensor,
                       gamma_d: torch.Tensor, sv_pos: torch.Tensor,
                       stale_pos: torch.Tensor, sv_blk: int, row_blk: int,
                       nsb: int, nrb: int,
                       K_sv: Optional[int] = None) -> tuple:
    """Alg. 6 over the mirror: SV blocks outer, stale-row query blocks
    inner (the host oracle's order), ``kernel_fns.recon_block`` per cell.
    ``sv_pos`` / ``stale_pos`` are mirror positions padded with -1 to
    ``nsb * sv_blk`` / ``nrb * row_blk``; ``K_sv`` is the SV blocks'
    shared ELL lane budget. Writes the stale rows' new gamma, rounded once
    to f32, into ``gamma_d`` in place; returns ``gamma_d`` and the stale
    rows' fp64 gamma in ``stale_pos`` order."""
    data = mir.data
    acc = torch.zeros((nrb * row_blk,), dtype=torch.float64,
                      device=gamma_d.device)
    for t in range(nsb):
        svd, valid, safe = _sv_block(
            data, sv_pos[t * sv_blk: (t + 1) * sv_blk], K_sv)
        gid = torch.where(valid, data.gids[safe], 0)
        coef = torch.where(valid, alpha_d[gid] * mir.y[safe], 0.0)
        for s in range(nrb):
            Zi = _dense_block(data, stale_pos[s * row_blk:
                                              (s + 1) * row_blk])
            g = kernel_fns.recon_block(provider, svd, Zi, coef)
            acc[s * row_blk: (s + 1) * row_blk] += g
    valid = stale_pos >= 0
    safe = torch.where(valid, stale_pos, 0)
    g64 = acc - mir.y[safe].double()
    gamma_d[data.gids[safe][valid]] = g64.float()[valid]
    return gamma_d, g64[valid]


def pad_pos(pos: np.ndarray, total: int) -> np.ndarray:
    """Pad a position vector with -1 up to ``total`` (i64, contiguous)."""
    out = np.full((total,), -1, np.int64)
    out[: pos.size] = pos
    return out
