#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
into ``build/``, holds each kernel against its plain PyTorch version at the
main paths' shapes, then drives the port's three main paths through the
entry points a user calls:

* LM serving: full-size ``llama3-8b`` (32 layers, bf16, random weights
  from a seed), 4 requests of 1,024 prompt tokens
  and 32 new tokens through ``launch.serve.generate`` (the prefill step,
  then greedy decode against the KV cache); and the same width at 2
  layers in fp32, where the flash prefill must agree with the plain
  blockwise one (the reference's attention without the kernel, swapped in
  for the gate only) and the decode-built cache with the prefill;
* dense: a full-size ``a9a`` fit (C=32, sigma2=64, multi5pc, wss1) to
  convergence, a Single-policy wss2 fit at scale 0.2, and
  ``SVMModel.predict`` over the test rows;
* sparse (block-ELL, CSR input): a full-size ``w7a`` fit fed as CSR
  (C=32, sigma2=64, multi5pc, wss1, ``format='ell'``) to convergence, a
  Single-policy wss2 fit at scale 0.2, one ``ELLKernelRowProvider.row``
  over the training buffer, and ``SVMModel.predict`` over the CSR test
  rows.

Every fit must pass Eq. 9 over all samples on gamma recomputed in fp64.
Kernel launch counts are reset just before each phase of a path and read
just after, so the run shows that serving and training went through the
kernels. Kernel times are device times with the inputs read from device
memory (``DeviceTimer``), the condition the bytes bound assumes. Every
phase prints its own line; a failure prints the phase and its reason (with
the traceback) to standard output and exits non-zero with no result. The
second-to-last line is the card's name and power limit, the line before it
the per-kernel JSON record, the last line the device JSON. It imports
nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12        # fp32 outside the tensor cores, same source
H100_BF16_FLOPS = 989e12       # bf16 tensor cores, dense, same source


PHASE = "start"


def phase(name: str) -> None:
    """Name the phase that runs now (printed if it fails)."""
    global PHASE
    PHASE = name


def fail(msg: str) -> None:
    print(f"FAIL [{PHASE}]: {msg}", flush=True)
    print(f"FAIL [{PHASE}]: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def nbytes_of(t) -> int:
    """Bytes held by a dense or sparse CSR tensor."""
    if t.is_sparse_csr:
        return sum(nbytes_of(p) for p in (t.crow_indices(), t.col_indices(),
                                          t.values()))
    return t.numel() * t.element_size()


class DeviceTimer:
    """Device time of one call ``fn(*inputs)`` (ms), from CUDA events around
    ``reps`` back-to-back calls. ``cold`` (the default) reads the inputs
    from device memory, not from L2, as the HBM bound each time is held
    against assumes: the calls cycle through copies of ``inputs`` that
    together hold more than twice the L2 cache, so a copy was evicted
    before it is read again. ``cold=False`` repeats the same inputs, which
    stay in L2 when they fit, as the SMO loop finds its buffer. These
    kernels run for less time than one Python launch takes, so events
    around a plain loop would time the host's launch rate: the timer first
    queues fp32 matmuls that keep the card busy while the host enqueues the
    timed calls, and checks that the card was still inside them when the
    host finished (else it retries with a longer lead)."""

    def __init__(self, torch, dev):
        self.torch = torch
        g = torch.Generator(device=dev).manual_seed(1)
        self.a = torch.randn(4096, 4096, generator=g, device=dev)
        self.l2 = getattr(torch.cuda.get_device_properties(dev),
                          "L2_cache_size", 50 << 20)

    def __call__(self, fn, inputs, reps: int, warmup: int = 3,
                 cold: bool = True) -> float:
        torch = self.torch
        held = sum(nbytes_of(t) for t in inputs)
        n = 1 + min(64, -(-2 * self.l2 // max(held, 1))) if cold else 1
        sets = [tuple(inputs)] + [tuple(t.clone() for t in inputs)
                                  for _ in range(n - 1)]
        for i in range(warmup):
            fn(*sets[i % n])
        torch.cuda.synchronize()
        for lead in (2, 8, 32):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            for _ in range(lead):
                self.a @ self.a
            e0.record()
            for i in range(reps):
                fn(*sets[i % n])
            e1.record()
            ahead = not e0.query()
            e1.synchronize()
            if ahead:
                return e0.elapsed_time(e1) / reps
        print("[time] warning: the host did not get ahead of the card; "
              "this time includes launch gaps", flush=True)
        return e0.elapsed_time(e1) / reps


def bound(nbytes: float, flops: float, peak_flops: float) -> tuple:
    """Least time (ms) for the work, and what bounds it."""
    t_b = nbytes / H100_BYTES_PER_S * 1e3
    t_f = flops / peak_flops * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def eq9_gap(torch, X, y, alpha, C, inv_2s2, dev, block=4096) -> float:
    """beta_low - beta_up over ALL samples, with gamma recomputed on the
    card in fp64 blocks and the solver's relative at-bound rule."""
    import numpy as np
    from repro_torch.core import smo
    sv = np.flatnonzero(alpha > 0)
    Xs = torch.as_tensor(X[sv], dtype=torch.float64, device=dev)
    coef = torch.as_tensor(alpha[sv].astype(np.float64) * y[sv], device=dev)
    sn = (Xs * Xs).sum(1)
    gam = torch.empty(X.shape[0], dtype=torch.float64, device=dev)
    for s in range(0, X.shape[0], block):
        xb = torch.as_tensor(X[s: s + block], dtype=torch.float64, device=dev)
        d2 = (xb * xb).sum(1)[:, None] - 2.0 * xb @ Xs.T + sn[None, :]
        gam[s: s + block] = torch.exp(-d2.clamp(min=0.0) * inv_2s2) @ coef
    gam -= torch.as_tensor(y, dtype=torch.float64, device=dev)
    thr0, thr1 = smo.bounds(C)
    a = torch.as_tensor(alpha, device=dev)
    pos = torch.as_tensor(y, device=dev) > 0
    in_up, in_low = smo._sets(a, pos, torch.ones_like(pos), thr0, thr1)
    b_up = torch.where(in_up, gam, float("inf")).min()
    b_low = torch.where(in_low, gam, float("-inf")).max()
    return float(b_low - b_up)


A9A_BUFFER = 32768    # the full-size a9a buffer after full_m_per
W7A_BUFFER = 32768    # the full-size w7a buffer after full_m_per
SRC_RBF_ROWS = "src/repro_torch/kernels/csrc/rbf_rows.cu"
SRC_RBF_ACC = "src/repro_torch/kernels/csrc/rbf_accumulate.cu"
SRC_ELL_ROWS = "src/repro_torch/kernels/csrc/ell_rows.cu"
SRC_ELL_ACC = "src/repro_torch/kernels/csrc/ell_accumulate.cu"
SRC_FLASH = "src/repro_torch/kernels/csrc/flash_attention.cu"
INV = 1.0 / (2.0 * 64.0)          # sigma2 = 64, the paper's a9a / w7a value


def check_dense(torch, np, dev, time_ms, kernels) -> None:
    """The three dense kernels against their plain versions at the a9a
    buffer (32,768 x 123) and a serve bucket (B = 4,096 x ~18k SVs, rows
    padded to 124 features as the serving engine pads them; the split-SV
    contracts of ``check_accumulate_split``; timed at B = 4,096 and B =
    64)."""
    from repro_torch.core.serve import row_width
    from repro_torch.data import make
    from repro_torch.kernels import ops, ref
    X, _, Xt, _ = make("a9a", 1.0, seed=0)
    m, d = A9A_BUFFER, X.shape[1]
    Xb = np.zeros((m, d), np.float32)
    Xb[: min(m, X.shape[0])] = X[:m]
    Xd = torch.as_tensor(Xb, device=dev)
    sq = (Xd * Xd).sum(1)
    g = torch.Generator(device=dev).manual_seed(0)
    gam = torch.randn(m, generator=g, device=dev)
    z2 = Xd[torch.tensor([5, 1000], device=dev)].contiguous()
    coef2 = torch.randn(2, generator=g, device=dev)

    got = ops.fused_gamma_update("rbf", Xd, sq, gam, z2, coef2, INV)
    want = ref.gamma_update(Xd, sq, gam, z2, coef2, INV)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    ins = (Xd, sq, gam, z2, coef2)
    t_k = time_ms(lambda *a: ops.fused_gamma_update("rbf", *a, INV), ins,
                  reps=100)
    t_w = time_ms(lambda *a: ops.fused_gamma_update("rbf", *a, INV), ins,
                  reps=100, cold=False)
    t_p = time_ms(lambda *a: ref.gamma_update(*a, INV), ins, reps=20)
    t_mm = time_ms(lambda x, z: x @ z.T, (Xd, z2), reps=100)
    b_ms, b_by = bound(4.0 * (m * d + 3 * m + 2 * d + 2),
                       m * (4.0 * d + 14.0), H100_FP32_FLOPS)
    kernels["gamma_update"] = dict(
        route="cuda", source=SRC_RBF_ROWS,
        replaces="src/repro/kernels/gamma_update.py:37", max_abs_err=err,
        ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        matmul_ms=t_mm, warm_ms=t_w, shape=f"X {m}x{d}")
    print(f"[check] gamma_update m={m} d={d}: max_abs_err={err:.3e} "
          f"(rtol/atol 1e-4) kernel {t_k*1e3:.2f} us (in L2 {t_w*1e3:.2f}), "
          f"plain {t_p*1e3:.2f} "
          f"us, X@z2.T {t_mm*1e3:.2f} us, bound {b_ms*1e3:.2f} us ({b_by}; "
          f"the kernel at {b_ms / t_k:.2f} of it)", flush=True)

    got = ops.kernel_rows2("rbf", Xd, sq, z2, INV)
    want = ref.kernel_rows2(Xd, sq, z2, INV)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    zz = torch.stack([z2[1], z2[1]])
    same = ops.kernel_rows2("rbf", Xd, sq, zz, INV)
    swap = ops.kernel_rows2("rbf", Xd, sq, z2.flip(0).contiguous(), INV)
    torch.cuda.synchronize()
    if not (torch.equal(same[:, 0], same[:, 1])
            and torch.equal(swap[:, 0], got[:, 1])
            and torch.equal(swap[:, 1], got[:, 0])):
        fail("rbf_rows2 columns are not bitwise position-symmetric")
    ins = (Xd, sq, z2)
    t_k = time_ms(lambda *a: ops.kernel_rows2("rbf", *a, INV), ins,
                  reps=100)
    t_w = time_ms(lambda *a: ops.kernel_rows2("rbf", *a, INV), ins,
                  reps=100, cold=False)
    t_p = time_ms(lambda *a: ref.kernel_rows2(*a, INV), ins, reps=20)
    b_ms, b_by = bound(4.0 * (m * d + m + 2 * d + 2 * m),
                       m * (4.0 * d + 12.0), H100_FP32_FLOPS)
    kernels["rbf_rows2"] = dict(
        route="cuda", source=SRC_RBF_ROWS,
        replaces="src/repro/kernels/rbf_row.py:51", max_abs_err=err,
        ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        matmul_ms=t_mm, warm_ms=t_w, shape=f"X {m}x{d}")
    print(f"[check] rbf_rows2 m={m} d={d}: max_abs_err={err:.3e} "
          f"(rtol 1e-5 / atol 1e-6), columns bitwise position-symmetric; "
          f"kernel {t_k*1e3:.2f} us (in L2 {t_w*1e3:.2f}), plain "
          f"{t_p*1e3:.2f} us, bound {b_ms*1e3:.2f} us ({b_by}; the kernel "
          f"at {b_ms / t_k:.2f} of it)", flush=True)

    B, M = 4096, 18048            # serve bucket; ~18k SVs padded to 128
    w = row_width(d)              # the serving engine's padded rows
    Xs = torch.nn.functional.pad(Xd[:M], (0, w - d)).contiguous()
    sqs = sq[:M].contiguous()
    cf = torch.rand(M, generator=g, device=dev) * 32.0   # positive: no
    Zq = torch.as_tensor(np.resize(Xt, (B, d)), device=dev)  # cancellation
    Zq = torch.nn.functional.pad(Zq, (0, w - d)).contiguous()
    got = ops.rbf_accumulate(Xs, sqs, cf, Zq, INV)
    want = ref.rbf_accumulate(Xs, sqs, cf, Zq, INV)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = float(((got - want).abs() / want.abs()).max())
    if not rel <= 1e-5:
        fail(f"rbf_accumulate relative error {rel:.3e} > 1e-5")
    if not torch.equal(ops.rbf_accumulate(Xs, sqs, cf, Zq, INV), got):
        fail("rbf_accumulate is not identical from run to run")
    acc = lambda X_, s_, c_, Z_: ops.rbf_accumulate(X_, s_, c_, Z_, INV)
    plain = lambda X_, s_, c_, Z_: ref.rbf_accumulate(X_, s_, c_, Z_, INV)
    check_accumulate_split(torch, "rbf_accumulate", acc, plain,
                           (Xs, sqs, cf), Zq)
    ins = (Xs, sqs, cf, Zq)
    t_k = time_ms(lambda *a: ops.rbf_accumulate(*a, INV), ins, reps=10)
    t_w = time_ms(lambda *a: ops.rbf_accumulate(*a, INV), ins, reps=10,
                  cold=False)
    t_64 = time_ms(lambda z: ops.rbf_accumulate(Xs, sqs, cf, z, INV),
                   (Zq[:64].contiguous(),), reps=50)
    t_p = time_ms(lambda *a: ref.rbf_accumulate(*a, INV), ins, reps=5)
    t_mm = time_ms(lambda z, x: z @ x.T, (Zq, Xs), reps=10)
    b_ms, b_by = bound(4.0 * (M * d + 2 * M + B * d + B),
                       2.0 * B * M * d + 6.0 * B * M, H100_FP32_FLOPS)
    kernels["rbf_accumulate"] = dict(
        route="cuda", source=SRC_RBF_ACC,
        replaces="src/repro/kernels/rbf_row.py:103", max_abs_err=err,
        ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        matmul_ms=t_mm, warm_ms=t_w, b64_ms=t_64,
        shape=f"B {B} x M {M} x d {d} (rows padded to {w})")
    print(f"[check] rbf_accumulate B={B} M={M} d={d} (padded to {w}): max "
          f"rel err {rel:.3e} (1e-5), identical across runs; kernel "
          f"{t_k:.4f} ms (in L2 {t_w:.4f}), B=64 {t_64 * 1e3:.2f} us (SVs "
          f"in L2), plain {t_p:.3f} ms, Z@X.T {t_mm:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})", flush=True)


def check_accumulate_split(torch, name, acc, plain, svs, Zq) -> None:
    """The split-SV contracts of an accumulate (SV chunks of 128 rows):
    the same 64 queries give the same bits as a B = 64 bucket and at
    scattered positions of a B = 4,096 bucket; and the first M rows of the
    SVs, M not a multiple of the chunk (1,000) and below one chunk (77),
    agree with the plain version within 1e-5 of max |sum|."""
    B = Zq.shape[0]
    g = torch.Generator(device=Zq.device).manual_seed(9)
    at = torch.randperm(B, generator=g, device=Zq.device)[:64].sort().values
    small = acc(*svs, Zq[at].contiguous())
    if not torch.equal(acc(*svs, Zq)[at], small):
        fail(f"{name}: 64 queries score differently in a B=64 bucket and "
             f"at scattered positions of a B={B} bucket")
    for m in (1000, 77):
        part = tuple(t[:m].contiguous() for t in svs)
        got, want = acc(*part, Zq), plain(*part, Zq)
        rel = float((got - want).abs().max() / want.abs().max())
        if not rel <= 1e-5:
            fail(f"{name} at M={m}: error {rel:.3e} of max |sum| > 1e-5")
    print(f"[check] {name}: 64 queries bitwise equal in a B=64 bucket and "
          f"at scattered positions of B={B}; M=1000 and M=77 within 1e-5 "
          f"of the plain version", flush=True)


def ell_buffer(torch, np, dev, X, m):
    """The w7a training set as a device ELL buffer of ``m`` rows (padding
    rows all (0.0, 0), as the driver builds it), and its CSR form for the
    cuSPARSE yardstick."""
    from repro_torch.core import dataplane
    from repro_torch.data import to_csr, to_ell
    e = to_ell(X)
    n, K = e.vals.shape
    vals = np.zeros((m, K), np.float32)
    cols = np.zeros((m, K), np.int32)
    vals[:n], cols[:n] = e.vals, e.cols
    put = lambda a: torch.as_tensor(a, device=dev)
    data = dataplane.ELLData(put(vals), put(cols),
                             put((vals * vals).sum(1)), X.shape[1])
    c = to_csr(X)
    indptr = np.concatenate([c.indptr, np.full(m - n, c.indptr[-1])])
    spm = torch.sparse_csr_tensor(put(indptr), put(c.indices.astype(np.int64)),
                                  put(c.data), size=(m, X.shape[1]))
    return data, spm


def spmm_ms(torch, time_ms, spm, dense, reps):
    """Device ms of cuSPARSE's ``torch.sparse.mm`` of the same contraction
    (the yardstick; the port never calls it), or None where this build of
    PyTorch cannot run it."""
    try:
        spm @ dense
        return time_ms(lambda a, b: a @ b, (spm, dense), reps=reps)
    except (RuntimeError, NotImplementedError) as e:
        print(f"[check-ell] no cuSPARSE yardstick: {e}", flush=True)
        return None


def ell_bytes(m, K, nnz):
    """Bytes an ELL pass must read of (vals, cols): every val (a zero is
    only known once read), but only the cols of the nonzero slots."""
    return 4.0 * (m * K + nnz)


def ell_rows_bound(m, K, d, nnz, q, gamma):
    """Least time for one ELL row pass: ``ell_bytes``, sq, the queries and
    the outputs (gamma in and out for the update); 2 flops per nonzero and
    query plus a 7-flop epilogue per row and query."""
    nbytes = ell_bytes(m, K, nnz) + 4.0 * (
        m + q * d + (2 * m if gamma else q * m))
    return bound(nbytes, 2.0 * q * nnz + 7.0 * q * m + 4.0 * m * gamma,
                 H100_FP32_FLOPS)


def check_ell_rows(torch, np, dev, time_ms, kernels) -> dict:
    """The three ELL row kernels against their plain versions at the w7a
    buffer (32,768 x K = 128, d = 300), plus a ragged lane budget (K = 13)
    and the budget ``ell_lane = 16`` would build (K = 16, timed), both
    bitwise equal to K = 128, a misaligned copy of vals (the same bits),
    and a large width (d = 16,384: the global-gather branch)."""
    from repro_torch.data import make
    from repro_torch.kernels import ops, ref
    X, _, _, _ = make("w7a", 1.0, seed=0)
    data, spm = ell_buffer(torch, np, dev, X, W7A_BUFFER)
    v, c, s = data.vals, data.cols, data.sq_norms
    m, K = v.shape
    d = X.shape[1]
    nnz = int((v != 0).sum())
    g = torch.Generator(device=dev).manual_seed(2)
    gam = torch.randn(m, generator=g, device=dev)
    gam[X.shape[0]:] = float("inf")               # buffer padding rows
    z2 = data.dense_rows(torch.tensor([5, X.shape[0] // 2], device=dev))
    coef2 = torch.randn(2, generator=g, device=dev)
    shape = f"ELL {m}x{K}, d {d}, nnz {nnz}"
    t_sp = spmm_ms(torch, time_ms, spm, z2.T.contiguous(), reps=100)

    got = ops.ell_fused_gamma_update("rbf", v, c, s, gam, z2, coef2, INV)
    want = ref.ell_gamma_update(v, c, s, gam, z2, coef2, INV)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    if not bool(torch.isinf(got[X.shape[0]:]).all()):
        fail("ell_gamma_update: padding rows lost gamma = +inf")
    fin = torch.isfinite(want)
    err = float((got[fin] - want[fin]).abs().max())
    ins = (v, c, s, gam, z2, coef2)
    t_k = time_ms(lambda *a: ops.ell_fused_gamma_update("rbf", *a, INV),
                  ins, reps=100)
    t_w = time_ms(lambda *a: ops.ell_fused_gamma_update("rbf", *a, INV),
                  ins, reps=100, cold=False)
    t_p = time_ms(lambda *a: ref.ell_gamma_update(*a, INV), ins, reps=20)
    b_ms, b_by = ell_rows_bound(m, K, d, nnz, 2, True)
    kernels["ell_gamma_update"] = dict(
        route="cuda", source=SRC_ELL_ROWS,
        replaces="src/repro/kernels/sparse_ell.py:122", max_abs_err=err,
        ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        spmm_ms=t_sp, warm_ms=t_w, shape=shape)
    print(f"[check-ell] ell_gamma_update m={m} K={K} d={d} nnz={nnz}: "
          f"max_abs_err={err:.3e} (rtol/atol 1e-4), padding rows stay inf; "
          f"kernel {t_k*1e3:.2f} us (in L2 {t_w*1e3:.2f}), plain "
          f"{t_p*1e3:.2f} us, cuSPARSE spmm "
          f"{t_sp if t_sp is None else round(t_sp*1e3, 2)} us, "
          f"bound {b_ms*1e3:.2f} us ({b_by})", flush=True)

    got = ops.ell_kernel_rows2(v, c, s, z2, INV)
    want = ref.ell_kernel_rows2(v, c, s, z2, INV)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    zz = torch.stack([z2[1], z2[1]])
    same = ops.ell_kernel_rows2(v, c, s, zz, INV)
    swap = ops.ell_kernel_rows2(v, c, s, z2.flip(0).contiguous(), INV)
    torch.cuda.synchronize()
    if not (torch.equal(same[:, 0], same[:, 1])
            and torch.equal(swap[:, 0], got[:, 1])
            and torch.equal(swap[:, 1], got[:, 0])):
        fail("ell_kernel_rows2 columns are not bitwise position-symmetric")
    ins = (v, c, s, z2)
    t_k = time_ms(lambda *a: ops.ell_kernel_rows2(*a, INV), ins, reps=100)
    t_w = time_ms(lambda *a: ops.ell_kernel_rows2(*a, INV), ins, reps=100,
                  cold=False)
    t_p = time_ms(lambda *a: ref.ell_kernel_rows2(*a, INV), ins, reps=20)
    b_ms, b_by = ell_rows_bound(m, K, d, nnz, 2, False)
    kernels["ell_kernel_rows2"] = dict(
        route="cuda", source=SRC_ELL_ROWS,
        replaces="src/repro/kernels/sparse_ell.py:96", max_abs_err=err,
        ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        spmm_ms=t_sp, warm_ms=t_w, shape=shape)
    print(f"[check-ell] ell_kernel_rows2 m={m} K={K} d={d}: max_abs_err="
          f"{err:.3e} (rtol 1e-5 / atol 1e-6), columns bitwise "
          f"position-symmetric; kernel {t_k*1e3:.2f} us (in L2 "
          f"{t_w*1e3:.2f}), plain "
          f"{t_p*1e3:.2f} us, bound {b_ms*1e3:.2f} us ({b_by})", flush=True)

    z = z2[0].contiguous()
    got = ops.ell_kernel_row(v, c, s, z, INV)
    want = ref.ell_kernel_row(v, c, s, z, INV)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    ins = (v, c, s, z)
    t_k = time_ms(lambda *a: ops.ell_kernel_row(*a, INV), ins, reps=100)
    t_w = time_ms(lambda *a: ops.ell_kernel_row(*a, INV), ins, reps=100,
                  cold=False)
    t_p = time_ms(lambda *a: ref.ell_kernel_row(*a, INV), ins, reps=20)
    t_sp1 = spmm_ms(torch, time_ms, spm, z[:, None].contiguous(), reps=100)
    b_ms, b_by = ell_rows_bound(m, K, d, nnz, 1, False)
    kernels["ell_kernel_row"] = dict(
        route="cuda", source=SRC_ELL_ROWS,
        replaces="src/repro/kernels/sparse_ell.py:45", max_abs_err=err,
        ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        spmm_ms=t_sp1, warm_ms=t_w, shape=shape)
    print(f"[check-ell] ell_kernel_row m={m} K={K} d={d}: max_abs_err="
          f"{err:.3e} (rtol 1e-5 / atol 1e-6); kernel {t_k*1e3:.2f} us (in "
          f"L2 {t_w*1e3:.2f}), "
          f"plain {t_p*1e3:.2f} us, bound {b_ms*1e3:.2f} us ({b_by})",
          flush=True)

    # ragged lane budget: the same rows at K = 13 (every row has 12)
    v13, c13 = v[:, :13].contiguous(), c[:, :13].contiguous()
    torch.testing.assert_close(
        ops.ell_kernel_rows2(v13, c13, s, z2, INV),
        ref.ell_kernel_rows2(v13, c13, s, z2, INV), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(
        ops.ell_fused_gamma_update("rbf", v13, c13, s, gam, z2, coef2, INV),
        ref.ell_gamma_update(v13, c13, s, gam, z2, coef2, INV),
        rtol=1e-4, atol=1e-4)
    rows128 = ops.ell_kernel_rows2(v, c, s, z2, INV)
    gam128 = ops.ell_fused_gamma_update("rbf", v, c, s, gam, z2, coef2, INV)
    if not torch.equal(ops.ell_kernel_rows2(v13, c13, s, z2, INV), rows128):
        fail("ell_kernel_rows2 at K=13 differs from the same rows at K=128")
    # the lane budget ell_lane = 16 would build: the same bits, and what it
    # would save per pass (sizes the open lane-budget question; the default
    # budget does not change)
    v16, c16 = v[:, :16].contiguous(), c[:, :16].contiguous()
    if not (torch.equal(ops.ell_kernel_rows2(v16, c16, s, z2, INV), rows128)
            and torch.equal(ops.ell_fused_gamma_update(
                "rbf", v16, c16, s, gam, z2, coef2, INV), gam128)):
        fail("ell_kernel_rows2 / ell_gamma_update at K=16 differ from the "
             "same rows at K=128")
    k16 = {}
    for name, fn, ins in (
            ("ell_gamma_update", lambda *a: ops.ell_fused_gamma_update(
                "rbf", *a, INV), (v16, c16, s, gam, z2, coef2)),
            ("ell_kernel_rows2", lambda *a: ops.ell_kernel_rows2(*a, INV),
             (v16, c16, s, z2))):
        k16[name] = (time_ms(fn, ins, reps=100),
                     time_ms(fn, ins, reps=100, cold=False))
        kernels[name]["k16_ms"], kernels[name]["k16_warm_ms"] = k16[name]
    # a misaligned vals (base one float past an aligned one): 4-byte loads,
    # the same bits
    flat = torch.empty(m * K + 1, device=dev)
    flat[1:] = v.reshape(-1)
    vm = flat[1:].view(m, K)
    if not (torch.equal(ops.ell_kernel_rows2(vm, c, s, z2, INV), rows128)
            and torch.equal(ops.ell_fused_gamma_update(
                "rbf", vm, c, s, gam, z2, coef2, INV), gam128)
            and torch.equal(ops.ell_kernel_row(vm, c, s, z, INV),
                            ops.ell_kernel_row(v, c, s, z, INV))):
        fail("the ELL row kernels differ on a misaligned copy of vals")
    print("[check-ell] K=16 (what ell_lane=16 would build): bitwise equal "
          "to K=128; " + ", ".join(
              f"{k} {a * 1e3:.2f} us (in L2 {b * 1e3:.2f})"
              for k, (a, b) in k16.items())
          + "; a misaligned vals (base + 4 bytes) gives the same bits",
          flush=True)
    del flat, vm
    # large width: queries beyond shared memory, gathered from global
    bv, bc, bs = ragged_ell(torch, dev, 8192, 128, 16384, seed=3)
    # small queries keep the distances O(|x|^2), so K is not 0
    bz = torch.randn(2, 16384, generator=g, device=dev) * 0.05
    torch.testing.assert_close(ops.ell_kernel_rows2(bv, bc, bs, bz, INV),
                               ref.ell_kernel_rows2(bv, bc, bs, bz, INV),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ops.ell_kernel_row(bv, bc, bs, bz[0], INV),
                               ref.ell_kernel_row(bv, bc, bs, bz[0], INV),
                               rtol=1e-5, atol=1e-6)
    bg = torch.randn(bv.shape[0], generator=g, device=dev)
    torch.testing.assert_close(
        ops.ell_fused_gamma_update("rbf", bv, bc, bs, bg, bz, coef2, INV),
        ref.ell_gamma_update(bv, bc, bs, bg, bz, coef2, INV),
        rtol=1e-4, atol=1e-4)
    print("[check-ell] ragged K=13 (rows bitwise equal to K=128) and "
          "d=16384 (global gathers, 8192 rows): all three row kernels "
          "within tolerance", flush=True)
    return data


def ragged_ell(torch, dev, m, K, d, seed):
    """Random ELL rows with a random occupied prefix (<= K slots) each,
    columns in [0, d); padding slots (0.0, 0)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ext = torch.randint(0, K + 1, (m, 1), generator=g, device=dev)
    live = torch.arange(K, device=dev)[None, :] < ext
    vals = torch.where(live, torch.randn(m, K, generator=g, device=dev), 0.0)
    cols = torch.where(live, torch.randint(0, d, (m, K), generator=g,
                                           device=dev), 0).to(torch.int32)
    return vals.contiguous(), cols.contiguous(), (vals * vals).sum(1)


def check_ell_accumulate(torch, np, dev, time_ms, kernels, model,
                         Xt) -> None:
    """``ell_rbf_accumulate`` against its plain version at B = 4,096 query
    rows x the trained model's ELL support vectors (w7a), with the
    split-SV contracts (``check_accumulate_split``) and the same SVs
    re-laid at the smallest K that holds them (bitwise equal), timed at B
    = 4,096 and B = 64; and at d = 16,384 (queries gathered from global
    memory)."""
    from repro_torch.kernels import ops, ref
    eng = model.serve_engine()
    data, coef = eng._data, eng._coef
    v, c, s = data.vals, data.cols, data.sq_norms
    M, K = v.shape
    Zq = torch.as_tensor(np.resize(Xt, (4096, Xt.shape[1])), device=dev)
    B, d = Zq.shape
    inv = model.config.inv_2s2
    nnz = int((v != 0).sum())
    got = ops.ell_rbf_accumulate(v, c, s, coef, Zq, inv)
    want = ref.ell_rbf_accumulate(v, c, s, coef, Zq, inv)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    if not rel <= 1e-5:
        fail(f"ell_rbf_accumulate error {rel:.3e} of max |sum| > 1e-5")
    again = ops.ell_rbf_accumulate(v, c, s, coef, Zq, inv)
    if not torch.equal(again, got):
        fail("ell_rbf_accumulate is not identical from run to run")
    acc = lambda v_, c_, s_, f_, Z_: ops.ell_rbf_accumulate(v_, c_, s_, f_,
                                                            Z_, inv)
    plain = lambda v_, c_, s_, f_, Z_: ref.ell_rbf_accumulate(v_, c_, s_,
                                                              f_, Z_, inv)
    check_accumulate_split(torch, "ell_rbf_accumulate", acc, plain,
                           (v, c, s, coef), Zq)
    # the same SVs re-laid at the smallest K that holds every nonzero
    ext = int(((v != 0) * torch.arange(1, K + 1, device=dev)).amax())
    small_k = ops.ell_rbf_accumulate(v[:, :ext].contiguous(),
                                     c[:, :ext].contiguous(), s, coef, Zq,
                                     inv)
    if not torch.equal(small_k, got):
        fail(f"ell_rbf_accumulate: the SVs re-laid at K={ext} score "
             f"differently from K={K}")
    ins = (v, c, s, coef, Zq)
    t_k = time_ms(lambda *a: ops.ell_rbf_accumulate(*a, inv), ins, reps=10)
    t_w = time_ms(lambda *a: ops.ell_rbf_accumulate(*a, inv), ins, reps=10,
                  cold=False)
    t_64 = time_ms(lambda z: ops.ell_rbf_accumulate(v, c, s, coef, z, inv),
                   (Zq[:64].contiguous(),), reps=50)
    t_p = time_ms(lambda *a: ref.ell_rbf_accumulate(*a, inv), ins, reps=3)
    sv_dense = np.zeros((M, d), np.float32)
    sv_dense[: model.stats.n_sv] = model._sv_dense()
    spm_sv = torch.as_tensor(sv_dense, device=dev).to_sparse_csr()
    t_sp = spmm_ms(torch, time_ms, spm_sv, Zq.T.contiguous(), reps=10)
    nbytes = ell_bytes(M, K, nnz) + 4.0 * (2 * M + B * d + B)
    flops = 2.0 * B * nnz + 10.0 * B * M + 2.0 * B * d
    b_ms, b_by = bound(nbytes, flops, H100_FP32_FLOPS)
    kernels["ell_rbf_accumulate"] = dict(
        route="cuda", source=SRC_ELL_ACC,
        replaces="src/repro/kernels/rbf_row.py:163", max_abs_err=err,
        ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        spmm_ms=t_sp, warm_ms=t_w, b64_ms=t_64,
        shape=f"B {B} x ELL SVs {M}x{K}, d {d}, nnz {nnz}")
    print(f"[check-ell] ell_rbf_accumulate B={B} M={M} K={K} d={d} "
          f"nnz={nnz}: max err {rel:.3e} of max |sum| (1e-5), identical "
          f"across runs and bitwise equal at K={ext}; kernel {t_k:.4f} ms "
          f"(in L2 {t_w:.4f}), B=64 {t_64 * 1e3:.2f} us (SVs in L2), plain "
          f"{t_p:.3f} ms, cuSPARSE "
          f"spmm {t_sp if t_sp is None else round(t_sp, 4)} ms, bound "
          f"{b_ms*1e3:.2f} us ({b_by})", flush=True)
    g = torch.Generator(device=dev).manual_seed(4)
    bv, bc, bs = ragged_ell(torch, dev, 2048, 128, 16384, seed=5)
    bcoef = torch.randn(bv.shape[0], generator=g, device=dev)
    bZ = torch.randn(256, 16384, generator=g, device=dev) * 0.05
    got = ops.ell_rbf_accumulate(bv, bc, bs, bcoef, bZ, inv)
    want = ref.ell_rbf_accumulate(bv, bc, bs, bcoef, bZ, inv)
    torch.cuda.synchronize()
    rel = float((got - want).abs().max() / want.abs().max())
    if not rel <= 1e-5:
        fail(f"ell_rbf_accumulate at d=16384: error {rel:.3e} > 1e-5")
    print(f"[check-ell] ell_rbf_accumulate d=16384 (global gathers, 256 "
          f"queries x 2048 SVs): max err {rel:.3e} of max |sum| (1e-5)",
          flush=True)


# -- LM serving (flash attention) -------------------------------------------

LM_ARCH = "llama3-8b"          # the serving CLI's default arch
LM_BATCH, LM_PROMPT, LM_NEW = 4, 1024, 32
LM_DECODE_CHECK = 256          # prompt tokens decoded one by one at bf16


def attn_work(B, H, Hkv, L, Dh) -> tuple:
    """(bytes, flops) of one causal bf16 attention call: q, k, v read and
    out written once; 4·Dh flops (two products) per (query, key) pair the
    mask keeps, L(L+1)/2 of them per head."""
    return 2.0 * (2 * B * H * L * Dh + 2 * B * Hkv * L * Dh), \
        4.0 * B * H * Dh * (L * (L + 1) // 2)


def check_attention(torch, dev, time_ms, kernels) -> None:
    """``flash_attention`` against its plain version (``ref.flash_attention``)
    at the llama3-8b prefill shapes (B 4, H 32, Hkv 8, Dh 128, bf16, causal;
    L 2,048 and the serving phase's 1,024), a ragged L = 1,000, fp32 at Dh
    128 and L 1,024, the fp32 GQA and MHA shapes of the reference's kernel
    tests, a bf16 one and a ragged non-causal one; and for the bf16 body's
    128-row tiles, L = 129 (one row past a tile) with GQA 4 and a
    non-causal Lq = 130 over Lk = 300. Tolerances: 2e-5 fp32
    (rtol and atol); bf16 rtol 2e-2 (the reference's) with atol 2e-3, a
    tenth of the reference's, since most causal rows at L >= 1,000 have
    outputs of a few hundredths. Each case also prints max |err| over
    max |want|; the timed shapes print their TFLOP/s and the share of the
    bound the kernel reaches."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device=dev).manual_seed(7)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(4, 32, 8, 2048, 2048, 128, bf16, True),
             (4, 32, 8, 1024, 1024, 128, bf16, True),
             (2, 32, 8, 1000, 1000, 128, bf16, True),
             (1, 32, 8, 1024, 1024, 128, f32, True),
             (1, 4, 4, 128, 128, 32, f32, True),
             (2, 4, 2, 256, 256, 64, f32, True),
             (1, 8, 1, 256, 256, 64, f32, True),
             (2, 4, 2, 128, 128, 64, bf16, True),
             (1, 2, 2, 128, 200, 32, f32, False),
             (2, 32, 8, 129, 129, 128, bf16, True),
             (2, 8, 2, 130, 300, 128, bf16, False)]
    timed = {}
    for B, H, Hkv, Lq, Lk, Dh, dt, causal in cases:
        mk = lambda *s: torch.randn(*s, generator=g, device=dev).to(dt)
        q, k, v = mk(B, H, Lq, Dh), mk(B, Hkv, Lk, Dh), mk(B, Hkv, Lk, Dh)
        got = ops.flash_attention(q, k, v, causal)
        want = ref.flash_attention(q, k, v, causal)
        torch.cuda.synchronize()
        rtol, atol = (2e-2, 2e-3) if dt == bf16 else (2e-5, 2e-5)
        err = float((got.float() - want.float()).abs().max())
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol)
        print(f"[check-attn] B={B} H={H} Hkv={Hkv} Lq={Lq} Lk={Lk} Dh={Dh} "
              f"{str(dt)[6:]} causal={causal}: max_abs_err={err:.3e}, "
              f"of max |want| {rel_err(got, want):.3e} (rtol {rtol:g}, "
              f"atol {atol:g})", flush=True)
        if dt == bf16 and Dh == 128 and Lq in (2048, 1024):
            timed[Lq] = (q, k, v, err)
    for L, (q, k, v, err) in sorted(timed.items(), reverse=True):
        ins = (q, k, v)
        t_k = time_ms(lambda *a: ops.flash_attention(*a, True), ins, reps=10)
        t_w = time_ms(lambda *a: ops.flash_attention(*a, True), ins, reps=10,
                      cold=False)
        t_p = time_ms(lambda *a: ref.flash_attention(*a, True), ins, reps=3)
        t_lib = time_ms(lambda *a: F.scaled_dot_product_attention(
            *a, is_causal=True, enable_gqa=True), ins, reps=20)
        nbytes, flops = attn_work(*q.shape[:2], k.shape[1], L, q.shape[3])
        b_ms, b_by = bound(nbytes, flops, H100_BF16_FLOPS)
        print(f"[check-attn] flash_attention B={q.shape[0]} H={q.shape[1]} "
              f"Hkv={k.shape[1]} L={L} Dh=128 bf16 causal: kernel "
              f"{t_k:.3f} ms (repeated inputs {t_w:.3f}), plain {t_p:.3f} ms, "
              f"SDPA {t_lib:.3f} ms, bound {b_ms * 1e3:.1f} us ({b_by}: "
              f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), "
              f"{flops / t_k / 1e9:.1f} TFLOP/s, {b_ms / t_k:.3f} of the "
              f"bound", flush=True)
        if L == 2048:
            kernels["flash_attention"] = dict(
                route="cuda", source=SRC_FLASH,
                replaces="src/repro/kernels/flash_attention.py:72",
                max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=b_ms,
                bound_by=b_by, library_ms=t_lib, warm_ms=t_w,
                shape=f"B 4 H 32 Hkv 8 L {L} Dh 128 bf16 causal",
                serve_shape_ms=None)
        else:
            kernels["flash_attention"]["serve_shape_ms"] = t_k


def rel_err(a, b) -> float:
    """max |a - b| over max |b|, in fp32."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max())


@contextlib.contextmanager
def plain_attention():
    """The model's attention swapped for the plain path the reference takes
    without the kernel (``blockwise_attention`` at a causal L that is a
    multiple of 512 above it, else ``ref.mha``), for the flash-vs-plain
    gates only; restored on exit."""
    from repro_torch.kernels import ref
    from repro_torch.models import common
    kernel_path = common.attention

    def plain(q, k, v, *, causal=True):
        L = q.shape[1]
        if causal and L == k.shape[1] and L > 512 and L % 512 == 0:
            return common.blockwise_attention(q, k, v, 512)
        return ref.mha(q, k, v, causal=causal)

    common.attention = plain
    try:
        yield
    finally:
        common.attention = kernel_path


def decode_built_logits(torch, model, cfg, params, prompts):
    """Last-position logits of the cache built the reference example's way:
    one-token decode over the whole prompt."""
    B, L = prompts.shape
    cache = model.init_cache(cfg, B, L, prompts.device)
    logits = None
    for t in range(L):
        logits, cache = model.decode(params, cfg, cache,
                                     {"tokens": prompts[:, t: t + 1]})
    return logits[:, -1]


def serve_lm(torch, dev) -> dict:
    """The LM serving path: full ``llama3-8b`` in bf16 with the flash
    kernel, 4 requests x (1,024 prompt + 32 new tokens) through
    ``launch.serve.generate``; then the full width at 2 layers in fp32
    for the flash-vs-plain and decode-vs-prefill gates."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.kernels import cuda
    from repro_torch.launch import serve
    from repro_torch.models.api import build

    phase("serve-lm")
    cfg = configs.full_config(LM_ARCH)
    model = build(cfg)
    t0 = time.perf_counter()
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_par = sum(w.numel() for w in params["layers"].values()) + sum(
        params[k].numel() for k in ("ln_f", "unembed", "embed"))
    g = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=g, device=dev, dtype=torch.int32)
    serve.generate(params, cfg, prompts, 2)          # warm-up (cuBLAS, ...)
    cuda.reset_launches()
    res = serve.generate(params, cfg, prompts, LM_NEW)
    launches = {"flash_attention": cuda.launches["flash_attention"]}
    toks = res["tokens"]
    steps = LM_NEW - 1
    print(f"[serve-lm] {cfg.name} full size: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads (kv {cfg.n_kv_heads}), d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {n_par / 1e9:.3f} B params "
          f"{cfg.dtype} (init {t_init:.1f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB); "
          f"{LM_BATCH} requests x {LM_PROMPT} prompt + {LM_NEW} new tokens: "
          f"prefill {res['prefill_s'] * 1e3:.1f} ms "
          f"({LM_BATCH * LM_PROMPT / res['prefill_s']:.0f} prompt tok/s), "
          f"decode {res['decode_s'] * 1e3 / steps:.2f} ms/token-step "
          f"({LM_BATCH * steps / res['decode_s']:.1f} tok/s), end to end "
          f"{LM_BATCH * LM_NEW / (res['prefill_s'] + res['decode_s']):.1f} "
          f"new tok/s; flash_attention launches="
          f"{launches['flash_attention']} (prefill: one per layer)",
          flush=True)
    if launches["flash_attention"] != cfg.n_layers:
        fail(f"serving launched flash_attention "
             f"{launches['flash_attention']} times, not once per layer "
             f"({cfg.n_layers})")
    if not (toks.shape == (LM_BATCH, LM_NEW) and int(toks.min()) >= 0
            and int(toks.max()) < cfg.vocab_size):
        fail(f"generated ids {tuple(toks.shape)} outside [0, "
             f"{cfg.vocab_size})")
    batch = {"tokens": prompts}
    flash, _ = model.forward(params, cfg, batch)
    last = flash[:, -1].float()
    del flash
    if not bool(torch.isfinite(last).all()):
        fail("prefill logits are not finite")
    with plain_attention():
        plain, _ = model.forward(params, cfg, batch)
    plain_last = plain[:, -1].float()
    del plain
    # the decode-built cache over a prefix (1,024 full-depth steps would
    # add ~40 s): against the prefill of the same prefix
    pre = prompts[:, :LM_DECODE_CHECK]
    pre_last = model.forward(params, cfg, {"tokens": pre})[0][:, -1]
    t0 = time.perf_counter()
    dec_last = decode_built_logits(torch, model, cfg, params, pre)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    print(f"[serve-lm] bf16 full depth (printed, not gated): last-position "
          f"logits flash vs plain blockwise {rel_err(last, plain_last):.3e}, "
          f"decode-built cache ({LM_DECODE_CHECK} one-token steps, "
          f"{t_dec:.1f} s) vs prefill of the same {LM_DECODE_CHECK} tokens "
          f"{rel_err(dec_last, pre_last):.3e} of max |logit|; greedy ids "
          f"equal flash/plain "
          f"{float((last.argmax(-1) == plain_last.argmax(-1)).float().mean()):.2f}"
          f", sample {toks[0, :8].tolist()}", flush=True)
    del params, res, last, plain_last, pre_last, dec_last
    torch.cuda.empty_cache()

    phase("serve-lm-fp32")
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    params = model.init(cfg32, torch.Generator(device=dev).manual_seed(2))
    cuda.reset_launches()
    flash, _ = model.forward(params, cfg32, batch)
    n_fa = cuda.launches["flash_attention"]
    with plain_attention():
        plain, _ = model.forward(params, cfg32, batch)
    e_flash = rel_err(flash, plain)
    last = flash[:, -1].clone()
    del flash, plain
    dec_last = decode_built_logits(torch, model, cfg32, params, prompts)
    e_dec = rel_err(dec_last, last)
    print(f"[serve-lm-fp32] {cfg.name} width, 2 layers, fp32, {LM_BATCH} x "
          f"{LM_PROMPT} tokens: prefill logits flash vs plain blockwise "
          f"{e_flash:.3e} of max |logit| (<= 1e-4); last-position logits "
          f"of the decode-built cache vs prefill {e_dec:.3e} (<= 5e-3); "
          f"flash_attention launches={n_fa}", flush=True)
    if not (n_fa == 2 and e_flash <= 1e-4 and e_dec <= 5e-3):
        fail(f"fp32 gates: launches {n_fa}, flash vs plain {e_flash:.3e}, "
             f"decode vs prefill {e_dec:.3e}")
    del params, last, dec_last
    torch.cuda.empty_cache()
    return launches


# the kernel each phase of a main path must launch: (train, wss2, serve)
HOT = {"dense": ("gamma_update", "rbf_rows2", "rbf_accumulate"),
       "ell": ("ell_gamma_update", "ell_kernel_rows2", "ell_rbf_accumulate")}


def run_path(torch, np, dev, time_ms, dataset, fmt) -> tuple:
    """One main path through the entry points a user calls: a full-size
    fit of ``dataset`` (C=32, sigma2=64, multi5pc, wss1) to convergence, a
    Single-policy wss2 fit at scale 0.2, and ``SVMModel.predict`` over the
    test rows. ``fmt='dense'`` feeds numpy rows; ``fmt='ell'`` feeds CSR to
    ``format='ell'`` training and serving. Launch counts are reset just
    before each phase and read just after it. Returns the trained model,
    the launches of each phase's kernel and the test rows."""
    from repro_torch.core import SVMConfig, SMOSolver
    from repro_torch.data import make, to_csr
    from repro_torch.kernels import cuda
    sfx = "" if fmt == "dense" else "-ell"
    feed = (lambda a: a) if fmt == "dense" else to_csr
    fed = "" if fmt == "dense" else " CSR in"
    k_train, k_wss2, k_serve = HOT[fmt]
    kw = dict(C=32.0, sigma2=64.0, heuristic="multi5pc", selection="wss1",
              device="cuda", **({} if fmt == "dense" else {"format": "ell"}))
    launches = {}

    phase("train" + sfx)
    X, y, Xt, yt = make(dataset, 1.0, seed=0)
    Xf, Xtf = feed(X), feed(Xt)
    cuda.reset_launches()
    t0 = time.perf_counter()
    model = SMOSolver(SVMConfig(**kw)).fit(Xf, y)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches[k_train] = cuda.launches[k_train]
    st = model.stats
    gap = eq9_gap(torch, X, y, model.alpha, 32.0, INV, dev)
    acc = float((model.predict(Xtf) == yt).mean())
    lanes = (f"nnz/row={(X != 0).sum() / X.shape[0]:.1f} buffer_K="
             f"{st.buffer_K} " if fmt == "ell" else "")
    print(f"[train{sfx}] {dataset} n={X.shape[0]} d={X.shape[1]}{fed}: "
          f"iterations={st.iterations} dispatches={st.dispatches} "
          f"compactions={st.compactions} "
          f"reconstructions={st.reconstructions} rechecks={st.eq9_rechecks}"
          f" {lanes}buffer_sizes={st.buffer_sizes} SVs={st.n_sv} "
          f"converged={st.converged} eq9_gap_all={gap:.3e} (<= 2eps 2e-03) "
          f"wall={wall:.1f} s us/iter="
          f"{1e6 * st.train_time / max(st.iterations, 1):.1f} "
          f"test_accuracy={acc:.4f} {k_train} launches={launches[k_train]}",
          flush=True)
    if launches[k_train] <= 0:
        fail(f"training did not launch {k_train}")
    if not (st.converged and gap <= 2e-3):
        fail(f"training: converged={st.converged}, gap {gap:.3e}")

    # The Single policy's last phase ends without a reconstruction, so its
    # verdict is the one the driver rechecks on recomputed gamma.
    phase("wss2" + sfx)
    X2, y2, _, _ = make(dataset, 0.2, seed=0)
    cuda.reset_launches()
    t0 = time.perf_counter()
    m2 = SMOSolver(SVMConfig(**dict(kw, selection="wss2",
                                    heuristic="single5pc"))).fit(
        feed(X2), y2)
    torch.cuda.synchronize()
    launches[k_wss2] = cuda.launches[k_wss2]
    s2 = m2.stats
    gap2 = eq9_gap(torch, X2, y2, m2.alpha, 32.0, INV, dev)
    print(f"[wss2{sfx}] {dataset} scale 0.2 n={X2.shape[0]} single5pc{fed}: "
          f"iterations={s2.iterations} reconstructions={s2.reconstructions} "
          f"rechecks={s2.eq9_rechecks} converged={s2.converged} "
          f"eq9_gap_all={gap2:.3e} (<= 2eps 2e-03) SVs={s2.n_sv} "
          f"wall={time.perf_counter() - t0:.1f} s "
          f"{k_wss2} launches={launches[k_wss2]}", flush=True)
    if launches[k_wss2] <= 0:
        fail(f"wss2 fit did not launch {k_wss2}")
    if not (s2.converged and gap2 <= 2e-3):
        fail(f"wss2 fit: converged={s2.converged}, gap {gap2:.3e}")

    phase("serve" + sfx)
    cuda.reset_launches()
    t0 = time.perf_counter()
    pred = model.predict(Xtf)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    launches[k_serve] = cuda.launches[k_serve]
    scores = model.decision_function(Xtf)
    host = model.decision_function_host(Xtf)
    serr = float(np.abs(scores - host).max() / np.abs(host).max())
    acc = float((pred == yt).mean())
    eng = model.serve_engine()
    print(f"[serve{sfx}] {Xt.shape[0]} test rows{fed}, {st.n_sv} SVs "
          f"({eng.describe()}, {eng.memory_bytes()} resident bytes): "
          f"accuracy={acc:.4f} predict wall={t_pred:.3f} s "
          f"max|score-host|/max|host|={serr:.3e} (<= 1e-4) "
          f"max|score|={np.abs(scores).max():.3f} (> 0.5) "
          f"{k_serve} launches={launches[k_serve]}", flush=True)
    if launches[k_serve] <= 0:
        fail(f"predict did not launch {k_serve}")
    if not (serr <= 1e-4 and np.abs(scores).max() > 0.5):
        fail("serving scores disagree with the host loop or are degenerate")
    # the resident SVs stay in L2 from bucket to bucket, as they do for a
    # serving engine under load; only the query buckets rotate
    per_bucket = {}
    b = eng.min_bucket
    while b <= eng.max_bucket:
        zb = np.zeros((b, eng.width), np.float32)   # the engine's padding
        zb[:, : Xt.shape[1]] = np.resize(Xt, (b, Xt.shape[1]))
        zb = torch.as_tensor(zb, device=dev)
        per_bucket[b] = time_ms(eng.score_bucket, (zb,), reps=20) * 1e3 / b
        b *= 2
    # where a warm predict's time goes (the engine is built by now): its
    # wall time, then one more predict traced for its device time
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        model.predict(Xtf)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    # each bucket is two kernels: the chunks' partials, then their sum
    split = predict_device_time(torch, lambda: model.predict(Xtf),
                                2 * launches[k_serve])
    print(f"[serve{sfx}] device us/query by bucket: " + ", ".join(
        f"{b}: {v:.3f}" for b, v in per_bucket.items()) + "; warm predict "
        f"{sorted(walls)[1] * 1e3:.3f} ms wall (median of 3); " + split,
        flush=True)
    return model, launches, Xt


def predict_device_time(torch, predict, n_acc_want) -> str:
    """One ``predict()`` under ``torch.profiler`` (after one traced as the
    profiler's warm-up and dropped): its wall time there and the device
    time of its kernels (the accumulates and the rest) and copies, summed
    per launch from the trace; the remainder of the wall time is the
    host's (densify, Python, launches, waits). A trace that holds another
    count of accumulate kernels than ``n_acc_want`` is reported as
    incomplete, with no device time."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            t0 = time.perf_counter()
            predict()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            prof.step()
    acc = copy = other = 0.0
    n_acc = 0
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.name.startswith("ProfilerStep")):  # the step's span
            continue
        ms = e.time_range.elapsed_us() / 1e3
        if "accumulate_chunks" in e.name or "chunk_sum::" in e.name:
            acc, n_acc = acc + ms, n_acc + 1
        elif e.name.startswith(("Memcpy", "Memset")):
            copy += ms
        else:
            other += ms
    busy = acc + copy + other
    if n_acc != n_acc_want:
        return (f"traced predict {wall:.3f} ms wall; device time not "
                f"measured (the trace holds {n_acc} of its {n_acc_want} "
                f"accumulate kernels)")
    return (f"traced predict {wall:.3f} ms wall: device {busy:.3f} ms "
            f"({busy / wall:.1%}) = accumulate kernels {acc:.3f} ms "
            f"({n_acc} launches) + copies {copy:.3f} ms + other kernels "
            f"{other:.3f} ms; host {wall - busy:.3f} ms")


def row_path(torch, dev, data) -> dict:
    """One ``ELLKernelRowProvider.row`` over the w7a buffer (no training or
    serving path calls it; the provider API does): ``ell_kernel_row``,
    held against the plain version and, bitwise, against column 0 of
    ``rows2([z; z])``."""
    from repro_torch.core import kernel_fns
    from repro_torch.kernels import cuda, ref
    phase("row-ell")
    provider = kernel_fns.make_provider("rbf", "ell", True, INV)
    z = data.dense_rows(torch.tensor([77], device=dev))[0]
    cuda.reset_launches()
    row = provider.row(data, z)
    torch.cuda.synchronize()
    launches = {"ell_kernel_row": cuda.launches["ell_kernel_row"]}
    plain = ref.ell_kernel_row(data.vals, data.cols, data.sq_norms, z, INV)
    via2 = kernel_fns.row_via_rows2(provider, data, z)
    err = float((row - plain).abs().max())
    torch.testing.assert_close(row, plain, rtol=1e-5, atol=1e-6)
    print(f"[row-ell] ELLKernelRowProvider.row over the w7a buffer "
          f"({data.m}x{data.K}): max_abs_err={err:.3e} vs plain (rtol 1e-5 "
          f"/ atol 1e-6), bitwise equal to rows2([z; z])[:, 0]: "
          f"{torch.equal(row, via2)}; ell_kernel_row launches="
          f"{launches['ell_kernel_row']}", flush=True)
    if not torch.equal(row, via2):
        fail("ELLKernelRowProvider.row differs from rows2([z; z])[:, 0]")
    if launches["ell_kernel_row"] <= 0:
        fail("ELLKernelRowProvider.row did not launch ell_kernel_row")
    return launches


def main() -> None:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    from repro_torch import device as devmod
    from repro_torch.kernels import cuda

    dev = devmod.resolve("cuda")
    card = card_line()
    t_all = time.perf_counter()
    time_ms = DeviceTimer(torch, dev)

    phase("build")
    t0 = time.perf_counter()
    rep = cuda.build()
    t_build = time.perf_counter() - t0
    print(f"[build] {len(rep)} libraries in {t_build:.1f} s "
          f"({', '.join(f'{k}: {v['seconds']:.1f} s' for k, v in rep.items())})",
          flush=True)
    for name, r in rep.items():
        for line in r["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)
    print(f"[time] kernel times are device times with the inputs out of L2 "
          f"({time_ms.l2 / 2**20:.0f} MiB on this card)", flush=True)

    kernels = {}
    phase("check")
    check_dense(torch, np, dev, time_ms, kernels)
    phase("check-ell")
    w7a_buffer = check_ell_rows(torch, np, dev, time_ms, kernels)
    phase("check-attn")
    check_attention(torch, dev, time_ms, kernels)

    launches = serve_lm(torch, dev)
    _, dense_launches, _ = run_path(torch, np, dev, time_ms, "a9a", "dense")
    launches.update(dense_launches)
    model, ell_launches, Xt = run_path(torch, np, dev, time_ms, "w7a", "ell")
    launches.update(ell_launches)
    phase("check-ell")
    check_ell_accumulate(torch, np, dev, time_ms, kernels, model, Xt)
    launches.update(row_path(torch, dev, w7a_buffer))

    phase("report")
    record = []
    for name, k in kernels.items():
        record.append(dict(name=name, **{key: k[key] for key in (
            "route", "source", "replaces")}, launches=launches[name],
            **{key: k[key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")},
            **{key: k[key] for key in ("matmul_ms", "spmm_ms", "warm_ms",
                                       "b64_ms", "k16_ms", "k16_warm_ms",
                                       "serve_shape_ms", "shape")
               if key in k}, card=card))
    print(f"[done] total {time.perf_counter() - t_all:.1f} s", flush=True)
    print(json.dumps({"kernels": record}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def run() -> None:
    """``main`` with every failure reported on standard output: the phase
    and the traceback, then a non-zero exit (nothing is caught and carried
    on)."""
    try:
        main()
    except Exception:
        print(f"FAIL [{PHASE}]: uncaught exception", flush=True)
        traceback.print_exc(file=sys.stdout)
        sys.stdout.flush()
        sys.exit(1)


if __name__ == "__main__":
    run()
