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
* LM serving of the other families, each the same 4 x (1,024 + 32)
  through ``generate`` in bf16: ``phi3.5-moe-42b-a6.6b`` at full width,
  cut to 24 of its 32 layers to fit the card (``[serve-moe]``: flash once
  a layer, the capacity drops printed; at 2 layers in fp32 'scatter' ==
  'einsum', flash == plain, and with capacity factor E/k the decode-built
  cache continues as the prefill-filled one does), ``zamba2-1.2b`` uncut
  (``[serve-zamba]``: flash once per shared-block invocation, 6; at 2
  groups in fp32 flash == plain and the same cache gate) and
  ``xlstm-125m`` uncut (``[serve-xlstm]``: no kernel; the cache gate in
  fp32);
* LM training: ``llama3-8b`` at full width cut to 8 of its 32 layers
  (bf16 params, grads and fp32 AdamW moments of all 32 would not fit the
  card), remat full, through ``launch.train.train``: one warm-up and 10
  timed steps of 4 x 1,024 tokens, the flash kernel twice a layer a step
  (the forward and the remat recompute; the backward recomputes the plain
  attention), finite falling losses, every leaf updated
  (``[train-lm]``); at 2 layers in fp32 the loss gradient with the kernel
  against the plain attention's (``[train-lm-fp32]``);
* sharded LM training (``launch.train_lib.MeshStep``) at the same width,
  2 of 32 layers, on an NCCL group of one rank: (1, 1) meshes under the
  tp and fsdp layouts, ``gather_params_once`` off and on, accumulation 1
  and 2, and the (1, 1, 1) pod mesh with each gradient codec, every run
  bitwise equal to the unsharded step (the codecs' residuals to
  ``optim.compress``), collectives equal to the step's plan, and a
  sharded save restored on another mesh (``[train-lm-mesh]``); the
  tensor-parallel step (the 'model' axis splitting heads, FFN width and
  vocabulary) at 2 layers on a (1, 2) tp mesh of two processes sharing
  the card in a gloo group, fp32 against the unsharded step at the
  train-step tolerance, bf16 ms a step and peak memory a rank beside the
  unsharded step's, collectives equal to the plan, and on the same two
  ranks the fsdp layout (a 2-way FSDP) at 4 layers, one step with the
  per-layer gather and one with ``gather_params_once`` from the same
  state, bitwise equal, the per-layer peak a rank at least 3 GiB lower,
  then zamba2-1.2b at 7 of 38 layers and xlstm-125m at 5 of 12, full
  width, split over 'model' by heads (fp32 against the unsharded step's
  exact value, bf16 ms and peak a rank beside the unsharded step's,
  zamba2's flash launches, collectives equal to the plan)
  (``[train-lm-tp]``); on the same two ranks the sharded serving step
  (``MeshServe``: prefill into each rank's block of the KV cache, then
  greedy decode), llama3-8b and phi3.5-moe at 2 layers in fp32 against
  the unsharded step's logits and tokens, llama3-8b at 4 layers and
  phi3.5-moe at 2 in bf16, ms a prefill, ms a decode step and peak memory
  a rank beside the unsharded step's, the fp32 tp train step and
  prefill with ``seq_parallel`` against without it, and zamba2-1.2b and
  xlstm-125m as ``[train-lm-tp]`` cuts them: fp32 against the unsharded
  step's exact (fp64) logits on (1, 2) and at one row on a (2, 1) mesh
  of the same ranks (zamba2's shared KV cache split by positions over
  'data'), bf16 ms and peak a rank on (1, 2) (``[serve-lm-tp]``);
  and the
  dry-run of every (arch x shape) cell on both production meshes on this
  machine's CPU, beside the later phases (``[dryrun]``);
* dense: a full-size ``a9a`` fit (C=32, sigma2=64, multi5pc, wss1) to
  convergence, a Single-policy wss2 fit at scale 0.035, and
  ``SVMModel.predict`` over the test rows;
* sparse (block-ELL, CSR input): a full-size ``w7a`` fit fed as CSR
  (C=32, sigma2=64, multi5pc, wss1, ``format='ell'``) to convergence, a
  Single-policy wss2 fit at scale 0.035, one ``ELLKernelRowProvider.row``
  over the training buffer, and ``SVMModel.predict`` over the CSR test
  rows;
* the kernel-row cache (``row_cache=True``): its own repeat-heavy workload
  at the reference's benchmark size, dense wss1, ELL wss1 and dense wss2,
  each with the cache off and on (``[cache]``); ``[dist]``'s a9a fit
  with the cache on, bitwise equal to the cache-off one
  (``[train-cache]``); and
  the scale-0.035 a9a wss2 fit with the cache on, bitwise equal to the
  cache-off one (``[wss2-cache]``). The two-row kernels' cached entries
  are held against their plain version in ``[check]`` / ``[check-ell]``,
  their hit path timed.
* batched multi-problem training (``core.multi.MultiProblemDriver``):
  one-vs-rest on the full-size news20 stand-in fed as CSR (20 problems,
  ``[multi-ovr]``) and its union serving engine over the test rows
  (``[multi-serve]``); batched fits of the covtype stand-in (dense: wss1
  with the cache off and on, wss2) and of news20 at scale 0.1 (ELL), each
  bitwise equal per problem to its loop of single fits, and the dense
  union engine (``[multi-loop]``);
* the distributed solver (``core.parallel.ParallelSMOSolver``) on an NCCL
  process group of one rank: an a9a fit at ``DIST_SCALE`` and the w7a
  wss2 fit, each bitwise equal to its single-device twin, sharded
  serving of the a9a test rows, bitwise equal to ``[serve]``'s scores,
  and the batched covtype fit through the group, bitwise equal to
  ``[multi-loop]``'s (``[dist]``, ``[dist-ell]``, ``[dist-serve]``,
  ``[dist-multi]``); with two or more cards, ``[dist]`` also at min(4,
  cards) ranks, one a card;
* checkpoints, elastic resume and the chaos harness (``SVMConfig(
  checkpoint_dir=..., resume=...)``, ``launch.chaos``), under a temporary
  directory: ``[dist]``'s a9a fit killed at half its dispatches and
  resumed, the same kill with its newest step bit-flipped (resumed from
  the step before), one dispatch delayed under the straggler watchdog
  (one forced save), ``[wss2-ell]``'s w7a fit killed at save 2, and the
  a9a fit on the NCCL group of one rank killed and resumed (``[chaos]``);
  ``[multi-loop]``'s covtype wss1 / wss2 and news20 batched fits killed
  mid-sweep and resumed (``[chaos-multi]``). Each resumed fit must be
  bitwise equal to its uncut twin, and the kernels line's
  ``chaos_launches`` shows the resumed fits' launches of rows 1, 2, 6
  and 7;
* bf16 SV serving: the bf16 variants of the two accumulates at the
  ``[check]`` / ``[check-ell]`` shapes (bitwise equal to the fp32 kernel
  on the widened SVs, within 1e-5 of the plain version; their times on
  the kernels line as ``bf16_ms`` / ``bf16_b64_ms`` beside
  ``bf16_bound_ms``), and the full-size a9a and w7a models served through
  ``ServeEngine(dtype='bfloat16')`` and ``compact(dtype='bfloat16')``
  (``[serve-bf16]``);
* the command lines, as subprocesses on the card: ``python -m
  repro_torch.launch.svm_train`` on ``[dist]``'s a9a config, against
  that fit (``[cli-train]``), and ``python -m repro_torch.launch.serve
  --svm`` with a bf16 compact model and ``--roofline --json-out``
  (``[cli-serve]``).

The SVM fits launch their kernels from the host and leave the card mostly
idle, so after the LM phases the SVM phases run in two processes on the
card: the side lane (``side_lane``: ``[multi-ovr]``, ``[multi-loop]``,
then on its own NCCL group ``[dist-multi]``, ``[chaos-multi]``,
``[dist]``, ``[dist-ell]`` and ``[chaos]``, then ``[cache]`` and
``[train-cache]``) beside the main lane's full-size fits, wss2 fits,
serving, ``[dist-serve]`` and ``[wss2-cache]``, with the command lines;
``[serve-bf16]`` and the last kernel check run after the side lane is
joined. ``[done]`` prints the seconds of each phase.

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
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# the H100 SXM data-sheet peaks, set by main() from
# repro_torch.launch.roofline (one copy of them)
H100_BYTES_PER_S = H100_FP32_FLOPS = H100_BF16_FLOPS = None


PHASE = "start"
# seconds spent in each phase so far, and when the current one began
PHASE_SECONDS: dict = {}
PHASE_T0 = [time.perf_counter()]


def phase(name: str) -> None:
    """Name the phase that runs now (printed if it fails) and add the
    seconds of the one that ends to ``PHASE_SECONDS``."""
    global PHASE
    now = time.perf_counter()
    PHASE_SECONDS[PHASE] = PHASE_SECONDS.get(PHASE, 0.0) + now - PHASE_T0[0]
    PHASE_T0[0] = now
    PHASE = name


def phase_seconds() -> str:
    """``PHASE_SECONDS`` up to now, rounded to 0.1 s, as JSON."""
    phase(PHASE)
    return json.dumps({k: round(v, 1) for k, v in PHASE_SECONDS.items()})


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
    check_cached_entry(
        torch, dev, time_ms, kernels["rbf_rows2"], "rbf_rows2_cached",
        lambda t, sl, h: ops.kernel_rows2_cached("rbf", Xd, sq, z2, t, sl, h,
                                                 INV), got)

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
    # bf16 SVs (the serving engine's bf16 storage): the same SVs rounded
    X16 = Xs.to(torch.bfloat16)
    Xw = X16.float()
    sq16 = (Xw * Xw).sum(1)
    check_bf16_variant(
        torch, time_ms, kernels["rbf_accumulate"], "rbf_accumulate", acc,
        plain, (X16, sq16, cf), (Xw, sq16, cf), Zq,
        nbytes=2.0 * M * d + 4.0 * (2 * M + B * d + B),
        flops=2.0 * B * M * d + 6.0 * B * M)


def check_bf16_variant(torch, time_ms, record, name, acc, plain, svs16,
                       svs32, Zq, nbytes, flops) -> None:
    """An accumulate on bf16 SVs (``svs16``, the SV values stored as
    bf16): bitwise equal to the fp32 kernel on the widened SVs
    (``svs32``) at B = 4,096 and B = 64, within 1e-5 of max |sum| of the
    plain version, and the split-SV contracts; timed with the inputs out
    of L2 (``bf16_ms``) and at B = 64 (``bf16_b64_ms``, SVs in L2) beside
    its bound (``nbytes`` counting 2 bytes an SV value)."""
    from repro_torch.kernels import cuda
    n0 = cuda.launches[name]
    got = acc(*svs16, Zq)
    if cuda.launches[name] != n0 + 1:
        fail(f"{name} on bf16 SVs is not one counted launch")
    z64 = Zq[:64].contiguous()
    if not (torch.equal(got, acc(*svs32, Zq))
            and torch.equal(acc(*svs16, z64), acc(*svs32, z64))):
        fail(f"{name} on bf16 SVs differs from the fp32 kernel on the "
             "widened SVs")
    want = plain(*svs16, Zq)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    if not rel <= 1e-5:
        fail(f"{name} on bf16 SVs: error {rel:.3e} of max |sum| > 1e-5")
    check_accumulate_split(torch, f"{name} bf16", acc, plain, svs16, Zq)
    t16 = time_ms(acc, (*svs16, Zq), reps=10)
    t64 = time_ms(lambda z: acc(*svs16, z), (z64,), reps=50)
    b_ms, b_by = bound(nbytes, flops, H100_FP32_FLOPS)
    record.update(bf16_ms=t16, bf16_b64_ms=t64, bf16_bound_ms=b_ms,
                  bf16_bound_by=b_by, bf16_max_abs_err=err)
    print(f"[check] {name} bf16 SVs: bitwise equal to the fp32 kernel on "
          f"the widened SVs (B=4096 and B=64), max err {rel:.3e} of max "
          f"|sum| (1e-5); kernel {t16:.4f} ms (fp32 {record['ms']:.4f}), "
          f"B=64 {t64 * 1e3:.2f} us (fp32 {record['b64_ms'] * 1e3:.2f}), "
          f"bound {b_ms:.4f} ms ({b_by}, 2 bytes an SV value)", flush=True)


def check_cached_entry(torch, dev, time_ms, record, name, cached,
                       rows) -> None:
    """The row cache's entry of a two-row kernel at the main path's buffer
    (``cached(table, slot2, hit)``, a table of the default 64 slots): with
    the device hit flag set, the two table rows bitwise, against the plain
    version (``ref.cached_rows``); with it clear, the normal entry's
    ``rows`` bitwise; ``slot2 = [s, s]`` equal columns. The hit path is
    timed with the table out of L2 (``hit_ms``) beside its bound: 16 bytes
    a buffer row, two table floats read and two written (``hit_bound_ms``)."""
    from repro_torch.kernels import ref
    m = rows.shape[0]
    g = torch.Generator(device=dev).manual_seed(5)
    table = torch.randn(64, m, generator=g, device=dev)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    slot2, hit, miss = i32([3, 60]), i32(1), i32(0)
    got = cached(table, slot2, hit)
    want = ref.cached_rows(table, slot2, hit, rows)
    same = cached(table, i32([9, 9]), hit)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"{name}: a hit does not give the two table rows")
    if not torch.equal(cached(table, slot2, miss), rows):
        fail(f"{name}: a miss differs from the normal entry's rows")
    if not torch.equal(same[:, 0], same[:, 1]):
        fail(f"{name}: slot2 = [s, s] gives unequal columns")
    t_hit = time_ms(cached, (table, slot2, hit), reps=100)
    b_ms, _ = bound(16.0 * m, 0.0, H100_FP32_FLOPS)
    record.update(hit_ms=t_hit, hit_bound_ms=b_ms)
    print(f"[check] {name} m={m}: a hit gives the two table rows bitwise, "
          f"a miss the normal entry's bits, slot2=[s, s] equal columns; "
          f"hit path {t_hit*1e3:.2f} us (table out of L2), bound "
          f"{b_ms*1e3:.3f} us (bytes: 16 a buffer row)", flush=True)


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
    check_cached_entry(
        torch, dev, time_ms, kernels["ell_kernel_rows2"],
        "ell_kernel_rows2_cached",
        lambda t, sl, h: ops.ell_kernel_rows2_cached(v, c, s, z2, t, sl, h,
                                                     INV), got)

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
    v16 = v.to(torch.bfloat16)
    vw = v16.float()
    s16 = (vw * vw).sum(1)
    nnz16 = int((vw != 0).sum())
    check_bf16_variant(
        torch, time_ms, kernels["ell_rbf_accumulate"], "ell_rbf_accumulate",
        acc, plain, (v16, c, s16, coef), (vw, c, s16, coef), Zq,
        nbytes=2.0 * M * K + 4.0 * nnz16 + 4.0 * (2 * M + B * d + B),
        flops=2.0 * B * nnz16 + 10.0 * B * M + 2.0 * B * d)
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
LM_DECODE_CHECK = 64           # prompt tokens decoded one by one at bf16


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
    non-causal Lq = 130 over Lk = 300; and zamba2-1.2b's shared-attention
    prefill (B 4, H 32, Hkv 32, L 1,024, Dh 64, bf16, causal; timed as
    ``zamba_shape_ms``). Tolerances: 2e-5 fp32
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
             (2, 8, 2, 130, 300, 128, bf16, False),
             (4, 32, 32, 1024, 1024, 64, bf16, True)]
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
        if dt == bf16 and (Dh, Lq) in ((128, 2048), (128, 1024), (64, 1024)):
            timed[(Dh, Lq)] = (q, k, v, err)
    for (Dh, L), (q, k, v, err) in sorted(timed.items(), reverse=True):
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
              f"Hkv={k.shape[1]} L={L} Dh={Dh} bf16 causal: kernel "
              f"{t_k:.3f} ms (repeated inputs {t_w:.3f}), plain {t_p:.3f} ms, "
              f"SDPA {t_lib:.3f} ms, bound {b_ms * 1e3:.1f} us ({b_by}: "
              f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), "
              f"{flops / t_k / 1e9:.1f} TFLOP/s, {b_ms / t_k:.3f} of the "
              f"bound", flush=True)
        if Dh == 64:                          # zamba2-1.2b's shared block
            kernels["flash_attention"]["zamba_shape_ms"] = t_k
        elif L == 2048:
            kernels["flash_attention"] = dict(
                route="cuda", source=SRC_FLASH,
                replaces="src/repro/kernels/flash_attention.py:72",
                max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=b_ms,
                bound_by=b_by, library_ms=t_lib, warm_ms=t_w,
                shape=f"B 4 H 32 Hkv 8 L {L} Dh 128 bf16 causal",
                serve_shape_ms=None)
        else:                                 # llama3-8b's serving prefill
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
    # argmax maps NaN logits to valid ids: check the bf16 decode itself,
    # one more step on the cache generate returned
    step, _ = model.decode(params, cfg, res["cache"],
                           {"tokens": toks[:, -1:]})
    if not bool(torch.isfinite(step).all()):
        fail("bf16 decode logits after the generated tokens are not finite")
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


# -- LM serving of the MoE, Zamba2 and xLSTM families -----------------------

# (phase, arch, layers served in bf16: None = uncut). phi3.5-moe at all 32
# layers is ~84 GB in bf16 and does not fit the card's 80 GB; 24 layers
# are ~63 GB.
LM_FAMILIES = (("serve-moe", "phi3.5-moe-42b-a6.6b", 24),
               ("serve-zamba", "zamba2-1.2b", None),
               ("serve-xlstm", "xlstm-125m", None))
# the cache gates' decode-built prefix (two chunks: the fp32 gate configs
# take a chunk of LM_STATE_CHECK // 2), then the steps continued from it
LM_STATE_CHECK, LM_STATE_CONT = 256, 8


def flash_per_prefill(cfg) -> int:
    """flash_attention launches of one prefill: one per attention layer
    (hybrid: one per shared-block invocation; ssm: none)."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return 0 if cfg.family == "ssm" else cfg.n_layers


def n_params(tree) -> int:
    return sum(n_params(v) if isinstance(v, dict) else v.numel()
               for v in tree.values())


@contextlib.contextmanager
def count_drops(record: list):
    """Records (kept, total) (token, slot) pairs of every MoE routing over
    more than one position (the prefill's) while open."""
    from repro_torch.models import transformer
    route = transformer._route

    def counted(x, p, cfg):
        out = route(x, p, cfg)
        if x.shape[1] > 1:
            record.append((int(out[3].sum()), out[3].numel()))
        return out

    transformer._route = counted
    try:
        yield
    finally:
        transformer._route = route


def continuation_err(torch, model, cfg, params, prompts) -> tuple:
    """The prefill-filled cache against the decode-built one over the
    first ``LM_STATE_CHECK`` prompt tokens: (last-position logits of the
    decode-built cache against the prefill's, then the worst of the two
    caches' logits over the next ``LM_STATE_CONT`` prompt tokens), each
    as max |diff| over max |logit|."""
    B = prompts.shape[0]
    n, L = LM_STATE_CHECK, LM_STATE_CHECK + LM_STATE_CONT
    tok = lambda t: {"tokens": prompts[:, t: t + 1]}
    pre = model.init_cache(cfg, B, L, prompts.device)
    logits, _ = model.forward(params, cfg, {"tokens": prompts[:, :n]},
                              cache=pre)
    built = model.init_cache(cfg, B, L, prompts.device)
    for t in range(n):
        last, built = model.decode(params, cfg, built, tok(t))
    e_last = rel_err(last[:, 0], logits[:, -1])
    e_cont = 0.0
    for t in range(n, L):
        a, pre = model.decode(params, cfg, pre, tok(t))
        b, built = model.decode(params, cfg, built, tok(t))
        e_cont = max(e_cont, rel_err(b, a))
    return e_last, e_cont


def serve_family(torch, dev, tag, arch, n_layers, card) -> int:
    """One family's serving phase: the arch's full config (cut to
    ``n_layers`` when given) in bf16, random weights from a seed, 4
    requests x (1,024 prompt + 32 new tokens) through
    ``launch.serve.generate``; then the family's fp32 gates. Returns the
    prefill's flash_attention launches."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.kernels import cuda
    from repro_torch.launch import serve
    from repro_torch.models.api import build

    phase(tag)
    full = configs.full_config(arch)
    cfg = full if n_layers is None else dataclasses.replace(
        full, n_layers=n_layers)
    model = build(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    g = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=g, device=dev, dtype=torch.int32)
    serve.generate(params, cfg, prompts, 2)          # warm-up (cuBLAS, ...)
    cuda.reset_launches()
    res = serve.generate(params, cfg, prompts, LM_NEW)
    n_fa = cuda.launches["flash_attention"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    toks = res["tokens"]
    steps = LM_NEW - 1
    want_fa = flash_per_prefill(cfg)
    cut = "uncut" if n_layers is None else (
        f"cut to {n_layers} of its {full.n_layers} layers (all "
        f"{full.n_layers} would not fit the card)")
    print(f"[{tag}] {cfg.name} full width, {cut}: {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {n_params(params) / 1e9:.3f} B params "
          f"{cfg.dtype} (init {t_init:.1f} s, peak device memory "
          f"{peak:.1f} GiB); {LM_BATCH} requests x {LM_PROMPT} prompt + "
          f"{LM_NEW} new tokens: prefill {res['prefill_s'] * 1e3:.1f} ms "
          f"({LM_BATCH * LM_PROMPT / res['prefill_s']:.0f} prompt tok/s), "
          f"decode {res['decode_s'] * 1e3 / steps:.2f} ms/token-step "
          f"({LM_BATCH * steps / res['decode_s']:.1f} tok/s), end to end "
          f"{LM_BATCH * LM_NEW / (res['prefill_s'] + res['decode_s']):.1f} "
          f"new tok/s; flash_attention launches={n_fa} (prefill: want "
          f"{want_fa}); card {card}", flush=True)
    if n_fa != want_fa:
        fail(f"serving launched flash_attention {n_fa} times, not "
             f"{want_fa}")
    if not (toks.shape == (LM_BATCH, LM_NEW) and int(toks.min()) >= 0
            and int(toks.max()) < cfg.vocab_size):
        fail(f"generated ids {tuple(toks.shape)} outside [0, "
             f"{cfg.vocab_size})")
    # argmax maps NaN logits to valid ids: check the bf16 decode itself,
    # one more step on the cache generate returned
    step, _ = model.decode(params, cfg, res["cache"],
                           {"tokens": toks[:, -1:]})
    if not bool(torch.isfinite(step).all()):
        fail("bf16 decode logits after the generated tokens are not finite")
    drops = []
    with count_drops(drops):
        last = model.forward(params, cfg, {"tokens": prompts})[0][:, -1]
    if not bool(torch.isfinite(last).all()):
        fail("prefill logits are not finite")
    if cfg.is_moe:
        kept, total = map(sum, zip(*drops))
        print(f"[{tag}] capacity drops in the prefill: {total - kept} of "
              f"{total} (token, slot) pairs over {len(drops)} layers "
              f"({(total - kept) / total:.4f}; capacity factor "
              f"{cfg.capacity_factor}, cap "
              f"{int(cfg.capacity_factor * LM_PROMPT * cfg.top_k / cfg.n_experts)}"
              f" a sequence); sample {toks[0, :8].tolist()}", flush=True)
    del params, res, last, step
    torch.cuda.empty_cache()

    phase(tag + "-fp32")
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                chunk=min(cfg.chunk, LM_STATE_CHECK // 2))
    if cfg.family == "hybrid":
        cfg32 = dataclasses.replace(cfg32, n_layers=2 * cfg.attn_every)
    elif cfg.is_moe:
        cfg32 = dataclasses.replace(cfg32, n_layers=2)
    params = model.init(cfg32, torch.Generator(device=dev).manual_seed(2))
    batch = {"tokens": prompts}
    gates = {}
    if want_fa:
        cuda.reset_launches()
        flash, _ = model.forward(params, cfg32, batch)
        n32 = cuda.launches["flash_attention"]
        with plain_attention():
            plain, _ = model.forward(params, cfg32, batch)
        gates["flash vs plain blockwise"] = (rel_err(flash, plain), 1e-4)
        if cfg.is_moe:
            ein, _ = model.forward(params, dataclasses.replace(
                cfg32, moe_impl="einsum"), batch)
            gates["'scatter' vs 'einsum'"] = (rel_err(flash, ein), 1e-4)
            del ein
        del flash, plain
    if cfg.is_moe:               # cap = L: no pair dropped in the prefill
        cfg32 = dataclasses.replace(
            cfg32, capacity_factor=cfg.n_experts / cfg.top_k)
    t0 = time.perf_counter()
    e_last, e_cont = continuation_err(torch, model, cfg32, params, prompts)
    t_dec = time.perf_counter() - t0
    gates["decode-built vs prefill, last position"] = (e_last, 5e-3)
    gates["decode-built vs prefill-filled cache, continued"] = (e_cont, 5e-3)
    print(f"[{tag}-fp32] {cfg.name} width, {cfg32.n_layers} layers, fp32"
          + (f", capacity factor {cfg32.capacity_factor} for the cache "
             f"gates" if cfg.is_moe else "")
          + f"; {LM_BATCH} x {LM_PROMPT} tokens (cache gates: "
          f"{LM_STATE_CHECK} decoded one by one, chunk {cfg32.chunk}, "
          f"{t_dec:.1f} s, then {LM_STATE_CONT} more): "
          + ", ".join(f"{k} {e:.3e} (<= {b:g})" for k, (e, b) in
                      gates.items())
          + (f"; flash_attention launches={n32}" if want_fa else ""),
          flush=True)
    bad = {k: e for k, (e, b) in gates.items() if not e <= b}
    if want_fa and n32 != flash_per_prefill(cfg32):
        bad["flash_attention launches"] = n32
    if bad:
        fail(f"fp32 gates: {bad}")
    del params
    torch.cuda.empty_cache()
    return n_fa


# -- LM training --------------------------------------------------------------

# llama3-8b at full width cut to 8 of its 32 layers: all 32 are 8.030 B
# parameters, 96.4 GB of bf16 params and grads and fp32 AdamW moments (12
# bytes a parameter), over the card's 80 GB; 8 layers are 2.796 B, 33.5 GB
TRAIN_LAYERS = 8
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 10   # after 1 warm-up step


def rounds_away(torch, ocfg, opt, p, m, v) -> bool:
    """Whether the last AdamW update of an unchanged bf16 leaf ``p``,
    recomputed from the final moments ``m`` / ``v`` (the leaf equals its
    value before that step), rounds back to ``p`` in its dtype: the update
    was applied and lost under half an ulp, as it is in the reference."""
    from repro_torch.optim import adamw
    step = opt["step"]
    lr = adamw.schedule(ocfg, step)
    u = (m / (1 - ocfg.b1 ** step.float())) / (
        torch.sqrt(v / (1 - ocfg.b2 ** step.float())) + ocfg.eps)
    if p.ndim >= 2:
        u = u + ocfg.weight_decay * p.float()
    return torch.equal((p.float() - lr * u).to(p.dtype), p)


def flash_backward_ms(torch, dev, time_ms) -> tuple:
    """Device ms of the flash Function at the training phase's attention
    shapes (B 4, H 32, Hkv 8, L 1,024, Dh 128, bf16, causal): the kernel
    forward, and the backward (the plain recompute through ``ref.mha`` in
    fp32 and its gradient) as forward + backward less the forward."""
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(3)
    mk = lambda *s: torch.randn(*s, generator=g, device=dev).to(
        torch.bfloat16)
    ins = (mk(TRAIN_BATCH, 32, TRAIN_SEQ, 128), mk(TRAIN_BATCH, 8, TRAIN_SEQ,
                                                   128),
           mk(TRAIN_BATCH, 8, TRAIN_SEQ, 128), mk(TRAIN_BATCH, 32, TRAIN_SEQ,
                                                  128))

    def fwd_bwd(q, k, v, go):
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad(ops.flash_attention(*qkv, True), qkv, go)

    t_fwd = time_ms(lambda q, k, v, go: ops.flash_attention(q, k, v, True),
                    ins, reps=10)
    t_all = time_ms(fwd_bwd, ins, reps=5)
    return t_fwd, t_all - t_fwd


def train_lm(torch, dev, time_ms, card) -> dict:
    """The LM training path: llama3-8b at full width, ``TRAIN_LAYERS`` of
    its 32 layers, bf16, remat full, through ``launch.train.train`` (one
    warm-up step, then ``TRAIN_STEPS`` timed, each ``TRAIN_BATCH`` x
    ``TRAIN_SEQ`` tokens of ``TokenPipeline``); then one loss gradient at
    the same width, 2 layers, fp32, with the kernel and with the plain
    attention. Returns the timed steps' flash launches and the flash
    Function's forward and backward times at the phase's shapes."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import cuda
    from repro_torch.launch import train, train_lib
    from repro_torch.models.api import build
    from repro_torch.optim import adamw

    phase("train-lm")
    t_phases = time.perf_counter()
    t_fwd, t_bwd = flash_backward_ms(torch, dev, time_ms)
    print(f"[train-lm] flash_attention at B {TRAIN_BATCH} H 32 Hkv 8 L "
          f"{TRAIN_SEQ} Dh 128 bf16 causal: kernel forward {t_fwd:.3f} ms, "
          f"backward (plain fp32 recompute and its gradient) {t_bwd:.3f} "
          f"ms", flush=True)
    full = configs.full_config(LM_ARCH)
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    ocfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=20, decay_steps=100)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    per_step = []

    def on_step(i, rec):
        if i > 0:
            per_step.append(cuda.launches["flash_attention"])
        cuda.reset_launches()     # the timed steps' counts start at step 1

    res = train.train(cfg, ocfg, 1 + TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ,
                      device="cuda", on_step=on_step)
    peak = torch.cuda.max_memory_allocated() / 2**30
    params, opt = res["params"], res["opt"]
    ms = statistics.median(res["seconds"][1:]) * 1e3
    want = 2 * cfg.n_layers
    print(f"[train-lm] {cfg.name} full width, cut to {cfg.n_layers} of its "
          f"{full.n_layers} layers (all {full.n_layers}: 96.4 GB of params, "
          f"grads and AdamW moments, over the card): d_model {cfg.d_model}, "
          f"{n_params(params) / 1e9:.3f} B params {cfg.dtype}, remat "
          f"{cfg.remat} (init {res['init_s']:.1f} s, peak device memory "
          f"{peak:.1f} GiB); {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step, 1 "
          f"warm-up + {TRAIN_STEPS} timed steps: median {ms:.1f} ms a step, "
          f"{TRAIN_BATCH * TRAIN_SEQ / ms * 1e3:.0f} tok/s; flash_attention "
          f"launches a step {per_step} (want {want}: forward + remat); card "
          f"{card}", flush=True)
    for i, (lo, lr, gn, t) in enumerate(zip(res["loss"], res["lr"],
                                            res["grad_norm"],
                                            res["seconds"])):
        print(f"[train-lm] step {i}: loss {lo:.6f} grad_norm {gn:.6f} lr "
              f"{lr:.3e} ({t * 1e3:.1f} ms)", flush=True)
    if not all(map(math.isfinite, res["loss"] + res["grad_norm"])):
        fail("a loss or grad norm is not finite")
    if not res["loss"][-1] < res["loss"][0]:
        fail(f"the loss did not fall: {res['loss'][0]} -> "
             f"{res['loss'][-1]}")
    if per_step != [want] * TRAIN_STEPS:
        fail(f"flash_attention launches a step {per_step}, want {want}")
    init = build(cfg).init(cfg, torch.Generator(device=dev).manual_seed(0))
    stayed, no_grad = [], []
    for path, p0, p, m, v in zip(
            leaf_paths(init), adamw.leaves(init),
            adamw.leaves(params), adamw.leaves(opt["m"]),
            adamw.leaves(opt["v"])):
        if not bool((m != 0).any()):
            no_grad.append(path)
        elif torch.equal(p0, p):
            stayed.append(path)
            if not rounds_away(torch, ocfg, opt, p, m, v):
                no_grad.append(path)
    print(f"[train-lm] every leaf got a gradient; unchanged from init, "
          f"their last update lost under half a {cfg.dtype} ulp (lr "
          f"{res['lr'][-1]:.3e}): {stayed}", flush=True)
    if no_grad:
        fail(f"leaves without a gradient or an update: {no_grad}")
    del init, params, opt, res
    torch.cuda.empty_cache()

    phase("train-lm-fp32")
    cfg32 = dataclasses.replace(full, n_layers=2, dtype="float32")
    params = build(cfg32).init(cfg32,
                               torch.Generator(device=dev).manual_seed(2))
    raw = TokenPipeline(cfg32.vocab_size, batch=TRAIN_BATCH,
                        seq_len=TRAIN_SEQ, seed=0).batch_at(0)
    batch = {k: torch.as_tensor(a, device=dev) for k, a in raw.items()}
    loss_fn = train_lib.make_loss_fn(cfg32)

    def grads():
        flat = [w.detach().requires_grad_() for w in adamw.leaves(params)]
        loss, _ = loss_fn(adamw.tree_like(params, flat), batch)
        return float(loss.detach()), torch.autograd.grad(loss, flat)

    cuda.reset_launches()
    l_k, g_k = grads()
    n_k = cuda.launches["flash_attention"]
    with plain_attention():
        l_p, g_p = grads()
    e_loss = abs(l_k - l_p) / abs(l_p)
    e_leaf = max(float((a - b).abs().max() / b.abs().max())
                 for a, b in zip(g_k, g_p))
    nrm_k, nrm_p = (float(adamw.global_norm(g)) for g in (g_k, g_p))
    e_norm = abs(nrm_k - nrm_p) / nrm_p
    print(f"[train-lm-fp32] {cfg.name} width, 2 layers, fp32, remat "
          f"{cfg32.remat}, {TRAIN_BATCH} x {TRAIN_SEQ} tokens: loss gradient "
          f"with the kernel vs the plain attention: loss {l_k:.7f} vs "
          f"{l_p:.7f} ({e_loss:.3e} <= 1e-5), worst leaf's max |diff| "
          f"{e_leaf:.3e} of its max |g| (<= 1e-3), grad norm {nrm_k:.6f} vs "
          f"{nrm_p:.6f} ({e_norm:.3e} <= 1e-4); flash_attention launches="
          f"{n_k} (want {2 * cfg32.n_layers}); the two phases "
          f"{time.perf_counter() - t_phases:.1f} s", flush=True)
    if not (e_loss <= 1e-5 and e_leaf <= 1e-3 and e_norm <= 1e-4
            and n_k == 2 * cfg32.n_layers):
        fail(f"fp32 gates: loss {e_loss:.3e}, leaf {e_leaf:.3e}, norm "
             f"{e_norm:.3e}, launches {n_k}")
    del params, g_k, g_p
    torch.cuda.empty_cache()
    return {"train_lm_launches": {
        "per_step": want, "timed_steps": TRAIN_STEPS,
        "launches": sum(per_step), "arch": cfg.name,
        "layers": cfg.n_layers},
        "train_fwd_ms": t_fwd, "train_bwd_ms": t_bwd}


MESH_LAYERS, MESH_STEPS = 2, 2
# the sharded save / restore check: llama3-8b's layer at a quarter of its
# width (head dim 128, GQA 4:1), 1 layer, an 8,192 vocab: at full width
# one layer wrote ~3.4 GB of npz, sha256-summed twice, in 15.8-19.5 s
SAVE_CUT = dict(n_layers=1, vocab_size=8192, d_model=1024, n_heads=8,
                n_kv_heads=2, d_ff=3584)


def fingerprint(torch, t) -> int:
    """A 64-bit fingerprint of a tensor's bits: the sum, mod 2**64, of each
    element's bits read as an integer times an odd weight of its position.
    Equal bits give equal fingerprints, and one changed element always
    changes it (an odd weight is a unit mod 2**64); the bitwise gates of
    ``[train-lm-mesh]`` compare these, not a second copy of an 80 GB-class
    state."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32}
    x = t.detach().reshape(-1).view(ints[t.element_size()])
    total, chunk = 0, 1 << 26
    for s in range(0, x.numel(), chunk):
        seg = x[s: s + chunk].to(torch.int64)
        w = torch.arange(s, s + seg.numel(), dtype=torch.int64,
                         device=x.device) * 2 + 1
        total += int((seg * (w * 0x2545F4914F6CDD1D)).sum())
    return total % (1 << 64)


def train_lm_mesh(torch, dev, card) -> dict:
    """``[train-lm-mesh]``: the sharded train step (``train_lib.MeshStep``)
    at llama3-8b's full width, ``MESH_LAYERS`` of its 32 layers, bf16,
    remat full, ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens of ``TokenPipeline``
    a step, on an NCCL group of one rank (this card):

    * a (1, 1) ('data', 'model') mesh under the tp and fsdp layouts,
      ``gather_params_once`` off and on, ``accum_steps`` 1 and 2,
      ``MESH_STEPS`` steps each: losses, params and both moments bitwise
      equal to the unsharded step's (64-bit fingerprints of every leaf
      after every step);
    * a (1, 1, 1) ('pod', 'data', 'model') mesh: ``grad_compress`` None, 2
      steps bitwise equal to the unsharded step's; 'bf16' and 'int8', 2
      steps with the residuals carried: the first step's loss (from the
      same state, as the reference's test compares them) within 1e-2 /
      5e-2 of None's, and the first residuals bitwise equal to
      ``x - decode(encode(x))`` of the unsharded fp32 gradient, recomputed
      by ``optim.compress``;
    * every step's ``dist.calls`` by helper equal to ``MeshStep.plan``'s,
      and ``2 x layers x accum`` flash launches a step;
    * a sharded save at step 2 on the (1, 1) mesh restored onto the
      (1, 1, 1) mesh, whose step 3 is bitwise the unsharded step 3
      (``SAVE_CUT``).

    Returns the mesh runs' flash launches for the kernels line."""
    import dataclasses
    import tempfile
    from repro_torch import configs
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import cuda
    from repro_torch.launch import dist, train_lib
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import sharding as shd
    from repro_torch.models.api import build
    from repro_torch.optim import adamw, compress

    phase("train-lm-mesh")
    t_phase = time.perf_counter()
    full = configs.full_config(LM_ARCH)
    base = dataclasses.replace(full, n_layers=MESH_LAYERS)
    ocfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=20, decay_steps=100)

    def token_batches(cfg, n):
        tp = TokenPipeline(cfg.vocab_size, batch=TRAIN_BATCH,
                           seq_len=TRAIN_SEQ, seed=0)
        return [{k: torch.as_tensor(a, device=dev)
                 for k, a in tp.batch_at(i).items()} for i in range(n)]

    def fresh(cfg, mesh=None):
        params = build(cfg).init(cfg, torch.Generator(device=dev)
                                 .manual_seed(0))
        if mesh is not None:
            params = shd.shard_tree(
                params, train_lib.shardings_for(cfg, mesh, {})[0], mesh)
        return params, adamw.init(params)

    def fps(params, opt):
        return [fingerprint(torch, t) for t in adamw.leaves(params)
                + adamw.leaves(opt["m"]) + adamw.leaves(opt["v"])] \
            + [int(opt["step"])]

    def run(step, params, opt, batches, lo, hi, res=None):
        rec = dict(loss=[], ms=[], flash=[], calls=[], fps=[])
        pod = getattr(step, "use_pod", False)
        for i in range(lo, hi):
            cuda.reset_launches()
            dist.calls.clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(params, opt, batches[i], res) if pod \
                else step(params, opt, batches[i])
            params, opt, m = out[:3]
            res = out[3] if pod else None
            rec["loss"].append(float(m["loss"]))
            torch.cuda.synchronize()
            rec["ms"].append((time.perf_counter() - t) * 1e3)
            rec["flash"].append(cuda.launches["flash_attention"])
            rec["calls"].append(dict(dist.calls))
            rec["fps"].append(fps(params, opt))
        return params, opt, res, rec

    def free():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    batches = token_batches(base, MESH_STEPS)
    torch.cuda.reset_peak_memory_stats()
    twins = {}
    for A in (1, 2):
        p, o = fresh(base)
        step = train_lib.make_train_step(base, ocfg, accum_steps=A)
        *_, twins[A] = run(step, p, o, batches, 0, MESH_STEPS)
        del p, o, _
        free()
        print(f"[train-lm-mesh] {base.name} full width, {base.n_layers} of "
              f"{full.n_layers} layers, {base.dtype}, remat {base.remat}, "
              f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens: unsharded step, accum "
              f"{A}: losses {twins[A]['loss']}, ms a step "
              f"{[round(x, 1) for x in twins[A]['ms']]}", flush=True)
    dist.init(device="cuda", init_method=f"tcp://localhost:{free_port()}",
              rank=0, world=1)
    m11 = meshlib.make_mesh((1, 1), ("data", "model"))
    pod = meshlib.make_mesh((1, 1, 1), ("pod", "data", "model"))
    bad, launches, n_steps = [], 0, 0

    def held(tag, step, r, want, A, n=MESH_STEPS):
        nonlocal launches, n_steps
        plan = train_lib.plan_calls(step.plan(batches[0]))
        same = r["loss"] == want["loss"][:n] and r["fps"] == want["fps"][:n]
        calls = all(c == plan for c in r["calls"])
        flash = all(f == 2 * base.n_layers * A for f in r["flash"])
        launches += sum(r["flash"])
        n_steps += len(r["flash"])
        print(f"[train-lm-mesh] {tag}: losses {r['loss']}, params and "
              f"moments bitwise equal to the unsharded step: {same}; ms a "
              f"step {[round(x, 1) for x in r['ms']]}; flash_attention "
              f"launches a step {r['flash']} (want {2 * base.n_layers * A});"
              f" collectives a step {r['calls'][0]} == plan {plan}: "
              f"{calls}", flush=True)
        if not (same and calls and flash):
            bad.append(tag)

    for layout in ("tp", "fsdp"):
        cfg = dataclasses.replace(base, layout=layout)
        for A in (1, 2):
            for once in (False, True):
                p, o = fresh(cfg, m11)
                step = train_lib.make_train_step(
                    cfg, ocfg, m11, accum_steps=A, gather_params_once=once)
                *_, r = run(step, p, o, batches, 0, MESH_STEPS)
                del p, o, _
                free()
                held(f"(1, 1) {layout} accum {A} gather_params_once "
                     f"{once}", step, r, twins[A], A)
    p, o = fresh(base, pod)
    step = train_lib.make_train_step(base, ocfg, pod)
    *_, r = run(step, p, o, batches, 0, 2)
    del p, o, _
    free()
    held("(1, 1, 1) pod grad_compress None", step, r, twins[1], 1, n=2)
    base_loss = r["loss"]
    for codec, tol in (("bf16", 1e-2), ("int8", 5e-2)):
        p = build(base).init(base, torch.Generator(device=dev)
                             .manual_seed(0))
        flat = [w.detach().requires_grad_() for w in adamw.leaves(p)]
        loss = train_lib.make_loss_fn(base)(adamw.tree_like(p, flat),
                                            batches[0])[0]
        want = []
        for g in torch.autograd.grad(loss, flat):
            x = g.float()
            x = x + torch.zeros_like(x)
            dec = compress.dequantize_int8(*compress.quantize_int8(x)) \
                if codec == "int8" else x.to(torch.bfloat16).float()
            want.append(fingerprint(torch, x - dec))
            del x, dec
        del p, flat, loss
        free()
        p, o = fresh(base, pod)
        step = train_lib.make_train_step(base, ocfg, pod,
                                         grad_compress=codec)
        p, o, res, r1 = run(step, p, o, batches, 0, 1)
        got = [fingerprint(torch, t) for t in adamw.leaves(res)]
        p, o, res, r2 = run(step, p, o, batches, 1, 2, res)
        del p, o, res
        free()
        r = {k: r1[k] + r2[k] for k in r1}
        plan = train_lib.plan_calls(step.plan(batches[0]))
        ok = (abs(r["loss"][0] - base_loss[0]) < tol and got == want
              and all(c == plan for c in r["calls"])
              and all(f == 2 * base.n_layers for f in r["flash"]))
        launches += sum(r["flash"])
        n_steps += len(r["flash"])
        print(f"[train-lm-mesh] (1, 1, 1) pod grad_compress {codec}: losses "
              f"{r['loss']} (None: {base_loss}; step 1 within {tol}); the "
              f"first residuals bitwise x - decode(encode(x)) of the "
              f"unsharded gradient: {got == want}; ms a step "
              f"{[round(x, 1) for x in r['ms']]}; flash_attention launches "
              f"a step {r['flash']}; collectives a step {r['calls'][0]} == "
              f"plan {plan}", flush=True)
        if not ok:
            bad.append(f"pod {codec}")
    peak = torch.cuda.max_memory_allocated() / 2**30

    small = dataclasses.replace(base, **SAVE_CUT)
    sb = token_batches(small, 3)
    p, o = fresh(small)
    *_, twin = run(train_lib.make_train_step(small, ocfg), p, o, sb, 0, 3)
    p, o = fresh(small, m11)
    p, o, _, r = run(train_lib.make_train_step(small, ocfg, m11), p, o, sb,
                     0, 2)
    specs = train_lib.shardings_for(small, m11, {})
    t_save = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        d = f"{tmp}/step_2"
        ckpt.save_sharded(d, 2, {"params": p, "opt": o},
                          {"params": specs[0], "opt": specs[1]}, m11)
        t_save = time.perf_counter() - t_save
        del p, o
        pspecs, ospecs, _, (pshapes, oshapes) = train_lib.shardings_for(
            small, pod, {})
        t_restore = time.perf_counter()
        p = ckpt.restore_sharded(d, "params", pshapes, pspecs, pod, dev)
        o = ckpt.restore_sharded(d, "opt", oshapes, ospecs, pod, dev)
        t_restore = time.perf_counter() - t_restore
    *_, r3 = run(train_lib.make_train_step(small, ocfg, pod), p, o, sb, 2, 3)
    del p, o
    same = r3["loss"] == twin["loss"][2:] and r3["fps"] == twin["fps"][2:]
    print(f"[train-lm-mesh] sharded save at step 2 on (1, 1) ({t_save:.1f} "
          f"s), restored onto (1, 1, 1) ({t_restore:.1f} s), step 3 bitwise "
          f"the unsharded step 3: {same} ({small.name}: d_model "
          f"{small.d_model}, {small.n_layers} layer, vocab "
          f"{small.vocab_size})", flush=True)
    if not same:
        bad.append("save/restore")
    dist.destroy()
    free()
    print(f"[train-lm-mesh] {n_steps} mesh steps, {launches} flash_attention "
          f"launches; peak device memory {peak:.1f} GiB; the phase "
          f"{time.perf_counter() - t_phase:.1f} s; card {card}", flush=True)
    if bad:
        fail(f"[train-lm-mesh] gates failed: {bad}")
    return {"train_lm_mesh_launches": {
        "mesh_steps": n_steps, "launches": launches, "arch": base.name,
        "layers": base.n_layers}}


TP_LAYERS, TP_STEPS = 2, 3        # after 1 warm-up step
TP_NOISE = 1e-3                   # the train-step tests' NOISE
# [train-lm-tp]'s recurrent families at full width, cut in depth: zamba2 one
# group of 6 Mamba layers with its shared block and 1 tail layer; xLSTM 3
# mLSTM blocks and 1 sLSTM block, then 1 mLSTM tail block
TP_FAMILIES = (("zamba2-1.2b", 7), ("xlstm-125m", 5))
# [train-lm-tp]'s fsdp runs: layers, and the least the per-layer gather
# must save of the whole-gather peak a rank (by shapes at 4 layers: ~3.85
# GB of gathered bf16 weights, their bf16 and ~7.7 GB of fp32 gradient)
FSDP_LAYERS, FSDP_SAVES_GIB = 4, 3.0


def tp_rank(rank: int, port: int, out: str) -> None:
    """One of the two ranks of ``[train-lm-tp]`` (a process of its own, on
    the one card, in a gloo group): it imports, waits for ``go`` on its
    standard input (the card is the earlier phase's until then), then runs
    the fp32 gate, the bf16 timing, the fsdp pair and the recurrent
    families (``TP_FAMILIES``); its record goes to ``out`` as JSON, with
    the seconds of each part."""
    t0 = time.perf_counter()
    import dataclasses
    import torch
    import torch.distributed as tdist
    sys.path.insert(0, str(SRC))
    from repro_torch import configs
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import cuda
    from repro_torch.launch import dist, train_lib
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import sharding as shd
    from repro_torch.models.api import build
    from repro_torch.optim import adamw

    secs = {"imports": time.perf_counter() - t0}
    if sys.stdin.readline().strip() != "go":
        return
    t0 = time.perf_counter()
    dev = dist.init(device="cuda", backend="gloo", rank=rank, world=2,
                    init_method=f"tcp://localhost:{port}")
    mesh = meshlib.make_mesh((1, 2), ("data", "model"))
    secs["group"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    full = configs.full_config(LM_ARCH)
    ocfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=20, decay_steps=100)
    tp = TokenPipeline(full.vocab_size, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                       seed=0)
    batches = [{k: torch.as_tensor(a, device=dev)
                for k, a in tp.batch_at(i).items()}
               for i in range(1 + TP_STEPS)]
    rec = {}

    def fresh(cfg):
        return build(cfg).init(cfg, torch.Generator(device=dev)
                               .manual_seed(0))

    def free():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    def mine(tree, specs):
        return [shd.shard(t, s, mesh)
                for t, s in zip(adamw.leaves(tree), shd.leaves(specs))]

    def timed(step, params, opt, b):
        cuda.reset_launches()
        dist.calls.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt, m = step(params, opt, b)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        return params, opt, m, dict(
            ms=(time.perf_counter() - t) * 1e3, loss=loss,
            flash=cuda.launches["flash_attention"], calls=dict(dist.calls))

    def exact(cfg, b):
        """Loss and gradient norm of the unsharded step's function on an
        fp64 copy of the seeded fp32 state (``common.upcast`` keeps every
        fp32 accumulation in fp64; the attention plain, as the kernel has
        no fp64)."""
        p = fresh(cfg)
        flat = [w.double().requires_grad_() for w in adamw.leaves(p)]
        tree = adamw.tree_like(p, flat)
        del p
        with plain_attention():
            loss, _ = train_lib.make_loss_fn(cfg)(tree, b)
            g = torch.autograd.grad(loss, flat)
        out = float(loss), float(torch.sqrt(sum((x * x).sum() for x in g)))
        del tree, flat, g, loss
        free()
        return out

    def gate_fp32(cfg, b, fp64=False):
        """The two ranks' fp32 step against the unsharded step from the
        same state, at the train-step tests' tolerance. The two ranks'
        step comes first, so that both pay their first step's loads at
        once; then the unsharded step runs on one rank at a time (two
        would not fit). With ``fp64`` the loss and grad norm are held to
        the unsharded step's exact values (:func:`exact`), and the fp32
        unsharded step's own distance from them is reported: where the
        function amplifies fp32 rounding, two fp32 steps differ by more
        than the tolerance while each is close to the exact value."""
        t0 = time.perf_counter()
        specs = train_lib.shardings_for(cfg, mesh, {})[0]
        step = train_lib.make_train_step(cfg, ocfg, mesh)
        pb = shd.shard_tree(fresh(cfg), specs, mesh)
        pb, ob, m, r = timed(step, pb, adamw.init(pb), b)
        gn = float(m["grad_norm"])
        plan = train_lib.plan_calls(step.plan(b))
        del ob, m
        free()
        secs[f"fp32 tp {cfg.name}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for turn in range(2):
            if turn == rank:
                p = fresh(cfg)
                o = adamw.init(p)
                p, o, m = train_lib.make_train_step(cfg, ocfg)(p, o, b)
                want = mine(p, specs)
                gmax = [float(x.abs().max()) / 0.1
                        for x in adamw.leaves(o["m"])]
                wm = mine(o["m"], specs)
                one = dict(loss=float(m["loss"]), gn=float(m["grad_norm"]),
                           lr=float(m["lr"]))
                del p, o, m
                free()
                if fp64 and rank == 0:
                    one["exact_loss"], one["exact_gn"] = exact(cfg, b)
            tdist.barrier()
        if fp64:                         # rank 0's, once
            got = [one.get("exact_loss"), one.get("exact_gn")]
            tdist.broadcast_object_list(got, src=0)
            one["exact_loss"], one["exact_gn"] = got
        secs[f"fp32 unsharded {cfg.name}"] = time.perf_counter() - t0
        worst, off, excused = 0.0, 0, True
        for a, w, g, mx in zip(adamw.leaves(pb), want, wm, gmax):
            d = (a - w).abs()
            bad = d > 1e-5
            worst = max(worst, float(d.max()))
            if bool(bad.any()):
                off += int(bad.sum())
                noisy = (g / 0.1).abs() < TP_NOISE * mx
                excused &= bool(noisy[bad].all()) and \
                    float(d.max()) <= 2 * one["lr"]
        del pb, want, wm
        free()
        loss_to, gn_to = (one["exact_loss"], one["exact_gn"]) if fp64 \
            else (one["loss"], one["gn"])
        return dict(
            r, gn=gn, want=one, calls_ok=r["calls"] == plan,
            plan=plan, worst=worst, off=off, excused=excused,
            split=sorted(step.roles), fp64=fp64,
            ok=bool(abs(r["loss"] - loss_to) <= 1e-5 * abs(loss_to)
                    and abs(gn - gn_to) <= 1e-5 * abs(gn_to)
                    and excused and r["calls"] == plan))

    rec["fp32"] = gate_fp32(dataclasses.replace(
        full, n_layers=TP_LAYERS, dtype="float32"), batches[0])
    t0 = time.perf_counter()

    # bf16, remat full: ms a step and the peak a rank, then the unsharded
    # step's on rank 0 while rank 1 waits
    cfg = dataclasses.replace(full, n_layers=TP_LAYERS)
    specs = train_lib.shardings_for(cfg, mesh, {})[0]
    step = train_lib.make_train_step(cfg, ocfg, mesh)
    plan = train_lib.plan_calls(step.plan(batches[0]))
    pb = shd.shard_tree(fresh(cfg), specs, mesh)
    ob = adamw.init(pb)
    free()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for b in batches:
        pb, ob, _, r = timed(step, pb, ob, b)
        runs.append(r)
    rec["bf16"] = dict(runs=runs, plan=plan,
                       peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                       held_gib=torch.cuda.memory_allocated() / 2**30)
    del pb, ob
    free()
    tdist.barrier()
    secs["bf16 tp"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if rank == 0:
        p = fresh(cfg)
        o = adamw.init(p)
        free()
        torch.cuda.reset_peak_memory_stats()
        plain = train_lib.make_train_step(cfg, ocfg)
        runs = []
        for b in batches:
            p, o, _, r = timed(plain, p, o, b)
            runs.append(r)
        rec["unsharded"] = dict(
            runs=runs, peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del p, o
        free()
    tdist.barrier()
    secs["bf16 unsharded"] = time.perf_counter() - t0

    # fsdp on the same mesh ('model' folds into the batch axes: a 2-way
    # FSDP), bf16, remat full: one step from the seeded init with the
    # per-layer gather, then one from the same init with gather_params_once;
    # ms, the peak a rank from the state up, collectives against the plan,
    # and 64-bit fingerprints of the loss's bits and every block of the
    # params and both moments
    cfg = dataclasses.replace(full, n_layers=FSDP_LAYERS, layout="fsdp")
    specs = train_lib.shardings_for(cfg, mesh, {})[0]
    rec["fsdp"] = {}
    for once in (False, True):
        t0 = time.perf_counter()
        step = train_lib.make_train_step(cfg, ocfg, mesh,
                                         gather_params_once=once)
        pb = shd.shard_tree(fresh(cfg), specs, mesh)
        ob = adamw.init(pb)
        free()
        torch.cuda.reset_peak_memory_stats()
        pb, ob, m, r = timed(step, pb, ob, batches[0])
        peak = torch.cuda.max_memory_allocated() / 2**30
        rec["fsdp"]["once" if once else "per_layer"] = dict(
            r, peak_gib=peak, plan=train_lib.plan_calls(step.plan(batches[0])),
            loss_bits=fingerprint(torch, m["loss"].reshape(1)),
            fps=[fingerprint(torch, t) for t in adamw.leaves(pb)
                 + adamw.leaves(ob["m"]) + adamw.leaves(ob["v"])])
        del pb, ob, m
        free()
        tdist.barrier()
        secs["fsdp " + ("once" if once else "per layer")] = \
            time.perf_counter() - t0

    # zamba2 and xLSTM at full width, cut in depth: the fp32 gate, then two
    # bf16 steps (the first a warm-up) a rank and on rank 0 alone the
    # unsharded step's; flash launches a rank a step against the shared
    # block's invocations (zamba2; xLSTM has no attention)
    rec["families"] = {}
    for arch, n_layers in TP_FAMILIES:
        fam = configs.full_config(arch)
        tpf = TokenPipeline(fam.vocab_size, batch=TRAIN_BATCH,
                            seq_len=TRAIN_SEQ, seed=0)
        fb = [{k: torch.as_tensor(a, device=dev)
               for k, a in tpf.batch_at(i).items()} for i in range(2)]
        cfg = dataclasses.replace(fam, n_layers=n_layers)
        model = build(cfg)
        fr = dict(fp32=gate_fp32(dataclasses.replace(cfg, dtype="float32"),
                                 fb[0], fp64=True),
                  want_flash=model._group_struct(cfg)[0]
                  if cfg.family == "hybrid" else 0)
        t0 = time.perf_counter()
        specs = train_lib.shardings_for(cfg, mesh, {})[0]
        step = train_lib.make_train_step(cfg, ocfg, mesh)
        pb = shd.shard_tree(fresh(cfg), specs, mesh)
        ob = adamw.init(pb)
        free()
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for b in fb:
            pb, ob, _, r = timed(step, pb, ob, b)
            runs.append(r)
        fr["bf16"] = dict(runs=runs, plan=train_lib.plan_calls(step.plan(
            fb[0])), peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del pb, ob
        free()
        tdist.barrier()
        secs[f"bf16 tp {arch}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if rank == 0:
            p = fresh(cfg)
            o = adamw.init(p)
            free()
            torch.cuda.reset_peak_memory_stats()
            plain = train_lib.make_train_step(cfg, ocfg)
            runs = []
            for b in fb:
                p, o, _, r = timed(plain, p, o, b)
                runs.append(r)
            fr["unsharded"] = dict(
                runs=runs, peak_gib=torch.cuda.max_memory_allocated() / 2**30)
            del p, o
            free()
        tdist.barrier()
        secs[f"bf16 unsharded {arch}"] = time.perf_counter() - t0
        rec["families"][arch] = fr
    t0 = time.perf_counter()
    rec["serve"] = serve_tp_rank(torch, tdist, dev, mesh, fresh, free, secs)
    secs["serve-lm-tp"] = time.perf_counter() - t0
    rec["seconds"] = secs
    dist.destroy()
    with open(out, "w") as f:
        json.dump(rec, f)


# [serve-lm-tp]: llama3-8b at full width in bf16, cut in depth; phi3.5-moe
# at 2 layers (split by experts); the fp32 gates at 2 layers of each
SERVE_TP_LAYERS, SERVE_TP_GATE = 4, 2
SERVE_TP_MOE = "phi3.5-moe-42b-a6.6b"
SERVE_TP_TOL = 1e-4     # fp32: max |logit - unsharded| over max |unsharded|


def serve_tp_rank(torch, tdist, dev, mesh, fresh, free, secs) -> dict:
    """``[serve-lm-tp]`` on one of ``[train-lm-tp]``'s two ranks: the
    sharded serving step (``MeshServe``: the prefill into this rank's
    block of the KV cache, then greedy decode steps) on the (1, 2) tp
    mesh, ``LM_BATCH`` x ``LM_PROMPT`` prompt tokens and ``LM_NEW``
    decode steps.

    * fp32 gates at ``SERVE_TP_GATE`` layers of llama3-8b and of
      phi3.5-moe: the prefill's logits (every position) and each decode
      step's against the port's unsharded step on this card from the same
      weights and the same decode inputs (the unsharded step's greedy
      tokens, fed to both), within ``SERVE_TP_TOL`` of max |logit|; the
      greedy tokens equal, except where the unsharded logits of the two
      tokens are within that tolerance (a near tie, counted); a token
      that an MoE layer routes to other experts in the two runs (its
      top-k near a tie, flipped by rounding) is counted, and it and its
      sequence's later positions are left out (at most half of them);
    * bf16, llama3-8b at ``SERVE_TP_LAYERS`` layers and phi3.5-moe at
      ``SERVE_TP_GATE``: a warm-up, then ms a prefill, ms a decode step
      and the peak a rank, beside the unsharded step's (rank 0 alone);
    * ``seq_parallel``: the fp32 tp train step (``TRAIN_BATCH`` x
      ``TRAIN_SEQ``) and the fp32 prefill at ``SERVE_TP_GATE`` layers with
      it against without it, from the same state;
    * zamba2-1.2b and xlstm-125m at full width, cut in depth
      (``TP_FAMILIES``): the fp32 gate on the (1, 2) tp mesh (their
      Mamba2 layers, shared block, mLSTM and sLSTM blocks split by
      heads), and at one row on a (2, 1) mesh of the same two ranks
      (zamba2's shared cache then splits its positions over 'data', and
      its decode combines the two blocks' softmax), the logits held to
      the unsharded step's exact (fp64) ones, as ``[train-lm-tp]`` holds
      these families' steps, within ``SERVE_TP_TOL`` more than the fp32
      unsharded step's own distance from them (zamba2's fp32 prefill
      amplifies rounding: no fp32 step is within the tolerance of the
      exact value); bf16 ms and peak on (1, 2) beside the unsharded
      step's;
    * every call's ``dist.calls`` against its plan, and the prefill's
      flash launches a rank (one a layer; one a zamba2 shared-block
      invocation)."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import cuda
    from repro_torch.launch import dist, train_lib
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import sharding as shd
    from repro_torch.models import transformer
    from repro_torch.models.api import build
    from repro_torch.optim import adamw

    B, L, N = LM_BATCH, LM_PROMPT, LM_NEW
    group = mesh.group(("model",))
    out = {}

    def inputs(cfg):
        g = torch.Generator(device=dev).manual_seed(1)
        return torch.randint(0, cfg.vocab_size, (B, L), generator=g,
                             device=dev, dtype=torch.int32)

    def vocab(x, split):
        # this rank's vocabulary block -> the whole vocabulary
        if "unembed" not in split:
            return x
        return dist.all_gather_rows(x.contiguous(), x.dim() - 1, group)

    def unsharded(cfg, prompts, feed=None, n=N):
        """The port's unsharded prefill and ``n`` decode steps (fed
        ``feed``, else greedy): logits, tokens, ms, peak."""
        p = fresh(cfg)
        model = build(cfg)
        free()
        torch.cuda.reset_peak_memory_stats()
        cache = model.init_cache(cfg, prompts.shape[0], L + n, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg, _ = model.forward(p, cfg, {"tokens": prompts}, cache=cache)
        tok = torch.argmax(lg[:, -1], dim=-1)
        torch.cuda.synchronize()
        ms_pre = (time.perf_counter() - t) * 1e3
        res = dict(prefill=lg, decode=[], tokens=[tok], ms_pre=ms_pre)
        t = time.perf_counter()
        for i in range(n):
            x = tok[:, None] if feed is None else feed[:, i: i + 1]
            lg, cache = model.decode(p, cfg, cache, {"tokens": x})
            tok = torch.argmax(lg[:, -1], dim=-1)
            res["decode"].append(lg[:, -1])
            res["tokens"].append(tok)
        torch.cuda.synchronize()
        res["ms_dec"] = (time.perf_counter() - t) * 1e3 / n
        res["peak"] = torch.cuda.max_memory_allocated() / 2**30
        del p, cache
        return res

    def sharded(cfg, prompts, feed=None, n=N, on=mesh):
        """The same through ``MeshServe`` on this rank's blocks of the mesh
        ``on``: logits over the whole vocabulary, tokens, ms, peak, flash
        launches of the prefill, and whether every call's collectives met
        its plan."""
        specs = train_lib.shardings_for(cfg, on, {})[0]
        pb = shd.shard_tree(fresh(cfg), specs, on)
        pre = train_lib.make_prefill_step(cfg, on)
        dec = train_lib.make_serve_step(cfg, on)
        free()
        torch.cuda.reset_peak_memory_stats()
        cache = pre.init_cache(prompts.shape[0], L + n, device=dev)
        batch = {"tokens": prompts}
        cuda.reset_launches()
        dist.calls.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg, cache = pre.logits(pb, batch, cache)
        tok = pre.greedy(lg)
        torch.cuda.synchronize()
        ms_pre = (time.perf_counter() - t) * 1e3
        flash = cuda.launches["flash_attention"]
        ok = dict(dist.calls) == train_lib.plan_calls(
            pre.plan(batch, max_len=L + n))
        res = dict(prefill=lg, decode=[], tokens=[tok], ms_pre=ms_pre,
                   flash=flash, split=sorted(pre.roles))
        ms = 0.0
        for i in range(n):
            x = tok[:, None] if feed is None else feed[:, i: i + 1]
            b = {"tokens": x}
            plan = train_lib.plan_calls(dec.plan(b, pos=cache["pos"],
                                                 max_len=L + n))
            dist.calls.clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            lg, cache = dec.logits(pb, b, cache)
            tok = dec.greedy(lg)
            torch.cuda.synchronize()
            ms += time.perf_counter() - t
            ok &= dict(dist.calls) == plan
            res["decode"].append(lg[:, -1])
            res["tokens"].append(tok)
        res.update(ms_dec=ms * 1e3 / n, calls_ok=bool(ok),
                   peak=torch.cuda.max_memory_allocated() / 2**30,
                   cache_block=list(cache["k"].shape) if "k" in cache
                   else {k: list((v[0] if type(v) is tuple else v).shape)
                         for k, v in cache.items()
                         if k not in ("pos", "len")})
        del pb, cache
        return res

    def exact(cfg, prompts, feed):
        """The unsharded step's logits on an fp64 copy of the seeded fp32
        weights and cache (``common.upcast`` keeps every fp32 accumulation
        in fp64; the attention plain, as the kernel has no fp64), fed
        ``feed``: the prefill's, then each decode step's last position."""
        model = build(cfg)
        f64 = lambda t: shd.map_with_path(
            lambda _, x: x.double() if torch.is_tensor(x) else x, t)
        p = f64(fresh(cfg))
        cache = f64(model.init_cache(cfg, prompts.shape[0], L + N,
                                     device=dev))
        with plain_attention():
            lg, _ = model.forward(p, cfg, {"tokens": prompts}, cache=cache)
            out = [lg]
            for i in range(N):
                lg, cache = model.decode(p, cfg, cache,
                                         {"tokens": feed[:, i: i + 1]})
                out.append(lg[:, -1])
        del p, cache
        free()
        return out

    @contextlib.contextmanager
    def routes(record):
        # each MoE layer call's top-k experts (sorted), (B, L, k)
        route = transformer._route

        def rec(x, p, c):
            out = route(x, p, c)
            record.append(torch.sort(out[0], dim=-1).values)
            return out
        transformer._route = rec
        try:
            yield
        finally:
            transformer._route = route

    def gate(cfg, n_rows=B, on=mesh, fp64=False):
        """The fp32 gate of ``cfg`` (see the docstring) on the first
        ``n_rows`` prompts and the mesh ``on``. Where an MoE layer routes a
        token to other experts in the two runs (top-k near a tie, flipped
        by rounding), that token and the later positions of its sequence
        (their capacity slots and attention depend on it) are counted and
        left out of the logits' comparison, and its row out of the decode
        steps' after it. With ``fp64`` the logits are held to the
        unsharded step's exact ones (:func:`exact`): each within
        ``SERVE_TP_TOL`` more than the fp32 unsharded step's own distance
        from them. Where the function amplifies fp32 rounding (zamba2's
        prefill: 1.8e-4 of max |logit| at 7 layers for the unsharded step
        too), no fp32 step is within the tolerance of the exact value,
        and two of them differ by as much again."""
        prompts = inputs(cfg)[:n_rows]
        r1, r2 = [], []
        with routes(r1):
            one = unsharded(cfg, prompts)
        feed = torch.stack(one["tokens"][:N], dim=1)   # its greedy inputs
        free()
        with routes(r2):
            got = sharded(cfg, prompts, feed, on=on)
        want_lg = [one["prefill"]] + one["decode"]
        got_lg = [vocab(x, got["split"])
                  for x in [got["prefill"]] + got["decode"]]
        held_to, own = want_lg, [0.0] * len(want_lg)
        if fp64:
            held_to = exact(cfg, prompts, feed)
            own = [rel_err(a, b) for a, b in zip(want_lg, held_to)]
        n = cfg.n_layers if cfg.is_moe else 0
        flip = torch.zeros((n_rows, L), dtype=torch.bool, device=dev)
        for x, y in zip(r1[:n], r2[:n]):
            flip |= (x != y).any(-1)
        first = torch.where(flip.any(1), flip.float().argmax(1),
                            torch.full((n_rows,), L, device=dev))
        keep = [torch.arange(L, device=dev)[None] < first[:, None]]
        rows = ~flip.any(1)
        for i in range(N):
            for x, y in zip(r1[n * (i + 1): n * (i + 2)],
                            r2[n * (i + 1): n * (i + 2)]):
                rows &= ~(x != y).any(-1)[:, 0]
            keep.append(rows.clone())
        errs = []
        for a, b, k in zip(got_lg, held_to, keep):
            d = torch.where(k[..., None], (a - b).abs(), 0.0)
            errs.append(float(d.max() / b.abs().max()))
        ties, off = 0, 0
        for a, b, lg, k in zip(got["tokens"], one["tokens"],
                               [x[:, -1] if x.dim() == 3 else x
                                for x in want_lg], keep):
            k = k[:, -1] if k.dim() == 2 else k
            diff = (a != b) & k
            if bool(diff.any()):
                idx = torch.nonzero(diff)[:, 0]
                gap = (lg[idx, b[idx]] - lg[idx, a[idx]]).abs()
                near = gap <= SERVE_TP_TOL * lg.abs().max()
                ties += int(near.sum())
                off += int((~near).sum())
        res = dict(err_prefill=errs[0], err_decode=max(errs[1:]),
                   own_prefill=own[0], own_decode=max(own[1:]),
                   fp64=fp64, ties=ties, off=off, calls_ok=got["calls_ok"],
                   flash=got["flash"], split=got["split"],
                   cache_block=got["cache_block"],
                   flips=int(sum(int((x != y).any(-1).sum())
                                 for x, y in zip(r1, r2))),
                   left_out=int((~keep[0]).sum()),
                   rows_left_out=int((~keep[-1]).sum()),
                   ok=bool(all(e <= SERVE_TP_TOL + o
                               for e, o in zip(errs, own)) and off == 0
                           and got["calls_ok"]
                           and int((~keep[0]).sum()) <= n_rows * L // 2))
        del one, got, want_lg, got_lg, held_to
        free()
        return res

    def timed(cfg):
        """bf16: a warm-up, then the sharded step a rank and the unsharded
        step on rank 0 alone (greedy)."""
        prompts = inputs(cfg)
        sharded(cfg, prompts, n=2)                      # warm-up
        free()
        got = sharded(cfg, prompts)
        finite = all(bool(torch.isfinite(x).all())
                     for x in [got["prefill"]] + got["decode"])
        res = dict(ms_pre=got["ms_pre"], ms_dec=got["ms_dec"],
                   peak=got["peak"], flash=got["flash"],
                   calls_ok=got["calls_ok"], finite=finite,
                   split=got["split"], cache_block=got["cache_block"],
                   sample=[int(t[0]) for t in got["tokens"][:8]])
        del got
        free()
        tdist.barrier()
        if tdist.get_rank() == 0:
            unsharded(cfg, prompts, n=2)                 # warm-up
            free()
            one = unsharded(cfg, prompts)
            res["unsharded"] = dict(ms_pre=one["ms_pre"],
                                    ms_dec=one["ms_dec"], peak=one["peak"])
            del one
            free()
        tdist.barrier()
        return res

    llama = configs.full_config(LM_ARCH)
    moe = configs.full_config(SERVE_TP_MOE)
    t0 = time.perf_counter()
    for name, cfg in ((LM_ARCH, llama), (SERVE_TP_MOE, moe)):
        out[f"gate {name}"] = gate(dataclasses.replace(
            cfg, n_layers=SERVE_TP_GATE, dtype="float32"))
    secs["serve fp32 gates"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out[f"bf16 {LM_ARCH}"] = timed(dataclasses.replace(
        llama, n_layers=SERVE_TP_LAYERS))
    out[f"bf16 {SERVE_TP_MOE}"] = timed(dataclasses.replace(
        moe, n_layers=SERVE_TP_GATE))
    secs["serve bf16"] = time.perf_counter() - t0

    # seq_parallel: the fp32 tp train step and prefill with it and without
    t0 = time.perf_counter()
    cfg = dataclasses.replace(llama, n_layers=SERVE_TP_GATE, dtype="float32")
    tp = TokenPipeline(cfg.vocab_size, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                       seed=0)
    batch = {k: torch.as_tensor(a, device=dev)
             for k, a in tp.batch_at(0).items()}
    ocfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=20, decay_steps=100)
    specs = train_lib.shardings_for(cfg, mesh, {})[0]
    steps = {}
    for sp in (False, True):
        c = dataclasses.replace(cfg, seq_parallel=sp)
        step = train_lib.make_train_step(c, ocfg, mesh)
        pb = shd.shard_tree(fresh(c), specs, mesh)
        dist.calls.clear()
        pb, ob, m = step(pb, adamw.init(pb), batch)
        steps[sp] = dict(loss=float(m["loss"]), gn=float(m["grad_norm"]),
                         lr=float(m["lr"]), params=adamw.leaves(pb),
                         m=adamw.leaves(ob["m"]),
                         calls_ok=dict(dist.calls) == train_lib.plan_calls(
                             step.plan(batch)),
                         rs=dist.calls["reduce_scatter"])
        del ob
        free()
    a, b = steps[True], steps[False]
    worst, excused = 0.0, True
    for x, w, g in zip(a["params"], b["params"], b["m"]):
        d = (x - w).abs()
        worst = max(worst, float(d.max()))
        bad = d > 1e-5
        if bool(bad.any()):
            noisy = (g / 0.1).abs() < TP_NOISE * float((g / 0.1).abs().max())
            excused &= bool(noisy[bad].all()) and float(d.max()) <= 2 * b["lr"]
    prompts = inputs(cfg)
    pre = {}
    for sp in (False, True):
        c = dataclasses.replace(cfg, seq_parallel=sp)
        srv = train_lib.make_prefill_step(c, mesh)
        pb = shd.shard_tree(fresh(c), specs, mesh)
        dist.calls.clear()
        lg, _ = srv.logits(pb, {"tokens": prompts})
        srv.greedy(lg)
        ok = dict(dist.calls) == train_lib.plan_calls(
            srv.plan({"tokens": prompts}))
        pre[sp] = (vocab(lg, srv.roles), ok)
        del pb, lg
    err = rel_err(pre[True][0], pre[False][0])
    out["seq_parallel"] = dict(
        loss=[a["loss"], b["loss"]], gn=[a["gn"], b["gn"]], worst=worst,
        excused=excused, prefill_err=err, rs=a["rs"],
        calls_ok=a["calls_ok"] and b["calls_ok"] and pre[True][1]
        and pre[False][1],
        ok=bool(abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"])
                and abs(a["gn"] - b["gn"]) <= 1e-5 * abs(b["gn"])
                and excused and err <= SERVE_TP_TOL and a["rs"] > 0
                and a["calls_ok"] and b["calls_ok"] and pre[True][1]
                and pre[False][1]))
    del steps, a, b, pre
    free()
    secs["serve seq_parallel"] = time.perf_counter() - t0

    # zamba2 and xlstm-125m: the fp32 gates on (1, 2) and at one row on
    # (2, 1), then bf16 ms and peak on (1, 2)
    mesh21 = meshlib.make_mesh((2, 1), ("data", "model"))
    for arch, n_layers in TP_FAMILIES:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(configs.full_config(arch),
                                  n_layers=n_layers)
        f32 = dataclasses.replace(cfg, dtype="float32")
        out[f"gate {arch}"] = gate(f32, fp64=True)
        out[f"gate {arch} b1"] = gate(f32, n_rows=1, on=mesh21, fp64=True)
        secs[f"serve fp32 {arch}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out[f"bf16 {arch}"] = timed(cfg)
        secs[f"serve bf16 {arch}"] = time.perf_counter() - t0
    return out


def start_train_lm_tp() -> dict:
    """Start ``[train-lm-tp]``'s two rank processes, which import while the
    earlier phases hold the card and wait for :func:`train_lm_tp`. Killed
    at exit if still running."""
    import atexit
    import os
    import tempfile
    tmp = tempfile.TemporaryDirectory()
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2")
    outs = [f"{tmp.name}/rank{r}.json" for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
         f"import chip_smoke; chip_smoke.tp_rank({r}, {port}, "
         f"{outs[r]!r})"], cwd=ROOT, env=env, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]

    def stop():
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    atexit.register(stop)
    return dict(procs=procs, outs=outs, tmp=tmp, stop=stop)


def train_lm_tp(run, card) -> dict:
    """``[train-lm-tp]``: the tensor-parallel train step (``MeshStep`` under
    the tp layout: the 'model' axis splits heads, FFN width and vocabulary)
    on a (1, 2) ('data', 'model') mesh of two processes on this card, in an
    explicit gloo group (NCCL takes one rank a card): llama3-8b at full
    width, ``TP_LAYERS`` of its 32 layers, ``TRAIN_BATCH`` x ``TRAIN_SEQ``
    tokens a step.

    * fp32: one step from the seeded init against the unsharded step from
      the same state — loss and grad norm within 1e-5 relative, every
      param within 1e-5 except where the unsharded gradient is under
      ``TP_NOISE`` of its leaf's max |g| (then within 2 lr: Adam's first
      step moves an element by about lr, of its gradient's sign);
    * bf16, remat full: 1 warm-up + ``TP_STEPS`` steps, ms a step and the
      peak device memory a rank, beside the unsharded step's (run by rank
      0 alone), and 2 x layers flash launches a rank a step;
    * fsdp (the same mesh, 'model' folded into the batch axes: a 2-way
      FSDP), ``FSDP_LAYERS`` layers, bf16, remat full, one step with the
      per-layer gather and one with ``gather_params_once`` from the same
      init: the loss, every block of the params and both moments bitwise
      equal (fingerprints; each gradient element is a sum of two fp32
      addends on both paths), the per-layer peak a rank at least
      ``FSDP_SAVES_GIB`` below the whole gather's, ms and peak printed;
    * zamba2-1.2b and xlstm-125m at full width, cut in depth
      (``TP_FAMILIES``), their Mamba2 layers, shared block, mLSTM and
      sLSTM blocks split by heads: the fp32 step from the seeded init
      against the unsharded step from the same state, its loss and grad
      norm within 1e-5 of the unsharded step's exact value (on an fp64
      copy of the state: these gradients amplify fp32 rounding, so an
      fp32 unsharded step may sit further from it than the tolerance;
      both fp32 steps' distances are printed), its params by the rule
      above against the fp32 unsharded step; a warm-up and a bf16 remat
      step a rank, ms and peak beside the unsharded step's; zamba2's
      flash launches a rank a step equal to its shared block's
      invocations;
    * every step's ``dist.calls`` equal to ``MeshStep.plan``.

    Both ranks share the card and gloo stages every collective through
    the host, so the times say what this path costs here, not what two
    cards would take. ``run`` is :func:`start_train_lm_tp`'s. Returns its
    flash launches for the kernels line."""
    phase("train-lm-tp")
    t0 = time.perf_counter()
    procs = run["procs"]
    try:
        for proc in procs:               # both, before either is waited on
            proc.stdin.write("go\n")
            proc.stdin.flush()
        logs = [proc.communicate(timeout=600)[0] for proc in procs]
    finally:
        run["stop"]()
    if any(proc.returncode for proc in procs):
        fail("[train-lm-tp] a rank failed:\n"
             + "\n".join(log[-3000:] for log in logs))
    recs = []
    for o in run["outs"]:
        with open(o) as f:
            recs.append(json.load(f))
    run["tmp"].cleanup()
    want_flash = 2 * TP_LAYERS
    bad = []
    for r, rec in enumerate(recs):
        f32 = rec["fp32"]
        print(f"[train-lm-tp] rank {r} fp32, {LM_ARCH} full width, "
              f"{TP_LAYERS} layers, {TRAIN_BATCH} x {TRAIN_SEQ} tokens, split "
              f"over 'model': {f32['split']}; loss {f32['loss']:.7f} / "
              f"unsharded {f32['want']['loss']:.7f}, grad norm "
              f"{f32['gn']:.7f} / {f32['want']['gn']:.7f}; params off by "
              f"{f32['worst']:.3e} at most, {f32['off']} over 1e-5, all "
              f"where the gradient is under {TP_NOISE} of its leaf's max and "
              f"within 2 lr: {f32['excused']}; collectives {f32['calls']} "
              f"== plan: {f32['calls_ok']}; gate: {f32['ok']}", flush=True)
        if not f32["ok"] or f32["flash"] != want_flash:
            bad.append(f"rank {r} fp32")
        b16 = rec["bf16"]
        runs = b16["runs"]
        ms = [round(x["ms"], 1) for x in runs]
        calls = all(x["calls"] == b16["plan"] for x in runs)
        flash = [x["flash"] for x in runs]
        losses = [x["loss"] for x in runs]
        print(f"[train-lm-tp] rank {r} bf16 remat full: losses {losses}; "
              f"ms a step {ms} (first: warm-up); peak {b16['peak_gib']:.2f} "
              f"GiB, {b16['held_gib']:.2f} held between steps; flash "
              f"launches a step {flash} (want {want_flash}); collectives a "
              f"step {runs[0]['calls']} == plan: {calls}; seconds by part "
              f"{ {k: round(v, 1) for k, v in rec['seconds'].items()} }",
              flush=True)
        if not (calls and all(f == want_flash for f in flash)
                and all(math.isfinite(x) for x in losses)):
            bad.append(f"rank {r} bf16")
        fs = rec["fsdp"]
        per, once = fs["per_layer"], fs["once"]
        same = per["loss_bits"] == once["loss_bits"] and \
            per["fps"] == once["fps"]
        saved = once["peak_gib"] - per["peak_gib"]
        secs = rec["seconds"]
        for tag, x in (("per-layer gather", per),
                       ("gather_params_once", once)):
            print(f"[train-lm-tp] rank {r} fsdp (1, 2), {LM_ARCH} full "
                  f"width, {FSDP_LAYERS} layers, bf16, remat full, one "
                  f"step, {tag}: loss {x['loss']}; {x['ms']:.1f} ms; peak "
                  f"{x['peak_gib']:.2f} GiB; flash launches {x['flash']} "
                  f"(want {2 * FSDP_LAYERS}); collectives {x['calls']} == "
                  f"plan: {x['calls'] == x['plan']}", flush=True)
        print(f"[train-lm-tp] rank {r} fsdp: loss, params and both moments "
              f"bitwise equal between the two: {same}; the per-layer peak "
              f"{saved:.2f} GiB below the whole gather's (want >= "
              f"{FSDP_SAVES_GIB}); seconds {secs['fsdp per layer']:.1f} / "
              f"{secs['fsdp once']:.1f}", flush=True)
        if not (same and saved >= FSDP_SAVES_GIB
                and all(x["calls"] == x["plan"]
                        and x["flash"] == 2 * FSDP_LAYERS
                        and math.isfinite(x["loss"]) for x in (per, once))):
            bad.append(f"rank {r} fsdp")
    fam_launches = {}
    for arch, n_layers in TP_FAMILIES:
        one = recs[0]["families"][arch]["unsharded"]
        for r, rec in enumerate(recs):
            fr = rec["families"][arch]
            f32, b16, want = fr["fp32"], fr["bf16"], fr["want_flash"]
            w = f32["want"]
            print(f"[train-lm-tp] rank {r} {arch} full width, {n_layers} "
                  f"layers, fp32: split over 'model': {f32['split']}; loss "
                  f"{f32['loss']:.9f} / unsharded fp32 {w['loss']:.9f}, fp64 "
                  f"{w['exact_loss']:.9f}; grad norm {f32['gn']:.9f} / "
                  f"unsharded fp32 {w['gn']:.9f}, fp64 {w['exact_gn']:.9f} "
                  f"(off fp64 by {f32['gn'] / w['exact_gn'] - 1:+.2e} split, "
                  f"{w['gn'] / w['exact_gn'] - 1:+.2e} unsharded; the gate "
                  f"holds the split step's loss and norm to fp64 at 1e-5); "
                  f"params off by {f32['worst']:.3e} at most, {f32['off']} "
                  f"over 1e-5, all where the gradient is under {TP_NOISE} of "
                  f"its leaf's max and within 2 lr: {f32['excused']}; "
                  f"collectives {f32['calls']} == plan: {f32['calls_ok']}; "
                  f"flash {f32['flash']} (want {want}); gate: {f32['ok']}",
                  flush=True)
            runs = b16["runs"]
            calls = all(x["calls"] == b16["plan"] for x in runs)
            flash = [x["flash"] for x in runs]
            losses = [x["loss"] for x in runs]
            print(f"[train-lm-tp] rank {r} {arch} bf16 remat full: losses "
                  f"{losses}; ms a step {[round(x['ms'], 1) for x in runs]} "
                  f"(first: warm-up) against the unsharded step's "
                  f"{[round(x['ms'], 1) for x in one['runs']]} (rank 0 "
                  f"alone); peak {b16['peak_gib']:.2f} GiB a rank against "
                  f"{one['peak_gib']:.2f}; flash a step {flash} (want "
                  f"{want}); collectives a step {runs[0]['calls']} == plan: "
                  f"{calls}; card {card}", flush=True)
            if not (f32["ok"] and f32["flash"] == want and calls
                    and all(f == want for f in flash)
                    and all(math.isfinite(x) for x in losses)):
                bad.append(f"rank {r} {arch}")
        fam_launches[arch] = dict(
            layers=n_layers, steps_a_rank=1 + len(recs[0]["families"][arch]
                                                  ["bf16"]["runs"]),
            launches=sum(x["flash"] for rec in recs for x in
                         rec["families"][arch]["bf16"]["runs"]
                         + [rec["families"][arch]["fp32"]]))
    one = recs[0]["unsharded"]
    print(f"[train-lm-tp] unsharded bf16 step (rank 0 alone): losses "
          f"{[x['loss'] for x in one['runs']]}; ms a step "
          f"{[round(x['ms'], 1) for x in one['runs']]}; peak "
          f"{one['peak_gib']:.2f} GiB; the phase "
          f"{time.perf_counter() - t0:.1f} s; card {card}", flush=True)
    if bad:
        fail(f"[train-lm-tp] gates failed: {bad}")
    launches = sum(x["flash"] for rec in recs
                   for x in rec["bf16"]["runs"] + [rec["fp32"]])
    launches = {"train_lm_tp_launches": {
        "ranks": 2, "steps_a_rank": 2 + TP_STEPS, "launches": launches,
        "arch": LM_ARCH, "layers": TP_LAYERS,
        "fsdp_steps_a_rank": 2, "fsdp_layers": FSDP_LAYERS,
        "fsdp_launches": sum(x["flash"] for rec in recs
                             for x in rec["fsdp"].values()),
        "families": fam_launches}}
    launches["serve_lm_tp_launches"] = serve_lm_tp(recs, card)
    return launches


def serve_lm_tp(recs, card) -> dict:
    """``[serve-lm-tp]``'s report and gates, from the two ranks' records
    (:func:`serve_tp_rank`); returns the prefills' flash launches a rank
    for the kernels line."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models.api import build
    phase("serve-lm-tp")
    bad, flash = [], {}
    for r, rec in enumerate(recs):
        sv = rec["serve"]
        for name in (LM_ARCH, SERVE_TP_MOE):
            g = sv[f"gate {name}"]
            print(f"[serve-lm-tp] rank {r} {name} full width, "
                  f"{SERVE_TP_GATE} layers, fp32, {LM_BATCH} x {LM_PROMPT} "
                  f"prompt + {LM_NEW} decode steps on (1, 2), split over "
                  f"'model': {g['split']}; cache block {g['cache_block']}; "
                  f"prefill logits off the unsharded step's by "
                  f"{g['err_prefill']:.3e} of max |logit|, decode steps by "
                  f"{g['err_decode']:.3e} at most (<= {SERVE_TP_TOL}); "
                  f"greedy tokens differ at {g['ties'] + g['off']} (near "
                  f"ties {g['ties']}); MoE tokens routed to other experts "
                  f"than unsharded {g['flips']} (layer calls x tokens), "
                  f"prefill positions left out {g['left_out']} of "
                  f"{LM_BATCH * LM_PROMPT}, rows left out of the last "
                  f"decode step {g['rows_left_out']}; flash a prefill "
                  f"{g['flash']} (want "
                  f"{SERVE_TP_GATE}); collectives == plan: {g['calls_ok']}; "
                  f"gate: {g['ok']}; card {card}", flush=True)
            if not (g["ok"] and g["flash"] == SERVE_TP_GATE):
                bad.append(f"rank {r} fp32 {name}")
        for name, layers in ((LM_ARCH, SERVE_TP_LAYERS),
                             (SERVE_TP_MOE, SERVE_TP_GATE)):
            t = sv[f"bf16 {name}"]
            one = recs[0]["serve"][f"bf16 {name}"]["unsharded"]
            flash.setdefault(f"rank {r}", {})[name] = dict(
                layers=layers, flash_a_prefill=t["flash"])
            print(f"[serve-lm-tp] rank {r} {name} full width, {layers} "
                  f"layers, bf16, {LM_BATCH} x {LM_PROMPT} + {LM_NEW} greedy "
                  f"steps: prefill {t['ms_pre']:.1f} ms, decode "
                  f"{t['ms_dec']:.2f} ms a step, peak {t['peak']:.2f} GiB a "
                  f"rank; the unsharded step (rank 0 alone) "
                  f"{one['ms_pre']:.1f} ms, {one['ms_dec']:.2f} ms, "
                  f"{one['peak']:.2f} GiB; cache block {t['cache_block']}; "
                  f"flash a prefill {t['flash']} (want {layers}); "
                  f"collectives == plan: {t['calls_ok']}; finite: "
                  f"{t['finite']}; tokens of row 0 {t['sample']}; card "
                  f"{card}", flush=True)
            if not (t["calls_ok"] and t["finite"] and t["flash"] == layers):
                bad.append(f"rank {r} bf16 {name}")
        sp = sv["seq_parallel"]
        print(f"[serve-lm-tp] rank {r} seq_parallel, {LM_ARCH} full width, "
              f"{SERVE_TP_GATE} layers, fp32: the tp train step "
              f"({TRAIN_BATCH} x {TRAIN_SEQ}) with it / without it: loss "
              f"{sp['loss'][0]:.7f} / {sp['loss'][1]:.7f}, grad norm "
              f"{sp['gn'][0]:.7f} / {sp['gn'][1]:.7f}, params off by "
              f"{sp['worst']:.3e} at most (any over 1e-5 where the gradient "
              f"is under {TP_NOISE} of its leaf's max and within 2 lr: "
              f"{sp['excused']}); {sp['rs']} reduce-scatters; the prefill's "
              f"logits off by {sp['prefill_err']:.3e} of max |logit|; "
              f"collectives == plan: {sp['calls_ok']}; gate: {sp['ok']}; "
              f"seconds {rec['seconds'].get('serve-lm-tp', 0.0):.1f}; card "
              f"{card}", flush=True)
        if not sp["ok"]:
            bad.append(f"rank {r} seq_parallel")
        for arch, layers in TP_FAMILIES:
            cfg = dataclasses.replace(configs.full_config(arch),
                                      n_layers=layers)
            want = build(cfg)._group_struct(cfg)[0] \
                if cfg.family == "hybrid" else 0
            for key, rows, on in (("", LM_BATCH, "(1, 2)"),
                                  (" b1", 1, "(2, 1)")):
                g = sv[f"gate {arch}{key}"]
                print(f"[serve-lm-tp] rank {r} {arch} full width, {layers} "
                      f"layers, fp32, {rows} x {LM_PROMPT} prompt + "
                      f"{LM_NEW} decode steps on {on}, split over 'model': "
                      f"{g['split']}; cache blocks {g['cache_block']}; "
                      f"prefill logits off the unsharded step's exact (fp64) "
                      f"ones by {g['err_prefill']:.3e} of max |logit|, "
                      f"decode steps by {g['err_decode']:.3e} at most (the "
                      f"fp32 unsharded step's own {g['own_prefill']:.3e} / "
                      f"{g['own_decode']:.3e}; each <= it + "
                      f"{SERVE_TP_TOL}); "
                      f"greedy tokens against the fp32 unsharded step's "
                      f"differ at "
                      f"{g['ties'] + g['off']} (near ties {g['ties']}); "
                      f"flash a prefill {g['flash']} (want {want}); "
                      f"collectives == plan: {g['calls_ok']}; gate: "
                      f"{g['ok']}; card {card}", flush=True)
                flash.setdefault(f"rank {r}", {})[f"{arch} fp32 {on}"] = \
                    dict(layers=layers, flash_a_prefill=g["flash"])
                if not (g["ok"] and g["flash"] == want):
                    bad.append(f"rank {r} fp32 {arch} {on}")
            t = sv[f"bf16 {arch}"]
            one = recs[0]["serve"][f"bf16 {arch}"]["unsharded"]
            flash[f"rank {r}"][f"{arch} bf16 (1, 2)"] = dict(
                layers=layers, flash_a_prefill=t["flash"])
            print(f"[serve-lm-tp] rank {r} {arch} full width, {layers} "
                  f"layers, bf16, {LM_BATCH} x {LM_PROMPT} + {LM_NEW} greedy "
                  f"steps on (1, 2): prefill {t['ms_pre']:.1f} ms, decode "
                  f"{t['ms_dec']:.2f} ms a step, peak {t['peak']:.2f} GiB a "
                  f"rank; the unsharded step (rank 0 alone) "
                  f"{one['ms_pre']:.1f} ms, {one['ms_dec']:.2f} ms, "
                  f"{one['peak']:.2f} GiB; flash a prefill {t['flash']} "
                  f"(want {want}); collectives == plan: {t['calls_ok']}; "
                  f"finite: {t['finite']}; tokens of row 0 {t['sample']}; "
                  f"seconds fp32 "
                  f"{rec['seconds'].get(f'serve fp32 {arch}', 0.0):.1f}, "
                  f"bf16 {rec['seconds'].get(f'serve bf16 {arch}', 0.0):.1f}"
                  f"; card {card}", flush=True)
            if not (t["calls_ok"] and t["finite"] and t["flash"] == want):
                bad.append(f"rank {r} bf16 {arch}")
    if bad:
        fail(f"[serve-lm-tp] gates failed: {bad}")
    return flash


def start_dryrun() -> dict:
    """Start ``[dryrun]``: ``python -m repro_torch.launch.dryrun --all
    --both-meshes`` on this machine's CPU (no card visible to it), three
    cells at a time, beside the next phases; its record goes to a
    temporary file. Killed at exit if still running."""
    import atexit
    import os
    import tempfile
    tmp = tempfile.TemporaryDirectory()
    out = os.path.join(tmp.name, "dryrun.json")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   p for p in (str(SRC), os.environ.get("PYTHONPATH")) if p))
    cmd = ["-m", "repro_torch.launch.dryrun", "--all", "--both-meshes",
           "--jobs", "3", "--out", out]
    proc = subprocess.Popen([sys.executable, *cmd], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    atexit.register(stop)
    return dict(proc=proc, out=out, tmp=tmp, stop=stop,
                t0=time.perf_counter())


def check_dryrun(run) -> None:
    """Wait for :func:`start_dryrun` and hold it: exit 0, no error cell, the
    reference's skips (long_500k of the 8 full-attention archs, on both
    meshes); print the counts and llama3-8b x train_4k's row."""
    phase("dryrun")
    try:
        out, err = run["proc"].communicate(timeout=600)
    except subprocess.TimeoutExpired:
        fail("the dry-run ran past 600 s")
    finally:
        run["stop"]()
    wall = time.perf_counter() - run["t0"]
    if run["proc"].returncode != 0:
        fail(f"the dry-run exited {run['proc'].returncode}:\n"
             f"{out[-2000:]}\n{err[-3000:]}")
    with open(run["out"]) as f:
        recs = json.load(f)
    run["tmp"].cleanup()
    n = {k: sum(r["status"] == k for r in recs)
         for k in ("ok", "skip", "error")}
    skips = sorted((r["arch"], r["shape"]) for r in recs
                   if r["status"] == "skip")
    row = next(r for r in recs if (r["arch"], r["shape"], r["mesh"])
               == (LM_ARCH, "train_4k", "16x16"))
    secs = sum(r.get("flops_seconds", 0.0) for r in recs)
    print(f"[dryrun] --all --both-meshes on the CPU, 3 cells at a time "
          f"beside the card's phases: {n['ok']} ok, {n['skip']} skip, "
          f"{n['error']} error, collected {wall:.1f} s after its start "
          f"({secs:.1f} s of meta FLOP passes)", flush=True)
    print(f"[dryrun] {LM_ARCH} x train_4k x 16x16: "
          + json.dumps({k: row[k] for k in (
              "layout", "accum_steps", "memory", "model_flops",
              "flops_global", "useful_ratio", "link_bytes_per_chip",
              "collectives", "t_compute_s", "t_memory_s", "t_collective_s",
              "dominant")}), flush=True)
    want = sorted((a, "long_500k") for a in {r["arch"] for r in recs}
                  if a not in ("xlstm-125m", "zamba2-1.2b")) * 2
    if n["error"] or n["ok"] != 64 or skips != sorted(want):
        fail(f"dry-run: {n}, skips {skips}")


def leaf_paths(tree, prefix="") -> list:
    """The ``/``-joined leaf paths of a nested dict in ``adamw.leaves``
    order (keys sorted)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += (leaf_paths(v, f"{prefix}{k}/") if isinstance(v, dict)
                else [prefix + k])
    return out


# the kernel each phase of a main path must launch: (train, wss2, serve)
HOT = {"dense": ("gamma_update", "rbf_rows2", "rbf_accumulate"),
       "ell": ("ell_gamma_update", "ell_kernel_rows2", "ell_rbf_accumulate")}
# the scale of the Single-policy wss2 fits, [wss2-cache]'s, [dist-ell]'s
# and [chaos]'s w7a fit among them: cut from 0.2 to 0.1 to keep the smoke
# inside its time limit with the full-size cached a9a fit, to 0.05 when
# the LM family phases came in (a slow host ran the smoke in 1,183 s of its
# 1,200 s at 0.1), and to 0.035 when the tensor-parallel LM phase came in
# (a slow host: 1,230.1 s; at 0.035 a9a still compacts twice and w7a once);
# their gates (converged, fp64 gap, bits) hold at any scale
WSS2_SCALE = 0.035


def run_path(torch, np, dev, time_ms, dataset, fmt) -> tuple:
    """One main path through the entry points a user calls: a full-size
    fit of ``dataset`` (C=32, sigma2=64, multi5pc, wss1) to convergence, a
    Single-policy wss2 fit at ``WSS2_SCALE``, and ``SVMModel.predict`` over the
    test rows. ``fmt='dense'`` feeds numpy rows; ``fmt='ell'`` feeds CSR to
    ``format='ell'`` training and serving. Launch counts are reset just
    before each phase and read just after it. Returns the trained model,
    the wss2 fit's model, the launches of each phase's kernel and the test
    rows."""
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
    X2, y2, _, _ = make(dataset, WSS2_SCALE, seed=0)
    cuda.reset_launches()
    t0 = time.perf_counter()
    m2 = SMOSolver(SVMConfig(**dict(kw, selection="wss2",
                                    heuristic="single5pc"))).fit(
        feed(X2), y2)
    torch.cuda.synchronize()
    launches[k_wss2] = cuda.launches[k_wss2]
    s2 = m2.stats
    gap2 = eq9_gap(torch, X2, y2, m2.alpha, 32.0, INV, dev)
    print(f"[wss2{sfx}] {dataset} scale {WSS2_SCALE} n={X2.shape[0]} "
          f"single5pc{fed}: "
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
    return model, m2, launches, Xt


def serve_bf16(torch, np, dev, time_ms, paths) -> dict:
    """``[serve-bf16]``: the full-size a9a and w7a models of the main paths
    (``paths``: label, model, test rows, the kernel its serving launches)
    served with bf16 SVs, through ``ServeEngine(dtype='bfloat16')`` and
    through ``compact(dtype='bfloat16')``, over their test rows (w7a fed
    as CSR). Gates: each engine holds bf16 values on the card and launches
    its accumulate; its scores are bitwise those of an fp32 engine over
    the same bf16-rounded SVs, and within the reference's storage-rounding
    envelope of the fp32 scores (rtol 2e-2, atol 3e-2). Prints the
    resident bytes and the device µs a query at B 64 / 4,096 both ways."""
    import dataclasses
    from repro_torch.core import ServeEngine, bf16
    from repro_torch.data import to_csr
    from repro_torch.kernels import cuda
    phase("serve-bf16")
    out = {}
    same_bits = lambda a, b: np.array_equal(a.view(np.int32),
                                            b.view(np.int32))
    for label, model, Xt, k_serve in paths:
        dense = model.sv_vals is None
        feed = Xt if dense else to_csr(Xt)
        field = "sv_x" if dense else "sv_vals"
        as_f32 = lambda m, f=field: dataclasses.replace(
            m, **{f: bf16.widen(bf16.round_bf16(getattr(m, f)))})
        e32 = model.serve_engine()
        s32 = e32.decision_function(feed)
        e16 = ServeEngine(model, dtype="bfloat16")
        cuda.reset_launches()
        s16 = e16.decision_function(feed)
        torch.cuda.synchronize()
        n16 = cuda.launches[k_serve]
        c16 = model.compact(dtype="bfloat16")
        ec = c16.serve_engine()
        sc = ec.decision_function(feed)
        held = [(e._data.X if dense else e._data.vals) for e in (e16, ec)]
        bitwise = (same_bits(s16, ServeEngine(as_f32(model))
                             .decision_function(feed))
                   and same_bits(sc, ServeEngine(as_f32(c16))
                                 .decision_function(feed)))
        env = [float(np.max(np.abs(s - s32) / (3e-2 + 2e-2 * np.abs(s32))))
               for s in (s16, sc)]
        us = {}
        for name, eng in (("fp32", e32), ("bf16", e16)):
            for b in (64, 4096):
                zb = np.zeros((b, eng.width), np.float32)
                zb[:, : Xt.shape[1]] = np.resize(Xt, (b, Xt.shape[1]))
                zb = torch.as_tensor(zb, device=dev)
                us[f"{name}_{b}"] = time_ms(eng.score_bucket, (zb,),
                                            reps=20) * 1e3 / b
        mem = [e.memory_bytes() for e in (e32, e16, ec)]
        print(f"[serve-bf16] {label}: {Xt.shape[0]} test rows, {e16.n_sv} "
              f"SVs (compact {ec.n_sv}); resident bytes fp32 {mem[0]}, bf16 "
              f"{mem[1]}, compact bf16 {mem[2]}; scores bitwise equal to an "
              f"fp32 engine over the rounded SVs: {bitwise}; max |bf16 - "
              f"fp32| / (3e-2 + 2e-2 |fp32|) engine {env[0]:.3f}, compact "
              f"{env[1]:.3f} (<= 1); device us/query B=64 fp32 "
              f"{us['fp32_64']:.3f} bf16 {us['bf16_64']:.3f}, B=4096 fp32 "
              f"{us['fp32_4096']:.3f} bf16 {us['bf16_4096']:.3f}; {k_serve} "
              f"launches={n16}", flush=True)
        if not all(t.dtype == torch.bfloat16 and t.is_cuda for t in held) \
                or e16.describe()["dtype"] != "bfloat16" \
                or ec.describe()["dtype"] != "bfloat16":
            fail(f"{label}: the bf16 engines do not hold bf16 SVs on the card")
        if not bitwise:
            fail(f"{label}: bf16 scores differ from the fp32 engine over the "
                 "rounded SVs")
        if not max(env) <= 1.0:
            fail(f"{label}: bf16 scores outside the storage-rounding "
                 "envelope of fp32")
        if n16 <= 0:
            fail(f"{label}: bf16 serving did not launch {k_serve}")
        out[k_serve] = dict(launches=n16, memory_bytes=mem, us_per_query=us)
    return out


def start_clis() -> dict:
    """Start ``[cli-train]`` and ``[cli-serve]`` (see :func:`check_clis`),
    the two command lines as subprocesses on the card, both at once; they
    run while the caller drives the next phases. Every process started
    here is killed at exit if it is still running."""
    import atexit
    import os
    import tempfile
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(SRC), os.environ.get("PYTHONPATH")) if p))
    a9a = ["--dataset", "a9a", "--scale", str(DIST_SCALE)]
    tmp = tempfile.TemporaryDirectory()
    report = os.path.join(tmp.name, "serve.json")
    cmds = {"cli-train": ["-m", "repro_torch.launch.svm_train", *a9a],
            "cli-serve": ["-m", "repro_torch.launch.serve", "--svm", *a9a,
                          "--compact", "--dtype", "bfloat16", "--roofline",
                          "--json-out", report]}
    procs = {k: subprocess.Popen([sys.executable, *c], cwd=ROOT, env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, c in cmds.items()}

    def stop():
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    atexit.register(stop)
    return dict(cmds=cmds, procs=procs, report=report, tmp=tmp, stop=stop,
                t0=time.perf_counter())


def check_clis(clis, base) -> None:
    """Wait for the command lines of :func:`start_clis` and hold them.
    ``[cli-train]``: ``python -m repro_torch.launch.svm_train --dataset a9a
    --scale DIST_SCALE`` (C 32, σ² 64, multi5pc, wss1: its a9a defaults)
    prints the iterations and SVs (``base``: ``{"iterations", "n_sv"}``)
    of ``[dist]``'s ``SMOSolver`` fit of the same config. ``[cli-serve]``: ``python -m
    repro_torch.launch.serve --svm`` of the same model, compacted to bf16,
    with ``--roofline --json-out``: a positive p50, a bf16 engine and the
    roofline row's keys. A non-zero exit or a difference fails."""
    from repro_torch.launch import roofline
    cmds, res = clis["cmds"], {}
    try:
        for k, p in clis["procs"].items():
            phase(k)
            try:
                res[k] = (*p.communicate(timeout=600), p.returncode)
            except subprocess.TimeoutExpired:
                fail(f"{' '.join(cmds[k][:2])} ran past 600 s")
    finally:
        clis["stop"]()
    wall = time.perf_counter() - clis["t0"]
    for k, (out, err, rc) in res.items():
        phase(k)
        if rc != 0:
            fail(f"{' '.join(cmds[k][:2])} exited {rc}:\n{err[-3000:]}")
    phase("cli-train")
    line = next((ln for ln in res["cli-train"][0].splitlines()
                 if ln.startswith("a9a/multi5pc: ")), "")
    got = dict(kv.split("=", 1) for kv in line.split()[1:] if "=" in kv)
    print(f"[cli-train] python {' '.join(cmds['cli-train'])}: {line!r}; "
          f"[dist]'s SMOSolver fit: iters={base['iterations']} "
          f"nsv={base['n_sv']}; both command lines collected {wall:.1f} s "
          f"after their start", flush=True)
    if (got.get("iters"), got.get("nsv"), got.get("conv")) != (
            str(base["iterations"]), str(base["n_sv"]), "True"):
        fail("the training CLI's fit differs from [dist]'s SMOSolver fit")
    phase("cli-serve")
    with open(clis["report"]) as f:
        rep = json.load(f)
    clis["tmp"].cleanup()
    rf = rep.get("roofline", {})
    keys = sorted(roofline.analyze(1.0, 1.0, 0.0, 1, 1.0).row())
    print(f"[cli-serve] python {' '.join(cmds['cli-serve'][:10])}: engine "
          f"{rep['engine']}; p50 {rep['p50_s'] * 1e3:.3f} ms, p99 "
          f"{rep['p99_s'] * 1e3:.3f} ms at batch {rep['batch']}; roofline "
          f"dominant={rf.get('dominant')} t_compute={rf.get('t_compute_s')} "
          f"t_memory={rf.get('t_memory_s')} useful_ratio="
          f"{rf.get('useful_ratio')}", flush=True)
    if not (rep["p50_s"] > 0 and rep["engine"]["dtype"] == "bfloat16"
            and sorted(rf) == keys):
        fail("the serving CLI's report lacks a p50, a bf16 engine or the "
             "roofline row")


# the row cache's own workload at the reference's benchmark size
# (benchmarks/sparse_bench.py): make_repeat_heavy(3072, 768, 0.25, seed=1)
CACHE_SET = (3072, 768, 0.25, 1)
CACHE_FIT = dict(C=8.0, sigma2=96.0, eps=1e-5, heuristic="original",
                 chunk_iters=512)
CACHE_SLOTS = 2048


def rel_gap(a, b) -> float:
    return abs(a - b) / abs(b)


def cache_workload(torch, np, dev) -> dict:
    """``[cache]``: six fits of the repeat-heavy workload — dense wss1, ELL
    wss1 (the dense rows fed with ``format='ell'``) and dense wss2, each
    with the row cache off and on (2,048 slots, LRU). Every fit converges
    (fp64 Eq. 9 gap <= 2 eps); with the cache on, hits + misses = 2 x
    iterations, the hit rate is >= 0.5 and the rows come from the two-row
    kernel (wss1 launches no fused update); wss2 is bitwise equal on and
    off; wss1 (off runs the fused update) keeps the outcome contract.
    Returns each cached fit's two-row kernel launches, keyed by kernel and
    then by fit."""
    from repro_torch.core import SVMConfig, SMOSolver
    from repro_torch.data import make_repeat_heavy
    from repro_torch.kernels import cuda
    phase("cache")
    X, y = make_repeat_heavy(*CACHE_SET[:3], seed=CACHE_SET[3])
    inv = 1.0 / (2.0 * CACHE_FIT["sigma2"])
    eps = CACHE_FIT["eps"]
    launches = {}
    for label, extra in (("dense wss1", {}), ("ell wss1", {"format": "ell"}),
                         ("dense wss2", {"selection": "wss2"})):
        rows2 = "ell_kernel_rows2" if "ell" in label else "rbf_rows2"
        fused = "ell_gamma_update" if "ell" in label else "gamma_update"
        fits = {}
        for on in (False, True):
            kw = dict(CACHE_FIT, device="cuda", **extra)
            if on:
                kw.update(row_cache=True, row_cache_slots=CACHE_SLOTS)
            cuda.reset_launches()
            t0 = time.perf_counter()
            m = SMOSolver(SVMConfig(**kw)).fit(X, y)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n_rows2, n_fused = cuda.launches[rows2], cuda.launches[fused]
            st = m.stats
            gap = eq9_gap(torch, X, y, m.alpha, CACHE_FIT["C"], inv, dev)
            obj = m.dual_objective()
            fits[on] = (m, obj)
            looked = st.cache_hits + st.cache_misses
            print(f"[cache] {label} cache {'on ' if on else 'off'} "
                  f"n={X.shape[0]} d={X.shape[1]}: iterations="
                  f"{st.iterations} hits={st.cache_hits} misses="
                  f"{st.cache_misses} hit_rate={st.cache_hit_rate:.4f} "
                  f"us/iter={1e6 * st.train_time / max(st.iterations, 1):.1f}"
                  f" dual_objective={obj:.6f} eq9_gap_all={gap:.3e} (<= "
                  f"2eps {2 * eps:.0e}) wall={wall:.1f} s {rows2} launches="
                  f"{n_rows2} {fused} launches={n_fused}", flush=True)
            if not (st.converged and gap <= 2 * eps):
                fail(f"{label} cache {on}: converged={st.converged}, gap "
                     f"{gap:.3e}")
            if on:
                if looked != 2 * st.iterations:
                    fail(f"{label}: hits + misses {looked} != 2 x "
                         f"{st.iterations} iterations")
                if st.cache_hit_rate < 0.5:
                    fail(f"{label}: hit rate {st.cache_hit_rate:.4f} < 0.5")
                if n_rows2 <= 0 or (label.endswith("wss1") and n_fused):
                    fail(f"{label}: the cached fit launched {rows2} "
                         f"{n_rows2} and {fused} {n_fused} times")
                launches.setdefault(rows2, {})[f"cache {label}"] = n_rows2
        (m0, o0), (m1, o1) = fits[False], fits[True]
        if label.endswith("wss2"):
            if not (m1.stats.iterations == m0.stats.iterations
                    and np.array_equal(m1.alpha, m0.alpha)):
                fail(f"{label}: cache on differs from off")
            how = "bitwise equal (alpha, iterations)"
        else:
            agree = float((m1.predict(X) == m0.predict(X)).mean())
            if not (rel_gap(o1, o0) <= 5e-4 and agree >= 0.995):
                fail(f"{label}: cache on vs off: dual objective "
                     f"{rel_gap(o1, o0):.3e} apart, labels {agree:.4f}")
            how = (f"dual objective {rel_gap(o1, o0):.3e} apart (<= 5e-4), "
                   f"labels {agree:.4f} equal (>= 0.995)")
        print(f"[cache] {label}: cache on vs off {how}; us/iter "
              f"{1e6 * m1.stats.train_time / m1.stats.iterations:.1f} on, "
              f"{1e6 * m0.stats.train_time / m0.stats.iterations:.1f} off",
              flush=True)
    return launches


def train_cache(torch, np, dev, base) -> dict:
    """``[train-cache]``: ``[dist]``'s a9a fit (``DIST_SCALE``, C=32,
    sigma2=64, multi5pc, wss1) with the row cache on (64 slots, LRU):
    converged (fp64 gap <= 2e-3), at least one compaction (the device
    remap) and one reconstruction (the rewarm), hits > 0, rows from the
    two-row kernel and no fused update, and bitwise equal (alpha,
    iterations) to ``[dist]``'s ``SMOSolver`` fit ``base``. Cut from the
    full-size a9a fit, whose cache checks this fit makes as well. Returns the cached fit's ``rbf_rows2`` launches."""
    from repro_torch.core import SVMConfig, SMOSolver
    from repro_torch.data import make
    from repro_torch.kernels import cuda
    phase("train-cache")
    X, y, _, _ = make("a9a", DIST_SCALE, seed=0)
    kw = dict(C=32.0, sigma2=64.0, heuristic="multi5pc", selection="wss1",
              device="cuda", row_cache=True)
    cuda.reset_launches()
    t0 = time.perf_counter()
    m = SMOSolver(SVMConfig(**kw)).fit(X, y)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_rows2 = cuda.launches["rbf_rows2"]
    n_fused = cuda.launches["gamma_update"]
    st, sb = m.stats, base.stats
    gap = eq9_gap(torch, X, y, m.alpha, 32.0, INV, dev)
    same = (st.iterations == sb.iterations
            and np.array_equal(m.alpha.view(np.int32),
                               base.alpha.view(np.int32)))
    us = lambda s: 1e6 * s.train_time / max(s.iterations, 1)
    print(f"[train-cache] a9a scale {DIST_SCALE} n={X.shape[0]} "
          f"d={X.shape[1]} dense row_cache 64 slots lru: iterations="
          f"{st.iterations} ([dist] single device: {sb.iterations}) "
          f"compactions={st.compactions} "
          f"reconstructions={st.reconstructions} buffer_sizes="
          f"{st.buffer_sizes} hits={st.cache_hits} misses={st.cache_misses} "
          f"hit_rate={st.cache_hit_rate:.4f} converged={st.converged} "
          f"eq9_gap_all={gap:.3e} (<= 2eps 2e-03) wall={wall:.1f} s "
          f"us/iter={us(st):.1f} (cache off: {us(sb):.1f}); alpha and "
          f"iterations bitwise equal to [dist]'s single-device fit: {same}; "
          f"rbf_rows2 launches={n_rows2} gamma_update launches={n_fused}",
          flush=True)
    if not (st.converged and gap <= 2e-3):
        fail(f"cached training: converged={st.converged}, gap {gap:.3e}")
    if not (st.compactions >= 1 and st.reconstructions >= 1
            and st.cache_hits > 0):
        fail(f"cached training: compactions {st.compactions}, "
             f"reconstructions {st.reconstructions}, hits {st.cache_hits}")
    if n_rows2 <= 0 or n_fused:
        fail(f"cached training launched rbf_rows2 {n_rows2} and "
             f"gamma_update {n_fused} times")
    if not same:
        fail("cached training differs from [dist]'s single-device fit")
    return {"rbf_rows2": {"train-cache a9a": n_rows2}}


def wss2_cache(torch, np, dev, base) -> dict:
    """``[wss2-cache]``: the ``[wss2]`` fit (a9a at ``WSS2_SCALE``, single5pc)
    with the row cache on, bitwise equal to it (alpha and iterations)
    through shrink and un-shrink, its rows from ``rbf_rows2``. Returns that
    fit's ``rbf_rows2`` launches."""
    from repro_torch.core import SVMConfig, SMOSolver
    from repro_torch.data import make
    from repro_torch.kernels import cuda
    phase("wss2-cache")
    X2, y2, _, _ = make("a9a", WSS2_SCALE, seed=0)
    kw = dict(C=32.0, sigma2=64.0, heuristic="single5pc", selection="wss2",
              device="cuda", row_cache=True)
    cuda.reset_launches()
    t0 = time.perf_counter()
    m2 = SMOSolver(SVMConfig(**kw)).fit(X2, y2)
    torch.cuda.synchronize()
    n_rows2 = cuda.launches["rbf_rows2"]
    s2, sb = m2.stats, base.stats
    same = (s2.iterations == sb.iterations
            and np.array_equal(m2.alpha, base.alpha))
    us = lambda s: 1e6 * s.train_time / max(s.iterations, 1)
    print(f"[wss2-cache] a9a scale {WSS2_SCALE} n={X2.shape[0]} single5pc "
          f"row_cache: "
          f"iterations={s2.iterations} ([wss2]: {sb.iterations}) "
          f"reconstructions={s2.reconstructions} hits={s2.cache_hits} "
          f"misses={s2.cache_misses} hit_rate={s2.cache_hit_rate:.4f} "
          f"wall={time.perf_counter() - t0:.1f} s us/iter={us(s2):.1f} "
          f"([wss2]: {us(sb):.1f}); alpha and iterations bitwise equal to "
          f"[wss2]: {same}; rbf_rows2 launches={n_rows2}", flush=True)
    if n_rows2 <= 0:
        fail("the cached wss2 fit did not launch rbf_rows2")
    if not same:
        fail("the cached wss2 fit differs from [wss2]")
    return {"rbf_rows2": {"wss2-cache a9a": n_rows2}}


# the scale of [dist]'s a9a fits (n 814, full width; each still compacts
# three times and reconstructs twice, and [chaos]'s kill at half its 17
# dispatches leaves two complete steps): cut from 0.1 because the group's
# fit and its single-device twin took 84 s there, over the ~100 s the
# three distributed phases may add to the smoke, from 0.05 when the LM
# family phases came in (a slow host ran the smoke in 1,080-1,183 s), from
# 0.04 when the sharded LM phase came in (a slow host: 1,205.0 s), and from
# 0.03 when the tensor-parallel one came in (a slow host: 1,230.1 s)
DIST_SCALE = 0.025


def free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def dist_fit_line(st, us_single, calls) -> str:
    us = 1e6 * st.train_time / max(st.iterations, 1)
    per = {k: v / max(st.iterations, 1) for k, v in sorted(calls.items())}
    return (f"iterations={st.iterations} compactions={st.compactions} "
            f"reconstructions={st.reconstructions} dispatches="
            f"{st.dispatches} us/iter={us:.1f} (single device: "
            f"{us_single:.1f}) collectives/iter=" + ", ".join(
                f"{k} {v:.3f}" for k, v in per.items()))


def dist_fits(torch, np, dev) -> tuple:
    """The distributed solver (``core.parallel.ParallelSMOSolver``) on the
    NCCL process group of one rank — this card — that the caller set up:

    * ``[dist]``: a9a at ``DIST_SCALE`` (C 32, sigma2 64, multi5pc, wss1),
      ``SMOSolver`` and the group's solver, bitwise equal in alpha,
      iterations, compactions and reconstructions (at least one of each),
      converged with the fp64 Eq. 9 gap <= 2e-3, ``gamma_update``
      launched;
    * ``[dist-ell]``: w7a at ``WSS2_SCALE`` fed as CSR, single5pc wss2
      (``[wss2-ell]``'s fit), ``SMOSolver`` and the group's solver bitwise
      equal, the rows from ``ell_kernel_rows2``.

    With two or more cards it also runs ``[dist]`` at world size
    min(4, cards), one process a card, against the single fit's outcome.
    Returns each phase's launches of its kernel, by kernel and then by
    fit, and the two ``SMOSolver`` fits (the twins of ``[chaos]``)."""
    from repro_torch.core import SVMConfig, SMOSolver
    from repro_torch.core.parallel import ParallelSMOSolver
    from repro_torch.data import make, to_csr
    from repro_torch.kernels import cuda
    from repro_torch.launch import dist
    out = {}
    phase("dist")
    X, y, Xt, _ = make("a9a", DIST_SCALE, seed=0)
    kw = dict(C=32.0, sigma2=64.0, heuristic="multi5pc", selection="wss1",
              device="cuda")
    ms = SMOSolver(SVMConfig(**kw)).fit(X, y)
    us_single = 1e6 * ms.stats.train_time / max(ms.stats.iterations, 1)
    cuda.reset_launches()
    dist.calls.clear()
    t0 = time.perf_counter()
    mp = ParallelSMOSolver(SVMConfig(**kw)).fit(X, y)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_gu = cuda.launches["gamma_update"]
    calls = dict(dist.calls)
    st = mp.stats
    gap = eq9_gap(torch, X, y, mp.alpha, 32.0, INV, dev)
    same = (np.array_equal(mp.alpha.view(np.int32), ms.alpha.view(np.int32))
            and [st.iterations, st.compactions, st.reconstructions]
            == [ms.stats.iterations, ms.stats.compactions,
                ms.stats.reconstructions])
    print(f"[dist] a9a scale {DIST_SCALE} n={X.shape[0]} d={X.shape[1]} "
          f"NCCL world 1: {dist_fit_line(st, us_single, calls)} "
          f"converged={st.converged} eq9_gap_all={gap:.3e} (<= 2eps 2e-03)"
          f" wall={wall:.1f} s; alpha, iterations, compactions and "
          f"reconstructions bitwise equal to SMOSolver: {same}; "
          f"gamma_update launches={n_gu}", flush=True)
    if not same:
        fail("the world-size-1 fit differs from SMOSolver's")
    if not (st.compactions >= 1 and st.reconstructions >= 1):
        fail("the distributed fit neither compacted nor reconstructed")
    if not (st.converged and gap <= 2e-3):
        fail(f"distributed fit: converged={st.converged}, gap {gap:.3e}")
    if n_gu <= 0:
        fail("the distributed fit did not launch gamma_update")
    out["gamma_update"] = {"dist a9a": n_gu}
    cards = torch.cuda.device_count()
    if cards >= 2:
        world = min(4, cards)
        got = dist_spawn(world, X, y, kw)
        dist_outcome(torch, np, dev, world, got, ms, X, y, Xt)
    else:
        print(f"[dist] {cards} card: only world size 1 ran (NCCL allows one "
              "rank a card)", flush=True)

    phase("dist-ell")
    X2, y2, _, _ = make("w7a", WSS2_SCALE, seed=0)
    kw2 = dict(C=32.0, sigma2=64.0, heuristic="single5pc", selection="wss2",
               format="ell", device="cuda")
    Xc2 = to_csr(X2)
    w7a_wss2 = SMOSolver(SVMConfig(**kw2)).fit(Xc2, y2)
    us_single = 1e6 * w7a_wss2.stats.train_time / max(
        w7a_wss2.stats.iterations, 1)
    cuda.reset_launches()
    dist.calls.clear()
    t0 = time.perf_counter()
    me = ParallelSMOSolver(SVMConfig(**kw2)).fit(Xc2, y2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_r2 = cuda.launches["ell_kernel_rows2"]
    st, sb = me.stats, w7a_wss2.stats
    gap = eq9_gap(torch, X2, y2, me.alpha, 32.0, INV, dev)
    same = (np.array_equal(me.alpha.view(np.int32),
                           w7a_wss2.alpha.view(np.int32))
            and [st.iterations, st.compactions, st.reconstructions]
            == [sb.iterations, sb.compactions, sb.reconstructions])
    print(f"[dist-ell] w7a scale {WSS2_SCALE} n={X2.shape[0]} single5pc "
          f"wss2 CSR in, NCCL world 1: "
          f"{dist_fit_line(st, us_single, dict(dist.calls))} "
          f"converged={st.converged} eq9_gap_all={gap:.3e} (<= 2eps 2e-03)"
          f" wall={wall:.1f} s; alpha, iterations, compactions and "
          f"reconstructions bitwise equal to SMOSolver: {same}; "
          f"ell_kernel_rows2 launches={n_r2}", flush=True)
    if not same:
        fail("the world-size-1 ELL wss2 fit differs from SMOSolver's")
    if not (st.compactions >= 1 and st.reconstructions >= 1):
        fail("the distributed ELL fit neither compacted nor reconstructed")
    if not (st.converged and gap <= 2e-3):
        fail(f"distributed ELL fit: converged={st.converged}, gap {gap:.3e}")
    if n_r2 <= 0:
        fail("the distributed ELL fit did not launch ell_kernel_rows2")
    out["ell_kernel_rows2"] = {"dist-ell w7a": n_r2}
    return out, ms, w7a_wss2


def dist_serve(torch, np, a9a, Xt_a9a) -> dict:
    """``[dist-serve]``: ``ServeEngine(shards=None)`` — the group's size,
    through the sharded path's fp64 all-reduce — on an NCCL process group
    of one rank, bitwise equal to ``[serve]``'s scores, ``rbf_accumulate``
    launched. Returns its launches, by kernel and then by fit."""
    from repro_torch.core import ServeEngine
    from repro_torch.kernels import cuda
    from repro_torch.launch import dist
    phase("dist-serve")
    dist.init(device="cuda", init_method=f"tcp://localhost:{free_port()}",
              rank=0, world=1)
    eng = ServeEngine(a9a, shards=None)
    cuda.reset_launches()
    dist.calls.clear()
    t0 = time.perf_counter()
    scores = eng.decision_function(Xt_a9a)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_acc = cuda.launches["rbf_accumulate"]
    base = a9a.decision_function(Xt_a9a)
    same = np.array_equal(scores.view(np.int32), base.view(np.int32))
    print(f"[dist-serve] a9a {Xt_a9a.shape[0]} test rows, {a9a.stats.n_sv} "
          f"SVs, ServeEngine(shards=None) on NCCL world 1 "
          f"({eng.describe()['shards']} shard, all_reduce calls "
          f"{dist.calls['all_reduce']}): predict wall={wall:.3f} s; scores "
          f"bitwise equal to [serve]: {same}; rbf_accumulate launches="
          f"{n_acc}", flush=True)
    if not same:
        fail("the group's serving engine scores differ from [serve]'s")
    if n_acc <= 0:
        fail("the group's serving engine did not launch rbf_accumulate")
    dist.destroy()
    return {"rbf_accumulate": {"dist-serve a9a": n_acc}}


def dist_rank(rank, world, init, X, y, kw, path) -> None:
    """One rank of the multi-card ``[dist]`` run (a spawned process)."""
    import numpy as np
    sys.path.insert(0, str(SRC))
    from repro_torch.core import SVMConfig
    from repro_torch.core.parallel import ParallelSMOSolver
    from repro_torch.launch import dist
    dist.init(device="cuda", init_method=init, rank=rank, world=world)
    m = ParallelSMOSolver(SVMConfig(**kw)).fit(X, y)
    if rank == 0:
        np.savez(path, alpha=m.alpha, sv_x=m.sv_x, sv_coef=m.sv_coef,
                 beta=m.beta, stats=np.array([
                     m.stats.iterations, m.stats.compactions,
                     m.stats.reconstructions, int(m.stats.converged),
                     1e6 * m.stats.train_time / max(m.stats.iterations, 1)]))
    dist.destroy()


def dist_spawn(world, X, y, kw) -> dict:
    """``[dist]`` at ``world`` ranks, one a card; rank 0's model."""
    import numpy as np
    import torch.multiprocessing as tmp
    path = ROOT / "build" / f"dist-{world}.npz"
    path.parent.mkdir(exist_ok=True)
    tmp.spawn(dist_rank, args=(world, f"tcp://localhost:{free_port()}", X,
                               y, kw, str(path)), nprocs=world, join=True)
    return dict(np.load(path))


def dist_outcome(torch, np, dev, world, got, ms, X, y, Xt) -> None:
    """The multi-card fit against the single-device one: the outcome
    contract (verdict, dual objective 5e-4 relative, test labels >= 99.5%,
    the fp64 Eq. 9 gap <= 2e-3)."""
    import dataclasses
    from repro_torch.core import SVMConfig
    it, comp, recon, conv, us = got["stats"]
    model = dataclasses.replace(ms, sv_x=got["sv_x"],
                                sv_coef=got["sv_coef"],
                                beta=float(got["beta"]), alpha=got["alpha"])
    model.__dict__.pop("_engines", None)
    gap = eq9_gap(torch, X, y, got["alpha"], 32.0, INV, dev)
    obj = rel_gap(model.dual_objective(), ms.dual_objective())
    agree = float((model.predict(Xt) == ms.predict(Xt)).mean())
    print(f"[dist] a9a scale {DIST_SCALE} NCCL world {world} (one card a "
          f"rank): iterations={int(it)} compactions={int(comp)} "
          f"reconstructions={int(recon)} converged={bool(conv)} "
          f"us/iter={us:.1f} eq9_gap_all={gap:.3e} (<= 2e-03) dual "
          f"objective {obj:.3e} from the single fit's (<= 5e-4), test "
          f"labels {agree:.4f} equal (>= 0.995)", flush=True)
    if not (conv and gap <= 2e-3 and obj <= 5e-4 and agree >= 0.995):
        fail(f"the world-{world} fit breaks the outcome contract")


def dist_multi(torch, np, multi) -> dict:
    """``[dist-multi]``: the covtype problems of ``[multi-loop]`` through
    ``MultiProblemDriver(parallel=True)`` on the process group (one rank
    here), bitwise equal per problem (alpha, iterations) to the batched
    single-device cache-off fit. Returns its ``gamma_update`` launches."""
    from repro_torch.core import MultiProblemDriver, SVMConfig
    from repro_torch.kernels import cuda
    from repro_torch.launch import dist
    phase("dist-multi")
    X, _, Y, _, base, _ = multi
    cuda.reset_launches()
    dist.calls.clear()
    t0 = time.perf_counter()
    mp = MultiProblemDriver(SVMConfig(**COVTYPE, **MULTI_FIT),
                            parallel=True).fit_tasks(X, Y)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_gu = cuda.launches["gamma_update"]
    st = mp[0].stats
    same = all(
        r["iterations"] == b.stats.per_problem[k]["iterations"]
        and np.array_equal(m.alpha.view(np.int32), b.alpha.view(np.int32))
        for k, (r, m, b) in enumerate(zip(st.per_problem, mp, base)))
    per = {k: v / max(st.joint_iters, 1) for k, v in sorted(dist.calls.items())}
    print(f"[dist-multi] covtype scale {COVTYPE_SCALE} n={X.shape[0]} "
          f"K={Y.shape[0]} NCCL world 1: iterations={st.iterations} "
          f"joint_iters={st.joint_iters} dispatches={st.dispatches} "
          f"reconstructions={st.reconstructions} converged={st.converged} "
          f"wall={wall:.1f} s us/problem-iter="
          f"{1e6 * st.train_time / max(st.iterations, 1):.1f} (batched "
          f"single device: {1e6 * base[0].stats.train_time / max(base[0].stats.iterations, 1):.1f}) "
          f"collectives/joint iter=" + ", ".join(
              f"{k} {v:.3f}" for k, v in per.items())
          + f"; alpha and iterations bitwise equal to [multi-loop]'s "
          f"batched fit per problem: {same}; gamma_update launches={n_gu}",
          flush=True)
    if not same:
        fail("the group's batched fit differs from the single-device one")
    if not st.converged:
        fail("the group's batched fit did not converge")
    if n_gu < st.iterations:
        fail(f"the group's batched fit launched gamma_update {n_gu} times "
             f"for {st.iterations} problem-iterations")
    return {"gamma_update": {"dist-multi covtype": n_gu}}


# [chaos]: the a9a fit's saves land every CHAOS_EVERY segments; the
# watchdog flags a dispatch slower than CHAOS_THRESHOLD x the running median
# and one dispatch is delayed by at least CHAOS_DELAY s (a9a dispatches take
# ~0.35-0.5 s)
CHAOS_EVERY = 4
CHAOS_THRESHOLD = 5.0
CHAOS_DELAY = 2.0


def killed(what, fit, **plan):
    """Run ``fit`` under ``chaos.FaultPlan(**plan)``; fail unless the
    planned kill fires. Returns the plan's record."""
    from repro_torch.launch import chaos
    with chaos.inject(chaos.FaultPlan(**plan)) as p:
        try:
            fit()
        except chaos.InjectedKill:
            return p
    fail(f"{what}: the kill ({plan}) did not fire")


def timed_fit(torch, fit, hot) -> tuple:
    """``fit()`` with the launch counts reset just before it: (its result,
    the launches of kernel ``hot``, its wall seconds)."""
    from repro_torch.kernels import cuda
    cuda.reset_launches()
    t0 = time.perf_counter()
    m = fit()
    torch.cuda.synchronize()
    return m, cuda.launches[hot], time.perf_counter() - t0


def chaos_paths(torch, np, dev, a9a_dist, w7a_wss2) -> dict:
    """The fault-tolerance path (``SVMConfig(checkpoint_dir=..., resume=
    ...)``, ``launch.chaos``): fits killed by the chaos harness and resumed
    from their step dirs (under a temporary directory), each bitwise equal
    to a fit an earlier phase ran uncut, converged, with the fp64 Eq. 9 gap
    over all samples <= 2e-3, and launching its kernel.

    ``[chaos]``:
    * ``[dist]``'s a9a fit (``DIST_SCALE``, dense, multi5pc, wss1, a save
      every ``CHAOS_EVERY`` segments), killed at half its dispatches and
      resumed; the same kill with its newest step bit-flipped, resumed
      from the step before; and one dispatch delayed by at least
      ``CHAOS_DELAY`` s under ``watchdog_threshold=CHAOS_THRESHOLD``: one
      straggle event, one forced step dir, the same bits (twin:
      ``[dist]``'s ``SMOSolver`` fit);
    * ``[dist-ell]``'s ``SMOSolver`` w7a fit (``[wss2-ell]``'s: scale
      ``WSS2_SCALE``, CSR in, single5pc, wss2) killed at save 2 and
      resumed from save 1;
    * ``[dist]``'s a9a fit on the NCCL group of one rank, killed and
      resumed.

    A kill that does not fire, a resume that starts fresh (or from another
    step) or any difference fails the phase. Returns the launches of each
    fit's kernel, by kernel and then by fit."""
    import dataclasses
    import shutil
    import tempfile
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.core import SMOSolver, SVMConfig
    from repro_torch.core.parallel import ParallelSMOSolver
    from repro_torch.data import make, to_csr
    from repro_torch.launch import chaos
    launches: dict = {}
    tmp = tempfile.mkdtemp(prefix="chaos_smoke_")
    t_phases = time.perf_counter()

    def held(label, key, got, twin, X, y, C, inv, hot, step):
        m, n, wall = got
        st = m.stats
        gap = eq9_gap(torch, X, y, m.alpha, C, inv, dev)
        same = (st.iterations == twin.stats.iterations and np.array_equal(
            m.alpha.view(np.int32), twin.alpha.view(np.int32)))
        print(f"[{PHASE}] {label}: resumed_from={st.resumed_from} (want "
              f"{step}) iterations={st.iterations} (uncut "
              f"{twin.stats.iterations}) converged={st.converged} "
              f"eq9_gap_all={gap:.3e} (<= 2eps 2e-03) wall={wall:.1f} s; "
              f"alpha bitwise equal to the uncut fit: {same}; {hot} "
              f"launches={n}", flush=True)
        if st.resumed_from < 0:
            fail(f"{label}: the resume started fresh")
        if st.resumed_from != step:
            fail(f"{label}: resumed from step {st.resumed_from}, not {step}")
        if not same:
            fail(f"{label}: the resumed fit differs from the uncut one")
        if not (st.converged and gap <= 2e-3):
            fail(f"{label}: converged={st.converged}, gap {gap:.3e}")
        if n <= 0:
            fail(f"{label}: the resumed fit did not launch {hot}")
        launches.setdefault(hot, {})[key] = n

    try:
        phase("chaos")
        X, y, _, _ = make("a9a", DIST_SCALE, seed=0)
        kw = dict(C=32.0, sigma2=64.0, heuristic="multi5pc",
                  selection="wss1", device="cuda")
        d = f"{tmp}/a9a"
        cfg = SVMConfig(**kw, checkpoint_dir=d, checkpoint_every=CHAOS_EVERY)
        kill = a9a_dist.stats.dispatches // 2
        plan = killed("a9a", lambda: SMOSolver(cfg).fit(X, y),
                      kill_at_dispatch=kill)
        steps = ck.complete_steps(d)
        print(f"[chaos] a9a scale {DIST_SCALE} n={X.shape[0]} killed at "
              f"dispatch {plan.dispatches - 1} of "
              f"{a9a_dist.stats.dispatches}: complete steps {steps}",
              flush=True)
        if len(steps) < 2:
            fail(f"the killed a9a fit left {len(steps)} complete steps")
        shutil.copytree(d, d + "_flip")
        held(f"a9a killed at dispatch {kill}", "chaos a9a kill",
             timed_fit(torch, lambda: SMOSolver(dataclasses.replace(
                 cfg, resume=True)).fit(X, y), "gamma_update"),
             a9a_dist, X, y, 32.0, INV, "gamma_update", steps[-1])
        chaos.corrupt_step(d + "_flip", mode="flip")
        if ck.complete_steps(d + "_flip") != steps[:-1]:
            fail("the bit-flipped step still reads as complete")
        held("a9a, newest step bit-flipped", "chaos a9a flip",
             timed_fit(torch, lambda: SMOSolver(dataclasses.replace(
                 cfg, checkpoint_dir=d + "_flip", resume=True)).fit(X, y),
                 "gamma_update"),
             a9a_dist, X, y, 32.0, INV, "gamma_update", steps[-2])

        wd = dataclasses.replace(
            cfg, checkpoint_dir=d + "_wd", checkpoint_every=10**6,
            watchdog_threshold=CHAOS_THRESHOLD)
        # at dispatch 5 the watchdog's median is over dispatches 0-4, the
        # slowest of the fit (full buffer): the delay is held at twice the
        # threshold over the slowest of them in the uncut twin, so a host
        # slower than usual cannot hide it
        delay = max(CHAOS_DELAY, 2.0 * CHAOS_THRESHOLD
                    * max(a9a_dist.stats.dispatch_times[:5]))
        with chaos.inject(chaos.FaultPlan(delay_dispatch=5,
                                          delay_seconds=delay)):
            m, n, wall = timed_fit(torch, lambda: SMOSolver(wd).fit(X, y),
                                   "gamma_update")
        st, forced = m.stats, ck.complete_steps(d + "_wd")
        times = sorted(st.dispatch_times)
        same = np.array_equal(m.alpha.view(np.int32),
                              a9a_dist.alpha.view(np.int32))
        print(f"[chaos] a9a, dispatch 5 delayed {delay:.2f} s under "
              f"watchdog_threshold={CHAOS_THRESHOLD}: straggle_events="
              f"{st.straggle_events} forced steps {forced} dispatch median "
              f"{times[len(times) // 2]:.3f} s, max {times[-1]:.3f} s "
              f"iterations={st.iterations} wall={wall:.1f} s; alpha bitwise "
              f"equal to the uncut fit: {same}; gamma_update launches={n}",
              flush=True)
        if st.straggle_events != 1 or len(forced) != 1:
            fail(f"the watchdog flagged {st.straggle_events} dispatches and "
                 f"forced {len(forced)} saves, not one")
        if not (same and st.iterations == a9a_dist.stats.iterations):
            fail("the delayed fit differs from the uncut one")
        launches["gamma_update"]["chaos a9a watchdog"] = n

        X2, y2, _, _ = make("w7a", WSS2_SCALE, seed=0)
        every = max(1, w7a_wss2.stats.dispatches // 6)
        cfg2 = SVMConfig(C=32.0, sigma2=64.0, heuristic="single5pc",
                         selection="wss2", format="ell", device="cuda",
                         checkpoint_dir=f"{tmp}/w7a", checkpoint_every=every)
        Xc2 = to_csr(X2)
        killed("w7a", lambda: SMOSolver(cfg2).fit(Xc2, y2), kill_at_save=2)
        steps = ck.complete_steps(cfg2.checkpoint_dir)
        if len(steps) != 2:
            fail(f"killed at save 2, the w7a fit left steps {steps}")
        held(f"w7a scale {WSS2_SCALE} CSR in single5pc wss2, killed at save "
             f"2 (a save every {every} segments)", "chaos w7a wss2",
             timed_fit(torch, lambda: SMOSolver(dataclasses.replace(
                 cfg2, resume=True)).fit(Xc2, y2), "ell_kernel_rows2"),
             w7a_wss2, X2, y2, 32.0, INV, "ell_kernel_rows2", steps[-1])

        cfg3 = dataclasses.replace(cfg, checkpoint_dir=f"{tmp}/nccl")
        killed("a9a on NCCL", lambda: ParallelSMOSolver(cfg3).fit(X, y),
               kill_at_dispatch=kill)
        steps = ck.complete_steps(cfg3.checkpoint_dir)
        held("a9a on the NCCL group of one rank, killed at dispatch "
             f"{kill}", "chaos a9a NCCL world 1",
             timed_fit(torch, lambda: ParallelSMOSolver(dataclasses.replace(
                 cfg3, resume=True)).fit(X, y), "gamma_update"),
             a9a_dist, X, y, 32.0, INV, "gamma_update",
             steps[-1] if steps else -2)

        print(f"[chaos] took {time.perf_counter() - t_phases:.1f} s",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def chaos_multi(torch, np, dev, twins) -> dict:
    """``[chaos-multi]``: ``[multi-loop]``'s batched covtype wss1 and wss2
    fits and its news20 ELL fit (``twins``), each killed mid-sweep by the
    chaos harness and resumed from its step dir (under a temporary
    directory), bitwise per problem (alpha, iterations), converged with
    every problem's fp64 Eq. 9 gap <= 2e-3, launching its kernel. A kill
    that does not fire, a resume that starts fresh or any difference fails
    the phase. Returns the launches of each fit's kernel, by kernel and
    then by fit."""
    import dataclasses
    import shutil
    import tempfile
    from repro_torch.core import MultiProblemDriver, SVMConfig
    phase("chaos-multi")
    launches: dict = {}
    tmp = tempfile.mkdtemp(prefix="chaos_multi_smoke_")
    t_phase = time.perf_counter()
    try:
        for label, (Xf, Xd, Y, fkw, twin, hot) in twins.items():
            cfgm = SVMConfig(**dict(MULTI_FIT, **fkw),
                             checkpoint_dir=f"{tmp}/multi_{hot}")
            kill = twin[0].stats.dispatches // 2
            killed(label, lambda: MultiProblemDriver(cfgm).fit_tasks(Xf, Y),
                   kill_at_dispatch=kill)
            ms, n, wall = timed_fit(torch, lambda: MultiProblemDriver(
                dataclasses.replace(cfgm, resume=True)).fit_tasks(Xf, Y), hot)
            st = ms[0].stats
            C, inv = fkw["C"], 1.0 / (2.0 * fkw["sigma2"])
            gaps = [eq9_gap(torch, Xd, Y[k], m.alpha, C, inv, dev)
                    for k, m in enumerate(ms)]
            same = [r["iterations"] == t.stats.per_problem[k]["iterations"]
                    and np.array_equal(m.alpha.view(np.int32),
                                       t.alpha.view(np.int32))
                    for k, (r, m, t) in enumerate(zip(st.per_problem, ms,
                                                      twin))]
            print(f"[chaos-multi] {label}: K={Y.shape[0]} killed at dispatch "
                  f"{kill} of {twin[0].stats.dispatches}, resumed_from="
                  f"{st.resumed_from} (problem-iterations) iterations="
                  f"{st.iterations} (uncut {twin[0].stats.iterations}) "
                  f"converged={st.converged} max eq9_gap_all={max(gaps):.3e}"
                  f" (<= 2eps 2e-03) wall={wall:.1f} s; bitwise equal to the "
                  f"uncut batched fit per problem: {all(same)}; {hot} "
                  f"launches={n}", flush=True)
            if st.resumed_from <= 0:
                fail(f"{label}: the resume started fresh")
            if not all(same):
                fail(f"{label}: the resumed fit differs on problems "
                     f"{[k for k, v in enumerate(same) if not v]}")
            if not (st.converged and max(gaps) <= 2e-3):
                fail(f"{label}: converged={st.converged}, gap {max(gaps):.3e}")
            if n <= 0:
                fail(f"{label}: the resumed fit did not launch {hot}")
            launches.setdefault(hot, {})[f"chaos-multi {label}"] = n
        print(f"[chaos-multi] took {time.perf_counter() - t_phase:.1f} s",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# the one-vs-rest sets: the news20 and covtype stand-ins (data/synthetic.py
# SPECS, the reference's multi-class specs) with their specs' C and sigma2;
# news20 at its full public size, covtype cut to scale 0.004 (n 2,091;
# 0.005 until the LM family phases came in; it still compacts) and
# news20 to scale 0.1 (n 1,593) where a batched fit is held against its
# loop of single fits, which costs the loop's time on top
NEWS20 = dict(C=4.0, sigma2=64.0)
COVTYPE = dict(C=10.0, sigma2=16.0)
COVTYPE_SCALE = 0.004
NEWS20_LOOP_SCALE = 0.1
MULTI_FIT = dict(heuristic="multi5pc", eps=1e-3, device="cuda")
MULTI_CACHE_SLOTS = 2048


def bucket_calls(eng, n: int) -> int:
    """The buckets ``eng.decision_function`` scores ``n`` queries in."""
    calls = s = 0
    while s < n:
        s += min(n - s, eng._bucket_of(n - s))
        calls += 1
    return calls


def loop_us(models) -> float:
    """Training wall time per problem-iteration (us) of a loop of single
    fits."""
    t = sum(m.stats.train_time for m in models)
    return 1e6 * t / max(sum(m.stats.iterations for m in models), 1)


def multi_ovr(torch, np, dev) -> dict:
    """``[multi-ovr]``: one-vs-rest training of the full-size news20
    stand-in (15,935 x 8,192, 20 classes) fed as CSR, ``format='ell'``, C
    4, sigma2 64, multi5pc, wss1, eps 1e-3, through
    ``MultiProblemDriver.fit_ovr``: every problem converged with its fp64
    Eq. 9 gap over all samples <= 2e-3; ``ell_gamma_update`` launched at
    least once per problem-iteration and at most once per problem and
    enqueued joint iteration. ``[multi-serve]``: the union engine over the
    3,993 test rows, CSR in: scores within 1e-4 of the per-model host
    oracle, predictions their argmax, one ``ell_rbf_accumulate`` launch a
    class and bucket. Returns each phase's launches."""
    from repro_torch.core import MultiProblemDriver, SVMConfig, ovr_tasks
    from repro_torch.data import make, to_csr
    from repro_torch.kernels import cuda
    phase("multi-ovr")
    t0 = time.perf_counter()
    X, y, Xt, yt = make("news20", 1.0, seed=0)
    Xc = to_csr(X)
    t_data = time.perf_counter() - t0
    cfg = SVMConfig(format="ell", selection="wss1", **NEWS20, **MULTI_FIT)
    cuda.reset_launches()
    t0 = time.perf_counter()
    mdl = MultiProblemDriver(cfg).fit_ovr(Xc, y)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_gu = cuda.launches["ell_gamma_update"]
    st = mdl.stats
    K = len(mdl.classes)
    _, Y = ovr_tasks(y)
    inv = 1.0 / (2.0 * NEWS20["sigma2"])
    gaps = [eq9_gap(torch, X, Y[k], m.alpha, NEWS20["C"], inv, dev)
            for k, m in enumerate(mdl.models)]
    its = sorted(r["iterations"] for r in st.per_problem)
    most = cfg.chunk_iters * st.dispatches * max(1, cfg.fuse_iters) * K
    print(f"[multi-ovr] news20 n={X.shape[0]} d={X.shape[1]} CSR in, K={K} "
          f"one-vs-rest, C {NEWS20['C']} sigma2 {NEWS20['sigma2']} multi5pc "
          f"wss1 ell (data {t_data:.1f} s): joint_iters={st.joint_iters} "
          f"iterations={st.iterations} per problem min/median/max="
          f"{its[0]}/{its[len(its) // 2]}/{its[-1]} dispatches="
          f"{st.dispatches} compactions={st.compactions} reconstructions="
          f"{st.reconstructions} rechecks={st.eq9_rechecks} buffer_sizes="
          f"{st.buffer_sizes} buffer_K={st.buffer_K} SVs/problem="
          f"{st.n_sv / K:.0f} converged={st.converged} max eq9_gap_all="
          f"{max(gaps):.3e} (<= 2eps 2e-03) wall={wall:.1f} s train="
          f"{st.train_time:.1f} s recon={st.recon_time:.1f} s "
          f"us/joint-iter={1e6 * st.train_time / max(st.joint_iters, 1):.1f}"
          f" us/problem-iter={1e6 * st.train_time / max(st.iterations, 1):.1f}"
          f" ell_gamma_update launches={n_gu} (>= {st.iterations}, <= "
          f"{most})", flush=True)
    if K != 20:
        fail(f"news20 has {K} classes, not 20")
    if not (st.converged and all(r["converged"] for r in st.per_problem)
            and max(gaps) <= 2e-3):
        fail(f"one-vs-rest: converged={st.converged}, max gap "
             f"{max(gaps):.3e}")
    if not st.iterations <= n_gu <= most:
        fail(f"ell_gamma_update launched {n_gu} times for {st.iterations} "
             f"problem-iterations (at most {most})")
    launches = {"ell_gamma_update": {"multi-ovr news20": n_gu}}

    phase("multi-serve")
    Xtc = to_csr(Xt)
    eng = mdl.union_engine()
    cuda.reset_launches()
    t0 = time.perf_counter()
    scores = mdl.decision_matrix(Xtc)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    n_acc = cuda.launches["ell_rbf_accumulate"]
    want = K * bucket_calls(eng, Xt.shape[0])
    host = mdl.decision_matrix_host(Xtc)
    err = float(np.abs(scores - host).max())
    pred = mdl.predict(Xtc)
    vote = bool((pred == mdl.classes[np.argmax(scores, 1)]).all())
    print(f"[multi-serve] news20 {Xt.shape[0]} test rows CSR in, union "
          f"engine ({eng.describe()}): accuracy={float((pred == yt).mean()):.4f} "
          f"wall={t_pred:.3f} s max|score-host|={err:.3e} (<= 1e-4) "
          f"predictions the argmax: {vote}; ell_rbf_accumulate launches="
          f"{n_acc} (K x buckets = {want})", flush=True)
    if not (err <= 1e-4 and vote):
        fail("the union engine disagrees with the per-model host oracle")
    if n_acc != want:
        fail(f"the union engine launched ell_rbf_accumulate {n_acc} times, "
             f"not {want}")
    launches["ell_rbf_accumulate"] = {"multi-serve news20": n_acc}
    return launches


def multi_loop(torch, np, dev) -> tuple:
    """``[multi-loop]``: batched == loop on the card, bitwise per problem
    (alpha bits, iterations, reconstructions): the covtype stand-in at
    ``COVTYPE_SCALE`` (7 classes, C 10, sigma2 16, multi5pc) under wss1
    with the cache off, wss1 with the cache on (``MULTI_CACHE_SLOTS``
    slots, hits > 0) — both against one loop of cache-off single fits —
    and wss2 with the cache off; the news20 stand-in at
    ``NEWS20_LOOP_SCALE`` fed as CSR (ELL, wss1); and the dense union
    engine over the covtype test rows against the per-model host oracle
    (1e-4). Prints us per problem-iteration, batched and loop. Returns the
    launches by kernel and fit, and (X, Y, batched cache-off models) for
    ``[dist-multi]``."""
    from repro_torch.core import MultiProblemDriver, SVMConfig, ovr_tasks
    from repro_torch.data import make, to_csr
    from repro_torch.kernels import cuda
    phase("multi-loop")
    launches: dict = {}

    def fit(X, Y, backend, **kw):
        cfg = SVMConfig(**dict(MULTI_FIT, **kw))
        cuda.reset_launches()
        t0 = time.perf_counter()
        ms = MultiProblemDriver(cfg, backend=backend).fit_tasks(X, Y)
        torch.cuda.synchronize()
        return ms, dict(cuda.launches), time.perf_counter() - t0

    def held(label, X, Y, batched, loop, hot, key):
        ms, n, wall = batched
        ml, _, wall_l = loop
        st = ms[0].stats
        same = [r["iterations"] == m.stats.iterations
                and r["reconstructions"] == m.stats.reconstructions
                and np.array_equal(b.alpha.view(np.int32),
                                   m.alpha.view(np.int32))
                for r, b, m in zip(st.per_problem, ms, ml)]
        print(f"[multi-loop] {label}: K={Y.shape[0]} joint_iters="
              f"{st.joint_iters} iterations={st.iterations} compactions="
              f"{st.compactions} reconstructions={st.reconstructions} hits="
              f"{st.cache_hits} converged={st.converged} wall batched "
              f"{wall:.1f} s, loop {wall_l:.1f} s; us/problem-iter batched "
              f"{1e6 * st.train_time / max(st.iterations, 1):.1f}, loop "
              f"{loop_us(ml):.1f}; bitwise equal to the loop per "
              f"problem: {all(same)}; {hot} launches={n[hot]}", flush=True)
        if not all(same):
            fail(f"{label}: batched differs from the loop on problems "
                 f"{[k for k, v in enumerate(same) if not v]}")
        if not st.converged or n[hot] < st.iterations:
            fail(f"{label}: converged={st.converged}, {hot} launched "
                 f"{n[hot]} times for {st.iterations} problem-iterations")
        launches.setdefault(hot, {})[key] = n[hot]

    X, y, Xt, _ = make("covtype", COVTYPE_SCALE, seed=0)
    _, Y = ovr_tasks(y)
    loop1 = fit(X, Y, "loop", selection="wss1", **COVTYPE)
    base = fit(X, Y, "batched", selection="wss1", **COVTYPE)
    held("covtype wss1 cache off", X, Y, base, loop1, "gamma_update",
         "multi-loop covtype wss1")
    cached = fit(X, Y, "batched", selection="wss1", row_cache=True,
                 row_cache_slots=MULTI_CACHE_SLOTS, **COVTYPE)
    held(f"covtype wss1 cache on ({MULTI_CACHE_SLOTS} slots)", X, Y, cached,
         loop1, "rbf_rows2", "multi-loop covtype wss1 cache")
    if cached[0][0].stats.cache_hits <= 0:
        fail("the shared cache never hit")
    wss2 = fit(X, Y, "batched", selection="wss2", **COVTYPE)
    held("covtype wss2 cache off", X, Y, wss2,
         fit(X, Y, "loop", selection="wss2", **COVTYPE), "rbf_rows2",
         "multi-loop covtype wss2")
    Xn, yn, _, _ = make("news20", NEWS20_LOOP_SCALE, seed=0)
    _, Yn = ovr_tasks(yn)
    Xnc = to_csr(Xn)
    news = fit(Xnc, Yn, "batched", selection="wss1", format="ell", **NEWS20)
    held(f"news20 scale {NEWS20_LOOP_SCALE} CSR in ell wss1", Xn, Yn, news,
         fit(Xnc, Yn, "loop", selection="wss1", format="ell", **NEWS20),
         "ell_gamma_update", "multi-loop news20")

    from repro_torch.core.multi import OvRSVMModel, _union_model
    ms = base[0]
    mdl = OvRSVMModel(np.arange(Y.shape[0]), ms, ms[0].stats,
                      _union_model(ms))
    eng = mdl.union_engine()
    cuda.reset_launches()
    scores = mdl.decision_matrix(Xt)
    n_acc = cuda.launches["rbf_accumulate"]
    err = float(np.abs(scores - mdl.decision_matrix_host(Xt)).max())
    want = Y.shape[0] * bucket_calls(eng, Xt.shape[0])
    print(f"[multi-loop] covtype union engine over {Xt.shape[0]} test rows "
          f"({eng.describe()['n_sv']} union SVs, K={eng.n_out}): "
          f"max|score-host|={err:.3e} (<= 1e-4); rbf_accumulate launches="
          f"{n_acc} (K x buckets = {want})", flush=True)
    if not err <= 1e-4:
        fail("the dense union engine disagrees with the host oracle")
    if n_acc != want:
        fail(f"the dense union engine launched rbf_accumulate {n_acc} "
             f"times, not {want}")
    launches["rbf_accumulate"] = {"multi-loop covtype union": n_acc}
    # the batched fits [chaos-multi] kills and resumes: (fed X, dense X, Y,
    # config, models, the kernel its fit launches)
    twins = {
        "covtype wss1": (X, X, Y, dict(selection="wss1", **COVTYPE), ms,
                         "gamma_update"),
        "covtype wss2": (X, X, Y, dict(selection="wss2", **COVTYPE),
                         wss2[0], "rbf_rows2"),
        f"news20 scale {NEWS20_LOOP_SCALE} ell": (
            Xnc, Xn, Yn, dict(selection="wss1", format="ell", **NEWS20),
            news[0], "ell_gamma_update")}
    return launches, twins


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


def side_lane(out: str) -> None:
    """The side lane, a second process on the card: the SVM phases that
    need none of the main lane's fits — ``[multi-ovr]``, ``[multi-loop]``,
    then on this process's own NCCL group of one rank ``[dist-multi]``,
    ``[chaos-multi]``, ``[dist]``, ``[dist-ell]`` and ``[chaos]``, then
    ``[cache]`` and ``[train-cache]`` — run here beside the main lane's
    fits, which leave the card mostly idle (their host launches the
    kernels). Writes to ``out`` as JSON their launches, by kernel and then
    by fit, ``[dist]``'s ``SMOSolver`` fit's iterations and SVs (the CLI's
    twin) and the fingerprint of ``[dist-ell]``'s ``SMOSolver`` fit (the
    main lane holds it against ``[wss2-ell]``)."""
    import numpy as np
    import torch
    sys.path.insert(0, str(SRC))
    from repro_torch import device as devmod
    from repro_torch.kernels import cuda
    from repro_torch.launch import dist
    dev = devmod.resolve("cuda")
    t0 = time.perf_counter()
    cuda.build()                # built by the main lane: read from build/
    multi = multi_ovr(torch, np, dev)
    loop, twins = multi_loop(torch, np, dev)
    phase("dist-multi")
    dist.init(device="cuda", init_method=f"tcp://localhost:{free_port()}",
              rank=0, world=1)
    on_group = dist_multi(torch, np, twins["covtype wss1"])
    chaos = chaos_multi(torch, np, dev, twins)
    del twins
    on_dist, a9a_dist, w7a_wss2 = dist_fits(torch, np, dev)
    for name, by_fit in chaos_paths(torch, np, dev, a9a_dist,
                                    w7a_wss2).items():
        chaos.setdefault(name, {}).update(by_fit)
    dist.destroy()
    cached = cache_workload(torch, np, dev)
    for name, by_fit in train_cache(torch, np, dev, a9a_dist).items():
        cached.setdefault(name, {}).update(by_fit)
    print(f"[side] the side lane's phases took "
          f"{time.perf_counter() - t0:.1f} s; seconds by phase "
          f"{phase_seconds()}", flush=True)
    with open(out, "w") as f:
        json.dump(dict(multi=multi, loop=loop, dist_multi=on_group,
                       dist=on_dist, chaos=chaos, cached=cached,
                       dist_twin=dict(iterations=a9a_dist.stats.iterations,
                                      n_sv=a9a_dist.stats.n_sv),
                       wss2_ell=fit_print(w7a_wss2)), f)


def fit_print(m) -> list:
    """A fit's iterations, compactions, reconstructions and a SHA-256 of
    its alpha bits: equal lists, bitwise equal fits."""
    import hashlib
    import numpy as np
    st = m.stats
    return [st.iterations, st.compactions, st.reconstructions,
            hashlib.sha256(np.ascontiguousarray(m.alpha).tobytes())
            .hexdigest()]


def start_side_lane() -> dict:
    """Start :func:`side_lane` as a second process on the card; its output
    goes to a temporary file that :func:`join_side_lane` prints. Killed at
    exit if still running."""
    import atexit
    import os
    import signal
    import tempfile
    tmp = tempfile.TemporaryDirectory()
    out = os.path.join(tmp.name, "side.json")
    log = open(os.path.join(tmp.name, "side.log"), "w+")
    proc = subprocess.Popen(
        [sys.executable, "-c",
         f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
         f"import chip_smoke; chip_smoke.run(chip_smoke.side_lane, {out!r})"],
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)

    def stop():             # the lane and any process it started
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    atexit.register(stop)
    return dict(proc=proc, out=out, log=log, tmp=tmp, stop=stop,
                t0=time.perf_counter())


def join_side_lane(lane) -> dict:
    """Wait for :func:`start_side_lane`'s process, print its output, and
    fail if it failed. Returns its launches (see :func:`side_lane`)."""
    phase("side")
    try:
        lane["proc"].wait(timeout=900)
    except subprocess.TimeoutExpired:
        fail("the side lane ran past 900 s")
    finally:
        lane["stop"]()
    wall = time.perf_counter() - lane["t0"]
    lane["log"].seek(0)
    print(lane["log"].read(), end="", flush=True)
    lane["log"].close()
    if lane["proc"].returncode != 0:
        fail(f"the side lane exited {lane['proc'].returncode}")
    with open(lane["out"]) as f:
        got = json.load(f)
    lane["tmp"].cleanup()
    print(f"[side] joined {wall:.1f} s after its start", flush=True)
    return got


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
    from repro_torch.launch import roofline
    global H100_BYTES_PER_S, H100_FP32_FLOPS, H100_BF16_FLOPS
    H100_BYTES_PER_S = roofline.H100_BYTES_PER_S
    H100_FP32_FLOPS = roofline.H100_FP32_FLOPS
    H100_BF16_FLOPS = roofline.H100_BF16_FLOPS

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
    # the dry-run prices every cell on this machine's CPU beside the LM
    # phases, which are mostly bound by the card
    dry = start_dryrun()

    launches = serve_lm(torch, dev)
    lm_launches = {LM_ARCH: launches["flash_attention"]}
    for tag, arch, n_layers in LM_FAMILIES:
        lm_launches[arch] = serve_family(torch, dev, tag, arch, n_layers,
                                         card)
    kernels["flash_attention"]["lm_launches"] = lm_launches
    kernels["flash_attention"].update(train_lm(torch, dev, time_ms, card))
    # the tensor-parallel phase's ranks import beside the sharded one
    tp = start_train_lm_tp()
    kernels["flash_attention"].update(train_lm_mesh(torch, dev, card))
    kernels["flash_attention"].update(train_lm_tp(tp, card))
    # the SVM phases that need none of the fits below run in a second
    # process on the card beside them (these fits' host launches the
    # kernels and leaves the card mostly idle), and so do the command
    # lines; the timed serving phases and kernel checks run after the side
    # lane is joined
    side = start_side_lane()
    clis = start_clis()
    a9a, a9a_wss2, dense_launches, Xt_a9a = run_path(torch, np, dev,
                                                     time_ms, "a9a", "dense")
    launches.update(dense_launches)
    model, w7a_wss2, ell_launches, Xt = run_path(torch, np, dev, time_ms,
                                                 "w7a", "ell")
    launches.update(ell_launches)
    served = dist_serve(torch, np, a9a, Xt_a9a)
    # the cached phases' two-row kernel launches, by kernel and then by fit
    cached_here = wss2_cache(torch, np, dev, a9a_wss2)
    lane = join_side_lane(side)
    same = lane["wss2_ell"] == fit_print(w7a_wss2)
    print(f"[side] [dist-ell]'s SMOSolver fit bitwise equal to [wss2-ell]'s "
          f"(alpha, iterations, compactions, reconstructions): {same}",
          flush=True)
    if not same:
        fail("the side lane's w7a wss2 fit differs from [wss2-ell]'s")
    check_clis(clis, lane["dist_twin"])
    # the launches of the side lane's fits, by kernel and then by fit
    multi = lane["multi"]
    for fits in (lane["loop"], lane["dist_multi"]):
        for name, by_fit in fits.items():
            multi.setdefault(name, {}).update(by_fit)
    dist_launches = lane["dist"]
    for name, by_fit in served.items():
        dist_launches.setdefault(name, {}).update(by_fit)
    chaos_launches = lane["chaos"]
    cached = lane["cached"]
    for name, by_fit in cached_here.items():
        cached.setdefault(name, {}).update(by_fit)
    check_dryrun(dry)
    bf16_serving = serve_bf16(torch, np, dev, time_ms, (
        ("a9a", a9a, Xt_a9a, "rbf_accumulate"),
        ("w7a CSR in", model, Xt, "ell_rbf_accumulate")))
    del a9a, a9a_wss2, w7a_wss2
    phase("check-ell")
    check_ell_accumulate(torch, np, dev, time_ms, kernels, model, Xt)
    launches.update(row_path(torch, dev, w7a_buffer))
    for name, by_fit in cached.items():
        kernels[name]["cache_launches"] = by_fit
    for name, by_fit in dist_launches.items():
        kernels[name]["dist_launches"] = by_fit
    for name, by_fit in multi.items():
        kernels[name]["multi_launches"] = by_fit
    for name, by_fit in chaos_launches.items():
        kernels[name]["chaos_launches"] = by_fit
    for name, rec in bf16_serving.items():
        kernels[name]["serve_bf16"] = rec

    phase("report")
    record = []
    for name, k in kernels.items():
        record.append(dict(name=name, **{key: k[key] for key in (
            "route", "source", "replaces")}, launches=launches[name],
            **{key: k[key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")},
            **{key: k[key] for key in ("matmul_ms", "spmm_ms", "warm_ms",
                                       "b64_ms", "bf16_ms", "bf16_b64_ms",
                                       "bf16_bound_ms", "bf16_bound_by",
                                       "bf16_max_abs_err", "serve_bf16",
                                       "k16_ms", "k16_warm_ms",
                                       "hit_ms", "hit_bound_ms",
                                       "cache_launches", "dist_launches",
                                       "multi_launches", "chaos_launches",
                                       "lm_launches", "train_lm_launches",
                                       "train_lm_mesh_launches",
                                       "train_lm_tp_launches",
                                       "serve_lm_tp_launches",
                                       "train_fwd_ms", "train_bwd_ms",
                                       "serve_shape_ms",
                                       "zamba_shape_ms", "shape")
               if key in k}, card=card))
    print(f"[done] total {time.perf_counter() - t_all:.1f} s; seconds by "
          f"phase {phase_seconds()}", flush=True)
    print(json.dumps({"kernels": record}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def run(fn=main, *args) -> None:
    """``fn(*args)`` (``main``, or the side lane in its own process) with
    every failure reported on standard output: the phase and the traceback,
    then a non-zero exit (nothing is caught and carried on)."""
    try:
        fn(*args)
    except Exception:
        print(f"FAIL [{PHASE}]: uncaught exception", flush=True)
        traceback.print_exc(file=sys.stdout)
        sys.stdout.flush()
        sys.exit(1)


if __name__ == "__main__":
    run()
