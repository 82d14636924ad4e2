#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
into ``build/``, holds each kernel against its plain PyTorch version at the
main path's shapes, then drives the port's main path through the entry
points a user calls: a full-size ``a9a`` fit (C=32, sigma2=64, multi5pc,
wss1) to convergence, a Single-policy wss2 fit at scale 0.2, and
``SVMModel.predict`` over the test rows; both fits must pass Eq. 9 over
all samples on gamma recomputed in fp64. Kernel launch counts are reset just before the main path and read
just after, so the run shows that training and serving went through the
kernels. Every phase prints its own line; any failure exits non-zero with
no result. The second-to-last line is the card's name and power limit, the
line before it the per-kernel JSON record, the last line the device JSON.
It imports nothing of the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12        # fp32 outside the tensor cores, same source


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


class DeviceTimer:
    """Device time of one call of ``fn`` (ms), from CUDA events around
    ``reps`` back-to-back calls. These kernels run for less time than one
    Python launch takes, so events around a plain loop would time the
    host's launch rate: the timer first queues fp32 matmuls that keep the
    card busy while the host enqueues the timed calls, and checks that the
    card was still inside them when the host finished (else it retries
    with a longer lead)."""

    def __init__(self, torch, dev):
        self.torch = torch
        g = torch.Generator(device=dev).manual_seed(1)
        self.a = torch.randn(4096, 4096, generator=g, device=dev)

    def __call__(self, fn, reps: int, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        for lead in (2, 8, 32):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            for _ in range(lead):
                self.a @ self.a
            e0.record()
            for _ in range(reps):
                fn()
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


def main() -> None:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    from repro_torch import device as devmod
    from repro_torch.core import SVMConfig, SMOSolver
    from repro_torch.data import make
    from repro_torch.kernels import cuda, ops, ref

    dev = devmod.resolve("cuda")
    card = card_line()
    t_all = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    time_ms = DeviceTimer(torch, dev)

    # ---- 1. build -------------------------------------------------------
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

    # ---- 2. kernels against their plain versions -----------------------
    X, y, Xt, yt = make("a9a", 1.0, seed=0)
    d = X.shape[1]
    m = 32768                         # the a9a buffer after full_m_per
    Xb = np.zeros((m, d), np.float32)
    Xb[: min(m, X.shape[0])] = X[:m]
    Xd = torch.as_tensor(Xb, device=dev)
    sq = (Xd * Xd).sum(1)
    inv = 1.0 / (2.0 * 64.0)
    gam = torch.randn(m, generator=g, device=dev)
    z2 = Xd[torch.tensor([5, 1000], device=dev)].contiguous()
    coef2 = torch.randn(2, generator=g, device=dev)
    kernels = {}

    got = ops.fused_gamma_update("rbf", Xd, sq, gam, z2, coef2, inv)
    want = ref.gamma_update(Xd, sq, gam, z2, coef2, inv)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    t_k = time_ms(lambda: ops.fused_gamma_update(
        "rbf", Xd, sq, gam, z2, coef2, inv), reps=100)
    t_p = time_ms(lambda: ref.gamma_update(Xd, sq, gam, z2, coef2, inv),
                  reps=20)
    t_mm = time_ms(lambda: Xd @ z2.T, reps=100)
    b_ms, b_by = bound(4.0 * (m * d + 3 * m + 2 * d + 2),
                       m * (4.0 * d + 14.0), H100_FP32_FLOPS)
    kernels["gamma_update"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/rbf_rows.cu",
        replaces="src/repro/kernels/gamma_update.py:37", max_abs_err=err,
        ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        matmul_ms=t_mm, shape=f"X {m}x{d}")
    print(f"[check] gamma_update m={m} d={d}: max_abs_err={err:.3e} "
          f"(rtol/atol 1e-4) kernel {t_k*1e3:.1f} us, plain {t_p*1e3:.1f} us,"
          f" X@z2.T {t_mm*1e3:.1f} us, bound {b_ms*1e3:.2f} us ({b_by})",
          flush=True)

    got = ops.kernel_rows2("rbf", Xd, sq, z2, inv)
    want = ref.kernel_rows2(Xd, sq, z2, inv)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    zz = torch.stack([z2[1], z2[1]])
    same = ops.kernel_rows2("rbf", Xd, sq, zz, inv)
    swap = ops.kernel_rows2("rbf", Xd, sq, z2.flip(0).contiguous(), inv)
    torch.cuda.synchronize()
    if not (torch.equal(same[:, 0], same[:, 1])
            and torch.equal(swap[:, 0], got[:, 1])
            and torch.equal(swap[:, 1], got[:, 0])):
        fail("rbf_rows2 columns are not bitwise position-symmetric")
    t_k = time_ms(lambda: ops.kernel_rows2("rbf", Xd, sq, z2, inv),
                  reps=100)
    t_p = time_ms(lambda: ref.kernel_rows2(Xd, sq, z2, inv), reps=20)
    b_ms, b_by = bound(4.0 * (m * d + m + 2 * d + 2 * m),
                       m * (4.0 * d + 12.0), H100_FP32_FLOPS)
    kernels["rbf_rows2"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/rbf_rows.cu",
        replaces="src/repro/kernels/rbf_row.py:51", max_abs_err=err,
        ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        matmul_ms=t_mm, shape=f"X {m}x{d}")
    print(f"[check] rbf_rows2 m={m} d={d}: max_abs_err={err:.3e} "
          f"(rtol 1e-5 / atol 1e-6), columns bitwise position-symmetric; "
          f"kernel {t_k*1e3:.1f} us, plain {t_p*1e3:.1f} us, "
          f"bound {b_ms*1e3:.2f} us ({b_by})", flush=True)

    B, M = 4096, 18048            # serve bucket; ~18k SVs padded to 128
    Xs = Xd[:M].contiguous()
    sqs = sq[:M].contiguous()
    cf = torch.rand(M, generator=g, device=dev) * 32.0   # positive: no
    Zq = torch.as_tensor(np.resize(Xt, (B, d)), device=dev)  # cancellation
    got = ops.rbf_accumulate(Xs, sqs, cf, Zq, inv)
    want = ref.rbf_accumulate(Xs, sqs, cf, Zq, inv)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = float(((got - want).abs() / want.abs()).max())
    if not rel <= 1e-5:
        fail(f"rbf_accumulate relative error {rel:.3e} > 1e-5")
    t_k = time_ms(lambda: ops.rbf_accumulate(Xs, sqs, cf, Zq, inv),
                  reps=10)
    t_p = time_ms(lambda: ref.rbf_accumulate(Xs, sqs, cf, Zq, inv),
                  reps=5)
    t_mm = time_ms(lambda: Zq @ Xs.T, reps=10)
    b_ms, b_by = bound(4.0 * (M * d + 2 * M + B * d + B),
                       2.0 * B * M * d + 6.0 * B * M, H100_FP32_FLOPS)
    kernels["rbf_accumulate"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/rbf_accumulate.cu",
        replaces="src/repro/kernels/rbf_row.py:103", max_abs_err=err,
        ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        matmul_ms=t_mm, shape=f"B {B} x M {M} x d {d}")
    print(f"[check] rbf_accumulate B={B} M={M} d={d}: max rel err "
          f"{rel:.3e} (1e-5), kernel {t_k:.3f} ms, plain {t_p:.3f} ms, "
          f"Z@X.T {t_mm:.3f} ms, bound {b_ms:.3f} ms ({b_by})", flush=True)

    # ---- 3. full-size training (main path) ------------------------------
    cuda.reset_launches()
    kw = dict(C=32.0, sigma2=64.0, heuristic="multi5pc", selection="wss1",
              device="cuda")
    t0 = time.perf_counter()
    model = SMOSolver(SVMConfig(**kw)).fit(X, y)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = model.stats
    train_launches = dict(cuda.launches)
    gap = eq9_gap(torch, X, y, model.alpha, 32.0, inv, dev)
    print(f"[train] a9a n={X.shape[0]} d={d}: iterations={st.iterations} "
          f"dispatches={st.dispatches} compactions={st.compactions} "
          f"reconstructions={st.reconstructions} SVs={st.n_sv} "
          f"rechecks={st.eq9_rechecks} converged={st.converged} "
          f"eq9_gap_all={gap:.3e} (<= 2eps "
          f"{2e-3:.0e}) wall={wall:.1f} s "
          f"us/iter={1e6 * st.train_time / max(st.iterations, 1):.1f} "
          f"gamma_update launches={train_launches['gamma_update']}",
          flush=True)
    if train_launches["gamma_update"] <= 0:
        fail("training did not launch gamma_update")
    if not (st.converged and gap <= 2e-3):
        fail(f"training: converged={st.converged}, gap {gap:.3e}")

    # ---- 4. wss2, Single policy -------------------------------------------
    # The Single policy's last phase ends without a reconstruction, so its
    # verdict is the one the driver rechecks on recomputed gamma.
    X2, y2, _, _ = make("a9a", 0.2, seed=0)
    cuda.reset_launches()
    t0 = time.perf_counter()
    m2 = SMOSolver(SVMConfig(**dict(kw, selection="wss2",
                                    heuristic="single5pc"))).fit(X2, y2)
    torch.cuda.synchronize()
    wss2_launches = dict(cuda.launches)
    s2 = m2.stats
    gap2 = eq9_gap(torch, X2, y2, m2.alpha, 32.0, inv, dev)
    print(f"[wss2] a9a scale 0.2 n={X2.shape[0]} single5pc: "
          f"iterations={s2.iterations} reconstructions={s2.reconstructions} "
          f"rechecks={s2.eq9_rechecks} converged={s2.converged} "
          f"eq9_gap_all={gap2:.3e} (<= 2eps {2e-3:.0e}) SVs={s2.n_sv} "
          f"wall={time.perf_counter() - t0:.1f} s "
          f"rbf_rows2 launches={wss2_launches['rbf_rows2']}", flush=True)
    if wss2_launches["rbf_rows2"] <= 0:
        fail("wss2 fit did not launch rbf_rows2")
    if not (s2.converged and gap2 <= 2e-3):
        fail(f"wss2 fit: converged={s2.converged}, gap {gap2:.3e}")

    # ---- 5. serving ------------------------------------------------------
    cuda.reset_launches()
    t0 = time.perf_counter()
    pred = model.predict(Xt)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    serve_launches = dict(cuda.launches)
    scores = model.decision_function(Xt)
    host = model.decision_function_host(Xt)
    serr = float(np.abs(scores - host).max() / np.abs(host).max())
    acc = float((pred == yt).mean())
    print(f"[serve] {Xt.shape[0]} test rows, {model.stats.n_sv} SVs: "
          f"accuracy={acc:.4f} predict wall={t_pred:.3f} s "
          f"max|score-host|/max|host|={serr:.3e} (<= 1e-4) "
          f"max|score|={np.abs(scores).max():.3f} (> 0.5) "
          f"rbf_accumulate launches={serve_launches['rbf_accumulate']}",
          flush=True)
    if serve_launches["rbf_accumulate"] <= 0:
        fail("predict did not launch rbf_accumulate")
    if not (serr <= 1e-4 and np.abs(scores).max() > 0.5):
        fail("serving scores disagree with the host loop or are degenerate")
    eng = model.serve_engine()
    per_bucket = {}
    b = eng.min_bucket
    while b <= eng.max_bucket:
        zb = torch.as_tensor(np.resize(Xt, (b, d)), device=dev)
        per_bucket[b] = time_ms(lambda: eng.score_bucket(zb),
                                reps=20) * 1e3 / b
        b *= 2
    print("[serve] device us/query by bucket: " + ", ".join(
        f"{b}: {v:.3f}" for b, v in per_bucket.items()), flush=True)

    # ---- 6. kernels line ---------------------------------------------------
    launches = {"gamma_update": train_launches["gamma_update"],
                "rbf_rows2": wss2_launches["rbf_rows2"],
                "rbf_accumulate": serve_launches["rbf_accumulate"]}
    record = []
    for name, k in kernels.items():
        record.append(dict(name=name, **{key: k[key] for key in (
            "route", "source", "replaces")}, launches=launches[name],
            **{key: k[key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "matmul_ms", "shape")}, card=card))
    print(f"[done] total {time.perf_counter() - t_all:.1f} s", flush=True)
    print(json.dumps({"kernels": record}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
