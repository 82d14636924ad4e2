#!/usr/bin/env python3
"""Device busy/idle share of the port's SMO training loop on one GPU.

    python3 scripts/profile_torch_train.py [--dataset a9a|w7a] [--scale 1.0]
                                           [--iters 1024]

Trains the a9a stand-in (dense) or the w7a stand-in (fed as CSR,
``format='ell'``) — C=32, sigma2=64, multi5pc, wss1; by default the
full-size set (a9a n=32,561, w7a n=24,692) — with ``repro_torch`` on
``cuda`` twice: once
unprofiled to build the kernels and warm up, then under ``torch.profiler``
for the first ``--iters`` SMO iterations (the full buffer, before any
compaction).
Prints the window's wall time, the summed device time of the CUDA kernels
(busy share = device time / wall time), kernel launches per SMO iteration,
and the kernels with the most device time; the last line is a JSON
summary. Needs a CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", choices=("a9a", "w7a"), default="a9a")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--iters", type=int, default=1024)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    from repro_torch.core import SVMConfig, SMOSolver
    from repro_torch.data import make, to_csr

    X, y, _, _ = make(args.dataset, args.scale, seed=0)
    kw = dict(C=32.0, sigma2=64.0, heuristic="multi5pc", device="cuda",
              max_iters=args.iters)
    if args.dataset == "w7a":                # the sparse path: CSR in
        X, kw = to_csr(X), dict(kw, format="ell")
    SMOSolver(SVMConfig(**kw)).fit(X, y)          # build + warm up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m = SMOSolver(SVMConfig(**kw)).fit(X, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    busy_us = sum(v[1] for v in by_name.values())
    iters = m.stats.iterations
    print(f"[profile] {torch.cuda.get_device_name(0)}: {args.dataset} scale "
          f"{args.scale} n={X.shape[0]}, {iters} SMO iterations in "
          f"{wall:.3f} s ({1e6 * wall / max(iters, 1):.1f} us/iter, "
          f"profiler on)")
    print(f"[profile] device kernel time {busy_us / 1e3:.1f} ms = "
          f"{100 * busy_us / (wall * 1e6):.2f}% of the window; "
          f"{len(kernels)} kernel launches = "
          f"{len(kernels) / max(iters, 1):.1f} per iteration")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    for name, (cnt, us) in top:
        print(f"[profile]   {us / 1e3:9.2f} ms  {cnt:7d} x  {name[:90]}")
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "dataset": args.dataset,
        "scale": args.scale,
        "iterations": iters, "wall_s": wall, "device_busy_ms": busy_us / 1e3,
        "busy_share": busy_us / (wall * 1e6), "kernel_launches": len(kernels),
        "launches_per_iter": len(kernels) / max(iters, 1),
        "top": [{"name": n, "count": c, "ms": us / 1e3}
                for n, (c, us) in top]}))


if __name__ == "__main__":
    main()
