"""SVM serving launcher — train (or compact) a model, stand up the
inference plane, report latency percentiles (twin of
``repro.launch.svm_serve``).

    python -m repro_torch.launch.svm_serve --dataset a9a [--format ell] \\
        [--device cpu] [--compact] [--dtype bfloat16] [--batch 256] \\
        [--repeats 50] [--roofline] [--json-out report.json]

Also reachable as ``python -m repro_torch.launch.serve --svm ...`` (the
unified serving entry point; LM serving stays behind ``--arch``). The
reference's flags, lines and JSON keys, with ``--device {cuda,cpu}`` in
place of ``--use-pallas``: on the card each bucket launches the
hand-written accumulate kernel (``rbf_accumulate`` or
``ell_rbf_accumulate``, bf16 SVs loaded as bf16). ``--shards N`` (0: the
group's size) deals the SVs over a process group of N ranks, one process
a device under ``torchrun``; every rank serves the same queries and rank 0
reports. ``--roofline`` prices the hot bucket from shapes
(``ServeEngine.roofline``) against the H100's peaks.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.svm_serve")
    ap.add_argument("--dataset", default="a9a")
    ap.add_argument("--heuristic", default="multi5pc")
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--format", default="dense", choices=("dense", "ell"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to train and serve: the CUDA kernels on the "
                         "card, their plain versions on the CPU")
    ap.add_argument("--shards", type=int, default=1,
                    help="ranks the SV axis is dealt over (0 = the process "
                         "group's size; > 1 needs torchrun)")
    ap.add_argument("--compact", action="store_true",
                    help="serve the deduped/pruned deployment artifact")
    ap.add_argument("--dtype", default=None,
                    choices=(None, "float32", "bfloat16"),
                    help="SV storage dtype on device")
    ap.add_argument("--min-bucket", type=int, default=64)
    ap.add_argument("--max-bucket", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=256,
                    help="query batch size for the latency report")
    ap.add_argument("--repeats", type=int, default=50)
    ap.add_argument("--roofline", action="store_true",
                    help="price the hot bucket against the card's peaks")
    ap.add_argument("--json-out", default=None)
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)

    from repro_torch.core import SMOSolver, SVMConfig
    from repro_torch.data import SPECS, make
    from repro_torch.launch import dist

    grouped = args.shards != 1 and "WORLD_SIZE" in os.environ
    if grouped:
        dist.init(device=args.device)
    try:
        spec = SPECS[args.dataset]
        X, y, Xt, yt = make(args.dataset, scale=args.scale, seed=0)
        cfg = SVMConfig(C=spec.C, sigma2=spec.sigma2,
                        heuristic=args.heuristic, format=args.format,
                        device=args.device)
        model = SMOSolver(cfg).fit(X, y)
        kw = dict(shards=args.shards or None, min_bucket=args.min_bucket,
                  max_bucket=args.max_bucket)
        if args.compact:
            model = model.compact(dtype=args.dtype)
            engine = model.serve_engine(**kw)
        else:
            engine = model.serve_engine(dtype=args.dtype, **kw)
        return _report(args, engine, X, Xt, yt, dist.rank() == 0)
    finally:
        if grouped:
            dist.destroy()


def _report(args, engine, X, Xt, yt, say: bool) -> dict:
    """Warm the bucket, time ``repeats`` calls of one batch, print the
    reference's lines (rank 0) and write its JSON report."""
    out = print if say else (lambda *a, **k: None)
    out(f"engine: {engine.describe()}")
    Zt = Xt if len(Xt) else X
    rng = np.random.default_rng(0)
    Z = Zt[rng.integers(0, len(Zt), size=args.batch)]
    engine.decision_function(Z)                     # warm the bucket
    lat = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        engine.decision_function(Z)         # ends in a copy to the host
        lat.append(time.perf_counter() - t0)
    lat = np.sort(np.asarray(lat))
    p50 = float(np.percentile(lat, 50))
    p99 = float(np.percentile(lat, 99))
    qps = args.batch / p50
    out(f"batch={args.batch}: p50={p50 * 1e3:.3f}ms p99={p99 * 1e3:.3f}ms "
        f"qps={qps:,.0f} us/query={p50 / args.batch * 1e6:.2f}")
    if len(yt):
        acc = float((np.where(engine.decision_function(Xt) >= 0.0, 1.0, -1.0)
                     == yt).mean())
        out(f"test acc: {acc:.4f}")
    report = {"engine": engine.describe(), "batch": args.batch,
              "p50_s": p50, "p99_s": p99, "qps": qps}
    if args.roofline:
        rf = engine.roofline(engine._bucket_of(args.batch)).row()
        out(f"roofline: dominant={rf['dominant']} "
            f"t_compute={rf['t_compute_s']:.2e}s "
            f"t_memory={rf['t_memory_s']:.2e}s "
            f"useful_ratio={rf['useful_ratio']:.3f}")
        report["roofline"] = rf
    if args.json_out and say:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=2, default=str)
        out(f"wrote {args.json_out}")
    return report


if __name__ == "__main__":
    main()
