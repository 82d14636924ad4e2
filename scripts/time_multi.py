#!/usr/bin/env python3
"""Host time per problem-iteration of the port's batched one-vs-rest fit.

    python3 scripts/time_multi.py [--src PATH] [--label NAME] [--reps 4]
                                  [--selection wss1|wss2] [--scale 0.005]
                                  [--device cuda|cpu] [--count-ops]

Fits the covtype stand-in's one-vs-rest problems (7 classes; C 10,
sigma2 16, multi5pc, eps 1e-3, cache off — ``chip_smoke.py``
``[multi-loop]``'s batched fit, scale 0.005 by default) ``--reps`` times
with ``MultiProblemDriver`` and prints each fit's training time over its
problem-iterations (``FitStats.train_time / iterations``, µs); the first
fit builds the kernels and warms up. ``--src`` imports ``repro_torch``
from another checkout's ``src`` (for example a parent commit unpacked
with ``git archive``), so two versions can be timed alternately in one
session on one card. ``--count-ops`` instead runs one fit under
``torch.profiler`` and prints the operator calls per joint iteration.
The last line is a JSON summary.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--selection", choices=("wss1", "wss2"), default="wss1")
    ap.add_argument("--scale", type=float, default=0.005)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--count-ops", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("FAIL: needs a CUDA device (or --device cpu)", file=sys.stderr)
        sys.exit(1)
    from repro_torch.core import MultiProblemDriver, SVMConfig, ovr_tasks
    from repro_torch.data import make

    X, y, _, _ = make("covtype", args.scale, seed=0)
    _, Y = ovr_tasks(y)
    cfg = SVMConfig(C=10.0, sigma2=16.0, heuristic="multi5pc", eps=1e-3,
                    device=args.device, selection=args.selection)

    def fit():
        ms = MultiProblemDriver(cfg).fit_tasks(X, Y)
        if args.device == "cuda":
            torch.cuda.synchronize()
        return ms[0].stats

    out = {"label": args.label, "src": args.src,
           "selection": args.selection, "scale": args.scale}
    if args.count_ops:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            st = fit()
        ops = sum(e.count for e in prof.key_averages())
        out.update(joint_iters=st.joint_iters, iterations=st.iterations,
                   ops_per_joint_iter=ops / st.joint_iters)
    else:
        us = []
        for _ in range(args.reps):
            st = fit()
            us.append(1e6 * st.train_time / st.iterations)
            print(f"[time_multi] {args.label} {args.selection}: "
                  f"{st.iterations} problem-iterations, {st.joint_iters} "
                  f"joint, {us[-1]:.1f} us/problem-iter", flush=True)
        out.update(iterations=st.iterations, joint_iters=st.joint_iters,
                   us_per_problem_iter=us)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
