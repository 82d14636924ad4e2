#!/usr/bin/env python3
"""Where the port's LM serving (or training) time goes on one GPU.

    python3 scripts/profile_torch_serve.py [--arch ARCH]
    python3 scripts/profile_torch_serve.py --train

Builds the full config of ``--arch`` (default ``chip_smoke.py``'s serving
arch ``LM_ARCH``, or one of its ``LM_FAMILIES`` archs at the depth the
smoke serves it at; random bf16 weights from a seed) with ``repro_torch``
on ``cuda``, warms
up with one short ``launch.serve.generate``, then traces under
``torch.profiler`` one prefill step over the smoke's ``LM_BATCH`` prompts
of ``LM_PROMPT`` tokens (which fills the KV cache) and ``STEPS`` greedy
decode steps. For each phase it prints the
wall time, the summed device time of the CUDA kernels (busy share = device
time / wall time), the kernel launches, and the kernels with the most
device time; the last line is a JSON summary. Needs a CUDA device; exits
non-zero without one.

``--train`` traces ``chip_smoke.py``'s ``[train-lm]`` configuration
instead (llama3-8b, ``TRAIN_LAYERS`` layers, bf16, remat full, AdamW as
there): after one warm-up step, one whole train step, then the loss and
its gradients alone and the AdamW update alone.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from chip_smoke import (LM_ARCH, LM_BATCH, LM_FAMILIES,  # noqa: E402
                        LM_PROMPT, TRAIN_BATCH, TRAIN_LAYERS, TRAIN_SEQ)

STEPS = 8                      # decode steps traced


def _phase(torch, profile, activities, fn) -> dict:
    """Wall time, device kernel time and launches of ``fn()`` (traced)."""
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name][0] += 1
            by_name[e.name][1] += e.time_range.elapsed_us()
    busy_us = sum(v[1] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {"wall_ms": wall * 1e3, "device_ms": busy_us / 1e3,
            "busy_share": busy_us / (wall * 1e6),
            "launches": sum(v[0] for v in by_name.values()),
            "top": [{"name": n, "count": c, "ms": us / 1e3}
                    for n, (c, us) in top]}


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    depth = {LM_ARCH: None, **{a: n for _, a, n in LM_FAMILIES}}
    ap = argparse.ArgumentParser(prog="profile_torch_serve.py")
    ap.add_argument("--arch", default=LM_ARCH, choices=list(depth))
    ap.add_argument("--train", action="store_true",
                    help="trace the smoke's [train-lm] step instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    if args.train:
        return profile_train(torch, profile, ProfilerActivity)
    from repro_torch import device as devmod
    from repro_torch.launch import serve, train_lib
    from repro_torch.models.api import build

    dev = devmod.resolve("cuda")
    cfg = configs.full_config(args.arch)
    if depth[args.arch]:
        cfg = dataclasses.replace(cfg, n_layers=depth[args.arch])
    model = build(cfg)
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size,
                            (LM_BATCH, LM_PROMPT), generator=g,
                            device=dev, dtype=torch.int32)
    serve.generate(params, cfg, prompts, 2)            # build + warm up
    cache = model.init_cache(cfg, LM_BATCH, LM_PROMPT + STEPS,
                             dev)
    prefill = train_lib.make_prefill_step(cfg)
    step = train_lib.make_serve_step(cfg)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {}
    nxt = {}

    def run_prefill():
        nxt["t"] = prefill(params, {"tokens": prompts}, cache)

    def run_decode():
        c = cache
        for _ in range(STEPS):
            nxt["t"], c = step(params, c, {"tokens": nxt["t"][:, None]})

    out["prefill"] = _phase(torch, profile, acts, run_prefill)
    out["decode"] = _phase(torch, profile, acts, run_decode)
    name = torch.cuda.get_device_name(0)
    for ph, r in out.items():
        per = "" if ph == "prefill" else (
            f", {STEPS} steps: {r['wall_ms'] / STEPS:.2f} ms and "
            f"{r['launches'] / STEPS:.0f} launches per step")
        _print("profile-serve", name, f"{cfg.name} ({cfg.n_layers} layers) "
               f"{ph} (B={LM_BATCH}, prompt {LM_PROMPT}{per})", r)
    print(json.dumps({"device": name, "arch": cfg.name,
                      "layers": cfg.n_layers,
                      "batch": LM_BATCH, "prompt_len": LM_PROMPT,
                      "steps": STEPS, **out}))


def _print(tag, name, what, r) -> None:
    print(f"[{tag}] {name}: {what}: wall {r['wall_ms']:.1f} ms, device "
          f"kernel time {r['device_ms']:.1f} ms = "
          f"{100 * r['busy_share']:.1f}% busy, {r['launches']} launches "
          f"(profiler on)")
    for t in r["top"]:
        print(f"[{tag}]   {t['ms']:9.2f} ms  {t['count']:6d} x  "
              f"{t['name'][:90]}")


def profile_train(torch, profile, ProfilerActivity) -> None:
    from repro_torch import configs
    from repro_torch import device as devmod
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import train_lib
    from repro_torch.models.api import build
    from repro_torch.optim import adamw

    dev = devmod.resolve("cuda")
    cfg = dataclasses.replace(configs.full_config(LM_ARCH),
                              n_layers=TRAIN_LAYERS)
    ocfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=20, decay_steps=100)
    params = build(cfg).init(cfg, torch.Generator(device=dev).manual_seed(0))
    opt = adamw.init(params)
    tp = TokenPipeline(cfg.vocab_size, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                       seed=0)
    batch = lambda i: {k: torch.as_tensor(a, device=dev)
                       for k, a in tp.batch_at(i).items()}
    step = train_lib.make_train_step(cfg, ocfg)
    loss_fn = train_lib.make_loss_fn(cfg)
    step(params, opt, batch(0))                        # warm up
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    held = {}

    def grads():
        flat = [w.detach().requires_grad_() for w in adamw.leaves(params)]
        loss, _ = loss_fn(adamw.tree_like(params, flat), batch(2))
        held["g"] = torch.autograd.grad(loss, flat)

    out = {"step": _phase(torch, profile, acts,
                          lambda: step(params, opt, batch(1))),
           "loss_and_grads": _phase(torch, profile, acts, grads),
           "update": _phase(torch, profile, acts, lambda: adamw.update(
               ocfg, held["g"], opt, params))}
    name = torch.cuda.get_device_name(0)
    for ph, r in out.items():
        _print("profile-train", name, f"{cfg.name} ({cfg.n_layers} layers, "
               f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, remat {cfg.remat}) "
               f"{ph}", r)
    print(json.dumps({"device": name, "arch": cfg.name,
                      "layers": cfg.n_layers, "batch": TRAIN_BATCH,
                      "seq": TRAIN_SEQ, **out}))


if __name__ == "__main__":
    main()
