"""LM training (twin of ``repro.launch.train`` and the
``examples/train_lm.py`` it runs; the port runs no file of the reference).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
        --steps 30 --device cpu        # the arch's smoke config; default cuda

:func:`train` is the library function (``chip_smoke.py`` calls it with a
full config on the card): random weights from a seeded generator on the
device, the deterministic token stream (``data.TokenPipeline``), the
train step of ``launch.train_lib`` (AdamW in place, remat as the config
says, optional gradient accumulation), the straggler watchdog, async
checkpoints of ``{'params', 'opt'}`` and resume from the newest step. On
a mesh (``mesh=``, a live ``launch.mesh.Mesh``) each rank holds its
blocks of the state and runs the sharded step; saves gather the blocks
(blocking) and rank 0 writes the usual format, so a run resumes on any
mesh, or on none.
:func:`main` is the example's CLI, plus ``--device`` and
``--accum-steps``: the arch's smoke config with remat off, as there.
``--mesh 4,2`` means (data=4, model=2) and needs that many ranks, one
process a device:

    torchrun --nproc-per-node 8 -m repro_torch.launch.train \
        --arch llama3-8b --mesh 4,2 --device cpu    # gloo; cuda: NCCL
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch import device as devmod
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.data import TokenPipeline
from repro_torch.launch import dist, train_lib
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import sharding as shd
from repro_torch.launch.elastic import StragglerWatchdog
from repro_torch.models.api import ModelConfig, build
from repro_torch.optim import adamw


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _batcher(cfg: ModelConfig, dev: torch.device):
    """Raw numpy batch -> model batch on ``dev``. The embeds frontend is
    the example's stub: frame embeddings looked up from a fixed (V, d)
    table (``default_rng(0)``, scale 0.02)."""
    if cfg.frontend != "embeds":
        return lambda raw: {k: torch.as_tensor(v, device=dev)
                            for k, v in raw.items()}
    emb = np.random.default_rng(0).normal(
        scale=0.02, size=(cfg.vocab_size, cfg.d_model)).astype(np.float32)
    return lambda raw: {"embeds": torch.as_tensor(emb[raw["tokens"]],
                                                  device=dev),
                        "targets": torch.as_tensor(raw["targets"],
                                                   device=dev)}


def _restore(directory: str, name: str, tree: dict) -> None:
    """Group ``name`` of a step dir written into ``tree``'s tensors, leaf
    by leaf through host memory (no second device copy of the state)."""
    got = ckpt.restore(directory, name, tree, device="cpu")
    with torch.no_grad():
        for w, r in zip(adamw.leaves(tree), adamw.leaves(got)):
            w.copy_(r)


def train(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, steps: int,
          batch: int, seq: int, device: "str | torch.device" = "cuda",
          ckpt_dir: "str | None" = None, ckpt_every: int = 50,
          resume: bool = False, accum_steps: int = 1, seed: int = 0,
          on_step=None, mesh=None) -> dict:
    """Train ``cfg`` for ``steps`` steps of ``batch`` x ``seq`` tokens
    (steps ``start .. start + steps - 1``; ``start`` is 0, or with
    ``resume`` the newest step saved under ``ckpt_dir``). Every
    ``ckpt_every`` steps ``{'params', 'opt'}`` is saved asynchronously as
    ``step_<n>`` (the previous save joined first). ``on_step(i, record)``
    is called after each step with its record. Returns per-step lists
    ``step``, ``loss``, ``lr``, ``grad_norm`` and ``seconds`` (wall time
    of the step, ending in a device synchronise), ``start``, ``init_s``,
    and the final ``params`` and ``opt`` state (this rank's blocks on a
    ``mesh``; every rank takes the same global batches and only rank 0
    prints)."""
    dev = devmod.resolve(device)
    model = build(cfg)
    tp = TokenPipeline(cfg.vocab_size, batch=batch, seq_len=seq, seed=seed)
    to_batch = _batcher(cfg, dev)
    t0 = time.perf_counter()
    say = print if mesh is None or mesh.rank == 0 else lambda *a, **k: None
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(seed))
    if mesh is not None:
        p_specs, o_specs, _, (p_shapes, o_shapes) = train_lib.shardings_for(
            cfg, mesh, {})
        params = shd.shard_tree(params, p_specs, mesh)
    opt = adamw.init(params)
    start = 0
    if resume and ckpt_dir and ckpt.latest_step(ckpt_dir):
        start = ckpt.latest_step(ckpt_dir)
        d = os.path.join(ckpt_dir, f"step_{start}")
        if mesh is None:
            _restore(d, "params", params)
            _restore(d, "opt", opt)
        else:
            params = ckpt.restore_sharded(d, "params", p_shapes, p_specs,
                                          mesh, dev)
            opt = ckpt.restore_sharded(d, "opt", o_shapes, o_specs, mesh,
                                       dev)
        say(f"resumed from step {start}")
    _sync(dev)
    init_s = time.perf_counter() - t0
    step_fn = train_lib.make_train_step(cfg, opt_cfg, mesh,
                                        accum_steps=accum_steps)
    wd = StragglerWatchdog(
        threshold=5.0,
        on_straggle=lambda s, dt, med: say(
            f"[watchdog] step {s} took {dt:.2f}s (median {med:.2f}s)"))
    hist = {k: [] for k in ("step", "loss", "lr", "grad_norm", "seconds")}
    pending = None
    t_start = time.perf_counter()
    try:
        for i in range(start, start + steps):
            b = to_batch(tp.batch_at(i))
            wd.start_step()
            t = time.perf_counter()
            params, opt, metrics = step_fn(params, opt, b)
            rec = {"step": i, "loss": float(metrics["loss"]),
                   "lr": float(metrics["lr"]),
                   "grad_norm": float(metrics["grad_norm"])}
            rec["seconds"] = time.perf_counter() - t
            wd.end_step()
            for k, v in rec.items():
                hist[k].append(v)
            if i % 10 == 0 or i == start + steps - 1:
                say(f"step {i:4d} loss {rec['loss']:.4f} lr "
                      f"{rec['lr']:.2e} gnorm {rec['grad_norm']:.2f} "
                      f"({time.perf_counter() - t_start:.1f}s)", flush=True)
            if ckpt_dir and (i + 1) % ckpt_every == 0 and mesh is not None:
                ckpt.save_sharded(
                    os.path.join(ckpt_dir, f"step_{i + 1}"), i + 1,
                    {"params": params, "opt": opt},
                    {"params": p_specs, "opt": o_specs}, mesh)
            elif ckpt_dir and (i + 1) % ckpt_every == 0:
                if pending is not None:
                    pending.join()          # don't stack async saves
                pending = ckpt.save(
                    os.path.join(ckpt_dir, f"step_{i + 1}"), i + 1,
                    {"params": params, "opt": opt}, async_=True)
            if on_step is not None:
                on_step(i, rec)
    finally:
        if pending is not None:
            pending.join()
    return dict(hist, start=start, init_s=init_s, params=params, opt=opt)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="xlstm-125m", choices=configs.ARCH_IDS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default=None,
                    help="e.g. 4,2 => (data=4, model=2), one rank each "
                         "(under torchrun, or an initialised group)")
    ap.add_argument("--smoke-width", action="store_true", default=True,
                    help="use the reduced smoke config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    cfg = (configs.smoke_config(args.arch) if args.smoke_width
           else configs.full_config(args.arch))
    cfg = dataclasses.replace(cfg, remat="none")
    ocfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=20,
                             decay_steps=max(args.steps, 100))
    kw = dict(device=args.device, ckpt_dir=args.ckpt_dir,
              ckpt_every=args.ckpt_every, resume=args.resume,
              accum_steps=args.accum_steps)
    if not args.mesh:
        return train(cfg, ocfg, args.steps, args.batch, args.seq, **kw)
    shape = tuple(int(x) for x in args.mesh.split(","))
    own = not dist.initialized()
    if own and "RANK" not in os.environ:
        raise ValueError(f"--mesh {args.mesh}: run under torchrun with one "
                         f"process a device, or in an initialised group")
    kw["device"] = dist.init(device=args.device) if own else dist.device()
    try:
        mesh = meshlib.make_mesh(shape, ("data", "model")[: len(shape)])
        return train(cfg, ocfg, args.steps, args.batch, args.seq, mesh=mesh,
                     **kw)
    finally:
        if own:
            dist.destroy()


if __name__ == "__main__":
    main()
