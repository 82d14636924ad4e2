"""SVM training launcher — the paper's algorithm as a CLI (twin of
``repro.launch.svm_train``).

    python -m repro_torch.launch.svm_train --dataset a9a --heuristic multi5pc \\
        [--scale 0.05] [--ckpt-dir ckpt/ --resume] [--device cpu]
    torchrun --nproc-per-node N -m repro_torch.launch.svm_train --devices N

The reference's flags and defaults, with ``--device {cuda,cpu}`` (default
``cuda``) in place of ``--use-pallas``: the port runs its hand-written
kernels on CUDA tensors and their plain versions on CPU tensors, so the
device picks the kernels. Multi-class datasets (``covtype``, ``news20``)
train one-vs-rest as ONE batched fit (``core.multi.MultiProblemDriver``;
``--multi-backend loop`` is the sequential parity oracle); ``--grid-c``
sweeps a C grid the same way on a binary dataset.

``--parallel`` / ``--devices N`` train on a process group, one process a
device (``launch.dist``: NCCL between cards, gloo between CPU processes):
start the N processes with ``torchrun``; N must equal the group's size.
Every rank trains; rank 0 prints.
"""
from __future__ import annotations

import argparse
import contextlib
import os


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.svm_train")
    ap.add_argument("--dataset", default="a9a")
    ap.add_argument("--heuristic", default="multi5pc")
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--chunk-iters", type=int, default=256)
    ap.add_argument("--fuse-iters", type=int, default=1,
                    help="SMO segments fused into one device dispatch "
                         "(each up to --chunk-iters iterations); the host "
                         "reads back one fixed-size summary per dispatch. "
                         "Any value is bit-identical to 1")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--parallel", action="store_true",
                    help="train on the process group torchrun started, one "
                         "process a device")
    ap.add_argument("--devices", type=int, default=None,
                    help="the group's size (implies --parallel; must equal "
                         "torchrun's process count). Checkpoints are "
                         "mesh-portable: --resume re-deals a run saved "
                         "under ANY device count onto this one")
    ap.add_argument("--watchdog-threshold", type=float, default=0.0,
                    help="arm the straggler watchdog: a dispatch slower "
                         "than this multiple of the running median forces "
                         "a checkpoint and halves the fused segment "
                         "budget (0 = off)")
    ap.add_argument("--chaos", default=None,
                    help="fault-injection spec (kill@I | kill-save@K | "
                         "delay@I:S | delay-all@I:S) — see "
                         "repro_torch.launch.chaos")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to train: the CUDA kernels on the card, "
                         "their plain versions on the CPU")
    ap.add_argument("--format", default="dense", choices=("dense", "ell"),
                    help="sample storage: dense or block-ELL sparse")
    ap.add_argument("--selection", default="wss1", choices=("wss1", "wss2"),
                    help="working-set selection: first- or second-order")
    ap.add_argument("--row-cache", action="store_true",
                    help="device-resident kernel-row cache (exact: "
                         "identical trajectory, fewer kernel-row passes)")
    ap.add_argument("--row-cache-slots", type=int, default=64)
    ap.add_argument("--row-cache-policy", default="lru",
                    choices=("lru", "slru"),
                    help="cache eviction: plain LRU or scan-resistant "
                         "segmented LRU (both exact)")
    ap.add_argument("--compact-backend", default="device",
                    choices=("device", "host"),
                    help="physical compaction: on-device gather (default) "
                         "or host store rebuild (parity oracle)")
    ap.add_argument("--mirror", default="auto",
                    choices=("auto", "device", "host"),
                    help="device-resident full-set mirror for Alg. 6 and "
                         "the un-shrink: when it fits ('auto'), forced "
                         "('device'), or the host-streaming oracle ('host')")
    ap.add_argument("--mirror-budget-bytes", type=int, default=None,
                    help="per-device byte cap for the mirror (default: "
                         "a fraction of reported device memory)")
    ap.add_argument("--multi-backend", default="batched",
                    choices=("batched", "loop"),
                    help="multi-problem training (multi-class datasets, "
                         "--grid-c): one batched K-problem program "
                         "('batched') or K sequential fits ('loop', the "
                         "parity oracle)")
    ap.add_argument("--grid-c", default=None,
                    help="comma-separated C values: hyperparameter sweep "
                         "on a binary dataset, one problem per value "
                         "batched over the shared store")
    return ap


def join_group(device: str, devices: "int | None") -> None:
    """Join the process group torchrun set up (``launch.dist.init``); a
    run outside torchrun, or one whose ``devices`` differs from the
    group's size, raises ``ValueError``."""
    from repro_torch.launch import dist
    world = os.environ.get("WORLD_SIZE")
    if world is None or "RANK" not in os.environ:
        raise ValueError(
            "--parallel / --devices runs one process a device: start it "
            "under torchrun (torchrun --nproc-per-node N -m "
            "repro_torch.launch.svm_train --devices N ...)")
    if devices is not None and devices != int(world):
        raise ValueError(
            f"--devices {devices}, but torchrun started {world} "
            f"process(es): run torchrun --nproc-per-node {devices}")
    dist.init(device=device)


def main(argv=None) -> None:
    args = parser().parse_args(argv)

    from repro_torch.core import SMOSolver, SVMConfig
    from repro_torch.data import SPECS, make
    from repro_torch.launch import chaos, dist

    if args.devices is not None:
        args.parallel = True
    if args.parallel:
        join_group(args.device, args.devices)
    try:
        spec = SPECS[args.dataset]
        X, y, Xt, yt = make(args.dataset, scale=args.scale, seed=0)
        cfg = SVMConfig(C=spec.C, sigma2=spec.sigma2, eps=args.eps,
                        heuristic=args.heuristic,
                        chunk_iters=args.chunk_iters,
                        fuse_iters=args.fuse_iters,
                        checkpoint_dir=args.ckpt_dir, resume=args.resume,
                        device=args.device, format=args.format,
                        selection=args.selection, row_cache=args.row_cache,
                        row_cache_slots=args.row_cache_slots,
                        row_cache_policy=args.row_cache_policy,
                        compact_backend=args.compact_backend,
                        mirror=args.mirror,
                        mirror_budget_bytes=args.mirror_budget_bytes,
                        watchdog_threshold=args.watchdog_threshold)
        say = print if dist.rank() == 0 else (lambda *a, **k: None)
        plan = (chaos.inject(chaos.parse_spec(args.chaos)) if args.chaos
                else contextlib.nullcontext())
        with plan:
            if spec.n_classes > 2 or args.grid_c:
                _multi(args, cfg, spec, X, y, Xt, yt, say)
                return
            if args.parallel:
                from repro_torch.core.parallel import ParallelSMOSolver
                solver = ParallelSMOSolver(cfg)
            else:
                solver = SMOSolver(cfg)
            m = solver.fit(X, y)
        s = m.stats
        cache = (f" cache_hit={s.cache_hit_rate:.2f}" if args.row_cache
                 else "")
        say(f"{args.dataset}/{args.heuristic}: iters={s.iterations} "
            f"nsv={s.n_sv} conv={s.converged} recon={s.reconstructions} "
            f"mirror={s.mirror} train={s.train_time:.2f}s "
            f"recon_t={s.recon_time:.2f}s{cache}")
        if len(yt) and dist.rank() == 0:
            say(f"test acc: {(m.predict(Xt) == yt).mean():.4f}")
    finally:
        if args.parallel:
            dist.destroy()


def _multi(args, cfg, spec, X, y, Xt, yt, say) -> None:
    """The multi-problem routes: ``--grid-c`` (one problem a C) and the
    one-vs-rest fit of a multi-class dataset."""
    from repro_torch.core import MultiProblemDriver
    drv = MultiProblemDriver(cfg, backend=args.multi_backend,
                             parallel=args.parallel)
    if args.grid_c:
        if spec.n_classes != 2:
            raise ValueError("--grid-c needs a binary dataset")
        Cs = [float(c) for c in args.grid_c.split(",")]
        models = drv.fit_grid(X, y, Cs)
        for k, (C, m) in enumerate(zip(Cs, models)):
            # batched: all models share ONE stats with a K-entry
            # per_problem table; the loop oracle: each model its own
            rec = next((r for r in m.stats.per_problem
                        if r["problem"] == k),
                       {"iterations": m.stats.iterations,
                        "n_sv": m.stats.n_sv})
            say(f"{args.dataset}/C={C:g}: iters={rec['iterations']} "
                f"nsv={rec['n_sv']} obj={m.dual_objective():.4f}")
        return
    mdl = drv.fit_ovr(X, y)
    st = mdl.stats
    train = sum({id(m.stats): m.stats.train_time
                 for m in mdl.models}.values())
    tot = sum(r["iterations"] for r in st.per_problem)
    cache = f" cache_hit={st.cache_hit_rate:.2f}" if args.row_cache else ""
    say(f"{args.dataset}/ovr{len(mdl.classes)}/{args.multi_backend}: "
        f"iters={tot} nsv={st.n_sv} train={train:.2f}s{cache}")
    if len(yt):
        say(f"test acc: {(mdl.predict(Xt) == yt).mean():.4f}")


if __name__ == "__main__":
    main()
