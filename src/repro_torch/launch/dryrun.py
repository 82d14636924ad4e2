"""Multi-pod dry-run of the port (twin of ``repro.launch.dryrun``): every
(architecture x input shape) cell on the production meshes, priced from
shapes, with no process and no allocation.

    python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] \\
        [--out results.json] [--jobs 4]

The reference lowers and compiles each cell for 256 or 512 fake devices
and reads XLA's cost and memory analyses. The port runs eagerly and has
no compiled program, so each cell is priced from what the port would do:

* the reference's four per-cell policies, copied exactly (the layout, the
  MoE dispatch, the accumulation factor, the repeat unit), so every cell
  is the same work as the reference's;
* its skip rule (``configs.applicable``);
* per-device argument bytes, exactly: each rank's blocks of the params,
  the AdamW moments (train), the batch and the cache (decode), from the
  specs of ``launch.sharding`` on an axis view of the mesh;
* ``model_flops``: 6 (train) or 2 times ``active_params`` times tokens,
  as the reference computes it;
* the collectives: the step's own plan, the list that tests hold its
  ``dist.calls`` to: ``MeshStep.plan`` for a train cell, ``MeshServe.plan``
  for a prefill or decode cell of every family (a decode cell reading a
  cache of ``seq_len`` positions filled to ``seq_len - 1``), priced per
  chip by the ring model;
* FLOPs, on the single-pod mesh, by the reference's scheme: models of one
  and two repeat units (and the hybrid's tail), differenced and
  extrapolated to full depth, times ``accum``. Each is a forward (and for
  a train cell a backward, through remat as configured) at the cell's
  full width, full sequence and one rank's microbatch, on ``meta``
  tensors under ``torch.utils.flop_counter.FlopCounterMode``, so it also
  proves that every cell's shapes flow through the step. A cell under tp
  runs with this rank's 'model' blocks (``local_shapes``; a decode cell
  with this rank's block of the cache, in ``MeshServe.context``) inside
  ``common.model_parallel`` with no process group, so it counts a rank's
  own split products and its collectives only give shapes (the plan
  prices them). The count is of matrix
  products (what ``FlopCounterMode`` counts); on meta the attention takes
  its plain path.

``overrides`` (``run_cell``'s, applied to the config as the reference's
``lower_cell`` applies its own) price a variant of a cell, e.g.
``{"seq_parallel": True}``; there is no command-line flag for them.

The three terms use the H100 peaks of ``launch.roofline`` (bf16 tensor
cores, HBM3, NVLink). The memory term is a lower bound: the arguments read
once and the updated state written once. A 256-card mesh spans 32 hosts,
so its collectives cross nodes, and one NVLink figure is the best case.
Where the port has no compiler number (temporary bytes, XLA's bytes
accessed) the record's key is ``null``, under ``"source": "shapes"``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import multiprocessing
import time
import traceback
from concurrent.futures import ProcessPoolExecutor

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import roofline
from repro_torch.launch import sharding as shd
from repro_torch.launch import train_lib
from repro_torch.launch.mesh import production_axes
from repro_torch.models import common
from repro_torch.models.api import build
from repro_torch.optim import adamw


def _layout_for(cfg, shape) -> str:
    """Auto layout per cell (§Perf iteration 6): pure-FSDP (model axis folded
    into data parallelism) wins 3.8x on collectives for dense train cells
    whose global batch covers the whole mesh and whose activations fit at
    accum=1; TP/EP otherwise (MoE dispatch + wide-arch memory)."""
    if (shape.kind == "train" and not cfg.is_moe
            and cfg.family in ("dense", "audio", "vlm")
            and cfg.d_model <= 4096 and shape.global_batch >= 256):
        return "fsdp"
    return cfg.layout


def _moe_impl_for(cfg, shape) -> str:
    """Per-shape MoE dispatch policy (§Perf known-regression fix): scatter
    wins on train/decode; at 32k-token prefill groups the scatter/gather
    resharding outweighs the phantom-FLOP savings — use the GShard einsum
    there."""
    return "einsum" if shape.kind == "prefill" else cfg.moe_impl


def _accum_for(cfg, shape) -> int:
    """Microbatch accumulation factor for train cells (memory knob).
    Wide archs (d_model >= 5120) need 16 to fit 16 GiB v5e HBM at global
    batch 256 x 4k; the fsdp layout requires accum=1 (microbatch must cover
    the full 256-device combined axis)."""
    if shape.kind != "train":
        return 1
    if _layout_for(cfg, shape) == "fsdp":
        return 1
    # microbatch must stay divisible by the 16-way data axis (256/16): a
    # smaller microbatch un-shards the batch dim and replicates activations
    return 16 if cfg.d_model >= 5120 else 8


def _unit_layers(cfg) -> int:
    """Smallest homogeneous repeat unit (layers per scan group)."""
    if cfg.family == "ssm" and cfg.slstm_every:
        return cfg.slstm_every
    if cfg.family == "hybrid" and cfg.attn_every:
        return cfg.attn_every
    return 1


class SkipCell(Exception):
    pass


def cell_config(arch: str, shape_name: str, overrides: "dict | None" = None):
    """(cfg, shape) of a cell: the full config with the cell's policies,
    after ``overrides``; raises :class:`SkipCell` where it does not
    apply."""
    overrides = overrides or {}
    cfg = dataclasses.replace(configs.full_config(arch), **overrides)
    shape = SHAPES[shape_name]
    if "layout" not in overrides:
        cfg = dataclasses.replace(cfg, layout=_layout_for(cfg, shape))
    if cfg.is_moe and "moe_impl" not in overrides:
        cfg = dataclasses.replace(cfg, moe_impl=_moe_impl_for(cfg, shape))
    ok, why = configs.applicable(cfg, shape)
    if not ok:
        raise SkipCell(why)
    return cfg, shape


def _block_bytes(tree, specs, mesh) -> int:
    return sum(math.prod(shd.block_shape(s, tuple(x.shape), mesh))
               * x.dtype.itemsize
               for x, s in zip(shd.leaves(tree), shd.leaves(specs)))


def argument_bytes(cfg, shape, mesh) -> dict:
    """Per-device bytes of the step's arguments, by group: this rank's
    blocks of params, moments (train), batch and cache (decode)."""
    batch = configs.input_specs(cfg, shape)
    p_specs, o_specs, b_specs, (p_shapes, o_shapes) = \
        train_lib.shardings_for(cfg, mesh, batch)
    out = {"params": _block_bytes(p_shapes, p_specs, mesh),
           "batch": _block_bytes(batch, b_specs, mesh)}
    if shape.kind == "train":
        out["opt"] = _block_bytes(o_shapes, o_specs, mesh)
    if shape.kind == "decode":
        c_specs, c_shapes = train_lib.serve_shardings(
            cfg, mesh, shape.global_batch, shape.seq_len)
        out["cache"] = _block_bytes(c_shapes, c_specs, mesh)
    return out


def model_flops(cfg, shape) -> float:
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    return (6.0 if shape.kind == "train" else 2.0) * cfg.active_params() \
        * tokens


def collective_plan(cfg, shape, mesh, accum: int) -> list:
    """The collectives of one step of the cell: the train step's plan, or
    the serving step's (a prefill that fills no cache; a decode from a
    cache of ``seq_len`` positions filled to ``seq_len - 1``)."""
    batch = configs.input_specs(cfg, shape)
    if shape.kind == "train":
        step = train_lib.MeshStep(cfg, adamw.AdamWConfig(), mesh,
                                  accum_steps=accum)
        return step.plan(batch)
    return train_lib.MeshServe(cfg, mesh, shape.kind).plan(
        batch, pos=shape.seq_len - 1 if shape.kind == "decode" else 0)


def local_rows(cfg, shape, mesh, accum: int) -> int:
    """Rows of one rank's microbatch: the train step's split, or a serving
    batch's ``batch_specs`` block."""
    if shape.kind == "train":
        step = train_lib.MeshStep(cfg, adamw.AdamWConfig(), mesh,
                                  accum_steps=accum)
        per, split, _ = step.layout(shape.global_batch)
        return per // math.prod(mesh.sizes[a] for a in split)
    ba = shd.batch_axes_for(mesh, cfg.layout)
    n = math.prod(mesh.sizes[a] for a in ba)
    return shape.global_batch // n if shape.global_batch % n == 0 \
        else shape.global_batch


def meta_flops(cfg, shape, rows: int, mesh=None) -> float:
    """FLOPs of one rank's pass over ``rows`` rows on meta tensors: the
    loss's forward and backward (train), the prefill step, or one decode
    step against a cache filled to ``seq_len - 1``. Given the ``mesh``, the
    pass takes the sharded step's 'model' blocks (a decode cell this
    rank's block of the cache, in the serving step's contexts)."""
    model = build(cfg)
    params = model.init(cfg, common.MetaDraw())
    sub = dataclasses.replace(shape, global_batch=rows)
    batch = configs.input_specs(cfg, sub)
    ctx = contextlib.nullcontext()
    step = None
    if mesh is not None and shape.kind == "train":
        step = train_lib.MeshStep(cfg, adamw.AdamWConfig(), mesh)
        sp = step._seq(shape.seq_len, step.layout(shape.global_batch)[1])
        if step.tp:
            ctx = common.model_parallel(None, step.n_model, 0,
                                        step.seq_roles if sp else step.roles,
                                        seq=sp)
    elif mesh is not None:
        step = train_lib.MeshServe(cfg, mesh, shape.kind)
        n = shape.global_batch
        sp = step._seq(batch[next(iter(batch))].shape[1], step.row_axes(n))
        specs = train_lib.serve_shardings(cfg, mesh, n, shape.seq_len)[0] \
            if shape.kind == "decode" else None
        ctx = step.context(n, specs, sp, live=False)
    if step is not None and step.tp:
        params = adamw.tree_like(params, [
            torch.empty(s, dtype=x.dtype, device="meta")
            for s, x in zip(step.local_shapes(), adamw.leaves(params))])
    with ctx, FlopCounterMode(display=False) as fc:
        if shape.kind == "train":
            flat = [w.requires_grad_() for w in adamw.leaves(params)]
            loss, _ = train_lib.make_loss_fn(cfg)(
                adamw.tree_like(params, flat), batch)
            torch.autograd.grad(loss, flat)
        elif shape.kind == "prefill":
            with torch.no_grad():
                train_lib.make_prefill_step(cfg)(params, batch)
        else:
            cache = model.init_cache(cfg, rows, shape.seq_len, device="meta") \
                if step is None else step.init_cache(
                    shape.global_batch, shape.seq_len, device="meta")
            cache["pos"] = shape.seq_len - 1
            with torch.no_grad():
                train_lib.make_serve_step(cfg)(params, cache, batch)
    return float(fc.get_total_flops())


def flops_extrapolated(arch: str, shape_name: str, mesh, accum: int,
                       rows: int, overrides: "dict | None" = None) -> float:
    """Global FLOPs of the cell's step: 1-unit and 2-unit models
    differenced and extrapolated to full depth (plus the hybrid's tail),
    exact by linearity because repeat units are identical; times the
    accumulation factor and the chips."""
    full = configs.full_config(arch)
    unit = _unit_layers(full)
    n_units = full.n_layers // unit
    tail = full.n_layers - n_units * unit
    shape, seq = SHAPES[shape_name], SHAPES[shape_name].seq_len
    if full.family == "ssm" and shape.kind != "decode":
        # the sLSTM recurrence steps position by position, ~25 meta ops a
        # step at ~1 ms each: price one scan chunk and scale, exact because
        # every product of the family is linear in L over whole chunks
        seq = full.chunk
    scale = shape.seq_len / seq

    def measure(n_layers):
        cfg, sh = cell_config(arch, shape_name,
                              dict(overrides or {}, n_layers=n_layers))
        return meta_flops(cfg, dataclasses.replace(sh, seq_len=seq), rows,
                          mesh)

    a, b = measure(unit), measure(2 * unit)
    tot = a + (n_units - 1) * (b - a)
    if tail:  # hybrid tail = plain backbone layers (no shared-attn call)
        tot += measure(unit + tail) - a
    return tot * scale * accum * mesh.size


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             verbose: bool = True, cost_tier: bool = True,
             overrides: "dict | None" = None) -> dict:
    mesh = production_axes(multi_pod=multi_pod)
    name = "2x16x16" if multi_pod else "16x16"
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {name}", flush=True)
    rec = {"arch": arch, "shape": shape_name, "mesh": name,
           "source": "shapes"}
    try:
        cfg, shape = cell_config(arch, shape_name, overrides)
    except SkipCell as e:
        if verbose:
            print(f"  SKIP: {e}")
        rec.update(status="skip", reason=str(e))
        return rec
    chips, accum = mesh.size, _accum_for(cfg, shape)
    args = argument_bytes(cfg, shape, mesh)
    arg_b = sum(args.values())
    plan = collective_plan(cfg, shape, mesh, accum)
    link = train_lib.link_bytes(plan)
    counts = train_lib.plan_calls(plan)
    by_kind = {}
    for e in plan:
        by_kind[e["op"]] = by_kind.get(e["op"], 0) + e["bytes"] * e["calls"]
    mf = model_flops(cfg, shape)
    rec.update(status="ok", accum_steps=accum, layout=cfg.layout,
               memory={"argument_size_in_bytes": arg_b,
                       "output_size_in_bytes": None,
                       "temp_size_in_bytes": None,
                       "alias_size_in_bytes": None},
               argument_bytes=args, model_flops=mf,
               link_bytes_per_chip=link,
               collectives={"counts": counts, "bytes": by_kind})
    if verbose:
        print(f"  memory/device: args = {arg_b / 2**30:.2f} GiB "
              f"(accum={accum}, layout={cfg.layout}); collectives "
              f"{counts}, {link / 2**30:.3f} GiB a chip", flush=True)
    if not cost_tier:
        return rec
    t0 = time.perf_counter()
    rows = local_rows(cfg, shape, mesh, accum)
    flops_g = flops_extrapolated(arch, shape_name, mesh, accum, rows,
                                 overrides)
    # the state is read once, and a train step writes params and moments
    written = args["params"] + args.get("opt", 0) if shape.kind == "train" \
        else args.get("cache", 0)
    bytes_dev = arg_b + written
    rl = roofline.analyze(flops_g, bytes_dev * chips, link, chips, mf,
                          collectives=rec["collectives"],
                          bytes_per_device=arg_b,
                          peak_flops=roofline.H100_BF16_FLOPS)
    rec.update(
        flops_global=flops_g, hbm_bytes_global=None,
        hbm_bytes_est_per_dev=None, hbm_bytes_min_per_dev=bytes_dev,
        t_compute_s=rl.t_compute, t_memory_s=rl.t_memory,
        t_memory_est_s=None, t_collective_s=rl.t_collective,
        dominant=rl.dominant, useful_ratio=rl.useful_ratio,
        local_rows=rows, flops_seconds=time.perf_counter() - t0)
    if verbose:
        print(f"  roofline: compute={rl.t_compute * 1e3:.2f}ms "
              f"memory(min)={rl.t_memory * 1e3:.2f}ms "
              f"collective={rl.t_collective * 1e3:.2f}ms -> {rl.dominant}"
              f" | useful={rl.useful_ratio:.2f} "
              f"({rec['flops_seconds']:.1f} s)", flush=True)
    return rec


def _cell(arch: str, shp: str, mp: bool, verbose: bool) -> dict:
    try:
        # the roofline terms are single-pod only, as in the reference; the
        # multi-pod pass prices its state and its collectives
        return run_cell(arch, shp, mp, verbose=verbose, cost_tier=not mp)
    except Exception:
        traceback.print_exc()
        return {"arch": arch, "shape": shp,
                "mesh": "2x16x16" if mp else "16x16", "status": "error",
                "error": traceback.format_exc()[-2000:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells priced at once, one process each")
    args = ap.parse_args(argv)
    archs = configs.ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if (args.both_meshes or
                               (args.all and not args.multi_pod)) \
        else [args.multi_pod]
    cells = [(arch, shp, mp) for mp in meshes for arch in archs
             for shp in shapes]
    if args.jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(args.jobs, mp_context=ctx) as pool:
            futs = [pool.submit(_cell, *c, False) for c in cells]
            results = [f.result() for f in futs]
        for r in results:
            print(f"[dryrun] {r['arch']} x {r['shape']} x {r['mesh']}: "
                  f"{r['status']}", flush=True)
    else:
        results = [_cell(*c, True) for c in cells]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skip, {n_err} error")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
