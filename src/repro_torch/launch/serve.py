"""Unified serving launcher: SVM scoring, or LM serving — prefill a batch
of prompts, then greedy-decode against the family's cache (KV cache /
mLSTM and sLSTM states / Mamba2 states and shared-attention KV; twin of
``repro.launch.serve`` and the ``examples/serve_lm.py`` it runs). Every
arch of ``configs.ARCH_IDS`` serves.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
        --device cpu            # the arch's smoke config; default cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --svm --dataset a9a \\
        --device cpu            # launch.svm_serve's flags

``--svm`` dispatches to :mod:`repro_torch.launch.svm_serve` (the SVM
inference plane, ``core.serve.ServeEngine``); everything else is LM
serving.

Same flags and the same smoke config as the reference example, plus
``--device``. ``generate`` is the library function (``chip_smoke.py``
calls it with a full config). Unlike the example, which builds the cache
by one-token decode over the prompt, the prompt goes through the prefill
step in one pass (attention through the flash kernel on the card, the
recurrent families' chunkwise scans) and that pass fills the cache. An
MoE prefill drops (token, slot) pairs over an expert's capacity as the
reference's forward does, which one-token decode never does, so its
continuation can differ from the example's.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch import device as devmod
from repro_torch.launch import train_lib
from repro_torch.models.api import ModelConfig, build


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(params: dict, cfg: ModelConfig, prompts: torch.Tensor,
             n_tokens: int, embed_table: "torch.Tensor | None" = None
             ) -> dict:
    """Greedy continuation of ``prompts`` (B, Lp) int tokens: one prefill
    step over the prompts (which fills the family's cache), then
    ``n_tokens - 1`` decode steps. The recurrent families need Lp to be a
    multiple of ``min(cfg.chunk, Lp)``. The embeds frontend maps tokens to inputs through
    ``embed_table`` (V, d), as the reference example does. Returns
    ``tokens`` (B, n_tokens), the wall seconds of the prefill and of the
    decode steps (each ending in a device synchronise), and the cache."""
    if n_tokens < 1:
        raise ValueError(f"n_tokens must be >= 1, got {n_tokens}")
    model = build(cfg)
    if cfg.frontend == "tokens":
        to_in = lambda t: {"tokens": t}
    elif embed_table is None:
        raise ValueError(f"{cfg.name} takes embeddings: pass embed_table")
    else:
        to_in = lambda t: {"embeds": embed_table[t.long()]}
    B, Lp = prompts.shape
    dev = prompts.device
    cache = model.init_cache(cfg, B, Lp + n_tokens, dev)
    prefill = train_lib.make_prefill_step(cfg)
    step = train_lib.make_serve_step(cfg)
    _sync(dev)
    t0 = time.perf_counter()
    nxt = prefill(params, to_in(prompts), cache)
    _sync(dev)
    t1 = time.perf_counter()
    out = [nxt]
    for _ in range(n_tokens - 1):
        nxt, cache = step(params, cache, to_in(nxt[:, None]))
        out.append(nxt)
    _sync(dev)
    t2 = time.perf_counter()
    return {"tokens": torch.stack(out, dim=1), "prefill_s": t1 - t0,
            "decode_s": t2 - t1, "cache": cache}


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--svm" in argv:
        argv.remove("--svm")
        from repro_torch.launch import svm_serve
        return svm_serve.main(argv)
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="llama3-8b", choices=configs.ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = devmod.resolve(args.device)
    cfg = configs.smoke_config(args.arch)
    model = build(cfg)
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    emb = None
    if cfg.frontend == "embeds":
        emb = torch.as_tensor(rng.normal(
            scale=0.02, size=(cfg.vocab_size, cfg.d_model)).astype(np.float32),
            device=dev)
    prompts = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32),
        device=dev)
    res = generate(params, cfg, prompts, args.tokens, emb)
    gen = res["tokens"].cpu().numpy()
    dt = res["prefill_s"] + res["decode_s"]
    print(f"{args.arch}: generated {gen.shape} on {dev.type} in {dt:.2f}s "
          f"(prefill {res['prefill_s'] * 1e3:.1f} ms, decode "
          f"{res['decode_s'] * 1e3 / max(args.tokens - 1, 1):.2f} ms/step, "
          f"{args.batch * args.tokens / dt:.1f} tok/s)")
    print("sample:", gen[0][:16])
    return res


if __name__ == "__main__":
    main()
