#!/usr/bin/env python3
"""Device time of the two serve-time accumulates, fp32 and bf16 SVs.

    python3 scripts/time_accumulate.py [--src PATH] [--label NAME]

Times ``rbf_accumulate`` at ``chip_smoke.py``'s ``[check]`` shape (B
4,096 queries x the first 18,048 rows of the a9a stand-in, rows padded to
124 features as the serving engine pads them) and ``ell_rbf_accumulate``
at B 4,096 x 7,936 rows of the w7a stand-in laid out as ELL at K 128 (the
shape of ``[check-ell]``'s trained model), each at B 4,096 with the
inputs out of L2 and at B 64 with the SVs in L2 (``chip_smoke.py``'s
``DeviceTimer``). Where the checkout's wrappers take bf16 SVs, the same
SVs stored as bf16 are timed too. ``--src`` imports ``repro_torch`` from
another checkout's ``src`` (a parent commit unpacked with ``git
archive``), so two versions can be timed alternately in one call on one
card. Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(0, str(ROOT))

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    from chip_smoke import INV, DeviceTimer, card_line
    from repro_torch.data import make
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    time_ms = DeviceTimer(torch, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    out = {"label": args.label, "src": args.src, "card": card_line()}

    X, _, Xt, _ = make("a9a", 1.0, seed=0)
    B, M, w = 4096, 18048, 124
    pad = lambda a, n: np.pad(a, ((0, 0), (0, w - a.shape[1])))[:n]
    Xs = torch.as_tensor(pad(X, M), device=dev)
    Zq = torch.as_tensor(pad(np.resize(Xt, (B, Xt.shape[1])), B), device=dev)
    cf = torch.rand(M, generator=g, device=dev) * 32.0
    Xw = Xs.to(torch.bfloat16).float()
    sq = (Xw * Xw).sum(1)
    dense = {"fp32": Xw, "bf16": Xw.to(torch.bfloat16)}

    Xe, _, Xet, _ = make("w7a", 1.0, seed=0)
    Me, K = 7936, 128
    vals = np.zeros((Me, K), np.float32)
    cols = np.zeros((Me, K), np.int32)
    for i in range(Me):
        nz = np.flatnonzero(Xe[i])[:K]
        vals[i, : nz.size], cols[i, : nz.size] = Xe[i, nz], nz
    v = torch.as_tensor(vals, device=dev).to(torch.bfloat16).float()
    c = torch.as_tensor(cols, device=dev)
    se = (v * v).sum(1)
    ce = torch.randn(Me, generator=g, device=dev)
    Ze = torch.as_tensor(np.resize(Xet, (B, Xet.shape[1])), device=dev)
    ell = {"fp32": v, "bf16": v.to(torch.bfloat16)}

    for kind in ("fp32", "bf16"):
        try:
            ops.rbf_accumulate(dense[kind], sq, cf, Zq[:64].contiguous(), INV)
            ops.ell_rbf_accumulate(ell[kind], c, se, ce,
                                   Ze[:64].contiguous(), INV)
        except (TypeError, RuntimeError) as e:   # no bf16 SVs there
            out[kind] = f"not taken: {e}"
            continue
        xd, ve = dense[kind], ell[kind]
        out[kind] = {
            "rbf_accumulate_ms": time_ms(
                lambda *a: ops.rbf_accumulate(*a, INV), (xd, sq, cf, Zq),
                reps=10),
            "rbf_accumulate_b64_ms": time_ms(
                lambda z: ops.rbf_accumulate(xd, sq, cf, z, INV),
                (Zq[:64].contiguous(),), reps=50),
            "ell_rbf_accumulate_ms": time_ms(
                lambda *a: ops.ell_rbf_accumulate(*a, INV),
                (ve, c, se, ce, Ze), reps=10),
            "ell_rbf_accumulate_b64_ms": time_ms(
                lambda z: ops.ell_rbf_accumulate(ve, c, se, ce, z, INV),
                (Ze[:64].contiguous(),), reps=50)}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
