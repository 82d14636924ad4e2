#!/usr/bin/env python3
"""The dense row/gamma kernels beside a bare read of the same X, on one GPU.

    python3 scripts/row_stream_floor.py

At the a9a buffer of ``chip_smoke.py`` (X 32,768 x 123 fp32, 16.1 MB) it
times, with ``chip_smoke.DeviceTimer`` (out of L2, and in L2 with the same
inputs repeated): ``gamma_update`` and ``rbf_rows2`` through
``kernels.ops``, and a bare streaming read of X — each thread sums float4
loads of a grid-strided span and the kernel stores nothing that depends on
them, so it moves the kernel's input bytes and does nothing else — at a
few grid sizes. The gap between the two is what the reduction adds on top
of the stream. The bare kernel is built here with ``nvcc`` into
``build/``; it is a yardstick, not a kernel of the port. Prints the card's
name and power limit, one line per timing and a JSON summary last. Needs a
CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from chip_smoke import A9A_BUFFER, INV, DeviceTimer, card_line  # noqa: E402

READ_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void bare_read(const float4* __restrict__ x, long n4, float* out) {
  float a = 0.0f;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n4;
       i += (long)gridDim.x * blockDim.x) {
    const float4 v = __ldg(x + i);
    a += v.x + v.y + v.z + v.w;
  }
  if (a == 12345.0f) out[0] = a;  // keeps the loads; never true here
}
extern "C" int bare_read_launch(const float* x, long n, float* out,
                                int blocks, int threads, void* stream) {
  bare_read<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float4*)x, n / 4, out);
  return (int)cudaGetLastError();
}
"""
GRIDS = ((264, 1024), (528, 512), (1056, 256), (4224, 256))


def bare_read_lib():
    from repro_torch.kernels import cuda
    cuda.build_dir().mkdir(parents=True, exist_ok=True)
    src = cuda.build_dir() / "bare_read.cu"
    out = cuda.build_dir() / "libbare_read.so"
    src.write_text(READ_SOURCE)
    subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True)
    f = ctypes.CDLL(str(out)).bare_read_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    f.argtypes = [P, ctypes.c_long, P, I, I, P]
    f.restype = I
    return f


def main() -> None:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    from repro_torch.data import make
    from repro_torch.kernels import cuda, ops
    dev = torch.device("cuda")
    print(card_line(), flush=True)
    time_ms = DeviceTimer(torch, dev)
    X, _, _, _ = make("a9a", 1.0, seed=0)
    m, d = A9A_BUFFER, X.shape[1]
    Xb = np.zeros((m, d), np.float32)
    Xb[: min(m, X.shape[0])] = X[:m]
    Xd = torch.as_tensor(Xb, device=dev)
    sq = (Xd * Xd).sum(1)
    g = torch.Generator(device=dev).manual_seed(0)
    gam = torch.randn(m, generator=g, device=dev)
    z2 = Xd[torch.tensor([5, 1000], device=dev)].contiguous()
    coef2 = torch.randn(2, generator=g, device=dev)
    read = bare_read_lib()
    sink = torch.zeros(1, device=dev)
    res = {}

    def timed(name, fn, ins):
        res[name] = (time_ms(fn, ins, reps=200) * 1e3,
                     time_ms(fn, ins, reps=200, cold=False) * 1e3)
        print(f"[floor] {name}: {res[name][0]:.2f} us out of L2, "
              f"{res[name][1]:.2f} us in L2", flush=True)

    for blocks, threads in GRIDS:
        def bare(x, blocks=blocks, threads=threads):
            cuda.raise_on(read(cuda.ptr(x), x.numel(), cuda.ptr(sink), blocks,
                               threads, cuda.stream(x)), "bare_read")
        timed(f"bare read {blocks}x{threads}", bare, (Xd,))
    timed("gamma_update", lambda *a: ops.fused_gamma_update("rbf", *a, INV),
          (Xd, sq, gam, z2, coef2))
    timed("rbf_rows2", lambda *a: ops.kernel_rows2("rbf", *a, INV),
          (Xd, sq, z2))
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "shape": f"X {m}x{d}", "bytes": Xd.numel() * 4,
                      "us": res}), flush=True)


if __name__ == "__main__":
    main()
