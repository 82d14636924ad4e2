#!/usr/bin/env python3
"""The row/gamma kernels beside a bare read of the bytes they stream, on one
GPU.

    python3 scripts/row_stream_floor.py          # dense: the a9a buffer
    python3 scripts/row_stream_floor.py --ell    # block-ELL: the w7a buffer

Dense (the default). At the a9a buffer of ``chip_smoke.py`` (X 32,768 x
123 fp32, 16.1 MB) it times, with ``chip_smoke.DeviceTimer`` (out of L2,
and in L2 with the same inputs repeated): ``gamma_update`` and
``rbf_rows2`` through
``kernels.ops``, and a bare streaming read of X — each thread sums float4
loads of a grid-strided span and the kernel stores nothing that depends on
them, so it moves the kernel's input bytes and does nothing else — at a
few grid sizes. The gap between the two is what the reduction adds on top
of the stream.

``--ell``. At the w7a buffer of ``chip_smoke.py`` (32,768 x K 128, d 300,
vals 16.8 MB fp32 and cols 16.8 MB int32) it times ``ell_gamma_update`` and
``ell_kernel_rows2`` through ``kernels.ops`` beside a bare float4 read of
vals, and a bare read of vals and cols together (the bytes a body that
read every col would move), at the same grid sizes; then the two kernels
on the same rows at K = 16 (what the lane budget ``ell_lane = 16`` would
build).

The bare kernels are built here with ``nvcc`` into ``build/``; they are
yardsticks, not kernels of the port. Prints the
card's name and power limit, one line per timing and a JSON summary last.
Needs a CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from chip_smoke import (A9A_BUFFER, INV, W7A_BUFFER,  # noqa: E402
                        DeviceTimer, card_line, ell_buffer)

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
__global__ void bare_read2(const float4* __restrict__ x,
                           const float4* __restrict__ y, long n4,
                           float* out) {
  float a = 0.0f;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n4;
       i += (long)gridDim.x * blockDim.x) {
    const float4 v = __ldg(x + i), w = __ldg(y + i);
    a += v.x + v.y + v.z + v.w + w.x + w.y + w.z + w.w;
  }
  if (a == 12345.0f) out[0] = a;
}
extern "C" int bare_read_launch(const float* x, long n, float* out,
                                int blocks, int threads, void* stream) {
  bare_read<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float4*)x, n / 4, out);
  return (int)cudaGetLastError();
}
extern "C" int bare_read2_launch(const float* x, const void* y, long n,
                                 float* out, int blocks, int threads,
                                 void* stream) {
  bare_read2<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (const float4*)y, n / 4, out);
  return (int)cudaGetLastError();
}
"""
GRIDS = ((264, 1024), (528, 512), (1056, 256), (4224, 256))
P, I = ctypes.c_void_p, ctypes.c_int


def bare_read_lib():
    """Build the bare reads with the port's nvcc flags into ``build/`` and
    load them."""
    from repro_torch.kernels import cuda
    cuda.build_dir().mkdir(parents=True, exist_ok=True)
    src = cuda.build_dir() / "bare_read.cu"
    out = cuda.build_dir() / "libbare_read.so"
    src.write_text(READ_SOURCE)
    subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-o", str(out), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    f, f2 = lib.bare_read_launch, lib.bare_read2_launch
    f.argtypes = [P, ctypes.c_long, P, I, I, P]
    f2.argtypes = [P, P, ctypes.c_long, P, I, I, P]
    f.restype = f2.restype = I
    return f, f2


def setup(torch):
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda")
    print(card_line(), flush=True)
    return dev, DeviceTimer(torch, dev), {}


def timer(time_ms, res):
    def timed(name, fn, ins):
        res[name] = (time_ms(fn, ins, reps=200) * 1e3,
                     time_ms(fn, ins, reps=200, cold=False) * 1e3)
        print(f"[floor] {name}: {res[name][0]:.2f} us out of L2, "
              f"{res[name][1]:.2f} us in L2", flush=True)
    return timed


def ell_main() -> None:
    """The ELL row kernels at the w7a buffer beside bare reads of vals and
    of vals + cols, and at K = 16."""
    import numpy as np
    import torch
    dev, time_ms, res = setup(torch)
    from repro_torch.data import make
    from repro_torch.kernels import cuda, ops
    X, _, _, _ = make("w7a", 1.0, seed=0)
    data, _ = ell_buffer(torch, np, dev, X, W7A_BUFFER)
    v, c, s = data.vals, data.cols, data.sq_norms
    m, K = v.shape
    g = torch.Generator(device=dev).manual_seed(2)
    gam = torch.randn(m, generator=g, device=dev)
    gam[X.shape[0]:] = float("inf")
    z2 = data.dense_rows(torch.tensor([5, X.shape[0] // 2], device=dev))
    coef2 = torch.randn(2, generator=g, device=dev)
    read, read2 = bare_read_lib()
    sink = torch.zeros(1, device=dev)
    timed = timer(time_ms, res)
    for blocks, threads in GRIDS:
        def bare(x, blocks=blocks, threads=threads):
            cuda.raise_on(read(cuda.ptr(x), x.numel(), cuda.ptr(sink), blocks,
                               threads, cuda.stream(x)), "bare_read")

        def bare2(x, y, blocks=blocks, threads=threads):
            cuda.raise_on(read2(cuda.ptr(x), cuda.ptr(y), x.numel(),
                                cuda.ptr(sink), blocks, threads,
                                cuda.stream(x)), "bare_read2")
        timed(f"bare read of vals {blocks}x{threads}", bare, (v,))
        timed(f"bare read of vals+cols {blocks}x{threads}", bare2, (v, c))
    gamma_ins, rows_ins = (v, c, s, gam, z2, coef2), (v, c, s, z2)
    want_g = ops.ell_fused_gamma_update("rbf", *gamma_ins, INV)
    want_r = ops.ell_kernel_rows2(*rows_ins, INV)
    timed("ell_gamma_update", lambda *a: ops.ell_fused_gamma_update(
        "rbf", *a, INV), gamma_ins)
    timed("ell_kernel_rows2", lambda *a: ops.ell_kernel_rows2(*a, INV),
          rows_ins)
    v16, c16 = v[:, :16].contiguous(), c[:, :16].contiguous()
    if not (torch.equal(ops.ell_fused_gamma_update(
            "rbf", v16, c16, s, gam, z2, coef2, INV), want_g)
            and torch.equal(ops.ell_kernel_rows2(v16, c16, s, z2, INV),
                            want_r)):
        print("FAIL: the kernels at K = 16 differ from K = 128",
              file=sys.stderr)
        sys.exit(1)
    timed("ell_gamma_update K=16", lambda *a: ops.ell_fused_gamma_update(
        "rbf", *a, INV), (v16, c16, s, gam, z2, coef2))
    timed("ell_kernel_rows2 K=16", lambda *a: ops.ell_kernel_rows2(*a, INV),
          (v16, c16, s, z2))
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "shape": f"ELL {m}x{K}, d {X.shape[1]}",
                      "bytes_vals": v.numel() * 4,
                      "nnz": int((v != 0).sum()), "us": res}), flush=True)


def dense_main() -> None:
    import numpy as np
    import torch
    dev, time_ms, res = setup(torch)
    from repro_torch.data import make
    from repro_torch.kernels import cuda, ops
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
    read, _ = bare_read_lib()
    sink = torch.zeros(1, device=dev)
    timed = timer(time_ms, res)

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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--ell", action="store_true",
                    help="the block-ELL row kernels at the w7a buffer")
    (ell_main if ap.parse_args().ell else dense_main)()


if __name__ == "__main__":
    main()
