// Serve-time RBF decision sum on Hopper (sm_90a), without forming the
// (B, M) kernel matrix:
//
//   out[j] = sum_i coef[i] * exp(-max(|z_j|^2 - 2<z_j, x_i> + |x_i|^2, 0)
//                                * inv_2s2)
//
// Replaces: src/repro/kernels/rbf_row.py::rbf_accumulate (Pallas body
// _accum_kernel; wrapper repro.kernels.ops.rbf_accumulate).
//
// What bounds it on this card: fp32 arithmetic. A bucket of B queries
// against M support vectors of width d costs 2*B*M*d flops of FMA (18.2
// GFLOP at B=4096, M=18048, d=123: 0.27 ms at the 67 TFLOP/s fp32 peak)
// and B*M exps, against (M + B)*d*4 bytes of input — hundreds of flops per
// byte. CUDA cores, not tensor cores: the distance is taken in full fp32,
// with no TF32 rounding.
//
// Design: the SV axis is split across the card. The grid is (SV chunk of
// kChunk = 128 rows) x (query tile), so a B = 64 bucket against ~18k SVs
// already launches 141 blocks. A block of 256 threads computes its 128 x
// 128 (64 x 128 for B <= 64) tile of dot products as a register-tiled fp32
// product, 8 x 8 (4 x 8) outputs a thread, from 16-feature slabs of the
// query tile and the SV chunk staged transposed in shared memory
// ([feature][row]: float4 reads of 4 rows). The next slab is read into
// registers while this one is used, by 16-byte loads where rows are a
// multiple of 4 floats wide and start on 16 bytes (the serving engine pads
// d to a multiple of 4 with zero columns, an exact pad), else by 4-byte
// ones, and stored after the math; features past d and rows past B or M
// read as 0 and add exactly 0 to a dot. The epilogue turns dots into
// kernel values and folds coef * K into one fp64 partial per (chunk,
// query), written to part (n_chunks, B); a second kernel (chunk_sum.cuh)
// adds the chunks' partials in chunk-index order and rounds to fp32 once.
// fp64, because a decision value is a sum of ~M signed terms that mostly
// cancel, and one fp64 FMA per (query, SV) pair is cheap beside the d fp32
// FMAs of its dot product.
//
// Order: a query's bits depend on the SV index only. Each dot runs over k
// in order (one fmaf chain per output, slab after slab); thread tx holds
// the chunk's SVs 4tx.., 64 + 4tx.., folds them in that order, and the 16
// threads sharing a query add in a fixed xor-shuffle tree; chunks add in
// index order. Neither B, the query's place in the bucket, the tile shape,
// the load width nor trailing coef-0 rows change a bit (a coef-0 row adds
// +0; a chunk past M is never launched). No atomics: scores are identical
// from run to run.
//
// Tried and measured slower (PERF.md §6), in order: one block per 32
// queries walking every SV (2x4 outputs a thread, load then sync per
// 32-feature slab; 3.67 ms at B = 4096, ~2.5 ms at B = 64); the split
// grid with slabs staged transposed by 4-byte cp.async; row-major slabs by
// 16-byte cp.async with an 8-query x 4-feature register tile (spilling at
// the 128-register cap).
#include <cstdint>

#include <cuda_runtime.h>

#include "chunk_sum.cuh"

namespace {

constexpr int kChunk = 128;       // SV rows a chunk: fixes a query's order
constexpr int kDK = 16;           // features a slab
constexpr int kThreads = 256;     // (16 query quads) x (16 SV quads)
constexpr int kXLd = kChunk + 4;  // stride of a staged SV feature (floats)

// Thread (ty, tx) holds queries 4ty.. (and 64 + 4ty.. when kQI = 8) and SVs
// 4tx.., 64 + 4tx.. of the block's tile: kQI x 8 outputs. kTQ = 16 kQI
// queries a block. kVec: rows are read in 16-byte loads (d % 4 == 0, rows
// 16-byte aligned), else in 4-byte ones.
template <int kQI, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
rbf_accumulate_chunks(const float* __restrict__ X,
                      const float* __restrict__ sq,
                      const float* __restrict__ coef,
                      const float* __restrict__ Z, float inv_2s2,
                      double* __restrict__ part, int m, int b, int d) {
  constexpr int kTQ = 16 * kQI;
  constexpr int kZLd = kTQ + 4;
  constexpr int kZLoads = kTQ * 4 / kThreads;     // 16-byte groups a thread
  constexpr int kXLoads = kChunk * 4 / kThreads;
  __shared__ __align__(16) float zs[2][kDK][kZLd];
  __shared__ __align__(16) float xs[2][kDK][kXLd];
  __shared__ float qn[kTQ];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int s0 = blockIdx.x * kChunk;
  const int q0 = blockIdx.y * kTQ;
  const int nslab = d > 0 ? (d + kDK - 1) / kDK : 1;

  // Group e = tid + kThreads*i of a slab: row e / 4, features 4 (e % 4)..
  // of the slab; read into registers, stored transposed ([k][row]) after
  // the current slab's math.
  float4 zr[kZLoads], xr[kXLoads];
  auto fetch = [&](float4& v, const float* src, int row, int lim, int k) {
    v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row >= lim) return;
    const float* p = src + static_cast<long>(row) * d + k;
    if constexpr (kVec) {
      if (k < d) v = __ldg(reinterpret_cast<const float4*>(p));
    } else {
      if (k < d) v.x = __ldg(p);
      if (k + 1 < d) v.y = __ldg(p + 1);
      if (k + 2 < d) v.z = __ldg(p + 2);
      if (k + 3 < d) v.w = __ldg(p + 3);
    }
  };
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kZLoads; ++i) {
      const int e = tid + kThreads * i;
      fetch(zr[i], Z, q0 + (e >> 2), b, k0 + 4 * (e & 3));
    }
#pragma unroll
    for (int i = 0; i < kXLoads; ++i) {
      const int e = tid + kThreads * i;
      fetch(xr[i], X, s0 + (e >> 2), m, k0 + 4 * (e & 3));
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kZLoads; ++i) {
      const int e = tid + kThreads * i, r = e >> 2, c = 4 * (e & 3);
      zs[buf][c][r] = zr[i].x;
      zs[buf][c + 1][r] = zr[i].y;
      zs[buf][c + 2][r] = zr[i].z;
      zs[buf][c + 3][r] = zr[i].w;
    }
#pragma unroll
    for (int i = 0; i < kXLoads; ++i) {
      const int e = tid + kThreads * i, r = e >> 2, c = 4 * (e & 3);
      xs[buf][c][r] = xr[i].x;
      xs[buf][c + 1][r] = xr[i].y;
      xs[buf][c + 2][r] = xr[i].z;
      xs[buf][c + 3][r] = xr[i].w;
    }
  };

  float acc[kQI][8];
#pragma unroll
  for (int i = 0; i < kQI; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  float qa = 0.0f;  // |z_tid|^2, k in order (threads tid < kTQ)

  load(0);
  store(0);
  __syncthreads();
  for (int t = 0; t < nslab; ++t) {
    const int buf = t & 1;
    if (t + 1 < nslab) load((t + 1) * kDK);  // in flight during the math
    if (tid < kTQ) {
#pragma unroll
      for (int c = 0; c < kDK; ++c)
        qa = fmaf(zs[buf][c][tid], zs[buf][c][tid], qa);
    }
#pragma unroll
    for (int c = 0; c < kDK; ++c) {
      float a[kQI], v[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&zs[buf][c][4 * ty]);
      a[0] = a0.x, a[1] = a0.y, a[2] = a0.z, a[3] = a0.w;
      if constexpr (kQI == 8) {
        const float4 a1 =
            *reinterpret_cast<const float4*>(&zs[buf][c][64 + 4 * ty]);
        a[4] = a1.x, a[5] = a1.y, a[6] = a1.z, a[7] = a1.w;
      }
      const float4 b0 = *reinterpret_cast<const float4*>(&xs[buf][c][4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&xs[buf][c][64 + 4 * tx]);
      v[0] = b0.x, v[1] = b0.y, v[2] = b0.z, v[3] = b0.w;
      v[4] = b1.x, v[5] = b1.y, v[6] = b1.z, v[7] = b1.w;
#pragma unroll
      for (int i = 0; i < kQI; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
    }
    if (t + 1 < nslab) store(buf ^ 1);  // buf ^ 1 was last read at t - 1
    __syncthreads();
  }
  if (tid < kTQ) qn[tid] = qa;
  __syncthreads();

  float sqv[8];
  double cv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int s = s0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
    sqv[j] = s < m ? sq[s] : 0.0f;
    cv[j] = s < m ? static_cast<double>(coef[s]) : 0.0;
  }
  double* dst = part + static_cast<long>(blockIdx.x) * b;
#pragma unroll
  for (int i = 0; i < kQI; ++i) {
    const int r = i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4;
    const float qv = qn[r];
    double p = 0.0;
    // no branch for SVs past m: their coef reads as 0 and their kernel
    // value is finite, and fma(0, k, p) == p for every p this sum reaches
    // (it starts at +0 and never becomes -0)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d2 =
          __fadd_rn(__fsub_rn(qv, __fmul_rn(2.0f, acc[i][j])), sqv[j]);
      const float kv = expf(__fmul_rn(-fmaxf(d2, 0.0f), inv_2s2));
      p = fma(cv[j], static_cast<double>(kv), p);
    }
    // the 16 lanes of a half-warp share ty: fixed xor tree over tx
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      p = __dadd_rn(p, __shfl_xor_sync(0xffffffffu, p, off));
    if (tx == 0 && q0 + r < b) dst[q0 + r] = p;
  }
}

template <int kQI, bool kVec>
cudaError_t launch_chunks(const float* X, const float* sq, const float* coef,
                          const float* Z, float inv_2s2, double* part, int m,
                          int b, int d, int n_chunks, cudaStream_t s) {
  const dim3 grid(n_chunks, (b + 16 * kQI - 1) / (16 * kQI));
  rbf_accumulate_chunks<kQI, kVec><<<grid, kThreads, 0, s>>>(
      X, sq, coef, Z, inv_2s2, part, m, b, d);
  return cudaGetLastError();
}

}  // namespace

// SV rows a chunk: part holds ceil(m / this) rows of partials.
extern "C" int repro_rbf_accumulate_chunk_rows() { return kChunk; }

// X (m, d) SVs, sq (m,), coef (m,), Z (b, d) queries -> out (b,); all f32,
// contiguous, on the current device; part (ceil(m / kChunk), b) fp64
// scratch. Returns the first cudaGetLastError() of the two launches.
extern "C" int repro_rbf_accumulate(const float* X, const float* sq,
                                    const float* coef, const float* Z,
                                    float inv_2s2, float* out, double* part,
                                    int m, int b, int d, void* stream) {
  if (b <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (m + kChunk - 1) / kChunk;
  if (n_chunks > 0) {
    const bool vec = d % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(X) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(Z) % 16 == 0;
    cudaError_t e;
    if (b <= 64)
      e = vec ? launch_chunks<4, true>(X, sq, coef, Z, inv_2s2, part, m, b, d,
                                       n_chunks, s)
              : launch_chunks<4, false>(X, sq, coef, Z, inv_2s2, part, m, b,
                                        d, n_chunks, s);
    else
      e = vec ? launch_chunks<8, true>(X, sq, coef, Z, inv_2s2, part, m, b, d,
                                       n_chunks, s)
              : launch_chunks<8, false>(X, sq, coef, Z, inv_2s2, part, m, b,
                                        d, n_chunks, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(chunk_sum::launch(part, out, n_chunks, b, s));
}
