// Two RBF kernel rows over dense samples, and the fused Eq. 6 gamma update
// built on them, for Hopper (sm_90a).
//
//   K(z, x)  = exp(-max(|x|^2 - 2<x, z> + |z|^2, 0) * inv_2s2)
//   rows2:        out[i, j] = K(z_j, x_i), j in {0, 1}; out is (N, 2)
//   gamma_update: out[i] = gamma[i] + c_0 * K(z_0, x_i) + c_1 * K(z_1, x_i)
//
// Replaces: src/repro/kernels/rbf_row.py::rbf_rows2 (Pallas body
// _rows2_kernel; wrapper repro.kernels.ops.kernel_rows2, which transposes
// the TPU's (2, N) output — this kernel writes (N, 2) directly) and
// src/repro/kernels/gamma_update.py::gamma_update (Pallas body
// _gamma_kernel; wrapper repro.kernels.ops.fused_gamma_update).
//
// What bounds them on this card: device memory. Per launch each streams X
// once (N*d*4 bytes: 16.1 MB at the a9a buffer N=32768, d=123, 4.8 us at
// 3.35 TB/s) plus sq (and gamma), against 4*N*d flops — about 1 flop per
// byte, far below the H100's ~20 flop/byte fp32 ridge. Across SMO
// iterations the same X is read every time, and at a9a size it fits the
// 50 MB L2. At that size a launch lasts microseconds: a bare read of X
// takes ~8.4 us back to back out of L2 on the H100 (~4.4 us in L2), and
// what the kernel adds on top is the reduction it cannot hide behind the
// stream — so the design keeps the loads flowing and the per-row work
// small.
//
// Design: one pipelined stream over X, one kernel body, two epilogues.
// Blocks of 128 threads, up to 6 per SM (the grid is sized by occupancy),
// walk the tiles of R rows of X, grid-strided. X is row-major and
// contiguous, so a tile is one span of R*d floats; R is a multiple of 4 /
// gcd(d, 4), so a tile starts 16-byte aligned whenever X does, and holds
// ~8 KB (16 rows at d = 123; 1 to 4 rows, by d's alignment, past d = 512). Each tile lands in a
// 2-stage ring in shared memory by cp.async (16 bytes a thread where the
// span is aligned, 4 bytes otherwise, e.g. for a misaligned X): the next
// tile loads while a tile is reduced. Deeper rings and larger tiles were
// slower on the H100: when every block asks for all of its rows at once,
// every tile lands late and the reductions run after the stream instead
// of beside it. A row wider than half of shared memory runs a 1-stage ring
// (copy, reduce, repeat). The prologue runs once per block, while the
// first tile loads: the queries and |z_0|^2, |z_1|^2. At d <= 128 each lane
// keeps its own query entries in registers, so a row costs one shared
// load per element; wider rows read the queries through L1. No padding of
// N or d is needed: the ragged N edge shortens the last tile, d is the
// loop bound.
//
// Reduction order, fixed and the same for both columns: G lanes per row (G
// = 8 at d <= 128, 4 rows per warp at once; G = 32, one warp per row,
// above, so no lane sums more than d / 32 terms); lane l of a row's group
// sums x[k] * z_j[k] over k = l, l + G, ... in that order, then the group
// adds its lanes by the same xor-shuffle tree for both queries (and for
// |z_j|^2). So the result is deterministic, and a row made in slot 0 is
// bitwise equal to the same row made in slot 1: single-row production
// (kernel_fns.row_via_rows2: rows2([z, z])[:, 0]) relies on this position
// symmetry. Distance, exp and the FMA into gamma stay in fp32 with
// explicitly rounded operations (no contraction differences between
// builds).
//
// The row cache's entry, rbf_rows2_cached (core/rowcache.py): the rows2
// kernel with the cache's value table, the two rows' slots and a device hit
// flag. Every block reads the flag at entry, before its first cp.async: on a
// hit it copies the two table rows into out and returns (cached_rows.cuh);
// on a miss it runs the rows2 body above, the same template instance as
// rbf_rows2, so a miss gives rbf_rows2's bits.
#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"
#include "cached_rows.cuh"
#include "occupancy.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRegZ = 128;         // widest d whose queries live in registers
constexpr int kTileFloats = 2048;  // target tile: 8 KB
constexpr int kMaxRows = 256;      // rows per tile at small d
constexpr int kBlocksPerSm = 6;    // resident blocks per SM, at most
constexpr int kMaxSmem = 231424;   // dynamic shared memory per block: sm_90's
                                   // 227 KB less 1 KB of the runtime's

// Sum over the G lanes of a row group by the same xor tree for every group
// and every query (all 32 lanes of the warp take part).
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;  // every lane of the group holds the same bits
}

__device__ __forceinline__ float rbf(float sq, float dot, float zn,
                                     float inv_2s2) {
  const float d2 = __fadd_rn(__fsub_rn(sq, __fmul_rn(2.0f, dot)), zn);
  return expf(__fmul_rn(-fmaxf(d2, 0.0f), inv_2s2));
}

// The queries as one lane of a G-lane row group reads them, and |z_0|^2,
// |z_1|^2 (n0, n1) reduced as the row dots are. G = 8 (d <= kRegZ): the
// lane's own z_j[sub + 8i] in registers; G = 32: read through L1 from z2.
// dots() is this lane's share of <x, z_0> and <x, z_1>: the fmaf chain over
// k = sub, sub + G, ... in that order, for both queries.
template <int G>
struct Queries;

template <>
struct Queries<8> {
  static constexpr int kN = kRegZ / 8;
  float z0[kN], z1[kN], n0, n1;
  __device__ __forceinline__ Queries(const float* z2, int d, int sub) {
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int k = sub + 8 * i;
      z0[i] = k < d ? z2[k] : 0.0f;
      z1[i] = k < d ? z2[d + k] : 0.0f;
      if (k < d) {
        s0 = fmaf(z0[i], z0[i], s0);
        s1 = fmaf(z1[i], z1[i], s1);
      }
    }
    n0 = group_sum<8>(s0);
    n1 = group_sum<8>(s1);
  }
  __device__ __forceinline__ float2 dots(const float* x, int d,
                                         int sub) const {
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      if (sub + 8 * i < d) {
        const float xv = x[sub + 8 * i];
        a0 = fmaf(xv, z0[i], a0);
        a1 = fmaf(xv, z1[i], a1);
      }
    }
    return make_float2(a0, a1);
  }
};

template <>
struct Queries<32> {
  const float* __restrict__ z2;
  float n0, n1;
  __device__ __forceinline__ Queries(const float* z, int d, int sub) : z2(z) {
    n0 = group_sum<32>(dots(z2, d, sub).x);
    n1 = group_sum<32>(dots(z2 + d, d, sub).y);
  }
  __device__ __forceinline__ float2 dots(const float* x, int d,
                                         int sub) const {
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll 4
    for (int k = sub; k < d; k += 32) {
      const float xv = x[k];
      a0 = fmaf(xv, z2[k], a0);
      a1 = fmaf(xv, z2[d + k], a1);
    }
    return make_float2(a0, a1);
  }
};

// Start copying floats [src, src + count) into shared memory at dst (all
// threads of the block take part; the caller commits the group).
__device__ __forceinline__ void stage(uint32_t dst, const float* src,
                                      int count) {
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    head = count & ~3;
    for (int c = threadIdx.x; c < head / 4; c += kThreads)
      sm90::cp_async16(dst + 16u * c, src + 4 * c);
  }
  for (int i = head + threadIdx.x; i < count; i += kThreads)
    sm90::cp_async4(dst + 4u * i, src + i);
}

// kGamma = false: write the (N, 2) rows; true: the Eq. 6 update into out.
// G lanes per row; tiles of `rows` rows, kStages (1 or 2) of them in the
// ring, one every `stride` floats. `cache`: the row cache's hit path (rows
// only; its flag is nullptr for the normal entries).
template <bool kGamma, int G, int kStages>
__global__ void __launch_bounds__(kThreads)
rbf_rows_kernel(const float* __restrict__ X, const float* __restrict__ sq,
                const float* __restrict__ z2, float inv_2s2,
                const float* __restrict__ gamma,
                const float* __restrict__ coef2, float* __restrict__ out,
                int n, int d, int rows, int stride,
                cached_rows::Table cache) {
  if constexpr (!kGamma) {
    if (cache.is_hit()) {  // before any copy is issued
      cache.serve(out, n);
      return;
    }
  }
  extern __shared__ float4 ring_raw[];
  float* ring = reinterpret_cast<float*>(ring_raw);
  const int n_tiles = (n + rows - 1) / rows;
  const int mine = static_cast<int>(blockIdx.x) < n_tiles
                       ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1
                       : 0;
  auto first_row = [&](int i) {  // of this block's i-th tile
    return static_cast<long>(blockIdx.x + static_cast<long>(i) * gridDim.x) *
           rows;
  };
  auto issue = [&](int i) {  // this block's i-th tile into stage i % kStages
    if (i < mine) {
      const long r0 = first_row(i);
      const long nr = n - r0 < rows ? n - r0 : rows;
      stage(sm90::smem_u32(ring + (i % kStages) * stride), X + r0 * d,
            static_cast<int>(nr * d));
    }
    sm90::cp_async_commit();
  };

  if constexpr (kStages == 2) issue(0);
  // prologue, once per block while the first tile loads: the queries and
  // their squared norms
  const int grp = threadIdx.x / G;
  const int sub = threadIdx.x % G;
  const Queries<G> z(z2, d, sub);

  for (int i = 0; i < mine; ++i) {
    if constexpr (kStages == 1) issue(i);
    sm90::cp_async_wait<0>();  // tile i has landed (this thread's copies)
    __syncthreads();           // ... and everyone's; tile i - 1 is reduced
    if constexpr (kStages == 2) issue(i + 1);
    const float* tile = ring + (i % kStages) * stride;
    const long r0 = first_row(i);
    const int nr = static_cast<int>(n - r0 < rows ? n - r0 : rows);
    for (int pass = 0; pass < nr; pass += kThreads / G) {
      // every lane runs every pass (the shuffles need the whole warp); a
      // group past the tile's last row reduces row 0 and stores nothing
      const bool live = pass + grp < nr;
      const int r = live ? pass + grp : 0;
      const long row = r0 + r;
      const float s = sq[row];  // loads in flight during the dots
      const float g = kGamma ? gamma[row] : 0.0f;
      const float2 a = z.dots(tile + static_cast<long>(r) * d, d, sub);
      const float a0 = group_sum<G>(a.x), a1 = group_sum<G>(a.y);
      if (sub == 0 && live) {
        const float k0 = rbf(s, a0, z.n0, inv_2s2);
        const float k1 = rbf(s, a1, z.n1, inv_2s2);
        if constexpr (kGamma) {
          out[row] = __fadd_rn(g, __fadd_rn(__fmul_rn(k0, coef2[0]),
                                            __fmul_rn(k1, coef2[1])));
        } else {
          out[2 * row] = k0;
          out[2 * row + 1] = k1;
        }
      }
    }
    if constexpr (kStages == 1) __syncthreads();  // before the stage refills
  }
}

template <bool kGamma, int G, int kStages>
int run(const float* X, const float* sq, const float* z2, float inv_2s2,
        const float* gamma, const float* coef2, float* out, int n, int d,
        int rows, int stride, cached_rows::Table cache, void* stream) {
  auto kernel = rbf_rows_kernel<kGamma, G, kStages>;
  static int raised_to = 48 * 1024, cached_smem = -1, cached_blocks = 0;
  const int smem = kStages * stride * static_cast<int>(sizeof(float));
  if (smem > raised_to) {  // the attribute is per function
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    raised_to = smem;
  }
  const int n_tiles = (n + rows - 1) / rows;
  const int resident =
      occupancy::resident_blocks<kThreads, kBlocksPerSm>(
          kernel, smem, &cached_smem, &cached_blocks);
  const int grid = n_tiles < resident ? n_tiles : resident;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      X, sq, z2, inv_2s2, gamma, coef2, out, n, d, rows, stride, cache);
  return static_cast<int>(cudaGetLastError());
}

template <bool kGamma>
int launch(const float* X, const float* sq, const float* z2, float inv_2s2,
           const float* gamma, const float* coef2, float* out, int n, int d,
           void* stream, cached_rows::Table cache = {}) {
  if (n <= 0) return 0;
  if (d < 0) return static_cast<int>(cudaErrorInvalidValue);
  // rows per tile: ~kTileFloats floats, a multiple of `step` so that every
  // tile starts 16-byte aligned (d % 4 == 0: any; d % 2 == 0: even; else
  // a multiple of 4)
  const int step = d % 4 == 0 ? 1 : d % 2 == 0 ? 2 : 4;
  const int fit = d > 0 ? kTileFloats / d : kMaxRows;
  int rows = (fit < kMaxRows ? fit : kMaxRows) / step * step;
  if (rows < step) rows = step;
  auto stride_of = [d](long r) {  // floats per stage, rounded to 16 bytes
    return static_cast<int>((r * d + 3) / 4 * 4);
  };
  auto bytes = [](long stages, int stride) {
    return stages * stride * static_cast<long>(sizeof(float));
  };
  if (d <= kRegZ)  // <= 8 KB tiles: a 2-stage ring always fits
    return run<kGamma, 8, 2>(X, sq, z2, inv_2s2, gamma, coef2, out, n, d,
                             rows, stride_of(rows), cache, stream);
  if (bytes(2, stride_of(rows)) <= kMaxSmem)
    return run<kGamma, 32, 2>(X, sq, z2, inv_2s2, gamma, coef2, out, n, d,
                              rows, stride_of(rows), cache, stream);
  // wide rows: one per tile (16-byte copies where aligned), 2 stages while
  // they fit, then 1
  if (bytes(2, stride_of(1)) <= kMaxSmem)
    return run<kGamma, 32, 2>(X, sq, z2, inv_2s2, gamma, coef2, out, n, d, 1,
                              stride_of(1), cache, stream);
  if (bytes(1, stride_of(1)) <= kMaxSmem)
    return run<kGamma, 32, 1>(X, sq, z2, inv_2s2, gamma, coef2, out, n, d, 1,
                              stride_of(1), cache, stream);
  return static_cast<int>(cudaErrorInvalidValue);  // d > 57,856
}

}  // namespace

// X (n, d), sq (n,), z2 (2, d) -> out (n, 2); all f32, contiguous, on the
// current device. Returns cudaGetLastError().
extern "C" int repro_rbf_rows2(const float* X, const float* sq,
                               const float* z2, float inv_2s2, float* out,
                               int n, int d, void* stream) {
  return launch<false>(X, sq, z2, inv_2s2, nullptr, nullptr, out, n, d,
                       stream);
}

// As repro_rbf_rows2, behind the row cache: table (S, ld) f32, slot2 (2,)
// i32 in [0, S), hit an i32 flag, all on the current device. Where *hit is
// nonzero, out[i, j] = table[slot2[j], i]; else rbf_rows2's rows.
extern "C" int repro_rbf_rows2_cached(const float* X, const float* sq,
                                      const float* z2, float inv_2s2,
                                      const float* table, const int* slot2,
                                      const int* hit, int ld, float* out,
                                      int n, int d, void* stream) {
  return launch<false>(X, sq, z2, inv_2s2, nullptr, nullptr, out, n, d,
                       stream, {table, slot2, hit, ld});
}

// X (n, d), sq (n,), gamma (n,), z2 (2, d), coef2 (2,) -> out (n,); all f32,
// contiguous, on the current device. Returns cudaGetLastError().
extern "C" int repro_gamma_update(const float* X, const float* sq,
                                  const float* gamma, const float* z2,
                                  const float* coef2, float inv_2s2,
                                  float* out, int n, int d, void* stream) {
  return launch<true>(X, sq, z2, inv_2s2, gamma, coef2, out, n, d, stream);
}
