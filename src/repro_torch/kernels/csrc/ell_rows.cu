// RBF kernel rows over block-ELL samples, and the fused Eq. 6 gamma update
// built on them, for Hopper (sm_90a): one template body, three epilogues.
//
//   K(z, x)  = exp(-max(|x|^2 - 2<x, z> + |z|^2, 0) * inv_2s2)
//   <x_i, z> = sum_k vals[i, k] * z[cols[i, k]]   (padding slot: val 0, col 0)
//   row:          out[i] = K(z, x_i)                                    (N,)
//   rows2:        out[i, j] = K(z_j, x_i), j in {0, 1}                  (N, 2)
//   gamma_update: out[i] = gamma[i] + c_0 * K(z_0, x_i) + c_1 * K(z_1, x_i)
//
// Replaces: src/repro/kernels/sparse_ell.py::ell_kernel_row (Pallas body
// _ell_kernel), ::ell_kernel_rows2 (_ell_rows2_kernel; the TPU wrote (2, N),
// this kernel writes (N, 2) directly) and ::ell_gamma_update
// (_ell_gamma_kernel; all three on the shared body _ell_rows2_body).
//
// What bounds them on this card: device memory. A pass must read every val
// (N*K*4 bytes: a zero is only known once read) and the cols of the nonzero
// slots, plus sq (and gamma in and out): 18.4 MB at the w7a buffer (N =
// 32768, K = 128, 12 nonzeros per row), a 5.5 us bound at 3.35 TB/s,
// against 4 flops per nonzero and query: far below the H100's fp32 ridge.
// At that size a launch lasts microseconds, and what it loses beyond the
// bytes is every round trip to memory that a warp waits for with nothing
// else in flight. The first port's body (one warp per row, each slot a
// chain of dependent global loads: vals, then cols, then the z gather) kept
// about one 128-byte load in flight per warp.
//
// Design: a stream of 16-byte loads from registers, as many in flight as
// the register file allows. Blocks of 128 threads, up to 8 per SM (the
// grid is sized by occupancy), reduce passes of 128 / W rows, grid-
// strided: W lanes a row (W = 8, or the fewest that cover the row's 16-byte
// chunks when K < 32). A lane issues the loads of its first 4 chunks of
// vals (all of a row at K = 128) together, with the row's sq (and gamma);
// then, for each chunk that is not all zero, the 16-byte load of its cols
// (a w7a row reads 3 of its 32 chunks of cols); then gathers z from shared
// memory and adds. The first pass's vals are requested before the
// prologue (the queries into shared memory by plain loads, and |z_j|^2),
// so they stream while it runs. Queries wider than 32 KB are gathered from
// global memory through the read-only path (__ldg). Rows of more than 4
// chunks a lane (K > 128) take further rounds of 4 in the same order. No
// padding of N, K or d is needed: K and d are loop bounds, a group past the
// last row reduces a real row and stores nothing; at K % 4 != 0 or a
// misaligned vals or cols the loads are 4 bytes wide.
// Measured against the alternatives (scripts/row_stream_floor.py --ell,
// PERF.md): cp.async rings in shared memory, shared by a block, private to
// a warp or to a thread, 2 to 6 stages deep, and a ring of 8 KB tiles
// filled by bulk copies (TMA), with the cols of nonzero chunks copied
// beside the vals or loaded by the lanes a tile behind, were all slower,
// most of all in L2; so were parking a pass's vals in shared memory to
// load the next pass during the cols' round trip, and prefetching the
// next pass's vals or the first cols into L2. On this card, whatever asks
// for more bytes at once than this many warps hold in registers lands
// every tile late. Reading every col costs more bytes than the wait for
// the nonzero chunks' cols saves. 8 lanes a row at every K would be
// slower at small K (K = 16: two passes a block instead of one), hence W
// from the row's chunks; the bits are the same either way. Measured on an
// NVIDIA H100 80GB HBM3 at a 700 W power limit, at the w7a buffer, inputs
// out of L2 (in L2): ell_gamma_update 11.90 us (7.30), ell_kernel_rows2
// 11.82 us (7.19), 0.46 of the bound; the first port's body 13.65 (10.46)
// and 13.16 (10.11); a bare float4 read of the same vals 8.18-8.47 us
// (4.29-4.62). What is left above the bare read: the cols of the nonzero
// chunks (~2 MB more in 32-byte sectors) and their round trip, two passes
// a block deep.
//
// Reduction order, fixed and independent of K and of the load width: the
// slots of a row fall in 16-byte chunks (chunk q: slots 4q .. 4q + 3);
// lane l of the row's 8 lanes owns the chunks q = l, l + 8, l + 16, ...
// and sums vals[i, k] * z_j[cols[i, k]] over their slots in slot order,
// one fmaf each, skipping zero slots (a zero slot adds exactly 0); then
// the 8 lanes add by the xor-shuffle tree (offsets 4, 2, 1). A row of
// fewer chunks runs the tree's last log2(W) levels on its W lanes: the
// same bits, since the lanes it drops would hold +0. |z_j|^2: one warp per
// query, lane l sums k = l, l + 32, ... then the 32-lane xor tree. So for
// rows whose nonzeros are a slot prefix the result does not depend on the
// buffer's K (the adaptive lane budget changes K at compactions); both
// queries run the identical instruction sequence (a row made in slot 0 is
// bitwise equal to the same row made in slot 1, and to the one-query
// entry: kernel_fns.row_via_rows2 relies on it); and a misaligned vals
// gives the same bits. Distance, exp and the update stay in fp32 with
// explicitly rounded operations. Padding rows carry gamma = +inf, and +inf
// plus a finite update stays +inf.
//
// The row cache's entry, ell_kernel_rows2_cached (core/rowcache.py): the
// rows2 kernel with the cache's value table, the two rows' slots and a
// device hit flag. Every block reads the flag at entry, before its first
// load of vals: on a hit it copies the two table rows into out and returns
// (cached_rows.cuh); on a miss it runs the rows2 body above, the same
// template instance as ell_kernel_rows2, so a miss gives its bits.
#include <cuda_runtime.h>

#include <cstdint>

#include "cached_rows.cuh"
#include "occupancy.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 8;                 // lanes per row, at most
constexpr int kBatch = 4;                 // chunks a lane loads at once
constexpr int kBlocksPerSm = 8;           // resident blocks per SM, at most
constexpr long kSharedQueryBytes = 32 * 1024;

enum Mode { kRow = 0, kRows2 = 1, kGamma = 2 };

// Sum over the 2^lw lanes of a row group by the last lw levels of the same
// xor tree for every group and every query (all 32 lanes take part).
__device__ __forceinline__ float group_sum(float v, int lw) {
  for (int off = (1 << lw) >> 1; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;  // every lane of the group holds the same bits
}

__device__ __forceinline__ float rbf(float sq, float dot, float zn,
                                     float inv_2s2) {
  const float d2 = __fadd_rn(__fsub_rn(sq, __fmul_rn(2.0f, dot)), zn);
  return expf(__fmul_rn(-fmaxf(d2, 0.0f), inv_2s2));
}

__device__ __forceinline__ bool any_nonzero(float4 x) {
  return x.x != 0.0f || x.y != 0.0f || x.z != 0.0f || x.w != 0.0f;
}

// Chunk q (slots 4q .. 4q + 3) of the row at p, slots past K read as 0:
// one 16-byte load where `vec` (K % 4 == 0 and the array 16-byte
// aligned), else one load per slot.
template <typename T, typename T4>
__device__ __forceinline__ T4 chunk(const T* p, int q, int K, bool vec) {
  const int k = 4 * q;
  if (vec) {
    if (k < K) return __ldg(reinterpret_cast<const T4*>(p + k));
    return T4{0, 0, 0, 0};
  }
  return T4{k < K ? __ldg(p + k) : T(0), k + 1 < K ? __ldg(p + k + 1) : T(0),
            k + 2 < K ? __ldg(p + k + 2) : T(0),
            k + 3 < K ? __ldg(p + k + 3) : T(0)};
}

// The lane's chunks q0, q0 + W, ... (kBatch of them) of the row at v.
__device__ __forceinline__ void load_vals(float4 (&x)[kBatch], const float* v,
                                          int q0, int W, int K, bool vec) {
#pragma unroll
  for (int b = 0; b < kBatch; ++b)
    x[b] = chunk<float, float4>(v, q0 + b * W, K, vec);
}

// The lane's share of <x, z_0> (and <x, z_1>) for one row: its chunks in
// order and the slots of each in order, one fmaf each; a zero slot adds
// nothing and its column is not read. z: shared memory, or global
// (kSharedZ false).
template <int Q, bool kSharedZ>
struct Dots {
  const float* zq;
  int d;
  float a0 = 0.0f, a1 = 0.0f;
  __device__ __forceinline__ float z_at(int i) const {
    return kSharedZ ? zq[i] : __ldg(zq + i);
  }
  __device__ __forceinline__ void add(float xv, int ci) {
    if (xv != 0.0f) {
      a0 = fmaf(xv, z_at(ci), a0);
      if constexpr (Q == 2) a1 = fmaf(xv, z_at(d + ci), a1);
    }
  }
  // the chunks q0, q0 + W, ... whose vals are x: the cols of each that is
  // not all zero, then its gathers
  __device__ __forceinline__ void batch(const float4 (&x)[kBatch],
                                        const int* c, int q0, int W, int K,
                                        bool vec) {
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (any_nonzero(x[b])) {
        const int4 ci = chunk<int, int4>(c, q0 + b * W, K, vec);
        add(x[b].x, ci.x);
        add(x[b].y, ci.y);
        add(x[b].z, ci.z);
        add(x[b].w, ci.w);
      }
    }
  }
};

// The queries into shared memory (plain loads: after the first block of an
// SM, L1 serves them) and |z_j|^2, one warp per query, the same code for
// both; the caller synchronises.
template <int Q, bool kSharedZ>
__device__ __forceinline__ void load_queries(float* zs, float* zn,
                                             const float* z, int d) {
  if constexpr (kSharedZ)
    for (int k = threadIdx.x; k < Q * d; k += kThreads) zs[k] = __ldg(z + k);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < Q) {
    float a = 0.0f;
    for (int k = lane; k < d; k += 32) {
      const float v = __ldg(z + warp * d + k);
      a = fmaf(v, v, a);
    }
    a = group_sum(a, 5);
    if (lane == 0) zn[warp] = a;
  }
}

// The epilogue of a live row, from the group's dots.
template <int kMode>
__device__ __forceinline__ void write_row(long row, float s, float g,
                                          float a0, float a1,
                                          const float* zn, float inv_2s2,
                                          const float* coef2, float* out) {
  const float k0 = rbf(s, a0, zn[0], inv_2s2);
  if constexpr (kMode == kRow) {
    out[row] = k0;
  } else {
    const float k1 = rbf(s, a1, zn[1], inv_2s2);
    if constexpr (kMode == kGamma) {
      out[row] = __fadd_rn(g, __fadd_rn(__fmul_rn(k0, __ldg(coef2)),
                                        __fmul_rn(k1, __ldg(coef2 + 1))));
    } else {
      reinterpret_cast<float2*>(out)[row] = make_float2(k0, k1);
    }
  }
}

// Groups of W = 2^lw lanes, one row each, 128 / W rows a pass of the
// block; the block's passes are grid-strided. kSharedZ: the queries in
// shared memory. vec_v / vec_c: 16-byte loads of vals / cols. `cache`: the
// row cache's hit path (rows2 only; its flag is nullptr for the normal
// entries).
template <int kMode, bool kSharedZ>
__global__ void __launch_bounds__(kThreads)
ell_rows_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                const float* __restrict__ sq, const float* __restrict__ z,
                float inv_2s2, const float* __restrict__ gamma,
                const float* __restrict__ coef2, float* __restrict__ out,
                int n, int K, int d, int lw, bool vec_v, bool vec_c,
                cached_rows::Table cache) {
  if constexpr (kMode == kRows2) {
    if (cache.is_hit()) {  // before any load of vals
      cache.serve(out, n);
      return;
    }
  }
  constexpr int Q = kMode == kRow ? 1 : 2;
  constexpr bool kG = kMode == kGamma;
  extern __shared__ float zs[];  // z_0 at [0, d), z_1 at [d, 2d)
  __shared__ float zn[2];
  const int W = 1 << lw, per_pass = kThreads >> lw;
  const int grp = threadIdx.x >> lw, sub = threadIdx.x & (W - 1);
  const int nq = (K + 3) >> 2;
  const long stride = static_cast<long>(gridDim.x) * per_pass;

  // the group's row in the pass at `base` (< n): a group past the last row
  // reduces row `base` and stores nothing (every lane runs every pass: the
  // shuffles need the whole warp)
  auto row_of = [&](long base) { return base + grp < n ? base + grp : base; };
  long base = static_cast<long>(blockIdx.x) * per_pass;
  float4 x[kBatch];
  if (base < n) load_vals(x, vals + row_of(base) * K, sub, W, K, vec_v);
  load_queries<Q, kSharedZ>(zs, zn, z, d);  // while the first pass loads
  __syncthreads();

  for (bool first = true; base < n; base += stride, first = false) {
    const long row = row_of(base);
    const float s = sq[row];  // loads in flight during the dots
    const float g = kG ? gamma[row] : 0.0f;
    const float* v = vals + row * K;
    const int* c = cols + row * K;
    if (!first) load_vals(x, v, sub, W, K, vec_v);
    Dots<Q, kSharedZ> acc{kSharedZ ? zs : z, d};
    acc.batch(x, c, sub, W, K, vec_c);
    // rows of more than kBatch chunks a lane (K > 4 * kBatch * W)
    for (int q0 = sub + kBatch * W; q0 < nq; q0 += kBatch * W) {
      load_vals(x, v, q0, W, K, vec_v);
      acc.batch(x, c, q0, W, K, vec_c);
    }
    const float a0 = group_sum(acc.a0, lw);
    const float a1 = Q == 2 ? group_sum(acc.a1, lw) : 0.0f;
    if (sub == 0 && base + grp < n)
      write_row<kMode>(row, s, g, a0, a1, zn, inv_2s2, coef2, out);
  }
}

template <int kMode, bool kSharedZ>
int run(const float* vals, const int* cols, const float* sq, const float* z,
        float inv_2s2, const float* gamma, const float* coef2, float* out,
        int n, int K, int d, int lw, bool vec_v, bool vec_c, int smem,
        cached_rows::Table cache, void* stream) {
  auto kernel = ell_rows_kernel<kMode, kSharedZ>;
  static int cached_smem = -1, cached_blocks = 0;
  const int resident = occupancy::resident_blocks<kThreads, kBlocksPerSm>(
      kernel, smem, &cached_smem, &cached_blocks);
  const long passes = (static_cast<long>(n) + (kThreads >> lw) - 1) /
                      (kThreads >> lw);
  const int grid = passes < resident ? static_cast<int>(passes) : resident;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      vals, cols, sq, z, inv_2s2, gamma, coef2, out, n, K, d, lw, vec_v,
      vec_c, cache);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode>
int launch(const float* vals, const int* cols, const float* sq,
           const float* z, float inv_2s2, const float* gamma,
           const float* coef2, float* out, int n, int K, int d,
           void* stream, cached_rows::Table cache = {}) {
  if (n <= 0) return 0;
  if (K < 0 || d < 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int Q = kMode == kRow ? 1 : 2;
  // lanes a row: the fewest (a power of two) that cover its chunks, at
  // most kLanes
  int lw = 0;
  while ((1 << lw) < kLanes && (1 << lw) < (K + 3) / 4) ++lw;
  const bool vec_v =
      K % 4 == 0 && (reinterpret_cast<uintptr_t>(vals) & 15) == 0;
  const bool vec_c =
      K % 4 == 0 && (reinterpret_cast<uintptr_t>(cols) & 15) == 0;
  const long zbytes = static_cast<long>(Q) * d * sizeof(float);
  if (zbytes <= kSharedQueryBytes)
    return run<kMode, true>(vals, cols, sq, z, inv_2s2, gamma, coef2, out, n,
                            K, d, lw, vec_v, vec_c,
                            static_cast<int>(zbytes), cache, stream);
  return run<kMode, false>(vals, cols, sq, z, inv_2s2, gamma, coef2, out, n,
                           K, d, lw, vec_v, vec_c, 0, cache, stream);
}

}  // namespace

// vals (n, K) f32, cols (n, K) i32 in [0, d), sq (n,), z (d,) -> out (n,);
// contiguous, on the current device. Returns cudaGetLastError().
extern "C" int repro_ell_kernel_row(const float* vals, const int* cols,
                                    const float* sq, const float* z,
                                    float inv_2s2, float* out, int n, int K,
                                    int d, void* stream) {
  return launch<kRow>(vals, cols, sq, z, inv_2s2, nullptr, nullptr, out, n,
                      K, d, stream);
}

// vals, cols, sq as above, z2 (2, d) -> out (n, 2).
extern "C" int repro_ell_kernel_rows2(const float* vals, const int* cols,
                                      const float* sq, const float* z2,
                                      float inv_2s2, float* out, int n, int K,
                                      int d, void* stream) {
  return launch<kRows2>(vals, cols, sq, z2, inv_2s2, nullptr, nullptr, out,
                        n, K, d, stream);
}

// As repro_ell_kernel_rows2, behind the row cache: table (S, ld) f32, slot2
// (2,) i32 in [0, S), hit an i32 flag, all on the current device. Where
// *hit is nonzero, out[i, j] = table[slot2[j], i]; else ell_kernel_rows2's
// rows.
extern "C" int repro_ell_kernel_rows2_cached(
    const float* vals, const int* cols, const float* sq, const float* z2,
    float inv_2s2, const float* table, const int* slot2, const int* hit,
    int ld, float* out, int n, int K, int d, void* stream) {
  return launch<kRows2>(vals, cols, sq, z2, inv_2s2, nullptr, nullptr, out,
                        n, K, d, stream, {table, slot2, hit, ld});
}

// vals, cols, sq as above, gamma (n,), z2 (2, d), coef2 (2,) -> out (n,).
extern "C" int repro_ell_gamma_update(const float* vals, const int* cols,
                                      const float* sq, const float* gamma,
                                      const float* z2, const float* coef2,
                                      float inv_2s2, float* out, int n, int K,
                                      int d, void* stream) {
  return launch<kGamma>(vals, cols, sq, z2, inv_2s2, gamma, coef2, out, n,
                        K, d, stream);
}
