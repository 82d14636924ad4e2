// Serve-time RBF decision sum over block-ELL support vectors on Hopper
// (sm_90a), without forming the (B, M) kernel matrix:
//
//   out[j] = sum_i coef[i] * exp(-max(|z_j|^2 - 2<z_j, x_i> + |x_i|^2, 0)
//                                * inv_2s2)
//   <z_j, x_i> = sum_k vals[i, k] * z_j[cols[i, k]]   (padding: val 0, col 0)
//
// Replaces: src/repro/kernels/rbf_row.py::ell_rbf_accumulate (Pallas body
// _ell_accum_kernel; wrapper repro.kernels.ops.ell_rbf_accumulate).
//
// What bounds it on this card: not the arithmetic (2 flops per nonzero and
// query, ~10 per SV and query: 16.5 us at the w7a model and B = 4,096) but
// the traffic and the latency around it. Every nonzero is gathered once per
// query, z[col] at a data-dependent column: from shared memory 4 bytes a
// query, ~1.6 GB per bucket at those shapes, ~50 us at 128 bytes a clock
// per SM. Each SV and query also costs an exp and an fp64 FMA. The SV rows
// (vals of every slot, cols of the nonzero ones) and the queries move from
// L2 into each block that uses them.
//
// Design: the SV axis is split across the card. SV rows form chunks of
// kChunk = 128; a block takes a tile of 128 queries (64 for B <= 64) and a
// run of G consecutive chunks (G chosen from the grid so that the card
// fills and the query tile is staged as few times as that allows). The
// query tile is staged once in shared memory by plain loads, transposed
// ([col][query]), so a lane's 4 (or 2) queries sit in one 16-byte (8-byte)
// word and a warp's z[col] is one conflict-free vector read; a d whose tile
// does not fit reads the queries from global memory instead (any d works).
// Row r of a chunk belongs to warp r % 16 of the block's 16. For each chunk
// a warp loads its 8 rows' vals (128-slot segments, 4 loads of 32 slots
// each, all in flight), finds the nonzero slots by ballot, ranks them by
// popc prefix and compacts (val, col) pairs in slot order into its list in
// shared memory, with the cols of the nonzero slots only, all in flight at
// once (cp.async). Then it walks the list: (val, col) is a warp-wide
// broadcast, z[col] one vector read, one fmaf a query; at each row's end
// it folds coef * K into its fp64 partials. A warp whose nonzeros overflow
// its list reloads and refills it in windows, and a row longer than a
// round of loads carries its dot over. The 16 warps' partials add in warp
// order into one fp64 partial per (chunk, query), written to part
// (n_chunks, B); a second kernel (chunk_sum.cuh) adds the chunks in index
// order and rounds to fp32 once. 16 warps of 128 registers, one block an
// SM (the query tile takes 155 KB at d = 300): the latency of one warp's
// chain of list read, z read and fmaf hides behind the others.
//
// Order: a query's bits depend on the SV rows only. Each dot is one fmaf
// chain over the row's nonzero slots in slot order (padding and explicitly
// stored zeros are skipped: they would add exactly 0), so neither K nor the
// slot padding change a bit; rows fold in index order within their warp,
// warps and chunks add in index order. Neither B, the query's place in
// the bucket, the tile, G nor trailing coef-0 rows change a bit. No
// atomics: scores are identical from run to run.
//
// Tried and measured slower (PERF.md §6), in order: one block per 32
// queries walking every SV row (16 warps, nonzeros broadcast one shuffle
// pair at a time; 1.39 ms at B = 4096, ~0.94 ms at B = 64); two warps a
// row group sharing a rank scan, 2 queries a lane, the query tile staged by
// 4-byte cp.async; one warp a group of 16 rows, 4 queries a lane, with 64
// loads a lane of runtime (row, piece) items (spilling at 255
// registers), then of static segments. The spills land in L2: the
// query tile leaves little L1.
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "chunk_sum.cuh"
#include "occupancy.cuh"

namespace {

constexpr int kChunk = 128;                  // SV rows a chunk
constexpr int kWarps = 16;                   // row r of a chunk: warp r % 16
constexpr int kWarpRows = kChunk / kWarps;   // 8
constexpr int kThreads = kWarps * 32;
constexpr int kSegs = 8;    // 128-slot row segments a warp loads at once
constexpr int kCap = 256;   // (val, col) pairs a warp's list holds
constexpr int kMaxSmem = 227 * 1024;

// Dynamic shared memory of a block: partials, lists, norms, then the query
// tile when it is staged. kQL queries a lane.
template <int kQL>
struct Smem {
  static constexpr int kTQ = 32 * kQL;
  static constexpr int kLd = kTQ + 4;  // stride of a staged query column
  static constexpr int kFixed =
      2 * kWarps * kTQ * 8 + kWarps * kCap * 8 + kTQ * 4 + 16;
  static int bytes(int d, bool shared) {
    return kFixed + (shared ? d * kLd * 4 : 0);
  }
};

template <int kQL>
struct Vec;
template <>
struct Vec<2> {
  static __device__ __forceinline__ void get(const float* p, float* z) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    z[0] = v.x;
    z[1] = v.y;
  }
};
template <>
struct Vec<4> {
  static __device__ __forceinline__ void get(const float* p, float* z) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    z[0] = v.x;
    z[1] = v.y;
    z[2] = v.z;
    z[3] = v.w;
  }
};

// kQL queries a lane (queries kQL*lane.. of the tile); the tile staged in
// shared memory (kShared) or read from global memory.
template <int kQL, bool kShared>
__global__ void __launch_bounds__(kThreads, 1)
ell_accumulate_chunks(const float* __restrict__ vals,
                      const int* __restrict__ cols,
                      const float* __restrict__ sq,
                      const float* __restrict__ coef,
                      const float* __restrict__ Z, float inv_2s2,
                      double* __restrict__ part, int m, int K, int b, int d,
                      int n_chunks, int per_block) {
  using S = Smem<kQL>;
  constexpr int kTQ = S::kTQ;
  extern __shared__ __align__(16) unsigned char smem[];
  double* red = reinterpret_cast<double*>(smem);  // [parity][warp][kTQ]
  float2* lists = reinterpret_cast<float2*>(red + 2 * kWarps * kTQ);
  float* qn = reinterpret_cast<float*>(lists + kWarps * kCap);
  int* sync = reinterpret_cast<int*>(qn + kTQ);  // arrived[2], reduced[2]
  float* zs = reinterpret_cast<float*>(sync + 4);               // [d][kLd]

  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.y * kTQ;
  const int nq = min(kTQ, b - q0);
  const int zq = kQL * lane;  // this lane's first query in the tile

  if (tid < 4) sync[tid] = 0;
  if constexpr (kShared) {
    // warp w stages query rows w + 16 i, 32 columns a step, the loads of
    // all its rows and of 4 steps in flight together
    constexpr int kRowsW = kTQ / kWarps;
#pragma unroll 4
    for (int c = lane; c < d; c += 32) {
      float v[kRowsW];
#pragma unroll
      for (int i = 0; i < kRowsW; ++i) {
        const int r = w + kWarps * i;
        v[i] = r < nq ? __ldg(Z + static_cast<long>(q0 + r) * d + c) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kRowsW; ++i) zs[c * S::kLd + w + kWarps * i] = v[i];
    }
    __syncthreads();
  }
  if (tid < kTQ) {  // |z|^2 of the tile, k in order
    float a = 0.0f;
    if (tid < nq) {
#pragma unroll 8
      for (int k = 0; k < d; ++k) {
        const float v =
            kShared ? zs[k * S::kLd + tid]
                    : __ldg(Z + static_cast<long>(q0 + tid) * d + k);
        a = fmaf(v, v, a);
      }
    }
    qn[tid] = a;
  }
  __syncthreads();
  float qv[kQL];
  const float* zg[kQL];  // global gathers: rows past the bucket read row q0
#pragma unroll
  for (int u = 0; u < kQL; ++u) {
    qv[u] = qn[zq + u];
    zg[u] = Z + static_cast<long>(q0 + (zq + u < nq ? zq + u : 0)) * d;
  }

  // One nonzero of a row: dots += val * z[col] for the lane's queries.
  auto step = [&](float2 e, float (&dots)[kQL]) {
    const int c = __float_as_int(e.y);
    float z[kQL];
    if constexpr (kShared) {
      Vec<kQL>::get(zs + c * S::kLd + zq, z);
    } else {
#pragma unroll
      for (int u = 0; u < kQL; ++u) z[u] = __ldg(zg[u] + c);
    }
#pragma unroll
    for (int u = 0; u < kQL; ++u) dots[u] = fmaf(e.x, z[u], dots[u]);
  };
  // A row's end: sums += coef * K(z, x) for the lane's queries, in fp64.
  auto fold = [&](float s, float coef_r, const float (&dots)[kQL],
                  double (&sums)[kQL]) {
    const double cf = static_cast<double>(coef_r);
#pragma unroll
    for (int u = 0; u < kQL; ++u) {
      const float e = __fadd_rn(__fsub_rn(qv[u], __fmul_rn(2.0f, dots[u])), s);
      const float kv = expf(__fmul_rn(-fmaxf(e, 0.0f), inv_2s2));
      sums[u] = fma(cf, static_cast<double>(kv), sums[u]);
    }
  };

  float2* list = lists + w * kCap;
  const int segs = K > 128 ? (K + 127) / 128 : 1;  // 128-slot segments a row
  const unsigned below = (1u << lane) - 1u;
  const int c_end = min(n_chunks, (blockIdx.x + 1) * per_block);

  for (int ch = blockIdx.x * per_block; ch < c_end; ++ch) {
    const int r0 = ch * kChunk + w;  // this warp's rows: r0 + 16i
    const int nr = m > r0 ? min(kWarpRows, (m - r0 + kWarps - 1) / kWarps)
                          : 0;
    float my_sq = 0.0f, my_coef = 0.0f;  // lane i: the warp's row i
    if (lane < nr) {
      my_sq = __ldg(sq + r0 + kWarps * lane);
      my_coef = __ldg(coef + r0 + kWarps * lane);
    }
    double p[kQL];    // this warp's partials of the lane's queries
    float dot[kQL];   // dots of the open row
#pragma unroll
    for (int u = 0; u < kQL; ++u) {
      p[u] = 0.0;
      dot[u] = 0.0f;
    }
    int cur = 0;   // the warp's next row to fold
    int pos = 0;   // rank of the next nonzero to consume
    int base = 0;  // rank of the round's first nonzero
    const int n_seg = nr * segs;  // (row, 128-slot segment), row-major
    for (int sg0 = 0; sg0 < n_seg; sg0 += kSegs) {
      const int n_sg = min(kSegs, n_seg - sg0);
      const int fi = sg0 / segs, fg = sg0 - fi * segs;
      // Load the round's vals (4 pieces of 32 slots a segment), then
      // compact the ranks [w0, w0 + kCap) of its nonzeros into the list
      // (the cols by cp.async, all in flight at once). Returns one past
      // the round's last rank; lane i of `end` gets one past the rank of
      // row i's last nonzero, for the rows whose last segment is here.
      auto compact = [&](int w0, int& end) {
        float v[kSegs][4];
        {
          int i = fi, g = fg;
#pragma unroll
          for (int j = 0; j < kSegs; ++j) {
            const float* vr =
                vals + static_cast<long>(r0 + kWarps * i) * K + 128 * g;
            const int left = j < n_sg ? K - 128 * g : 0;
#pragma unroll
            for (int q = 0; q < 4; ++q)
              v[j][q] = 32 * q + lane < left ? __ldg(vr + 32 * q + lane)
                                             : 0.0f;
            if (++g == segs) { g = 0; ++i; }
          }
        }
        int i = fi, g = fg, rank = base;
#pragma unroll
        for (int j = 0; j < kSegs; ++j) {
          const int* cr =
              cols + static_cast<long>(r0 + kWarps * i) * K + 128 * g + lane;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const unsigned nz = __ballot_sync(0xffffffffu, v[j][q] != 0.0f);
            const int my = rank + __popc(nz & below);
            if (v[j][q] != 0.0f && my >= w0 && my < w0 + kCap) {
              float2* e = list + (my - w0);
              e->x = v[j][q];
              sm90::cp_async4(sm90::smem_u32(&e->y), cr + 32 * q);
            }
            rank += __popc(nz);
          }
          if (j < n_sg && g == segs - 1 && lane == i) end = rank;
          if (++g == segs) { g = 0; ++i; }
        }
        sm90::cp_async_commit();
        sm90::cp_async_wait<0>();
        __syncwarp();
        return rank;
      };
      int my_end = 0;
      const int round_end = compact(base, my_end);
      if (segs == 1 && round_end <= kCap) {
        // The common case (K <= 128, the rows' nonzeros fit one list): the
        // round holds the warp's rows whole. Walk them with each row's dots
        // in registers, then fold all rows together: their exps are
        // independent. The same steps and folds in the same order as the
        // general walk below.
        float dd[kWarpRows][kQL];
        int t = 0;
#pragma unroll
        for (int r = 0; r < kWarpRows; ++r) {
#pragma unroll
          for (int u = 0; u < kQL; ++u) dd[r][u] = 0.0f;
          const int end = r < nr ? __shfl_sync(0xffffffffu, my_end, r) : t;
#pragma unroll 4
          for (; t < end; ++t) step(list[t], dd[r]);
        }
#pragma unroll
        for (int r = 0; r < kWarpRows; ++r) {
          const float s = __shfl_sync(0xffffffffu, my_sq, r);
          const float cf = __shfl_sync(0xffffffffu, my_coef, r);
          if (r < nr) fold(s, cf, dd[r], p);
        }
        __syncwarp();  // the list is free again
        cur = nr;
        base = round_end;
        continue;
      }
      const int close = (sg0 + n_sg) / segs;  // rows [cur, close) end here
      for (int w0 = base;;) {
        const int w1 = min(w0 + kCap, round_end);
        while (cur < nr) {
          const bool ends = cur < close;
          const int end = ends ? __shfl_sync(0xffffffffu, my_end, cur) : w1;
          const int stop = min(end, w1);
#pragma unroll 4
          for (int t = pos; t < stop; ++t) step(list[t - w0], dot);
          pos = stop;
          if (!ends || end > w1) break;
          fold(__shfl_sync(0xffffffffu, my_sq, cur),
               __shfl_sync(0xffffffffu, my_coef, cur), dot, p);
#pragma unroll
          for (int u = 0; u < kQL; ++u) dot[u] = 0.0f;
          ++cur;
        }
        __syncwarp();  // the list is free again
        w0 = w1;
        if (w0 >= round_end) break;
        int unused = 0;  // an overflowing round: reload, compact the next
        compact(w0, unused);  // window of its ranks
      }
      base = round_end;
    }
    // Hand the partials to the chunk's reduction without a block barrier:
    // the warps of a block drift apart, so one warp's loads wait while the
    // others compute. Chunks alternate between two partial areas; the
    // last warp to arrive adds a chunk's 16 partials in warp order.
    const int j = ch - blockIdx.x * per_block, par = j & 1;
    volatile int* arrived = sync + par;
    volatile int* reduced = sync + 2 + par;
    while (*reduced < (j >> 1)) __nanosleep(64);  // area free (chunk j - 2)
    double* area = red + par * kWarps * kTQ;
#pragma unroll
    for (int u = 0; u < kQL; ++u) area[w * kTQ + zq + u] = p[u];
    __threadfence_block();
    __syncwarp();  // every lane's partials are stored before lane 0 arrives
    int last = 0;
    if (lane == 0) last = atomicAdd(const_cast<int*>(arrived), 1) == kWarps - 1;
    if (__shfl_sync(0xffffffffu, last, 0)) {
      __threadfence_block();
#pragma unroll
      for (int u = 0; u < kQL; ++u) {
        double t = 0.0;
#pragma unroll
        for (int v = 0; v < kWarps; ++v)
          t = __dadd_rn(t, area[v * kTQ + zq + u]);
        if (zq + u < nq) part[static_cast<long>(ch) * b + q0 + zq + u] = t;
      }
      __syncwarp();
      if (lane == 0) {
        *arrived = 0;
        __threadfence_block();
        *reduced = (j >> 1) + 1;
      }
    }
  }
}

template <int kQL, bool kShared>
cudaError_t launch_chunks(const float* vals, const int* cols, const float* sq,
                          const float* coef, const float* Z, float inv_2s2,
                          double* part, int m, int K, int b, int d,
                          int n_chunks, cudaStream_t s) {
  auto kernel = ell_accumulate_chunks<kQL, kShared>;
  const int smem = Smem<kQL>::bytes(d, kShared);
  static int cached_smem = -1, cached_blocks = 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int resident = occupancy::resident_blocks<kThreads, 4>(
      kernel, smem, &cached_smem, &cached_blocks);
  // Chunks a block: the fewest waves of blocks, counting the staging of a
  // query tile as half a chunk's work.
  const int tiles = (b + Smem<kQL>::kTQ - 1) / Smem<kQL>::kTQ;
  int per_block = 1;
  double best = 1e300;
  for (int G = 1; G <= n_chunks && G <= 64; ++G) {
    const long blocks = static_cast<long>(tiles) * ((n_chunks + G - 1) / G);
    const double cost =
        static_cast<double>((blocks + resident - 1) / resident) * (G + 0.5);
    if (cost < best) {
      best = cost;
      per_block = G;
    }
  }
  const dim3 grid((n_chunks + per_block - 1) / per_block, tiles);
  kernel<<<grid, kThreads, smem, s>>>(vals, cols, sq, coef, Z, inv_2s2, part,
                                      m, K, b, d, n_chunks, per_block);
  return cudaGetLastError();
}

}  // namespace

// SV rows a chunk: part holds ceil(m / this) rows of partials.
extern "C" int repro_ell_rbf_accumulate_chunk_rows() { return kChunk; }

// vals (m, K) f32 and cols (m, K) i32 in [0, d) SVs, sq (m,), coef (m,),
// Z (b, d) queries -> out (b,); contiguous, on the current device; part
// (ceil(m / kChunk), b) fp64 scratch. Returns the first cudaGetLastError()
// of the two launches.
extern "C" int repro_ell_rbf_accumulate(const float* vals, const int* cols,
                                        const float* sq, const float* coef,
                                        const float* Z, float inv_2s2,
                                        float* out, double* part, int m,
                                        int K, int b, int d, void* stream) {
  if (b <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (m + kChunk - 1) / kChunk;
  if (n_chunks > 0) {
    cudaError_t e;
    if (b > 64 && Smem<4>::bytes(d, true) <= kMaxSmem)
      e = launch_chunks<4, true>(vals, cols, sq, coef, Z, inv_2s2, part, m, K,
                                 b, d, n_chunks, s);
    else if (Smem<2>::bytes(d, true) <= kMaxSmem)
      e = launch_chunks<2, true>(vals, cols, sq, coef, Z, inv_2s2, part, m, K,
                                 b, d, n_chunks, s);
    else
      e = launch_chunks<2, false>(vals, cols, sq, coef, Z, inv_2s2, part, m,
                                  K, b, d, n_chunks, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(chunk_sum::launch(part, out, n_chunks, b, s));
}
