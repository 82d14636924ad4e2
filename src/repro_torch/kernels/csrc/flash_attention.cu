// Flash-attention forward (causal or not, GQA) for Hopper (sm_90a).
//
//   q (B, H, Lq, Dh), k / v (B, Hkv, Lk, Dh), H a multiple of Hkv; query
//   head h reads kv head h / (H / Hkv). s = (q . k) * Dh^-0.5, masked to
//   -1e30 where col >= Lk or (causal and row < col); online softmax with
//   running (m, l, acc) in fp32; out = acc / max(l, 1e-30) in the input
//   type (fp32 or bf16). Causal is the TPU kernel's row >= col, which is
//   the decode-offset mask of ref.mha only for Lq == Lk (the wrapper
//   refuses causal with Lq != Lk).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (Pallas
// body _fa_kernel; wrapper repro.kernels.ops.flash_attention).
//
// What bounds it on this card: operations. At the llama3-8b prefill shape
// (B 4, H 32, Hkv 8, L 2048, Dh 128, causal) the two products are 137.5
// GFLOP against 168 MB of q/k/v/out: 139 us at the bf16 tensor-core rate
// (989 TFLOP/s), 50 us of HBM. So the products belong on the tensor cores,
// and the loads must overlap them.
//
// Two bodies, one per input type.
//
// bf16 (the LM's type; flash_attention_tc below): the FlashAttention-3
// structure without warpgroup ping-pong or fp8. One block of 384 threads
// per (batch, head, 128-row query tile): warpgroups 0 and 1 each own 64
// query rows (wgmma's M) and compute; warpgroup 2 produces — one thread
// issues every copy, and the warpgroup gives its registers to the
// consumers (setmaxnreg 24 / 240). The Q tile (128 x Dh bf16) is loaded
// once; K and V tiles (128 x Dh each) flow through a 2-stage ring in shared
// memory (160 KB at Dh 128), filled by TMA (cp.async.bulk.tensor over 3-D
// tensor maps (Dh, L, heads) with the 128-byte swizzle, or 64 / 32 bytes at
// Dh 32 / 16, so rows past Lq or Lk read as zeros per head) and guarded by
// full / empty mbarriers. S = Q K^T is wgmma m64n128k16 with both operands
// read from shared memory (K-major, descriptors swizzled as the maps are);
// the online softmax runs on the fp32 accumulator fragment in registers
// (row max and sum over the 4 threads that share a row, exp2 with
// scale * log2(e) folded in; the mask arithmetic runs only on the diagonal
// tile and a ragged last tile); O += P V is wgmma m64nDhk16 with P as the A
// operand from registers and V read MN-major (the descriptor's transpose
// bit). O stays in fp32 registers; O / l is rounded to bf16 and stored
// from registers, masked at Lq. The first product is exact in fp32 (bf16
// operands, fp32 accumulation, as the TPU kernel's upcast dot); only the
// order of summation differs.
//   P and the second product. wgmma multiplies bf16 by bf16, so P must
// enter it as bf16. Rounding P once, as the reference's own blockwise
// attention does (src/repro/models/common.py:84, p.astype(v.dtype); the
// port's twin is models/common.py blockwise_attention), keeps 8 bits of
// each probability: on short causal rows, where a few keys carry the
// whole row, that moves some outputs past the bf16 gate against the plain
// version, which keeps P in fp32 (rtol 2e-2, atol 2e-3; at llama3-8b's
// heads and L = 129 an error of 2.9e-3 where 2.4e-3 is allowed —
// tests/test_torch_lm.py emulates both ways on the CPU).
// So P enters as two bf16 parts, hi = bf16(P) and lo = bf16(P - hi), and
// O += hi V + lo V: 16 bits of each probability, two RS wgmmas per 16
// keys, and the gate holds at its tolerance. The row sum l adds the
// unrounded fp32 P.
//   Query heads that share a kv head are neighbours in blockIdx, so their
// K / V tiles come from L2; the most loaded query tiles (causal) run first.
// What bounds it now: the tensor cores issue from one warpgroup at a time
// between each warpgroup's softmax (no ping-pong, no overlap of a tile's
// softmax with the next tile's S product), the split P doubles the second
// product (1.5x the bound's operations), and the exp2 of every score runs
// on the SFUs (16 a clock per SM).
//
// fp32 (flash_attention_kernel, unchanged from the first port): one block
// of 256 threads per (batch, head, 64-row query tile); the TPU grid's
// sequential kv axis is a loop inside the block. The query tile is staged
// once in shared memory, transposed ([Dh][64 + pad]); each 64-row K tile is
// staged transposed the same way and each V tile as is, rows past Lq / Lk
// zero-filled, so ragged L needs no padding in device memory. Thread (ty,
// tx) of the 16 x 16 grid owns query rows 4ty..4ty+3: it computes their
// scores against key columns 4tx..4tx+3 (float4 shared loads of both
// operands, 16 FMAs per Dh step) and accumulates their output columns (Dh /
// 16 of them, float4-strided so neighbouring lanes read neighbouring
// words). The 16 lanes that share a row group sit in one half-warp, so row
// max and row sum are xor shuffles within it. P goes through shared memory
// (transposed) between the two products. Causal blocks stop at the
// diagonal tile (tiles wholly above it are skipped, as the TPU kernel's
// should_run), and the most loaded query tiles are scheduled first. Both
// products run on fp32 FMAs (67 TFLOP/s peak), which is what bounds it;
// fp32 is not the LM's serving type. Kernel dynamic shared memory: 119.8
// KB at Dh 128, above the 48 KB static limit, so the launcher raises the
// function's limit first.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kStride = 68;    // row stride of the transposed tiles (float4-aligned)
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

template <int Dh>
constexpr size_t smem_floats() {
  return 2 * Dh * kStride + kBK * Dh + kBK * kStride;  // qT, kT, v, pT
}

// Stage rows [r0, r0 + 64) of one (n, Dh) head slab as fp32 into shared
// memory, transposed (dst[d * kStride + r]) or not (dst[r * Dh + d]); rows
// at or past n are zero.
template <typename T, int Dh, bool kTransposed>
__device__ __forceinline__ void stage(const T* __restrict__ src, int r0,
                                      int n, float* __restrict__ dst) {
  for (int idx = threadIdx.x; idx < 64 * Dh; idx += kThreads) {
    const int r = idx / Dh;
    const int d = idx % Dh;
    const float x = (r0 + r < n) ? to_f(src[static_cast<size_t>(r0 + r) * Dh + d])
                                 : 0.0f;
    if constexpr (kTransposed)
      dst[d * kStride + r] = x;
    else
      dst[r * Dh + d] = x;
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int Dh>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int BH,
                       int H, int group, int Lq, int Lk, float scale,
                       int causal) {
  // output columns per thread: kNV float-vectors of kVec, kVec * 16 apart
  constexpr int kVec = Dh >= 64 ? 4 : Dh / 16;
  constexpr int kNV = Dh / (16 * kVec);
  constexpr int kCols = kVec * kNV;

  extern __shared__ float4 smem_raw[];
  float* qT = reinterpret_cast<float*>(smem_raw);  // [Dh][kStride]
  float* kT = qT + Dh * kStride;                   // [Dh][kStride]
  float* vs = kT + Dh * kStride;                   // [kBK][Dh]
  float* pT = vs + kBK * Dh;                       // [kBK][kStride]

  const int nq = (Lq + kBQ - 1) / kBQ;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x / BH);  // heavy first
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int b = bh / H, h = bh % H;
  const int hk = h / group;
  const int Hkv = H / group;
  const int q0 = qt * kBQ;
  const T* qh = q + static_cast<size_t>(bh) * Lq * Dh;
  const T* kh = k + static_cast<size_t>(b * Hkv + hk) * Lk * Dh;
  const T* vh = v + static_cast<size_t>(b * Hkv + hk) * Lk * Dh;
  T* oh = o + static_cast<size_t>(bh) * Lq * Dh;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  stage<T, Dh, true>(qh, q0, Lq, qT);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  int n_tiles = (Lk + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, q0 / kBK + 1);  // k0 <= q0 + kBQ - 1

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's readers of kT / vs / pT are done
    stage<T, Dh, true>(kh, k0, Lk, kT);
    stage<T, Dh, false>(vh, k0, Lk, vs);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < Dh; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(qT + d * kStride + ty * 4);
      const float4 kb = *reinterpret_cast<const float4*>(kT + d * kStride + tx * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        const bool keep = col < Lk && (!causal || row >= col);
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = l[i] * corr + rs;  // this thread's share of the row sum
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pT + (tx * 4 + j) * kStride + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(pT + c * kStride + ty * 4);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      float vv[kCols];
#pragma unroll
      for (int jj = 0; jj < kNV; ++jj) {
        const float* src = vs + c * Dh + jj * 16 * kVec + tx * kVec;
        if constexpr (kVec == 4) {
          const float4 x = *reinterpret_cast<const float4*>(src);
          vv[jj * 4] = x.x;
          vv[jj * 4 + 1] = x.y;
          vv[jj * 4 + 2] = x.z;
          vv[jj * 4 + 3] = x.w;
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) vv[jj * kVec + e] = src[e];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < kCols; ++e) acc[i][e] = fmaf(pv[i], vv[e], acc[i][e]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = 1.0f / fmaxf(half_warp_sum(l[i]), 1e-30f);
    const int row = q0 + ty * 4 + i;
    if (row >= Lq) continue;
    T* dst = oh + static_cast<size_t>(row) * Dh;
#pragma unroll
    for (int jj = 0; jj < kNV; ++jj)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        dst[jj * 16 * kVec + tx * kVec + e] = from_f<T>(acc[i][jj * kVec + e] * inv);
  }
}

template <typename T, int Dh>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Hkv, int Lq, int Lk, int causal, void* stream) {
  const int smem = static_cast<int>(smem_floats<Dh>() * sizeof(float));
  if (smem > 48 * 1024) {
    static int raised = 0;  // the attribute is per function; set it once
    if (!raised) {
      const cudaError_t e = cudaFuncSetAttribute(
          flash_attention_kernel<T, Dh>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      raised = 1;
    }
  }
  const int BH = B * H;
  const long blocks = static_cast<long>((Lq + kBQ - 1) / kBQ) * BH;
  flash_attention_kernel<T, Dh><<<static_cast<unsigned>(blocks), kThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), BH, H, H / Hkv, Lq, Lk,
      1.0f / sqrtf(static_cast<float>(Dh)), causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int Hkv, int Lq, int Lk, int Dh, int causal,
             void* stream) {
  switch (Dh) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, Hkv, Lq, Lk, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, H, Hkv, Lq, Lk, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, Hkv, Lq, Lk, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, Hkv, Lq, Lk, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ---------------------------------------------------------------------------
// bf16 body: wgmma products fed by a TMA ring (see the header).

namespace tc {

constexpr int kBM = 128;        // query rows per block: 2 consumer warpgroups
constexpr int kBN = 128;        // key rows per K / V tile
constexpr int kStages = 2;      // depth of the K / V ring
constexpr int kConsumers = 256; // threads of warpgroups 0 and 1
constexpr int kThreads = 384;   // + the producer warpgroup

// Shared-memory layout of one block. A tile of Dh bf16 columns is stored
// as kPanels column panels of kPw columns, each row of a panel one swizzle
// span (kSw bytes): a TMA box writes one panel, swizzled, and the wgmma
// descriptors read it with the same swizzle (kDescLayout).
template <int Dh>
struct Layout {
  static constexpr int kSw = Dh * 2 < 128 ? Dh * 2 : 128;
  static constexpr int kPw = kSw / 2;
  static constexpr int kPanels = Dh / kPw;
  static constexpr uint32_t kQBytes = kBM * Dh * 2;
  static constexpr uint32_t kTileBytes = kBN * Dh * 2;
  static constexpr uint32_t kBars = kQBytes + kStages * 2 * kTileBytes;
  // full[kStages], empty[kStages], q; + slack to align the base to 1024 B
  static constexpr int kSmem = kBars + 8 * (2 * kStages + 1) + 1024;
  static constexpr uint64_t kDescLayout = kSw == 128 ? 1 : kSw == 64 ? 2 : 3;
};

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle mode.
template <int Dh>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (Layout<Dh>::kDescLayout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving or reusing registers that an asynchronous
// wgmma still reads or writes: every access is ordered against this point.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D (64 x 128 fp32; 64 per thread) = [D +] A (64 x 16, shared memory,
// K-major) * B (16 x 128, shared memory, K-major); scale_d = 0 drops D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 16 fp32; 8 per thread) += A (64 x 16 bf16, registers) *
// B (16 x 16, shared memory, MN-major: the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 32 fp32; 16 per thread) += A (64 x 16 bf16, registers) *
// B (16 x 32, shared memory, MN-major: the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64 fp32; 32 per thread) += A (64 x 16 bf16, registers) *
// B (16 x 64, shared memory, MN-major: the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128 fp32; 64 per thread) += A (64 x 16 bf16, registers) *
// B (16 x 128, shared memory, MN-major: the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int Dh>
__device__ __forceinline__ void wgmma_rs(float (&d)[Dh / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (Dh == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (Dh == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (Dh == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// (x, y) as two bf16 pairs, hi = bf16(x, y) and lo = bf16((x, y) - hi),
// packed as wgmma A-fragment registers (x in the low half): hi + lo holds
// 16 significant bits of each, where hi alone holds 8.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int Dh>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tc(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ o, int BH, int H, int group,
                   int Lq, int Lk, float scale_log2, int causal) {
  using L = Layout<Dh>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t bars = base + L::kBars;
  auto sk = [&](int s) { return base + L::kQBytes + s * 2 * L::kTileBytes; };
  auto sv = [&](int s) { return sk(s) + L::kTileBytes; };
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };
  const uint32_t qbar = bars + 8u * 2 * kStages;

  const int nq = (Lq + kBM - 1) / kBM;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x / BH);  // heavy first
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int b = bh / H, h = bh % H;
  const int bkv = b * (H / group) + h / group;
  const int q0 = qt * kBM;
  int n_tiles = (Lk + kBN - 1) / kBN;
  if (causal) n_tiles = min(n_tiles, q0 / kBN + 1);  // k0 <= q0 + kBM - 1

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), kConsumers);
    }
    sm90::mbar_init(qbar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // -- producer warpgroup: one thread issues every TMA load -------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumers) {
      sm90::mbar_expect_tx(qbar, L::kQBytes);
      for (int p = 0; p < L::kPanels; ++p)
        sm90::tma_load3d(sq + p * kBM * L::kSw, &tm_q, p * L::kPw, q0, bh,
                         qbar);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        sm90::mbar_wait(empty(s), ((t / kStages) & 1) ^ 1);
        sm90::mbar_expect_tx(full(s), 2 * L::kTileBytes);
        for (int p = 0; p < L::kPanels; ++p) {
          sm90::tma_load3d(sk(s) + p * kBN * L::kSw, &tm_k, p * L::kPw,
                           t * kBN, bkv, full(s));
          sm90::tma_load3d(sv(s) + p * kBN * L::kSw, &tm_v, p * L::kPw,
                           t * kBN, bkv, full(s));
        }
      }
    }
  } else {
    // -- consumer warpgroups: 64 query rows each --------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    // accumulator fragment: this thread holds rows row0 and row0 + 8, and
    // in every 8-column block j the columns 8j + cl and 8j + cl + 1:
    // element 4j + 2i + c is (row0 + 8i, 8j + cl + c)
    const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;
    const int cl = 2 * (lane % 4);
    const uint32_t q_rows = sq + wg * 64 * L::kSw;

    float acc[Dh / 2];
#pragma unroll
    for (int i = 0; i < Dh / 2; ++i) acc[i] = 0.0f;
    float m0 = kNegInf, m1 = kNegInf;  // running max, scaled by log2(e)
    float l0 = 0.0f, l1 = 0.0f;         // this thread's share of the row sum

    sm90::mbar_wait(qbar, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      sm90::mbar_wait(full(s), (t / kStages) & 1);

      // S = Q K^T (64 x 128, fp32)
      float sc[64];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < Dh / 16; ++kk) {
        const uint32_t panel = (kk * 16) / L::kPw;
        const uint32_t col = (kk * 16) % L::kPw * 2;
        wgmma_ss_n128(
            sc,
            desc<Dh>(q_rows + panel * kBM * L::kSw + col, 16, 8 * L::kSw),
            desc<Dh>(sk(s) + panel * kBN * L::kSw + col, 16, 8 * L::kSw),
            kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(sc);

      const int k0 = t * kBN;
      if ((causal && t == n_tiles - 1) || k0 + kBN > Lk) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = k0 + 8 * j + cl + (e & 1);
            const int r = row0 + 8 * (e >> 1);
            if (c >= Lk || (causal && r < c)) sc[4 * j + e] = kNegInf;
          }
      }
      float r0 = kNegInf, r1 = kNegInf;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        r0 = fmaxf(r0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        r1 = fmaxf(r1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        r0 = fmaxf(r0, __shfl_xor_sync(0xffffffffu, r0, off));
        r1 = fmaxf(r1, __shfl_xor_sync(0xffffffffu, r1, off));
      }
      const float n0 = fmaxf(m0, r0 * scale_log2);
      const float n1 = fmaxf(m1, r1 * scale_log2);
      const float c0 = exp2f(m0 - n0), c1 = exp2f(m1 - n1);
      m0 = n0;
      m1 = n1;
      // P = exp2(S * scale * log2(e) - m), fp32 for the row sum; hi and lo
      // bf16 A fragments for the second product (p[2j] row0, p[2j + 1]
      // row0 + 8)
      uint32_t p[32], pl[32];
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float a = exp2f(fmaf(sc[4 * j], scale_log2, -n0));
        const float bb = exp2f(fmaf(sc[4 * j + 1], scale_log2, -n0));
        const float c = exp2f(fmaf(sc[4 * j + 2], scale_log2, -n1));
        const float d = exp2f(fmaf(sc[4 * j + 3], scale_log2, -n1));
        s0 += a + bb;
        s1 += c + d;
        split_bf16(a, bb, p[2 * j], pl[2 * j]);
        split_bf16(c, d, p[2 * j + 1], pl[2 * j + 1]);
      }
      l0 = fmaf(l0, c0, s0);
      l1 = fmaf(l1, c1, s1);
#pragma unroll
      for (int j = 0; j < Dh / 8; ++j) {
        acc[4 * j] *= c0;
        acc[4 * j + 1] *= c0;
        acc[4 * j + 2] *= c1;
        acc[4 * j + 3] *= c1;
      }

      // O += P_hi V + P_lo V (64 x Dh, fp32): 16 keys per step
      pin(acc);
      pin(p);
      pin(pl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint64_t dv =
            desc<Dh>(sv(s) + kk * 16 * L::kSw, kBN * L::kSw, 8 * L::kSw);
        const uint32_t hi[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                                p[4 * kk + 3]};
        const uint32_t lo[4] = {pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2],
                                pl[4 * kk + 3]};
        wgmma_rs<Dh>(acc, hi, dv);
        wgmma_rs<Dh>(acc, lo, dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(acc);
      pin(p);
      pin(pl);
      sm90::mbar_arrive(empty(s));
    }

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.0f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.0f / fmaxf(l1, 1e-30f);
    __nv_bfloat16* out = o + static_cast<size_t>(bh) * Lq * Dh;
    if (row0 < Lq) {
      __nv_bfloat16* dst = out + static_cast<size_t>(row0) * Dh + cl;
#pragma unroll
      for (int j = 0; j < Dh / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    }
    if (row0 + 8 < Lq) {
      __nv_bfloat16* dst = out + static_cast<size_t>(row0 + 8) * Dh + cl;
#pragma unroll
      for (int j = 0; j < Dh / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2] * inv1,
                                  acc[4 * j + 3] * inv1);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 3-D map (Dh, L, heads) of one (B, heads, L, Dh) bf16 tensor, read in
// boxes of one panel (kPw columns) by `rows` rows of one head.
template <int Dh>
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int L,
              int heads, int rows) {
  using Lay = Layout<Dh>;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Dh),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {Dh * 2ull,
                                 static_cast<cuuint64_t>(L) * Dh * 2ull};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(Lay::kPw),
                             static_cast<cuuint32_t>(rows), 1u};
  const cuuint32_t unit[3] = {1u, 1u, 1u};
  const CUtensorMapSwizzle swizzle =
      Lay::kSw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : Lay::kSw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                       : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int Dh>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Hkv, int Lq, int Lk, int causal, void* stream) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);  // TMA needs 16 B
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap mq, mk, mv;
  if (!make_map<Dh>(encode, &mq, q, Lq, B * H, kBM) ||
      !make_map<Dh>(encode, &mk, k, Lk, B * Hkv, kBN) ||
      !make_map<Dh>(encode, &mv, v, Lk, B * Hkv, kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  static int raised = 0;  // the attribute is per function; set it once
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_tc<Dh>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Layout<Dh>::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    raised = 1;
  }
  const long blocks = static_cast<long>((Lq + kBM - 1) / kBM) * B * H;
  const float log2e = 1.4426950408889634f;
  flash_attention_tc<Dh><<<static_cast<unsigned>(blocks), kThreads,
                           Layout<Dh>::kSmem,
                           static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), B * H, H, H / Hkv, Lq, Lk,
      log2e / sqrtf(static_cast<float>(Dh)), causal);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int Hkv, int Lq, int Lk, int Dh, int causal,
             void* stream) {
  switch (Dh) {
    case 16: return launch<16>(q, k, v, o, B, H, Hkv, Lq, Lk, causal, stream);
    case 32: return launch<32>(q, k, v, o, B, H, Hkv, Lq, Lk, causal, stream);
    case 64: return launch<64>(q, k, v, o, B, H, Hkv, Lq, Lk, causal, stream);
    case 128: return launch<128>(q, k, v, o, B, H, Hkv, Lq, Lk, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

}  // namespace

// q (B, H, Lq, Dh), k / v (B, Hkv, Lk, Dh) -> o (B, H, Lq, Dh); all fp32
// (bf16 = 0) or all bf16 (bf16 = 1), contiguous, on the current device
// (bf16: q, k, v 16-byte aligned); Dh in {16, 32, 64, 128}, H % Hkv == 0,
// Lq, Lk >= 1. Returns cudaGetLastError() (cudaErrorInvalidValue for an
// unsupported Dh or a tensor map the driver refuses,
// cudaErrorMisalignedAddress for a misaligned bf16 operand).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int H,
                                     int Hkv, int Lq, int Lk, int Dh,
                                     int causal, int bf16, void* stream) {
  if (B <= 0 || Lq <= 0) return 0;
  if (Lk <= 0 || Hkv <= 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? tc::dispatch(q, k, v, o, B, H, Hkv, Lq, Lk, Dh, causal,
                             stream)
              : dispatch<float>(q, k, v, o, B, H, Hkv, Lq, Lk, Dh, causal,
                                stream);
}
