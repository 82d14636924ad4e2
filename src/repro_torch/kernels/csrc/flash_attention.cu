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
// GFLOP against 168 MB of q/k/v/out: 139 us at the bf16 tensor-core rate,
// 50 us of HBM. This first kernel runs both products on fp32 FMAs (67
// TFLOP/s peak, so >= 2 ms at that shape); tensor cores (wgmma) and TMA
// loads are later work.
//
// Design: one block of 256 threads per (batch, head, 64-row query tile);
// the TPU grid's sequential kv axis is a loop inside the block. The query
// tile is staged once in shared memory, transposed ([Dh][64 + pad]); each
// 64-row K tile is staged transposed the same way and each V tile as is,
// all converted to fp32, rows past Lq / Lk zero-filled, so ragged L needs
// no padding in device memory. Thread (ty, tx) of the 16 x 16 grid owns
// query rows 4ty..4ty+3: it computes their scores against key columns
// 4tx..4tx+3 (float4 shared loads of both operands, 16 FMAs per Dh step)
// and accumulates their output columns (Dh / 16 of them, float4-strided
// so neighbouring lanes read neighbouring words). The 16 lanes that share
// a row group sit in one half-warp, so row max and row sum are xor
// shuffles within it. P goes through shared memory (transposed) between
// the two products. Causal blocks stop at the diagonal tile (tiles wholly
// above it are skipped, as the TPU kernel's should_run), and the most
// loaded query tiles are scheduled first. Kernel dynamic shared memory:
// 119.8 KB at Dh 128, above the 48 KB static limit, so the launcher raises
// the function's limit first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

}  // namespace

// q (B, H, Lq, Dh), k / v (B, Hkv, Lk, Dh) -> o (B, H, Lq, Dh); all fp32
// (bf16 = 0) or all bf16 (bf16 = 1), contiguous, on the current device;
// Dh in {16, 32, 64, 128}, H % Hkv == 0, Lq, Lk >= 1. Returns
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported Dh).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int H,
                                     int Hkv, int Lq, int Lk, int Dh,
                                     int causal, int bf16, void* stream) {
  if (B <= 0 || Lq <= 0) return 0;
  if (Lk <= 0 || Hkv <= 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, B, H, Hkv, Lq, Lk, Dh,
                                        causal, stream)
              : dispatch<float>(q, k, v, o, B, H, Hkv, Lq, Lk, Dh, causal,
                                stream);
}
