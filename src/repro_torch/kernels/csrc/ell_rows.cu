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
// What bounds them on this card: device memory, and the latency of each
// row's chain of loads. A pass must read every val (N*K*4 bytes: a zero is
// only known once read) and the cols of the nonzero slots, plus sq (and
// gamma in and out): 18.4 MB at the w7a buffer (N = 32768, K = 128, 12
// nonzeros per row), a 5.5 us bound at 3.35 TB/s, against 4 flops per
// nonzero and query: far below the H100's fp32 ridge. The kernel skips the
// cols of zero slots (reading every col, 33.9 MB there, took ~3 us more
// with the buffer out of L2) and runs at ~2.5x the bound: each warp walks
// ~4 rows one after another, each a chain of dependent loads (vals, cols,
// the z gathers, sq). The gathers of z hit shared memory (or L1/L2).
//
// Design: one warp per row, grid-stride over rows (a few rows per warp, so
// each block's load of the queries into shared memory is amortized). Lane l
// reads slots l, l+32, ..., so every warp load of vals (and of the cols of
// its nonzero slots) is contiguous; the lane gathers z[col] for the query
// (or both queries) from shared memory when Q*d*4 bytes fit in 48 KB, else
// from global memory through the read-only path (__ldg), so any d works. K
// is live (adaptive K changes it at every compaction) and need not be a
// multiple of 32: the slot loop bound masks the ragged K edge, the row
// loop the ragged N edge.
// Both queries share the slot loads and run the identical instruction
// sequence — the same FMA order, the same fixed xor-shuffle reduction, the
// same explicitly rounded epilogue — so a row made in slot 0 is bitwise
// equal to the same row made in slot 1 (kernel_fns.row_via_rows2 relies on
// it) and to the one-query entry. Padding slots add exactly 0; padding
// rows carry gamma = +inf, and +inf plus a finite update stays +inf.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kBlocksPerSM = 8;
// dynamic shared memory for the queries without an opt-in (48 KB less the
// kernel's static shared memory)
constexpr size_t kSharedQueryBytes = 48 * 1024 - 256;

enum Mode { kRow = 0, kRows2 = 1, kGamma = 2 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;  // every lane holds the same bits (fp add commutes)
}

__device__ __forceinline__ float rbf(float sq, float dot, float zn,
                                     float inv_2s2) {
  const float d2 = __fadd_rn(__fsub_rn(sq, __fmul_rn(2.0f, dot)), zn);
  return expf(__fmul_rn(-fmaxf(d2, 0.0f), inv_2s2));
}

template <bool kShared>
__device__ __forceinline__ float load_z(const float* p) {
  if constexpr (kShared) {
    return *p;
  } else {
    return __ldg(p);
  }
}

template <int kMode, bool kShared>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ell_rows_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                const float* __restrict__ sq, const float* __restrict__ z,
                float inv_2s2, const float* __restrict__ gamma,
                const float* __restrict__ coef2, float* __restrict__ out,
                int n, int K, int d) {
  constexpr int Q = kMode == kRow ? 1 : 2;
  extern __shared__ float zs[];  // z_0 at [0, d), z_1 at [d, 2d) (kShared)
  __shared__ float zn[2];
  if constexpr (kShared) {
    for (int k = threadIdx.x; k < Q * d; k += blockDim.x) zs[k] = z[k];
    __syncthreads();
  }
  const float* zq = kShared ? zs : z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp < Q) {  // |z_j|^2, one warp per query, the same code for both
    const float* zj = zq + warp * d;
    float a = 0.0f;
    for (int k = lane; k < d; k += 32) {
      const float v = load_z<kShared>(zj + k);
      a = fmaf(v, v, a);
    }
    a = warp_sum(a);
    if (lane == 0) zn[warp] = a;
  }
  __syncthreads();

  const long stride = static_cast<long>(gridDim.x) * kWarpsPerBlock;
  for (long row = static_cast<long>(blockIdx.x) * kWarpsPerBlock + warp;
       row < n; row += stride) {
    const float* v = vals + row * K;
    const int* c = cols + row * K;
    float a0 = 0.0f, a1 = 0.0f;
    for (int k = lane; k < K; k += 32) {
      const float xv = __ldg(v + k);
      // a zero slot adds 0 whatever its column, so its column is not read
      // (z[0] stands in): a warp whose 32 slots are all padding loads no
      // cols at all
      const int ci = xv != 0.0f ? __ldg(c + k) : 0;
      a0 = fmaf(xv, load_z<kShared>(zq + ci), a0);
      if constexpr (Q == 2) a1 = fmaf(xv, load_z<kShared>(zq + d + ci), a1);
    }
    a0 = warp_sum(a0);
    if constexpr (Q == 2) a1 = warp_sum(a1);
    if (lane == 0) {
      const float s = sq[row];
      const float k0 = rbf(s, a0, zn[0], inv_2s2);
      if constexpr (kMode == kRow) {
        out[row] = k0;
      } else {
        const float k1 = rbf(s, a1, zn[1], inv_2s2);
        if constexpr (kMode == kGamma) {
          out[row] = __fadd_rn(gamma[row],
                               __fadd_rn(__fmul_rn(k0, coef2[0]),
                                         __fmul_rn(k1, coef2[1])));
        } else {
          out[2 * row] = k0;
          out[2 * row + 1] = k1;
        }
      }
    }
  }
}

int sm_count() {
  static int count = 0;
  if (count <= 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess ||
        count <= 0)
      count = 132;
  }
  return count;
}

template <int kMode>
int launch(const float* vals, const int* cols, const float* sq,
           const float* z, float inv_2s2, const float* gamma,
           const float* coef2, float* out, int n, int K, int d,
           void* stream) {
  if (n <= 0) return 0;
  constexpr int Q = kMode == kRow ? 1 : 2;
  const size_t zbytes = static_cast<size_t>(Q) * d * sizeof(float);
  const long need = (static_cast<long>(n) + kWarpsPerBlock - 1) /
                    kWarpsPerBlock;
  const long cap = static_cast<long>(sm_count()) * kBlocksPerSM;
  const int grid = static_cast<int>(need < cap ? need : cap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (zbytes <= kSharedQueryBytes) {
    ell_rows_kernel<kMode, true><<<grid, kWarpsPerBlock * 32, zbytes, s>>>(
        vals, cols, sq, z, inv_2s2, gamma, coef2, out, n, K, d);
  } else {
    ell_rows_kernel<kMode, false><<<grid, kWarpsPerBlock * 32, 0, s>>>(
        vals, cols, sq, z, inv_2s2, gamma, coef2, out, n, K, d);
  }
  return static_cast<int>(cudaGetLastError());
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

// vals, cols, sq as above, gamma (n,), z2 (2, d), coef2 (2,) -> out (n,).
extern "C" int repro_ell_gamma_update(const float* vals, const int* cols,
                                      const float* sq, const float* gamma,
                                      const float* z2, const float* coef2,
                                      float inv_2s2, float* out, int n, int K,
                                      int d, void* stream) {
  return launch<kGamma>(vals, cols, sq, z2, inv_2s2, gamma, coef2, out, n,
                        K, d, stream);
}
