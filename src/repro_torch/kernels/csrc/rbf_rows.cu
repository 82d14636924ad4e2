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
// once (N*d*4 bytes: 16.1 MB at the a9a buffer N=32768, d=123) plus sq
// (and gamma), against 4*N*d flops — about 1 flop per byte, far below the
// H100's ~20 flop/byte fp32 ridge. Across SMO iterations the same X is read
// every time, and at a9a size it fits the 50 MB L2.
//
// Design: one kernel body, two epilogues. One warp per sample row. Lanes
// stride over d, so each warp load is 32 consecutive floats of one row
// (coalesced, no alignment needed for any d); the ragged d edge is masked
// by the loop bound and the ragged N edge by the row guard — no padding of
// X is required. Both queries live in shared memory (2*d floats), loaded
// once per block. The two dot products share the X load and reduce with
// the same fixed xor-shuffle tree, so the result is deterministic, and the
// two columns run the *identical* instruction sequence: a row made in slot
// 0 is bitwise equal to the same row made in slot 1. Single-row production
// (kernel_fns.row_via_rows2: rows2([z, z])[:, 0]) relies on this position
// symmetry. Distance, exp and the FMA into gamma stay in fp32 with
// explicitly rounded operations (no contraction differences between
// builds).
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

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

// kGamma = false: write the (N, 2) rows; true: the Eq. 6 update into out.
template <bool kGamma>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rbf_rows_kernel(const float* __restrict__ X, const float* __restrict__ sq,
                const float* __restrict__ z2, float inv_2s2,
                const float* __restrict__ gamma,
                const float* __restrict__ coef2, float* __restrict__ out,
                int n, int d) {
  extern __shared__ float zs[];  // z_0 at [0, d), z_1 at [d, 2d)
  __shared__ float zn[2];
  for (int k = threadIdx.x; k < 2 * d; k += blockDim.x) zs[k] = z2[k];
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp < 2) {  // |z_j|^2 with the same reduction as the row dots
    const float* z = zs + warp * d;
    float a = 0.0f;
    for (int k = lane; k < d; k += 32) a = fmaf(z[k], z[k], a);
    a = warp_sum(a);
    if (lane == 0) zn[warp] = a;
  }
  __syncthreads();
  const long row = (long)blockIdx.x * kWarpsPerBlock + warp;
  if (row >= n) return;
  const float* x = X + row * d;
  float a0 = 0.0f, a1 = 0.0f;
  for (int k = lane; k < d; k += 32) {
    const float xv = __ldg(x + k);
    a0 = fmaf(xv, zs[k], a0);
    a1 = fmaf(xv, zs[d + k], a1);
  }
  a0 = warp_sum(a0);
  a1 = warp_sum(a1);
  if (lane == 0) {
    const float s = sq[row];
    const float k0 = rbf(s, a0, zn[0], inv_2s2);
    const float k1 = rbf(s, a1, zn[1], inv_2s2);
    if constexpr (kGamma) {
      out[row] = __fadd_rn(gamma[row], __fadd_rn(__fmul_rn(k0, coef2[0]),
                                                 __fmul_rn(k1, coef2[1])));
    } else {
      out[2 * row] = k0;
      out[2 * row + 1] = k1;
    }
  }
}

template <bool kGamma>
int launch(const float* X, const float* sq, const float* z2, float inv_2s2,
           const float* gamma, const float* coef2, float* out, int n, int d,
           void* stream) {
  if (n <= 0) return 0;
  const size_t smem = 2 * static_cast<size_t>(d) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rbf_rows_kernel<kGamma>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  rbf_rows_kernel<kGamma><<<grid, kWarpsPerBlock * 32, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      X, sq, z2, inv_2s2, gamma, coef2, out, n, d);
  return static_cast<int>(cudaGetLastError());
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

// X (n, d), sq (n,), gamma (n,), z2 (2, d), coef2 (2,) -> out (n,); all f32,
// contiguous, on the current device. Returns cudaGetLastError().
extern "C" int repro_gamma_update(const float* X, const float* sq,
                                  const float* gamma, const float* z2,
                                  const float* coef2, float inv_2s2,
                                  float* out, int n, int d, void* stream) {
  return launch<true>(X, sq, z2, inv_2s2, gamma, coef2, out, n, d, stream);
}
