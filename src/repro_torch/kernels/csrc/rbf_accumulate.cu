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
// against M support vectors of width d costs 2*B*M*d flops of FMA (18.1
// GFLOP at B=4096, M=18000, d=123) and B*M exps, against (M + B)*d*4 bytes
// of input — hundreds of flops per byte.
//
// Design: one block per tile of 32 queries. It walks the SV tiles (64 rows)
// in a fixed order; for each, it stages 32-wide feature chunks of the query
// tile and the SV tile in shared memory (transposed, padded against bank
// conflicts) and accumulates the 32x64 dot products in registers, 2x4 per
// thread. The tile epilogue turns dots into kernel values and folds
// coef * K into per-thread partial sums held in registers across all SV
// tiles, in fp64: a decision value is a sum of ~M signed terms that mostly
// cancel, and one fp64 FMA per (query, SV) pair is cheap beside the d fp32
// FMAs of its dot product. At the end the 16 threads sharing a query reduce
// with a fixed xor-shuffle tree. No atomics and a fixed order everywhere, so scores are
// identical from run to run. SV rows past M are never read; an SV with
// coef 0 adds exactly 0 (fma(0, k, p) == p for the finite k in [0, 1]).
// CUDA cores, not tensor cores: fp32 accuracy with no TF32 rounding.
#include <cuda_runtime.h>

namespace {

constexpr int kTQ = 32;   // queries per block
constexpr int kTS = 64;   // support vectors per tile
constexpr int kDK = 32;   // feature chunk staged in shared memory
constexpr int kThreads = 256;  // (16 query pairs) x (16 SV lanes)

__global__ void __launch_bounds__(kThreads)
rbf_accumulate_kernel(const float* __restrict__ X,
                      const float* __restrict__ sq,
                      const float* __restrict__ coef,
                      const float* __restrict__ Z, float inv_2s2,
                      float* __restrict__ out, int m, int b, int d) {
  __shared__ float zs[kDK][kTQ + 1];
  __shared__ float xs[kDK][kTS + 1];
  __shared__ float qn[kTQ];
  const int tid = threadIdx.x;
  const int tx = tid & 15;   // SV lane: SVs tx + 16*j, j < 4
  const int ty = tid >> 4;   // query pair: queries 2*ty + i, i < 2
  const int q0 = blockIdx.x * kTQ;

  if (tid < kTQ) {
    float a = 0.0f;
    const int q = q0 + tid;
    if (q < b) {
      const float* z = Z + static_cast<long>(q) * d;
      for (int k = 0; k < d; ++k) a = fmaf(z[k], z[k], a);
    }
    qn[tid] = a;
  }
  __syncthreads();
  const float qn0 = qn[2 * ty], qn1 = qn[2 * ty + 1];

  double part[2] = {0.0, 0.0};
  for (int s0 = 0; s0 < m; s0 += kTS) {
    float acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < d; k0 += kDK) {
      for (int e = tid; e < kTQ * kDK; e += kThreads) {
        const int r = e / kDK, c = e % kDK;
        const int q = q0 + r, k = k0 + c;
        zs[c][r] = (q < b && k < d) ? Z[static_cast<long>(q) * d + k] : 0.0f;
      }
      for (int e = tid; e < kTS * kDK; e += kThreads) {
        const int r = e / kDK, c = e % kDK;
        const int s = s0 + r, k = k0 + c;
        xs[c][r] = (s < m && k < d) ? X[static_cast<long>(s) * d + k] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kDK; ++c) {
        const float a0 = zs[c][2 * ty];
        const float a1 = zs[c][2 * ty + 1];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float bv = xs[c][tx + 16 * j];
          acc[0][j] = fmaf(a0, bv, acc[0][j]);
          acc[1][j] = fmaf(a1, bv, acc[1][j]);
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = s0 + tx + 16 * j;
      if (s < m) {
        const double cs = coef[s];
        const float ss = sq[s];
        const float d20 = __fadd_rn(__fsub_rn(qn0, __fmul_rn(2.0f, acc[0][j])), ss);
        const float d21 = __fadd_rn(__fsub_rn(qn1, __fmul_rn(2.0f, acc[1][j])), ss);
        const float k0 = expf(__fmul_rn(-fmaxf(d20, 0.0f), inv_2s2));
        const float k1 = expf(__fmul_rn(-fmaxf(d21, 0.0f), inv_2s2));
        part[0] = fma(cs, static_cast<double>(k0), part[0]);
        part[1] = fma(cs, static_cast<double>(k1), part[1]);
      }
    }
  }

  // the 16 lanes of a half-warp share ty: fixed xor tree over tx
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    part[0] = __dadd_rn(part[0], __shfl_xor_sync(0xffffffffu, part[0], off));
    part[1] = __dadd_rn(part[1], __shfl_xor_sync(0xffffffffu, part[1], off));
  }
  if (tx == 0) {
    const int q = q0 + 2 * ty;
    if (q < b) out[q] = static_cast<float>(part[0]);
    if (q + 1 < b) out[q + 1] = static_cast<float>(part[1]);
  }
}

}  // namespace

// X (m, d) SVs, sq (m,), coef (m,), Z (b, d) queries -> out (b,); all f32,
// contiguous, on the current device. Returns cudaGetLastError().
extern "C" int repro_rbf_accumulate(const float* X, const float* sq,
                                    const float* coef, const float* Z,
                                    float inv_2s2, float* out, int m, int b,
                                    int d, void* stream) {
  if (b <= 0) return 0;
  const int grid = (b + kTQ - 1) / kTQ;
  rbf_accumulate_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      X, sq, coef, Z, inv_2s2, out, m, b, d);
  return static_cast<int>(cudaGetLastError());
}
