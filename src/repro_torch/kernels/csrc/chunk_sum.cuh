// The second pass of the split serve-time accumulates (rbf_accumulate.cu,
// ell_accumulate.cu). Their first kernel leaves one fp64 partial per (SV
// chunk, query) in part (n_chunks, b); this one adds a query's partials in
// chunk-index order and rounds the sum to fp32 once:
//
//   out[q] = (float) (((0 + part[0][q]) + part[1][q]) + ... )
//
// A block takes 32 queries: its 256 threads stage up to 192 chunks' rows
// of them in shared memory by coalesced loads (one round trip), then lane
// q adds its column in chunk order. The order is fixed whatever b and
// n_chunks are, and a chunk whose partial is +0 changes no bit. No atomics.
#pragma once

#include <cuda_runtime.h>

namespace chunk_sum {
namespace {

constexpr int kQ = 32;       // queries a block
constexpr int kRows = 192;   // chunks staged at once: 48 KB
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sum_kernel(const double* __restrict__ part, float* __restrict__ out,
           int n_chunks, int b) {
  __shared__ double s[kRows][kQ];
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kQ + lane;
  double t = 0.0;
  for (int c0 = 0; c0 < n_chunks; c0 += kRows) {
#pragma unroll
    for (int i = 0; i < kRows * kQ / kThreads; ++i) {
      const int r = (threadIdx.x >> 5) + kThreads / 32 * i;
      const int c = c0 + r;
      s[r][lane] =
          c < n_chunks && q < b ? part[static_cast<long>(c) * b + q] : 0.0;
    }
    __syncthreads();
    if (threadIdx.x < kQ) {
      const int n = min(kRows, n_chunks - c0);
#pragma unroll 8
      for (int r = 0; r < n; ++r) t = __dadd_rn(t, s[r][lane]);
    }
    __syncthreads();
  }
  if (threadIdx.x < kQ && q < b) out[q] = __double2float_rn(t);
}

// Launch the sum of part (n_chunks, b) into out (b,); cudaGetLastError().
cudaError_t launch(const double* part, float* out, int n_chunks, int b,
                   cudaStream_t s) {
  sum_kernel<<<(b + kQ - 1) / kQ, kThreads, 0, s>>>(part, out, n_chunks, b);
  return cudaGetLastError();
}

}  // namespace
}  // namespace chunk_sum
