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
// What bounds it on this card: the gathers and FMAs over the nonzero slots.
// A bucket of B queries against M SVs with nnz nonzeros each costs 2*B*M*nnz
// flops (w7a: 12 nonzeros in K = 128 slots) plus B*M exps, against
// (M*K*8 + B*d*4) bytes of input; at the serve shapes that is well above
// the fp32 ridge, so operations, not bytes, bound it.
//
// Design: one block per tile of 32 queries (lane j of every warp owns query
// j of the tile), 16 warps walking the SV rows i = warp, warp + 16, ... in a
// fixed order. A warp reads each SV row's (vals, cols) once per tile, 32
// slots per coalesced load; a ballot over the loaded values picks the
// nonzero slots, and each is broadcast to the lanes by shuffle in slot
// order (padding slots and explicitly stored zeros would add exactly 0, so
// skipping them changes no bit). Each lane gathers z_j[col] from the query
// tile staged in shared memory (odd row stride: the 32 lanes hit 32 banks)
// when the tile fits in 200 KB, else from global memory through the
// read-only path — any d works. K is computed in fp32 with explicitly
// rounded operations; coef * K is accumulated in fp64 registers, because a
// decision value is a sum of ~M signed terms that mostly cancel (fp32 left
// 8.5e-4 relative error on the dense a9a model). At the end the 16 warps'
// partials add in warp order through shared memory. No atomics and a fixed
// order everywhere, so scores are identical from run to run; SV rows with
// coef 0 add exactly 0.
#include <cuda_runtime.h>

namespace {

constexpr int kTQ = 32;      // queries per block (one per lane)
constexpr int kWarps = 16;   // warps per block, each walking 1/16 of the SVs
constexpr size_t kMaxTileBytes = 200 * 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <bool kShared>
__device__ __forceinline__ float load_z(const float* p) {
  if constexpr (kShared) {
    return *p;
  } else {
    return __ldg(p);
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kWarps * 32)
ell_accumulate_kernel(const float* __restrict__ vals,
                      const int* __restrict__ cols,
                      const float* __restrict__ sq,
                      const float* __restrict__ coef,
                      const float* __restrict__ Z, float inv_2s2,
                      float* __restrict__ out, int m, int K, int b, int d,
                      int ds) {
  extern __shared__ float zs[];  // kTQ query rows of stride ds (kShared)
  __shared__ float qn[kTQ];
  __shared__ double red[kWarps][kTQ];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kTQ;
  const int nq = b - q0 < kTQ ? b - q0 : kTQ;

  if constexpr (kShared) {
    for (long e = threadIdx.x; e < static_cast<long>(kTQ) * d;
         e += blockDim.x) {
      const int r = static_cast<int>(e / d);
      const int c = static_cast<int>(e - static_cast<long>(r) * d);
      zs[r * ds + c] =
          r < nq ? Z[static_cast<long>(q0 + r) * d + c] : 0.0f;
    }
    __syncthreads();
  }
  for (int r = warp; r < kTQ; r += kWarps) {  // |z_r|^2 for the tile
    float a = 0.0f;
    if (r < nq) {
      const float* zr =
          kShared ? zs + r * ds : Z + static_cast<long>(q0 + r) * d;
      for (int k = lane; k < d; k += 32) {
        const float v = load_z<kShared>(zr + k);
        a = fmaf(v, v, a);
      }
    }
    a = warp_sum(a);
    if (lane == 0) qn[r] = a;
  }
  __syncthreads();

  const bool live = lane < nq;
  const float my_qn = qn[lane];
  const float* zrow =
      kShared ? zs + lane * ds
              : Z + static_cast<long>(q0 + (live ? lane : 0)) * d;
  double part = 0.0;
  for (int s = warp; s < m; s += kWarps) {
    const float* v = vals + static_cast<long>(s) * K;
    const int* c = cols + static_cast<long>(s) * K;
    float dot = 0.0f;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      const float vv = k < K ? __ldg(v + k) : 0.0f;
      const int cc = k < K ? __ldg(c + k) : 0;
      unsigned nz = __ballot_sync(0xffffffffu, vv != 0.0f);
      while (nz) {  // warp-uniform: every lane walks the same slots
        const int j = __ffs(nz) - 1;
        nz &= nz - 1;
        const float x = __shfl_sync(0xffffffffu, vv, j);
        const int ci = __shfl_sync(0xffffffffu, cc, j);
        dot = fmaf(x, load_z<kShared>(zrow + ci), dot);
      }
    }
    const float d2 =
        __fadd_rn(__fsub_rn(my_qn, __fmul_rn(2.0f, dot)), sq[s]);
    const float kv = expf(__fmul_rn(-fmaxf(d2, 0.0f), inv_2s2));
    part = fma(static_cast<double>(coef[s]), static_cast<double>(kv), part);
  }
  red[warp][lane] = part;
  __syncthreads();
  if (warp == 0) {
    double t = red[0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t = __dadd_rn(t, red[w][lane]);
    if (live) out[q0 + lane] = static_cast<float>(t);
  }
}

}  // namespace

// vals (m, K) f32 and cols (m, K) i32 in [0, d) SVs, sq (m,), coef (m,),
// Z (b, d) queries -> out (b,); contiguous, on the current device. Returns
// cudaGetLastError().
extern "C" int repro_ell_rbf_accumulate(const float* vals, const int* cols,
                                        const float* sq, const float* coef,
                                        const float* Z, float inv_2s2,
                                        float* out, int m, int K, int b,
                                        int d, void* stream) {
  if (b <= 0) return 0;
  const int grid = (b + kTQ - 1) / kTQ;
  const int ds = d | 1;  // odd row stride: conflict-free lane gathers
  const size_t tile = static_cast<size_t>(kTQ) * ds * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile <= kMaxTileBytes) {
    if (tile > 32 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          ell_accumulate_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(tile));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    ell_accumulate_kernel<true><<<grid, kWarps * 32, tile, s>>>(
        vals, cols, sq, coef, Z, inv_2s2, out, m, K, b, d, ds);
  } else {
    ell_accumulate_kernel<false><<<grid, kWarps * 32, 0, s>>>(
        vals, cols, sq, coef, Z, inv_2s2, out, m, K, b, d, ds);
  }
  return static_cast<int>(cudaGetLastError());
}
