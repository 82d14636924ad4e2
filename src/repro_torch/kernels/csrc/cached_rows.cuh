// The row cache's hit path, shared by the two-row kernels of this directory
// (rbf_rows.cu: rbf_rows2, ell_rows.cu: ell_kernel_rows2).
//
// The SMO segment never waits for the card (core/smo.py), so the host
// cannot skip a launch when the cache holds both rows of a pair. The cached
// entry of a two-row kernel launches in every case and reads a device flag
// instead: on a hit every block copies the two table rows into its share of
// out, out[i, j] = vals[slot2[j], i], and returns before it loads anything
// else (16 bytes a buffer row, against the row pass's whole buffer); on a
// miss it runs the normal entry's body, so a miss gives that entry's bits.
// The flag is the same for every block, so a launch takes one path.
#pragma once

#include <cuda_runtime.h>

namespace cached_rows {

struct Table {
  const float* vals = nullptr;  // (S, ld) f32: the cache's value table
  const int* slot2 = nullptr;   // (2,) i32: the slots of the two rows
  const int* hit = nullptr;     // i32: nonzero when both rows are cached;
                                // nullptr for the normal entries
  long ld = 0;                  // floats from one table row to the next

  __device__ __forceinline__ bool is_hit() const {
    return hit != nullptr && __ldg(hit) != 0;
  }

  // out (n, 2) from the two table rows, grid-strided over the rows.
  __device__ __forceinline__ void serve(float* out, int n) const {
    const float* r0 = vals + static_cast<long>(__ldg(slot2)) * ld;
    const float* r1 = vals + static_cast<long>(__ldg(slot2 + 1)) * ld;
    const long step = static_cast<long>(gridDim.x) * blockDim.x;
    for (long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < n; i += step)
      reinterpret_cast<float2*>(out)[i] = make_float2(__ldg(r0 + i),
                                                      __ldg(r1 + i));
  }
};

}  // namespace cached_rows
