// Grid sizing by occupancy, shared by the row kernels of this directory
// (rbf_rows.cu, ell_rows.cu): a grid-strided kernel launches as many blocks
// as the card holds at once, and no more.
#pragma once

#include <cuda_runtime.h>

namespace occupancy {

// Blocks of `kernel` (kThreads threads each, `smem` bytes of dynamic shared
// memory) resident at once: min(occupancy, kBlocksPerSm) per SM, times the
// SMs; cached in *cached_smem / *cached_blocks for the last size asked.
template <int kThreads, int kBlocksPerSm, typename Kernel>
int resident_blocks(Kernel kernel, int smem, int* cached_smem,
                    int* cached_blocks) {
  if (*cached_smem == smem) return *cached_blocks;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                smem);
  per_sm = per_sm < 1 ? 1 : per_sm > kBlocksPerSm ? kBlocksPerSm : per_sm;
  *cached_smem = smem;
  *cached_blocks = per_sm * (sms > 0 ? sms : 1);
  return *cached_blocks;
}

}  // namespace occupancy
