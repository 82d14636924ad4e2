// PTX wrappers for Hopper's asynchronous copies and shared-memory barriers
// (sm_90a), shared by the kernels of this directory.
//
//   cp.async (16 or 4 bytes a thread, commit / wait groups): per-thread
//     copies from device to shared memory that stay in flight while the
//     thread computes (rbf_rows.cu's ring over X, the cols ell_accumulate.cu
//     compacts).
//   mbarrier: a barrier in shared memory that counts thread arrivals and,
//     for TMA, the bytes still to land (flash_attention.cu's full / empty
//     ring barriers).
//   TMA (cp.async.bulk.tensor): one thread asks for a whole tile, described
//     by a CUtensorMap; the hardware computes the addresses, swizzles the
//     tile into shared memory, zero-fills what lies outside the tensor and
//     reports the bytes to an mbarrier.
#pragma once

#include <cstdint>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- cp.async ----------------------------------------------------------------

// 16 bytes; both addresses 16-byte aligned. Bypasses L1 (streamed data).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// 4 bytes; both addresses 4-byte aligned.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// -- mbarrier ----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrive and announce `bytes` of TMA traffic that must land before the
// barrier's phase completes.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Spin until the barrier's current phase parity differs from `parity`, i.e.
// until the phase numbered `parity` (mod 2) has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// -- TMA ---------------------------------------------------------------------

// Load the box at coordinates (c0, c1, c2) of the 3-D tensor map `map` (a
// __grid_constant__ kernel parameter) into shared memory at `dst`,
// completing `bytes` on `bar`.
__device__ __forceinline__ void tma_load3d(uint32_t dst, const void* map,
                                           int c0, int c1, int c2,
                                           uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

}  // namespace sm90
