// Loads of stored support-vector values, widened to fp32, for the two
// serve-time accumulates (rbf_accumulate.cu, ell_accumulate.cu). SVs are
// stored as fp32 or as bf16; a bf16 value is the top 16 bits of an fp32
// one, so widening is a shift and exact: a kernel that reads bf16 SVs
// through these loads computes on the same fp32 values, bit for bit, as on
// the fp32 copy of those SVs.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sv_load {

__device__ __forceinline__ float widen(unsigned short u) {
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}

// One value.
__device__ __forceinline__ float one(const float* p) { return __ldg(p); }
__device__ __forceinline__ float one(const __nv_bfloat16* p) {
  return widen(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

// Four consecutive values from p in one load: 16 bytes (fp32) or 8 bytes
// (bf16, widened), which needs p aligned to that.
__device__ __forceinline__ float4 four(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 four(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  // little-endian: element 0 is the low half of u.x
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// Whether rows of `width` values of T starting at p take four() loads:
// the width a multiple of 4 and p aligned to 4 values.
template <typename T>
inline bool vec_ok(const T* p, int width) {
  return width % 4 == 0 &&
         reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
}

}  // namespace sv_load
