// The 64-bit key through which the max/min kernels (spmm_minmax_v4.cu, K3,
// and spmm_minmax.cu, K7) combine candidates with atomicMax:
//     key = (ordered(w) << 32) | (0xFFFFFFFF - e)
// where ordered() maps fp32 order onto unsigned order.  The larger product
// w wins and, between equal products, the lower edge id e.  -0.0 is made
// +0.0 first, so the two zeros tie (they compare equal in the reference) and
// the lower id wins between them.  Key 0 is no candidate: no finite w and
// valid id encode to it.

#pragma once

#include <stdint.h>

__device__ __forceinline__ unsigned long long minmax_key(float w, int e) {
  if (w == 0.f) w = 0.f;  // -0.0 -> +0.0
  unsigned u = __float_as_uint(w);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) |
         (0xffffffffu - static_cast<unsigned>(e));
}

// The product a key was made from (a zero as +0.0).
__device__ __forceinline__ float minmax_key_value(unsigned long long key) {
  unsigned u = static_cast<unsigned>(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
}

__device__ __forceinline__ int minmax_key_id(unsigned long long key) {
  return static_cast<int>(0xffffffffu -
                          static_cast<unsigned>(key & 0xffffffffull));
}
