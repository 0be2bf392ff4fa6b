// Lane loads and stores shared by the region kernels.
//
// A region row is n4 packed uint32 lanes.  Each thread owns V
// consecutive lanes of every row: one 4*V-byte load when the rows are
// aligned for it (`vec`, from aligned_rows), else V masked scalar loads,
// so any n4 >= 1 works and the ragged tail is masked here, not by the
// caller.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Whether every row of `in` and `out` (n4 lanes each) starts on a
// 4*V-byte boundary, so that V lanes move in one vector access.
template <int V>
inline int aligned_rows(const void* in, const void* out, long long n4) {
  const uintptr_t a = 4 * V;
  return n4 % V == 0 && reinterpret_cast<uintptr_t>(in) % a == 0 &&
         reinterpret_cast<uintptr_t>(out) % a == 0;
}

template <int V>
__device__ __forceinline__ void load_lanes(const uint32_t* __restrict__ row,
                                           long long c0, long long n4,
                                           bool vec, uint32_t (&x)[V]) {
  if (vec && c0 + V <= n4) {
    if constexpr (V == 4) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(row + c0));
      x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
      return;
    } else if constexpr (V == 2) {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(row + c0));
      x[0] = q.x; x[1] = q.y;
      return;
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) x[v] = (c0 + v < n4) ? __ldg(row + c0 + v) : 0u;
}

template <int V>
__device__ __forceinline__ void store_lanes(uint32_t* __restrict__ row,
                                            long long c0, long long n4,
                                            bool vec, const uint32_t (&x)[V]) {
  if (vec && c0 + V <= n4) {
    if constexpr (V == 4) {
      *reinterpret_cast<uint4*>(row + c0) = make_uint4(x[0], x[1], x[2], x[3]);
      return;
    } else if constexpr (V == 2) {
      *reinterpret_cast<uint2*>(row + c0) = make_uint2(x[0], x[1]);
      return;
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v)
    if (c0 + v < n4) row[c0 + v] = x[v];
}
