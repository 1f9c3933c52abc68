// Helpers shared by the port's kernels: f32 <-> storage-type conversion and
// vector loads from shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace msau {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// N consecutive floats of shared memory into registers; 16-byte loads when
// N is a multiple of 4 (``src`` must then be 16-byte aligned).
template <int N>
__device__ __forceinline__ void load_row(float (&dst)[N], const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N; q += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + q);
      dst[q] = v.x;
      dst[q + 1] = v.y;
      dst[q + 2] = v.z;
      dst[q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) dst[q] = src[q];
  }
}

constexpr int cmax(int a, int b) { return a > b ? a : b; }

}  // namespace msau
