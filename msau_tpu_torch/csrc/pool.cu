// 2x2 stride-2 max pool with TF-SAME padding on NCHW: an odd H or W is
// padded with -inf at the bottom / right, so the output is
// [N, C, ceil(H/2), ceil(W/2)] and a partial window takes the max of what
// it covers.
//
// Replaces the TPU kernel msau_tpu/ops/flatconv.py:_mp_fwd_kernel (launcher
// _flat_maxpool2_prim), which takes the row-pair max on Wp-chunks of the
// body layout and compacts the even columns with a 0/1 selection matmul on
// the MXU; odd sizes took an XLA fallback there (flatconv.py:2040-2047).
// One kernel covers both here.
//
// What bounds it on the H100: memory, one read of x and a quarter-size
// write (8 channels at 512^2: 8 MiB in, 2 MiB out in f32).  One thread per
// output pixel: adjacent threads read adjacent column pairs, so a warp
// reads 256 contiguous bytes of each of two rows and writes 128.  A NaN in
// a window propagates, as in torch's max_pool2d.

#include <stdint.h>

#include "common.cuh"

namespace {

using msau::store;
using msau::to_f32;

constexpr int kThreads = 256;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
maxpool2_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t total, int h,
                int w, int ho, int wo) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int ox = (int)(idx % wo);
  const int64_t t = idx / wo;
  const int oy = (int)(t % ho);
  const int64_t plane = t / ho;
  const T* xp = x + plane * h * (int64_t)w + (int64_t)(2 * oy) * w + 2 * ox;
  const bool right = 2 * ox + 1 < w, down = 2 * oy + 1 < h;
  float m = to_f32(xp[0]);
  if (right) m = nan_max(m, to_f32(xp[1]));
  if (down) {
    m = nan_max(m, to_f32(xp[w]));
    if (right) m = nan_max(m, to_f32(xp[w + 1]));
  }
  store(y + idx, m);
}

template <typename T>
int launch(const void* x, void* y, int nc, int h, int w, cudaStream_t stream) {
  const int ho = (h + 1) / 2, wo = (w + 1) / 2;
  const int64_t total = (int64_t)nc * ho * wo;
  if (total == 0) return 0;
  maxpool2_kernel<T><<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0,
                       stream>>>((const T*)x, (T*)y, total, h, w, ho, wo);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [nc, h, w]; y: [nc, ceil(h/2), ceil(w/2)], both f32 or both bf16.
extern "C" int msau_maxpool2(const void* x, void* y, int nc, int h, int w,
                             int is_bf16, void* stream) {
  if (nc < 0 || h < 0 || w < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch<__nv_bfloat16>(x, y, nc, h, w, s)
                 : launch<float>(x, y, nc, h, w, s);
}
