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
//
// The backward (msau_maxpool2_bwd) replaces _mp_bwd_kernel (launcher
// _flat_maxpool2_bwd) and computes what the JAX package computes for each
// size, with one thread per window writing all four of its dx entries:
//   - even H and W (the Pallas kernel, and _pool2_even_bwd): the gradient
//     goes to one element, chosen column first: the column whose row-pair
//     max is larger, a tie to the even column; then in that column the
//     lower row only if it is strictly larger (flatconv.py:1929-1938,
//     :1790-1800).  [[1, 5], [5, 0]] sends it to the bottom left;
//   - an odd H or W (jnp.max over the -inf-padded reshape, :2040-2046):
//     the gradient is split evenly over the elements equal to the max.
// Memory-bound like the forward: x and dx at full size, g at a quarter.

#include <math.h>
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
maxpool2_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    T* __restrict__ dx, int64_t total, int h, int w, int ho, int wo) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int ox = (int)(idx % wo);
  const int64_t t = idx / wo;
  const int oy = (int)(t % ho);
  const int64_t plane = t / ho;
  const int64_t base = plane * h * (int64_t)w + (int64_t)(2 * oy) * w + 2 * ox;
  const bool right = 2 * ox + 1 < w, down = 2 * oy + 1 < h;
  const float gv = to_f32(g[idx]);
  float v[4] = {to_f32(x[base]), right ? to_f32(x[base + 1]) : -INFINITY,
                down ? to_f32(x[base + w]) : -INFINITY,
                right && down ? to_f32(x[base + w + 1]) : -INFINITY};
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  if ((h % 2) == 0 && (w % 2) == 0) {
    // row-pair max per column, the column (ties even), then the row
    // (ties upper)
    const float r0 = fmaxf(v[0], v[2]), r1 = fmaxf(v[1], v[3]);
    const int col = r0 >= r1 ? 0 : 1;
    d[v[col] >= v[col + 2] ? col : col + 2] = gv;
  } else {
    const float m = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
    int count = 0;
    for (int i = 0; i < 4; ++i) count += v[i] == m;
    for (int i = 0; i < 4; ++i) d[i] = v[i] == m ? gv / (float)count : 0.f;
  }
  store(dx + base, d[0]);
  if (right) store(dx + base + 1, d[1]);
  if (down) store(dx + base + w, d[2]);
  if (right && down) store(dx + base + w + 1, d[3]);
}

template <typename T>
int launch_bwd(const void* x, const void* g, void* dx, int nc, int h, int w,
               cudaStream_t stream) {
  const int ho = (h + 1) / 2, wo = (w + 1) / 2;
  const int64_t total = (int64_t)nc * ho * wo;
  if (total == 0) return 0;
  maxpool2_bwd_kernel<T><<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0,
                           stream>>>((const T*)x, (const T*)g, (T*)dx, total, h, w,
                                     ho, wo);
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

// x, dx: [nc, h, w]; g: [nc, ceil(h/2), ceil(w/2)]; all f32 or all bf16.
extern "C" int msau_maxpool2_bwd(const void* x, const void* g, void* dx, int nc, int h,
                                 int w, int is_bf16, void* stream) {
  if (nc < 0 || h < 0 || w < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch_bwd<__nv_bfloat16>(x, g, dx, nc, h, w, s)
                 : launch_bwd<float>(x, g, dx, nc, h, w, s);
}
