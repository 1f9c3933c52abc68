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
// size:
//   - even H and W (the Pallas kernel, and _pool2_even_bwd): the gradient
//     goes to one element, chosen column first: the column whose row-pair
//     max is larger, a tie to the even column; then in that column the
//     lower row only if it is strictly larger (flatconv.py:1929-1938,
//     :1790-1800).  [[1, 5], [5, 0]] sends it to the bottom left;
//   - an odd H or W (jnp.max over the -inf-padded reshape, :2040-2046):
//     the gradient is split evenly over the elements equal to the max.
// Memory-bound like the forward: x and dx at full size, g at a quarter
// (the flagship's 8 channels at 512^2, batch 16, move 302 MB in f32: 0.090
// ms at 3.35 TB/s; each smaller scale half that).  Even sizes whose rows
// are whole 16-byte pieces (W a multiple of 4 in f32, 8 in bf16, aligned
// bases) take maxpool2_bwd_vec_kernel: a thread owns a 16-byte piece of a
// row pair (2 windows in f32, 4 in bf16), so a warp reads and writes 512
// contiguous bytes of each row and 256 of g per instruction; it takes
// kUnroll pieces a block's width apart, their loads all issued before the
// first store, with 32-bit indices from a grid of (pieces of a plane,
// plane).  g or 0 is written as it is read, so the routing is bit-exact.
// Odd sizes, other widths and misaligned bases take maxpool2_bwd_kernel,
// one thread per window.

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

constexpr int kUnroll = 4;   // 16-byte pieces per thread in the vector path

// 16 bytes of x or dx (V = 16 / sizeof(T) columns, V / 2 windows) and the
// 8 bytes of g that go with them, as 32-bit words
template <typename T>
struct PoolPiece {
  static constexpr int V = 16 / (int)sizeof(T);
  uint4 top, bot;
  uint2 g;
};

// window k's four values (top left, top right, bottom left, bottom right)
// from a piece's rows as floats, and its gradient's bits
__device__ __forceinline__ void window(const PoolPiece<float>& p, int k, float (&v)[4],
                                       unsigned& gb) {
  const unsigned t[4] = {p.top.x, p.top.y, p.top.z, p.top.w};
  const unsigned b[4] = {p.bot.x, p.bot.y, p.bot.z, p.bot.w};
  v[0] = __uint_as_float(t[2 * k]);
  v[1] = __uint_as_float(t[2 * k + 1]);
  v[2] = __uint_as_float(b[2 * k]);
  v[3] = __uint_as_float(b[2 * k + 1]);
  gb = k == 0 ? p.g.x : p.g.y;
}
__device__ __forceinline__ void window(const PoolPiece<__nv_bfloat16>& p, int k, float (&v)[4],
                                       unsigned& gb) {
  const unsigned t[4] = {p.top.x, p.top.y, p.top.z, p.top.w};
  const unsigned b[4] = {p.bot.x, p.bot.y, p.bot.z, p.bot.w};
  // a bf16 is the high half of the f32 of the same value
  v[0] = __uint_as_float(t[k] << 16);
  v[1] = __uint_as_float(t[k] & 0xffff0000u);
  v[2] = __uint_as_float(b[k] << 16);
  v[3] = __uint_as_float(b[k] & 0xffff0000u);
  gb = ((k < 2 ? p.g.x : p.g.y) >> (16 * (k & 1))) & 0xffffu;
}
// window k's dx words: gb at position at (0-3 as in window), 0 elsewhere
__device__ __forceinline__ void put(unsigned (&t)[4], unsigned (&b)[4], int k, int at,
                                    unsigned gb, float) {
  t[2 * k] = at == 0 ? gb : 0u;
  t[2 * k + 1] = at == 1 ? gb : 0u;
  b[2 * k] = at == 2 ? gb : 0u;
  b[2 * k + 1] = at == 3 ? gb : 0u;
}
__device__ __forceinline__ void put(unsigned (&t)[4], unsigned (&b)[4], int k, int at,
                                    unsigned gb, __nv_bfloat16) {
  t[k] = (at == 0 ? gb : 0u) | (at == 1 ? gb << 16 : 0u);
  b[k] = (at == 2 ? gb : 0u) | (at == 3 ? gb << 16 : 0u);
}

// Even H and W, W a multiple of V: grid (pieces of a plane / (kThreads
// kUnroll), planes, looped past 65535).  Per plane, piece p of row pair oy
// covers columns V (p % (W / V)) .. of input rows 2 oy, 2 oy + 1.
template <typename T>
__global__ void __launch_bounds__(kThreads)
maxpool2_bwd_vec_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ dx,
                        int nc, int w, int ho) {
  constexpr int V = PoolPiece<T>::V;
  const int per_row = w / V, pieces = ho * per_row, wo = w / 2;
  for (int plane = blockIdx.y; plane < nc; plane += gridDim.y) {
    const int64_t xbase = (int64_t)plane * 2 * ho * w;
    const int64_t gbase = (int64_t)plane * ho * wo;
    PoolPiece<T> p[kUnroll];
    int xo[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = (blockIdx.x * kUnroll + u) * kThreads + threadIdx.x;
      xo[u] = -1;
      if (e < pieces) {
        const int oy = e / per_row, c = e - oy * per_row;
        xo[u] = 2 * oy * w + c * V;
        const T* xp = x + xbase + xo[u];
        p[u].top = *reinterpret_cast<const uint4*>(xp);
        p[u].bot = *reinterpret_cast<const uint4*>(xp + w);
        p[u].g = *reinterpret_cast<const uint2*>(g + gbase + oy * wo + c * (V / 2));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (xo[u] < 0) continue;
      unsigned top[4], bot[4];
#pragma unroll
      for (int k = 0; k < V / 2; ++k) {
        float v[4];
        unsigned gb;
        window(p[u], k, v, gb);
        // row-pair max per column, the column (ties even), then the row
        // (ties upper), as maxpool2_bwd_kernel
        const bool left = fmaxf(v[0], v[2]) >= fmaxf(v[1], v[3]);
        const bool up = left ? v[0] >= v[2] : v[1] >= v[3];
        put(top, bot, k, (left ? 0 : 1) + (up ? 0 : 2), gb, T());
      }
      T* dp = dx + xbase + xo[u];
      *reinterpret_cast<uint4*>(dp) = make_uint4(top[0], top[1], top[2], top[3]);
      *reinterpret_cast<uint4*>(dp + w) = make_uint4(bot[0], bot[1], bot[2], bot[3]);
    }
  }
}

template <typename T>
int launch_bwd(const void* x, const void* g, void* dx, int nc, int h, int w,
               cudaStream_t stream) {
  const int ho = (h + 1) / 2, wo = (w + 1) / 2;
  const int64_t total = (int64_t)nc * ho * wo;
  if (total == 0) return 0;
  constexpr int V = PoolPiece<T>::V;
  const bool aligned = ((uintptr_t)x % 16 | (uintptr_t)dx % 16 | (uintptr_t)g % 8) == 0;
  if (h % 2 == 0 && w % V == 0 && aligned && (int64_t)h * w < INT32_MAX) {
    const int pieces = ho * (w / V), per_block = kThreads * kUnroll;
    const dim3 grid((pieces + per_block - 1) / per_block, nc < 65535 ? nc : 65535);
    maxpool2_bwd_vec_kernel<T><<<grid, kThreads, 0, stream>>>((const T*)x, (const T*)g,
                                                               (T*)dx, nc, w, ho);
    return (int)cudaGetLastError();
  }
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
