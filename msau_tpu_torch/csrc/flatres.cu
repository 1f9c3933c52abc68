// Fused residual block (res_depth 2, 3x3, Cin = Cout = C) on NCHW:
//
//   h1 = act(conv1(relu(x)) + b1)     rounded to the activation dtype
//   y  = act(conv2(h1) + b2 + x)
//
// with SAME padding for both convs: h1 is 0 outside the image (conv2 reads
// zero padding there, not act(b1)).  Accumulation and epilogues in f32.
//
// Replaces the TPU kernels msau_tpu/ops/flatres.py:_fwd_kernel and
// _fwd_kernel_al (launcher _fused_fwd_call; the _al body is the same
// function on the TPU's lane-aligned layout), which keep relu(x), the conv1
// output (in an x.dtype scratch) and the residual in VMEM; only x is read
// and y written.  The JAX package falls back to two flat convs where its
// VMEM gate fails; this kernel has no such gate.
//
// What bounds it on the H100: FP32 arithmetic, 2 * 9 * C^2 FMAs per pixel
// (plus ~20 % for conv1 over the tile's halo) against 2 * C values moved.
// Design: one block per 32-column x TH-row output tile of one image:
//   - relu(x) over the tile with a 2-pixel halo, both weight sets
//     ([ci][tap][co], f32) and the conv1 output over a 1-pixel halo all
//     live in shared memory (C = 32: 172.5 KB, one block per SM);
//   - conv1 runs over the (TH+2) x 34 halo tile, then conv2 over the tile;
//     each thread computes 2 vertically adjacent pixels x C channels
//     (2C accumulators), each weight load feeding 2 FMAs per channel;
//   - conv1 outputs outside the image are written as 0 (the SAME-padding
//     pitfall of the fused form, flatres.py:668-678), and rounded to the
//     activation dtype as the TPU kernel's scratch is;
//   - the residual x is re-read from global memory (L2) at the epilogue.

#include <stdint.h>

#include "common.cuh"

namespace {

using msau::apply_act;
using msau::load_row;
using msau::round_to;
using msau::store;
using msau::to_f32;

constexpr int kTw = 32;
constexpr int kTy = 4;
constexpr int kThreads = kTw * kTy;
constexpr int kPix = 2;   // vertically adjacent pixels per thread

// rows per block: C = 32 halves the tile to fit its weights in shared memory
template <int C>
__host__ __device__ constexpr int tile_h() { return C >= 32 ? 8 : 16; }

template <int C>
constexpr size_t smem_bytes() {
  constexpr int TH = tile_h<C>();
  return (size_t)(2 * C * 9 * C + C * (TH + 4) * (kTw + 4) + C * (TH + 2) * (kTw + 2)) *
         sizeof(float);
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
res_block_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                 const float* __restrict__ b1, const T* __restrict__ w2,
                 const float* __restrict__ b2, T* __restrict__ y, int h, int wd,
                 int act) {
  constexpr int TH = tile_h<C>();
  constexpr int XH = TH + 4, XW = kTw + 4;   // relu(x), origin (-2, -2)
  constexpr int HH = TH + 2, HW = kTw + 2;   // h1, origin (-1, -1)
  extern __shared__ __align__(16) float smem[];
  float* w1s = smem;             // [C][9][C]
  float* w2s = w1s + C * 9 * C;  // [C][9][C]
  float* xs = w2s + C * 9 * C;   // [C][XH][XW]
  float* hs = xs + C * XH * XW;  // [C][HH][HW]
  const int img = blockIdx.z;
  const int x0 = blockIdx.x * kTw, y0 = blockIdx.y * TH;
  const int64_t plane = (int64_t)h * wd;
  const T* xi = x + (int64_t)img * C * plane;

  for (int i = threadIdx.x; i < C * 9 * C; i += kThreads) {
    const int co = i % C, t = i / C;
    const int tap = t % 9, ci = t / 9;
    w1s[i] = to_f32(w1[(co * C + ci) * 9 + tap]);
    w2s[i] = to_f32(w2[(co * C + ci) * 9 + tap]);
  }
  for (int i = threadIdx.x; i < C * XH * XW; i += kThreads) {
    const int ci = i / (XH * XW), rem = i - ci * XH * XW;
    const int r = rem / XW, q = rem - r * XW;
    const int gy = y0 - 2 + r, gx = x0 - 2 + q;
    xs[i] = (gy >= 0 && gy < h && gx >= 0 && gx < wd)
                ? fmaxf(to_f32(xi[ci * plane + (int64_t)gy * wd + gx]), 0.f)
                : 0.f;
  }
  __syncthreads();

  // conv1 over h1 tile rows [0, HH) x cols [0, HW): image (y0-1+r, x0-1+q)
  for (int it = threadIdx.x; it < (HH / kPix) * HW; it += kThreads) {
    const int r0 = (it / HW) * kPix, q = it % HW;
    float acc[kPix][C];
#pragma unroll
    for (int i = 0; i < kPix; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
    for (int ci = 0; ci < C; ++ci) {
      const float* xc = xs + (ci * XH + r0) * XW + q;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        float wv[C];
        load_row(wv, w1s + (ci * 9 + tap) * C);
        const float* xr = xc + (tap / 3) * XW + tap % 3;
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          const float v = xr[i * XW];
#pragma unroll
          for (int c = 0; c < C; ++c) acc[i][c] = fmaf(v, wv[c], acc[i][c]);
        }
      }
    }
    const int gx = x0 - 1 + q;
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      const int gy = y0 - 1 + r0 + i;
      const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < wd;
#pragma unroll
      for (int c = 0; c < C; ++c)
        hs[(c * HH + r0 + i) * HW + q] =
            inside ? round_to<T>(apply_act(acc[i][c] + b1[c], act)) : 0.f;
    }
  }
  __syncthreads();

  // conv2 over the tile: lane = column, each warp takes pixel-row pairs
  const int tx = threadIdx.x % kTw, ty = threadIdx.x / kTw;
  const int gx = x0 + tx;
  for (int r0 = ty * kPix; r0 < TH; r0 += kTy * kPix) {
    float acc[kPix][C];
#pragma unroll
    for (int i = 0; i < kPix; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
    for (int ci = 0; ci < C; ++ci) {
      const float* hc = hs + (ci * HH + r0) * HW + tx;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        float wv[C];
        load_row(wv, w2s + (ci * 9 + tap) * C);
        const float* hr = hc + (tap / 3) * HW + tap % 3;
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          const float v = hr[i * HW];
#pragma unroll
          for (int c = 0; c < C; ++c) acc[i][c] = fmaf(v, wv[c], acc[i][c]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      const int gy = y0 + r0 + i;
      if (gy < h && gx < wd) {
        const int64_t off = (int64_t)gy * wd + gx;
#pragma unroll
        for (int c = 0; c < C; ++c)
          store(y + ((int64_t)img * C + c) * plane + off,
                apply_act(acc[i][c] + b2[c] + to_f32(xi[c * plane + off]), act));
      }
    }
  }
}

template <typename T, int C>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, void* y, int n, int h, int wd, int act,
           cudaStream_t stream) {
  constexpr int TH = tile_h<C>();
  constexpr size_t smem = smem_bytes<C>();
  cudaError_t err = msau::allow_smem(res_block_kernel<T, C>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((wd + kTw - 1) / kTw, (h + TH - 1) / TH, n);
  res_block_kernel<T, C><<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const T*)w1, (const float*)b1, (const T*)w2, (const float*)b2,
      (T*)y, h, wd, act);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w1, const void* b1, const void* w2,
             const void* b2, void* y, int n, int c, int h, int wd, int act,
             cudaStream_t s) {
  switch (c) {
    case 4: return launch<T, 4>(x, w1, b1, w2, b2, y, n, h, wd, act, s);
    case 8: return launch<T, 8>(x, w1, b1, w2, b2, y, n, h, wd, act, s);
    case 16: return launch<T, 16>(x, w1, b1, w2, b2, y, n, h, wd, act, s);
    case 32: return launch<T, 32>(x, w1, b1, w2, b2, y, n, h, wd, act, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: [n, c, h, w] with c in {4, 8, 16, 32}; w1, w2: [c, c, 3, 3] in the
// activation dtype; b1, b2: [c] f32; act: 1 relu, 2 elu.
extern "C" int msau_flat_res_block(const void* x, const void* w1, const void* b1,
                                   const void* w2, const void* b2, void* y, int n,
                                   int c, int h, int wd, int act, int is_bf16,
                                   void* stream) {
  if (n < 0 || n > 65535 || h < 0 || wd < 0 || act < 1 || act > 2)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || h == 0 || wd == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? dispatch<__nv_bfloat16>(x, w1, b1, w2, b2, y, n, c, h, wd, act, s)
                 : dispatch<float>(x, w1, b1, w2, b2, y, n, c, h, wd, act, s);
}
