// Backward of the fused residual block of flatres.cu (res_depth 2, 3x3,
// Cin = Cout = C, NCHW):
//
//   h0 = relu(x);  u = conv1(h0) + b1;  h1 = act(u) rounded, 0 off the image
//   v  = conv2(h1) + b2 + x;           y  = act(v)
//
// From the cotangent g of y it recomputes the block over a halo of 4 (the
// backward's effective window is 9 x 9) and emits dx, dw1, db1, dw2, db2:
//   gv2 = g act'(v)                       (0 off the image)
//   gu  = conv2^T(gv2 rounded) act'(u)    (0 off the image: h1 is a constant
//                                          0 there, so nothing flows into u)
//   dx  = conv1^T(gu rounded) [x > 0] + gv2
//   dw2 = sum h1 (x) gv2 rounded, db2 = sum gv2;
//   dw1 = sum h0 (x) gu rounded,  db1 = sum gu
// each conv's weight gradient summed over its own output pixels.  Rounding
// as the TPU kernel: g arrives in the activation dtype, h1 and the
// cotangents that feed a conv or a weight gradient are rounded to it, the
// residual term and the bias gradients stay f32, every sum is f32.
//
// Replaces the TPU kernels msau_tpu/ops/flatres.py:_bwd_kernel and
// _bwd_kernel_al (launcher _fused_vjp_bwd; the _al body is the same
// function on the TPU's lane-aligned layout), which accumulate dw and db
// in place across a sequential grid.  Here the grid runs in parallel: a
// grid of at most kPartialBlocks blocks walks the tiles, each block adds
// its tiles in order into its own f32 partial row, and sum_partials
// (common.cuh) adds the rows in block order, so the same inputs give the
// same bits.
//
// What bounds it on the H100: FP32 arithmetic: four 3x3 convs, two of them
// over a halo, and two weight gradients, each 9 C^2 FMAs per pixel.
// Design: one block per 32-column x TH-row tile; relu(x) over the tile
// with a 4-pixel halo, h1 over a 3-pixel halo, gv2 over 2 and u (then gu)
// over 1 live in shared memory, channel-major, next to the weights of the
// conv being run ([ci][tap][co]); at C = 32 the tile is 4 rows (205 KB),
// at 16 8 rows, at 8 and 4 16 rows.  Each conv stage gives a thread two
// vertically adjacent output pixels x C channels (2C accumulators), as the
// forward does; a weight gradient gives a thread an (input channel, tap)
// pair with C output channels in registers.

#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

using msau::act_grad;
using msau::apply_act;
using msau::load_row;
using msau::round_to;
using msau::store;
using msau::to_f32;

constexpr int kTw = 32;
constexpr int kThreads = 128;

template <int C>
__host__ __device__ constexpr int tile_h() { return C >= 32 ? 4 : C >= 16 ? 8 : 16; }

// region rows / columns (channel-major, per channel)
template <int C> struct Regions {
  static constexpr int TH = tile_h<C>();
  static constexpr int AH = TH + 8, AW = kTw + 8;   // h0, origin (-4, -4)
  static constexpr int BH = TH + 6, BW = kTw + 6;   // h1, origin (-3, -3)
  static constexpr int GH = TH + 4, GW = kTw + 4;   // gv2, origin (-2, -2)
  static constexpr int UH = TH + 2, UW = kTw + 2;   // u, then gu, (-1, -1)
  static constexpr int W = 9 * C * C;
  static constexpr int A = C * AH * AW, B = C * BH * BW, G = C * GH * GW,
                       U = C * UH * UW;
  static constexpr size_t bytes = (size_t)(W + A + B + G + U) * sizeof(float);
};

// Stages weights of a conv as [in][tap][out]: transposed = false gives
// conv's own taps (in = ci, out = co) of w [co][ci][3][3]; true the taps
// of its transposed conv (in = co, out = ci, taps flipped).
template <typename T, int C>
__device__ inline void stage_w(float* ws, const T* __restrict__ w, bool transposed) {
  for (int i = threadIdx.x; i < 9 * C * C; i += kThreads) {
    const int o = i % C, t = i / C;
    const int tap = t % 9, in = t / 9;
    ws[i] = transposed ? to_f32(w[(in * C + o) * 9 + 8 - tap])
                       : to_f32(w[(o * C + in) * 9 + tap]);
  }
}

// A 3x3 conv over an oh x ow output region whose source region (channel-
// major, sh x sw per channel) starts one pixel up and left of it; each
// source value goes through ``rd`` (a rounding) and each output pixel's C
// sums through ``epi(r, q, acc)``.
template <int C, typename Rd, typename Epi>
__device__ inline void conv_region(const float* src, int sh, int sw, const float* ws,
                                   int oh, int ow, Rd rd, Epi epi) {
  for (int it = threadIdx.x; it < (oh / 2) * ow; it += kThreads) {
    const int r0 = (it / ow) * 2, q = it % ow;
    float acc[2][C];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
    for (int ci = 0; ci < C; ++ci) {
      const float* sc = src + (ci * sh + r0) * sw + q;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        float wv[C];
        load_row(wv, ws + (ci * 9 + tap) * C);
        const float* sr = sc + (tap / 3) * sw + tap % 3;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float v = rd(sr[i * sw]);
#pragma unroll
          for (int c = 0; c < C; ++c) acc[i][c] = fmaf(v, wv[c], acc[i][c]);
        }
      }
    }
    epi(r0, q, acc[0]);
    epi(r0 + 1, q, acc[1]);
  }
}

// part[(co * C + ci) * 9 + tap] (+)= sum over the tile's pixels of
// gsrc[co] (rounded) * xsrc[ci] at the tap's offset; gsrc / xsrc are
// channel-major regions whose (0, 0) pixel lies at (g0r, g0q) / (x0r, x0q)
// of their own grid, the tap (ky, kx) offset (ky - 1, kx - 1).
template <typename T, int C>
__device__ inline void weight_grad(float* part, bool first, const float* xsrc, int xh,
                                   int xw, int x0r, int x0q, const float* gsrc, int gh,
                                   int gw, int g0r, int g0q, int th) {
  for (int it = threadIdx.x; it < 9 * C; it += kThreads) {
    const int ci = it / 9, tap = it % 9;
    const float* xc = xsrc + (ci * xh + x0r + tap / 3 - 1) * xw + x0q + tap % 3 - 1;
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;
    for (int r = 0; r < th; ++r) {
      for (int q = 0; q < kTw; ++q) {
        const float xv = xc[r * xw + q];
        const float* gp = gsrc + (g0r + r) * gw + g0q + q;
#pragma unroll
        for (int c = 0; c < C; ++c)
          acc[c] = fmaf(xv, round_to<T>(gp[c * gh * gw]), acc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float* dst = part + (c * C + ci) * 9 + tap;
      *dst = first ? acc[c] : *dst + acc[c];
    }
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
res_block_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                     const T* __restrict__ w1, const float* __restrict__ b1,
                     const T* __restrict__ w2, const float* __restrict__ b2,
                     T* __restrict__ dx, float* __restrict__ partial, int h, int wd,
                     int act, int tiles_x, int tiles_y, int n_tiles) {
  using R = Regions<C>;
  constexpr int TH = R::TH;
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;
  float* A = ws + R::W;
  float* B = A + R::A;
  float* G = B + R::B;
  float* U = G + R::G;
  const int64_t plane = (int64_t)h * wd;
  const int64_t stride = 2 * (9 * C * C + C);
  float* __restrict__ part = partial + (int64_t)blockIdx.x * stride;
  float db = 0.f;   // thread t: db1[t] for t < C, db2[t - C] for t < 2C
  const auto keep = [](float v) { return v; };
  const auto rnd = [](float v) { return round_to<T>(v); };

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    const int img = tile / (tiles_x * tiles_y), t2 = tile % (tiles_x * tiles_y);
    const int x0 = (t2 % tiles_x) * kTw, y0 = (t2 / tiles_x) * TH;
    const T* xi = x + (int64_t)img * C * plane;
    const T* gi = g + (int64_t)img * C * plane;
    const auto inside = [&](int gy, int gx) {
      return gy >= 0 && gy < h && gx >= 0 && gx < wd;
    };

    __syncthreads();   // the previous tile's readers are done
    for (int i = threadIdx.x; i < R::A; i += kThreads) {
      const int c = i / (R::AH * R::AW), rem = i % (R::AH * R::AW);
      const int gy = y0 - 4 + rem / R::AW, gx = x0 - 4 + rem % R::AW;
      A[i] = inside(gy, gx) ? fmaxf(to_f32(xi[c * plane + (int64_t)gy * wd + gx]), 0.f)
                            : 0.f;
    }
    stage_w<T, C>(ws, w1, false);
    __syncthreads();
    // conv1 -> h1 (rounded, 0 off the image) and u over U's region
    conv_region<C>(A, R::AH, R::AW, ws, R::BH, R::BW, keep,
                   [&](int r, int q, const float (&v)[C]) {
      const bool in = inside(y0 - 3 + r, x0 - 3 + q);
      const bool in_u = r >= 2 && r < R::UH + 2 && q >= 2 && q < R::UW + 2;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float u = v[c] + b1[c];
        B[(c * R::BH + r) * R::BW + q] = in ? round_to<T>(apply_act(u, act)) : 0.f;
        if (in_u) U[(c * R::UH + r - 2) * R::UW + q - 2] = u;
      }
    });
    __syncthreads();
    stage_w<T, C>(ws, w2, false);
    __syncthreads();
    // conv2 -> gv2 = g act'(v), 0 off the image
    conv_region<C>(B, R::BH, R::BW, ws, R::GH, R::GW, keep,
                   [&](int r, int q, const float (&v)[C]) {
      const int gy = y0 - 2 + r, gx = x0 - 2 + q;
      const bool in = inside(gy, gx);
      const int64_t off = in ? (int64_t)gy * wd + gx : 0;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float gv = 0.f;
        if (in) {
          const float pre = v[c] + b2[c] + to_f32(xi[c * plane + off]);
          gv = to_f32(gi[c * plane + off]) * act_grad(pre, act);
        }
        G[(c * R::GH + r) * R::GW + q] = gv;
      }
    });
    __syncthreads();
    stage_w<T, C>(ws, w2, true);
    __syncthreads();
    // conv2^T -> gu = (conv2^T gv2) act'(u), 0 off the image, over U
    conv_region<C>(G, R::GH, R::GW, ws, R::UH, R::UW, rnd,
                   [&](int r, int q, const float (&v)[C]) {
      const bool in = inside(y0 - 1 + r, x0 - 1 + q);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float* up = U + (c * R::UH + r) * R::UW + q;
        *up = in ? v[c] * act_grad(*up, act) : 0.f;
      }
    });
    __syncthreads();
    stage_w<T, C>(ws, w1, true);
    __syncthreads();
    // conv1^T -> dx = (conv1^T gu) [x > 0] + gv2 over the tile
    conv_region<C>(U, R::UH, R::UW, ws, TH, kTw, rnd,
                   [&](int r, int q, const float (&v)[C]) {
      const int gy = y0 + r, gx = x0 + q;
      if (gy >= h || gx >= wd) return;
      const int64_t off = (int64_t)gy * wd + gx;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float xv = to_f32(xi[c * plane + off]);
        store(dx + ((int64_t)img * C + c) * plane + off,
              (xv > 0.f ? v[c] : 0.f) + G[(c * R::GH + r + 2) * R::GW + q + 2]);
      }
    });
    // weight gradients over the tile's own pixels
    weight_grad<T, C>(part, first, A, R::AH, R::AW, 4, 4, U, R::UH, R::UW, 1, 1, TH);
    weight_grad<T, C>(part + 9 * C * C + C, first, B, R::BH, R::BW, 3, 3, G, R::GH,
                      R::GW, 2, 2, TH);
    if ((int)threadIdx.x < 2 * C) {
      const int c = threadIdx.x % C;
      const float* src = threadIdx.x < C ? U + (c * R::UH + 1) * R::UW + 1
                                         : G + (c * R::GH + 2) * R::GW + 2;
      const int sw = threadIdx.x < C ? R::UW : R::GW;
      float sum = 0.f;
      for (int r = 0; r < TH; ++r)
        for (int q = 0; q < kTw; ++q) sum += src[r * sw + q];
      db += sum;
    }
  }
  if ((int)threadIdx.x < 2 * C) {
    const int c = threadIdx.x % C;
    part[threadIdx.x < C ? 9 * C * C + c : 2 * 9 * C * C + C + c] = db;
  }
}

template <typename T, int C>
int launch(const void* x, const void* g, const void* w1, const void* b1,
           const void* w2, const void* b2, void* dx, void* partial, void* out, int n,
           int h, int wd, int act, cudaStream_t stream) {
  constexpr int TH = tile_h<C>();
  constexpr size_t smem = Regions<C>::bytes;
  cudaError_t err = msau::allow_smem(res_block_bwd_kernel<T, C>, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (wd + kTw - 1) / kTw, tiles_y = (h + TH - 1) / TH;
  const int64_t n_tiles = (int64_t)n * tiles_x * tiles_y;
  if (n_tiles > (1 << 30)) return (int)cudaErrorInvalidValue;
  const int blocks = (int)std::min<int64_t>(n_tiles, msau::kPartialBlocks);
  res_block_bwd_kernel<T, C><<<blocks, kThreads, smem, stream>>>(
      (const T*)x, (const T*)g, (const T*)w1, (const float*)b1, (const T*)w2,
      (const float*)b2, (T*)dx, (float*)partial, h, wd, act, tiles_x, tiles_y,
      (int)n_tiles);
  const int code = (int)cudaGetLastError();
  if (code != 0) return code;
  return msau::sum_partials((const float*)partial, blocks, 2 * (9 * C * C + C),
                            (float*)out, stream);
}

template <typename T>
int dispatch(const void* x, const void* g, const void* w1, const void* b1,
             const void* w2, const void* b2, void* dx, void* partial, void* out, int n,
             int c, int h, int wd, int act, cudaStream_t s) {
  switch (c) {
    case 4: return launch<T, 4>(x, g, w1, b1, w2, b2, dx, partial, out, n, h, wd, act, s);
    case 8: return launch<T, 8>(x, g, w1, b1, w2, b2, dx, partial, out, n, h, wd, act, s);
    case 16: return launch<T, 16>(x, g, w1, b1, w2, b2, dx, partial, out, n, h, wd, act, s);
    case 32: return launch<T, 32>(x, g, w1, b1, w2, b2, dx, partial, out, n, h, wd, act, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, g, dx: [n, c, h, w] with c in {4, 8, 16, 32}; w1, w2: [c, c, 3, 3] in
// the activation dtype; b1, b2: [c] f32; act: 1 relu, 2 elu; partial: f32
// scratch of kPartialBlocks * 2 * (9 c^2 + c) floats; out: f32
// [2 * (9 c^2 + c)]: dw1 (OIHW), db1, dw2 (OIHW), db2.
extern "C" int msau_flat_res_block_bwd(const void* x, const void* g, const void* w1,
                                       const void* b1, const void* w2, const void* b2,
                                       void* dx, void* partial, void* out, int n, int c,
                                       int h, int wd, int act, int is_bf16,
                                       void* stream) {
  if (n < 0 || h < 0 || wd < 0 || act < 1 || act > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0 || h == 0 || wd == 0)
    return (int)cudaMemsetAsync(out, 0, 2 * (9 * (size_t)c * c + c) * sizeof(float), s);
  return is_bf16 ? dispatch<__nv_bfloat16>(x, g, w1, b1, w2, b2, dx, partial, out, n,
                                           c, h, wd, act, s)
                 : dispatch<float>(x, g, w1, b1, w2, b2, dx, partial, out, n, c, h,
                                   wd, act, s);
}
