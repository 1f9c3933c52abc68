// The stride-1 KH x KW conv over one output tile, shared by the forward
// conv (flatconv.cu) and the conv backward (flatconv_bwd.cu), which
// recomputes the preactivation.  A block of kThreads threads owns a
// 32-column x (kTy * PIX)-row output tile; thread (tx, ty) owns column
// x0 + tx and rows y0 + ty * PIX + [0, PIX), with COUT output channels of
// each in registers.  Input channels are staged kCi at a time, with the
// dilated halo, in shared memory as f32 ([kCi][ih][iw]), their weights
// beside them as [ci][tap][co] so a thread reads one tap's COUT weights as
// 16-byte broadcast loads.  The input may be two tensors [a; b] read as
// their channel concat.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace msau {

constexpr int kTw = 32;       // output columns per tile: one per lane
constexpr int kTy = 4;        // warps per block
constexpr int kThreads = kTw * kTy;
constexpr int kCi = 8;        // input channels staged per chunk

struct ConvIn {
  const void* a;
  const void* b;
  const void* w;       // [cout, ca + cb, kh, kw] in the activation dtype
  int ca, cb, h, w_, cout, kh, kw, dil, pt, pleft;
};

// input tile rows / columns (with the halo) of a th-row tile
__host__ __device__ inline int tile_ih(const ConvIn& p, int th) {
  return th + (p.kh - 1) * p.dil;
}
__host__ __device__ inline int tile_iw(const ConvIn& p) {
  return kTw + (p.kw - 1) * p.dil;
}
// floats of the staged input chunk, padded to a 16-byte multiple
__host__ __device__ inline int staged_x_floats(const ConvIn& p, int th) {
  return (kCi * tile_ih(p, th) * tile_iw(p) + 3) & ~3;
}
// floats of shared memory conv_tile needs: the input chunk and its weights
template <int COUT>
__host__ __device__ inline int conv_tile_floats(const ConvIn& p, int th) {
  return staged_x_floats(p, th) + kCi * p.kh * p.kw * COUT;
}

// Stages input channels [c0, c0 + cc) of image img for the tile at
// (x0, y0) (th rows) into xs, 0 outside the image (SAME padding).
template <typename T>
__device__ inline void stage_x(const ConvIn& p, float* xs, int img, int c0, int cc,
                               int x0, int y0, int th) {
  const T* a = (const T*)p.a;
  const T* b = (const T*)p.b;
  const int ih = tile_ih(p, th), iw = tile_iw(p);
  const int64_t plane = (int64_t)p.h * p.w_;
  for (int i = threadIdx.x; i < cc * ih * iw; i += blockDim.x) {
    const int ci = i / (ih * iw), rem = i - ci * ih * iw;
    const int r = rem / iw, q = rem - r * iw;
    const int gy = y0 - p.pt + r, gx = x0 - p.pleft + q;
    float v = 0.f;
    if (gy >= 0 && gy < p.h && gx >= 0 && gx < p.w_) {
      const int ch = c0 + ci;
      const T* src = ch < p.ca ? a + ((int64_t)img * p.ca + ch) * plane
                               : b + ((int64_t)img * p.cb + (ch - p.ca)) * plane;
      v = to_f32(src[(int64_t)gy * p.w_ + gx]);
    }
    xs[i] = v;
  }
}

// acc[i][c] = sum over the conv window of output channel co0 + c at row
// y0 + ty * PIX + i, column x0 + tx (channels at or above cout read zero
// weights).  Starts and ends with every thread past its shared-memory
// reads of the previous use (one __syncthreads per chunk, before staging).
template <typename T, int COUT, int PIX>
__device__ inline void conv_tile(const ConvIn& p, float* smem, int img, int co0,
                                 int x0, int y0, float (&acc)[PIX][COUT]) {
  constexpr int TH = kTy * PIX;
  const T* __restrict__ w = (const T*)p.w;
  const int cin = p.ca + p.cb, taps = p.kh * p.kw;
  const int iw = tile_iw(p);
  float* xs = smem;                           // [kCi][ih][iw]
  float* ws = smem + staged_x_floats(p, TH);  // [kCi][taps][COUT]
  const int tx = threadIdx.x % kTw, ty = threadIdx.x / kTw;
#pragma unroll
  for (int i = 0; i < PIX; ++i)
#pragma unroll
    for (int c = 0; c < COUT; ++c) acc[i][c] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += kCi) {
    const int cc = min(kCi, cin - c0);
    __syncthreads();  // every thread is done with the previous chunk
    stage_x<T>(p, xs, img, c0, cc, x0, y0, TH);
    for (int i = threadIdx.x; i < cc * taps * COUT; i += blockDim.x) {
      const int co = i % COUT, t = i / COUT;
      const int tap = t % taps, ci = t / taps;
      ws[i] = co0 + co < p.cout
                  ? to_f32(w[((int64_t)(co0 + co) * cin + c0 + ci) * taps + tap])
                  : 0.f;
    }
    __syncthreads();
    const int ih = tile_ih(p, TH);
    for (int ci = 0; ci < cc; ++ci) {
      const float* xc = xs + ci * ih * iw + ty * PIX * iw + tx;
      const float* wc = ws + ci * taps * COUT;
      for (int ky = 0; ky < p.kh; ++ky) {
        for (int kx = 0; kx < p.kw; ++kx) {
          float wv[COUT];
          load_row(wv, wc + (ky * p.kw + kx) * COUT);
          const float* xr = xc + ky * p.dil * iw + kx * p.dil;
#pragma unroll
          for (int i = 0; i < PIX; ++i) {
            const float v = xr[i * iw];
#pragma unroll
            for (int c = 0; c < COUT; ++c) acc[i][c] = fmaf(v, wv[c], acc[i][c]);
          }
        }
      }
    }
  }
  __syncthreads();  // shared memory free for the caller
}

}  // namespace msau
