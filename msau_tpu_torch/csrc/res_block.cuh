// The fused residual block's kernels (flatres.cu: the forward; flatres_bwd.cu:
// the backward): the pieces both share.
//
// A block of NW warps walks output tiles of TH rows x TW columns of one image
// (a persistent grid, sized by the occupancy API).  Every region a block keeps
// in shared memory is a rectangle of pixels around its tile, stored as
// [pixel][channel] in the activation dtype: a pixel is a run of CP channels
// (C, at least 8; zeros past C) padded to an odd number of 16-byte chunks (CS
// elements), so the 8 pixels an ldmatrix or 8 lanes' float4 loads read fall
// in 8 distinct bank groups.  The region of halo H spans image rows y0 - H ..
// y0 + TH + H and columns x0 - H .. x0 + TW + H, row-major: a 3x3 conv that
// writes the region of halo H reads the region of halo H + 1, the tap's
// pixel at a fixed shift of the output pixel's.
//
// The conv over a staged region is an implicit GEMM, M = the output region's
// pixels, N = C output channels, K = 9 taps x C input channels; a transposed
// conv (the backward's conv2^T and conv1^T) is the same GEMM on the same
// staged weights, B transposed and the taps flipped:
//   - bf16 on the tensor cores: mma.sync m16n8k16 (f32 sums); A (16 pixels x
//     16 channels) by ldmatrix from the staged pixels at the tap's shift, any
//     16 pixels of the region (each lane addresses its own row, so a region
//     34 or 38 pixels wide wastes no m-tile but the last); B by ldmatrix
//     (conv) or ldmatrix.trans (transposed conv) from the weights staged once
//     per block as [tap][co][ci].  At C = 8 a k16 step is two taps of 8
//     channels and the ninth tap an m16n8k8 step; C = 4 runs as C = 8 with
//     zero channels;
//   - f32 on the FP32 pipes (1e-5: no TF32): a lane owns 2 to 4 pixels x 8
//     output channels, each float4 of input feeding 4 x 8 FMAs, from
//     weights staged as [ci][tap][co].
// conv_exact is the same conv summed in the plain version's order, on the
// FP32 pipes in both dtypes (the backward's conv1, whose relu masks must
// agree with the plain version's bit for bit).
// The weight gradient dw[co][ci][tap] = sum over the tile's pixels of
// g[co] a[ci] at the tap's shift is a split-K GEMM over the tile's pixels,
// its sums in registers across the block's tiles:
//   - bf16 on mma.sync: M = 16 input channels (C = 8: 8 channels at two
//     taps), N = 8 output channels, K = 16 pixels of a tile row; A and B by
//     ldmatrix.trans from the [pixel][channel] regions; warp w owns the (tap,
//     M, N) tiles w, w + NW, ..., all on one (M, N) pair, so the g fragment is
//     loaded once per K step;
//   - f32 on the FP32 pipes: a thread owns 4 input x 8 output channels at one
//     tap and a fixed slice of the pixels; the slices are added in slice
//     order at the end.

#pragma once

#include <stdint.h>

#include "conv_fast.cuh"

namespace msau {
namespace res {

// channel geometry of the staged regions
template <typename T, int C>
struct Ch {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int CP = C < 8 ? 8 : C;               // channels kept per pixel
  static constexpr int V = 16 / (int)sizeof(T);          // elements per 16 bytes
  static constexpr int CS = kF32 ? 4 * ((CP / 4) | 1) : 8 * ((CP / 8) | 1);
  static constexpr int NG = CP / 8;                      // 8-channel groups
  static constexpr int WS = kF32 ? CP : CS;              // weight row stride
  static constexpr int W_ELEMS = 9 * CP * WS;            // one staged weight set
};

// the region of halo H around a TH x TW tile
template <int TH, int TW, int H>
struct Reg {
  static constexpr int R = TH + 2 * H, W = TW + 2 * H, N = R * W;
};

__host__ __device__ constexpr size_t a16(size_t b) { return (b + 15) & ~(size_t)15; }

// The stride of an f32 [channel][pixel] array of n pixels: 4 (mod 32) words,
// so an mma epilogue's lanes (8 pixels x 4 channel pairs) hit distinct banks.
__host__ __device__ constexpr int row4(int n) { return n + ((36 - n % 32) % 32); }

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
template <typename T>
__device__ __forceinline__ float2 load2(const T* p);
template <>
__device__ __forceinline__ float2 load2<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <>
__device__ __forceinline__ float2 load2<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T>
__device__ __forceinline__ uint4 relu16(uint4 v);
template <>
__device__ __forceinline__ uint4 relu16<float>(uint4 v) {
  float* f = reinterpret_cast<float*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = fmaxf(f[i], 0.f);
  return v;
}
template <>
__device__ __forceinline__ uint4 relu16<__nv_bfloat16>(uint4 v) {
  __nv_bfloat162* b = reinterpret_cast<__nv_bfloat162*>(&v);
  const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < 4; ++i) b[i] = __hmax2(b[i], zero);
  return v;
}

// ldmatrix of one 8x8 b16 matrix (lanes 0-7 address its rows)
__device__ __forceinline__ unsigned ldsm_x1(const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  unsigned r;
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];\n"
               : "=r"(r)
               : "r"(s)
               : "memory");
  return r;
}
__device__ __forceinline__ unsigned ldsm_x1_trans(const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  unsigned r;
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.trans.shared.b16 {%0}, [%1];\n"
               : "=r"(r)
               : "r"(s)
               : "memory");
  return r;
}

// Stages channels [0, C) of one image (src: [C][h][w]) over the region of
// halo H into dst ([pixel][CS]; zeros outside the image and past C; relu'd
// where RELU).  Rows are read as 16-byte runs from the aligned column x0 - RA
// and transposed in registers (conv_fast.cuh's load_run, transpose_runs);
// work items take the channel group fastest.  ``vec``: w % V == 0 and src
// 16-byte aligned.
template <typename T, int C, int TH, int TW, int H, bool RELU, int NT>
__device__ void stage(const T* __restrict__ src, T* __restrict__ dst, int h, int w, int x0,
                      int y0, bool vec) {
  using Q = Ch<T, C>;
  using RG = Reg<TH, TW, H>;
  constexpr int V = Q::V, CS = Q::CS, CG = Q::CP / V;
  constexpr int RA = (H + V - 1) / V * V, NR = (TW + 2 * RA) / V;
  const int64_t plane = (int64_t)h * w;
  for (int it = threadIdx.x; it < RG::R * NR * CG; it += NT) {
    const int cg = it % CG, rest = it / CG;
    const int j = rest % NR, r = rest / NR;
    const int gy = y0 - H + r, gx = x0 - RA + j * V;
    const bool row_ok = gy >= 0 && gy < h;
    uint4 v[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int ch = cg * V + e;
      const T* row = row_ok && ch < C ? src + ch * plane + (int64_t)gy * w : nullptr;
      v[e] = fast::load_run<T>(row, gx, w, vec);
    }
    uint4 o[V];
    fast::transpose_runs<V>(v, o);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int q = j * V + k - RA + H;
      if (q >= 0 && q < RG::W) {
        uint4 val = o[k];
        if constexpr (RELU) val = relu16<T>(val);
        *reinterpret_cast<uint4*>(dst + (size_t)(r * RG::W + q) * CS + cg * V) = val;
      }
    }
  }
}

// w [co][ci][3][3] into shared memory, zeros past C: for mma.sync (S =
// bf16) as [tap][co][CS], ci innermost, the B rows of the conv (ldmatrix)
// and of its transpose (ldmatrix.trans); for the FP32 pipes (S = float) as
// [ci][tap][CP], co innermost, whose float4 runs give the conv 4 output
// channels of one input channel, its transpose 4 input channels of one
// output channel, and conv_exact 8 output channels per (channel, tap).
template <typename T, typename S, int C, int NT>
__device__ void stage_weights(const T* __restrict__ w, S* __restrict__ ws) {
  constexpr int CP = Ch<T, C>::CP;
  for (int i = threadIdx.x; i < 9 * CP * CP; i += NT) {
    if constexpr (sizeof(S) == 4) {
      const int co = i % CP, rest = i / CP;
      const int tap = rest % 9, ci = rest / 9;
      ws[i] = co < C && ci < C ? to_f32(w[(co * C + ci) * 9 + tap]) : 0.f;
    } else {
      const int ci = i % CP, rest = i / CP;
      const int co = rest % CP, tap = rest / CP;
      ws[(tap * CP + co) * Ch<T, C>::CS + ci] =
          co < C && ci < C ? w[(co * C + ci) * 9 + tap] : fast::zero_of<T>();
    }
  }
}

// weight (co, ci, tap) of a set staged by stage_weights
template <typename T, int C>
__device__ __forceinline__ float weight_at(const T* ws, int co, int ci, int tap) {
  using Q = Ch<T, C>;
  if constexpr (sizeof(T) == 4)
    return ws[(ci * 9 + tap) * Q::CP + co];
  else
    return to_f32(ws[(tap * Q::CP + co) * Q::CS + ci]);
}

// ---- the 3x3 conv over a staged region ------------------------------------

__device__ __forceinline__ unsigned relu_bf16x2(unsigned a) {
  __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&a);
  h = __hmax2(h, __floats2bfloat162_rn(0.f, 0.f));
  return *reinterpret_cast<const unsigned*>(&h);
}

// bf16: the output region of halo HO from src (the region of halo HO + 1);
// epi(pixel, co, v[co], v[co + 1]) for every output pixel and even co < CP.
template <int C, int TH, int TW, int HO, bool TRANS, int NW, typename Epi>
__device__ void conv_mma(const __nv_bfloat16* __restrict__ src,
                         const __nv_bfloat16* __restrict__ ws, Epi&& epi) {
  using Q = Ch<__nv_bfloat16, C>;
  using O = Reg<TH, TW, HO>;
  constexpr int CP = Q::CP, CS = Q::CS, NT = Q::NG, SW = O::W + 2;
  constexpr int MT = (O::N + 15) / 16;
  // m-tiles per warp and round: two (each B fragment feeds both) unless
  // that takes the warps more rounds
  constexpr int R1 = (MT + NW - 1) / NW, R2 = 2 * ((MT + 2 * NW - 1) / (2 * NW));
  constexpr int MP = R2 <= R1 ? 2 : 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int m0 = MP * warp; m0 < MT; m0 += MP * NW) {
    float acc[MP][NT][4];
#pragma unroll
    for (int m = 0; m < MP; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
    // lane's A row: pixel 16 m + lane % 16 (clamped into the region)
    const __nv_bfloat16* xa[MP];
#pragma unroll
    for (int m = 0; m < MP; ++m) {
      const int pix = min(16 * (m0 + m) + (lane & 15), O::N - 1);
      xa[m] = src + (size_t)((pix / O::W) * SW + pix % O::W) * CS;
    }
    if constexpr (CP >= 16) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        // A: channels + 8 for lanes 16-31 (the k8-15 half)
        const int toff = ((tap / 3) * SW + tap % 3) * CS + 8 * (lane >> 4);
        const __nv_bfloat16* wt = ws + (size_t)(TRANS ? 8 - tap : tap) * CP * CS;
#pragma unroll
        for (int kc = 0; kc < CP / 16; ++kc) {
          unsigned af[MP][4];
#pragma unroll
          for (int m = 0; m < MP; ++m) msau::ldsm_x4(af[m], xa[m] + toff + 16 * kc);
#pragma unroll
          for (int n = 0; n < NT; n += 2) {
            unsigned b4[4];
            if constexpr (TRANS)
              // B^T rows ci = 8 (n + lane / 16) + row, k = co 16 kc + 8 ((lane / 8) % 2)
              msau::ldsm_x4_trans(b4, wt + (size_t)(16 * kc + 8 * ((lane >> 3) & 1) + (lane & 7)) *
                                               CS +
                                          8 * n + 8 * (lane >> 4));
            else
              msau::ldsm_x4(b4, wt + (size_t)(8 * n + 8 * (lane >> 4) + (lane & 7)) * CS +
                                    16 * kc + 8 * ((lane >> 3) & 1));
            const unsigned lo[2] = {b4[0], b4[1]}, hi[2] = {b4[2], b4[3]};
#pragma unroll
            for (int m = 0; m < MP; ++m) {
              msau::mma_bf16(acc[m][n], af[m], lo);
              msau::mma_bf16(acc[m][n + 1], af[m], hi);
            }
          }
        }
      }
    } else {
      // CP = 8: a k16 step is taps 2 s and 2 s + 1 (lanes 16-31 address the
      // second), the ninth tap an m16n8k8 step
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int ta = 2 * s + (lane >> 4), tb = 2 * s + ((lane >> 3) & 1);
        unsigned af[MP][4];
#pragma unroll
        for (int m = 0; m < MP; ++m)
          msau::ldsm_x4(af[m], xa[m] + ((ta / 3) * SW + ta % 3) * CS);
        const __nv_bfloat16* wp = ws + (size_t)((TRANS ? 8 - tb : tb) * CP + (lane & 7)) * CS;
        unsigned b[2];
        if constexpr (TRANS)
          msau::ldsm_x2_trans(b, wp);
        else
          msau::ldsm_x2(b, wp);
#pragma unroll
        for (int m = 0; m < MP; ++m) msau::mma_bf16(acc[m][0], af[m], b);
      }
      unsigned a2[MP][2];
#pragma unroll
      for (int m = 0; m < MP; ++m) msau::ldsm_x2(a2[m], xa[m] + (2 * SW + 2) * CS);
      const __nv_bfloat16* wp = ws + (size_t)((TRANS ? 0 : 8) * CP + (lane & 7)) * CS;
      const unsigned b1 = TRANS ? ldsm_x1_trans(wp) : ldsm_x1(wp);
#pragma unroll
      for (int m = 0; m < MP; ++m) msau::mma_bf16_k8(acc[m][0], a2[m][0], a2[m][1], b1);
    }
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int m = 0; m < MP; ++m) {
      if (m0 + m >= MT) break;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int pix = 16 * (m0 + m) + g + 8 * hr;
          if (pix < O::N) epi(pix, 8 * n + 2 * t4, acc[m][n][2 * hr], acc[m][n][2 * hr + 1]);
        }
    }
  }
}

__host__ __device__ constexpr int fma_rounds(int n, int ng, int nw, int pix) {
  return pix * (((n + 32 * pix - 1) / (32 * pix) * ng + nw - 1) / nw);
}
__host__ __device__ constexpr int fma_pix(int n, int ng, int nw) {
  int best = 4;
  for (int p = 3; p >= 2; --p)
    if (fma_rounds(n, ng, nw, p) < fma_rounds(n, ng, nw, best)) best = p;
  return best;
}

// f32: the same on the FP32 pipes.  Warp items are (a chunk of 32 PIX
// pixels, 8 output channels); lane l owns pixels l, l + 32, ... of the
// chunk.  Per (tap, 4 input channels) it reads PIX float4 of input and 8 of
// weights (the same for every lane) for 32 PIX FMAs.
template <int C, int TH, int TW, int HO, bool TRANS, int NW, typename Epi>
__device__ void conv_fma(const float* __restrict__ src, const float* __restrict__ ws,
                         Epi&& epi) {
  using Q = Ch<float, C>;
  using O = Reg<TH, TW, HO>;
  constexpr int CP = Q::CP, CS = Q::CS, NG = Q::NG, SW = O::W + 2;
  // pixels per lane: 2, 3 or 4, whichever takes the warps fewest pixel
  // rounds (the most pixels on a tie)
  constexpr int PIX = fma_pix(O::N, NG, NW);
  constexpr int CH = 32 * PIX, ITEMS = (O::N + CH - 1) / CH * NG;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int it = warp; it < ITEMS; it += NW) {
    const int grp = it % NG, chunk = it / NG;
    int off[PIX];
#pragma unroll
    for (int i = 0; i < PIX; ++i) {
      const int pix = min(chunk * CH + lane + 32 * i, O::N - 1);
      off[i] = ((pix / O::W) * SW + pix % O::W) * CS;
    }
    float acc[PIX][8];
#pragma unroll
    for (int i = 0; i < PIX; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = ((tap / 3) * SW + tap % 3) * CS;
      const float* wt = ws + (TRANS ? 8 - tap : tap) * CP;   // [ci][tap][co] at the tap
#pragma unroll
      for (int cq = 0; cq < CP / 4; ++cq) {
        float4 xv[PIX];
#pragma unroll
        for (int i = 0; i < PIX; ++i)
          xv[i] = *reinterpret_cast<const float4*>(src + off[i] + toff + 4 * cq);
        // wv[e][j]: input channel 4 cq + e, output channel 8 grp + j (the
        // transpose: weight (4 cq + e, 8 grp + j), taps flipped)
        float wv[4][8];
        if constexpr (TRANS) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float4 c4 = *reinterpret_cast<const float4*>(wt + (8 * grp + j) * 9 * CP + 4 * cq);
            wv[0][j] = c4.x, wv[1][j] = c4.y, wv[2][j] = c4.z, wv[3][j] = c4.w;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float* row = wt + (4 * cq + e) * 9 * CP + 8 * grp;
            const float4 lo = *reinterpret_cast<const float4*>(row);
            const float4 hi = *reinterpret_cast<const float4*>(row + 4);
            wv[e][0] = lo.x, wv[e][1] = lo.y, wv[e][2] = lo.z, wv[e][3] = lo.w;
            wv[e][4] = hi.x, wv[e][5] = hi.y, wv[e][6] = hi.z, wv[e][7] = hi.w;
          }
        }
#pragma unroll
        for (int i = 0; i < PIX; ++i) {
          const float xe[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xe[e], wv[e][j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < PIX; ++i) {
      const int pix = chunk * CH + lane + 32 * i;
      if (pix < O::N)
#pragma unroll
        for (int j = 0; j < 8; j += 2) epi(pix, 8 * grp + j, acc[i][j], acc[i][j + 1]);
    }
  }
}

// The conv of relu(src) in the plain version's order: f32 FMAs over input
// channel, then kernel row and column, from 0 (the bias is the caller's).  The plain
// version's f32 convolution sums in that order on the card, so a relu mask
// of this output agrees with its mask bit for bit (the GEMMs above sum in
// other orders and flip masks where a sum lies within rounding of 0).  wx:
// f32 weights [ci][tap][co].  Warp items are (a chunk of 64 pixels, 8
// output channels); lane l owns pixels l and l + 32 of the chunk, and per
// 16 bytes of input channels loads the 9 taps' runs, then takes the
// channels in order, each (channel, tap) feeding 2 x 8 FMAs.
template <typename T, int C, int TH, int TW, int HO, int NW, typename Epi>
__device__ void conv_exact(const T* __restrict__ src, const float* __restrict__ wx,
                           Epi&& epi) {
  using Q = Ch<T, C>;
  using O = Reg<TH, TW, HO>;
  constexpr int CP = Q::CP, CS = Q::CS, NG = Q::NG, V = Q::V, SW = O::W + 2;
  constexpr int PIX = 2, CH = 32 * PIX, ITEMS = (O::N + CH - 1) / CH * NG;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int it = warp; it < ITEMS; it += NW) {
    const int grp = it % NG, chunk = it / NG;
    int off[PIX];
#pragma unroll
    for (int i = 0; i < PIX; ++i) {
      const int pix = min(chunk * CH + lane + 32 * i, O::N - 1);
      off[i] = ((pix / O::W) * SW + pix % O::W) * CS;
    }
    float acc[PIX][8];
#pragma unroll
    for (int i = 0; i < PIX; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 1
    for (int c0 = 0; c0 < C; c0 += V) {
      uint4 xr[9][PIX];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
#pragma unroll
        for (int i = 0; i < PIX; ++i)
          xr[tap][i] = relu16<T>(*reinterpret_cast<const uint4*>(
              src + off[i] + ((tap / 3) * SW + tap % 3) * CS + c0));
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (e >= C) break;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const float* wp = wx + ((c0 + e) * 9 + tap) * CP + 8 * grp;
          const float4 lo = *reinterpret_cast<const float4*>(wp);
          const float4 hi = *reinterpret_cast<const float4*>(wp + 4);
          const float wv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int i = 0; i < PIX; ++i) {
            const unsigned* word = reinterpret_cast<const unsigned*>(&xr[tap][i]);
            float xv;
            if constexpr (sizeof(T) == 4)
              xv = __uint_as_float(word[e]);
            else
              xv = __uint_as_float(e % 2 ? word[e / 2] & 0xffff0000u : word[e / 2] << 16);
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv, wv[j], acc[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < PIX; ++i) {
      const int pix = chunk * CH + lane + 32 * i;
      if (pix < O::N)
#pragma unroll
        for (int j = 0; j < 8; j += 2) epi(pix, 8 * grp + j, acc[i][j], acc[i][j + 1]);
    }
  }
}

template <typename T, int C, int TH, int TW, int HO, bool TRANS, int NW, typename Epi>
__device__ __forceinline__ void conv(const T* src, const T* ws, Epi&& epi) {
  if constexpr (sizeof(T) == 4)
    conv_fma<C, TH, TW, HO, TRANS, NW>(src, ws, epi);
  else
    conv_mma<C, TH, TW, HO, TRANS, NW>(src, ws, epi);
}

// ---- the weight gradient over a tile --------------------------------------
//
// dw[co][ci][tap] (+)= sum over the tile's pixels p of g[p][co] a[p + tap -
// (1, 1)][ci], g the region of halo HG, a the region of halo HA >= 1 (relu'd
// as it is read where RA).
// add_tile sums one tile; finish writes the block's sums into its partial
// row (OIHW), called by every thread (``red``: shared memory the caller is
// done with).
template <typename T, int C, int TH, int TW, int HG, int HA, bool RA, int NW>
struct Dw;

template <int C, int TH, int TW, int HG, int HA, bool RA, int NW>
struct Dw<__nv_bfloat16, C, TH, TW, HG, HA, RA, NW> {
  using Q = Ch<__nv_bfloat16, C>;
  static constexpr int CP = Q::CP, CS = Q::CS, NT = Q::NG;
  static constexpr int MTL = CP >= 16 ? CP / 16 : 1;   // m-tiles (C = 8: one over a tap pair)
  static constexpr int TG = CP >= 16 ? 9 : 5;          // tap groups: taps, or tap pairs
  static constexpr int PAIRS = MTL * NT;               // (M, N) tiles per tap group
  static constexpr int UNITS = TG * PAIRS;
  static constexpr int UPW = (UNITS + NW - 1) / NW;
  static_assert(NW % PAIRS == 0, "a warp's tiles share one (M, N) pair");
  static_assert(TW % 16 == 0, "K steps of 16 pixels of a tile row");
  float v[UPW][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < UPW; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[i][e] = 0.f;
  }

  __device__ void add_tile(const __nv_bfloat16* __restrict__ a,
                           const __nv_bfloat16* __restrict__ g) {
    using A = Reg<TH, TW, HA>;
    using G = Reg<TH, TW, HG>;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (warp >= UNITS) return;   // whole warps
    const int pr = warp % PAIRS, mt = pr / NT, nt = pr % NT;
    // A (.trans): lane's pixel (lane % 8) + 8 (lane / 16) of the K step,
    // channels + 8 ((lane / 8) % 2) (C = 8: the second tap of the pair)
    const int pa = (lane & 7) + 8 * (lane >> 4), half = (lane >> 3) & 1;
    for (int ks = 0; ks < TH * TW / 16; ++ks) {
      const int r = ks / (TW / 16), q0 = (ks % (TW / 16)) * 16;
      unsigned b[2];
      msau::ldsm_x2_trans(b, g + (size_t)((r + HG) * G::W + q0 + HG + (lane & 15)) * CS + 8 * nt);
      const __nv_bfloat16* arow = a + (size_t)((r + HA - 1) * A::W + q0 + HA - 1 + pa) * CS;
#pragma unroll
      for (int i = 0; i < UPW; ++i) {
        const int u = warp + NW * i;
        if (u >= UNITS) break;   // warp-uniform
        const int tg = u / PAIRS;
        unsigned af[4];
        if constexpr (CP >= 16) {
          msau::ldsm_x4_trans(af, arow + ((tg / 3) * A::W + tg % 3) * CS + 16 * mt + 8 * half);
        } else {
          const int tap = min(2 * tg + half, 8);
          msau::ldsm_x4_trans(af, arow + ((tap / 3) * A::W + tap % 3) * CS);
        }
        if constexpr (RA)
#pragma unroll
          for (int k = 0; k < 4; ++k) af[k] = relu_bf16x2(af[k]);
        msau::mma_bf16(v[i], af, b);
      }
    }
  }

  __device__ void finish(float* __restrict__ part, float*) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int i = 0; i < UPW; ++i) {
      const int u = warp + NW * i;
      if (u >= UNITS) break;
      const int tg = u / PAIRS, pr = u % PAIRS, mt = pr / NT, nt = pr % NT;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = g + 8 * (e >> 1), co = 8 * nt + 2 * t4 + (e & 1);
        const int ci = CP >= 16 ? 16 * mt + row : row & 7;
        const int tap = CP >= 16 ? tg : 2 * tg + (row >> 3);
        if (ci < C && co < C && tap < 9) part[(co * C + ci) * 9 + tap] = v[i][e];
      }
    }
  }
};

template <int C, int TH, int TW, int HG, int HA, bool RA, int NW>
struct Dw<float, C, TH, TW, HG, HA, RA, NW> {
  using Q = Ch<float, C>;
  static constexpr int CP = Q::CP, CS = Q::CS, NG = Q::NG, CQ = CP / 4;
  static constexpr int NTH = 32 * NW;
  static constexpr int UNITS = 9 * CQ * NG;   // (tap, 4 input, 8 output channels)
  static_assert(UNITS <= NTH, "one unit per thread");
  static constexpr int S = NTH / UNITS;       // pixel slices
  float v[4][8];

  __device__ void zero() {
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int j = 0; j < 8; ++j) v[e][j] = 0.f;
  }

  // thread t: unit t % UNITS (output channel group fastest, so a warp's
  // lanes share their pixel's loads), slice t / UNITS
  __device__ void add_tile(const float* __restrict__ a, const float* __restrict__ g) {
    using A = Reg<TH, TW, HA>;
    using G = Reg<TH, TW, HG>;
    const int t = threadIdx.x;
    if (t >= UNITS * S) return;
    const int u = t % UNITS, s = t / UNITS;
    const int co8 = u % NG, cq = (u / NG) % CQ, tap = u / (NG * CQ);
    const float* ab = a + (size_t)((HA - 1 + tap / 3) * A::W + HA - 1 + tap % 3) * CS + 4 * cq;
    const float* gb = g + (size_t)(HG * G::W + HG) * CS + 8 * co8;
    for (int p = s; p < TH * TW; p += S) {
      const int r = p / TW, q = p % TW;
      float4 av = *reinterpret_cast<const float4*>(ab + (size_t)(r * A::W + q) * CS);
      if constexpr (RA)
        av = make_float4(fmaxf(av.x, 0.f), fmaxf(av.y, 0.f), fmaxf(av.z, 0.f), fmaxf(av.w, 0.f));
      const float* gp = gb + (size_t)(r * G::W + q) * CS;
      const float4 g0 = *reinterpret_cast<const float4*>(gp);
      const float4 g1 = *reinterpret_cast<const float4*>(gp + 4);
      const float ae[4] = {av.x, av.y, av.z, av.w};
      const float ge[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int j = 0; j < 8; ++j) v[e][j] = fmaf(ae[e], ge[j], v[e][j]);
    }
  }

  // the slices added in slice order through ``red`` (NTH * 33 floats)
  __device__ void finish(float* __restrict__ part, float* red) const {
    const int t = threadIdx.x;
    if (t < UNITS * S)
#pragma unroll
      for (int k = 0; k < 32; ++k) red[t * 33 + k] = v[k / 8][k % 8];
    __syncthreads();
    for (int i = t; i < UNITS * 32; i += NTH) {
      const int u = i / 32, k = i % 32;
      float sum = 0.f;
      for (int s = 0; s < S; ++s) sum += red[(s * UNITS + u) * 33 + k];
      const int co8 = u % NG, cq = (u / NG) % CQ, tap = u / (NG * CQ);
      const int ci = 4 * cq + k / 8, co = 8 * co8 + k % 8;
      if (ci < C && co < C) part[(co * C + ci) * 9 + tap] = sum;
    }
    __syncthreads();
  }
};

// ---- the tile's output ----------------------------------------------------

// out[co] over the tile = act(E[co] + res[co]) (res may be null), from E
// ([CP][row4(TH TW)] f32), written as 16-byte runs of the tile's rows.
template <typename T, int C, int TH, int TW, int NT>
__device__ void write_tile(T* __restrict__ out, const T* __restrict__ res,
                           const float* __restrict__ E, int h, int w, int x0, int y0,
                           bool vec, int act) {
  constexpr int V = Ch<T, C>::V, RUNS = TW / V, ES = row4(TH * TW);
  const int64_t plane = (int64_t)h * w;
  for (int it = threadIdx.x; it < C * TH * RUNS; it += NT) {
    const int j = it % RUNS, rest = it / RUNS;
    const int r = rest % TH, co = rest / TH;
    const int gy = y0 + r, gx = x0 + j * V;
    if (gy >= h || gx >= w) continue;
    const float* e = E + co * ES + r * TW + j * V;
    float vals[V];
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      const float4 f = *reinterpret_cast<const float4*>(e + k);
      vals[k] = f.x, vals[k + 1] = f.y, vals[k + 2] = f.z, vals[k + 3] = f.w;
    }
    const int64_t off = co * plane + (int64_t)gy * w;
    if (res != nullptr) {
      const uint4 xr = fast::load_run<T>(res + off, gx, w, vec);
      const T* xe = reinterpret_cast<const T*>(&xr);
#pragma unroll
      for (int k = 0; k < V; ++k) vals[k] += to_f32(xe[k]);
    }
    T* dst = out + off + gx;
    if (vec) {
      alignas(16) T o[V];
#pragma unroll
      for (int k = 0; k < V; ++k) msau::store(&o[k], apply_act(vals[k], act));
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (gx + k < w) msau::store(dst + k, apply_act(vals[k], act));
    }
  }
}

// ---- host side ------------------------------------------------------------

// a persistent grid: the resident blocks of ``threads`` at ``smem`` bytes
// on every SM, at most ``cap`` (if > 0) and n_tiles
template <typename Kernel>
inline int grid_size(Kernel kernel, int threads, size_t smem, int64_t n_tiles, int cap) {
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  int64_t b = (int64_t)(per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  if (cap > 0 && b > cap) b = cap;
  return (int)(b < n_tiles ? b : n_tiles);
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace res
}  // namespace msau
