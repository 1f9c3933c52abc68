// Backward stage 1 of the flat conv (conv_tile.cuh's conv + bias -> act ->
// LRN, one or two inputs, any KH x KW and dilation): from the cotangent g of
// the output it computes
//   g0 = d loss / d preactivation   (g back through the LRN and the act),
//   dw = sum over pixels of g0 (x) the input taps   (f32, OIHW),
//   db = sum over pixels of g0                       (f32),
// in one pass over the input.  The input's cotangent is the transposed conv
// of g0, a launch of msau_flat_conv2d (flatconv.cu) with flipped taps.
//
// Replaces the TPU kernels msau_tpu/ops/flatconv.py:_epi_bwd_kernel
// (launcher _epi_bwd_call: recompute, LRN / act backward, dw and db in one
// pass) and _dw_kernel (launcher _dw_call: the case with no epilogue, where
// g0 = g, for the merge and end convs); the coupling conv's backward
// (_cc_bwd_kernel) is concat1x1_bwd.cu's one pass.  Rounding as there: g
// arrives in the activation dtype; g0 is
// written in that dtype and dw is summed from the rounded g0; db from the
// f32 g0; every sum in f32.
//
// The LRN backward, per pixel (y1 = act(a), s = alpha / size):
//   t[co] = k + s * sum_{c in win(co)} y1[c]^2,  r = t^-beta,
//   g1[ci] = g[ci] r[ci] - 2 beta s y1[ci] sum_{co : ci in win(co)}
//            g[co] y1[co] r[co] / t[co]
// with win(co) = [co - size/2, co + (size-1)/2]; the co with ci in win(co)
// form the mirror window [ci - (size-1)/2, ci + size/2].
//
// What bounds it on the H100: FP32 arithmetic: the recompute is one
// forward conv, and dw is as many FMAs again.  Design:
//   - a grid of at most kPartialBlocks blocks walks the 32 x TH output
//     tiles; per tile a block
//       1. recomputes the preactivation of every output channel into
//          shared memory (conv_tile, 32 channels at a time),
//       2. maps g back through the LRN and act, one thread per pixel
//          over every channel (the windows read neighbours' values from
//          shared memory), writes g0 and keeps it in shared memory as
//          [pixel][channel] rows,
//       3. stages the input 8 channels at a time and sums dw: a thread
//          owns one (input channel, tap) pair and a slice of the tile's
//          pixels with up to 32 output channels in registers, reading g0
//          rows as 16-byte broadcast loads; the slices of a pair are added
//          in order into the block's own f32 partial row;
//   - sum_partials (common.cuh) adds the blocks' rows in order: the same
//     inputs give the same bits.

#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "conv_tile.cuh"

namespace {

using msau::act_grad;
using msau::apply_act;
using msau::conv_tile;
using msau::ConvIn;
using msau::kCi;
using msau::kThreads;
using msau::kTw;
using msau::kTy;
using msau::load_row;
using msau::round_to;
using msau::store;
using msau::to_f32;

struct BwdArgs {
  ConvIn in;
  const float* bias;   // [cout]
  const void* g;       // [n, cout, h, w] in the activation dtype
  void* g0;            // [n, cout, h, w] or null (no epilogue: g0 = g)
  int act, lrn_size;
  float alpha, beta, lrn_k;
};

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// (input channel, tap) pairs of a chunk of cc channels, and the pixel
// slices each pair's sum is split into so that every thread has work
__host__ __device__ inline int dw_slices(int pairs) {
  return (kThreads + pairs - 1) / pairs;
}

// shared memory layout of one block, in floats
struct Smem {
  int conv, a, u, g, red, total;
  __host__ __device__ Smem(const ConvIn& p, int COUT, int TH, bool lrn) {
    const int P = kTw * TH, gs = round_up(p.cout, COUT);
    const int taps = p.kh * p.kw, cin = p.ca + p.cb;
    // the full chunks' items and the last, partial chunk's
    const int full = min(kCi, cin) * taps, last = (cin % kCi) * taps;
    int items = full * dw_slices(full);
    if (last > 0) items = max(items, last * dw_slices(last));
    conv = (msau::staged_x_floats(p, TH) + kCi * taps * COUT + 3) & ~3;
    a = p.cout * P;
    u = lrn ? p.cout * P : 0;
    g = P * gs;
    red = items * COUT;
    total = conv + a + u + g + red;
  }
};

template <typename T, int COUT, int PIX>
__global__ void __launch_bounds__(kThreads)
conv_bwd_kernel(BwdArgs p, int tiles_x, int tiles_y, int n_tiles,
                float* __restrict__ partial, int64_t stride) {
  constexpr int TH = kTy * PIX, P = kTw * TH;
  extern __shared__ __align__(16) float smem[];
  const ConvIn& in = p.in;
  const int cout = in.cout, cin = in.ca + in.cb, taps = in.kh * in.kw;
  const bool epi = p.act != 0 || p.lrn_size > 0;
  const Smem lay(in, COUT, TH, p.lrn_size > 0);
  float* xs = smem;                            // conv_tile's / dw's input chunk
  float* A = smem + lay.conv;                  // [cout][P] preact, then f32 g0
  float* U = A + lay.a;                        // [cout][P] LRN's g y1 r / t
  float* G = U + lay.u;                        // [P][gs] rounded g0 (and g r)
  float* red = G + lay.g;                      // dw slice sums
  const int gs = round_up(cout, COUT);
  const int tx = threadIdx.x % kTw, ty = threadIdx.x / kTw;
  const int64_t plane = (int64_t)in.h * in.w_;
  const T* __restrict__ g = (const T*)p.g;
  float* __restrict__ part = partial + (int64_t)blockIdx.x * stride;
  const int lo = p.lrn_size / 2, hi = (p.lrn_size - 1) / 2;
  const float s = p.lrn_size > 0 ? p.alpha / (float)p.lrn_size : 0.f;
  float db = 0.f;   // thread co's sum of g0 over this block's tiles

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    const int img = tile / (tiles_x * tiles_y), t2 = tile % (tiles_x * tiles_y);
    const int x0 = (t2 % tiles_x) * kTw, y0 = (t2 / tiles_x) * TH;

    // 1. the preactivation of every channel
    if (epi) {
      for (int co0 = 0; co0 < cout; co0 += COUT) {
        float acc[PIX][COUT];
        conv_tile<T, COUT, PIX>(in, smem, img, co0, x0, y0, acc);
#pragma unroll
        for (int i = 0; i < PIX; ++i)
#pragma unroll
          for (int c = 0; c < COUT; ++c)
            if (co0 + c < cout)
              A[(co0 + c) * P + (ty * PIX + i) * kTw + tx] = acc[i][c] + p.bias[co0 + c];
      }
    }
    __syncthreads();

    // 2. g0 per pixel
    for (int pp = threadIdx.x; pp < P; pp += kThreads) {
      const int gy = y0 + pp / kTw, gx = x0 + pp % kTw;
      const bool inside = gy < in.h && gx < in.w_;
      const T* gp = g + (int64_t)img * cout * plane + (int64_t)gy * in.w_ + gx;
      float* grow = G + pp * gs;
      for (int co = cout; co < gs; ++co) grow[co] = 0.f;
      if (!inside) {
        for (int co = 0; co < cout; ++co) A[co * P + pp] = grow[co] = 0.f;
        continue;
      }
      if (!epi) {
        for (int co = 0; co < cout; ++co)
          A[co * P + pp] = grow[co] = to_f32(gp[co * plane]);
        continue;
      }
      if (p.lrn_size > 0) {
        for (int co = 0; co < cout; ++co) {
          float win = 0.f;
          for (int c = max(0, co - lo); c <= min(cout - 1, co + hi); ++c) {
            const float y = apply_act(A[c * P + pp], p.act);
            win += y * y;
          }
          const float t = p.lrn_k + s * win, r = powf(t, -p.beta);
          const float gv = to_f32(gp[co * plane]);
          U[co * P + pp] = gv * apply_act(A[co * P + pp], p.act) * (r / t);
          grow[co] = gv * r;
        }
      }
      for (int co = 0; co < cout; ++co) {
        const float a = A[co * P + pp];
        float g1;
        if (p.lrn_size > 0) {
          float mu = 0.f;
          for (int c = max(0, co - hi); c <= min(cout - 1, co + lo); ++c)
            mu += U[c * P + pp];
          g1 = grow[co] - (2.f * p.beta * s) * apply_act(a, p.act) * mu;
        } else {
          g1 = to_f32(gp[co * plane]);
        }
        const float g0 = g1 * act_grad(a, p.act);
        A[co * P + pp] = g0;
        grow[co] = round_to<T>(g0);
        store((T*)p.g0 + (int64_t)img * cout * plane + co * plane +
                  (int64_t)gy * in.w_ + gx, g0);
      }
    }
    __syncthreads();
    if ((int)threadIdx.x < cout) {
      float sum = 0.f;
      for (int pp = 0; pp < P; ++pp) sum += A[threadIdx.x * P + pp];
      db += sum;
    }

    // 3. dw: the input 8 channels at a time against the g0 rows
    const int ih = msau::tile_ih(in, TH), iw = msau::tile_iw(in);
    for (int c0 = 0; c0 < cin; c0 += kCi) {
      const int cc = min(kCi, cin - c0);
      __syncthreads();   // the previous chunk's readers are done
      msau::stage_x<T>(in, xs, img, c0, cc, x0, y0, TH);
      __syncthreads();
      const int pairs = cc * taps, nsl = dw_slices(pairs);
      for (int co0 = 0; co0 < cout; co0 += COUT) {
        for (int it = threadIdx.x; it < pairs * nsl; it += kThreads) {
          const int pair = it % pairs, sl = it / pairs;
          const int ci = pair / taps, tap = pair % taps;
          const float* xb = xs + ci * ih * iw + (tap / in.kw) * in.dil * iw +
                            (tap % in.kw) * in.dil;
          float acc[COUT];
#pragma unroll
          for (int c = 0; c < COUT; ++c) acc[c] = 0.f;
          for (int pp = sl * P / nsl; pp < (sl + 1) * P / nsl; ++pp) {
            const float xv = xb[(pp / kTw) * iw + pp % kTw];
            float gr[COUT];
            load_row(gr, G + pp * gs + co0);
#pragma unroll
            for (int c = 0; c < COUT; ++c) acc[c] = fmaf(xv, gr[c], acc[c]);
          }
#pragma unroll
          for (int c = 0; c < COUT; ++c) red[it * COUT + c] = acc[c];
        }
        __syncthreads();
        for (int j = threadIdx.x; j < pairs * COUT; j += kThreads) {
          const int pair = j / COUT, c = j % COUT;
          if (co0 + c >= cout) continue;
          float v = 0.f;
          for (int sl = 0; sl < nsl; ++sl) v += red[(sl * pairs + pair) * COUT + c];
          const int ci = c0 + pair / taps, tap = pair % taps;
          float* dst = part + ((int64_t)(co0 + c) * cin + ci) * taps + tap;
          *dst = first ? v : *dst + v;
        }
        __syncthreads();
      }
    }
  }
  if ((int)threadIdx.x < cout) part[(int64_t)cout * cin * taps + threadIdx.x] = db;
}

template <typename T, int COUT, int PIX>
int launch(const BwdArgs& p, int n, float* partial, float* out, cudaStream_t stream) {
  constexpr int TH = kTy * PIX;
  const Smem lay(p.in, COUT, TH, p.lrn_size > 0);
  const size_t smem = (size_t)lay.total * sizeof(float);
  cudaError_t err = msau::allow_smem(conv_bwd_kernel<T, COUT, PIX>, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (p.in.w_ + kTw - 1) / kTw, tiles_y = (p.in.h + TH - 1) / TH;
  const int64_t n_tiles = (int64_t)n * tiles_x * tiles_y;
  if (n_tiles > (1 << 30)) return (int)cudaErrorInvalidValue;
  const int blocks = (int)std::min<int64_t>(n_tiles, msau::kPartialBlocks);
  const int64_t stride =
      (int64_t)p.in.cout * (p.in.ca + p.in.cb) * p.in.kh * p.in.kw + p.in.cout;
  conv_bwd_kernel<T, COUT, PIX><<<blocks, kThreads, smem, stream>>>(
      p, tiles_x, tiles_y, (int)n_tiles, partial, stride);
  const int code = (int)cudaGetLastError();
  if (code != 0) return code;
  return msau::sum_partials(partial, blocks, stride, out, stream);
}

template <typename T>
int dispatch(const BwdArgs& p, int n, float* partial, float* out, cudaStream_t s) {
  if (p.in.cout <= 8) return launch<T, 8, 2>(p, n, partial, out, s);
  if (p.in.cout <= 16) return launch<T, 16, 2>(p, n, partial, out, s);
  if (p.in.cout <= 32) return launch<T, 32, 2>(p, n, partial, out, s);
  return launch<T, 32, 1>(p, n, partial, out, s);
}

}  // namespace

// a, b, w, bias, act, lrn_*: the forward's (msau_flat_conv2d, with the
// forward's padding pt / pleft); g: [n, cout, h, w] in the activation
// dtype; g0: [n, cout, h, w] out in that dtype, written only when act or
// lrn_size is set (null otherwise); partial: f32 scratch of
// kPartialBlocks * (cout * cin * kh * kw + cout) floats; out: f32
// [cout * cin * kh * kw + cout], dw (OIHW) then db.
extern "C" int msau_flat_conv_bwd(const void* a, const void* b, const void* w,
                                  const void* bias, const void* g, void* g0,
                                  void* partial, void* out, int n, int ca, int cb,
                                  int h, int wd, int cout, int kh, int kw, int dil,
                                  int pt, int pleft, int act, int lrn_size,
                                  float alpha, float beta, float lrn_k, int is_bf16,
                                  void* stream) {
  const bool epi = act != 0 || lrn_size > 0;
  if (n < 0 || ca <= 0 || cb < 0 || h < 0 || wd < 0 || cout <= 0 || cout > kThreads ||
      kh <= 0 || kw <= 0 || dil <= 0 || pt < 0 || pleft < 0 || act < 0 || act > 2 ||
      lrn_size < 0 || (cb > 0 && b == nullptr) || (epi && g0 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0 || h == 0 || wd == 0)
    return (int)cudaMemsetAsync(
        out, 0, ((size_t)cout * (ca + cb) * kh * kw + cout) * sizeof(float), s);
  const BwdArgs p{{a, b, w, ca, cb, h, wd, cout, kh, kw, dil, pt, pleft},
                  (const float*)bias, g, g0, act, lrn_size, alpha, beta, lrn_k};
  return is_bf16 ? dispatch<__nv_bfloat16>(p, n, (float*)partial, (float*)out, s)
                 : dispatch<float>(p, n, (float*)partial, (float*)out, s);
}
