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
// What bounds it on the H100: in f32 the FP32 pipes (the recompute is one
// forward conv, and dw is as many FMAs again); in bf16, with both on the
// tensor cores, device memory.
//
// The fast path (conv_fast.cuh's shapes, where its dw plan and shared
// memory fit: every conv of the flagship and config 5) is one pass per
// tile over one staging of the input, described at conv_bwd_fast_kernel
// below.  The general path (any other shape):
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
//     inputs give the same bits (both paths).

#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "conv_fast.cuh"
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

// ---- the fast path: square 3x3 / 4x4 kernels, up to 64 -> 64 channels ----
//
// One pass per tile over conv_fast.cuh's staging: the input is staged once
// ([pixel][channel], every channel) and serves both the recompute (the
// forward's implicit GEMM, with an epilogue) and dw.  Per tile:
//   1. (with an epilogue) the preactivation into f32 [co][pixel];
//   2. one thread per pixel maps g (staged with the input) back through the
//      LRN and the act (running window sums over the pixel's channels in
//      shared memory), writes g0 and keeps it, rounded to the activation
//      dtype, for dw; db: thread (co, s) adds the f32 g0 of channel co over
//      a fixed slice s of the tile's pixels, in registers across tiles,
//      and the slices are added in order at the end;
//   3. dw += x (x) g0 as a split-K GEMM over the tile's pixels, the sums in
//      registers across the block's tiles:
//        - bf16 on mma.sync: M = 16 input channels, N = 8 output channels,
//          K = 16 pixels of a tile row; A (the input at the tap's shift) by
//          ldmatrix .trans from the staged pixels, B from g0 kept as
//          [co][pixel]; a warp owns one or two (M, N) tiles for every tap,
//          or a share of the K steps of one (the shares added in order at
//          the end through shared memory);
//        - f32 on the FP32 pipes: a thread owns 4 input x 8 output
//          channels x the KW taps of one kernel row (48 or 64 sums) and a
//          slice of the pixels (its slices on neighbouring lanes, added by
//          shuffles at the end); per pixel it reads KW float4 of input and
//          2 float4 of g0 (kept as [pixel][co]) for 32 KW FMAs.
// Each block writes its partial row once; sum_partials adds the rows in
// block order.

// byte offsets of a block's shared memory, and the dw plan
struct FastBwdPlan {
  int w, x, red, e, u, g, dbs, gin, total;
  int raw;           // the cp.async input buffer, or -1 (staged synchronously)
  int gs;            // f32: g0's row stride in floats ([pixel][gs])
  int units, ps;     // f32 dw: thread units and pixel slices per unit
  int ntd, pairs, ks;   // bf16 dw: 8-channel n-tiles, (M, N) tiles, K shares
};

template <typename T, int KH, int PPW>
struct DwAcc;

// f32: unit u = (input float4 group, kernel row, 8 output channels), the
// output-channel group fastest, so a warp's lanes share input loads
template <int KH, int PPW>
struct DwAcc<float, KH, PPW> {
  float v[4][8][KH];
  __device__ void zero() {
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int k = 0; k < KH; ++k) v[e][c][k] = 0.f;
  }
  __device__ void add_tile(const ConvIn& in, const msau::fast::Geo& g, const FastBwdPlan& q,
                           const float* xs, const float* G) {
    using Tl = msau::fast::Tile<float>;
    const int u = threadIdx.x / q.ps, s = threadIdx.x % q.ps;
    if (u >= q.units) return;
    const int co8n = q.ntd;
    const int co8 = u % co8n, ky = (u / co8n) % KH, c4 = u / (co8n * KH);
    const int cs = g.cs, d = in.dil;
    const float* xb = xs + (size_t)(ky * d * Tl::SW + Tl::V - in.pleft) * cs + 4 * c4;
    const float* gb = G + 8 * co8;
    for (int p = s; p < Tl::P; p += q.ps) {
      const int r = p >> 5, c = p & 31;
      const float4 ga = *reinterpret_cast<const float4*>(gb + p * q.gs);
      const float4 gc = *reinterpret_cast<const float4*>(gb + p * q.gs + 4);
      const float gv[8] = {ga.x, ga.y, ga.z, ga.w, gc.x, gc.y, gc.z, gc.w};
      const float* xr = xb + (size_t)(r * Tl::SW + c) * cs;
#pragma unroll
      for (int kx = 0; kx < KH; ++kx) {
        const float4 xv = *reinterpret_cast<const float4*>(xr + (size_t)kx * d * cs);
        const float xe[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int cc = 0; cc < 8; ++cc) v[e][cc][kx] = fmaf(xe[e], gv[cc], v[e][cc][kx]);
      }
    }
  }
  // adds the slices (neighbouring lanes) and writes the unit's sums
  __device__ void finish(const ConvIn& in, const FastBwdPlan& q, unsigned char*, float* part) {
    for (int off = q.ps / 2; off > 0; off >>= 1)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int k = 0; k < KH; ++k)
            v[e][c][k] += __shfl_xor_sync(0xffffffffu, v[e][c][k], off);
    const int u = threadIdx.x / q.ps, s = threadIdx.x % q.ps;
    if (u >= q.units || s != 0) return;
    const int co8n = q.ntd, cin = in.ca + in.cb, taps = KH * KH;
    const int co8 = u % co8n, ky = (u / co8n) % KH, c4 = u / (co8n * KH);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ci = 4 * c4 + e;
      if (ci >= cin) break;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int co = 8 * co8 + c;
        if (co >= in.cout) break;
#pragma unroll
        for (int k = 0; k < KH; ++k)
          part[((int64_t)co * cin + ci) * taps + ky * KH + k] = v[e][c][k];
      }
    }
  }
};

// bf16: PPW (M, N) tiles per warp, every tap
template <int KH, int PPW>
struct DwAcc<__nv_bfloat16, KH, PPW> {
  static constexpr int TAPS = KH * KH;
  float v[PPW][TAPS][4];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < PPW; ++i)
#pragma unroll
      for (int t = 0; t < TAPS; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) v[i][t][e] = 0.f;
  }
  // warp's i-th tile (or -1) and its K share
  __device__ int tile_of(const FastBwdPlan& q, int i) const {
    const int warp = threadIdx.x >> 5;
    const int t = q.ks == 1 ? warp + msau::fast::kWarps * i : (i == 0 ? warp / q.ks : q.pairs);
    return t < q.pairs ? t : -1;
  }
  __device__ void add_tile(const ConvIn& in, const msau::fast::Geo& g, const FastBwdPlan& q,
                           const __nv_bfloat16* xs, const __nv_bfloat16* G) {
    using Tl = msau::fast::Tile<__nv_bfloat16>;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int ksl = q.ks == 1 ? 0 : warp % q.ks;
    const int cs = g.cs, d = in.dil;
    int tl[PPW];
#pragma unroll
    for (int i = 0; i < PPW; ++i) tl[i] = tile_of(q, i);
    // lane's A row: pixel column 16 h + lane % 8 + 8 (lane / 16), channels
    // 16 mt + 8 ((lane / 8) % 2); B row: co 8 nt + lane % 8, pixels + 8 ((lane / 8) % 2)
    const __nv_bfloat16* xl =
        xs + (size_t)((lane & 7) + 8 * (lane >> 4) + Tl::V - in.pleft) * cs + 8 * ((lane >> 3) & 1);
    const __nv_bfloat16* gl = G + (lane & 7) * msau::fast::kGs + 8 * ((lane >> 3) & 1);
    for (int j = ksl; j < 2 * Tl::TH; j += q.ks) {
      const int r = j >> 1, h = j & 1;
#pragma unroll
      for (int i = 0; i < PPW; ++i) {
        if (tl[i] < 0) continue;
        const int mt = tl[i] / q.ntd, nt = tl[i] % q.ntd;
        unsigned b[2];
        msau::ldsm_x2(b, gl + 8 * nt * msau::fast::kGs + kTw * r + 16 * h);
        const __nv_bfloat16* xa = xl + (size_t)(r * Tl::SW + 16 * h) * cs + 16 * mt;
#pragma unroll
        for (int ky = 0; ky < KH; ++ky)
#pragma unroll
          for (int kx = 0; kx < KH; ++kx) {
            unsigned a[4];
            msau::ldsm_x4_trans(a, xa + (size_t)(ky * d * Tl::SW + kx * d) * cs);
            msau::mma_bf16(v[i][ky * KH + kx], a, b);
          }
      }
    }
  }
  // v[i][tap]: rows (input channels) 16 mt + lane / 4 and + 8, columns
  // (output channels) 8 nt + 2 (lane % 4) and + 1; with K shares, the
  // shares are added in order through shared memory (all of it: the caller
  // is done with the tile)
  __device__ void finish(const ConvIn& in, const FastBwdPlan& q, unsigned char* smem,
                         float* part) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int cin = in.ca + in.cb;
    auto emit = [&](int t, int tap, const float (&s)[4]) {
      const int mt = t / q.ntd, nt = t % q.ntd;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = 16 * mt + (lane >> 2) + 8 * (e >> 1);
        const int co = 8 * nt + 2 * (lane & 3) + (e & 1);
        if (ci < cin && co < in.cout) part[((int64_t)co * cin + ci) * TAPS + tap] = s[e];
      }
    };
    if (q.ks == 1) {
#pragma unroll
      for (int i = 0; i < PPW; ++i) {
        const int t = tile_of(q, i);
        if (t >= 0)
#pragma unroll
          for (int tap = 0; tap < TAPS; ++tap) emit(t, tap, v[i][tap]);
      }
      return;
    }
    float* red = reinterpret_cast<float*>(smem);
    __syncthreads();   // every warp is past its last tile
#pragma unroll
    for (int tap = 0; tap < TAPS; ++tap)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[((size_t)warp * TAPS + tap) * 128 + lane * 4 + e] = v[0][tap][e];
    __syncthreads();
    const int t = tile_of(q, 0);
    if (warp % q.ks != 0 || t < 0) return;
#pragma unroll
    for (int tap = 0; tap < TAPS; ++tap) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < q.ks; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[e] += red[((size_t)(warp + k) * TAPS + tap) * 128 + lane * 4 + e];
      emit(t, tap, s);
    }
  }
};

// The tile's cotangent g into gin[co][pixel] (activation dtype, zeros
// outside the image): cp.async 16-byte runs where the width allows
// (``async``), else loaded here.
template <typename T>
__device__ void stage_g(const BwdArgs& p, T* __restrict__ gin, int img, int x0, int y0,
                        bool async) {
  using Tl = msau::fast::Tile<T>;
  constexpr int V = Tl::V, RUNS = kTw / V;
  const ConvIn& in = p.in;
  const T* g = (const T*)p.g;
  const int items = in.cout * Tl::TH * RUNS;
  for (int it = threadIdx.x; it < items; it += msau::fast::kThreads) {
    const int q = it % RUNS, rest = it / RUNS;
    const int r = rest % Tl::TH, co = rest / Tl::TH;
    const int gy = y0 + r, gx = x0 + q * V;
    const bool ok = gy < in.h && gx < in.w_;
    const T* row = ok ? g + (((int64_t)img * in.cout + co) * in.h + gy) * in.w_ : nullptr;
    T* dst = gin + co * Tl::P + r * kTw + q * V;
    if (async)
      msau::cp_async16(dst, ok ? row + gx : g, ok);
    else
      *reinterpret_cast<uint4*>(dst) = msau::fast::load_run<T>(row, gx, in.w_, false);
  }
}

// Step 2 for one pixel per thread (threads past the tile's pixels: none):
// g0 from g (and the preactivation E, where there is an epilogue) into G
// (f32 [pixel][gs] or bf16 [co][kGs], rounded), to p.g0 where there is an
// epilogue, and (bf16 with an epilogue) unrounded into D [co][ES] for db.
template <typename T>
__device__ void epilogue_bwd(const BwdArgs& p, const FastBwdPlan& q, const T* gin,
                             const float* E, float* U, void* G, float* D, int img, int x0,
                             int y0) {
  using Tl = msau::fast::Tile<T>;
  constexpr int ES = Tl::ES;
  const int pp = threadIdx.x;
  if (pp >= Tl::P) return;   // whole warps
  const ConvIn& in = p.in;
  const int oy = y0 + pp / kTw, ox = x0 + pp % kTw;
  const bool inside = oy < in.h && ox < in.w_;
  const int cout = in.cout;
  const int64_t plane = (int64_t)in.h * in.w_;
  const int64_t off = (int64_t)img * cout * plane + (int64_t)oy * in.w_ + ox;
  const T* gp = gin + pp;   // g of channel co at gp[co * P]
  constexpr int P = Tl::P;
  const bool lrn = p.lrn_size > 0, epi = p.act != 0 || lrn;
  const float s = lrn ? p.alpha / (float)p.lrn_size : 0.f;
  const int lo = p.lrn_size / 2, hi = (p.lrn_size - 1) / 2;
  const float* e = E + pp;
  float* u = U + pp;            // g y1 r / t
  float* gr = U + cout * ES + pp;   // g r
  if (lrn && inside) {
    auto sq = [&](int c) {
      const float y = apply_act(e[c * ES], p.act);
      return y * y;
    };
    msau::fast::Window win;
    win.start(cout, hi, sq);
    for (int co = 0; co < cout; ++co) {
      const float t = p.lrn_k + s * win.sum, r = __powf(t, -p.beta);
      const float gv = to_f32(gp[co * P]);
      u[co * ES] = gv * apply_act(e[co * ES], p.act) * (r / t);
      gr[co * ES] = gv * r;
      win.step(co, cout, lo, hi, sq);
    }
  }
  // the mirror window [co - hi, co + lo] over u
  auto uv = [&](int c) { return u[c * ES]; };
  msau::fast::Window mu;
  if (lrn && inside) mu.start(cout, lo, uv);
  for (int co = 0; co < cout; ++co) {
    float g0 = 0.f;
    if (inside) {
      const float gv = to_f32(gp[co * P]);
      if (!epi) {
        g0 = gv;
      } else {
        const float a = e[co * ES];
        float g1 = gv;
        if (lrn) {
          g1 = gr[co * ES] - (2.f * p.beta * s) * apply_act(a, p.act) * mu.sum;
          mu.step(co, cout, hi, lo, uv);
        }
        g0 = g1 * act_grad(a, p.act);
        store((T*)p.g0 + off + co * plane, g0);
      }
    }
    if constexpr (sizeof(T) == 4) {
      reinterpret_cast<float*>(G)[pp * q.gs + co] = g0;
    } else {
      reinterpret_cast<T*>(G)[co * msau::fast::kGs + pp] = __float2bfloat16(g0);
      if (epi) D[co * ES + pp] = g0;
    }
  }
}

template <typename T, int KH, int NC, int PPW>
__global__ void __launch_bounds__(msau::fast::kThreads,
                                  sizeof(T) == 2 && KH == 3 && PPW == 1 ? 2 : 1)
conv_bwd_fast_kernel(BwdArgs p, msau::fast::Geo g, FastBwdPlan q, float* __restrict__ partial,
                     int64_t stride) {
  using namespace msau::fast;
  constexpr int TH = Tile<T>::TH;
  extern __shared__ __align__(16) float smem_f[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  const ConvIn& in = p.in;
  T* ws = reinterpret_cast<T*>(smem + q.w);
  T* xs = reinterpret_cast<T*>(smem + q.x);
  float* red = reinterpret_cast<float*>(smem + q.red);
  float* E = reinterpret_cast<float*>(smem + q.e);
  float* U = reinterpret_cast<float*>(smem + q.u);
  T* G = reinterpret_cast<T*>(smem + q.g);
  float* dbs = reinterpret_cast<float*>(smem + q.dbs);   // [cout][dns]
  T* gin = reinterpret_cast<T*>(smem + q.gin);   // [2][cout][P]
  T* raw = reinterpret_cast<T*>(smem + (q.raw >= 0 ? q.raw : 0));
  const bool epi = p.act != 0 || p.lrn_size > 0, async = q.raw >= 0;
  const int per_img = g.tiles_x * g.tiles_y, gsz = in.cout * Tile<T>::P;
  auto origin = [&](int tile, int& img, int& x0, int& y0) {
    img = tile / per_img;
    const int t2 = tile - img * per_img;
    x0 = (t2 % g.tiles_x) * kTw;
    y0 = (t2 / g.tiles_x) * TH;
  };
  // g0's padding rows / columns stay zero
  for (int i = threadIdx.x; i < (q.dbs - q.g) / 4; i += msau::fast::kThreads)
    reinterpret_cast<float*>(smem + q.g)[i] = 0.f;
  // db: thread (co, s) adds g0[co] over pixels s, s + dns, ... of each tile
  // (f32: kept in G; bf16: G with no epilogue, where g0 = g, else D)
  const int dns = msau::fast::kThreads / in.cout;
  const int dco = threadIdx.x / dns, dsl = threadIdx.x % dns;
  const float* D = U + (p.lrn_size > 0 ? in.cout * Tile<T>::ES : 0);
  float db = 0.f;
  if (epi) stage_weights<T>(in, g, ws, NC);
  if (async && (int)blockIdx.x < g.n_tiles) {
    int img, x0, y0;
    origin(blockIdx.x, img, x0, y0);
    prefetch_tile<T>(in, g, raw, img, x0, y0);
    stage_g<T>(p, gin, img, x0, y0, true);
    msau::cp_async_commit();
  }
  DwAcc<T, KH, PPW> acc;
  acc.zero();
  int buf = 0;
  for (int tile = blockIdx.x; tile < g.n_tiles; tile += gridDim.x, buf ^= 1) {
    int img, x0, y0;
    origin(tile, img, x0, y0);
    T* gt = gin + buf * gsz;
    if (async) {
      msau::cp_async_wait<0>();
      __syncthreads();   // the tile has landed; the last tile's dw is done
      transpose_tile<T>(g, raw, xs);
      __syncthreads();
      if (tile + (int)gridDim.x < g.n_tiles) {
        int img2, x2, y2;
        origin(tile + gridDim.x, img2, x2, y2);
        prefetch_tile<T>(in, g, raw, img2, x2, y2);
        stage_g<T>(p, gin + (buf ^ 1) * gsz, img2, x2, y2, true);
      }
      msau::cp_async_commit();
    } else {
      __syncthreads();   // the last tile's dw is done with xs and G
      stage_tile<T>(in, g, xs, img, x0, y0);
      stage_g<T>(p, gt, img, x0, y0, false);
      __syncthreads();
    }
    if (epi) {
      if constexpr (sizeof(T) == 4)
        conv_core_f32<KH, NC>(in, g, xs, ws, p.bias, red, E);
      else
        conv_core_bf16<KH, NC>(in, g, xs, ws, p.bias, E);
    }
    epilogue_bwd<T>(p, q, gt, E, U, G, (float*)D, img, x0, y0);
    __syncthreads();
    if (dco < in.cout) {
      constexpr int P = Tile<T>::P;
      if constexpr (sizeof(T) == 4) {
        for (int px = dsl; px < P; px += dns) db += G[px * q.gs + dco];
      } else {
        if (epi)
          for (int px = dsl; px < P; px += dns) db += D[dco * Tile<T>::ES + px];
        else
          for (int px = dsl; px < P; px += dns) db += to_f32(G[dco * kGs + px]);
      }
    }
    acc.add_tile(in, g, q, xs, G);
  }
  float* part = partial + (int64_t)blockIdx.x * stride;
  __syncthreads();
  if (dco < in.cout) dbs[threadIdx.x] = db;
  __syncthreads();
  if ((int)threadIdx.x < in.cout) {
    float v = 0.f;
    for (int s = 0; s < dns; ++s) v += dbs[threadIdx.x * dns + s];
    part[stride - in.cout + threadIdx.x] = v;
  }
  acc.finish(in, q, smem, part);
}

// -> the launches' code, or -1 (nothing launched) where the shape's shared
// memory or dw plan is past what the fast kernel takes
template <typename T, int KH, int NC, int PPW>
int launch_bwd_fast(const BwdArgs& p, int n, float* partial, float* out, cudaStream_t stream) {
  using namespace msau::fast;
  constexpr bool kF32 = sizeof(T) == 4;
  const ConvIn& in = p.in;
  const bool lrn = p.lrn_size > 0, epi = p.act != 0 || lrn;
  const Geo g = make_geo<T>(in, n, kF32 ? NC : 0);
  FastBwdPlan q{};
  q.ntd = (in.cout + 7) / 8;
  size_t gbytes;
  if constexpr (kF32) {
    q.units = g.kc * KH * q.ntd;
    if (q.units > msau::fast::kThreads) return -1;
    q.ps = 1;
    while (q.ps < 32 && 2 * q.ps * q.units <= msau::fast::kThreads) q.ps *= 2;
    q.gs = 4 * (2 * q.ntd + 1);
    gbytes = align16((size_t)Tile<T>::P * q.gs * 4);
  } else {
    q.pairs = g.kc * q.ntd;
    if (q.pairs > msau::fast::kWarps * PPW) return -1;
    q.ks = 1;
    while (2 * q.ks * q.pairs <= msau::fast::kWarps) q.ks *= 2;
    gbytes = align16((size_t)q.ntd * 8 * kGs * 2);
  }
  size_t at = 0;
  auto put = [&](int& field, size_t bytes) {
    field = (int)at;
    at += bytes;
  };
  put(q.w, epi ? w_bytes<T>(in, g, NC) : 0);
  put(q.x, xs_bytes<T>(g));
  put(q.red, epi && kF32 ? red_bytes(g) : 0);
  put(q.e, epi ? e_bytes<T>(in.cout) : 0);
  // U, then g r (LRN); bf16's unrounded g0 D in the g r rows or, with no
  // LRN, in U's
  put(q.u, (lrn ? 2 : !kF32 && epi ? 1 : 0) * e_bytes<T>(in.cout));
  put(q.g, gbytes);
  put(q.dbs, align16((size_t)msau::fast::kThreads * 4));
  put(q.gin, align16((size_t)2 * in.cout * Tile<T>::P * sizeof(T)));
  if (!kF32 && q.ks > 1) at = std::max(at, (size_t)msau::fast::kWarps * KH * KH * 128 * 4);
  if (at > 227 * 1024) return -1;
  // the cp.async prefetch where the runs allow it and shared memory holds it
  const bool gvec = in.w_ % Tile<T>::V == 0 && ((uintptr_t)p.g & 15) == 0;
  auto kernel = conv_bwd_fast_kernel<T, KH, NC, PPW>;
  q.raw = -1;
  const size_t with_raw = at + raw_bytes<T>(g);
  if (g.vec && gvec && with_raw <= 227 * 1024) {
    const cudaError_t err = msau::allow_smem(kernel, with_raw);
    if (err != cudaSuccess) return (int)err;
    // only where it costs no resident block (the grid fills 2 per SM at most)
    if (std::min(2, blocks_per_sm(kernel, with_raw)) >= std::min(2, blocks_per_sm(kernel, at)))
      put(q.raw, raw_bytes<T>(g));
  }
  q.total = (int)at;
  const cudaError_t err = msau::allow_smem(kernel, q.total);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (int)std::min<int64_t>(g.n_tiles, msau::kPartialBlocks);
  const int64_t stride = (int64_t)in.cout * g.cin * in.kh * in.kw + in.cout;
  kernel<<<blocks, msau::fast::kThreads, q.total, stream>>>(p, g, q, partial, stride);
  const int code = (int)cudaGetLastError();
  if (code != 0) return code;
  return msau::sum_partials(partial, blocks, stride, out, stream);
}

// The fast path where the shape allows it, else -1.  Instances: with no
// epilogue (dw alone) or at most 8 output channels, one per kernel side
// with the narrowest recompute tile (and in bf16, for more than 8 (M, N)
// tiles, one with two per warp); an epilogue over more channels, the 3x3
// kernel at each recompute tile width.
template <typename T>
int dispatch_fast(const BwdArgs& p, int n, float* partial, float* out, cudaStream_t s) {
  if (!msau::fast::fast_shape<T>(p.in) || p.in.kh == 1) return -1;
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int NC0 = kF32 ? 8 : 1;
  const int cout = p.in.cout;
  const bool epi = p.act != 0 || p.lrn_size > 0;
  if (!epi || cout <= 8) {
    if (p.in.kh == 4) return launch_bwd_fast<T, 4, NC0, 1>(p, n, partial, out, s);
    const int pairs = (p.in.ca + p.in.cb + 15) / 16 * ((cout + 7) / 8);
    if constexpr (!kF32)
      if (pairs > msau::fast::kWarps) return launch_bwd_fast<T, 3, NC0, 2>(p, n, partial, out, s);
    return launch_bwd_fast<T, 3, NC0, 1>(p, n, partial, out, s);
  }
  if (p.in.kh != 3) return -1;
  if constexpr (kF32) {
    if (cout > 16 && cout <= 24) return launch_bwd_fast<T, 3, 12, 1>(p, n, partial, out, s);
    return launch_bwd_fast<T, 3, 16, 1>(p, n, partial, out, s);
  } else {
    if (cout <= 16) return launch_bwd_fast<T, 3, 2, 1>(p, n, partial, out, s);
    if (cout <= 32) return launch_bwd_fast<T, 3, 4, 1>(p, n, partial, out, s);
    return launch_bwd_fast<T, 3, 8, 1>(p, n, partial, out, s);
  }
}

template <typename T>
int dispatch(const BwdArgs& p, int n, float* partial, float* out, cudaStream_t s) {
  const int fast = dispatch_fast<T>(p, n, partial, out, s);
  if (fast >= 0) return fast;
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
