// Stride-1 KH x KW conv with dilation d and explicit (TF-SAME by default)
// padding on NCHW, with the ConvBnLrnDrop epilogue fused: + bias, then
// relu / elu, then a LocalResponseNorm across the output channels (torch
// semantics: window [c - size/2, c + (size-1)/2] clamped to the channels,
// scaled by alpha / size), all on the f32 accumulator.  The input may be two
// tensors [a; b] read as their channel concat, which is never written out;
// the output may be split over two tensors (channels [0, cout_a) and the
// rest), which is how the backward writes the two branch cotangents of a
// concat conv as its transposed conv.
//
// Replaces the TPU kernels msau_tpu/ops/flatconv.py:_fwd_kernel (launcher
// _conv_body: convs, tuple-input merge convs, split-output dx convs, the
// fused epilogue) and _cc_fwd_kernel (launcher _concat_conv1x1_prim: the
// two-input 1x1 coupling conv, here the KH = KW = 1 case of the same
// kernel).  The TPU kernels build a tap stack in VMEM for one MXU matmul
// per row block, split a wide cin over separate launches and sum their
// outputs; here one block loops over every input channel itself.
//
// What bounds it on the H100.  A 3x3 conv does 9 cin cout multiply-adds
// per pixel against (cin + cout) values moved: 8 -> 8 in f32 is 1152
// operations for 64 B, 18 a byte.  The FP32 pipes (67 TFLOP/s) meet device
// memory (3.35 TB/s) at 20 a byte, so f32 there (held to 1e-5: no TF32) is
// bound by the pipes; f32 as six bf16 products on the tensor cores (989 / 6
// TFLOP/s) meets it at 49 a byte and bf16 (989) at 295, so on the tensor
// cores both dtypes are bound by device memory.
//
// The fast path (conv_fast.cuh; square 1x1, 3x3 and 4x4 kernels, up to 64
// -> 64 channels, taps within 16 bytes of columns of the tile: every conv
// and coupling of the flagship and config 5): a persistent grid of 8-warp
// blocks walks 32-column tiles (8 rows; 4 in f32 where 8 do not fit); each
// tile's input, every channel with its halo, is
// staged once as [pixel][channel] (prefetched by cp.async while the tile
// before computes, where the width allows 16-byte runs and the buffer costs
// no resident block); the conv is an implicit GEMM (M = pixels, N = cout,
// K = taps x cin) on mma.sync from ldmatrix, one warp per 32 or 16 pixels
// with every output channel: bf16 as it is, f32 as three bf16 parts of
// each operand, split as they are staged, six products a k step.  The
// sums land in shared memory as [co][pixel] and one thread per pixel adds
// the bias, applies the act and the LRN window (a running sum over the
// channels) and writes every output channel once.
//
// f32 shapes whose three parts do not fit a block's shared memory even in
// tiles of 4 rows (wide weights: 48 -> 48 at 3x3, 32 -> 48 at 4x4) run on
// the FP32 pipes instead, in tiles of 4 rows: 4 x 16 register tiles, K
// split across warps and summed through shared memory.
//
// The general path (any other kernel size, wider channels): one block per
// 32-column x TH-row output tile and 32 output channels (a wider cout takes
// several blocks); each thread owns one column and 64 / COUT rows, with all
// COUT accumulators in registers (conv_tile.cuh), FP32 pipes in both
// dtypes; the epilogue runs on the registers.  An LRN over more than 32
// channels needs channels of other blocks: such a block (one row per
// thread, TH = 4) recomputes the conv of every 32-channel chunk its
// channels' windows touch and adds their squares into its window sums, so
// cout and the LRN size are unbounded.

#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "conv_fast.cuh"
#include "conv_tile.cuh"

namespace {

using msau::apply_act;
using msau::conv_tile;
using msau::ConvIn;
using msau::kThreads;
using msau::kTw;
using msau::kTy;
using msau::store;

constexpr int kAcc = 64;      // f32 accumulators per thread

struct ConvArgs {
  ConvIn in;
  const float* bias;   // [cout]
  void* y;             // [n, cout_a, h, w]
  void* y2;            // [n, cout - cout_a, h, w] or null (cout_a = cout)
  int cout_a, act, lrn_size;
  float alpha, beta, lrn_k;
};

// LocalResponseNorm across the COUT registers of one pixel (channels at or
// above cout are padding and never enter a window).
template <int COUT>
__device__ __forceinline__ void lrn_inplace(float (&v)[COUT], int cout, int size,
                                            float alpha, float beta, float k) {
  const int lo = size / 2, hi = (size - 1) / 2;
  const float scale = alpha / (float)size;
  float sq[COUT];
#pragma unroll
  for (int c = 0; c < COUT; ++c) sq[c] = v[c] * v[c];
#pragma unroll
  for (int co = 0; co < COUT; ++co) {
    float win = 0.f;
#pragma unroll
    for (int c = 0; c < COUT; ++c)
      if (c < cout && c >= co - lo && c <= co + hi) win += sq[c];
    v[co] *= powf(k + scale * win, -beta);
  }
}

// Writes output channel co of pixel (oy, ox) into y or y2.
template <typename T>
__device__ __forceinline__ void store_split(const ConvArgs& p, int img, int co, int oy,
                                            int ox, float v) {
  const int64_t plane = (int64_t)p.in.h * p.in.w_;
  const int64_t off = (int64_t)oy * p.in.w_ + ox;
  if (co < p.cout_a)
    store((T*)p.y + ((int64_t)img * p.cout_a + co) * plane + off, v);
  else
    store((T*)p.y2 + ((int64_t)img * (p.in.cout - p.cout_a) + co - p.cout_a) * plane +
              off, v);
}

template <typename T, int COUT>
__global__ void __launch_bounds__(kThreads)
conv_kernel(ConvArgs p, int groups) {
  constexpr int PIX = kAcc / COUT;   // output rows per thread
  extern __shared__ __align__(16) float smem[];
  const int img = blockIdx.z / groups, co0 = (blockIdx.z % groups) * COUT;
  const int x0 = blockIdx.x * kTw, y0 = blockIdx.y * (kTy * PIX);
  const int tx = threadIdx.x % kTw, ty = threadIdx.x / kTw;
  float acc[PIX][COUT];
  conv_tile<T, COUT, PIX>(p.in, smem, img, co0, x0, y0, acc);

  float bv[COUT];
#pragma unroll
  for (int c = 0; c < COUT; ++c)
    bv[c] = co0 + c < p.in.cout ? p.bias[co0 + c] : 0.f;
  const int ox = x0 + tx;
#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    const int oy = y0 + ty * PIX + i;
    float v[COUT];
#pragma unroll
    for (int c = 0; c < COUT; ++c) v[c] = apply_act(acc[i][c] + bv[c], p.act);
    if (p.lrn_size > 0)
      lrn_inplace(v, p.in.cout, p.lrn_size, p.alpha, p.beta, p.lrn_k);
    if (oy < p.in.h && ox < p.in.w_) {
#pragma unroll
      for (int c = 0; c < COUT; ++c)
        if (co0 + c < p.in.cout) store_split<T>(p, img, co0 + c, oy, ox, v[c]);
    }
  }
}

// cout > 32 with LRN: 32 channels per block, one row per thread; the
// squares of every channel in the block's windows come from recomputing
// the conv of each 32-channel chunk they lie in (ascending channel order,
// as lrn_inplace sums).
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_lrn_wide_kernel(ConvArgs p, int groups) {
  constexpr int COUT = 32;
  extern __shared__ __align__(16) float smem[];
  const int img = blockIdx.z / groups, co0 = (blockIdx.z % groups) * COUT;
  const int x0 = blockIdx.x * kTw, y0 = blockIdx.y * kTy;
  const int tx = threadIdx.x % kTw, ty = threadIdx.x / kTw;
  const int cout = p.in.cout, lo = p.lrn_size / 2, hi = (p.lrn_size - 1) / 2;
  float v[COUT], win[COUT];
#pragma unroll
  for (int c = 0; c < COUT; ++c) v[c] = win[c] = 0.f;
  const int j_end = min(cout - 1, co0 + COUT - 1 + hi) / COUT;
  for (int j = max(0, co0 - lo) / COUT; j <= j_end; ++j) {
    float acc[1][COUT];
    conv_tile<T, COUT, 1>(p.in, smem, img, j * COUT, x0, y0, acc);
#pragma unroll
    for (int c = 0; c < COUT; ++c) {
      const int ch = j * COUT + c;
      const float y = ch < cout ? apply_act(acc[0][c] + p.bias[ch], p.act) : 0.f;
      if (j * COUT == co0) v[c] = y;
      const float sq = y * y;
#pragma unroll
      for (int co = 0; co < COUT; ++co)
        if (ch < cout && ch >= co0 + co - lo && ch <= co0 + co + hi) win[co] += sq;
    }
  }
  const float scale = p.alpha / (float)p.lrn_size;
  const int oy = y0 + ty, ox = x0 + tx;
  if (oy < p.in.h && ox < p.in.w_) {
#pragma unroll
    for (int c = 0; c < COUT; ++c)
      if (co0 + c < cout)
        store_split<T>(p, img, co0 + c, oy, ox,
                       v[c] * powf(p.lrn_k + scale * win[c], -p.beta));
  }
}

template <typename Kernel>
int launch_grid(Kernel kernel, const ConvArgs& p, int n, int cout_blk, int th,
                size_t smem, cudaStream_t stream) {
  const int groups = (p.in.cout + cout_blk - 1) / cout_blk;
  if ((int64_t)n * groups > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = msau::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.in.w_ + kTw - 1) / kTw, (p.in.h + th - 1) / th, n * groups);
  kernel<<<grid, kThreads, smem, stream>>>(p, groups);
  return (int)cudaGetLastError();
}

template <typename T, int COUT>
int launch(const ConvArgs& p, int n, cudaStream_t stream) {
  constexpr int TH = kTy * (kAcc / COUT);
  const size_t smem = msau::conv_tile_floats<COUT>(p.in, TH) * sizeof(float);
  return launch_grid(conv_kernel<T, COUT>, p, n, COUT, TH, smem, stream);
}

// ---- the fast path (see the top of the file and conv_fast.cuh) ----------

// One pixel's epilogue: act(E + bias) (E holds the bias), then the LRN over
// the output channels, stored to y / y2.
template <typename T, int TH>
__device__ inline void epilogue_fwd(const ConvArgs& p, const float* E, int img, int x0,
                                    int y0) {
  using Tl = msau::fast::Tile<T, TH>;
  const int pp = threadIdx.x;
  if (pp >= Tl::P) return;
  const int oy = y0 + pp / kTw, ox = x0 + pp % kTw;
  if (oy >= p.in.h || ox >= p.in.w_) return;
  const float* e = E + pp;
  const int cout = p.in.cout;
  const int64_t plane = (int64_t)p.in.h * p.in.w_, off = (int64_t)oy * p.in.w_ + ox;
  T* ya = (T*)p.y + (int64_t)img * p.cout_a * plane + off;   // channel co at ya[co plane]
  T* yb = p.cout_a < cout
              ? (T*)p.y2 + ((int64_t)img * (cout - p.cout_a) - p.cout_a) * plane + off
              : ya;
  const bool lrn = p.lrn_size > 0;
  const float scale = lrn ? p.alpha / (float)p.lrn_size : 0.f;
  const int lo = p.lrn_size / 2, hi = (p.lrn_size - 1) / 2;
  auto sq = [&](int c) {
    const float y = apply_act(e[c * Tl::ES], p.act);
    return y * y;
  };
  msau::fast::Window win;
  if (lrn) win.start(cout, hi, sq);
  for (int co = 0; co < cout; ++co) {
    float v = apply_act(e[co * Tl::ES], p.act);
    if (lrn) {
      v *= __powf(p.lrn_k + scale * win.sum, -p.beta);
      win.step(co, cout, lo, hi, sq);
    }
    store((co < p.cout_a ? ya : yb) + co * plane, v);
  }
}

// NC: n-tiles of 8 output channels on the tensor cores (NT); in f32 on the
// FP32 pipes, output channels per warp group (CT).  MT > 0: f32 on the
// tensor cores, tiles of 4 MT rows.  Shared memory: the weights, then the
// staged tile (the FP32 pipes: its space then holds the K shares; the
// tensor cores: then E), then the FP32 pipes' E.  off_r >= 0: the input is
// prefetched there by cp.async (double buffered with xs); else staged
// synchronously.
template <typename T, int KH, int NC, int MT = 0>
__global__ void __launch_bounds__(msau::fast::kThreads, MT * NC >= 16 ? 1 : 2)
conv_fast_kernel(ConvArgs p, msau::fast::Geo g, int off_x, int off_e, int off_r) {
  using namespace msau::fast;
  constexpr bool kTc = MT > 0;
  constexpr int TH = kTc ? 4 * MT : Tile<T>::TH;
  extern __shared__ __align__(16) float smem_f[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  T* ws = reinterpret_cast<T*>(smem);
  T* xs = reinterpret_cast<T*>(smem + off_x);
  float* E = reinterpret_cast<float*>(smem + off_e);
  T* raw = reinterpret_cast<T*>(smem + (off_r >= 0 ? off_r : 0));
  using bf16 = __nv_bfloat16;
  [[maybe_unused]] const PartStore parts{reinterpret_cast<bf16*>(xs), g.cs, g.sw, g.psz};
  const int per_img = g.tiles_x * g.tiles_y;
  auto origin = [&](int tile, int& img, int& x0, int& y0) {
    img = tile / per_img;
    const int t2 = tile - img * per_img;
    x0 = (t2 % g.tiles_x) * kTw;
    y0 = (t2 / g.tiles_x) * TH;
  };
  if constexpr (kTc)
    stage_weights_tc(p.in, g, reinterpret_cast<bf16*>(ws), NC);
  else
    stage_weights<T>(p.in, g, ws, NC);
  if (off_r >= 0 && (int)blockIdx.x < g.n_tiles) {
    int img, x0, y0;
    origin(blockIdx.x, img, x0, y0);
    prefetch_tile<T>(p.in, g, raw, img, x0, y0);
    msau::cp_async_commit();
  }
  for (int tile = blockIdx.x; tile < g.n_tiles; tile += gridDim.x) {
    int img, x0, y0;
    origin(tile, img, x0, y0);
    if (off_r >= 0) {
      msau::cp_async_wait<0>();
      __syncthreads();   // the tile has landed; the last epilogue is done
      if constexpr (kTc)
        transpose_runs_from<T>(g, raw, parts);
      else
        transpose_tile<T>(g, raw, xs);
      __syncthreads();
      if (tile + (int)gridDim.x < g.n_tiles) {
        int img2, x2, y2;
        origin(tile + gridDim.x, img2, x2, y2);
        prefetch_tile<T>(p.in, g, raw, img2, x2, y2);
      }
      msau::cp_async_commit();
    } else {
      __syncthreads();   // the last tile's epilogue is done with E / xs
      if constexpr (kTc)
        stage_runs<T>(p.in, g, parts, img, x0, y0);
      else
        stage_tile<T>(p.in, g, xs, img, x0, y0);
      __syncthreads();
    }
    if constexpr (kTc) {
      float acc[MT][NC][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
      const bf16* xb = reinterpret_cast<const bf16*>(xs);
      const bf16* wb = reinterpret_cast<const bf16*>(ws);
      conv_core_tc<KH, NC, MT>(p.in, g, xb, wb, 0, acc);
      for (int j = 1; j < g.nch; ++j) {   // the next kChunk input channels
        __syncthreads();
        stage_runs<T>(p.in, g, parts, img, x0, y0, j * kChunk);
        __syncthreads();
        conv_core_tc<KH, NC, MT>(p.in, g, xb, wb, j, acc);
      }
      store_tc<NC, MT>(p.in, acc, p.bias, E);
    } else if constexpr (sizeof(T) == 4) {
      conv_core_f32<KH, NC>(p.in, g, (const float*)xs, (const float*)ws, p.bias,
                            (float*)xs, E);
    } else {
      conv_core_bf16<KH, NC>(p.in, g, xs, ws, p.bias, E);
    }
    epilogue_fwd<T, TH>(p, E, img, x0, y0);
  }
}

// Blocks of a persistent grid: as many as fit on the card at once.
template <typename Kernel>
int resident_blocks(Kernel kernel, size_t smem) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return msau::fast::blocks_per_sm(kernel, smem) * std::max(1, sms);
}

// Launches a fast kernel over g's tiles with ``smem`` bytes of shared
// memory, plus the cp.async prefetch buffer where the runs allow it (and a
// tile's input is staged in one pass), shared memory holds it and it costs
// no resident block.
template <typename T, typename Kernel>
int launch_tiles(Kernel kernel, const ConvArgs& p, const msau::fast::Geo& g, size_t smem,
                 int off_x, int off_e, cudaStream_t stream, bool one_pass = true) {
  using namespace msau::fast;
  int off_r = -1;
  const size_t with_raw = smem + raw_bytes<T>(g);
  if (one_pass && g.vec && with_raw <= 227 * 1024) {
    const cudaError_t err = msau::allow_smem(kernel, with_raw);
    if (err != cudaSuccess) return (int)err;
    if (blocks_per_sm(kernel, with_raw) >= blocks_per_sm(kernel, smem)) {
      off_r = (int)smem;
      smem = with_raw;
    }
  }
  const cudaError_t err = msau::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (int)std::min<int64_t>(g.n_tiles, resident_blocks(kernel, smem));
  kernel<<<blocks, msau::fast::kThreads, smem, stream>>>(p, g, off_x, off_e, off_r);
  return (int)cudaGetLastError();
}

// -> the launch's code, or -1 (nothing launched) where the shared memory
// the shape needs is more than a block may have
template <typename T, int KH, int NC>
int launch_fast(const ConvArgs& p, int n, cudaStream_t stream) {
  using namespace msau::fast;
  constexpr bool kF32 = sizeof(T) == 4;
  const Geo g = make_geo<T>(p.in, n, kF32 ? NC : 0);
  const size_t wb = w_bytes<T>(p.in, g, NC);
  const size_t region = kF32 ? std::max(xs_bytes<T>(g), red_bytes(g))
                             : std::max(xs_bytes<T>(g), e_bytes<T>(p.in.cout));
  const size_t smem = wb + region + (kF32 ? e_bytes<T>(p.in.cout) : 0);
  if (smem > 227 * 1024) return -1;
  return launch_tiles<T>(conv_fast_kernel<T, KH, NC>, p, g, smem, (int)wb,
                         (int)(kF32 ? wb + region : wb), stream);
}

template <int NT>
int launch_fast_k(const ConvArgs& p, int n, cudaStream_t stream) {
  using T = __nv_bfloat16;
  if (p.in.kh == 1) return launch_fast<T, 1, NT>(p, n, stream);
  return p.in.kh == 3 ? launch_fast<T, 3, NT>(p, n, stream)
                      : launch_fast<T, 4, NT>(p, n, stream);
}

// the n-tiles of 8 output channels a tensor-core instance holds: 1, 2, 3,
// 4 or 8
int cout_tiles(int cout) {
  return cout <= 8 ? 1 : cout <= 16 ? 2 : cout <= 24 ? 3 : cout <= 32 ? 4 : 8;
}

// ---- f32 on the tensor cores ----------------------------------------------

// shared memory of tiles of 4 mt rows: the weights' three parts, then the
// tile's (E in their place once the conv is summed)
size_t tc_smem(const ConvIn& in, const msau::fast::Geo& g, int mt) {
  using namespace msau::fast;
  const size_t e = align16((size_t)in.cout * (32 * 4 * mt + 4) * 4);
  return parts_bytes(g.wsz) + std::max(parts_bytes(g.psz), e);
}
size_t tc_smem(const ConvIn& in, int mt, bool passes) {
  return tc_smem(in, msau::fast::make_geo_tc(in, 1, mt, cout_tiles(in.cout), passes), mt);
}

// f32 fast shapes on the tensor cores: tiles of 8 rows (2), of 4 (1) where
// 8 rows' parts pass a block's shared memory (of the fast shapes only 3x3
// kernels into more than 24 channels), else the FP32 pipes (0).
int tc_plan(const ConvIn& in) {
  if (!msau::fast::fast_shape<float>(in)) return 0;
  if (tc_smem(in, 2, true) <= 227 * 1024) return 2;
  return in.kh == 3 && in.cout > 24 && tc_smem(in, 1, true) <= 227 * 1024 ? 1 : 0;
}

// A tile's input channels are staged in one pass where the cp.async
// prefetch can hold them (it overlaps their staging with the tile before),
// else in passes of kChunk, which leave room for more resident blocks.
template <int KH, int NT, int MT>
int launch_tc(const ConvArgs& p, int n, cudaStream_t stream) {
  using namespace msau::fast;
  Geo g = make_geo_tc(p.in, n, MT, NT, false);
  if (!(g.vec && tc_smem(p.in, g, MT) + raw_bytes<float>(g) <= 227 * 1024))
    g = make_geo_tc(p.in, n, MT, NT, true);
  const int wb = (int)parts_bytes(g.wsz);
  return launch_tiles<float>(conv_fast_kernel<float, KH, NT, MT>, p, g, tc_smem(p.in, g, MT),
                             wb, wb, stream, g.nch == 1);
}

template <int NT>
int launch_tc_k(const ConvArgs& p, int n, int mt, cudaStream_t stream) {
  if constexpr (NT >= 4)
    if (mt == 1) return launch_tc<3, NT, 1>(p, n, stream);
  const int kh = p.in.kh;
  return kh == 1 ? launch_tc<1, NT, 2>(p, n, stream)
                 : kh == 3 ? launch_tc<3, NT, 2>(p, n, stream) : launch_tc<4, NT, 2>(p, n, stream);
}

int dispatch_tc(const ConvArgs& p, int n, int mt, cudaStream_t stream) {
  switch (cout_tiles(p.in.cout)) {
    case 1: return launch_tc_k<1>(p, n, mt, stream);
    case 2: return launch_tc_k<2>(p, n, mt, stream);
    case 3: return launch_tc_k<3>(p, n, mt, stream);
    case 4: return launch_tc_k<4>(p, n, mt, stream);
    default: return launch_tc_k<8>(p, n, mt, stream);
  }
}

// The fast path where the shape allows it, else -1.
template <typename T>
int dispatch_fast(const ConvArgs& p, int n, cudaStream_t stream) {
  if (!msau::fast::fast_shape<T>(p.in)) return -1;
  if constexpr (sizeof(T) == 4) {
    const int mt = tc_plan(p.in);
    if (mt > 0) return dispatch_tc(p, n, mt, stream);
    // the FP32 pipes: 3x3 and 4x4 kernels into more than 24 channels
    return p.in.kh == 1 ? -1
           : p.in.kh == 3 ? launch_fast<T, 3, 16>(p, n, stream)
                          : launch_fast<T, 4, 16>(p, n, stream);
  } else {
    switch (cout_tiles(p.in.cout)) {
      case 1: return launch_fast_k<1>(p, n, stream);
      case 2: return launch_fast_k<2>(p, n, stream);
      case 3: return launch_fast_k<3>(p, n, stream);
      case 4: return launch_fast_k<4>(p, n, stream);
      default: return launch_fast_k<8>(p, n, stream);
    }
  }
}

template <typename T>
int dispatch(const ConvArgs& p, int n, cudaStream_t stream) {
  const int fast = dispatch_fast<T>(p, n, stream);
  if (fast >= 0) return fast;
  if (p.in.cout <= 8) return launch<T, 8>(p, n, stream);
  if (p.in.cout <= 16) return launch<T, 16>(p, n, stream);
  if (p.in.cout <= 32 || p.lrn_size == 0) return launch<T, 32>(p, n, stream);
  const size_t smem = msau::conv_tile_floats<32>(p.in, kTy) * sizeof(float);
  return launch_grid(conv_lrn_wide_kernel<T>, p, n, 32, kTy, smem, stream);
}

}  // namespace

// a: [n, ca, h, w]; b: [n, cb, h, w] or null with cb = 0; w: [cout, ca + cb,
// kh, kw] in the activation dtype; bias: [cout] f32; y: [n, cout_a, h, w]
// and y2: [n, cout - cout_a, h, w] (null with cout_a = cout).  pt / pleft:
// the padding above / left of the image (the output has the input's size).
// act: 0 none, 1 relu, 2 elu.  lrn_size 0 skips the LRN.
extern "C" int msau_flat_conv2d(const void* a, const void* b, const void* w,
                                const void* bias, void* y, void* y2, int n, int ca,
                                int cb, int h, int wd, int cout, int cout_a, int kh,
                                int kw, int dil, int pt, int pleft, int act,
                                int lrn_size, float alpha, float beta, float lrn_k,
                                int is_bf16, void* stream) {
  if (n < 0 || ca <= 0 || cb < 0 || h < 0 || wd < 0 || cout <= 0 || kh <= 0 ||
      kw <= 0 || dil <= 0 || pt < 0 || pleft < 0 || pt > (kh - 1) * dil ||
      pleft > (kw - 1) * dil || act < 0 || act > 2 || lrn_size < 0 ||
      (cb > 0 && b == nullptr) || cout_a <= 0 || cout_a > cout ||
      (cout_a < cout && y2 == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || h == 0 || wd == 0) return 0;
  const ConvArgs p{{a, b, w, ca, cb, h, wd, cout, kh, kw, dil, pt, pleft},
                   (const float*)bias, y, y2, cout_a, act, lrn_size, alpha, beta,
                   lrn_k};
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? dispatch<__nv_bfloat16>(p, n, s) : dispatch<float>(p, n, s);
}

// 1 where msau_flat_conv2d runs this shape in f32 on the tensor cores (the
// launches ops/flatconv.py counts in ``tc_launches``), else 0.
extern "C" int msau_flat_conv_tc(int ca, int cb, int cout, int kh, int kw, int dil,
                                 int pleft, int is_bf16) {
  if (is_bf16 || ca <= 0 || cb < 0 || cout <= 0 || kh <= 0 || kw <= 0 || dil <= 0 ||
      pleft < 0)
    return 0;
  const ConvIn in{nullptr, nullptr, nullptr, ca, cb, 1, 1, cout, kh, kw, dil, 0, pleft};
  return tc_plan(in) > 0 ? 1 : 0;
}
