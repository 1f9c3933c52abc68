// The flat conv's fast path (flatconv.cu's forward and dx, flatconv_bwd.cu's
// stage 1): the pieces both kernels share.
//
// A block of 8 warps walks output tiles of TH rows x 32 columns of one image
// (TH = 4 in f32 on the FP32 pipes, 8 in bf16, 8 or 4 in f32 on the tensor
// cores).  Per tile it stages the input once, every input channel of the
// tile and its dilated halo, as [pixel][channel]: each staged pixel is a run
// of channels laid out so that the 8 pixels an ldmatrix or 8 lanes of a
// float4 load read fall in 8 distinct bank groups, and a tap's window is a
// shift by whole pixels.  Global rows are read as 16-byte runs from an
// aligned column x0 - V (V = 16 bytes of elements), so the staged rows span
// 32 + 2V columns and the taps may reach up to V columns left or right of
// the tile; runs of V channels x V pixels are transposed in registers.
// Where the width allows 16-byte runs, the next tile's rows are prefetched
// by cp.async into a buffer of their own while the block computes this one,
// then transposed on chip (prefetch_tile, transpose_tile); else they are
// loaded and transposed in one step (stage_tile).  Work items take the
// channel group fastest, so a warp's stores to the staged pixels fall in
// distinct bank groups.
//
// The conv over a staged tile, preact[co][pixel] (+ bias, f32), is an
// implicit GEMM, M = the tile's pixels, N = output channels, K = taps x
// input channels:
//   - bf16 on the tensor cores: mma.sync m16n8k16 (f32 sums), A (16 pixels
//     x 16 channels) by ldmatrix from the staged pixels at the tap's shift,
//     B from the weights staged as [tap][cout][channel]; warp w owns tile
//     row w (two m-tiles) and every output channel.  Staged pixels are runs
//     padded to an odd number of 16-byte chunks;
//   - f32 on the tensor cores (conv_core_tc): the same products with each
//     operand split into three bf16 parts x = x0 + x1 + x2 when it is
//     staged, and the six products qa + qb < 3 of each k step summed as the
//     attention's f32 products are (attention_mma.cuh: mma_parts), which
//     carries them to f32's 24 bits (no TF32: two parts carry 16).  Each
//     part is staged as [pixel][channel] runs of 8-channel chunks of 16
//     bytes (an odd number of chunks, or a power of two with the chunk
//     index XORed with pixel bits), at most 32 channels a pass; K runs over
//     (tap, chunk) pairs, two a k16 step and an odd last one an m16n8k8
//     step.  Warp w owns MT m-tiles (TH = 4 MT) and every output channel:
//     no K split;
//   - f32 on the FP32 pipes (stage 1): lane c owns column c and the
//     tile's 4 rows, with 8 or 16 output channels in registers (64 sums);
//     the warps split the output channels and K, and add their K shares in
//     order through shared memory.  Each float4 of input feeds 4 x CT FMAs.
// The result lands in shared memory as f32 [co][pixel] for an epilogue that
// runs one thread per pixel (bias, act, LRN; or the LRN / act backward).

#pragma once

#include <stdint.h>

#include <algorithm>

#include "attention_mma.cuh"
#include "conv_tile.cuh"

namespace msau {
namespace fast {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

template <typename T, int TH_ = sizeof(T) == 4 ? 4 : 8>
struct Tile {
  static constexpr int V = 16 / (int)sizeof(T);   // elements per 16 bytes
  static constexpr int TH = TH_;                  // tile rows
  static constexpr int SW = kTw + 2 * V;          // staged columns
  static constexpr int P = TH * kTw;              // tile pixels
  static constexpr int ES = P + 4;                // f32 [co][pixel] row stride
};

// bf16 g0 rows [co][pixel] (stage 1's dw operand): ldmatrix-friendly stride
constexpr int kGs = ldsm_stride(8 * kTw);

struct Geo {
  int cin;
  int cgs;      // V-channel groups staged per pixel (zeros past cin)
  int cs;       // staged pixel stride in elements (an odd number of 16 B)
  int kc;       // bf16: k16 steps over the channels; f32: float4 groups
  int hr;       // staged rows
  int ng, ns;   // f32 conv: output-channel groups of CT and K shares
  int co;       // f32 conv: ng * CT, the weights' row length
  int tiles_x, tiles_y, n_tiles;
  int vec;      // 16-byte global loads (width and pointers allow them)
  int rgs;      // prefetch buffer: elements per group of V channels
  // f32 on the tensor cores: pixel bits >> sw pick a staged pixel's chunk
  // XOR, wcs / wsw the weight rows' stride and XOR shift; psz / wsz the
  // bf16 elements of one part of the tile, of the weights; nch passes of
  // kChunk input channels staged per tile
  int sw, wcs, wsw, psz, wsz, nch;
};

// f32 on the tensor cores: input channels staged per pass over a tile
constexpr int kChunk = 32;

// resident blocks of kThreads per SM at ``smem`` bytes of shared memory
// (the kernel's attribute must already allow them)
template <typename Kernel>
inline int blocks_per_sm(Kernel kernel, size_t smem) {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem);
  return n > 0 ? n : 1;
}

template <typename T>
inline Geo make_geo(const ConvIn& p, int n, int ct) {
  using Tl = Tile<T>;
  Geo g{};
  g.cin = p.ca + p.cb;
  if (sizeof(T) == 4) {
    g.kc = (g.cin + 3) / 4;
    g.cgs = g.kc;
    g.cs = 4 * (g.kc | 1);
  } else {
    g.kc = (g.cin + 15) / 16;
    g.cgs = 2 * g.kc;
    g.cs = 8 * (2 * g.kc + 1);
  }
  g.hr = Tl::TH + (p.kh - 1) * p.dil;
  // an odd number of 16-byte chunks per channel group, so the V-channel
  // groups a warp's lanes read lie in distinct bank groups
  g.rgs = Tl::V * g.hr * Tl::SW + ((g.hr * Tl::SW) % 2 == 0 ? Tl::V : 0);
  g.ng = ct > 0 ? (p.cout + ct - 1) / ct : 1;
  g.ns = kWarps / g.ng;
  g.co = g.ng * ct;
  g.tiles_x = (p.w_ + kTw - 1) / kTw;
  g.tiles_y = (p.h + Tl::TH - 1) / Tl::TH;
  g.n_tiles = n * g.tiles_x * g.tiles_y;
  const auto aligned = [](const void* q) { return ((uintptr_t)q & 15) == 0; };
  g.vec = p.w_ % Tl::V == 0 && aligned(p.a) && (p.b == nullptr || aligned(p.b));
  return g;
}

// f32 on the tensor cores, tiles of 4 MT rows, input channels staged in
// one pass or (``passes``) in nch passes of at most kChunk: each pixel of
// a part holds cs channels, the pass's in 8-channel chunks of 16 bytes,
// each weight row wcs >= cin (zeros past cin).
inline Geo make_geo_tc(const ConvIn& p, int n, int mt, int nt, bool passes) {
  using Tl = Tile<float>;
  Geo g{};
  g.cin = p.ca + p.cb;
  g.nch = passes ? (g.cin + kChunk - 1) / kChunk : 1;
  const int pass = passes ? std::min(g.cin, kChunk) : g.cin;
  // m chunks a row: 8 rows at a stride of an odd number of chunks fall in
  // distinct bank groups as they lie; at 2, 4 or 8 chunks the chunk index
  // is XORed with row bits >> sw (8 / m rows share an XOR)
  const auto chunks = [](int c, int& sw) {
    int m = (c + 7) / 8;
    if (m == 6) m = 7;
    sw = m == 2 ? 2 : m == 4 ? 1 : m == 8 ? 0 : 31;
    return 8 * m;
  };
  g.cs = chunks(pass, g.sw);
  g.wcs = chunks(g.nch > 1 ? g.nch * kChunk : g.cin, g.wsw);   // every pass's chunks
  g.cgs = g.cs / 4;
  const int th = 4 * mt;
  g.hr = th + (p.kh - 1) * p.dil;
  g.rgs = Tl::V * g.hr * Tl::SW + ((g.hr * Tl::SW) % 2 == 0 ? Tl::V : 0);
  g.psz = g.hr * Tl::SW * g.cs;
  g.wsz = p.kh * p.kw * nt * 8 * g.wcs;
  g.tiles_x = (p.w_ + kTw - 1) / kTw;
  g.tiles_y = (p.h + th - 1) / th;
  g.n_tiles = n * g.tiles_x * g.tiles_y;
  const auto aligned = [](const void* q) { return ((uintptr_t)q & 15) == 0; };
  g.vec = p.w_ % Tl::V == 0 && aligned(p.a) && (p.b == nullptr || aligned(p.b));
  return g;
}

// The tile geometry the fast path takes: a square kernel of side 1 (the
// coupling conv; forward only), 3 or 4, at most 64 input and 64 output
// channels, taps reaching at most V columns past either side of the tile.
template <typename T>
inline bool fast_shape(const ConvIn& p) {
  constexpr int V = Tile<T>::V;
  const int right = (p.kw - 1) * p.dil - p.pleft;
  return p.kh == p.kw && (p.kh == 1 || p.kh == 3 || p.kh == 4) && p.ca + p.cb <= 64 &&
         p.cout <= 64 && p.pleft <= V && right >= 0 && right <= V;
}

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) & ~(size_t)15; }

template <typename T>
inline size_t xs_bytes(const Geo& g) {
  return align16((size_t)g.hr * Tile<T>::SW * g.cs * sizeof(T));
}
// weights: bf16 [tap][nt * 8][cs]; f32 [tap][kc * 4][co]
template <typename T>
inline size_t w_bytes(const ConvIn& p, const Geo& g, int nt) {
  const size_t taps = (size_t)p.kh * p.kw;
  return sizeof(T) == 4 ? align16(taps * g.kc * 4 * g.co * 4)
                        : align16(taps * nt * 8 * g.cs * 2);
}
// the f32 conv's K shares: [ns][co][P]
inline size_t red_bytes(const Geo& g) {
  return align16((size_t)g.ns * g.co * Tile<float>::P * 4);
}
template <typename T, int TH = Tile<T>::TH>
inline size_t e_bytes(int cout) {
  return align16((size_t)cout * Tile<T, TH>::ES * 4);
}
// f32 on the tensor cores: the three parts of the tile, of the weights
inline size_t parts_bytes(int elems) { return align16((size_t)3 * elems * 2); }

// ---- staging --------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T zero_of() { return T(0.f); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// V elements of a row from column gx, zero outside [0, w) (``row`` may be
// null: all zeros).  ``vec``: w % V == 0 and the row 16-byte aligned, so a
// run is inside or outside as a whole.
template <typename T>
__device__ __forceinline__ uint4 load_run(const T* row, int gx, int w, bool vec) {
  constexpr int V = 16 / (int)sizeof(T);
  if (row == nullptr) return make_uint4(0u, 0u, 0u, 0u);
  if (vec)
    return gx >= 0 && gx < w ? __ldg(reinterpret_cast<const uint4*>(row + gx))
                             : make_uint4(0u, 0u, 0u, 0u);
  alignas(16) T e[V];
#pragma unroll
  for (int j = 0; j < V; ++j) e[j] = gx + j >= 0 && gx + j < w ? row[gx + j] : zero_of<T>();
  return *reinterpret_cast<const uint4*>(e);
}

// in[e] = V elements (pixels) of channel e -> out[j] = V channels of pixel j
template <int V>
__device__ __forceinline__ void transpose_runs(const uint4 (&in)[V], uint4 (&out)[V]) {
  if constexpr (V == 4) {
    out[0] = make_uint4(in[0].x, in[1].x, in[2].x, in[3].x);
    out[1] = make_uint4(in[0].y, in[1].y, in[2].y, in[3].y);
    out[2] = make_uint4(in[0].z, in[1].z, in[2].z, in[3].z);
    out[3] = make_uint4(in[0].w, in[1].w, in[2].w, in[3].w);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const unsigned sel = (j & 1) ? 0x7632u : 0x5410u;
      unsigned o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const unsigned* lo = reinterpret_cast<const unsigned*>(&in[2 * k]);
        const unsigned* hi = reinterpret_cast<const unsigned*>(&in[2 * k + 1]);
        o[k] = __byte_perm(lo[j / 2], hi[j / 2], sel);
      }
      out[j] = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

// Where a transposed run goes: o[j] holds V channels, group chg, of staged
// pixel (row r, column q V + j).  RunStore: xs[row][SW][cs] as it is
// (the FP32 and bf16 cores); PartStore: f32 split into three bf16 parts.
template <typename T>
struct RunStore {
  T* xs;
  int cs;
  __device__ __forceinline__ void operator()(int r, int q, int chg,
                                             const uint4 (&o)[Tile<T>::V]) const {
    constexpr int V = Tile<T>::V;
    T* dst = xs + (size_t)(r * Tile<T>::SW + q * V) * cs + chg * V;
#pragma unroll
    for (int j = 0; j < V; ++j) *reinterpret_cast<uint4*>(dst + (size_t)j * cs) = o[j];
  }
};

// The offset of 16-byte chunk c of staged row px (a pixel, or a weight row)
// in one part: rows of cs bf16, the chunk index XORed with row bits >> sw
// where cs / 8 is a power of two (sw 31: none), so the 8 consecutive rows
// an ldmatrix reads fall in 8 distinct bank groups.
__device__ __forceinline__ int part_at(int cs, int sw, int px, int c) {
  return px * cs + ((c ^ ((px >> sw) & (cs / 8 - 1))) << 3);
}
__device__ __forceinline__ int part_at(const Geo& g, int px, int c) {
  return part_at(g.cs, g.sw, px, c);
}

struct PartStore {
  __nv_bfloat16* xs;   // three parts of psz elements
  int cs, sw, psz;
  __device__ __forceinline__ void operator()(int r, int q, int chg, const uint4 (&o)[4]) const {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int px = r * Tile<float>::SW + q * 4 + j;
      const float4 v = *reinterpret_cast<const float4*>(&o[j]);
      unsigned lo[3], hi[3];
      attn::split2<3>(lo, v.x, v.y);
      attn::split2<3>(hi, v.z, v.w);
      __nv_bfloat16* dst = xs + part_at(cs, sw, px, chg >> 1) + 4 * (chg & 1);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        *reinterpret_cast<uint2*>(dst + (size_t)k * psz) = make_uint2(lo[k], hi[k]);
    }
  }
};

// Stages input channels [c0, c0 + cgs V) of image img for the tile at (x0,
// y0) through ``put``: staged row r is image row y0 - pt + r, staged column
// q image column x0 - V + q; zeros outside the image and past cin.
template <typename T, typename Store>
__device__ void stage_runs(const ConvIn& p, const Geo& g, const Store& put, int img, int x0,
                           int y0, int c0 = 0) {
  using Tl = Tile<T>;
  constexpr int V = Tl::V, SW = Tl::SW, CG = SW / V;
  constexpr int NB = V == 4 ? 4 : 2;   // runs in flight per thread
  const T* a = (const T*)p.a;
  const T* b = (const T*)p.b;
  const int items = g.hr * g.cgs * CG;
  const int64_t plane = (int64_t)p.h * p.w_;
  const bool vec = g.vec;
  for (int i0 = threadIdx.x; i0 < items; i0 += NB * kThreads) {
    uint4 v[NB][V];
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const int it = i0 + k * kThreads;
      const int chg = it % g.cgs, rest = it / g.cgs;
      const int q = rest % CG, r = rest / CG;
      const int gy = y0 - p.pt + r, gx = x0 - V + q * V;
      const bool row_ok = it < items && gy >= 0 && gy < p.h;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int ch = c0 + chg * V + e;
        const T* row = nullptr;
        if (row_ok && ch < g.cin)
          row = (ch < p.ca ? a + ((int64_t)img * p.ca + ch) * plane
                           : b + ((int64_t)img * p.cb + (ch - p.ca)) * plane) +
                (int64_t)gy * p.w_;
        v[k][e] = load_run<T>(row, gx, p.w_, vec);
      }
    }
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const int it = i0 + k * kThreads;
      if (it >= items) break;
      const int chg = it % g.cgs, rest = it / g.cgs;
      uint4 o[V];
      transpose_runs<V>(v[k], o);
      put(rest / CG, rest % CG, chg, o);
    }
  }
}

template <typename T>
__device__ void stage_tile(const ConvIn& p, const Geo& g, T* __restrict__ xs, int img,
                           int x0, int y0) {
  stage_runs<T>(p, g, RunStore<T>{xs, g.cs}, img, x0, y0);
}

// The double-buffered form of stage_tile, for widths and pointers that
// allow 16-byte runs (g.vec): prefetch_tile issues cp.async copies of the
// tile's rows as they lie, raw[ch][row][SW] (zeros outside the image), so
// they land while the block computes the tile before; transpose_tile then
// turns them into xs's [pixel][channel] on chip.
template <typename T>
__device__ void prefetch_tile(const ConvIn& p, const Geo& g, T* __restrict__ raw, int img,
                              int x0, int y0) {
  using Tl = Tile<T>;
  constexpr int V = Tl::V, SW = Tl::SW, CG = SW / V;
  const T* a = (const T*)p.a;
  const T* b = (const T*)p.b;
  const int64_t plane = (int64_t)p.h * p.w_;
  // a thread per (channel, 16-byte column run), down the staged rows
  for (int it = threadIdx.x; it < g.cin * CG; it += kThreads) {
    const int q = it % CG, ch = it / CG;
    const int gx = x0 - V + q * V;
    const bool col_ok = gx >= 0 && gx < p.w_;
    int gy = y0 - p.pt;
    const T* src = (ch < p.ca ? a + ((int64_t)img * p.ca + ch) * plane
                              : b + ((int64_t)img * p.cb + (ch - p.ca)) * plane) +
                   (int64_t)gy * p.w_ + gx;
    T* dst = raw + (size_t)(ch / V) * g.rgs + (size_t)(ch % V) * g.hr * SW + q * V;
    for (int r = 0; r < g.hr; ++r, ++gy, src += p.w_, dst += SW) {
      const bool ok = col_ok && gy >= 0 && gy < p.h;
      cp_async16(dst, ok ? src : a, ok);
    }
  }
}

template <typename T>
inline size_t raw_bytes(const Geo& g) {
  return align16((size_t)((g.cin + Tile<T>::V - 1) / Tile<T>::V) * g.rgs * sizeof(T));
}

template <typename T, typename Store>
__device__ void transpose_runs_from(const Geo& g, const T* __restrict__ raw, const Store& put) {
  using Tl = Tile<T>;
  constexpr int V = Tl::V, SW = Tl::SW, CG = SW / V;
  const int items = g.hr * g.cgs * CG;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int chg = it % g.cgs, rest = it / g.cgs;
    const int q = rest % CG, r = rest / CG;
    uint4 v[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int ch = chg * V + e;
      v[e] = ch < g.cin ? *reinterpret_cast<const uint4*>(raw + (size_t)chg * g.rgs +
                                                         ((size_t)e * g.hr + r) * SW + q * V)
                        : make_uint4(0u, 0u, 0u, 0u);
    }
    uint4 o[V];
    transpose_runs<V>(v, o);
    put(r, q, chg, o);
  }
}

template <typename T>
__device__ void transpose_tile(const Geo& g, const T* __restrict__ raw, T* __restrict__ xs) {
  transpose_runs_from<T>(g, raw, RunStore<T>{xs, g.cs});
}

// Weights w [cout][cin][kh][kw] (activation dtype) into shared memory:
// bf16 wb[tap][nt * 8][cs] (channel runs, zeros past cin / cout); f32
// wf[tap][kc * 4][co] (output channels innermost, zeros past them).
template <typename T>
__device__ void stage_weights(const ConvIn& p, const Geo& g, T* __restrict__ ws, int nt) {
  const T* w = (const T*)p.w;
  const int taps = p.kh * p.kw;
  if constexpr (sizeof(T) == 4) {
    const int rows = taps * g.kc * 4;
    for (int i = threadIdx.x; i < rows * g.co; i += kThreads) {
      const int co = i % g.co, rc = i / g.co;
      const int ci = rc % (g.kc * 4), tap = rc / (g.kc * 4);
      ws[i] = co < p.cout && ci < g.cin ? w[((int64_t)co * g.cin + ci) * taps + tap] : 0.f;
    }
  } else {
    const int width = 16 * g.kc;
    for (int i = threadIdx.x; i < taps * nt * 8 * width; i += kThreads) {
      const int ci = i % width, rc = i / width;
      const int co = rc % (nt * 8), tap = rc / (nt * 8);
      ws[(size_t)rc * g.cs + ci] = co < p.cout && ci < g.cin
                                       ? w[((int64_t)co * g.cin + ci) * taps + tap]
                                       : zero_of<T>();
    }
  }
}

// f32 on the tensor cores: w [cout][cin][kh][kw] into three bf16 parts
// (attn::split2, two channels at a time), each [tap][nt * 8][wcs] (weight
// row tap nt 8 + co, chunks XORed as the staged pixels'), zeros past cin /
// cout.
__device__ inline void stage_weights_tc(const ConvIn& p, const Geo& g,
                                        __nv_bfloat16* __restrict__ ws, int nt) {
  const float* w = (const float*)p.w;
  const int taps = p.kh * p.kw, rows = taps * nt * 8, pairs = g.wcs / 2;
  for (int i = threadIdx.x; i < rows * pairs; i += kThreads) {
    const int ci = 2 * (i % pairs), rw = i / pairs;
    const int co = rw % (nt * 8), tap = rw / (nt * 8);
    const auto at = [&](int c) {
      return co < p.cout && c < g.cin ? w[((int64_t)co * g.cin + c) * taps + tap] : 0.f;
    };
    unsigned q[3];
    attn::split2<3>(q, at(ci), at(ci + 1));
    __nv_bfloat16* dst = ws + part_at(g.wcs, g.wsw, rw, ci >> 3) + (ci & 7);
#pragma unroll
    for (int k = 0; k < 3; ++k) *reinterpret_cast<unsigned*>(dst + (size_t)k * g.wsz) = q[k];
  }
}

// ---- the conv over a staged tile ------------------------------------------

// bf16: E[co][pixel] = bias + sum over taps and channels, for co < cout.
// E may alias xs: every warp is past its reads before E is written.
template <int KH, int NT>
__device__ void conv_core_bf16(const ConvIn& p, const Geo& g, const __nv_bfloat16* xs,
                               const __nv_bfloat16* wb, const float* __restrict__ bias,
                               float* E) {
  using Tl = Tile<__nv_bfloat16>;
  constexpr int KW = KH, SW = Tl::SW, ES = Tl::ES;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cs = g.cs, d = p.dil;
  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
  // lane's A row: pixel (warp, 16 m + lane % 16), channels + 8 (lane / 16)
  const __nv_bfloat16* xa =
      xs + (size_t)(warp * SW + (lane & 15) + Tl::V - p.pleft) * cs + 8 * (lane >> 4);
  // lane's B row (x4: two n-tiles): co 8 (n + lane / 16) + lane % 8, k half
  const __nv_bfloat16* wl = wb + (size_t)(8 * (lane >> 4) + (lane & 7)) * cs + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int ky = 0; ky < KH; ++ky)
#pragma unroll
    for (int kx = 0; kx < KW; ++kx) {
      const int tap = ky * KW + kx;
      const __nv_bfloat16* xt = xa + (size_t)(ky * d * SW + kx * d) * cs;
      const __nv_bfloat16* wt = wl + (size_t)tap * NT * 8 * cs;
      for (int k = 0; k < g.kc; ++k) {
        unsigned af[2][4];
        msau::ldsm_x4(af[0], xt + 16 * k);
        msau::ldsm_x4(af[1], xt + (size_t)16 * cs + 16 * k);
#pragma unroll
        for (int n = 0; n + 1 < NT; n += 2) {
          unsigned b4[4];
          msau::ldsm_x4(b4, wt + (size_t)n * 8 * cs + 16 * k);
          const unsigned lo[2] = {b4[0], b4[1]}, hi[2] = {b4[2], b4[3]};
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            msau::mma_bf16(acc[m][n], af[m], lo);
            msau::mma_bf16(acc[m][n + 1], af[m], hi);
          }
        }
        if constexpr (NT % 2 == 1) {
          // x2: lanes 0-15 address co 8 (NT - 1) + lane % 8, k half lane / 8
          unsigned b2[2];
          msau::ldsm_x2(b2, wt + (size_t)((NT - 1) * 8 - 8 * (lane >> 4)) * cs + 16 * k);
#pragma unroll
          for (int m = 0; m < 2; ++m) msau::mma_bf16(acc[m][NT - 1], af[m], b2);
        }
      }
    }
  __syncthreads();   // E may alias xs
  const int gq = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = 8 * n + 2 * t4 + (e & 1);
        const int px = warp * kTw + 16 * m + gq + 8 * (e >> 1);
        if (co < p.cout) E[co * ES + px] = acc[m][n][e] + bias[co];
      }
  __syncthreads();
}

// d += a b over three parts of each (the m16n8k8 form of attn::mma_parts:
// the six products qa + qb < 3, the smallest first, into a zeroed
// temporary added to d on the FP32 pipes).
__device__ __forceinline__ void mma_parts_k8(float (&d)[4], const unsigned (&a)[3][2],
                                             const unsigned (&b)[3]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int s = 2; s >= 0; --s)
#pragma unroll
    for (int qa = 0; qa <= s; ++qa) msau::mma_bf16_k8(t, a[qa][0], a[qa][1], b[s - qa]);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

// f32 on the tensor cores: acc += the conv over pass j's input channels,
// from the three parts of the staged tile (xs, PartStore) and of the
// weights (ws, stage_weights_tc).  Each tap's channels are c8 chunks of 8:
// k16 steps take two chunks of a tap and an odd chunk count's last one an
// m16n8k8 step, except at one chunk (at most 8 channels), where a k16 step
// takes two taps and an odd last tap the m16n8k8 step; so no step
// multiplies zero padding past a multiple of 8 channels.  Warp w owns
// m-tiles MT w .. MT w + MT - 1 of the tile's 4 MT rows (two 16-pixel
// m-tiles a row) and every output channel; acc[m][n] is m-tile MT w + m,
// output channels 8 n .. 8 n + 7 as mma.sync's accumulator holds them.
template <int KH, int NT, int MT>
__device__ __forceinline__ void conv_core_tc(const ConvIn& p, const Geo& g,
                                             const __nv_bfloat16* xs,
                                             const __nv_bfloat16* ws, int j,
                                             float (&acc)[MT][NT][4]) {
  using Tl = Tile<float, 4 * MT>;
  constexpr int KW = KH, TAPS = KH * KW, SW = Tl::SW, WR = NT * 8;
  using bf16 = __nv_bfloat16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = p.dil, xp = g.psz, wp = g.wsz, c8 = g.cs / 8, wc0 = c8 * j;
  // lane's A row at tap (0, 0): staged pixel of tile pixel 16 mt + lane % 16
  int pa[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int mt = MT * warp + m;
    pa[m] = (mt >> 1) * SW + 16 * (mt & 1) + (lane & 15) + Tl::V - p.pleft;
  }
  // A (x4: lanes 16-31 the k 8-15 half) at staged pixel px, chunk c
  auto load_a = [&](unsigned (&a)[3][4], int px, int c) {
    const bf16* at = xs + part_at(g, px, c);
#pragma unroll
    for (int k = 0; k < 3; ++k) msau::ldsm_x4(a[k], at + (size_t)k * xp);
  };
  // B of n-tiles n, n + 1 (x4: lanes 16-31 the second) at weight row
  // ``row`` + their output channel, chunk c; then the products
  auto mma_pair = [&](unsigned (&a)[MT][3][4], int n, int row, int c) {
    unsigned b4[3][4];
    const bf16* at = ws + part_at(g.wcs, g.wsw, row + 8 * (n + (lane >> 4)) + (lane & 7), c);
#pragma unroll
    for (int k = 0; k < 3; ++k) msau::ldsm_x4(b4[k], at + (size_t)k * wp);
    unsigned lo[3][2], hi[3][2];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      lo[k][0] = b4[k][0];
      lo[k][1] = b4[k][1];
      hi[k][0] = b4[k][2];
      hi[k][1] = b4[k][3];
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      attn::mma_parts<3>(acc[m][n], a[m], lo);
      attn::mma_parts<3>(acc[m][n + 1], a[m], hi);
    }
  };
  // the last n-tile of an odd NT (x2: lanes 0-15)
  auto mma_last = [&](unsigned (&a)[MT][3][4], int row, int c) {
    unsigned b2[3][2];
    const bf16* at = ws + part_at(g.wcs, g.wsw, row + 8 * (NT - 1) + (lane & 7), c);
#pragma unroll
    for (int k = 0; k < 3; ++k) msau::ldsm_x2(b2[k], at + (size_t)k * wp);
#pragma unroll
    for (int m = 0; m < MT; ++m) attn::mma_parts<3>(acc[m][NT - 1], a[m], b2);
  };
  // an m16n8k8 step: A x2 (lanes 0-15 address the rows) at pixel shift sh,
  // chunk c; B (x2: lanes 0-7 n-tile n, 8-15 n + 1) at weight row ``row``
  auto mma_k8 = [&](int sh, int c, int row, int wc) {
    unsigned a2[MT][3][2];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const bf16* at = xs + part_at(g, pa[m] + sh, c);
#pragma unroll
      for (int k = 0; k < 3; ++k) msau::ldsm_x2(a2[m][k], at + (size_t)k * xp);
    }
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      const int nn = n + 1 < NT ? n + ((lane >> 3) & 1) : n;   // an odd last: n twice
      const bf16* at = ws + part_at(g.wcs, g.wsw, row + 8 * nn + (lane & 7), wc);
      unsigned b2[3][2];
#pragma unroll
      for (int k = 0; k < 3; ++k) msau::ldsm_x2(b2[k], at + (size_t)k * wp);
      const unsigned b0[3] = {b2[0][0], b2[1][0], b2[2][0]};
      const unsigned b1[3] = {b2[0][1], b2[1][1], b2[2][1]};
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma_parts_k8(acc[m][n], a2[m], b0);
        if (n + 1 < NT) mma_parts_k8(acc[m][n + 1], a2[m], b1);
      }
    }
  };
  if (c8 > 1) {
#pragma unroll 1
    for (int tap = 0; tap < TAPS; ++tap) {
      const int sh = (tap / KW) * d * SW + (tap % KW) * d;
      for (int k = 0; k + 1 < c8; k += 2) {
        unsigned af[MT][3][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) load_a(af[m], pa[m] + sh, k + (lane >> 4));
        const int hk = wc0 + k + ((lane >> 3) & 1);
#pragma unroll
        for (int n = 0; n + 1 < NT; n += 2) mma_pair(af, n, tap * WR, hk);
        if constexpr (NT % 2 == 1) mma_last(af, tap * WR, hk);
      }
      if (c8 & 1) mma_k8(sh, c8 - 1, tap * WR, wc0 + c8 - 1);
    }
  } else {
    // at most 8 channels: k16 step s is taps 2 s (k 0-7) and 2 s + 1
#pragma unroll 1
    for (int s = 0; s < TAPS / 2; ++s) {
      const int ta = 2 * s + (lane >> 4), tb = 2 * s + ((lane >> 3) & 1);
      const int sh = (ta / KW) * d * SW + (ta % KW) * d;
      unsigned af[MT][3][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) load_a(af[m], pa[m] + sh, 0);
      // B: lanes 8-15 (and 24-31) address tap 2 s + 1's rows
#pragma unroll
      for (int n = 0; n + 1 < NT; n += 2) mma_pair(af, n, tb * WR, 0);
      if constexpr (NT % 2 == 1) mma_last(af, tb * WR, 0);
    }
    if constexpr (TAPS % 2 == 1) {
      constexpr int tap = TAPS - 1;
      mma_k8((tap / KW) * d * SW + (tap % KW) * d, 0, tap * WR, 0);
    }
  }
}

// E[co][pixel] = bias + acc (conv_core_tc's sums), for co < cout.  E may
// alias xs: every warp is past its reads before E is written.
template <int NT, int MT>
__device__ __forceinline__ void store_tc(const ConvIn& p, const float (&acc)[MT][NT][4],
                                         const float* __restrict__ bias, float* E) {
  constexpr int ES = Tile<float, 4 * MT>::ES;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();   // E may alias xs
  const int gq = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int mt = MT * warp + m;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = 8 * n + 2 * t4 + (e & 1);
        const int px = (mt >> 1) * kTw + 16 * (mt & 1) + gq + 8 * (e >> 1);
        if (co < p.cout) E[co * ES + px] = acc[m][n][e] + bias[co];
      }
  }
  __syncthreads();
}

// f32: the same on the FP32 pipes.  Warp w takes output channels [CT cg,
// CT cg + CT) (cg = w % ng) and K share s = w / ng of the (tap, float4
// group) items; lane c owns column c of the tile's 4 rows.  The shares land
// in red[s][co][pixel] and are added in share order into E (+ bias).  red
// may alias xs.
template <int KH, int CT>
__device__ void conv_core_f32(const ConvIn& p, const Geo& g, const float* xs,
                              const float* wf, const float* __restrict__ bias, float* red,
                              float* E) {
  using Tl = Tile<float>;
  constexpr int KW = KH, SW = Tl::SW, PIX = Tl::TH, P = Tl::P, ES = Tl::ES;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cs = g.cs, d = p.dil, kc = g.kc;
  const int cg = warp % g.ng, s = warp / g.ng;
  const bool active = s < g.ns;
  float acc[PIX][CT];
#pragma unroll
  for (int r = 0; r < PIX; ++r)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[r][c] = 0.f;
  if (active) {
    const int items = KH * KW * kc;
    const int k0 = s * items / g.ns, k1 = (s + 1) * items / g.ns;
    int tap = k0 / kc, c4 = k0 - tap * kc;
    const float* xl = xs + (size_t)(lane + Tl::V - p.pleft) * cs;
    for (int k = k0; k < k1; ++k) {
      const int ky = tap / KW, kx = tap - ky * KW;
      const float* xp = xl + (size_t)(ky * d * SW + kx * d) * cs + 4 * c4;
      float4 xv[PIX];
#pragma unroll
      for (int r = 0; r < PIX; ++r)
        xv[r] = *reinterpret_cast<const float4*>(xp + (size_t)r * SW * cs);
      const float* wp = wf + (size_t)k * 4 * g.co + cg * CT;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float wv[CT];
        load_row(wv, wp + e * g.co);
#pragma unroll
        for (int r = 0; r < PIX; ++r) {
          const float xe = e == 0 ? xv[r].x : e == 1 ? xv[r].y : e == 2 ? xv[r].z : xv[r].w;
#pragma unroll
          for (int c = 0; c < CT; ++c) acc[r][c] = fmaf(xe, wv[c], acc[r][c]);
        }
      }
      if (++c4 == kc) {
        c4 = 0;
        ++tap;
      }
    }
  }
  __syncthreads();   // red may alias xs
  if (active)
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int r = 0; r < PIX; ++r)
        red[((size_t)s * g.co + cg * CT + c) * P + r * kTw + lane] = acc[r][c];
  __syncthreads();
  for (int i = threadIdx.x; i < p.cout * P; i += kThreads) {
    const int co = i / P, px = i - co * P;
    float v = 0.f;
    for (int k = 0; k < g.ns; ++k) v += red[((size_t)k * g.co + co) * P + px];
    E[co * ES + px] = v + bias[co];
  }
  __syncthreads();
}

// LocalResponseNorm windows at one pixel, walked in ascending channels:
// win(co) = sum of v(c) over c in [co - below, co + above] within [0, cout),
// kept as a running sum (start, then step after each co).
struct Window {
  float sum = 0.f;
  template <typename F>
  __device__ __forceinline__ void start(int cout, int above, F v) {
    for (int c = 0; c <= min(cout - 1, above); ++c) sum += v(c);
  }
  template <typename F>
  __device__ __forceinline__ void step(int co, int cout, int below, int above, F v) {
    if (co + 1 + above < cout) sum += v(co + 1 + above);
    if (co - below >= 0) sum -= v(co - below);
  }
};

}  // namespace fast
}  // namespace msau
