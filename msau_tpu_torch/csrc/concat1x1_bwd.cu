// Backward of the coupling conv y = act(Wa a + Wb b + bias) (the two-input
// 1x1 conv of flatconv.cu's msau_flat_conv2d with kh = kw = 1), in one pass:
// per pixel, with x = [a; b] and W = [Wa Wb] ([cout][cin], cin = ca + cb),
//   z  = Wa a + Wb b + bias          (f32, only where act is set)
//   g0 = g act'(z)                   (f32; g0 = g without act)
//   gc = g0 rounded to the activation dtype
//   dx = W^T gc                      -> da (channels < ca), db (the rest)
//   dw += gc x^T,  dbias += g0       (f32 sums over every pixel)
// so a, b and g are read once and g0 never leaves the chip.
//
// Replaces the TPU kernel msau_tpu/ops/flatconv.py:_cc_bwd_kernel (launcher
// _cc_vjp_bwd), which does the same in one pass with the same rounding: dw
// from the rounded g0, dbias from the f32 one, every sum in f32.
//
// With 8 to 32 channels it is 3 cin cout multiply-adds per pixel against
// (2 cin + cout) values moved: bound by device memory, except f32 near 32
// channels, where the FP32 pipes come close.  Two kernels:
//   - f32 on the FP32 pipes (f32 must hold 1e-5, so no TF32), below;
//   - bf16 on the tensor cores (mma.sync), further down.
// msau_concat_conv1x1_bwd_fits says which channel counts they take (f32:
// about 32 + 32 -> 32, bf16: a and b padded to 8, at most 64 together,
// -> 32); the wrapper sends
// wider couplings to the two general kernels (flatconv_bwd.cu's stage 1,
// then flatconv.cu's dx conv).
//
// f32 design:
//   - a grid of at most kPartialBlocks blocks walks tiles of P pixels of
//     one image (1x1: a tile is a run of the flattened H x W); x is staged
//     by 16-byte cp.async as [channel][pixel], double buffered, so the next
//     tile loads while this one computes; the weights sit in shared memory
//     both as [cin][cout] and [cout][cin];
//   - z (where act is set) and g0: a thread owns 4 output channels x 4
//     pixels (x read as float4 across the warp, the weights broadcast),
//     reads g from device memory, and writes g0 to shared memory;
//   - dx: a thread owns 4 input channels x 4 pixels and sums over the
//     output channels, then stores its 4 rows of 4 pixels to da or db;
//   - dw, dbias: a thread owns 4 output x 4 input channels (strided, so the
//     rows read by a warp's lanes fall in distinct banks) and a slice of
//     the tile's pixels; its sums stay in registers over the block's tiles,
//     the slices are added by shuffles, and each block writes its own
//     partial row, which sum_partials (common.cuh) adds in block order: no
//     float atomics, and the same inputs give the same bits.

#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

using msau::act_grad;
using msau::load4;
using msau::load_row;
using msau::store4;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kSmem = 110 * 1024;   // two blocks per SM
constexpr int kZItems = 4;          // z / g0 items per thread and tile, at most

struct Geom {
  int ca, cb, cout, hw;
  int cin4, cout4;   // channels padded to 4
  int p;             // pixels per tile
  int ps;            // pixel slices per dw tile
  int xp, gp;        // row pitches of staged x (elements) and g0 (floats)
  __host__ __device__ int cin() const { return ca + cb; }
  __host__ __device__ int dw_tiles() const { return (cout4 / 4) * (cin4 / 4); }
};

size_t smem_bytes(const Geom& q) {
  return (size_t)2 * q.cin4 * q.xp * 4 + (size_t)q.cout4 * q.gp * 4 +
         (size_t)2 * q.cin4 * q.cout4 * 4;
}

__global__ void __launch_bounds__(kThreads, 2)
concat1x1_bwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     const float* __restrict__ w, const float* __restrict__ bias,
                     const float* __restrict__ g, float* __restrict__ da,
                     float* __restrict__ db, Geom q, int act, int n_tiles, int vec,
                     float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cin = q.cin(), P = q.p, xp = q.xp, gp = q.gp;
  float* xs = reinterpret_cast<float*>(smem_raw);                          // [2][cin4][xp]
  float* G = xs + 2 * q.cin4 * xp;                                        // [cout4][gp]
  float* wz = G + q.cout4 * gp;                                           // [cin4][cout4]
  float* wd = wz + q.cin4 * q.cout4;                                      // [cout4][cin4]
  const int tiles_img = (q.hw + P - 1) / P;
  const int64_t hw = q.hw;

  for (int i = threadIdx.x; i < q.cin4 * q.cout4; i += kThreads) {
    const int co = i % q.cout4, c = i / q.cout4;
    const float v = c < cin && co < q.cout ? w[(int64_t)co * cin + c] : 0.f;
    wz[c * q.cout4 + co] = v;
    wd[co * q.cin4 + c] = v;
  }

  auto stage = [&](int tile, int buf) {
    const int img = tile / tiles_img, p0 = (tile % tiles_img) * P;
    float* dst0 = xs + buf * q.cin4 * xp;
    const int per_row = P / 4;
    for (int i = threadIdx.x; i < q.cin4 * per_row; i += kThreads) {
      const int v = i % per_row, c = i / per_row, p = p0 + v * 4;
      float* dst = dst0 + c * xp + v * 4;
      const float* row = c < q.ca ? a + ((int64_t)img * q.ca + c) * hw
                                  : b + ((int64_t)img * q.cb + (c - q.ca)) * hw;
      if (c >= cin || p >= hw) {
        msau::cp_async16(dst, a, false);
      } else if (vec && p + 4 <= hw) {
        msau::cp_async16(dst, row + p);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          msau::cp_async4(dst + e, row + min(p + e, q.hw - 1), p + e < hw);
      }
    }
    msau::cp_async_commit();
  };

  // dw tile of this thread: output channels cog + k cog_n and input
  // channels cig + k cig_n (k < 4), pixel slice s
  const int cog_n = q.cout4 / 4, cig_n = q.cin4 / 4;
  const int dt = threadIdx.x / q.ps, s = threadIdx.x % q.ps;
  const bool dw_live = dt < q.dw_tiles();
  const int cog = dw_live ? dt % cog_n : 0, cig = dw_live ? dt / cog_n : 0;
  // dbias: the f32 g0 of the thread's z items (item tid + k kThreads, 4
  // output channels each), summed over the block's tiles
  float dwacc[4][4], dbz[kZItems][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int k = 0; k < kZItems; ++k) dbz[k][i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) dwacc[i][j] = 0.f;
  }
  const int pq = q.p / 4, z_items = cog_n * pq;

  stage(blockIdx.x, 0);
  int buf = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    const int img = tile / tiles_img, p0 = (tile % tiles_img) * P;
    if (tile + (int)gridDim.x < n_tiles) {
      stage(tile + gridDim.x, buf ^ 1);
      msau::cp_async_wait<1>();
    } else {
      msau::cp_async_wait<0>();
    }
    __syncthreads();   // this tile's x (and, the first time, the weights)
    const float* xb = xs + buf * q.cin4 * xp;

    // z and g0: 4 output channels x 4 pixels per item; G holds g0, dbz
    // sums it
#pragma unroll
    for (int k = 0; k < kZItems; ++k) {
      const int it = threadIdx.x + k * kThreads;
      if (it >= z_items) break;
      const int pg = it % pq, co0 = (it / pq) * 4, p = p0 + 4 * pg;
      float g4[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        g4[i][0] = g4[i][1] = g4[i][2] = g4[i][3] = 0.f;
        if (co0 + i < q.cout && p < hw)
          load4(g4[i], g + ((int64_t)img * q.cout + co0 + i) * hw, p, q.hw, vec);
      }
      if (act) {
        // z = Wa a + Wb b + bias, the two sums then the bias, as the TPU
        // kernel adds them
        float z[2][4][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < 4; ++i) z[h][i][0] = z[h][i][1] = z[h][i][2] = z[h][i][3] = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          for (int c = h ? q.ca : 0; c < (h ? cin : q.ca); ++c) {
            float xv[4], wv[4];
            load_row(xv, xb + c * xp + 4 * pg);
            load_row(wv, wz + c * q.cout4 + co0);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int e = 0; e < 4; ++e) z[h][i][e] = fmaf(wv[i], xv[e], z[h][i][e]);
          }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float bc = co0 + i < q.cout ? bias[co0 + i] : 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            g4[i][e] *= act_grad(z[0][i][e] + z[1][i][e] + bc, act);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dbz[k][i] += (g4[i][0] + g4[i][1]) + (g4[i][2] + g4[i][3]);
        *reinterpret_cast<float4*>(G + (co0 + i) * gp + 4 * pg) =
            make_float4(g4[i][0], g4[i][1], g4[i][2], g4[i][3]);
      }
    }
    __syncthreads();   // gc complete

    // dx = W^T g0: 4 input channels x 4 pixels per item
    for (int it = threadIdx.x; it < cig_n * pq; it += kThreads) {
      const int pg = it % pq, c0 = (it / pq) * 4, p = p0 + 4 * pg;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
      for (int co = 0; co < q.cout; ++co) {
        float gv[4], wv[4];
        load_row(gv, G + co * gp + 4 * pg);
        load_row(wv, wd + co * q.cin4 + c0);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(wv[i], gv[e], acc[i][e]);
      }
      if (p >= hw) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = c0 + i;
        if (c >= cin) break;
        float* row = c < q.ca ? da + ((int64_t)img * q.ca + c) * hw
                              : db + ((int64_t)img * q.cb + (c - q.ca)) * hw;
        store4(row, p, q.hw, vec, acc[i]);
      }
    }

    // dw += g0 x^T over this thread's pixel slice
    if (dw_live) {
      for (int pg = s; pg < pq; pg += q.ps) {
        float gv[4][4], xv[4][4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          load_row(gv[k], G + (cog + k * cog_n) * gp + 4 * pg);
          load_row(xv[k], xb + (cig + k * cig_n) * xp + 4 * pg);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int j = 0; j < 4; ++j) dwacc[i][j] = fmaf(gv[i][e], xv[j][e], dwacc[i][j]);
      }
    }
    __syncthreads();   // G and this x buffer are written again
  }

  // dbias: the items' sums through shared memory (G is read no more), each
  // output channel's added in pixel-group order
  float* red = G;   // [z item][4]
#pragma unroll
  for (int k = 0; k < kZItems; ++k) {
    const int it = threadIdx.x + k * kThreads;
    if (it < z_items)
#pragma unroll
      for (int i = 0; i < 4; ++i) red[it * 4 + i] = dbz[k][i];
  }
  __syncthreads();
  float* part = partial + (int64_t)blockIdx.x * (q.cout * cin + q.cout);
  if ((int)threadIdx.x < q.cout) {
    const int co = threadIdx.x;
    float sum = 0.f;
    for (int pg = 0; pg < pq; ++pg) sum += red[((co / 4) * pq + pg) * 4 + co % 4];
    part[q.cout * cin + co] = sum;
  }
  // the ps slices of a dw tile are consecutive lanes
  for (int off = q.ps / 2; off > 0; off /= 2)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dwacc[i][j] += __shfl_xor_sync(0xffffffffu, dwacc[i][j], off);
  if (!dw_live || s != 0) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int co = cog + i * cog_n;
    if (co >= q.cout) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = cig + j * cig_n;
      if (c < cin) part[co * cin + c] = dwacc[i][j];
    }
  }
}

// The f32 kernel's tiling of q's channels, or false where it has none: at
// most kThreads dw tiles, pixels per tile the most of 512, 256, 128 that
// lets two blocks share an SM (row pitches padded by min(ps, 8) 16-byte
// units, so the lanes of a dw load phase, ps slices of 8 / ps neighbouring
// tiles, hit distinct bank groups), and at most kZItems z items a thread.
bool f32_geom(Geom& q) {
  if (q.dw_tiles() > kThreads) return false;
  // pixel slices per dw tile: about kThreads threads in all, 1 to 32
  q.ps = 1;
  while (q.ps < 32 && q.dw_tiles() * q.ps * 2 <= kThreads) q.ps *= 2;
  const int pad = 16 * std::min(q.ps, 8);
  q.p = 0;
  for (int p : {512, 256, 128}) {
    Geom t = q;
    t.p = p;
    t.xp = p + pad / 4;
    t.gp = p + pad / 4;
    if (smem_bytes(t) <= (size_t)kSmem) {
      q = t;
      break;
    }
  }
  return q.p != 0 && (q.cout4 / 4) * (q.p / 4) <= kZItems * kThreads;
}

Geom f32_channels(int ca, int cb, int cout) {
  return Geom{ca, cb, cout, 0, (ca + cb + 3) / 4 * 4, (cout + 3) / 4 * 4, 0, 1, 0, 0};
}

int launch_f32(const void* a, const void* b, const void* w, const float* bias, const void* g,
               void* da, void* db, float* partial, float* out, int n, int hw, Geom q, int act,
               cudaStream_t stream) {
  q.hw = hw;
  if (!f32_geom(q)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(q);
  cudaError_t err = msau::allow_smem(concat1x1_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t n_tiles = (int64_t)n * ((q.hw + q.p - 1) / q.p);
  if (n_tiles > (1 << 30)) return (int)cudaErrorInvalidValue;
  const int blocks = (int)std::min<int64_t>(n_tiles, msau::kPartialBlocks);
  const int vec = q.hw % 4 == 0 && (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0 &&
                  (uintptr_t)g % 16 == 0 && (uintptr_t)da % 16 == 0 && (uintptr_t)db % 16 == 0;
  concat1x1_bwd_kernel<<<blocks, kThreads, smem, stream>>>(
      (const float*)a, (const float*)b, (const float*)w, bias, (const float*)g, (float*)da,
      (float*)db, q, act, (int)n_tiles, vec, partial);
  const int code = (int)cudaGetLastError();
  if (code != 0) return code;
  return msau::sum_partials(partial, blocks, (int64_t)q.cout * (q.ca + q.cb) + q.cout, out,
                            stream);
}

// ---- bf16: the three products on the tensor cores ------------------------------
//
// mma.sync, bf16 operands, f32 sums.  A warp walks its own chunks of pw
// pixels (64 or 32) of one image through a ring of kSlots shared-memory
// slots, which 16-byte cp.async fills while it computes, with no block
// barrier until the end: many warps in flight is what feeds it.  A slot
// holds x as [row][pixel] (a's channels from row 0, b's from row cb0 = ca
// padded to 8, zero rows between and after, to MI tiles of 16 rows) and g
// as [output channel][pixel] (zero rows up to MO tiles of 16).  The row pitch pw + 8 puts the eight rows of an ldmatrix
// matrix in distinct bank groups.  Per 16 pixels, with A and B the mma
// operands:
//   z^T [px][co] = x^T W^T   A: ldmatrix.trans of x; m16n8k8 products, so
//                            that a's rows and b's are summed apart, then
//                            added, then the bias, as the TPU kernel adds
//                            them
//   g                        ldmatrix.trans of g: z^T's fragment layout
//   g0 = g act'(z) in f32, summed into dbias; gc = g0 in bf16, which as it
//   lies in registers is the A operand of
//   dx^T [px][c] = gc W      m16n8k16; written over these pixels' x by
//                            stmatrix.trans
//   dw [c][co]  += x gc^T    m16n8k16; A: ldmatrix of x; B: gc transposed
//                            in registers (movmatrix)
// then the chunk's da and db rows leave by 16-byte stores.  W's fragments
// sit in shared memory in the order the lanes read them.  At the end the
// block adds its warps' dw and dbias in warp order into its partial row,
// and sum_partials adds the rows in block order.
constexpr int kSlots = 2;

struct BfGeom {
  int ca, cb, cout, hw;
  int cb0;                 // slot row of b's first channel
  int pw, pp;              // pixels per chunk, slot row pitch (elements)
  int nw;                  // warps per block
  int chunks_img, n_chunks;
  int vec;                 // 16-byte copies and stores allowed
};

template <int MI, int MO>
struct BfShape {
  static constexpr int XR = 16 * MI, GR = 16 * MO;   // slot rows of x, of g
  static constexpr int NC = 2 * MO, NX = 2 * MI;     // 8-wide n-tiles of co, of x rows
  // the warps' rings, reused at the end for their dw and dbias
  static __host__ __device__ size_t ring_bytes(const BfGeom& q) {
    const size_t ring = (size_t)q.nw * kSlots * (XR + GR) * q.pp * 2;
    const size_t red = (size_t)q.nw * (XR + 1) * GR * 4;
    return ring > red ? ring : red;
  }
  static size_t smem_bytes(const BfGeom& q) {
    return ring_bytes(q) + (size_t)(MI * NC + MO * NX) * 32 * 8 + GR * 4;
  }
};

template <int MI, int MO>
__global__ void __launch_bounds__(256)
concat1x1_bwd_bf16_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                          const bf16* __restrict__ w, const float* __restrict__ bias,
                          const bf16* __restrict__ g, bf16* __restrict__ da,
                          bf16* __restrict__ db, BfGeom q, int act, float* __restrict__ partial) {
  using S = BfShape<MI, MO>;
  constexpr int XR = S::XR, GR = S::GR, NC = S::NC, NX = S::NX;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int cin = q.ca + q.cb, pp = q.pp, slot = (XR + GR) * pp;
  uint2* wzs = reinterpret_cast<uint2*>(smem_raw + S::ring_bytes(q));   // [MI][NC][lane]
  uint2* wds = wzs + MI * NC * 32;                                       // [MO][NX][lane]
  float* bs = reinterpret_cast<float*>(wds + MO * NX * 32);             // [GR]
  bf16* ring = reinterpret_cast<bf16*>(smem_raw) + (size_t)warp * kSlots * slot;

  // the channel of slot row r, or -1 for a zero row
  auto chan = [&](int r) {
    return r < q.ca ? r : (r >= q.cb0 && r < q.cb0 + q.cb ? q.ca + r - q.cb0 : -1);
  };
  auto wpair = [&](int co0, int r0, int co1, int r1) {
    const int c0 = chan(r0), c1 = chan(r1);
    const unsigned lo = co0 < q.cout && c0 >= 0 ? __bfloat16_as_ushort(w[co0 * cin + c0]) : 0u;
    const unsigned hi = co1 < q.cout && c1 >= 0 ? __bfloat16_as_ushort(w[co1 * cin + c1]) : 0u;
    return lo | hi << 16;
  };
  // B of z^T (k: x row, n: co) and of dx^T (k: co, n: x row), per lane
  for (int i = threadIdx.x; i < MI * NC * 32; i += blockDim.x) {
    const int l = i % 32, co = (i / 32 % NC) * 8 + l / 4, r = i / 32 / NC * 16 + 2 * (l % 4);
    wzs[i] = make_uint2(wpair(co, r, co, r + 1), wpair(co, r + 8, co, r + 9));
  }
  for (int i = threadIdx.x; i < MO * NX * 32; i += blockDim.x) {
    const int l = i % 32, r = (i / 32 % NX) * 8 + l / 4, co = i / 32 / NX * 16 + 2 * (l % 4);
    wds[i] = make_uint2(wpair(co, r, co + 1, r), wpair(co + 8, r, co + 9, r));
  }
  for (int i = threadIdx.x; i < GR; i += blockDim.x) bs[i] = i < q.cout ? bias[i] : 0.f;
  // the padding rows are zero and stay so (dx writes zeros there)
  for (int i = lane; i < kSlots * slot / 8; i += 32)
    reinterpret_cast<uint4*>(ring)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  const int per_row = q.pw / 8;
  auto stage = [&](int chunk, int s) {
    const int img = chunk / q.chunks_img, p0 = chunk % q.chunks_img * q.pw;
    bf16* dst0 = ring + s * slot;
    for (int i = lane; i < (cin + q.cout) * per_row; i += 32) {
      const int row = i / per_row, v = i % per_row, p = p0 + 8 * v;
      const bf16* src;
      int r;
      if (row < q.ca) {
        src = a + ((int64_t)img * q.ca + row) * q.hw;
        r = row;
      } else if (row < cin) {
        src = b + ((int64_t)img * q.cb + row - q.ca) * q.hw;
        r = q.cb0 + row - q.ca;
      } else {
        src = g + ((int64_t)img * q.cout + row - cin) * q.hw;
        r = XR + row - cin;
      }
      bf16* dst = dst0 + r * pp + 8 * v;
      if (q.vec) {   // hw % 8 == 0: a piece is whole or past the row
        msau::cp_async16(dst, p < q.hw ? src + p : src, p < q.hw);
      } else {
        alignas(16) bf16 e8[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) e8[e] = p + e < q.hw ? src[p + e] : __float2bfloat16(0.f);
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(e8);
      }
    }
  };

  // the warp's chunks: wg, wg + nwg, ...
  const int wg = blockIdx.x * q.nw + warp, nwg = gridDim.x * q.nw;
  const int mine = wg < q.n_chunks ? (q.n_chunks - 1 - wg) / nwg + 1 : 0;
  auto chunk_of = [&](int k) { return wg + k * nwg; };
  float dw[MI][NC][4], dbs[NC][2];
#pragma unroll
  for (int nt = 0; nt < NC; ++nt) {
    dbs[nt][0] = dbs[nt][1] = 0.f;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) dw[mi][nt][0] = dw[mi][nt][1] = dw[mi][nt][2] = dw[mi][nt][3] = 0.f;
  }
  // lane addresses of the .trans operands (rows r0 + tr, columns pc + tc)
  // and of the plain A operand of dw (rows r0 + ar, columns pc + ac)
  const int tr = lane / 16 * 8 + lane % 8, tc = lane / 8 % 2 * 8;
  const int ar = lane / 8 % 2 * 8 + lane % 8, ac = lane / 16 * 8;
#pragma unroll
  for (int k = 0; k < kSlots - 1; ++k) {
    if (k < mine) stage(chunk_of(k), k);
    msau::cp_async_commit();
  }
  for (int k = 0; k < mine; ++k) {
    if (k + kSlots - 1 < mine) stage(chunk_of(k + kSlots - 1), (k + kSlots - 1) % kSlots);
    msau::cp_async_commit();
    msau::cp_async_wait<kSlots - 1>();
    __syncwarp();   // chunk k has landed, every lane's part of it
    const int chunk = chunk_of(k);
    const int img = chunk / q.chunks_img, p0 = chunk % q.chunks_img * q.pw;
    bf16* xs = ring + k % kSlots * slot;
    const bf16* gs = xs + XR * pp;
    for (int pc = 0; pc < q.pw; pc += 16) {
      float za[NC][4], zb[NC][4];
#pragma unroll
      for (int nt = 0; nt < NC; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) za[nt][e] = zb[nt][e] = 0.f;
      if (act) {
#pragma unroll
        for (int ki = 0; ki < MI; ++ki) {
          // af[0], af[1]: rows ki 16 .. + 7; af[2], af[3]: the next 8
          unsigned af[4];
          msau::ldsm_x4_trans(af, xs + (ki * 16 + tr) * pp + pc + tc);
          const bool a_lo = ki * 16 < q.cb0, a_hi = ki * 16 + 8 < q.cb0;
#pragma unroll
          for (int nt = 0; nt < NC; ++nt) {
            const uint2 u = wzs[(ki * NC + nt) * 32 + lane];
            if (a_lo)
              msau::mma_bf16_k8(za[nt], af[0], af[1], u.x);
            else
              msau::mma_bf16_k8(zb[nt], af[0], af[1], u.x);
            if (a_hi)
              msau::mma_bf16_k8(za[nt], af[2], af[3], u.y);
            else
              msau::mma_bf16_k8(zb[nt], af[2], af[3], u.y);
          }
        }
      }
      float dx[NX][4];
#pragma unroll
      for (int nx = 0; nx < NX; ++nx) dx[nx][0] = dx[nx][1] = dx[nx][2] = dx[nx][3] = 0.f;
      unsigned bt[MO][4];
#pragma unroll
      for (int ko = 0; ko < MO; ++ko) {
        // g of 16 output channels: register j holds n-tile 2 ko + j / 2,
        // pixel gq + 8 (j % 2), channels 2 tq and + 1
        unsigned gc[4];
        msau::ldsm_x4_trans(gc, gs + (ko * 16 + tr) * pp + pc + tc);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int nt = 2 * ko + j / 2, e = j % 2 * 2, co = nt * 8 + 2 * tq;
          float2 v = msau::unpack_bf16(gc[j]);
          if (act) {
            v.x *= act_grad(za[nt][e] + zb[nt][e] + bs[co], act);
            v.y *= act_grad(za[nt][e + 1] + zb[nt][e + 1] + bs[co + 1], act);
          }
          dbs[nt][0] += v.x;
          dbs[nt][1] += v.y;
          gc[j] = msau::pack_bf16(v.x, v.y);
          bt[ko][j] = msau::movm_trans(gc[j]);
        }
#pragma unroll
        for (int nx = 0; nx < NX; ++nx) {
          const uint2 u = wds[(ko * NX + nx) * 32 + lane];
          const unsigned bw[2] = {u.x, u.y};
          msau::mma_bf16(dx[nx], gc, bw);
        }
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        unsigned xf[4];
        msau::ldsm_x4(xf, xs + (mi * 16 + ar) * pp + pc + ac);
#pragma unroll
        for (int ko = 0; ko < MO; ++ko) {
          const unsigned b0[2] = {bt[ko][0], bt[ko][1]}, b1[2] = {bt[ko][2], bt[ko][3]};
          msau::mma_bf16(dw[mi][2 * ko], xf, b0);
          msau::mma_bf16(dw[mi][2 * ko + 1], xf, b1);
        }
      }
      __syncwarp();   // these pixels' x is read: dx takes its place
#pragma unroll
      for (int u = 0; u < MI; ++u) {
        const unsigned r[4] = {msau::pack_bf16(dx[2 * u][0], dx[2 * u][1]),
                               msau::pack_bf16(dx[2 * u][2], dx[2 * u][3]),
                               msau::pack_bf16(dx[2 * u + 1][0], dx[2 * u + 1][1]),
                               msau::pack_bf16(dx[2 * u + 1][2], dx[2 * u + 1][3])};
        msau::stsm_x4_trans(xs + (u * 16 + tr) * pp + pc + tc, r);
      }
    }
    __syncwarp();   // the chunk's dx is in its slot
    for (int i = lane; i < cin * per_row; i += 32) {
      const int row = i / per_row, v = i % per_row, p = p0 + 8 * v;
      if (p >= q.hw) continue;
      bf16* dst;
      int r;
      if (row < q.ca) {
        dst = da + ((int64_t)img * q.ca + row) * q.hw;
        r = row;
      } else {
        dst = db + ((int64_t)img * q.cb + row - q.ca) * q.hw;
        r = q.cb0 + row - q.ca;
      }
      const uint4 u = *reinterpret_cast<const uint4*>(xs + r * pp + 8 * v);
      if (q.vec) {
        *reinterpret_cast<uint4*>(dst + p) = u;
      } else {
        const bf16* e8 = reinterpret_cast<const bf16*>(&u);
        for (int e = 0; e < 8 && p + e < q.hw; ++e) dst[p + e] = e8[e];
      }
    }
    __syncwarp();   // before the slot is staged again
  }

  // the block's sums: each warp's dw [XR][GR] and dbias [GR] through shared
  // memory (the rings are read no more), added in warp order
  msau::cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem_raw);   // [warp][XR + 1][GR]
  float* own = red + warp * (XR + 1) * GR;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nt = 0; nt < NC; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        own[(mi * 16 + gq + e / 2 * 8) * GR + nt * 8 + 2 * tq + e % 2] = dw[mi][nt][e];
#pragma unroll
  for (int nt = 0; nt < NC; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = dbs[nt][e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (gq == 0) own[XR * GR + nt * 8 + 2 * tq + e] = v;
    }
  __syncthreads();
  float* part = partial + (int64_t)blockIdx.x * (q.cout * cin + q.cout);
  for (int i = threadIdx.x; i < (XR + 1) * GR; i += blockDim.x) {
    const int r = i / GR, co = i % GR, c = r < XR ? chan(r) : 0;
    if (co >= q.cout || c < 0) continue;
    float s = 0.f;
    for (int k = 0; k < q.nw; ++k) s += red[k * (XR + 1) * GR + i];
    part[r < XR ? co * cin + c : q.cout * cin + co] = s;
  }
}

// The bf16 kernel's (MI, MO) for the channels, or false where it has none:
// a's and b's rows padded to 8 each, at most 64 in all; at most 32 output
// channels.
bool bf16_tiles(int ca, int cb, int cout, int& mi, int& mo) {
  const int rows = (ca + 7) / 8 * 8 + (cb + 7) / 8 * 8;
  mi = rows <= 16 ? 1 : rows <= 32 ? 2 : 4;
  mo = cout <= 16 ? 1 : 2;
  return rows <= 64 && cout <= 32;
}

template <int MI, int MO>
int launch_bf16(const void* a, const void* b, const void* w, const float* bias, const void* g,
                void* da, void* db, float* partial, float* out, int n, BfGeom q, int act,
                cudaStream_t stream) {
  using S = BfShape<MI, MO>;
  // Two slots a warp (one chunk lands while the other computes) and 8
  // warps a block, 6 for the widest (168 registers), with chunks of 64
  // pixels where two blocks then share an SM, else 32: the fastest of the
  // settings timed on the H100 (4 to 16 warps, 2 to 4 slots, 32 to 128
  // pixels).
  q.nw = MI * MO > 2 ? 6 : 8;
  q.pw = 64;
  q.pp = q.pw + 8;
  if (S::smem_bytes(q) > (size_t)kSmem) {
    q.pw = 32;
    q.pp = q.pw + 8;
  }
  const size_t smem = S::smem_bytes(q);
  cudaError_t err = msau::allow_smem(concat1x1_bwd_bf16_kernel<MI, MO>, smem);
  if (err != cudaSuccess) return (int)err;
  q.chunks_img = (q.hw + q.pw - 1) / q.pw;
  const int64_t n_chunks = (int64_t)n * q.chunks_img;
  if (n_chunks > (1 << 30)) return (int)cudaErrorInvalidValue;
  q.n_chunks = (int)n_chunks;
  const int blocks = (int)std::min<int64_t>((n_chunks + q.nw - 1) / q.nw, msau::kPartialBlocks);
  q.vec = q.hw % 8 == 0 && (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0 &&
          (uintptr_t)g % 16 == 0 && (uintptr_t)da % 16 == 0 && (uintptr_t)db % 16 == 0;
  concat1x1_bwd_bf16_kernel<MI, MO><<<blocks, q.nw * 32, smem, stream>>>(
      (const bf16*)a, (const bf16*)b, (const bf16*)w, bias, (const bf16*)g, (bf16*)da,
      (bf16*)db, q, act, partial);
  const int code = (int)cudaGetLastError();
  if (code != 0) return code;
  return msau::sum_partials(partial, blocks, (int64_t)q.cout * (q.ca + q.cb) + q.cout, out,
                            stream);
}

}  // namespace

// 1 where one pass takes a coupling of ca + cb -> cout channels in the
// dtype (is_bf16), else 0: the wrapper then takes the two general kernels.
extern "C" int msau_concat_conv1x1_bwd_fits(int ca, int cb, int cout, int is_bf16) {
  if (ca <= 0 || cb <= 0 || cout <= 0) return 0;
  int mi, mo;
  if (is_bf16) return bf16_tiles(ca, cb, cout, mi, mo);
  Geom q = f32_channels(ca, cb, cout);
  return f32_geom(q);
}

// a: [n, ca, h, w], b: [n, cb, h, w], g: [n, cout, h, w] and w: [cout, ca +
// cb] (the 1x1 weight) in the activation dtype; bias f32 [cout]; act 0
// none, 1 relu, 2 elu.  Out: da, db in the activation dtype; partial: f32
// scratch of kPartialBlocks * (cout * (ca + cb) + cout) floats; out: f32
// [cout * (ca + cb) + cout], dw ([cout][ca + cb]) then dbias.  Channel
// counts that msau_concat_conv1x1_bwd_fits refuses are an error.
extern "C" int msau_concat_conv1x1_bwd(const void* a, const void* b, const void* w,
                                       const void* bias, const void* g, void* da, void* db,
                                       void* partial, void* out, int n, int ca, int cb, int h,
                                       int wd, int cout, int act, int is_bf16, void* stream) {
  if (n < 0 || h < 0 || wd < 0 || act < 0 || act > 2 || (int64_t)h * wd >= (1LL << 31) ||
      !msau_concat_conv1x1_bwd_fits(ca, cb, cout, is_bf16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0 || h == 0 || wd == 0)
    return (int)cudaMemsetAsync(out, 0, ((size_t)cout * (ca + cb) + cout) * sizeof(float), s);
  const float* bs = (const float*)bias;
  float *part = (float*)partial, *o = (float*)out;
  if (!is_bf16)
    return launch_f32(a, b, w, bs, g, da, db, part, o, n, h * wd, f32_channels(ca, cb, cout),
                      act, s);
  int mi, mo;
  bf16_tiles(ca, cb, cout, mi, mo);
  const BfGeom q{ca, cb, cout, h * wd, (ca + 7) / 8 * 8, 0, 0, 0, 0, 0, 0};
#define MSAU_CC_LAUNCH(MI, MO) \
  if (mi == MI && mo == MO) return launch_bf16<MI, MO>(a, b, w, bs, g, da, db, part, o, n, q, act, s)
  MSAU_CC_LAUNCH(1, 1);
  MSAU_CC_LAUNCH(1, 2);
  MSAU_CC_LAUNCH(2, 1);
  MSAU_CC_LAUNCH(2, 2);
  MSAU_CC_LAUNCH(4, 1);
  MSAU_CC_LAUNCH(4, 2);
#undef MSAU_CC_LAUNCH
  return (int)cudaErrorInvalidValue;
}
