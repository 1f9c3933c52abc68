// Backward of the stride-2 transposed conv of deconv.cu (torch's
// ConvTranspose2d(stride 2, padding K/2) to an exact target [Ho, Wo], Ho in
// {2H-1, 2H}, weight w [cin, cout, K, K]): with g the cotangent of the
// output,
//   dx[ci][m][j]      = sum_{co,ky,kx} w[ci][co][ky][kx] g[co][2m-p+ky][2j-p+kx]
//   dw[ci][co][ky][kx] = sum_{n,m,j}   x[ci][m][j]       g[co][2m-p+ky][2j-p+kx]
// (p = K/2, g read as 0 outside [0, Ho) x [0, Wo), so odd targets need no
// special case).  dx is a stride-2 conv of g; dw correlates x with g at the
// parity-class taps, and the zero-inserted canvas never exists.  db is one
// torch reduction, as it is an XLA sum in the JAX package.
//
// Replaces the TPU kernels msau_tpu/ops/flatconv.py:_dc_dx_kernel and
// _dc_dw_kernel (launcher _flat_deconv2_bwd), which build the transposed
// conv of g over the dilated rows in VMEM and sample it with a 0/1 matrix
// on the MXU, and _ups_bwd_kernel (launcher _flat_upsample2_bwd: g sampled
// at the even positions, the two-op form's zero-insert backward, which
// this dx computes together with the conv's dx, as deconv.cu's forward
// folds the zero-insert in).
//
// dx with the 3x3 kernel (every configuration's filter_size): 9*cin*cout
// FMAs per input pixel against 4 cout + cin values moved, so in f32 the
// FP32 pipes bound it (67 TFLOP/s; at 16 -> 8 channels to 512^2 its 201 MB
// come close) and in bf16, with the tensor cores doing the arithmetic,
// device memory.  Both designs (below, "dx, the 3x3 kernel") give one block
// every input channel of its pixel tile (so g is read once) and read g's
// tap windows from shared memory without bank conflicts: f32 stages g rows
// as they lie by double-buffered cp.async and computes on the FP32 pipes
// (64 sums per thread), bf16 de-interleaves g into parity planes and runs
// mma.sync.  dx is written once, in the activation dtype.  Any other odd K
// takes the general dx kernel (FP32 pipes): a block owns 32 x 8 input
// pixels of one image and 8 input channels; it stages the g rows its
// pixels read 8 output channels at a time as [row][col][co], beside the
// weights as [co][tap][ci], in shared memory.
//
// dw with the 3x3 kernel (every configuration's filter_size): 9*cin*cout
// FMAs per input pixel against cin + 4 cout values read.  In f32 the FP32
// pipes bound it (67 TFLOP/s; at 16 -> 8 channels to 512^2 its 201 MB come
// close); in bf16, with the tensor cores doing the arithmetic, device
// memory.  The design (below, "dw, the 3x3 kernel"): split-K over pixels,
// each tile staged once for all channels (output channels taken in chunks
// only where shared memory forces it: beyond about 210 in f32 and 136 in
// bf16) with g de-interleaved into parity planes so every tap is a small
// GEMM over shifted windows; f32 on the FP32 pipes with 48 sums per
// thread, bf16 on mma.sync; each block's sums stay in registers across its
// tiles, are written once as a tile-major partial row (contiguous stores),
// and one more kernel adds the rows in block order: no float atomics, and
// the same inputs give the same bits.  Any other odd K takes the general
// dw kernel ("dw, any odd K"): 8 x 8 channel groups of a 32 x 8 pixel tile
// staged at a time, a thread per (input channel, tap) pair and pixel
// slice, FP32 pipes, its partial rows summed the same way.

#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

using msau::load_row;
using msau::store;
using msau::store4;
using msau::to_f32;

constexpr int kQx = 32;   // input columns per tile: one per lane
constexpr int kTy = 4;    // warps per block
constexpr int kQr = 2;    // input rows per thread (dx)
constexpr int kThreads = kQx * kTy;
constexpr int kTh = kTy * kQr;   // input rows per tile
constexpr int kG = 8;            // channels staged / owned per group

struct Dims {
  int cin, h, w, cout, k, ho, wo;
  int gc;   // g's channels: its image stride and dw's co stride (dw takes
            // cout of them per launch, dx all)
  __host__ __device__ int p() const { return k / 2; }
  __host__ __device__ int gh() const { return 2 * kTh + k - 2; }   // g rows
  __host__ __device__ int gw() const { return 2 * kQx + k - 2; }   // g cols
};

// Stages g channels [c0, c0 + cc) read by the tile at input (m0, j0) into
// gs[row][col][kG] (zero outside the target and for channels past cc).
template <typename T>
__device__ inline void stage_g(const T* __restrict__ g, const Dims& d, float* gs,
                               int img, int c0, int cc, int m0, int j0) {
  const int gh = d.gh(), gw = d.gw();
  const int64_t plane = (int64_t)d.ho * d.wo;
  for (int i = threadIdx.x; i < gh * gw * kG; i += kThreads) {
    const int c = i % kG, rc = i / kG;
    const int r = rc / gw, q = rc % gw;
    const int oy = 2 * m0 - d.p() + r, ox = 2 * j0 - d.p() + q;
    gs[i] = (c < cc && oy >= 0 && oy < d.ho && ox >= 0 && ox < d.wo)
                ? to_f32(g[((int64_t)img * d.cout + c0 + c) * plane +
                           (int64_t)oy * d.wo + ox])
                : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
deconv2_dx_kernel(const T* __restrict__ g, const T* __restrict__ w, T* __restrict__ dx,
                  Dims d, int groups) {
  extern __shared__ __align__(16) float smem[];
  const int taps = d.k * d.k, gw = d.gw();
  float* gs = smem;                           // [gh][gw][kG] of output channels
  float* ws = smem + d.gh() * gw * kG;        // [kG co][taps][kG ci]
  const int img = blockIdx.z / groups, ci0 = (blockIdx.z % groups) * kG;
  const int m0 = blockIdx.y * kTh, j0 = blockIdx.x * kQx;
  const int tx = threadIdx.x % kQx, ty = threadIdx.x / kQx;
  float acc[kQr][kG];
#pragma unroll
  for (int i = 0; i < kQr; ++i)
#pragma unroll
    for (int c = 0; c < kG; ++c) acc[i][c] = 0.f;

  for (int c0 = 0; c0 < d.cout; c0 += kG) {
    const int cc = min(kG, d.cout - c0);
    __syncthreads();
    stage_g<T>(g, d, gs, img, c0, cc, m0, j0);
    for (int i = threadIdx.x; i < kG * taps * kG; i += kThreads) {
      const int ci = i % kG, t = i / kG;
      const int tap = t % taps, co = t / taps;
      ws[i] = (co < cc && ci0 + ci < d.cin)
                  ? to_f32(w[((int64_t)(ci0 + ci) * d.cout + c0 + co) * taps + tap])
                  : 0.f;
    }
    __syncthreads();
    for (int co = 0; co < cc; ++co) {
      for (int tap = 0; tap < taps; ++tap) {
        float wv[kG];
        load_row(wv, ws + (co * taps + tap) * kG);
        const int ky = tap / d.k, kx = tap % d.k;
#pragma unroll
        for (int i = 0; i < kQr; ++i) {
          const float v = gs[((2 * (ty * kQr + i) + ky) * gw + 2 * tx + kx) * kG + co];
#pragma unroll
          for (int c = 0; c < kG; ++c) acc[i][c] = fmaf(v, wv[c], acc[i][c]);
        }
      }
    }
  }
  const int64_t plane = (int64_t)d.h * d.w;
  const int j = j0 + tx;
#pragma unroll
  for (int i = 0; i < kQr; ++i) {
    const int m = m0 + ty * kQr + i;
    if (m >= d.h || j >= d.w) continue;
#pragma unroll
    for (int c = 0; c < kG; ++c)
      if (ci0 + c < d.cin)
        store(dx + ((int64_t)img * d.cin + ci0 + c) * plane + (int64_t)m * d.w + j,
              acc[i][c]);
  }
}

// ---- dx, the 3x3 kernel, f32 ---------------------------------------------------
//
// dx[ci][m][j] = sum_{co,ky,kx} w[ci][co][ky][kx] g[co][2m-1+ky][2j-1+kx]: for
// a tile of input pixels a GEMM with M = input channels, N = the tile's
// pixels, K = 9 cout, on the FP32 pipes (f32 holds 1e-5: no TF32).  A block
// of 16 warps owns up to 64 input channels (all of them in every
// configuration, so g is read from device memory once) of a tile of 32
// input columns and 128 / ceil(cin / 8) rows.  Warp w owns the 8 input
// channels of group w % cg and 8 rows of the tile; lane (rq, cq) owns 2
// rows x 4 columns of them (64 sums).  The g rows the tile reads (2 tr + 1
// rows of 65 columns) are staged as they lie, by 16-byte cp.async, a chunk
// of output channels at a time and double buffered, so the next chunk
// loads while this one is multiplied; the weights come with them by 4-byte
// cp.async, read in order and written as [co][tap][ci].  The 9 columns
// 2j - 1 .. 2j + 7 of one g row hold every tap column of the lane's 4
// pixels: it reads 2j .. 2j + 7 (two float4) and takes 2j - 1 from its
// neighbour lane by a shuffle; per output channel it reads 5 rows and 9 x 2
// float4 of weights (the same for the whole warp) for 9 x 64 FMAs.  The
// chunks of a row's second half are rotated by one, so the 8 lanes of a
// row read 8 distinct bank groups in each of their two loads.

constexpr int kDxTc = 32;              // input columns per tile: 8 lanes x 4
constexpr int kDxChunks = 2 * kDxTc / 4;   // 16-byte chunks of a staged row
constexpr int kDxPitch = 2 * kDxTc + 4;    // a staged row: 64 columns, then 2 j0 - 1

// where chunk k of a staged row sits
__host__ __device__ constexpr int dx_slot(int k) { return k >= 8 ? 8 + ((k + 1) & 7) : k; }

struct DxGeom {
  int nw;   // warps per block
  int cg;   // groups of 8 input channels per block (1, 2, 4 or 8)
  int tr;   // tile rows: 8 per pixel warp, nw / cg pixel warps
  int cc;   // output channels per staged chunk
  __host__ __device__ int grows() const { return 2 * tr + 1; }
  // weights [cc][tap][wst()]: rows of 8 cg input channels, padded by 4 (the
  // staging writes rows 4 banks apart)
  __host__ __device__ int wst() const { return 8 * cg + 4; }
  // one buffer: the chunk's g rows [cc][grows][kDxPitch], then its weights
  __host__ __device__ int gfloats() const { return cc * grows() * kDxPitch; }
  __host__ __device__ int buf_floats() const { return gfloats() + cc * 9 * wst(); }
};

// nw warps: 16 (one block per SM) or 8 (two, in half the shared memory);
// chunks of output channels as even as the staging allows
DxGeom dx_geom(int cin, int cout, int nw) {
  DxGeom geo{nw, 1, 0, 1};
  const int groups = (std::min(cin, 64) + 7) / 8;
  while (geo.cg < groups) geo.cg *= 2;
  geo.tr = 8 * nw / geo.cg;
  const size_t cap = (nw == 16 ? 220 : 110) * 1024;
  while (geo.cc < std::min(cout, 16)) {
    DxGeom more = geo;
    ++more.cc;
    if (2 * (size_t)more.buf_floats() * 4 > cap) break;
    geo = more;
  }
  const int chunks = (cout + geo.cc - 1) / geo.cc;
  geo.cc = (cout + chunks - 1) / chunks;
  return geo;
}

// columns 2j - 1 .. 2j + 7 of a staged row for the lane's 4 pixels (j =
// j0 + 4 cq): 2j .. 2j + 7 from its chunks lo and hi, 2j - 1 from the lane
// before (lane cq = 0: the row's last element)
__device__ inline void dx_row(float (&v)[9], const float* row, int cq, int lo, int hi) {
  load_row(*reinterpret_cast<float(*)[4]>(v + 1), row + lo);
  load_row(*reinterpret_cast<float(*)[4]>(v + 5), row + hi);
  const float prev = __shfl_up_sync(0xffffffffu, v[8], 1);
  v[0] = cq == 0 ? row[2 * kDxTc] : prev;
}

// acc[c][r][e] += w[c] g over the 3 tap columns of one tap row, the lane's
// rows r = 0, 1 reading staged rows v0, v1
__device__ __forceinline__ void dx_taps(float (&acc)[8][2][4], const float (&v0)[9],
                                        const float (&v1)[9], const float* wk, int wstride) {
#pragma unroll
  for (int kx = 0; kx < 3; ++kx) {
    float wv[8];
    load_row(wv, wk + kx * wstride);
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[c][0][e] = fmaf(wv[c], v0[2 * e + kx], acc[c][0][e]);
        acc[c][1][e] = fmaf(wv[c], v1[2 * e + kx], acc[c][1][e]);
      }
  }
}

// grid: (column tiles, row tiles, n * ci passes of 64 channels)
__global__ void __launch_bounds__(512, 1)
deconv2_dx3_kernel(const float* __restrict__ g, const float* __restrict__ w,
                   float* __restrict__ dx, Dims d, DxGeom geo, int passes, int vec_g,
                   int vec_x) {
  extern __shared__ __align__(16) float smem[];
  const int cg = geo.cg, tr = geo.tr, gr = geo.grows(), wst = geo.wst();
  const int img = blockIdx.z / passes, ci0 = (blockIdx.z % passes) * 64;
  const int m0 = blockIdx.y * tr, j0 = blockIdx.x * kDxTc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cgi = warp % cg, rq = lane / 8, cq = lane % 8;
  const int mb = (warp / cg) * 8 + 2 * rq;   // the lane's first tile row
  const int64_t gplane = (int64_t)d.ho * d.wo;
  const int chunks = (d.cout + geo.cc - 1) / geo.cc;

  auto stage = [&](int c, int b) {
    const int co0 = c * geo.cc, cc = min(geo.cc, d.cout - co0);
    float* gs = smem + b * geo.buf_floats();
    // two rows per warp, a half-warp each: lane k < 16 copies chunk k
    // (columns 2 j0 + 4k ..), lane 0 also column 2 j0 - 1
    const int k = lane % 16;
    for (int row = 2 * warp + lane / 16; row < cc * gr; row += 2 * geo.nw) {
      const int co = row / gr, rr = row - co * gr;
      const int gy = 2 * m0 - 1 + rr;
      const bool row_ok = gy >= 0 && gy < d.ho;
      const float* src =
          g + ((int64_t)img * d.cout + co0 + co) * gplane + (int64_t)(row_ok ? gy : 0) * d.wo;
      float* dst = gs + row * kDxPitch;
      if (k == 0) {
        const int gx = 2 * j0 - 1;
        msau::cp_async4(dst + 2 * kDxTc, src + max(gx, 0), row_ok && gx >= 0 && gx < d.wo);
      }
      const int gx = 2 * j0 + 4 * k;
      float* dk = dst + 4 * dx_slot(k);
      if (!row_ok || gx >= d.wo) {
        msau::cp_async16(dk, g, false);
      } else if (vec_g && gx + 4 <= d.wo) {
        msau::cp_async16(dk, src + gx);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          msau::cp_async4(dk + e, src + min(gx + e, d.wo - 1), gx + e < d.wo);
      }
    }
    // the weights w[ch][co0 .. co0 + cc)[tap], a contiguous run per input
    // channel: a warp per input channel, its lanes along the run
    float* ws = gs + geo.gfloats();
    for (int ci = warp; ci < 8 * cg; ci += geo.nw) {
      const int ch = ci0 + ci;
      const float* src = w + ((int64_t)min(ch, d.cin - 1) * d.cout + co0) * 9;
      for (int kk = lane; kk < cc * 9; kk += 32)
        msau::cp_async4(ws + kk * wst + ci, src + kk, ch < d.cin);
    }
    msau::cp_async_commit();
  };

  float acc[8][2][4];
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][r][e] = 0.f;
  const int lo = 4 * dx_slot(2 * cq), hi = 4 * dx_slot(2 * cq + 1);   // the lane's two chunks

  stage(0, 0);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      stage(c + 1, (c + 1) & 1);
      msau::cp_async_wait<1>();
    } else {
      msau::cp_async_wait<0>();
    }
    __syncthreads();   // chunk c staged
    const int cc = min(geo.cc, d.cout - c * geo.cc);
    const float* gs = smem + (c & 1) * geo.buf_floats();
    const float* ws = gs + geo.gfloats() + cgi * 8;
    gs += 2 * mb * kDxPitch;
    for (int co = 0; co < cc; ++co) {
      // staged row 2 mb + rr is g row 2 (m0 + mb) - 1 + rr: tap row ky of
      // the lane's row r reads rr = 2 r + ky
      const float* gc = gs + co * gr * kDxPitch;
      const float* wk = ws + co * 9 * wst;
      float va[9], vb[9];
      dx_row(va, gc, cq, lo, hi);
      dx_row(vb, gc + 2 * kDxPitch, cq, lo, hi);
      dx_taps(acc, va, vb, wk, wst);                  // ky 0: rr 0, 2
      dx_row(va, gc + 4 * kDxPitch, cq, lo, hi);
      dx_taps(acc, vb, va, wk + 6 * wst, wst);        // ky 2: rr 2, 4
      dx_row(va, gc + kDxPitch, cq, lo, hi);
      dx_row(vb, gc + 3 * kDxPitch, cq, lo, hi);
      dx_taps(acc, va, vb, wk + 3 * wst, wst);        // ky 1: rr 1, 3
    }
    __syncthreads();   // buffer c & 1 is staged again
  }
  const int64_t xplane = (int64_t)d.h * d.w;
  const int j = j0 + 4 * cq;
  if (j >= d.w) return;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int ch = ci0 + cgi * 8 + c;
    if (ch >= d.cin) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = m0 + mb + r;
      if (m < d.h) store4(dx + ((int64_t)img * d.cin + ch) * xplane + (int64_t)m * d.w, j, d.w,
                          vec_x, acc[c][r]);
    }
  }
}

// ---- dw, the 3x3 kernel -------------------------------------------------------
//
// dw[ci][co][ky][kx] = sum_{n,m,j} x[ci][m][j] g[co][2m-1+ky][2j-1+kx] (3x3,
// padding 1).  A block walks tiles of tr x 32 input pixels and stages
// each tile once for every channel: x as [ci][pixel], and g de-interleaved
// into its parity planes g_ab[co][m][j] = g[co][2m+a-1][2j+b-1] on a
// (tile + 1)^2 window, so tap (ky, kx) reads plane (ky % 2, kx % 2) at
// (m + ky / 2, j + kx / 2): every tap is a shifted window of one plane and
// dw_tap = X G_tap^T a small GEMM (M = cin, N = cout, K = the tile's
// pixels).  Each block's sums stay in registers over all its tiles and land
// in its own partial row, which deconv2_dw_sum_kernel adds in block order.

constexpr int kDwTc = 32;   // input columns per tile

// Tile rows: the most of 4, 2, 1 whose staging lets two blocks share an
// SM, else the most that fits one block.
template <typename Bytes>
int dw_tile_rows(Bytes bytes_of) {
  for (size_t cap : {(size_t)113 * 1024, (size_t)227 * 1024})
    for (int tr : {4, 2, 1})
      if (bytes_of(tr) <= cap) return tr;
  return 0;
}

// Blocks of a dw launch: every block writes, and the sum reads, one
// partial row of cin * cout * 9 sums, so a block takes at least 512 input
// pixels where that still leaves one block per SM (at 64 -> 32 channels
// the rows are 18 K floats: more blocks cost more in writes and in the sum
// than they gain in spread), and at most kPartialBlocks blocks.
int dw_blocks(int64_t n_tiles, int tr) {
  const int64_t by_pixels = std::max<int64_t>(132, n_tiles * tr * kDwTc / 512);
  return (int)std::min<int64_t>({n_tiles, by_pixels, (int64_t)msau::kPartialBlocks});
}

// f32: FP32 pipes.  Thread (ot, s): output tile ot = 4 input channels x 4
// output channels x the 3 taps of one row ky (48 sums; each g value read
// feeds 4 FMAs, each x value 12), pixel slice s of ps (consecutive lanes,
// added by a butterfly of shuffles at the end).
// The staging layout, shared by the launch (sizes) and the kernel (offsets):
// x [cig * 4][xp] floats (rows 16-byte aligned), then the g planes
// [a][b][cog][tr + 1][kDwTc + 1] as float4 over 4 output channels.
struct DwF32Geom {
  int tr, cig, cog, xp, plane;
  __host__ __device__ DwF32Geom(const Dims& d, int tr_)
      : tr(tr_), cig((d.cin + 3) / 4), cog((d.cout + 3) / 4), xp(tr_ * kDwTc + 4),
        plane((tr_ + 1) * (kDwTc + 1)) {}
  size_t bytes() const { return (size_t)cig * 4 * xp * 4 + (size_t)4 * cog * plane * 16; }
};

__global__ void __launch_bounds__(512)
deconv2_dw_f32_kernel(const float* __restrict__ x, const float* __restrict__ g, Dims d,
                      DwF32Geom geo, int tiles_x, int tiles_y, int n_tiles, int ps,
                      int vec_x, int vec_g, float* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  const int tr = geo.tr, cig_n = geo.cig, cog_n = geo.cog, xp = geo.xp, plane = geo.plane;
  const int P = tr * kDwTc;
  float* xs = reinterpret_cast<float*>(smem4);
  float4* gs = smem4 + cig_n * xp;
  const int64_t xplane = (int64_t)d.h * d.w, gplane = (int64_t)d.ho * d.wo;
  const int ots = cig_n * cog_n * 3, per_pass = blockDim.x / ps;
  for (int ot0 = 0; ot0 < ots; ot0 += per_pass) {
    const int ot = ot0 + threadIdx.x / ps, s = threadIdx.x % ps;
    const bool active = ot < ots;
    // output channel groups vary fastest: a warp's lanes then read one x
    // value (broadcast) and g planes whose strides fall in distinct banks
    const int cog = ot % cog_n, ky = (ot / cog_n) % 3, cig = ot / (cog_n * 3);
    float acc[4][4][3];
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int k = 0; k < 3; ++k) acc[e][c][k] = 0.f;

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int img = tile / (tiles_x * tiles_y), t2 = tile % (tiles_x * tiles_y);
      const int j0 = (t2 % tiles_x) * kDwTc, m0 = (t2 / tiles_x) * tr;
      __syncthreads();   // the previous tile's readers are done
      for (int i = threadIdx.x; i < cig_n * 4 * tr * (kDwTc / 4); i += blockDim.x) {
        const int q = i % (kDwTc / 4), r = (i / (kDwTc / 4)) % tr, ci = i / (tr * kDwTc / 4);
        const int gy = m0 + r, gx = j0 + 4 * q;
        float* dst = xs + ci * xp + r * kDwTc + 4 * q;
        const float* src = x + ((int64_t)img * d.cin + ci) * xplane + (int64_t)gy * d.w;
        if (ci >= d.cin || gy >= d.h || gx >= d.w) {
          msau::cp_async16(dst, x, false);
        } else if (vec_x && gx + 4 <= d.w) {
          msau::cp_async16(dst, src + gx);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            msau::cp_async4(dst + e, src + min(gx + e, d.w - 1), gx + e < d.w);
        }
      }
      msau::cp_async_commit();
      // g rows 2 m0 - 1 + rr, rr < 2 tr + 1; columns 2 j0 - 1 + cc, cc <=
      // 2 kDwTc: 16 groups of 4 from 2 j0 (q < 16), and column 2 j0 - 1
      constexpr int kq = kDwTc / 2 + 1;
      for (int i = threadIdx.x; i < cog_n * (2 * tr + 1) * kq; i += blockDim.x) {
        const int q = i % kq, rr = (i / kq) % (2 * tr + 1), cg = i / (kq * (2 * tr + 1));
        const int gy = 2 * m0 - 1 + rr, a = rr & 1, mm = rr >> 1;
        const bool row_ok = gy >= 0 && gy < d.ho;
        float v[4][4];   // [co][column]
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int co = 4 * cg + c;
          const float* src = g + ((int64_t)img * d.gc + co) * gplane + (int64_t)gy * d.wo;
          const bool ok = row_ok && co < d.cout;
          if (q == kq - 1) {
            const int gx = 2 * j0 - 1;
            v[c][0] = ok && gx >= 0 ? src[gx] : 0.f;
          } else {
            const int gx = 2 * j0 + 4 * q;
            if (ok && vec_g && gx + 4 <= d.wo) {
              const float4 u = *reinterpret_cast<const float4*>(src + gx);
              v[c][0] = u.x;
              v[c][1] = u.y;
              v[c][2] = u.z;
              v[c][3] = u.w;
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) v[c][e] = ok && gx + e < d.wo ? src[gx + e] : 0.f;
            }
          }
        }
        float4* gp = gs + ((a * 2) * cog_n + cg) * plane + mm * (kDwTc + 1);
        if (q == kq - 1) {   // cc = 0: plane b = 0, column 0
          gp[0] = make_float4(v[0][0], v[1][0], v[2][0], v[3][0]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {   // cc = 1 + 4q + e: plane b = cc % 2
            const int cc = 1 + 4 * q + e, b = cc & 1;
            gp[b * cog_n * plane + (cc >> 1)] = make_float4(v[0][e], v[1][e], v[2][e], v[3][e]);
          }
        }
      }
      msau::cp_async_wait<0>();
      __syncthreads();
      if (active) {
        const float* xc = xs + 4 * cig * xp;
        const float4* gk = gs + ((ky & 1) * 2 * cog_n + cog) * plane + (ky >> 1) * (kDwTc + 1);
        const int b0 = cog_n * plane;   // plane b = 1 after plane b = 0
        for (int p = s; p < P; p += ps) {
          const int mi = p / kDwTc, ji = p % kDwTc;
          float xv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) xv[e] = xc[e * xp + p];
          const float4* gr = gk + mi * (kDwTc + 1) + ji;
          const float4 gv[3] = {gr[0], gr[b0], gr[1]};   // kx 0, 1, 2
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const float gc[4] = {gv[k].x, gv[k].y, gv[k].z, gv[k].w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[e][c][k] = fmaf(xv[e], gc[c], acc[e][c][k]);
          }
        }
      }
    }
    // the ps slices of an output tile are consecutive lanes
    for (int off = ps / 2; off > 0; off /= 2)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int k = 0; k < 3; ++k)
            acc[e][c][k] += __shfl_xor_sync(0xffffffffu, acc[e][c][k], off);
    // this block's partial row, tile-major: output tile ot's 48 sums
    // [ci][co][kx] side by side, so a warp's stores are contiguous
    if (active && s == 0) {
      float4* part = reinterpret_cast<float4*>(partial + (int64_t)blockIdx.x * ots * 48) +
                     ot * 12;
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int q = 0; q < 3; ++q)   // sums 4q .. 4q + 3 of acc[e] as [co][kx]
          part[e * 3 + q] = make_float4(
              acc[e][(4 * q) / 3][(4 * q) % 3], acc[e][(4 * q + 1) / 3][(4 * q + 1) % 3],
              acc[e][(4 * q + 2) / 3][(4 * q + 2) % 3], acc[e][(4 * q + 3) / 3][(4 * q + 3) % 3]);
    }
  }
}

// bf16: mma.sync m16n8k16, A = x [16 input channels][16 pixels] (ldmatrix
// from [ci][pixel]), B = the tap's window of g [8 output channels][16
// pixels] (ldmatrix from [co][pixel] rows).  ldmatrix rows must be 16-byte
// aligned, so the plane b = 0, read at column offsets 0 (kx 0) and 1 (kx
// 2), is kept twice: g is staged as V[ky % 2][kx][co][m][j] =
// g[co][2m + ky % 2 - 1][2j + kx - 1], 1.5 copies of the tile's g.  A warp
// owns PPW (16 input x 8 output channel) pairs for all 9 taps (36 PPW
// sums) and a 1 / ks share of the tile's 16-pixel steps; the ks shares are
// added in order through shared memory at the end.
constexpr int kDwWarps = 8;
constexpr int kDwVPitch = 40;   // V rows: 32 columns + 8 (80 bytes)

struct DwBfGeom {
  int tr, cit, cot, xp, cs;   // tile rows, channel tiles, x row and V channel strides
  __host__ __device__ DwBfGeom(const Dims& d, int tr_)
      : tr(tr_), cit((d.cin + 15) / 16), cot((d.cout + 7) / 8),
        xp(msau::ldsm_stride(tr_ * kDwTc)), cs(msau::ldsm_stride((tr_ + 1) * kDwVPitch)) {}
  size_t stage_bytes() const { return ((size_t)cit * 16 * xp + (size_t)6 * cot * 8 * cs) * 2; }
  size_t bytes() const {   // the ks shares' sums reuse the staging space
    return std::max(stage_bytes(), (size_t)kDwWarps * 9 * 128 * 4);
  }
};

template <int PPW>
__global__ void __launch_bounds__(kDwWarps * 32)
deconv2_dw_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                       Dims d, DwBfGeom geo, int tiles_x, int tiles_y, int n_tiles,
                       int ks, int vec_x, int vec_g, float* __restrict__ partial) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tr = geo.tr, cit_n = geo.cit, cot_n = geo.cot, xp = geo.xp, cs = geo.cs;
  const int vs = cot_n * 8 * cs;   // one (ky % 2, kx) variant of V
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);   // [cit_n * 16][xp]
  bf16* vv = xs + cit_n * 16 * xp;                // [ky % 2][kx][co][tr + 1][kDwVPitch]
  float* red = reinterpret_cast<float*>(smem_raw);
  const int64_t xplane = (int64_t)d.h * d.w, gplane = (int64_t)d.ho * d.wo;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, mi = lane / 8, lr = lane % 8;
  const int pairs = cit_n * cot_n, ksl = warp % ks, pg = warp / ks;
  const int per_pass = (kDwWarps / ks) * PPW;
  const bf16 zero = __float2bfloat16(0.f);

  for (int pb = 0; pb < pairs; pb += per_pass) {
    int cit[PPW], cot[PPW];
    bool live[PPW];
#pragma unroll
    for (int i = 0; i < PPW; ++i) {
      const int p = pb + pg * PPW + i;
      live[i] = pg < kDwWarps / ks && p < pairs;
      cit[i] = live[i] ? p / cot_n : 0;
      cot[i] = live[i] ? p % cot_n : 0;
    }
    float acc[PPW][9][4];
#pragma unroll
    for (int i = 0; i < PPW; ++i)
#pragma unroll
      for (int t = 0; t < 9; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][t][e] = 0.f;

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int img = tile / (tiles_x * tiles_y), t2 = tile % (tiles_x * tiles_y);
      const int j0 = (t2 % tiles_x) * kDwTc, m0 = (t2 / tiles_x) * tr;
      __syncthreads();
      for (int i = threadIdx.x; i < cit_n * 16 * tr * (kDwTc / 8); i += blockDim.x) {
        const int q = i % (kDwTc / 8), r = (i / (kDwTc / 8)) % tr, ci = i / (tr * kDwTc / 8);
        const int gy = m0 + r, gx = j0 + 8 * q;
        bf16* dst = xs + ci * xp + r * kDwTc + 8 * q;
        const bf16* src = x + ((int64_t)img * d.cin + ci) * xplane + (int64_t)gy * d.w + gx;
        if (ci >= d.cin || gy >= d.h || gx >= d.w) {
          msau::cp_async16(dst, x, false);
        } else if (vec_x && gx + 8 <= d.w) {
          msau::cp_async16(dst, src);
        } else {
          alignas(16) bf16 v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = gx + e < d.w ? src[e] : zero;
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
        }
      }
      msau::cp_async_commit();
      // g rows 2 m0 - 1 + rr (rr < 2 tr + 1), one per thread: columns
      // 2 j0 .. 2 j0 + 63 as 8 groups of 8 (all loaded before any is
      // stored) and column 2 j0 - 1
      const int grows = cot_n * 8 * (2 * tr + 1);
      for (int gi = threadIdx.x; gi < grows; gi += blockDim.x) {
        const int rr = gi % (2 * tr + 1), co = gi / (2 * tr + 1);
        const int gy = 2 * m0 - 1 + rr;
        const bool ok = gy >= 0 && gy < d.ho && co < d.cout;
        const bf16* src = g + ((int64_t)img * d.gc + co) * gplane + (int64_t)gy * d.wo;
        constexpr int kq = kDwTc / 4;
        uint4 v[kq];
#pragma unroll
        for (int q = 0; q < kq; ++q) {
          const int gx = 2 * j0 + 8 * q;
          if (ok && vec_g && gx + 8 <= d.wo) {
            v[q] = *reinterpret_cast<const uint4*>(src + gx);
          } else {
            alignas(16) bf16 e8[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) e8[e] = ok && gx + e < d.wo ? src[gx + e] : zero;
            v[q] = *reinterpret_cast<const uint4*>(e8);
          }
        }
        bf16* row = vv + ((rr & 1) * 3 * cot_n * 8 + co) * cs + (rr >> 1) * kDwVPitch;
        row[0] = ok && j0 > 0 ? src[2 * j0 - 1] : zero;   // column 2 j0 - 1: kx 0 at j 0
#pragma unroll
        for (int q = 0; q < kq; ++q) {
          // element e: even e (odd columns from 2 j0 - 1) is kx 1 at j =
          // 4q + e / 2; odd e is kx 2 at 4q + (e - 1) / 2 and kx 0 at
          // 4q + (e + 1) / 2
          const unsigned u[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
          *reinterpret_cast<uint2*>(row + vs + 4 * q) =
              make_uint2(__byte_perm(u[0], u[1], 0x5410), __byte_perm(u[2], u[3], 0x5410));
          *reinterpret_cast<uint2*>(row + 2 * vs + 4 * q) =
              make_uint2(__byte_perm(u[0], u[1], 0x7632), __byte_perm(u[2], u[3], 0x7632));
#pragma unroll
          for (int k = 0; k < 4; ++k)   // e = 2k + 1: the high half of u[k]
            if (4 * q + k + 1 < kDwTc)
              row[4 * q + k + 1] = __ushort_as_bfloat16((unsigned short)(u[k] >> 16));
        }
      }
      msau::cp_async_wait<0>();
      __syncthreads();
      for (int step = ksl; step < 2 * tr; step += ks) {
        const int r = step / 2, c0 = (step % 2) * 16;
        unsigned afr[PPW][4];
#pragma unroll
        for (int i = 0; i < PPW; ++i)
          msau::ldsm_x4(afr[i], xs + (cit[i] * 16 + (mi & 1) * 8 + lr) * xp + step * 16 +
                                    (mi >> 1) * 8);
#pragma unroll
        for (int i = 0; i < PPW; ++i) {
          // two taps per ldmatrix.x4: lanes 16-31 address the second
          const bf16* col = vv + (cot[i] * 8 + lr) * cs + c0 + (mi & 1) * 8;
#pragma unroll
          for (int t = 0; t < 9; t += 2) {
            const int tt = (t + 1 < 9 && (mi >> 1)) ? t + 1 : t;
            const int ky = tt / 3, kx = tt % 3;
            const bf16* p = col + ((ky & 1) * 3 + kx) * vs + (r + (ky >> 1)) * kDwVPitch;
            if (t + 1 < 9) {
              unsigned b4[4];
              msau::ldsm_x4(b4, p);
              const unsigned lo[2] = {b4[0], b4[1]}, hi[2] = {b4[2], b4[3]};
              msau::mma_bf16(acc[i][t], afr[i], lo);
              msau::mma_bf16(acc[i][t + 1], afr[i], hi);
            } else {
              unsigned b2[2];
              msau::ldsm_x2(b2, p);
              msau::mma_bf16(acc[i][t], afr[i], b2);
            }
          }
        }
      }
    }
    // acc[i][tap]: rows (input channels) lane / 4 and + 8, columns (output
    // channels) 2 (lane % 4) and + 1.  The block's partial row is
    // tile-major, [pair][tap][16 ci][8 co], so a warp's stores are contiguous
    const int gq = lane / 4, t4 = lane % 4;
    float* part = partial + (int64_t)blockIdx.x * pairs * 9 * 128 + gq * 8 + 2 * t4;
    auto emit = [&](int i, int t, float v0, float v1, float v2, float v3) {
      float* dst = part + ((int64_t)(pb + pg * PPW + i) * 9 + t) * 128;
      *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      *reinterpret_cast<float2*>(dst + 64) = make_float2(v2, v3);
    };
    if (ks == 1) {
#pragma unroll
      for (int i = 0; i < PPW; ++i)
        if (live[i])
#pragma unroll
          for (int t = 0; t < 9; ++t)
            emit(i, t, acc[i][t][0], acc[i][t][1], acc[i][t][2], acc[i][t][3]);
    } else {   // PPW == 1: add the ks shares in order
      __syncthreads();   // the staging space is read no more
      float* mine = red + ((size_t)warp * 9) * 128 + lane * 4;
#pragma unroll
      for (int t = 0; t < 9; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[t * 128 + e] = acc[0][t][e];
      __syncthreads();
      if (ksl == 0 && live[0]) {
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          float v[4] = {0.f, 0.f, 0.f, 0.f};
          for (int k = 0; k < ks; ++k)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              v[e] += red[((size_t)(warp + k) * 9 + t) * 128 + lane * 4 + e];
          emit(0, t, v[0], v[1], v[2], v[3]);
        }
      }
    }
  }
}

// ---- dx, the 3x3 kernel, bf16: mma.sync ---------------------------------------
//
// The same GEMM (M = input channels, N = the tile's pixels, K = (tap, output
// channel) pairs) on the tensor cores: mma.sync m16n8k16, f32 sums.  g is
// staged as dw's bf16 kernel stages it, V[ky % 2][kx][co][m][j] =
// g[co][2m + ky % 2 - 1][2j + kx - 1] (the plane b = 0 kept twice, so every
// tap's window of 8 columns is a 16-byte aligned run): B, 16 (tap, output
// channel) pairs x 8 pixels of one row, is two 8 x 8 matrices that
// ldmatrix .trans reads row by row, each lane giving the address of its
// pair's row, so the K axis can take the weights' own order: pair k of a
// chunk is output channel co0 + k / 9, tap k % 9, and A, the weights as
// [input channel][k], is a straight copy of each input channel's run
// w[ci][co0 ..][tap] (16-byte cp.async, no transpose), read by ldmatrix.
// A block owns 8 rows x 32 columns of input pixels and up to 64 input
// channels (MT m-tiles of 16), warp w row w: 16 MT x 32 sums, per step MT
// A and 2 B loads (ldmatrix.x4) for 4 MT products.  Output channels come in
// chunks of 8 (the least staging per block, so four blocks share an SM),
// each staged once.

constexpr int kDxBfRows = 8;            // tile rows: one per warp

constexpr int kDxBfCo = 8;   // output channels per staged chunk
// V's stride per output channel, and A's per input channel (a chunk's 72
// pairs in k16 steps), each equal to 8 modulo 64 elements
constexpr int kDxBfCs = msau::ldsm_stride((kDxBfRows + 1) * kDwVPitch);
constexpr int kDxBfKp = msau::ldsm_stride((9 * kDxBfCo + 15) / 16 * 16);

size_t dx_bf16_bytes(int mt) { return (size_t)(6 * kDxBfCo * kDxBfCs + mt * 16 * kDxBfKp) * 2; }

template <int MT>
__global__ void __launch_bounds__(kDxBfRows * 32)
deconv2_dx_bf16_kernel(const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ w,
                       __nv_bfloat16* __restrict__ dx, Dims d, int passes, int vec_g,
                       int vec_w, int vec_x) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int cs = kDxBfCs, kp = kDxBfKp;
  constexpr int vs = kDxBfCo * cs;   // one (ky % 2, kx) variant of V
  bf16* vv = reinterpret_cast<bf16*>(smem_raw);   // [ky % 2][kx][co][rows][kDwVPitch]
  bf16* ws = vv + 6 * vs;                         // [16 MT][kp]
  const int img = blockIdx.z / passes, ci0 = (blockIdx.z % passes) * 16 * MT;
  const int m0 = blockIdx.y * kDxBfRows, j0 = blockIdx.x * kDwTc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, mi = lane / 8, lr = lane % 8;
  const int64_t gplane = (int64_t)d.ho * d.wo;
  const bf16 zero = __float2bfloat16(0.f);
  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int co0 = 0; co0 < d.cout; co0 += kDxBfCo) {
    const int K = min(kDxBfCo, d.cout - co0) * 9, S = (K + 15) / 16;
    __syncthreads();   // the previous chunk's readers are done
    // A: input channel ci's run w[ci0 + ci][co0 ..][tap], K pairs, then
    // zeros to the step's end (16-byte cp.async where the run allows)
    for (int r = threadIdx.x; r < 16 * MT * 2 * S; r += blockDim.x) {
      const int ci = r / (2 * S), e0 = (r % (2 * S)) * 8, ch = ci0 + ci;
      bf16* dst = ws + ci * kp + e0;
      const bf16* src = w + ((int64_t)min(ch, d.cin - 1) * d.cout + co0) * 9 + e0;
      if (ch >= d.cin || e0 >= K) {
        msau::cp_async16(dst, w, false);
      } else if (vec_w && e0 + 8 <= K) {
        msau::cp_async16(dst, src);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = e0 + e < K ? src[e] : zero;
      }
    }
    msau::cp_async_commit();
    // g rows 2 m0 - 1 + rr (rr < 2 rows + 1), one per thread: columns
    // 2 j0 .. 2 j0 + 63 as 8 groups of 8 (all loaded before any is stored)
    // and column 2 j0 - 1
    constexpr int kr = 2 * kDxBfRows + 1;
    for (int gi = threadIdx.x; gi < kDxBfCo * kr; gi += blockDim.x) {
      const int rr = gi % kr, co = gi / kr;
      const int gy = 2 * m0 - 1 + rr;
      const bool ok = gy >= 0 && gy < d.ho && co0 + co < d.cout;
      const bf16* src = g + ((int64_t)img * d.cout + co0 + co) * gplane + (int64_t)gy * d.wo;
      constexpr int kq = kDwTc / 4;
      uint4 v[kq];
#pragma unroll
      for (int q = 0; q < kq; ++q) {
        const int gx = 2 * j0 + 8 * q;
        if (ok && vec_g && gx + 8 <= d.wo) {
          v[q] = *reinterpret_cast<const uint4*>(src + gx);
        } else {
          alignas(16) bf16 e8[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) e8[e] = ok && gx + e < d.wo ? src[gx + e] : zero;
          v[q] = *reinterpret_cast<const uint4*>(e8);
        }
      }
      bf16* row = vv + ((rr & 1) * 3 * kDxBfCo + co) * cs + (rr >> 1) * kDwVPitch;
      row[0] = ok && j0 > 0 ? src[2 * j0 - 1] : zero;   // column 2 j0 - 1: kx 0 at j 0
#pragma unroll
      for (int q = 0; q < kq; ++q) {
        // element e: even e is kx 1 at j = 4q + e / 2; odd e is kx 2 at
        // 4q + (e - 1) / 2 and kx 0 at 4q + (e + 1) / 2
        const unsigned u[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
        *reinterpret_cast<uint2*>(row + vs + 4 * q) =
            make_uint2(__byte_perm(u[0], u[1], 0x5410), __byte_perm(u[2], u[3], 0x5410));
        *reinterpret_cast<uint2*>(row + 2 * vs + 4 * q) =
            make_uint2(__byte_perm(u[0], u[1], 0x7632), __byte_perm(u[2], u[3], 0x7632));
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (4 * q + k + 1 < kDwTc)
            row[4 * q + k + 1] = __ushort_as_bfloat16((unsigned short)(u[k] >> 16));
      }
    }
    msau::cp_async_wait<0>();
    __syncthreads();
    for (int s = 0; s < S; ++s) {
      // lane l gives row l % 8 of matrix l / 8: n-tile 2p + mi / 2, pair k
      // = 16 s + 8 (mi % 2) + l % 8; a pair past K reads any finite row
      // (its weights are zero)
      int k = 16 * s + 8 * (mi & 1) + lr;
      if (k >= K) k = 0;
      const int cl = k / 9, tap = k - 9 * cl, ky = tap / 3, kx = tap % 3;
      const bf16* bp = vv + ((ky & 1) * 3 + kx) * vs + cl * cs +
                       (warp + (ky >> 1)) * kDwVPitch + (mi >> 1) * 8;
      unsigned bfr[4][2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        unsigned r4[4];
        msau::ldsm_x4_trans(r4, bp + 16 * p);
        bfr[2 * p][0] = r4[0];
        bfr[2 * p][1] = r4[1];
        bfr[2 * p + 1][0] = r4[2];
        bfr[2 * p + 1][1] = r4[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        unsigned afr[4];
        msau::ldsm_x4(afr, ws + (mt * 16 + (mi & 1) * 8 + lr) * kp + 16 * s + (mi >> 1) * 8);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) msau::mma_bf16(acc[mt][nt], afr, bfr[nt]);
      }
    }
  }
  // acc[mt][nt]: rows (input channels) lane / 4 and + 8, columns (pixels)
  // 2 (lane % 4) and + 1 of n-tile nt
  const int m = m0 + warp;
  if (m >= d.h) return;
  const int64_t xplane = (int64_t)d.h * d.w;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int ch = ci0 + mt * 16 + hf * 8 + lane / 4;
      if (ch >= d.cin) continue;
      bf16* row = dx + ((int64_t)img * d.cin + ch) * xplane + (int64_t)m * d.w;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int j = j0 + nt * 8 + 2 * (lane % 4);
        const float v0 = acc[mt][nt][2 * hf], v1 = acc[mt][nt][2 * hf + 1];
        if (vec_x && j + 2 <= d.w) {
          *reinterpret_cast<__nv_bfloat162*>(row + j) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (j < d.w) row[j] = __float2bfloat16(v0);
          if (j + 1 < d.w) row[j + 1] = __float2bfloat16(v1);
        }
      }
    }
}

int launch_dx_bf16(const __nv_bfloat16* g, const __nv_bfloat16* w, __nv_bfloat16* dx, int n,
                   const Dims& d, cudaStream_t stream) {
  // (chunks of 8 output channels: at 64 -> 32 channels to 128^2, batch 16,
  // 0.0282 ms against 0.0306 with chunks of 16, on an H100)
  int mt = (std::min(d.cin, 64) + 15) / 16;   // m-tiles of 16 input channels
  if (mt == 3) mt = 4;
  const size_t smem = dx_bf16_bytes(mt);
  const int passes = (d.cin + 16 * mt - 1) / (16 * mt);
  if ((int64_t)n * passes > 65535) return (int)cudaErrorInvalidValue;
  const int vec_g = d.wo % 8 == 0 && (uintptr_t)g % 16 == 0;
  // every run w[ci][co0 ..] starts on a 16-byte boundary
  const int vec_w = d.cout % 8 == 0 && (uintptr_t)w % 16 == 0;
  const int vec_x = d.w % 2 == 0 && (uintptr_t)dx % 4 == 0;
  const dim3 grid((d.w + kDwTc - 1) / kDwTc, (d.h + kDxBfRows - 1) / kDxBfRows, n * passes);
  cudaError_t err;
#define MSAU_DX(MT)                                                                      \
  err = msau::allow_smem(deconv2_dx_bf16_kernel<MT>, smem);                              \
  if (err != cudaSuccess) return (int)err;                                               \
  deconv2_dx_bf16_kernel<MT><<<grid, kDxBfRows * 32, smem, stream>>>(g, w, dx, d, passes, \
                                                                     vec_g, vec_w, vec_x);
  if (mt == 1) {
    MSAU_DX(1)
  } else if (mt == 2) {
    MSAU_DX(2)
  } else {
    MSAU_DX(4)
  }
#undef MSAU_DX
  return (int)cudaGetLastError();
}

// partial[0..nblocks)[j] added in row order.  Loads go out kSumBatch rows
// at a time (independent, so in flight together): the same sum, bit for
// bit, as one row after the other, without a load latency per row.
constexpr int kSumBatch = 24;

__device__ __forceinline__ float sum_rows(const float* __restrict__ part, int nblocks,
                                          int64_t stride, int64_t j) {
  float s = 0.f;
  int b = 0;
  for (; b + kSumBatch <= nblocks; b += kSumBatch) {
    float v[kSumBatch];
#pragma unroll
    for (int k = 0; k < kSumBatch; ++k) v[k] = part[(int64_t)(b + k) * stride + j];
#pragma unroll
    for (int k = 0; k < kSumBatch; ++k) s += v[k];
  }
  for (; b < nblocks; ++b) s += part[(int64_t)b * stride + j];
  return s;
}

// dw[ci][co][tap] = the blocks' tile-major partial rows added in block
// order (sum_rows); f32 rows hold output tiles of 4 input x 4
// output channels x one tap row (48 sums, ot = cog + cog_n (ky + 3 cig)),
// bf16 rows (16 input x 8 output channel pair, tap) tiles of 128.
__global__ void deconv2_dw_sum_kernel(const float* __restrict__ part, int nblocks,
                                      int64_t stride, Dims d, int is_bf16,
                                      float* __restrict__ dw) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= stride) return;
  int ci, co, tap;
  if (is_bf16) {
    const int tile = (int)(j / (9 * 128)), r = (int)(j % (9 * 128));
    const int cot_n = (d.cout + 7) / 8, q = r % 128;
    ci = tile / cot_n * 16 + q / 8;
    co = tile % cot_n * 8 + q % 8;
    tap = r / 128;
  } else {
    const int ot = (int)(j / 48), r = (int)(j % 48), cog_n = (d.cout + 3) / 4;
    ci = ot / (3 * cog_n) * 4 + r / 12;
    co = ot % cog_n * 4 + (r / 3) % 4;
    tap = (ot / cog_n) % 3 * 3 + r % 3;
  }
  if (ci < d.cin && co < d.cout)
    dw[((int64_t)ci * d.gc + co) * 9 + tap] = sum_rows(part, nblocks, stride, j);
}

int sum_dw(const float* partial, int blocks, int64_t stride, const Dims& d, int is_bf16,
           float* dw, cudaStream_t stream) {
  deconv2_dw_sum_kernel<<<(unsigned)((stride + 63) / 64), 64, 0, stream>>>(
      partial, blocks, stride, d, is_bf16, dw);
  return (int)cudaGetLastError();
}

// ---- dw, any odd K -----------------------------------------------------------

constexpr int kSlices = 2;   // pixel slices per (input channel, tap) pair

template <typename T>
__global__ void __launch_bounds__(kThreads)
deconv2_dw_general_kernel(const T* __restrict__ x, const T* __restrict__ g, Dims d,
                          int tiles_x, int tiles_y, int n_tiles,
                          float* __restrict__ partial) {
  extern __shared__ __align__(16) float smem[];
  constexpr int P = kQx * kTh;
  const int taps = d.k * d.k, gw = d.gw(), pairs = kG * taps;
  float* gs = smem;                          // [gh][gw][kG]
  float* xs = gs + d.gh() * gw * kG;         // [kG][P]
  float* red = xs + kG * P;                  // [kSlices][pairs][kG]
  const int64_t stride = (int64_t)d.cin * d.cout * taps;
  float* __restrict__ part = partial + (int64_t)blockIdx.x * stride;
  const int64_t plane = (int64_t)d.h * d.w;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    const int img = tile / (tiles_x * tiles_y), t2 = tile % (tiles_x * tiles_y);
    const int j0 = (t2 % tiles_x) * kQx, m0 = (t2 / tiles_x) * kTh;
    for (int ci0 = 0; ci0 < d.cin; ci0 += kG) {
      const int ccin = min(kG, d.cin - ci0);
      for (int co0 = 0; co0 < d.cout; co0 += kG) {
        const int ccout = min(kG, d.cout - co0);
        __syncthreads();   // the previous group's readers are done
        stage_g<T>(g, d, gs, img, co0, ccout, m0, j0);
        for (int i = threadIdx.x; i < kG * P; i += kThreads) {
          const int ci = i / P, pp = i % P;
          const int m = m0 + pp / kQx, j = j0 + pp % kQx;
          xs[i] = (ci < ccin && m < d.h && j < d.w)
                      ? to_f32(x[((int64_t)img * d.cin + ci0 + ci) * plane +
                                 (int64_t)m * d.w + j])
                      : 0.f;
        }
        __syncthreads();
        for (int it = threadIdx.x; it < pairs * kSlices; it += kThreads) {
          const int pair = it % pairs, sl = it / pairs;
          const int ci = pair / taps, tap = pair % taps;
          const int ky = tap / d.k, kx = tap % d.k;
          float acc[kG];
#pragma unroll
          for (int c = 0; c < kG; ++c) acc[c] = 0.f;
          for (int pp = sl * P / kSlices; pp < (sl + 1) * P / kSlices; ++pp) {
            const float xv = xs[ci * P + pp];
            float gv[kG];
            load_row(gv, gs + ((2 * (pp / kQx) + ky) * gw + 2 * (pp % kQx) + kx) * kG);
#pragma unroll
            for (int c = 0; c < kG; ++c) acc[c] = fmaf(xv, gv[c], acc[c]);
          }
#pragma unroll
          for (int c = 0; c < kG; ++c) red[it * kG + c] = acc[c];
        }
        __syncthreads();
        for (int jj = threadIdx.x; jj < pairs * kG; jj += kThreads) {
          const int pair = jj / kG, c = jj % kG;
          const int ci = pair / taps, tap = pair % taps;
          if (ci >= ccin || c >= ccout) continue;
          float v = 0.f;
          for (int sl = 0; sl < kSlices; ++sl) v += red[(sl * pairs + pair) * kG + c];
          float* dst = part + ((int64_t)(ci0 + ci) * d.cout + co0 + c) * taps + tap;
          *dst = first ? v : *dst + v;
        }
      }
    }
  }
}

template <typename T>
int launch_dw_general(const void* x, const void* g, void* partial, void* dw, int n,
                      const Dims& d, cudaStream_t stream) {
  constexpr int P = kQx * kTh;
  const int taps = d.k * d.k;
  const size_t smem = (size_t)(d.gh() * d.gw() * kG + kG * P +
                               kSlices * kG * taps * kG) * sizeof(float);
  cudaError_t err = msau::allow_smem(deconv2_dw_general_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (d.w + kQx - 1) / kQx, tiles_y = (d.h + kTh - 1) / kTh;
  const int64_t n_tiles = (int64_t)n * tiles_x * tiles_y;
  if (n_tiles > (1 << 30)) return (int)cudaErrorInvalidValue;
  const int blocks = (int)std::min<int64_t>(n_tiles, msau::kPartialBlocks);
  deconv2_dw_general_kernel<T><<<blocks, kThreads, smem, stream>>>(
      (const T*)x, (const T*)g, d, tiles_x, tiles_y, (int)n_tiles, (float*)partial);
  const int code = (int)cudaGetLastError();
  if (code != 0) return code;
  return msau::sum_partials((const float*)partial, blocks, (int64_t)d.cin * d.cout * taps,
                            (float*)dw, stream);
}

template <typename T>
int launch_dx(const void* g, const void* w, void* dx, int n, const Dims& d,
              cudaStream_t stream) {
  const int groups = (d.cin + kG - 1) / kG;
  if ((int64_t)n * groups > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(d.gh() * d.gw() * kG + kG * d.k * d.k * kG) * sizeof(float);
  cudaError_t err = msau::allow_smem(deconv2_dx_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((d.w + kQx - 1) / kQx, (d.h + kTh - 1) / kTh, n * groups);
  deconv2_dx_kernel<T><<<grid, kThreads, smem, stream>>>((const T*)g, (const T*)w,
                                                          (T*)dx, d, groups);
  return (int)cudaGetLastError();
}

int launch_dx_f32(const float* g, const float* w, float* dx, int n, const Dims& d,
                  cudaStream_t stream) {
  // 16 warps where a tile holds 32 input channels or more; with fewer the
  // tile is 64 or 128 rows tall, and two blocks of 8 warps hide each
  // other's staging better (at 16 -> 8 channels to 512^2: 0.119 against
  // 0.125 ms on an H100)
  const DxGeom geo = dx_geom(d.cin, d.cout, std::min(d.cin, 64) > 16 ? 16 : 8);
  const size_t smem = 2 * (size_t)geo.buf_floats() * 4;
  cudaError_t err = msau::allow_smem(deconv2_dx3_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int passes = (d.cin + 63) / 64;
  if ((int64_t)n * passes > 65535) return (int)cudaErrorInvalidValue;
  // g rows by 16-byte copies; dx rows by float4 stores
  const int vec_g = d.wo % 4 == 0 && (uintptr_t)g % 16 == 0;
  const int vec_x = d.w % 4 == 0 && (uintptr_t)dx % 16 == 0;
  const dim3 grid((d.w + kDxTc - 1) / kDxTc, (d.h + geo.tr - 1) / geo.tr, n * passes);
  deconv2_dx3_kernel<<<grid, geo.nw * 32, smem, stream>>>(g, w, dx, d, geo, passes, vec_g,
                                                            vec_x);
  return (int)cudaGetLastError();
}

int launch_dw_f32(const float* x, const float* g, float* partial, float* dw, int n,
                  const Dims& d, cudaStream_t stream) {
  const int tr = dw_tile_rows([&](int t) { return DwF32Geom(d, t).bytes(); });
  const DwF32Geom geo(d, tr);
  const size_t smem = geo.bytes();
  cudaError_t err = msau::allow_smem(deconv2_dw_f32_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (d.w + kDwTc - 1) / kDwTc, tiles_y = (d.h + tr - 1) / tr;
  const int64_t n_tiles = (int64_t)n * tiles_x * tiles_y;
  if (n_tiles > (1 << 30)) return (int)cudaErrorInvalidValue;
  const int blocks = dw_blocks(n_tiles, tr);
  // pixel slices per output tile: about 256 threads in all, 1 to 32
  const int ots = ((d.cin + 3) / 4) * ((d.cout + 3) / 4) * 3;
  int ps = 1;
  while (ps < 32 && ots * ps * 2 <= 256) ps *= 2;
  const int threads = (int)std::min<int64_t>(512, ((int64_t)ots * ps + 31) / 32 * 32);
  const int vec_x = d.w % 4 == 0 && (uintptr_t)x % 16 == 0;
  const int vec_g = d.wo % 4 == 0 && (uintptr_t)g % 16 == 0;
  deconv2_dw_f32_kernel<<<blocks, threads, smem, stream>>>(
      x, g, d, geo, tiles_x, tiles_y, (int)n_tiles, ps, vec_x, vec_g, partial);
  const int code = (int)cudaGetLastError();
  if (code != 0) return code;
  return sum_dw(partial, blocks, (int64_t)ots * 48, d, 0, dw, stream);
}

int launch_dw_bf16(const __nv_bfloat16* x, const __nv_bfloat16* g, float* partial, float* dw,
                   int n, const Dims& d, cudaStream_t stream) {
  const int tr = dw_tile_rows([&](int t) { return DwBfGeom(d, t).bytes(); });
  const DwBfGeom geo(d, tr);
  const size_t smem = geo.bytes();
  const int tiles_x = (d.w + kDwTc - 1) / kDwTc, tiles_y = (d.h + tr - 1) / tr;
  const int64_t n_tiles = (int64_t)n * tiles_x * tiles_y;
  if (n_tiles > (1 << 30)) return (int)cudaErrorInvalidValue;
  const int blocks = dw_blocks(n_tiles, tr);
  // (16 input, 8 output channel) pairs: one per warp, the 8 warps split
  // over the tile's steps where there are fewer pairs than warps
  const int pairs = ((d.cin + 15) / 16) * ((d.cout + 7) / 8);
  int ks = 1;
  while (ks < kDwWarps && pairs * ks * 2 <= kDwWarps) ks *= 2;
  const int vec_x = d.w % 8 == 0 && (uintptr_t)x % 16 == 0;
  const int vec_g = d.wo % 8 == 0 && (uintptr_t)g % 16 == 0;
  cudaError_t err;
#define MSAU_DW(PPW)                                                                      \
  err = msau::allow_smem(deconv2_dw_bf16_kernel<PPW>, smem);                              \
  if (err != cudaSuccess) return (int)err;                                                \
  deconv2_dw_bf16_kernel<PPW><<<blocks, kDwWarps * 32, smem, stream>>>(                   \
      x, g, d, geo, tiles_x, tiles_y, (int)n_tiles, ks, vec_x, vec_g, partial);
  if (pairs > kDwWarps) {
    MSAU_DW(2)
  } else {
    MSAU_DW(1)
  }
#undef MSAU_DW
  const int code = (int)cudaGetLastError();
  if (code != 0) return code;
  return sum_dw(partial, blocks, (int64_t)pairs * 9 * 128, d, 1, dw, stream);
}

// Output channels per dw launch: all of them where the staging of a one-row
// tile for every channel fits the block's shared memory, else the most (a
// multiple of 8) that fits; 0 where none does.  The chunks' launches and
// sums run one after the other on the stream, each on its own channels of
// g and dw (Dims::gc keeps the strides), reusing the partial scratch.
template <typename Geom, typename Launch>
int dw_by_chunks(const Dims& d, Launch launch) {
  int coc = d.cout;
  for (Dims c = d; coc > 0; coc = (coc - 1) / 8 * 8) {
    c.cout = coc;
    if (dw_tile_rows([&](int t) { return Geom(c, t).bytes(); }) > 0) break;
  }
  if (coc == 0) return (int)cudaErrorInvalidValue;
  for (int co0 = 0; co0 < d.cout; co0 += coc) {
    Dims c = d;
    c.cout = std::min(coc, d.cout - co0);
    const int code = launch(c, co0);
    if (code != 0) return code;
  }
  return 0;
}

bool bad_dims(int n, const Dims& d) {
  return n < 0 || d.cin <= 0 || d.h < 0 || d.w < 0 || d.cout <= 0 || d.k <= 0 ||
         d.k % 2 == 0 || (d.ho != 2 * d.h - 1 && d.ho != 2 * d.h) ||
         (d.wo != 2 * d.w - 1 && d.wo != 2 * d.w);
}

}  // namespace

// g: [n, cout, ho, wo]; w: [cin, cout, k, k] (odd k), both in the
// activation dtype; dx: [n, cin, h, w] in that dtype.
extern "C" int msau_flat_deconv2_dx(const void* g, const void* w, void* dx, int n,
                                    int cin, int h, int wd, int cout, int k, int ho,
                                    int wo, int is_bf16, void* stream) {
  const Dims d{cin, h, wd, cout, k, ho, wo, cout};
  if (bad_dims(n, d)) return (int)cudaErrorInvalidValue;
  if (n == 0 || h == 0 || wd == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (k == 3)
    return is_bf16 ? launch_dx_bf16((const __nv_bfloat16*)g, (const __nv_bfloat16*)w,
                                    (__nv_bfloat16*)dx, n, d, s)
                   : launch_dx_f32((const float*)g, (const float*)w, (float*)dx, n, d, s);
  return is_bf16 ? launch_dx<__nv_bfloat16>(g, w, dx, n, d, s)
                 : launch_dx<float>(g, w, dx, n, d, s);
}

// x: [n, cin, h, w] and g: [n, cout, ho, wo] in the activation dtype;
// partial: f32 scratch of kPartialBlocks * ceil(cin / 16) * 16 *
// ceil(cout / 8) * 8 * k * k floats (the blocks' partial rows: with the
// 3x3 kernel tile-major and of one channel chunk at a time); dw: f32
// [cin, cout, k, k] (odd k).
extern "C" int msau_flat_deconv2_dw(const void* x, const void* g, void* partial,
                                    void* dw, int n, int cin, int h, int wd, int cout,
                                    int k, int ho, int wo, int is_bf16, void* stream) {
  const Dims d{cin, h, wd, cout, k, ho, wo, cout};
  if (bad_dims(n, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0 || h == 0 || wd == 0)
    return (int)cudaMemsetAsync(dw, 0, (size_t)cin * cout * k * k * sizeof(float), s);
  if (k != 3)
    return is_bf16 ? launch_dw_general<__nv_bfloat16>(x, g, partial, dw, n, d, s)
                   : launch_dw_general<float>(x, g, partial, dw, n, d, s);
  const int64_t gplane = (int64_t)ho * wo;
  if (is_bf16)
    return dw_by_chunks<DwBfGeom>(d, [&](const Dims& c, int co0) {
      return launch_dw_bf16((const __nv_bfloat16*)x, (const __nv_bfloat16*)g + co0 * gplane,
                            (float*)partial, (float*)dw + co0 * 9, n, c, s);
    });
  return dw_by_chunks<DwF32Geom>(d, [&](const Dims& c, int co0) {
    return launch_dw_f32((const float*)x, (const float*)g + co0 * gplane, (float*)partial,
                         (float*)dw + co0 * 9, n, c, s);
  });
}
