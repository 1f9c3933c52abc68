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
// dx (any odd K): what bounds it on the H100 is FP32 arithmetic, K*K*cin*cout
// FMAs per input pixel.  A block owns 32 x 8 input pixels of one image and
// 8 input channels (2 rows x 8 channels of accumulators per thread); it
// stages the g rows its pixels read (2*8 + K - 2 rows x 2*32 + K - 2
// columns) 8 output channels at a time as [row][col][co], beside the
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
