// Stride-2 transposed conv with an odd K x K kernel to an exact target
// [Ho, Wo], Ho in {2H-1, 2H}: torch's ConvTranspose2d(stride 2, padding
// K/2, output_padding Ho - (2H-1)) plus an f32 bias, which is the
// zero-insertion of x onto the target canvas followed by a SAME conv with
// the spatially flipped kernel.
//
// Replaces the TPU kernels msau_tpu/ops/flatconv.py:_dc_fwd_kernel
// (launcher _flat_deconv2_prim, the fused deconv) and _ups_fwd_kernel
// (launcher flat_upsample2, the zero-insert that the JAX package follows
// with a flat conv where the fused deconv's lane-alignment gate fails).
// Both compute this function; the TPU builds the dilated rows in VMEM with
// a 0/1 insert matrix on the MXU.  Here the zero-inserted canvas never
// exists.  With the 3x3 kernel (every configuration's filter_size), output
// pixel (2m + a, 2j + b) of parity class (a, b) takes only the taps of that
// class: 1, 2, 2 and 4 taps, each reading input (m + dr, j + dc) with dr,
// dc in {0, 1}.  So each class is a stride-1 implicit GEMM over the input
// grid: M = the class's pixels, N = cout, K = cin x its taps; 9 * cin *
// cout FMAs per input pixel in all.  Any other odd K takes the general
// kernel at the end of the file (the same parity split, taps walked at run
// time, FP32 pipes in both dtypes).
//
// What bounds the 3x3 kernels on the H100, per dtype: in f32, the FP32
// pipes (67 TFLOP/s; TF32 would miss the 1e-5 bound); in bf16, device
// memory, once the tensor cores do the arithmetic (at 16 -> 8 channels to
// 512^2, 6 bytes moved per 288 FMAs).  Both designs:
//   - one block owns every output channel of its pixel tile (a loop over
//     passes of 32 channels beyond that), so x is read once;
//   - x is staged in 16-byte cp.async copies (zero-filled off the image),
//     double buffered over input-channel chunks, so the next chunk loads
//     while this one is multiplied;
//   - tiles are sized per launch so that the batch-1 serve instances give
//     the card at least two blocks per SM where the image allows it;
//   - a thread writes the two columns b = 0, 1 of an output row as one
//     store (8 bytes in f32, 8 bytes for two quads in bf16).
// f32: a thread owns QR vertically adjacent quads (all four classes) x 8
// output channels, 32 QR accumulators; per staged input channel it reads
// 2 (QR + 1) inputs and 9 x 8 weights (16-byte broadcast loads) for 72 QR
// FMAs.  bf16: mma.sync m16n8k16 (bf16 in, f32 accumulate) with
// M = output channels (the weights, ldmatrix from a [tap][co][ci] copy) and
// N = 8 quads of one quad row (x, ldmatrix .trans from [ci][row][col]).
// The weights arrive with the chunk's x, by cp.async, as they lie in
// torch's [ci][co][tap], and are transposed in shared memory beside the
// copy of the staged tile shifted by one column that the column shift
// dc = 1 reads (ldmatrix rows must be 16-byte aligned).  Each warp owns one
// quad row of NT x 8 quads and every class: per 16 input channels it loads
// B for the 4 shifts once and issues 9 x MT x NT products.
// The weight is torch's [cin, cout, K, K]; bias f32 [cout].

#include <stdint.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using msau::cp_async16;
using msau::cp_async4;
using msau::load_row;

constexpr int kTaps = 9;
// The 3x3 kernel's taps (padding 1) by parity class: output row 2m + a
// takes tap ky from input row m + (a + 1 - ky) / 2, and so for columns.
struct Tap {
  int cls, tap, dr, dc;   // class a * 2 + b, tap ky * 3 + kx, input shift
};
__host__ __device__ constexpr Tap tap_of(int t) {
  return t == 0   ? Tap{0, 4, 0, 0}    // (0, 0): ky 1, kx 1
         : t == 1 ? Tap{1, 3, 0, 1}    // (0, 1): kx 0
         : t == 2 ? Tap{1, 5, 0, 0}    //         kx 2
         : t == 3 ? Tap{2, 1, 1, 0}    // (1, 0): ky 0
         : t == 4 ? Tap{2, 7, 0, 0}    //         ky 2
         : t == 5 ? Tap{3, 0, 1, 1}    // (1, 1): ky 0, kx 0
         : t == 6 ? Tap{3, 2, 1, 0}    //         ky 0, kx 2
         : t == 7 ? Tap{3, 6, 0, 1}    //         ky 2, kx 0
                  : Tap{3, 8, 0, 0};   //         ky 2, kx 2
}

// ---- f32: FP32 pipes ------------------------------------------------------

constexpr int kF32Threads = 128;
constexpr int kF32Ci = 8;      // input channels per staged chunk
constexpr int kF32Cols = 32;   // quad columns per block: one per lane
constexpr int kF32Pitch = 40;  // staged input columns (33 read), 16-byte groups
constexpr int kF32Co = 32;     // output channels per pass: 4 groups of 8

__host__ __device__ inline int f32_xbuf(int rows) { return kF32Ci * (rows + 1) * kF32Pitch; }
constexpr int kF32Wbuf = kF32Ci * kTaps * kF32Co;

// gp: groups of 8 output channels per pass (1, 2 or 4); the 4 warps are gp
// groups x 4 / gp bands of QR quad rows.
template <int QR>
__global__ void __launch_bounds__(kF32Threads)
deconv2_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ y, int cin, int h,
                   int wi, int cout, int ho, int wo, int gp, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int rows = (4 / gp) * QR, xr = rows + 1, xbuf = f32_xbuf(rows);
  float* xs = smem;              // [2][kF32Ci][xr][kF32Pitch]
  float* ws = smem + 2 * xbuf;   // [2][kF32Ci][tap][kF32Co]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cg = warp % gp, band = warp / gp;
  const int img = blockIdx.z, m0 = blockIdx.y * rows, j0 = blockIdx.x * kF32Cols;
  const int64_t plane = (int64_t)h * wi;
  const int chunks = (cin + kF32Ci - 1) / kF32Ci, co_pass = 8 * gp;
  constexpr int groups = kF32Pitch / 4;

  for (int co0 = 0; co0 < cout; co0 += co_pass) {
    auto stage = [&](int c, int buf) {
      const int c0 = c * kF32Ci;
      float* xd = xs + buf * xbuf;
      for (int i = threadIdx.x; i < kF32Ci * xr * groups; i += kF32Threads) {
        const int q = i % groups, r = (i / groups) % xr, ci = i / (groups * xr);
        const int gy = m0 + r, gx = j0 + 4 * q, ch = c0 + ci;
        const bool row_ok = ch < cin && gy < h;
        const float* src =
            x + ((int64_t)img * cin + (row_ok ? ch : 0)) * plane + (int64_t)(row_ok ? gy : 0) * wi;
        float* dst = xd + (ci * xr + r) * kF32Pitch + 4 * q;
        if (!row_ok || gx >= wi) {
          cp_async16(dst, x, false);
        } else if (vec && gx + 4 <= wi) {
          cp_async16(dst, src + gx);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) cp_async4(dst + e, src + min(gx + e, wi - 1), gx + e < wi);
        }
      }
      float* wd = ws + buf * kF32Wbuf;
      for (int i = threadIdx.x; i < kF32Wbuf; i += kF32Threads) {
        const int co = i % kF32Co, tap = (i / kF32Co) % kTaps, ci = i / (kF32Co * kTaps);
        const int ch = c0 + ci, oc = co0 + co;
        const bool ok = co < co_pass && ch < cin && oc < cout;
        cp_async4(wd + i, ok ? w + ((int64_t)ch * cout + oc) * kTaps + tap : w, ok);
      }
      msau::cp_async_commit();
    };

    float acc[QR][2][2][8];
#pragma unroll
    for (int q = 0; q < QR; ++q)
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[q][a][b][c] = 0.f;

    stage(0, 0);
    for (int c = 0; c < chunks; ++c) {
      if (c + 1 < chunks) {
        stage(c + 1, (c + 1) & 1);
        msau::cp_async_wait<1>();
      } else {
        msau::cp_async_wait<0>();
      }
      __syncthreads();
      const float* xc = xs + (c & 1) * xbuf + band * QR * kF32Pitch + lane;
      const float* wc = ws + (c & 1) * kF32Wbuf + cg * 8;
#pragma unroll 2
      for (int ci = 0; ci < kF32Ci; ++ci) {
        float xv[QR + 1][2];
#pragma unroll
        for (int r = 0; r <= QR; ++r) {
          xv[r][0] = xc[(ci * xr + r) * kF32Pitch];
          xv[r][1] = xc[(ci * xr + r) * kF32Pitch + 1];
        }
#pragma unroll
        for (int t = 0; t < kTaps; ++t) {
          const Tap tp = tap_of(t);
          const int cls = tp.cls, dr = tp.dr, dc = tp.dc;
          float wv[8];
          load_row(wv, wc + (ci * kTaps + tp.tap) * kF32Co);
#pragma unroll
          for (int q = 0; q < QR; ++q)
#pragma unroll
            for (int o = 0; o < 8; ++o)
              acc[q][cls >> 1][cls & 1][o] =
                  fmaf(xv[q + dr][dc], wv[o], acc[q][cls >> 1][cls & 1][o]);
        }
      }
      __syncthreads();   // this buffer is staged again two chunks on
    }

    const int j = j0 + lane, ox = 2 * j;
    if (ox < wo) {
      const bool pair = ox + 1 < wo, vec2 = (wo % 2) == 0;
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        const int oc = co0 + cg * 8 + o;
        if (oc >= cout) break;
        const float bc = bias[oc];
        float* yo = y + ((int64_t)img * cout + oc) * ho * wo + ox;
#pragma unroll
        for (int q = 0; q < QR; ++q)
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            const int oy = 2 * (m0 + band * QR + q) + a;
            if (oy >= ho) continue;
            float* dst = yo + (int64_t)oy * wo;
            const float v0 = acc[q][a][0][o] + bc, v1 = acc[q][a][1][o] + bc;
            if (pair && vec2) {
              *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
            } else {
              dst[0] = v0;
              if (pair) dst[1] = v1;
            }
          }
      }
    }
  }
}

// ---- bf16: mma.sync on the tensor cores ----------------------------------

constexpr int kBfCi = 16;   // input channels per staged chunk: one k16 step
constexpr int kBfCo = 32;   // output channels per pass: MT <= 2 tiles of 16
constexpr int kBfWPitch = 24;   // [tap][co][ci] rows: 16 ci + 8 (48 bytes)
// one tap's rows, plus 16 bytes so the taps' rows fall in distinct bank
// groups when a warp writes them
constexpr int kBfWTap = kBfCo * kBfWPitch + 8;
// a staged weight row: w[ci][co0 ..][tap] from the 16-byte boundary at or
// before its first element, so up to 7 + 32 * 9 elements in 37 copies
constexpr int kBfRawVecs = (7 + kBfCo * kTaps + 7) / 8;
constexpr int kBfRawPitch = 8 * kBfRawVecs;

struct BfGeom {
  int xr, xc, xs, x1s;   // staged rows, columns, ci strides (x, shifted x)
  __host__ __device__ constexpr BfGeom(int wb, int nt)
      : xr(wb + 1), xc(8 * nt + 8), xs(msau::ldsm_stride((wb + 1) * (8 * nt + 8))),
        x1s(msau::ldsm_stride((wb + 1) * 8 * nt)) {}
  __host__ __device__ constexpr int xbuf() const { return kBfCi * xs; }
  __host__ __device__ constexpr int rawbuf() const { return kBfCi * kBfRawPitch; }
  // elements: two x buffers, the shifted copy, two staged weight buffers,
  // the transposed weights
  __host__ __device__ constexpr int elems() const {
    return 2 * xbuf() + kBfCi * x1s + 2 * rawbuf() + kTaps * kBfWTap;
  }
};

// A block is WB warps: warp i owns quad row m0 + i and quad columns
// [j0, j0 + 8 NT); MT m-tiles of 16 output channels per pass.  The shape is
// compile-time, so the staging loops' index arithmetic is.  w must be
// 16-byte aligned.
template <int MT, int NT, int WB>
__global__ void __launch_bounds__(WB * 32)
deconv2_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const float* __restrict__ bias, bf16* __restrict__ y, int cin, int h,
                    int wi, int cout, int ho, int wo, int bands, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  constexpr int wb = WB;
  constexpr BfGeom geo(WB, NT);
  bf16* xs = smem;                                  // [2][kBfCi][xr][xc]
  bf16* x1 = xs + 2 * geo.xbuf();                   // [kBfCi][xr][8 NT]
  bf16* wr = x1 + kBfCi * geo.x1s;                  // [2][kBfCi][kBfRawPitch]
  bf16* wt = wr + 2 * geo.rawbuf();                 // [tap][kBfCo][kBfWPitch] + pad
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int img = blockIdx.z, m0 = blockIdx.y * wb * bands, j0 = blockIdx.x * 8 * NT;
  const int64_t plane = (int64_t)h * wi, wsize = (int64_t)cin * cout * kTaps;
  const int chunks = (cin + kBfCi - 1) / kBfCi;
  const bf16 zero = __float2bfloat16(0.f);
  constexpr int groups = geo.xc / 8;   // 16-byte groups per staged row
  // the block's bands of wb quad rows, one after the other: steps (band,
  // chunk) in order, the next one staged while this one is multiplied
  const int steps = min(bands, (h - m0 + wb - 1) / wb) * chunks;

  for (int co0 = 0; co0 < cout; co0 += MT * 16) {
    const int rows = min(MT * 16, cout - co0);   // this pass's output channels
    // the low 3 bits of w[c0 + k][co0][0]'s index: where row k starts in
    // its staged copy (unsigned wrap-around keeps them)
    auto row_off = [&](int c0, int k) {
      return (int)((((unsigned)(c0 + k) * cout + co0) * kTaps) & 7u);
    };
    auto stage = [&](int st, int buf) {
      const int c = st % chunks, c0 = c * kBfCi, mb = m0 + (st / chunks) * wb;
      bf16* xd = xs + buf * geo.xbuf();
      for (int i = threadIdx.x; i < kBfCi * geo.xr * groups; i += blockDim.x) {
        const int q = i % groups, r = (i / groups) % geo.xr, ci = i / (groups * geo.xr);
        const int gy = mb + r, gx = j0 + 8 * q, ch = c0 + ci;
        const bool row_ok = ch < cin && gy < h;
        bf16* dst = xd + ci * geo.xs + r * geo.xc + 8 * q;
        const bf16* src = x + ((int64_t)img * cin + ch) * plane + (int64_t)gy * wi + gx;
        if (!row_ok || gx >= wi) {
          cp_async16(dst, x, false);
        } else if (vec && gx + 8 <= wi) {
          cp_async16(dst, src);
        } else {   // the ragged edge: plain loads, zero past the image
          alignas(16) bf16 v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = gx + e < wi ? src[e] : __float2bfloat16(0.f);
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
        }
      }
      // the chunk's weights as they lie: row k = w[c0 + k][co0 ..
      // co0 + rows)[tap], contiguous, copied from the 16-byte boundary at or
      // before its start (zeros past the tensor's end)
      bf16* wd = wr + buf * geo.rawbuf();
      for (int i = threadIdx.x; i < kBfCi * kBfRawVecs; i += blockDim.x) {
        const int v = i % kBfRawVecs, k = i / kBfRawVecs;
        if (c0 + k >= cin || 8 * v >= row_off(c0, k) + rows * kTaps) continue;
        const int64_t e = ((((int64_t)(c0 + k) * cout + co0) * kTaps) & ~(int64_t)7) + 8 * v;
        msau::cp_async16_bytes(wd + k * kBfRawPitch + 8 * v, w + e,
                               (int)min((int64_t)16, 2 * (wsize - e)));
      }
      msau::cp_async_commit();
    };

    float acc[4][MT][NT][4];
    stage(0, 0);
    for (int st = 0; st < steps; ++st) {
      const int c = st % chunks;
      if (c == 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[k][mt][nt][e] = 0.f;
      }
      if (st + 1 < steps) {
        stage(st + 1, (st + 1) & 1);
        msau::cp_async_wait<1>();
      } else {
        msau::cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* xb = xs + (st & 1) * geo.xbuf();
      // the tile shifted by one column: x1[ci][r][k] = xb[ci][r][k + 1]
      for (int i = threadIdx.x; i < kBfCi * geo.xr * NT; i += blockDim.x) {
        const int q = i % NT, r = (i / NT) % geo.xr, ci = i / (NT * geo.xr);
        const bf16* s = xb + ci * geo.xs + r * geo.xc + 8 * q;
        const uint4 lo = *reinterpret_cast<const uint4*>(s);
        const uint4 hi = *reinterpret_cast<const uint4*>(s + 8);
        uint4 o;
        o.x = __funnelshift_r(lo.x, lo.y, 16);
        o.y = __funnelshift_r(lo.y, lo.z, 16);
        o.z = __funnelshift_r(lo.z, lo.w, 16);
        o.w = __funnelshift_r(lo.w, hi.x, 16);
        *reinterpret_cast<uint4*>(x1 + ci * geo.x1s + r * 8 * NT + 8 * q) = o;
      }
      // the weights transposed to [tap][co][ci], A as ldmatrix reads it: a
      // thread takes a (co, tap) pair and its 16 input channels (a warp's
      // reads of one row are consecutive); zero past cin and cout
      const bf16* wc_raw = wr + (st & 1) * geo.rawbuf();
      const int c0 = c * kBfCi;
      for (int pr = threadIdx.x; pr < MT * 16 * kTaps; pr += blockDim.x) {
        const int co = pr / kTaps, tap = pr % kTaps;
        alignas(16) bf16 v[kBfCi];
#pragma unroll
        for (int k = 0; k < kBfCi; ++k)
          v[k] = co < rows && c0 + k < cin ? wc_raw[k * kBfRawPitch + row_off(c0, k) + pr]
                                           : zero;
        uint4* d = reinterpret_cast<uint4*>(wt + tap * kBfWTap + co * kBfWPitch);
        d[0] = reinterpret_cast<const uint4*>(v)[0];
        d[1] = reinterpret_cast<const uint4*>(v)[1];
      }
      __syncthreads();

      // B fragments (k = 16 input channels, n = 8 quads) for the 4 shifts
      unsigned bfr[2][2][NT][2];
      const int mi = lane / 8, lr = lane % 8;
#pragma unroll
      for (int dr = 0; dr < 2; ++dr)
#pragma unroll
        for (int dc = 0; dc < 2; ++dc) {
          const bf16* base = dc ? x1 + (mi & 1) * 8 * geo.x1s + lr * geo.x1s +
                                      (warp + dr) * 8 * NT
                                : xb + (mi & 1) * 8 * geo.xs + lr * geo.xs +
                                      (warp + dr) * geo.xc;
          if constexpr (NT == 1) {
            unsigned r2[2];
            msau::ldsm_x2_trans(r2, base);
            bfr[dr][dc][0][0] = r2[0];
            bfr[dr][dc][0][1] = r2[1];
          } else {
#pragma unroll
            for (int p = 0; p < NT / 2; ++p) {
              unsigned r4[4];
              msau::ldsm_x4_trans(r4, base + 8 * (2 * p + (mi >> 1)));
              bfr[dr][dc][2 * p][0] = r4[0];
              bfr[dr][dc][2 * p][1] = r4[1];
              bfr[dr][dc][2 * p + 1][0] = r4[2];
              bfr[dr][dc][2 * p + 1][1] = r4[3];
            }
          }
        }
#pragma unroll
      for (int t = 0; t < kTaps; ++t) {
        const Tap tp = tap_of(t);
        const int cls = tp.cls, dr = tp.dr, dc = tp.dc;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          unsigned afr[4];
          msau::ldsm_x4(afr, wt + tp.tap * kBfWTap +
                                 (mt * 16 + (mi & 1) * 8 + lr) * kBfWPitch + (mi >> 1) * 8);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) msau::mma_bf16(acc[cls][mt][nt], afr, bfr[dr][dc][nt]);
        }
      }
      __syncthreads();   // this buffer and the shifted copy are written again
      if (c + 1 < chunks) continue;

      // acc[a * 2 + b][mt][nt]: rows (channels) lane / 4 and + 8, columns
      // (quads) 2 (lane % 4) and + 1 of the n-tile; a thread writes output
      // columns 2q .. 2q + 3 of its quad pair as one 8-byte store
      const int g = lane / 4, t4 = lane % 4, m = m0 + (st / chunks) * wb + warp;
      const bool vec4 = (wo % 4) == 0;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int oc = co0 + mt * 16 + hf * 8 + g;
          if (oc >= cout) continue;
          const float bc = bias[oc];
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            const int oy = 2 * m + a;
            if (oy >= ho) continue;
            bf16* yr = y + (((int64_t)img * cout + oc) * ho + oy) * wo;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const int ox = 2 * (j0 + 8 * nt + 2 * t4);
              if (ox >= wo) continue;
              const float v[4] = {acc[2 * a][mt][nt][2 * hf] + bc,
                                  acc[2 * a + 1][mt][nt][2 * hf] + bc,
                                  acc[2 * a][mt][nt][2 * hf + 1] + bc,
                                  acc[2 * a + 1][mt][nt][2 * hf + 1] + bc};
              if (vec4 && ox + 4 <= wo) {
                __nv_bfloat162 p0 = __floats2bfloat162_rn(v[0], v[1]);
                __nv_bfloat162 p1 = __floats2bfloat162_rn(v[2], v[3]);
                uint2 u;
                u.x = *reinterpret_cast<unsigned*>(&p0);
                u.y = *reinterpret_cast<unsigned*>(&p1);
                *reinterpret_cast<uint2*>(yr + ox) = u;
              } else {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  if (ox + e < wo) yr[ox + e] = __float2bfloat16(v[e]);
              }
            }
          }
        }
    }
  }
}

// ---- launch ----------------------------------------------------------------

constexpr int kWaveBlocks = 2 * 132;   // two blocks per SM of the H100

int64_t blocks_of(int64_t n, int h, int wi, int rows, int cols) {
  return n * ((h + rows - 1) / rows) * ((wi + cols - 1) / cols);
}

int launch_f32(const float* x, const float* w, const float* bias, float* y, int n, int cin,
               int h, int wi, int cout, int ho, int wo, cudaStream_t stream) {
  const int groups = (min(cout, kF32Co) + 7) / 8;
  const int gp = groups <= 1 ? 1 : groups <= 2 ? 2 : 4;
  // the most quad rows per thread that still gives two blocks per SM
  int qr = 1;
  for (int cand : {4, 2}) {
    if (blocks_of(n, h, wi, (4 / gp) * cand, kF32Cols) >= kWaveBlocks) {
      qr = cand;
      break;
    }
  }
  const int rows = (4 / gp) * qr;
  const size_t smem = (size_t)(2 * f32_xbuf(rows) + 2 * kF32Wbuf) * sizeof(float);
  const dim3 grid((wi + kF32Cols - 1) / kF32Cols, (h + rows - 1) / rows, n);
  const int vec = (wi % 4 == 0) && ((uintptr_t)x % 16 == 0);
  cudaError_t err;
#define MSAU_F32(QR)                                                                    \
  err = msau::allow_smem(deconv2_f32_kernel<QR>, smem);                                 \
  if (err != cudaSuccess) return (int)err;                                              \
  deconv2_f32_kernel<QR><<<grid, kF32Threads, smem, stream>>>(x, w, bias, y, cin, h, wi, \
                                                               cout, ho, wo, gp, vec);
  if (qr == 4) {
    MSAU_F32(4)
  } else if (qr == 2) {
    MSAU_F32(2)
  } else {
    MSAU_F32(1)
  }
#undef MSAU_F32
  return (int)cudaGetLastError();
}

template <int MT, int NT, int WB>
int launch_bf16_tile(const bf16* x, const bf16* w, const float* bias, bf16* y, int n,
                     int cin, int h, int wi, int cout, int ho, int wo, int bands,
                     cudaStream_t stream) {
  const size_t smem = (size_t)BfGeom(WB, NT).elems() * sizeof(bf16);
  cudaError_t err = msau::allow_smem(deconv2_bf16_kernel<MT, NT, WB>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((wi + 8 * NT - 1) / (8 * NT), (h + WB * bands - 1) / (WB * bands), n);
  const int vec = (wi % 8 == 0) && ((uintptr_t)x % 16 == 0);
  deconv2_bf16_kernel<MT, NT, WB><<<grid, 32 * WB, smem, stream>>>(
      x, w, bias, y, cin, h, wi, cout, ho, wo, bands, vec);
  return (int)cudaGetLastError();
}

int launch_bf16(const bf16* x, const bf16* w, const float* bias, bf16* y, int n, int cin,
                int h, int wi, int cout, int ho, int wo, cudaStream_t stream) {
  if ((uintptr_t)w % 16 != 0) return (int)cudaErrorMisalignedAddress;
  // quads per block: 4 rows x 32 columns where that gives two blocks per
  // SM, else fewer warps, then narrower warps
  static const int kShapes[5][2] = {{4, 4}, {4, 2}, {4, 1}, {2, 1}, {1, 1}};   // NT, WB
  int nt = 1, wb = 1;
  for (const auto& s : kShapes) {
    if (blocks_of(n, h, wi, s[1], 8 * s[0]) >= kWaveBlocks) {
      nt = s[0];
      wb = s[1];
      break;
    }
  }
  // a block walks up to 4 bands of quad rows, staging the next while it
  // multiplies this one, where four blocks per SM remain
  const int64_t base = blocks_of(n, h, wi, wb, 8 * nt);
  const int bands = base >= 4 * 2 * kWaveBlocks ? 4 : base >= 2 * 2 * kWaveBlocks ? 2 : 1;
  const bool two = cout > 16;
#define MSAU_BF(MT, NT, WB)                                                                \
  return launch_bf16_tile<MT, NT, WB>(x, w, bias, y, n, cin, h, wi, cout, ho, wo, bands, \
                                      stream);
#define MSAU_BF_SHAPES(MT)                     \
  if (nt == 4 && wb == 4) MSAU_BF(MT, 4, 4)    \
  if (nt == 4 && wb == 2) MSAU_BF(MT, 4, 2)    \
  if (nt == 4) MSAU_BF(MT, 4, 1)               \
  if (nt == 2) MSAU_BF(MT, 2, 1)               \
  MSAU_BF(MT, 1, 1)
  if (two) {
    MSAU_BF_SHAPES(2)
  }
  MSAU_BF_SHAPES(1)
#undef MSAU_BF_SHAPES
#undef MSAU_BF
}

// ---- any other odd K: the general kernel -----------------------------------
//
// Each thread owns two vertically adjacent output quads (all four parity
// classes) for 8 output channels, 64 accumulators; a block is 32 x 8 quads
// of one image and one group of 8 output channels; it stages 8 input
// channels of its input tile (with the K/4-wide halo) and their weights
// [ci][tap][co] in shared memory at a time, converted to f32, and walks
// each class's taps at run time.  FP32 pipes in both dtypes.

constexpr int kGenQx = 32;   // quad columns per block: one per lane
constexpr int kGenTy = 4;    // warps per block
constexpr int kGenQr = 2;    // quad rows per thread
constexpr int kGenThreads = kGenQx * kGenTy;
constexpr int kGenQh = kGenTy * kGenQr;   // quad rows per block
constexpr int kGenCo = 8;                 // output channels per block
constexpr int kGenCi = 8;                 // input channels staged per chunk

template <typename T>
__global__ void __launch_bounds__(kGenThreads)
deconv2_general_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ bias, T* __restrict__ y, int cin, int h,
                       int wi, int cout, int k, int ho, int wo, int groups) {
  using msau::store;
  using msau::to_f32;
  extern __shared__ __align__(16) float smem[];
  const int p = k / 2;
  // input rows (and columns) a quad reads lie in [m - lo, m + hi]
  const int lo = (k - 1 - p) / 2, hi = (1 + p) / 2;
  const int ih = kGenQh + lo + hi, iw = kGenQx + lo + hi;
  const int taps = k * k;
  float* xs = smem;                                   // [kGenCi][ih][iw]
  float* ws = smem + ((kGenCi * ih * iw + 3) & ~3);   // [kGenCi][taps][kGenCo]
  const int img = blockIdx.z / groups, co0 = (blockIdx.z % groups) * kGenCo;
  const int m0 = blockIdx.y * kGenQh, j0 = blockIdx.x * kGenQx;
  const int tx = threadIdx.x % kGenQx, ty = threadIdx.x / kGenQx;
  const int64_t plane_in = (int64_t)h * wi;

  float acc[kGenQr][2][2][kGenCo];
#pragma unroll
  for (int q = 0; q < kGenQr; ++q)
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int c = 0; c < kGenCo; ++c) acc[q][a][b][c] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += kGenCi) {
    const int cc = min(kGenCi, cin - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < cc * ih * iw; i += kGenThreads) {
      const int ci = i / (ih * iw), rem = i - ci * ih * iw;
      const int r = rem / iw, q = rem - r * iw;
      const int gy = m0 - lo + r, gx = j0 - lo + q;
      xs[i] = (gy >= 0 && gy < h && gx >= 0 && gx < wi)
                  ? to_f32(x[((int64_t)img * cin + c0 + ci) * plane_in +
                             (int64_t)gy * wi + gx])
                  : 0.f;
    }
    for (int i = threadIdx.x; i < cc * taps * kGenCo; i += kGenThreads) {
      const int co = i % kGenCo, t = i / kGenCo;
      const int tap = t % taps, ci = t / taps;
      ws[i] = co0 + co < cout
                  ? to_f32(w[((int64_t)(c0 + ci) * cout + co0 + co) * taps + tap])
                  : 0.f;
    }
    __syncthreads();
    for (int ci = 0; ci < cc; ++ci) {
      const float* xc = xs + ci * ih * iw + (ty * kGenQr + lo) * iw + tx + lo;
      const float* wc = ws + ci * taps * kGenCo;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        // output row 2m + a takes tap ky from input row m + (a + p - ky) / 2
        for (int ky = (a + p) & 1; ky < k; ky += 2) {
          const int dr = (a + p - ky) / 2;
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            for (int kx = (b + p) & 1; kx < k; kx += 2) {
              const int dc = (b + p - kx) / 2;
              float wv[kGenCo];
              load_row(wv, wc + (ky * k + kx) * kGenCo);
              const float* xr = xc + dr * iw + dc;
#pragma unroll
              for (int q = 0; q < kGenQr; ++q) {
                const float v = xr[q * iw];
#pragma unroll
                for (int c = 0; c < kGenCo; ++c)
                  acc[q][a][b][c] = fmaf(v, wv[c], acc[q][a][b][c]);
              }
            }
          }
        }
      }
    }
  }

  const int64_t plane_out = (int64_t)ho * wo;
  T* yo = y + ((int64_t)img * cout + co0) * plane_out;
#pragma unroll
  for (int c = 0; c < kGenCo; ++c) {
    if (co0 + c >= cout) break;
    const float bc = bias[co0 + c];
#pragma unroll
    for (int q = 0; q < kGenQr; ++q)
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int oy = 2 * (m0 + ty * kGenQr + q) + a;
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int ox = 2 * (j0 + tx) + b;
          if (oy < ho && ox < wo)
            store(yo + c * plane_out + (int64_t)oy * wo + ox, acc[q][a][b][c] + bc);
        }
      }
  }
}

template <typename T>
int launch_general(const void* x, const void* w, const void* bias, void* y, int n,
                   int cin, int h, int wi, int cout, int k, int ho, int wo,
                   cudaStream_t stream) {
  const int groups = (cout + kGenCo - 1) / kGenCo;
  if ((int64_t)n * groups > 65535) return (int)cudaErrorInvalidValue;
  const int p = k / 2, lo = (k - 1 - p) / 2, hi = (1 + p) / 2;
  const int ih = kGenQh + lo + hi, iw = kGenQx + lo + hi;
  const size_t smem =
      (size_t)(((kGenCi * ih * iw + 3) & ~3) + kGenCi * k * k * kGenCo) * sizeof(float);
  cudaError_t err = msau::allow_smem(deconv2_general_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  // one quad row per input row: quads cover rows [0, ceil(ho / 2)) = [0, h)
  const dim3 grid((wi + kGenQx - 1) / kGenQx, (h + kGenQh - 1) / kGenQh, n * groups);
  deconv2_general_kernel<T><<<grid, kGenThreads, smem, stream>>>(
      (const T*)x, (const T*)w, (const float*)bias, (T*)y, cin, h, wi, cout, k, ho, wo,
      groups);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [n, cin, h, w]; w: [cin, cout, k, k] (odd k) in the activation dtype,
// 16-byte aligned in bf16; bias: [cout] f32; y: [n, cout, ho, wo] with ho in
// {2h-1, 2h}, wo in {2w-1, 2w}.
extern "C" int msau_flat_deconv2(const void* x, const void* w, const void* bias, void* y,
                                 int n, int cin, int h, int wd, int cout, int k, int ho,
                                 int wo, int is_bf16, void* stream) {
  if (n < 0 || cin <= 0 || h < 0 || wd < 0 || cout <= 0 || k <= 0 || k % 2 == 0 ||
      (ho != 2 * h - 1 && ho != 2 * h) || (wo != 2 * wd - 1 && wo != 2 * wd) ||
      n > 65535 || h > 65535)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || h == 0 || wd == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (k != 3)
    return is_bf16 ? launch_general<bf16>(x, w, bias, y, n, cin, h, wd, cout, k, ho, wo, s)
                   : launch_general<float>(x, w, bias, y, n, cin, h, wd, cout, k, ho, wo, s);
  if (is_bf16)
    return launch_bf16((const bf16*)x, (const bf16*)w, (const float*)bias, (bf16*)y, n, cin,
                       h, wd, cout, ho, wo, s);
  return launch_f32((const float*)x, (const float*)w, (const float*)bias, (float*)y, n, cin,
                    h, wd, cout, ho, wo, s);
}
