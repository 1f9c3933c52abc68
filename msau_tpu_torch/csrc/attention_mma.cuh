// Building blocks of the attention's kernels (attention.cu: the resident
// and the streaming forward; attention_bwd.cu): every wide product on bf16
// tensor cores (mma.sync from ldmatrix), with f32 sums.
//
// A kernel instance is either
//  - bf16 (P = 1 part): the operands are bf16, the score product s = g fᵀ
//    runs on the tensor cores too (m16n8k8, Cb padded to 8 or 16; the
//    products of bf16 values are exact in f32), and A and ds are rounded to
//    bf16 before their products, where the TPU kernels round them
//    (pallas_attn.py:_res_fwd_kernel, _res_bwd_kernel: acc_dtype with f32
//    sums); or
//  - f32 (P = 3 parts): every operand of a wide product is split into three
//    bf16 parts x = x0 + x1 + x2 (each difference exact in f32), and the
//    product sums the six terms qa + qb < 3 (mma_parts), which carries it to
//    f32's 24 bits (two parts and three terms carry 16).  The score product
//    and rho stay on the FP32 pipes: the logits feed an exponential; or
//  - the streaming forward's with bf16 operands: bf16 scores as in the
//    first, but A in f32, three parts against h's one (three terms).
//
// Fragment layouts (PTX ISA, mma.m16n8k16 / m16n8k8 .bf16, lane = 4 gq + tq):
// an accumulator (C) tile of 16 x 8 holds rows gq and gq + 8 at columns
// 2 tq and 2 tq + 1; an A operand of 16 x 16 holds the same positions of
// its left (k 0-7) and right (k 8-15) halves.  So two C tiles side by side,
// rounded or split to bf16 pairs, are an A operand whose k axis is their
// columns (mma_a_from_c): a score tile becomes the A of the product that
// sums over its columns without leaving registers, and movmatrix transposes
// it for the product that sums over its rows.
#pragma once

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace msau {
namespace attn {

using bf16 = __nv_bfloat16;

// Cb padded to the score product's k (8, or a multiple of 16: 16 up to Cb
// 16, 32 at Cb 32) and the row strides of the staged operands, in
// elements: bf16 rows for ldmatrix (ldsm_stride), f32 rows of Cb (16-byte
// loads where Cb % 4 == 0).
template <int CB>
struct Keys {
  static constexpr int KB = CB <= 8 ? 8 : (CB + 15) / 16 * 16;
  static constexpr int KS = ldsm_stride(KB);
  static constexpr int CF = (CB + 3) / 4 * 4;
};
// C padded to the k of one m16n8k16 product (16) and its bf16 row stride
template <int C>
struct Cols {
  static constexpr int KC = C < 16 ? 16 : C;
  static constexpr int CS = ldsm_stride(KC);
  static constexpr int NT = KC / 8;   // n8 tiles of C
};

// (x, y) split into P bf16 pairs, x ~= sum of the parts, the largest first
// (P = 1: rounded to bf16, to nearest even, as a cast to bf16 rounds).
template <int P>
__device__ __forceinline__ void split2(unsigned (&out)[P], float x, float y) {
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(x, y);
    out[q] = *reinterpret_cast<const unsigned*>(&b);
    if (q + 1 < P) {
      const float2 r = __bfloat1622float2(b);
      x -= r.x;
      y -= r.y;
    }
  }
}

// d += a b over the parts, a in PA parts and b in PB: every product of
// parts qa + qb < max(PA, PB), the smallest first (PA = PB = 3: six; PA =
// 3 with a bf16 b, PB = 1: the three (qa, 0), since a bf16 value's second
// and third parts are 0).  With more than one part the terms sum into a
// zeroed temporary that is then added to d on the FP32 pipes: the tensor
// cores' accumulator drops low bits on every product (summed straight into
// d, the f32 forward at T = 4096 lay 3.1e-4 from its plain version on the
// H100), so they only ever sum one k step.
template <int PA, int PB = PA>
__device__ __forceinline__ void mma_parts(float (&d)[4], const unsigned (&a)[PA][4],
                                          const unsigned (&b)[PB][2]) {
  constexpr int P = PA > PB ? PA : PB;
  if constexpr (P == 1) {
    mma_bf16(d, a[0], b[0]);
  } else {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = P - 1; s >= 0; --s)
#pragma unroll
      for (int qa = s - PB + 1 > 0 ? s - PB + 1 : 0; qa <= (s < PA - 1 ? s : PA - 1); ++qa)
        mma_bf16(t, a[qa], b[s - qa]);
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] += t[e];
  }
}

// The A operand (16 x 16, k = the 16 columns) made from two 16 x 8 C tiles
// c0 (columns 0-7) and c1 (8-15), split into P parts.
template <int P>
__device__ __forceinline__ void mma_a_from_c(unsigned (&a)[P][4], const float (&c0)[4],
                                             const float (&c1)[4]) {
  unsigned p[P];
  split2<P>(p, c0[0], c0[1]);
#pragma unroll
  for (int q = 0; q < P; ++q) a[q][0] = p[q];
  split2<P>(p, c0[2], c0[3]);
#pragma unroll
  for (int q = 0; q < P; ++q) a[q][1] = p[q];
  split2<P>(p, c1[0], c1[1]);
#pragma unroll
  for (int q = 0; q < P; ++q) a[q][2] = p[q];
  split2<P>(p, c1[2], c1[3]);
#pragma unroll
  for (int q = 0; q < P; ++q) a[q][3] = p[q];
}

// The transpose of mma_a_from_c's operand: with a from C tiles whose rows
// are r and columns s, the A operand whose rows are s and k is r.
template <int P>
__device__ __forceinline__ void mma_a_transposed(unsigned (&at)[P][4], const unsigned (&a)[P][4]) {
#pragma unroll
  for (int q = 0; q < P; ++q) {
    at[q][0] = movm_trans(a[q][0]);
    at[q][1] = movm_trans(a[q][2]);
    at[q][2] = movm_trans(a[q][1]);
    at[q][3] = movm_trans(a[q][3]);
  }
}

// 8 consecutive values of a row in global memory as f32 (16-byte aligned).
__device__ __forceinline__ void load8(float (&v)[8], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(float (&v)[8], const bf16* p) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = unpack_bf16(w[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

// Rows [r0, r0 + NROWS) of a [t, W] row-major matrix (W % 8 == 0) into P
// bf16 planes of [NROWS][stride] (plane q at dst + q * plane), its parts;
// columns [W, WP) and rows at or past t as zeros.  A block of THREADS
// threads issues every load before the first store.
template <int P, int NROWS, int THREADS, int W, int WP, typename S>
__device__ __forceinline__ void stage_planes(bf16* dst, int plane, int stride, const S* src,
                                             int r0, int t) {
  constexpr int G = WP / 8, N = NROWS * G, ITER = (N + THREADS - 1) / THREADS;
  float v[ITER][8];
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    const int e = threadIdx.x + it * THREADS;
    const int r = e / G, c = (e % G) * 8;
    if (e < N && r0 + r < t && c < W) {
      load8(v[it], src + (int64_t)(r0 + r) * W + c);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[it][k] = 0.f;
    }
  }
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    const int e = threadIdx.x + it * THREADS;
    if (e >= N) continue;
    const int r = e / G, c = (e % G) * 8;
    unsigned words[P][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      unsigned p[P];
      split2<P>(p, v[it][2 * k], v[it][2 * k + 1]);
#pragma unroll
      for (int q = 0; q < P; ++q) words[q][k] = p[q];
    }
#pragma unroll
    for (int q = 0; q < P; ++q)
      *reinterpret_cast<uint4*>(dst + q * plane + r * stride + c) =
          make_uint4(words[q][0], words[q][1], words[q][2], words[q][3]);
  }
}

// Rows [r0, r0 + NROWS) of a [t, CB] matrix: as P bf16 planes of
// [NROWS][KS] (columns CB..KB zero) where ``planes`` is set, and as f32
// rows of [NROWS][CF] where ``rows_f32`` is set; rows at or past t zero.
// Every load is issued before the first store.
template <int P, int CB, int NROWS, int THREADS, typename S>
__device__ __forceinline__ void stage_keys(bf16* planes, int plane, float* rows_f32, const S* src,
                                           int r0, int t) {
  using K = Keys<CB>;
  constexpr int W = K::KB > K::CF ? K::KB : K::CF;
  constexpr int N = NROWS * W, ITER = (N + THREADS - 1) / THREADS;
  float v[ITER];
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    const int e = threadIdx.x + it * THREADS;
    const int r = e / W, k = e % W;
    v[it] = (e < N && r0 + r < t && k < CB) ? to_f32(src[(int64_t)(r0 + r) * CB + k]) : 0.f;
  }
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    const int e = threadIdx.x + it * THREADS;
    if (e >= N) continue;
    const int r = e / W, k = e % W;
    if (planes != nullptr && k < K::KB) {
      float x = v[it];
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const bf16 b = __float2bfloat16(x);
        planes[q * plane + r * K::KS + k] = b;
        x -= __bfloat162float(b);
      }
    }
    if (rows_f32 != nullptr && k < K::CF) rows_f32[r * K::CF + k] = v[it];
  }
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the SFU, one instruction (denormal results flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A row's softmax constants, for a = exp(s - m) / l.  f32 takes it as the
// plain version's two steps, exp(s - m) times 1/l; bf16, whose a is
// rounded to bf16 next, takes 2^((s - m) log2e - log2 l): one FADD, one
// FFMA and one SFU op per score.  s - m comes first in both: the flagship's
// bf16 model at flat_scales 0 gives its first attention logits so large
// that a folded exponent s log2e - (m log2e + log2 l) loses whole ulps of
// m log2e (0.03 at m = 2e5), and that model stopped training with it.
// Rows past t (m = l = 0) give a = 0 either way.
struct RowSoftmax {
  float m, il, lg;
};
__device__ __forceinline__ RowSoftmax row_softmax(float m, float l) {
  return {m, l > 0.f ? __frcp_rn(l) : 0.f, l > 0.f ? __log2f(l) : INFINITY};
}
template <bool F32>
__device__ __forceinline__ float softmax_a(float s, const RowSoftmax& r) {
  if constexpr (F32)
    return ex2((s - r.m) * kLog2e) * r.il;
  else
    return ex2(fmaf(s - r.m, kLog2e, -r.lg));
}

// Keys rows whose bytes are whole 16-byte pieces of a staged row, which
// stage_key_rows copies asynchronously: bf16 at Cb 8, 16 or 32 (rows of
// KS), f32 at Cb 4, 8, 16 or 32 (rows of CF = Cb).
template <typename T, int CB>
constexpr bool kAsyncKeys = CB * (int)sizeof(T) % 16 == 0;

// Rows [r0, r0 + nrows) of a [t, w] row-major matrix of S into shared rows
// of ``stride`` elements, asynchronously (cp.async, 16 bytes a piece: w and
// stride in elements of 16 bytes); rows at or past t zero-filled.
template <typename S>
__device__ __forceinline__ void async_rows(S* dst, int stride, const S* src, int r0, int nrows,
                                           int w, int t) {
  constexpr int V = 16 / (int)sizeof(S);
  const int pieces = w / V;
  for (int e = threadIdx.x; e < nrows * pieces; e += blockDim.x) {
    const int r = e / pieces, c = (e % pieces) * V;
    const bool ok = r0 + r < t;
    cp_async16(dst + r * stride + c, src + (int64_t)(ok ? r0 + r : 0) * w + c, ok);
  }
}
// src[r0, r0 + n) into dst, asynchronously; zeros at or past t.
__device__ __forceinline__ void async_floats(float* dst, const float* src, int r0, int n, int t) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const bool ok = r0 + e < t;
    cp_async4(dst + e, src + (ok ? r0 + e : 0), ok);
  }
}

// The score product's A operand (m16n8k8, k = Cb padded) for rows gq and
// gq + 8 from r0 (= the tile's first row + gq) of a [t, CB] matrix: a[kk]
// = {row gq, row gq + 8} at k 8 kk + 2 tq, + 1.
template <int CB, typename S>
__device__ __forceinline__ void load_score_a(unsigned (&a)[Keys<CB>::KB / 8][2], const S* src,
                                             int r0, int t, int tq) {
#pragma unroll
  for (int kk = 0; kk < Keys<CB>::KB / 8; ++kk)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 8 * hh, k = 8 * kk + 2 * tq;
      const float x = (r < t && k < CB) ? to_f32(src[(int64_t)r * CB + k]) : 0.f;
      const float y = (r < t && k + 1 < CB) ? to_f32(src[(int64_t)r * CB + k + 1]) : 0.f;
      a[kk][hh] = pack_bf16(x, y);
    }
}
// The same rows as f32 values for the FP32-pipe score product.
template <int CB, typename S>
__device__ __forceinline__ void load_score_rows(float (&x)[2][CB], const S* src, int r0, int t) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int k = 0; k < CB; ++k)
      x[hh][k] = r0 + 8 * hh < t ? to_f32(src[(int64_t)(r0 + 8 * hh) * CB + k]) : 0.f;
}

// The score tile of 16 rows x 16 columns as two C tiles s[nt] (columns
// 8 nt ..): rows from registers, columns from the 16 staged rows at
// ``cols``.  bf16: tensor cores on the staged bf16 rows (stride KS).
template <int MT, int CB>
__device__ __forceinline__ void score_mma(float (&s)[MT][2][4],
                                          const unsigned (&a)[MT][Keys<CB>::KB / 8][2],
                                          const bf16* cols, int lane) {
  using K = Keys<CB>;
  unsigned b[K::KB / 8][2];
  const bf16* p = cols + ((lane & 7) + 8 * ((lane >> 3) & 1)) * K::KS;
  if constexpr (K::KB == 8) {
    unsigned r[2];
    ldsm_x2(r, p);
    b[0][0] = r[0];
    b[0][1] = r[1];
  } else {
    // one x4 load per 16 columns of k: k8 steps 2 kh and 2 kh + 1
#pragma unroll
    for (int kh = 0; kh < K::KB / 16; ++kh) {
      unsigned r[4];
      ldsm_x4(r, p + 16 * kh + 8 * (lane >> 4));
      b[2 * kh][0] = r[0];
      b[2 * kh][1] = r[1];
      b[2 * kh + 1][0] = r[2];
      b[2 * kh + 1][1] = r[3];
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      s[mt][nt][0] = s[mt][nt][1] = s[mt][nt][2] = s[mt][nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < K::KB / 8; ++kk)
        mma_bf16_k8(s[mt][nt], a[mt][kk][0], a[mt][kk][1], b[kk][nt]);
    }
}
// f32: FP32 pipes, the staged f32 rows at ``cols`` (stride CF), each dot in
// the order k = 0 .. Cb - 1 from 0.
template <int MT, int CB>
__device__ __forceinline__ void score_ffma(float (&s)[MT][2][4], const float (&x)[MT][2][CB],
                                           const float* cols, int tq) {
  using K = Keys<CB>;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float y[CB];
      load_row(y, cols + (8 * nt + 2 * tq + e) * K::CF);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float acc = 0.f;
#pragma unroll
          for (int k = 0; k < CB; ++k) acc = fmaf(x[mt][hh][k], y[k], acc);
          s[mt][nt][2 * hh + e] = acc;
        }
    }
}


// The keys rows [r0, r0 + NROWS) of a [t, CB] matrix into the buffer at
// dst as the score product reads them: bf16 rows of KS (T = bf16) or f32
// rows of CF (T = f32); asynchronously (cp.async, the caller commits) where
// kAsyncKeys, else by plain loads.  Rows at or past t are zero.
template <typename T, int CB, int NROWS, int THREADS>
__device__ __forceinline__ void stage_key_rows(void* dst, const T* src, int r0, int t) {
  using K = Keys<CB>;
  constexpr bool f32 = std::is_same<T, float>::value;
  if constexpr (kAsyncKeys<T, CB>) {
    async_rows<T>(reinterpret_cast<T*>(dst), f32 ? K::CF : K::KS, src, r0, NROWS, CB, t);
  } else if constexpr (f32) {
    stage_keys<1, CB, NROWS, THREADS>(nullptr, 0, reinterpret_cast<float*>(dst), src, r0, t);
  } else {
    stage_keys<1, CB, NROWS, THREADS>(reinterpret_cast<bf16*>(dst), 0, nullptr, src, r0, t);
  }
}

// The backward's df: the per_image slices [per_image, N, T, Cb] f32 summed
// in block order (no float atomics: a rerun gives the same bits), cast
template <typename T>
__global__ void combine_kernel(const float* __restrict__ partial, T* __restrict__ out,
                               int64_t count, int per_image) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float s = 0.f;
  for (int k = 0; k < per_image; ++k) s += partial[k * count + e];
  store(out + e, s);
}

}  // namespace attn
}  // namespace msau
