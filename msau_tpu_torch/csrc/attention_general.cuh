// The attention at any width: every (Cb, C) without an instance of its own
// in attention.cu and attention_bwd.cu (those keep their kernels for (1, 8),
// (2, 16), (4, 32), (8, 64), (16, 128), (32, 256)).  Cb and C are runtime
// arguments; the kernels live in attention_general_fwd.cu (stats, accum)
// and attention_general_bwd.cu (dh, ds, combine), built from the pieces
// here and from attention_mma.cuh.
//
// The same semantics as the specialised kernels (s_ij = g_i . f_j, A =
// softmax over j with the saved m_i, l_i, out_j = sum_i A_ij h_i; the VJP
// with ds_ij = a_ij (h_i . dout_j - rho_i)), and the same types:
//  - every wide product (A^T h, a dout, h dout^T, ds f, ds^T g) runs on
//    the bf16 tensor cores (mma.sync m16n8k16 from ldmatrix): bf16
//    operands as they are, with a and ds rounded to bf16 where the TPU
//    kernels round them; f32 operands as three bf16 parts (mma_parts, six
//    products), each k step summed apart and added on the FP32 pipes;
//  - the score product s = g f^T: bf16 operands on the tensor cores
//    (products exact in f32; with more than one k step each step is summed
//    apart and added in f32), f32 operands on the FP64 tensor cores
//    (mma.sync m8n8k4 .f64: the products of f32 values are exact in f64,
//    so s - m reaches the exponent with f32's precision; f32 sums of the
//    score at Cb 12 put the output 3.5e-5 from float64, past ATTN_TOL's
//    1e-5).
//
// Widths.  Cb pads to the score product's k step (16 in bf16, 4 in f64)
// and C to a multiple of 16, with zeros staged in shared memory: padded
// columns add exact zeros, and nothing past T, Cb or C reaches memory.
// The score product reads the keys side from shared memory (score rows,
// staged once per chunk: the first kStageCb columns of Cb; any further
// column of a wider Cb from global memory where it is used) and a warp's
// own rows from registers (RowFrags: loaded once per item, Cb up to 16 or
// 32) or, past that, from global memory.  So shared memory holds the same
// score rows at any Cb past kStageCb, and every Cb >= 1 runs.  Output
// columns come in groups of NT n8 tiles (a template constant, the
// accumulators of a warp); the launchers pick the smallest NT that covers
// C up to a cap, and past the cap the grid takes the groups.
#pragma once

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_mma.cuh"

namespace msau {
namespace attn {
namespace general {

// columns of Cb staged as score rows (a multiple of 16): f64 rows of 256
// columns already bound the chunks of the f32 kernels (fit_chunk, DsGeom)
constexpr int kStageCb = 256;

template <typename T>
constexpr bool kIsF32 = std::is_same<T, float>::value;

// The score product's sums: f64 for f32 operands, f32 for bf16 ones.
template <typename T>
using ScoreT = typename std::conditional<kIsF32<T>, double, float>::type;

// The score product's operand rows in shared memory: ``stride`` elements a
// row (bf16, or f64 for f32 operands), Cb padded with zeros to ``steps``
// k steps (16 columns in bf16, 4 in f64), of which the first ``staged``
// (up to kStageCb columns) are in the rows.  bf16 rows of an odd multiple
// of 8 elements and f64 rows of 4 modulo 8 doubles put the rows of one
// ldmatrix matrix, or of one quarter of a warp's f64 loads, on distinct
// banks.
struct KLayout {
  int steps, staged, stride, row_bytes;
};
template <typename T>
__host__ __device__ inline KLayout k_layout(int cb) {
  if (kIsF32<T>) {
    const int kd = (cb + 3) / 4 * 4, ks = kd < kStageCb ? kd : kStageCb;
    const int stride = ks % 8 == 4 ? ks : ks + 4;
    return {kd / 4, ks / 4, stride, stride * 8};
  }
  const int kb = (cb + 15) / 16 * 16, ks = kb < kStageCb ? kb : kStageCb;
  return {kb / 16, ks / 16, ks + 8, (ks + 8) * 2};
}

// Element e of rows [r0, r0 + nrows) of a [t, cb] matrix as score rows
// (KLayout<T>: rows of L.stride, zeros past t and cb) and its store.
template <typename T>
__device__ __forceinline__ float score_value(const T* src, int r0, int e, int t, int cb,
                                             KLayout L) {
  const int r = e / L.stride, k = e - r * L.stride;
  return r0 + r < t && k < cb && k < kStageCb ? to_f32(src[(int64_t)(r0 + r) * cb + k]) : 0.f;
}
template <typename T>
__device__ __forceinline__ void put_score(unsigned char* dst, int e, float v) {
  if constexpr (kIsF32<T>)
    reinterpret_cast<double*>(dst)[e] = (double)v;
  else
    reinterpret_cast<bf16*>(dst)[e] = __float2bfloat16(v);
}

// Rows [r0, r0 + nrows) of a [t, cb] matrix into score rows at dst.
template <typename T>
__device__ inline void stage_score_rows(unsigned char* dst, const T* src, int r0, int nrows,
                                        int t, int cb, KLayout L) {
  for (int e = threadIdx.x; e < nrows * L.stride; e += blockDim.x)
    put_score<T>(dst, e, score_value(src, r0, e, t, cb, L));
}

// 8 consecutive columns [col, col + 8) of a row of a [t, width] row-major
// matrix (zeros past t and width; ``in``: the row lies in the block), as
// P bf16 parts: P = 1 for a bf16 source (the words as read), P = 3 for an
// f32 one (its values, split into parts when stored); 16-byte loads where
// width is a multiple of 8.
template <int P>
struct Piece {
  static_assert(P == 1 || P == 3, "a bf16 source (one part) or an f32 one (three)");
  unsigned w[P == 1 ? 4 : 1];
  float v[P == 3 ? 8 : 1];
  template <typename S>
  __device__ __forceinline__ void load(const S* src, int row, int col, int width, bool in) {
    const S* p = src + (int64_t)row * width + col;
    const bool whole = in && width % 8 == 0 && col + 8 <= width;
    if constexpr (P == 1) {
      if (whole) {
        const uint4 q = *reinterpret_cast<const uint4*>(p);
        w[0] = q.x, w[1] = q.y, w[2] = q.z, w[3] = q.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          w[k] = pack_bf16(in && col + 2 * k < width ? to_f32(p[2 * k]) : 0.f,
                           in && col + 2 * k + 1 < width ? to_f32(p[2 * k + 1]) : 0.f);
      }
    } else if (whole) {
      load8(v, p);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = in && col + k < width ? to_f32(p[k]) : 0.f;
    }
  }
  // to element ``at`` of P planes ``plane`` elements apart
  __device__ __forceinline__ void store(bf16* dst, int plane, int at) const {
    if constexpr (P == 1) {
      *reinterpret_cast<uint4*>(dst + at) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      unsigned words[P][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        unsigned q[P];
        split2<P>(q, v[2 * k], v[2 * k + 1]);
#pragma unroll
        for (int j = 0; j < P; ++j) words[j][k] = q[j];
      }
#pragma unroll
      for (int j = 0; j < P; ++j)
        *reinterpret_cast<uint4*>(dst + j * plane + at) =
            make_uint4(words[j][0], words[j][1], words[j][2], words[j][3]);
    }
  }
};

// Rows [r0, r0 + nrows) x columns [c0, c0 + ncols) of a [t, width]
// row-major matrix into P bf16 planes of [nrows][stride] (plane q at dst +
// q * plane), its parts; rows past t and columns past width as zeros.
// ncols, c0, stride and plane are multiples of 8.
template <int P, typename S>
__device__ inline void stage_cols(bf16* dst, int plane, int stride, const S* src, int r0,
                                  int nrows, int t, int width, int c0, int ncols) {
  const int pieces = ncols / 8;
  for (int e = threadIdx.x; e < nrows * pieces; e += blockDim.x) {
    const int r = e / pieces, c = (e - r * pieces) * 8;
    Piece<P> x;
    x.load(src, r0 + r, c0 + c, width, r0 + r < t);
    x.store(dst, plane, r * stride + c);
  }
}

// stage_cols and stage_score_rows split into their loads (global memory
// to registers: load) and stores (registers to shared memory: store), so
// that the next chunk's loads are in flight while a chunk is used.  ITEMS
// bounds what a thread holds: pieces for ColsStage (nrows x ncols / 8 over
// the block's threads), values for ScoreStage (nrows x stride over them);
// a ScoreStage whose rows do not fit stages them synchronously in store.
template <int P, int ITEMS>
struct ColsStage {
  Piece<P> x[ITEMS];
  template <typename S>
  __device__ void load(const S* src, int r0, int nrows, int t, int width, int c0, int ncols) {
    const int pieces = ncols / 8;
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int e = threadIdx.x + it * blockDim.x;
      const int r = e / pieces, c = (e - r * pieces) * 8;
      x[it].load(src, r0 + r, c0 + c, width, e < nrows * pieces && r0 + r < t);
    }
  }
  __device__ void store(bf16* dst, int plane, int stride, int nrows, int ncols) const {
    const int pieces = ncols / 8;
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int e = threadIdx.x + it * blockDim.x;
      const int r = e / pieces, c = (e - r * pieces) * 8;
      if (e < nrows * pieces) x[it].store(dst, plane, r * stride + c);
    }
  }
};

template <typename T, int ITEMS>
struct ScoreStage {
  float v[ITEMS];
  const T* src;
  int r0;
  bool held;   // the rows fit: loaded into v
  __device__ void load(const T* src_, int r0_, int nrows, int t, int cb, KLayout L) {
    src = src_;
    r0 = r0_;
    held = nrows * L.stride <= ITEMS * (int)blockDim.x;
    if (!held) return;
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int e = threadIdx.x + it * blockDim.x;
      v[it] = e < nrows * L.stride ? score_value(src, r0, e, t, cb, L) : 0.f;
    }
  }
  __device__ void store(unsigned char* dst, int nrows, int t, int cb, KLayout L) const {
    if (!held) {
      stage_score_rows<T>(dst, src, r0, nrows, t, cb, L);
      return;
    }
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int e = threadIdx.x + it * blockDim.x;
      if (e < nrows * L.stride) put_score<T>(dst, e, v[it]);
    }
  }
};
// a score row's widest stride for Cb up to kb (a multiple of 8)
template <typename T>
__host__ __device__ constexpr int max_score_stride(int kb) {
  return kIsF32<T> ? kb + 4 : (kb + 15) / 16 * 16 + 8;
}

// d += a b on the FP64 tensor cores (mma.sync m8n8k4 .f64: a = A[lane / 4]
// [lane % 4], b = B[lane % 4][lane / 4], d[e] = D[lane / 4][2 (lane % 4) +
// e]).
__device__ __forceinline__ void mma_f64(double* d, double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// Elements k and k + 1 of row ``row`` of a [t, cb] bf16 matrix in global
// memory as a bf16 pair (zeros past t and cb): a lane's word of an mma
// fragment whose k axis is Cb.
__device__ __forceinline__ unsigned row_pair(const bf16* rows, int row, int k, int t, int cb) {
  const bf16* p = rows + (int64_t)row * cb + k;
  const float x = row < t && k < cb ? to_f32(p[0]) : 0.f;
  const float y = row < t && k + 1 < cb ? to_f32(p[1]) : 0.f;
  return pack_bf16(x, y);
}

// A warp's own rows' operand of the score product (16 MT rows from r0 =
// its first row + lane / 4 of a [t, cb] matrix in global memory): the
// first R k steps, which cover Cb up to 32 (16 for f32 at MT 2), held in
// registers for an item; any further step is loaded from global memory
// where it is used.
template <typename T, int MT>
struct RowFrags;
// bf16: the m16n8k16 A fragments, rows r0 + 16 mt + 8 (e & 1), k 16 kk +
// 8 (e >> 1) + 2 (lane % 4) and + 1
template <int MT>
struct RowFrags<bf16, MT> {
  static constexpr int R = 2;
  unsigned a[MT][R][4];
  __device__ static unsigned frag(const bf16* rows, int r0, int t, int cb, int tq, int mt, int kk,
                                  int e) {
    return row_pair(rows, r0 + 16 * mt + 8 * (e & 1), 16 * kk + 8 * (e >> 1) + 2 * tq, t, cb);
  }
  __device__ void load(const bf16* rows, int r0, int t, int cb, int lane) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int kk = 0; kk < R; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[mt][kk][e] = frag(rows, r0, t, cb, lane & 3, mt, kk, e);
  }
};
// f32: the m8n8k4 .f64 A values, rows r0 + 16 mt + 8 hh, k 4 kk + lane % 4
template <int MT>
struct RowFrags<float, MT> {
  static constexpr int R = MT == 1 ? 8 : 4;   // Cb up to 32, or 16 at MT 2
  float a[MT][2][R];   // f32, made f64 where used (half the registers)
  __device__ static float value(const float* rows, int row, int t, int cb, int k) {
    return row < t && k < cb ? rows[(int64_t)row * cb + k] : 0.f;
  }
  __device__ void load(const float* rows, int r0, int t, int cb, int lane) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int kk = 0; kk < R; ++kk)
          a[mt][hh][kk] = value(rows, r0 + 16 * mt + 8 * hh, t, cb, 4 * kk + (lane & 3));
  }
};

// The score tile of a warp's own rows (fr, or ``rows`` past its steps)
// against 16 keys (rows key0.. of ``key_rows``: the staged score rows at
// ``keys`` for the first L.staged steps; past them, in the WIDE instances
// a kernel takes at Cb > kStageCb, global memory): s[mt][nt] the C tile
// of rows 16 mt.. and keys 8 nt.., as the m16n8 layout holds it, k in
// order.  At Cb <= kStageCb every step is staged, and the kernels'
// instances without WIDE keep the global keys' loop out of their code.
// bf16: m16n8k16 on the tensor cores, each k step after the first summed
// apart and added in f32.
template <int MT, bool WIDE>
__device__ inline void score_tile(float (&s)[MT][2][4], const RowFrags<bf16, MT>& fr,
                                  const bf16* rows, int r0, const bf16* key_rows, int key0, int t,
                                  int cb, const unsigned char* keys, KLayout L, int lane) {
  constexpr int R = RowFrags<bf16, MT>::R;
  static_assert(16 * R <= kStageCb, "the register steps' keys are staged");
  const bf16* kp = reinterpret_cast<const bf16*>(keys) +
                   ((lane & 7) + 8 * ((lane >> 3) & 1)) * L.stride + 8 * (lane >> 4);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
  // one k step with the A fragments a[mt] and the keys' b
  // (b[0]: keys 0-7, k 0-7; b[1]: keys 8-15, k 0-7; b[2], b[3]: k 8-15)
  auto step = [&](int kk, const unsigned (&a)[MT][4], const unsigned (&b)[4]) {
    const unsigned b0[2] = {b[0], b[2]}, b1[2] = {b[1], b[3]};
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (kk == 0) {
        mma_bf16(s[mt][0], a[mt], b0);
        mma_bf16(s[mt][1], a[mt], b1);
      } else {
        float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(t0, a[mt], b0);
        mma_bf16(t1, a[mt], b1);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mt][0][e] += t0[e];
          s[mt][1][e] += t1[e];
        }
      }
    }
  };
#pragma unroll
  for (int kk = 0; kk < R; ++kk) {
    if (kk < L.steps) {
      unsigned a[MT][4], b[4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[mt][e] = fr.a[mt][kk][e];
      ldsm_x4(b, kp + 16 * kk);
      step(kk, a, b);
    }
  }
  // own rows from global memory, keys staged
  auto own = [&](int kk, unsigned (&a)[MT][4]) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        a[mt][e] = RowFrags<bf16, MT>::frag(rows, r0, t, cb, lane & 3, mt, kk, e);
  };
  for (int kk = R; kk < (WIDE ? L.staged : L.steps); ++kk) {
    unsigned a[MT][4], b[4];
    own(kk, a);
    ldsm_x4(b, kp + 16 * kk);
    step(kk, a, b);
  }
  // Cb past kStageCb: the keys from global memory too (matrix q: keys 8 (q
  // & 1).., k 8 (q >> 1)..; a lane holds its row lane / 4, columns 2
  // (lane % 4) and + 1)
  if constexpr (WIDE) {
    for (int kk = L.staged; kk < L.steps; ++kk) {
      unsigned a[MT][4], b[4];
      own(kk, a);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        b[q] = row_pair(key_rows, key0 + (lane >> 2) + 8 * (q & 1),
                        16 * kk + 8 * (q >> 1) + 2 * (lane & 3), t, cb);
      step(kk, a, b);
    }
  }
}
// f32: m8n8k4 .f64, the f32 values exact in f64
template <int MT, bool WIDE>
__device__ inline void score_tile(double (&s)[MT][2][4], const RowFrags<float, MT>& fr,
                                  const float* rows, int r0, const float* key_rows, int key0,
                                  int t, int cb, const unsigned char* keys, KLayout L, int lane) {
  using RF = RowFrags<float, MT>;
  constexpr int R = RF::R;
  static_assert(4 * R <= kStageCb, "the register steps' keys are staged");
  const double* kp = reinterpret_cast<const double*>(keys) + (lane >> 2) * L.stride + (lane & 3);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.0;
#pragma unroll
  for (int kk = 0; kk < R; ++kk) {
    if (kk < L.steps) {
      const double b0 = kp[4 * kk], b1 = kp[8 * L.stride + 4 * kk];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const double a = fr.a[mt][hh][kk];
          mma_f64(&s[mt][0][2 * hh], a, b0);
          mma_f64(&s[mt][1][2 * hh], a, b1);
        }
    }
  }
  // own rows from global memory with the keys' b0, b1 (keys 0-7, 8-15)
  auto step = [&](int kk, double b0, double b1) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const double a = RF::value(rows, r0 + 16 * mt + 8 * hh, t, cb, 4 * kk + (lane & 3));
        mma_f64(&s[mt][0][2 * hh], a, b0);
        mma_f64(&s[mt][1][2 * hh], a, b1);
      }
  };
  for (int kk = R; kk < (WIDE ? L.staged : L.steps); ++kk)
    step(kk, kp[4 * kk], kp[8 * L.stride + 4 * kk]);
  // Cb past kStageCb: the keys from global memory too
  if constexpr (WIDE) {
    for (int kk = L.staged; kk < L.steps; ++kk) {
      const int k = 4 * kk + (lane & 3), key = key0 + (lane >> 2);
      step(kk, RF::value(key_rows, key, t, cb, k), RF::value(key_rows, key + 8, t, cb, k));
    }
  }
}

// a = exp(d) / l from d = s - m (RowSoftmax): F32 (a kept in f32) takes the
// plain version's two steps, exp(d) times 1 / l; else the exponent folded
// with log2 l, as softmax_a (a is rounded to bf16 next).
template <bool F32>
__device__ __forceinline__ float softmax_diff(float d, float il_or_lg) {
  if constexpr (F32)
    return ex2(d * kLog2e) * il_or_lg;
  else
    return ex2(fmaf(d, kLog2e, -il_or_lg));
}

// The launchers (attention_general_fwd.cu, attention_general_bwd.cu), behind
// the entry points of attention.cu and attention_bwd.cu.  fwd: out [N, T, C]
// in the operands' dtype, or f32 with out_f32 (the streaming form).  bwd:
// dout in the operands' dtype, or f32 with dout_f32; scratch f32 of
// scratch_floats, the rho slices [bwd_rho_groups(C), N, T] then per_image
// df slices [N, T, Cb], with per_image blocks per image (at most ceil(T /
// bwd_rows(cb, f32 operands)); ops/attention.py:general_bwd_plan sizes
// both, and bwd refuses a scratch smaller than these slices).  Both return
// a cudaError (0: none).
// rows i of a tile of the ds kernel: 8 warps of 16, 4 with f32 operands
// at Cb > 32 (DsGeom)
__host__ __device__ inline int bwd_rows(int cb, bool f32) { return f32 && cb > 32 ? 64 : 128; }
// column groups of the dh kernel: one partial rho slice [N, T] each
__host__ __device__ inline int bwd_rho_groups(int c) { return c <= 128 ? 1 : (c + 255) / 256; }
int fwd(const void* f, const void* g, const void* h, void* out, void* m, void* l, int n, int t,
        int cb, int c, bool is_bf16, bool out_f32, cudaStream_t stream);
int bwd(const void* f, const void* g, const void* h, const void* dout, const void* m,
        const void* l, void* df, void* dg, void* dh, float* scratch, int64_t scratch_floats,
        int per_image, int n, int t, int cb, int c, bool is_bf16, bool dout_f32,
        cudaStream_t stream);

}  // namespace general
}  // namespace attn
}  // namespace msau
