// The attention at any width: every (Cb, C) without an instance of its own
// in attention.cu and attention_bwd.cu (those keep their tensor-core
// kernels for (1, 8), (2, 16), (4, 32), (8, 64), (16, 128), (32, 256)).
// Cb and C are runtime arguments here; nothing in these kernels holds a
// register array whose length is a width.
//
// The same semantics as the specialised kernels (s_ij = g_i . f_j, A =
// softmax over j with the saved m_i, l_i, out_j = sum_i A_ij h_i):
//
//   stats_kernel   m_i, l_i over every key j;
//   sweep_kernel   one of four sums over a second axis, each a
//                  [rows] x [columns] output tile of a block:
//     FWD  out_j = sum_i a_ij h_i       (rows j, chunks of rows i)
//     DH   dh_i  = sum_j a_ij dout_j    (rows i, chunks of keys j), and
//                  rho_i = h_i . dh_i over the block's columns
//     DG   dg_i  = sum_j ds_ij f_j      (rows i, chunks of keys j)
//     DF   df_j  = sum_i ds_ij g_i      (rows j, chunks of rows i)
//   with ds_ij = a_ij (h_i . dout_j - rho_i).
//
// Every product runs on the FP32 pipes from operands staged in shared
// memory as f32 (the f32 score product in f64: ScoreAcc): a simple kernel,
// not yet a fast one (the specialised instances put the wide products on
// the tensor cores).  bf16 operands are exact in f32, so the products are
// the ones the TPU kernels form; a (forward, dh) and ds (dg, df) are
// rounded to bf16 where the specialised kernels and the plain versions
// round them (bf16 output of the resident forward; a bf16 cotangent in the
// backward), and every other sum stays f32, each chunk's apart.
//
// Widths.  The score product s = g fᵀ (k = Cb) and h doutᵀ (k = C) are
// k-loops over pieces of kK columns staged in shared memory, the padded
// columns zero: they add exact zeros to each dot, whose order is k = 0, 1,
// ... in every kernel, so the stats, the forward and the three backward
// sweeps see the same bits of s and u.  The output columns are groups of
// kGroup (a template constant); a block holds GPB groups of its rows in
// registers (4 x 4 values a thread per group) and the grid's y axis takes
// the rest of the columns: a block of fewer groups recomputes the scores
// (and the exponentials, and in DG / DF h doutᵀ) for each of its column
// blocks.  The forward runs GPB 1 (the grid takes every group) or the
// fewest of 1, 2, 4 groups that cover C (the block loops over its groups
// on one A tile staged in shared memory), by fwd_groups; the backward's dh
// sweep takes the latter, and since rho needs the whole row it writes one
// partial rho per column block, [blocks, N, T] f32, which dg and df add in
// block order.  dg and df take GPB 1 (Cb is C / 8 in the model).
//
// Ragged edges: rows and columns past T, Cb or C stage as zeros, a is
// forced to 0 where i or j lies past T, and nothing past an edge is
// written.  No atomics: a rerun gives the same bits.
#pragma once

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_mma.cuh"

namespace msau {
namespace attn {
namespace general {

constexpr int kThreads = 256;
constexpr int kRows = 64;     // a block's rows r
constexpr int kQ = 32;        // rows q of the summed axis per chunk
constexpr int kK = 32;        // columns of a staged piece of the k-loops
// a staged piece's row stride, in its elements: f32 rows of kK + 4 (16-byte
// rows, a quarter warp's 16-byte loads on distinct banks), f64 rows of
// kK + 2 (likewise); the buffers hold either
template <typename D>
constexpr int kPieceStride = std::is_same<D, double>::value ? kK + 2 : kK + 4;
constexpr int kRBytes = kRows * (kK + 4) * 8;   // a staged R piece, f32 or f64
constexpr int kQBytes = kQ * (kK + 4) * 8;
constexpr int kVS = kRows + 4;
constexpr int kGroup = 64;    // output columns of a group

enum Mode { FWD, DH, DG, DF };

// groups of kGroup columns a block holds: the fewest of 1, 2, 4 that cover
// c, at most 4 (ops/attention.py:general_bwd_groups mirrors it)
inline int loop_groups(int c) { return c <= kGroup ? 1 : c <= 2 * kGroup ? 2 : 4; }

// Rows [r0, r0 + nrows) x columns [k0, k0 + kK) of a [t, w] row-major
// matrix into dst[nrows][kPieceStride<D>] as D (f32, or f64 converted once
// here rather than by every thread that reads it); zeros past t and w.
template <typename D, typename S>
__device__ __forceinline__ void stage_piece(D* dst, const S* src, int r0, int nrows, int t, int w,
                                            int k0) {
  for (int e = threadIdx.x; e < nrows * kK; e += kThreads) {
    const int r = e / kK, k = e % kK;
    dst[r * kPieceStride<D> + k] =
        (D)(r0 + r < t && k0 + k < w ? to_f32(src[(int64_t)(r0 + r) * w + k0 + k]) : 0.f);
  }
}

// 4 consecutive staged values (16-byte aligned)
__device__ __forceinline__ void load4(float (&v)[4], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(double (&v)[4], const double* p) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// acc[a][b] += the staged piece's dot of rows R[tr + 16 a] and Q[tq + 16 b],
// k in order, in Acc (f32, or f64 for the f32 score product)
template <typename Acc>
__device__ __forceinline__ void piece_fma(Acc (&acc)[4][2], const Acc* R, const Acc* Q, int tr,
                                          int tq) {
  constexpr int S = kPieceStride<Acc>;
#pragma unroll 2
  for (int k = 0; k < kK; k += 4) {
    Acc x[4][4], y[2][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) load4(x[a], R + (tr + 16 * a) * S + k);
#pragma unroll
    for (int b = 0; b < 2; ++b) load4(y[b], Q + (tq + 16 * b) * S + k);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        Acc s = acc[a][b];
#pragma unroll
        for (int i = 0; i < 4; ++i) s = fma(x[a][i], y[b][i], s);
        acc[a][b] = s;
      }
  }
}

// acc[a][b] = the dot over all w columns of rows r0 + tr + 16 a of R and
// q0 + tq + 16 b of Q ([t, w] matrices), through the pieces staged as Acc
// in the buffers s_r (kRBytes) and s_q (kQBytes); the block's threads all
// call it (it synchronises)
template <typename Acc, typename SR, typename SQ>
__device__ __forceinline__ void tile_dot(Acc (&acc)[4][2], void* s_r, void* s_q, const SR* R,
                                         int r0, const SQ* Q, int q0, int t, int w, int tr,
                                         int tq) {
  Acc* pr = reinterpret_cast<Acc*>(s_r);
  Acc* pq = reinterpret_cast<Acc*>(s_q);
#pragma unroll
  for (int a = 0; a < 4; ++a) acc[a][0] = acc[a][1] = 0;
  for (int k0 = 0; k0 < w; k0 += kK) {
    __syncthreads();   // the last piece is consumed
    stage_piece(pr, R, r0, kRows, t, w, k0);
    stage_piece(pq, Q, q0, kQ, t, w, k0);
    __syncthreads();
    piece_fma(acc, pr, pq, tr, tq);
  }
}

// The score product's sums: double for f32 operands, so that s - m
// reaches the exponent with f32's precision (a score of 40 summed in f32
// is off by a few of its ulps, 4e-6 each, and exp(s - m) by as much: at N
// 16, T 4096, Cb 12 that put the f32 output 3.5e-5 from the float64
// answer); f32 for bf16 operands, whose products are exact in f32 and
// whose plain versions sum in f32.
template <typename T>
using ScoreAcc = typename std::conditional<std::is_same<T, float>::value, double, float>::type;

// a = exp(d) / l from d = s - m (RowSoftmax: F32 takes 1 / l, else the
// folded exponent with log2 l, as softmax_a)
template <bool F32>
__device__ __forceinline__ float a_from_diff(float d, const RowSoftmax& r) {
  if constexpr (F32)
    return ex2(d * kLog2e) * r.il;
  else
    return ex2(fmaf(d, kLog2e, -r.lg));
}

constexpr int kStatsSmem = kRBytes + kQBytes + kRows * 16 * 2 * 4;

// m_i, l_i of rows [64 x, 64 x + 64) of image z
template <typename T>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const T* __restrict__ f, const T* __restrict__ g, float* __restrict__ m_out,
             float* __restrict__ l_out, int t, int cb) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* s_r = smem;
  unsigned char* s_q = s_r + kRBytes;
  float* s_merge = reinterpret_cast<float*>(s_q + kQBytes);   // [kRows][16][m, l]
  const int n = blockIdx.z, r0 = blockIdx.x * kRows;
  const int tr = threadIdx.x & 15, tq = threadIdx.x >> 4;
  const T* fn = f + (int64_t)n * t * cb;
  const T* gn = g + (int64_t)n * t * cb;
  float mrun[4], lrun[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) mrun[a] = -INFINITY, lrun[a] = 0.f;
  using Acc = ScoreAcc<T>;
  for (int q0 = 0; q0 < t; q0 += kQ) {
    Acc s[4][2];
    tile_dot(s, s_r, s_q, gn, r0, fn, q0, t, cb, tr, tq);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const Acc v0 = q0 + tq < t ? s[a][0] : (Acc)-INFINITY;
      const Acc v1 = q0 + tq + 16 < t ? s[a][1] : (Acc)-INFINITY;
      // m is the largest score rounded to f32, as the output holds it
      const float mt = (float)(v0 > v1 ? v0 : v1);
      float& m = mrun[a];
      float& l = lrun[a];
      if (mt > -INFINITY) {
        if (mt > m) {
          l *= __expf(m - mt);   // m = -inf: l is 0 and stays 0
          m = mt;
        }
        l += ex2((float)(v0 - (Acc)m) * kLog2e) + ex2((float)(v1 - (Acc)m) * kLog2e);
      }
    }
  }
  // the 16 threads of each row merge in a fixed order
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    s_merge[((tr + 16 * a) * 16 + tq) * 2] = mrun[a];
    s_merge[((tr + 16 * a) * 16 + tq) * 2 + 1] = lrun[a];
  }
  __syncthreads();
  const int r = threadIdx.x;
  if (r < kRows && r0 + r < t) {
    float m = -INFINITY, l = 0.f;
    for (int k = 0; k < 16; ++k) {
      const float mo = s_merge[(r * 16 + k) * 2], lo = s_merge[(r * 16 + k) * 2 + 1];
      const float mn = fmaxf(m, mo);
      l = (m == -INFINITY ? 0.f : l * __expf(m - mn)) + (mo == -INFINITY ? 0.f : lo * __expf(mo - mn));
      m = mn;
    }
    m_out[(int64_t)n * t + r0 + r] = m;
    l_out[(int64_t)n * t + r0 + r] = l;
  }
}

template <int GPB>
constexpr int sweep_smem() {
  return kRBytes + kQBytes + (kQ * kVS + kQ * (GPB * kGroup + 4) + 3 * kRows) * 4;
}

// One of the four sums (Mode) for rows [64 x, 64 x + 64), the y-th block of
// GPB groups of output columns, image z.  T: f, g, h; TD: dout; TO: the
// output (FWD: out; DH: dh; DG: dg; DF: df).  rho_part: [gridDim.y, N, T]
// partial rho, written by DH and read (rho_groups slices) by DG and DF.
template <Mode M, typename T, typename TD, typename TO, int GPB>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const T* __restrict__ f, const T* __restrict__ g, const T* __restrict__ h,
             const TD* __restrict__ dout, const float* __restrict__ m_in,
             const float* __restrict__ l_in, float* __restrict__ rho_part, int rho_groups,
             TO* __restrict__ out, int t, int cb, int c) {
  constexpr bool kRowsAreI = M == DH || M == DG;   // else rows are j and chunks i
  constexpr bool kUsesU = M == DG || M == DF;
  // a (FWD, DH) or ds (DG, DF) rounded to bf16 before its product
  constexpr bool kRound = M == FWD ? std::is_same<TO, bf16>::value : std::is_same<TD, bf16>::value;
  constexpr int XW = GPB * kGroup, XS = XW + 4;
  using TX = typename std::conditional<M == DH, TD, T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* s_r = smem;         // a staged piece of rows r (tile_dot)
  unsigned char* s_q = s_r + kRBytes;  // and of chunk rows q
  float* s_v = reinterpret_cast<float*>(s_q + kQBytes);  // [kQ][kVS]: a or ds, q major
  float* s_x = s_v + kQ * kVS;       // [kQ][XS]: the summed operand's rows
  float* s_c = s_x + kQ * XS;        // [3][kRows]: m, 1/l or log2 l, rho of rows i

  const int n = blockIdx.z, r0 = blockIdx.x * kRows, col0 = blockIdx.y * XW;
  const int n_batch = gridDim.z;
  const int w = M == FWD || M == DH ? c : cb;   // output columns
  const int tr = threadIdx.x & 15, tq = threadIdx.x >> 4;   // the score tile's rows, columns
  const int cx = threadIdx.x & 15, ry = threadIdx.x >> 4;   // the output tile's
  const T* fn = f + (int64_t)n * t * cb;
  const T* gn = g + (int64_t)n * t * cb;
  const T* hn = h + (int64_t)n * t * c;
  const TD* dn = dout + (int64_t)n * t * c;
  const TX* xn;
  if constexpr (M == FWD)
    xn = hn;
  else if constexpr (M == DH)
    xn = dn;
  else if constexpr (M == DG)
    xn = fn;
  else
    xn = gn;

  // the softmax constants (and rho) of rows i [i0, i0 + count) into s_c
  auto stage_consts = [&](int i0, int count) {
    for (int e = threadIdx.x; e < count; e += kThreads) {
      const int i = i0 + e;
      const float mv = i < t ? m_in[(int64_t)n * t + i] : 0.f;
      const float lv = i < t ? l_in[(int64_t)n * t + i] : 0.f;
      const RowSoftmax rs = row_softmax(mv, lv);
      s_c[e] = mv;
      s_c[kRows + e] = kRound ? rs.lg : rs.il;
      if constexpr (kUsesU) {
        float rho = 0.f;
        if (i < t)
          for (int z = 0; z < rho_groups; ++z) rho += rho_part[((int64_t)z * n_batch + n) * t + i];
        s_c[2 * kRows + e] = rho;
      }
    }
  };

  float acc[GPB][4][4];
#pragma unroll
  for (int gp = 0; gp < GPB; ++gp)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[gp][a][b] = 0.f;

  if constexpr (kRowsAreI) stage_consts(r0, kRows);
  for (int q0 = 0; q0 < t; q0 += kQ) {
    if constexpr (!kRowsAreI) {
      __syncthreads();   // the last chunk's constants are consumed
      stage_consts(q0, kQ);
    }
    // s[a][b] for rows r0 + tr + 16 a, chunk rows q0 + tq + 16 b
    ScoreAcc<T> s[4][2];
    float u[4][2];
    if constexpr (kRowsAreI)
      tile_dot(s, s_r, s_q, gn, r0, fn, q0, t, cb, tr, tq);
    else
      tile_dot(s, s_r, s_q, fn, r0, gn, q0, t, cb, tr, tq);
    if constexpr (M == DG) tile_dot(u, s_r, s_q, hn, r0, dn, q0, t, c, tr, tq);
    if constexpr (M == DF) tile_dot(u, s_r, s_q, dn, r0, hn, q0, t, c, tr, tq);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int r = tr + 16 * a, q = tq + 16 * b;
        const int ci = kRowsAreI ? r : q;   // row i's slot in s_c
        const RowSoftmax rs = {s_c[ci], s_c[kRows + ci], s_c[kRows + ci]};
        float v = a_from_diff<!kRound>((float)(s[a][b] - (ScoreAcc<T>)rs.m), rs);
        if constexpr (kUsesU) v *= u[a][b] - s_c[2 * kRows + ci];
        if constexpr (kRound) v = round_to<bf16>(v);
        if (r0 + r >= t || q0 + q >= t) v = 0.f;
        s_v[q * kVS + r] = v;
      }
    for (int e = threadIdx.x; e < kQ * XW; e += kThreads) {
      const int q = e / XW, col = e % XW;
      s_x[q * XS + col] =
          q0 + q < t && col0 + col < w ? to_f32(xn[(int64_t)(q0 + q) * w + col0 + col]) : 0.f;
    }
    __syncthreads();
    // the chunk's kQ products summed apart, then added to the running sum:
    // one long f32 chain over T rows would drift by sqrt(T) roundings of
    // the sum (0.6 of the f32 tolerance at T 4096, by a host emulation)
    float part[GPB][4][4];
#pragma unroll
    for (int gp = 0; gp < GPB; ++gp)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) part[gp][a][b] = 0.f;
#pragma unroll 4
    for (int q = 0; q < kQ; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(s_v + q * kVS + 4 * ry);
      const float va[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int gp = 0; gp < GPB; ++gp) {
        const float4 x = *reinterpret_cast<const float4*>(s_x + q * XS + gp * kGroup + 4 * cx);
        const float xa[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) part[gp][a][b] = fmaf(va[a], xa[b], part[gp][a][b]);
      }
    }
#pragma unroll
    for (int gp = 0; gp < GPB; ++gp)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[gp][a][b] += part[gp][a][b];
  }

  TO* on = out + (int64_t)n * t * w;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = r0 + 4 * ry + a;
    if (row >= t) continue;
#pragma unroll
    for (int gp = 0; gp < GPB; ++gp)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int col = col0 + gp * kGroup + 4 * cx + b;
        if (col < w) store(on + (int64_t)row * w + col, acc[gp][a][b]);
      }
  }
  if constexpr (M == DH) {
    // rho_i over this block's columns: each thread's in column order, then
    // the 16 threads of a row in a fixed order (s_r is free again)
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = r0 + 4 * ry + a;
      float p = 0.f;
      if (row < t) {
#pragma unroll
        for (int gp = 0; gp < GPB; ++gp)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int col = col0 + gp * kGroup + 4 * cx + b;
            if (col < w) p = fmaf(to_f32(hn[(int64_t)row * c + col]), acc[gp][a][b], p);
          }
      }
      reinterpret_cast<float*>(s_r)[(4 * ry + a) * 16 + cx] = p;
    }
    __syncthreads();
    const int r = threadIdx.x;
    if (r < kRows && r0 + r < t) {
      float p = 0.f;
      for (int k = 0; k < 16; ++k) p += reinterpret_cast<const float*>(s_r)[r * 16 + k];
      rho_part[((int64_t)blockIdx.y * n_batch + n) * t + r0 + r] = p;
    }
  }
}

inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

template <Mode M, typename T, typename TD, typename TO, int GPB>
int launch_sweep(const void* f, const void* g, const void* h, const void* dout, const void* m,
                 const void* l, float* rho_part, int rho_groups, void* out, int n, int t, int cb,
                 int c, cudaStream_t stream) {
  auto kernel = sweep_kernel<M, T, TD, TO, GPB>;
  constexpr int smem = sweep_smem<GPB>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int w = M == FWD || M == DH ? c : cb;
  const dim3 grid((t + kRows - 1) / kRows, (w + GPB * kGroup - 1) / (GPB * kGroup), n);
  kernel<<<grid, kThreads, smem, stream>>>((const T*)f, (const T*)g, (const T*)h, (const TD*)dout,
                                           (const float*)m, (const float*)l, rho_part, rho_groups,
                                           (TO*)out, t, cb, c);
  return (int)cudaGetLastError();
}

template <Mode M, typename T, typename TD, typename TO>
int launch_sweep_groups(int gpb, const void* f, const void* g, const void* h, const void* dout,
                        const void* m, const void* l, float* rho_part, int rho_groups, void* out,
                        int n, int t, int cb, int c, cudaStream_t stream) {
  if (gpb == 1)
    return launch_sweep<M, T, TD, TO, 1>(f, g, h, dout, m, l, rho_part, rho_groups, out, n, t, cb,
                                         c, stream);
  if (gpb == 2)
    return launch_sweep<M, T, TD, TO, 2>(f, g, h, dout, m, l, rho_part, rho_groups, out, n, t, cb,
                                         c, stream);
  if (gpb == 4)
    return launch_sweep<M, T, TD, TO, 4>(f, g, h, dout, m, l, rho_part, rho_groups, out, n, t, cb,
                                         c, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_stats(const void* f, const void* g, void* m, void* l, int n, int t, int cb,
                 cudaStream_t stream) {
  auto kernel = stats_kernel<T>;
  cudaError_t err = allow_smem(kernel, kStatsSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((t + kRows - 1) / kRows, 1, n), kThreads, kStatsSmem, stream>>>(
      (const T*)f, (const T*)g, (float*)m, (float*)l, t, cb);
  return (int)cudaGetLastError();
}

}  // namespace general
}  // namespace attn
}  // namespace msau
