// Resident exact-softmax attention, forward, with the MSAU semantics:
//   s_ij = g_i . f_j        (no 1/sqrt(d) scaling)
//   A_ij = exp(s_ij - m_i) / l_i,  m_i = max_j s_ij,  l_i = sum_j exp(s_ij - m_i)
//   out_j = sum_i A_ij h_i   (the softmax runs over j, the sum over i: the
//                             transpose of standard attention)
// f, g: [N, T, Cb]; h, out: [N, T, C]; f32 or bf16 in, f32 arithmetic, out
// in h's dtype.  m and l ([N, T] f32) are written for the backward.
//
// Replaces the TPU kernel msau_tpu/ops/pallas_attn.py:_res_fwd_kernel
// (launcher _resident_forward).  That kernel computes whole score rows
// s[i_blk, :] per grid step and carries the [T, C] output in VMEM across a
// SEQUENTIAL grid (o_ref += A^T h_blk).  Hopper blocks run in no order, so
// that carry does not translate.
//
// What bounds it on the H100: at the flagship (T = 4096, Cb = 8, C = 64)
// the operands are 2.6 MiB, but the T x T scores are 16.7 M exponentials
// and the A^T h product is 2.1 GFLOP; the scores must never reach HBM.
// With Cb = 8 the score product is too thin for tensor cores to pay, and
// f32 accuracy (1e-5) rules out TF32, so this kernel runs on the FP32
// pipes: the A^T h product (1.07 G FMA, about 36 us at the card's FP32
// peak) bounds it, and shared-memory loads are what keeps it off that peak.
//
// Design: three launches, no atomics, so the result is deterministic.
//  (a) stats_kernel: 16 threads per query row i; each takes every 16th key
//      j of 256-key f tiles staged in shared memory, keeps its tile's
//      scores in registers, and updates a running (max, sum-exp) once per
//      tile; the 16 partials merge in a fixed shuffle order.
//  (b) accum_kernel: a block owns 64 output rows j and one of `splits`
//      contiguous ranges of i.  Per 64-row i tile it recomputes s_ij (Cb
//      FMAs, f_j held in registers), forms A_ij in shared memory, and
//      accumulates A^T h into a 4 x C/8 register tile per thread (32 FMAs
//      per 3 shared loads at C = 64).  Splitting i fills the card (64 row
//      tiles alone would use half the SMs at T = 4096); each split writes
//      its own f32 partial.
//  (c) combine_kernel: sums the partials in split order and casts to the
//      output dtype.
// The ragged edge of T is masked in every pass: missing keys score -inf in
// (a); missing rows have g = h = 0 and 1/l = 0 in (b).  Scores are
// recomputed in (b) rather than stored: 2 x 16.7 M Cb-wide dots cost less
// than writing and re-reading a 64 MiB score matrix.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using msau::store;
using msau::to_f32;

// pass (a)
constexpr int kStatsThreads = 256;
constexpr int kStatsLanes = 16;                        // threads per row
constexpr int kStatsRows = kStatsThreads / kStatsLanes;  // 16 rows per block
constexpr int kStatsTileJ = 256;                       // keys per tile
constexpr int kKeysPerLane = kStatsTileJ / kStatsLanes;
// pass (b)
constexpr int kAccThreads = 128;
constexpr int kAccJ = 64;          // output rows per block
constexpr int kColGroups = 8;      // threads across the C columns
constexpr int kRowsPerThread = kAccJ / (kAccThreads / kColGroups);  // 4

template <typename T, int CB>
__global__ void __launch_bounds__(kStatsThreads)
stats_kernel(const T* __restrict__ f, const T* __restrict__ g,
             float* __restrict__ m_out, float* __restrict__ l_out, int t) {
  __shared__ float s_f[kStatsTileJ][CB + 1];  // +1: conflict-free rows
  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % kStatsLanes;
  const int i = blockIdx.x * kStatsRows + tid / kStatsLanes;
  const T* fn = f + (int64_t)n * t * CB;
  const T* gn = g + (int64_t)n * t * CB;

  float gi[CB];
#pragma unroll
  for (int k = 0; k < CB; ++k)
    gi[k] = i < t ? to_f32(gn[(int64_t)i * CB + k]) : 0.f;

  float m = -INFINITY, l = 0.f;
  for (int j0 = 0; j0 < t; j0 += kStatsTileJ) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < kStatsTileJ * CB; e += kStatsThreads) {
      const int jj = e / CB, k = e % CB;
      s_f[jj][k] = j0 + jj < t ? to_f32(fn[(int64_t)(j0 + jj) * CB + k]) : 0.f;
    }
    __syncthreads();
    const int jn = min(kStatsTileJ, t - j0);
    float s[kKeysPerLane];
    float mt = -INFINITY;
#pragma unroll
    for (int q = 0; q < kKeysPerLane; ++q) {
      const int jj = lane + q * kStatsLanes;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < CB; ++k) acc = fmaf(gi[k], s_f[jj][k], acc);
      s[q] = jj < jn ? acc : -INFINITY;
      mt = fmaxf(mt, s[q]);
    }
    if (mt > -INFINITY) {
      if (mt > m) {
        l *= expf(m - mt);  // m = -inf: l is 0 and stays 0
        m = mt;
      }
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < kKeysPerLane; ++q) acc += expf(s[q] - m);
      l += acc;
    }
  }
  // merge the 16 lanes of this row in a fixed order (deterministic)
#pragma unroll
  for (int off = 1; off < kStatsLanes; off <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float lo = __shfl_xor_sync(0xffffffffu, l, off);
    const float mn = fmaxf(m, mo);
    l = (m == -INFINITY ? 0.f : l * expf(m - mn)) +
        (mo == -INFINITY ? 0.f : lo * expf(mo - mn));
    m = mn;
  }
  if (lane == 0 && i < t) {
    m_out[(int64_t)n * t + i] = m;
    l_out[(int64_t)n * t + i] = l;
  }
}

template <typename T, int CB, int C>
__global__ void __launch_bounds__(kAccThreads)
accum_kernel(const T* __restrict__ f, const T* __restrict__ g,
             const T* __restrict__ h, const float* __restrict__ m_in,
             const float* __restrict__ l_in, float* __restrict__ partial,
             int t, int n_batch) {
  constexpr int BI = C >= 128 ? 32 : 64;     // i rows per tile (smem budget)
  constexpr int RC = C / kColGroups;         // columns per thread
  static_assert(C % kColGroups == 0, "C must be a multiple of 8");
  __shared__ __align__(16) float s_gi[BI][CB];
  __shared__ __align__(16) float s_h[BI][C];
  __shared__ __align__(16) float s_a[BI][kAccJ];
  __shared__ float s_m[BI];
  __shared__ float s_il[BI];

  const int n = blockIdx.z;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kAccJ;
  const int tj = tid / kColGroups;   // rows tj*4 .. tj*4+3 of the j tile
  const int tc = tid % kColGroups;   // columns tc*RC .. tc*RC+RC-1
  const T* fn = f + (int64_t)n * t * CB;
  const T* gn = g + (int64_t)n * t * CB;
  const T* hn = h + (int64_t)n * t * C;

  // this split's contiguous range of i tiles
  const int n_tiles = (t + BI - 1) / BI;
  const int tile0 = (int)((int64_t)n_tiles * split / splits);
  const int tile1 = (int)((int64_t)n_tiles * (split + 1) / splits);

  // score phase: this thread always takes output row js of the tile, so
  // its f_j lives in registers
  const int js = tid % kAccJ;
  float fj[CB];
#pragma unroll
  for (int k = 0; k < CB; ++k)
    fj[k] = j0 + js < t ? to_f32(fn[(int64_t)(j0 + js) * CB + k]) : 0.f;
  float acc[kRowsPerThread][RC];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
    for (int q = 0; q < RC; ++q) acc[r][q] = 0.f;

  for (int tile = tile0; tile < tile1; ++tile) {
    const int i0 = tile * BI;
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < BI * CB; e += kAccThreads) {
      const int ii = e / CB, k = e % CB;
      s_gi[ii][k] = i0 + ii < t ? to_f32(gn[(int64_t)(i0 + ii) * CB + k]) : 0.f;
    }
    for (int e = tid; e < BI * C; e += kAccThreads) {
      const int ii = e / C, cc = e % C;
      s_h[ii][cc] = i0 + ii < t ? to_f32(hn[(int64_t)(i0 + ii) * C + cc]) : 0.f;
    }
    for (int ii = tid; ii < BI; ii += kAccThreads) {
      const bool ok = i0 + ii < t;
      s_m[ii] = ok ? m_in[(int64_t)n * t + i0 + ii] : 0.f;
      s_il[ii] = ok ? 1.f / l_in[(int64_t)n * t + i0 + ii] : 0.f;
    }
    __syncthreads();
    for (int ii = tid / kAccJ; ii < BI; ii += kAccThreads / kAccJ) {
      // a warp shares ii: the g row is a broadcast (vector) load
      float gv[CB];
      if constexpr (CB % 4 == 0) {
#pragma unroll
        for (int k = 0; k < CB; k += 4) {
          const float4 g4 = *reinterpret_cast<const float4*>(&s_gi[ii][k]);
          gv[k] = g4.x; gv[k + 1] = g4.y; gv[k + 2] = g4.z; gv[k + 3] = g4.w;
        }
      } else {
#pragma unroll
        for (int k = 0; k < CB; ++k) gv[k] = s_gi[ii][k];
      }
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < CB; ++k) s = fmaf(gv[k], fj[k], s);
      // masked rows have g = 0 (s = 0, m = 0) and 1/l = 0: A = 0
      s_a[ii][js] = expf(s - s_m[ii]) * s_il[ii];
    }
    __syncthreads();
#pragma unroll 4
    for (int ii = 0; ii < BI; ++ii) {
      const float4 a = *reinterpret_cast<const float4*>(&s_a[ii][tj * kRowsPerThread]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float hv[RC];
      if constexpr (RC % 4 == 0) {
#pragma unroll
        for (int q = 0; q < RC; q += 4) {
          const float4 h4 = *reinterpret_cast<const float4*>(&s_h[ii][tc * RC + q]);
          hv[q] = h4.x; hv[q + 1] = h4.y; hv[q + 2] = h4.z; hv[q + 3] = h4.w;
        }
      } else {
#pragma unroll
        for (int q = 0; q < RC; ++q) hv[q] = s_h[ii][tc * RC + q];
      }
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
        for (int q = 0; q < RC; ++q) acc[r][q] = fmaf(av[r], hv[q], acc[r][q]);
    }
  }
  float* pn = partial + ((int64_t)split * n_batch + n) * t * C;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int j = j0 + tj * kRowsPerThread + r;
    if (j < t) {
#pragma unroll
      for (int q = 0; q < RC; ++q) pn[(int64_t)j * C + tc * RC + q] = acc[r][q];
    }
  }
}

template <typename T>
__global__ void combine_kernel(const float* __restrict__ partial,
                               T* __restrict__ out, int64_t count, int splits) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[k * count + e];
  store(out + e, s);
}

template <typename T, int CB, int C>
int launch(const void* f, const void* g, const void* h, void* out, void* m,
           void* l, void* partial, int splits, int n, int t,
           cudaStream_t stream) {
  dim3 grid_a((t + kStatsRows - 1) / kStatsRows, n);
  stats_kernel<T, CB><<<grid_a, kStatsThreads, 0, stream>>>(
      (const T*)f, (const T*)g, (float*)m, (float*)l, t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_b((t + kAccJ - 1) / kAccJ, splits, n);
  accum_kernel<T, CB, C><<<grid_b, kAccThreads, 0, stream>>>(
      (const T*)f, (const T*)g, (const T*)h, (const float*)m, (const float*)l,
      (float*)partial, t, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t count = (int64_t)n * t * C;
  combine_kernel<T><<<(unsigned)((count + 255) / 256), 256, 0, stream>>>(
      (const float*)partial, (T*)out, count, splits);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* f, const void* g, const void* h, void* out, void* m,
             void* l, void* partial, int splits, int n, int t, int cb, int c,
             cudaStream_t stream) {
  // the model's projections have Cb = max(C / 8, 1)
#define MSAU_ATTN_CASE(CB_, C_)                                              \
  if (cb == CB_ && c == C_)                                                  \
    return launch<T, CB_, C_>(f, g, h, out, m, l, partial, splits, n, t, stream);
  MSAU_ATTN_CASE(1, 8)
  MSAU_ATTN_CASE(2, 16)
  MSAU_ATTN_CASE(4, 32)
  MSAU_ATTN_CASE(8, 64)
  MSAU_ATTN_CASE(16, 128)
#undef MSAU_ATTN_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// partial: [splits, N, T, C] f32 scratch, allocated by the caller.
extern "C" int msau_resident_attention_fwd(const void* f, const void* g,
                                           const void* h, void* out, void* m,
                                           void* l, void* partial, int splits,
                                           int n, int t, int cb, int c,
                                           int is_bf16, void* stream) {
  if (n <= 0 || t <= 0) return 0;
  if (splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? dispatch<__nv_bfloat16>(f, g, h, out, m, l, partial, splits,
                                           n, t, cb, c, s)
                 : dispatch<float>(f, g, h, out, m, l, partial, splits, n, t,
                                   cb, c, s);
}
