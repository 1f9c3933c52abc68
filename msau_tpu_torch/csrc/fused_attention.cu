// Streaming exact-softmax attention, forward, with the MSAU semantics:
//   s_ij = g_i . f_j        (no 1/sqrt(d) scaling)
//   A_ij = exp(s_ij - m_i) / l_i,  m_i = max_j s_ij,  l_i = sum_j exp(s_ij - m_i)
//   out_j = sum_i A_ij h_i   (the softmax runs over j, the sum over i: the
//                             transpose of standard attention)
// f, g: [N, T, Cb]; h: [N, T, C]; f32 or bf16 in, upcast at entry, f32
// arithmetic and an F32 OUTPUT whatever the operands' type.  m and l
// ([N, T] f32) are written for the backward.
//
// Replaces the TPU kernel pair msau_tpu/ops/pallas_attn.py:_stats_kernel and
// :_accum_kernel (launcher _fused_forward), the path the model takes at
// T >= 8192 tokens (1024^2 pages: T = 16384, Cb = 8, C = 64).  Both Pallas
// kernels revisit an output block across a SEQUENTIAL inner grid axis (the
// online (m, l), then out_j +=); Hopper blocks run in no order, so here a loop
// inside the block takes that axis' place.
//
// What bounds it on the H100: at T = 16384 the operands are 9.4 MiB per image
// but there are 268 M scores, each needing Cb FMAs and an exponential in both
// passes, and A^T h is 17.2 G FMA per image; the scores must never reach HBM.
// With Cb = 8 the score product is too thin for tensor cores to pay and f32
// accuracy (1e-5) rules out TF32, so the kernel runs on the FP32 pipes and
// the A^T h product bounds it.  What keeps a kernel off that peak is every
// instruction that is not one of its FMAs, so both passes hold register
// tiles fed by 16-byte shared-memory loads:
//  (a) stream_stats_kernel: 16 lanes share 4 query rows (g in registers) and
//      stream 256-key tiles of f^T from shared memory; a lane holds a 4 x 16
//      score tile (16 FMAs per load) and updates each row's running
//      (max, sum-exp) once per tile; the lanes merge in a fixed shuffle order.
//  (b) stream_accum_kernel: a block owns 128 output rows j (64 at C = 128)
//      and one of `splits` contiguous ranges of i.  Per 32-row i tile it
//      recomputes s_ij (each thread two keys, f_j in registers; a row's g, m
//      and 1/l arrive in one broadcast load), forms A in shared memory, and
//      accumulates A^T h into an 8 x C/8 register tile per thread (64 FMAs
//      per 4 loads at C = 64).  The 128-row tile halves what each block
//      re-reads of g and h against a 64-row one.  The launch bounds hold it
//      at 128 registers (8 of them spilled at C = 64), so four blocks share
//      an SM (at 153 registers three did, and the 512 blocks of N = 2,
//      T = 16384 took a second wave).
//      Each split writes its own f32 slice; with one split that slice is the
//      output.
//  (c) stream_combine_kernel: sums the slices in split order (no atomics, so
//      the result is deterministic).
// exp is __expf (ex2.approx of x log2 e): its absolute error on
// exp(s - m) <= 1 stays below 1e-6 (the argument's rounding costs
// |x| 6e-8 e^x <= 3e-8), and it is a fifth of expf's instructions.
// The ragged edge of T is masked in every pass: missing keys score -inf in
// (a); missing rows have g = h = 0 and 1/l = 0 in (b).

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using msau::load_row;
using msau::to_f32;

// pass (a)
constexpr int kStatsThreads = 128;
constexpr int kStatsLanes = 16;   // threads sharing a group of rows
constexpr int kStatsRI = 4;       // rows per thread
constexpr int kStatsRows = kStatsThreads / kStatsLanes * kStatsRI;  // 32 per block
constexpr int kStatsTileJ = 256;  // keys per shared-memory tile
constexpr int kStatsPad = 4;      // row padding: conflict-free transposing stores
constexpr int kStatsQ = kStatsTileJ / (kStatsLanes * 4);  // 4-key groups per lane
constexpr int kStatsKeys = kStatsQ * 4;                   // keys per lane and tile
// pass (b)
constexpr int kAccThreads = 128;
constexpr int kColGroups = 8;     // threads across the C columns
constexpr int kAccBI = 32;        // i rows per tile

template <typename T, int CB>
__global__ void __launch_bounds__(kStatsThreads)
stream_stats_kernel(const T* __restrict__ f, const T* __restrict__ g,
                    float* __restrict__ m_out, float* __restrict__ l_out, int t) {
  __shared__ __align__(16) float s_ft[CB][kStatsTileJ + kStatsPad];  // f^T
  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % kStatsLanes;
  const int i0 = blockIdx.x * kStatsRows + (tid / kStatsLanes) * kStatsRI;
  const T* fn = f + (int64_t)n * t * CB;
  const T* gn = g + (int64_t)n * t * CB;

  float gi[kStatsRI][CB];
#pragma unroll
  for (int r = 0; r < kStatsRI; ++r)
#pragma unroll
    for (int k = 0; k < CB; ++k)
      gi[r][k] = i0 + r < t ? to_f32(gn[(int64_t)(i0 + r) * CB + k]) : 0.f;

  float m[kStatsRI], l[kStatsRI];
#pragma unroll
  for (int r = 0; r < kStatsRI; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  for (int j0 = 0; j0 < t; j0 += kStatsTileJ) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < kStatsTileJ * CB; e += kStatsThreads) {
      const int jj = e / CB, k = e % CB;
      s_ft[k][jj] = j0 + jj < t ? to_f32(fn[(int64_t)(j0 + jj) * CB + k]) : 0.f;
    }
    __syncthreads();
    float s[kStatsRI][kStatsKeys];
#pragma unroll
    for (int r = 0; r < kStatsRI; ++r)
#pragma unroll
      for (int x = 0; x < kStatsKeys; ++x) s[r][x] = 0.f;
#pragma unroll
    for (int q = 0; q < kStatsQ; ++q) {
      const int jb = (q * kStatsLanes + lane) * 4;
#pragma unroll
      for (int k = 0; k < CB; ++k) {
        float fv[4];
        load_row(fv, &s_ft[k][jb]);
#pragma unroll
        for (int r = 0; r < kStatsRI; ++r)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            s[r][q * 4 + x] = fmaf(gi[r][k], fv[x], s[r][q * 4 + x]);
      }
    }
    const int jn = t - j0;  // keys left from this tile on
    if (jn < kStatsTileJ) {
#pragma unroll
      for (int q = 0; q < kStatsQ; ++q)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if ((q * kStatsLanes + lane) * 4 + x >= jn) {
#pragma unroll
            for (int r = 0; r < kStatsRI; ++r) s[r][q * 4 + x] = -INFINITY;
          }
    }
#pragma unroll
    for (int r = 0; r < kStatsRI; ++r) {
      float mt = -INFINITY;
#pragma unroll
      for (int x = 0; x < kStatsKeys; ++x) mt = fmaxf(mt, s[r][x]);
      if (mt > -INFINITY) {
        if (mt > m[r]) {
          l[r] *= __expf(m[r] - mt);  // m = -inf: l is 0 and stays 0
          m[r] = mt;
        }
        float acc = 0.f;
#pragma unroll
        for (int x = 0; x < kStatsKeys; ++x) acc += __expf(s[r][x] - m[r]);
        l[r] += acc;
      }
    }
  }
  // merge the 16 lanes of each row in a fixed order (deterministic)
#pragma unroll
  for (int r = 0; r < kStatsRI; ++r) {
    float mr = m[r], lr = l[r];
#pragma unroll
    for (int off = 1; off < kStatsLanes; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, mr, off);
      const float lo = __shfl_xor_sync(0xffffffffu, lr, off);
      const float mn = fmaxf(mr, mo);
      lr = (mr == -INFINITY ? 0.f : lr * __expf(mr - mn)) +
           (mo == -INFINITY ? 0.f : lo * __expf(mo - mn));
      mr = mn;
    }
    if (lane == 0 && i0 + r < t) {
      m_out[(int64_t)n * t + i0 + r] = mr;
      l_out[(int64_t)n * t + i0 + r] = lr;
    }
  }
}

// tile shape of pass (b) by the width of h
template <int CB, int C>
struct AccShape {
  static constexpr int RJ = C >= 128 ? 4 : 8;  // output rows per thread
  static constexpr int RC = C / kColGroups;    // columns per thread
  static constexpr int BJ = kAccThreads / kColGroups * RJ;  // rows per block
  static constexpr int HALF = BJ / 2;          // a thread scores keys js, js + HALF
  static constexpr int PARTS = kAccThreads / HALF;  // thread groups across a tile's i
  static constexpr int GS = (CB + 2 + 3) / 4 * 4;   // g row, m, 1/l, padding
  static_assert(C % kColGroups == 0, "C must be a multiple of 8");
  static_assert(kAccBI % PARTS == 0, "the score threads must tile the i rows");
};

template <typename T, int CB, int C>
__global__ void __launch_bounds__(kAccThreads, 4)
stream_accum_kernel(const T* __restrict__ f, const T* __restrict__ g,
                    const T* __restrict__ h, const float* __restrict__ m_in,
                    const float* __restrict__ l_in, float* __restrict__ partial,
                    int t, int n_batch) {
  using S = AccShape<CB, C>;
  __shared__ __align__(16) float s_g[kAccBI][S::GS];  // g_i, m_i, 1/l_i
  __shared__ __align__(16) float s_h[kAccBI][C];
  __shared__ __align__(16) float s_a[kAccBI][S::BJ];

  const int n = blockIdx.z;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * S::BJ;
  const int tj = tid / kColGroups;  // rows tj*RJ .. of the j tile
  const int tc = tid % kColGroups;  // columns tc*RC ..
  const T* fn = f + (int64_t)n * t * CB;
  const T* gn = g + (int64_t)n * t * CB;
  const T* hn = h + (int64_t)n * t * C;

  // this split's contiguous range of i tiles
  const int n_tiles = (t + kAccBI - 1) / kAccBI;
  const int tile0 = (int)((int64_t)n_tiles * split / splits);
  const int tile1 = (int)((int64_t)n_tiles * (split + 1) / splits);

  // score phase: this thread always takes keys js and js + HALF of the
  // tile, so their f rows live in registers, and every PARTS-th row i
  const int js = tid % S::HALF;
  const int part = tid / S::HALF;
  float fj[2][CB];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int j = j0 + js + e * S::HALF;
#pragma unroll
    for (int k = 0; k < CB; ++k)
      fj[e][k] = j < t ? to_f32(fn[(int64_t)j * CB + k]) : 0.f;
  }
  float acc[S::RJ][S::RC];
#pragma unroll
  for (int r = 0; r < S::RJ; ++r)
#pragma unroll
    for (int q = 0; q < S::RC; ++q) acc[r][q] = 0.f;

  for (int tile = tile0; tile < tile1; ++tile) {
    const int i0 = tile * kAccBI;
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < kAccBI * CB; e += kAccThreads) {
      const int ii = e / CB, k = e % CB;
      s_g[ii][k] = i0 + ii < t ? to_f32(gn[(int64_t)(i0 + ii) * CB + k]) : 0.f;
    }
    for (int e = tid; e < kAccBI * C; e += kAccThreads) {
      const int ii = e / C, cc = e % C;
      s_h[ii][cc] = i0 + ii < t ? to_f32(hn[(int64_t)(i0 + ii) * C + cc]) : 0.f;
    }
    for (int ii = tid; ii < kAccBI; ii += kAccThreads) {
      const bool ok = i0 + ii < t;
      // masked rows have g = 0 (s = 0), m = 0 and 1/l = 0: A = 0
      s_g[ii][CB] = ok ? m_in[(int64_t)n * t + i0 + ii] : 0.f;
      s_g[ii][CB + 1] = ok ? 1.f / l_in[(int64_t)n * t + i0 + ii] : 0.f;
    }
    __syncthreads();
    for (int ii = part; ii < kAccBI; ii += S::PARTS) {
      float gv[S::GS];
      load_row(gv, &s_g[ii][0]);  // a warp shares ii: a broadcast
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < CB; ++k) s = fmaf(gv[k], fj[e][k], s);
        s_a[ii][js + e * S::HALF] = __expf(s - gv[CB]) * gv[CB + 1];
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int ii = 0; ii < kAccBI; ++ii) {
      float av[S::RJ], hv[S::RC];
      load_row(av, &s_a[ii][tj * S::RJ]);
      load_row(hv, &s_h[ii][tc * S::RC]);
#pragma unroll
      for (int r = 0; r < S::RJ; ++r)
#pragma unroll
        for (int q = 0; q < S::RC; ++q) acc[r][q] = fmaf(av[r], hv[q], acc[r][q]);
    }
  }
  float* pn = partial + ((int64_t)split * n_batch + n) * t * C;
#pragma unroll
  for (int r = 0; r < S::RJ; ++r) {
    const int j = j0 + tj * S::RJ + r;
    if (j < t) {
      float* row = pn + (int64_t)j * C + tc * S::RC;
      if constexpr (S::RC % 4 == 0) {
#pragma unroll
        for (int q = 0; q < S::RC; q += 4)
          *reinterpret_cast<float4*>(row + q) =
              make_float4(acc[r][q], acc[r][q + 1], acc[r][q + 2], acc[r][q + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < S::RC; ++q) row[q] = acc[r][q];
      }
    }
  }
}

__global__ void stream_combine_kernel(const float* __restrict__ partial,
                                      float* __restrict__ out, int64_t count,
                                      int splits) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[k * count + e];
  out[e] = s;
}

template <typename T, int CB, int C>
int launch(const void* f, const void* g, const void* h, void* out, void* m,
           void* l, void* partial, int splits, int n, int t,
           cudaStream_t stream) {
  using S = AccShape<CB, C>;
  dim3 grid_a((t + kStatsRows - 1) / kStatsRows, n);
  stream_stats_kernel<T, CB><<<grid_a, kStatsThreads, 0, stream>>>(
      (const T*)f, (const T*)g, (float*)m, (float*)l, t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // one split writes the output itself
  float* slices = splits == 1 ? (float*)out : (float*)partial;
  dim3 grid_b((t + S::BJ - 1) / S::BJ, splits, n);
  stream_accum_kernel<T, CB, C><<<grid_b, kAccThreads, 0, stream>>>(
      (const T*)f, (const T*)g, (const T*)h, (const float*)m, (const float*)l,
      slices, t, n);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int64_t count = (int64_t)n * t * C;
  stream_combine_kernel<<<(unsigned)((count + 255) / 256), 256, 0, stream>>>(
      slices, (float*)out, count, splits);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* f, const void* g, const void* h, void* out, void* m,
             void* l, void* partial, int splits, int n, int t, int cb, int c,
             cudaStream_t stream) {
  // the widths of ops/attention.py:KERNEL_WIDTHS (Cb = max(C / 8, 1))
#define MSAU_STREAM_CASE(CB_, C_)                                            \
  if (cb == CB_ && c == C_)                                                  \
    return launch<T, CB_, C_>(f, g, h, out, m, l, partial, splits, n, t, stream);
  MSAU_STREAM_CASE(1, 8)
  MSAU_STREAM_CASE(2, 16)
  MSAU_STREAM_CASE(4, 32)
  MSAU_STREAM_CASE(8, 64)
  MSAU_STREAM_CASE(16, 128)
#undef MSAU_STREAM_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// out: [N, T, C] f32.  partial: [splits, N, T, C] f32 scratch, allocated by
// the caller; unused (may be null) when splits == 1.
extern "C" int msau_fused_attention_fwd(const void* f, const void* g,
                                        const void* h, void* out, void* m,
                                        void* l, void* partial, int splits,
                                        int n, int t, int cb, int c,
                                        int is_bf16, void* stream) {
  if (n <= 0 || t <= 0) return 0;
  if (splits < 1 || (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? dispatch<__nv_bfloat16>(f, g, h, out, m, l, partial, splits,
                                           n, t, cb, c, s)
                 : dispatch<float>(f, g, h, out, m, l, partial, splits, n, t,
                                   cb, c, s);
}
