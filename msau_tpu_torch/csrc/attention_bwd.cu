// Resident exact-softmax attention, backward, with the MSAU semantics of
// attention.cu (s_ij = g_i . f_j, A = softmax over j, out_j = sum_i A_ij h_i):
//
//   a_ij  = exp(s_ij - m_i) / l_i        (m, l saved by the forward)
//   dh_i  = sum_j a_ij dout_j
//   rho_i = h_i . dh_i
//   ds_ij = a_ij (h_i . dout_j - rho_i)
//   dg_i  = sum_j ds_ij f_j,   df_j = sum_i ds_ij g_i
//
// f, g, df, dg: [N, T, Cb]; h, dout, dh: [N, T, C]; f32 or bf16 in and out,
// f32 arithmetic throughout.  dout has the operands' type (the resident
// forward returns it) or is f32 beside bf16 operands (the streaming forward
// of fused_attention.cu always returns f32).
//
// Replaces the TPU kernel msau_tpu/ops/pallas_attn.py:_res_bwd_kernel
// (launcher _resident_bwd).  The streaming path's backward in the JAX
// package (_fused_bwd, blockwise XLA from the saved m and l) is this
// formula in f32 too, so the same kernel serves it.  That kernel holds a whole score row block
// [Bi, T] in VMEM, does everything in one pass, and carries df across a
// SEQUENTIAL grid.  A Hopper block cannot hold [Bi, T] (16 rows at T = 4096
// is 256 KB of f32) and its blocks run in no order.
//
// What bounds it on the H100: at the flagship (N = 16, T = 4096, Cb = 8,
// C = 64) the operands are a few MiB, but dh = A dout and u = h doutᵀ are
// 2 x 17.2 G FMA over the batch, and the T x T matrices must never reach
// HBM.  As in the forward, Cb = 8 is too thin for tensor cores to pay and f32
// accuracy rules out TF32, so it runs on the FP32 pipes with register tiles
// fed from shared memory.
//
// Design: two launches, no float atomics, so the gradients are deterministic.
//  (a) rows_kernel: one block per 64-row i tile (32 when C = 128) and image.
//      It holds its rows' g, h, m, 1/l in shared memory and sweeps the j
//      tiles (64 keys) twice:
//        sweep 1: a tile in shared memory, dh_i += a_ij dout_j in a 4 x C/8
//                 register tile per thread; then rho_i = h_i . dh_i
//                 (8-lane shuffle, fixed order) and dh is written;
//        sweep 2: u_ij = h_i . dout_j in a 4 x 8 register tile per thread,
//                 ds_ij = a_ij (u_ij - rho_i) into shared memory, then
//                 dg_i += sum_j ds_ij f_j (registers, across tiles) and the
//                 tile's df partial sum_{i in block} ds_ij g_i, written to its
//                 own f32 slice [tile, N, T, Cb].
//  (b) combine_kernel: df = sum of the tile partials in tile order, cast.
// The slices grow with T^2 (256 MiB at N = 2, T = 16384), so the launcher
// may take the row tiles in groups of `group`: each group reuses the
// [group, N, T, Cb] scratch and its sum is added, in group order, into an
// f32 [N, T, Cb] accumulator that the last group casts into df.  The order
// is fixed, so a rerun gives the same bits.
// Scores are recomputed in both sweeps (Cb FMAs and an exp each) rather than
// stored.  The ragged edge of T is masked: missing rows have g = h = 0 and
// 1/l = 0 (a = 0); missing keys have f = dout = 0 and a forced to 0.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using msau::cmax;
using msau::load_row;
using msau::store;
using msau::to_f32;

constexpr int kThreads = 128;

// shared-memory layout of rows_kernel, in floats; every region starts on a
// 16-byte boundary
template <int CB, int C>
struct Shape {
  static constexpr int BI = C >= 128 ? 32 : 64;  // rows i per block
  static constexpr int BJ = 64;                  // keys j per tile
  static constexpr int BIP = BI + 4;             // padded row strides
  static constexpr int BJP = BJ + 4;
  static constexpr int CP = C + 4;
  static constexpr int BJS = BJ + 1;             // ds row stride
  static constexpr int RI = BI / 16;             // rows per thread (16 x 8 grid)
  static constexpr int RC = C / 8;               // columns of C per thread
  static constexpr int RJ = BJ / 8;              // keys per thread
  static constexpr int KG = CB < 4 ? CB : 4;     // Cb columns per dg/df thread
  static constexpr int GROUPS = CB / KG;
  static constexpr int NDG = (BI * GROUPS + kThreads - 1) / kThreads;
  static constexpr int NDF = (BJ * GROUPS + kThreads - 1) / kThreads;

  static constexpr int GT = 0;                   // g^T [CB][BIP]
  static constexpr int G = GT + CB * BIP;        // g   [BI][CB]
  static constexpr int HT = G + cmax(BI * CB, 4);  // h^T [C][BIP]
  static constexpr int M = HT + C * BIP;         // m, 1/l, rho [BI] each
  static constexpr int IL = M + BI;
  static constexpr int RHO = IL + BI;
  static constexpr int FT = RHO + BI;            // f^T [CB][BJP]
  static constexpr int F = FT + CB * BJP;        // f   [BJ][CB]
  static constexpr int DO = F + cmax(BJ * CB, 4);  // dout [BJ][CP] / [C][BJP]
  static constexpr int A = DO + cmax(BJ * CP, C * BJP);  // a^T [BJ][BIP] / ds
  static constexpr int TOTAL = A + cmax(BJ * BIP, BI * BJS);

  static_assert(C % 8 == 0, "C must be a multiple of 8");
  static_assert(kThreads % BI == 0, "a block's threads must tile its rows");
  static_assert(CB % KG == 0, "Cb must be 1, 2 or a multiple of 4");
};

// T: the type of f, g, h and the gradients; TD: dout's.  The block takes row
// tile tile0 + blockIdx.x and writes df slice blockIdx.x.
template <typename T, typename TD, int CB, int C>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const T* __restrict__ f, const T* __restrict__ g,
            const T* __restrict__ h, const TD* __restrict__ dout,
            const float* __restrict__ m_in, const float* __restrict__ l_in,
            T* __restrict__ dg, T* __restrict__ dh,
            float* __restrict__ df_partial, int t, int n_batch, int tile0) {
  using S = Shape<CB, C>;
  extern __shared__ __align__(16) float smem[];
  float* s_gt = smem + S::GT;
  float* s_g = smem + S::G;
  float* s_ht = smem + S::HT;
  float* s_m = smem + S::M;
  float* s_il = smem + S::IL;
  float* s_rho = smem + S::RHO;
  float* s_ft = smem + S::FT;
  float* s_f = smem + S::F;
  float* s_do = smem + S::DO;
  float* s_a = smem + S::A;

  const int n = blockIdx.y;
  const int i0 = (tile0 + (int)blockIdx.x) * S::BI;
  const int tid = threadIdx.x;
  const int ti = tid / 8;  // rows ti*RI .. of the block
  const int tc = tid % 8;  // columns tc*RC (sweep 1) or keys tc*RJ (sweep 2)
  const T* fn = f + (int64_t)n * t * CB;
  const T* gn = g + (int64_t)n * t * CB;
  const T* hn = h + (int64_t)n * t * C;
  const TD* don = dout + (int64_t)n * t * C;

  // this block's rows
  for (int e = tid; e < S::BI * CB; e += kThreads) {
    const int ii = e / CB, k = e % CB;
    const float v = i0 + ii < t ? to_f32(gn[(int64_t)(i0 + ii) * CB + k]) : 0.f;
    s_gt[k * S::BIP + ii] = v;
    s_g[ii * CB + k] = v;
  }
  for (int e = tid; e < S::BI * C; e += kThreads) {
    const int ii = e / C, c = e % C;
    s_ht[c * S::BIP + ii] =
        i0 + ii < t ? to_f32(hn[(int64_t)(i0 + ii) * C + c]) : 0.f;
  }
  for (int ii = tid; ii < S::BI; ii += kThreads) {
    const bool ok = i0 + ii < t;
    s_m[ii] = ok ? m_in[(int64_t)n * t + i0 + ii] : 0.f;
    s_il[ii] = ok ? 1.f / l_in[(int64_t)n * t + i0 + ii] : 0.f;
  }
  __syncthreads();

  // ---- sweep 1: dh = A dout ---------------------------------------------
  // the a^T tile: this thread always takes row ia, so g_i lives in registers
  const int ia = tid % S::BI;
  float gi[CB];
#pragma unroll
  for (int k = 0; k < CB; ++k) gi[k] = s_gt[k * S::BIP + ia];
  const float mi = s_m[ia], ili = s_il[ia];

  float acc[S::RI][S::RC];
#pragma unroll
  for (int r = 0; r < S::RI; ++r)
#pragma unroll
    for (int q = 0; q < S::RC; ++q) acc[r][q] = 0.f;

  for (int j0 = 0; j0 < t; j0 += S::BJ) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < S::BJ * CB; e += kThreads) {
      const int jj = e / CB, k = e % CB;
      s_f[jj * CB + k] =
          j0 + jj < t ? to_f32(fn[(int64_t)(j0 + jj) * CB + k]) : 0.f;
    }
    for (int e = tid; e < S::BJ * C; e += kThreads) {
      const int jj = e / C, c = e % C;
      s_do[jj * S::CP + c] =
          j0 + jj < t ? to_f32(don[(int64_t)(j0 + jj) * C + c]) : 0.f;
    }
    __syncthreads();
    for (int jj = tid / S::BI; jj < S::BJ; jj += kThreads / S::BI) {
      float fv[CB];
      load_row(fv, s_f + jj * CB);  // a warp shares jj: a broadcast
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < CB; ++k) s = fmaf(gi[k], fv[k], s);
      s_a[jj * S::BIP + ia] = j0 + jj < t ? expf(s - mi) * ili : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < S::BJ; ++jj) {
      float av[S::RI], dv[S::RC];
      load_row(av, s_a + jj * S::BIP + ti * S::RI);
      load_row(dv, s_do + jj * S::CP + tc * S::RC);
#pragma unroll
      for (int r = 0; r < S::RI; ++r)
#pragma unroll
        for (int q = 0; q < S::RC; ++q) acc[r][q] = fmaf(av[r], dv[q], acc[r][q]);
    }
  }

  // rho_i = h_i . dh_i over the 8 lanes sharing row ti (fixed shuffle order:
  // every lane ends with the same sum); write dh
  T* dhn = dh + (int64_t)n * t * C;
#pragma unroll
  for (int r = 0; r < S::RI; ++r) {
    const int ii = ti * S::RI + r;
    float p = 0.f;
#pragma unroll
    for (int q = 0; q < S::RC; ++q)
      p = fmaf(s_ht[(tc * S::RC + q) * S::BIP + ii], acc[r][q], p);
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      p += __shfl_xor_sync(0xffffffffu, p, off);
    if (tc == 0) s_rho[ii] = p;
    if (i0 + ii < t) {
#pragma unroll
      for (int q = 0; q < S::RC; ++q)
        store(dhn + (int64_t)(i0 + ii) * C + tc * S::RC + q, acc[r][q]);
    }
  }

  // ---- sweep 2: ds, dg, df partials ---------------------------------------
  float acc_dg[S::NDG][S::KG];
#pragma unroll
  for (int q = 0; q < S::NDG; ++q)
#pragma unroll
    for (int k = 0; k < S::KG; ++k) acc_dg[q][k] = 0.f;
  float* pn = df_partial + ((int64_t)blockIdx.x * n_batch + n) * t * CB;

  for (int j0 = 0; j0 < t; j0 += S::BJ) {
    __syncthreads();  // the previous tile is consumed; s_rho is visible
    for (int e = tid; e < S::BJ * CB; e += kThreads) {
      const int jj = e / CB, k = e % CB;
      const float v = j0 + jj < t ? to_f32(fn[(int64_t)(j0 + jj) * CB + k]) : 0.f;
      s_ft[k * S::BJP + jj] = v;
      s_f[jj * CB + k] = v;
    }
    for (int e = tid; e < S::BJ * C; e += kThreads) {
      const int jj = e / C, c = e % C;
      s_do[c * S::BJP + jj] =
          j0 + jj < t ? to_f32(don[(int64_t)(j0 + jj) * C + c]) : 0.f;
    }
    __syncthreads();
    float u[S::RI][S::RJ], s[S::RI][S::RJ];
#pragma unroll
    for (int r = 0; r < S::RI; ++r)
#pragma unroll
      for (int q = 0; q < S::RJ; ++q) u[r][q] = s[r][q] = 0.f;
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      float hv[S::RI], dv[S::RJ];
      load_row(hv, s_ht + c * S::BIP + ti * S::RI);
      load_row(dv, s_do + c * S::BJP + tc * S::RJ);
#pragma unroll
      for (int r = 0; r < S::RI; ++r)
#pragma unroll
        for (int q = 0; q < S::RJ; ++q) u[r][q] = fmaf(hv[r], dv[q], u[r][q]);
    }
#pragma unroll
    for (int k = 0; k < CB; ++k) {
      float gv[S::RI], fv[S::RJ];
      load_row(gv, s_gt + k * S::BIP + ti * S::RI);
      load_row(fv, s_ft + k * S::BJP + tc * S::RJ);
#pragma unroll
      for (int r = 0; r < S::RI; ++r)
#pragma unroll
        for (int q = 0; q < S::RJ; ++q) s[r][q] = fmaf(gv[r], fv[q], s[r][q]);
    }
#pragma unroll
    for (int r = 0; r < S::RI; ++r) {
      const int ii = ti * S::RI + r;
      const float mr = s_m[ii], ilr = s_il[ii], rr = s_rho[ii];
#pragma unroll
      for (int q = 0; q < S::RJ; ++q) {
        const int jj = tc * S::RJ + q;
        const float a = j0 + jj < t ? expf(s[r][q] - mr) * ilr : 0.f;
        s_a[ii * S::BJS + jj] = a * (u[r][q] - rr);
      }
    }
    __syncthreads();
    // dg_i += sum_j ds_ij f_j: a thread owns row ii and KG columns of Cb
#pragma unroll
    for (int q = 0; q < S::NDG; ++q) {
      const int e = tid + q * kThreads;
      if (e < S::BI * S::GROUPS) {
        const int ii = e / S::GROUPS, k0 = (e % S::GROUPS) * S::KG;
        for (int jj = 0; jj < S::BJ; ++jj) {
          const float d = s_a[ii * S::BJS + jj];
          float fv[S::KG];
          load_row(fv, s_f + jj * CB + k0);
#pragma unroll
          for (int k = 0; k < S::KG; ++k) acc_dg[q][k] = fmaf(d, fv[k], acc_dg[q][k]);
        }
      }
    }
    // this tile's df partial over the block's rows: df_j = sum_i ds_ij g_i
#pragma unroll
    for (int q = 0; q < S::NDF; ++q) {
      const int e = tid + q * kThreads;
      if (e < S::BJ * S::GROUPS) {
        const int jj = e / S::GROUPS, k0 = (e % S::GROUPS) * S::KG;
        float out[S::KG];
#pragma unroll
        for (int k = 0; k < S::KG; ++k) out[k] = 0.f;
        for (int ii = 0; ii < S::BI; ++ii) {
          const float d = s_a[ii * S::BJS + jj];
          float gv[S::KG];
          load_row(gv, s_g + ii * CB + k0);
#pragma unroll
          for (int k = 0; k < S::KG; ++k) out[k] = fmaf(d, gv[k], out[k]);
        }
        if (j0 + jj < t) {
#pragma unroll
          for (int k = 0; k < S::KG; ++k)
            pn[(int64_t)(j0 + jj) * CB + k0 + k] = out[k];
        }
      }
    }
  }

  T* dgn = dg + (int64_t)n * t * CB;
#pragma unroll
  for (int q = 0; q < S::NDG; ++q) {
    const int e = tid + q * kThreads;
    if (e < S::BI * S::GROUPS) {
      const int ii = e / S::GROUPS, k0 = (e % S::GROUPS) * S::KG;
      if (i0 + ii < t) {
#pragma unroll
        for (int k = 0; k < S::KG; ++k)
          store(dgn + (int64_t)(i0 + ii) * CB + k0 + k, acc_dg[q][k]);
      }
    }
  }
}

// One group's slices summed in tile order onto the earlier groups' sum
// (acc, f32; not read by the first group, not written by the last, which
// casts the total into out).
template <typename T>
__global__ void combine_kernel(const float* __restrict__ partial,
                               float* __restrict__ acc, T* __restrict__ out,
                               int64_t count, int tiles, bool first, bool last) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float s = first ? 0.f : acc[e];
  for (int k = 0; k < tiles; ++k) s += partial[k * count + e];
  if (last)
    store(out + e, s);
  else
    acc[e] = s;
}

template <typename T, typename TD, int CB, int C>
int launch(const void* f, const void* g, const void* h, const void* dout,
           const void* m, const void* l, void* df, void* dg, void* dh,
           void* partial, void* acc, int tiles, int group, int n, int t,
           cudaStream_t stream) {
  using S = Shape<CB, C>;
  if (tiles != (t + S::BI - 1) / S::BI || group < 1 ||
      (group < tiles && acc == nullptr))
    return (int)cudaErrorInvalidValue;
  const int smem = S::TOTAL * (int)sizeof(float);
  auto kernel = rows_kernel<T, TD, CB, C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t count = (int64_t)n * t * CB;
  for (int tile0 = 0; tile0 < tiles; tile0 += group) {
    const int cnt = tiles - tile0 < group ? tiles - tile0 : group;
    kernel<<<dim3(cnt, n), kThreads, smem, stream>>>(
        (const T*)f, (const T*)g, (const T*)h, (const TD*)dout, (const float*)m,
        (const float*)l, (T*)dg, (T*)dh, (float*)partial, t, n, tile0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    combine_kernel<T><<<(unsigned)((count + 255) / 256), 256, 0, stream>>>(
        (const float*)partial, (float*)acc, (T*)df, count, cnt, tile0 == 0,
        tile0 + cnt >= tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T, typename TD>
int dispatch(const void* f, const void* g, const void* h, const void* dout,
             const void* m, const void* l, void* df, void* dg, void* dh,
             void* partial, void* acc, int tiles, int group, int n, int t,
             int cb, int c, cudaStream_t stream) {
  // the widths of ops/attention.py:KERNEL_WIDTHS (Cb = max(C / 8, 1))
#define MSAU_ATTN_BWD_CASE(CB_, C_)                                          \
  if (cb == CB_ && c == C_)                                                  \
    return launch<T, TD, CB_, C_>(f, g, h, dout, m, l, df, dg, dh, partial,  \
                                  acc, tiles, group, n, t, stream);
  MSAU_ATTN_BWD_CASE(1, 8)
  MSAU_ATTN_BWD_CASE(2, 16)
  MSAU_ATTN_BWD_CASE(4, 32)
  MSAU_ATTN_BWD_CASE(8, 64)
  MSAU_ATTN_BWD_CASE(16, 128)
#undef MSAU_ATTN_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// partial: [tiles, N, T, Cb] f32 scratch, tiles = ceil(T / rows per block),
// allocated by the caller.  dout has the operands' type.
extern "C" int msau_resident_attention_bwd(
    const void* f, const void* g, const void* h, const void* dout,
    const void* m, const void* l, void* df, void* dg, void* dh, void* partial,
    int tiles, int n, int t, int cb, int c, int is_bf16, void* stream) {
  if (n <= 0 || t <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? dispatch<__nv_bfloat16, __nv_bfloat16>(
                       f, g, h, dout, m, l, df, dg, dh, partial, nullptr,
                       tiles, tiles, n, t, cb, c, s)
                 : dispatch<float, float>(f, g, h, dout, m, l, df, dg, dh,
                                          partial, nullptr, tiles, tiles, n, t,
                                          cb, c, s);
}

// The streaming path's backward: dout is f32 whatever the operands' type.
// partial: [min(group, tiles), N, T, Cb] f32 scratch; acc: [N, T, Cb] f32
// scratch, needed when group < tiles.
extern "C" int msau_fused_attention_bwd(
    const void* f, const void* g, const void* h, const void* dout,
    const void* m, const void* l, void* df, void* dg, void* dh, void* partial,
    void* acc, int tiles, int group, int n, int t, int cb, int c, int is_bf16,
    void* stream) {
  if (n <= 0 || t <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? dispatch<__nv_bfloat16, float>(
                       f, g, h, dout, m, l, df, dg, dh, partial, acc, tiles,
                       group, n, t, cb, c, s)
                 : dispatch<float, float>(f, g, h, dout, m, l, df, dg, dh,
                                          partial, acc, tiles, group, n, t, cb,
                                          c, s);
}
