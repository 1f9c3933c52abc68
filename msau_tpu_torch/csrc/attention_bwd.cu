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
// f32 sums.  dout has the operands' type (the resident forward returns it)
// or is f32 beside either operand type (the streaming forward,
// msau_fused_attention_fwd in attention.cu, always returns f32).
//
// Replaces the TPU kernel msau_tpu/ops/pallas_attn.py:_res_bwd_kernel
// (launcher _resident_bwd).  The streaming path's backward in the JAX
// package (_fused_bwd, blockwise XLA from the saved m and l, every operand
// upcast to f32) is this formula in f32, so the same kernel serves it on the
// f32 path whatever the operands' type.  The TPU kernel holds a whole score
// row block [Bi, T] in VMEM, does everything in one pass, rounds a to bf16
// before a dout and ds before ds f and ds^T g when the operands are bf16,
// and carries df across a SEQUENTIAL grid.
//
// What bounds it on the H100 (N = 16, T = 4096, Cb = 8, C = 64): the
// products s, dh = A dout, u = h dout^T, ds f and ds^T g are 81.6 GFLOP
// (0.083 ms at the bf16 tensor-core peak, 1.22 ms at the FP32 peak), and
// each pass over the scores is N T^2 = 268 M exponentials (~0.07 ms on the
// SFUs).  Every wide product runs on the tensor cores (attention_mma.cuh,
// and attention.cu's note on why): bf16 as the TPU kernel computes it (a
// and ds rounded to bf16 there, f32 sums), f32 with the operands split into
// three bf16 parts; the f32 score product and rho stay on the FP32 pipes.
//
// Design: a persistent grid of 4-warp blocks, per_image blocks per image
// (sized from the slots the occupancy API reports, msau_attention_bwd_slots),
// and one combine launch; no float atomics, so a rerun gives the same bits.
//  (a) rows_kernel: block (p, n) takes the row tiles p, p + per_image, ...
//      of image n, 128 rows i (64 when C >= 128; a warp 32 or 16).  Its
//      warps hold their rows' softmax constants and score fragments in
//      registers and sweep the keys j twice, 64 at a time (32 at C = 256)
//      staged in shared memory (bf16: cp.async, double-buffered; f32: one
//      chunk at a time, split into parts on the way in):
//        sweep 1: the score tile, a = exp(s - m) / l, and with a as the A
//                 operand (mma_a_from_c) dh += a dout; then rho = h . dh in
//                 the fragments (a quad's lanes, fixed order), dh written;
//        sweep 2: the score tile, a, u = h dout^T (h from registers in
//                 bf16, from shared memory in f32), ds = a (u - rho) as an A
//                 operand: dg += ds f, and its transpose (movmatrix) gives
//                 the warp's df_j = sum over its rows of ds_ij g_i; the 4
//                 warps' df add in shared memory in warp order, and the
//                 block adds that, tile after tile, into its own f32 slice
//                 [p, n, T, Cb] of the scratch (plain stores: no other
//                 block writes it; the slice's old values load ahead of
//                 the chunk's work).
//  (b) combine_kernel: df = the sum of the per_image slices in block order,
//      cast.
// Two sweeps, not the TPU kernel's one pass: at T = 4096 a 16-row score
// block in bf16 is 128 KB, so one pass would hold one 16-row block per SM
// and leave the tensor cores waiting on its staging; two sweeps pay one more
// exponential per score (~0.07 ms at the flagship) and keep 4 blocks of 128
// rows per SM.  At T = 16384 (the streaming use) a row block could not stay
// resident at all.  The ragged edge of T is masked: missing rows have g = h
// = 0 and 1/l = 0 (a = 0); missing keys have f = dout = 0 and a forced to 0.
//
// The rows kernel is instantiated for the widths of attention.cu; every
// other Cb, C >= 1 takes the general backward of attention_general_bwd.cu
// through the same entry points (two passes over the scores, the scratch
// its rho and df slices).

#include <math.h>
#include <stdint.h>

#include "attention_general.cuh"
#include "attention_mma.cuh"

namespace {

using namespace msau;
using namespace msau::attn;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <typename T, typename TD, int CB, int C>
struct Shape {
  using K = Keys<CB>;
  using W = Cols<C>;
  static constexpr bool F32 = std::is_same<TD, float>::value;
  static constexpr int P = F32 ? 3 : 1;
  static constexpr int MT = C >= 128 ? 1 : 2;        // m16 tiles of rows i per warp
  static constexpr int BI = kWarps * 16 * MT;        // rows i per tile
  // keys j staged per step: 32 at C = 256, whose f32 chunk of 64 keys
  // (dout's three parts) with h's parts would pass the 227 KB of shared
  // memory a block may hold
  static constexpr int KEYS = C >= 256 ? 32 : 64;
  static constexpr int NB = K::KB / 8;               // n8 tiles of Cb
  static constexpr int KT = W::KC / 16;              // k16 steps of C
  // shared memory, bytes.  Per staged chunk of keys: f (its P parts, rows
  // of KS), f32 f (f32 path), dout (its P parts, rows of CS); bf16
  // double-buffers the chunks (cp.async), f32 stages one at a time (its
  // parts are made on the way in).  Then h's parts (f32 path) and the
  // warps' df.
  static constexpr int NBUF = F32 ? 1 : 2;
  static constexpr int FPLANE = KEYS * K::KS;        // elements
  static constexpr int DPLANE = KEYS * W::CS;
  static constexpr int HPLANE = BI * W::CS;
  static constexpr int FB = 0;
  static constexpr int FF = FB + P * FPLANE * 2;
  static constexpr int DO = FF + (F32 ? KEYS * K::CF * 4 : 0);
  static constexpr int BUF = DO + P * DPLANE * 2;
  static constexpr int HS = NBUF * BUF;
  static constexpr int DF = HS + (F32 ? P * HPLANE * 2 : 0);  // [warp][KEYS][KB] f32
  static constexpr int TOTAL = DF + kWarps * KEYS * K::KB * 4;
};

template <typename T, typename TD, int CB, int C>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const T* __restrict__ f, const T* __restrict__ g, const T* __restrict__ h,
            const TD* __restrict__ dout, const float* __restrict__ m_in,
            const float* __restrict__ l_in, T* __restrict__ dg, T* __restrict__ dh,
            float* __restrict__ df_partial, int t, int n_batch) {
  using S = Shape<T, TD, CB, C>;
  using K = Keys<CB>;
  using W = Cols<C>;
  constexpr int P = S::P, MT = S::MT, NB = S::NB, kKeys = S::KEYS;
  constexpr bool F32 = S::F32;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_h = reinterpret_cast<bf16*>(smem + S::HS);
  float* s_df = reinterpret_cast<float*>(smem + S::DF);

  const int per_image = gridDim.x, p = blockIdx.x, n = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int tiles = (t + S::BI - 1) / S::BI;
  const T* fn = f + (int64_t)n * t * CB;
  const T* gn = g + (int64_t)n * t * CB;
  const T* hn = h + (int64_t)n * t * C;
  const TD* don = dout + (int64_t)n * t * C;
  float* pn = df_partial + ((int64_t)p * n_batch + n) * t * CB;
  // lane offsets of the ldmatrix addresses: .trans reads of a [k][n] tile
  // (k = the 16 rows) and plain reads of an [n][k] tile (n = the 16 rows)
  const int trans_row = (lane & 7) + 8 * ((lane >> 3) & 1), trans_col = 8 * (lane >> 4);
  const int plain_row = (lane & 7) + 8 * (lane >> 4), plain_col = 8 * ((lane >> 3) & 1);

  if constexpr (W::KC > C && !F32) {
    // the pad columns of dout that cp.async never writes
    for (int e = threadIdx.x; e < S::NBUF * kKeys * (W::KC - C); e += kThreads) {
      const int b = e / (kKeys * (W::KC - C)), r = e / (W::KC - C) % kKeys;
      reinterpret_cast<bf16*>(smem + b * S::BUF + S::DO)[r * W::CS + C + e % (W::KC - C)] =
          __float2bfloat16(0.f);
    }
  }
  // one chunk of keys (f, dout) into buffer b; the bf16 path's copies are
  // asynchronous, and every call commits one group
  auto stage = [&](int j0, int b) {
    unsigned char* buf = smem + b * S::BUF;
    if constexpr (F32) {
      stage_keys<P, CB, kKeys, kThreads>(reinterpret_cast<bf16*>(buf + S::FB), S::FPLANE,
                                         reinterpret_cast<float*>(buf + S::FF), fn, j0, t);
      stage_planes<P, kKeys, kThreads, C, W::KC>(reinterpret_cast<bf16*>(buf + S::DO), S::DPLANE,
                                                 W::CS, don, j0, t);
    } else {
      stage_key_rows<T, CB, kKeys, kThreads>(buf + S::FB, fn, j0, t);
      async_rows<bf16>(reinterpret_cast<bf16*>(buf + S::DO), W::CS, don, j0, kKeys, C, t);
    }
    cp_async_commit();
  };
  // before chunk c (keys j0) is used: stage it (f32) or the next one (bf16),
  // wait for chunk c and make it visible; -> its buffer
  auto arrive = [&](int c, int j0) -> const unsigned char* {
    int b = 0;
    if constexpr (S::NBUF == 2) {
      b = c & 1;
      if (c == 0) stage(0, 0);
      if (j0 + kKeys < t)
        stage(j0 + kKeys, b ^ 1);
      else
        cp_async_commit();
      cp_async_wait<1>();
    } else {
      stage(j0, 0);
      cp_async_wait<0>();
    }
    return smem + b * S::BUF;
  };

  for (int tile = p; tile < tiles; tile += per_image) {
    const bool first = tile == p;
    const int i0 = tile * S::BI;
    const int iw = i0 + 16 * MT * warp;   // this warp's rows
    // per m tile: rows iw + 16 mt + gq (hh = 0) and + 8 (hh = 1)
    RowSoftmax row[MT][2];
    unsigned ga[MT][NB][2];
    float gr[MT][2][CB];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r0 = iw + 16 * mt + gq;
      if constexpr (F32)
        load_score_rows<CB>(gr[mt], gn, r0, t);
      else
        load_score_a<CB>(ga[mt], gn, r0, t, tq);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + 8 * hh;
        row[mt][hh] = row_softmax(r < t ? m_in[(int64_t)n * t + r] : 0.f,
                                  r < t ? l_in[(int64_t)n * t + r] : 0.f);
      }
    }

    // ---- sweep 1: dh = a dout -------------------------------------------
    float acc[MT][W::NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < W::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

    for (int c = 0, j0 = 0; j0 < t; ++c, j0 += kKeys) {
      const unsigned char* buf = arrive(c, j0);
      if constexpr (F32) {
        if (c == 0) stage_planes<P, S::BI, kThreads, C, W::KC>(s_h, S::HPLANE, W::CS, hn, i0, t);
      }
      __syncthreads();
      const bf16* s_fb = reinterpret_cast<const bf16*>(buf + S::FB);
      const float* s_ff = reinterpret_cast<const float*>(buf + S::FF);
      const bf16* s_do = reinterpret_cast<const bf16*>(buf + S::DO);
      for (int jb = 0; jb < kKeys; jb += 16) {
        if (j0 + jb >= t) break;
        float s[MT][2][4];
        if constexpr (F32)
          score_ffma<MT, CB>(s, gr, s_ff + jb * K::CF, tq);
        else
          score_mma<MT, CB>(s, ga, s_fb + jb * K::KS, lane);
        const bool ragged = j0 + jb + 16 > t;
        unsigned pa[MT][P][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int hh = e >> 1;
              const float a = softmax_a<F32>(s[mt][nt][e], row[mt][hh]);
              s[mt][nt][e] =
                  ragged && j0 + jb + 8 * nt + 2 * tq + (e & 1) >= t ? 0.f : a;
            }
          mma_a_from_c<P>(pa[mt], s[mt][0], s[mt][1]);
        }
        const bf16* drow = s_do + (jb + trans_row) * W::CS + trans_col;
#pragma unroll
        for (int cp = 0; cp < W::NT / 2; ++cp) {
          unsigned b0[P][2], b1[P][2];
#pragma unroll
          for (int q = 0; q < P; ++q) {
            unsigned r[4];
            ldsm_x4_trans(r, drow + q * S::DPLANE + 16 * cp);
            b0[q][0] = r[0];
            b0[q][1] = r[1];
            b1[q][0] = r[2];
            b1[q][1] = r[3];
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_parts<P>(acc[mt][2 * cp], pa[mt], b0);
            mma_parts<P>(acc[mt][2 * cp + 1], pa[mt], b1);
          }
        }
      }
      __syncthreads();   // chunk c is consumed before its buffer is staged again
    }

    // rho_i = h_i . dh_i over the quad's lanes (every lane of the quad ends
    // with the same sum); dh written
    float rho[MT][2];
    T* dhn = dh + (int64_t)n * t * C;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = iw + 16 * mt + gq + 8 * hh;
        float sum = 0.f;
        if (r < t) {
#pragma unroll
          for (int nt = 0; nt < C / 8; ++nt) {
            const int c = 8 * nt + 2 * tq;
            sum = fmaf(to_f32(hn[(int64_t)r * C + c]), acc[mt][nt][2 * hh], sum);
            sum = fmaf(to_f32(hn[(int64_t)r * C + c + 1]), acc[mt][nt][2 * hh + 1], sum);
            store(dhn + (int64_t)r * C + c, acc[mt][nt][2 * hh]);
            store(dhn + (int64_t)r * C + c + 1, acc[mt][nt][2 * hh + 1]);
          }
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        rho[mt][hh] = sum;
      }

    // ---- sweep 2: ds, dg, df ----------------------------------------------
    // the u product's A operand (h rows, k = C) in bf16 lives in registers;
    // the df product's B operand (g rows, k = i) in registers, split
    unsigned ha[MT][S::KT][4];
    if constexpr (!F32) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kt = 0; kt < S::KT; ++kt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = iw + 16 * mt + gq + 8 * (e & 1);
            const int c = 16 * kt + 2 * tq + 8 * (e >> 1);
            ha[mt][kt][e] = r < t && c < C
                                ? *reinterpret_cast<const unsigned*>(hn + (int64_t)r * C + c)
                                : 0u;
          }
    }
    unsigned gb[MT][NB][P][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = iw + 16 * mt + 2 * tq + 8 * e, k = 8 * nb + gq;
          const float x = r < t && k < CB ? to_f32(gn[(int64_t)r * CB + k]) : 0.f;
          const float y = r + 1 < t && k < CB ? to_f32(gn[(int64_t)(r + 1) * CB + k]) : 0.f;
          unsigned parts[P];
          split2<P>(parts, x, y);
#pragma unroll
          for (int q = 0; q < P; ++q) gb[mt][nb][q][e] = parts[q];
        }
    float dga[MT][NB][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) dga[mt][nb][e] = 0.f;

    for (int c = 0, j0 = 0; j0 < t; ++c, j0 += kKeys) {
      // this block's slice of df for these keys so far, loaded ahead of
      // the chunk's work
      constexpr int DFI = (kKeys * CB + kThreads - 1) / kThreads;
      float prev[DFI];
#pragma unroll
      for (int it = 0; it < DFI; ++it) {
        const int e = threadIdx.x + it * kThreads;
        prev[it] = !first && e < kKeys * CB && j0 + e / CB < t ? pn[(int64_t)j0 * CB + e] : 0.f;
      }
      const unsigned char* buf = arrive(c, j0);
      __syncthreads();
      const bf16* s_fb = reinterpret_cast<const bf16*>(buf + S::FB);
      const float* s_ff = reinterpret_cast<const float*>(buf + S::FF);
      const bf16* s_do = reinterpret_cast<const bf16*>(buf + S::DO);
      for (int jb = 0; jb < kKeys; jb += 16) {
        if (j0 + jb >= t) break;
        float s[MT][2][4];
        if constexpr (F32)
          score_ffma<MT, CB>(s, gr, s_ff + jb * K::CF, tq);
        else
          score_mma<MT, CB>(s, ga, s_fb + jb * K::KS, lane);
        // u = h dout^T over the C axis
        float u[MT][2][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) u[mt][nt][e] = 0.f;
        const bf16* drow = s_do + (jb + plain_row) * W::CS + plain_col;
#pragma unroll
        for (int kt = 0; kt < S::KT; ++kt) {
          unsigned b0[P][2], b1[P][2];
#pragma unroll
          for (int q = 0; q < P; ++q) {
            unsigned r[4];
            ldsm_x4(r, drow + q * S::DPLANE + 16 * kt);
            b0[q][0] = r[0];
            b0[q][1] = r[1];
            b1[q][0] = r[2];
            b1[q][1] = r[3];
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            unsigned a[P][4];
            if constexpr (F32) {
#pragma unroll
              for (int q = 0; q < P; ++q)
                ldsm_x4(a[q], s_h + q * S::HPLANE +
                                  (16 * MT * warp + 16 * mt + trans_row) * W::CS + 16 * kt +
                                  trans_col);
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) a[0][e] = ha[mt][kt][e];
            }
            mma_parts<P>(u[mt][0], a, b0);
            mma_parts<P>(u[mt][1], a, b1);
          }
        }
        // ds = a (u - rho), split (bf16: rounded) as an A operand (k = j)
        const bool ragged = j0 + jb + 16 > t;
        unsigned dsa[MT][P][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int hh = e >> 1;
              const float a = softmax_a<F32>(s[mt][nt][e], row[mt][hh]);
              const float d = a * (u[mt][nt][e] - rho[mt][hh]);
              s[mt][nt][e] =
                  ragged && j0 + jb + 8 * nt + 2 * tq + (e & 1) >= t ? 0.f : d;
            }
          mma_a_from_c<P>(dsa[mt], s[mt][0], s[mt][1]);
        }
        // dg += ds f: f rows j as the B operand (k = j)
        const bf16* frow = s_fb + (jb + trans_row) * K::KS;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          unsigned fb[P][2];
#pragma unroll
          for (int q = 0; q < P; ++q) ldsm_x2_trans(fb[q], frow + q * S::FPLANE + 8 * nb);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_parts<P>(dga[mt][nb], dsa[mt], fb);
        }
        // this warp's df_j = sum over its rows of ds_ij g_i: ds^T (rows j,
        // k = i) against g's rows
        float dfw[NB][4];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) dfw[nb][e] = 0.f;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          unsigned at[P][4];
          mma_a_transposed<P>(at, dsa[mt]);
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) mma_parts<P>(dfw[nb], at, gb[mt][nb]);
        }
        float* mine = s_df + (warp * kKeys + jb + gq) * K::KB + 2 * tq;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          *reinterpret_cast<float2*>(mine + 8 * nb) = make_float2(dfw[nb][0], dfw[nb][1]);
          *reinterpret_cast<float2*>(mine + 8 * K::KB + 8 * nb) =
              make_float2(dfw[nb][2], dfw[nb][3]);
        }
      }
      __syncthreads();
      // the block's df for these keys: the warps in order, added to this
      // block's slice (the first tile stores)
#pragma unroll
      for (int it = 0; it < DFI; ++it) {
        const int e = threadIdx.x + it * kThreads;
        const int jj = e / CB, k = e % CB;
        if (e >= kKeys * CB || j0 + jj >= t) continue;
        float v = s_df[jj * K::KB + k];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) v += s_df[(w * kKeys + jj) * K::KB + k];
        pn[(int64_t)j0 * CB + e] = first ? v : prev[it] + v;
      }
    }

    T* dgn = dg + (int64_t)n * t * CB;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = iw + 16 * mt + gq + 8 * hh;
        if (r >= t) continue;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 8 * nb + 2 * tq + e;
            if (k < CB) store(dgn + (int64_t)r * CB + k, dga[mt][nb][2 * hh + e]);
          }
      }
  }
}

// Blocks of rows_kernel the card holds at once (blocks per SM from the
// occupancy API, times the SMs), or a negative error.
template <typename T, typename TD, int CB, int C>
int card_slots() {
  using S = Shape<T, TD, CB, C>;
  auto kernel = rows_kernel<T, TD, CB, C>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = allow_smem(kernel, S::TOTAL);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, S::TOTAL);
  if (err != cudaSuccess) return -(int)err;
  return per_sm > 0 ? per_sm * sms : -(int)cudaErrorInvalidConfiguration;
}

template <typename T, typename TD, int CB, int C>
int launch(const void* f, const void* g, const void* h, const void* dout, const void* m,
           const void* l, void* df, void* dg, void* dh, void* partial, int64_t partial_floats,
           int per_image, int n, int t, cudaStream_t stream) {
  using S = Shape<T, TD, CB, C>;
  if (per_image < 1 || per_image > (t + S::BI - 1) / S::BI ||
      partial_floats < (int64_t)per_image * n * t * CB)
    return (int)cudaErrorInvalidValue;
  auto kernel = rows_kernel<T, TD, CB, C>;
  cudaError_t err = allow_smem(kernel, S::TOTAL);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(per_image, n), kThreads, S::TOTAL, stream>>>(
      (const T*)f, (const T*)g, (const T*)h, (const TD*)dout, (const float*)m, (const float*)l,
      (T*)dg, (T*)dh, (float*)partial, t, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t count = (int64_t)n * t * CB;
  combine_kernel<T><<<(unsigned)((count + 255) / 256), 256, 0, stream>>>((const float*)partial,
                                                                         (T*)df, count, per_image);
  return (int)cudaGetLastError();
}

// the widths with an instance of their own (ops/attention.py:
// SPECIALISED_WIDTHS): the model's Cb = max(C / 8, 1) at C = 8 ... 256
#define MSAU_ATTN_BWD_WIDTHS(X) X(1, 8) X(2, 16) X(4, 32) X(8, 64) X(16, 128) X(32, 256)

template <typename T, typename TD>
int dispatch(const void* f, const void* g, const void* h, const void* dout, const void* m,
             const void* l, void* df, void* dg, void* dh, void* partial, int64_t partial_floats,
             int per_image, int n, int t, int cb, int c, cudaStream_t stream) {
#define MSAU_CASE(CB_, C_)                                                                \
  if (cb == CB_ && c == C_)                                                               \
    return launch<T, TD, CB_, C_>(f, g, h, dout, m, l, df, dg, dh, partial, partial_floats, \
                                  per_image, n, t, stream);
  MSAU_ATTN_BWD_WIDTHS(MSAU_CASE)
#undef MSAU_CASE
  // every other width: attention_general_bwd.cu
  return general::bwd(f, g, h, dout, m, l, df, dg, dh, (float*)partial, partial_floats, per_image,
                      n, t, cb, c, !std::is_same<T, float>::value, std::is_same<TD, float>::value,
                      stream);
}

template <typename T, typename TD>
int dispatch_slots(int cb, int c) {
#define MSAU_CASE(CB_, C_) \
  if (cb == CB_ && c == C_) return card_slots<T, TD, CB_, C_>();
  MSAU_ATTN_BWD_WIDTHS(MSAU_CASE)
#undef MSAU_CASE
  return -(int)cudaErrorInvalidValue;
}

}  // namespace

// Blocks of the backward's rows kernel that the card holds at once, for
// these widths and types, or a negative CUDA error; the caller sizes its
// grid from it (ops/attention.py:bwd_blocks_per_image).  dout_f32: the
// streaming path's f32 cotangent (msau_fused_attention_bwd).  Only the
// widths with an instance of their own have a rows kernel; any other gives
// -cudaErrorInvalidValue (the general backward's scratch is sized without
// the card: ops/attention.py:general_bwd_plan).
extern "C" int msau_attention_bwd_slots(int cb, int c, int is_bf16, int dout_f32) {
  if (!is_bf16) return dispatch_slots<float, float>(cb, c);
  return dout_f32 ? dispatch_slots<__nv_bfloat16, float>(cb, c)
                  : dispatch_slots<__nv_bfloat16, __nv_bfloat16>(cb, c);
}

// partial: f32 scratch of partial_floats, allocated by the caller: [per_image,
// N, T, Cb] with per_image blocks per image (at most the row tiles of an
// image), for the widths with an instance of their own; for any other, the
// general backward's rho and df slices (attention_general.cuh:
// general::bwd) with per_image blocks per image of its ds kernel.  A
// scratch smaller than what the kernels write is refused.  dout has the
// operands' type.
extern "C" int msau_resident_attention_bwd(const void* f, const void* g, const void* h,
                                           const void* dout, const void* m, const void* l,
                                           void* df, void* dg, void* dh, void* partial,
                                           long long partial_floats, int per_image, int n, int t,
                                           int cb, int c, int is_bf16, void* stream) {
  if (n <= 0 || t <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? dispatch<__nv_bfloat16, __nv_bfloat16>(f, g, h, dout, m, l, df, dg, dh,
                                                          partial, partial_floats, per_image, n,
                                                          t, cb, c, s)
                 : dispatch<float, float>(f, g, h, dout, m, l, df, dg, dh, partial,
                                          partial_floats, per_image, n, t, cb, c, s);
}

// The streaming path's backward: dout is f32 whatever the operands' type,
// and the kernel takes its f32 path.  partial as above.
extern "C" int msau_fused_attention_bwd(const void* f, const void* g, const void* h,
                                        const void* dout, const void* m, const void* l, void* df,
                                        void* dg, void* dh, void* partial,
                                        long long partial_floats, int per_image, int n, int t,
                                        int cb, int c, int is_bf16, void* stream) {
  if (n <= 0 || t <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? dispatch<__nv_bfloat16, float>(f, g, h, dout, m, l, df, dg, dh, partial,
                                                  partial_floats, per_image, n, t, cb, c, s)
                 : dispatch<float, float>(f, g, h, dout, m, l, df, dg, dh, partial,
                                          partial_floats, per_image, n, t, cb, c, s);
}
