// Exact-softmax attention, forward, with the MSAU semantics:
//   s_ij = g_i . f_j        (no 1/sqrt(d) scaling)
//   A_ij = exp(s_ij - m_i) / l_i,  m_i = max_j s_ij,  l_i = sum_j exp(s_ij - m_i)
//   out_j = sum_i A_ij h_i   (the softmax runs over j, the sum over i: the
//                             transpose of standard attention)
// f, g: [N, T, Cb]; h, out: [N, T, C]; f32 or bf16 in, f32 sums.  m and l
// ([N, T] f32) are written for the backward.  Two entry points:
//  - msau_resident_attention_fwd, out in h's dtype.  Replaces the TPU
//    kernel msau_tpu/ops/pallas_attn.py:_res_fwd_kernel (launcher
//    _resident_forward), which computes whole score rows s[i_blk, :] per
//    grid step, rounds A to bf16 for bf16 operands, and carries the [T, C]
//    output in VMEM across a SEQUENTIAL grid (o_ref += A^T h_blk).
//  - msau_fused_attention_fwd, the streaming form the model takes from
//    8192 tokens (1024^2 pages: T = 16384), out in f32 whatever the
//    operands, A never rounded.  Replaces the TPU kernel pair
//    pallas_attn.py:_stats_kernel and _accum_kernel (launcher
//    _fused_forward, which upcasts its operands to f32), whose online
//    (m, l) and out_j += revisit an output block across a SEQUENTIAL inner
//    grid axis.  Neither kernel here holds a row of T scores, so the same
//    two launches serve any T: with f32 operands it is the resident f32
//    instance itself; with bf16 operands the stats pass is the resident
//    bf16 one (exact bf16 products, f32 sums) and the accumulate pass keeps
//    A in f32 as three bf16 parts against h's one (AccShape: PA = 3,
//    PH = 1, three products per k step instead of six).
// Hopper blocks run in no order, so the TPU kernels' carries do not
// translate: out_j needs every row's (m, l), so each form takes two
// launches.
//
// What bounds it on the H100 (N = 16, T = 4096, Cb = 8, C = 64, the train
// step's instance): N T^2 = 268 M exponentials per pass on the SFUs (16 per
// clock per SM: ~0.07 ms a pass at 1.75 GHz) and the A^T h product, 34.4
// GFLOP (0.035 ms at the bf16 tensor-core peak, 0.51 ms at the FP32 peak).
// The streaming form's instance (config 5's train step: N = 2, T = 16384)
// has twice the scores, 537 M, and A^T h is 34.4 G multiply-adds: six bf16
// products each with f32 operands, three with bf16 ones.  The scores never
// reach HBM.
//
// Tensor cores.  A design that kept every product on the FP32 pipes, on
// the grounds that Cb = 8 is too thin for tensor cores and that f32
// accuracy rules out TF32, ran this instance at ~2 ms in both dtypes.  What
// was found instead (attention_mma.cuh): in bf16 the TPU kernel itself
// multiplies bf16 values with f32 sums, so both products go to mma.sync as
// it computes them (A rounded to bf16); in f32 each operand splits into
// three bf16 parts and the six products that matter carry each product to
// f32's precision at the cost of 3xTF32 (two parts missed 1e-5; TF32 alone
// keeps 11 bits), summed one k step at a time on the FP32 pipes because the
// tensor cores' accumulator drops low bits.  The f32 score product stays on
// the FP32 pipes in a fixed order: it feeds the exponential.
//
// Design: two launches, each a persistent grid of 8-warp blocks sized by the
// occupancy API; no atomics and no scratch, so a rerun gives the same bits.
// bf16 chunks are double-buffered (cp.async, the next chunk in flight while
// one is used); f32 chunks are staged one at a time, split into parts on
// the way in.
//  (a) stats_kernel: a block owns 32 wr query rows i (a warp 32); the other
//      8 / wr warps of the block split the keys j of each 128-key chunk.  A
//      warp computes its 32 x 16 score tiles (mma m16n8k8, or FFMA in f32),
//      keeps an online (max, sum-exp) per row, merges its quad's lanes and
//      then the block's warps in a fixed order, and writes m, l.
//  (b) accum_kernel: a block owns 32 wj output rows j (16 when C >= 128; a
//      warp 32 or 16); the other 8 / wj warps of the block split the summed
//      rows i.  Per staged chunk of 128 rows i (g, h, m, l; each row's
//      softmax constants made once per chunk), a warp forms the transposed
//      score tile S^T[j, i] (its f_j fragments live in registers), A =
//      exp(S^T - m_i) / l_i in registers, and with A as the A operand
//      (mma_a_from_c) out += A h (mma m16n8k16, h by ldmatrix.trans).  The
//      warps that split i add their sums in shared memory in warp order,
//      and the block writes out (h's dtype, or f32 for the streaming
//      form).  No combine launch and no scratch: the split of i is inside
//      the block.
// wr and wj take the fewest waves of the card's resident blocks, each as
// long as a block's rows (pick_layout; N = 1 at T = 4096: 32-row blocks,
// 128 of them).  The ragged edge of T is masked: missing keys score -inf
// in (a); missing rows i have g = h = 0 and m = l = 0, so A = 0, in (b);
// missing rows j are not written.
//
// These kernels are instantiated for (Cb, C) = (1, 8), (2, 16), (4, 32),
// (8, 64), (16, 128) and (32, 256): the model's Cb = max(C / 8, 1) at
// feat_root 8 and pool 2.  Every other Cb, C >= 1 (feat_root 12 or 16,
// pool 3, a seventh scale...) takes the general pair of
// attention_general_fwd.cu through the same entry points: the same two
// launches on the tensor cores with Cb and C runtime arguments.

#include <math.h>
#include <stdint.h>

#include "attention_general.cuh"
#include "attention_mma.cuh"

namespace {

using namespace msau;
using namespace msau::attn;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;   // keys (a) or rows i (b) staged per step

template <typename T>
constexpr bool kF32 = std::is_same<T, float>::value;

// ---- (a) stats ----------------------------------------------------------

constexpr int kStatsMT = 2;   // m16 tiles of query rows per warp in (a)

template <typename T, int CB>
struct StatsSmem {
  using K = Keys<CB>;
  static constexpr int KEYS = kF32<T> ? kChunk * K::CF * 4 : kChunk * K::KS * 2;
  static constexpr int MERGE = 2 * KEYS;   // [8 warps][32 lanes][kStatsMT][2 rows][m, l]
  static constexpr int TOTAL = MERGE + kWarps * 32 * kStatsMT * 4 * 4;
};

template <typename T, int CB>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const T* __restrict__ f, const T* __restrict__ g, float* __restrict__ m_out,
             float* __restrict__ l_out, int t, int n_batch, int wr) {
  using K = Keys<CB>;
  using L = StatsSmem<T, CB>;
  constexpr int MT = kStatsMT;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_merge = reinterpret_cast<float*>(smem + L::MERGE);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int ws = kWarps / wr, wrow = warp % wr, wsi = warp / wr;
  const int rows = 16 * MT * wr;
  const int tiles = (t + rows - 1) / rows;

  for (int item = blockIdx.x; item < n_batch * tiles; item += gridDim.x) {
    const int n = item / tiles;
    const int r0 = (item % tiles) * rows + 16 * MT * wrow + gq;   // this lane's first row
    const T* fn = f + (int64_t)n * t * CB;
    const T* gn = g + (int64_t)n * t * CB;
    unsigned ga[MT][K::KB / 8][2];
    float gr[MT][2][CB];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if constexpr (kF32<T>)
        load_score_rows<CB>(gr[mt], gn, r0 + 16 * mt, t);
      else
        load_score_a<CB>(ga[mt], gn, r0 + 16 * mt, t, tq);
    }

    // per m tile and row half: the running max and sum-exp of this lane's keys
    float mrun[MT][2], lrun[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) mrun[mt][hh] = -INFINITY, lrun[mt][hh] = 0.f;
    // key chunks double-buffered: chunk c + 1 is in flight while c is used
    stage_key_rows<T, CB, kChunk, kThreads>(smem, fn, 0, t);
    cp_async_commit();
    for (int c = 0, j0 = 0; j0 < t; ++c, j0 += kChunk) {
      if (j0 + kChunk < t)
        stage_key_rows<T, CB, kChunk, kThreads>(smem + ((c + 1) & 1) * L::KEYS, fn, j0 + kChunk, t);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const unsigned char* keys = smem + (c & 1) * L::KEYS;
      for (int sub = wsi; sub < kChunk / 16; sub += ws) {
        const int jb = 16 * sub;
        if (j0 + jb >= t) break;
        float s[MT][2][4];
        if constexpr (kF32<T>)
          score_ffma<MT, CB>(s, gr, reinterpret_cast<const float*>(keys) + jb * K::CF, tq);
        else
          score_mma<MT, CB>(s, ga, reinterpret_cast<const bf16*>(keys) + jb * K::KS, lane);
        if (j0 + jb + 16 > t) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (j0 + jb + 8 * nt + 2 * tq + (e & 1) >= t) s[mt][nt][e] = -INFINITY;
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float v[4] = {s[mt][0][2 * hh], s[mt][0][2 * hh + 1], s[mt][1][2 * hh],
                                s[mt][1][2 * hh + 1]};
            const float mt4 = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
            float& m = mrun[mt][hh];
            float& l = lrun[mt][hh];
            if (mt4 > -INFINITY) {
              if (mt4 > m) {
                l *= __expf(m - mt4);   // m = -inf: l is 0 and stays 0
                m = mt4;
              }
              l += (ex2((v[0] - m) * kLog2e) + ex2((v[1] - m) * kLog2e)) +
                   (ex2((v[2] - m) * kLog2e) + ex2((v[3] - m) * kLog2e));
            }
          }
      }
      __syncthreads();   // chunk c is consumed before chunk c + 2 lands in its buffer
    }
    // merge the quad's lanes, then the ws warps of these rows, in a fixed order
    float* mine = s_merge + (warp * 32 + lane) * MT * 4;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float m = mrun[mt][hh], l = lrun[mt][hh];
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const float mo = __shfl_xor_sync(0xffffffffu, m, off);
          const float lo = __shfl_xor_sync(0xffffffffu, l, off);
          const float mn = fmaxf(m, mo);
          l = (m == -INFINITY ? 0.f : l * __expf(m - mn)) +
              (mo == -INFINITY ? 0.f : lo * __expf(mo - mn));
          m = mn;
        }
        mine[(mt * 2 + hh) * 2] = m;
        mine[(mt * 2 + hh) * 2 + 1] = l;
      }
    __syncthreads();
    if (wsi == 0 && tq == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float m = -INFINITY, l = 0.f;
          for (int w = 0; w < ws; ++w) {
            const float* o = s_merge + ((w * wr + wrow) * 32 + lane) * MT * 4 + (mt * 2 + hh) * 2;
            const float mn = fmaxf(m, o[0]);
            l = (m == -INFINITY ? 0.f : l * __expf(m - mn)) +
                (o[0] == -INFINITY ? 0.f : o[1] * __expf(o[0] - mn));
            m = mn;
          }
          const int r = r0 + 16 * mt + 8 * hh;
          if (r < t) {
            m_out[(int64_t)n * t + r] = m;
            l_out[(int64_t)n * t + r] = l;
          }
        }
    }
    __syncthreads();   // the merge buffer is read before the next item writes it
  }
}

// ---- (b) accumulate -----------------------------------------------------

// T: the operands' type; TO: the output's.  An f32 output keeps A in f32
// (AF32): three bf16 parts (PA) and the plain version's two steps, exp(s -
// m) times 1/l; a bf16 output rounds A to bf16 (one part) with the folded
// exponent, as _res_fwd_kernel rounds it.  h has three parts in f32 and one
// in bf16 (PH): with bf16 operands and an f32 output (the streaming form)
// each k step takes the three products (qa, 0).
template <typename T, int CB, int C, typename TO>
struct AccShape {
  using K = Keys<CB>;
  using W = Cols<C>;
  static constexpr bool AF32 = kF32<TO>;
  static constexpr int PA = AF32 ? 3 : 1;
  static constexpr int PH = kF32<T> ? 3 : 1;
  static_assert(AF32 || !kF32<T>, "f32 operands give an f32 output");
  static constexpr int MT = C >= 128 ? 1 : 2;   // m16 tiles of rows j per warp
  // shared memory, bytes, per staged chunk: g rows (bf16 [KS] or f32 [CF]),
  // h (bf16, or its PH parts), m, l.  bf16 double-buffers the chunks
  // (cp.async); f32 stages one at a time (its parts are made on the way in).
  // After the sweep, the warps' sums alias the chunks.
  static constexpr int NBUF = kF32<T> ? 1 : 2;
  static constexpr int PLANE = kChunk * W::CS;   // elements
  static constexpr int G = 0;
  static constexpr int H = G + (kF32<T> ? kChunk * K::CF * 4 : kChunk * K::KS * 2);
  static constexpr int M = H + PH * PLANE * 2;
  static constexpr int L = M + kChunk * 4;
  static constexpr int BUF = L + kChunk * 4;
  static constexpr int ACC = MT * W::NT * 4;     // floats per lane
  static constexpr int RED = (kWarps - 1) * 32 * ACC * 4;
  static constexpr int TOTAL = NBUF * BUF > RED ? NBUF * BUF : RED;
};

template <typename T, int CB, int C, typename TO>
__global__ void __launch_bounds__(kThreads)
accum_kernel(const T* __restrict__ f, const T* __restrict__ g, const T* __restrict__ h,
             const float* __restrict__ m_in, const float* __restrict__ l_in, TO* __restrict__ out,
             int t, int n_batch, int wj) {
  using K = Keys<CB>;
  using W = Cols<C>;
  using S = AccShape<T, CB, C, TO>;
  constexpr int PA = S::PA, PH = S::PH, MT = S::MT;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_red = reinterpret_cast<float*>(smem);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int wi = kWarps / wj, wjx = warp % wj, wix = warp / wj;
  const int rows = 16 * MT * wj;
  const int tiles = (t + rows - 1) / rows;

  if constexpr (W::KC > C && S::NBUF == 2) {
    // the pad columns of h that cp.async never writes
    for (int e = threadIdx.x; e < S::NBUF * kChunk * (W::KC - C); e += kThreads) {
      const int b = e / (kChunk * (W::KC - C)), r = e / (W::KC - C) % kChunk;
      reinterpret_cast<bf16*>(smem + b * S::BUF + S::H)[r * W::CS + C + e % (W::KC - C)] =
          __float2bfloat16(0.f);
    }
  }

  for (int item = blockIdx.x; item < n_batch * tiles; item += gridDim.x) {
    const int n = item / tiles;
    const int j0w = (item % tiles) * rows + 16 * MT * wjx;   // this warp's rows j
    const T* fn = f + (int64_t)n * t * CB;
    const T* gn = g + (int64_t)n * t * CB;
    const T* hn = h + (int64_t)n * t * C;
    unsigned fa[MT][K::KB / 8][2];
    float fr[MT][2][CB];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if constexpr (kF32<T>)
        load_score_rows<CB>(fr[mt], fn, j0w + 16 * mt + gq, t);
      else
        load_score_a<CB>(fa[mt], fn, j0w + 16 * mt + gq, t, tq);
    }
    float acc[MT][W::NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < W::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

    // one chunk of rows i (g, h, m, l) into buffer b
    auto stage = [&](int i0, int b) {
      unsigned char* buf = smem + b * S::BUF;
      stage_key_rows<T, CB, kChunk, kThreads>(buf + S::G, gn, i0, t);
      if constexpr (kF32<T>)
        stage_planes<PH, kChunk, kThreads, C, W::KC>(reinterpret_cast<bf16*>(buf + S::H),
                                                     S::PLANE, W::CS, hn, i0, t);
      else
        async_rows<bf16>(reinterpret_cast<bf16*>(buf + S::H), W::CS, hn, i0, kChunk, C, t);
      async_floats(reinterpret_cast<float*>(buf + S::M), m_in + (int64_t)n * t, i0, kChunk, t);
      async_floats(reinterpret_cast<float*>(buf + S::L), l_in + (int64_t)n * t, i0, kChunk, t);
      cp_async_commit();
    };
    if constexpr (S::NBUF == 2) stage(0, 0);
    for (int c = 0, i0 = 0; i0 < t; ++c, i0 += kChunk) {
      const int b = S::NBUF == 2 ? (c & 1) : 0;
      if constexpr (S::NBUF == 2) {
        if (i0 + kChunk < t)
          stage(i0 + kChunk, b ^ 1);
        else
          cp_async_commit();
        cp_async_wait<1>();
      } else {
        stage(i0, 0);
        cp_async_wait<0>();
      }
      __syncthreads();
      unsigned char* buf = smem + b * S::BUF;
      // each row's softmax constants, once per chunk, in place over l:
      // 1 / l where A stays f32, log2 l where it is rounded to bf16 (rows
      // past t give A = 0)
      for (int r = threadIdx.x; r < kChunk; r += kThreads) {
        float* lr = reinterpret_cast<float*>(buf + S::L) + r;
        const RowSoftmax x = row_softmax(reinterpret_cast<const float*>(buf + S::M)[r], *lr);
        *lr = S::AF32 ? x.il : x.lg;
      }
      __syncthreads();
      const bf16* s_h = reinterpret_cast<const bf16*>(buf + S::H);
      const float* s_m = reinterpret_cast<const float*>(buf + S::M);
      const float* s_l = reinterpret_cast<const float*>(buf + S::L);
      for (int sub = wix; sub < kChunk / 16; sub += wi) {
        const int ib = 16 * sub;
        if (i0 + ib >= t) break;
        // S^T[j, i]: rows j from registers, columns i from the chunk
        float s[MT][2][4];
        if constexpr (kF32<T>)
          score_ffma<MT, CB>(s, fr, reinterpret_cast<const float*>(buf + S::G) + ib * K::CF, tq);
        else
          score_mma<MT, CB>(s, fa, reinterpret_cast<const bf16*>(buf + S::G) + ib * K::KS, lane);
        // A^T = exp(S^T - m_i) / l_i: column i = ib + 8 nt + 2 tq (+ e); rows
        // past t have m = l = 0, and A = 0 there
        RowSoftmax col[2][2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float2 mv = *reinterpret_cast<const float2*>(s_m + ib + 8 * nt + 2 * tq);
          const float2 lv = *reinterpret_cast<const float2*>(s_l + ib + 8 * nt + 2 * tq);
          col[nt][0] = {mv.x, lv.x, lv.x};
          col[nt][1] = {mv.y, lv.y, lv.y};
        }
        unsigned pa[MT][PA][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[mt][nt][e] = softmax_a<S::AF32>(s[mt][nt][e], col[nt][e & 1]);
          mma_a_from_c<PA>(pa[mt], s[mt][0], s[mt][1]);
        }
        // out[j, :] += A^T[j, i] h[i, :], two n8 tiles of C at a time
        const bf16* hrow = s_h + (ib + (lane & 7) + 8 * ((lane >> 3) & 1)) * W::CS + 8 * (lane >> 4);
#pragma unroll
        for (int cp = 0; cp < W::NT / 2; ++cp) {
          unsigned b0[PH][2], b1[PH][2];
#pragma unroll
          for (int q = 0; q < PH; ++q) {
            unsigned r[4];
            ldsm_x4_trans(r, hrow + q * S::PLANE + 16 * cp);
            b0[q][0] = r[0];
            b0[q][1] = r[1];
            b1[q][0] = r[2];
            b1[q][1] = r[3];
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_parts<PA, PH>(acc[mt][2 * cp], pa[mt], b0);
            mma_parts<PA, PH>(acc[mt][2 * cp + 1], pa[mt], b1);
          }
        }
      }
      __syncthreads();   // chunk c is consumed before its buffer is staged again
    }
    // the warps that split i add their sums, in warp order (s_red aliases
    // the consumed chunks)
    if (wi > 1) {
      if (wix > 0) {
        float* mine = s_red + ((wix - 1) * wj + wjx) * 32 * S::ACC + lane;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < W::NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) mine[((mt * W::NT + nt) * 4 + e) * 32] = acc[mt][nt][e];
      }
      __syncthreads();
      if (wix == 0) {
        for (int w = 1; w < wi; ++w) {
          const float* o = s_red + ((w - 1) * wj + wjx) * 32 * S::ACC + lane;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < W::NT; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[mt][nt][e] += o[((mt * W::NT + nt) * 4 + e) * 32];
        }
      }
    }
    if (wix == 0) {
      TO* on = out + (int64_t)n * t * C;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int j = j0w + 16 * mt + gq + 8 * hh;
          if (j >= t) continue;
#pragma unroll
          for (int nt = 0; nt < C / 8; ++nt) {
            TO* o = on + (int64_t)j * C + 8 * nt + 2 * tq;
            store(o, acc[mt][nt][2 * hh]);
            store(o + 1, acc[mt][nt][2 * hh + 1]);
          }
        }
    }
    if (wi > 1) __syncthreads();   // the sums are read before the next item stages over them
    if constexpr (W::KC > C && S::NBUF == 2) {
      // the pad columns of h, which s_red may have overwritten
      if (wi > 1) {
        for (int e = threadIdx.x; e < S::NBUF * kChunk * (W::KC - C); e += kThreads) {
          const int b = e / (kChunk * (W::KC - C)), r = e / (W::KC - C) % kChunk;
          reinterpret_cast<bf16*>(smem + b * S::BUF + S::H)[r * W::CS + C + e % (W::KC - C)] =
              __float2bfloat16(0.f);
        }
      }
    }
  }
}

// Block slots the card holds at once for ``kernel`` (blocks per SM, from the
// occupancy API, times the SMs) and its SMs; slots < 0: a CUDA error.
struct Card {
  int slots, sms;
};
template <typename Kernel>
Card card_slots(Kernel kernel, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return {-(int)err, sms};
  return {per_sm * sms > 0 ? per_sm * sms : -(int)cudaErrorInvalidConfiguration, sms};
}

// The warps-per-block layout w in {8, 4, 2, 1} (w warps along the kernel's
// own rows, 8 / w splitting the summed axis) that takes the fewest sweeps:
// n * ceil(t / (rows_per_warp w)) blocks run in ceil(blocks / slots) waves,
// each as long as a block's rows, so a layout costs waves * w.  slots: the
// card's resident blocks, at most two per SM (more share an SM's pipes and
// add nothing to them).  A tie goes to the larger w: fewer, larger blocks do
// more work between their barriers.  (N = 2, T = 16384 with the f32
// accumulate kernel's one block per SM: one wave of 8-warp rows, not 1.94
// waves of 4-warp rows; N = 1 at T = 4096: 1-warp rows, 128 blocks.)
int pick_layout(int n, int t, int rows_per_warp, Card card) {
  const int64_t slots = card.slots < 2 * card.sms ? card.slots : 2 * card.sms;
  int best = kWarps;
  int64_t best_cost = -1;
  for (int w = kWarps; w >= 1; w /= 2) {
    const int64_t blocks = (int64_t)n * ((t + rows_per_warp * w - 1) / (rows_per_warp * w));
    const int64_t cost = (blocks + slots - 1) / slots * w;
    if (best_cost < 0 || cost < best_cost) {
      best = w;
      best_cost = cost;
    }
  }
  return best;
}

template <typename T, int CB, int C, typename TO>
int launch(const void* f, const void* g, const void* h, void* out, void* m, void* l, int n,
           int t, cudaStream_t stream) {
  using SS = StatsSmem<T, CB>;
  using AS = AccShape<T, CB, C, TO>;
  auto stats = stats_kernel<T, CB>;
  Card card = card_slots(stats, SS::TOTAL);
  if (card.slots < 0) return -card.slots;
  const int wr = pick_layout(n, t, 16 * kStatsMT, card);
  int items = n * ((t + 16 * kStatsMT * wr - 1) / (16 * kStatsMT * wr));
  stats<<<items < card.slots ? items : card.slots, kThreads, SS::TOTAL, stream>>>(
      (const T*)f, (const T*)g, (float*)m, (float*)l, t, n, wr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto accum = accum_kernel<T, CB, C, TO>;
  card = card_slots(accum, AS::TOTAL);
  if (card.slots < 0) return -card.slots;
  const int rows = 16 * AS::MT;
  const int wj = pick_layout(n, t, rows, card);
  items = n * ((t + rows * wj - 1) / (rows * wj));
  accum<<<items < card.slots ? items : card.slots, kThreads, AS::TOTAL, stream>>>(
      (const T*)f, (const T*)g, (const T*)h, (const float*)m, (const float*)l, (TO*)out, t, n,
      wj);
  return (int)cudaGetLastError();
}

template <typename T, typename TO>
int dispatch(const void* f, const void* g, const void* h, void* out, void* m, void* l, int n,
             int t, int cb, int c, cudaStream_t stream) {
  // the widths with an instance of their own (ops/attention.py:
  // SPECIALISED_WIDTHS): the model's Cb = max(C / 8, 1) at C = 8 ... 256
#define MSAU_ATTN_CASE(CB_, C_)                                                      \
  if (cb == CB_ && c == C_)                                                          \
    return launch<T, CB_, C_, TO>(f, g, h, out, m, l, n, t, stream);
  MSAU_ATTN_CASE(1, 8)
  MSAU_ATTN_CASE(2, 16)
  MSAU_ATTN_CASE(4, 32)
  MSAU_ATTN_CASE(8, 64)
  MSAU_ATTN_CASE(16, 128)
  MSAU_ATTN_CASE(32, 256)
#undef MSAU_ATTN_CASE
  // every other width: attention_general_fwd.cu
  return general::fwd(f, g, h, out, m, l, n, t, cb, c, !kF32<T>, kF32<TO>, stream);
}

}  // namespace

// out: [N, T, C] in the operands' dtype; any Cb, C >= 1.
extern "C" int msau_resident_attention_fwd(const void* f, const void* g, const void* h, void* out,
                                           void* m, void* l, int n, int t, int cb, int c,
                                           int is_bf16, void* stream) {
  if (n <= 0 || t <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? dispatch<bf16, bf16>(f, g, h, out, m, l, n, t, cb, c, s)
                 : dispatch<float, float>(f, g, h, out, m, l, n, t, cb, c, s);
}

// The streaming form: out [N, T, C] f32 whatever the operands' dtype.
extern "C" int msau_fused_attention_fwd(const void* f, const void* g, const void* h, void* out,
                                        void* m, void* l, int n, int t, int cb, int c,
                                        int is_bf16, void* stream) {
  if (n <= 0 || t <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? dispatch<bf16, float>(f, g, h, out, m, l, n, t, cb, c, s)
                 : dispatch<float, float>(f, g, h, out, m, l, n, t, cb, c, s);
}
