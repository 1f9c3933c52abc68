// The attention backward at any width (attention_general.cuh): the general
// counterpart of attention_bwd.cu's rows kernel, behind
// msau_resident_attention_bwd and msau_fused_attention_bwd for every (Cb,
// C) outside ops/attention.py:SPECIALISED_WIDTHS.  Replaces, with it, the
// TPU kernel msau_tpu/ops/pallas_attn.py:_res_bwd_kernel (launcher
// _resident_bwd) and serves the streaming path's backward (_fused_bwd) on
// an f32 cotangent:
//
//   a_ij  = exp(s_ij - m_i) / l_i,  dh_i = sum_j a_ij dout_j,
//   rho_i = h_i . dh_i,             ds_ij = a_ij (h_i . dout_j - rho_i),
//   dg_i  = sum_j ds_ij f_j,        df_j = sum_i ds_ij g_i.
//
// What bounds it on the H100 (9a: N 16, T 4096, Cb 12, C 96): the products
// s, a dout, h dout^T, ds f and ds^T g, 61 G multiply-adds (six bf16
// products each with f32 operands; the f32 score product in f64, formed in
// both passes), and each pass over the scores is N T^2 = 268 M
// exponentials (~0.07 ms on the SFUs).
//
// Design: two passes over the T x T scores (up to C 256 and Cb 128; past
// them each further column group of (a) and Cb group of (b) forms them
// again) and a combine; no float atomics, so a rerun gives the same bits.
//  (a) dh_kernel: block (tile, group, n) owns 16 MT rows i a warp (8 warps)
//      and one group of NT n8 tiles of C (all of C up to 256 columns; the
//      grid takes further groups).  It sweeps the keys j, KEYS at a time
//      (f's score rows and dout's group columns as parts, staged; the next
//      chunk's loads in flight while one is used), forms the score tile, a
//      in registers and, with a as the A operand, dh += a dout; then writes
//      dh and its part of rho_i = h_i . dh_i, one [N, T] f32 slice per
//      group.
//  (b) ds_kernel: block (p, n) takes the row tiles p, p + per_image, ...
//      of image n (8 warps of 16 rows, 4 at f32 Cb > 32: bwd_rows).  It
//      holds rho (the slices added in group order) and stages g as parts;
//      per chunk of KEYS keys it forms u = h dout^T for the whole chunk (C
//      in pieces of up to 128 columns: h and dout staged as parts; h once
//      per tile where one piece covers C), then per 16 keys the score
//      tile, a, ds = a (u - rho) once, as an A operand: dg += ds f in
//      registers, and its transpose (movmatrix) gives the warp's df_j =
//      sum over its rows of ds_ij g_i.  The warps' df add in shared memory
//      in warp order, and the block adds that, tile after tile, into its
//      own f32 slice [p, n, T, Cb] of the scratch (plain stores: no other
//      block writes it).  With f32 operands a block fills an SM's shared
//      memory, and the next chunk's loads are in flight while one is used;
//      bf16 operands stage each chunk when it is used, two blocks an SM.
//  (c) combine_kernel: df = the slices summed in block order, cast.
// Cb past kStageCb takes the WIDE instances of (a) and (b), at their
// widest groups (the score product reads the columns past the staged ones
// from global memory). The scratch, [groups, N, T] rho slices then
// [per_image, N, T, Cb] df slices, is sized on the host without asking the
// card (ops/attention.py:general_bwd_plan); bwd refuses a smaller one.

#include <math.h>
#include <stdint.h>

#include "attention_general.cuh"

namespace msau {
namespace attn {
namespace general {
namespace {

constexpr int kThreads = 256;   // the dh kernel's; the ds kernel's: DsGeom::THREADS
constexpr int kWarps = kThreads / 32;

// Parts of each operand: a, ds and dout in f32 (three) with an f32
// cotangent, rounded to bf16 (one) with a bf16 one; f, g, h three in f32
// and one in bf16.
template <typename T, typename TD>
struct Parts {
  static constexpr bool F32 = kIsF32<TD>;
  static constexpr int PA = F32 ? 3 : 1;
  static constexpr int PD = F32 ? 3 : 1;
  static constexpr int PO = kIsF32<T> ? 3 : 1;
};

// lane offsets of the ldmatrix addresses: .trans reads of a [k][n] tile
// (k = the 16 rows) and plain reads of an [n][k] tile (n = the 16 rows)
struct Lanes {
  int trans_row, trans_col, plain_row, plain_col;
  __device__ explicit Lanes(int lane)
      : trans_row((lane & 7) + 8 * ((lane >> 3) & 1)),
        trans_col(8 * (lane >> 4)),
        plain_row((lane & 7) + 8 * (lane >> 4)),
        plain_col(8 * ((lane >> 3) & 1)) {}
};

// ---- (a) dh ------------------------------------------------------------------

template <typename T, typename TD, int NT>
struct DhGeom {
  // m16 tiles of rows a warp: two where the accumulators leave room (up
  // to 96 columns, 128 with one part of a and dout: a bf16 cotangent)
  static constexpr int MT = NT <= 12 || (Parts<T, TD>::PD == 1 && NT <= 16) ? 2 : 1;
  static constexpr int BI = kWarps * 16 * MT;        // rows i per block
  static constexpr int KEYS = NT >= 32 ? 32 : 64;     // keys per staged chunk
  static constexpr int DS = NT * 8 + 8;               // dout row stride
  static constexpr int DPLANE = KEYS * DS;
  static constexpr int F = Parts<T, TD>::PD * DPLANE * 2;   // f's score rows after dout
  static int smem(int cb) { return F + KEYS * k_layout<T>(cb).row_bytes; }
  // the next chunk's loads a thread holds: dout's group columns, and f's
  // score rows up to Cb 32 (wider ones are staged when used)
  static constexpr int DITEMS = (KEYS * NT + kThreads - 1) / kThreads;
  static constexpr int SITEMS = (KEYS * max_score_stride<T>(32) + kThreads - 1) / kThreads;
};

template <typename T, typename TD, int NT, bool WIDE>
__global__ void __launch_bounds__(kThreads)
dh_kernel(const T* __restrict__ f, const T* __restrict__ g, const T* __restrict__ h,
          const TD* __restrict__ dout, const float* __restrict__ m_in,
          const float* __restrict__ l_in, T* __restrict__ dh, float* __restrict__ rho_part, int t,
          int cb, int c) {
  using G = DhGeom<T, TD, NT>;
  using P = Parts<T, TD>;
  constexpr int MT = G::MT, PA = P::PA, PD = P::PD, kKeys = G::KEYS;
  using S = ScoreT<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const KLayout L = k_layout<T>(cb);
  bf16* s_do = reinterpret_cast<bf16*>(smem);
  unsigned char* s_f = smem + G::F;

  const int n = blockIdx.z, n_batch = gridDim.z, grp = blockIdx.y;
  const int col0 = grp * NT * 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const Lanes ln(lane);
  const int r0 = blockIdx.x * G::BI + 16 * MT * warp + gq;   // this lane's first row
  const T* fn = f + (int64_t)n * t * cb;
  const T* gn = g + (int64_t)n * t * cb;
  const T* hn = h + (int64_t)n * t * c;
  const TD* don = dout + (int64_t)n * t * c;

  // per m tile: rows r0 + 16 mt (hh = 0) and + 8 (hh = 1)
  float rm[MT][2], rc[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 16 * mt + 8 * hh;
      const RowSoftmax x = row_softmax(r < t ? m_in[(int64_t)n * t + r] : 0.f,
                                       r < t ? l_in[(int64_t)n * t + r] : 0.f);
      rm[mt][hh] = x.m;
      rc[mt][hh] = P::F32 ? x.il : x.lg;
    }
  RowFrags<T, MT> fr;
  fr.load(gn, r0, t, cb, lane);
  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // each chunk issues the next one's loads before its work
  ColsStage<PD, G::DITEMS> st_d;
  ScoreStage<T, G::SITEMS> st_s;
  st_d.load(don, 0, kKeys, t, c, col0, NT * 8);
  st_s.load(fn, 0, kKeys, t, cb, L);
  for (int j0 = 0; j0 < t; j0 += kKeys) {
    __syncthreads();   // the last chunk is consumed
    st_d.store(s_do, G::DPLANE, G::DS, kKeys, NT * 8);
    st_s.store(s_f, kKeys, t, cb, L);
    __syncthreads();
    if (j0 + kKeys < t) {
      st_d.load(don, j0 + kKeys, kKeys, t, c, col0, NT * 8);
      st_s.load(fn, j0 + kKeys, kKeys, t, cb, L);
    }
    for (int jb = 0; jb < kKeys; jb += 16) {
      if (j0 + jb >= t) break;
      S s[MT][2][4];
      score_tile<MT, WIDE>(s, fr, gn, r0, fn, j0 + jb, t, cb, s_f + jb * L.row_bytes, L, lane);
      const bool ragged = j0 + jb + 16 > t;
      unsigned pa[MT][PA][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float a[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hh = e >> 1;
            const float v =
                softmax_diff<P::F32>((float)(s[mt][nt][e] - (S)rm[mt][hh]), rc[mt][hh]);
            a[nt][e] = ragged && j0 + jb + 8 * nt + 2 * tq + (e & 1) >= t ? 0.f : v;
          }
        mma_a_from_c<PA>(pa[mt], a[0], a[1]);
      }
      const bf16* drow = s_do + (jb + ln.trans_row) * G::DS + ln.trans_col;
#pragma unroll
      for (int cp = 0; cp < NT / 2; ++cp) {
        unsigned b0[PD][2], b1[PD][2];
#pragma unroll
        for (int q = 0; q < PD; ++q) {
          unsigned r[4];
          ldsm_x4_trans(r, drow + q * G::DPLANE + 16 * cp);
          b0[q][0] = r[0];
          b0[q][1] = r[1];
          b1[q][0] = r[2];
          b1[q][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_parts<PA, PD>(acc[mt][2 * cp], pa[mt], b0);
          mma_parts<PA, PD>(acc[mt][2 * cp + 1], pa[mt], b1);
        }
      }
    }
  }

  // dh written; rho_i over the group's columns: the lane's in column
  // order, then the quad's lanes (every lane of the quad ends with the sum)
  T* dhn = dh + (int64_t)n * t * c;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 16 * mt + 8 * hh;
      float sum = 0.f;
      if (r < t) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = col0 + 8 * nt + 2 * tq + e;
            if (col < c) {
              sum = fmaf(to_f32(hn[(int64_t)r * c + col]), acc[mt][nt][2 * hh + e], sum);
              store(dhn + (int64_t)r * c + col, acc[mt][nt][2 * hh + e]);
            }
          }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (tq == 0 && r < t) rho_part[((int64_t)grp * n_batch + n) * t + r] = sum;
    }
}

// ---- (b) ds, dg, df ----------------------------------------------------------

// KB: Cb padded to a multiple of 8 that the template covers (NB n8 tiles of
// dg and df; past 128 the launcher takes KB columns a launch, kg0 the
// first); C in pieces of up to kPiece columns.
constexpr int kPiece = 128;

template <typename T, typename TD, int KB>
struct DsGeom {
  using P = Parts<T, TD>;
  // 8 warps of 16 rows i, 4 where f32 operands' parts at Cb > 32 would
  // pass the 227 KB of shared memory a block may hold (bwd_rows)
  static constexpr int WARPS = P::PO == 3 && KB >= 64 ? 4 : 8;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int BI = WARPS * 16;                // rows i per tile
  // keys per chunk: 64 up to Cb 16 (and with bf16 operands up to Cb 32),
  // else 32 (16 at Cb 128): the warps' df, [WARPS][KEYS][KB] f32, in
  // shared memory
  static constexpr int KEYS = KB <= 16 || (P::PO == 1 && KB <= 32) ? 64 : KB >= 128 ? 16 : 32;
  static constexpr int SUBS = KEYS / 16;
  static constexpr int NB = KB / 8;
  static constexpr int FS = KB + 8;                    // f, g parts row stride
  static constexpr int DFI = (KEYS * KB + THREADS - 1) / THREADS;
  // the next chunk's loads a thread holds (ColsStage, ScoreStage): dout's
  // piece, f's score rows, f's parts
  // with f32 operands (a block an SM: its parts fill shared memory); bf16
  // operands stage each chunk when it is used and keep two blocks an SM
  static constexpr bool PREFETCH = P::PO == 3;
  static constexpr int MIN_BLOCKS = PREFETCH ? 1 : 2;
  static constexpr int DITEMS =
      PREFETCH ? (KEYS * (kPiece / 8) + THREADS - 1) / THREADS : 1;
  static constexpr int SITEMS =
      PREFETCH ? (KEYS * max_score_stride<T>(KB) + THREADS - 1) / THREADS : 1;
  static constexpr int FITEMS = PREFETCH ? (KEYS * (KB / 8) + THREADS - 1) / THREADS : 1;
  // byte offsets of the buffers, for C in pieces of pw columns (row
  // stride pw + 8) and Cb's score rows of row_bytes
  struct Layout {
    int pw, ps, pieces, h, d, fs, fp, gp, df, total;
  };
  __host__ __device__ static Layout layout(int cb, int c) {
    Layout y;
    const int kc = (c + 15) / 16 * 16;
    y.pw = kc < kPiece ? kc : kPiece;
    y.ps = y.pw + 8;
    y.pieces = (kc + kPiece - 1) / kPiece;
    y.h = 0;                                        // h's piece, PO planes [BI][ps]
    y.d = y.h + P::PO * BI * y.ps * 2;              // dout's piece, PD planes [KEYS][ps]
    y.fs = y.d + P::PD * KEYS * y.ps * 2;           // f's score rows
    y.fp = y.fs + KEYS * k_layout<T>(cb).row_bytes;  // f's parts [KEYS][FS]
    y.gp = y.fp + P::PO * KEYS * FS * 2;            // g's parts [BI][FS]
    y.df = y.gp + P::PO * BI * FS * 2;              // the warps' df [warp][KEYS][KB] f32
    y.total = y.df + WARPS * KEYS * KB * 4;
    return y;
  }
};

template <typename T, typename TD, int KB, bool WIDE>
__global__ void __launch_bounds__(DsGeom<T, TD, KB>::THREADS, DsGeom<T, TD, KB>::MIN_BLOCKS)
ds_kernel(const T* __restrict__ f, const T* __restrict__ g, const T* __restrict__ h,
          const TD* __restrict__ dout, const float* __restrict__ m_in,
          const float* __restrict__ l_in, const float* __restrict__ rho_part, int rho_groups,
          T* __restrict__ dg, float* __restrict__ df_partial, int t, int cb, int c, int kg0) {
  using G = DsGeom<T, TD, KB>;
  using P = Parts<T, TD>;
  constexpr int PA = P::PA, PD = P::PD, PO = P::PO, NB = G::NB, kKeys = G::KEYS;
  using S = ScoreT<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const KLayout L = k_layout<T>(cb);
  const typename G::Layout Y = G::layout(cb, c);
  bf16* s_h = reinterpret_cast<bf16*>(smem + Y.h);
  bf16* s_do = reinterpret_cast<bf16*>(smem + Y.d);
  unsigned char* s_fs = smem + Y.fs;
  bf16* s_fp = reinterpret_cast<bf16*>(smem + Y.fp);
  bf16* s_gp = reinterpret_cast<bf16*>(smem + Y.gp);
  float* s_df = reinterpret_cast<float*>(smem + Y.df);
  const int hplane = G::BI * Y.ps, dplane = kKeys * Y.ps;
  constexpr int FPLANE = kKeys * G::FS, GPLANE = G::BI * G::FS;

  const int per_image = gridDim.x, p = blockIdx.x, n = blockIdx.y, n_batch = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const Lanes ln(lane);
  const int tiles = (t + G::BI - 1) / G::BI;
  const int kc = (c + 15) / 16 * 16;
  const int kw = cb - kg0 < KB ? cb - kg0 : KB;   // this launch's columns of Cb
  const T* fn = f + (int64_t)n * t * cb;
  const T* gn = g + (int64_t)n * t * cb;
  const T* hn = h + (int64_t)n * t * c;
  const TD* don = dout + (int64_t)n * t * c;
  float* pn = df_partial + ((int64_t)p * n_batch + n) * t * cb;
  ColsStage<PD, G::DITEMS> st_d;
  ScoreStage<T, G::SITEMS> st_s;
  ColsStage<PO, G::FITEMS> st_f;
  // the loads of step (j0, pc): dout's piece pc of keys j0, and at pc 0
  // f's score rows and parts
  auto prefetch = [&](int j0, int pc) {
    st_d.load(don, j0, kKeys, t, c, pc * kPiece, Y.pw);
    if (pc == 0) {
      st_s.load(fn, j0, kKeys, t, cb, L);
      st_f.load(fn, j0, kKeys, t, cb, kg0, KB);
    }
  };

  for (int tile = p; tile < tiles; tile += per_image) {
    const bool first = tile == p;
    const int i0 = tile * G::BI;
    const int r0 = i0 + 16 * warp + gq;   // this lane's rows r0 and r0 + 8
    float rm[2], rc[2], rho[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 8 * hh;
      const RowSoftmax x = row_softmax(r < t ? m_in[(int64_t)n * t + r] : 0.f,
                                       r < t ? l_in[(int64_t)n * t + r] : 0.f);
      rm[hh] = x.m;
      rc[hh] = P::F32 ? x.il : x.lg;
      float sum = 0.f;
      if (r < t)
        for (int z = 0; z < rho_groups; ++z) sum += rho_part[((int64_t)z * n_batch + n) * t + r];
      rho[hh] = sum;
    }
    RowFrags<T, 1> fr;
    fr.load(gn, r0, t, cb, lane);
    __syncthreads();   // the last tile's buffers are consumed
    stage_cols<PO>(s_gp, GPLANE, G::FS, gn, i0, G::BI, t, cb, kg0, KB);
    if (Y.pieces == 1) stage_cols<PO>(s_h, hplane, Y.ps, hn, i0, G::BI, t, c, 0, Y.pw);
    float dga[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) dga[nb][e] = 0.f;

    // the first chunk's loads (each chunk issues the next one's before its
    // work: the last chunk of a tile, the next tile's first)
    if (G::PREFETCH && first) prefetch(0, 0);
    for (int j0 = 0; j0 < t; j0 += kKeys) {
      // this block's slice of df for these keys so far, loaded ahead of the
      // chunk's work
      float prev[G::DFI];
#pragma unroll
      for (int it = 0; it < G::DFI; ++it) {
        const int e = threadIdx.x + it * G::THREADS;
        const int jj = e / kw;
        prev[it] = !first && e < kKeys * kw && j0 + jj < t
                       ? pn[(int64_t)(j0 + jj) * cb + kg0 + e - jj * kw]
                       : 0.f;
      }
      // u = h dout^T for the chunk's keys, C in pieces
      float u[G::SUBS][2][4];
#pragma unroll
      for (int sb = 0; sb < G::SUBS; ++sb)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) u[sb][nt][e] = 0.f;
      for (int pc = 0; pc < Y.pieces; ++pc) {
        __syncthreads();   // the last piece (and the df sums) are consumed
        const int c0 = pc * kPiece;
        if (Y.pieces > 1) stage_cols<PO>(s_h, hplane, Y.ps, hn, i0, G::BI, t, c, c0, Y.pw);
        if constexpr (G::PREFETCH) {
          st_d.store(s_do, dplane, Y.ps, kKeys, Y.pw);
          if (pc == 0) {
            st_s.store(s_fs, kKeys, t, cb, L);
            st_f.store(s_fp, FPLANE, G::FS, kKeys, KB);
          }
        } else {
          stage_cols<PD>(s_do, dplane, Y.ps, don, j0, kKeys, t, c, c0, Y.pw);
          if (pc == 0) {
            stage_score_rows<T>(s_fs, fn, j0, kKeys, t, cb, L);
            stage_cols<PO>(s_fp, FPLANE, G::FS, fn, j0, kKeys, t, cb, kg0, KB);
          }
        }
        __syncthreads();
        // the next step's loads: the next piece, the next chunk's first, or
        // the next tile's first chunk
        if constexpr (G::PREFETCH) {
          if (pc + 1 < Y.pieces)
            prefetch(j0, pc + 1);
          else if (j0 + kKeys < t)
            prefetch(j0 + kKeys, 0);
          else if (tile + per_image < tiles)
            prefetch(0, 0);
        }
        const int steps = ((kc - c0 < Y.pw ? kc - c0 : Y.pw) + 15) / 16;
        const bf16* arow = s_h + (16 * warp + ln.trans_row) * Y.ps + ln.trans_col;
        for (int kt = 0; kt < steps; ++kt) {
          unsigned a[PO][4];
#pragma unroll
          for (int q = 0; q < PO; ++q) ldsm_x4(a[q], arow + q * hplane + 16 * kt);
#pragma unroll
          for (int sb = 0; sb < G::SUBS; ++sb) {
            unsigned b0[PD][2], b1[PD][2];
#pragma unroll
            for (int q = 0; q < PD; ++q) {
              unsigned r[4];
              ldsm_x4(r, s_do + q * dplane + (16 * sb + ln.plain_row) * Y.ps + ln.plain_col +
                             16 * kt);
              b0[q][0] = r[0];
              b0[q][1] = r[1];
              b1[q][0] = r[2];
              b1[q][1] = r[3];
            }
            mma_parts<PO, PD>(u[sb][0], a, b0);
            mma_parts<PO, PD>(u[sb][1], a, b1);
          }
        }
      }
#pragma unroll
      for (int sb = 0; sb < G::SUBS; ++sb) {
        const int jb = 16 * sb;
        if (j0 + jb >= t) break;
        S s[1][2][4];
        score_tile<1, WIDE>(s, fr, gn, r0, fn, j0 + jb, t, cb, s_fs + jb * L.row_bytes, L, lane);
        // ds = a (u - rho), split (bf16: rounded) as an A operand (k = j)
        const bool ragged = j0 + jb + 16 > t;
        float d[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hh = e >> 1;
            const float a = softmax_diff<P::F32>((float)(s[0][nt][e] - (S)rm[hh]), rc[hh]);
            const float v = a * (u[sb][nt][e] - rho[hh]);
            d[nt][e] = ragged && j0 + jb + 8 * nt + 2 * tq + (e & 1) >= t ? 0.f : v;
          }
        unsigned dsa[PA][4];
        mma_a_from_c<PA>(dsa, d[0], d[1]);
        // dg += ds f: f rows j as the B operand (k = j)
        const bf16* frow = s_fp + (jb + ln.trans_row) * G::FS;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          unsigned fb[PO][2];
#pragma unroll
          for (int q = 0; q < PO; ++q) ldsm_x2_trans(fb[q], frow + q * FPLANE + 8 * nb);
          mma_parts<PA, PO>(dga[nb], dsa, fb);
        }
        // this warp's df_j = sum over its rows of ds_ij g_i: ds^T (rows j,
        // k = i) against g's rows
        unsigned at[PA][4];
        mma_a_transposed<PA>(at, dsa);
        const bf16* grow = s_gp + (16 * warp + ln.trans_row) * G::FS;
        float* mine = s_df + (warp * kKeys + jb + gq) * KB + 2 * tq;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          unsigned gb[PO][2];
#pragma unroll
          for (int q = 0; q < PO; ++q) ldsm_x2_trans(gb[q], grow + q * GPLANE + 8 * nb);
          float dfw[4] = {0.f, 0.f, 0.f, 0.f};
          mma_parts<PA, PO>(dfw, at, gb);
          *reinterpret_cast<float2*>(mine + 8 * nb) = make_float2(dfw[0], dfw[1]);
          *reinterpret_cast<float2*>(mine + 8 * KB + 8 * nb) = make_float2(dfw[2], dfw[3]);
        }
      }
      __syncthreads();
      // the block's df for these keys: the warps in order, added to this
      // block's slice (the first tile stores)
#pragma unroll
      for (int it = 0; it < G::DFI; ++it) {
        const int e = threadIdx.x + it * G::THREADS;
        const int jj = e / kw, k = e - jj * kw;
        if (e >= kKeys * kw || j0 + jj >= t) continue;
        float v = s_df[jj * KB + k];
#pragma unroll
        for (int w = 1; w < G::WARPS; ++w) v += s_df[(w * kKeys + jj) * KB + k];
        pn[(int64_t)(j0 + jj) * cb + kg0 + k] = first ? v : prev[it] + v;
      }
    }

    T* dgn = dg + (int64_t)n * t * cb;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 8 * hh;
      if (r >= t) continue;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 8 * nb + 2 * tq + e;
          if (k < kw) store(dgn + (int64_t)r * cb + kg0 + k, dga[nb][2 * hh + e]);
        }
    }
  }
}

// ---- launch ----------------------------------------------------------------------

template <typename T, typename TD, int NT, bool WIDE = false>
int launch_dh(const void* f, const void* g, const void* h, const void* dout, const void* m,
              const void* l, void* dh, float* rho, int n, int t, int cb, int c,
              cudaStream_t stream) {
  using G = DhGeom<T, TD, NT>;
  auto kernel = dh_kernel<T, TD, NT, WIDE>;
  const int smem = G::smem(cb);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t + G::BI - 1) / G::BI, (c + NT * 8 - 1) / (NT * 8), n);
  kernel<<<grid, kThreads, smem, stream>>>((const T*)f, (const T*)g, (const T*)h,
                                           (const TD*)dout, (const float*)m, (const float*)l,
                                           (T*)dh, rho, t, cb, c);
  return (int)cudaGetLastError();
}

template <typename T, typename TD, int KB, bool WIDE = false>
int launch_ds(const void* f, const void* g, const void* h, const void* dout, const void* m,
              const void* l, const float* rho, int rho_groups, void* dg, float* dfp,
              int per_image, int n, int t, int cb, int c, cudaStream_t stream) {
  using G = DsGeom<T, TD, KB>;
  auto kernel = ds_kernel<T, TD, KB, WIDE>;
  const int smem = G::layout(cb, c).total;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  // Cb past KB: one launch per KB columns of dg and df, each with the
  // whole score product
  for (int kg0 = 0; kg0 < cb && err == cudaSuccess; kg0 += KB) {
    kernel<<<dim3(per_image, n), G::THREADS, smem, stream>>>(
        (const T*)f, (const T*)g, (const T*)h, (const TD*)dout, (const float*)m,
        (const float*)l, rho, rho_groups, (T*)dg, dfp, t, cb, c, kg0);
    err = cudaGetLastError();
  }
  return (int)err;
}

// (c): df from the slices
template <typename T>
int combine(const float* dfp, void* df, int n, int t, int cb, int per_image,
            cudaStream_t stream) {
  const int64_t count = (int64_t)n * t * cb;
  combine_kernel<T><<<(unsigned)((count + 255) / 256), 256, 0, stream>>>(dfp, (T*)df, count,
                                                                         per_image);
  return (int)cudaGetLastError();
}

template <typename T, typename TD>
int bwd_t(const void* f, const void* g, const void* h, const void* dout, const void* m,
          const void* l, void* df, void* dg, void* dh, float* scratch, int per_image, int n,
          int t, int cb, int c, cudaStream_t stream) {
  const int groups = bwd_rho_groups(c);
  float* rho = scratch;
  float* dfp = scratch + (int64_t)groups * n * t;
  // Cb past kStageCb: the WIDE instances (their score product reads the
  // further columns from global memory), with the widest groups
  if (cb > kStageCb) {
    int err = launch_dh<T, TD, 32, true>(f, g, h, dout, m, l, dh, rho, n, t, cb, c, stream);
    if (err == 0)
      err = launch_ds<T, TD, 128, true>(f, g, h, dout, m, l, rho, groups, dg, dfp, per_image, n,
                                        t, cb, c, stream);
    return err != 0 ? err : combine<T>(dfp, df, n, t, cb, per_image, stream);
  }
  // (a): the narrowest group that covers C, up to 256 columns
  int err;
  if (c <= 32)
    err = launch_dh<T, TD, 4>(f, g, h, dout, m, l, dh, rho, n, t, cb, c, stream);
  else if (c <= 64)
    err = launch_dh<T, TD, 8>(f, g, h, dout, m, l, dh, rho, n, t, cb, c, stream);
  else if (c <= 96)
    err = launch_dh<T, TD, 12>(f, g, h, dout, m, l, dh, rho, n, t, cb, c, stream);
  else if (c <= 128)
    err = launch_dh<T, TD, 16>(f, g, h, dout, m, l, dh, rho, n, t, cb, c, stream);
  else
    err = launch_dh<T, TD, 32>(f, g, h, dout, m, l, dh, rho, n, t, cb, c, stream);
  if (err != 0) return err;
  // (b): Cb's n8 tiles
  if (cb <= 16)
    err = launch_ds<T, TD, 16>(f, g, h, dout, m, l, rho, groups, dg, dfp, per_image, n, t, cb, c,
                               stream);
  else if (cb <= 32)
    err = launch_ds<T, TD, 32>(f, g, h, dout, m, l, rho, groups, dg, dfp, per_image, n, t, cb, c,
                               stream);
  else if (cb <= 64)
    err = launch_ds<T, TD, 64>(f, g, h, dout, m, l, rho, groups, dg, dfp, per_image, n, t, cb, c,
                               stream);
  else
    err = launch_ds<T, TD, 128>(f, g, h, dout, m, l, rho, groups, dg, dfp, per_image, n, t, cb,
                                c, stream);
  return err != 0 ? err : combine<T>(dfp, df, n, t, cb, per_image, stream);
}

}  // namespace

int bwd(const void* f, const void* g, const void* h, const void* dout, const void* m,
        const void* l, void* df, void* dg, void* dh, float* scratch, int64_t scratch_floats,
        int per_image, int n, int t, int cb, int c, bool is_bf16, bool dout_f32,
        cudaStream_t stream) {
  const int rows = bwd_rows(cb, !is_bf16);
  if (cb <= 0 || c <= 0 || per_image < 1 || per_image > (t + rows - 1) / rows)
    return (int)cudaErrorInvalidValue;
  // the rho slices, then the df slices: what the kernels write
  if (scratch_floats < ((int64_t)bwd_rho_groups(c) + (int64_t)per_image * cb) * n * t)
    return (int)cudaErrorInvalidValue;
  if (!is_bf16)
    return bwd_t<float, float>(f, g, h, dout, m, l, df, dg, dh, scratch, per_image, n, t, cb, c,
                               stream);
  if (dout_f32)
    return bwd_t<bf16, float>(f, g, h, dout, m, l, df, dg, dh, scratch, per_image, n, t, cb, c,
                              stream);
  return bwd_t<bf16, bf16>(f, g, h, dout, m, l, df, dg, dh, scratch, per_image, n, t, cb, c,
                           stream);
}

}  // namespace general
}  // namespace attn
}  // namespace msau
