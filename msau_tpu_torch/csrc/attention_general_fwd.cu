// The attention forward at any width (attention_general.cuh): the general
// counterpart of attention.cu's stats and accumulate kernels, behind
// msau_resident_attention_fwd and msau_fused_attention_fwd for every (Cb,
// C) outside ops/attention.py:SPECIALISED_WIDTHS.  Replaces, with them, the
// TPU kernels msau_tpu/ops/pallas_attn.py:_res_fwd_kernel (launcher
// _resident_forward) and _stats_kernel / _accum_kernel (_fused_forward).
//
// What bounds it on the H100 (9a: N 16, T 4096, Cb 12, C 96): the N T^2 =
// 268 M exponentials per pass (~0.07 ms on the SFUs) and A^T h, 25.8 G
// multiply-adds (0.05 ms at the bf16 tensor-core peak; six bf16 products
// each with f32 operands); the score product, 3.2 G multiply-adds, runs in
// f64 for f32 operands (0.1 ms at the FP64 tensor-core peak).
//
// Design: two launches, as attention.cu's, each a persistent grid of
// 8-warp blocks sized by the occupancy API; no atomics and no scratch.
//  (a) stats_kernel: a block owns 32 wr rows i (a warp 32); the other 8 /
//      wr warps split the keys of each staged chunk of 128; online (m, l)
//      per row, merged over a quad's lanes and then the block's warps in
//      a fixed order.
//  (b) accum_kernel: a block owns 16 MT wj rows j and one group of NT n8
//      tiles of C (the grid takes the groups); the other 8 / wj warps
//      split the rows i of each staged chunk of 128 (fewer where wide f64
//      score rows need the room: fit_chunk; g's score rows, h's group
//      columns as parts, m, l).  Per 16 rows i a warp forms S^T[j,
//      i], A^T in registers and, with it as the A operand (mma_a_from_c),
//      out += A^T h (h by ldmatrix.trans); the warps that split i add their
//      sums in shared memory in warp order.
// wr and wj take the fewest waves of the card's resident blocks, each as
// long as a block's rows (pick_warps; N 1 at T 4096 gives 128 blocks of
// 32 rows j at C 96).  Cb past kStageCb takes each kernel's WIDE instance
// (the score product reads the columns past the staged ones from global
// memory; accumulate at its widest group), so the others' code is as at
// Cb <= kStageCb.

#include <math.h>
#include <stdint.h>

#include <mutex>
#include <vector>

#include "attention_general.cuh"

namespace msau {
namespace attn {
namespace general {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;   // keys (a) or rows i (b) staged per step
constexpr int kStatsMT = 2;   // m16 tiles of rows per warp in (a)
constexpr int kStatsMerge = kWarps * 32 * kStatsMT * 4 * 4;   // bytes

// Rows a step: kChunk, or fewer where wide f64 score rows (row_bytes each)
// and ``fixed`` bytes would pass the 227 KB of shared memory a block may
// hold (Cb 128 and wider in f32)
__host__ __device__ inline int fit_chunk(int row_bytes, int fixed) {
  int chunk = kChunk;
  while (chunk > 16 && chunk * row_bytes + fixed > 227 * 1024) chunk /= 2;
  return chunk;
}

// ---- (a) stats ----------------------------------------------------------

template <typename T, bool WIDE>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const T* __restrict__ f, const T* __restrict__ g, float* __restrict__ m_out,
             float* __restrict__ l_out, int t, int cb, int n_batch, int wr, int chunk) {
  constexpr int MT = kStatsMT;
  using S = ScoreT<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const KLayout L = k_layout<T>(cb);
  unsigned char* s_keys = smem;
  float* s_merge = reinterpret_cast<float*>(smem + chunk * L.row_bytes);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tq = lane % 4;
  const int ws = kWarps / wr, wrow = warp % wr, wsi = warp / wr;
  const int rows = 16 * MT * wr;
  const int tiles = (t + rows - 1) / rows;

  for (int item = blockIdx.x; item < n_batch * tiles; item += gridDim.x) {
    const int n = item / tiles;
    const int r0 = (item % tiles) * rows + 16 * MT * wrow + lane / 4;   // this lane's first row
    const T* fn = f + (int64_t)n * t * cb;
    const T* gn = g + (int64_t)n * t * cb;
    RowFrags<T, MT> fr;
    fr.load(gn, r0, t, cb, lane);
    float mrun[MT][2], lrun[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) mrun[mt][hh] = -INFINITY, lrun[mt][hh] = 0.f;
    for (int j0 = 0; j0 < t; j0 += chunk) {
      __syncthreads();   // the last chunk (or the last item's merge) is consumed
      stage_score_rows<T>(s_keys, fn, j0, chunk, t, cb, L);
      __syncthreads();
      for (int sub = wsi; sub < chunk / 16; sub += ws) {
        const int jb = 16 * sub;
        if (j0 + jb >= t) break;
        S s[MT][2][4];
        score_tile<MT, WIDE>(s, fr, gn, r0, fn, j0 + jb, t, cb, s_keys + jb * L.row_bytes, L, lane);
        if (j0 + jb + 16 > t) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (j0 + jb + 8 * nt + 2 * tq + (e & 1) >= t) s[mt][nt][e] = (S)-INFINITY;
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const S v[4] = {s[mt][0][2 * hh], s[mt][0][2 * hh + 1], s[mt][1][2 * hh],
                            s[mt][1][2 * hh + 1]};
            const S v01 = v[0] > v[1] ? v[0] : v[1], v23 = v[2] > v[3] ? v[2] : v[3];
            const S vm = v01 > v23 ? v01 : v23;
            // m is the largest score rounded to f32, as the output holds it
            const float mt4 = (float)vm;
            float& m = mrun[mt][hh];
            float& l = lrun[mt][hh];
            if (mt4 > -INFINITY) {
              if (mt4 > m) {
                l *= __expf(m - mt4);   // m = -inf: l is 0 and stays 0
                m = mt4;
              }
              const S ms = (S)m;
              l += (ex2((float)(v[0] - ms) * kLog2e) + ex2((float)(v[1] - ms) * kLog2e)) +
                   (ex2((float)(v[2] - ms) * kLog2e) + ex2((float)(v[3] - ms) * kLog2e));
            }
          }
      }
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
  }
}

// ---- (b) accumulate -----------------------------------------------------

// T: the operands' type; TO: the output's.  An f32 output keeps A in f32
// (three bf16 parts, PA, and the plain version's two steps), a bf16 output
// rounds A to bf16 with the folded exponent, as _res_fwd_kernel rounds it.
// h: three parts in f32, one in bf16 (PH).  MT m16 tiles of rows j a warp,
// NT n8 tiles of C a group.
template <typename T, int NT, typename TO>
struct AccGeom {
  static constexpr bool AF32 = kIsF32<TO>;
  static constexpr int PA = AF32 ? 3 : 1;
  static constexpr int PH = kIsF32<T> ? 3 : 1;
  static_assert(AF32 || !kIsF32<T>, "f32 operands give an f32 output");
  static constexpr int MT = NT <= 12 ? 2 : 1;
  static constexpr int HS = NT * 8 + 8;          // h row stride, elements
  static constexpr int ACC = MT * NT * 4;        // floats per lane
  static constexpr int RED = (kWarps - 1) * 32 * ACC * 4;
  // byte offsets for ``chunk`` rows i a step: h's planes, m, l, then g's
  // score rows; the warps' sums alias them after the sweep
  struct Layout {
    int plane, m, l, g, total;
  };
  __host__ __device__ static Layout layout(int cb, int chunk) {
    Layout y;
    y.plane = chunk * HS;
    y.m = PH * y.plane * 2;
    y.l = y.m + chunk * 4;
    y.g = y.l + chunk * 4;
    y.total = y.g + chunk * k_layout<T>(cb).row_bytes;
    if (y.total < RED) y.total = RED;
    return y;
  }
  // the rows a step (fit_chunk): h's parts, m, l and g's score row a row
  static int chunk(int cb) { return fit_chunk(PH * HS * 2 + 8 + k_layout<T>(cb).row_bytes, 0); }
};

template <typename T, int NT, typename TO, bool WIDE>
__global__ void __launch_bounds__(kThreads)
accum_kernel(const T* __restrict__ f, const T* __restrict__ g, const T* __restrict__ h,
             const float* __restrict__ m_in, const float* __restrict__ l_in, TO* __restrict__ out,
             int t, int cb, int c, int n_batch, int wj, int chunk) {
  using A = AccGeom<T, NT, TO>;
  constexpr int PA = A::PA, PH = A::PH, MT = A::MT;
  using S = ScoreT<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const KLayout L = k_layout<T>(cb);
  const typename A::Layout Y = A::layout(cb, chunk);
  bf16* s_h = reinterpret_cast<bf16*>(smem);
  float* s_m = reinterpret_cast<float*>(smem + Y.m);
  float* s_l = reinterpret_cast<float*>(smem + Y.l);
  unsigned char* s_g = smem + Y.g;
  float* s_red = reinterpret_cast<float*>(smem);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int wi = kWarps / wj, wjx = warp % wj, wix = warp / wj;
  const int rows = 16 * MT * wj;
  const int tiles = (t + rows - 1) / rows;
  const int groups = (c + NT * 8 - 1) / (NT * 8);
  const bf16* hrow = s_h + ((lane & 7) + 8 * ((lane >> 3) & 1)) * A::HS + 8 * (lane >> 4);

  for (int item = blockIdx.x; item < n_batch * tiles * groups; item += gridDim.x) {
    const int n = item / (tiles * groups), rest = item % (tiles * groups);
    const int j0w = (rest / groups) * rows + 16 * MT * wjx;   // this warp's rows j
    const int col0 = (rest % groups) * NT * 8;
    const T* fn = f + (int64_t)n * t * cb;
    const T* gn = g + (int64_t)n * t * cb;
    const T* hn = h + (int64_t)n * t * c;
    RowFrags<T, MT> fr;
    fr.load(fn, j0w + gq, t, cb, lane);
    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

    for (int i0 = 0; i0 < t; i0 += chunk) {
      __syncthreads();   // the last chunk (or the last item's sums) is consumed
      stage_score_rows<T>(s_g, gn, i0, chunk, t, cb, L);
      stage_cols<PH>(s_h, Y.plane, A::HS, hn, i0, chunk, t, c, col0, NT * 8);
      // each row's softmax constants: 1 / l where A stays f32, log2 l where
      // it is rounded to bf16 (rows past t: m = l = 0, g = 0, so A = 0)
      for (int r = threadIdx.x; r < chunk; r += kThreads) {
        const int i = i0 + r;
        const float mv = i < t ? m_in[(int64_t)n * t + i] : 0.f;
        const RowSoftmax x = row_softmax(mv, i < t ? l_in[(int64_t)n * t + i] : 0.f);
        s_m[r] = mv;
        s_l[r] = A::AF32 ? x.il : x.lg;
      }
      __syncthreads();
      for (int sub = wix; sub < chunk / 16; sub += wi) {
        const int ib = 16 * sub;
        if (i0 + ib >= t) break;
        // S^T[j, i]: rows j from f, columns i from the chunk's g
        S s[MT][2][4];
        score_tile<MT, WIDE>(s, fr, fn, j0w + gq, gn, i0 + ib, t, cb, s_g + ib * L.row_bytes, L,
                             lane);
        float mc[2][2], lc[2][2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float2 mv = *reinterpret_cast<const float2*>(s_m + ib + 8 * nt + 2 * tq);
          const float2 lv = *reinterpret_cast<const float2*>(s_l + ib + 8 * nt + 2 * tq);
          mc[nt][0] = mv.x, mc[nt][1] = mv.y, lc[nt][0] = lv.x, lc[nt][1] = lv.y;
        }
        unsigned pa[MT][PA][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float a[2][4];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              a[nt][e] = softmax_diff<A::AF32>((float)(s[mt][nt][e] - (S)mc[nt][e & 1]),
                                               lc[nt][e & 1]);
          mma_a_from_c<PA>(pa[mt], a[0], a[1]);
        }
        // out[j, group] += A^T[j, i] h[i, group], two n8 tiles at a time
#pragma unroll
        for (int cp = 0; cp < NT / 2; ++cp) {
          unsigned b0[PH][2], b1[PH][2];
#pragma unroll
          for (int q = 0; q < PH; ++q) {
            unsigned r[4];
            ldsm_x4_trans(r, hrow + q * Y.plane + ib * A::HS + 16 * cp);
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
    }
    __syncthreads();   // every warp is done with the last chunk
    // the warps that split i add their sums, in warp order (s_red aliases
    // the chunk)
    if (wi > 1) {
      if (wix > 0) {
        float* mine = s_red + ((wix - 1) * wj + wjx) * 32 * A::ACC + lane;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) mine[((mt * NT + nt) * 4 + e) * 32] = acc[mt][nt][e];
      }
      __syncthreads();
      if (wix == 0) {
        for (int w = 1; w < wi; ++w) {
          const float* o = s_red + ((w - 1) * wj + wjx) * 32 * A::ACC + lane;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[mt][nt][e] += o[((mt * NT + nt) * 4 + e) * 32];
        }
      }
    }
    if (wix == 0) {
      TO* on = out + (int64_t)n * t * c;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int j = j0w + 16 * mt + gq + 8 * hh;
          if (j >= t) continue;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int col = col0 + 8 * nt + 2 * tq;
            if (col < c) store(on + (int64_t)j * c + col, acc[mt][nt][2 * hh]);
            if (col + 1 < c) store(on + (int64_t)j * c + col + 1, acc[mt][nt][2 * hh + 1]);
          }
        }
    }
  }
}

// ---- launch ---------------------------------------------------------------

// Block slots the card holds at once for ``kernel`` at ``smem`` bytes of
// shared memory (blocks per SM from the occupancy API, times the SMs); < 0:
// a CUDA error.  Asked once for each (kernel, shared memory, device) and
// kept, so a call after the first makes no runtime query.  The kernel's
// shared-memory allowance only grows (the widest asked so far), so every
// kept answer stays launchable.
template <typename Kernel>
int card_slots(Kernel kernel, int smem) {
  struct Seen {
    const void* kernel;
    int smem, dev, slots;
  };
  static std::mutex mu;
  static std::vector<Seen> seen;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  const void* key = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  int allowed = 0;
  for (const Seen& x : seen) {
    if (x.kernel != key || x.dev != dev) continue;
    if (x.smem == smem) return x.slots;
    allowed = allowed > x.smem ? allowed : x.smem;
  }
  if (smem > allowed) err = allow_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return -(int)err;
  if (per_sm <= 0) return -(int)cudaErrorInvalidConfiguration;
  seen.push_back({key, smem, dev, per_sm * sms});
  return per_sm * sms;
}

// The warps-per-block layout w in {8, 4, 2, 1} (w warps along the kernel's
// own rows, 8 / w splitting the summed axis) that takes the fewest sweeps:
// units * ceil(t / (rows_per_warp w)) blocks run in ceil(blocks / slots)
// waves, each as long as a block's rows; a tie goes to the larger w.
int pick_warps(int64_t units, int t, int rows_per_warp, int slots) {
  int best = kWarps;
  int64_t best_cost = -1;
  for (int w = kWarps; w >= 1; w /= 2) {
    const int64_t blocks = units * ((t + rows_per_warp * w - 1) / (rows_per_warp * w));
    const int64_t cost = (blocks + slots - 1) / slots * w;
    if (best_cost < 0 || cost < best_cost) {
      best = w;
      best_cost = cost;
    }
  }
  return best;
}

template <typename T, int NT, typename TO, bool WIDE = false>
int launch_accum(const void* f, const void* g, const void* h, const void* m, const void* l,
                 void* out, int n, int t, int cb, int c, cudaStream_t stream) {
  using A = AccGeom<T, NT, TO>;
  auto kernel = accum_kernel<T, NT, TO, WIDE>;
  const int chunk = A::chunk(cb);
  const int smem = A::layout(cb, chunk).total;
  const int slots = card_slots(kernel, smem);
  if (slots < 0) return -slots;
  const int groups = (c + NT * 8 - 1) / (NT * 8);
  const int wj = pick_warps((int64_t)n * groups, t, 16 * A::MT, slots);
  const int64_t items = (int64_t)n * groups * ((t + 16 * A::MT * wj - 1) / (16 * A::MT * wj));
  kernel<<<(unsigned)(items < slots ? items : slots), kThreads, smem, stream>>>(
      (const T*)f, (const T*)g, (const T*)h, (const float*)m, (const float*)l, (TO*)out, t, cb,
      c, n, wj, chunk);
  return (int)cudaGetLastError();
}

template <typename T, typename TO>
int fwd_t(const void* f, const void* g, const void* h, void* out, void* m, void* l, int n, int t,
          int cb, int c, cudaStream_t stream) {
  // Cb past kStageCb: the WIDE instances (their score product reads the
  // further columns from global memory), with C's widest group
  const bool wide = cb > kStageCb;
  auto stats = wide ? stats_kernel<T, true> : stats_kernel<T, false>;
  const int chunk = fit_chunk(k_layout<T>(cb).row_bytes, kStatsMerge);
  const int smem = chunk * k_layout<T>(cb).row_bytes + kStatsMerge;
  const int slots = card_slots(stats, smem);
  if (slots < 0) return -slots;
  const int wr = pick_warps(n, t, 16 * kStatsMT, slots);
  const int64_t items = (int64_t)n * ((t + 16 * kStatsMT * wr - 1) / (16 * kStatsMT * wr));
  stats<<<(unsigned)(items < slots ? items : slots), kThreads, smem, stream>>>(
      (const T*)f, (const T*)g, (float*)m, (float*)l, t, cb, n, wr, chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the narrowest group that covers C, up to 128 columns (16 n8 tiles)
  if (wide) return launch_accum<T, 16, TO, true>(f, g, h, m, l, out, n, t, cb, c, stream);
  if (c <= 32) return launch_accum<T, 4, TO>(f, g, h, m, l, out, n, t, cb, c, stream);
  if (c <= 64) return launch_accum<T, 8, TO>(f, g, h, m, l, out, n, t, cb, c, stream);
  if (c <= 96) return launch_accum<T, 12, TO>(f, g, h, m, l, out, n, t, cb, c, stream);
  return launch_accum<T, 16, TO>(f, g, h, m, l, out, n, t, cb, c, stream);
}

}  // namespace

int fwd(const void* f, const void* g, const void* h, void* out, void* m, void* l, int n, int t,
        int cb, int c, bool is_bf16, bool out_f32, cudaStream_t stream) {
  if (cb <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  if (!is_bf16) return fwd_t<float, float>(f, g, h, out, m, l, n, t, cb, c, stream);
  if (out_f32) return fwd_t<bf16, float>(f, g, h, out, m, l, n, t, cb, c, stream);
  return fwd_t<bf16, bf16>(f, g, h, out, m, l, n, t, cb, c, stream);
}

}  // namespace general
}  // namespace attn
}  // namespace msau
