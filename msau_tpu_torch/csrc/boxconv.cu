// Learnable box filter (the box convolution of msau_tpu_torch/ops/boxconv.py:
// box_conv2d), forward and backward, NCHW; x (and dx) f32 or bf16, the
// coordinates, the output and its cotangent f32, every sum in f32:
//
//   out[n, c*B + b, i, j] = (1 / A_cb) sum_{r, s} x[n, c, r, s] wy_cb(r - i) wx_cb(s - j)
//
// where each (channel c, box b) holds raw coordinates ybox[:, c, b] and
// xbox[:, c, b] ([2, C, B], min and max), ordered by min / max and clipped
// to +-max_h / +-max_w (y1 <= y2, x1 <= x2); wy is 1 on the rows i + y1 ..
// i + y2 + 1 of a linear blend at both ends (the exclusive integral image II
// sampled at y2 + 1 and at y1, each a blend of its two neighbouring rows),
// x is zero past the image (II's index clamp), A = max(area, 1) with
// area = (y2 - y1 + 1)(x2 - x1 + 1), or 1 without normalisation.  The
// backward returns the input's gradient and the gradients to the raw
// coordinates, with ops/boxconv.py's tie rules: min / max of a tied pair and
// a clip at its bound pass half the gradient (torch.minimum /
// torch.maximum, as jnp.clip).
//
// Replaces no TPU kernel: the JAX package computes the box filter in XLA
// (two banded einsums over the padded integral image, msau_tpu/ops/
// boxconv.py), which costs O(H) multiply-adds an output where the filter
// needs O(1) reads.  What bounds it on the H100: memory.  A scale-0 call of
// the BMSAU (x [16, 8, 512, 512]) reads 134 MB and writes 403 MB; its
// backward reads 403 + 134 MB and writes 134 MB.
//
// Design.  A block takes one (image, channel) plane's tile of up to 64 x 64
// outputs and builds the tile's own integral image in shared memory over
// the tile and a halo of max + 2 rows and columns (zeros past the image),
// so its values stay small (up to 122 x 122 of the inputs' magnitude at
// max 28, where one over a 512 x 512 plane reaches 2.6e5 of it); the
// tile-local base cancels, since each axis's four weights sum to 0.  A
// sample is 16 reads (4 rows x 4 columns, the blends of both corners of
// both axes); a thread walks down its column of the tile, 16 outputs, and
// reads 2 new rows of 4 an output (``Walk``), a warp a row's consecutive
// columns.
//  filter_fwd: load the halo region (row and column 0 zero), a prefix sum
//    along each row (a thread a row) and down each column (a thread a
//    column), then each box's outputs, written coalesced.
//  filter_bwd: per box, the integral image of that box's cotangent plane,
//    sampled by the transposed filter (offsets 1 - o): over 1 / A and
//    summed over the boxes, dx; the same 16 samples against x give the
//    coordinates' 5 sums a box (the edge integrals of the cotangent and
//    the unnormalised sum, by the filter's transposition), reduced over
//    the block in a fixed order into a partial per block.  The last block
//    of a channel to finish (an integer ticket; no float atomics) sums the
//    channel's partials over N x tiles in block order, in f64, applies the
//    chain rule through the area, the clips and the ordering, writes the
//    coordinates' gradients and resets the ticket.  So one launch forward,
//    one backward (three integral images, one a box), and a rerun gives
//    the same bits.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace msau {
namespace box {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTilePixels = 4096;
constexpr int kPixels = kTilePixels / kThreads;  // most outputs a thread walks, per box
constexpr int kMaxBoxes = 8;
constexpr int kSums = 5;  // per box: row edges at y2 + 1 and y1, columns' alike, U

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// d clip(v, lo, hi) / dv as torch.minimum(torch.maximum(v, lo), hi) has it
__device__ __forceinline__ float clip_grad(float v, float lo, float hi) {
  const float m = fmaxf(v, lo);
  const float a = v > lo ? 1.f : (v == lo ? 0.5f : 0.f);
  const float b = m < hi ? 1.f : (m == hi ? 0.5f : 0.f);
  return a * b;
}

// the raw pair of one axis of box (c, b) -> ordered and clipped (lo, hi)
struct Pair {
  float a, b;  // raw: min and max as stored
  float lo, hi;
};

__device__ __forceinline__ Pair pair(const float* box, int cb, int plane, int bound) {
  Pair p;
  p.a = box[cb];
  p.b = box[plane + cb];
  p.lo = clip(fminf(p.a, p.b), (float)-bound, (float)bound);
  p.hi = clip(fmaxf(p.a, p.b), (float)-bound, (float)bound);
  return p;
}

// sample offsets and weights of one axis: the upper corner's blend at hi + 1
// (rows o[0], o[1]), the lower corner's at lo (rows o[2], o[3], negative)
struct Axis {
  int o[4];
  float w[4];
};

__device__ __forceinline__ Axis axis(float lo, float hi, int pad) {
  const float d2 = clip(hi + 1.f, (float)-pad, (float)(pad - 1));
  const float d1 = clip(lo, (float)-pad, (float)(pad - 1));
  const float k2 = floorf(d2), k1 = floorf(d1);
  const float f2 = d2 - k2, f1 = d1 - k1;
  Axis ax;
  ax.o[0] = (int)k2;
  ax.o[1] = (int)k2 + 1;
  ax.o[2] = (int)k1;
  ax.o[3] = (int)k1 + 1;
  ax.w[0] = 1.f - f2;
  ax.w[1] = f2;
  ax.w[2] = -(1.f - f1);
  ax.w[3] = -f1;
  return ax;
}

struct Geom {
  Axis y, x;
  float inv;  // 1 / A
};

__device__ __forceinline__ float area_of(const Pair& py, const Pair& px) {
  return (py.hi - py.lo + 1.f) * (px.hi - px.lo + 1.f);
}

__device__ __forceinline__ Geom geom(const float* ybox, const float* xbox, int c, int b,
                                     int nc, int nb, int mh, int mw, int normalize) {
  const int cb = c * nb + b, plane = nc * nb, pad = max(mh, mw) + 2;
  const Pair py = pair(ybox, cb, plane, mh), px = pair(xbox, cb, plane, mw);
  Geom g;
  g.y = axis(py.lo, py.hi, pad);
  g.x = axis(px.lo, px.hi, pad);
  g.inv = normalize ? 1.f / fmaxf(area_of(py, px), 1.f) : 1.f;
  return g;
}

// The transposed filter: sum_i g[i] w(r - i) samples g's integral image at
// r + 1 - o with the weight of o.
__device__ __forceinline__ Axis transposed(Axis ax) {
#pragma unroll
  for (int t = 0; t < 4; ++t) ax.o[t] = 1 - ax.o[t];
  return ax;
}

// II rows [plo, phi] and columns [qlo, qhi] of a plane, in shared memory
// at L[(p - plo) * stride + (q - qlo)]; the region may reach past the
// image, whose rows and columns there count as zeros
struct Region {
  int plo, phi, qlo, qhi, stride;
};

// The region of tile (i0, j0) whose samples reach offsets [omin, omax]
__device__ __forceinline__ Region region(int i0, int j0, int th, int tw, int omin_y,
                                         int omax_y, int omin_x, int omax_x, int stride) {
  Region r;
  r.plo = i0 + omin_y;
  r.phi = i0 + th - 1 + omax_y;
  r.qlo = j0 + omin_x;
  r.qhi = j0 + tw - 1 + omax_x;
  r.stride = stride;
  return r;
}

// L = the exclusive integral image of ``plane`` ([h, w], zero past it;
// f32 or bf16, summed in f32) over the region; ends with a barrier.  A warp
// loads 4 rows (8 apart) of 4 pieces of 32 columns at a time, all 16 loads
// in flight before their stores.
template <typename T>
__device__ void integral(float* L, const T* __restrict__ plane, const Region& R, int h,
                         int w) {
  const int rows = R.phi - R.plo + 1, cols = R.qhi - R.qlo + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r0 = warp; r0 < rows; r0 += 4 * kWarps) {
    for (int q0 = lane; q0 < cols; q0 += 4 * 32) {
      float v[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int r = r0 + t * kWarps, y = R.plo + r - 1;
        const T* src = plane + (int64_t)y * w + (R.qlo - 1);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int q = q0 + u * 32, xq = R.qlo + q - 1;
          v[t][u] = (r > 0 && r < rows && q > 0 && q < cols && y >= 0 && y < h && xq >= 0 &&
                     xq < w) ? to_f32(src[q]) : 0.f;
        }
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int r = r0 + t * kWarps;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int q = q0 + u * 32;
          if (r < rows && q < cols) L[r * R.stride + q] = v[t][u];
        }
      }
    }
  }
  __syncthreads();
  for (int r = 1 + threadIdx.x; r < rows; r += kThreads) {
    float* row = L + r * R.stride;
    float s = 0.f;
#pragma unroll 8
    for (int q = 1; q < cols; ++q) {
      s += row[q];
      row[q] = s;
    }
  }
  __syncthreads();
  for (int q = 1 + threadIdx.x; q < cols; q += kThreads) {
    float s = 0.f;
#pragma unroll 8
    for (int r = 1; r < rows; ++r) {
      s += L[r * R.stride + q];
      L[r * R.stride + q] = s;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float blend(const float (&v)[4][4], const Axis& ay, const Axis& ax) {
  float u = 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float t = 0.f;
#pragma unroll
    for (int s = 0; s < 4; ++s) t += ax.w[s] * v[r][s];
    u += ay.w[r] * t;
  }
  return u;
}

// One thread's walk down its column of a tile: the 4 x 4 samples v[r][s]
// (II row i + oy[r], column j + ox[s]) of output row i, then of i + 1 by
// two new rows of 4 reads: the rows of a corner's blend are adjacent, so
// each corner's upper row (forward axis, kUp: o[1] = o[0] + 1) or lower
// row (transposed axis: o[1] = o[0] - 1) is the next output's other row.
// No read needs a clamp: the region holds every sample of the tile.
template <bool kUp>
struct Walk {
  const float* L;
  int stride, col[4], row[4];  // the region's columns, and rows of output row 0
  float v[4][4];

  template <int r>
  __device__ __forceinline__ void load(int i) {
    const float* p = L + (row[r] + i) * stride;
#pragma unroll
    for (int s = 0; s < 4; ++s) v[r][s] = p[col[s]];
  }

  // the samples of local output row il (tile-relative)
  __device__ __forceinline__ Walk(const float* l, const Region& R, const Axis& ay,
                                  const Axis& ax, int i0, int j0, int il, int jl)
      : L(l), stride(R.stride) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      row[t] = i0 + ay.o[t] - R.plo;
      col[t] = j0 + jl + ax.o[t] - R.qlo;
    }
    load<0>(il);
    load<1>(il);
    load<2>(il);
    load<3>(il);
  }

  // from local output row i - 1 to i
  __device__ __forceinline__ void next(int i) {
    constexpr int keep0 = kUp ? 0 : 1, from0 = kUp ? 1 : 0;
    constexpr int keep2 = kUp ? 2 : 3, from2 = kUp ? 3 : 2;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      v[keep0][s] = v[from0][s];
      v[keep2][s] = v[from2][s];
    }
    load<from0>(i);
    load<from2>(i);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// A tile is th x tw outputs (tw = 64, or the plane's width rounded up to
// a power of two where that is less; th likewise for the height); thread
// t walks column t % tw, rows strip * len .. strip * len + len - 1 of it
// with strip = t / tw, so a warp reads and writes a row's consecutive
// columns.
struct Launch {
  int nc, nb, h, w, mh, mw, normalize;
  int th, tw, tw_shift, len, tiles_w, stride;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
filter_fwd(const T* __restrict__ x, const float* __restrict__ ybox,
           const float* __restrict__ xbox, float* __restrict__ out, Launch a) {
  extern __shared__ float L[];
  const int c = blockIdx.y, n = blockIdx.z;
  const int i0 = (blockIdx.x / a.tiles_w) * a.th, j0 = (blockIdx.x % a.tiles_w) * a.tw;
  const int jl = threadIdx.x & (a.tw - 1), il0 = (threadIdx.x >> a.tw_shift) * a.len;
  const int64_t hw = (int64_t)a.h * a.w;
  const Region R = region(i0, j0, a.th, a.tw, -a.mh, a.mh + 2, -a.mw, a.mw + 2, a.stride);
  integral(L, x + ((int64_t)n * a.nc + c) * hw, R, a.h, a.w);
  const int j = j0 + jl, rows = min(a.len, min(a.th, a.h - i0) - il0);
  if (j >= a.w || rows <= 0) return;
  for (int b = 0; b < a.nb; ++b) {
    const Geom g = geom(ybox, xbox, c, b, a.nc, a.nb, a.mh, a.mw, a.normalize);
    float* dst = out + ((int64_t)n * a.nc * a.nb + c * a.nb + b) * hw + j;
    Walk<true> wk(L, R, g.y, g.x, i0, j0, il0, jl);
    for (int k = 0; k < rows; ++k) {
      if (k) wk.next(il0 + k);
      dst[(int64_t)(i0 + il0 + k) * a.w] = blend(wk.v, g.y, g.x) * g.inv;
    }
  }
}

// the chain rule of box (c, b) from its five sums over N x H x W ->
// the gradients of the raw ybox / xbox pair
__device__ void coordinate_grads(const double* s, const float* __restrict__ ybox,
                                 const float* __restrict__ xbox, float* __restrict__ dybox,
                                 float* __restrict__ dxbox, int c, int b, const Launch& a) {
  const int cb = c * a.nb + b, plane = a.nc * a.nb, pad = max(a.mh, a.mw) + 2;
  const Pair py = pair(ybox, cb, plane, a.mh), px = pair(xbox, cb, plane, a.mw);
  const float area = area_of(py, px);
  const double inv = a.normalize ? 1.0 / (double)fmaxf(area, 1.f) : 1.0;
  // d loss / d A, through max(area, 1): half at the tie
  const double d_area = a.normalize
      ? -inv * inv * s[4] * (area > 1.f ? 1.0 : (area == 1.f ? 0.5 : 0.0)) : 0.0;
  const double wy = py.hi - py.lo + 1.f, wx = px.hi - px.lo + 1.f;
  const float fp = (float)-pad, fq = (float)(pad - 1);
  // the sample positions hi + 1 and lo, each through the band's clip
  const double g_yhi = inv * s[0] * clip_grad(py.hi + 1.f, fp, fq) + d_area * wx;
  const double g_ylo = -inv * s[1] * clip_grad(py.lo, fp, fq) - d_area * wx;
  const double g_xhi = inv * s[2] * clip_grad(px.hi + 1.f, fp, fq) + d_area * wy;
  const double g_xlo = -inv * s[3] * clip_grad(px.lo, fp, fq) - d_area * wy;
  const Pair* ps[2] = {&py, &px};
  const double gs[2][2] = {{g_ylo, g_yhi}, {g_xlo, g_xhi}};
  float* outs[2] = {dybox, dxbox};
  const int bounds[2] = {a.mh, a.mw};
#pragma unroll
  for (int ax = 0; ax < 2; ++ax) {
    const Pair& p = *ps[ax];
    const float m = (float)bounds[ax];
    // through the clip to +-max, then min / max of the raw pair
    const double glo = gs[ax][0] * clip_grad(fminf(p.a, p.b), -m, m);
    const double ghi = gs[ax][1] * clip_grad(fmaxf(p.a, p.b), -m, m);
    double ga, gb;
    if (p.a < p.b) {
      ga = glo;
      gb = ghi;
    } else if (p.a > p.b) {
      ga = ghi;
      gb = glo;
    } else {
      ga = gb = 0.5 * (glo + ghi);
    }
    outs[ax][cb] = (float)ga;
    outs[ax][plane + cb] = (float)gb;
  }
}

// three blocks an SM, as many as their shared memory allows at 64 x 64
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
filter_bwd(const T* __restrict__ x, const float* __restrict__ ybox,
           const float* __restrict__ xbox, const float* __restrict__ g,
           T* __restrict__ dx, float* __restrict__ dybox, float* __restrict__ dxbox,
           float* __restrict__ partial, int* __restrict__ tickets, Launch a) {
  extern __shared__ float L[];
  __shared__ float s_red[kWarps][kSums];
  __shared__ double s_tot[kMaxBoxes * kSums];
  __shared__ int s_last;
  const int c = blockIdx.y, n = blockIdx.z;
  const int i0 = (blockIdx.x / a.tiles_w) * a.th, j0 = (blockIdx.x % a.tiles_w) * a.tw;
  const int blocks = gridDim.x * gridDim.z, blk = n * gridDim.x + blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t hw = (int64_t)a.h * a.w;
  const float* gplanes = g + ((int64_t)n * a.nc * a.nb + c * a.nb) * hw;
  const T* xplane = x + ((int64_t)n * a.nc + c) * hw;

  const int jl = threadIdx.x & (a.tw - 1), il0 = (threadIdx.x >> a.tw_shift) * a.len;
  const int j = j0 + jl, rows = min(a.len, min(a.th, a.h - i0) - il0);
  const bool live = j < a.w && rows > 0;

  // For each box: the integral image of its cotangent plane, sampled by the
  // transposed filter (offsets 1 - o; the weights -w of each axis, whose
  // product is the filter's): dx += that over A.  By the same
  // transposition the coordinates' five sums are sums over x:
  // sum_i g_i dU_i/dd2 = sum_r x_r g_(r - k2) (2-D: the cotangent's row
  // r - k2 blended along the columns by the transposed weights) = x times
  // the columns' blend of samples' rows 1 - 0; the lower corner's of rows
  // 3 - 2, the columns' alike; and sum_i g_i U_i = sum_r x_r (T g)_r.
  float xk[kPixels], acc[kPixels];
#pragma unroll
  for (int k = 0; k < kPixels; ++k) {
    xk[k] = live && k < rows ? to_f32(xplane[(int64_t)(i0 + il0 + k) * a.w + j]) : 0.f;
    acc[k] = 0.f;
  }
  const Region R = region(i0, j0, a.th, a.tw, -a.mh - 1, a.mh + 1, -a.mw - 1, a.mw + 1,
                          a.stride);
  for (int b = 0; b < a.nb; ++b) {
    const Geom gm = geom(ybox, xbox, c, b, a.nc, a.nb, a.mh, a.mw, a.normalize);
    const Axis ty = transposed(gm.y), tx = transposed(gm.x);
    integral(L, gplanes + b * hw, R, a.h, a.w);
    float sums[kSums] = {0.f, 0.f, 0.f, 0.f, 0.f};
    if (live) {
      Walk<false> wk(L, R, ty, tx, i0, j0, il0, jl);
#pragma unroll
      for (int k = 0; k < kPixels; ++k) {
        if (k < rows) {
          if (k) wk.next(il0 + k);
          const float(&v)[4][4] = wk.v;
          float ey2 = 0.f, ey1 = 0.f, ex2 = 0.f, ex1 = 0.f;
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            ey2 += gm.x.w[t] * (v[1][t] - v[0][t]);
            ey1 += gm.x.w[t] * (v[3][t] - v[2][t]);
            ex2 += gm.y.w[t] * (v[t][1] - v[t][0]);
            ex1 += gm.y.w[t] * (v[t][3] - v[t][2]);
          }
          const float u = blend(v, ty, tx);
          acc[k] += u * gm.inv;
          sums[0] += xk[k] * ey2;
          sums[1] += xk[k] * ey1;
          sums[2] += xk[k] * ex2;
          sums[3] += xk[k] * ex1;
          sums[4] += xk[k] * u;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kSums; ++q) {
      const float t = warp_sum(sums[q]);
      if (lane == 0) s_red[warp][q] = t;
    }
    __syncthreads();  // also: every read of L before the next box's image
    if (threadIdx.x < kSums) {
      float t = 0.f;
      for (int wp = 0; wp < kWarps; ++wp) t += s_red[wp][threadIdx.x];
      partial[((int64_t)(c * a.nb + b) * kSums + threadIdx.x) * blocks + blk] = t;
    }
  }
  T* dst = dx + ((int64_t)n * a.nc + c) * hw + j;
#pragma unroll
  for (int k = 0; k < kPixels; ++k)
    if (live && k < rows) store(dst + (int64_t)(i0 + il0 + k) * a.w, acc[k]);

  // (3) the channel's last block sums its partials in block order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(tickets + c, 1) == blocks - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int v = warp; v < a.nb * kSums; v += kWarps) {
    const float* p = partial + ((int64_t)c * a.nb * kSums + v) * blocks;
    double s = 0.0;
    for (int k = lane; k < blocks; k += 32) s += (double)__ldcg(p + k);
    s = warp_sum(s);
    if (lane == 0) s_tot[v] = s;
  }
  __syncthreads();
  if (threadIdx.x < a.nb)
    coordinate_grads(s_tot + threadIdx.x * kSums, ybox, xbox, dybox, dxbox, c, threadIdx.x, a);
  if (threadIdx.x == 0) tickets[c] = 0;
}

// The tiles (at most 64 x 64 outputs, each side the plane's rounded up to
// a power of two where that is less) and the shared memory of their halo
// regions, in bytes
Launch plan(int nc, int nb, int h, int w, int mh, int mw, int normalize, size_t* smem,
            int* tiles) {
  Launch a;
  a.nc = nc;
  a.nb = nb;
  a.h = h;
  a.w = w;
  a.mh = mh;
  a.mw = mw;
  a.normalize = normalize;
  a.tw = 1;
  a.tw_shift = 0;
  while (a.tw < w && a.tw < 64) {
    a.tw *= 2;
    a.tw_shift += 1;
  }
  a.th = 1;
  while (a.th < h && a.th < 64) a.th *= 2;
  const int strips = kThreads / a.tw;
  a.len = (a.th + strips - 1) / strips;
  a.tiles_w = (w + a.tw - 1) / a.tw;
  *tiles = a.tiles_w * ((h + a.th - 1) / a.th);
  const int rows = a.th + 2 * mh + 2, cols = a.tw + 2 * mw + 2;
  a.stride = cols | 1;  // odd: a thread a row scans without bank conflicts
  *smem = (size_t)rows * a.stride * sizeof(float);
  return a;
}

constexpr size_t kMaxSmem = 227 * 1024 - kWarps * kSums * 4 - kMaxBoxes * kSums * 8 - 64;

bool valid(int n, int nc, int nb, int h, int w, int mh, int mw) {
  return n > 0 && nc > 0 && nb > 0 && nb <= kMaxBoxes && h > 0 && w > 0 && mh >= 0 &&
         mw >= 0 && n <= 65535 && nc <= 65535;
}

template <typename T>
int launch_fwd(const void* x, const void* ybox, const void* xbox, void* out, int n, int c,
               int b, int h, int w, int max_h, int max_w, int normalize, void* stream) {
  if (!valid(n, c, b, h, w, max_h, max_w)) return (int)cudaErrorInvalidValue;
  size_t smem;
  int tiles;
  const Launch a = plan(c, b, h, w, max_h, max_w, normalize, &smem, &tiles);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(filter_fwd<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  filter_fwd<T><<<dim3(tiles, c, n), kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)ybox, (const float*)xbox, (float*)out, a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* ybox, const void* xbox, const void* g, void* dx,
               void* dybox, void* dxbox, void* partial, void* tickets, int n, int c, int b,
               int h, int w, int max_h, int max_w, int normalize, void* stream) {
  if (!valid(n, c, b, h, w, max_h, max_w)) return (int)cudaErrorInvalidValue;
  size_t smem;
  int tiles;
  const Launch a = plan(c, b, h, w, max_h, max_w, normalize, &smem, &tiles);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(filter_bwd<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  filter_bwd<T><<<dim3(tiles, c, n), kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)ybox, (const float*)xbox, (const float*)g, (T*)dx,
      (float*)dybox, (float*)dxbox, (float*)partial, (int*)tickets, a);
  return (int)cudaGetLastError();
}

}  // namespace box
}  // namespace msau

// bytes of dynamic shared memory a launch of this shape needs (0 where the
// shape is refused); the kernels take up to 227 KB
extern "C" int msau_box_conv_smem(int n, int c, int b, int h, int w, int max_h, int max_w) {
  using namespace msau::box;
  if (!valid(n, c, b, h, w, max_h, max_w)) return 0;
  size_t smem;
  int tiles;
  plan(c, b, h, w, max_h, max_w, 1, &smem, &tiles);
  return smem <= kMaxSmem ? (int)smem : 0;
}

// x [N, C, H, W] (f32, or bf16 where is_bf16), ybox / xbox [2, C, B] f32,
// out [N, C*B, H, W] f32
extern "C" int msau_box_conv_fwd(const void* x, const void* ybox, const void* xbox, void* out,
                                 int n, int c, int b, int h, int w, int max_h, int max_w,
                                 int normalize, int is_bf16, void* stream) {
  using namespace msau::box;
  return is_bf16 ? launch_fwd<__nv_bfloat16>(x, ybox, xbox, out, n, c, b, h, w, max_h, max_w,
                                             normalize, stream)
                 : launch_fwd<float>(x, ybox, xbox, out, n, c, b, h, w, max_h, max_w,
                                     normalize, stream);
}

// g [N, C*B, H, W] f32 -> dx [N, C, H, W] in x's type, dybox / dxbox
// [2, C, B] f32; partial: f32 scratch of C * B * 5 * N * tiles
// (msau_box_conv_tiles); tickets: C int32 zeros, left zero by the launch
extern "C" int msau_box_conv_bwd(const void* x, const void* ybox, const void* xbox,
                                 const void* g, void* dx, void* dybox, void* dxbox,
                                 void* partial, void* tickets, int n, int c, int b, int h,
                                 int w, int max_h, int max_w, int normalize, int is_bf16,
                                 void* stream) {
  using namespace msau::box;
  return is_bf16 ? launch_bwd<__nv_bfloat16>(x, ybox, xbox, g, dx, dybox, dxbox, partial,
                                             tickets, n, c, b, h, w, max_h, max_w, normalize,
                                             stream)
                 : launch_bwd<float>(x, ybox, xbox, g, dx, dybox, dxbox, partial, tickets, n,
                                     c, b, h, w, max_h, max_w, normalize, stream);
}

// tiles of a plane of this shape (the backward's partial scratch holds
// C * B * 5 * N * tiles floats), 0 where the shape is refused
extern "C" int msau_box_conv_tiles(int n, int c, int b, int h, int w) {
  using namespace msau::box;
  if (!valid(n, c, b, h, w, 0, 0)) return 0;
  size_t smem;
  int tiles;
  plan(c, b, h, w, 0, 0, 1, &smem, &tiles);
  return tiles;
}
