// Backward of the stride-2 transposed conv of deconv.cu (torch's
// ConvTranspose2d(stride 2, padding K/2) to an exact target [Ho, Wo], Ho in
// {2H-1, 2H}, weight w [cin, cout, K, K]): with g the cotangent of the
// output,
//   dx[ci][m][j]      = sum_{co,ky,kx} w[ci][co][ky][kx] g[co][2m-p+ky][2j-p+kx]
//   dw[ci][co][ky][kx] = sum_{n,m,j}   x[ci][m][j]       g[co][2m-p+ky][2j-p+kx]
// (p = K/2, g read as 0 outside [0, Ho) x [0, Wo), so odd targets need no
// special case).  dx is a stride-2 conv of g; dw correlates x with g at the
// parity-class taps, and the zero-inserted canvas never exists.  db is one
// torch reduction, as it is an XLA sum in the JAX package.
//
// Replaces the TPU kernels msau_tpu/ops/flatconv.py:_dc_dx_kernel and
// _dc_dw_kernel (launcher _flat_deconv2_bwd), which build the transposed
// conv of g over the dilated rows in VMEM and sample it with a 0/1 matrix
// on the MXU, and _ups_bwd_kernel (launcher _flat_upsample2_bwd: g sampled
// at the even positions, the two-op form's zero-insert backward, which
// this dx computes together with the conv's dx, as deconv.cu's forward
// folds the zero-insert in).
//
// What bounds it on the H100: FP32 arithmetic, K*K*cin*cout FMAs per input
// pixel for each of dx and dw (64 -> 32 channels at 64^2: 18432).  Design:
//   - dx: a block owns 32 x 8 input pixels of one image and 8 input
//     channels (2 rows x 8 channels of accumulators per thread); it stages
//     the g rows its pixels read (2*8 + K - 2 rows x 2*32 + K - 2 columns)
//     8 output channels at a time as [row][col][co], beside the weights as
//     [co][tap][ci], in shared memory;
//   - dw: a grid of at most kPartialBlocks blocks walks the same tiles;
//     per (8 input, 8 output channels) it stages x and the g rows, and a
//     thread owns one (input channel, tap) pair and a slice of the tile's
//     pixels with 8 output channels in registers, reading 8 g values as two
//     16-byte loads; slices and tiles add in order into the block's own
//     partial row, which sum_partials (common.cuh) adds in block order: the
//     same inputs give the same bits.

#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

using msau::load_row;
using msau::store;
using msau::to_f32;

constexpr int kQx = 32;   // input columns per tile: one per lane
constexpr int kTy = 4;    // warps per block
constexpr int kQr = 2;    // input rows per thread (dx)
constexpr int kThreads = kQx * kTy;
constexpr int kTh = kTy * kQr;   // input rows per tile
constexpr int kG = 8;            // channels staged / owned per group

struct Dims {
  int cin, h, w, cout, k, ho, wo;
  __host__ __device__ int p() const { return k / 2; }
  __host__ __device__ int gh() const { return 2 * kTh + k - 2; }   // g rows
  __host__ __device__ int gw() const { return 2 * kQx + k - 2; }   // g cols
};

// Stages g channels [c0, c0 + cc) read by the tile at input (m0, j0) into
// gs[row][col][kG] (zero outside the target and for channels past cc).
template <typename T>
__device__ inline void stage_g(const T* __restrict__ g, const Dims& d, float* gs,
                               int img, int c0, int cc, int m0, int j0) {
  const int gh = d.gh(), gw = d.gw();
  const int64_t plane = (int64_t)d.ho * d.wo;
  for (int i = threadIdx.x; i < gh * gw * kG; i += kThreads) {
    const int c = i % kG, rc = i / kG;
    const int r = rc / gw, q = rc % gw;
    const int oy = 2 * m0 - d.p() + r, ox = 2 * j0 - d.p() + q;
    gs[i] = (c < cc && oy >= 0 && oy < d.ho && ox >= 0 && ox < d.wo)
                ? to_f32(g[((int64_t)img * d.cout + c0 + c) * plane +
                           (int64_t)oy * d.wo + ox])
                : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
deconv2_dx_kernel(const T* __restrict__ g, const T* __restrict__ w, T* __restrict__ dx,
                  Dims d, int groups) {
  extern __shared__ __align__(16) float smem[];
  const int taps = d.k * d.k, gw = d.gw();
  float* gs = smem;                           // [gh][gw][kG] of output channels
  float* ws = smem + d.gh() * gw * kG;        // [kG co][taps][kG ci]
  const int img = blockIdx.z / groups, ci0 = (blockIdx.z % groups) * kG;
  const int m0 = blockIdx.y * kTh, j0 = blockIdx.x * kQx;
  const int tx = threadIdx.x % kQx, ty = threadIdx.x / kQx;
  float acc[kQr][kG];
#pragma unroll
  for (int i = 0; i < kQr; ++i)
#pragma unroll
    for (int c = 0; c < kG; ++c) acc[i][c] = 0.f;

  for (int c0 = 0; c0 < d.cout; c0 += kG) {
    const int cc = min(kG, d.cout - c0);
    __syncthreads();
    stage_g<T>(g, d, gs, img, c0, cc, m0, j0);
    for (int i = threadIdx.x; i < kG * taps * kG; i += kThreads) {
      const int ci = i % kG, t = i / kG;
      const int tap = t % taps, co = t / taps;
      ws[i] = (co < cc && ci0 + ci < d.cin)
                  ? to_f32(w[((int64_t)(ci0 + ci) * d.cout + c0 + co) * taps + tap])
                  : 0.f;
    }
    __syncthreads();
    for (int co = 0; co < cc; ++co) {
      for (int tap = 0; tap < taps; ++tap) {
        float wv[kG];
        load_row(wv, ws + (co * taps + tap) * kG);
        const int ky = tap / d.k, kx = tap % d.k;
#pragma unroll
        for (int i = 0; i < kQr; ++i) {
          const float v = gs[((2 * (ty * kQr + i) + ky) * gw + 2 * tx + kx) * kG + co];
#pragma unroll
          for (int c = 0; c < kG; ++c) acc[i][c] = fmaf(v, wv[c], acc[i][c]);
        }
      }
    }
  }
  const int64_t plane = (int64_t)d.h * d.w;
  const int j = j0 + tx;
#pragma unroll
  for (int i = 0; i < kQr; ++i) {
    const int m = m0 + ty * kQr + i;
    if (m >= d.h || j >= d.w) continue;
#pragma unroll
    for (int c = 0; c < kG; ++c)
      if (ci0 + c < d.cin)
        store(dx + ((int64_t)img * d.cin + ci0 + c) * plane + (int64_t)m * d.w + j,
              acc[i][c]);
  }
}

constexpr int kSlices = 2;   // pixel slices per (input channel, tap) pair

template <typename T>
__global__ void __launch_bounds__(kThreads)
deconv2_dw_kernel(const T* __restrict__ x, const T* __restrict__ g, Dims d,
                  int tiles_x, int tiles_y, int n_tiles, float* __restrict__ partial) {
  extern __shared__ __align__(16) float smem[];
  constexpr int P = kQx * kTh;
  const int taps = d.k * d.k, gw = d.gw(), pairs = kG * taps;
  float* gs = smem;                          // [gh][gw][kG]
  float* xs = gs + d.gh() * gw * kG;         // [kG][P]
  float* red = xs + kG * P;                  // [kSlices][pairs][kG]
  const int64_t stride = (int64_t)d.cin * d.cout * taps;
  float* __restrict__ part = partial + (int64_t)blockIdx.x * stride;
  const int64_t plane = (int64_t)d.h * d.w;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    const int img = tile / (tiles_x * tiles_y), t2 = tile % (tiles_x * tiles_y);
    const int j0 = (t2 % tiles_x) * kQx, m0 = (t2 / tiles_x) * kTh;
    for (int ci0 = 0; ci0 < d.cin; ci0 += kG) {
      const int ccin = min(kG, d.cin - ci0);
      for (int co0 = 0; co0 < d.cout; co0 += kG) {
        const int ccout = min(kG, d.cout - co0);
        __syncthreads();   // the previous group's readers are done
        stage_g<T>(g, d, gs, img, co0, ccout, m0, j0);
        for (int i = threadIdx.x; i < kG * P; i += kThreads) {
          const int ci = i / P, pp = i % P;
          const int m = m0 + pp / kQx, j = j0 + pp % kQx;
          xs[i] = (ci < ccin && m < d.h && j < d.w)
                      ? to_f32(x[((int64_t)img * d.cin + ci0 + ci) * plane +
                                 (int64_t)m * d.w + j])
                      : 0.f;
        }
        __syncthreads();
        for (int it = threadIdx.x; it < pairs * kSlices; it += kThreads) {
          const int pair = it % pairs, sl = it / pairs;
          const int ci = pair / taps, tap = pair % taps;
          const int ky = tap / d.k, kx = tap % d.k;
          float acc[kG];
#pragma unroll
          for (int c = 0; c < kG; ++c) acc[c] = 0.f;
          for (int pp = sl * P / kSlices; pp < (sl + 1) * P / kSlices; ++pp) {
            const float xv = xs[ci * P + pp];
            float gv[kG];
            load_row(gv, gs + ((2 * (pp / kQx) + ky) * gw + 2 * (pp % kQx) + kx) * kG);
#pragma unroll
            for (int c = 0; c < kG; ++c) acc[c] = fmaf(xv, gv[c], acc[c]);
          }
#pragma unroll
          for (int c = 0; c < kG; ++c) red[it * kG + c] = acc[c];
        }
        __syncthreads();
        for (int jj = threadIdx.x; jj < pairs * kG; jj += kThreads) {
          const int pair = jj / kG, c = jj % kG;
          const int ci = pair / taps, tap = pair % taps;
          if (ci >= ccin || c >= ccout) continue;
          float v = 0.f;
          for (int sl = 0; sl < kSlices; ++sl) v += red[(sl * pairs + pair) * kG + c];
          float* dst = part + ((int64_t)(ci0 + ci) * d.cout + co0 + c) * taps + tap;
          *dst = first ? v : *dst + v;
        }
      }
    }
  }
}

template <typename T>
int launch_dx(const void* g, const void* w, void* dx, int n, const Dims& d,
              cudaStream_t stream) {
  const int groups = (d.cin + kG - 1) / kG;
  if ((int64_t)n * groups > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(d.gh() * d.gw() * kG + kG * d.k * d.k * kG) * sizeof(float);
  cudaError_t err = msau::allow_smem(deconv2_dx_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((d.w + kQx - 1) / kQx, (d.h + kTh - 1) / kTh, n * groups);
  deconv2_dx_kernel<T><<<grid, kThreads, smem, stream>>>((const T*)g, (const T*)w,
                                                          (T*)dx, d, groups);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dw(const void* x, const void* g, void* partial, void* dw, int n,
              const Dims& d, cudaStream_t stream) {
  constexpr int P = kQx * kTh;
  const int taps = d.k * d.k;
  const size_t smem = (size_t)(d.gh() * d.gw() * kG + kG * P +
                               kSlices * kG * taps * kG) * sizeof(float);
  cudaError_t err = msau::allow_smem(deconv2_dw_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (d.w + kQx - 1) / kQx, tiles_y = (d.h + kTh - 1) / kTh;
  const int64_t n_tiles = (int64_t)n * tiles_x * tiles_y;
  if (n_tiles > (1 << 30)) return (int)cudaErrorInvalidValue;
  const int blocks = (int)std::min<int64_t>(n_tiles, msau::kPartialBlocks);
  deconv2_dw_kernel<T><<<blocks, kThreads, smem, stream>>>(
      (const T*)x, (const T*)g, d, tiles_x, tiles_y, (int)n_tiles, (float*)partial);
  const int code = (int)cudaGetLastError();
  if (code != 0) return code;
  return msau::sum_partials((const float*)partial, blocks,
                            (int64_t)d.cin * d.cout * taps, (float*)dw, stream);
}

bool bad_dims(int n, const Dims& d) {
  return n < 0 || d.cin <= 0 || d.h < 0 || d.w < 0 || d.cout <= 0 || d.k <= 0 ||
         d.k % 2 == 0 || (d.ho != 2 * d.h - 1 && d.ho != 2 * d.h) ||
         (d.wo != 2 * d.w - 1 && d.wo != 2 * d.w);
}

}  // namespace

// g: [n, cout, ho, wo]; w: [cin, cout, k, k] (odd k), both in the
// activation dtype; dx: [n, cin, h, w] in that dtype.
extern "C" int msau_flat_deconv2_dx(const void* g, const void* w, void* dx, int n,
                                    int cin, int h, int wd, int cout, int k, int ho,
                                    int wo, int is_bf16, void* stream) {
  const Dims d{cin, h, wd, cout, k, ho, wo};
  if (bad_dims(n, d)) return (int)cudaErrorInvalidValue;
  if (n == 0 || h == 0 || wd == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch_dx<__nv_bfloat16>(g, w, dx, n, d, s)
                 : launch_dx<float>(g, w, dx, n, d, s);
}

// x: [n, cin, h, w] and g: [n, cout, ho, wo] in the activation dtype;
// partial: f32 scratch of kPartialBlocks * cin * cout * k * k floats; dw:
// f32 [cin, cout, k, k].
extern "C" int msau_flat_deconv2_dw(const void* x, const void* g, void* partial,
                                    void* dw, int n, int cin, int h, int wd, int cout,
                                    int k, int ho, int wo, int is_bf16, void* stream) {
  const Dims d{cin, h, wd, cout, k, ho, wo};
  if (bad_dims(n, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0 || h == 0 || wd == 0)
    return (int)cudaMemsetAsync(dw, 0, (size_t)cin * cout * k * k * sizeof(float), s);
  return is_bf16 ? launch_dw<__nv_bfloat16>(x, g, partial, dw, n, d, s)
                 : launch_dw<float>(x, g, partial, dw, n, d, s);
}
