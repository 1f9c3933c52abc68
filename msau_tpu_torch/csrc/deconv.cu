// Stride-2 transposed conv with an odd K x K kernel (the flagship's 3x3) to
// an exact target [Ho, Wo], Ho in {2H-1, 2H}: torch's ConvTranspose2d(
// stride 2, padding K/2, output_padding Ho - (2H-1)) plus a bias, which is
// the zero-insertion of x onto the target canvas followed by a SAME conv
// with the spatially flipped kernel.
//
// Replaces the TPU kernels msau_tpu/ops/flatconv.py:_dc_fwd_kernel
// (launcher _flat_deconv2_prim, the fused deconv) and _ups_fwd_kernel
// (launcher flat_upsample2, the zero-insert that the JAX package follows
// with a flat conv where the fused deconv's lane-alignment gate fails).
// Both compute this function; the TPU builds the dilated rows in VMEM with
// a 0/1 insert matrix on the MXU.  Here the zero-inserted canvas never
// exists: output pixel (2m + a, 2j + b) is a sum over only the taps whose
// parity matches (a, b), at most 4 inputs for a 3x3 kernel.
//
// What bounds it on the H100: FP32 arithmetic, K*K*cin*cout/4 FMAs per
// output pixel against cin/4 + cout input and output values; at 64 -> 32
// channels that is 4608 FMAs per 36 values written.  Design:
//   - each thread owns two vertically adjacent output quads (the 2 x 2
//     output pixels of one input position, all four parity classes, so no
//     thread diverges on parity) for 8 output channels: 64 accumulators;
//   - a block is 32 x 8 quads (64 x 16 outputs) of one image and one group
//     of 8 output channels; it stages 8 input channels of its input tile
//     (with the K/4-wide halo) and their weights [ci][tap][co] in shared
//     memory at a time, converted to f32;
//   - weights are read as 16-byte broadcast loads, each feeding 16 FMAs.
// The weight is torch's [cin, cout, K, K]; bias f32 [cout].

#include <stdint.h>

#include "common.cuh"

namespace {

using msau::load_row;
using msau::store;
using msau::to_f32;

constexpr int kQx = 32;   // quad columns per block: one per lane
constexpr int kTy = 4;    // warps per block
constexpr int kQr = 2;    // quad rows per thread
constexpr int kThreads = kQx * kTy;
constexpr int kQh = kTy * kQr;   // quad rows per block
constexpr int kCoutG = 8;        // output channels per block
constexpr int kCi = 8;           // input channels staged per chunk

template <typename T>
__global__ void __launch_bounds__(kThreads)
deconv2_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ bias, T* __restrict__ y, int cin, int h,
               int wi, int cout, int k, int ho, int wo, int groups) {
  extern __shared__ __align__(16) float smem[];
  const int p = k / 2;
  // input rows (and columns) a quad reads lie in [m - lo, m + hi]
  const int lo = (k - 1 - p) / 2, hi = (1 + p) / 2;
  const int ih = kQh + lo + hi, iw = kQx + lo + hi;
  const int taps = k * k;
  float* xs = smem;                                // [kCi][ih][iw]
  float* ws = smem + ((kCi * ih * iw + 3) & ~3);   // [kCi][taps][kCoutG]
  const int img = blockIdx.z / groups, co0 = (blockIdx.z % groups) * kCoutG;
  const int m0 = blockIdx.y * kQh, j0 = blockIdx.x * kQx;
  const int tx = threadIdx.x % kQx, ty = threadIdx.x / kQx;
  const int64_t plane_in = (int64_t)h * wi;

  float acc[kQr][2][2][kCoutG];
#pragma unroll
  for (int q = 0; q < kQr; ++q)
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int c = 0; c < kCoutG; ++c) acc[q][a][b][c] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += kCi) {
    const int cc = min(kCi, cin - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < cc * ih * iw; i += kThreads) {
      const int ci = i / (ih * iw), rem = i - ci * ih * iw;
      const int r = rem / iw, q = rem - r * iw;
      const int gy = m0 - lo + r, gx = j0 - lo + q;
      xs[i] = (gy >= 0 && gy < h && gx >= 0 && gx < wi)
                  ? to_f32(x[((int64_t)img * cin + c0 + ci) * plane_in +
                             (int64_t)gy * wi + gx])
                  : 0.f;
    }
    for (int i = threadIdx.x; i < cc * taps * kCoutG; i += kThreads) {
      const int co = i % kCoutG, t = i / kCoutG;
      const int tap = t % taps, ci = t / taps;
      ws[i] = co0 + co < cout
                  ? to_f32(w[((int64_t)(c0 + ci) * cout + co0 + co) * taps + tap])
                  : 0.f;
    }
    __syncthreads();
    for (int ci = 0; ci < cc; ++ci) {
      const float* xc = xs + ci * ih * iw + (ty * kQr + lo) * iw + tx + lo;
      const float* wc = ws + ci * taps * kCoutG;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        // output row 2m + a takes tap ky from input row m + (a + p - ky) / 2
        for (int ky = (a + p) & 1; ky < k; ky += 2) {
          const int dr = (a + p - ky) / 2;
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            for (int kx = (b + p) & 1; kx < k; kx += 2) {
              const int dc = (b + p - kx) / 2;
              float wv[kCoutG];
              load_row(wv, wc + (ky * k + kx) * kCoutG);
              const float* xr = xc + dr * iw + dc;
#pragma unroll
              for (int q = 0; q < kQr; ++q) {
                const float v = xr[q * iw];
#pragma unroll
                for (int c = 0; c < kCoutG; ++c)
                  acc[q][a][b][c] = fmaf(v, wv[c], acc[q][a][b][c]);
              }
            }
          }
        }
      }
    }
  }

  const int64_t plane_out = (int64_t)ho * wo;
  T* yo = y + ((int64_t)img * cout + co0) * plane_out;
#pragma unroll
  for (int c = 0; c < kCoutG; ++c) {
    if (co0 + c >= cout) break;
    const float bc = bias[co0 + c];
#pragma unroll
    for (int q = 0; q < kQr; ++q)
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int oy = 2 * (m0 + ty * kQr + q) + a;
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int ox = 2 * (j0 + tx) + b;
          if (oy < ho && ox < wo)
            store(yo + c * plane_out + (int64_t)oy * wo + ox, acc[q][a][b][c] + bc);
        }
      }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* bias, void* y, int n, int cin,
           int h, int wi, int cout, int k, int ho, int wo, cudaStream_t stream) {
  const int groups = (cout + kCoutG - 1) / kCoutG;
  if ((int64_t)n * groups > 65535) return (int)cudaErrorInvalidValue;
  const int p = k / 2, lo = (k - 1 - p) / 2, hi = (1 + p) / 2;
  const int ih = kQh + lo + hi, iw = kQx + lo + hi;
  const size_t smem =
      (size_t)(((kCi * ih * iw + 3) & ~3) + kCi * k * k * kCoutG) * sizeof(float);
  cudaError_t err = msau::allow_smem(deconv2_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  // one quad row per input row: quads cover rows [0, ceil(ho / 2)) = [0, h)
  const dim3 grid((wi + kQx - 1) / kQx, (h + kQh - 1) / kQh, n * groups);
  deconv2_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const T*)w, (const float*)bias, (T*)y, cin, h, wi, cout, k, ho,
      wo, groups);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [n, cin, h, w]; w: [cin, cout, k, k] (odd k) in the activation dtype;
// bias: [cout] f32; y: [n, cout, ho, wo] with ho in {2h-1, 2h}, wo in
// {2w-1, 2w}.
extern "C" int msau_flat_deconv2(const void* x, const void* w, const void* bias,
                                 void* y, int n, int cin, int h, int wd, int cout,
                                 int k, int ho, int wo, int is_bf16, void* stream) {
  if (n < 0 || cin <= 0 || h < 0 || wd < 0 || cout <= 0 || k <= 0 || k % 2 == 0 ||
      (ho != 2 * h - 1 && ho != 2 * h) || (wo != 2 * wd - 1 && wo != 2 * wd))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || h == 0 || wd == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch<__nv_bfloat16>(x, w, bias, y, n, cin, h, wd, cout, k, ho,
                                         wo, s)
                 : launch<float>(x, w, bias, y, n, cin, h, wd, cout, k, ho, wo, s);
}
