// Stride-1 KH x KW conv with dilation d and TF-SAME padding on NCHW, with
// the ConvBnLrnDrop epilogue fused: + bias, then relu / elu, then a
// LocalResponseNorm across the output channels (torch semantics: window
// [c - size/2, c + (size-1)/2] clamped to the channels, scaled by
// alpha / size), all on the f32 accumulator.  The input may be two tensors
// [a; b] read as their channel concat, which is never written out.
//
// Replaces the TPU kernels msau_tpu/ops/flatconv.py:_fwd_kernel (launcher
// _conv_body: convs, tuple-input merge convs, the fused epilogue) and
// _cc_fwd_kernel (launcher _concat_conv1x1_prim: the two-input 1x1
// coupling conv, here the KH = KW = 1 case of the same kernel).  The TPU
// kernels build a tap stack in VMEM for one MXU matmul per row block, split
// a wide cin over separate launches and sum their outputs; here one block
// loops over cin chunks itself.
//
// What bounds it on the H100: arithmetic on the FP32 pipes.  At the
// flagship's 512^2 scale a 3x3 conv does 9 * cin * cout FMAs per pixel
// against (cin + cout) * 4 bytes of traffic: 8 -> 8 is 576 FMAs for 64 B,
// far above the 20 FMA/B at which the card's 67 TFLOP/s f32 rate and
// 3.35 TB/s meet.  So the design keeps every operand on chip:
//   - one block per 32-column x TH-row output tile, all cout (up to 32; a
//     wider cout without LRN takes several blocks, one per 32 channels);
//   - the input tile with its halo for 8 input channels at a time in
//     shared memory (f32, converted once from bf16), the weights of those
//     8 channels beside it, laid out [ci][tap][co] so a thread reads one
//     tap's cout weights as 16-byte broadcast loads;
//   - each thread owns one column and 64 / COUT rows of it, with all COUT
//     accumulators in registers (64 f32 registers), so each shared-memory
//     load of an input feeds COUT FMAs and each weight load 64 / COUT;
//   - the epilogue (bias, act, the LRN window as a sum over the thread's
//     own registers) runs before the only global write.
// Tensor cores are later work: the channel counts (8..32) are below one
// wgmma tile's K.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using msau::apply_act;
using msau::load_row;
using msau::store;
using msau::to_f32;

constexpr int kTw = 32;       // output columns per block: one per lane
constexpr int kTy = 4;        // warps per block
constexpr int kThreads = kTw * kTy;
constexpr int kCi = 8;        // input channels staged per chunk
constexpr int kAcc = 64;      // f32 accumulators per thread

struct ConvArgs {
  const void* a;
  const void* b;
  const void* w;       // [cout, ca + cb, kh, kw] in the activation dtype
  const float* bias;   // [cout]
  void* y;             // [n, cout, h, w]
  int ca, cb, h, w_, cout, kh, kw, dil, pt, pleft, act, lrn_size;
  float alpha, beta, lrn_k;
};

// LocalResponseNorm across the COUT registers of one pixel (channels at or
// above cout are padding and never enter a window).
template <int COUT>
__device__ __forceinline__ void lrn_inplace(float (&v)[COUT], int cout, int size,
                                            float alpha, float beta, float k) {
  const int lo = size / 2, hi = (size - 1) / 2;
  const float scale = alpha / (float)size;
  float sq[COUT];
#pragma unroll
  for (int c = 0; c < COUT; ++c) sq[c] = v[c] * v[c];
#pragma unroll
  for (int co = 0; co < COUT; ++co) {
    float win = 0.f;
#pragma unroll
    for (int c = 0; c < COUT; ++c)
      if (c < cout && c >= co - lo && c <= co + hi) win += sq[c];
    v[co] *= powf(k + scale * win, -beta);
  }
}

template <typename T, int COUT>
__global__ void __launch_bounds__(kThreads)
conv_kernel(ConvArgs p, int groups) {
  constexpr int PIX = kAcc / COUT;   // output rows per thread
  constexpr int TH = kTy * PIX;      // output rows per block
  extern __shared__ __align__(16) float smem[];
  const T* __restrict__ a = (const T*)p.a;
  const T* __restrict__ b = (const T*)p.b;
  const T* __restrict__ w = (const T*)p.w;
  const int cin = p.ca + p.cb, taps = p.kh * p.kw;
  const int ih = TH + (p.kh - 1) * p.dil, iw = kTw + (p.kw - 1) * p.dil;
  float* xs = smem;                                  // [kCi][ih][iw]
  float* ws = smem + ((kCi * ih * iw + 3) & ~3);     // [kCi][taps][COUT]
  const int img = blockIdx.z / groups, co0 = (blockIdx.z % groups) * COUT;
  const int x0 = blockIdx.x * kTw, y0 = blockIdx.y * TH;
  const int tx = threadIdx.x % kTw, ty = threadIdx.x / kTw;
  const int64_t plane = (int64_t)p.h * p.w_;

  float acc[PIX][COUT];
#pragma unroll
  for (int i = 0; i < PIX; ++i)
#pragma unroll
    for (int c = 0; c < COUT; ++c) acc[i][c] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += kCi) {
    const int cc = min(kCi, cin - c0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = threadIdx.x; i < cc * ih * iw; i += kThreads) {
      const int ci = i / (ih * iw), rem = i - ci * ih * iw;
      const int r = rem / iw, q = rem - r * iw;
      const int gy = y0 - p.pt + r, gx = x0 - p.pleft + q;
      float v = 0.f;  // SAME padding
      if (gy >= 0 && gy < p.h && gx >= 0 && gx < p.w_) {
        const int ch = c0 + ci;
        const T* src = ch < p.ca ? a + ((int64_t)img * p.ca + ch) * plane
                                 : b + ((int64_t)img * p.cb + (ch - p.ca)) * plane;
        v = to_f32(src[(int64_t)gy * p.w_ + gx]);
      }
      xs[i] = v;
    }
    for (int i = threadIdx.x; i < cc * taps * COUT; i += kThreads) {
      const int co = i % COUT, t = i / COUT;
      const int tap = t % taps, ci = t / taps;
      ws[i] = co0 + co < p.cout
                  ? to_f32(w[((int64_t)(co0 + co) * cin + c0 + ci) * taps + tap])
                  : 0.f;
    }
    __syncthreads();
    for (int ci = 0; ci < cc; ++ci) {
      const float* xc = xs + ci * ih * iw + ty * PIX * iw + tx;
      const float* wc = ws + ci * taps * COUT;
      for (int ky = 0; ky < p.kh; ++ky) {
        for (int kx = 0; kx < p.kw; ++kx) {
          float wv[COUT];
          load_row(wv, wc + (ky * p.kw + kx) * COUT);
          const float* xr = xc + ky * p.dil * iw + kx * p.dil;
#pragma unroll
          for (int i = 0; i < PIX; ++i) {
            const float v = xr[i * iw];
#pragma unroll
            for (int c = 0; c < COUT; ++c) acc[i][c] = fmaf(v, wv[c], acc[i][c]);
          }
        }
      }
    }
  }

  float bv[COUT];
#pragma unroll
  for (int c = 0; c < COUT; ++c) bv[c] = co0 + c < p.cout ? p.bias[co0 + c] : 0.f;
  T* y = (T*)p.y + ((int64_t)img * p.cout + co0) * plane;
  const int ox = x0 + tx;
#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    const int oy = y0 + ty * PIX + i;
    float v[COUT];
#pragma unroll
    for (int c = 0; c < COUT; ++c) v[c] = apply_act(acc[i][c] + bv[c], p.act);
    if (p.lrn_size > 0) lrn_inplace(v, p.cout, p.lrn_size, p.alpha, p.beta, p.lrn_k);
    if (oy < p.h && ox < p.w_) {
#pragma unroll
      for (int c = 0; c < COUT; ++c)
        if (co0 + c < p.cout) store(y + c * plane + (int64_t)oy * p.w_ + ox, v[c]);
    }
  }
}

template <typename T, int COUT>
int launch(const ConvArgs& p, int n, cudaStream_t stream) {
  constexpr int TH = kTy * (kAcc / COUT);
  const int groups = (p.cout + COUT - 1) / COUT;
  if ((int64_t)n * groups > 65535) return (int)cudaErrorInvalidValue;
  const int ih = TH + (p.kh - 1) * p.dil, iw = kTw + (p.kw - 1) * p.dil;
  const size_t smem =
      (size_t)(((kCi * ih * iw + 3) & ~3) + kCi * p.kh * p.kw * COUT) * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = msau::allow_smem(conv_kernel<T, COUT>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.w_ + kTw - 1) / kTw, (p.h + TH - 1) / TH, n * groups);
  conv_kernel<T, COUT><<<grid, kThreads, smem, stream>>>(p, groups);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const ConvArgs& p, int n, cudaStream_t stream) {
  if (p.cout <= 8) return launch<T, 8>(p, n, stream);
  if (p.cout <= 16) return launch<T, 16>(p, n, stream);
  return launch<T, 32>(p, n, stream);
}

}  // namespace

// a: [n, ca, h, w]; b: [n, cb, h, w] or null with cb = 0; w: [cout, ca + cb,
// kh, kw] in the activation dtype; bias: [cout] f32; y: [n, cout, h, w].
// pt / pleft: the SAME padding above / left of the image.  act: 0 none,
// 1 relu, 2 elu.  lrn_size 0 skips the LRN; it needs cout <= 32 (one block
// holds every channel).
extern "C" int msau_flat_conv2d(const void* a, const void* b, const void* w,
                                const void* bias, void* y, int n, int ca, int cb,
                                int h, int wd, int cout, int kh, int kw, int dil,
                                int pt, int pleft, int act, int lrn_size,
                                float alpha, float beta, float lrn_k,
                                int is_bf16, void* stream) {
  if (n < 0 || ca <= 0 || cb < 0 || h < 0 || wd < 0 || cout <= 0 || kh <= 0 ||
      kw <= 0 || dil <= 0 || pt < 0 || pleft < 0 || act < 0 || act > 2 ||
      lrn_size < 0 || (lrn_size > 0 && cout > 32) || (cb > 0 && b == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || h == 0 || wd == 0) return 0;
  const ConvArgs p{a, b, w, (const float*)bias, y, ca, cb, h, wd, cout, kh, kw,
                   dil, pt, pleft, act, lrn_size, alpha, beta, lrn_k};
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? dispatch<__nv_bfloat16>(p, n, s) : dispatch<float>(p, n, s);
}
