// Stride-1 KH x KW conv with dilation d and explicit (TF-SAME by default)
// padding on NCHW, with the ConvBnLrnDrop epilogue fused: + bias, then
// relu / elu, then a LocalResponseNorm across the output channels (torch
// semantics: window [c - size/2, c + (size-1)/2] clamped to the channels,
// scaled by alpha / size), all on the f32 accumulator.  The input may be two
// tensors [a; b] read as their channel concat, which is never written out;
// the output may be split over two tensors (channels [0, cout_a) and the
// rest), which is how the backward writes the two branch cotangents of a
// concat conv as its transposed conv.
//
// Replaces the TPU kernels msau_tpu/ops/flatconv.py:_fwd_kernel (launcher
// _conv_body: convs, tuple-input merge convs, split-output dx convs, the
// fused epilogue) and _cc_fwd_kernel (launcher _concat_conv1x1_prim: the
// two-input 1x1 coupling conv, here the KH = KW = 1 case of the same
// kernel).  The TPU kernels build a tap stack in VMEM for one MXU matmul
// per row block, split a wide cin over separate launches and sum their
// outputs; here one block loops over cin chunks itself (conv_tile.cuh).
//
// What bounds it on the H100: arithmetic on the FP32 pipes.  At the
// flagship's 512^2 scale a 3x3 conv does 9 * cin * cout FMAs per pixel
// against (cin + cout) * 4 bytes of traffic: 8 -> 8 is 576 FMAs for 64 B,
// far above the 20 FMA/B at which the card's 67 TFLOP/s f32 rate and
// 3.35 TB/s meet.  So the design keeps every operand on chip:
//   - one block per 32-column x TH-row output tile and 32 output channels
//     (a wider cout takes several blocks, one per 32 channels);
//   - each thread owns one column and 64 / COUT rows of it, with all COUT
//     accumulators in registers (64 f32 registers), so each shared-memory
//     load of an input feeds COUT FMAs and each weight load 64 / COUT;
//   - the epilogue (bias, act, the LRN window as a sum over the thread's
//     own registers) runs before the only global write.
// An LRN over more than 32 channels needs channels of other blocks: such a
// block (one row per thread, TH = 4) recomputes the conv of every 32-channel
// chunk its channels' windows touch and adds their squares into its window
// sums, so cout and the LRN size are unbounded.
// Tensor cores are later work: the channel counts (8..32) are below one
// wgmma tile's K.

#include <math.h>
#include <stdint.h>

#include "conv_tile.cuh"

namespace {

using msau::apply_act;
using msau::conv_tile;
using msau::ConvIn;
using msau::kThreads;
using msau::kTw;
using msau::kTy;
using msau::store;

constexpr int kAcc = 64;      // f32 accumulators per thread

struct ConvArgs {
  ConvIn in;
  const float* bias;   // [cout]
  void* y;             // [n, cout_a, h, w]
  void* y2;            // [n, cout - cout_a, h, w] or null (cout_a = cout)
  int cout_a, act, lrn_size;
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

// Writes output channel co of pixel (oy, ox) into y or y2.
template <typename T>
__device__ __forceinline__ void store_split(const ConvArgs& p, int img, int co, int oy,
                                            int ox, float v) {
  const int64_t plane = (int64_t)p.in.h * p.in.w_;
  const int64_t off = (int64_t)oy * p.in.w_ + ox;
  if (co < p.cout_a)
    store((T*)p.y + ((int64_t)img * p.cout_a + co) * plane + off, v);
  else
    store((T*)p.y2 + ((int64_t)img * (p.in.cout - p.cout_a) + co - p.cout_a) * plane +
              off, v);
}

template <typename T, int COUT>
__global__ void __launch_bounds__(kThreads)
conv_kernel(ConvArgs p, int groups) {
  constexpr int PIX = kAcc / COUT;   // output rows per thread
  extern __shared__ __align__(16) float smem[];
  const int img = blockIdx.z / groups, co0 = (blockIdx.z % groups) * COUT;
  const int x0 = blockIdx.x * kTw, y0 = blockIdx.y * (kTy * PIX);
  const int tx = threadIdx.x % kTw, ty = threadIdx.x / kTw;
  float acc[PIX][COUT];
  conv_tile<T, COUT, PIX>(p.in, smem, img, co0, x0, y0, acc);

  float bv[COUT];
#pragma unroll
  for (int c = 0; c < COUT; ++c)
    bv[c] = co0 + c < p.in.cout ? p.bias[co0 + c] : 0.f;
  const int ox = x0 + tx;
#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    const int oy = y0 + ty * PIX + i;
    float v[COUT];
#pragma unroll
    for (int c = 0; c < COUT; ++c) v[c] = apply_act(acc[i][c] + bv[c], p.act);
    if (p.lrn_size > 0)
      lrn_inplace(v, p.in.cout, p.lrn_size, p.alpha, p.beta, p.lrn_k);
    if (oy < p.in.h && ox < p.in.w_) {
#pragma unroll
      for (int c = 0; c < COUT; ++c)
        if (co0 + c < p.in.cout) store_split<T>(p, img, co0 + c, oy, ox, v[c]);
    }
  }
}

// cout > 32 with LRN: 32 channels per block, one row per thread; the
// squares of every channel in the block's windows come from recomputing
// the conv of each 32-channel chunk they lie in (ascending channel order,
// as lrn_inplace sums).
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_lrn_wide_kernel(ConvArgs p, int groups) {
  constexpr int COUT = 32;
  extern __shared__ __align__(16) float smem[];
  const int img = blockIdx.z / groups, co0 = (blockIdx.z % groups) * COUT;
  const int x0 = blockIdx.x * kTw, y0 = blockIdx.y * kTy;
  const int tx = threadIdx.x % kTw, ty = threadIdx.x / kTw;
  const int cout = p.in.cout, lo = p.lrn_size / 2, hi = (p.lrn_size - 1) / 2;
  float v[COUT], win[COUT];
#pragma unroll
  for (int c = 0; c < COUT; ++c) v[c] = win[c] = 0.f;
  const int j_end = min(cout - 1, co0 + COUT - 1 + hi) / COUT;
  for (int j = max(0, co0 - lo) / COUT; j <= j_end; ++j) {
    float acc[1][COUT];
    conv_tile<T, COUT, 1>(p.in, smem, img, j * COUT, x0, y0, acc);
#pragma unroll
    for (int c = 0; c < COUT; ++c) {
      const int ch = j * COUT + c;
      const float y = ch < cout ? apply_act(acc[0][c] + p.bias[ch], p.act) : 0.f;
      if (j * COUT == co0) v[c] = y;
      const float sq = y * y;
#pragma unroll
      for (int co = 0; co < COUT; ++co)
        if (ch < cout && ch >= co0 + co - lo && ch <= co0 + co + hi) win[co] += sq;
    }
  }
  const float scale = p.alpha / (float)p.lrn_size;
  const int oy = y0 + ty, ox = x0 + tx;
  if (oy < p.in.h && ox < p.in.w_) {
#pragma unroll
    for (int c = 0; c < COUT; ++c)
      if (co0 + c < cout)
        store_split<T>(p, img, co0 + c, oy, ox,
                       v[c] * powf(p.lrn_k + scale * win[c], -p.beta));
  }
}

template <typename Kernel>
int launch_grid(Kernel kernel, const ConvArgs& p, int n, int cout_blk, int th,
                size_t smem, cudaStream_t stream) {
  const int groups = (p.in.cout + cout_blk - 1) / cout_blk;
  if ((int64_t)n * groups > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = msau::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.in.w_ + kTw - 1) / kTw, (p.in.h + th - 1) / th, n * groups);
  kernel<<<grid, kThreads, smem, stream>>>(p, groups);
  return (int)cudaGetLastError();
}

template <typename T, int COUT>
int launch(const ConvArgs& p, int n, cudaStream_t stream) {
  constexpr int TH = kTy * (kAcc / COUT);
  const size_t smem = msau::conv_tile_floats<COUT>(p.in, TH) * sizeof(float);
  return launch_grid(conv_kernel<T, COUT>, p, n, COUT, TH, smem, stream);
}

template <typename T>
int dispatch(const ConvArgs& p, int n, cudaStream_t stream) {
  if (p.in.cout <= 8) return launch<T, 8>(p, n, stream);
  if (p.in.cout <= 16) return launch<T, 16>(p, n, stream);
  if (p.in.cout <= 32 || p.lrn_size == 0) return launch<T, 32>(p, n, stream);
  const size_t smem = msau::conv_tile_floats<32>(p.in, kTy) * sizeof(float);
  return launch_grid(conv_lrn_wide_kernel<T>, p, n, 32, kTy, smem, stream);
}

}  // namespace

// a: [n, ca, h, w]; b: [n, cb, h, w] or null with cb = 0; w: [cout, ca + cb,
// kh, kw] in the activation dtype; bias: [cout] f32; y: [n, cout_a, h, w]
// and y2: [n, cout - cout_a, h, w] (null with cout_a = cout).  pt / pleft:
// the padding above / left of the image (the output has the input's size).
// act: 0 none, 1 relu, 2 elu.  lrn_size 0 skips the LRN.
extern "C" int msau_flat_conv2d(const void* a, const void* b, const void* w,
                                const void* bias, void* y, void* y2, int n, int ca,
                                int cb, int h, int wd, int cout, int cout_a, int kh,
                                int kw, int dil, int pt, int pleft, int act,
                                int lrn_size, float alpha, float beta, float lrn_k,
                                int is_bf16, void* stream) {
  if (n < 0 || ca <= 0 || cb < 0 || h < 0 || wd < 0 || cout <= 0 || kh <= 0 ||
      kw <= 0 || dil <= 0 || pt < 0 || pleft < 0 || pt > (kh - 1) * dil ||
      pleft > (kw - 1) * dil || act < 0 || act > 2 || lrn_size < 0 ||
      (cb > 0 && b == nullptr) || cout_a <= 0 || cout_a > cout ||
      (cout_a < cout && y2 == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || h == 0 || wd == 0) return 0;
  const ConvArgs p{{a, b, w, ca, cb, h, wd, cout, kh, kw, dil, pt, pleft},
                   (const float*)bias, y, y2, cout_a, act, lrn_size, alpha, beta,
                   lrn_k};
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? dispatch<__nv_bfloat16>(p, n, s) : dispatch<float>(p, n, s);
}
