// Fused masked cross-entropy over channel-major logits [N, C, L], forward
// and backward:
//
//   ce_sum  = sum_p mask_p (logsumexp_c l[c, p] - l[label_p, p])
//   correct = sum_p mask_p [l[label_p, p] >= max_c l[c, p]]   (ties correct)
//   dlogits = (softmax_c l[:, p] - onehot(label_p)) * mask_p * g
//
// labels int32 [N, L] clamped to [0, C-1]; mask f32 0/1 [N, L]; logits f32
// or bf16, f32 arithmetic, dlogits in the logits' dtype.
//
// Replaces the TPU kernels msau_tpu/ops/ce_loss.py:_ce_fwd_kernel (launcher
// _ce_call) and _ce_bwd_kernel (launcher _ce_vjp_bwd).  Those accumulate the
// two scalars across a SEQUENTIAL grid; Hopper blocks run in no order.
//
// What bounds it on the H100: memory.  At the flagship ([16, 17, 512^2] f32)
// the forward reads 285 MB of logits and does ~20 flops per element; the
// backward reads and writes 285 MB each.  One thread per pixel: adjacent
// threads take adjacent pixels, so each class row is read coalesced along L;
// a pixel's logits are read once from device memory and again (sum-exp,
// label / gradient pass) from L1.
//
// Design, with no float atomics so the loss is reproducible:
//  fwd_kernel:     each block reduces 1024 pixels into one (ce, correct)
//                  partial in a fixed shuffle order;
//  combine_kernel: one block sums the partials in a fixed order, in f64, and
//                  writes the two f32 scalars;
//  bwd_kernel:     one elementwise pass; g is read from device memory, so the
//                  host never waits for the loss.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using msau::store;
using msau::to_f32;

constexpr int kFwdThreads = 256;
constexpr int kFwdPixels = 1024;  // per block: 4 per thread
constexpr int kCombineThreads = 1024;
constexpr int kBwdThreads = 256;

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

// max and sum-exp of one pixel's logits (stride L between classes)
template <typename T>
__device__ __forceinline__ void pixel_stats(const T* lp, int nclass, int64_t length,
                                            float& mx, float& se) {
  mx = -INFINITY;
  for (int c = 0; c < nclass; ++c) mx = fmaxf(mx, to_f32(lp[c * length]));
  se = 0.f;
  for (int c = 0; c < nclass; ++c) se += expf(to_f32(lp[c * length]) - mx);
}

template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
fwd_kernel(const T* __restrict__ logits, const int* __restrict__ labels,
           const float* __restrict__ mask, float* __restrict__ partial,
           int nclass, int length, int64_t total, int blocks) {
  float ce = 0.f, cnt = 0.f;
#pragma unroll
  for (int r = 0; r < kFwdPixels / kFwdThreads; ++r) {
    const int64_t p = (int64_t)blockIdx.x * kFwdPixels + r * kFwdThreads + threadIdx.x;
    if (p < total) {
      const int64_t img = p / length, pix = p % length;
      const T* lp = logits + img * nclass * (int64_t)length + pix;
      const int lab = min(max(labels[p], 0), nclass - 1);
      const float mk = mask[p];
      float mx, se;
      pixel_stats(lp, nclass, length, mx, se);
      const float lsel = to_f32(lp[(int64_t)lab * length]);
      ce += (mx + logf(se) - lsel) * mk;
      cnt += lsel >= mx ? mk : 0.f;
    }
  }
  __shared__ float s_ce[kFwdThreads / 32], s_cnt[kFwdThreads / 32];
  ce = warp_sum(ce);
  cnt = warp_sum(cnt);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_ce[warp] = ce;
    s_cnt[warp] = cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f, b = 0.f;
    for (int w = 0; w < kFwdThreads / 32; ++w) {
      a += s_ce[w];
      b += s_cnt[w];
    }
    partial[blockIdx.x] = a;
    partial[blocks + blockIdx.x] = b;
  }
}

__global__ void __launch_bounds__(kCombineThreads)
combine_kernel(const float* __restrict__ partial, float* __restrict__ ce_out,
               float* __restrict__ correct_out, int blocks) {
  double a = 0.0, b = 0.0;
  for (int k = threadIdx.x; k < blocks; k += kCombineThreads) {
    a += partial[k];
    b += partial[blocks + k];
  }
  __shared__ double s_a[kCombineThreads / 32], s_b[kCombineThreads / 32];
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_a[warp] = a;
    s_b[warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double sa = 0.0, sb = 0.0;
    for (int w = 0; w < kCombineThreads / 32; ++w) {
      sa += s_a[w];
      sb += s_b[w];
    }
    *ce_out = (float)sa;
    *correct_out = (float)sb;
  }
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
bwd_kernel(const T* __restrict__ logits, const int* __restrict__ labels,
           const float* __restrict__ mask, const float* __restrict__ g,
           T* __restrict__ dlogits, int nclass, int length, int64_t total) {
  const int64_t p = (int64_t)blockIdx.x * kBwdThreads + threadIdx.x;
  if (p >= total) return;
  const int64_t img = p / length, pix = p % length;
  const int64_t base = img * nclass * (int64_t)length + pix;
  const T* lp = logits + base;
  T* dp = dlogits + base;
  const int lab = min(max(labels[p], 0), nclass - 1);
  const float scale = mask[p] * *g;
  float mx, se;
  pixel_stats(lp, nclass, length, mx, se);
  for (int c = 0; c < nclass; ++c) {
    const float prob = expf(to_f32(lp[c * (int64_t)length]) - mx) / se;
    store(dp + c * (int64_t)length, (prob - (c == lab ? 1.f : 0.f)) * scale);
  }
}

template <typename T>
int launch_fwd(const void* logits, const void* labels, const void* mask,
               void* partial, void* ce_out, void* correct_out, int blocks,
               int n, int c, int length, cudaStream_t stream) {
  const int64_t total = (int64_t)n * length;
  if (blocks != (int)((total + kFwdPixels - 1) / kFwdPixels) && !(total == 0 && blocks == 1))
    return (int)cudaErrorInvalidValue;
  fwd_kernel<T><<<blocks, kFwdThreads, 0, stream>>>(
      (const T*)logits, (const int*)labels, (const float*)mask,
      (float*)partial, c, length, total, blocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<<<1, kCombineThreads, 0, stream>>>(
      (const float*)partial, (float*)ce_out, (float*)correct_out, blocks);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* logits, const void* labels, const void* mask,
               const void* g, void* dlogits, int n, int c, int length,
               cudaStream_t stream) {
  const int64_t total = (int64_t)n * length;
  if (total == 0) return 0;
  bwd_kernel<T><<<(unsigned)((total + kBwdThreads - 1) / kBwdThreads),
                  kBwdThreads, 0, stream>>>(
      (const T*)logits, (const int*)labels, (const float*)mask,
      (const float*)g, (T*)dlogits, c, length, total);
  return (int)cudaGetLastError();
}

}  // namespace

// partial: [2, blocks] f32 scratch, blocks = max(1, ceil(N * L / 1024)),
// allocated by the caller; ce_out and correct_out are one f32 each.
extern "C" int msau_masked_ce_fwd(const void* logits, const void* labels,
                                  const void* mask, void* partial,
                                  void* ce_out, void* correct_out, int blocks,
                                  int n, int c, int length, int is_bf16,
                                  void* stream) {
  if (n < 0 || c <= 0 || length < 0 || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch_fwd<__nv_bfloat16>(logits, labels, mask, partial,
                                             ce_out, correct_out, blocks, n, c,
                                             length, s)
                 : launch_fwd<float>(logits, labels, mask, partial, ce_out,
                                     correct_out, blocks, n, c, length, s);
}

extern "C" int msau_masked_ce_bwd(const void* logits, const void* labels,
                                  const void* mask, const void* g,
                                  void* dlogits, int n, int c, int length,
                                  int is_bf16, void* stream) {
  if (n < 0 || c <= 0 || length < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch_bwd<__nv_bfloat16>(logits, labels, mask, g, dlogits,
                                             n, c, length, s)
                 : launch_bwd<float>(logits, labels, mask, g, dlogits, n, c,
                                     length, s);
}
