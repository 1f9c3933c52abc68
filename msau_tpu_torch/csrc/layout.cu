// Entry layout: NHWC [N, H, W, C] -> contiguous NCHW [N, C, H, W], cast to
// the compute dtype in the same pass.
//
// Replaces the TPU kernel msau_tpu/ops/flatconv.py:_to_body_kernel (launcher
// _to_body_nhwc_prim), which transposes the chargrid into the W-on-lanes
// body layout on the MXU (an identity contraction) after XLA has cast it
// (msau_tpu/models/msau.py:145).  The port's layout is compact NCHW, so the
// guard blocks and pad columns go; the cast folds into this pass.
//
// What bounds it on the H100: memory.  At the flagship (one 512^2 page, 64
// channels) it reads 64 MiB of f32 and writes 32 MiB of bf16 (64 MiB f32),
// no arithmetic.  Design: the classic shared-memory tiled transpose.  Each
// image is a [H*W, C] matrix; a 32 x 32 tile is read with a warp along C
// (128 contiguous bytes of f32) and written with a warp along H*W, through a
// padded [32][33] f32 tile so neither side has bank conflicts.

#include <stdint.h>

#include "common.cuh"

namespace {

using msau::store;
using msau::to_f32;

constexpr int kTile = 32;
constexpr int kRows = 8;  // threadIdx.y extent: each thread moves 4 values

template <typename TI, typename TO>
__global__ void __launch_bounds__(kTile * kRows)
nhwc_to_nchw_kernel(const TI* __restrict__ x, TO* __restrict__ y, int hw, int c) {
  __shared__ float tile[kTile][kTile + 1];
  const int p0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  const int64_t img = blockIdx.z;
  const TI* xi = x + img * hw * (int64_t)c;
  TO* yi = y + img * hw * (int64_t)c;
#pragma unroll
  for (int j = threadIdx.y; j < kTile; j += kRows) {
    const int p = p0 + j, ch = c0 + threadIdx.x;
    if (p < hw && ch < c) tile[j][threadIdx.x] = to_f32(xi[(int64_t)p * c + ch]);
  }
  __syncthreads();
#pragma unroll
  for (int j = threadIdx.y; j < kTile; j += kRows) {
    const int ch = c0 + j, p = p0 + threadIdx.x;
    if (p < hw && ch < c) store(yi + (int64_t)ch * hw + p, tile[threadIdx.x][j]);
  }
}

template <typename TI, typename TO>
int launch(const void* x, void* y, int n, int hw, int c, cudaStream_t stream) {
  const dim3 grid((hw + kTile - 1) / kTile, (c + kTile - 1) / kTile, n);
  nhwc_to_nchw_kernel<TI, TO><<<grid, dim3(kTile, kRows), 0, stream>>>(
      (const TI*)x, (TO*)y, hw, c);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [n, hw, c] in f32 or bf16 (in_bf16); y: [n, c, hw] in f32 or bf16.
extern "C" int msau_nhwc_to_nchw(const void* x, void* y, int n, int hw, int c,
                                 int in_bf16, int out_bf16, void* stream) {
  if (n < 0 || hw < 0 || c < 0 || n > 65535) return (int)cudaErrorInvalidValue;
  if (n == 0 || hw == 0 || c == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (in_bf16)
    return out_bf16 ? launch<bf16, bf16>(x, y, n, hw, c, s)
                    : launch<bf16, float>(x, y, n, hw, c, s);
  return out_bf16 ? launch<float, bf16>(x, y, n, hw, c, s)
                  : launch<float, float>(x, y, n, hw, c, s);
}
