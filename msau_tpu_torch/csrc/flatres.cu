// Fused residual block (res_depth 2, 3x3, Cin = Cout = C) on NCHW:
//
//   h1 = act(conv1(relu(x)) + b1)     rounded to the activation dtype
//   y  = act(conv2(h1) + b2 + x)
//
// with SAME padding for both convs: h1 is 0 outside the image (conv2 reads
// zero padding there, not act(b1)).  Accumulation and epilogues in f32.
//
// Replaces the TPU kernels msau_tpu/ops/flatres.py:_fwd_kernel and
// _fwd_kernel_al (launcher _fused_fwd_call; the _al body is the same
// function on the TPU's lane-aligned layout), which keep relu(x), the conv1
// output (in an x.dtype scratch) and the residual in VMEM; only x is read
// and y written.  The JAX package falls back to two flat convs where its
// VMEM gate fails; this kernel has no such gate.
//
// What bounds it on the H100: in f32 the FP32 pipes (2 x 9 C^2 FMAs per
// pixel, plus conv1 over the tile's 1-pixel halo); in bf16, with both convs
// on the tensor cores, device memory (x read once, y written once).
// Design (res_block.cuh): a persistent grid of 8-warp blocks, each staging
// both weight sets once and walking 32-column tiles (16 rows at C <= 16 in
// bf16 and C <= 8 in f32, else 8).  Per tile:
//   1. relu(x) over the tile's 2-pixel halo, staged as [pixel][channel];
//   2. conv1 over the 1-pixel halo (an implicit GEMM: mma.sync in bf16, FMA
//      register tiles in f32): h1 = act(. + b1), rounded, 0 off the image,
//      kept as [pixel][channel] in the activation dtype;
//   3. conv2 over the tile into f32 [co][pixel] (+ b2, in the staged x's
//      place);
//   4. y = act(. + x) written as 16-byte runs, x re-read from L2.

#include <stdint.h>

#include "res_block.cuh"

namespace {

using msau::apply_act;
using namespace msau::res;

template <typename T, int C>
struct FwdCfg {
  static constexpr int TH = (sizeof(T) == 4 ? C >= 16 : C >= 32) ? 8 : 16;
  static constexpr int TW = 32, NW = 8;
  // f32 at C <= 8: 3 resident blocks (0.43 against 0.46 ms with 2 at 8 ch
  // 512^2, batch 16, on an H100)
  static constexpr int MINB = sizeof(T) == 4 ? (C >= 32 ? 1 : C <= 8 ? 3 : 2) : 2;
};

// shared memory, bytes: both weight sets, the biases, h1 (halo 1), then
// relu(x) (halo 2) and in its place conv2's f32 [co][pixel] output
template <typename T, int C>
struct FwdLayout {
  using Q = Ch<T, C>;
  using F = FwdCfg<T, C>;
  using X = Reg<F::TH, F::TW, 2>;
  using H1 = Reg<F::TH, F::TW, 1>;
  static constexpr int ES = row4(F::TH * F::TW);
  static constexpr size_t bias = a16(2 * Q::W_ELEMS * sizeof(T));
  static constexpr size_t hs = bias + a16(2 * Q::CP * 4);
  static constexpr size_t xs = hs + a16(H1::N * Q::CS * sizeof(T));
  static constexpr size_t xbytes = a16(X::N * Q::CS * sizeof(T));
  static constexpr size_t ebytes = a16(Q::CP * ES * 4);
  static constexpr size_t total = xs + (xbytes > ebytes ? xbytes : ebytes);
};

template <typename T, int C>
__global__ void __launch_bounds__(FwdCfg<T, C>::NW * 32, FwdCfg<T, C>::MINB)
res_block_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                 const float* __restrict__ b1, const T* __restrict__ w2,
                 const float* __restrict__ b2, T* __restrict__ y, int h, int wd, int act,
                 int tiles_x, int tiles_y, int n_tiles, int vec) {
  using F = FwdCfg<T, C>;
  using Q = Ch<T, C>;
  using L = FwdLayout<T, C>;
  constexpr int TH = F::TH, TW = F::TW, NW = F::NW, NTH = 32 * NW;
  constexpr int CP = Q::CP, CS = Q::CS, ES = L::ES;
  extern __shared__ __align__(16) unsigned char smem[];
  T* w1s = reinterpret_cast<T*>(smem);
  T* w2s = w1s + Q::W_ELEMS;
  float* bs = reinterpret_cast<float*>(smem + L::bias);   // b1 [CP], b2 [CP]
  T* hs = reinterpret_cast<T*>(smem + L::hs);
  T* xs = reinterpret_cast<T*>(smem + L::xs);
  float* E = reinterpret_cast<float*>(smem + L::xs);
  stage_weights<T, T, C, NTH>(w1, w1s);
  stage_weights<T, T, C, NTH>(w2, w2s);
  for (int i = threadIdx.x; i < 2 * CP; i += NTH) {
    const int c = i % CP;
    bs[i] = c < C ? (i < CP ? b1[c] : b2[c]) : 0.f;
  }
  const int64_t plane = (int64_t)h * wd;
  const int per_img = tiles_x * tiles_y;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int img = tile / per_img, t2 = tile - img * per_img;
    const int x0 = (t2 % tiles_x) * TW, y0 = (t2 / tiles_x) * TH;
    const T* xi = x + (int64_t)img * C * plane;
    __syncthreads();   // the last tile's writer is done with E
    stage<T, C, TH, TW, 2, true, NTH>(xi, xs, h, wd, x0, y0, vec);
    __syncthreads();
    // conv1 over h1's region (halo 1): h1 = act(. + b1) rounded, 0 off the image
    conv<T, C, TH, TW, 1, false, NW>(xs, w1s, [&](int pix, int co, float v0, float v1) {
      const int gy = y0 - 1 + pix / (TW + 2), gx = x0 - 1 + pix % (TW + 2);
      const bool in = gy >= 0 && gy < h && gx >= 0 && gx < wd;
      store2<T>(hs + (size_t)pix * CS + co, in ? apply_act(v0 + bs[co], act) : 0.f,
                in ? apply_act(v1 + bs[co + 1], act) : 0.f);
    });
    __syncthreads();
    conv<T, C, TH, TW, 0, false, NW>(hs, w2s, [&](int pix, int co, float v0, float v1) {
      E[co * ES + pix] = v0 + bs[CP + co];
      E[(co + 1) * ES + pix] = v1 + bs[CP + co + 1];
    });
    __syncthreads();
    write_tile<T, C, TH, TW, NTH>(y + (int64_t)img * C * plane, xi, E, h, wd, x0, y0, vec,
                                  act);
  }
}

template <typename T, int C>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, void* y, int n, int h, int wd, int act,
           cudaStream_t stream) {
  using F = FwdCfg<T, C>;
  constexpr size_t smem = FwdLayout<T, C>::total;
  auto kernel = res_block_kernel<T, C>;
  const cudaError_t err = msau::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (wd + F::TW - 1) / F::TW, tiles_y = (h + F::TH - 1) / F::TH;
  const int64_t n_tiles = (int64_t)n * tiles_x * tiles_y;
  if (n_tiles > (1 << 30)) return (int)cudaErrorInvalidValue;
  const int blocks = grid_size(kernel, 32 * F::NW, smem, n_tiles, 0);
  const int vec = wd % Ch<T, C>::V == 0 && aligned16(x) && aligned16(y);
  kernel<<<blocks, 32 * F::NW, smem, stream>>>(
      (const T*)x, (const T*)w1, (const float*)b1, (const T*)w2, (const float*)b2, (T*)y,
      h, wd, act, tiles_x, tiles_y, (int)n_tiles, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w1, const void* b1, const void* w2,
             const void* b2, void* y, int n, int c, int h, int wd, int act,
             cudaStream_t s) {
  switch (c) {
    case 4: return launch<T, 4>(x, w1, b1, w2, b2, y, n, h, wd, act, s);
    case 8: return launch<T, 8>(x, w1, b1, w2, b2, y, n, h, wd, act, s);
    case 16: return launch<T, 16>(x, w1, b1, w2, b2, y, n, h, wd, act, s);
    case 32: return launch<T, 32>(x, w1, b1, w2, b2, y, n, h, wd, act, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: [n, c, h, w] with c in {4, 8, 16, 32}; w1, w2: [c, c, 3, 3] in the
// activation dtype; b1, b2: [c] f32; act: 1 relu, 2 elu.
extern "C" int msau_flat_res_block(const void* x, const void* w1, const void* b1,
                                   const void* w2, const void* b2, void* y, int n,
                                   int c, int h, int wd, int act, int is_bf16,
                                   void* stream) {
  if (n < 0 || h < 0 || wd < 0 || act < 1 || act > 2) return (int)cudaErrorInvalidValue;
  if (n == 0 || h == 0 || wd == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? dispatch<__nv_bfloat16>(x, w1, b1, w2, b2, y, n, c, h, wd, act, s)
                 : dispatch<float>(x, w1, b1, w2, b2, y, n, c, h, wd, act, s);
}
