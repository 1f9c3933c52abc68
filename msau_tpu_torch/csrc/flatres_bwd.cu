// Backward of the fused residual block of flatres.cu (res_depth 2, 3x3,
// Cin = Cout = C, NCHW):
//
//   h0 = relu(x);  u = conv1(h0) + b1;  h1 = act(u) rounded, 0 off the image
//   v  = conv2(h1) + b2 + x;           y  = act(v)
//
// From the cotangent g of y it recomputes the block over a halo of 4 (the
// backward's effective window is 9 x 9) and emits dx, dw1, db1, dw2, db2:
//   gv2 = g act'(v)                       (0 off the image)
//   gu  = conv2^T(gv2 rounded) act'(u)    (0 off the image: h1 is a constant
//                                          0 there, so nothing flows into u)
//   dx  = conv1^T(gu rounded) [x > 0] + gv2
//   dw2 = sum h1 (x) gv2 rounded, db2 = sum gv2;
//   dw1 = sum h0 (x) gu rounded,  db1 = sum gu
// each conv's weight gradient summed over its own output pixels.  Rounding
// as the TPU kernel: g arrives in the activation dtype, h1 and the
// cotangents that feed a conv or a weight gradient are rounded to it, the
// residual term and the bias gradients stay f32, every sum is f32.
//
// Replaces the TPU kernels msau_tpu/ops/flatres.py:_bwd_kernel and
// _bwd_kernel_al (launcher _fused_vjp_bwd; the _al body is the same
// function on the TPU's lane-aligned layout), which accumulate dw and db
// in place across a sequential grid.  Here the grid runs in parallel: a
// persistent grid of at most kPartialBlocks blocks walks the tiles, each
// block keeps its sums in registers across its tiles and writes its own f32
// partial row once, and sum_partials (common.cuh) adds the rows in block
// order, so the same inputs give the same bits.
//
// What bounds it on the H100: in f32 the FP32 pipes (four 3x3 convs, three
// of them over a halo, and two weight gradients, each 9 C^2 FMAs per
// pixel); in bf16, with five of the six GEMMs on the tensor cores, device
// memory (x and g read once, dx written once).
// Design (res_block.cuh): blocks of 8 warps (9 in f32 at C = 32) stage both
// weight sets once and walk tiles of 8 x 32 pixels (16 x 32 at C <= 8; in
// bf16 16 x 16 at C = 16 and 8 x 16 at C = 32; in f32 8 x 8 at C = 32, for
// shared memory).  Per tile, with the regions as [pixel][channel] in the
// activation dtype and the f32 arrays beside them:
//   1. x over the 4-pixel halo (kept for the whole tile, relu'd where it is
//      read as h0) and g over the 2-pixel halo;
//   2. conv1 over the 3-pixel halo in the plain version's order (see
//      kExactBand) -> h1 (rounded, 0 off the image) and act'(u) (f32
//      [co][pixel]) over the 1-pixel halo;
//   3. conv2 over the 2-pixel halo, its epilogue turning g into gv2 in
//      place (rounded), with the f32 gv2 over the tile kept as [co][pixel]
//      and the relu z near 0 listed, then summed again (see kExactBand);
//   4. dw2 += h1 (x) gv2 (sums in registers); db2 from the f32 gv2;
//   5. conv2^T over the 1-pixel halo -> gu = . act'(u), rounded in h1's
//      place and f32 in act'(u)'s;
//   6. db1 from the f32 gu; dw1 += h0 (x) gu; conv1^T over the tile -> dx
//      = . [x > 0] + gv2 in the f32 gv2's place, written as 16-byte runs.
// db: thread (channel, pixel slice), sums in registers.  The block's
// partial row (dw1 OIHW, db1, dw2 OIHW, db2) is written once, the pixel
// slices added in slice order.

#include <stdint.h>

#include "res_block.cuh"

namespace {

using msau::act_grad;
using msau::apply_act;
using msau::to_f32;
using namespace msau::res;

template <typename T, int C>
struct BwdCfg {
  static constexpr bool kF32 = sizeof(T) == 4;
  // (on an H100 at batch 16, bf16 16 ch 256^2: 16 x 16 tiles at one block
  // per SM 0.95 ms, 8 x 16 at two 1.11; bf16 8 ch 512^2: two blocks 0.90,
  // one 1.20; f32 8 ch 512^2: 16 rows 2.14, 8 rows 2.35)
  static constexpr int TH = C <= 8 || (!kF32 && C == 16) ? 16 : 8;
  static constexpr int TW = kF32 ? (C >= 32 ? 8 : 32) : (C <= 8 ? 32 : 16);
  static constexpr int NW = kF32 && C >= 32 ? 9 : 8;
  static constexpr int MINB = !kF32 && C <= 8 ? 2 : 1;
};

// shared memory, bytes: both weight sets, the biases, (bf16) w1 for
// conv_exact as f32 [ci][tap][co], the list of v to sum again (15-bit
// (pixel, channel) entries, room for every value) and its count; X: x
// (halo 4); G: g, then gv2 (halo 2);
// H: h1 (halo 3), then gu (halo 1); U: f32 [CP][row4] over the 1-pixel
// halo, act'(u) then gu; E: f32 [CP][row4] over the tile, gv2 then dx
template <typename T, int C>
struct BwdLayout {
  using Q = Ch<T, C>;
  using F = BwdCfg<T, C>;
  using A = Reg<F::TH, F::TW, 4>;
  using B = Reg<F::TH, F::TW, 3>;
  using G2 = Reg<F::TH, F::TW, 2>;
  using G1 = Reg<F::TH, F::TW, 1>;
  static constexpr int ES = row4(F::TH * F::TW), UP = row4(G1::N);
  static constexpr size_t px = Q::CS * sizeof(T);
  static constexpr size_t bias = a16(2 * Q::W_ELEMS * sizeof(T));
  static constexpr size_t wx = bias + a16(2 * Q::CP * 4);
  static constexpr size_t list = wx + (Q::kF32 ? 0 : a16(9 * Q::CP * Q::CP * 4));
  static constexpr size_t count = list + a16(2 * G2::N * C);
  static constexpr size_t xs = count + 16;
  static constexpr size_t gs = xs + a16(A::N * px);
  static constexpr size_t hs = gs + a16(G2::N * px);
  static constexpr size_t up = hs + a16(B::N * px);
  static constexpr size_t e = up + a16(Q::CP * UP * 4);
  static constexpr size_t total = e + a16(Q::CP * ES * 4);
};

// The relu masks [u > 0] and [v > 0] decide whether a whole cotangent
// passes, so they must agree with the plain version's bit for bit, and so
// must h1, from which v is summed (in bf16 its rounding too): u is summed
// in the plain version's order everywhere (conv_exact); v comes from the
// GEMM, which sums in another order (~1e-6 apart here), and the values
// within kExactBand of 0 are listed and summed again in the plain
// version's order after it (summed inside the GEMM's epilogue, they cost
// the backward 10-18 % on an H100 even where none was in the band).  The
// band is far above that disagreement and holds ~1e-4 of the values.
// (Re-summing only the bf16 u near 0 or near a rounding midpoint of h1,
// with conv1 on mma.sync, listed a few % of the values and ran 1.3-1.6x
// slower on an H100.)
constexpr float kExactBand = 1e-4f;

// conv over the region of halo H + 1 (src, [pixel][CS], RW pixels a row) at
// output pixel (r, q) of the region of halo H, channel co, in the plain
// version's order
template <typename T, int C>
__device__ float conv_in_order(const T* src, const T* ws, int rw, int r, int q, int co) {
  float acc = 0.f;
  for (int ci = 0; ci < C; ++ci)
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
      acc = fmaf(to_f32(src[((r + tap / 3) * rw + q + tap % 3) * Ch<T, C>::CS + ci]),
                 weight_at<T, C>(ws, co, ci, tap), acc);
  return acc;
}

template <typename T, int C>
__global__ void __launch_bounds__(BwdCfg<T, C>::NW * 32, BwdCfg<T, C>::MINB)
res_block_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                     const T* __restrict__ w1, const float* __restrict__ b1,
                     const T* __restrict__ w2, const float* __restrict__ b2,
                     T* __restrict__ dx, float* __restrict__ partial, int h, int wd,
                     int act, int tiles_x, int tiles_y, int n_tiles, int vec) {
  using F = BwdCfg<T, C>;
  using Q = Ch<T, C>;
  using L = BwdLayout<T, C>;
  constexpr int TH = F::TH, TW = F::TW, NW = F::NW, NTH = 32 * NW;
  constexpr int CP = Q::CP, CS = Q::CS, ES = L::ES, UP = L::UP;
  extern __shared__ __align__(16) unsigned char smem[];
  T* w1s = reinterpret_cast<T*>(smem);
  T* w2s = w1s + Q::W_ELEMS;
  float* bs = reinterpret_cast<float*>(smem + L::bias);   // b1 [CP], b2 [CP]
  T* X = reinterpret_cast<T*>(smem + L::xs);
  T* G = reinterpret_cast<T*>(smem + L::gs);
  T* H = reinterpret_cast<T*>(smem + L::hs);
  float* U = reinterpret_cast<float*>(smem + L::up);
  float* E = reinterpret_cast<float*>(smem + L::e);
  float* wx1 = reinterpret_cast<float*>(Q::kF32 ? smem : smem + L::wx);
  uint16_t* vlist = reinterpret_cast<uint16_t*>(smem + L::list);
  int* n_v = reinterpret_cast<int*>(smem + L::count);
  if (threadIdx.x == 0) *n_v = 0;
  stage_weights<T, T, C, NTH>(w1, w1s);
  stage_weights<T, T, C, NTH>(w2, w2s);
  if constexpr (!Q::kF32) stage_weights<T, float, C, NTH>(w1, wx1);
  for (int i = threadIdx.x; i < 2 * CP; i += NTH) {
    const int c = i % CP;
    bs[i] = c < C ? (i < CP ? b1[c] : b2[c]) : 0.f;
  }
  Dw<T, C, TH, TW, 2, 3, false, NW> dw2;   // gv2 (halo 2) against h1 (halo 3)
  Dw<T, C, TH, TW, 1, 4, true, NW> dw1;    // gu (halo 1) against relu(x) (halo 4)
  dw1.zero();
  dw2.zero();
  // db: thread (co, slice) adds channel co over pixels slice, slice + DS, ...
  constexpr int DS = NTH / CP;
  const int dco = threadIdx.x / DS, dsl = threadIdx.x % DS;
  float db1 = 0.f, db2 = 0.f;
  const int64_t plane = (int64_t)h * wd;
  const int per_img = tiles_x * tiles_y;
  // x at pixel (r, q) of the region of halo H, channels co and co + 1
  const auto x_at = [&](int hh, int r, int q, int co) {
    return load2<T>(X + (size_t)((r + 4 - hh) * (TW + 8) + q + 4 - hh) * CS + co);
  };
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int img = tile / per_img, t2 = tile - img * per_img;
    const int x0 = (t2 % tiles_x) * TW, y0 = (t2 / tiles_x) * TH;
    const int64_t ioff = (int64_t)img * C * plane;
    const auto inside = [&](int gy, int gx) {
      return gy >= 0 && gy < h && gx >= 0 && gx < wd;
    };
    // 1. (the last tile's readers of X, G, H and U were done at its last
    // barrier; E's reader, its writer, is done before conv2 below)
    stage<T, C, TH, TW, 4, false, NTH>(x + ioff, X, h, wd, x0, y0, vec);
    stage<T, C, TH, TW, 2, false, NTH>(g + ioff, G, h, wd, x0, y0, vec);
    __syncthreads();
    // 2. conv1 over h1's region (halo 3), in the plain version's order;
    // act'(u) over gu's (halo 1)
    conv_exact<T, C, TH, TW, 3, NW>(X, wx1, [&](int pix, int co, float v0, float v1) {
      const int r = pix / (TW + 6), q = pix % (TW + 6);
      const bool in = inside(y0 - 3 + r, x0 - 3 + q);
      const float u0 = v0 + bs[co], u1 = v1 + bs[co + 1];
      store2<T>(H + (size_t)pix * CS + co, in ? apply_act(u0, act) : 0.f,
                in ? apply_act(u1, act) : 0.f);
      if (r >= 2 && r < TH + 4 && q >= 2 && q < TW + 4) {
        float* up = U + co * UP + (r - 2) * (TW + 2) + q - 2;
        up[0] = in && co < C ? act_grad(u0, act) : 0.f;
        up[UP] = in && co + 1 < C ? act_grad(u1, act) : 0.f;
      }
    });
    __syncthreads();
    // 3. conv2 over gv2's region (halo 2): gv2 = g act'(. + b2 + x) in g's
    // place, the relu z near 0 listed
    conv<T, C, TH, TW, 2, false, NW>(H, w2s, [&](int pix, int co, float v0, float v1) {
      const int r = pix / (TW + 4), q = pix % (TW + 4);
      T* gp = G + (size_t)pix * CS + co;
      float o0 = 0.f, o1 = 0.f;
      if (inside(y0 - 2 + r, x0 - 2 + q)) {
        const float2 gv = load2<T>(gp), xv = x_at(2, r, q, co);
        const float z0 = v0 + bs[CP + co] + xv.x, z1 = v1 + bs[CP + co + 1] + xv.y;
        if (co < C) o0 = gv.x * act_grad(z0, act);
        if (co + 1 < C) o1 = gv.y * act_grad(z1, act);
        if (act == msau::kActRelu) {
          if (co < C && fabsf(z0) < kExactBand)
            vlist[atomicAdd(n_v, 1)] = (uint16_t)(pix << 5 | co);
          if (co + 1 < C && fabsf(z1) < kExactBand)
            vlist[atomicAdd(n_v, 1)] = (uint16_t)(pix << 5 | (co + 1));
        }
      }
      store2<T>(gp, o0, o1);
      const int tr = r - 2, tq = q - 2;
      if (tr >= 0 && tr < TH && tq >= 0 && tq < TW) {
        E[co * ES + tr * TW + tq] = o0;
        E[(co + 1) * ES + tr * TW + tq] = o1;
      }
    });
    __syncthreads();
    // the listed v again, in the plain version's order (each entry one
    // value, g read again from device memory: the list's order does not
    // change the result)
    const int nv = *n_v;
    for (int i = threadIdx.x; i < nv; i += NTH) {
      const int pix = vlist[i] >> 5, c = vlist[i] & 31;
      const int r = pix / (TW + 4), q = pix % (TW + 4);
      const int64_t off = ioff + c * plane + (int64_t)(y0 - 2 + r) * wd + x0 - 2 + q;
      const float z = conv_in_order<T, C>(H, w2s, TW + 6, r, q, c) + bs[CP + c] +
                      to_f32(X[((r + 2) * (TW + 8) + q + 2) * CS + c]);
      const float gv = to_f32(g[off]) * act_grad(z, act);
      msau::store(G + (size_t)pix * CS + c, gv);
      if (r >= 2 && r < TH + 2 && q >= 2 && q < TW + 2) E[c * ES + (r - 2) * TW + q - 2] = gv;
    }
    __syncthreads();
    if (threadIdx.x == 0) *n_v = 0;   // read again after the next conv2
    // 4. dw2 (h1 is about to be overwritten by gu); db2
    dw2.add_tile(H, G);
    if (dco < C)
      for (int p = dsl; p < TH * TW; p += DS) db2 += E[dco * ES + p];
    __syncthreads();
    // 5. conv2^T over gu's region (halo 1): gu = . act'(u)
    conv<T, C, TH, TW, 1, true, NW>(G, w2s, [&](int pix, int co, float v0, float v1) {
      float* up = U + co * UP + pix;
      const float gu0 = v0 * up[0], gu1 = v1 * up[UP];
      up[0] = gu0;
      up[UP] = gu1;
      store2<T>(H + (size_t)pix * CS + co, gu0, gu1);
    });
    __syncthreads();
    // 6. db1; dw1; conv1^T over the tile: dx = . [x > 0] + gv2
    if (dco < C)
      for (int p = dsl; p < TH * TW; p += DS)
        db1 += U[dco * UP + (p / TW + 1) * (TW + 2) + p % TW + 1];
    dw1.add_tile(X, H);
    conv<T, C, TH, TW, 0, true, NW>(H, w1s, [&](int pix, int co, float v0, float v1) {
      const float2 xv = x_at(0, pix / TW, pix % TW, co);
      float* e = E + co * ES + pix;
      e[0] += xv.x > 0.f ? v0 : 0.f;
      e[ES] += xv.y > 0.f ? v1 : 0.f;
    });
    __syncthreads();
    write_tile<T, C, TH, TW, NTH>(dx + ioff, nullptr, E, h, wd, x0, y0, vec, msau::kActNone);
  }
  // the block's partial row: dw1 (OIHW), db1, dw2 (OIHW), db2
  float* part = partial + (int64_t)blockIdx.x * (2 * (9 * C * C + C));
  float* red = reinterpret_cast<float*>(smem);
  __syncthreads();
  red[threadIdx.x] = db1;
  red[NTH + threadIdx.x] = db2;
  __syncthreads();
  if ((int)threadIdx.x < C) {
    float s1 = 0.f, s2 = 0.f;
    for (int s = 0; s < DS; ++s) {
      s1 += red[threadIdx.x * DS + s];
      s2 += red[NTH + threadIdx.x * DS + s];
    }
    part[9 * C * C + threadIdx.x] = s1;
    part[2 * 9 * C * C + C + threadIdx.x] = s2;
  }
  __syncthreads();
  dw1.finish(part, red);
  dw2.finish(part + 9 * C * C + C, red);
}

template <typename T, int C>
int launch(const void* x, const void* g, const void* w1, const void* b1,
           const void* w2, const void* b2, void* dx, void* partial, void* out, int n,
           int h, int wd, int act, cudaStream_t stream) {
  using F = BwdCfg<T, C>;
  constexpr size_t smem = BwdLayout<T, C>::total;
  auto kernel = res_block_bwd_kernel<T, C>;
  const cudaError_t err = msau::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (wd + F::TW - 1) / F::TW, tiles_y = (h + F::TH - 1) / F::TH;
  const int64_t n_tiles = (int64_t)n * tiles_x * tiles_y;
  if (n_tiles > (1 << 30)) return (int)cudaErrorInvalidValue;
  const int blocks = grid_size(kernel, 32 * F::NW, smem, n_tiles, msau::kPartialBlocks);
  const int vec = wd % Ch<T, C>::V == 0 && aligned16(x) && aligned16(g) && aligned16(dx);
  kernel<<<blocks, 32 * F::NW, smem, stream>>>(
      (const T*)x, (const T*)g, (const T*)w1, (const float*)b1, (const T*)w2,
      (const float*)b2, (T*)dx, (float*)partial, h, wd, act, tiles_x, tiles_y,
      (int)n_tiles, vec);
  const int code = (int)cudaGetLastError();
  if (code != 0) return code;
  return msau::sum_partials((const float*)partial, blocks, 2 * (9 * C * C + C),
                            (float*)out, stream);
}

template <typename T>
int dispatch(const void* x, const void* g, const void* w1, const void* b1,
             const void* w2, const void* b2, void* dx, void* partial, void* out, int n,
             int c, int h, int wd, int act, cudaStream_t s) {
  switch (c) {
    case 4: return launch<T, 4>(x, g, w1, b1, w2, b2, dx, partial, out, n, h, wd, act, s);
    case 8: return launch<T, 8>(x, g, w1, b1, w2, b2, dx, partial, out, n, h, wd, act, s);
    case 16: return launch<T, 16>(x, g, w1, b1, w2, b2, dx, partial, out, n, h, wd, act, s);
    case 32: return launch<T, 32>(x, g, w1, b1, w2, b2, dx, partial, out, n, h, wd, act, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, g, dx: [n, c, h, w] with c in {4, 8, 16, 32}; w1, w2: [c, c, 3, 3] in
// the activation dtype; b1, b2: [c] f32; act: 1 relu, 2 elu; partial: f32
// scratch of kPartialBlocks * 2 * (9 c^2 + c) floats; out: f32
// [2 * (9 c^2 + c)]: dw1 (OIHW), db1, dw2 (OIHW), db2.
extern "C" int msau_flat_res_block_bwd(const void* x, const void* g, const void* w1,
                                       const void* b1, const void* w2, const void* b2,
                                       void* dx, void* partial, void* out, int n, int c,
                                       int h, int wd, int act, int is_bf16,
                                       void* stream) {
  if (n < 0 || h < 0 || wd < 0 || act < 1 || act > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0 || h == 0 || wd == 0)
    return (int)cudaMemsetAsync(out, 0, 2 * (9 * (size_t)c * c + c) * sizeof(float), s);
  return is_bf16 ? dispatch<__nv_bfloat16>(x, g, w1, b1, w2, b2, dx, partial, out, n,
                                           c, h, wd, act, s)
                 : dispatch<float>(x, g, w1, b1, w2, b2, dx, partial, out, n, c, h,
                                   wd, act, s);
}
