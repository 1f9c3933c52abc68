// Helpers shared by the port's kernels: f32 <-> storage-type conversion and
// vector loads from shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace msau {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// N consecutive floats of shared memory into registers; 16-byte loads when
// N is a multiple of 4 (``src`` must then be 16-byte aligned).
template <int N>
__device__ __forceinline__ void load_row(float (&dst)[N], const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N; q += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + q);
      dst[q] = v.x;
      dst[q + 1] = v.y;
      dst[q + 2] = v.z;
      dst[q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) dst[q] = src[q];
  }
}

// 4 consecutive floats of a row of n from column x, zero past the row's
// end; ``vec``: the row and x allow one aligned vector load.
__device__ inline void load4(float (&v)[4], const float* row, int x, int n, bool vec) {
  if (vec && x + 4 <= n) {
    const float4 u = *reinterpret_cast<const float4*>(row + x);
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = x + e < n ? row[x + e] : 0.f;
  }
}
// 4 floats to a row of n from column x (a vector store where ``vec``).
__device__ inline void store4(float* row, int x, int n, bool vec, const float (&v)[4]) {
  if (vec && x + 4 <= n) {
    *reinterpret_cast<float4*>(row + x) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (x + e < n) row[x + e] = v[e];
  }
}

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Activation codes of the flat-layout kernels: 0 none, 1 relu, 2 elu
// (jax.nn.elu / torch F.elu: expm1 below 0).
enum Act { kActNone = 0, kActRelu = 1, kActElu = 2 };

__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == kActRelu) return fmaxf(v, 0.f);
  if (act == kActElu) return v > 0.f ? v : expm1f(v);
  return v;
}

// x rounded to the storage type T and back (identity for float).
template <typename T>
__device__ __forceinline__ float round_to(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel;
// returns the cudaError of the attribute call (0 when none was needed).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Weight gradients are sums over every pixel of the batch.  Blocks run in
// parallel and in no order, so a kernel that sums them walks its tiles with
// a grid of at most kPartialBlocks blocks; block b adds its tiles, in
// order, into its own f32 row partial[b][0, stride) (plain stores: no other
// block touches the row), and sum_partials adds the rows in block order.
// The same inputs therefore give the same bits, with no float atomics.
constexpr int kPartialBlocks = 264;

static __global__ void sum_partials_kernel(const float* __restrict__ part, int nblocks,
                                           int64_t stride, float* __restrict__ out) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= stride) return;
  float s = 0.f;
  for (int b = 0; b < nblocks; ++b) s += part[(int64_t)b * stride + j];
  out[j] = s;
}

static inline int sum_partials(const float* part, int nblocks, int64_t stride,
                               float* out, cudaStream_t stream) {
  sum_partials_kernel<<<(unsigned)((stride + 255) / 256), 256, 0, stream>>>(
      part, nblocks, stride, out);
  return (int)cudaGetLastError();
}

// ---- Hopper data movement and bf16 tensor-core products (sm_80+ PTX) ----

// 16 bytes global -> shared, asynchronously, of which the first ``bytes``
// (0 to 16) are read and the rest written as zeros (``src`` must still be a
// device address).
__device__ __forceinline__ void cp_async16_bytes(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}
// 16 bytes global -> shared, asynchronously; ``valid`` false writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid = true) {
  cp_async16_bytes(dst, src, valid ? 16 : 0);
}
// 4 bytes global -> shared, asynchronously, zeros when ``valid`` is false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid = true) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ldmatrix: four (x4) or two (x2) 8x8 b16 matrices; lane i gives the
// address of row i % 8 of matrix i / 8 (16 bytes, 16-byte aligned).
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}
__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s)
               : "memory");
}
__device__ __forceinline__ void ldsm_x2_trans(unsigned (&r)[2], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s)
               : "memory");
}

// stmatrix (sm_90): four 8x8 b16 matrices to shared memory, transposed;
// the inverse of ldsm_x4_trans at the same lane addresses.
__device__ __forceinline__ void stsm_x4_trans(void* p, const unsigned (&r)[4]) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1,%2,%3,%4};\n" ::"r"(s),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}
// An 8x8 b16 matrix held as ldmatrix gives it (lane i: row i / 4, columns
// 2 (i % 4) and + 1), transposed in registers.
__device__ __forceinline__ unsigned movm_trans(unsigned a) {
  unsigned d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}
// two floats as a bf16 pair (x in the low half) and back
__device__ __forceinline__ unsigned pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const unsigned*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(unsigned u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// d += a b with mma.sync m16n8k16: bf16 operands, f32 accumulators.  a:
// A (16 x 16, row-major) as ldmatrix.x4 gives it; b: B (16 x 8) as
// ldmatrix.x2 of its transpose gives it; d[0..1] row lane/4, d[2..3] row
// lane/4 + 8, columns 2 (lane % 4) and + 1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b with mma.sync m16n8k8: a0, a1 the A registers of rows lane/4
// and + 8 (k 2 (lane % 4) and + 1), b the B register; d as in mma_bf16.
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], unsigned a0, unsigned a1, unsigned b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// A shared-memory stride, in b16 elements, at least ``n`` and equal to 8
// modulo 64 (16 bytes modulo 128): the eight rows of an ldmatrix matrix
// taken at that stride fall in distinct bank groups.
__host__ __device__ constexpr int ldsm_stride(int n) { return n + ((72 - n % 64) % 64); }

// d act(a) / da from the preactivation a (jax.nn.elu's derivative: exp(a)
// below 0).
__device__ __forceinline__ float act_grad(float a, int act) {
  if (act == kActRelu) return a > 0.f ? 1.f : 0.f;
  if (act == kActElu) return a > 0.f ? 1.f : expf(fminf(a, 0.f));
  return 1.f;
}

}  // namespace msau
