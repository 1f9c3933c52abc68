// Multiclass 4-connected component labelling: a pixel joins only neighbours
// of the SAME class (class <= 0 is background).  The label of a component is
// the linear index of its raster-first pixel + 1; background is 0.
//
// Replaces the TPU kernel msau_tpu/ops/ccl.py:_ccl_mc_kernel (launcher
// connected_components_multiclass_pallas), which keeps the [H, W] label map
// in VMEM and iterates row/column segmented min-scans (Hillis-Steele
// doubling) to a fixpoint, capped at max_iters sweeps.  That in-core
// iteration has no Hopper counterpart: a block's shared memory cannot hold
// a 512^2 map, and sweeps across blocks would each cost a launch.
//
// What bounds it on the H100: a 512^2 map is 1 MiB; the work is one pass of
// neighbour unions, bound by the latency of the find chains and the atomics,
// not by bandwidth.
//
// Design: union-find label equivalence in three launches.
//  1. init:    parent[p] = p for foreground pixels.
//  2. merge:   each pixel unions with its right and down neighbour of the
//              same class; a union links the larger root under the smaller
//              with atomicMin, retrying if another thread moved the root.
//  3. flatten: find the root with path compression, label = root + 1.
// Parents only ever decrease and always point into the same component, so
// every root is its component's minimum linear index — the raster-first
// pixel.  The labels therefore equal the TPU kernel's FIXPOINT exactly, with
// no sweep cap; they differ from that kernel only where it stops at its cap
// unconverged.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int find_root(const int* parent, int x) {
  int p = __ldcg(parent + x);
  while (p != x) {
    x = p;
    p = __ldcg(parent + x);
  }
  return x;
}

__device__ void unite(int* parent, int a, int b) {
  while (true) {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a == b) return;
    if (a > b) {  // keep a the smaller root
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(parent + b, a);
    if (old == b) return;  // linked b's tree under a
    // another thread re-linked b to old first; b now points at min(old, a),
    // so old's tree must still be joined with a's
    b = old;
  }
}

__global__ void init_kernel(const int* __restrict__ cls, int* __restrict__ parent,
                            int hw) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p < hw) parent[p] = cls[p] > 0 ? p : -1;
}

__global__ void merge_kernel(const int* __restrict__ cls, int* parent,
                             int height, int width) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= height * width) return;
  const int c = cls[p];
  if (c <= 0) return;
  const int x = p % width;
  const int y = p / width;
  if (x + 1 < width && cls[p + 1] == c) unite(parent, p, p + 1);
  if (y + 1 < height && cls[p + width] == c) unite(parent, p, p + width);
}

__global__ void flatten_kernel(int* parent, int* __restrict__ labels, int hw) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= hw) return;
  if (parent[p] < 0) {
    labels[p] = 0;
    return;
  }
  const int root = find_root(parent, p);
  parent[p] = root;  // path compression (other threads only read roots' ancestors)
  labels[p] = root + 1;
}

}  // namespace

extern "C" int msau_ccl_multiclass(const void* cls, void* parent, void* labels,
                                   int height, int width, void* stream) {
  const int hw = height * width;
  if (hw <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (hw + kThreads - 1) / kThreads;
  init_kernel<<<blocks, kThreads, 0, s>>>((const int*)cls, (int*)parent, hw);
  merge_kernel<<<blocks, kThreads, 0, s>>>((const int*)cls, (int*)parent,
                                           height, width);
  flatten_kernel<<<blocks, kThreads, 0, s>>>((int*)parent, (int*)labels, hw);
  return (int)cudaGetLastError();
}
