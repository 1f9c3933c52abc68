// Box-program painting: grid[y1:y2, x1:x2] = value for every box in order,
// the last write winning.
//
// Replaces the TPU kernel msau_tpu/ops/paint_pallas.py:_paint_kernel
// (launcher paint_boxes_pallas), which walks the whole box list once per
// 128-row VMEM tile and applies a masked select for every box touching it.
//
// What bounds it on the H100: the output is 1 MiB at 512^2 and 4 MiB at
// 1024^2 (int32), written once, and the box list (20 bytes a box, 5-26 K
// boxes on a page) read once: a few microseconds of HBM time.  The boxes
// are small (a page's char boxes are 3 x 2 pixels at the serve scale, its
// line boxes up to 3 x 34), so the work a box brings is its area, not the
// grid.  A design that tests every box against every tile does O(tiles x
// B) work, quadratic in the page side.
//
// Design: "the last write wins" is "the largest covering index wins", and a
// maximum does not depend on order, so the boxes are scattered in any
// order, in three passes on the stream:
//  1. clear the grid (cudaMemsetAsync);
//  2. scatter: atomicMax of i + 1 into every pixel box i covers, its
//     coordinates clipped to the grid.  A thread owns one box: it paints a
//     box of up to kOwnArea pixels itself; larger boxes go to a list in
//     shared memory that the whole block paints afterwards, one box at a
//     time with a thread per pixel, so a page-sized box costs H W / 256
//     pixels a thread, not H W;
//  3. map in place: w -> w ? values[w - 1] : 0.
// The grid holds the winning index, never the value, so a later box of
// value 0 still overwrites an earlier one.  The result is the same bits
// whatever the order of the atomics.  Work: B + sum of box areas + H W.
// Zero-padded boxes (y1 = y2 = 0) and boxes with y2 <= y1 or x2 <= x1
// cover nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // boxes per block in the scatter pass
constexpr int kOwnArea = 64;    // larger boxes are painted by the block

// result unused: a reduction (RED) that returns nothing to the thread
__device__ __forceinline__ void paint_pixel(int* out, int p, int win) {
  atomicMax(out + p, win);
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const int4* __restrict__ boxes, int n_boxes,
               int* __restrict__ out, int height, int width) {
  __shared__ int4 s_box[kThreads];   // clipped (y1, y2, x1, x2)
  __shared__ int s_win[kThreads];
  __shared__ int s_count;
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();

  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b < n_boxes) {
    const int4 box = boxes[b];
    const int y1 = max(box.x, 0), y2 = min(box.y, height);
    const int x1 = max(box.z, 0), x2 = min(box.w, width);
    if (y1 < y2 && x1 < x2) {
      const int w = x2 - x1;
      if ((y2 - y1) * w <= kOwnArea) {
        for (int y = y1; y < y2; ++y) {
          for (int x = x1; x < x2; ++x) paint_pixel(out, y * width + x, b + 1);
        }
      } else {
        const int slot = atomicAdd(&s_count, 1);
        s_box[slot] = make_int4(y1, y2, x1, x2);
        s_win[slot] = b + 1;
      }
    }
  }
  __syncthreads();
  const int n_large = s_count;
  for (int k = 0; k < n_large; ++k) {
    const int4 box = s_box[k];
    const int w = box.w - box.z;
    const int area = (box.y - box.x) * w;
    for (int i = threadIdx.x; i < area; i += kThreads) {
      const int dy = i / w;
      paint_pixel(out, (box.x + dy) * width + box.z + i - dy * w, s_win[k]);
    }
  }
}

__device__ __forceinline__ int value_of(const int* values, int win) {
  return win ? __ldg(values + win - 1) : 0;
}

// out[p] = winner ? values[winner - 1] : 0, four pixels a thread
__global__ void map_kernel(const int* __restrict__ values, int* out,
                           int n_pixels) {
  const int n4 = n_pixels / 4;
  int4* out4 = reinterpret_cast<int4*>(out);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += gridDim.x * blockDim.x) {
    int4 w = out4[i];
    w.x = value_of(values, w.x);
    w.y = value_of(values, w.y);
    w.z = value_of(values, w.z);
    w.w = value_of(values, w.w);
    out4[i] = w;
  }
  const int tail = n4 * 4 + blockIdx.x * blockDim.x + threadIdx.x;
  if (tail < n_pixels) out[tail] = value_of(values, out[tail]);
}

}  // namespace

extern "C" int msau_paint_boxes(const void* boxes, const void* values,
                                int n_boxes, void* out, int height, int width,
                                void* stream) {
  // the wrapper holds height * width below 2^31
  const int n_pixels = height * width;
  if (n_pixels <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)n_pixels * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (n_boxes > 0) {
    scatter_kernel<<<(n_boxes + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        (const int4*)boxes, n_boxes, (int*)out, height, width);
    const int fill = n_pixels / 4 / kThreads + 1;
    const int blocks = fill < 1024 ? fill : 1024;
    map_kernel<<<blocks, kThreads, 0, s>>>((const int*)values, (int*)out,
                                          n_pixels);
  }
  return (int)cudaGetLastError();
}
