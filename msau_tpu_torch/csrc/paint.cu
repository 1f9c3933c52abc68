// Box-program painting: grid[y1:y2, x1:x2] = value for every box in order,
// the last write winning.
//
// Replaces the TPU kernel msau_tpu/ops/paint_pallas.py:_paint_kernel
// (launcher paint_boxes_pallas), which walks the whole box list once per
// 128-row VMEM tile and applies a masked select for every box touching it.
//
// What bounds it on the H100: the output is 1 MiB at 512^2 (int32), written
// once — about 0.3 us of HBM time — so the cost is the box tests: every
// pixel must find the LAST box covering it among B (4096 on the bench page).
// A sequential select loop over the grid does O(B * H * W) work.
//
// Design: one thread per output pixel, one block per 8x32 pixel tile (a warp
// is one 128-byte row of the tile, so the store is coalesced).  The block
// walks the box list from LAST to FIRST in chunks of 256: each thread loads
// one box, the block keeps only the boxes that intersect its tile (order-
// preserving compaction with warp ballots into shared memory), and each
// pixel scans the kept boxes from last to first and stops at the first one
// that covers it.  That is the same last-write-wins value without a
// sequential loop over the grid, and a tile of small character boxes
// tests only the handful that touch it.  The block stops as soon as every
// pixel in it is decided.  A pixel no box covers is 0.  Zero-padded boxes
// (y1 = y2 = 0) and boxes with x2 <= x1 or y2 <= y1 cover nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 32;
constexpr int kThreads = kTileH * kTileW;   // 256: one chunk of boxes
constexpr int kWarps = kThreads / 32;

__global__ void paint_kernel(const int4* __restrict__ boxes,
                             const int* __restrict__ values, int n_boxes,
                             int* __restrict__ out, int height, int width) {
  __shared__ int4 s_box[kThreads];
  __shared__ int s_val[kThreads];
  __shared__ int s_warp_count[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.y * kTileH;
  const int col0 = blockIdx.x * kTileW;
  const int r = row0 + tid / kTileW;
  const int c = col0 + tid % kTileW;
  const bool inside = r < height && c < width;

  int value = 0;
  bool done = !inside;
  const int n_chunks = (n_boxes + kThreads - 1) / kThreads;
  for (int chunk = n_chunks - 1; chunk >= 0; --chunk) {
    // every pixel of the tile decided: the earlier boxes cannot matter
    if (__syncthreads_and(done)) break;
    const int b = chunk * kThreads + tid;
    int4 box = make_int4(0, 0, 0, 0);
    int val = 0;
    bool keep = false;
    if (b < n_boxes) {
      box = boxes[b];  // (y1, y2, x1, x2)
      val = values[b];
      keep = box.x < box.y && box.z < box.w && box.x < row0 + kTileH &&
             box.y > row0 && box.z < col0 + kTileW && box.w > col0;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_warp_count[warp] = __popc(ballot);
    __syncthreads();
    int offset = __popc(ballot & ((1u << lane) - 1u));
    int n_kept = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int cnt = s_warp_count[w];
      offset += (w < warp) ? cnt : 0;
      n_kept += cnt;
    }
    if (keep) {
      s_box[offset] = box;
      s_val[offset] = val;
    }
    __syncthreads();
    if (!done) {
      for (int k = n_kept - 1; k >= 0; --k) {
        const int4 bx = s_box[k];
        if (r >= bx.x && r < bx.y && c >= bx.z && c < bx.w) {
          value = s_val[k];
          done = true;
          break;
        }
      }
    }
    // s_box / s_warp_count are rewritten by the next chunk: the
    // __syncthreads_and at the loop head orders those writes
  }
  if (inside) out[(int64_t)r * width + c] = value;
}

}  // namespace

extern "C" int msau_paint_boxes(const void* boxes, const void* values,
                                int n_boxes, void* out, int height, int width,
                                void* stream) {
  dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH);
  paint_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)boxes, (const int*)values, n_boxes, (int*)out, height,
      width);
  return (int)cudaGetLastError();
}
