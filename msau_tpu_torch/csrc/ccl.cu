// Multiclass 4-connected component labelling of a stack of B pages: a pixel
// joins only neighbours of the SAME class on the same page (class <= 0 is
// background).  The label of a component is the linear index of its
// raster-first pixel within its page + 1; background is 0.  This is what
// jax.vmap of the TPU kernel gives on a [B, H, W] stack.
//
// Replaces the TPU kernel msau_tpu/ops/ccl.py:_ccl_mc_kernel (launcher
// connected_components_multiclass_pallas), which keeps the [H, W] label map
// in VMEM and iterates row/column segmented min-scans (Hillis-Steele
// doubling) to a fixpoint, capped at max_iters sweeps.  That in-core
// iteration has no Hopper counterpart: a block's shared memory cannot hold
// a 512^2 map, and sweeps across blocks would each cost a launch.
//
// What bounds it on the H100: a 512^2 map is 1 MiB in and 1 MiB out.  A
// union-find over the whole map in global memory is bound instead by the
// latency of its find chains (an L2 round trip a hop) and its atomics.
//
// Design: block-based union-find in three launches, so that global memory
// sees only the unions across tile borders (Playne & Hawick, IEEE TPDS
// 2018; Allegretti, Bolelli & Grana, IEEE TPDS 2019).
//  1. local:   a block labels a 32 x 32 tile in shared memory.  A warp is a
//              row: a ballot of "same class as the left neighbour" gives
//              every pixel its run's first pixel at once; runs then unite
//              with the row above (once per pair of runs) by atomicMin on
//              shared memory, larger roots under smaller.  Each pixel's tile
//              root is written to the label map as a code (0 background, 1
//              the root itself, 2 + the root's index in the tile), and each
//              root starts its global tree: parent[root] = root.
//  2. border:  a thread per pair of same-class pixels across a tile border
//              unites their tiles' roots in global memory: find with path
//              halving, link by atomicMin.  A pair is skipped where the pair
//              before it on the same border, in the same tile, has the same
//              class on both sides: its union already joins the same roots.
//  3. flatten: a block per tile again; each tile root finds its global root,
//              and every pixel of the tile takes its tile root's through
//              shared memory: label = root + 1.
// Parents only ever decrease and always point into the same component (a
// tile's row-major order is the map's raster order restricted to the tile),
// so every root is its component's minimum linear index -- the raster-first
// pixel -- whatever the order of the unions: the labels are the same bits
// on every run, and equal the TPU kernel's FIXPOINT exactly, with no sweep
// cap; they differ from that kernel only where it stops at its cap
// unconverged.
//
// The page axis: the tile and flatten kernels take their page from
// blockIdx.z, and the border kernel's flat index runs over the pairs of
// every page in turn.  Each kernel offsets its cls, parent and label
// pointers by the page's H * W, so every index inside a find or a union is
// page-local: no union crosses a page, a page's trees are the ones a B = 1
// call builds, and B = 1 is the same three launches and the same bits as
// an unbatched call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 32;   // a warp is a row of a tile
constexpr int kTileH = 32;
constexpr int kThreads = kTileW * kTileH;
constexpr int kBorderThreads = 256;
constexpr unsigned kAll = 0xffffffffu;
// the label map's code between the passes: 0 background, kTileRoot for a
// tile root, kTileRoot + 1 + (its tile root's index in the tile) otherwise
constexpr int kTileRoot = 1;

__device__ __forceinline__ int find_local(const volatile int* s, int x) {
  int p = s[x];
  while (p != x) {
    x = p;
    p = s[x];
  }
  return x;
}

__device__ void unite_local(int* s, int a, int b) {
  while (true) {
    a = find_local(s, a);
    b = find_local(s, b);
    if (a == b) return;
    if (a > b) {  // keep a the smaller root
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(s + b, a);
    if (old == b) return;  // linked b's tree under a
    // another thread re-linked b to old first; b now points at min(old, a),
    // so old's tree must still be joined with a's
    b = old;
  }
}

// Path halving: a node that is not a root is pointed at its grandparent.
// Only roots are linked (atomicMin), a node that is not a root never
// becomes one, and the store writes an ancestor, so a link made between the
// loads and the store is kept: its thread goes on to unite the old parent.
__device__ __forceinline__ int find_root(int* parent, int x) {
  int p = __ldcg(parent + x);
  while (p != x) {
    const int gp = __ldcg(parent + p);
    if (gp == p) return p;
    __stcg(parent + x, gp);
    x = gp;
    p = __ldcg(parent + x);
  }
  return x;
}

__device__ void unite(int* parent, int a, int b) {
  while (true) {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(parent + b, a);
    if (old == b) return;
    b = old;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
local_kernel(const int* __restrict__ cls, int* __restrict__ parent,
             int* __restrict__ code, int height, int width) {
  const size_t page = (size_t)blockIdx.z * height * width;
  cls += page;
  parent += page;
  code += page;
  __shared__ int s_cls[kThreads];
  __shared__ int s_par[kThreads];
  const int li = threadIdx.x;
  const int lane = li & (kTileW - 1);
  const int row = li / kTileW;
  const int x = blockIdx.x * kTileW + lane;
  const int y = blockIdx.y * kTileH + row;
  const bool inside = x < width && y < height;
  const int p = inside ? y * width + x : 0;
  const int c = inside ? __ldg(cls + p) : 0;
  const bool fg = c > 0;

  // runs along the row: each pixel's run starts at the nearest lane at or
  // left of it whose left neighbour differs (every lane shuffles: a lane
  // that skipped a *_sync call would leave the others waiting)
  const int left = __shfl_up_sync(kAll, c, 1);
  const bool left_same = fg && lane > 0 && left == c;
  const unsigned starts = __ballot_sync(kAll, !left_same);
  const int start = 31 - __clz(starts & (kAll >> (31 - lane)));
  s_cls[li] = c;
  s_par[li] = row * kTileW + start;
  __syncthreads();

  // a run joins each run above it that touches it, once: where the pixel to
  // the left is in the same run and also touches the same run above, its
  // union is the same
  const bool up_same = fg && row > 0 && s_cls[li - kTileW] == c;
  const bool up_left_same = __shfl_up_sync(kAll, up_same, 1);
  if (up_same && !(left_same && up_left_same))
    unite_local(s_par, li, li - kTileW);
  __syncthreads();

  if (!inside) return;
  if (!fg) {
    code[p] = 0;
    return;
  }
  const int root = find_local(s_par, li);
  if (root == li) {
    code[p] = kTileRoot;
    parent[p] = p;
  } else {
    code[p] = kTileRoot + 1 + root;
  }
}

// the global index of the tile root of pixel (y, x), from its code
__device__ __forceinline__ int tile_root(const int* code, int y, int x,
                                         int width) {
  const int p = y * width + x;
  const int k = __ldg(code + p) - kTileRoot - 1;
  if (k < 0) return p;
  return (y - y % kTileH + k / kTileW) * width + x - x % kTileW + k % kTileW;
}

__global__ void __launch_bounds__(kBorderThreads)
border_kernel(const int* __restrict__ cls, int* parent,
              const int* __restrict__ code, int height, int width,
              int n_vertical, int n_pairs, int batch) {
  const long long k = (long long)blockIdx.x * kBorderThreads + threadIdx.x;
  if (k >= (long long)n_pairs * batch) return;
  const int b = (int)(k / n_pairs);
  const int i = (int)(k - (long long)b * n_pairs);  // the pair in its page
  const size_t page = (size_t)b * height * width;
  cls += page;
  parent += page;
  code += page;
  int ya, xa, yb, xb, step;  // a before b; step back along the border
  if (i < n_vertical) {      // (y, xa) | (y, xa + 1) across a column border
    const int border = i / height;
    ya = yb = i - border * height;
    xb = (border + 1) * kTileW;
    xa = xb - 1;
    step = width;
    if (ya % kTileH == 0) step = 0;   // first row of the tile: no pair before
  } else {                   // (ya, x) over (ya + 1, x) across a row border
    const int j = i - n_vertical;
    const int border = j / width;
    xa = xb = j - border * width;
    yb = (border + 1) * kTileH;
    ya = yb - 1;
    step = xa % kTileW == 0 ? 0 : 1;
  }
  const int pa = ya * width + xa, pb = yb * width + xb;
  const int c = __ldg(cls + pa);
  if (c <= 0 || __ldg(cls + pb) != c) return;
  if (step && __ldg(cls + pa - step) == c && __ldg(cls + pb - step) == c)
    return;
  unite(parent, tile_root(code, ya, xa, width), tile_root(code, yb, xb, width));
}

__global__ void __launch_bounds__(kThreads, 2)
flatten_kernel(int* parent, int* code, int height, int width) {
  const size_t page = (size_t)blockIdx.z * height * width;
  parent += page;
  code += page;
  __shared__ int s_root[kThreads];
  const int li = threadIdx.x;
  const int x = blockIdx.x * kTileW + (li & (kTileW - 1));
  const int y = blockIdx.y * kTileH + li / kTileW;
  const bool inside = x < width && y < height;
  const int p = inside ? y * width + x : 0;
  const int k = inside ? code[p] : 0;
  int root = 0;
  if (k == kTileRoot) {
    root = find_root(parent, p);
    s_root[li] = root;
  }
  __syncthreads();
  if (k > kTileRoot) root = s_root[k - kTileRoot - 1];
  if (inside) code[p] = k ? root + 1 : 0;
}

}  // namespace

// cls, parent and labels are [batch, height, width] int32.
extern "C" int msau_ccl_multiclass(const void* cls, void* parent, void* labels,
                                   int batch, int height, int width,
                                   void* stream) {
  if (batch <= 0 || height <= 0 || width <= 0) return 0;
  if (batch > 65535) return (int)cudaErrorInvalidValue;  // gridDim.z
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 tiles((width + kTileW - 1) / kTileW,
                   (height + kTileH - 1) / kTileH, batch);
  local_kernel<<<tiles, kThreads, 0, s>>>((const int*)cls, (int*)parent,
                                          (int*)labels, height, width);
  const int n_vertical = (tiles.x - 1) * height;
  const int n_pairs = n_vertical + (tiles.y - 1) * width;  // per page
  const long long all_pairs = (long long)n_pairs * batch;
  if (all_pairs > 0)
    border_kernel<<<(unsigned)((all_pairs + kBorderThreads - 1) /
                               kBorderThreads),
                    kBorderThreads, 0, s>>>((const int*)cls, (int*)parent,
                                            (const int*)labels, height, width,
                                            n_vertical, n_pairs, batch);
  flatten_kernel<<<tiles, kThreads, 0, s>>>((int*)parent, (int*)labels,
                                            height, width);
  return (int)cudaGetLastError();
}
