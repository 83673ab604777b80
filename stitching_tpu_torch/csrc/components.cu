// The number of 4-connected foreground regions of a binary mask.
//
// Replaces no TPU kernel. The JAX package decides whether the LOW panorama
// mask is one region (stitching_tpu/cropper.py::single_region) with a host
// flood fill: one 4-neighbour dilation a round, each round a pass over the
// mask, until a round adds nothing, O((h + w) h w). On the card the port
// counts the regions instead, with the mask where the paste composite left
// it: the crop planner needs one bit (is the count 1?), and a count takes a
// few passes over the mask rather than one per pixel of its longest path.
//
// Contract: mask (h, w) bytes, row-major, nonzero = foreground; parent
// (h * w) int32 scratch; count one int32. Afterwards count holds the number
// of 4-connected foreground regions (pixels that touch only at a corner lie
// in two), and parent[i] is -1 at background pixels and leads, through
// parent links, to the region's root elsewhere. h * w < 2^31.
//
// Method: block-based union-find (Playne & Hawick 2018; Allegretti et al.
// 2019, "BUF"), three launches on the caller's stream:
//   1. tile_labels: one block per 32 x 32 tile, a warp per tile row. A
//      warp's ballot gives each pixel its row run's first pixel as its
//      label, so runs cost no union; a union in shared memory (atomicMin,
//      the larger root linked under the smaller) joins runs that touch
//      vertically, once per stretch of touching pixels. Each pixel then
//      writes the global index of its tile-local root.
//   2. border_unions: a block per tile joins, in the global parents, the
//      pixels of its top row and left column with their foreground
//      neighbours across the border, with the same lock-free union and the
//      same one union per stretch.
//   3. count_roots: foreground pixels whose parent is themselves, summed in
//      each block and added to the count with one atomicAdd a block.
//
// What bounds it on the H100: bytes, and below them the launches. A call
// reads the mask once (1 byte a pixel), writes the parents once and reads
// them once (4 + 4); the merge touches border pixels only. About 9 h w
// bytes: 4.8 MB for a 300 x 1770 mask, 1.4 us at 3.35 TB/s, and 2 MB at
// 300 x 750, under the floor of three launches. The design keeps to those
// bytes: labels stay in shared memory until each tile is done, no pass
// iterates over the whole mask, and nothing synchronises with the host.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;  // tile side: one warp per tile row
constexpr int kCountThreads = 256;

// The root of i: follow parent links until a label is its own parent.
// Volatile reads: links change under other threads' atomics, and on the
// device another block's writes bypass this SM's L1.
__device__ __forceinline__ int find_root(const volatile int* parent, int i) {
  int p = parent[i];
  while (p != i) {
    i = p;
    p = parent[i];
  }
  return i;
}

// Lock-free union (Playne & Hawick): link the larger of the two roots under
// the smaller with atomicMin; if the larger was linked meanwhile, carry on
// from what it was linked to. Links only ever point to smaller labels.
__device__ void unite(int* parent, int a, int b) {
  const volatile int* links = parent;
  bool done;
  do {
    a = find_root(links, a);
    b = find_root(links, b);
    if (a < b) {
      const int old = atomicMin(parent + b, a);
      done = old == b;
      b = old;
    } else if (b < a) {
      const int old = atomicMin(parent + a, b);
      done = old == a;
      a = old;
    } else {
      done = true;
    }
  } while (!done);
}

__global__ void tile_labels(const unsigned char* __restrict__ mask,
                            int* __restrict__ parent, int* __restrict__ count,
                            int h, int w) {
  __shared__ int label[kTile * kTile];
  __shared__ unsigned rows[kTile];
  const int lx = threadIdx.x;
  const int ly = threadIdx.y;
  const int x = blockIdx.x * kTile + lx;
  const int y = blockIdx.y * kTile + ly;
  const bool inside = x < w && y < h;
  const bool fg = inside && mask[y * w + x] != 0;
  const unsigned bits = __ballot_sync(0xffffffffu, fg);
  const int li = ly * kTile + lx;
  if (lx == 0) rows[ly] = bits;
  if (fg) {
    // the highest run start at or left of lx is this pixel's run's first
    const unsigned starts = bits & ~(bits << 1);
    label[li] = ly * kTile + 31 - __clz(starts & (0xffffffffu >> (31 - lx)));
  }
  if (li == 0 && blockIdx.x == 0 && blockIdx.y == 0) *count = 0;
  __syncthreads();
  if (fg && ly > 0) {
    const unsigned pairs = bits & rows[ly - 1];  // foreground above too
    // one union per stretch of vertical pairs: where the pair to the left
    // is foreground too, the two runs already meet there
    if (((pairs >> lx) & 1u) && (lx == 0 || !((pairs >> (lx - 1)) & 1u)))
      unite(label, li, li - kTile);
  }
  __syncthreads();
  if (inside) {
    int root = -1;
    if (fg) {
      const int r = find_root(label, li);
      root = (blockIdx.y * kTile + r / kTile) * w + blockIdx.x * kTile +
             r % kTile;
    }
    parent[y * w + x] = root;
  }
}

// Threads 0-31 take the tile's top row (the neighbour above), 32-63 its left
// column (the neighbour to the left). The sign of a parent says foreground:
// unions change roots, never signs.
__global__ void border_unions(int* parent, int h, int w) {
  const int t = threadIdx.x;
  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * kTile;
  if (t < kTile) {
    const int x = x0 + t;
    if (y0 == 0 || x >= w) return;
    const int i = y0 * w + x;
    if (parent[i] < 0 || parent[i - w] < 0) return;
    if (t > 0 && parent[i - 1] >= 0 && parent[i - w - 1] >= 0) return;
    unite(parent, i, i - w);
  } else {
    const int y = y0 + t - kTile;
    if (x0 == 0 || y >= h) return;
    const int i = y * w + x0;
    if (parent[i] < 0 || parent[i - 1] < 0) return;
    if (t > kTile && parent[i - w] >= 0 && parent[i - w - 1] >= 0) return;
    unite(parent, i, i - 1);
  }
}

__global__ void count_roots(const int* __restrict__ parent, int n,
                            int* __restrict__ count) {
  __shared__ int warp_sums[kCountThreads / 32];
  int c = 0;
  for (int i = blockIdx.x * kCountThreads + threadIdx.x; i < n;
       i += gridDim.x * kCountThreads)
    c += parent[i] == i;
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x < 32) {
    c = threadIdx.x < kCountThreads / 32 ? warp_sums[threadIdx.x] : 0;
    for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
    if (threadIdx.x == 0 && c) atomicAdd(count, c);
  }
}

}  // namespace

// Three launches on `stream` (a memset of the count alone for an empty
// mask). Returns cudaGetLastError() after the launches.
extern "C" int count_components(const unsigned char* mask, int* parent,
                                int* count, int h, int w,
                                cudaStream_t stream) {
  if (h <= 0 || w <= 0)
    return (int)cudaMemsetAsync(count, 0, sizeof(int), stream);
  const dim3 tiles((w + kTile - 1) / kTile, (h + kTile - 1) / kTile);
  tile_labels<<<tiles, dim3(kTile, kTile), 0, stream>>>(mask, parent, count,
                                                        h, w);
  border_unions<<<tiles, 2 * kTile, 0, stream>>>(parent, h, w);
  const int n = h * w;
  const int needed = (n + kCountThreads - 1) / kCountThreads;
  const int blocks = needed < 4 * 132 ? needed : 4 * 132;
  count_roots<<<blocks, kCountThreads, 0, stream>>>(parent, n, count);
  return (int)cudaGetLastError();
}
