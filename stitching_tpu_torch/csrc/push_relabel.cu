// The min cut of one graph-cut level: every pair's whole push-relabel loop
// in one launch.
//
// Replaces no TPU kernel. The JAX package cuts a level with a plain
// lax.while_loop of stencil ops, vmapped over the pairs
// (stitching_tpu/ops/graphcut.py::grid_min_cut). The port's plain version
// (stitching_tpu_torch/ops/graphcut.py::_push_relabel) runs the same loop as
// about 118 small PyTorch ops an iteration, selects every pair's state under
// its live flag, and reads the loop's end (and the BFS's) on the host every
// 8 steps: some 200 iterations of 2-3 ms of host dispatch a 12 MP stitch.
// Here each pair runs its own loop to its own end on the card, and the host
// reads one number a level.
//
// Contract: P pairs of an (h, w) grid, float32, row-major: cap (P, 4, h, w)
// the capacity of the edge from each pixel to its neighbour to the right,
// left, below and above (edges off the grid 0); s, t (P, h, w) the terminal
// capacities. scratch holds 10 h w floats a pair. Afterwards src (P, h, w)
// bytes is 1 on the pixels that cannot reach the sink in the final residual
// graph (the source side of the cut) and iters (P,) int32 holds each pair's
// iterations. Both equal the plain version's exactly: the same preflow, a
// global relabel (the BFS of residual distance to the sink, run to its
// fixed point) whenever the pair's iteration index is a multiple of
// relabel_every, then drain, push right, left, down, up (each pixel's
// excess - amount + amount received, with the heights fixed through the
// pushes), drain, relabel (1 + the lowest neighbour over positive residual
// edges, capped at 2n), all in float32 in the plain version's order, while
// any pixel has excess below height n, at most max_iters times. A pair's
// state never depends on another's, and once its own condition is false it
// no longer changes, so its own loop is the plain version's shared loop
// with the pair frozen. The BFS's distances are small whole numbers, exact
// in float32, and its fixed point is the same in any order of updates.
//
// Method: one thread-block cluster of C CTAs a pair (C from the caller,
// 1 to 8, by the grid's pixels), each CTA a contiguous share of the pair's
// pixels, each pixel's state written only by the thread that owns it.
// Neighbours meet through global memory (the scratch, in L2): an iteration
// is five phases with a cluster barrier after each, since a pixel's next
// step needs its neighbours' pushes of the last direction (the amounts go
// through two buffers, the heights through two, this iteration's and the
// next's). The loop's test and the BFS's "changed" are OR-reduced over the
// cluster in rank 0's shared memory (three slots in turn, each cleared two
// rounds before its reuse), so no block reads the host or another cluster:
// clusters are independent and any number of pairs runs.
//
// What bounds it on the H100: the barriers and the L2 round trips of each
// phase, not DRAM. A 256 x 256 pair holds 2.6 MB of state, 14 pairs 37 MB,
// which stay in the 50 MB L2; a phase reads and writes some 30 bytes a
// pixel. Each iteration waits on five cluster barriers and, in each phase,
// on one L2 round trip per pixel a thread owns (8 at 256 x 256 with C = 8).
// The design keeps those few: one launch a level, the pairs side by side
// across the SMs, up to 8 SMs on one pair so that a thread owns few pixels,
// and no host read until the level's end.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr float kInf = 1e18f;  // the plain version's INF, in float32

struct Params {
  const float* cap;
  const float* s;
  const float* t;
  float* scratch;
  unsigned char* src;
  int* iters;
  int h, w, max_iters, relabel_every;
  float n_nodes, hmax;  // n = h w + 2 and 2 n, as float32
};

// Values another thread wrote are read and written at L2 (ld.global.cg,
// st.global.cg): the cluster barrier orders them, no SM's L1 keeps a stale
// copy.
__device__ __forceinline__ float ld(const float* p) { return __ldcg(p); }
__device__ __forceinline__ void st(float* p, float v) { __stcg(p, v); }

// Whether any thread of the cluster passed `mine`: a block vote, one atomic
// a block on rank 0's slot of this round, a cluster barrier, one read. The
// slots rotate through three, and rank 0 clears the one of the last round
// (every block read it before this barrier; it is next added to two
// barriers from now).
struct ClusterAny {
  unsigned* local;  // this block's slots; [3] broadcasts the answer
  unsigned* root;   // rank 0's slots
  int round;

  __device__ bool operator()(cg::cluster_group& cluster, bool mine) {
    const int s = round % 3;
    if (__syncthreads_or(mine) && threadIdx.x == 0) atomicOr(root + s, 1u);
    cluster.sync();
    if (threadIdx.x == 0) {
      local[3] = *reinterpret_cast<volatile unsigned*>(root + s);
      if (cluster.block_rank() == 0) local[(s + 2) % 3] = 0u;
    }
    __syncthreads();
    ++round;
    return local[3] != 0u;
  }
};

struct Grid {
  int h, w, n, first, last;
  float* res;   // (4, n) residual capacities, written only by their pixel
  float* exc;   // excess
  float* tres;  // residual capacity to the sink
  float* hgt;   // (2, n) this iteration's heights and the next's
  float* amt;   // (2, n) the amounts pushed in the last two directions
  float* dist;  // the BFS's distances, over amt[0]
};

// Distance to the sink through positive residual edges (kInf where there
// is none), at its fixed point, into g.dist.
__device__ void residual_bfs(cg::cluster_group& cluster, ClusterAny& any,
                             const Grid& g) {
  const int n = g.n, w = g.w;
  for (int i = g.first + threadIdx.x; i < g.last; i += kThreads)
    st(g.dist + i, g.tres[i] > 0.f ? 0.f : kInf);
  cluster.sync();
  bool again = true;
  while (again) {
    bool changed = false;
    for (int i = g.first + threadIdx.x; i < g.last; i += kThreads) {
      const int y = i / w, x = i - y * w;
      const float d = ld(g.dist + i);
      float best = d;
      if (x + 1 < w && g.res[i] > 0.f)
        best = fminf(best, ld(g.dist + i + 1) + 1.f);
      if (x > 0 && g.res[n + i] > 0.f)
        best = fminf(best, ld(g.dist + i - 1) + 1.f);
      if (y + 1 < g.h && g.res[2 * n + i] > 0.f)
        best = fminf(best, ld(g.dist + i + w) + 1.f);
      if (y > 0 && g.res[3 * n + i] > 0.f)
        best = fminf(best, ld(g.dist + i - w) + 1.f);
      if (best < d) {
        st(g.dist + i, best);
        changed = true;
      }
    }
    again = any(cluster, changed);
  }
}

// One direction's push from a pixel of excess e along residual r toward a
// neighbour of height nb: the amount, and e and r less it.
__device__ __forceinline__ float push(float& e, float& r, float h, float nb) {
  const float m = e > 0.f && r > 0.f && h == nb + 1.f ? fminf(e, r) : 0.f;
  e = e - m;
  r = r - m;
  return m;
}

__global__ void __launch_bounds__(kThreads, 1)
    push_relabel_kernel(const Params p) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ unsigned slots[4];
  const unsigned c = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const int n = p.h * p.w, w = p.w, h = p.h;
  const size_t pair = blockIdx.x / c;
  const size_t base = pair * n;
  Grid g;
  g.h = h;
  g.w = w;
  g.n = n;
  g.first = static_cast<int>(static_cast<long long>(n) * rank / c);
  g.last = static_cast<int>(static_cast<long long>(n) * (rank + 1) / c);
  g.res = p.scratch + 10 * base;
  g.exc = g.res + 4 * static_cast<size_t>(n);
  g.tres = g.exc + n;
  g.hgt = g.tres + n;
  g.amt = g.hgt + 2 * static_cast<size_t>(n);
  g.dist = g.amt;
  const float* cap = p.cap + 4 * base;
  const float n_nodes = p.n_nodes, hmax = p.hmax;

  if (threadIdx.x < 4) slots[threadIdx.x] = 0u;
  // the preflow: terminal edges cancelled, source edges saturated
  bool mine = false;
  for (int i = g.first + threadIdx.x; i < g.last; i += kThreads) {
    const float s = p.s[base + i], t = p.t[base + i];
    const float common = fminf(s, t);
    const float e = s - common;
    g.exc[i] = e;
    g.tres[i] = t - common;
    for (int k = 0; k < 4; ++k) g.res[k * n + i] = cap[k * n + i];
    st(g.hgt + i, 0.f);
    mine |= e > 0.f;  // every height, 0, is below n
  }
  cluster.sync();  // rank 0's slots are clear before any block adds to them
  ClusterAny any{slots, cluster.map_shared_rank(slots, 0), 0};
  bool live = any(cluster, mine);

  int it = 0, cur = 0;
  while (live && it < p.max_iters) {
    float* hc = g.hgt + static_cast<size_t>(cur) * n;
    float* hn = g.hgt + static_cast<size_t>(cur ^ 1) * n;
    float* amt0 = g.amt;
    float* amt1 = g.amt + n;
    if (it % p.relabel_every == 0) {
      residual_bfs(cluster, any, g);
      // the source-disconnected nodes are parked at height n
      for (int i = g.first + threadIdx.x; i < g.last; i += kThreads) {
        const float d = fminf(ld(g.dist + i), hmax);
        st(hc + i, d >= hmax ? fmaxf(ld(hc + i), n_nodes) : d);
      }
      cluster.sync();
    }
    // drain, push right
    for (int i = g.first + threadIdx.x; i < g.last; i += kThreads) {
      const int x = i % w;
      float e = g.exc[i];
      const float t = g.tres[i];
      const float a = fminf(e, t);
      e = e - a;
      g.tres[i] = t - a;
      float r = g.res[i];
      st(amt0 + i, push(e, r, ld(hc + i), x + 1 < w ? ld(hc + i + 1) : kInf));
      g.exc[i] = e;
      g.res[i] = r;
    }
    cluster.sync();
    // take the pushes from the left neighbour, push left
    for (int i = g.first + threadIdx.x; i < g.last; i += kThreads) {
      const int x = i % w;
      const float in = x > 0 ? ld(amt0 + i - 1) : 0.f;
      float e = g.exc[i] + in;
      float r = g.res[n + i] + in;
      st(amt1 + i, push(e, r, ld(hc + i), x > 0 ? ld(hc + i - 1) : kInf));
      g.exc[i] = e;
      g.res[n + i] = r;
    }
    cluster.sync();
    // take the pushes from the right neighbour, push down
    for (int i = g.first + threadIdx.x; i < g.last; i += kThreads) {
      const int y = i / w, x = i - y * w;
      const float in = x + 1 < w ? ld(amt1 + i + 1) : 0.f;
      float e = g.exc[i] + in;
      g.res[i] = g.res[i] + in;
      float r = g.res[2 * n + i];
      st(amt0 + i, push(e, r, ld(hc + i), y + 1 < h ? ld(hc + i + w) : kInf));
      g.exc[i] = e;
      g.res[2 * n + i] = r;
    }
    cluster.sync();
    // take the pushes from above, push up
    for (int i = g.first + threadIdx.x; i < g.last; i += kThreads) {
      const int y = i / w;
      const float in = y > 0 ? ld(amt0 + i - w) : 0.f;
      float e = g.exc[i] + in;
      float r = g.res[3 * n + i] + in;
      st(amt1 + i, push(e, r, ld(hc + i), y > 0 ? ld(hc + i - w) : kInf));
      g.exc[i] = e;
      g.res[3 * n + i] = r;
    }
    cluster.sync();
    // take the pushes from below, drain, relabel
    mine = false;
    for (int i = g.first + threadIdx.x; i < g.last; i += kThreads) {
      const int y = i / w, x = i - y * w;
      const float in = y + 1 < h ? ld(amt1 + i + w) : 0.f;
      float e = g.exc[i] + in;
      float r[4] = {g.res[i], g.res[n + i], g.res[2 * n + i] + in,
                    g.res[3 * n + i]};
      g.res[2 * n + i] = r[2];
      float t = g.tres[i];
      const float a = fminf(e, t);
      e = e - a;
      t = t - a;
      g.exc[i] = e;
      g.tres[i] = t;
      const float hi = ld(hc + i);
      const float nb[4] = {x + 1 < w ? ld(hc + i + 1) : kInf,
                           x > 0 ? ld(hc + i - 1) : kInf,
                           y + 1 < h ? ld(hc + i + w) : kInf,
                           y > 0 ? ld(hc + i - w) : kInf};
      // an active node with no admissible edge lifts to 1 + the lowest
      // neighbour over positive residual edges
      float low = kInf;
      bool admissible = t > 0.f;
      for (int k = 0; k < 4; ++k) {
        if (r[k] > 0.f) {
          low = fminf(low, nb[k]);
          admissible |= hi == nb[k] + 1.f;
        }
      }
      const float hnew =
          e > 0.f && hi < hmax && !admissible ? fminf(low + 1.f, hmax) : hi;
      st(hn + i, hnew);
      mine |= e > 0.f && hnew < n_nodes;
    }
    live = any(cluster, mine);
    cur ^= 1;
    ++it;
  }

  // the min cut: the pixels that cannot reach the sink
  residual_bfs(cluster, any, g);
  for (int i = g.first + threadIdx.x; i < g.last; i += kThreads)
    p.src[base + i] = ld(g.dist + i) >= hmax;
  if (rank == 0 && threadIdx.x == 0) p.iters[pair] = it;
  cluster.sync();  // no block leaves while another may read rank 0's slots
}

}  // namespace

// One launch on `stream`: pairs clusters of `cluster` CTAs (1 to 8).
// Returns the launch's cudaError_t, or cudaGetLastError() after it.
extern "C" int push_relabel(const float* cap, const float* s, const float* t,
                            float* scratch, unsigned char* src, int* iters,
                            int pairs, int h, int w, int max_iters,
                            int relabel_every, int cluster,
                            cudaStream_t stream) {
  if (pairs <= 0 || h <= 0 || w <= 0 || relabel_every <= 0 || cluster < 1 ||
      cluster > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{cap, s, t, scratch, src, iters, h, w, max_iters, relabel_every,
           static_cast<float>(static_cast<long long>(h) * w + 2), 0.f};
  p.hmax = 2.f * p.n_nodes;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pairs * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, push_relabel_kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
