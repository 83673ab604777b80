// Ordered top-2 of a row of distances, shared by the binary and the float
// 2-nearest-neighbour kernels (two_nn.cu, two_nn_float.cu).
//
// A `Best` is the partial result over some set of target columns: d0 the
// smallest distance, i0 the lowest column attaining it, d1 the smallest
// over the other columns. It starts empty (d0 = d1 = 3e38, i0 = INT_MAX).
//   fold:  adds one column; columns must come in increasing order, and d0
//          moves only on a strict `<`, so the lowest column wins a tie and a
//          later equal column makes d1 = d0.
//   merge: joins two partials over disjoint column sets: the lower d0 wins,
//          equal d0 goes to the lower column, d1 = min(winner's d1, loser's
//          d0). The result does not depend on the order of merging, so
//          lanes, warps and blocks may merge in any order.
// Columns at or beyond nt are never folded; the padded invalid columns of
// the contract exist only through `pad_col` (d1 = min(d1, 1e30)) at the
// final store, where i0 is also clamped to nt - 1.
//
// When the query rows alone would not fill the card, the target axis is
// split over blockIdx.y: every block writes its rows' partials to a scratch
// array (splits, batch, nq, 3), and `merge_segments`, a launch of its own
// with one thread a row, merges them (`merge_after`). Grid of the search:
// x = row block, y = target segment, z = batch entry. (A merge inside the
// search, by the last block of a row block to arrive, was built and
// measured at every grid: never faster and up to 20% slower, because that
// block merges alone what the separate launch spreads over the card, and
// every block pays a fence and an atomic. PERF.md keeps the numbers.)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace top2 {

constexpr float kBig = 1.0e30f;
constexpr float kInit = 3.0e38f;
constexpr int kNoCol = 0x7fffffff;

struct Best {
  float d0, d1;
  int i0;
};

__device__ __forceinline__ Best empty() { return Best{kInit, kInit, kNoCol}; }

__device__ __forceinline__ void fold(Best& b, float dist, int col) {
  // without branches: d1 takes the larger of (dist, old d0) if that is
  // smaller, which is old d0 exactly when dist wins
  b.i0 = dist < b.d0 ? col : b.i0;
  b.d1 = fminf(b.d1, fmaxf(dist, b.d0));
  b.d0 = fminf(b.d0, dist);
}

__device__ __forceinline__ void merge(Best& b, const Best& o) {
  const bool mine = b.d0 < o.d0 || (b.d0 == o.d0 && b.i0 < o.i0);
  if (mine) {
    b.d1 = fminf(b.d1, o.d0);
  } else {
    b.d1 = fminf(o.d1, b.d0);
    b.d0 = o.d0;
    b.i0 = o.i0;
  }
}

// merge with the lane `offset` away (butterfly step)
__device__ __forceinline__ void merge_lane(Best& b, int offset) {
  Best o;
  o.d0 = __shfl_xor_sync(0xffffffffu, b.d0, offset);
  o.d1 = __shfl_xor_sync(0xffffffffu, b.d1, offset);
  o.i0 = __shfl_xor_sync(0xffffffffu, b.i0, offset);
  merge(b, o);
}

struct Out {
  float* d0;       // (batch, nq)
  float* d1;
  int* i0;
  float* partial;  // (splits, batch, nq, 3): d0, d1, i0's bits
  int nq, nt, pad_col;
  int splits, batch;  // the search grid's y and z extents
};

__device__ __forceinline__ void store_final(const Out& o, long long idx,
                                            const Best& b) {
  o.d0[idx] = b.d0;
  o.d1[idx] = o.pad_col ? fminf(b.d1, kBig) : b.d1;
  o.i0[idx] = min(b.i0, o.nt - 1);
}

__device__ __forceinline__ float* partial_at(const Out& o, int split,
                                             long long idx) {
  return o.partial + ((long long)split * o.batch * o.nq + idx) * 3;
}

// `row`'s top-2 over this block's target segment: the result itself when
// the target axis is not split, else one partial of it
__device__ __forceinline__ void store(const Out& o, int row, const Best& b) {
  if (row >= o.nq) return;
  const long long idx = (long long)blockIdx.z * o.nq + row;
  if (o.splits == 1) {
    store_final(o, idx, b);
    return;
  }
  float* p = partial_at(o, blockIdx.y, idx);
  p[0] = b.d0;
  p[1] = b.d1;
  reinterpret_cast<int*>(p)[2] = b.i0;
}

// merges the segments' partials of one row and writes the result
__device__ __forceinline__ void merge_row(const Out& o, long long idx) {
  Best b = empty();
  for (int s = 0; s < o.splits; ++s) {
    const float* p = partial_at(o, s, idx);
    Best x;
    x.d0 = __ldcg(p);
    x.d1 = __ldcg(p + 1);
    x.i0 = __ldcg(reinterpret_cast<const int*>(p) + 2);
    merge(b, x);
  }
  store_final(o, idx, b);
}

__global__ void merge_segments(Out o) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx < (long long)o.batch * o.nq) merge_row(o, idx);
}

// after the search: starts `merge_segments` where the target axis is split
inline cudaError_t merge_after(const Out& o, cudaStream_t stream) {
  if (o.splits > 1) {
    const long long rows = (long long)o.batch * o.nq;
    merge_segments<<<(unsigned)((rows + 127) / 128), 128, 0, stream>>>(o);
  }
  return cudaGetLastError();
}

}  // namespace top2
