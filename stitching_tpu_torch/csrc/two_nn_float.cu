// Float 2-nearest-neighbour search (squared L2): every image pair in both
// directions (`two_nn_pairs_float`) and one query set against one target
// set (`two_nn_float`). One kernel serves both.
//
// Replaces: the float case (`is_binary=False`) of
// stitching_tpu/ops/pallas/two_nn.py::two_nn_pairs and ::two_nn, whose body
// forms the distance tile with one MXU product and reduces it on the VPU.
//
// Contract, per query row r against a target set of nt rows:
//   dist(r, c) = max(|q_r|^2 + (|t_c|^2 + adj_c) - 2 q_r.t_c, 0),
//   adj_c = 0 for a valid target and 1e30 for an invalid one (which absorbs
//   the real distance in float32),
//   d0 = min over columns, i0 = the lowest column attaining d0 (clamped to
//   nt - 1), d1 = min over the other columns.
// Distances are SQUARED; the caller takes the root. The TPU versions pad
// the target axis with invalid columns (to a multiple of 8 or of 128);
// `pad_col` says whether such columns exist, and then d1 is at most 1e30.
// Queries are not masked.
//
// What bounds it on the H100: operations. A pair of 500 x 500 descriptors
// of 128 floats is 2 * 500 * 500 * 128 = 64 MFLOP on 0.5 MB, ~250 FLOP per
// byte, far above the card's float32 balance (67 TFLOP/s over 3.35 TB/s =
// 20 FLOP per byte). Tensor cores are out: the contract is full float32
// (no TF32), so the bound is the FMA rate outside them. Measured on an H100
// at 700 W (chip_smoke.py, CUDA graph replay): 0.277 ms for 28 pairs of
// 8 x 500 x 128 descriptors in both directions, 10x the bound (which counts
// one product per pair: the backward direction's is the forward's
// transpose, and this kernel computes it again), and 0.060 ms for one
// 500 x 500 x 128 set, 62x its bound: 32 blocks of 4 warps leave
// one warp on each scheduler of 32 SMs, so the shared-memory latency of
// the FMA loop is not hidden. Fewer query rows per block for a small query
// set, and more targets per lane, are the first speed steps.
//
// Design: a first pass (`row_norms`) writes |row|^2, and for targets
// |row|^2 + adj, one warp per row. The main kernel gives a block 16 query
// rows of one (pair, direction), 4 to each of its 4 warps. Targets go
// through shared memory 64 at a time, and the descriptor axis 128 columns
// at a time, so any nt and any d fit (a descriptor of up to 128 columns,
// SIFT's width, is staged in one step per tile, and its query rows only
// once). The target chunk is stored
// transposed ([column][target], row stride 65), so a warp's lanes read 32
// neighbouring targets without bank conflicts while the query value is a
// broadcast. Each lane owns targets lane and lane + 32 of the tile and
// accumulates q.t for its warp's 4 queries with serial float32 FMAs in
// column order of d: 8 sums in registers. After a tile a lane folds its
// two distances into a running top-2 in increasing column order, with
// strict `<`, so the lowest column wins a tie. At the end the 32 lanes'
// top-2s are merged by shuffles with the same rule (lower d0 wins, equal
// d0 goes to the lower column, d1 = min(winner's d1, loser's d0)), which
// does not depend on the order of merging. The sum q.t is taken in
// another order than a library product would take it, so d0 and d1 agree
// with the plain version to rounding (1e-3 relative + 1e-3 absolute is
// the stated tolerance), and i0 wherever the two nearest are further
// apart than that.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;     // 4 warps
constexpr int kRowsPerWarp = 4;   // query rows per warp
constexpr int kQueryTile = 16;    // query rows per block
constexpr int kTargetTile = 64;   // targets staged per tile, 2 per lane
constexpr int kChunk = 128;       // descriptor columns staged per step
constexpr float kBig = 1.0e30f;
constexpr float kInit = 3.0e38f;

// norm[r] = |desc_r|^2; adj[r] = norm[r] + (valid[r] ? 0 : 1e30). Either
// output may be null. One warp per row.
__global__ void row_norms(const float* __restrict__ desc,
                          const uint8_t* __restrict__ valid,
                          float* __restrict__ norm, float* __restrict__ adj,
                          int rows, int d) {
  const int warp = (int)((blockIdx.x * (long long)blockDim.x + threadIdx.x)
                         / 32);
  const int lane = threadIdx.x % 32;
  if (warp >= rows) return;
  const float* src = desc + (long long)warp * d;
  float s = 0.0f;
  for (int k = lane; k < d; k += 32) s = fmaf(src[k], src[k], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    if (norm) norm[warp] = s;
    if (adj) adj[warp] = s + (valid[warp] ? 0.0f : kBig);
  }
}

__device__ __forceinline__ void fold(float dist, int col, float& d0,
                                     float& d1, int& i0) {
  if (dist < d0) {
    d1 = d0;
    d0 = dist;
    i0 = col;
  } else if (dist < d1) {
    d1 = dist;
  }
}

__global__ void __launch_bounds__(kThreads)
two_nn_float_kernel(const float* __restrict__ q_desc,
                    const float* __restrict__ t_desc,
                    const float* __restrict__ q_norm,
                    const float* __restrict__ t_adj,
                    const int* __restrict__ pair_ij,
                    float* __restrict__ d0_out, float* __restrict__ d1_out,
                    int* __restrict__ i0_out, int nq, int nt, int d,
                    int pad_col) {
  __shared__ float q_s[kQueryTile][kChunk];
  __shared__ float t_s[kChunk][kTargetTile + 1];

  const int p = blockIdx.z;
  const int dir = blockIdx.y;
  // without a pair list: one query set against one target set
  const int qi = pair_ij ? pair_ij[2 * p + dir] : 0;
  const int ti = pair_ij ? pair_ij[2 * p + 1 - dir] : 0;
  const float* q_src = q_desc + (long long)qi * nq * d;
  const float* t_src = t_desc + (long long)ti * nt * d;
  const float* qn_src = q_norm + (long long)qi * nq;
  const float* ta_src = t_adj + (long long)ti * nt;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int block_row0 = blockIdx.x * kQueryTile;
  const int row0 = block_row0 + warp * kRowsPerWarp;

  float qn[kRowsPerWarp], d0[kRowsPerWarp], d1[kRowsPerWarp];
  int i0[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    qn[r] = row0 + r < nq ? qn_src[row0 + r] : 0.0f;
    d0[r] = kInit;
    d1[r] = kInit;
    i0[r] = 0x7fffffff;
  }

  for (int t0 = 0; t0 < nt; t0 += kTargetTile) {
    float acc[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) acc[r][0] = acc[r][1] = 0.0f;

    for (int k0 = 0; k0 < d; k0 += kChunk) {
      // stage the chunk: queries [row][k], targets transposed [k][target];
      // consecutive threads read consecutive descriptor columns
      // (a descriptor that fits one chunk keeps its queries from tile 0)
      if (t0 == 0 || d > kChunk) {
        for (int e = threadIdx.x; e < kQueryTile * kChunk; e += kThreads) {
          const int r = e / kChunk, k = e % kChunk;
          const int row = block_row0 + r;
          q_s[r][k] = (row < nq && k0 + k < d)
                          ? q_src[(long long)row * d + k0 + k] : 0.0f;
        }
      }
      for (int e = threadIdx.x; e < kTargetTile * kChunk; e += kThreads) {
        const int c = e / kChunk, k = e % kChunk;
        const int col = t0 + c;
        t_s[k][c] = (col < nt && k0 + k < d)
                        ? t_src[(long long)col * d + k0 + k] : 0.0f;
      }
      __syncthreads();
      const int kc = min(kChunk, d - k0);
#pragma unroll 8
      for (int k = 0; k < kc; ++k) {
        const float ta = t_s[k][lane];
        const float tb = t_s[k][lane + 32];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float qv = q_s[warp * kRowsPerWarp + r][k];
          acc[r][0] = fmaf(qv, ta, acc[r][0]);
          acc[r][1] = fmaf(qv, tb, acc[r][1]);
        }
      }
      __syncthreads();
    }

    // this lane's two columns of the tile, in increasing order
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = t0 + lane + 32 * j;
      if (col < nt) {
        const float ta = ta_src[col];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          // 2 * acc is exact, so the FMA rounds once like s - 2 * acc
          const float dist = fmaxf(fmaf(-2.0f, acc[r][j], qn[r] + ta), 0.0f);
          fold(dist, col, d0[r], d1[r], i0[r]);
        }
      }
    }
  }

  // merge the lanes' top-2s; the result does not depend on the order
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o0 = __shfl_xor_sync(0xffffffffu, d0[r], off);
      const float o1 = __shfl_xor_sync(0xffffffffu, d1[r], off);
      const int oi = __shfl_xor_sync(0xffffffffu, i0[r], off);
      const bool mine = d0[r] < o0 || (d0[r] == o0 && i0[r] < oi);
      if (mine) {
        d1[r] = fminf(d1[r], o0);
      } else {
        d1[r] = fminf(o1, d0[r]);
        d0[r] = o0;
        i0[r] = oi;
      }
    }
    const int row = row0 + r;
    if (lane == 0 && row < nq) {
      const long long o = ((long long)p * 2 + dir) * nq + row;
      d0_out[o] = d0[r];
      d1_out[o] = pad_col ? fminf(d1[r], kBig) : d1[r];
      i0_out[o] = min(i0[r], nt - 1);
    }
  }
}

int norms(const float* desc, const uint8_t* valid, float* norm, float* adj,
          long long rows, int d, cudaStream_t stream) {
  const long long threads = rows * 32;
  row_norms<<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
      desc, valid, norm, adj, (int)rows, d);
  return (int)cudaGetLastError();
}

}  // namespace

// desc: (b, n, d) float32; valid: (b, n) uint8; pair_ij: (p, 2) int32;
// norm, adj: scratch of b * n floats each; outputs (p, 2, n). Returns
// cudaGetLastError().
extern "C" int two_nn_pairs_float(const float* desc, const uint8_t* valid,
                                  const int* pair_ij, float* norm,
                                  float* adj, float* d0, float* d1, int* i0,
                                  int b, int n, int d, int p, int pad_col,
                                  cudaStream_t stream) {
  if (d <= 0 || n <= 0 || p <= 0 || b <= 0) return (int)cudaErrorInvalidValue;
  int err = norms(desc, valid, norm, adj, (long long)b * n, d, stream);
  if (err != 0) return err;
  const dim3 grid((n + kQueryTile - 1) / kQueryTile, 2, p);
  two_nn_float_kernel<<<grid, kThreads, 0, stream>>>(
      desc, desc, norm, adj, pair_ij, d0, d1, i0, n, n, d, pad_col);
  return (int)cudaGetLastError();
}

// desc_q: (nq, d) and desc_t: (nt, d) float32; valid_t: (nt,) uint8;
// norm_q: scratch of nq floats, adj_t: scratch of nt floats; outputs
// (nq,). Returns cudaGetLastError().
extern "C" int two_nn_float(const float* desc_q, const float* desc_t,
                            const uint8_t* valid_t, float* norm_q,
                            float* adj_t, float* d0, float* d1, int* i0,
                            int nq, int nt, int d, int pad_col,
                            cudaStream_t stream) {
  if (d <= 0 || nq <= 0 || nt <= 0) return (int)cudaErrorInvalidValue;
  int err = norms(desc_q, nullptr, norm_q, nullptr, nq, d, stream);
  if (err != 0) return err;
  err = norms(desc_t, valid_t, nullptr, adj_t, nt, d, stream);
  if (err != 0) return err;
  const dim3 grid((nq + kQueryTile - 1) / kQueryTile, 1, 1);
  two_nn_float_kernel<<<grid, kThreads, 0, stream>>>(
      desc_q, desc_t, norm_q, adj_t, nullptr, d0, d1, i0, nq, nt, d, pad_col);
  return (int)cudaGetLastError();
}
