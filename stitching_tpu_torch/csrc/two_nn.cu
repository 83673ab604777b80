// Binary 2-nearest-neighbour search: every image pair in both directions
// (`two_nn_pairs_binary`) and one query set against one target set
// (`two_nn_binary`).
//
// Replaces: stitching_tpu/ops/pallas/two_nn.py::two_nn_pairs (the Pallas
// TPU kernel called from pipeline.py::_match_kernel) and ::two_nn (called
// from ops/match.py::match_pair), binary descriptors.
//
// Contract, per query row r of a query set against a target set of nt
// rows (for a pair p = (i, j): direction 0 is i queries j, 1 is j queries
// i, and both sets have n rows):
//   d0 = min over target columns c of dist(r, c),
//   i0 = the lowest column attaining d0 (clamped to nt - 1),
//   d1 = min over the other columns,
// where dist is the Hamming distance for a valid target and 1e30 for an
// invalid one. The TPU versions pad the target axis with invalid columns,
// `two_nn_pairs` to a multiple of 8 and `two_nn` to a multiple of 128;
// `pad_col` says whether such columns exist, and then d1 is at most 1e30.
// Queries are not masked. With every target invalid the result is i0 = 0,
// d0 = d1 = 1e30.
//
// What bounds it on the H100: at the matcher's shapes (8 images of 500
// descriptors, 28 pairs) the work is 28 * 2 * 500 * 500 distances of 256
// bits: ~0.4 G word operations on 4 MB of descriptors, so instruction
// issue, not memory, is the limit. Measured on an H100 at these shapes
// (chip_smoke.py): ~57 us of device time per call, 16x the bound, because
// 224 blocks of 4 warps leave ~7 warps per SM to hide the latency of each
// thread's serial walk over 500 targets. More warps per query tile
// (splitting the target axis, then merging the top-2s in column order) is
// the first speed step. One pair of 500 x 500 (`two_nn_binary`) is four
// blocks and takes the same ~58 us (measured likewise): the time is one
// thread's walk, not the card's throughput.
//
// Design: a first pass packs each {0,1} float row into 8 32-bit words, so
// a distance is 8 XOR + popcount instead of 256 multiply-adds. The main
// kernel runs one thread per query row, holding its words in registers;
// a block covers 128 query rows of one (pair, direction) and stages 128
// target rows and their valid flags at a time in shared memory, where
// every thread reads the same word (a broadcast), so any number of
// targets goes through tile by tile. Each
// thread walks the targets in increasing column order and keeps a running
// top-2: d0 moves only on a strict `<`, so the lowest index wins ties, and a
// later column equal to d0 makes d1 = d0. Hamming distances are small
// integers, so the result equals the plain version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQueryTile = 128;   // query rows per block, one thread each
constexpr int kTargetTile = 128;  // target rows staged per shared tile
constexpr int NW = 8;             // 32-bit words per 256-bit descriptor

__global__ void pack_bits(const float* __restrict__ desc,
                          uint32_t* __restrict__ words, int rows, int d) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= (long long)rows * NW) return;
  const int r = (int)(idx / NW);
  const int w = (int)(idx % NW);
  const float* src = desc + (long long)r * d;
  uint32_t v = 0;
  for (int k = 0; k < 32; ++k) {
    const int c = w * 32 + k;
    if (c < d && src[c] > 0.5f) v |= (1u << k);
  }
  words[idx] = v;
}

__global__ void __launch_bounds__(kQueryTile)
two_nn_binary_kernel(const uint32_t* __restrict__ q_words,
                     const uint32_t* __restrict__ t_words,
                     const uint8_t* __restrict__ valid,
                     const int* __restrict__ pair_ij,
                     float* __restrict__ d0_out, float* __restrict__ d1_out,
                     int* __restrict__ i0_out, int nq, int nt, int pad_col) {
  __shared__ uint32_t s_words[kTargetTile * NW];
  __shared__ uint8_t s_valid[kTargetTile];

  const int p = blockIdx.z;
  const int dir = blockIdx.y;
  // without a pair list: one query set against one target set
  const int qi = pair_ij ? pair_ij[2 * p + dir] : 0;
  const int ti = pair_ij ? pair_ij[2 * p + 1 - dir] : 0;
  const int row = blockIdx.x * kQueryTile + threadIdx.x;

  uint32_t q[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w)
    q[w] = row < nq ? q_words[((long long)qi * nq + row) * NW + w] : 0u;

  float d0 = 3.0e38f;
  float d1 = 3.0e38f;
  int i0 = 0;
  const uint32_t* t_src = t_words + (long long)ti * nt * NW;
  const uint8_t* v_src = valid + (long long)ti * nt;
  for (int t0 = 0; t0 < nt; t0 += kTargetTile) {
    const int cnt = min(kTargetTile, nt - t0);
    for (int k = threadIdx.x; k < cnt * NW; k += blockDim.x)
      s_words[k] = t_src[(long long)t0 * NW + k];
    for (int k = threadIdx.x; k < cnt; k += blockDim.x)
      s_valid[k] = v_src[t0 + k];
    __syncthreads();
    for (int c = 0; c < cnt; ++c) {
      int s = 0;
#pragma unroll
      for (int w = 0; w < NW; ++w) s += __popc(q[w] ^ s_words[c * NW + w]);
      const float dist = s_valid[c] ? (float)s : 1.0e30f;
      if (dist < d0) {
        d1 = d0;
        d0 = dist;
        i0 = t0 + c;
      } else if (dist < d1) {
        d1 = dist;
      }
    }
    __syncthreads();
  }
  if (pad_col) d1 = fminf(d1, 1.0e30f);
  if (row < nq) {
    const long long o = ((long long)p * 2 + dir) * nq + row;
    d0_out[o] = d0;
    d1_out[o] = d1;
    i0_out[o] = min(i0, nt - 1);
  }
}

}  // namespace

// desc: (b, n, d) float32 {0,1} with d <= 256; valid: (b, n) uint8;
// pair_ij: (p, 2) int32; words: scratch of b * n * 8 uint32; outputs
// (p, 2, n). Returns cudaGetLastError().
extern "C" int two_nn_pairs_binary(const float* desc, const uint8_t* valid,
                                   const int* pair_ij, uint32_t* words,
                                   float* d0, float* d1, int* i0, int b,
                                   int n, int d, int p, int pad_col,
                                   cudaStream_t stream) {
  if (d > 32 * NW || n <= 0 || p <= 0) return (int)cudaErrorInvalidValue;
  const long long packs = (long long)b * n * NW;
  pack_bits<<<(unsigned)((packs + 255) / 256), 256, 0, stream>>>(
      desc, words, b * n, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kQueryTile - 1) / kQueryTile, 2, p);
  two_nn_binary_kernel<<<grid, kQueryTile, 0, stream>>>(
      words, words, valid, pair_ij, d0, d1, i0, n, n, pad_col);
  return (int)cudaGetLastError();
}

// desc_q: (nq, d) and desc_t: (nt, d) float32 {0,1} with d <= 256;
// valid_t: (nt,) uint8; words_q, words_t: scratch of nq * 8 and nt * 8
// uint32; outputs (nq,). Returns cudaGetLastError().
extern "C" int two_nn_binary(const float* desc_q, const float* desc_t,
                             const uint8_t* valid_t, uint32_t* words_q,
                             uint32_t* words_t, float* d0, float* d1,
                             int* i0, int nq, int nt, int d, int pad_col,
                             cudaStream_t stream) {
  if (d > 32 * NW || nq <= 0 || nt <= 0) return (int)cudaErrorInvalidValue;
  const unsigned q_blocks = (unsigned)(((long long)nq * NW + 255) / 256);
  const unsigned t_blocks = (unsigned)(((long long)nt * NW + 255) / 256);
  pack_bits<<<q_blocks, 256, 0, stream>>>(desc_q, words_q, nq, d);
  pack_bits<<<t_blocks, 256, 0, stream>>>(desc_t, words_t, nt, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nq + kQueryTile - 1) / kQueryTile, 1, 1);
  two_nn_binary_kernel<<<grid, kQueryTile, 0, stream>>>(
      words_q, words_t, valid_t, nullptr, d0, d1, i0, nq, nt, pad_col);
  return (int)cudaGetLastError();
}
