// Binary 2-nearest-neighbour search: every image pair in both directions
// (`two_nn_pairs_binary`) and one query set against one target set
// (`two_nn_binary`). One kernel serves both.
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
// d0 = d1 = 1e30. Hamming distances are small integers, so the result
// equals the plain version bit for bit.
//
// What bounds it on the H100: at the matcher's shapes (8 images of 500
// descriptors, 28 pairs) the work is 28 * 2 * 500 * 500 distances of 256
// bits on 4.4 MB of descriptors and results. Done word by word that is 112 M
// popcounts, about 31 us of the integer pipe however well it is spread (16
// a clock an SM), so the distances come from the tensor cores. Their 1-bit
// product ran at 21,703 bit products a clock an SM here
// (scripts/probe_mma_rate.cu), 5.3 times the int8 peak; at that rate the
// products take under 0.4 us, so the call is bound by its bytes (1.3 us),
// and in practice by its two launches (2.1 us). One pair (500 x 500) is
// bound by its 0.26 MB of bytes (0.3 us) and in practice by three launches.
//
// Design:
// - A pre-pass (`pack_rows`, one launch for every operand row of a call)
//   packs each {0,1} float row into 8 32-bit words, one warp a row and one
//   `__ballot_sync` per 32 columns, so the reads coalesce; rows narrower
//   than 256 bits are zero-padded. It also writes each row's bit count s,
//   once plain (the query's term) and once as a target (1024 if invalid).
// - Distances by the 1-bit tensor-core product
//   `mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc`: one
//   instruction gives popc(q & t) over all 256 bits for 16 query rows x 8
//   targets. Hamming = s_q + s_t - 2 popc(q & t), exact in int32.
//   (`.xor.popc` is deprecated for sm_90; `.and.popc` assembles for sm_90a.
//   The int8 form m16n8k32 on {0,1} bytes was built and measured too: it
//   needs 8 instructions and 8 times the bytes for the same tile, each
//   instruction as slow as the 1-bit one (scripts/probe_mma_rate.cu), and
//   was slower at every grid, see PERF.md. The
//   form is a choice made when the kernel was designed, not a switch at
//   run time. `wgmma` is not needed: a warp's strip of 16 x 500 is 63
//   instructions.)
// - A warp owns 16 query rows: its A fragment (4 registers a thread) stays
//   in registers while it walks the block's target segment in increasing
//   column order, 4 tiles of 8 columns a step, so that four independent
//   `mma`s and their loads are in flight at once (a scheduler starts one
//   `mma` about every 6 clocks, but only from independent chains).
// - Targets are staged in shared memory 1024 at a time (32 B of words and
//   a key a row) with 16-byte `cp.async` copies, any nt chunk by chunk.
//   The two halves of every other group of 4 rows are swapped so that the
//   B fragment's loads (8 rows x 4 words a warp) touch 32 different banks.
// - The fold is integer and free of branches: key = dist << 16 | (column -
//   segment start), and a running (smallest, second smallest) key per row
//   is three min/max instructions a distance. Keys are distinct, so the
//   smallest key is the lowest column of the smallest distance and the
//   second smallest key's distance is the minimum over the other columns:
//   the contract's tie rule. An invalid target counts 1024 bits, which
//   puts its distance at 768 or more; a segment is at most 65536 columns.
//   At the end of the segment the 4 lanes of a quad merge their keys by
//   shuffles, and the keys become top2.cuh's (d0, d1, i0): 1e30 for an
//   invalid distance, with i0 the segment's first column when even the
//   nearest is invalid.
// - A block is 4 warps (64 query rows). Where the query rows give too few
//   blocks for the card the wrapper splits the target axis over blockIdx.y
//   (ops/kernels/two_nn.py::launch_plan) and a small third launch merges
//   the segments' partial results (top2.cuh); else a call is two launches.
// - Both directions of a pair compute their own product. Sharing one (the
//   backward distances are the forward's transpose) needs a column-wise
//   top-2 across blocks and is worth about a microsecond of tensor work;
//   the bound keeps counting one product a pair.
//
// Measured on an NVIDIA H100 80GB HBM3 at a power limit of 700 W
// (scripts/bench_two_nn.py, device time per call from a CUDA graph replay):
// 0.0105 ms for 28 pairs of 8 x 500 x 256 bits in both directions (8x its
// bytes bound of 0.0013 ms, 5x the 0.0021 ms that two empty launches
// cost; the kernel this one replaced took 0.059 ms) and 0.0062 ms
// for one 500 x 500 pair (three launches, floor 0.0030 ms; before: 0.057).
// Of the pairs call's 7.9 us of search, 2.8 us are the folds, 0.3 us the
// `mma`s and the rest launch, staging and loads (measured by leaving each
// out); the pre-pass is 2.3 us. PERF.md keeps the record.

#include <cuda_runtime.h>
#include <stdint.h>

#include "top2.cuh"

namespace {

constexpr int NW = 8;              // 32-bit words per 256-bit descriptor
constexpr int kRowsPerWarp = 16;   // the mma's m
constexpr int kThreads = 128;      // 4 warps
constexpr int kChunk = 1024;       // targets staged at a time
constexpr int kStep = 32;          // targets a step: 4 mma tiles of 8
constexpr int kInvalidCount = 1024;  // bit count standing for an invalid target
constexpr int kInvalidDist = 768;    // distances from here on are invalid targets
constexpr int kNoDist = 0x2000;      // distances from here on are no column at all
constexpr int kNoKey = 0x7fffffff;
constexpr int kPadKey = 0x3fff0000;  // a chunk's columns past the segment's end
constexpr int kMaxSeg = 1 << 16;

// One warp per operand row. Rows [0, rows_q) come from desc_q, the rest
// from desc_t; valid_q / valid_t may be null (all valid).
__global__ void pack_rows(const float* __restrict__ desc_q,
                          const float* __restrict__ desc_t,
                          const uint8_t* __restrict__ valid_q,
                          const uint8_t* __restrict__ valid_t,
                          uint32_t* __restrict__ words,
                          int* __restrict__ count_q, int* __restrict__ count_t,
                          int rows_q, int rows, int d) {
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const int row = (int)(tid / 32);
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bool is_q = row < rows_q;
  const float* src = is_q ? desc_q + (long long)row * d
                          : desc_t + (long long)(row - rows_q) * d;
  uint32_t mine = 0;
  int s = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const int c = w * 32 + lane;
    const uint32_t word = __ballot_sync(0xffffffffu, c < d && src[c] > 0.5f);
    s += __popc(word);
    if (lane == w) mine = word;
  }
  if (lane < NW) words[(long long)row * NW + lane] = mine;
  if (lane == 0) {
    const uint8_t* v = is_q ? valid_q : valid_t;
    const bool ok = v == nullptr || v[is_q ? row : row - rows_q] != 0;
    count_q[row] = s;
    count_t[row] = ok ? s : kInvalidCount;
  }
}

__device__ __forceinline__ void mma_and_popc(int (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = ok ? 16 : 0;   // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
               ::: "memory");
}

// running smallest (k0) and second smallest (k1) key
__device__ __forceinline__ void fold_key(int& k0, int& k1, int key) {
  k1 = min(k1, max(key, k0));
  k0 = min(k0, key);
}

__device__ __forceinline__ float key_dist(int key) {
  const int dist = key >> 16;
  return dist >= kNoDist ? top2::kInit
                         : dist >= kInvalidDist ? top2::kBig : (float)dist;
}

__device__ __forceinline__ top2::Best best_of_keys(int k0, int k1,
                                                   int seg_begin) {
  top2::Best b = top2::empty();
  const int dist = k0 >> 16;
  if (dist < kNoDist) {
    b.d0 = key_dist(k0);
    b.d1 = key_dist(k1);
    // with even the nearest invalid, every column of the segment is
    b.i0 = seg_begin + (dist >= kInvalidDist ? 0 : (k0 & 0xffff));
  }
  return b;
}

// words, count_q, count_t: the pre-pass's outputs, indexed by operand row.
// A pair's query image qi starts at operand row qi * nq and its target
// image at ti * nt; without a pair list the queries start at row 0 and the
// targets at row t_base. seg: targets per blockIdx.y, a multiple of 8, at
// most kMaxSeg.
__global__ void __launch_bounds__(kThreads)
two_nn_binary_kernel(const uint32_t* __restrict__ words,
                     const int* __restrict__ count_q,
                     const int* __restrict__ count_t,
                     const int* __restrict__ pair_ij, int t_base, int seg,
                     top2::Out out) {
  __shared__ uint4 s_words[kChunk * 2];
  __shared__ __align__(8) int s_key[kChunk];

  const int nq = out.nq, nt = out.nt;
  const int dir = blockIdx.z & 1;
  const int p = blockIdx.z >> 1;
  const long long q_off = pair_ij ? (long long)pair_ij[2 * p + dir] * nq : 0;
  const long long t_off = pair_ij ? (long long)pair_ij[2 * p + 1 - dir] * nt
                                  : t_base;
  const uint32_t* q_words = words + q_off * NW;
  const uint4* t_words = reinterpret_cast<const uint4*>(words + t_off * NW);
  const int* t_count = count_t + t_off;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // fragment row (A, C) and column (B)
  const int t = lane % 4;   // word of each half (A, B), column pair (C)
  constexpr int rows_per_block = (kThreads / 32) * kRowsPerWarp;
  const int row_a = blockIdx.x * rows_per_block + warp * kRowsPerWarp + g;
  const int row_b = row_a + 8;

  // A fragment: a0 = (row g, word t), a1 = (row g + 8, word t),
  // a2 = (row g, word t + 4), a3 = (row g + 8, word t + 4); and each row's
  // bit count, shifted to the key's distance field
  uint32_t a[4] = {0u, 0u, 0u, 0u};
  int qk_a = 0, qk_b = 0;
  if (row_a < nq) {
    a[0] = q_words[(long long)row_a * NW + t];
    a[2] = q_words[(long long)row_a * NW + t + 4];
    qk_a = count_q[q_off + row_a] << 16;
  }
  if (row_b < nq) {
    a[1] = q_words[(long long)row_b * NW + t];
    a[3] = q_words[(long long)row_b * NW + t + 4];
    qk_b = count_q[q_off + row_b] << 16;
  }

  int k0_a = kNoKey, k1_a = kNoKey, k0_b = kNoKey, k1_b = kNoKey;
  const int seg_begin = blockIdx.y * seg;
  const int seg_end = min(nt, seg_begin + seg);
  const int swap = g >> 2;  // rows 4..7 of a group of 8 keep their halves swapped

  for (int c0 = seg_begin; c0 < seg_end; c0 += kChunk) {
    const int cnt = min(kChunk, seg_end - c0);
    const int padded = (cnt + kStep - 1) / kStep * kStep;
    __syncthreads();
    // stage: 2 x 16 bytes a row, zero rows and keys that never win up to a
    // whole step
    for (int e = threadIdx.x; e < padded * 2; e += kThreads) {
      const int r = e >> 1, half = e & 1;
      cp_async16(s_words + r * 2 + (half ^ ((r >> 2) & 1)),
                 t_words + (r < cnt ? (long long)(c0 + r) * 2 + half : 0),
                 r < cnt);
    }
    for (int e = threadIdx.x; e < padded; e += kThreads)
      s_key[e] = e < cnt ? (t_count[c0 + e] << 16) + (c0 - seg_begin + e)
                         : kPadKey + e;
    cp_async_wait_all();
    __syncthreads();

    for (int r0 = 0; r0 < padded; r0 += kStep) {
      // B fragments of 4 tiles: b0 = (word t, column g), b1 = (word t + 4,
      // column g); and the keys of this thread's 2 columns of each
      uint32_t b0[4], b1[4];
      int2 tk[4];
      int c[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint32_t* tw = reinterpret_cast<const uint32_t*>(s_words)
                             + (r0 + 8 * u + g) * NW + t;
        b0[u] = tw[swap * 4];
        b1[u] = tw[(swap ^ 1) * 4];
        tk[u] = *reinterpret_cast<const int2*>(s_key + r0 + 8 * u + 2 * t);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        c[u][0] = c[u][1] = c[u][2] = c[u][3] = 0;
        mma_and_popc(c[u], a, b0[u], b1[u]);
      }
      // C fragment: c0, c1 = row g, columns 2t, 2t + 1; c2, c3 = row g + 8.
      // key = (s_q + s_t - 2 popc(q & t)) << 16 | column
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        fold_key(k0_a, k1_a, qk_a + tk[u].x - (c[u][0] << 17));
        fold_key(k0_a, k1_a, qk_a + tk[u].y - (c[u][1] << 17));
        fold_key(k0_b, k1_b, qk_b + tk[u].x - (c[u][2] << 17));
        fold_key(k0_b, k1_b, qk_b + tk[u].y - (c[u][3] << 17));
      }
    }
  }

  // the quad's four lanes hold disjoint columns of the same two rows
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    const int a0 = __shfl_xor_sync(0xffffffffu, k0_a, off);
    const int a1 = __shfl_xor_sync(0xffffffffu, k1_a, off);
    const int b0 = __shfl_xor_sync(0xffffffffu, k0_b, off);
    const int b1 = __shfl_xor_sync(0xffffffffu, k1_b, off);
    k1_a = min(min(k1_a, a1), max(k0_a, a0));
    k0_a = min(k0_a, a0);
    k1_b = min(min(k1_b, b1), max(k0_b, b0));
    k0_b = min(k0_b, b0);
  }
  if (t == 0) {
    top2::store(out, row_a, best_of_keys(k0_a, k1_a, seg_begin));
    top2::store(out, row_b, best_of_keys(k0_b, k1_b, seg_begin));
  }
}

// scratch, in 32-bit units: words (rows * 8), bit counts as queries (rows)
// and as targets (rows), partials (splits * batch * nq * 3 when splits > 1)
int search(const float* desc_q, const float* desc_t, const uint8_t* valid_q,
           const uint8_t* valid_t, const int* pair_ij, int* scratch,
           long long scratch_ints, float* d0, float* d1, int* i0,
           long long rows_q, long long rows, int nq, int nt, int d, int batch,
           int pad_col, int rows_per_block, int splits, int seg,
           cudaStream_t stream) {
  if (d <= 0 || d > 32 * NW || nq <= 0 || nt <= 0 || batch <= 0 ||
      rows_per_block != (kThreads / 32) * kRowsPerWarp || splits <= 0 ||
      seg <= 0 ||
      seg % 8 != 0 || seg > kMaxSeg || (long long)splits * seg < nt || batch > 65535 ||
      splits > 65535 || rows > 0x7fffffffLL / 32)
    return (int)cudaErrorInvalidValue;
  const int row_blocks = (nq + rows_per_block - 1) / rows_per_block;
  const long long partial = splits > 1 ? 3LL * splits * batch * nq : 0;
  if (rows * (NW + 2) + partial > scratch_ints)
    return (int)cudaErrorInvalidValue;
  uint32_t* words = reinterpret_cast<uint32_t*>(scratch);
  int* count_q = scratch + rows * NW;
  int* count_t = count_q + rows;
  float* part = reinterpret_cast<float*>(scratch + rows * (NW + 2));

  pack_rows<<<(unsigned)((rows * 32 + 255) / 256), 256, 0, stream>>>(
      desc_q, desc_t, valid_q, valid_t, words, count_q, count_t, (int)rows_q,
      (int)rows, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const top2::Out out{d0, d1, i0, part, nq, nt, pad_col, splits, batch};
  const dim3 grid(row_blocks, splits, batch);
  two_nn_binary_kernel<<<grid, kThreads, 0, stream>>>(
      words, count_q, count_t, pair_ij, pair_ij ? 0 : nq, seg, out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)top2::merge_after(out, stream);
}

}  // namespace

// desc: (b, n, d) float32 {0,1} with d <= 256; valid: (b, n) uint8;
// pair_ij: (p, 2) int32; scratch: scratch_ints 32-bit units, 16-byte
// aligned (layout above, rows = b * n, batch = 2 p); outputs (p, 2, n).
// rows_per_block: 64, the query rows a block takes; splits x seg targets
// cover n. Returns cudaGetLastError().
extern "C" int two_nn_pairs_binary(const float* desc, const uint8_t* valid,
                                   const int* pair_ij, int* scratch,
                                   long long scratch_ints, float* d0,
                                   float* d1, int* i0, int b, int n, int d,
                                   int p, int pad_col, int rows_per_block,
                                   int splits, int seg, cudaStream_t stream) {
  if (b <= 0 || p <= 0) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)b * n;
  return search(desc, desc, valid, valid, pair_ij, scratch, scratch_ints, d0,
                d1, i0, rows, rows, n, n, d, 2 * p, pad_col, rows_per_block,
                splits, seg, stream);
}

// desc_q: (nq, d) and desc_t: (nt, d) float32 {0,1} with d <= 256;
// valid_t: (nt,) uint8; scratch as above with rows = nq + nt, batch = 1;
// outputs (nq,). Returns cudaGetLastError().
extern "C" int two_nn_binary(const float* desc_q, const float* desc_t,
                             const uint8_t* valid_t, int* scratch,
                             long long scratch_ints, float* d0, float* d1,
                             int* i0, int nq, int nt, int d, int pad_col,
                             int rows_per_block, int splits, int seg,
                             cudaStream_t stream) {
  return search(desc_q, desc_t, nullptr, valid_t, nullptr, scratch,
                scratch_ints, d0, d1, i0, nq, (long long)nq + nt, nq, nt, d, 1,
                pad_col, rows_per_block, splits, seg, stream);
}
