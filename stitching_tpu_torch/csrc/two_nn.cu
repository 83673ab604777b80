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
// - Rows of up to 512 bits: ORB's 256, BRISK's 512 and AKAZE's 486 (the
//   Pallas kernel takes any width). Everything below is templated on NW,
//   the 32-bit words of a packed row: 8 for d <= 256, 16 for d <= 512; a
//   call picks NW from d, and narrower rows are zero-padded.
// - A pre-pass (`pack_rows`, one launch for every operand row of a call)
//   packs each {0,1} float row into NW 32-bit words, one warp a row and one
//   `__ballot_sync` per 32 columns, so the reads coalesce. It also writes
//   each row's bit count s, once plain (the query's term) and once as a
//   target (2048 if invalid).
// - Distances by the 1-bit tensor-core product
//   `mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc`: one
//   instruction gives popc(q & t) over 256 bits for 16 query rows x 8
//   targets; at 512 bits two of them accumulate into one C fragment.
//   Hamming = s_q + s_t - 2 popc(q & t), exact in int32.
//   (`.xor.popc` is deprecated for sm_90; `.and.popc` assembles for sm_90a.
//   The int8 form m16n8k32 on {0,1} bytes was built and measured too: it
//   needs 8 instructions and 8 times the bytes for the same tile, each
//   instruction as slow as the 1-bit one (scripts/probe_mma_rate.cu), and
//   was slower at every grid, see PERF.md. The
//   form is a choice made when the kernel was designed, not a switch at
//   run time. `wgmma` is not needed: a warp's strip of 16 x 500 is 63
//   instructions.)
// - A warp owns 16 query rows: its A fragments (NW / 2 registers a thread) stay
//   in registers while it walks the block's target segment in increasing
//   column order, 4 tiles of 8 columns a step, so that four independent
//   `mma`s and their loads are in flight at once (a scheduler starts one
//   `mma` about every 6 clocks, but only from independent chains).
// - Targets are staged in shared memory 32 KB of words at a time (1024
//   rows of 32 B, or 512 of 64 B, and a key a row: under the 48 KB of
//   static shared memory) with 16-byte `cp.async` copies, any nt chunk by
//   chunk. A row's 16-byte quarters are permuted by the row's place in its
//   tile (`swz`) so that the B fragments' loads (8 rows x 4 words a warp)
//   touch 32 different banks at both widths.
// - The fold is integer and free of branches: key = dist << 16 | (column -
//   segment start), and a running (smallest, second smallest) key per row
//   is three min/max instructions a distance. Keys are distinct, so the
//   smallest key is the lowest column of the smallest distance and the
//   second smallest key's distance is the minimum over the other columns:
//   the contract's tie rule. An invalid target counts 2048 bits, which
//   puts its distance at 1536 or more, past any valid distance (at most
//   512); a segment is at most 65536 columns.
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

constexpr int kRowsPerWarp = 16;   // the mma's m
constexpr int kThreads = 128;      // 4 warps
constexpr int kStageBytes = 32768; // target words staged at a time
constexpr int kStep = 32;          // targets a step: 4 mma tiles of 8
// a target's bit count when it is invalid: an invalid target's distance is
// then at least kInvalidCount - 512 = 1536 and a valid one's at most 512
constexpr int kInvalidCount = 2048;
constexpr int kInvalidDist = 1536;   // distances from here on are invalid targets
constexpr int kNoDist = 0x2000;      // distances from here on are no column at all
constexpr int kNoKey = 0x7fffffff;
constexpr int kPadKey = 0x3fff0000;  // a chunk's columns past the segment's end
constexpr int kMaxSeg = 1 << 16;
// the largest key: distance s_q + kInvalidCount <= 2560 or a pad key's
// s_q + 0x3fff, shifted by 16, plus a column; both stay below 2^31
static_assert((512 + 0x3fff + 1LL) << 16 < 0x7fffffffLL, "key overflow");
static_assert(kInvalidCount - 512 >= kInvalidDist && kInvalidDist > 512,
              "valid and invalid distances overlap");
static_assert(kInvalidCount + 512 < kNoDist, "invalid and pad keys overlap");

// One warp per operand row, NW 32-bit words a row (8: up to 256 bits, 16:
// up to 512). Rows [0, rows_q) come from desc_q, the rest from desc_t;
// valid_q / valid_t may be null (all valid).
template <int NW>
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

__device__ __forceinline__ void mma_and_popc(int (&c)[4], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
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

// A row of NW words is Q = NW / 4 quarters of 16 bytes. In shared memory
// row r keeps its quarter q at position q ^ swz(r), so that the B
// fragments' loads (8 rows x 4 words a warp, one quarter at a time) touch
// 32 different banks: rows r and r + 1 of a tile sit in the two 16-word
// halves of the banks at NW = 16 (and in one half at NW = 8), and swz
// spreads the rows that share a half over its Q quarters.
template <int NW>
__device__ __forceinline__ int swz(int r) {
  return NW == 8 ? (r >> 2) & 1 : (r >> 1) & 3;
}

// words, count_q, count_t: the pre-pass's outputs, indexed by operand row.
// A pair's query image qi starts at operand row qi * nq and its target
// image at ti * nt; without a pair list the queries start at row 0 and the
// targets at row t_base. seg: targets per blockIdx.y, a multiple of 8, at
// most kMaxSeg.
template <int NW>
__global__ void __launch_bounds__(kThreads)
two_nn_binary_kernel(const uint32_t* __restrict__ words,
                     const int* __restrict__ count_q,
                     const int* __restrict__ count_t,
                     const int* __restrict__ pair_ij, int t_base, int seg,
                     top2::Out out) {
  constexpr int Q = NW / 4;                  // 16-byte quarters a row
  constexpr int K = NW / 8;                  // m16n8k256 products a tile
  constexpr int kChunk = kStageBytes / (NW * 4);   // 1024 or 512 targets
  __shared__ uint4 s_words[kChunk * Q];
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
  const int t = lane % 4;   // word of each quarter (A, B), column pair (C)
  constexpr int rows_per_block = (kThreads / 32) * kRowsPerWarp;
  const int row_a = blockIdx.x * rows_per_block + warp * kRowsPerWarp + g;
  const int row_b = row_a + 8;

  // A fragments, one per 256 bits k: a[4k] = (row g, word 8k + t),
  // a[4k + 1] = (row g + 8, word 8k + t), a[4k + 2] = (row g, word 8k + 4
  // + t), a[4k + 3] = (row g + 8, word 8k + 4 + t); and each row's bit
  // count, shifted to the key's distance field
  uint32_t a[4 * K];
#pragma unroll
  for (int i = 0; i < 4 * K; ++i) a[i] = 0u;
  int qk_a = 0, qk_b = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (row_a < nq) {
      a[4 * k] = q_words[(long long)row_a * NW + 8 * k + t];
      a[4 * k + 2] = q_words[(long long)row_a * NW + 8 * k + 4 + t];
    }
    if (row_b < nq) {
      a[4 * k + 1] = q_words[(long long)row_b * NW + 8 * k + t];
      a[4 * k + 3] = q_words[(long long)row_b * NW + 8 * k + 4 + t];
    }
  }
  if (row_a < nq) qk_a = count_q[q_off + row_a] << 16;
  if (row_b < nq) qk_b = count_q[q_off + row_b] << 16;

  int k0_a = kNoKey, k1_a = kNoKey, k0_b = kNoKey, k1_b = kNoKey;
  const int seg_begin = blockIdx.y * seg;
  const int seg_end = min(nt, seg_begin + seg);
  const int sw = swz<NW>(g);   // the tile's rows start at multiples of 8

  for (int c0 = seg_begin; c0 < seg_end; c0 += kChunk) {
    const int cnt = min(kChunk, seg_end - c0);
    const int padded = (cnt + kStep - 1) / kStep * kStep;
    __syncthreads();
    // stage: Q x 16 bytes a row, zero rows and keys that never win up to a
    // whole step
    for (int e = threadIdx.x; e < padded * Q; e += kThreads) {
      const int r = e / Q, quarter = e % Q;
      cp_async16(s_words + r * Q + (quarter ^ swz<NW>(r)),
                 t_words + (r < cnt ? (long long)(c0 + r) * Q + quarter : 0),
                 r < cnt);
    }
    for (int e = threadIdx.x; e < padded; e += kThreads)
      s_key[e] = e < cnt ? (t_count[c0 + e] << 16) + (c0 - seg_begin + e)
                         : kPadKey + e;
    cp_async_wait_all();
    __syncthreads();

    for (int r0 = 0; r0 < padded; r0 += kStep) {
      // B fragments of 4 tiles: b[u][q] = (word 4q + t, column g); and the
      // keys of this thread's 2 columns of each
      uint32_t b[4][Q];
      int2 tk[4];
      int c[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint32_t* tw = reinterpret_cast<const uint32_t*>(s_words)
                             + (r0 + 8 * u + g) * NW + t;
#pragma unroll
        for (int q = 0; q < Q; ++q) b[u][q] = tw[(q ^ sw) * 4];
        tk[u] = *reinterpret_cast<const int2*>(s_key + r0 + 8 * u + 2 * t);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        c[u][0] = c[u][1] = c[u][2] = c[u][3] = 0;
#pragma unroll
        for (int k = 0; k < K; ++k)
          mma_and_popc(c[u], a[4 * k], a[4 * k + 1], a[4 * k + 2],
                       a[4 * k + 3], b[u][2 * k], b[u][2 * k + 1]);
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

// the words a packed row takes: 8 for up to 256 bits, 16 for up to 512
inline int words_per_row(int d) { return d <= 256 ? 8 : 16; }

// scratch, in 32-bit units: words (rows * NW), bit counts as queries (rows)
// and as targets (rows), partials (splits * batch * nq * 3 when splits > 1)
template <int NW>
int search_nw(const float* desc_q, const float* desc_t,
              const uint8_t* valid_q, const uint8_t* valid_t,
              const int* pair_ij, int* scratch, float* d0, float* d1,
              int* i0, long long rows_q, long long rows, int nq, int nt,
              int d, int batch, int pad_col, int splits, int seg,
              cudaStream_t stream) {
  uint32_t* words = reinterpret_cast<uint32_t*>(scratch);
  int* count_q = scratch + rows * NW;
  int* count_t = count_q + rows;
  float* part = reinterpret_cast<float*>(scratch + rows * (NW + 2));
  constexpr int rows_per_block = (kThreads / 32) * kRowsPerWarp;

  pack_rows<NW><<<(unsigned)((rows * 32 + 255) / 256), 256, 0, stream>>>(
      desc_q, desc_t, valid_q, valid_t, words, count_q, count_t, (int)rows_q,
      (int)rows, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const top2::Out out{d0, d1, i0, part, nq, nt, pad_col, splits, batch};
  const dim3 grid((nq + rows_per_block - 1) / rows_per_block, splits, batch);
  two_nn_binary_kernel<NW><<<grid, kThreads, 0, stream>>>(
      words, count_q, count_t, pair_ij, pair_ij ? 0 : nq, seg, out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)top2::merge_after(out, stream);
}

int search(const float* desc_q, const float* desc_t, const uint8_t* valid_q,
           const uint8_t* valid_t, const int* pair_ij, int* scratch,
           long long scratch_ints, float* d0, float* d1, int* i0,
           long long rows_q, long long rows, int nq, int nt, int d, int batch,
           int pad_col, int rows_per_block, int splits, int seg,
           cudaStream_t stream) {
  if (d <= 0 || d > 512 || nq <= 0 || nt <= 0 || batch <= 0 ||
      rows_per_block != (kThreads / 32) * kRowsPerWarp || splits <= 0 ||
      seg <= 0 ||
      seg % 8 != 0 || seg > kMaxSeg || (long long)splits * seg < nt || batch > 65535 ||
      splits > 65535 || rows > 0x7fffffffLL / 32)
    return (int)cudaErrorInvalidValue;
  const int nw = words_per_row(d);
  const long long partial = splits > 1 ? 3LL * splits * batch * nq : 0;
  if (rows * (nw + 2) + partial > scratch_ints)
    return (int)cudaErrorInvalidValue;
  return nw == 8
      ? search_nw<8>(desc_q, desc_t, valid_q, valid_t, pair_ij, scratch, d0,
                     d1, i0, rows_q, rows, nq, nt, d, batch, pad_col, splits,
                     seg, stream)
      : search_nw<16>(desc_q, desc_t, valid_q, valid_t, pair_ij, scratch, d0,
                      d1, i0, rows_q, rows, nq, nt, d, batch, pad_col, splits,
                      seg, stream);
}

}  // namespace

// desc: (b, n, d) float32 {0,1} with d <= 512; valid: (b, n) uint8;
// pair_ij: (p, 2) int32; scratch: scratch_ints 32-bit units, 16-byte
// aligned (layout above, rows = b * n, batch = 2 p, NW = 8 for d <= 256
// and 16 above); outputs (p, 2, n). rows_per_block: 64, the query rows a
// block takes; splits x seg targets cover n. Returns cudaGetLastError().
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

// desc_q: (nq, d) and desc_t: (nt, d) float32 {0,1} with d <= 512;
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
