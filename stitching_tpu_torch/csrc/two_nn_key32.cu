// The binary 2-NN pairs search as it stood before the 16-bit window fold of
// two_nn.cu: a measurement aid, not called by the port. chip_smoke.py's
// phase split times its phases beside two_nn.cu's on the same inputs.
//
// Design (two_nn.cu's notes hold the contract): a ballot pre-pass packs
// each {0,1} float row into NW words (`pack_rows`); the search stages the
// target rows 32 KB at a time in static shared memory with 16-byte
// `cp.async` copies, waits for the whole chunk, and folds every distance
// into a running (smallest, second smallest) 32-bit key dist << 16 |
// column, three min/max instructions a distance after building the key.
// A block is 4 warps of 16 query rows.
//
// Entry: `two_nn_pairs_binary_key32_phase(phase, ...)`, the arguments of
// two_nn.cu's `two_nn_pairs_binary` after `phase`: 0 the whole call, 1 the
// pre-pass, 2 the search, 3 the search with the fold left out, 4 the merge
// of split segments. Phases 2-4 read the scratch an earlier whole call
// left.

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
template <int NW, bool kFold>
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
  int live[4] = {};   // without the fold: keeps the products alive
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
      if (!kFold) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          live[u] ^= c[u][0] ^ c[u][1] ^ c[u][2] ^ c[u][3];
        continue;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        fold_key(k0_a, k1_a, qk_a + tk[u].x - (c[u][0] << 17));
        fold_key(k0_a, k1_a, qk_a + tk[u].y - (c[u][1] << 17));
        fold_key(k0_b, k1_b, qk_b + tk[u].x - (c[u][2] << 17));
        fold_key(k0_b, k1_b, qk_b + tk[u].y - (c[u][3] << 17));
      }
    }
  }

  if (!kFold) {
    // never true (popc sums are small): keeps the products alive
    if ((live[0] ^ live[1] ^ live[2] ^ live[3]) == 0x7fffffff) out.d0[0] = 0.f;
    return;
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

// scratch, in 32-bit units: words (rows * NW), bit counts as queries (rows)
// and as targets (rows), partials (splits * batch * nq * 3 when splits > 1)
template <int NW>
int search_nw(int phase, const float* desc_q, const float* desc_t,
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

  if (phase == 0 || phase == 1)
    pack_rows<NW><<<(unsigned)((rows * 32 + 255) / 256), 256, 0, stream>>>(
        desc_q, desc_t, valid_q, valid_t, words, count_q, count_t,
        (int)rows_q, (int)rows, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const top2::Out out{d0, d1, i0, part, nq, nt, pad_col, splits, batch};
  const dim3 grid((nq + rows_per_block - 1) / rows_per_block, splits, batch);
  if (phase == 0 || phase == 2)
    two_nn_binary_kernel<NW, true><<<grid, kThreads, 0, stream>>>(
        words, count_q, count_t, pair_ij, pair_ij ? 0 : nq, seg, out);
  if (phase == 3)
    two_nn_binary_kernel<NW, false><<<grid, kThreads, 0, stream>>>(
        words, count_q, count_t, pair_ij, pair_ij ? 0 : nq, seg, out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return phase == 0 || phase == 4 ? (int)top2::merge_after(out, stream) : 0;
}

}  // namespace

extern "C" int two_nn_pairs_binary_key32_phase(
    int phase, const float* desc, const uint8_t* valid, const int* pair_ij,
    int* scratch, long long scratch_ints, float* d0, float* d1, int* i0,
    int b, int n, int d, int p, int pad_col, int rows_per_block, int splits,
    int seg, cudaStream_t stream) {
  const long long rows = (long long)b * n;
  const int nw = d <= 256 ? 8 : 16;
  if (phase < 0 || phase > 4 || b <= 0 || p <= 0 || d <= 0 || d > 512 ||
      n <= 0 || rows_per_block != (kThreads / 32) * kRowsPerWarp ||
      splits <= 0 || seg <= 0 || seg % 8 != 0 || seg > kMaxSeg ||
      (long long)splits * seg < n || 2 * p > 65535 ||
      rows * (nw + 2) + (splits > 1 ? 6LL * splits * p * n : 0) >
          scratch_ints)
    return (int)cudaErrorInvalidValue;
  return nw == 8
      ? search_nw<8>(phase, desc, desc, valid, valid, pair_ij, scratch, d0,
                     d1, i0, rows, rows, n, n, d, 2 * p, pad_col, splits, seg,
                     stream)
      : search_nw<16>(phase, desc, desc, valid, valid, pair_ij, scratch, d0,
                      d1, i0, rows, rows, n, n, d, 2 * p, pad_col, splits,
                      seg, stream);
}
