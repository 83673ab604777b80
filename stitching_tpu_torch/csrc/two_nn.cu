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
// What bounds it on the H100: at the matchers' shapes (8 images of 500
// rows of 256 bits for ORB, 8 of 1024 rows of 512 bits for BRISK and
// AKAZE; 28 pairs) the call reads 4.1 or 16.8 MB of {0,1} float rows and
// computes 28 * 2 * n^2 distances (14 M or 58.7 M). The distances come
// from the 1-bit tensor-core product, whose rate (21,703 bit products a
// clock an SM, scripts/probe_mma_rate.cu) puts them under 0.4 or 3 us, so
// the bound is the bytes: 1.3 or 5.2 us. What the card spends beyond it is
// the integer work of keeping each row's top-2 (every distance passes
// through it), staging the target rows, and the two launches.
//
// Design:
// - Rows of up to 512 bits. Everything is templated on NW, the 32-bit
//   words of a packed row: 8 for d <= 256, 16 for d <= 512.
// - A pre-pass (`pack_rows`, one launch for every operand row of a call)
//   packs each {0,1} float row into NW words, one warp a row: each lane
//   reads 16 bytes at a time where the rows allow it, and one
//   `__ballot_sync` per component makes a word. Bit k of word w holds
//   column 128 (w / 4) + 4 k + w % 4: any order of the bits that every row
//   shares gives the same distances. Each word is stored where the `mma`
//   fragments read it: the k-word kw = 4 q + t at position t * NW / 4 + q,
//   so a thread's B fragment of a row is one 8- or 16-byte load. The
//   pre-pass also writes each row's bit count, once as a query and once as
//   a target (2 * 32 NW + 1 if invalid).
// - Distances by `mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc`
//   (popc(q & t) over 256 bits for 16 query rows x 8 targets; two
//   accumulate at 512 bits): dist = s_q + s_t - 2 popc(q & t). A block is 4
//   warps; a warp keeps the A fragments of one tile of 16 query rows in
//   registers, or of four at 16 words a row (`launch_plan`: rows of 64
//   bytes cost twice the shared-memory reads per distance of rows of 32,
//   and four tiles share each B fragment and column term a warp reads).
// - Staging: a block copies its target segment into dynamic shared memory
//   up to 1024 rows at a time (64 KB at 512 bits), in sub-chunks of 256
//   rows, each one bulk copy (`cp.async.bulk`) completing on an `mbarrier`
//   of its own, so the first window's products start while the rest of
//   the chunk lands. The packed layout needs no swizzle: the B loads of a
//   warp read 2 (or 4) whole consecutive rows a phase, 32 different banks.
// - The fold, on 16-bit keys. One thread holds rows g and g + 8 at the
//   same column (C fragments c0 and c2), so it keeps both rows' keys in
//   the two halves of one register and folds them with one DPX instruction
//   (`__vimin3_u16x2` and the 2-way min/max on 16-bit pairs). A key is
//   (s_t + B - 2 popc) << S | lc, where B = 32 NW: within a row it orders
//   like the distance (s_q is a constant of the row) and never goes below
//   0, so the two rows' keys come from one 32-bit expression without a
//   borrow between the halves: the column's term, duplicated into both
//   halves at staging, minus the two products shifted. lc numbers the
//   thread's own columns in a window of 2^S / 8 steps (S = 6 at 256 bits,
//   5 at 512: the largest key, (3 B + 1) << S plus lc, stays in 16 bits).
//   Two keys of a column pair fold into the running (smallest, second
//   smallest) pair in five DPX instructions. An invalid target counts 2 B
//   + 1 bits, which puts its key past every valid one; the rows a step
//   reads past the segment's end count as invalid targets too (the
//   contract's padded columns, or more of the invalid ones it has
//   already: they change no result).
// - At the end of a window the pair becomes 32-bit keys field << 16 |
//   (the thread's own column number) and joins the row's running top-2;
//   at the end the thread's column numbers become segment columns, and the
//   4 lanes of a quad merge their keys by shuffles. Keys are distinct, so
//   the smallest key is the lowest column of the smallest distance and the
//   second smallest key's distance is the minimum over the other columns:
//   the contract's tie rule. They become top2.cuh's (d0, d1, i0): 1e30 for
//   an invalid distance, with i0 the segment's first column when even the
//   nearest is invalid.
// - Where the query rows give too few blocks for the card the wrapper
//   splits the target axis over blockIdx.y (ops/kernels/two_nn.py::
//   launch_plan) and a small third launch merges the segments' partial
//   results (top2.cuh); else a call is two launches.
// - Both directions of a pair compute their own product. Sharing one (the
//   backward distances are the forward's transpose) needs a column-wise
//   top-2 across blocks; the bound keeps counting one product a pair.
//
// `two_nn_pairs_binary_phase` runs one phase of a pairs call (a
// measurement aid: chip_smoke.py's phase split). PERF.md keeps the times.

#include <cuda_runtime.h>
#include <stdint.h>

#include "top2.cuh"

namespace {

constexpr int kRowsPerWarp = 16;   // the mma's m
constexpr int kThreads = 128;      // 4 warps
constexpr int kStep = 32;          // targets a step: 4 mma tiles of 8
constexpr int kChunk = 1024;       // targets staged at a time, at most
constexpr int kSubRows = 256;      // targets a bulk copy and its barrier
constexpr int kSubs = kChunk / kSubRows;
constexpr int kMaxSeg = 1 << 16;
constexpr uint32_t kNoKey = 0xffffffffu;

// the constants of a packed row of NW words
template <int NW>
struct Width {
  static constexpr int kBits = 32 * NW;
  static constexpr int kInvalid = 2 * kBits + 1;   // an invalid target's count
  static constexpr int kShift = NW == 8 ? 6 : 5;   // column bits of a key
  static constexpr int kWin = (1 << kShift) / 8;   // steps a window
  static constexpr int kQ = NW / 4;                // words of a fragment row
  // the largest key: count s_t = kInvalid, no common bit, the last column
  static_assert(((3 * kBits + 1) << kShift) + (1 << kShift) - 1 <= 0xffff,
                "a key must fit in 16 bits");
  static_assert(kSubRows % (32 * kWin) == 0, "windows straddle a copy");
};

// One warp per operand row. Rows [0, rows_q) come from desc_q, the rest
// from desc_t; valid_q / valid_t may be null (all valid). kVec: the rows
// start 16-byte aligned (d % 4 == 0) and are read 16 bytes a lane.
template <int NW, bool kVec>
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
  for (int i = 0; i < NW / 4; ++i) {
    const int c = 128 * i + 4 * lane;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (kVec) {
      if (c < d) v = *reinterpret_cast<const float4*>(src + c);
    } else {
      if (c < d) v.x = src[c];
      if (c + 1 < d) v.y = src[c + 1];
      if (c + 2 < d) v.z = src[c + 2];
      if (c + 3 < d) v.w = src[c + 3];
    }
    const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t word = __ballot_sync(0xffffffffu, f[j] > 0.5f);
      const int kw = 4 * i + j;
      s += __popc(word);
      if (lane == (kw % 4) * (NW / 4) + kw / 4) mine = word;
    }
  }
  if (lane < NW) words[(long long)row * NW + lane] = mine;
  if (lane == 0) {
    const uint8_t* v = is_q ? valid_q : valid_t;
    const bool ok = v == nullptr || v[is_q ? row : row - rows_q] != 0;
    count_q[row] = s;
    count_t[row] = ok ? s : Width<NW>::kInvalid;
  }
}

__device__ __forceinline__ void mma_and_popc(int (&c)[4], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(1) : "memory");
}

// one bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// that completes on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%2], [%3], %1, [%0];\n"
      :: "r"(smem_addr(bar)), "r"(bytes), "r"(smem_addr(dst)), "l"(src)
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// running smallest (k0) and second smallest (k1) of two rows' 16-bit keys
// (the halves of each register), joined by the keys x and y of two more
// columns: five DPX instructions
__device__ __forceinline__ void fold2(uint32_t& k0, uint32_t& k1, uint32_t x,
                                      uint32_t y) {
  const uint32_t lo = __vminu2(x, y), hi = __vmaxu2(x, y);
  k1 = __vimin3_u16x2(k1, __vmaxu2(k0, lo), hi);
  k0 = __vminu2(k0, lo);
}

// the same on one row's 32-bit keys: (k0, k1) joined by the pair x < y
__device__ __forceinline__ void merge_pair(uint32_t& k0, uint32_t& k1,
                                           uint32_t x, uint32_t y) {
  k1 = __vimin3_u32(k1, max(k0, x), y);
  k0 = min(k0, x);
}

// a window's 16-bit key as a 32-bit one: field << 16 | the thread's own
// column number (`own`: its windows so far, times 2^S)
template <int S>
__device__ __forceinline__ uint32_t widen(uint32_t v, uint32_t own) {
  return ((v >> S) << 16) | (own + (v & ((1u << S) - 1)));
}

// the thread's own column number as a column of the segment: window
// own >> S, then step lc >> 3, tile (lc >> 1) & 3, quad lane t, lc & 1
template <int S>
__device__ __forceinline__ uint32_t to_column(uint32_t key, int t) {
  const uint32_t own = key & 0xffffu, lc = own & ((1u << S) - 1);
  return (key & 0xffff0000u) |
         (((own >> S) << (S + 2)) + ((lc >> 3) << 5) +
          (((lc >> 1) & 3) << 3) + 2 * t + (lc & 1));
}

template <int NW>
__device__ __forceinline__ top2::Best best_of_keys(uint32_t k0, uint32_t k1,
                                                   int s_q, int seg_begin) {
  constexpr int B = Width<NW>::kBits;
  const int dist0 = (int)(k0 >> 16) + s_q - B;
  const int dist1 = (int)(k1 >> 16) + s_q - B;
  top2::Best b;
  b.d0 = dist0 <= B ? (float)dist0 : top2::kBig;
  b.d1 = dist1 <= B ? (float)dist1 : top2::kBig;
  // with even the nearest invalid, every column of the segment is
  b.i0 = seg_begin + (dist0 <= B ? (int)(k0 & 0xffffu) : 0);
  return b;
}

template <int Q>
__device__ __forceinline__ void load_words(uint32_t (&w)[Q],
                                           const uint32_t* src) {
  if constexpr (Q == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    w[0] = v.x, w[1] = v.y;
  }
}

// words, count_q, count_t: the pre-pass's outputs, indexed by operand row.
// A pair's query image qi starts at operand row qi * nq and its target
// image at ti * nt; without a pair list the queries start at row 0 and the
// targets at row t_base. seg: targets per blockIdx.y, a multiple of 8, at
// most kMaxSeg. chunk: the target rows shared memory holds, a multiple of
// kSubRows. A warp owns MT tiles of 16 query rows, which share every B
// fragment and column term it loads. kFold false leaves the fold out (a
// measurement aid).
template <int NW, int MT, bool kFold>
__global__ void __launch_bounds__(kThreads)
two_nn_binary_kernel(const uint32_t* __restrict__ words,
                     const int* __restrict__ count_q,
                     const int* __restrict__ count_t,
                     const int* __restrict__ pair_ij, int t_base, int seg,
                     int chunk, top2::Out out) {
  using W = Width<NW>;
  constexpr int Q = W::kQ, K = NW / 8, S = W::kShift;
  constexpr int kWinRows = kStep * W::kWin;   // targets a window
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* s_words = smem;                 // chunk rows of NW words
  uint32_t* s_key = smem + chunk * NW;      // a column's term, both halves
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(s_key + chunk);

  const int nq = out.nq, nt = out.nt;
  const int dir = blockIdx.z & 1;
  const int p = blockIdx.z >> 1;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // fragment row (A, C) and column (B)
  const int t = lane % 4;   // word of each half (A, B), column pair (C)
  // tile m's rows: row0 + 16 m + g and row0 + 16 m + g + 8
  const int row0 =
      (blockIdx.x * (kThreads / 32) + warp) * kRowsPerWarp * MT + g;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kSubs; ++i) bar_init(s_bar + i);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }

  const long long q_off = pair_ij ? (long long)pair_ij[2 * p + dir] * nq : 0;
  const long long t_off = pair_ij ? (long long)pair_ij[2 * p + 1 - dir] * nt
                                  : t_base;
  const uint32_t* q_words = words + q_off * NW;
  const uint32_t* t_words = words + t_off * NW;
  const int* t_count = count_t + t_off;

  // A fragments of tile m, one per 256 bits k: a[m][4k] = (row g, k-word
  // 8k + t), a[m][4k + 1] = (row g + 8, 8k + t), a[m][4k + 2] = (row g,
  // 8k + 4 + t), a[m][4k + 3] = (row g + 8, 8k + 4 + t): positions t Q + 2k
  // and + 1 of the packed row
  uint32_t a[MT][4 * K];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    uint32_t qa[Q], qb[Q];
#pragma unroll
    for (int i = 0; i < Q; ++i) qa[i] = qb[i] = 0u;
    const int ra = row0 + 16 * m, rb = ra + 8;
    if (ra < nq) load_words<Q>(qa, q_words + (long long)ra * NW + t * Q);
    if (rb < nq) load_words<Q>(qb, q_words + (long long)rb * NW + t * Q);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      a[m][4 * k] = qa[2 * k];
      a[m][4 * k + 1] = qb[2 * k];
      a[m][4 * k + 2] = qa[2 * k + 1];
      a[m][4 * k + 3] = qb[2 * k + 1];
    }
  }

  // each row's running (smallest, second smallest) 32-bit key: [m][0] row
  // g of tile m, [m][1] row g + 8
  uint32_t k0[MT][2], k1[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
    k0[m][0] = k0[m][1] = k1[m][0] = k1[m][1] = kNoKey;
  uint32_t own = 0;      // the thread's own columns before this window
  uint32_t parity = 0;   // bit i: the phase barrier i completes next
  int live[4] = {};      // without the fold: keeps the products alive
  const int seg_begin = blockIdx.y * seg;
  const int seg_end = min(nt, seg_begin + seg);

  for (int c0 = seg_begin; c0 < seg_end; c0 += chunk) {
    const int cnt = min(chunk, seg_end - c0);
    // whole steps: the rows past cnt are read but count as invalid
    const int padded = (cnt + kStep - 1) / kStep * kStep;
    const int subs = (cnt + kSubRows - 1) / kSubRows;
    __syncthreads();   // every thread is done with the last chunk
    if (threadIdx.x == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      for (int i = 0; i < subs; ++i) {
        const int r = i * kSubRows;
        bulk_copy(s_words + r * NW, t_words + (long long)(c0 + r) * NW,
                  (unsigned)(min(kSubRows, cnt - r) * NW * 4), s_bar + i);
      }
    }
    // a column's term (s_t + B) << S | lc in both halves; rows past the
    // segment's end count as invalid targets
    for (int e = threadIdx.x; e < padded; e += kThreads) {
      const int s_t = e < cnt ? t_count[c0 + e] : W::kInvalid;
      const uint32_t lc = ((e >> 5) % W::kWin) * 8 + ((e >> 3) & 3) * 2 +
                          (e & 1);
      const uint32_t v = ((uint32_t)(s_t + W::kBits) << S) | lc;
      s_key[e] = v | (v << 16);
    }
    __syncthreads();

    for (int w0 = 0; w0 < padded; w0 += kWinRows) {
      if (w0 % kSubRows == 0)
        bar_wait(s_bar + w0 / kSubRows, (parity >> (w0 / kSubRows)) & 1);
      // the window's 16-bit pairs of tile m: row g low, row g + 8 high
      uint32_t w0k[MT], w1k[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) w0k[m] = w1k[m] = kNoKey;
      // one step: 4 tiles of 8 targets from row r0 against every tile of
      // query rows, folded into the window's pairs
      auto step = [&](int r0) {
        uint32_t bw[4][Q];
        uint2 tk[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          load_words<Q>(bw[u], s_words + (r0 + 8 * u + g) * NW + t * Q);
          tk[u] = *reinterpret_cast<const uint2*>(s_key + r0 + 8 * u + 2 * t);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          int c[4][4] = {};
#pragma unroll
          for (int k = 0; k < K; ++k)
#pragma unroll
            for (int u = 0; u < 4; ++u)
              mma_and_popc(c[u], a[m][4 * k], a[m][4 * k + 1],
                           a[m][4 * k + 2], a[m][4 * k + 3], bw[u][2 * k],
                           bw[u][2 * k + 1]);
          // C fragment: c0, c1 = row g, columns 2t, 2t + 1; c2, c3 = row
          // g + 8. Each half stays >= 0: no borrow crosses between them.
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (!kFold) {
              live[u] ^= c[u][0] ^ c[u][1] ^ c[u][2] ^ c[u][3];
              continue;
            }
            const uint32_t x = tk[u].x - ((uint32_t)c[u][0] << (S + 1)) -
                               ((uint32_t)c[u][2] << (S + 17));
            const uint32_t y = tk[u].y - ((uint32_t)c[u][1] << (S + 1)) -
                               ((uint32_t)c[u][3] << (S + 17));
            fold2(w0k[m], w1k[m], x, y);
          }
        }
      };
      if (w0 + kWinRows <= padded) {
#pragma unroll
        for (int ws = 0; ws < W::kWin; ++ws) step(w0 + kStep * ws);
      } else {   // the segment's last window, in whole steps
        for (int r0 = w0; r0 < padded; r0 += kStep) step(r0);
      }
      if (kFold) {
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          merge_pair(k0[m][0], k1[m][0], widen<S>(w0k[m] & 0xffffu, own),
                     widen<S>(w1k[m] & 0xffffu, own));
          merge_pair(k0[m][1], k1[m][1], widen<S>(w0k[m] >> 16, own),
                     widen<S>(w1k[m] >> 16, own));
        }
      }
      own += 1u << S;
    }
    for (int i = 0; i < subs; ++i) parity ^= 1u << i;
  }

  if (!kFold) {
    // never true (popc sums are small): keeps the products alive
    if ((live[0] ^ live[1] ^ live[2] ^ live[3]) == 0x7fffffff) out.d0[0] = 0.f;
    return;
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // a segment past the targets (only a forced grid has one) holds no
      // key at all
      const bool none = k0[m][h] == kNoKey;
      uint32_t x0 = none ? kNoKey : to_column<S>(k0[m][h], t);
      uint32_t x1 = none ? kNoKey : to_column<S>(k1[m][h], t);
      // the quad's four lanes hold disjoint columns of the same row
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const uint32_t o0 = __shfl_xor_sync(0xffffffffu, x0, off);
        const uint32_t o1 = __shfl_xor_sync(0xffffffffu, x1, off);
        x1 = __vimin3_u32(x1, o1, max(x0, o0));
        x0 = min(x0, o0);
      }
      const int row = row0 + kRowsPerWarp * m + 8 * h;
      if (t == 0 && row < nq)
        top2::store(out, row,
                    none ? top2::empty()
                         : best_of_keys<NW>(x0, x1, count_q[q_off + row],
                                            seg_begin));
    }
  }
}

// the words a packed row takes: 8 for up to 256 bits, 16 for up to 512
inline int words_per_row(int d) { return d <= 256 ? 8 : 16; }

// the target rows a block stages at a time: its segment, rounded up to a
// bulk copy, at most kChunk
inline int chunk_rows(int seg) {
  const int whole = (seg + kSubRows - 1) / kSubRows * kSubRows;
  return whole < kChunk ? whole : kChunk;
}

template <int NW, int MT, bool kFold>
cudaError_t launch_search(dim3 grid, int chunk, cudaStream_t stream,
                          const uint32_t* words, const int* count_q,
                          const int* count_t, const int* pair_ij, int t_base,
                          int seg, const top2::Out& out) {
  auto kernel = two_nn_binary_kernel<NW, MT, kFold>;
  const int smem = chunk * (NW + 1) * 4 + kSubs * 8;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kChunk * (NW + 1) * 4 + kSubs * 8);
  if (attr != cudaSuccess) return attr;
  kernel<<<grid, kThreads, smem, stream>>>(words, count_q, count_t, pair_ij,
                                          t_base, seg, chunk, out);
  return cudaGetLastError();
}

// a block of 64 query rows (a tile a warp) or 256 (four)
template <int NW, bool kFold>
cudaError_t launch_tiles(int rows_per_block, dim3 grid, int chunk,
                         cudaStream_t stream, const uint32_t* words,
                         const int* count_q, const int* count_t,
                         const int* pair_ij, int t_base, int seg,
                         const top2::Out& out) {
  return rows_per_block == 64
      ? launch_search<NW, 1, kFold>(grid, chunk, stream, words, count_q,
                                    count_t, pair_ij, t_base, seg, out)
      : launch_search<NW, 4, kFold>(grid, chunk, stream, words, count_q,
                                    count_t, pair_ij, t_base, seg, out);
}

// scratch, in 32-bit units: words (rows * NW), bit counts as queries (rows)
// and as targets (rows), partials (splits * batch * nq * 3 when splits > 1).
// phase: 0 the whole call; 1 the pre-pass, 2 the search, 3 the search
// without the fold, 4 the merge (2-4 read what an earlier whole call left)
template <int NW>
int search_nw(int phase, const float* desc_q, const float* desc_t,
              const uint8_t* valid_q, const uint8_t* valid_t,
              const int* pair_ij, int* scratch, float* d0, float* d1,
              int* i0, long long rows_q, long long rows, int nq, int nt,
              int d, int batch, int pad_col, int rows_per_block, int splits,
              int seg, cudaStream_t stream) {
  uint32_t* words = reinterpret_cast<uint32_t*>(scratch);
  int* count_q = scratch + rows * NW;
  int* count_t = count_q + rows;
  float* part = reinterpret_cast<float*>(scratch + rows * (NW + 2));

  if (phase == 0 || phase == 1) {
    const bool vec = d % 4 == 0 &&
                     ((reinterpret_cast<uintptr_t>(desc_q) |
                       reinterpret_cast<uintptr_t>(desc_t)) & 15) == 0;
    const unsigned blocks = (unsigned)((rows * 32 + 255) / 256);
    if (vec)
      pack_rows<NW, true><<<blocks, 256, 0, stream>>>(
          desc_q, desc_t, valid_q, valid_t, words, count_q, count_t,
          (int)rows_q, (int)rows, d);
    else
      pack_rows<NW, false><<<blocks, 256, 0, stream>>>(
          desc_q, desc_t, valid_q, valid_t, words, count_q, count_t,
          (int)rows_q, (int)rows, d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const top2::Out out{d0, d1, i0, part, nq, nt, pad_col, splits, batch};
  const dim3 grid((nq + rows_per_block - 1) / rows_per_block, splits, batch);
  const int chunk = chunk_rows(seg);
  const int t_base = pair_ij ? 0 : nq;
  if (phase == 0 || phase == 2 || phase == 3) {
    const cudaError_t err =
        phase == 3
            ? launch_tiles<NW, false>(rows_per_block, grid, chunk, stream,
                                      words, count_q, count_t, pair_ij,
                                      t_base, seg, out)
            : launch_tiles<NW, true>(rows_per_block, grid, chunk, stream,
                                     words, count_q, count_t, pair_ij,
                                     t_base, seg, out);
    if (err != cudaSuccess) return (int)err;
  }
  return phase == 0 || phase == 4 ? (int)top2::merge_after(out, stream) : 0;
}

int search(int phase, const float* desc_q, const float* desc_t,
           const uint8_t* valid_q, const uint8_t* valid_t, const int* pair_ij,
           int* scratch, long long scratch_ints, float* d0, float* d1,
           int* i0, long long rows_q, long long rows, int nq, int nt, int d,
           int batch, int pad_col, int rows_per_block, int splits, int seg,
           cudaStream_t stream) {
  if (phase < 0 || phase > 4 || d <= 0 || d > 512 || nq <= 0 || nt <= 0 ||
      batch <= 0 || (rows_per_block != 64 && rows_per_block != 256) ||
      splits <= 0 || seg <= 0 || seg % 8 != 0 || seg > kMaxSeg ||
      (long long)splits * seg < nt || batch > 65535 || splits > 65535 ||
      rows > 0x7fffffffLL / 32 ||
      (reinterpret_cast<uintptr_t>(scratch) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int nw = words_per_row(d);
  const long long partial = splits > 1 ? 3LL * splits * batch * nq : 0;
  if (rows * (nw + 2) + partial > scratch_ints)
    return (int)cudaErrorInvalidValue;
  return nw == 8
      ? search_nw<8>(phase, desc_q, desc_t, valid_q, valid_t, pair_ij,
                     scratch, d0, d1, i0, rows_q, rows, nq, nt, d, batch,
                     pad_col, rows_per_block, splits, seg, stream)
      : search_nw<16>(phase, desc_q, desc_t, valid_q, valid_t, pair_ij,
                      scratch, d0, d1, i0, rows_q, rows, nq, nt, d, batch,
                      pad_col, rows_per_block, splits, seg, stream);
}

}  // namespace

// desc: (b, n, d) float32 {0,1} with d <= 512; valid: (b, n) uint8;
// pair_ij: (p, 2) int32; scratch: scratch_ints 32-bit units, 16-byte
// aligned (layout above, rows = b * n, batch = 2 p, NW = 8 for d <= 256
// and 16 above); outputs (p, 2, n). rows_per_block: 64 or 128, the query
// rows a block takes; splits x seg targets cover n. Returns
// cudaGetLastError().
extern "C" int two_nn_pairs_binary(const float* desc, const uint8_t* valid,
                                   const int* pair_ij, int* scratch,
                                   long long scratch_ints, float* d0,
                                   float* d1, int* i0, int b, int n, int d,
                                   int p, int pad_col, int rows_per_block,
                                   int splits, int seg, cudaStream_t stream) {
  if (b <= 0 || p <= 0) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)b * n;
  return search(0, desc, desc, valid, valid, pair_ij, scratch, scratch_ints,
                d0, d1, i0, rows, rows, n, n, d, 2 * p, pad_col,
                rows_per_block, splits, seg, stream);
}

// `two_nn_pairs_binary`'s phase `phase` alone (see search_nw)
extern "C" int two_nn_pairs_binary_phase(
    int phase, const float* desc, const uint8_t* valid, const int* pair_ij,
    int* scratch, long long scratch_ints, float* d0, float* d1, int* i0,
    int b, int n, int d, int p, int pad_col, int rows_per_block, int splits,
    int seg, cudaStream_t stream) {
  if (b <= 0 || p <= 0) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)b * n;
  return search(phase, desc, desc, valid, valid, pair_ij, scratch,
                scratch_ints, d0, d1, i0, rows, rows, n, n, d, 2 * p, pad_col,
                rows_per_block, splits, seg, stream);
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
  return search(0, desc_q, desc_t, nullptr, valid_t, nullptr, scratch,
                scratch_ints, d0, d1, i0, nq, (long long)nq + nt, nq, nt, d,
                1, pad_col, rows_per_block, splits, seg, stream);
}
