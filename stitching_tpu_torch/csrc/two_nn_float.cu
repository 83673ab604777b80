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
// Queries are not masked. The sum q.t is taken in another order than a
// library product would take it, so d0 and d1 agree with the plain version
// to rounding (1e-3 relative + 1e-3 absolute is the stated tolerance), and
// i0 wherever the two nearest are further apart than that.
//
// What bounds it on the H100: operations. A pair of 500 x 500 descriptors
// of 128 floats is 2 * 500 * 500 * 128 = 64 MFLOP on 0.5 MB, ~250 FLOP per
// byte, far above the card's float32 balance (67 TFLOP/s over 3.35 TB/s =
// 20 FLOP per byte). The contract is full float32 (no TF32), so the bound
// is the FMA rate outside the tensor cores; it counts one product a pair,
// while this kernel computes one per direction (the backward distances are
// the forward's transpose, but sharing them needs a column-wise top-2
// across blocks). An SM starts one FMA instruction a clock on each of its
// four schedulers and nothing else in that slot, so the share of FMAs among
// the instructions of the inner loop is the ceiling.
//
// Design: a register-tiled float32 product with the top-2 as its epilogue.
// - A pre-pass (`row_norms`, one launch for every operand row of a call)
//   writes |row|^2 for queries and |row|^2 + adj for targets, one warp a
//   row.
// - A block is 4 warps and takes 64 or 128 query rows (16 or 32 a warp)
//   against its segment of the target axis, 64 targets a tile, 32
//   descriptor columns a stage. A warp is 4 x 8 threads; a thread owns 4
//   or 8 rows (every 4th of the warp's) x 8 columns (every 8th of the
//   tile's 64): 32 or 64 sums in registers. Both operands lie in shared
//   memory row by row as they do in device memory, padded to 36 floats, and
//   are read as float4 along the descriptor: 12 loads feed 128 FMAs, or 16
//   feed 256. A quarter warp's 8 float4 fall in 8 different bank groups and
//   equal addresses are broadcast, but a 16-byte load still takes the
//   shared-memory pipe four turns a warp, which holds the 4-row tile near
//   55% of the FMA peak and the 8-row tile near 70% (measured with staging
//   and epilogue switched off, PERF.md). The wrapper takes the 8-row tile
//   where 128-row blocks still give every SM a block, else the 4-row tile.
// - Staging is `cp.async` in a ring of three stages over (target tile,
//   descriptor chunk): the loads of step s + 2 are in flight while step s
//   computes, one barrier a step. A descriptor of up to 128 columns keeps
//   its query rows resident (four chunk slots) and stages them once; a
//   wider one restages its query chunk with each step. Rows and columns
//   past the edge are zero-filled by the copy (source size 0). Copies are
//   16 bytes where the rows allow it (d % 4 == 0, 16-byte aligned bases),
//   else 4 bytes.
// - After a tile's last chunk: dist = max(fma(-2, acc, |q|^2 + ta), 0)
//   (2 * acc is exact, so one rounding as in s - 2 * acc), folded per
//   thread in increasing column order without branches; columns at or
//   beyond nt are skipped. The running top-2 lives in registers across
//   tiles; at the end the 8 threads that share a row merge by shuffles.
// - Where the query rows give too few blocks for the card the wrapper
//   splits the target axis over blockIdx.y
//   (ops/kernels/two_nn.py::launch_plan) and a small third launch merges
//   the segments' partial results (top2.cuh); else a call is two launches.
//
// Measured on an NVIDIA H100 80GB HBM3 at a power limit of 700 W
// (scripts/bench_two_nn.py, device time per call from a CUDA graph replay):
// 0.127 ms for 28 pairs of 8 x 500 x 128 floats in both directions (3.6
// GFLOP at 28 TFLOP/s, 42% of the FMA peak; 4.7x the bound of 0.0267 ms,
// which counts one product a pair; the kernel this one replaced took 0.275
// ms) and 0.013 ms for one 500 x 500 pair (three launches, floor 0.0031
// ms; before: 0.059). PERF.md keeps the record.

#include <cuda_runtime.h>
#include <stdint.h>

#include "top2.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps: 4 x 8 threads each
constexpr int kTile = 64;     // targets per tile: 8 threads x 8 columns
constexpr int kBK = 32;       // descriptor columns per stage
constexpr int kLd = kBK + 4;  // padded row of a stage, in floats
constexpr int kStages = 3;    // ring of target stages
constexpr int kSlots = 4;     // query chunk slots (resident up to 128 columns)

// One warp per operand row. With `same` the rows_q rows of desc_q are both
// queries and targets; else rows [0, rows_q) are queries from desc_q and the
// next rows_t rows targets from desc_t.
__global__ void row_norms(const float* __restrict__ desc_q,
                          const float* __restrict__ desc_t,
                          const uint8_t* __restrict__ valid_t,
                          float* __restrict__ norm_q, float* __restrict__ adj_t,
                          int rows_q, int rows_t, int d, int same) {
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long row = tid / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (same ? rows_q : (long long)rows_q + rows_t)) return;
  const bool is_q = row < rows_q;
  const float* src = is_q ? desc_q + row * d : desc_t + (row - rows_q) * d;
  float s = 0.0f;
  for (int k = lane; k < d; k += 32) s = fmaf(src[k], src[k], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane != 0) return;
  if (is_q) norm_q[row] = s;
  if (same || !is_q) {
    const long long r = is_q ? row : row - rows_q;
    adj_t[r] = s + (valid_t[r] ? 0.0f : top2::kBig);
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = ok ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// dst[r][k] = src[row0 + r][k0 + k] for r < nrows, k < kBK; zero where the
// row is at or past row_end or the column at or past d. nrows is a
// multiple of 16.
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int row0, int row_end, int nrows,
                                           int k0, int d, bool vec) {
  if (vec) {
    // a thread keeps its 16-byte column and walks down the rows
    constexpr int kRowStep = kThreads / (kBK / 4);
    const int k = (threadIdx.x % (kBK / 4)) * 4;
    const int r0 = threadIdx.x / (kBK / 4);
    const bool k_ok = k0 + k < d;
    const float* from = src + (long long)(row0 + r0) * d + k0 + k;
    float* to = dst + r0 * kLd + k;
    for (int r = r0; r < nrows; r += kRowStep) {
      const bool ok = k_ok && row0 + r < row_end;
      cp_async16(to, ok ? from : src, ok);
      from += (long long)kRowStep * d;
      to += kRowStep * kLd;
    }
  } else {
    constexpr int kRowStep = kThreads / kBK;
    const int k = threadIdx.x % kBK;
    const int r0 = threadIdx.x / kBK;
    const bool k_ok = k0 + k < d;
    const float* from = src + (long long)(row0 + r0) * d + k0 + k;
    float* to = dst + r0 * kLd + k;
    for (int r = r0; r < nrows; r += kRowStep) {
      const bool ok = k_ok && row0 + r < row_end;
      cp_async4(to, ok ? from : src, ok);
      from += (long long)kRowStep * d;
      to += kRowStep * kLd;
    }
  }
}

// q_norm, t_adj: the pre-pass's outputs. A pair's query image qi starts at
// row qi * nq of q_desc and q_norm, its target image at row ti * nt of
// t_desc and t_adj. seg: targets per blockIdx.y, a multiple of kTile.
// kR: query rows a thread owns; the block takes 16 kR rows.
template <int kR>
__global__ void __launch_bounds__(kThreads)
two_nn_float_kernel(const float* __restrict__ q_desc,
                    const float* __restrict__ t_desc,
                    const float* __restrict__ q_norm,
                    const float* __restrict__ t_adj,
                    const int* __restrict__ pair_ij, int d, int seg, int vec,
                    top2::Out out) {
  extern __shared__ __align__(16) float smem[];

  const int nq = out.nq, nt = out.nt;
  const int dir = blockIdx.z & 1;
  const int p = blockIdx.z >> 1;
  const int qi = pair_ij ? pair_ij[2 * p + dir] : 0;
  const int ti = pair_ij ? pair_ij[2 * p + 1 - dir] : 0;
  const float* q_src = q_desc + (long long)qi * nq * d;
  const float* t_src = t_desc + (long long)ti * nt * d;
  const float* qn_src = q_norm + (long long)qi * nq;
  const float* ta_src = t_adj + (long long)ti * nt;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tx = lane % 8;   // columns tx + 8 j of a tile
  const int ty = lane / 8;   // rows ty + 4 i of the warp's
  constexpr int kRowsPerWarp = 4 * kR;
  constexpr int rows_per_block = (kThreads / 32) * kRowsPerWarp;
  const int block_row0 = blockIdx.x * rows_per_block;
  const int row0 = block_row0 + warp * kRowsPerWarp + ty;
  float* a_s = smem;                                  // [slot][row][kLd]
  float* b_s = smem + kSlots * rows_per_block * kLd;  // [stage][col][kLd]

  const int seg_begin = blockIdx.y * seg;
  const int seg_end = min(nt, seg_begin + seg);
  const int nchunks = (d + kBK - 1) / kBK;
  const bool resident = nchunks <= kSlots;
  const int nsteps = ((seg_end - seg_begin + kTile - 1) / kTile) * nchunks;

  float qn[kR];
  top2::Best best[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    qn[i] = row0 + 4 * i < nq ? qn_src[row0 + 4 * i] : 0.0f;
    best[i] = top2::empty();
  }

  // the loader runs two steps ahead of the FMAs; every call commits one
  // group, empty past the last step, so the groups count the steps
  int ld_step = 0, ld_tile = 0, ld_chunk = 0;
  auto prefetch = [&]() {
    if (ld_step < nsteps) {
      const int k0 = ld_chunk * kBK;
      if (ld_tile == 0 || !resident)
        stage_rows(a_s + (resident ? ld_chunk : ld_step % kSlots)
                             * rows_per_block * kLd,
                   q_src, block_row0, nq, rows_per_block, k0, d, vec);
      stage_rows(b_s + (ld_step % kStages) * kTile * kLd, t_src,
                 seg_begin + ld_tile * kTile, seg_end, kTile, k0, d, vec);
      if (++ld_chunk == nchunks) {
        ld_chunk = 0;
        ++ld_tile;
      }
    }
    ++ld_step;
    cp_async_commit();
  };
  prefetch();
  prefetch();

  float acc[kR][8];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  int tile = 0, chunk = 0;
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<1>();   // step s has landed (this thread's copies)
    __syncthreads();      // ... everyone's; and step s - 1 is consumed
    prefetch();           // step s + 2, into the stage step s - 1 used
    const float* As = a_s + ((resident ? chunk : s % kSlots) * rows_per_block
                             + warp * kRowsPerWarp + ty) * kLd;
    const float* Bs = b_s + ((s % kStages) * kTile + tx) * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 a[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i)
        a[i] = *reinterpret_cast<const float4*>(As + 4 * i * kLd + kk);
      // kJ columns at a time, and within them one descriptor column after
      // the other over all (row, column) sums: each sum still adds its
      // products in descriptor order, but two FMAs on the same sum are
      // kJ * kR >= 8 instructions apart, further than the FMA's latency
      // (measured: 6% faster for the 4-row tile than column by column)
      constexpr int kJ = kR >= 8 ? 1 : 4;
#pragma unroll
      for (int j0 = 0; j0 < 8; j0 += kJ) {
        float4 b[kJ];
#pragma unroll
        for (int j = 0; j < kJ; ++j)
          b[j] = *reinterpret_cast<const float4*>(Bs + 8 * (j0 + j) * kLd
                                                  + kk);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
#pragma unroll
            for (int i = 0; i < kR; ++i)
              acc[i][j0 + j] = fmaf(
                  reinterpret_cast<const float*>(&a[i])[c],
                  reinterpret_cast<const float*>(&b[j])[c], acc[i][j0 + j]);
          }
        }
      }
    }
    if (++chunk < nchunks) continue;
    // the tile is complete: this thread's 8 columns, in increasing order
    chunk = 0;
    const int col0 = seg_begin + tile * kTile + tx;
    ++tile;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + 8 * j;
      if (col < seg_end) {
        const float ta = ta_src[col];
#pragma unroll
        for (int i = 0; i < kR; ++i)
          top2::fold(best[i],
                     fmaxf(fmaf(-2.0f, acc[i][j], qn[i] + ta), 0.0f), col);
      }
#pragma unroll
      for (int i = 0; i < kR; ++i) acc[i][j] = 0.0f;
    }
  }
  cp_async_wait<0>();

  // the 8 threads of a row hold disjoint columns
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    top2::merge_lane(best[i], 1);
    top2::merge_lane(best[i], 2);
    top2::merge_lane(best[i], 4);
    if (tx == 0) top2::store(out, row0 + 4 * i, best[i]);
  }
}

template <int kR>
cudaError_t launch(const dim3& grid, size_t smem, cudaStream_t stream,
                   const float* desc_q, const float* desc_t,
                   const float* norm_q, const float* adj_t,
                   const int* pair_ij, int d, int seg, int vec,
                   const top2::Out& out) {
  cudaError_t err = cudaFuncSetAttribute(
      two_nn_float_kernel<kR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  two_nn_float_kernel<kR><<<grid, kThreads, smem, stream>>>(
      desc_q, desc_t, norm_q, adj_t, pair_ij, d, seg, vec, out);
  return cudaGetLastError();
}

// scratch, in 32-bit units: query norms (rows_q), target norms + adj
// (rows_t), partials (splits * batch * nq * 3 when splits > 1)
int search(const float* desc_q, const float* desc_t, const uint8_t* valid_t,
           const int* pair_ij, int* scratch, long long scratch_ints, float* d0,
           float* d1, int* i0, long long rows_q, long long rows_t, int nq,
           int nt, int d, int batch, int pad_col, int rows_per_block,
           int splits, int seg, cudaStream_t stream) {
  if (d <= 0 || nq <= 0 || nt <= 0 || batch <= 0 ||
      (rows_per_block != 64 && rows_per_block != 128) || splits <= 0 ||
      seg <= 0 || seg % kTile != 0 || (long long)splits * seg < nt ||
      batch > 65535 || splits > 65535 || rows_q + rows_t > 0x7fffffffLL / 32)
    return (int)cudaErrorInvalidValue;
  const int same = pair_ij != nullptr;
  const int row_blocks = (nq + rows_per_block - 1) / rows_per_block;
  const long long partial = splits > 1 ? 3LL * splits * batch * nq : 0;
  if (rows_q + rows_t + partial > scratch_ints)
    return (int)cudaErrorInvalidValue;
  float* norm_q = reinterpret_cast<float*>(scratch);
  float* adj_t = norm_q + rows_q;
  float* part = reinterpret_cast<float*>(scratch + rows_q + rows_t);

  const long long norm_rows = same ? rows_q : rows_q + rows_t;
  row_norms<<<(unsigned)((norm_rows * 32 + 255) / 256), 256, 0, stream>>>(
      desc_q, desc_t, valid_t, norm_q, adj_t, (int)rows_q, (int)rows_t, d,
      same);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem = (size_t)(kSlots * rows_per_block + kStages * kTile)
                      * kLd * sizeof(float);
  const int vec = d % 4 == 0 && (uintptr_t)desc_q % 16 == 0 &&
                  (uintptr_t)desc_t % 16 == 0;
  const top2::Out out{d0, d1, i0, part, nq, nt, pad_col, splits, batch};
  const dim3 grid(row_blocks, splits, batch);
  err = rows_per_block == 128
      ? launch<8>(grid, smem, stream, desc_q, desc_t, norm_q, adj_t, pair_ij,
                  d, seg, vec, out)
      : launch<4>(grid, smem, stream, desc_q, desc_t, norm_q, adj_t, pair_ij,
                  d, seg, vec, out);
  if (err != cudaSuccess) return (int)err;
  return (int)top2::merge_after(out, stream);
}

}  // namespace

// desc: (b, n, d) float32; valid: (b, n) uint8; pair_ij: (p, 2) int32;
// scratch: scratch_ints 32-bit units (layout above, rows_q = rows_t = b * n,
// batch = 2 p); outputs (p, 2, n). rows_per_block: 64 or 128 query rows a
// block; splits x seg targets cover n. Returns cudaGetLastError().
extern "C" int two_nn_pairs_float(const float* desc, const uint8_t* valid,
                                  const int* pair_ij, int* scratch,
                                  long long scratch_ints, float* d0, float* d1,
                                  int* i0, int b, int n, int d, int p,
                                  int pad_col, int rows_per_block, int splits,
                                  int seg, cudaStream_t stream) {
  if (b <= 0 || p <= 0) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)b * n;
  return search(desc, desc, valid, pair_ij, scratch, scratch_ints, d0, d1, i0,
                rows, rows, n, n, d, 2 * p, pad_col, rows_per_block, splits,
                seg, stream);
}

// desc_q: (nq, d) and desc_t: (nt, d) float32; valid_t: (nt,) uint8; scratch
// as above with rows_q = nq, rows_t = nt, batch = 1; outputs (nq,). Returns
// cudaGetLastError().
extern "C" int two_nn_float(const float* desc_q, const float* desc_t,
                            const uint8_t* valid_t, int* scratch,
                            long long scratch_ints, float* d0, float* d1,
                            int* i0, int nq, int nt, int d, int pad_col,
                            int rows_per_block, int splits, int seg,
                            cudaStream_t stream) {
  return search(desc_q, desc_t, valid_t, nullptr, scratch, scratch_ints, d0,
                d1, i0, nq, nt, nq, nt, d, 1, pad_col, rows_per_block, splits,
                seg, stream);
}
