// Instruction rate of two tensor-core `mma.sync` forms on the GPU it runs on:
// the 1-bit m16n8k256 `.and.popc` and the int8 m16n8k32. Each warp runs a
// loop of four independent accumulator chains; the clock ticks per
// instruction and warp are printed for 1 and 4 warps a scheduler, the
// fewest of five launches (a rate the card reached is a lower bound of its
// peak). It
// backs the choice of the 1-bit form in stitching_tpu_torch/csrc/two_nn.cu
// and the 1-bit rate that chip_smoke.py takes for the binary rows' bounds.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o probe_mma_rate \
//       scripts/probe_mma_rate.cu && ./probe_mma_rate

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

constexpr int kIters = 2048;
constexpr int kChains = 4;

template <bool kBinary>
__global__ void rate(const uint32_t* in, int* out, long long* ticks) {
  uint32_t a[4], b[2];
  for (int k = 0; k < 4; ++k) a[k] = in[threadIdx.x % 32 + 32 * k];
  for (int k = 0; k < 2; ++k) b[k] = in[threadIdx.x % 32 + 32 * (4 + k)];
  int c[kChains][4] = {};
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < kIters; ++it) {
#pragma unroll
    for (int n = 0; n < kChains; ++n) {
      if (kBinary) {
        asm volatile(
            "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
            : "+r"(c[n][0]), "+r"(c[n][1]), "+r"(c[n][2]), "+r"(c[n][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      } else {
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
            : "+r"(c[n][0]), "+r"(c[n][1]), "+r"(c[n][2]), "+r"(c[n][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      }
    }
  }
  const long long t1 = clock64();
  int s = 0;
  for (int n = 0; n < kChains; ++n)
    for (int k = 0; k < 4; ++k) s += c[n][k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) ticks[blockIdx.x] = t1 - t0;
}

int main() {
  uint32_t* in;
  int* out;
  long long* ticks;
  cudaMallocManaged(&in, 6 * 32 * 4);
  cudaMallocManaged(&out, 1024 * 4);
  cudaMallocManaged(&ticks, 8);
  for (int k = 0; k < 6 * 32; ++k) in[k] = 0x01010101u;
  for (int warps = 4; warps <= 16; warps *= 4) {
    for (int binary = 1; binary >= 0; --binary) {
      long long best = 0;
      for (int rep = 0; rep < 5; ++rep) {
        if (binary) rate<true><<<1, warps * 32>>>(in, out, ticks);
        else rate<false><<<1, warps * 32>>>(in, out, ticks);
        if (cudaDeviceSynchronize() != cudaSuccess) return 1;
        if (rep == 0 || ticks[0] < best) best = ticks[0];
      }
      const double per = (double)best / (kIters * kChains);
      // one SM has four schedulers; warps / 4 share each
      printf("%s, %d warps on one SM: %.2f clocks per instruction and warp, "
             "%.1f %s per clock and SM\n",
             binary ? "b1 m16n8k256 and.popc" : "s8 m16n8k32", warps, per,
             warps * (binary ? 16.0 * 8 * 256 : 16.0 * 8 * 32) / per,
             binary ? "bit products" : "byte products");
    }
  }
  return 0;
}
