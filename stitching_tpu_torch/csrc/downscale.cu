// The registration inputs of one view: its gray MEDIUM image and its colour
// LOW image, downscaled on the card from the uint8 original.
//
// Replaces no TPU kernel. The JAX package makes both on the host
// (stitching_tpu/engine.py::_host_downscale): the BT.601 luma in 8.8 fixed
// point, resized to MEDIUM for detection, and the colour original resized
// to LOW for planning, each by ops/resize.resize, which widens the whole
// original to float32 before it gathers the rows and columns it lerps;
// pipeline.stack_images then uploads the small images as padded float32
// stacks. At 12 MP that host pass converted 73 MP to read a fifth of it,
// while the originals were already streaming to the card for the FINAL
// pass. Here each original is read where it has landed.
//
// Contract: src (h, w, c) uint8, c 1 or 3, row-major. Two outputs, each
// one view's slot of a padded float32 stack, (hp, wp, oc) row-major:
//   med (oc 1): the MEDIUM image of (oh, ow), gray: for c == 3 each source
//     pixel's luma (29 c0 + 150 c1 + 77 c2 + 128) >> 8 before the lerp;
//   low (oc 1, or 3 with a gray source widened): the LOW image of (oh, ow).
// Each output has a table of int32 words, the rows' then the columns':
// i0[n], i1[n], w1[n], w0[n] (w1 and w0 = 1 - w1 as float32 bits), the
// taps and weights that ops/resize._axis_weights computes on the host.
// Pixels at or past (oh, ow) repeat the last row and column, as the
// stack's edge replication does. Every pixel of both slots is written.
//
// Arithmetic: numpy's, in its order, so that the slots equal the host
// path's bit for bit. Rows first, src[i0] * w0 + src[i1] * w1, then the
// columns of those rows the same way; each product and each sum rounded on
// its own (__fmul_rn, __fadd_rn: nvcc would contract them into FMAs); then
// rintf (numpy's round half to even) and a clip to [0, 255].
//
// What bounds it on the H100: bytes, and below them the launch. A view
// reads the source rows its taps name (at 12 MP to MEDIUM and LOW, about
// 1,900 of 3,024 rows of 12 KB: 23 MB) and writes its two slots (2.5 MB
// at MEDIUM, 1.5 MB at LOW): 8 us at 3.35 TB/s. One thread per output
// pixel reads its four taps (all channels) straight from the rows; taps of
// neighbouring threads share cache lines, so each needed row crosses DRAM
// about once, and no source row that no tap names is read. One launch per
// view covers both outputs, so the host can issue it as soon as that
// view's upload has landed.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;  // output columns a block
constexpr int kBlockY = 8;   // output rows a block

struct Output {
  float* data;         // the view's slot, (hp, wp, oc)
  const int* table;    // rows' i0, i1, w1, w0, then the columns'
  int hp, wp, oh, ow, oc;
};

// Source pixel (y, x) as the host path reads it: channel ch, or for ch < 0
// the 8.8 fixed-point luma of its three channels.
__device__ __forceinline__ float pixel(const unsigned char* __restrict__ src,
                                       int w, int c, int y, int x, int ch) {
  const unsigned char* p = src + (static_cast<size_t>(y) * w + x) * c;
  if (ch < 0) {
    const int b = __ldg(p), g = __ldg(p + 1), r = __ldg(p + 2);
    return static_cast<float>((29 * b + 150 * g + 77 * r + 128) >> 8);
  }
  return static_cast<float>(__ldg(p + ch));
}

// a * wa + b * wb with the product and the sum each rounded, as numpy does
__device__ __forceinline__ float lerp(float a, float wa, float b, float wb) {
  return __fadd_rn(__fmul_rn(a, wa), __fmul_rn(b, wb));
}

__global__ void downscale_kernel(const unsigned char* __restrict__ src, int w,
                                 int c, Output med, Output low,
                                 int med_blocks_x, int med_blocks,
                                 int low_blocks_x) {
  int b = blockIdx.x;
  const bool is_med = b < med_blocks;
  if (!is_med) b -= med_blocks;
  const Output o = is_med ? med : low;
  const int blocks_x = is_med ? med_blocks_x : low_blocks_x;
  const int x = (b % blocks_x) * kBlockX + threadIdx.x;
  const int y = (b / blocks_x) * kBlockY + threadIdx.y;
  if (x >= o.wp || y >= o.hp) return;
  const int yy = min(y, o.oh - 1);
  const int xx = min(x, o.ow - 1);
  const int* ty = o.table;
  const int* tx = o.table + 4 * o.oh;
  const int y0 = __ldg(ty + yy), y1 = __ldg(ty + o.oh + yy);
  const float wy1 = __int_as_float(__ldg(ty + 2 * o.oh + yy));
  const float wy0 = __int_as_float(__ldg(ty + 3 * o.oh + yy));
  const int x0 = __ldg(tx + xx), x1 = __ldg(tx + o.ow + xx);
  const float wx1 = __int_as_float(__ldg(tx + 2 * o.ow + xx));
  const float wx0 = __int_as_float(__ldg(tx + 3 * o.ow + xx));
  float* out = o.data + (static_cast<size_t>(y) * o.wp + x) * o.oc;
  // the channels this output takes from the source: luma, each of three,
  // or the one plane (repeated where a gray view widens to colour)
  const int first = is_med && c == 3 ? -1 : 0;
  const int n = is_med || c == 1 ? 1 : 3;
  for (int k = 0; k < n; ++k) {
    const int ch = first + k;
    const float r0 = lerp(pixel(src, w, c, y0, x0, ch), wy0,
                          pixel(src, w, c, y1, x0, ch), wy1);
    const float r1 = lerp(pixel(src, w, c, y0, x1, ch), wy0,
                          pixel(src, w, c, y1, x1, ch), wy1);
    const float v =
        fminf(fmaxf(rintf(lerp(r0, wx0, r1, wx1)), 0.0f), 255.0f);
    if (n == 1) {
      for (int j = 0; j < o.oc; ++j) out[j] = v;
    } else {
      out[k] = v;
    }
  }
}

int blocks_of(int extent, int block) { return (extent + block - 1) / block; }

}  // namespace

extern "C" int downscale_view(const unsigned char* src, int w, int c,
                              float* med, const int* med_table, int med_hp,
                              int med_wp, int med_h, int med_w, float* low,
                              const int* low_table, int low_hp, int low_wp,
                              int low_c, int low_h, int low_w,
                              cudaStream_t stream) {
  const Output m{med, med_table, med_hp, med_wp, med_h, med_w, 1};
  const Output l{low, low_table, low_hp, low_wp, low_h, low_w, low_c};
  const int med_bx = blocks_of(med_wp, kBlockX);
  const int med_blocks = med_bx * blocks_of(med_hp, kBlockY);
  const int low_bx = blocks_of(low_wp, kBlockX);
  const int blocks = med_blocks + low_bx * blocks_of(low_hp, kBlockY);
  downscale_kernel<<<blocks, dim3(kBlockX, kBlockY), 0, stream>>>(
      src, w, c, m, l, med_bx, med_blocks, low_bx);
  return static_cast<int>(cudaGetLastError());
}
