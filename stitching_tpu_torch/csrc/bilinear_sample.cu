// Bilinear sampling of an edge-padded image stack at per-pixel coordinates.
//
// Replaces: stitching_tpu/ops/pallas/block_warp.py::block_sample_dma (and
// block_sample, its narrow-source variant with the same contract), called
// from compose.py::_warp_stack_kernel's fast branch.
//
// Contract: data (b, h, w, c) float32, channels last, whose padding beyond
// each image's true extent replicates its edge; sxc, syc (b, th, tw)
// float32 source coordinates, already clamped to each image's true extent.
// out (b, th, tw, c) = ((1-fx)*a + fx*b)*(1-fy) + ((1-fx)*cc + fx*d)*fy
// with a, b, cc, d the taps at (x0, y0), (x0+1, y0), (x0, y0+1),
// (x0+1, y0+1), x0 = floor(sx), fx = sx - x0; x0+1 and y0+1 clamp to the
// padded extent. The result is exact at every pixel (the TPU version is
// exact only at `care` pixels, which this one therefore also satisfies).
//
// What bounds it on the H100: memory. Per output pixel it reads two
// coordinates and four taps of c floats and writes c floats, about 10
// floating-point operations per channel: far below the ~20 FLOP/byte at
// which the card stops being bound by its 3.35 TB/s.
//
// Design: one thread per output pixel; neighbouring threads take
// neighbouring destination pixels, so the coordinate reads and the output
// writes are coalesced, and the smooth backward map keeps a warp's taps on a
// few neighbouring source rows that L1/L2 serve. The TPU kernel's source
// windows, one-hot matrix-unit interpolation and 128-aligned copy starts
// worked around TPU gather rates; Hopper gathers through its caches, so
// none of them is carried over. The arithmetic uses round-to-nearest
// intrinsics (no fused multiply-add) so that it equals the plain PyTorch
// version bit for bit.

#include <cuda_runtime.h>

namespace {

__global__ void bilinear_sample_kernel(const float* __restrict__ data,
                                       const float* __restrict__ sxc,
                                       const float* __restrict__ syc,
                                       float* __restrict__ out, int h, int w,
                                       int c, long long plane,
                                       long long total) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long bi = idx / plane;
  const float sx = sxc[idx];
  const float sy = syc[idx];
  const float x0f = floorf(sx);
  const float y0f = floorf(sy);
  const float fx = __fsub_rn(sx, x0f);
  const float fy = __fsub_rn(sy, y0f);
  const float gx = __fsub_rn(1.0f, fx);
  const float gy = __fsub_rn(1.0f, fy);
  const int x0 = min(max((int)x0f, 0), w - 1);
  const int y0 = min(max((int)y0f, 0), h - 1);
  const int x1 = min(x0 + 1, w - 1);
  const int y1 = min(y0 + 1, h - 1);
  const float* img = data + bi * h * (long long)w * c;
  const float* pa = img + ((long long)y0 * w + x0) * c;
  const float* pb = img + ((long long)y0 * w + x1) * c;
  const float* pc = img + ((long long)y1 * w + x0) * c;
  const float* pd = img + ((long long)y1 * w + x1) * c;
  float* o = out + idx * c;
  for (int ch = 0; ch < c; ++ch) {
    const float top = __fadd_rn(__fmul_rn(pa[ch], gx), __fmul_rn(pb[ch], fx));
    const float bot = __fadd_rn(__fmul_rn(pc[ch], gx), __fmul_rn(pd[ch], fx));
    o[ch] = __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, fy));
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int bilinear_sample(const float* data, const float* sxc,
                               const float* syc, float* out, int b, int h,
                               int w, int c, int th, int tw,
                               cudaStream_t stream) {
  const long long plane = (long long)th * tw;
  const long long total = (long long)b * plane;
  if (total <= 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  bilinear_sample_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      data, sxc, syc, out, h, w, c, plane, total);
  return (int)cudaGetLastError();
}
