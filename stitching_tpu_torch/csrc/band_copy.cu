// One finished panorama band copied from the card straight into its place
// in a pinned host panorama.
//
// No TPU kernel stands behind it: the JAX package fetches each band into a
// host array of its own and then writes it into a host panorama
// (`stitching_tpu/compose.py`, the blends' `stream_fetch`). Here the copy engine
// lands the band in place, so the host neither zeroes a panorama nor
// writes a pixel of it. A column band is a strided copy (rows of `width`
// bytes, `dpitch` apart in the panorama), a row band the same call with
// equal pitches. Bound by the link's bytes; the copy runs on the caller's
// stream, after whatever that stream waits on, and the host does not wait.

#include <cuda_runtime.h>

extern "C" int copy_band_2d(void* dst, long long dpitch, const void* src,
                            long long spitch, long long width,
                            long long height, cudaStream_t stream) {
  return (int)cudaMemcpy2DAsync(dst, (size_t)dpitch, src, (size_t)spitch,
                                (size_t)width, (size_t)height,
                                cudaMemcpyDeviceToHost, stream);
}
