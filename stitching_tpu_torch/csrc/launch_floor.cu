// Measurement aids; no kernel of the port calls them.
//
// `launch_floor`: an empty kernel launched `launches` times on one stream,
// the least a call of that many launches can cost on the card. chip_smoke.py
// and scripts/bench_two_nn.py replay it from a CUDA graph to print a launch
// floor (`floor_ms`) beside each kernel's time, because the bounds of the
// small 2-NN rows lie below what any launch costs.
//
// `capture_begin` / `capture_end`: put a stream into capture and end it,
// returning how many operations (kernels, copies, memsets) were put on
// the stream in between: the number of launches one call of a wrapper
// makes, counted rather than derived. Nothing captured runs.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int launch_floor(int launches, cudaStream_t stream) {
  for (int k = 0; k < launches; ++k) empty_kernel<<<1, 32, 0, stream>>>();
  return (int)cudaGetLastError();
}

extern "C" int capture_begin(cudaStream_t stream) {
  return (int)cudaStreamBeginCapture(stream, cudaStreamCaptureModeRelaxed);
}

// the number of captured operations, or minus the cudaError_t
extern "C" int capture_end(cudaStream_t stream) {
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamEndCapture(stream, &graph);
  if (err != cudaSuccess) return -(int)err;
  size_t nodes = 0;
  err = cudaGraphGetNodes(graph, nullptr, &nodes);
  cudaGraphDestroy(graph);
  return err != cudaSuccess ? -(int)err : (int)nodes;
}
