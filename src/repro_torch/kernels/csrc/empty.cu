// An empty kernel: the card's launch floor.  chip_smoke.py times it in the
// same CUDA-graph harness as the port's kernels, so a kernel whose work
// takes less than a launch can be judged against what any launch costs.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int empty_launch(int blocks, cudaStream_t stream) {
  empty_kernel<<<blocks, 128, 0, stream>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* empty_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
