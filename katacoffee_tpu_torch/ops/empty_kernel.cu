// An empty kernel: the card's launch floor, the yardstick chip_smoke.py sets
// beside the times of the port's kernels (a launch that does no work, timed
// the way each kernel is timed). No search or training path launches it.
//
// Built by katacoffee_tpu_torch/ops/_build.py with nvcc into a shared library
// with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// Launches one block of one thread on `stream`; returns the cudaError_t.
extern "C" int kc_empty(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
