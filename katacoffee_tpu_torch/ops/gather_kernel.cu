// Child-stats row gather for the batched MCTS, for Hopper (sm_90a).
//
//   out[b, a, :] = 0 <= idx[b, a] < N ? table[b, idx[b, a], :] : 0
//
// table [B, N, 8] float32 (the packed node stats, Tree.stats), idx [B, A]
// int32 (a node's child slots, -1 where the child is missing), out [B, A, 8].
//
// Replaces the Pallas TPU kernel `_gather_kernel` in
// katacoffee_tpu/ops/gather.py, which builds a [tb, ca, N] one-hot in VMEM
// and contracts it with the table block on the MXU; JAX's search reaches the
// same function as the one-hot einsum in `_gather_child_stats`. On the GPU no
// one-hot is needed: each row is copied, and the missing-child mask of
// `_gather_child_stats` is fused in (out-of-range rows are zero, a defined
// value).
//
// Bound: bytes. Per row the kernel moves 4 bytes of index, at most 32 bytes
// of table and 32 bytes of output, and does no arithmetic. Two neighbouring
// lanes copy one 32-byte row, each with one 16-byte load and one 16-byte
// store, so a warp's store instruction writes 512 contiguous bytes and every
// sector it touches is full. Both lanes of a pair load the row's index (one
// transaction for the warp): sharing it from one lane by a shuffle put the
// shuffle on the path between the two dependent loads and measured slower.
// Table reads are scattered by nature; the table of the search's operating
// point (512 x 602 x 32 B = 9.9 MB) fits in the 50 MB L2. The grid is at
// most one wave (every SM's resident blocks) and strides over the rows. At
// the search's shapes (10k-51k rows, 0.1-0.9 us of HBM time) the launch and
// the two dependent loads are most of the time.
//
// Built by katacoffee_tpu_torch/ops/_build.py with nvcc into a shared library
// with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float4* __restrict__ table, const int* __restrict__ idx,
                   float4* __restrict__ out, int halves, int n, int a) {
  for (int t = blockIdx.x * kThreads + threadIdx.x; t < halves; t += gridDim.x * kThreads) {
    const int r = t >> 1;  // the row; t & 1 its half
    const int i = __ldg(idx + r);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i >= 0 && i < n) v = __ldg(table + (static_cast<long long>(r / a) * n + i) * 2 + (t & 1));
    out[t] = v;
  }
}

}  // namespace

// Launches the gather on `stream`; returns the cudaError_t of the launch.
extern "C" int kc_gather_rows(const void* table, const void* idx, void* out,
                              int b, int n, int a, void* stream) {
  const long long rows = static_cast<long long>(b) * a;
  if (rows == 0) return 0;
  if (rows > 0x1fffffffLL) return static_cast<int>(cudaErrorInvalidValue);  // the loop's int index
  // one wave: the blocks every SM of the current device holds at once,
  // asked once per device
  static int device = -1, wave = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev != device) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gather_rows_kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    wave = sms * per_sm;
    device = dev;
  }
  const int halves = static_cast<int>(2 * rows);
  const int need = (halves + kThreads - 1) / kThreads;
  const int blocks = need < wave ? need : wave;
  gather_rows_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(table), static_cast<const int*>(idx), static_cast<float4*>(out),
      halves, n, a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
