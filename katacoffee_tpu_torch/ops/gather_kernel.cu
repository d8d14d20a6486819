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
// one-hot is needed: each thread reads its index and copies one 32-byte row
// as two 16-byte loads, and the missing-child mask of `_gather_child_stats`
// is fused in (out-of-range rows are zero, a defined value).
//
// Bound: bytes. Per row the kernel moves 4 bytes of index, at most 32 bytes
// of table and 32 bytes of output, and does no arithmetic. One thread per
// (b, a) row keeps the loads independent; neighbouring threads write
// neighbouring 32-byte rows, so stores coalesce. Table reads are scattered
// by nature; the table of the search's operating point (512 x 602 x 32 B =
// 9.9 MB) fits in the 50 MB L2.
//
// Built by katacoffee_tpu_torch/ops/_build.py with nvcc into a shared library
// with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void gather_rows_kernel(const float4* __restrict__ table,
                                   const int* __restrict__ idx,
                                   float4* __restrict__ out,
                                   int rows, int n, int a) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= rows) return;
  const int b = r / a;
  const int i = __ldg(idx + r);
  float4 lo = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 hi = lo;
  if (i >= 0 && i < n) {
    const float4* row = table + (static_cast<long long>(b) * n + i) * 2;
    lo = __ldg(row);
    hi = __ldg(row + 1);
  }
  out[static_cast<long long>(r) * 2] = lo;
  out[static_cast<long long>(r) * 2 + 1] = hi;
}

}  // namespace

// Launches the gather on `stream`; returns the cudaError_t of the launch.
extern "C" int kc_gather_rows(const void* table, const void* idx, void* out,
                              int b, int n, int a, void* stream) {
  const long long rows = static_cast<long long>(b) * a;
  if (rows == 0) return 0;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((rows + kThreads - 1) / kThreads);
  gather_rows_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(table), static_cast<const int*>(idx),
      static_cast<float4*>(out), static_cast<int>(rows), n, a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
