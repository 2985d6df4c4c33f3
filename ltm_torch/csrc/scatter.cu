// The pose-graph solver's scatter-sums in a fixed order, CUDA C++ for Hopper
// (sm_90a).
//
// Replaces what XLA compiles from ltm's `.at[].add` scatters of the
// solver (ltm/graph/solver.py:157-176 in _precond_blocks, :255-257 in
// _grad_from_jacobians and the Gauss-Newton product of
// _hvp_from_jacobians), where PyTorch's index_add_ on the card adds by
// atomics in an order that changes from run to run, so a solve did not
// repeat bit for bit.
//
// Each output element (lane, row, e) is one thread's sequential sum,
// starting from +0.0, of its row's contributions in the row's list order
// (CSR: rowptr, cols): the order of index_add_ on the CPU and of the plain
// version (ltm_torch/kernels/scatter.py, fixed_order_sum_plain), so every
// result is theirs bit for bit.  Sums are __fadd_rn / __dadd_rn: nvcc never
// contracts them.
//
// What bounds it: bytes (one add a contribution read), and, on a row of
// high degree (a session's anchor, touched by every inter-session factor),
// the latency of its sequential loads: the loop is unrolled so the loads
// of several contributions are in flight while their adds wait in order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// out (n_lanes, n_rows, width) = the row sums of src (n_lanes, n_src, width)
template <typename T>
__global__ void __launch_bounds__(kThreads)
fixed_order_sum(const T* __restrict__ src, const int* __restrict__ rowptr,
                const int* __restrict__ cols, T* __restrict__ out, long long n_out, int n_src,
                int n_rows, int width) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_out) return;
  const int e = static_cast<int>(i % width);
  const long long r = i / width;
  const int v = static_cast<int>(r % n_rows);
  const long long lane = r / n_rows;
  const T* s = src + lane * n_src * width + e;
  T acc = static_cast<T>(0);
  const int j1 = rowptr[v + 1];
#pragma unroll 8
  for (int j = rowptr[v]; j < j1; ++j) {
    acc = add_rn(acc, s[static_cast<long long>(cols[j]) * width]);
  }
  out[i] = acc;
}

}  // namespace

// dtype 0: float32, 1: float64.  Returns a cudaError_t.
extern "C" int ltm_fixed_order_sum(const void* src, const int* rowptr, const int* cols, void* out,
                                   int dtype, int n_lanes, int n_src, int n_rows, int width,
                                   void* stream) {
  if (n_lanes < 0 || n_src < 0 || n_rows < 0 || width < 1 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_out = static_cast<long long>(n_lanes) * n_rows * width;
  if (n_out == 0) return 0;
  const long long blocks = (n_out + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    fixed_order_sum<float><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const float*>(src), rowptr, cols, static_cast<float*>(out), n_out, n_src,
        n_rows, width);
  } else {
    fixed_order_sum<double><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const double*>(src), rowptr, cols, static_cast<double*>(out), n_out, n_src,
        n_rows, width);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ltm_scatter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
