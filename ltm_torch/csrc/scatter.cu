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
// Each output element (lane, row, e) is the sequential sum, starting from
// +0.0, of its row's contributions in the row's list order (CSR: rowptr,
// cols): the order of index_add_ on the CPU and of the plain version
// (ltm_torch/kernels/scatter.py, fixed_order_sum_plain), so every result is
// theirs bit for bit.  Sums are __fadd_rn / __dadd_rn: nvcc never contracts
// them.
//
// What bounds it: bytes (one add a contribution read) and, on the solver's
// graphs (a thousand rows, most of degree 2-4, a session's anchor of degree
// up to a hundred), the latency of the loads behind a row's sequential sum.
//
// What the design does about it:
//   1. A warp a (lane, row).  The warp reads the row's index list once, 32
//      entries a load, and passes each entry to the threads that need it by
//      shuffle (the first design had every element's thread re-read it).
//   2. The loads of a contribution row are contiguous across threads: a row
//      of width w <= 32 is read by w neighbouring threads, 32 / w rows side
//      by side (w = 6: five 24-byte rows a warp load); a wider row by all 32
//      threads, in passes of 32 elements (w = 36: 144 contiguous bytes).
//   3. kSteps such loads are issued before their adds, so they are in flight
//      together; the adds then run in list order, each element's thread
//      taking the values of the rows side by side from its neighbours by
//      shuffle.
//   4. Rows start in the plan's order, highest degree first, so a session's
//      anchor is not the tail of the launch.
// The wrapper's per-call host work is one C call: the device is set here
// (and restored) rather than by a torch.cuda.device context.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps: 8 (lane, row) items a CTA
constexpr int kSteps = 8;       // contribution loads in flight a thread
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// out (n_lanes, n_rows, width) = the row sums of src (n_lanes, n_src, width).
// Warp w takes row order[w / n_lanes] of lane w % n_lanes.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fixed_order_sum(const T* __restrict__ src, const int* __restrict__ rowptr,
                const int* __restrict__ cols, const int* __restrict__ order,
                T* __restrict__ out, int n_lanes, int n_src, int n_rows, int width) {
  const long long item = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (item >= static_cast<long long>(n_lanes) * n_rows) return;   // uniform across the warp
  const int lid = threadIdx.x & 31;
  const int lane = static_cast<int>(item % n_lanes);
  const int v = order[item / n_lanes];
  const int j0 = rowptr[v], j1 = rowptr[v + 1];
  const T* s = src + static_cast<long long>(lane) * n_src * width;
  T* o = out + (static_cast<long long>(lane) * n_rows + v) * width;
  const bool narrow = width <= 32;
  const int per = narrow ? 32 / width : 1;           // contribution rows a warp load
  const int k = narrow ? lid / width : 0;            // this thread's row of the load
  const int e0 = narrow ? lid % width : lid;         // its element in the first pass
  const int passes = narrow ? 1 : (width + 31) / 32;
  for (int pass = 0; pass < passes; ++pass) {
    const int e = e0 + 32 * pass;
    const bool loads = k < per && e < width;
    T acc = static_cast<T>(0);
    for (int c0 = j0; c0 < j1; c0 += 32) {
      const int n = min(32, j1 - c0);
      const int col = lid < n ? cols[c0 + lid] : 0;
      for (int s0 = 0; s0 < n; s0 += kSteps * per) {
        T val[kSteps];
#pragma unroll
        for (int g = 0; g < kSteps; ++g) {
          const int c = s0 + g * per + k;             // the entry this thread loads
          const int row = __shfl_sync(kFull, col, c & 31);
          val[g] = (loads && c < n) ? s[static_cast<long long>(row) * width + e]
                                    : static_cast<T>(0);
        }
#pragma unroll
        for (int g = 0; g < kSteps; ++g) {
          for (int q = 0; q < per; ++q) {             // entries s0 + g*per + q, in order
            const T x = per == 1 ? val[g] : __shfl_sync(kFull, val[g], q * width + e0);
            if (s0 + g * per + q < n) acc = add_rn(acc, x);
          }
        }
      }
    }
    if (k == 0 && e < width) o[e] = acc;
  }
}

}  // namespace

// dtype 0: float32, 1: float64; order (n_rows,) the rows in launch order,
// each once.  Launches on `stream` on CUDA device `device` (the calling
// thread's current device is restored).  Returns a cudaError_t.
extern "C" int ltm_fixed_order_sum(const void* src, const int* rowptr, const int* cols,
                                   const int* order, void* out, int dtype, int n_lanes, int n_src,
                                   int n_rows, int width, int device, void* stream) {
  if (n_lanes < 0 || n_src < 0 || n_rows < 0 || width < 1 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long items = static_cast<long long>(n_lanes) * n_rows;
  if (items == 0) return 0;
  const long long blocks = (items * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t rc = cudaGetDevice(&current);
  if (rc == cudaSuccess && current != device) rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    fixed_order_sum<float><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const float*>(src), rowptr, cols, order, static_cast<float*>(out), n_lanes,
        n_src, n_rows, width);
  } else {
    fixed_order_sum<double><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const double*>(src), rowptr, cols, order, static_cast<double*>(out),
        n_lanes, n_src, n_rows, width);
  }
  rc = cudaGetLastError();
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(rc);
}

extern "C" const char* ltm_scatter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
