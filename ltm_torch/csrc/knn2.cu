// Brute-force 2-NN squared distances, CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel ltm/kernels/pallas_knn.py::knn2_sqdists_pallas
// (body _kernel): for each valid query, the squared distances to its two
// nearest valid targets, ascending.  Invalid queries get 1e30 rows; fewer
// than two valid targets pads with 1e30; a duplicated target counts twice.
//
// Design (simple and exact first):
//   * one thread per query, 256 threads a block; the block stages tiles of
//     1024 targets in shared memory as float4 (an invalid target is staged
//     at +inf, so its distance is +inf and never enters the top 2);
//   * each thread keeps a running top-2 in registers; an equal value goes
//     into slot 2, so duplicates count twice;
//   * a block whose queries are all invalid writes 1e30 and exits at once
//     (the pipeline's query sets are the eligible subsets of a padded map).
//   * distances use the direct form (qx-tx)^2 + (qy-ty)^2 + (qz-tz)^2 on the
//     ORIGINAL coordinates, in the order XLA's CPU reduction gives the
//     pipeline's exact re-score (ltm/kernels/knn.py:111-113):
//     fma(dz, dz, fma(dy, dy, dx*dx)).  The _rn intrinsics fix every
//     rounding (nvcc can neither contract nor split them), so each distance
//     is the float32 value the plain PyTorch version computes.  No
//     recentring, no extent gate and no re-score pass are needed, because
//     nothing is selected on an inexact |q|^2+|t|^2-2q.t form.
//
// Bound: N_valid * M_valid pairs x 8 float32 operations (3 sub, 1 mul,
// 2 FMA counted as two each) plus two compares, on the non-tensor FP32
// units (67 TFLOP/s peak on an H100 SXM, which counts an FMA as two).
// The bytes are tiny by comparison (each point read once: 13 B; each
// output 8 B), so the kernel is bound by operations.
//
// Making it fast is later work: double-buffered shared-memory tiles,
// several queries per thread to cut shared-memory reads per pair, and a
// 3xTF32 or split-bf16 tensor-core selection followed by an exact re-score
// of the picks.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;
constexpr float kBig = 1e30f;

__global__ void __launch_bounds__(kThreads)
knn2_kernel(const float* __restrict__ q, const bool* __restrict__ qmask,
            const float* __restrict__ t, const bool* __restrict__ tmask,
            float* __restrict__ out, int n, int m) {
  __shared__ float4 tile[kTile];
  const float inf = __int_as_float(0x7f800000);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < n && qmask[i];
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = q[3 * (size_t)i];
    qy = q[3 * (size_t)i + 1];
    qz = q[3 * (size_t)i + 2];
  }
  float b1 = kBig, b2 = kBig;
  if (__syncthreads_or(active)) {
    for (int base = 0; base < m; base += kTile) {
      const int cnt = min(kTile, m - base);
      for (int j = threadIdx.x; j < cnt; j += kThreads) {
        const size_t g = (size_t)base + j;
        tile[j] = tmask[g] ? make_float4(t[3 * g], t[3 * g + 1], t[3 * g + 2], 0.f)
                           : make_float4(inf, inf, inf, 0.f);
      }
      __syncthreads();
      if (active) {
#pragma unroll 8
        for (int j = 0; j < cnt; ++j) {
          const float4 p = tile[j];
          const float dx = __fsub_rn(qx, p.x);
          const float dy = __fsub_rn(qy, p.y);
          const float dz = __fsub_rn(qz, p.z);
          const float d = __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
          if (d < b2) {
            if (d < b1) {
              b2 = b1;
              b1 = d;
            } else {
              b2 = d;
            }
          }
        }
      }
      __syncthreads();
    }
  }
  if (i < n) {
    out[2 * (size_t)i] = active ? b1 : kBig;
    out[2 * (size_t)i + 1] = active ? b2 : kBig;
  }
}

}  // namespace

// q (n,3) f32, qmask (n,) bool, t (m,3) f32, tmask (m,) bool, out (n,2) f32,
// all contiguous on the current device; launches on `stream` and returns
// cudaGetLastError() (0 on success).  Does not synchronise.
extern "C" int ltm_knn2_sqdists(const float* q, const bool* qmask, const float* t,
                                const bool* tmask, float* out, int n, int m,
                                void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  knn2_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, qmask, t, tmask, out, n, m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ltm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
