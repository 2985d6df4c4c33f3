// The ICP correspondence search (K5b): for each lane and query, the nearest
// valid target and its index.  CUDA C++ for Hopper (sm_90a).
//
// Replaces the XLA-lowered ltm/kernels/knn.py:177::nn_sqdist_argmin (a scan
// of target tiles, a (N, tile) matmul distance block each, and a running
// argmin), which the port's plain version
// (ltm_torch/kernels/knn.py::nn_sqdist_argmin_plain) runs as a baddbmm that
// writes a (lanes, N, tile) float32 block per target tile and reads it back
// for min.  This kernel keeps every distance in registers.
//
// What it computes, and its rounding.  The wrapper centres both point sets
// on the target bounding box and computes q2 = |q_c|^2 and t2 = |t_c|^2
// (1e30 at an invalid target) with the plain version's own torch ops, and
// passes them in; the pack kernel stores each target as (x, y, z, t2).  The
// scan selects on ltm's matmul form, in one fixed order:
//     dot = fma(qz, tz, fma(qy, ty, qx * tx))
//     d   = fma(-2, dot, q2 + t2)            (2 * dot is exact, so this is
//                                             (q2 + t2) - 2 * dot rounded once)
//     d   = max(d, 0)
// every step a _rn intrinsic, so nvcc can neither contract nor split it.
// The plain version on the card differs only where cuBLAS takes the K = 3
// dot product in another order; its indices are then equal except at
// near-ties.  The exact re-score stays in the wrapper (the plain version's
// gather and (q - t)^2), so where the indices agree the distances are
// bit-equal.
//
// Selection.  Targets are taken in index order with a strict <, so among
// equal minima the lowest index wins, as the plain version's per-tile min
// and its strict < across tiles give; the result does not depend on the
// tile.  An invalid target has t2 = 1e30, so its d is 1e30 (the query terms
// vanish below its ulp) and never passes the running best's 1e30 start: it
// never wins, and a lane with no valid target returns index 0 and 1e30.
// Padding targets (past m) have t2 = +inf.  Invalid queries are computed as
// the plain version computes them (ICP gathers their index, at weight 0).
// A running best of 0 is kept as -inf, so that a later d <= 0 (a clamped
// 0) never replaces it: the test a pair takes is then the one compare d < b.
//
// What bounds it: operations on the pairs (8 FP32 flops a valid pair, an
// FMA counted as two: 67 TFLOP/s on an H100 SXM).  A pair takes 6 issue
// slots (FMUL, 3 FFMA, FADD, and an FSETP that ORs the test into a group
// predicate), so the loop tops out near 4/6 of the flop bound.  The bytes
// are small: each point is read once from device memory.
//
// What the design does about it (K1's, csrc/knn2.cu, with a top-1 and an
// index):
//   1. kR = 4 queries a thread, in registers with their running (d, index);
//      each target read from shared memory (a broadcast LDS.128) serves kR
//      pairs.  A group of kGroup = 2 targets x kR queries is scored and
//      tested with one branch; the update, in index order, runs only when
//      some pair of the group beats its query's best.  A running best
//      improves often (about ln j times over j targets, and in runs where
//      targets come in spatial order), and a warp takes the update when any
//      of its threads needs it, so the group is kept small: 8 queries x 4
//      targets (a warp's branch over 1 024 pairs), 6 x 4, 4 x 8 and a
//      branch-free update (9 slots a pair) each ran slower at the farm's
//      largest shape on the card (throwaway runs, PERF.md).
//   2. Target splits when the queries alone would not fill the card (the
//      wrapper's _plan): CTA (x, s) scans its query block against the s-th
//      contiguous chunk of the lane's targets and writes a partial (d,
//      index); nn_merge folds the splits in order with the same strict <,
//      so the smallest d, and the lowest index among equal d, win whatever
//      the split count.
//   3. Double-buffered tiles: cp.async stages the next tile into the other
//      half of a two-stage ring while the current one is scanned.
//   4. Lanes are independent: a CTA reads one lane's queries and targets,
//      and nothing of a lane's result depends on the other lanes of the
//      batch (the farm repacks lanes every segment).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // 4 warps: one per scheduler
constexpr int kTile = 512;      // targets per ring stage (8 KB)
constexpr int kR = 4;           // queries a thread
constexpr int kGroup = 2;       // targets a thread scores between two tests
constexpr float kBig = 1e30f;

__device__ __forceinline__ float select_d(float qx, float qy, float qz, float q2, float4 p) {
  const float dot = __fmaf_rn(qz, p.z, __fmaf_rn(qy, p.y, __fmul_rn(qx, p.x)));
  return __fmaf_rn(-2.f, dot, __fadd_rn(q2, p.w));
}

__device__ __forceinline__ void load_tile(float4* dst, const float4* src) {
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + j));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src + j));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// t (B, m, 3) centred targets and t2 (B, m) -> t4 (B, m_pad) float4 (x, y,
// z, t2); entries past m are (0, 0, 0, +inf).
__global__ void nn_pack(const float* __restrict__ t, const float* __restrict__ t2, int lanes,
                        int m, int m_pad, float4* __restrict__ t4) {
  const long long total = static_cast<long long>(lanes) * m_pad;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long b = i / m_pad;
    const int j = static_cast<int>(i - b * m_pad);
    if (j < m) {
      const long long k = b * m + j;
      t4[i] = make_float4(t[3 * k], t[3 * k + 1], t[3 * k + 2], t2[k]);
    } else {
      t4[i] = make_float4(0.f, 0.f, 0.f, __int_as_float(0x7f800000));
    }
  }
}

// q (B, n, 3) centred queries, q2 (B, n); t4 (B, m_pad) packed targets.
// blockIdx.x = lane * q_blocks + query block, blockIdx.y = split s over
// targets [s * chunk, (s + 1) * chunk).  Writes (d, index) to out_d/out_i
// when part is null, else part[(s * B + lane) * n + i] as (d, index bits).
__global__ void __launch_bounds__(kThreads, 8)
nn_scan(const float* __restrict__ q, const float* __restrict__ q2, int n, int q_blocks,
        const float4* __restrict__ t4, int m_pad, int chunk, int lanes,
        float2* __restrict__ part, float* __restrict__ out_d, long long* __restrict__ out_i) {
  __shared__ __align__(16) float4 ring[2][kTile];
  const int lane = blockIdx.x / q_blocks;
  const int first = (blockIdx.x - lane * q_blocks) * (kR * kThreads) + threadIdx.x;
  const int j_begin = blockIdx.y * chunk;
  const float4* ts = t4 + static_cast<size_t>(lane) * m_pad + j_begin;
  const float* ql = q + static_cast<size_t>(lane) * n * 3;
  const float* q2l = q2 + static_cast<size_t>(lane) * n;
  const float neg_inf = -__int_as_float(0x7f800000);
  float qx[kR], qy[kR], qz[kR], qq[kR], bd[kR];
  int bi[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = first + r * kThreads;
    qx[r] = qy[r] = qz[r] = qq[r] = 0.f;
    bd[r] = kBig;
    bi[r] = 0;
    if (i < n) {
      qx[r] = ql[3 * i];
      qy[r] = ql[3 * i + 1];
      qz[r] = ql[3 * i + 2];
      qq[r] = q2l[i];
    } else {
      bd[r] = neg_inf;   // empty slot: never updates
    }
  }
  const int n_tiles = chunk / kTile;
  load_tile(ring[0], ts);
  for (int k = 0; k < n_tiles; ++k) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();   // tile k is in for all threads, and all are done with tile k-1
    if (k + 1 < n_tiles) load_tile(ring[(k + 1) & 1], ts + static_cast<size_t>(k + 1) * kTile);
    const float4* tile = ring[k & 1];
    const int j_tile = j_begin + k * kTile;
#pragma unroll 2
    for (int j = 0; j < kTile; j += kGroup) {
      float d[kGroup][kR];
      bool hit = false;
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const float4 p = tile[j + u];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          d[u][r] = select_d(qx[r], qy[r], qz[r], qq[r], p);
          hit |= d[u][r] < bd[r];
        }
      }
      if (hit) {   // in index order: the first of equal minima stays
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            if (d[u][r] < bd[r]) {
              bd[r] = d[u][r] > 0.f ? d[u][r] : neg_inf;
              bi[r] = j_tile + j + u;
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = first + r * kThreads;
    if (i >= n) continue;
    const float dv = bd[r] == neg_inf ? 0.f : bd[r];
    if (part != nullptr) {
      part[(static_cast<size_t>(blockIdx.y) * lanes + lane) * n + i] =
          make_float2(dv, __int_as_float(bi[r]));
    } else {
      const size_t o = static_cast<size_t>(lane) * n + i;
      out_d[o] = dv;
      out_i[o] = bi[r];
    }
  }
}

// part (splits, B * n) partial (d, index) -> out_d, out_i: the splits in
// order, a later one taken only when strictly smaller.
__global__ void nn_merge(const float2* __restrict__ part, long long rows, int splits,
                         float* __restrict__ out_d, long long* __restrict__ out_i) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= rows) return;
  float bd = kBig;
  int bi = 0;
  for (int s = 0; s < splits; ++s) {
    const float2 p = part[static_cast<size_t>(s) * rows + i];
    if (p.x < bd) {
      bd = p.x;
      bi = __float_as_int(p.y);
    }
  }
  out_d[i] = bd;
  out_i[i] = bi;
}

}  // namespace

// Block size, tile length and queries a thread; the wrapper's launch plan
// must use the same.
extern "C" void ltm_nn_argmin_config(int* threads, int* tile, int* r) {
  *threads = kThreads;
  *tile = kTile;
  *r = kR;
}

// Resident CTAs of nn_scan on one SM of the current device, or a negative
// CUDA error.
extern "C" int ltm_nn_argmin_ctas_per_sm() {
  int n = 0;
  const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, nn_scan, kThreads, 0);
  return rc == cudaSuccess ? n : -static_cast<int>(rc);
}

// q (lanes, n, 3) f32 centred queries, q2 (lanes, n); t (lanes, m, 3) f32
// centred targets, t2 (lanes, m) (1e30 at an invalid target); chunk a
// multiple of the tile, splits * chunk >= m.  Scratch the caller allocates:
// t4 (lanes, splits * chunk) float4; part (splits, lanes * n) float2 when
// splits > 1, else null.  Out: out_d (lanes, n) f32, the selection's
// distance (before the re-score), out_i (lanes, n) i64.  Launches the pack,
// the scan and, when splits > 1, the merge on `stream`, checks
// cudaGetLastError() after each and returns the first error (0 on
// success).  Does not synchronise.
extern "C" int ltm_nn_argmin(const float* q, const float* q2, const float* t, const float* t2,
                             int lanes, int n, int m, int chunk, int splits, void* t4, void* part,
                             float* out_d, long long* out_i, void* stream) {
  if (lanes <= 0 || n <= 0 || m <= 0 || chunk <= 0 || chunk % kTile != 0 || splits < 1 ||
      splits > 65535 || static_cast<long long>(splits) * chunk < m ||
      static_cast<long long>(splits) * chunk >= (1LL << 31) ||
      (splits > 1) != (part != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int q_blocks = (n + kR * kThreads - 1) / (kR * kThreads);
  if (static_cast<long long>(lanes) * q_blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* tv = static_cast<float4*>(t4);
  float2* p2 = static_cast<float2*>(part);
  const int m_pad = splits * chunk;
  const long long packed = static_cast<long long>(lanes) * m_pad;
  const long long pack_blocks = (packed + 255) / 256;
  nn_pack<<<static_cast<unsigned>(pack_blocks < 8192 ? pack_blocks : 8192), 256, 0, s>>>(
      t, t2, lanes, m, m_pad, tv);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const dim3 grid(lanes * q_blocks, splits);
  nn_scan<<<grid, kThreads, 0, s>>>(q, q2, n, q_blocks, tv, m_pad, chunk, lanes, p2, out_d,
                                    out_i);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || splits == 1) return rc;
  const long long rows = static_cast<long long>(lanes) * n;
  nn_merge<<<static_cast<unsigned>((rows + 255) / 256), 256, 0, s>>>(p2, rows, splits, out_d,
                                                                     out_i);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ltm_nn_argmin_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
