// Chunked block 2-NN scan, CUDA C++ for Hopper (sm_90a).
//
// Replaces the XLA-lowered scan ltm/kernels/chunk_knn.py::_scan_chunks
// (a lax.scan over chunks with a lax.cond skip).  Input: Morton-sorted
// queries cut into C chunks, and a target block layout with per-block
// tight AABBs.  One CTA a chunk:
//   1. counts the chunk's valid queries; a chunk with none writes 1e30 rows
//      and exits at once (lax.cond's _empty);
//   2. sums the valid queries as a pairwise tree over the next power of two
//      (zero padded: x[i] += x[i + h], h = P/2 .. 1), the order
//      ltm_torch.kernels.chunk_knn._tree_sum takes, and divides by the
//      count: the center; the radius is the largest distance of a valid
//      query from it;
//   3. tests every valid block's point-to-AABB distance against
//      radius + clamp_radius, counts all hits and lists them in shared
//      memory (at most min(k_blocks, n_blocks));
//   4. when more than k_blocks blocks hit, writes the overflow count and NaN
//      rows for its valid queries (the caller re-resolves every query of an
//      overflowed chunk; ltm's lax.top_k of the nearest k_blocks is not
//      reproduced);
//   5. otherwise stages the valid slots of the listed blocks in shared
//      memory, kTile points at a time, and keeps a running top 2 of each
//      valid query, then clamps it at r^2.
// Every distance is fma(dz, dz, fma(dy, dy, dx*dx)) (the _rn intrinsics fix
// every rounding), the FMA chain ltm computes under jit on the CPU and
// ltm_torch.kernels.projection.sumsq3 reproduces.  The top-2 update is
// branch-free and puts an equal value in slot 2, so a duplicate counts
// twice, as ltm's k-fold argmin.  The two smallest of a multiset do not
// depend on the order they are taken in, so the unordered hit list and the
// atomic staging give the plain version's bits.  Invalid queries get 1e30
// rows.  The center is a reduction in another order than XLA's: a block on
// the exact boundary may be listed on one side and not the other, which
// under the clamp contract changes no clamped distance.
//
// What bounds it: operations on the scored pairs (8 FP32 flops a pair, an
// FMA counted as two; 67 TFLOP/s on an H100 SXM), or the bytes of the block
// gather where a chunk lists many sparse blocks.  This first version is
// simple: a thread keeps Q <= 8 queries in registers, each staged point is
// one broadcast shared-memory load for Q pairs, and every pair takes the
// three-instruction top-2 update.  The block test reads every block's
// bounds once a chunk (from L2).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxChunk = 1024;               // queries a chunk
constexpr int kTile = 1024;                   // staged target points (16 KB)
constexpr int kMaxList = 49152;               // listed blocks (192 KB of dynamic shared memory)
constexpr float kBig = 1e30f;

__device__ __forceinline__ float sumsq3(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
}

__device__ __forceinline__ void push2(float d, float& b1, float& b2) {
  b2 = fminf(b2, fmaxf(b1, d));
  b1 = fminf(b1, d);
}

// qx (C*chunk, 3), qm (C*chunk) sorted queries; bxyz (n_blocks*cap, 3),
// tmask (n_blocks*cap) the targets; bval, blo, bhi (n_blocks[, 3]) the
// blocks' validity and AABBs.  out (C*chunk, 2), overflow (C).
template <int Q>
__global__ void __launch_bounds__(kThreads)
chunk_knn_scan(const float* __restrict__ qx, const bool* __restrict__ qm, int chunk,
               const float* __restrict__ bxyz, const bool* __restrict__ tmask,
               const bool* __restrict__ bval, const float* __restrict__ blo,
               const float* __restrict__ bhi, int n_blocks, int cap, float clamp_radius,
               float r2, int k_blocks, float* __restrict__ out, int* __restrict__ overflow) {
  extern __shared__ int list[];
  __shared__ float red[3][kMaxChunk];
  __shared__ __align__(16) float4 tile[kTile];
  __shared__ float s_center[3];
  __shared__ int s_cnt, s_hits, s_rad, s_staged;

  const int tid = threadIdx.x;
  const size_t q0 = static_cast<size_t>(blockIdx.x) * chunk;
  int p2 = 1;
  while (p2 < chunk) p2 <<= 1;
  if (tid == 0) {
    s_cnt = 0;
    s_hits = 0;
    s_rad = 0;
  }
  float x[Q], y[Q], z[Q];
  bool v[Q];
  int mine = 0;
#pragma unroll
  for (int r = 0; r < Q; ++r) {
    const int i = tid + r * kThreads;
    v[r] = i < chunk && qm[q0 + i];
    x[r] = y[r] = z[r] = 0.f;
    if (v[r]) {
      x[r] = qx[3 * (q0 + i)];
      y[r] = qx[3 * (q0 + i) + 1];
      z[r] = qx[3 * (q0 + i) + 2];
      ++mine;
    }
  }
  for (int i = tid; i < p2; i += kThreads) {
    const bool ok = i < chunk && qm[q0 + i];
#pragma unroll
    for (int a = 0; a < 3; ++a) red[a][i] = ok ? qx[3 * (q0 + i) + a] : 0.f;
  }
  __syncthreads();
  if (mine) atomicAdd(&s_cnt, mine);
  __syncthreads();
  const int cnt = s_cnt;
  if (cnt == 0) {   // an all-invalid chunk: the tail of a padded query set
    for (int i = tid; i < 2 * chunk; i += kThreads) out[2 * q0 + i] = kBig;
    if (tid == 0) overflow[blockIdx.x] = 0;
    return;
  }
  for (int h = p2 / 2; h >= 1; h >>= 1) {
    for (int i = tid; i < h; i += kThreads) {
#pragma unroll
      for (int a = 0; a < 3; ++a) red[a][i] = __fadd_rn(red[a][i], red[a][i + h]);
    }
    __syncthreads();
  }
  if (tid == 0) {
    const float n = static_cast<float>(cnt);
#pragma unroll
    for (int a = 0; a < 3; ++a) s_center[a] = __fdiv_rn(red[a][0], n);
  }
  __syncthreads();
  const float cx = s_center[0], cy = s_center[1], cz = s_center[2];
  float rad = 0.f;
#pragma unroll
  for (int r = 0; r < Q; ++r) {
    if (v[r]) {
      rad = fmaxf(rad, __fsqrt_rn(sumsq3(__fsub_rn(x[r], cx), __fsub_rn(y[r], cy),
                                         __fsub_rn(z[r], cz))));
    }
  }
  atomicMax(&s_rad, __float_as_int(rad));   // non-negative floats order as ints
  __syncthreads();
  const float reach = __fadd_rn(__int_as_float(s_rad), clamp_radius);

  const int list_cap = min(k_blocks, n_blocks);
  for (int b = tid; b < n_blocks; b += kThreads) {
    if (!bval[b]) continue;
    const float* lo = blo + 3 * static_cast<size_t>(b);
    const float* hi = bhi + 3 * static_cast<size_t>(b);
    const float gx = fmaxf(fmaxf(__fsub_rn(lo[0], cx), __fsub_rn(cx, hi[0])), 0.f);
    const float gy = fmaxf(fmaxf(__fsub_rn(lo[1], cy), __fsub_rn(cy, hi[1])), 0.f);
    const float gz = fmaxf(fmaxf(__fsub_rn(lo[2], cz), __fsub_rn(cz, hi[2])), 0.f);
    if (__fsqrt_rn(sumsq3(gx, gy, gz)) <= reach) {
      const int h = atomicAdd(&s_hits, 1);
      if (h < list_cap) list[h] = b;
    }
  }
  __syncthreads();
  const int n_int = s_hits;
  if (n_int > k_blocks) {
    const float nan = __int_as_float(0x7fc00000);
#pragma unroll
    for (int r = 0; r < Q; ++r) {
      const int i = tid + r * kThreads;
      if (i < chunk) {
        out[2 * (q0 + i)] = v[r] ? nan : kBig;
        out[2 * (q0 + i) + 1] = v[r] ? nan : kBig;
      }
    }
    if (tid == 0) overflow[blockIdx.x] = n_int - k_blocks;
    return;
  }

  float b1[Q], b2[Q];
#pragma unroll
  for (int r = 0; r < Q; ++r) b1[r] = b2[r] = kBig;
  const int per_tile = kTile / cap;   // whole blocks a staging round
  for (int l0 = 0; l0 < n_int; l0 += per_tile) {
    if (tid == 0) s_staged = 0;
    __syncthreads();
    const int slots = min(per_tile, n_int - l0) * cap;
    for (int j = tid; j < slots; j += kThreads) {
      const size_t s = static_cast<size_t>(list[l0 + j / cap]) * cap + j % cap;
      if (tmask[s]) {
        tile[atomicAdd(&s_staged, 1)] =
            make_float4(bxyz[3 * s], bxyz[3 * s + 1], bxyz[3 * s + 2], 0.f);
      }
    }
    __syncthreads();
    const int m = s_staged;
    for (int j = 0; j < m; ++j) {
      const float4 p = tile[j];
#pragma unroll
      for (int r = 0; r < Q; ++r) {
        push2(sumsq3(__fsub_rn(x[r], p.x), __fsub_rn(y[r], p.y), __fsub_rn(z[r], p.z)),
              b1[r], b2[r]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < Q; ++r) {
    const int i = tid + r * kThreads;
    if (i < chunk) {
      out[2 * (q0 + i)] = v[r] ? fminf(b1[r], r2) : kBig;
      out[2 * (q0 + i) + 1] = v[r] ? fminf(b2[r], r2) : kBig;
    }
  }
  if (tid == 0) overflow[blockIdx.x] = 0;
}

template <int Q>
int launch(dim3 grid, size_t list_bytes, cudaStream_t s, const float* qx, const bool* qm,
           int chunk, const float* bxyz, const bool* tmask, const bool* bval, const float* blo,
           const float* bhi, int n_blocks, int cap, float clamp_radius, float r2, int k_blocks,
           float* out, int* overflow) {
  cudaError_t rc = cudaFuncSetAttribute(chunk_knn_scan<Q>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(list_bytes));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  chunk_knn_scan<Q><<<grid, kThreads, list_bytes, s>>>(qx, qm, chunk, bxyz, tmask, bval, blo,
                                                       bhi, n_blocks, cap, clamp_radius, r2,
                                                       k_blocks, out, overflow);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Largest chunk, block capacity and block list the scan takes; the wrapper
// checks its arguments against them.
extern "C" void ltm_chunk_knn_limits(int* max_chunk, int* max_cap, int* max_list) {
  *max_chunk = kMaxChunk;
  *max_cap = kTile;
  *max_list = kMaxList;
}

// qx (n_chunks*chunk, 3) f32 sorted queries, qm bool; bxyz (n_blocks*cap,
// 3) f32, tmask bool; bval (n_blocks) bool, blo/bhi (n_blocks, 3) f32.
// clamp_radius and r2 = float(clamp_radius^2) as the caller rounds them.
// out (n_chunks*chunk, 2) f32, overflow (n_chunks) i32.  Launches one CTA a
// chunk on `stream`, checks cudaGetLastError() and returns it (0 on
// success).  Does not synchronise.
extern "C" int ltm_chunk_knn_scan(const float* qx, const bool* qm, const float* bxyz,
                                  const bool* tmask, const bool* bval, const float* blo,
                                  const float* bhi, int n_chunks, int chunk, int n_blocks,
                                  int cap, float clamp_radius, float r2, int k_blocks,
                                  float* out, int* overflow, void* stream) {
  if (n_chunks <= 0 || chunk <= 0 || chunk > kMaxChunk || n_blocks <= 0 || cap <= 0 ||
      cap > kTile || k_blocks <= 0 || min(k_blocks, n_blocks) > kMaxList) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t list_bytes = sizeof(int) * static_cast<size_t>(min(k_blocks, n_blocks));
  const dim3 grid(n_chunks);
  const int per_thread = (chunk + kThreads - 1) / kThreads;
  if (per_thread <= 1) {
    return launch<1>(grid, list_bytes, s, qx, qm, chunk, bxyz, tmask, bval, blo, bhi, n_blocks,
                     cap, clamp_radius, r2, k_blocks, out, overflow);
  }
  if (per_thread <= 2) {
    return launch<2>(grid, list_bytes, s, qx, qm, chunk, bxyz, tmask, bval, blo, bhi, n_blocks,
                     cap, clamp_radius, r2, k_blocks, out, overflow);
  }
  if (per_thread <= 4) {
    return launch<4>(grid, list_bytes, s, qx, qm, chunk, bxyz, tmask, bval, blo, bhi, n_blocks,
                     cap, clamp_radius, r2, k_blocks, out, overflow);
  }
  return launch<8>(grid, list_bytes, s, qx, qm, chunk, bxyz, tmask, bval, blo, bhi, n_blocks,
                   cap, clamp_radius, r2, k_blocks, out, overflow);
}

extern "C" const char* ltm_chunk_knn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
