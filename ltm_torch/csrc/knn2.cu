// Brute-force 2-NN squared distances, CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel ltm/kernels/pallas_knn.py::knn2_sqdists_pallas
// (body _kernel): for each valid query, the squared distances to its two
// nearest valid targets, ascending.  Invalid queries get 1e30 rows; fewer
// than two valid targets pads with 1e30; a duplicated target counts twice.
// Every distance is fma(dz, dz, fma(dy, dy, dx*dx)) on the ORIGINAL
// coordinates, in the order XLA's CPU reduction gives the pipeline's exact
// re-score (ltm/kernels/knn.py:111-113); the _rn intrinsics fix every
// rounding (nvcc can neither contract nor split them), so each distance is
// the float32 value the plain PyTorch version computes.
//
// What bounds it: operations on the VALID pairs.  A pair costs 3 FADD,
// 1 FMUL and 2 FFMA (8 FP32 flops, an FMA counted as two: 67 TFLOP/s on
// an H100 SXM), plus its share of the top-2 test.  Each of those takes an
// issue slot, so a loop of ~7 slots a pair tops out near 4/7 of the flop
// bound.  The bytes are tiny (each point read once, each row written once).
//
// What the design does about it:
//   1. Only valid points enter.  knn2_compact writes the valid targets
//      into one float4 (x, y, z, 0) array, padded with +inf points to whole
//      tiles, and the valid queries into an index list, from the masks'
//      prefix sums (torch.cumsum in the wrapper, whose one host sync reads
//      the two counts); the scan writes each result row through that index.
//      No pair with an invalid point is ever scored.
//   2. kR = 8 queries a thread, kept in registers with their running
//      top-2s.  Each target read from shared memory (a broadcast LDS.128)
//      serves kR pairs.  (4 ties 8 on the card and 16 is slower: PERF.md;
//      to measure another count, edit kR and its mirror in knn2.py.)
//      The top-2 test is one FSETP a pair, OR-ed over a group of 32 pairs
//      (kGroup targets x kR queries) with a single branch; the update (3 FMNMX a pair, no branch, so a warp whose
//      queries improve at different targets does not diverge) runs only
//      when some pair beats its slot 2, which becomes rare once the lists
//      warm up.  An empty query slot has slot 2 at -inf, so it never passes.
//   3. Target splits when the query grid alone would not fill the card.
//      The wrapper's launch plan (_plan) gives S splits; CTA (x, s) scans
//      query block x against the s-th contiguous chunk of targets and
//      writes a partial top-2 to scratch, and knn2_merge folds the S
//      partials of each query through the same update and writes the row.
//      The merge is exact: the two smallest of a multiset do not depend on
//      the order they are taken in, and ties go to slot 2, so duplicates
//      across a split boundary still count twice.
//   4. Double-buffered tiles: cp.async copies the next 16-byte-aligned
//      tile into the other half of a two-stage ring while the current one
//      is scanned, with one __syncthreads() a tile and no registers spent
//      on the copy.
//
// Why not tensor cores: the TPU kernel selects on |q|^2+|t|^2-2q.t on the
// MXU and re-scores.  That form loses ~|x|^2*eps to cancellation; queries
// and targets here come in map order, not spatially sorted, so recentring
// a tile does not bound |x|, and at |x| ~ 600 m the error (~0.02 m^2) is
// the size of the pipeline's 0.04 m^2 kNN threshold.  A tensor-core
// selection is worth having only over spatially sorted tiles (the chunked
// kNN); this kernel stays on the FP32 cores with the exact direct form.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // 4 warps: one per scheduler
constexpr int kTile = 512;      // targets per ring stage (8 KB)
constexpr int kR = 8;           // queries a thread
constexpr int kPairs = 32;      // pairs a thread scores between two top-2 tests
constexpr float kBig = 1e30f;

__device__ __forceinline__ float sqdist(float qx, float qy, float qz, float4 p) {
  const float dx = __fsub_rn(qx, p.x);
  const float dy = __fsub_rn(qy, p.y);
  const float dz = __fsub_rn(qz, p.z);
  return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
}

// Running top-2, without branches (3 FMNMX): an equal value goes into
// slot 2, so duplicates count twice.  In the scan it is a group's slow
// path, which a warp takes when any of its 32 x kR queries improves, so it
// runs often while the lists warm up and must not diverge.
__device__ __forceinline__ void push2(float d, float& b1, float& b2) {
  b2 = fminf(b2, fmaxf(b1, d));
  b1 = fminf(b1, d);
}

__device__ __forceinline__ void load_tile(float4* dst, const float4* src) {
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + j));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src + j));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// q (n,3) original queries, qidx (n_valid,) their rows, t (splits*chunk)
// compacted float4 targets.  CTA (x, s): queries x*kR*kThreads + r*kThreads
// + threadIdx.x, r < kR, against targets [s*chunk, (s+1)*chunk).  Writes
// out rows through qidx when part is null, else part[s*n_valid + i].
__global__ void __launch_bounds__(kThreads, 5)
knn2_scan(const float* __restrict__ q, const int* __restrict__ qidx, int n_valid,
          const float4* __restrict__ t, int chunk, float2* __restrict__ part,
          float* __restrict__ out) {
  constexpr int kGroup = kPairs / kR;   // targets a group
  __shared__ __align__(16) float4 ring[2][kTile];
  const float4* ts = t + static_cast<size_t>(blockIdx.y) * chunk;
  const int base = blockIdx.x * (kR * kThreads) + threadIdx.x;
  float qx[kR], qy[kR], qz[kR], b1[kR], b2[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = base + r * kThreads;
    qx[r] = qy[r] = qz[r] = 0.f;
    b1[r] = kBig;
    b2[r] = kBig;
    if (i < n_valid) {
      const size_t k = 3 * static_cast<size_t>(qidx[i]);
      qx[r] = q[k];
      qy[r] = q[k + 1];
      qz[r] = q[k + 2];
    } else {
      b2[r] = -__int_as_float(0x7f800000);   // empty slot: never passes
    }
  }
  const int n_tiles = chunk / kTile;
  load_tile(ring[0], ts);
  for (int k = 0; k < n_tiles; ++k) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();   // tile k is in for all threads, and all are done with tile k-1
    if (k + 1 < n_tiles) load_tile(ring[(k + 1) & 1], ts + static_cast<size_t>(k + 1) * kTile);
    const float4* tile = ring[k & 1];
#pragma unroll 2
    for (int j = 0; j < kTile; j += kGroup) {
      float d[kGroup][kR];
      bool hit = false;
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const float4 p = tile[j + u];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          d[u][r] = sqdist(qx[r], qy[r], qz[r], p);
          hit |= d[u][r] < b2[r];
        }
      }
      if (hit) {
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
#pragma unroll
          for (int r = 0; r < kR; ++r) push2(d[u][r], b1[r], b2[r]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = base + r * kThreads;
    if (i >= n_valid) continue;
    if (part != nullptr) {
      part[static_cast<size_t>(blockIdx.y) * n_valid + i] = make_float2(b1[r], b2[r]);
    } else {
      const size_t o = 2 * static_cast<size_t>(qidx[i]);
      out[o] = b1[r];
      out[o + 1] = b2[r];
    }
  }
}

// Compaction, one thread an element: qidx[q_rank[i]-1] = i for a valid
// query and a 1e30 out row for an invalid one; t4[t_rank[j]-1] = (x, y, z,
// 0) for a valid target, and +inf points in [m_valid, m_pad).  The ranks
// are the masks' inclusive prefix sums.
__global__ void knn2_compact(const bool* __restrict__ qmask, const long long* __restrict__ q_rank,
                             int n, const bool* __restrict__ tmask,
                             const long long* __restrict__ t_rank, const float* __restrict__ t,
                             int m, int m_valid, int m_pad, int* __restrict__ qidx,
                             float4* __restrict__ t4, float* __restrict__ out) {
  const float inf = __int_as_float(0x7f800000);
  const int end = max(n, max(m, m_pad));
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < end; i += gridDim.x * blockDim.x) {
    if (i < n) {
      if (qmask[i]) {
        qidx[q_rank[i] - 1] = i;
      } else {
        out[2 * static_cast<size_t>(i)] = kBig;
        out[2 * static_cast<size_t>(i) + 1] = kBig;
      }
    }
    if (i < m && tmask[i]) {
      const size_t k = 3 * static_cast<size_t>(i);
      t4[t_rank[i] - 1] = make_float4(t[k], t[k + 1], t[k + 2], 0.f);
    }
    if (i >= m_valid && i < m_pad) t4[i] = make_float4(inf, inf, inf, 0.f);
  }
}

// part (splits, n_valid) partial top-2s -> out rows through qidx.
__global__ void knn2_merge(const float2* __restrict__ part, const int* __restrict__ qidx,
                           int n_valid, int splits, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_valid) return;
  float b1 = kBig, b2 = kBig;
#pragma unroll 4
  for (int s = 0; s < splits; ++s) {
    const float2 p = part[static_cast<size_t>(s) * n_valid + i];
    push2(p.x, b1, b2);
    push2(p.y, b1, b2);
  }
  const size_t o = 2 * static_cast<size_t>(qidx[i]);
  out[o] = b1;
  out[o + 1] = b2;
}

}  // namespace

// Block size, tile length and queries a thread; the wrapper's launch plan
// must use the same.
extern "C" void ltm_knn2_config(int* threads, int* tile, int* r) {
  *threads = kThreads;
  *tile = kTile;
  *r = kR;
}

// Resident CTAs of knn2_scan on one SM of the current device, or a
// negative CUDA error.
extern "C" int ltm_knn2_ctas_per_sm() {
  int n = 0;
  const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, knn2_scan, kThreads, 0);
  return rc == cudaSuccess ? n : -static_cast<int>(rc);
}

// q (n,3) f32 queries, qmask (n,) bool, q_rank (n,) i64 its inclusive
// prefix sum, n_valid = q_rank[n-1] > 0; t (m,3), tmask, t_rank likewise,
// m_valid > 0; chunk a multiple of the tile, splits chunks.  Scratch the
// caller allocates: qidx (n_valid,) i32, t4 (splits*chunk,) float4, part
// (splits, n_valid) float2 when splits > 1, else null.  out (n,2) f32.
// Launches the compaction, the scan and, when
// splits > 1, the merge on `stream`, checks cudaGetLastError() after each
// and returns the first error (0 on success).  Does not synchronise.
extern "C" int ltm_knn2_sqdists(const float* q, const bool* qmask, const long long* q_rank,
                                int n, const float* t, const bool* tmask,
                                const long long* t_rank, int m, int n_valid, int m_valid,
                                int chunk, int splits, int* qidx, void* t4, void* part,
                                float* out, void* stream) {
  if (n_valid <= 0 || n_valid > n || m_valid <= 0 || m_valid > m || chunk <= 0 ||
      chunk % kTile != 0 || splits < 1 || splits > 65535 ||
      static_cast<long long>(splits) * chunk < m_valid || (splits > 1) != (part != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* tv = static_cast<float4*>(t4);
  float2* p2 = static_cast<float2*>(part);
  const int m_pad = splits * chunk;
  const int end = max(n, max(m, m_pad));
  knn2_compact<<<min((end + 255) / 256, 4096), 256, 0, s>>>(
      qmask, q_rank, n, tmask, t_rank, t, m, m_valid, m_pad, qidx, tv, out);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const dim3 grid((n_valid + kR * kThreads - 1) / (kR * kThreads), splits);
  knn2_scan<<<grid, kThreads, 0, s>>>(q, qidx, n_valid, tv, chunk, p2, out);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || splits == 1) return rc;
  knn2_merge<<<(n_valid + 255) / 256, 256, 0, s>>>(p2, qidx, n_valid, splits, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ltm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
