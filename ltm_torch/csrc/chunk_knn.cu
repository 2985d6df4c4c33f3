// Chunked block 2-NN, CUDA C++ for Hopper (sm_90a).
//
// Replaces the XLA-lowered ltm/kernels/chunk_knn.py::chunk_knn_sqdists: the
// Morton sort of _prep_sorted_chunks (the keys, and their stable sort by
// CUB's radix sort in the same C call, as ltm sorts outside _scan_chunks),
// the AABBs of _block_bounds, the scan _scan_chunks (a lax.scan over chunks
// with a lax.cond skip) and the write-back by order.
// Every distance is fma(dz, dz, fma(dy, dy, dx*dx)) with the _rn
// intrinsics, the FMA chain ltm computes under jit on the CPU and
// ltm_torch.kernels.projection.sumsq3 reproduces; an overflowed chunk
// writes NaN rows for its valid queries (the caller re-resolves them),
// invalid queries 1e30 rows.
//
// What bounds it: operations on the scored pairs (8 FP32 flops a pair, an
// FMA counted as two; 67 TFLOP/s on an H100 SXM) where the chunks list many
// blocks, the bytes of reading the queries and the block map once where
// they list few.  The first version lost on three counts: one CTA walked a
// chunk's whole list alone (an escalation call of 21-29 chunks left most of
// the 132 SMs idle), every chunk tested every block (4 096 chunks x 32 768
// blocks at full width), and the prep around the scan (bounds, sort, padded
// copies, the write-back) were some twenty torch launches.  The kernels:
//
//   ck_cell_min, ck_keys   the Morton keys: each CTA's minimum cell of the
//                          valid queries, then floor(x * f32(1/sort_cell))
//                          less that minimum, clamped to 10 bits an axis
//                          and interleaved; invalid queries key INT_MAX.
//                          The same pass writes each query's index; CUB's
//                          stable cub::DeviceRadixSort::SortPairs over the
//                          keys' low 31 bits gives the order in the same C
//                          call; a sort enqueued from Python (~0.1 ms of
//                          host time) was most of an escalation call.
//   ck_bounds              one pass over the slots (mask & target_extra):
//                          each block's tight AABB and validity, and the AABB
//                          of each super-block of kSuper = 32 consecutive
//                          blocks.  The layout orders blocks by coarse voxel
//                          and sub-cell Morton code, so consecutive blocks
//                          are close in space and a super-block is compact.
//   ck_cull                one CTA a chunk, reading its queries through
//                          order: the count, the center (a pairwise tree sum
//                          over the next power of two, the order the plain
//                          version takes), the radius and reach = radius +
//                          clamp_radius; a lane tests a super-block, and only
//                          the blocks of the super-blocks that pass are
//                          tested, a lane a block.  The cull is exact: a
//                          super-block's AABB contains its blocks' AABBs,
//                          fl(a - c) is monotone in a, and max(., 0), sumsq3
//                          (FMAs of non-negative terms) and the square root
//                          are monotone, so a super-block's rounded gap is
//                          never above any of its blocks' and no listed block
//                          is lost.  The hits go to device memory (at most
//                          min(k_blocks, n_blocks) a chunk); the CTA writes
//                          every row the scoring will not (invalid queries,
//                          empty and overflowed chunks, chunks with no hit)
//                          and appends its work items, (chunk, query slab of
//                          256, segment of `seg` listed blocks, a parameter
//                          of the call), to a list.  It counts its block
//                          tests into the call's counters.
//   ck_score               persistent warps that take work items from a
//                          device counter, so a chunk with a thousand listed
//                          blocks spreads over every SM.  A lane keeps kR = 8
//                          queries with their running top 2, which starts at
//                          (r^2, r^2): the two smallest of the distances and
//                          two copies of r^2 are the clamped top 2, bit for
//                          bit, and only pairs nearer than the clamp take the
//                          update, so an item of a few blocks does not spend
//                          its groups warming a top 2 up from 1e30; a block is
//                          staged 128 slots at a time by cp.async of the
//                          16-byte units that cover them (any capacity and
//                          any alignment of the arrays), its valid slots
//                          compacted by a ballot into float4s in the warp's
//                          shared memory (up to three +inf sentinels pad it
//                          to a group of kGroup points); one OR-ed test a
//                          group of 32 pairs decides whether the branch-free
//                          update runs.  A chunk of one segment writes its
//                          rows through order; a chunk of several folds its
//                          partial top 2 into a packed 64-bit (b1 <= b2) word
//                          per query with atomicCAS.
//   ck_merge               the rows of the chunks of several segments, from
//                          the packed words (launched only when a chunk can
//                          list more than `seg` blocks).
//
// The merge is exact: the two smallest of a multiset do not depend on the
// order they are taken in, and the update puts an equal value in slot 2, so
// a duplicate counts twice on either side of a segment boundary, as ltm's
// k-fold argmin.  Unordered hit lists, unordered work items and atomic
// merges therefore give the plain version's bits.  The host reads nothing:
// grid sizes come from the chunk count, min(k_blocks, n_blocks) and `seg`.
// Two C entries: the prep (keys, sort, bounds) and the scan (cull,
// scoring, merge), each one ctypes call.
//
// Why not tensor cores: the matmul form |q|^2 + |t|^2 - 2 q.t carries
// ~0.5 m^2 of cancellation error at km coordinates and picks wrong
// candidates (ltm/kernels/chunk_knn.py:156-161); the contract is the bits
// of the direct form.

#include <cuda_runtime.h>

#include <algorithm>

#include <cub/device/device_radix_sort.cuh>

namespace {

constexpr int kWarp = 32;
constexpr int kR = 8;                  // queries a lane
constexpr int kSlab = kR * kWarp;      // queries a work item
constexpr int kSuper = 32;             // blocks a super-block: one lane each in the cull
constexpr int kPiece = 128;            // slots staged at a time: 4 a lane
constexpr int kGroup = 4;              // staged points between two top-2 tests (x kR = 32 pairs)
constexpr int kMaxChunk = 1024;        // queries a chunk
constexpr int kCullThreads = 128;
constexpr int kScoreWarps = 4;
constexpr int kBoundsThreads = 256;
constexpr int kPrepThreads = 256;
constexpr int kPrepCtas = 512;         // CTAs of the cell minimum (its partials)
constexpr int kKeyBits = 31;           // key bits the sort orders: 30 of Morton code, INT_MAX
constexpr int kCounts = 5;             // counts a scan writes (ltm_chunk_knn_scan)
constexpr float kBig = 1e30f;

__device__ __forceinline__ float sumsq3(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
}

// Running top-2, without branches: an equal value goes into slot 2, so
// duplicates count twice.
__device__ __forceinline__ void push2(float d, float& b1, float& b2) {
  b2 = fminf(b2, fmaxf(b1, d));
  b1 = fminf(b1, d);
}

__device__ __forceinline__ unsigned long long pack2(float b1, float b2) {
  return (static_cast<unsigned long long>(__float_as_uint(b2)) << 32) | __float_as_uint(b1);
}

__device__ __forceinline__ int cell_of(float x, float inv) {
  return __float2int_rz(floorf(__fmul_rn(x, inv)));
}

__device__ __forceinline__ int spread3(int v) {
  v = (v | (v << 16)) & 0x030000FF;
  v = (v | (v << 8)) & 0x0300F00F;
  v = (v | (v << 4)) & 0x030C30C3;
  v = (v | (v << 2)) & 0x09249249;
  return v;
}

__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

// Point-to-AABB distance of the center against reach, for a box whose .w
// says whether it holds a valid point (ltm_torch.kernels.chunk_knn's test).
__device__ __forceinline__ bool box_hit(float4 lo, float4 hi, float cx, float cy, float cz,
                                        float reach) {
  if (lo.w == 0.f) return false;
  const float gx = fmaxf(fmaxf(__fsub_rn(lo.x, cx), __fsub_rn(cx, hi.x)), 0.f);
  const float gy = fmaxf(fmaxf(__fsub_rn(lo.y, cy), __fsub_rn(cy, hi.y)), 0.f);
  const float gz = fmaxf(fmaxf(__fsub_rn(lo.z, cz), __fsub_rn(cz, hi.z)), 0.f);
  return __fsqrt_rn(sumsq3(gx, gy, gz)) <= reach;
}

// ---- prep: the Morton keys -------------------------------------------------

// part[3 * blockIdx.x + a]: the smallest cell of the valid queries this CTA
// visits along axis a (2^30 where it visits none).
__global__ void __launch_bounds__(kPrepThreads)
ck_cell_min(const float* __restrict__ q, const bool* __restrict__ qm, int n, float inv,
            int* __restrict__ part) {
  __shared__ int s_min[3][kPrepThreads / kWarp];
  int m[3] = {1 << 30, 1 << 30, 1 << 30};
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    if (!qm[i]) continue;
#pragma unroll
    for (int a = 0; a < 3; ++a) m[a] = min(m[a], cell_of(q[3 * static_cast<size_t>(i) + a], inv));
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    for (int o = kWarp / 2; o > 0; o >>= 1) m[a] = min(m[a], __shfl_xor_sync(~0u, m[a], o));
  }
  const int warp = threadIdx.x / kWarp;
  if (threadIdx.x % kWarp == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) s_min[a][warp] = m[a];
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    int v = 1 << 30;
    for (int w = 0; w < kPrepThreads / kWarp; ++w) v = min(v, s_min[threadIdx.x][w]);
    part[3 * blockIdx.x + threadIdx.x] = v;
  }
}

// keys[i]: the Morton key of query i's cell less the minimum over part
// (n_part CTAs' partials), each axis clamped to [0, 1023]; INT_MAX for an
// invalid query.  The subtraction wraps as int32 tensor arithmetic does.
// idx[i] = i, the values the sort permutes.
__global__ void __launch_bounds__(kPrepThreads)
ck_keys(const float* __restrict__ q, const bool* __restrict__ qm, int n, float inv,
        const int* __restrict__ part, int n_part, unsigned* __restrict__ keys,
        int* __restrict__ idx) {
  __shared__ int s_min[3];
  if (threadIdx.x < 3) {
    int v = 1 << 30;
    for (int b = 0; b < n_part; ++b) v = min(v, part[3 * b + threadIdx.x]);
    s_min[threadIdx.x] = v;
  }
  __syncthreads();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    idx[i] = i;
    if (!qm[i]) {
      keys[i] = 0x7fffffffu;
      continue;
    }
    int key = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int d = static_cast<int>(static_cast<unsigned>(cell_of(q[3 * static_cast<size_t>(i) + a], inv)) -
                                     static_cast<unsigned>(s_min[a]));
      key |= spread3(min(max(d, 0), 1023)) << a;
    }
    keys[i] = key;
  }
}

// ---- bounds ----------------------------------------------------------------

// One CTA a super-block, a warp a block at a time: lo4/hi4[b] the AABB of
// block b's valid slots (mask, and extra unless null), .w of lo4 1 when it
// has one; slo4/shi4 the same over the super-block's blocks.  A block with
// no valid slot has lo = +inf, hi = -inf.
__global__ void __launch_bounds__(kBoundsThreads)
ck_bounds(const float* __restrict__ xyz, const bool* __restrict__ mask,
          const bool* __restrict__ extra, int n_blocks, int cap, float4* __restrict__ lo4,
          float4* __restrict__ hi4, float4* __restrict__ slo4, float4* __restrict__ shi4) {
  constexpr int kWarps = kBoundsThreads / kWarp;
  __shared__ float s_lo[kWarps][3], s_hi[kWarps][3];
  __shared__ int s_any[kWarps];
  const float inf = __int_as_float(0x7f800000);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  float slo[3] = {inf, inf, inf}, shi[3] = {-inf, -inf, -inf};
  bool sany = false;
  for (int k = warp; k < kSuper; k += kWarps) {
    const int b = blockIdx.x * kSuper + k;
    if (b >= n_blocks) break;
    float lo[3] = {inf, inf, inf}, hi[3] = {-inf, -inf, -inf};
    bool any = false;
    for (int j = lane; j < cap; j += kWarp) {
      const size_t s = static_cast<size_t>(b) * cap + j;
      if (mask[s] && (extra == nullptr || extra[s])) {
        any = true;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float v = xyz[3 * s + a];
          lo[a] = fminf(lo[a], v);
          hi[a] = fmaxf(hi[a], v);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      for (int o = kWarp / 2; o > 0; o >>= 1) {
        lo[a] = fminf(lo[a], __shfl_xor_sync(~0u, lo[a], o));
        hi[a] = fmaxf(hi[a], __shfl_xor_sync(~0u, hi[a], o));
      }
      slo[a] = fminf(slo[a], lo[a]);
      shi[a] = fmaxf(shi[a], hi[a]);
    }
    any = __any_sync(~0u, any);
    sany |= any;
    if (lane == 0) {
      lo4[b] = make_float4(lo[0], lo[1], lo[2], any ? 1.f : 0.f);
      hi4[b] = make_float4(hi[0], hi[1], hi[2], 0.f);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      s_lo[warp][a] = slo[a];
      s_hi[warp][a] = shi[a];
    }
    s_any[warp] = sany;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bool v = false;
    for (int w = 0; w < kWarps; ++w) {
      v |= s_any[w] != 0;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        slo[a] = fminf(slo[a], s_lo[w][a]);
        shi[a] = fmaxf(shi[a], s_hi[w][a]);
      }
    }
    slo4[blockIdx.x] = make_float4(slo[0], slo[1], slo[2], v ? 1.f : 0.f);
    shi4[blockIdx.x] = make_float4(shi[0], shi[1], shi[2], 0.f);
  }
}

// ---- cull ------------------------------------------------------------------

struct ScanArgs {
  const float* q;           // (n, 3) queries, original order
  const bool* qm;           // (n,)
  const int* order;         // (n,) original index at each sorted position
  int n, chunk, slabs;
  const float* xyz;         // (n_blocks * cap, 3)
  const bool* mask;         // (n_blocks * cap,)
  const bool* extra;        // (n_blocks * cap,) or null
  int n_blocks, cap, n_super;
  const float4 *lo4, *hi4, *slo4, *shi4;
  float clamp_radius, r2;
  int k_blocks, list_cap, seg;   // seg: listed blocks a work item
  int* hits;                // (n_chunks, list_cap) listed blocks
  int* n_hits;              // (n_chunks,) blocks the scoring takes (0: none)
  int2* items;              // work items: (chunk * slabs + slab, segment)
  unsigned long long* counts;   // [kCounts], see ltm_chunk_knn_scan
  unsigned long long* packed;   // (n,) packed partial top 2 at sorted positions
  float* out;               // (n, 2) rows in original order
  int* overflow;            // (n_chunks,)
};

__global__ void __launch_bounds__(kCullThreads) ck_cull(const ScanArgs a) {
  __shared__ float red[3][kMaxChunk];
  __shared__ float s_center[3];
  __shared__ int s_cnt, s_hits, s_rad, s_base, s_tests;
  const int tid = threadIdx.x, c = blockIdx.x;
  const int p0 = c * a.chunk;   // the chunk's first sorted position
  int p2 = 1;
  while (p2 < a.chunk) p2 <<= 1;
  if (tid == 0) {
    s_cnt = 0;
    s_hits = 0;
    s_rad = 0;
    s_tests = 0;
  }
  int mine = 0;
  for (int i = tid; i < p2; i += kCullThreads) {
    float v[3] = {0.f, 0.f, 0.f};
    if (i < a.chunk && p0 + i < a.n) {
      const size_t o = a.order[p0 + i];
      if (a.qm[o]) {
#pragma unroll
        for (int k = 0; k < 3; ++k) v[k] = a.q[3 * o + k];
        ++mine;
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) red[k][i] = v[k];
  }
  __syncthreads();
  if (mine) atomicAdd(&s_cnt, mine);
  __syncthreads();
  const int cnt = s_cnt;
  if (cnt == 0) {   // an all-invalid chunk: the tail of a padded query set
    for (int i = tid; i < a.chunk && p0 + i < a.n; i += kCullThreads) {
      const size_t o = a.order[p0 + i];
      a.out[2 * o] = a.out[2 * o + 1] = kBig;
    }
    if (tid == 0) a.overflow[c] = a.n_hits[c] = 0;
    return;
  }
  for (int h = p2 / 2; h >= 1; h >>= 1) {
    for (int i = tid; i < h; i += kCullThreads) {
#pragma unroll
      for (int k = 0; k < 3; ++k) red[k][i] = __fadd_rn(red[k][i], red[k][i + h]);
    }
    __syncthreads();
  }
  if (tid == 0) {
    const float nf = static_cast<float>(cnt);
#pragma unroll
    for (int k = 0; k < 3; ++k) s_center[k] = __fdiv_rn(red[k][0], nf);
  }
  __syncthreads();
  const float cx = s_center[0], cy = s_center[1], cz = s_center[2];
  float rad = 0.f;
  for (int i = tid; i < a.chunk && p0 + i < a.n; i += kCullThreads) {
    const size_t o = a.order[p0 + i];
    if (a.qm[o]) {
      rad = fmaxf(rad, __fsqrt_rn(sumsq3(__fsub_rn(a.q[3 * o], cx), __fsub_rn(a.q[3 * o + 1], cy),
                                         __fsub_rn(a.q[3 * o + 2], cz))));
    }
  }
  atomicMax(&s_rad, __float_as_int(rad));   // non-negative floats order as ints
  __syncthreads();
  const float reach = __fadd_rn(__int_as_float(s_rad), a.clamp_radius);

  // two levels: a lane a super-block, then a lane a block of each one hit
  const int warp = tid / kWarp, lane = tid % kWarp;
  int* list = a.hits + static_cast<size_t>(c) * a.list_cap;
  int tests = 0;   // the warp's block and super-block tests
  for (int s0 = warp * kWarp; s0 < a.n_super; s0 += kCullThreads) {
    const int s = s0 + lane;
    unsigned sup = __ballot_sync(~0u, s < a.n_super &&
                                      box_hit(a.slo4[s], a.shi4[s], cx, cy, cz, reach));
    tests += min(kWarp, a.n_super - s0);
    while (sup) {
      const int b0 = (s0 + __ffs(sup) - 1) * kSuper;
      const int b = b0 + lane;
      sup &= sup - 1;
      tests += min(kSuper, a.n_blocks - b0);
      const bool hit = b < a.n_blocks && box_hit(a.lo4[b], a.hi4[b], cx, cy, cz, reach);
      const unsigned hb = __ballot_sync(~0u, hit);
      int base = 0;
      if (lane == 0 && hb) base = atomicAdd(&s_hits, __popc(hb));
      base = __shfl_sync(~0u, base, 0);
      const int h = base + __popc(hb & lanes_below(lane));
      if (hit && h < a.list_cap) list[h] = b;
    }
  }
  if (lane == 0) atomicAdd(&s_tests, tests);
  __syncthreads();
  const int n_int = s_hits;
  const bool over = n_int > a.k_blocks;
  const int listed = over ? 0 : n_int;
  const int nseg = (listed + a.seg - 1) / a.seg;
  const float nan = __int_as_float(0x7fc00000);
  const float none = fminf(kBig, a.r2);   // a valid query with no listed block
  for (int i = tid; i < a.chunk && p0 + i < a.n; i += kCullThreads) {
    const size_t o = a.order[p0 + i];
    if (!a.qm[o]) {
      a.out[2 * o] = a.out[2 * o + 1] = kBig;
    } else if (over) {
      a.out[2 * o] = a.out[2 * o + 1] = nan;
    } else if (listed == 0) {
      a.out[2 * o] = a.out[2 * o + 1] = none;
    } else if (nseg > 1) {
      a.packed[p0 + i] = pack2(a.r2, a.r2);
    }
  }
  if (tid == 0) {
    a.overflow[c] = over ? n_int - a.k_blocks : 0;
    a.n_hits[c] = listed;
    const unsigned long long items = a.slabs * nseg;
    s_base = items ? static_cast<int>(atomicAdd(&a.counts[0], items)) : 0;
    atomicAdd(&a.counts[2], static_cast<unsigned long long>(s_tests));
    atomicAdd(&a.counts[3], 1ull);
    atomicMax(&a.counts[4], static_cast<unsigned long long>(s_tests));
  }
  __syncthreads();
  for (int i = tid; i < a.slabs * nseg; i += kCullThreads) {
    a.items[s_base + i] = make_int2(c * a.slabs + i / nseg, i % nseg);
  }
}

// ---- scoring -----------------------------------------------------------------

// Folds (b1, b2) into the packed top 2 at addr.
__device__ __forceinline__ void merge_packed(unsigned long long* addr, float b1, float b2) {
  unsigned long long old = *addr;
  for (;;) {
    float o1 = __uint_as_float(static_cast<unsigned>(old));
    float o2 = __uint_as_float(static_cast<unsigned>(old >> 32));
    push2(b1, o1, o2);
    push2(b2, o1, o2);
    const unsigned long long now = pack2(o1, o2);
    if (now == old) return;
    const unsigned long long seen = atomicCAS(addr, old, now);
    if (seen == old) return;
    old = seen;
  }
}

// A piece of a block as it lies in device memory: the 16-byte units that
// cover kPiece slots' xyz, mask and extra.  A piece may start anywhere in
// its first unit (any capacity, any alignment of the arrays), so each array
// has room for one more unit; its slot j lies at the piece's offset + j.
struct __align__(16) RawPiece {
  float xyz[3 * kPiece + 4];
  bool mask[kPiece + 16];
  bool extra[kPiece + 16];
};

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// src's byte offset in its 16-byte unit.
__device__ __forceinline__ int unit_offset(const void* src) {
  return static_cast<int>(reinterpret_cast<size_t>(src) & 15);
}

// The calling lane's share of the copy of the 16-byte units that cover
// [src, src + bytes).  A unit holding a byte of an array lies in the
// array's allocation, whose start is aligned to far more than 16 bytes.
__device__ __forceinline__ void copy_units(void* dst, const void* src, int bytes, int lane) {
  const char* first = static_cast<const char*>(src) - unit_offset(src);
  char* out = static_cast<char*>(dst);
  const int units = (unit_offset(src) + bytes + 15) >> 4;
  for (int u = lane; u < units; u += kWarp) copy16(out + 16 * u, first + 16 * u);
}

// Starts the copy of `len` slots from flat slot `slot` into `raw` (the
// calling lane's share) and commits it as one group.
__device__ __forceinline__ void stage_piece(RawPiece* raw, const ScanArgs& a, size_t slot,
                                            int len, int lane) {
  copy_units(raw->xyz, a.xyz + 3 * slot, 12 * len, lane);
  copy_units(raw->mask, a.mask + slot, len, lane);
  if (a.extra != nullptr) copy_units(raw->extra, a.extra + slot, len, lane);
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(kScoreWarps * kWarp, 4) ck_score(const ScanArgs a) {
  __shared__ RawPiece ring[kScoreWarps][2];
  __shared__ __align__(16) float4 tiles[kScoreWarps][kPiece + kGroup];
  const float inf = __int_as_float(0x7f800000);
  const int lane = threadIdx.x % kWarp;
  RawPiece* raw = ring[threadIdx.x / kWarp];
  float4* tile = tiles[threadIdx.x / kWarp];
  const int pieces = (a.cap + kPiece - 1) / kPiece;   // a block's pieces
  const int n_items = static_cast<int>(a.counts[0]);   // final: the cull has finished
  for (;;) {
    int it = 0;
    if (lane == 0) it = static_cast<int>(atomicAdd(&a.counts[1], 1ull));
    it = __shfl_sync(~0u, it, 0);
    if (it >= n_items) return;
    const int2 w = a.items[it];
    const int c = w.x / a.slabs, first = (w.x % a.slabs) * kSlab;
    const int listed = a.n_hits[c];
    const int k0 = w.y * a.seg, k1 = min(listed, k0 + a.seg);
    float qx[kR], qy[kR], qz[kR], b1[kR], b2[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int i = first + r * kWarp + lane;
      const int p = c * a.chunk + i;
      qx[r] = qy[r] = qz[r] = 0.f;
      b1[r] = a.r2;
      b2[r] = -inf;   // an empty query slot never passes the test
      if (i < a.chunk && p < a.n) {
        const size_t o = a.order[p];
        if (a.qm[o]) {
          qx[r] = a.q[3 * o];
          qy[r] = a.q[3 * o + 1];
          qz[r] = a.q[3 * o + 2];
          b2[r] = a.r2;   // the clamp: only pairs nearer than r^2 update
        }
      }
    }
    // the item's pieces t = 0 .. n_pieces-1: block k0 + t / pieces, slots
    // from (t % pieces) * kPiece; piece t + 1 is copied while t is scored
    const int* list = a.hits + static_cast<size_t>(c) * a.list_cap;
    const int n_pieces = (k1 - k0) * pieces;
    auto piece_at = [&](int t, size_t& slot) {
      const int j0 = (t % pieces) * kPiece;
      slot = static_cast<size_t>(list[k0 + t / pieces]) * a.cap + j0;
      return min(kPiece, a.cap - j0);
    };
    size_t slot;
    int len = piece_at(0, slot);
    stage_piece(&raw[0], a, slot, len, lane);
    for (int t = 0; t < n_pieces; ++t) {
      const int cur = len;
      // where slot 0 of piece t lies in each staged array
      const int xo = unit_offset(a.xyz + 3 * slot) / 4, mo = unit_offset(a.mask + slot);
      const int eo = a.extra == nullptr ? 0 : unit_offset(a.extra + slot);
      if (t + 1 < n_pieces) {
        len = piece_at(t + 1, slot);
        stage_piece(&raw[(t + 1) & 1], a, slot, len, lane);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      __syncwarp();   // every lane's share of piece t has landed
      const RawPiece& in = raw[t & 1];
      int m = 0;      // valid slots compacted into the tile
#pragma unroll
      for (int u = 0; u < kPiece / kWarp; ++u) {
        const int j = u * kWarp + lane;
        const bool ok = j < cur && in.mask[mo + j] && (a.extra == nullptr || in.extra[eo + j]);
        const unsigned vb = __ballot_sync(~0u, ok);
        if (ok) {
          const float* x = in.xyz + xo + 3 * j;
          tile[m + __popc(vb & lanes_below(lane))] = make_float4(x[0], x[1], x[2], 0.f);
        }
        m += __popc(vb);
      }
      const int mg = (m + kGroup - 1) / kGroup * kGroup;
      if (lane < mg - m) tile[m + lane] = make_float4(inf, inf, inf, 0.f);
      __syncwarp();   // the tile is complete; every lane is done with piece t's raw copy
#pragma unroll 2
      for (int j = 0; j < mg; j += kGroup) {
        float d[kGroup][kR];
        bool hit = false;
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const float4 p = tile[j + u];
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            d[u][r] = sumsq3(__fsub_rn(qx[r], p.x), __fsub_rn(qy[r], p.y),
                             __fsub_rn(qz[r], p.z));
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
      __syncwarp();   // every lane is done with the tile before it is refilled
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (b2[r] == -inf) continue;
      const int p = c * a.chunk + first + r * kWarp + lane;
      if (listed > a.seg) {
        merge_packed(a.packed + p, b1[r], b2[r]);
      } else {
        const size_t o = a.order[p];
        a.out[2 * o] = b1[r];
        a.out[2 * o + 1] = b2[r];
      }
    }
  }
}

// The rows of the chunks that listed more than seg blocks, from their
// packed top 2s.
__global__ void ck_merge(const ScanArgs a) {
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < a.n; p += gridDim.x * blockDim.x) {
    if (a.n_hits[p / a.chunk] <= a.seg) continue;
    const size_t o = a.order[p];
    if (!a.qm[o]) continue;
    const unsigned long long v = a.packed[p];
    a.out[2 * o] = __uint_as_float(static_cast<unsigned>(v));
    a.out[2 * o + 1] = __uint_as_float(static_cast<unsigned>(v >> 32));
  }
}

// CTAs of ck_score the current device holds at once (SMs x CTAs an SM),
// found once a device: the persistent grid's size.
int score_residency(int* resident) {
  static int cache[64] = {};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (dev < 64 && cache[dev] > 0) {
    *resident = cache[dev];
    return 0;
  }
  int sms = 0, per_sm = 0;
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ck_score, kScoreWarps * kWarp, 0);
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  *resident = sms * std::max(per_sm, 1);
  if (dev < 64) cache[dev] = *resident;
  return 0;
}

}  // namespace

// The constants the wrapper plans with: largest chunk, queries a work item,
// blocks a super-block, CTAs of the cell minimum, counts a scan writes.
extern "C" void ltm_chunk_knn_config(int* max_chunk, int* slab, int* super_blocks,
                                     int* prep_ctas, int* counts) {
  *max_chunk = kMaxChunk;
  *slab = kSlab;
  *super_blocks = kSuper;
  *prep_ctas = kPrepCtas;
  *counts = kCounts;
}

namespace {

// Byte offsets in the prep's scratch of n queries, each region 256-aligned:
// the keys (n) u32, their sorted copy (n) u32, the indices (n) i32, the
// cell minimum's partials (3 * kPrepCtas) i32 and CUB's temporary storage.
struct PrepLayout {
  size_t keys, sorted, idx, part, temp, temp_bytes, total;
};

cudaError_t prep_layout(int n, PrepLayout* l) {
  size_t temp = 0;
  const cudaError_t rc = cub::DeviceRadixSort::SortPairs(
      nullptr, temp, static_cast<const unsigned*>(nullptr), static_cast<unsigned*>(nullptr),
      static_cast<const int*>(nullptr), static_cast<int*>(nullptr), n, 0, kKeyBits);
  const auto up = [](size_t b) { return (b + 255) / 256 * 256; };
  l->keys = 0;
  l->sorted = up(4 * static_cast<size_t>(n));
  l->idx = l->sorted + up(4 * static_cast<size_t>(n));
  l->part = l->idx + up(4 * static_cast<size_t>(n));
  l->temp = l->part + up(12 * kPrepCtas);
  l->temp_bytes = temp;
  l->total = l->temp + temp;
  return rc;
}

}  // namespace

// Bytes of the prep's scratch for n queries (no launch; negative on error).
extern "C" long long ltm_chunk_knn_prep_bytes(int n) {
  PrepLayout l;
  if (n <= 0 || prep_layout(n, &l) != cudaSuccess) return -1;
  return static_cast<long long>(l.total);
}

// The prep, on `stream`: ck_cell_min and ck_keys (q (n, 3) f32, qm (n,)
// bool, inv = f32(1 / sort_cell)) write the keys and indices into
// `scratch` (ltm_chunk_knn_prep_bytes(n) bytes, 256-aligned), and CUB's
// stable radix sort of the keys writes `order` (n,) i32; ck_bounds (xyz
// (n_blocks * cap, 3) f32, mask and extra (n_blocks * cap,) bool, extra
// may be null) writes into `bounds` the float4 arrays lo4, hi4 (n_blocks
// each), then slo4, shi4 (ceil(n_blocks / kSuper) each).  Returns the
// first error (0 on success).
extern "C" int ltm_chunk_knn_prep(const float* q, const bool* qm, int n, float inv,
                                  const float* xyz, const bool* mask, const bool* extra,
                                  int n_blocks, int cap, void* scratch, long long scratch_bytes,
                                  int* order, void* bounds, void* stream) {
  PrepLayout l;
  if (n <= 0 || n_blocks <= 0 || cap <= 0 || prep_layout(n, &l) != cudaSuccess ||
      scratch_bytes < static_cast<long long>(l.total)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* base = static_cast<char*>(scratch);
  unsigned* keys = reinterpret_cast<unsigned*>(base + l.keys);
  int* idx = reinterpret_cast<int*>(base + l.idx);
  int* part = reinterpret_cast<int*>(base + l.part);
  const int ctas = std::min((n + kPrepThreads - 1) / kPrepThreads, kPrepCtas);
  ck_cell_min<<<ctas, kPrepThreads, 0, s>>>(q, qm, n, inv, part);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  ck_keys<<<std::min((n + kPrepThreads - 1) / kPrepThreads, 4096), kPrepThreads, 0, s>>>(
      q, qm, n, inv, part, ctas, keys, idx);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  size_t temp = l.temp_bytes;
  rc = static_cast<int>(cub::DeviceRadixSort::SortPairs(
      base + l.temp, temp, keys, reinterpret_cast<unsigned*>(base + l.sorted), idx, order, n, 0,
      kKeyBits, s));
  if (rc != 0) return rc;
  float4* lo4 = static_cast<float4*>(bounds);
  const int n_super = (n_blocks + kSuper - 1) / kSuper;
  ck_bounds<<<n_super, kBoundsThreads, 0, s>>>(xyz, mask, extra, n_blocks, cap, lo4,
                                               lo4 + n_blocks, lo4 + 2 * n_blocks,
                                               lo4 + 2 * n_blocks + n_super);
  return static_cast<int>(cudaGetLastError());
}

// The scan, on `stream`: ck_cull, ck_score and, when a chunk can list more
// than seg blocks (min(k_blocks, n_blocks) > seg), ck_merge.  q, qm and the
// block map as for the prep; order (n,) i32, the stable sort of the keys;
// bounds from the prep; seg, the listed blocks a work item.  scratch:
// `scratch_bytes` bytes, 8-aligned, laid out as packed (n) u64 when the
// merge runs, work items (n_chunks * ceil(chunk / kSlab) * ceil(list_cap /
// seg)) int2, hits (n_chunks * list_cap) i32 and n_hits (n_chunks) i32.
// counts (kCounts) u64, which this zeroes: [0] work items, [1] work items
// taken (the work items plus one a scoring warp), [2] block and super-block
// tests, [3] chunks culled (those with a valid query), [4] the most tests
// in one chunk.  Out: out (n, 2) f32 in original order, overflow (n_chunks)
// i32.  Returns the first error (0 on success).
extern "C" int ltm_chunk_knn_scan(const float* q, const bool* qm, const int* order, int n,
                                  int chunk, const float* xyz, const bool* mask,
                                  const bool* extra, int n_blocks, int cap, const void* bounds,
                                  float clamp_radius, float r2, int k_blocks, int seg,
                                  void* scratch, long long scratch_bytes,
                                  unsigned long long* counts, float* out, int* overflow,
                                  void* stream) {
  if (n <= 0 || chunk <= 0 || chunk > kMaxChunk || n_blocks <= 0 || cap <= 0 || k_blocks <= 0 ||
      seg <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int list_cap = std::min(k_blocks, n_blocks);
  const bool merge = list_cap > seg;
  const int n_chunks = (n + chunk - 1) / chunk;
  const int slabs = (chunk + kSlab - 1) / kSlab;
  const int n_super = (n_blocks + kSuper - 1) / kSuper;
  const long long max_items =
      static_cast<long long>(n_chunks) * slabs * ((list_cap + seg - 1) / seg);
  char* base = static_cast<char*>(scratch);
  const long long at_items = merge ? 8LL * n : 0;
  const long long at_hits = at_items + 8 * max_items;
  const long long at_n_hits = at_hits + 4LL * n_chunks * list_cap;
  if (max_items >= (1LL << 31) || scratch_bytes < at_n_hits + 4LL * n_chunks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* lo4 = static_cast<const float4*>(bounds);
  ScanArgs a{q, qm, order, n, chunk, slabs, xyz, mask, extra, n_blocks, cap, n_super,
             lo4, lo4 + n_blocks, lo4 + 2 * n_blocks, lo4 + 2 * n_blocks + n_super,
             clamp_radius, r2, k_blocks, list_cap, seg, reinterpret_cast<int*>(base + at_hits),
             reinterpret_cast<int*>(base + at_n_hits), reinterpret_cast<int2*>(base + at_items),
             counts, merge ? reinterpret_cast<unsigned long long*>(base) : nullptr, out,
             overflow};
  int rc = static_cast<int>(cudaMemsetAsync(counts, 0, kCounts * sizeof(*counts), s));
  if (rc != 0) return rc;
  ck_cull<<<n_chunks, kCullThreads, 0, s>>>(a);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  int resident = 0;
  rc = score_residency(&resident);
  if (rc != 0) return rc;
  const long long ctas = std::min((max_items + kScoreWarps - 1) / kScoreWarps,
                                  static_cast<long long>(resident));
  ck_score<<<static_cast<int>(ctas), kScoreWarps * kWarp, 0, s>>>(a);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || !merge) return rc;
  ck_merge<<<std::min((n + 255) / 256, 4096), 256, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ltm_chunk_knn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
