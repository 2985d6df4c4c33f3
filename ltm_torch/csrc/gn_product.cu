// The pose-graph solver's Gauss-Newton product (K5c), CUDA C++ for Hopper
// (sm_90a).
//
// Replaces what XLA compiles from ltm's _hvp_from_jacobians
// (ltm/graph/solver.py:264): out = (J^T W J + lambda I) v for the lanes of v
// (n_lanes, n_vars, 6), from the explicit 6x6 Jacobian blocks of every factor
// end.  The ends come in ltm's order: the priors; the between factors' i,
// then j ends; the anchored factors' i, j, ai, aj ends (seven arrays).  With
// vf = v with its fixed variables read as 0:
//   y_f      = sum over f's ends, in that order, of J_e vf[idx_e]
//              (an anchored factor's sum starts from +0.0);
//   out[v]   = (sum over the ends of row v, in the scatter plan's order,
//              from +0.0, of J_e^T y_f(e)) + lambda * v[v].
// Every 6-term product sum_k J[i][k] x[k] runs in k order with each product
// and sum rounded (__fmul_rn / __fadd_rn, which nvcc never contracts), so the
// result is the plain version's (ltm_torch/kernels/gn_product.py,
// gn_product_plain) bit for bit.  That contract rules out FMA and tensor
// cores (an MMA fuses and reorders the products): the 144 operations a
// valid factor end and lane issue as 144 FP32 (FP64) instructions, so the
// floor is ops / (67 TFLOP/s / 2) in float32 (34 / 2 in float64), twice
// the FMA-counted operation bound.
//
// What bounds it: at one lane (the LM's PCG) the latency of a row's
// dependent loads (list entry -> block and y row), worst on the anchor rows
// (degree ~490 on phase 8's graph), and the 6x6 blocks' bytes; at many lanes
// (the RS marginals, 762) the operations, and the traffic of y: stored for
// every (factor, lane) it is 472 MB written and 943 MB read back on phase
// 8's graph, more than the 50 MB L2 holds, and it evicts v from L2.
//
// What the design does about it (no host sync, no allocation: y, vt and the
// end records are the caller's scratch, so a CUDA graph captures the
// launches alone).  Below kWide lanes, two passes joined by Programmatic
// Dependent Launch (the second grid starts while the first runs and waits,
// griddepcontrol.wait, only before it reads y):
//   1. gn_factors: a thread a (factor, lane), lanes fastest, over the whole
//      grid (at one lane one wave of 101 CTAs), the family's ends unrolled,
//      each block read as 16-byte vectors; y laid out (factor, 6, lanes).
//      It lets gn_rows launch at once: all its CTAs are resident by then.
//   2. gn_rows: rows in the scatter plan's order (highest degree first, as
//      csrc/scatter.cu).  A row of more than kHeavy ends takes a CTA a
//      (row, lane), a lighter row a warp.  The team's threads take kPer
//      ends each of a chunk of team * kPer, load their blocks, then wait for
//      gn_factors and load their y rows, and write the products J_e^T y to
//      shared memory in list order; one thread a column then adds them from
//      +0.0 in list order, carrying its sum across chunks.  Only the
//      products run in parallel, never the sum.
// From kWide lanes, no y in device memory:
//   3. gn_end_table (once a plan and its blocks): a 64-byte record a list
//      entry: its factor's block pointers and variables, which end it is.
//   4. gn_transpose: v into vt, by 32-lane tile (a variable's six entries for
//      a tile are 192 consecutive values), with a row of zeros that fixed
//      variables point to.
//   5. gn_rows_wide: a CTA a (row, 32 lanes), its eight warps forming a
//      chunk's products at once, each end's y_f formed afresh from vt and
//      the factor's blocks (216 operations a between factor's end and lane
//      against the two passes' 144, 360 an anchored factor's, and no y
//      traffic), then added in list order as in 2.  Records and blocks are
//      staged in shared memory ahead by cp.async.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// The call's operands, mirrored by kernels/gn_product.py::_Args.
struct GnArgs {
  const void* J[7];              // the ends' blocks (n, 6, 6), row-major, 16-byte aligned
  const int* idx[7];             // the ends' variables
  const unsigned char* fixed;    // (n_vars,) read as 0 in v
  const int* rowptr;             // the scatter plan: CSR lists of end positions
  const int* cols;
  const int* order;              // the rows, highest degree first
  const void* v;                 // (n_lanes, n_vars, 6)
  const void* lam;               // 0-d
  void* y;                       // scratch (P + B + A, 6, n_lanes), below kWide lanes
  void* vt;                      // scratch (n_vars + 1, lane tiles, 6, 32), from kWide
                                 // lanes: v by 32-lane tile, then a row of zeros
  void* ends;                    // scratch (list entries, 64 bytes), from kWide lanes:
                                 // each entry's factor (gn_end_table)
  void* out;                     // (n_lanes, n_vars, 6)
  int n_fac[3];                  // priors, between factors, anchored factors
  int n_vars;
  int n_lanes;
  int n_heavy;                   // rows of more than kHeavy ends (a prefix of order)
  int n_entries;                 // the plan's list entries (valid ends)
  int make_table;                // 1: write `ends` first (the first call of a plan)
  int dtype;                     // 0: float32, 1: float64
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// lanes from which the rows take a thread a lane: on phase 8's graph the
// narrow route is faster up to 16 lanes, the wide one from 24
// (chip_smoke.gn_crossover)
constexpr int kWide = 24;
template <typename T>             // ends a chunk of gn_rows_wide (its blocks: 18 KB)
constexpr int kChunk = sizeof(T) == 4 ? 16 : 8;
constexpr int kHeavy = 64;       // below kWide lanes, rows of more ends take a CTA
constexpr int kPer = 2;          // ends a thread a chunk in gn_rows
static_assert(32 * kPer == kHeavy, "a light row is one chunk of its warp");

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// Programmatic Dependent Launch: wait for the grids this one depends on (a
// no-op in a grid launched without the attribute); let dependents launch.
__device__ __forceinline__ void grid_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }
__device__ __forceinline__ void grid_trigger() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// 16 bytes from device to shared memory without a register on the way.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group 0;" ::: "memory"); }

// arr[k] by selects, so no parameter array is indexed at run time.
template <typename P>
__device__ __forceinline__ P pick(const P (&arr)[7], int k) {
  P p = arr[0];
#pragma unroll
  for (int s = 1; s < 7; ++s) p = k == s ? arr[s] : p;
  return p;
}

// A 6x6 block as 16-byte vectors (read-only path).
__device__ __forceinline__ void load_block(const float* jb, float (&J)[36]) {
  const float4* p = reinterpret_cast<const float4*>(jb);
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const float4 w = __ldg(p + q);
    J[4 * q] = w.x;
    J[4 * q + 1] = w.y;
    J[4 * q + 2] = w.z;
    J[4 * q + 3] = w.w;
  }
}
__device__ __forceinline__ void load_block(const double* jb, double (&J)[36]) {
  const double2* p = reinterpret_cast<const double2*>(jb);
#pragma unroll
  for (int q = 0; q < 18; ++q) {
    const double2 w = __ldg(p + q);
    J[2 * q] = w.x;
    J[2 * q + 1] = w.y;
  }
}

// Column j of J^T y: sum_i J[i][j] y[i] in i order.
template <typename T>
__device__ __forceinline__ T col_dot(const T (&J)[36], const T (&y)[6], int j) {
  T c = mul_rn(J[j], y[0]);
#pragma unroll
  for (int i = 1; i < 6; ++i) c = add_rn(c, mul_rn(J[i * 6 + j], y[i]));
  return c;
}

// y_f for one factor of a family of kEnds ends (arrays k0 .. k0 + kEnds - 1)
// and one lane, every load issued before the products.
template <typename T, int kEnds>
__device__ __forceinline__ void factor_y(const GnArgs& a, int k0, int local, long long yrow,
                                         int lane) {
  T Jb[kEnds][36];
  int var[kEnds];
#pragma unroll
  for (int e = 0; e < kEnds; ++e) {
    var[e] = __ldg(pick(a.idx, k0 + e) + local);
    load_block(static_cast<const T*>(pick(a.J, k0 + e)) + static_cast<long long>(local) * 36,
               Jb[e]);
  }
  bool fx[kEnds];
#pragma unroll
  for (int e = 0; e < kEnds; ++e) fx[e] = a.fixed[var[e]] != 0;
  const int L = a.n_lanes, V = a.n_vars;
  T acc[6];
#pragma unroll
  for (int e = 0; e < kEnds; ++e) {
    const T* vr = static_cast<const T*>(a.v) + (static_cast<long long>(lane) * V + var[e]) * 6;
    T x[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) x[k] = fx[e] ? static_cast<T>(0) : vr[k];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      T t = mul_rn(Jb[e][i * 6], x[0]);
#pragma unroll
      for (int k = 1; k < 6; ++k) t = add_rn(t, mul_rn(Jb[e][i * 6 + k], x[k]));
      acc[i] = e == 0 ? (kEnds == 4 ? add_rn(static_cast<T>(0), t) : t) : add_rn(acc[i], t);
    }
  }
  T* y = static_cast<T*>(a.y) + yrow * 6 * L + lane;
#pragma unroll
  for (int i = 0; i < 6; ++i) y[i * L] = acc[i];
}

// y (factor, 6, lanes) below kWide lanes: a thread a (factor, lane) over
// the whole grid, lanes fastest; the factors in y's row order (priors,
// between factors, anchored factors).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) gn_factors(GnArgs a) {
  grid_trigger();                                  // gn_rows' CTAs wait on the grid's end
  const long long q = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int P = a.n_fac[0], B = a.n_fac[1], A = a.n_fac[2], L = a.n_lanes;
  if (q < static_cast<long long>(P + B + A) * L) {
    const int f = static_cast<int>(q / L), lane = static_cast<int>(q - static_cast<long long>(f) * L);
    if (f < P) {
      factor_y<T, 1>(a, 0, f, f, lane);
    } else if (f < P + B) {
      factor_y<T, 2>(a, 1, f - P, f, lane);
    } else {
      factor_y<T, 4>(a, 3, f - P - B, f, lane);
    }
  }
}

// vt (n_vars + 1, lane tiles, 6, 32) from v (lanes, n_vars * 6) through a
// 32 x 32 tile: variable var's six entries for lane tile t are 192
// consecutive values, k-major; lanes past the last and the last row (the
// entries of fixed variables) are zeros.
template <typename T>
__global__ void __launch_bounds__(kThreads) gn_transpose(const T* v, T* vt, int L, int V) {
  __shared__ T tile[32][33];
  const int C = 6 * V, c0 = blockIdx.x * 32, t = blockIdx.y, l0 = t * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int r = ty; r < 32; r += kWarps) {
    const int l = l0 + r, c = c0 + tx;
    tile[r][tx] = l < L && c < C ? v[static_cast<long long>(l) * C + c] : static_cast<T>(0);
  }
  __syncthreads();
  for (int r = ty; r < 32; r += kWarps) {
    const int c = c0 + r;
    if (c < C + 6) {
      vt[((static_cast<long long>(c / 6) * gridDim.y + t) * 6 + c % 6) * 32 + tx] = tile[tx][r];
    }
  }
  grid_trigger();
}

// An end's place in its factor, from its position e in the ends' order:
// the family's first end array k0, its ends, the factor in the arrays, and
// which of its ends e is.
__device__ __forceinline__ void end_factor(const GnArgs& a, int e, int& k0, int& ends, int& local,
                                           int& p) {
  const int P = a.n_fac[0], B = a.n_fac[1], A = a.n_fac[2];
  if (e < P) {
    k0 = 0; ends = 1; local = e; p = 0;
  } else if (e < P + 2 * B) {
    const int r = e - P;
    k0 = 1; ends = 2; p = r >= B; local = r - p * B;
  } else {
    const int r = e - P - 2 * B;
    k0 = 3; ends = 4; p = (r >= A) + (r >= 2 * A) + (r >= 3 * A); local = r - p * A;
  }
}

// End e: its block, and its factor's row of y (priors, then between
// factors, then anchored factors).
template <typename T>
__device__ __forceinline__ const T* end_block(const GnArgs& a, int e, int& yrow) {
  int k0, ends, local, p;
  end_factor(a, e, k0, ends, local, p);
  yrow = (k0 == 0 ? 0 : k0 == 1 ? a.n_fac[0] : a.n_fac[0] + a.n_fac[1]) + local;
  return static_cast<const T*>(pick(a.J, k0 + p)) + static_cast<long long>(local) * 36;
}

template <int kTeam>
__device__ __forceinline__ void team_sync() {
  if (kTeam == 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// One (row, lane) by a team of kTeam threads (tid its thread): chunks of
// kTeam * kPer ends, thread tid taking ends tid and tid + kTeam of each;
// their products J_e^T y to prod (chunk position * 6 + column) in list
// order, then threads 0..5 add them in list order onto their column's sum.
template <typename T, int kTeam>
__device__ __forceinline__ void row_team(const GnArgs& a, int row, int lane, int tid, T* prod) {
  const int L = a.n_lanes, V = a.n_vars;
  const int j0 = a.rowptr[row], j1 = a.rowptr[row + 1];
  const T* y = static_cast<const T*>(a.y);
  T acc = static_cast<T>(0);
  for (int c0 = j0;; c0 += kTeam * kPer) {
    const int n = min(kTeam * kPer, j1 - c0);
    T J[kPer][36];
    int yrow[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int m = tid + q * kTeam;
      yrow[q] = -1;
      if (m < n) load_block(end_block<T>(a, __ldg(a.cols + c0 + m), yrow[q]), J[q]);
    }
    if (c0 == j0) grid_wait();                     // y is gn_factors' output
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      if (yrow[q] < 0) continue;
      const T* yr = y + static_cast<long long>(yrow[q]) * 6 * L + lane;
      T yv[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) yv[i] = yr[i * L];
      T* p = prod + (tid + q * kTeam) * 6;
#pragma unroll
      for (int j = 0; j < 6; ++j) p[j] = col_dot(J[q], yv, j);
    }
    team_sync<kTeam>();
    if (tid < 6) {
#pragma unroll 8
      for (int m = 0; m < n; ++m) acc = add_rn(acc, prod[m * 6 + tid]);
    }
    team_sync<kTeam>();
    if (c0 + kTeam * kPer >= j1) break;
  }
  if (tid < 6) {
    const long long o = (static_cast<long long>(lane) * V + row) * 6 + tid;
    static_cast<T*>(a.out)[o] =
        add_rn(acc, mul_rn(*static_cast<const T*>(a.lam), static_cast<const T*>(a.v)[o]));
  }
}

// out rows, below kWide lanes: blocks [0, n_heavy * L) a CTA a (heavy row,
// lane), lanes fastest; then a warp a (light row, lane), lanes fastest.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) gn_rows(GnArgs a) {
  __shared__ T s_prod[kThreads * kPer * 6];
  const int L = a.n_lanes, V = a.n_vars, H = a.n_heavy;
  const long long heavy = static_cast<long long>(H) * L;
  if (blockIdx.x < heavy) {
    const int rank = blockIdx.x / L, lane = blockIdx.x - rank * L;
    row_team<T, kThreads>(a, a.order[rank], lane, threadIdx.x, s_prod);
    return;
  }
  const int warp = threadIdx.x >> 5, lid = threadIdx.x & 31;
  const long long item = (static_cast<long long>(blockIdx.x) - heavy) * kWarps + warp;
  const long long rank = H + item / L;
  if (rank >= V) return;                                   // uniform across the warp
  row_team<T, 32>(a, a.order[rank], static_cast<int>(item % L), lid,
                  s_prod + warp * 32 * kPer * 6);
}

// A list entry's factor (gn_end_table, 64 bytes): its ends' blocks, their
// variables (n_vars, vt's row of zeros, where fixed), its ends | which end
// the entry is << 4.
struct EndRec {
  const void* blk[4];
  int var[4];
  int meta;
  int pad[3];
};
static_assert(sizeof(EndRec) == 64, "an end record is four 16-byte copies");

// y_f of a list entry's factor of kEnds ends for one lane from vt (vr: its
// lane's entries of variable 0, by tile) and the factor's blocks (staged
// in shared memory, blk[q]), in gn_factors' order, then J_p^T y_f into c
// (p: which of the factor's ends the entry is).
template <typename T, int kEnds>
__device__ __forceinline__ void end_product(const EndRec& r, const T (*blk)[36], int p,
                                            const T* vr, int tiles, T (&c)[6]) {
  T x[kEnds][6];
#pragma unroll
  for (int q = 0; q < kEnds; ++q) {
    const T* xr = vr + static_cast<long long>(r.var[q]) * tiles * 192;
#pragma unroll
    for (int k = 0; k < 6; ++k) x[q][k] = xr[k * 32];
  }
  T yv[6];
#pragma unroll
  for (int q = 0; q < kEnds; ++q) {
    const T* J = blk[q];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      T t = mul_rn(J[i * 6], x[q][0]);
#pragma unroll
      for (int k = 1; k < 6; ++k) t = add_rn(t, mul_rn(J[i * 6 + k], x[q][k]));
      yv[i] = q == 0 ? (kEnds == 4 ? add_rn(static_cast<T>(0), t) : t) : add_rn(yv[i], t);
    }
  }
  const T* J = blk[p];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    T cj = mul_rn(J[j], yv[0]);
#pragma unroll
    for (int i = 1; i < 6; ++i) cj = add_rn(cj, mul_rn(J[i * 6 + j], yv[i]));
    c[j] = cj;
  }
}

// Each list entry's factor (an EndRec), once a plan and its blocks (from
// kWide lanes).
template <typename T>
__global__ void __launch_bounds__(kThreads) gn_end_table(GnArgs a) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= a.n_entries) return;
  int k0, ends, local, p;
  end_factor(a, a.cols[j], k0, ends, local, p);
  EndRec r = {};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int var = q < ends ? pick(a.idx, k0 + q)[local] : 0;
    r.var[q] = q < ends && !a.fixed[var] ? var : a.n_vars;
    r.blk[q] = q < ends ? static_cast<const T*>(pick(a.J, k0 + q)) + static_cast<long long>(local) * 36
                        : nullptr;
  }
  r.meta = ends | (p << 4);
  static_cast<EndRec*>(a.ends)[j] = r;
}

// out rows, from kWide lanes, with no y in device memory: a CTA a (row, 32
// lanes), tiles fastest.  The row's list is walked in chunks of kChunk
// ends.  What a chunk reads but v is copied to shared memory ahead of it
// with cp.async, so no thread waits on it: the records of gn_end_table two
// chunks ahead, the blocks they point to one chunk ahead.  Warp w takes
// ends w and w + 8 of a chunk: it forms each end's y_f for its 32 lanes
// from vt (coalesced: one 128-byte load an entry, no index arithmetic past
// the variable's tile) and the staged blocks, and writes J_e^T y_f to
// shared memory in list order; then 192 threads, one a (column, lane), add
// the chunk's products in list order onto their sums, which carry across
// chunks.  Only the products run in parallel, never the sum.
template <typename T>
__global__ void __launch_bounds__(kThreads, 4) gn_rows_wide(GnArgs a) {
  constexpr int kC = kChunk<T>, kVecs = 36 * sizeof(T) / 16;
  __shared__ T s_prod[kC][6][32];
  __shared__ __align__(16) EndRec s_tab[3][kC];
  __shared__ __align__(16) T s_blk[2][kC][4][36];
  const int L = a.n_lanes, V = a.n_vars;
  const int tiles = (L + 31) / 32;
  const int rank = blockIdx.x / tiles, tile = blockIdx.x - rank * tiles;
  const int warp = threadIdx.x >> 5, lid = threadIdx.x & 31;
  const int row = a.order[rank];
  const int j0 = a.rowptr[row], j1 = a.rowptr[row + 1];
  const int chunks = (j1 - j0 + kC - 1) / kC;
  const T* vr = static_cast<const T*>(a.vt) + tile * 192 + lid;   // variable 0, this lane
  auto records = [&](int c) {                      // chunk c's records
    if (c >= chunks) return;
    const int c0 = j0 + c * kC, n = min(kC, j1 - c0);
    if (static_cast<int>(threadIdx.x) < 4 * n) {
      const int m = threadIdx.x >> 2, h = threadIdx.x & 3;
      cp_async16(reinterpret_cast<char*>(&s_tab[c % 3][m]) + 16 * h,
                 static_cast<const char*>(a.ends) + (static_cast<long long>(c0 + m) * 4 + h) * 16);
    }
  };
  auto blocks = [&](int c) {                       // chunk c's blocks, from its records
    if (c >= chunks) return;
    const int n = min(kC, j1 - j0 - c * kC);
    for (int t = threadIdx.x; t < n * 4 * kVecs; t += kThreads) {
      const int m = t / (4 * kVecs), r = t - m * 4 * kVecs, q = r / kVecs, w = r - q * kVecs;
      const EndRec& rec = s_tab[c % 3][m];
      if (q < (rec.meta & 15)) {
        cp_async16(&s_blk[c & 1][m][q][w * 16 / sizeof(T)],
                   static_cast<const char*>(rec.blk[q]) + 16 * w);
      }
    }
  };
  T acc = static_cast<T>(0);                       // threads < 192: column tid / 32
  records(0);
  cp_async_commit();
  cp_async_wait();
  __syncthreads();
  blocks(0);
  records(1);
  cp_async_commit();
  cp_async_wait();
  grid_wait();                                     // vt is gn_transpose's output
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    records(c + 2);
    blocks(c + 1);
    cp_async_commit();
    const int n = min(kC, j1 - j0 - c * kC);
    for (int m = warp; m < n; m += kWarps) {
      const EndRec& r = s_tab[c % 3][m];
      const int ends = r.meta & 15, p = r.meta >> 4;
      const T(*blk)[36] = s_blk[c & 1][m];
      T cv[6];
      if (ends == 2) {
        end_product<T, 2>(r, blk, p, vr, tiles, cv);
      } else if (ends == 4) {
        end_product<T, 4>(r, blk, p, vr, tiles, cv);
      } else {
        end_product<T, 1>(r, blk, p, vr, tiles, cv);
      }
#pragma unroll
      for (int j = 0; j < 6; ++j) s_prod[m][j][lid] = cv[j];
    }
    cp_async_wait();
    __syncthreads();
    if (threadIdx.x < 6 * 32) {
      const int j = threadIdx.x >> 5;
#pragma unroll 4
      for (int m = 0; m < n; ++m) acc = add_rn(acc, s_prod[m][j][lid]);
    }
    __syncthreads();
  }
  const int lane = tile * 32 + lid;
  if (threadIdx.x < 6 * 32 && lane < L) {
    const int j = threadIdx.x >> 5;
    const T lam = *static_cast<const T*>(a.lam);
    static_cast<T*>(a.out)[(static_cast<long long>(lane) * V + row) * 6 + j] =
        add_rn(acc, mul_rn(lam, vr[static_cast<long long>(row) * tiles * 192 + j * 32]));
  }
}

// A launch that may begin before the stream's previous kernel ends
// (Programmatic Dependent Launch); the kernel waits (griddepcontrol.wait)
// before it reads what that kernel writes.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), long long blocks, cudaStream_t s,
                             Args... args) {
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, args...);
  return rc != cudaSuccess ? rc : cudaGetLastError();
}

template <typename T>
cudaError_t launch(const GnArgs& a, cudaStream_t s) {
  const long long L = a.n_lanes, V = a.n_vars;
  const long long F = static_cast<long long>(a.n_fac[0]) + a.n_fac[1] + a.n_fac[2];
  const long long factor_blocks = (F * L + kThreads - 1) / kThreads;
  if (factor_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t rc;
  if (L >= kWide) {
    const long long tiles = (L + 31) / 32;
    if ((6 * (V + 1) + 31) / 32 > 0x7fffffffLL || tiles > 65535) return cudaErrorInvalidValue;
    if (a.make_table && a.n_entries > 0) {
      gn_end_table<T><<<(a.n_entries + kThreads - 1) / kThreads, kThreads, 0, s>>>(a);
      if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
    }
    gn_transpose<T><<<dim3(static_cast<unsigned>((6 * (V + 1) + 31) / 32),
                           static_cast<unsigned>(tiles)), kThreads, 0, s>>>(
        static_cast<const T*>(a.v), static_cast<T*>(a.vt), static_cast<int>(L),
        static_cast<int>(V));
    if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
    return launch_dependent(gn_rows_wide<T>, V * tiles, s, a);
  }
  if (factor_blocks > 0) {
    gn_factors<T><<<static_cast<unsigned>(factor_blocks), kThreads, 0, s>>>(a);
    if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  }
  const long long H = a.n_heavy;
  return launch_dependent(gn_rows<T>, H * L + ((V - H) * L + kWarps - 1) / kWarps, s, a);
}

}  // namespace

extern "C" int ltm_gn_args_size() { return static_cast<int>(sizeof(GnArgs)); }

extern "C" void ltm_gn_config(int* threads, int* wide, int* heavy, int* per) {
  *threads = kThreads;
  *wide = kWide;
  *heavy = kHeavy;
  *per = kPer;
}

// Launches the passes on `stream` on CUDA device `device` (the calling
// thread's current device is restored).  Returns a cudaError_t.
extern "C" int ltm_gn_product(const GnArgs* args, int device, void* stream) {
  const GnArgs& a = *args;
  if (a.n_fac[0] < 0 || a.n_fac[1] < 0 || a.n_fac[2] < 0 || a.n_vars < 0 || a.n_lanes < 0 ||
      a.n_heavy < 0 || a.n_heavy > a.n_vars || (a.dtype != 0 && a.dtype != 1) ||
      a.n_entries < 0 ||
      (a.n_lanes >= kWide ? a.vt == nullptr || a.ends == nullptr : a.y == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int k = 0; k < 7; ++k) {
    if (reinterpret_cast<uintptr_t>(a.J[k]) % 16 != 0) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
  }
  if (a.n_vars == 0 || a.n_lanes == 0) return 0;
  int current = -1;
  cudaError_t rc = cudaGetDevice(&current);
  if (rc == cudaSuccess && current != device) rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rc = a.dtype == 0 ? launch<float>(a, s) : launch<double>(a, s);
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(rc);
}

extern "C" const char* ltm_gn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
