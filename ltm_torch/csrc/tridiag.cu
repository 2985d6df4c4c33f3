// The pose-graph solver's block-tridiagonal (odometry-chain) preconditioner
// (K5a): the block-Thomas factorization and the solve, CUDA C++ for Hopper
// (sm_90a).
//
// Replaces the XLA-lowered scans of ltm/graph/solver.py:198::_tridiag_factor
// and :222::_tridiag_apply, which the port's plain versions
// (ltm_torch/kernels/tridiag.py, tridiag_factor_plain and
// tridiag_apply_plain) run as Python loops of batched 6x6 torch ops, one
// step per variable of the longest chain: some three thousand small
// launches a solve.  Here each is one launch.
//
// Layout (ltm_torch/graph/solver.py::_chains): the graph's independent
// chains side by side, pos (n_chains, max_len) int64 variable indices, V (or
// anything outside [0, V)) past a chain's end.  A chain's steps run up to its
// last valid entry; a padding entry before it (none in _chains' layout) is an
// identity step (D = I, L = 0, r = 0, no write), as the plain versions'
// padded gathers make it, and the steps past the last valid entry are
// written directly (identity Cinv, zero Lc and P) without running the
// recurrence, so a chain of one variable costs one step, not max_len.
//
// tridiag_factor.  For each chain, in order: C_0 = D_0,
// P_i = Cinv_{i-1} L_i^T, C_i = D_i - L_i P_i (ltm's product order),
// Cinv_i = C_i^-1; writes Cinv, Lc (the gathered L, its bits unchanged) and
// P, chain-major (n_chains, max_len, 6, 6).  One warp a chain, no CTA
// barrier: lane 3 k + g holds columns 2 g, 2 g + 1 of row k of each block
// in registers (lanes 18-31 repeat lanes 0-13, so the warp never
// diverges); P's pairs and the running matrix before each pivot are
// exchanged through shared memory after a __syncwarp (a double shuffle
// keeps one warp busy several times longer than a shared load).  D, L and
// pos are staged by all 32 lanes a segment of 8 steps ahead, so no
// device-memory access is on the chain.
//   The inverse is Gauss-Jordan with the pivots on the diagonal, not
// jnp.linalg.inv's LU with partial pivoting: C is SPD by construction
// (_precond_blocks' docstring; a fixed variable's block is the identity),
// so every diagonal pivot is a positive Schur complement and elimination
// without row exchange is backward stable for it, as Cholesky is; it needs
// no data-dependent row exchange, no square roots and no triangular
// passes.  Each pivot's reciprocal is rcp.approx.ftz.f64 and one cubic
// Newton step (`recip`), no IEEE division, and the next pivot and its
// reciprocal are formed before this pivot's update, so the chain from one
// reciprocal to the next is a multiply, an FMA, the seed and three FMAs.
//   Measured on an H100 at phase 8's graph (PERF.md): 0.475 us a dependent
// step, against 0.375 us for the same step with every operand in registers
// (tridiag_factor_step_floor); the first design (a CTA of 64 threads, an
// entry a thread, nine CTA barriers and six IEEE divisions a step) took
// 1.39 us.  The same design with six lanes a row each took 0.74 us
// (0.65 with its shuffles in a converged warp: idle lanes waiting at a
// barrier put every shuffle on its slow path).
//
// tridiag_apply.  For each lane of r (..., V, 6) (one for LM, 6 M for the
// marginals) and each chain, the block-Thomas solve rewritten on the
// factor's P (Cinv is symmetric, so L_i Cinv_{i-1} = P_i^T):
//     forward   y_i = r_i - P_i^T y_{i-1},        w_i = Cinv_i y_i,
//     back      x_i = w_i - P_{i+1} x_{i+1}        (x past the end = 0).
// The textbook form, y_i = r_i - L_i (Cinv_{i-1} y_{i-1}) and
// x_i = Cinv_i (y_i - L_{i+1}^T x_{i+1}), puts two 6x6 mat-vecs on each
// dependent step; this form puts one, and w_i, which no later step of the
// forward pass needs, is computed beside the chain.  r is read and x written
// through pos in variable order (every variable lies in exactly one chain,
// so every row of x is written once and x needs no initial fill); w goes to
// a double scratch the wrapper allocates, read back by the back pass.
//   What bounds it: each chain's dependent steps, 2 max_len of them, not
// bytes or flops (~0.3 kflop and two 6x6 blocks a variable a lane).  The
// first design (a warp a (lane, chain), two mat-vecs a step, its operands
// loaded from device memory two steps ahead) took 0.38 us a dependent step
// on an H100 at phase 8's graph, an L2 round trip a step.  Here:
//   1. one CTA a (chain, group of up to kCtaLanes = 5 lanes), two warps:
//      warp 0 runs the steps and nothing else: six threads a lane, thread k
//      holding row k of the carried 6-vector; a step is six broadcast
//      shuffles inside the six threads, six FMAs and a store of its result
//      to shared memory, its operands read from shared memory as double two
//      steps ahead into two register sets used in turn;
//   2. warps 1-3 produce the segments of kSeg steps the steps read: the
//      chain's blocks (P and Cinv forward, P shifted by a step back) and
//      the lanes' rows of r (forward) or w (back), gathered through pos, by
//      cp.async two segments ahead, pos a segment further still, each
//      landed segment's float blocks and rows turned to double once for
//      the CTA's lanes; and a segment after warp 0 ran it, they form
//      w_i = Cinv_i y_i (forward) and write w and x out through pos.  The
//      producers meet at a barrier of their own, and all four warps at one
//      barrier a segment.
//   Measured on an H100 at phase 8's graph (PERF.md), a dependent step
//   (one lane; 120 lanes): 0.097 us (0.118); the same step with every
//   operand in registers, 0.050 us.  With one producer warp it took
//   0.19 us: clock64 stamps showed the producer at ~13 700 cycles a
//   segment against the steps' ~6 000; earlier layouts, warp 0 also forming
//   w and writing out, 0.15 us (0.18); one CTA of eight warps (40 lanes),
//   each staging between its steps, (0.27); one warp a CTA doing its own
//   staging, (0.33).
// tridiag_step_floor runs the same dependent step with every operand in
// registers, the least time of the recurrence on this card (chip_smoke.py
// times it for PERF.md).
//
// Arithmetic.  Both kernels compute in double for float32 and float64
// inputs and round once at each store (P, Cinv, x; w stays double): the
// chains are ~500 steps long and the work is latency-bound, so double
// costs little, and the float32 results stay within the plain float32
// route's own error of the float64 plain version (the rule chip_smoke.py
// and tests/test_torch_card.py hold them to).  Every sum runs in a fixed
// order with no atomics, so a launch repeats bit for bit, in or out of a
// CUDA graph.
//
// The wrappers' host work is their checks, the output allocation and one C
// call, which launches on the caller's stream with no allocation and no
// sync, so the apply can be captured in the PCG's CUDA graph.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSeg = 32;         // steps a staged segment
constexpr int kCtaLanes = 5;     // lanes a CTA of the solve: one warp, six threads a lane
constexpr int kProducers = 96;   // the solve's producer threads (warps 1-3)
constexpr int kVecBytes = 48;    // a staged row: 6 doubles (or 6 T)

__device__ __forceinline__ bool in_range(long long v, int V) { return v >= 0 && v < V; }

// The steps of a chain up to its last valid entry: 1 + the largest i with
// pos[i] in [0, V), or 0, over the entries the warp's threads look at (each
// thread first, first + stride, ...); every thread of the warp gets it.
__device__ __forceinline__ int warp_chain_len(const int64_t* __restrict__ p, int max_len, int V,
                                              int first, int stride) {
  int last = 0;
  for (int i = first; i < max_len; i += stride) {
    if (in_range(p[i], V)) last = i + 1;
  }
  return __reduce_max_sync(kFull, last);
}

// ---- the factor: a warp a chain ------------------------------------------------

// The reciprocal of a pivot without an IEEE division: rcp.approx.ftz.f64's
// seed y0 = (1 - e)/x, then one cubic Newton step y1 = y0 (1 + e + e^2) =
// (1 - e^3)/x in three dependent FMAs (e = 1 - x y0, the product exact
// inside the FMA).  The seed's relative error is below 2^-19.9 on an H100
// (chip_smoke.recip_check: 9.8e-7 over 2^22 inputs), so e^3 < 2^-59 and
// the result is within one ulp of IEEE 1/x (the same check: at most one
// ulp, 99.97 % equal).  The block rule cannot see a missing step (its 1e-6
// floor is above the seed's error), so recip_check fails the run if any
// result is further.  The pivots are positive Schur complements of an SPD
// C, each at least C's smallest eigenvalue, which for the solver's blocks
// (information matrices plus the LM damping; a fixed variable's identity)
// is decades above the normal range's 2.2e-308: no zero or subnormal pivot
// reaches the flush-to-zero seed, and 1/x stays finite.
__device__ __forceinline__ double recip(double x) {
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(x));
  const double e = fma(-x, y, 1.0);
  return fma(y, fma(e, e, e), y);
}

// Six doubles from shared memory, 16-byte aligned.
__device__ __forceinline__ void load6(const double* src, double (&dst)[6]) {
  const double2* v = reinterpret_cast<const double2*>(src);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const double2 a = v[j];
    dst[2 * j] = a.x;
    dst[2 * j + 1] = a.y;
  }
}

// Two entries rounded once to T, to device memory (8-byte aligned for
// float, 16 for double: an even column of a block).
__device__ __forceinline__ void store_pair(float* dst, double2 v) {
  *reinterpret_cast<float2*>(dst) = make_float2(static_cast<float>(v.x), static_cast<float>(v.y));
}
__device__ __forceinline__ void store_pair(double* dst, double2 v) {
  *reinterpret_cast<double2*>(dst) = v;
}

// The factor's lanes: lane 3 k + g (< 18) holds columns 2 g and 2 g + 1
// of row k of each block; lanes 18-31 repeat lanes 0-13, so the warp never
// diverges (only lanes 0-17 write).
constexpr int kPairLanes = 18;

// The factor's exchange buffers in shared memory, 6x6 doubles each, every
// one written once a step by the lanes' pairs and read after a __syncwarp:
// P_i, the running matrix before each of the six pivots, and Cinv_i (read
// by the next step).  A buffer is rewritten only a step later, after the
// __syncwarps between, so no lane can still be reading it.
constexpr int kXP = 0, kXPivot = 1, kXCinv = 7, kXBufs = 8;

__device__ __forceinline__ void put_pair(double* buf, int k, int g, double2 v) {
  if (threadIdx.x < kPairLanes) *reinterpret_cast<double2*>(buf + k * 6 + 2 * g) = v;
}
__device__ __forceinline__ double2 get_pair(const double* buf, int r, int g) {
  return *reinterpret_cast<const double2*>(buf + r * 6 + 2 * g);
}

// One dependent step of the factor, run by every lane of the warp; `x`
// the exchange buffers, x[kXCinv] holding Cinv_{i-1}:
//   P_i[k][c]     = Cinv_{i-1} row k . L_i row c, c the lane's two columns;
//   C_i[k][c]     = D_i[k][c] - L_i row k . P_i column c (P_i's pairs
//                   through x[kXP]);
//   Cinv_i        by Gauss-Jordan with diagonal pivots: before pivot q the
//                   lanes put their pairs in x[kXPivot + q] and each takes row q's
//                   entries at its columns and its own row's entry q; the
//                   reciprocal is `recip` (every lane forms it), each
//                   entry one FMA.  Every lane also forms pivot q + 1 as its
//                   own lane will, from three entries of the same buffer, and
//                   its reciprocal before pivot q's update, so the chain from
//                   one reciprocal to the next is a multiply, an FMA and
//                   `recip`, and the buffer's round trip runs beside it (as
//                   does C[0][0], which every lane forms as lane 0 does).
// The exchanges go through shared memory, not shuffles: a double shuffle
// keeps one warp busy several times longer than a shared load, and
// the step needs ~40 of them.  Each entry's arithmetic is the same whatever
// lane holds it.  `ops` gives the step's operands (not on the chain):
// ops.cols(l0, l1) rows 2 g and 2 g + 1 of L_i, ops.own(lk, d) row k of L_i
// and D_i[k][2g..2g+1], ops.row0(l, d00) row 0 of L_i and D_i[0][0].
// Returns the lane's pairs of P_i in `pr` and of Cinv_i in `a` (also left
// in x[kXCinv] for the next step).
template <class Ops>
__device__ __forceinline__ void factor_step(double2& a, double2& pr, const Ops& ops,
                                            double (*x)[36], int k, int g) {
  double ar[6], l0[6], l1[6];                   // row k of Cinv_{i-1}; rows 2 g, 2 g + 1 of L_i
  load6(x[kXCinv] + k * 6, ar);
  ops.cols(l0, l1);
  auto dot = [&](const double (&l)[6]) {        // sum_m ar[m] l[m], two chains of three
    double s0 = ar[0] * l[0], s1 = ar[1] * l[1];
    s0 = fma(ar[2], l[2], s0);
    s1 = fma(ar[3], l[3], s1);
    s0 = fma(ar[4], l[4], s0);
    s1 = fma(ar[5], l[5], s1);
    return s0 + s1;
  };
  pr = make_double2(dot(l0), dot(l1));
  put_pair(x[kXP], k, g, pr);
  __syncwarp();
  double lk[6];
  double2 d, s0, s1;
  ops.own(lk, d);
#pragma unroll
  for (int m = 0; m < 6; ++m) {                 // C[k][c] = D[k][c] - sum_m L[k][m] P[m][c]
    const double2 pm = get_pair(x[kXP], m, g);  // (even m in s0, odd in s1)
    if (m == 0) {
      s0 = make_double2(lk[0] * pm.x, lk[0] * pm.y);
    } else if (m == 1) {
      s1 = make_double2(lk[1] * pm.x, lk[1] * pm.y);
    } else if (m % 2 == 0) {
      s0 = make_double2(fma(lk[m], pm.x, s0.x), fma(lk[m], pm.y, s0.y));
    } else {
      s1 = make_double2(fma(lk[m], pm.x, s1.x), fma(lk[m], pm.y, s1.y));
    }
  }
  a = make_double2(d.x - (s0.x + s1.x), d.y - (s0.y + s1.y));
  double ip;                                    // the reciprocal of the pivot to come
  {                                             // C[0][0], formed as lane 0 forms it
    double l[6], d00;
    ops.row0(l, d00);
    double t0 = 0.0, t1 = 0.0;
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      const double pm = x[kXP][m * 6];
      if (m == 0) t0 = l[0] * pm;
      else if (m == 1) t1 = l[1] * pm;
      else if (m % 2 == 0) t0 = fma(l[m], pm, t0);
      else t1 = fma(l[m], pm, t1);
    }
    ip = recip(d00 - (t0 + t1));
  }
#pragma unroll
  for (int q = 0; q < 6; ++q) {                 // Gauss-Jordan, pivot (q, q)
    double* b = x[kXPivot + q];
    put_pair(b, k, g, a);
    __syncwarp();
    const double2 row = get_pair(b, q, g);      // row q at the lane's columns
    const double akq = b[k * 6 + q];
    double ip_next = 0.0;
    if (q < 5) {                                // pivot q + 1 from row q + 1's entries q, q + 1
      const double nq = b[(q + 1) * 6 + q], nd = b[(q + 1) * 7], rq = b[q * 6 + q + 1];
      ip_next = recip(fma(-(nq * ip), rq, nd));
    }
    const bool pivot = k == q;
    // row q scales by ip; the others subtract a[k][q] ip times it
    const double m = pivot ? ip : -(akq * ip);
    a.x = 2 * g == q ? m : fma(m, row.x, pivot ? 0.0 : a.x);
    a.y = 2 * g + 1 == q ? m : fma(m, row.y, pivot ? 0.0 : a.y);
    ip = ip_next;
  }
  put_pair(x[kXCinv], k, g, a);
  __syncwarp();
}

// The factor's operands of a step, staged in shared memory as double:
// D_i (36) then L_i (36), row-major.
struct StagedOps {
  const double* blk;
  int k, g;
  __device__ __forceinline__ void cols(double (&l0)[6], double (&l1)[6]) const {
    load6(blk + 36 + 12 * g, l0);
    load6(blk + 42 + 12 * g, l1);
  }
  __device__ __forceinline__ void own(double (&lk)[6], double2& d) const {
    load6(blk + 36 + k * 6, lk);
    d = *reinterpret_cast<const double2*>(blk + k * 6 + 2 * g);
  }
  __device__ __forceinline__ void row0(double (&l)[6], double& d00) const {
    load6(blk + 36, l);
    d00 = blk[0];
  }
};

constexpr int kFSeg = 8;        // steps a staged segment of the factor (8 x 4 staging lanes)
constexpr int kFStage = 18;     // values of a segment a lane stages: 72 a step over 4 lanes

// grid (n_chains), one warp a chain.  Every lane runs the dependent steps
// (factor_step) and lanes 0-17 store their pairs of P_i and Cinv_i (the
// stores fill the chain's stall cycles; written a segment at a time they
// cost more); after each segment of kFSeg steps every lane stages: lane j
// loads a quarter of step j % 8's D and L (18 values, through its
// own pos entry) of the segment after next into registers, and a segment
// later converts them to double into shared memory (a ring of three) and
// writes that step's Lc; pos is loaded a segment before its blocks.  So a
// step's operands are in shared memory a segment before it runs, and no
// CTA barrier and no device-memory access is on the chain.
template <typename T>
__global__ void __launch_bounds__(32)
tridiag_factor(const T* __restrict__ D, const T* __restrict__ L, const int64_t* __restrict__ pos,
               T* __restrict__ Cinv, T* __restrict__ Lc, T* __restrict__ P, int max_len, int V) {
  __shared__ __align__(16) double sBlk[3][kFSeg][72];
  __shared__ __align__(16) double sX[kXBufs][36];
  const int lane = threadIdx.x;
  const int64_t* p = pos + static_cast<long long>(blockIdx.x) * max_len;
  const long long base = static_cast<long long>(blockIdx.x) * max_len * 36;
  const int n = warp_chain_len(p, max_len, V, lane, 32);

  // past the chain's last variable: identity and zero, as the padded gathers give
  const long long end = static_cast<long long>(max_len) * 36;
  for (long long e = static_cast<long long>(n) * 36 + lane; e < end; e += 32) {
    const int q = static_cast<int>(e % 36);
    Cinv[base + e] = static_cast<T>(q % 7 == 0 ? 1 : 0);
    Lc[base + e] = static_cast<T>(0);
    P[base + e] = static_cast<T>(0);
  }
  if (n == 0) return;

  // staging: lane j takes step j % 8 of a segment, entries j / 8 + 4 u of its
  // D (u < 9) and L (u >= 9); a padding entry is D = I, L = 0
  const int sq = lane & (kFSeg - 1), part = lane >> 3;
  T held[kFStage];
  auto pos_of = [&](int sg) -> long long {
    const int i = sg * kFSeg + sq;
    return i < n ? p[i] : -1;
  };
  auto fetch = [&](long long v) {
    const bool ok = in_range(v, V);
#pragma unroll
    for (int u = 0; u < 9; ++u) {
      const int e = part + 4 * u;
      held[u] = ok ? D[v * 36 + e] : static_cast<T>(e % 7 == 0 ? 1 : 0);
      held[9 + u] = ok ? L[v * 36 + e] : static_cast<T>(0);
    }
  };
  auto put = [&](int sg) {
    double* dst = sBlk[sg % 3][sq];
    const int i = sg * kFSeg + sq;
#pragma unroll
    for (int u = 0; u < 9; ++u) {
      dst[part + 4 * u] = static_cast<double>(held[u]);
      dst[36 + part + 4 * u] = static_cast<double>(held[9 + u]);
      if (i < n) Lc[base + static_cast<long long>(i) * 36 + part + 4 * u] = held[9 + u];
    }
  };
  const int segs = (n + kFSeg - 1) / kFSeg;
  fetch(pos_of(0));
  put(0);
  if (segs > 1) {
    fetch(pos_of(1));
    put(1);
  }
  if (segs > 2) fetch(pos_of(2));
  long long v_next = segs > 3 ? pos_of(3) : -1;
  __syncwarp();

  const int k = lane % kPairLanes / 3, g = lane % kPairLanes % 3;
  put_pair(sX[kXCinv], k, g, make_double2(2 * g == k ? 1.0 : 0.0,   // Cinv_{-1} = I (L_0 is
                                          2 * g + 1 == k ? 1.0 : 0.0));   // zero: C_0 = D_0)
  __syncwarp();
  for (int s = 0; s < segs; ++s) {
    const int steps = min(kFSeg, n - s * kFSeg);
    for (int q = 0; q < steps; ++q) {
      const int i = s * kFSeg + q;
      double2 a, pr;
      factor_step(a, pr, StagedOps{sBlk[s % 3][q], k, g}, sX, k, g);
      if (lane < kPairLanes) {                   // P_i and Cinv_i, rounded once
        const long long o = base + static_cast<long long>(i) * 36 + k * 6 + 2 * g;
        store_pair(P + o, pr);
        store_pair(Cinv + o, a);
      }
    }
    __syncwarp();
    if (s + 2 < segs) put(s + 2);                // its slot was last read in segment s - 1
    if (s + 3 < segs) {
      fetch(v_next);
      v_next = s + 4 < segs ? pos_of(s + 4) : -1;
    }
    __syncwarp();
  }
}

// The factor's operands held in registers (tridiag_factor_step_floor).
struct RegOps {
  const double (&l0)[6];
  const double (&l1)[6];
  const double (&lk)[6];
  const double (&lr0)[6];
  double2 d;
  double d00;
  __device__ __forceinline__ void cols(double (&c0)[6], double (&c1)[6]) const {
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      c0[j] = l0[j];
      c1[j] = l1[j];
    }
  }
  __device__ __forceinline__ void own(double (&l)[6], double2& dd) const {
#pragma unroll
    for (int j = 0; j < 6; ++j) l[j] = lk[j];
    dd = d;
  }
  __device__ __forceinline__ void row0(double (&l)[6], double& d) const {
#pragma unroll
    for (int j = 0; j < 6; ++j) l[j] = lr0[j];
    d = d00;
  }
};

// `steps` dependent steps of the factor's recurrence (factor_step) with
// every operand in registers: one warp, as tridiag_factor runs it, the same
// D and L each step.  out (36) keeps the result live.
__global__ void tridiag_factor_step_floor(const double* __restrict__ m, int steps,
                                          double* __restrict__ out) {
  __shared__ __align__(16) double sX[kXBufs][36];
  const int lane = threadIdx.x;
  const int k = lane % kPairLanes / 3, g = lane % kPairLanes % 3;
  double l0[6], l1[6], lk[6], lr0[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    l0[j] = m[36 + 12 * g + j];
    l1[j] = m[42 + 12 * g + j];
    lk[j] = m[36 + k * 6 + j];
    lr0[j] = m[36 + j];
  }
  const RegOps ops{l0, l1, lk, lr0, make_double2(m[k * 6 + 2 * g], m[k * 6 + 2 * g + 1]), m[0]};
  put_pair(sX[kXCinv], k, g, make_double2(2 * g == k ? 1.0 : 0.0, 2 * g + 1 == k ? 1.0 : 0.0));
  __syncwarp();
  double2 a, pr;
  for (int s = 0; s < steps; ++s) factor_step(a, pr, ops, sX, k, g);
  if (lane < kPairLanes) {
    out[k * 6 + 2 * g] = a.x + pr.x;
    out[k * 6 + 2 * g + 1] = a.y + pr.y;
  }
}

// The reciprocal as the factor forms it, and rcp.approx.ftz.f64's seed
// alone, of n doubles (chip_smoke.recip_check).
__global__ void tridiag_recip_probe(const double* __restrict__ x, double* __restrict__ seed,
                                    double* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  double s;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(s) : "d"(x[i]));
  seed[i] = s;
  y[i] = recip(x[i]);
}

// The solve's dependent step, as thread k of a lane's six holds it:
// rhs - sum_j m[j] * v_j, v_j the carried value of the lane's thread j
// (broadcast by shuffles from lane `first`, the lane's thread 0), the sum in
// two chains of three.  Returns it; `vj` gets the shuffled vector.
__device__ __forceinline__ double dep_step(const double (&m)[6], double v, double rhs, int first,
                                           double (&vj)[6]) {
#pragma unroll
  for (int j = 0; j < 6; ++j) vj[j] = __shfl_sync(kFull, v, first + j);
  double a = m[0] * vj[0], b = m[1] * vj[1];
  a = fma(m[2], vj[2], a);
  b = fma(m[3], vj[3], b);
  a = fma(m[4], vj[4], a);
  b = fma(m[5], vj[5], b);
  return (rhs - a) - b;
}

__device__ __forceinline__ double dot6(const double (&m)[6], const double (&v)[6]) {
  double a = m[0] * v[0], b = m[1] * v[1];
  a = fma(m[2], v[2], a);
  b = fma(m[3], v[3], b);
  a = fma(m[4], v[4], a);
  b = fma(m[5], v[5], b);
  return a + b;
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The solve's dynamic shared memory, between two guard bands (a step reads
// its operands two steps ahead, unclamped, so the last reads of a segment
// land past its buffer): three staging segments of blocks
// (kSeg steps of P, then kSeg of Cinv, as T, as cp.async lands them), for
// float input two of the same blocks in double (the operands the steps
// read), three of vectors (kSeg rows a lane), two of the steps' results
// (y forward, x back, as double), and a ring of four segments of pos.
__host__ __device__ constexpr int blocks_bytes(int elem) { return kSeg * 72 * elem; }
__host__ __device__ constexpr int operand_bytes(int elem) {
  return elem == 8 ? 0 : 2 * blocks_bytes(8);
}
constexpr int kVecsBytes = kSeg * kCtaLanes * kVecBytes;
constexpr int kGuard = 1024;   // bytes before and after: the steps read up to two steps past
__host__ __device__ constexpr int solve_smem(int elem) {
  return 2 * kGuard + 3 * blocks_bytes(elem) + operand_bytes(elem) + 5 * kVecsBytes +
         4 * kSeg * 8;
}

// A barrier of the solve's producer threads alone (named barrier 1).
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kProducers) : "memory");
}

// The CTA's view of its chain and lanes, and its shared memory.  The
// staging functions run on the producer threads (32-127, `t` from 0); `it` counts
// a pass's segments in the order they run (forward: segment it; back:
// segment S - 1 - it) and picks the buffers.
template <typename T>
struct Solve {
  const T* cinv;       // the chain's Cinv blocks, chain-major
  const T* pb;         // the chain's P blocks
  const int64_t* p;    // the chain's pos row
  const T* r;          // r of the CTA's first lane
  double* w;           // w of the CTA's first lane
  int n, V, lanes, S;  // steps, variables, lanes of this CTA, segments
  unsigned char* smem;

  __device__ T* staged(int it) const {
    return reinterpret_cast<T*>(smem + (it % 3) * blocks_bytes(sizeof(T)));
  }
  // The segment's blocks in double: the staged ones themselves for double
  // input, else a converted copy.  (`smem` points past the first guard.)
  __device__ double* operands(int it) const {
    if (sizeof(T) == 8) return reinterpret_cast<double*>(staged(it));
    return reinterpret_cast<double*>(smem + 3 * blocks_bytes(sizeof(T)) +
                                     (it & 1) * blocks_bytes(8));
  }
  __device__ unsigned char* vecs(int it) const {
    return smem + 3 * blocks_bytes(sizeof(T)) + operand_bytes(sizeof(T)) + (it % 3) * kVecsBytes;
  }
  // The steps' results of segment `it`: a row of 6 doubles a (step, lane).
  __device__ double* results(int it) const {
    return reinterpret_cast<double*>(smem + 3 * blocks_bytes(sizeof(T)) +
                                     operand_bytes(sizeof(T)) + (3 + (it & 1)) * kVecsBytes);
  }
  __device__ long long* pos_seg(int it) const {
    return reinterpret_cast<long long*>(smem + 3 * blocks_bytes(sizeof(T)) +
                                        operand_bytes(sizeof(T)) + 5 * kVecsBytes) +
           (it % 4) * kSeg;
  }
  __device__ int seg(int it, bool forward) const { return forward ? it : S - 1 - it; }
  __device__ int seg_len(int sg) const { return min(kSeg, n - sg * kSeg); }

  // pos of the pass's segment `it` into its ring slot (8-byte copies: a
  // row of pos is 8-byte aligned only)
  __device__ void stage_pos(int it, bool forward, int t) const {
    const int sg = seg(it, forward), c = seg_len(sg);
    long long* dst = pos_seg(it);
    for (int q = t; q < c; q += kProducers) cp_async(dst + q, p + sg * kSeg + q, 8);
  }

  // Rows of a vector (r forward, w back) of segment `it`, gathered through
  // its staged pos: a row of six T (or doubles) in three copies, zeros
  // where the entry is padding.
  template <typename U>
  __device__ void stage_rows(int it, int c, const U* src, int t) const {
    const long long* ps = pos_seg(it);
    unsigned char* dst = vecs(it);
    constexpr int part = 2 * sizeof(U);   // a third of a row: 8 bytes (float), 16 (double)
    for (int e = t; e < c * kCtaLanes * 3; e += kProducers) {
      const int row = e / 3, third = e - row * 3;
      const int q = row / kCtaLanes, l = row - q * kCtaLanes;
      unsigned char* d = dst + row * kVecBytes + third * part;
      const long long v = ps[q];
      if (l < lanes && in_range(v, V)) {
        cp_async(d, src + static_cast<long long>(l) * V * 6 + v * 6 + third * 2, part);
      } else {
        reinterpret_cast<U*>(d)[0] = U(0);
        reinterpret_cast<U*>(d)[1] = U(0);
      }
    }
  }

  // `count` blocks of a chain-major array from step `first` into a
  // staging segment (16-byte copies), zeros for the steps at or past `limit`.
  __device__ void stage_blocks(T* dst, const T* src, int first, int count, int limit,
                               int t) const {
    constexpr int per_step = 36 * sizeof(T) / 16;
    const int real = max(0, min(count, limit - first));
    for (int e = t; e < count * per_step; e += kProducers) {
      if (e / per_step < real) {
        cp_async(reinterpret_cast<unsigned char*>(dst) + e * 16,
                 reinterpret_cast<const unsigned char*>(src + static_cast<long long>(first) * 36) +
                     e * 16, 16);
      } else {
        reinterpret_cast<float4*>(dst)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }

  // Segment `it` of a pass: forward, P_i, Cinv_i and the lanes' r_i; back,
  // P_{i+1} (zero past the chain's last step) and the lanes' w_i.
  __device__ void stage(int it, bool forward, int t) const {
    const int sg = seg(it, forward), c = seg_len(sg);
    if (forward) {
      stage_blocks(staged(it), pb, sg * kSeg, c, n, t);
      stage_blocks(staged(it) + kSeg * 36, cinv, sg * kSeg, c, n, t);
      stage_rows(it, c, r, t);
    } else {
      stage_blocks(staged(it), pb, sg * kSeg + 1, c, n, t);
      stage_rows(it, c, w, t);
    }
  }

  // The landed segment `it` turned to double once for all the CTA's lanes
  // (float input): its blocks (four values a 16-byte load), in the staged
  // layout, and forward its rows of r, each in place in its 48-byte slot.
  __device__ void convert(int it, bool forward, int t) const {
    if (sizeof(T) == 8) return;
    const float4* src = reinterpret_cast<const float4*>(staged(it));
    double2* dst = reinterpret_cast<double2*>(operands(it));
    const int count = (forward ? 2 : 1) * kSeg * 36 / 4;
#pragma unroll 3
    for (int e = t; e < count; e += kProducers) {
      const float4 v = src[e];
      dst[2 * e] = make_double2(v.x, v.y);
      dst[2 * e + 1] = make_double2(v.z, v.w);
    }
    if (!forward) return;
    for (int row = t; row < seg_len(it) * kCtaLanes; row += kProducers) {
      unsigned char* slot = vecs(it) + row * kVecBytes;
      const float2 a = reinterpret_cast<const float2*>(slot)[0];
      const float2 b = reinterpret_cast<const float2*>(slot)[1];
      const float2 c = reinterpret_cast<const float2*>(slot)[2];
      double2* d = reinterpret_cast<double2*>(slot);
      d[0] = make_double2(a.x, a.y);
      d[1] = make_double2(b.x, b.y);
      d[2] = make_double2(c.x, c.y);
    }
  }

  // Segment `it`'s results out to device memory through its staged pos:
  // forward, w_i = Cinv_i y_i into the double scratch; back, x_i rounded to
  // T.  (Before produce_next: it reuses this segment's buffers.)
  __device__ void write_out(int it, bool forward, T* x, int t) const {
    const int c = seg_len(seg(it, forward));
    const long long* ps = pos_seg(it);
    const double* res = results(it);
    const double* cv = operands(it) + kSeg * 36;
    for (int e = t; e < c * kCtaLanes * 6; e += kProducers) {
      const int row = e / 6, kk = e - row * 6;
      const int q = row / kCtaLanes, l = row - q * kCtaLanes;
      const long long v = ps[q];
      if (l >= lanes || !in_range(v, V)) continue;
      const long long o = static_cast<long long>(l) * V * 6 + v * 6 + kk;
      if (forward) {
        double a[6], yv[6];
        load6(cv + q * 36 + kk * 6, a);
        load6(res + row * 6, yv);
        w[o] = dot6(a, yv);
      } else {
        x[o] = static_cast<T>(res[e]);
      }
    }
    producer_sync();
  }

  // The producer warp's part of a pass: segments 0 and 1 before the first
  // barrier, then in each iteration the segment after next.
  __device__ void produce_first(bool forward, int t) const {
    stage_pos(0, forward, t);
    cp_async_wait_all();
    producer_sync();
    if (S > 1) stage_pos(1, forward, t);
    stage(0, forward, t);
    cp_async_wait_all();
    producer_sync();
    convert(0, forward, t);
    if (S > 2) stage_pos(2, forward, t);
    if (S > 1) stage(1, forward, t);
    cp_async_commit();
  }
  __device__ void produce_next(int it, bool forward, int t) const {
    if (it + 1 >= S) return;
    cp_async_wait_all();   // segment it + 1 and pos it + 2, issued an iteration ago
    producer_sync();
    convert(it + 1, forward, t);
    if (it + 3 < S) stage_pos(it + 3, forward, t);
    if (it + 2 < S) stage(it + 2, forward, t);
    cp_async_commit();
  }
};

// Column six of a 6x6 row-major block from shared memory: src[0], src[6], ...
__device__ __forceinline__ void column6(const double* src, double (&dst)[6]) {
#pragma unroll
  for (int j = 0; j < 6; ++j) dst[j] = src[j * 6];
}

// What thread k of a lane reads for a step: a column (forward: column k of
// P_q) or row (back: row k of P_{q+1}) of a block, and the right-hand side
// (r_q forward, w_q back).
struct Operands {
  double p[6], r;
};

// grid (n_chains, lane groups), two warps a CTA: warp 0 runs the steps (its
// six-thread group g runs lane blockIdx.y * kCtaLanes + g of the chain),
// warp 1 stages and converts the segments ahead of it.  Warp 0 reads a
// step's operands two steps ahead into two register sets used in turn.
template <typename T>
__global__ void __launch_bounds__(32 + kProducers)
tridiag_apply(const T* __restrict__ Cinv, const T* __restrict__ P,
              const int64_t* __restrict__ pos, const T* __restrict__ r, double* __restrict__ w,
              T* __restrict__ x, int n_lanes, int max_len, int V) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sLen[1 + kProducers / 32];
  const int chain = blockIdx.x;
  const int lane0 = blockIdx.y * kCtaLanes;
  const int tl = threadIdx.x & 31;
  const bool producer = threadIdx.x >= 32;
  const int pt = threadIdx.x - 32;          // a producer thread's index
  const int64_t* p = pos + static_cast<long long>(chain) * max_len;
  const int len = warp_chain_len(p, max_len, V, threadIdx.x, 32 + kProducers);
  if (tl == 0) sLen[threadIdx.x >> 5] = len;
  __syncthreads();
  int n = 0;
  for (int i = 0; i < 1 + kProducers / 32; ++i) n = max(n, sLen[i]);
  if (n == 0) return;   // uniform across the CTA

  Solve<T> c;
  c.cinv = Cinv + static_cast<long long>(chain) * max_len * 36;
  c.pb = P + static_cast<long long>(chain) * max_len * 36;
  c.p = p;
  c.r = r + static_cast<long long>(lane0) * V * 6;
  c.w = w + static_cast<long long>(lane0) * V * 6;
  c.n = n;
  c.V = V;
  c.lanes = min(kCtaLanes, n_lanes - lane0);
  c.S = (n + kSeg - 1) / kSeg;
  c.smem = smem + kGuard;

  const int g = tl / 6, k = tl - 6 * g;
  const int first = 6 * g;                  // the group's thread 0 (30 for the idle pair)
  const bool group = g < kCtaLanes;          // threads 30-31 carry no lane
  T* xl = x + static_cast<long long>(lane0) * V * 6;
  double vj[6];

  // forward: y_i = r_i - P_i^T y_{i-1} into the segment's results; the
  // producer forms w_i = Cinv_i y_i from them a segment later
  if (producer) c.produce_first(true, pt);
  __syncthreads();
  double y = 0.0;
  for (int it = 0; it < c.S; ++it) {
    if (producer) {
      if (it > 0) c.write_out(it - 1, true, xl, pt);
      c.produce_next(it, true, pt);
    } else {
      const double* bp = c.operands(it) + k;   // column k of P_q, at q * 36
      const double* rows = reinterpret_cast<const double*>(c.vecs(it) + g * kVecBytes) + k;
      double* out = c.results(it) + g * 6 + k;
      const int steps = c.seg_len(it);
      // (reads past the segment's last step land in the guard or the next
      // buffer, and are never used)
      auto load = [&](Operands& f, int q) {
        column6(bp + q * 36, f.p);
        f.r = rows[q * kCtaLanes * 6];
      };
      auto step = [&](const Operands& f, int q) {
        y = dep_step(f.p, y, f.r, first, vj);
        if (group) out[q * kCtaLanes * 6] = y;
      };
      Operands a, b;
      load(a, 0);
      for (int q = 0; q < steps; q += 2) {
        load(b, q + 1);
        step(a, q);
        if (q + 1 >= steps) break;
        load(a, q + 2);
        step(b, q + 1);
      }
    }
    __syncthreads();
  }
  if (producer) c.write_out(c.S - 1, true, xl, pt);

  // back: x_i = w_i - P_{i+1} x_{i+1}, x past the end 0; w read back staged,
  // x written out by the producer a segment later
  __threadfence();
  __syncthreads();
  if (producer) c.produce_first(false, pt);
  __syncthreads();
  double xn = 0.0;
  for (int it = 0; it < c.S; ++it) {
    if (producer) {
      if (it > 0) c.write_out(it - 1, false, xl, pt);
      c.produce_next(it, false, pt);
    } else {
      const double* bp = c.operands(it) + k * 6;   // row k of P_{q+1}, at q * 36
      const double* rows = reinterpret_cast<const double*>(c.vecs(it) + g * kVecBytes) + k;
      double* out = c.results(it) + g * 6 + k;
      const int steps = c.seg_len(c.seg(it, false));
      auto load = [&](Operands& f, int q) {   // q down to -1: the guard or the buffer before
        load6(bp + q * 36, f.p);
        f.r = rows[q * kCtaLanes * 6];
      };
      auto step = [&](const Operands& f, int q) {
        xn = dep_step(f.p, xn, f.r, first, vj);
        if (group) out[q * kCtaLanes * 6] = xn;
      };
      Operands a, b;
      load(a, steps - 1);
      for (int q = steps - 1; q >= 0; q -= 2) {
        load(b, q - 1);
        step(a, q);
        if (q == 0) break;
        load(a, q - 2);
        step(b, q - 1);
      }
    }
    __syncthreads();
  }
  if (producer) c.write_out(c.S - 1, false, xl, pt);
}

// `steps` dependent steps of the solve's recurrence (dep_step) with every
// operand in registers: one warp, a lane of six threads in each group, as
// tridiag_apply runs it.  out[k] keeps the result live.
__global__ void tridiag_step_floor(const double* __restrict__ m, int steps,
                                   double* __restrict__ out) {
  const int tl = threadIdx.x & 31, k = tl % 6, first = 6 * (tl / 6);
  double row[6], vj[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) row[j] = m[k * 6 + j];
  const double rhs = m[36 + k];
  double v = rhs;
  for (int s = 0; s < steps; ++s) v = dep_step(row, v, rhs, first, vj);
  out[threadIdx.x] = v;
}

struct DeviceScope {
  int current = -1;
  int target;
  cudaError_t rc;
  explicit DeviceScope(int device) : target(device) {
    rc = cudaGetDevice(&current);
    if (rc == cudaSuccess && current != device) rc = cudaSetDevice(device);
  }
  ~DeviceScope() {
    if (current >= 0 && current != target) cudaSetDevice(current);
  }
};

// The solve's dynamic shared memory above 48 KB, allowed once a device
// (the first launch is eager: the PCG's capture comes after it).
template <typename T>
cudaError_t allow_smem(int device) {
  static bool done[64] = {};
  if (device >= 0 && device < 64 && done[device]) return cudaSuccess;
  const cudaError_t rc = cudaFuncSetAttribute(
      tridiag_apply<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, solve_smem(sizeof(T)));
  if (rc == cudaSuccess && device >= 0 && device < 64) done[device] = true;
  return rc;
}

}  // namespace

// dtype 0: float32, 1: float64.  D, L (V, 6, 6); pos (n_chains, max_len)
// int64; Cinv, Lc, P (n_chains, max_len, 6, 6).  Launches on `stream` on
// CUDA device `device` (the calling thread's current device is restored).
// Returns a cudaError_t.
extern "C" int ltm_tridiag_factor(const void* D, const void* L, const int64_t* pos, void* Cinv,
                                  void* Lc, void* P, int dtype, int n_chains, int max_len, int V,
                                  int device, void* stream) {
  if (n_chains < 0 || max_len < 0 || V < 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_chains == 0 || max_len == 0) return 0;
  DeviceScope scope(device);
  if (scope.rc != cudaSuccess) return static_cast<int>(scope.rc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    tridiag_factor<float><<<n_chains, 32, 0, s>>>(
        static_cast<const float*>(D), static_cast<const float*>(L), pos,
        static_cast<float*>(Cinv), static_cast<float*>(Lc), static_cast<float*>(P), max_len, V);
  } else {
    tridiag_factor<double><<<n_chains, 32, 0, s>>>(
        static_cast<const double*>(D), static_cast<const double*>(L), pos,
        static_cast<double*>(Cinv), static_cast<double*>(Lc), static_cast<double*>(P), max_len,
        V);
  }
  return static_cast<int>(cudaGetLastError());
}

// r, x (n_lanes, V, 6); w (n_lanes, V, 6) double scratch; Cinv, P, pos as
// tridiag_factor writes and reads them, each 16-byte aligned.  Every
// variable must lie in exactly one chain.
extern "C" int ltm_tridiag_apply(const void* Cinv, const void* P, const int64_t* pos,
                                 const void* r, double* w, void* x, int dtype, int n_lanes,
                                 int n_chains, int max_len, int V, int device, void* stream) {
  if (n_lanes < 0 || n_chains < 0 || max_len < 0 || V < 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_lanes == 0 || n_chains == 0 || max_len == 0) return 0;
  const int groups = (n_lanes + kCtaLanes - 1) / kCtaLanes;
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  DeviceScope scope(device);
  if (scope.rc != cudaSuccess) return static_cast<int>(scope.rc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_chains), static_cast<unsigned>(groups));
  if (dtype == 0) {
    const cudaError_t rc = allow_smem<float>(device);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    tridiag_apply<float><<<grid, 32 + kProducers, solve_smem(sizeof(float)), s>>>(
        static_cast<const float*>(Cinv), static_cast<const float*>(P), pos,
        static_cast<const float*>(r), w, static_cast<float*>(x), n_lanes, max_len, V);
  } else {
    const cudaError_t rc = allow_smem<double>(device);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    tridiag_apply<double><<<grid, 32 + kProducers, solve_smem(sizeof(double)), s>>>(
        static_cast<const double*>(Cinv), static_cast<const double*>(P), pos,
        static_cast<const double*>(r), w, static_cast<double*>(x), n_lanes, max_len, V);
  }
  return static_cast<int>(cudaGetLastError());
}

// m (42,) doubles: a 6x6 matrix and a right-hand side; out (32,) doubles.
// One warp, `steps` dependent steps (tridiag_step_floor).
extern "C" int ltm_tridiag_step_floor(const double* m, int steps, double* out, int device,
                                      void* stream) {
  DeviceScope scope(device);
  if (scope.rc != cudaSuccess) return static_cast<int>(scope.rc);
  tridiag_step_floor<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(m, steps, out);
  return static_cast<int>(cudaGetLastError());
}

// m (72,) doubles: D and L of a step; out (36,) doubles.  One warp,
// `steps` dependent steps (tridiag_factor_step_floor).
extern "C" int ltm_tridiag_factor_step_floor(const double* m, int steps, double* out, int device,
                                             void* stream) {
  DeviceScope scope(device);
  if (scope.rc != cudaSuccess) return static_cast<int>(scope.rc);
  tridiag_factor_step_floor<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(m, steps, out);
  return static_cast<int>(cudaGetLastError());
}

// x, seed, y (n,) doubles: seed = rcp.approx.ftz.f64(x), y = the factor's
// reciprocal of x (tridiag_recip_probe).
extern "C" int ltm_tridiag_recip_probe(const double* x, double* seed, double* y, int n, int device,
                                       void* stream) {
  if (n <= 0) return n == 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  DeviceScope scope(device);
  if (scope.rc != cudaSuccess) return static_cast<int>(scope.rc);
  tridiag_recip_probe<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, seed, y,
                                                                                     n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ltm_tridiag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
