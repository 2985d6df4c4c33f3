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
// P, chain-major (n_chains, max_len, 6, 6).  One CTA of 64 threads a chain;
// thread t < 36 holds entry (t / 6, t % 6) of each block.  The products read
// the running Cinv and L_i from shared memory; D_{i+1}, L_{i+1} and pos[i+1]
// are loaded into registers while step i computes, since they do not depend
// on the recurrence.
//   The inverse is an in-place Gauss-Jordan with the pivots on the diagonal
// (six steps, ping-pong buffers, one barrier each), not jnp.linalg.inv's LU
// with partial pivoting: C is SPD by construction (_precond_blocks'
// docstring; a fixed variable's block is the identity), so every diagonal
// pivot is a positive Schur complement and elimination without row
// exchange is backward stable for it, as Cholesky is; it needs no
// data-dependent row exchange, no square roots and no triangular passes.
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

constexpr int kFactorThreads = 64;   // two warps a chain, 36 of them hold an entry
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

template <typename T>
__global__ void __launch_bounds__(kFactorThreads)
tridiag_factor(const T* __restrict__ D, const T* __restrict__ L, const int64_t* __restrict__ pos,
               T* __restrict__ Cinv, T* __restrict__ Lc, T* __restrict__ P, int max_len, int V) {
  __shared__ double sC[2][36];   // the running inverse; ping-pong buffers of the elimination
  __shared__ double sL[36];
  __shared__ double sP[36];
  __shared__ int sLen[kFactorThreads / 32];
  const int t = threadIdx.x;
  const int chain = blockIdx.x;
  const int64_t* p = pos + static_cast<long long>(chain) * max_len;
  const long long base = static_cast<long long>(chain) * max_len * 36;

  const int warp_len = warp_chain_len(p, max_len, V, t, kFactorThreads);
  if ((t & 31) == 0) sLen[t >> 5] = warp_len;
  __syncthreads();
  const int n = max(sLen[0], sLen[1]);

  // past the chain's last variable: identity and zero, as the padded gathers give
  for (long long e = static_cast<long long>(n) * 36 + t; e < static_cast<long long>(max_len) * 36;
       e += kFactorThreads) {
    const int q = static_cast<int>(e % 36);
    Cinv[base + e] = static_cast<T>(q / 6 == q % 6 ? 1 : 0);
    Lc[base + e] = static_cast<T>(0);
    P[base + e] = static_cast<T>(0);
  }

  const bool on = t < 36;
  const int row = t / 6, col = t % 6;
  const double eye = row == col ? 1.0 : 0.0;
  if (on) sC[0][t] = eye;     // Cinv_{-1} = I (L_0 is zero, so C_0 = D_0)
  long long v_next = n > 0 ? p[0] : -1;
  T d_next = static_cast<T>(eye), l_next = static_cast<T>(0);
  if (on && in_range(v_next, V)) {
    d_next = D[v_next * 36 + t];
    l_next = L[v_next * 36 + t];
  }
  __syncthreads();

  for (int i = 0; i < n; ++i) {
    const double d = static_cast<double>(d_next);
    const T l_t = l_next;
    if (i + 1 < n) {                                   // the next step's blocks, in flight now
      v_next = p[i + 1];
      d_next = static_cast<T>(eye);
      l_next = static_cast<T>(0);
      if (on && in_range(v_next, V)) {
        d_next = D[v_next * 36 + t];
        l_next = L[v_next * 36 + t];
      }
    }
    if (on) {
      sL[t] = static_cast<double>(l_t);
      Lc[base + static_cast<long long>(i) * 36 + t] = l_t;
    }
    __syncthreads();
    if (on) {                                          // P = Cinv_{i-1} L_i^T
      double s = 0.0;
#pragma unroll
      for (int m = 0; m < 6; ++m) s = fma(sC[0][row * 6 + m], sL[col * 6 + m], s);
      sP[t] = s;
      P[base + static_cast<long long>(i) * 36 + t] = static_cast<T>(s);
    }
    __syncthreads();
    if (on) {                                          // C = D_i - L_i P
      double s = 0.0;
#pragma unroll
      for (int m = 0; m < 6; ++m) s = fma(sL[row * 6 + m], sP[m * 6 + col], s);
      sC[0][t] = d - s;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 6; ++q) {                      // Gauss-Jordan, pivot (q, q)
      const double* a = sC[q & 1];
      if (on) {
        const double ip = 1.0 / a[q * 7];
        double nv;
        if (row == q && col == q) {
          nv = ip;
        } else if (row == q) {
          nv = a[t] * ip;
        } else if (col == q) {
          nv = -a[t] * ip;
        } else {
          nv = fma(-a[row * 6 + q] * ip, a[q * 6 + col], a[t]);
        }
        sC[(q + 1) & 1][t] = nv;
      }
      __syncthreads();
    }
    if (on) Cinv[base + static_cast<long long>(i) * 36 + t] = static_cast<T>(sC[0][t]);
  }
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
    tridiag_factor<float><<<n_chains, kFactorThreads, 0, s>>>(
        static_cast<const float*>(D), static_cast<const float*>(L), pos,
        static_cast<float*>(Cinv), static_cast<float*>(Lc), static_cast<float*>(P), max_len, V);
  } else {
    tridiag_factor<double><<<n_chains, kFactorThreads, 0, s>>>(
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

extern "C" const char* ltm_tridiag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
