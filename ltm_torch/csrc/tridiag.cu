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
// written directly (identity Cinv, zero Lc) without running the recurrence,
// so a chain of one variable costs one step, not max_len.
//
// tridiag_factor.  For each chain, in order: C_0 = D_0,
// C_i = D_i - L_i (Cinv_{i-1} L_i^T) (ltm's product order), Cinv_i = C_i^-1;
// writes Cinv and Lc (the gathered L, its bits unchanged), chain-major
// (n_chains, max_len, 6, 6).  One CTA of 64 threads a chain; thread
// t < 36 holds entry (t / 6, t % 6) of each block.  The products read the
// running Cinv and L_i from shared memory; D_{i+1}, L_{i+1} and pos[i+1] are
// loaded into registers while step i computes, since they do not depend on
// the recurrence.
//   The inverse is an in-place Gauss-Jordan with the pivots on the diagonal
// (six steps, ping-pong buffers, one barrier each), not jnp.linalg.inv's LU
// with partial pivoting: C is SPD by construction (_precond_blocks'
// docstring; a fixed variable's block is the identity), so every diagonal
// pivot is a positive Schur complement and elimination without row
// exchange is backward stable for it, as Cholesky is; it needs no
// data-dependent row exchange, no square roots and no triangular passes.
//
// tridiag_apply.  For each lane of r (..., V, 6) (one for LM, 6 M for the
// marginals) and each chain: forward y_i = r_i - L_i u_{i-1},
// u_i = Cinv_i y_i, then back substitution
// x_i = Cinv_i (y_i - L_{i+1}^T x_{i+1}); r is read and x written through pos
// in variable order (every variable lies in exactly one chain, so every row
// of x is written once and x needs no initial fill).  y lives in the output
// buffer x between the two passes (rounded to the output type), read back by
// the thread that wrote it.  One warp a (lane, chain): the carried 6-vector
// sits in lanes 0-5, lane k holding row k of Cinv_i and L_i (column k of
// L_{i+1} in the back pass); each 6x6 mat-vec is six broadcast shuffles and
// six FMAs.  A step's blocks, its entry of r (or y) and pos[i + 2] are
// loaded two steps ahead into one of two register slots that are used in
// turn and never copied: the first design loaded one step ahead through a
// copied buffer, and its step waited on two L2 round trips (pos[i + 1], then
// r through it), 0.77 us a dependent step on phase 8's graph (PERF.md).
//
// Arithmetic.  Both kernels compute in double for float32 and float64
// inputs and round once at each store: the chains are ~500 steps long and
// the work is latency-bound, so double costs little, and the float32 results
// stay within the plain float32 route's own error of the float64 plain
// version (the rule chip_smoke.py and tests/test_torch_card.py hold them
// to).  Every sum runs in a fixed order with no atomics, so a launch repeats
// bit for bit, in or out of a CUDA graph.
//
// What bounds them: not bytes or flops (a factor needs three 6x6 blocks and
// does ~1.3 kflop a variable, 0.44 MB on phase 8's 1 026 variables, though
// it writes ~4 MB there with the chain-major padding of today's return
// contract; an apply ~0.3 kflop a variable a lane) but each chain's
// dependent steps: the factor is max_len dependent steps of two 6x6
// products and a 6x6 inverse (nine barriers each), the apply 2 max_len
// dependent pairs of 6x6 mat-vecs.  What the design does about it: a chain's
// whole recurrence in one CTA (factor) or warp (apply) with its state on
// chip, its next steps' loads in flight during the current one, chains (and
// lanes) side by side in one launch, and no step run past a chain's end.
// The wrapper's host work is its checks, the output allocation and one C
// call, which launches on the caller's stream with no allocation and no
// sync, so the apply can be captured in the PCG's CUDA graph.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFactorThreads = 64;   // two warps a chain, 36 of them hold an entry
constexpr int kApplyThreads = 128;   // four (lane, chain) warps a CTA
constexpr unsigned kFull = 0xffffffffu;

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
               T* __restrict__ Cinv, T* __restrict__ Lc, int max_len, int V) {
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

// sum_j m[j] * (lane j's w), j in order
template <typename T>
__device__ __forceinline__ double matvec_row(const T (&m)[6], double w) {
  double s = 0.0;
#pragma unroll
  for (int j = 0; j < 6; ++j) s = fma(static_cast<double>(m[j]), __shfl_sync(kFull, w, j), s);
  return s;
}

// One step of the solve's prefetch ring, as lane k (< 6) holds it: row k of
// two 6x6 blocks, one entry of a right-hand side, the step's variable, and
// the variable of the step two further on (the slot's next step).
template <typename T>
struct Slot {
  T a[6], b[6], rhs;
  long long v, v2;
};

// The warp's view of one (lane, chain): its pos row, blocks and vectors.
template <typename T>
struct Chain {
  const int64_t* p;
  const T* cb;   // Cinv, chain-major
  const T* lb;   // Lc, chain-major
  const T* rl;   // r of the lane
  T* xl;         // x of the lane
  int n, V, k;
  bool on;       // lanes 0-5 carry the vector
};

// Forward step i into slot s: row k of L_i and of Cinv_i, r at pos[i] (read
// two steps ago into s.v2), and pos[i + 2].
template <typename T>
__device__ __forceinline__ void fetch_forward(Slot<T>& s, int i, const Chain<T>& c) {
  s.v = s.v2;
  s.v2 = i + 2 < c.n ? c.p[i + 2] : -1;
  if (i >= c.n) return;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    s.a[j] = c.on ? c.lb[i * 36LL + c.k * 6 + j] : T(0);
    s.b[j] = c.on ? c.cb[i * 36LL + c.k * 6 + j] : T(0);
  }
  s.rhs = c.on && in_range(s.v, c.V) ? c.rl[s.v * 6 + c.k] : T(0);
}

// Back step i into slot s: column k of L_{i+1} (zero at the chain's last
// step), row k of Cinv_i, y_i from x at pos[i], and pos[i - 2].
template <typename T>
__device__ __forceinline__ void fetch_back(Slot<T>& s, int i, const Chain<T>& c) {
  s.v = s.v2;
  s.v2 = i >= 2 ? c.p[i - 2] : -1;
  if (i < 0) return;
  const bool next = c.on && i + 1 < c.n;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    s.a[j] = next ? c.lb[(i + 1) * 36LL + j * 6 + c.k] : T(0);
    s.b[j] = c.on ? c.cb[i * 36LL + c.k * 6 + j] : T(0);
  }
  s.rhs = c.on && in_range(s.v, c.V) ? c.xl[s.v * 6 + c.k] : T(0);
}

// y = rhs - A w, then w = B y; the output at the step's variable gets
// `keep_y ? y : w`.  Returns w.
template <typename T>
__device__ __forceinline__ double step(const Slot<T>& s, double w, bool keep_y, const Chain<T>& c) {
  const double y = static_cast<double>(s.rhs) - matvec_row(s.a, w);
  const double out = matvec_row(s.b, y);
  if (c.on && in_range(s.v, c.V)) c.xl[s.v * 6 + c.k] = static_cast<T>(keep_y ? y : out);
  return out;
}

// Warp w takes chain w / n_lanes and lane w % n_lanes: the warps of a CTA
// read one chain's blocks.
template <typename T>
__global__ void __launch_bounds__(kApplyThreads)
tridiag_apply(const T* __restrict__ Cinv, const T* __restrict__ Lc,
              const int64_t* __restrict__ pos, const T* __restrict__ r, T* __restrict__ x,
              int n_lanes, int n_chains, int max_len, int V) {
  const long long w = (static_cast<long long>(blockIdx.x) * kApplyThreads + threadIdx.x) >> 5;
  if (w >= static_cast<long long>(n_lanes) * n_chains) return;   // uniform across the warp
  const int k = threadIdx.x & 31;
  const int chain = static_cast<int>(w / n_lanes);
  const int lane = static_cast<int>(w % n_lanes);
  Chain<T> c;
  c.p = pos + static_cast<long long>(chain) * max_len;
  c.n = warp_chain_len(c.p, max_len, V, k, 32);
  if (c.n == 0) return;
  c.cb = Cinv + static_cast<long long>(chain) * max_len * 36;
  c.lb = Lc + static_cast<long long>(chain) * max_len * 36;
  c.rl = r + static_cast<long long>(lane) * V * 6;
  c.xl = x + static_cast<long long>(lane) * V * 6;
  c.V = V;
  c.k = k;
  c.on = k < 6;

  // Two slots, filled two steps ahead of their use and never copied, so a
  // step's loads have two steps' time to land (a copy would wait for them).
  Slot<T> s0, s1;
  // forward: y_i = r_i - L_i u_{i-1}, u_i = Cinv_i y_i (y kept in x)
  s0.v2 = c.p[0];
  s1.v2 = c.n > 1 ? c.p[1] : -1;
  fetch_forward(s0, 0, c);
  fetch_forward(s1, 1, c);
  double u = 0.0;
  for (int i = 0; i < c.n; i += 2) {
    u = step(s0, u, true, c);
    fetch_forward(s0, i + 2, c);
    if (i + 1 < c.n) {
      u = step(s1, u, true, c);
      fetch_forward(s1, i + 3, c);
    }
  }
  // back: x_i = Cinv_i (y_i - L_{i+1}^T x_{i+1}), x_n = 0
  s0.v2 = c.p[c.n - 1];
  s1.v2 = c.n > 1 ? c.p[c.n - 2] : -1;
  fetch_back(s0, c.n - 1, c);
  fetch_back(s1, c.n - 2, c);
  double xn = 0.0;
  for (int i = c.n - 1; i >= 0; i -= 2) {
    xn = step(s0, xn, false, c);
    fetch_back(s0, i - 2, c);
    if (i >= 1) {
      xn = step(s1, xn, false, c);
      fetch_back(s1, i - 3, c);
    }
  }
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

}  // namespace

// dtype 0: float32, 1: float64.  D, L (V, 6, 6); pos (n_chains, max_len)
// int64; Cinv, Lc (n_chains, max_len, 6, 6).  Launches on `stream` on CUDA
// device `device` (the calling thread's current device is restored).
// Returns a cudaError_t.
extern "C" int ltm_tridiag_factor(const void* D, const void* L, const int64_t* pos, void* Cinv,
                                  void* Lc, int dtype, int n_chains, int max_len, int V,
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
        static_cast<float*>(Cinv), static_cast<float*>(Lc), max_len, V);
  } else {
    tridiag_factor<double><<<n_chains, kFactorThreads, 0, s>>>(
        static_cast<const double*>(D), static_cast<const double*>(L), pos,
        static_cast<double*>(Cinv), static_cast<double*>(Lc), max_len, V);
  }
  return static_cast<int>(cudaGetLastError());
}

// r, x (n_lanes, V, 6); Cinv, Lc, pos as tridiag_factor writes and reads
// them.  Every variable must lie in exactly one chain.
extern "C" int ltm_tridiag_apply(const void* Cinv, const void* Lc, const int64_t* pos,
                                 const void* r, void* x, int dtype, int n_lanes, int n_chains,
                                 int max_len, int V, int device, void* stream) {
  if (n_lanes < 0 || n_chains < 0 || max_len < 0 || V < 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long warps = static_cast<long long>(n_lanes) * n_chains;
  if (warps == 0 || max_len == 0) return 0;
  const long long blocks = (warps * 32 + kApplyThreads - 1) / kApplyThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  DeviceScope scope(device);
  if (scope.rc != cudaSuccess) return static_cast<int>(scope.rc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    tridiag_apply<float><<<static_cast<unsigned>(blocks), kApplyThreads, 0, s>>>(
        static_cast<const float*>(Cinv), static_cast<const float*>(Lc), pos,
        static_cast<const float*>(r), static_cast<float*>(x), n_lanes, n_chains, max_len, V);
  } else {
    tridiag_apply<double><<<static_cast<unsigned>(blocks), kApplyThreads, 0, s>>>(
        static_cast<const double*>(Cinv), static_cast<const double*>(Lc), pos,
        static_cast<const double*>(r), static_cast<double*>(x), n_lanes, n_chains, max_len, V);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ltm_tridiag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
