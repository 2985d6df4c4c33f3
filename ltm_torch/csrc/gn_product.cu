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
// gn_product_plain) bit for bit.
//
// What bounds it: operations (144 a factor end and lane: 72 for J v, 72 for
// J^T y) at many lanes (the RS marginals' 6 M lanes); the 6x6 blocks' bytes
// and the latency of a row's gathers at one lane (the LM's PCG).
//
// What the design does about it (two launches, no host sync, no allocation:
// the scratch y (factors, lanes, 6) is the caller's, so a CUDA graph
// captures the two launches alone):
//   1. gn_factors: a CTA takes a tile of kTile factors of one family, stages
//      their blocks (and their ends' variables, -1 where fixed) in shared
//      memory once, then a thread a (factor, lane), lanes fastest: the
//      blocks are read from device memory once, not once a lane as the
//      broadcast matmul of the route before did, and y's rows are written
//      contiguous.
//   2. The rows, in the plan's order (highest degree first, as
//      csrc/scatter.cu), each row's list read 32 entries a load and
//      shuffled out.  From kWide lanes on, gn_rows_wide: a warp a (row, 32
//      lanes), a thread a lane with the row's six sums, each end's block
//      read warp-uniform and the lanes' y rows contiguous.  Below, gn_rows:
//      a warp a (row, tile of lanes), six threads a (lane, end) slot, one a
//      column j of J_e^T y, five slots a warp: five lanes of one end, or
//      the tile's lanes times consecutive ends (one lane: five ends at
//      once) whose products are then added in list order through shuffles;
//      kSteps ends' blocks and y rows are loaded before their products.
//      Nothing of size (lanes, ends, 6) is formed.

#include <cuda_runtime.h>
#include <stdint.h>

// The call's operands, mirrored by kernels/gn_product.py::_Args.
struct GnArgs {
  const void* J[7];              // the ends' blocks (n, 6, 6), row-major
  const int* idx[7];             // the ends' variables
  const unsigned char* fixed;    // (n_vars,) read as 0 in v
  const int* rowptr;             // the scatter plan: CSR lists of end positions
  const int* cols;
  const int* order;              // the rows, highest degree first
  const void* v;                 // (n_lanes, n_vars, 6)
  const void* lam;               // 0-d
  void* y;                       // scratch (P + B + A, n_lanes, 6)
  void* out;                     // (n_lanes, n_vars, 6)
  int n_fac[3];                  // priors, between factors, anchored factors
  int n_vars;
  int n_lanes;
  int dtype;                     // 0: float32, 1: float64
};

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;        // factors a CTA of gn_factors
constexpr int kStride = 37;      // a staged block's floats: 36 and one of padding, so the
                                 // 32 factors of a one-lane warp hit 32 banks
constexpr int kWide = 16;        // lanes from which gn_rows takes a thread a lane
constexpr int kSlots = 5;        // (lane, end) slots of six threads a warp in gn_rows
constexpr int kSteps = 4;        // ends in flight a slot in gn_rows
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// arr[k] by selects, so no parameter array is indexed at run time.
template <typename P>
__device__ __forceinline__ P pick(const P (&arr)[7], int k) {
  P p = arr[0];
#pragma unroll
  for (int s = 1; s < 7; ++s) p = k == s ? arr[s] : p;
  return p;
}

// y[f, lane, :] for a tile of factors of one family (blockIdx.x: the priors'
// tiles, then the between factors', then the anchored factors'): a thread a
// (factor, lane), lanes fastest, so a warp reads one factor's staged blocks
// (a shared-memory broadcast) and writes y rows that are contiguous.
template <typename T>
__global__ void __launch_bounds__(kThreads) gn_factors(GnArgs a) {
  __shared__ T s_blocks[4 * kTile * kStride];
  __shared__ int s_var[4 * kTile];
  const int P = a.n_fac[0], B = a.n_fac[1], A = a.n_fac[2];
  const int tiles_p = (P + kTile - 1) / kTile, tiles_b = (B + kTile - 1) / kTile;
  int fam, f0, n, k0, ends, yrow0;
  if (static_cast<int>(blockIdx.x) < tiles_p) {
    fam = 0; f0 = blockIdx.x * kTile; n = P; k0 = 0; ends = 1; yrow0 = 0;
  } else if (static_cast<int>(blockIdx.x) < tiles_p + tiles_b) {
    fam = 1; f0 = (blockIdx.x - tiles_p) * kTile; n = B; k0 = 1; ends = 2; yrow0 = P;
  } else {
    fam = 2; f0 = (blockIdx.x - tiles_p - tiles_b) * kTile; n = A; k0 = 3; ends = 4;
    yrow0 = P + B;
  }
  const int nf = min(kTile, n - f0);
  for (int q = threadIdx.x; q < ends * nf * 36; q += kThreads) {   // each end array's run
    const int ef = q / 36, c = q - ef * 36, e = ef / nf, f = ef - e * nf;
    s_blocks[(e * kTile + f) * kStride + c] =
        static_cast<const T*>(pick(a.J, k0 + e))[static_cast<long long>(f0 + f) * 36 + c];
  }
  for (int q = threadIdx.x; q < ends * nf; q += kThreads) {
    const int e = q / nf, f = q - e * nf;
    const int var = pick(a.idx, k0 + e)[f0 + f];
    s_var[e * kTile + f] = a.fixed[var] ? -1 : var;
  }
  __syncthreads();
  const int L = a.n_lanes, V = a.n_vars;
  const T* v = static_cast<const T*>(a.v);
  T* y = static_cast<T*>(a.y);
  for (int q = threadIdx.x; q < nf * L; q += kThreads) {
    const int lane = q % L, f = q / L;
    T acc[6];
    for (int e = 0; e < ends; ++e) {
      const int var = s_var[e * kTile + f];
      const T* vr = v + (static_cast<long long>(lane) * V + max(var, 0)) * 6;
      T x[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) x[k] = var < 0 ? static_cast<T>(0) : vr[k];
      const T* jb = s_blocks + (e * kTile + f) * kStride;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        T t = mul_rn(jb[i * 6], x[0]);
#pragma unroll
        for (int k = 1; k < 6; ++k) t = add_rn(t, mul_rn(jb[i * 6 + k], x[k]));
        acc[i] = e == 0 ? (fam == 2 ? add_rn(static_cast<T>(0), t) : t) : add_rn(acc[i], t);
      }
    }
    T* yr = y + (static_cast<long long>(yrow0 + f0 + f) * L + lane) * 6;
#pragma unroll
    for (int i = 0; i < 6; ++i) yr[i] = acc[i];
  }
}

// End e (a position in the ends' order): its block, and its factor's row
// of y.
template <typename T>
__device__ __forceinline__ const T* end_block(const GnArgs& a, int e, int& yrow) {
  const int P = a.n_fac[0], B = a.n_fac[1], A = a.n_fac[2];
  int k, local;
  if (e < P) {
    k = 0;
    local = e;
    yrow = e;
  } else if (e < P + 2 * B) {
    const int r = e - P, second = r >= B;
    k = 1 + second;
    local = r - second * B;
    yrow = P + local;
  } else {
    const int r = e - P - 2 * B, q = (r >= A) + (r >= 2 * A) + (r >= 3 * A);
    k = 3 + q;
    local = r - q * A;
    yrow = P + B + local;
  }
  return static_cast<const T*>(pick(a.J, k)) + static_cast<long long>(local) * 36;
}

// out rows, below kWide lanes: warp w takes row order[w / n_tiles], lanes
// (w % n_tiles) * tile on.  `tile` lanes times `group` consecutive ends fill
// the slots (tile * group <= kSlots).
template <typename T>
__global__ void __launch_bounds__(kThreads) gn_rows(GnArgs a, int tile, int group) {
  const long long item = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int L = a.n_lanes, V = a.n_vars;
  const int n_tiles = (L + tile - 1) / tile;
  if (item >= static_cast<long long>(V) * n_tiles) return;   // uniform across the warp
  const int lid = threadIdx.x & 31;
  const int row = a.order[item / n_tiles];
  const int slot = lid / 6, j = lid - 6 * slot;
  const int t = slot % tile, g = slot / tile;            // the slot's lane in the tile, its end
  const int lane = static_cast<int>(item % n_tiles) * tile + t;
  const bool works = slot < tile * group && lane < L;
  const T* y = static_cast<const T*>(a.y);
  const int j0 = a.rowptr[row], j1 = a.rowptr[row + 1];
  T acc = static_cast<T>(0);
  for (int c0 = j0; c0 < j1; c0 += 32) {
    const int n = min(32, j1 - c0);
    const int col = lid < n ? a.cols[c0 + lid] : 0;
    for (int s0 = 0; s0 < n; s0 += kSteps * group) {
      T jc[kSteps][6], yv[kSteps][6];
#pragma unroll
      for (int q = 0; q < kSteps; ++q) {
        const int m = s0 + q * group + g;                  // this slot's entry of the list
        const int e = __shfl_sync(kFull, col, m & 31);
        if (works && m < n) {
          int yrow;
          const T* jb = end_block<T>(a, e, yrow) + j;
          const T* yr = y + (static_cast<long long>(yrow) * L + lane) * 6;
#pragma unroll
          for (int i = 0; i < 6; ++i) {
            jc[q][i] = jb[i * 6];
            yv[q][i] = yr[i];
          }
        } else {
#pragma unroll
          for (int i = 0; i < 6; ++i) jc[q][i] = yv[q][i] = static_cast<T>(0);
        }
      }
#pragma unroll
      for (int q = 0; q < kSteps; ++q) {
        T c = mul_rn(jc[q][0], yv[q][0]);
#pragma unroll
        for (int i = 1; i < 6; ++i) c = add_rn(c, mul_rn(jc[q][i], yv[q][i]));
        for (int gg = 0; gg < group; ++gg) {              // the slot's lane's ends, in order
          const T x = __shfl_sync(kFull, c, ((gg * tile + t) * 6 + j) & 31);
          if (s0 + q * group + gg < n) acc = add_rn(acc, x);
        }
      }
    }
  }
  if (slot < tile && lane < L) {                           // g == 0: the lane's sum
    const long long o = (static_cast<long long>(lane) * V + row) * 6 + j;
    T* out = static_cast<T*>(a.out);
    out[o] = add_rn(acc, mul_rn(*static_cast<const T*>(a.lam), static_cast<const T*>(a.v)[o]));
  }
}

// out rows, at kWide lanes or more: a warp a (row, 32 lanes), a thread a
// lane with the row's six sums; each end's block is read warp-uniform and
// the lanes' y rows are contiguous.
template <typename T>
__global__ void __launch_bounds__(kThreads) gn_rows_wide(GnArgs a) {
  const long long item = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int L = a.n_lanes, V = a.n_vars;
  const int n_tiles = (L + 31) / 32;
  if (item >= static_cast<long long>(V) * n_tiles) return;   // uniform across the warp
  const int lid = threadIdx.x & 31;
  const int row = a.order[item / n_tiles];
  const int lane = static_cast<int>(item % n_tiles) * 32 + lid;
  const bool on = lane < L;
  const T* y = static_cast<const T*>(a.y);
  const int j0 = a.rowptr[row], j1 = a.rowptr[row + 1];
  T acc[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) acc[j] = static_cast<T>(0);
  for (int c0 = j0; c0 < j1; c0 += 32) {
    const int n = min(32, j1 - c0);
    const int col = lid < n ? a.cols[c0 + lid] : 0;
#pragma unroll 2
    for (int m = 0; m < n; ++m) {
      const int e = __shfl_sync(kFull, col, m);
      int yrow;
      const T* jb = end_block<T>(a, e, yrow);
      const T* yr = y + (static_cast<long long>(yrow) * L + (on ? lane : 0)) * 6;
      T yv[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) yv[i] = yr[i];
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        T c = mul_rn(jb[j], yv[0]);
#pragma unroll
        for (int i = 1; i < 6; ++i) c = add_rn(c, mul_rn(jb[i * 6 + j], yv[i]));
        acc[j] = add_rn(acc[j], c);
      }
    }
  }
  if (on) {
    const long long o = (static_cast<long long>(lane) * V + row) * 6;
    const T lam = *static_cast<const T*>(a.lam);
    const T* v = static_cast<const T*>(a.v) + o;
    T* out = static_cast<T*>(a.out) + o;
#pragma unroll
    for (int j = 0; j < 6; ++j) out[j] = add_rn(acc[j], mul_rn(lam, v[j]));
  }
}

template <typename T>
cudaError_t launch(const GnArgs& a, cudaStream_t s) {
  const int tiles = (a.n_fac[0] + kTile - 1) / kTile + (a.n_fac[1] + kTile - 1) / kTile +
                    (a.n_fac[2] + kTile - 1) / kTile;
  if (tiles > 0) gn_factors<T><<<tiles, kThreads, 0, s>>>(a);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  const bool wide = a.n_lanes >= kWide;
  const int tile = wide ? 32 : a.n_lanes >= kSlots ? kSlots : a.n_lanes;
  const long long warps = static_cast<long long>(a.n_vars) * ((a.n_lanes + tile - 1) / tile);
  const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (wide) {
    gn_rows_wide<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a);
  } else {
    gn_rows<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a, tile, kSlots / tile);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int ltm_gn_args_size() { return static_cast<int>(sizeof(GnArgs)); }

// Launches both passes on `stream` on CUDA device `device` (the calling
// thread's current device is restored).  Returns a cudaError_t.
extern "C" int ltm_gn_product(const GnArgs* args, int device, void* stream) {
  const GnArgs& a = *args;
  if (a.n_fac[0] < 0 || a.n_fac[1] < 0 || a.n_fac[2] < 0 || a.n_vars < 0 || a.n_lanes < 0 ||
      (a.dtype != 0 && a.dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
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
