// The ICP correspondence search (K5b): for each lane and query, the nearest
// valid target, its index and its exact squared distance.  CUDA C++ for
// Hopper (sm_90a).
//
// Replaces the XLA-lowered ltm/kernels/knn.py:177::nn_sqdist_argmin (a scan
// of target tiles, a (N, tile) matmul distance block each, and a running
// argmin), which the port's plain version
// (ltm_torch/kernels/knn.py::nn_sqdist_argmin_plain) runs as a baddbmm that
// writes a (lanes, N, tile) float32 block per target tile and reads it back
// for min.  This kernel keeps every distance in registers, and takes in the
// plain version's centring (knn.py::_nn_centred) and re-score
// (knn.py::_nn_rescore) too: a call is nn_pack, nn_scan and, when the
// targets split, nn_merge, where the first design also ran some twenty
// small torch ops.
//
// What it computes, and its rounding.  Every rounding of the plain
// version's torch ops is spelled with a _rn intrinsic, so nvcc can neither
// contract nor split it:
//   mid  = 0.5 * (lo + hi) of the lane's valid targets' bounding box (0 on
//          an axis without one), from the pack pass's tile boxes (min and
//          max are exact in any order);
//   q_c  = q - mid, t_c = t - mid;  q2 = |q_c|^2, t2 = |t_c|^2 (1e30 at an
//          invalid target, +inf past m), each sum of three squares in
//          torch's CUDA order, (x^2 + z^2) + y^2 (its reduction kernel
//          gives a last axis of three to two threads: elements 0 and 2,
//          then 1; probed on the card);
//   d    = fma(-2, dot, q2 + t2), dot = fma(qz, tz, fma(qy, ty, qx * tx)),
//          ltm's matmul form rounded once after 2 * dot (exact); selected
//          on max(d, 0);
//   the pick re-scored as (q - t)^2 on the original coordinates, the same
//          order; 1e30 where nothing beat 1e30 and at an invalid query.
// The plain version on the card differs only where cuBLAS takes the K = 3
// dot product in another order; its indices are then equal except at
// near-ties, and where the indices agree the distances are bit-equal.
//
// Selection.  The pick is the least (max(d, 0), index) in lexicographic
// order from (1e30, 0): the lowest index among equal values, as the plain
// version's per-tile min and its strict < across tiles give, whatever the
// order in which the targets are visited.  An invalid target has t2 = 1e30,
// so its d is 1e30 (the query terms vanish below its ulp) and never passes
// (1e30, 0): a lane with no valid target returns index 0 and 1e30.
// Invalid queries are computed as the plain version computes them (ICP
// gathers their index, at weight 0).  A query's running best b is kept as
// the selected value, so b >= 0 and the cheap test d <= b is the same as
// max(d, 0) <= b; the lexicographic update runs only behind it.
//
// What bounds it: operations on the pairs it scores (8 FP32 flops a pair,
// an FMA counted as two; a pair takes 6 issue slots: FMUL, 3 FFMA, FADD,
// FSETP), and the first design scored every pair in index order, where the
// farm's spatially sorted targets improve a running best again and again
// and a warp takes the update branch whenever one of its threads needs it.
// What the design does about it:
//   1. Nearest tile first.  The pack pass writes each tile's box over its
//      valid targets.  A warp holds 128 consecutive queries (kR a thread),
//      orders its split's tiles by the gap between the tile's box and its
//      queries' box (the index on ties; a rank sort in shared memory) and
//      scores them in that order, so its bests are near-final after a tile
//      or two and the update branch becomes rare.
//   2. An exact cull.  Before a tile, each thread tests its queries: the
//      squared gap g2 from the centred query to the tile's centred box (the
//      box's corners centred: rounding is monotone, so every centred target
//      of the tile lies inside it) bounds |q_c - t_c|^2 from below, and the
//      selected value from below less its rounding,
//          |fl(d) - |q_c - t_c|^2| <= gamma_5 (q2 + t2 + 2 sum|q_i t_i|)
//                                  <= gamma_5 (|q_c|_1 + |t_c|_1)^2,
//      gamma_5 = 5u / (1 - 5u), u = 2^-24 (three roundings in each of q2,
//      t2 and dot, one in q2 + t2, one in d; Higham, ch. 3).  The kernel
//      takes kGamma = 2^-21 > gamma_5, bounds |t_c|_1 by the box's corners,
//      and computes g2 rounded down and the slack rounded up, so
//          g2 - kGamma (|q_c|_1 + R_tile)^2 > b
//      proves that no target of the tile reaches b: the tile cannot change
//      the query's pick.  The warp skips the tile when every one of its
//      queries proves it (__all_sync), and the result is the unculled
//      one's, bit for bit.  (K4's cull, csrc/chunk_knn.cu, is the
//      precedent.)
//   3. Per-warp tiles: a warp stages each tile it scores into its own
//      shared-memory slot, centring it and forming t2 on the way (eight
//      targets a thread), kR = 4 queries a thread in registers, each
//      target read from shared memory (a broadcast LDS.128) serving kR
//      pairs, a group of kGroup = 2 targets tested with one branch.
//   4. Target splits when the queries alone would not fill the card (the
//      wrapper's _plan): CTA (x, s) scans the s-th contiguous chunk of at
//      most kMaxTiles tiles.  The splits of a query block share their
//      picks through device memory (a 64-bit key a query, atomicMin), so a
//      split culls against the best any split has found, not only its
//      own; nn_merge re-scores the final keys.  A split that kept its own
//      picks scored its chunk's nearest tiles whatever the others held:
//      on the farm's point order, 0.84 ms at 8 splits against 0.60 ms at
//      one (an H100, PERF.md).
//   5. Lanes are independent: a CTA reads one lane's queries and targets,
//      and nothing of a lane's result depends on the other lanes of the
//      batch (the farm repacks lanes every segment).
// With `counts`, the scan adds its work to counts[0..3]: tiles a warp
// considered, scored and culled, and update branches a warp took.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;              // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kR = 4;                      // queries a thread
constexpr int kTile = 256;                 // targets a tile
constexpr int kPer = kTile / 32;           // targets a thread stages
constexpr int kMaxTiles = 256;             // tiles a split
constexpr int kGroup = 2;                  // targets a thread scores between two tests
constexpr float kBig = 1e30f;
constexpr float kGamma = 4.76837158203125e-07f;   // 2^-21
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// torch's CUDA sum of a last axis of three, each square rounded
__device__ __forceinline__ float sumsq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(z, z)), __fmul_rn(y, y));
}

__device__ __forceinline__ float select_d(float qx, float qy, float qz, float q2, float4 p) {
  const float dot = __fmaf_rn(qz, p.z, __fmaf_rn(qy, p.y, __fmul_rn(qx, p.x)));
  return __fmaf_rn(-2.f, dot, __fadd_rn(q2, p.w));
}

// A pick (selected value >= 0, index) as a 64-bit key whose unsigned order
// is the lexicographic order of the pair.
__device__ __forceinline__ unsigned long long pick_key(float d, int idx) {
  return (static_cast<unsigned long long>(__float_as_uint(d)) << 32) | static_cast<unsigned>(idx);
}

// t (B, m, 3), tmask (B, m) -> t4 (B, tiles * kTile): (x, y, z, tag) on the
// original coordinates, tag 0 at a valid target, 1e30 at an invalid one,
// +inf past m (coordinates 0); boxes (B, tiles, 6): lo xyz, hi xyz of the
// tile's valid targets (+inf, -inf without one).  A warp a tile.  With
// `keys`, also sets each of its `rows` entries to the pick (1e30, 0).
__global__ void nn_pack(const float* __restrict__ t, const unsigned char* __restrict__ tmask,
                        int lanes, int m, int tiles, float4* __restrict__ t4,
                        float* __restrict__ boxes, unsigned long long* __restrict__ keys,
                        long long rows) {
  const int l = threadIdx.x & 31;
  if (keys != nullptr) {   // the splits' shared picks start at (1e30, 0)
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < rows;
         i += static_cast<long long>(gridDim.x) * blockDim.x) {
      keys[i] = pick_key(kBig, 0);
    }
  }
  const long long total = static_cast<long long>(lanes) * tiles;
  const long long stride = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  for (long long wi = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       wi < total; wi += stride) {
    const long long b = wi / tiles;
    const int tile = static_cast<int>(wi - b * tiles);
    float lo[3] = {pos_inf(), pos_inf(), pos_inf()}, hi[3] = {-pos_inf(), -pos_inf(), -pos_inf()};
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int j = tile * kTile + u * 32 + l;
      float4 v = make_float4(0.f, 0.f, 0.f, pos_inf());
      if (j < m) {
        const long long k = b * m + j;
        const float c[3] = {t[3 * k], t[3 * k + 1], t[3 * k + 2]};
        const bool ok = tmask[k] != 0;
        v = make_float4(c[0], c[1], c[2], ok ? 0.f : kBig);
        if (ok) {
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            lo[a] = fminf(lo[a], c[a]);
            hi[a] = fmaxf(hi[a], c[a]);
          }
        }
      }
      t4[b * tiles * kTile + j] = v;
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      for (int o = 16; o > 0; o >>= 1) {
        lo[a] = fminf(lo[a], __shfl_xor_sync(kFull, lo[a], o));
        hi[a] = fmaxf(hi[a], __shfl_xor_sync(kFull, hi[a], o));
      }
    }
    if (l < 6) boxes[wi * 6 + l] = l < 3 ? lo[l] : hi[l - 3];
  }
}

// A proof that no target in the centred box b (lo xyz, hi xyz, R = a bound
// on |t_c|_1) reaches `best` for the centred query q with |q_c|_1 <= an.
__device__ __forceinline__ bool prunable(float qx, float qy, float qz, float an,
                                         const float* b, float best) {
  const float gx = fmaxf(0.f, fmaxf(__fsub_rd(b[0], qx), __fsub_rd(qx, b[3])));
  const float gy = fmaxf(0.f, fmaxf(__fsub_rd(b[1], qy), __fsub_rd(qy, b[4])));
  const float gz = fmaxf(0.f, fmaxf(__fsub_rd(b[2], qz), __fsub_rd(qz, b[5])));
  const float g2 = __fadd_rd(__fadd_rd(__fmul_rd(gx, gx), __fmul_rd(gy, gy)), __fmul_rd(gz, gz));
  const float s = __fadd_ru(an, b[6]);
  return __fsub_rd(g2, __fmul_ru(kGamma, __fmul_ru(s, s))) > best;
}

// The plain version's re-score of row qi (lane `lane`): (q - t)^2 at the
// pick, 1e30 where nothing beat 1e30 and at an invalid query.
__device__ __forceinline__ void rescore(const float* __restrict__ q,
                                        const unsigned char* __restrict__ qmask,
                                        const float* __restrict__ t, long long qi, long long lane,
                                        int m, float best, int idx, float* __restrict__ out_d,
                                        long long* __restrict__ out_i) {
  const float* tp = t + (lane * m + min(idx, m - 1)) * 3;
  const float* qp = q + qi * 3;
  const float e = sumsq3(__fsub_rn(qp[0], tp[0]), __fsub_rn(qp[1], tp[1]),
                         __fsub_rn(qp[2], tp[2]));
  out_d[qi] = qmask[qi] != 0 && best < kBig ? e : kBig;
  out_i[qi] = idx;
}

// q (B, n, 3), qmask (B, n); t4, boxes from nn_pack (tiles a lane), t the
// original targets.  blockIdx.x = lane * q_blocks + query block, blockIdx.y
// = split s over tiles [s * chunk_tiles, (s + 1) * chunk_tiles).  Writes
// the re-scored (d, index) to out_d/out_i when keys is null (one split);
// else the splits share each query's pick in keys[lane * n + i]
// (pick_key): a CTA about to score a tile first adopts the shared pick
// where it is less than its own, and tests the cull again, and after each
// tile it scored it publishes its picks with atomicMin.  Every pick it
// holds is some target's, so the cull stays exact, and the last value of a
// key is the least pick over all targets, whatever the order the CTAs ran.
template <bool kCount>
__global__ void __launch_bounds__(kThreads, 7)
nn_scan(const float* __restrict__ q, const unsigned char* __restrict__ qmask, int n, int q_blocks,
        const float* __restrict__ t, const float4* __restrict__ t4,
        const float* __restrict__ boxes, int m, int tiles, int chunk_tiles,
        unsigned long long* __restrict__ keys, float* __restrict__ out_d,
        long long* __restrict__ out_i, unsigned long long* __restrict__ counts) {
  __shared__ __align__(16) float4 s_tile[kWarps][kTile];
  __shared__ float s_box[kMaxTiles][7];
  __shared__ float s_key[kWarps][kMaxTiles];
  __shared__ unsigned short s_order[kWarps][kMaxTiles];
  __shared__ float s_red[kWarps][6];
  __shared__ float s_mid[3];
  const int lane = blockIdx.x / q_blocks;
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const float* bl = boxes + static_cast<long long>(lane) * tiles * 6;

  // the lane's box over all its tiles, then its midpoint (torch's rule)
  float lo[3] = {pos_inf(), pos_inf(), pos_inf()}, hi[3] = {-pos_inf(), -pos_inf(), -pos_inf()};
  for (int k = threadIdx.x; k < tiles; k += kThreads) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], bl[k * 6 + a]);
      hi[a] = fmaxf(hi[a], bl[k * 6 + 3 + a]);
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    for (int o = 16; o > 0; o >>= 1) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(kFull, lo[a], o));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(kFull, hi[a], o));
    }
  }
  if (l < 6) s_red[w][l] = l < 3 ? lo[l] : hi[l - 3];
  __syncthreads();
  if (threadIdx.x < 3) {
    const int a = threadIdx.x;
    float x = s_red[0][a], y = s_red[0][3 + a];
    for (int i = 1; i < kWarps; ++i) {
      x = fminf(x, s_red[i][a]);
      y = fmaxf(y, s_red[i][3 + a]);
    }
    s_mid[a] = isfinite(x) ? __fmul_rn(0.5f, __fadd_rn(x, y)) : 0.f;
  }
  __syncthreads();
  const float mx = s_mid[0], my = s_mid[1], mz = s_mid[2];

  // this split's tile boxes, centred (an empty tile: a box no query reaches)
  const int first_tile = blockIdx.y * chunk_tiles;
  const int count = min(chunk_tiles, tiles - first_tile);
  for (int k = threadIdx.x; k < count; k += kThreads) {
    const float* b = bl + (first_tile + k) * 6;
    float* s = s_box[k];
    if (b[0] > b[3]) {
      for (int a = 0; a < 6; ++a) s[a] = pos_inf();
      s[6] = 0.f;
    } else {
      const float mid[3] = {mx, my, mz};
      float r = 0.f;
      for (int a = 0; a < 3; ++a) {
        s[a] = __fsub_rn(b[a], mid[a]);
        s[3 + a] = __fsub_rn(b[3 + a], mid[a]);
        r = __fadd_ru(r, fmaxf(fabsf(s[a]), fabsf(s[3 + a])));
      }
      s[6] = r;
    }
  }
  __syncthreads();

  // the warp's queries: 128 consecutive, kR a thread, centred
  const int q0 = (blockIdx.x - lane * q_blocks) * (kR * kThreads) + w * (kR * 32);
  const float* ql = q + static_cast<long long>(lane) * n * 3;
  float qx[kR], qy[kR], qz[kR], qq[kR], an[kR], bd[kR];
  int bi[kR];
  float qlo[3] = {pos_inf(), pos_inf(), pos_inf()}, qhi[3] = {-pos_inf(), -pos_inf(), -pos_inf()};
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = q0 + r * 32 + l;
    qx[r] = qy[r] = qz[r] = qq[r] = an[r] = 0.f;
    bd[r] = -pos_inf();   // an empty slot: never updates, never keeps a tile
    bi[r] = 0;
    if (i < n) {
      qx[r] = __fsub_rn(ql[3 * i], mx);
      qy[r] = __fsub_rn(ql[3 * i + 1], my);
      qz[r] = __fsub_rn(ql[3 * i + 2], mz);
      qq[r] = sumsq3(qx[r], qy[r], qz[r]);
      an[r] = __fadd_ru(__fadd_ru(fabsf(qx[r]), fabsf(qy[r])), fabsf(qz[r]));
      bd[r] = kBig;
      const float c[3] = {qx[r], qy[r], qz[r]};
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        qlo[a] = fminf(qlo[a], c[a]);
        qhi[a] = fmaxf(qhi[a], c[a]);
      }
    }
  }
  if (q0 >= n) return;   // a warp without queries (no barrier follows)
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    for (int o = 16; o > 0; o >>= 1) {
      qlo[a] = fminf(qlo[a], __shfl_xor_sync(kFull, qlo[a], o));
      qhi[a] = fmaxf(qhi[a], __shfl_xor_sync(kFull, qhi[a], o));
    }
  }

  // the visit order: by the gap between the tile's box and the queries' box
  float* key = s_key[w];
  unsigned short* order = s_order[w];
  for (int k = l; k < count; k += 32) {
    const float* b = s_box[k];
    float g2 = 0.f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float g = fmaxf(0.f, fmaxf(b[a] - qhi[a], qlo[a] - b[3 + a]));
      g2 += g * g;
    }
    key[k] = g2;   // +inf for an empty tile
  }
  __syncwarp();
  for (int k = l; k < count; k += 32) {
    const float kk = key[k];
    int rank = 0;
    for (int k2 = 0; k2 < count; ++k2) {
      const float o = key[k2];
      rank += o < kk || (o == kk && k2 < k);
    }
    order[rank] = static_cast<unsigned short>(k);
  }
  __syncwarp();

  float4* tile = s_tile[w];
  const float4* tl = t4 + static_cast<long long>(lane) * tiles * kTile;
  unsigned long long scored = 0, culled = 0, branches = 0;
  const long long row0 = static_cast<long long>(lane) * n + q0 + l;   // slot r: + r * 32
  for (int o = 0; o < count; ++o) {
    const int k = order[o];
    bool skip = true;
#pragma unroll
    for (int r = 0; r < kR; ++r) skip &= prunable(qx[r], qy[r], qz[r], an[r], s_box[k], bd[r]);
    if (!__all_sync(kFull, skip) && keys != nullptr) {   // the other splits' picks, then again
      skip = true;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (q0 + r * 32 + l < n) {
          const unsigned long long shared = __ldcg(keys + row0 + r * 32);
          if (shared < pick_key(bd[r], bi[r])) {
            bd[r] = __uint_as_float(static_cast<unsigned>(shared >> 32));
            bi[r] = static_cast<int>(shared & 0xffffffffu);
          }
        }
        skip &= prunable(qx[r], qy[r], qz[r], an[r], s_box[k], bd[r]);
      }
    }
    if (__all_sync(kFull, skip)) {
      ++culled;
      continue;
    }
    ++scored;
    const int j_tile = (first_tile + k) * kTile;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {   // centre, and t2 (the tag where not valid)
      const float4 v = tl[j_tile + u * 32 + l];
      const float x = __fsub_rn(v.x, mx), y = __fsub_rn(v.y, my), z = __fsub_rn(v.z, mz);
      tile[u * 32 + l] = make_float4(x, y, z, v.w == 0.f ? sumsq3(x, y, z) : v.w);
    }
    __syncwarp();
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
          hit |= d[u][r] <= bd[r];
        }
      }
      if (kCount) branches += __any_sync(kFull, hit);
      if (hit) {   // the least (max(d, 0), index)
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            const int jj = j_tile + j + u;
            const float dc = fmaxf(d[u][r], 0.f);
            if (d[u][r] <= bd[r] && (dc < bd[r] || jj < bi[r])) {
              bd[r] = dc;
              bi[r] = jj;
            }
          }
        }
      }
    }
    __syncwarp();   // done with the slot before the next tile overwrites it
    if (keys != nullptr) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (q0 + r * 32 + l < n) atomicMin(keys + row0 + r * 32, pick_key(bd[r], bi[r]));
      }
    }
  }
  if (kCount && l == 0) {
    atomicAdd(counts + 0, scored + culled);
    atomicAdd(counts + 1, scored);
    atomicAdd(counts + 2, culled);
    atomicAdd(counts + 3, branches);
  }

#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = q0 + r * 32 + l;
    if (i >= n) continue;
    if (keys == nullptr) {
      rescore(q, qmask, t, static_cast<long long>(lane) * n + i, lane, m, bd[r], bi[r], out_d,
              out_i);
    }
  }
}

// keys (B * n) the splits' shared picks -> re-scored.
__global__ void nn_merge(const unsigned long long* __restrict__ keys, long long rows, int n,
                         const float* __restrict__ q, const unsigned char* __restrict__ qmask,
                         const float* __restrict__ t, int m, float* __restrict__ out_d,
                         long long* __restrict__ out_i) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= rows) return;
  const unsigned long long key = keys[i];
  rescore(q, qmask, t, i, i / n, m, __uint_as_float(static_cast<unsigned>(key >> 32)),
          static_cast<int>(key & 0xffffffffu), out_d, out_i);
}

}  // namespace

// Block size, tile length, queries a thread and tiles a split; the
// wrapper's launch plan must use the same.
extern "C" void ltm_nn_argmin_config(int* threads, int* tile, int* r, int* max_tiles) {
  *threads = kThreads;
  *tile = kTile;
  *r = kR;
  *max_tiles = kMaxTiles;
}

// q (lanes, n, 3) f32, qmask (lanes, n) bool; t (lanes, m, 3) f32, tmask
// (lanes, m) bool, the original points; chunk a multiple of the tile of at
// most kMaxTiles tiles, splits * chunk >= m.  Scratch the caller allocates:
// t4 (lanes, splits * chunk) float4; boxes (lanes, splits * chunk / kTile,
// 6) f32; keys (lanes * n) uint64 when splits > 1, else null.  counts:
// null, or 4 uint64 the scan adds its work to.  Out: out_d (lanes, n) f32,
// the exact squared distance of the pick (1e30 at an invalid query or
// where nothing beat 1e30), out_i (lanes, n) i64.  Launches the pack, the
// scan and, when splits > 1, the merge on `stream`, checks
// cudaGetLastError() after each and returns the first error (0 on
// success).  Does not synchronise.
extern "C" int ltm_nn_argmin(const float* q, const unsigned char* qmask, const float* t,
                             const unsigned char* tmask, int lanes, int n, int m, int chunk,
                             int splits, void* t4, float* boxes, unsigned long long* keys,
                             float* out_d, long long* out_i, unsigned long long* counts,
                             void* stream) {
  if (lanes <= 0 || n <= 0 || m <= 0 || chunk <= 0 || chunk % kTile != 0 ||
      chunk / kTile > kMaxTiles || splits < 1 || splits > 65535 ||
      static_cast<long long>(splits) * chunk < m ||
      static_cast<long long>(splits) * chunk >= (1LL << 31) ||
      (splits > 1) != (keys != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int q_blocks = (n + kR * kThreads - 1) / (kR * kThreads);
  if (static_cast<long long>(lanes) * q_blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* tv = static_cast<float4*>(t4);
  const int chunk_tiles = chunk / kTile;
  const int tiles = splits * chunk_tiles;
  const long long rows = static_cast<long long>(lanes) * n;
  const long long pack_blocks = (static_cast<long long>(lanes) * tiles + 7) / 8;
  nn_pack<<<static_cast<unsigned>(pack_blocks < 8192 ? pack_blocks : 8192), 256, 0, s>>>(
      t, tmask, lanes, m, tiles, tv, boxes, keys, rows);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const dim3 grid(lanes * q_blocks, splits);
  if (counts != nullptr) {
    nn_scan<true><<<grid, kThreads, 0, s>>>(q, qmask, n, q_blocks, t, tv, boxes, m, tiles,
                                            chunk_tiles, keys, out_d, out_i, counts);
  } else {
    nn_scan<false><<<grid, kThreads, 0, s>>>(q, qmask, n, q_blocks, t, tv, boxes, m, tiles,
                                             chunk_tiles, keys, out_d, out_i, counts);
  }
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || splits == 1) return rc;
  nn_merge<<<static_cast<unsigned>((rows + 255) / 256), 256, 0, s>>>(keys, rows, n, q, qmask, t,
                                                                     m, out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ltm_nn_argmin_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
