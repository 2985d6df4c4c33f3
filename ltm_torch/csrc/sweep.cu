// LT-removert's block visibility sweeps, CUDA C++ for Hopper (sm_90a).
//
// Replaces what XLA compiles from ltm's jitted sweeps, a lax.scan over the
// keyframes of one block gather, spherical projection, scatter-min, gather
// and block scatter each:
//   K2, the scatter-min discrepancy sweep: ltm/kernels/blocks.py:222
//       block_sweep_discrepancy (over projection.py:282 discrepancy_mask,
//       :256 discrepancy_vs_image, :91 _project_min), :330
//       block_sweep_discrepancy_vs_images and :375 ..._vs_images_presel;
//   K3, the packed winner pass: ltm/kernels/blocks.py:537
//       block_fused_visibility_images (over projection.py:190
//       packed_winner_image, :138 _pack_points, :163 _decode_winner_image).
// ltm_torch/kernels/blocks.py picks every keyframe's blocks at once; the
// wrappers (ltm_torch/kernels/sweep.py) hand this file (keyframe, selected
// block) lists; each C entry launches a sweep for up to 65 535 keyframes
// (the cluster variant: one kernel; the global variant: a kernel a pass),
// with no host sync.
//
// Bits.  Every pixel id, range and packed value is the float32 value of
// the plain PyTorch version (ltm_torch/kernels/projection.py):
//   _fma (a float64 multiply and add rounded to float32, NOT an fmaf) is
//   fma64; float32 products and sums that PyTorch rounds one by one are
//   __fmul_rn/__fadd_rn/__fsub_rn, which nvcc never contracts; _sqrt is
//   __fsqrt_rn; _atan2 is float64 atan2 rounded to float32; _div is
//   __fdiv_rn; torch.round is rintf.  Python scalars arrive as PyTorch
//   casts them (float32), the float64 constants of _fma as doubles.
//   This file builds with the port's common NVCC_FLAGS (default -fmad), so
//   libdevice's atan2 compiles as it does inside PyTorch.
//
// What bounds it.  The work is FP64 operations: each projected point takes
// two float64 atan2 and ~16 float64 multiplies and adds (the pose, the
// sums of squares, the angles), which at the H100's 34 TFLOP/s of FP64
// (non-tensor) outweigh its 13 bytes at 3.35 TB/s several times over.
// The first design (kept below as the global variant: a kernel a pass,
// images in device memory) ran 34-95x that bound on an H100: its
// scatter-min passes took ~4x the time of the gather passes that do the
// same projection (k2_map_min 7.75 ms a phase-5 run of chip_smoke.py
// against k2_flag 1.75; k3_packed<false> 6.84 against <true> 1.40), so
// the cost was the global atomicMin traffic, queued at L2 on the few
// pixels a block's points share.
//
// Design (the cluster variant, the default):
//   * One thread-block cluster a keyframe: 4 CTAs, or 8, of 1 024 threads
//     (one CTA an SM: its registers allow no more warps), the fewest whose
//     bands take at most half a CTA's shared memory, else the fewest that
//     fit it: a large image spreads its keyframe's work over more SMs.
//     Each of the
//     keyframe's scatter-min images lives in the cluster's shared memory,
//     cut into row bands, one band a CTA; a pixel's owner is its row /
//     band_rows.  A scatter-min is an atomicMin on the owner's band
//     through cooperative_groups' map_shared_rank: a distributed-shared-
//     memory atomic, never an L2 one.
//   * Float ranges are kept as ordered int keys (the bits, with the
//     magnitude bits of a negative flipped), so one signed atomicMin orders
//     every value as the floats order, negatives included (K3's decode
//     wraps ranges negative past the int32 cut).
//   * Each point issues its own atomic.  Taking a warp's min first for
//     lanes on one pixel (__match_any_sync, __reduce_min_sync) measured
//     slower on every call: distributed-shared-memory atomics do not queue
//     as the L2's did, and the match cost more than it saved.
//   * One launch a sweep.  K2: (a) scan min (forward sweeps), (b) map
//     min, cluster barrier, (c) flag; K3: (1) packed min, barrier, (2)
//     winners and (3) decode, barrier, (4) keys to floats.  No internal
//     image (K2's scan and map images, K3's packed image) ever reaches
//     device memory; given scan images are read from it, and K3's output
//     image is written there whole by the kernel (filled, then decoded
//     into by global atomics: ~1.4 proj pixels a pixel, little contention).
//   * The CTAs of a cluster take the keyframe's list entries in turn, and
//     their slots as one flat range.  The gather
//     passes project each point again rather than keep (pixel, range) a
//     point in device memory: FP64 work (1.40-1.76 ms a phase-5 run in the
//     global variant's gather passes) against 8 bytes a point written and
//     read back, and a scratch allocation the size of the lists.
//   * min does not depend on the order of the atomics: every result is
//     the plain version's, bit for bit.
// Images larger than 8 CTAs can hold (a finer remove_resolution_list)
// take the global variant: a kernel a pass, images in device memory,
// global atomics.  The wrapper chooses by size before launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

// One image resolution's pixel rule (projection._pix_rowcol).  This struct
// and the next stay outside the anonymous namespace: the C entries take
// them and must keep external linkage.
struct Pix {
  double recip_v;      // float32(1 / vfov), widened: _fma's float64 operand
  float nrow_f;        // nrow, as PyTorch casts the int scalar
  float col_scale;     // float32(ncol) * float32(1 / hfov)
  int nrow, ncol;
};

// Every scalar of a launch set; mirrored by sweep.py's _Args.
struct SweepArgs {
  double half_v, half_h;   // vfov / 2.0, hfov / 2.0 (Python doubles)
  double rad2deg;          // float32(180 / pi), widened
  Pix img;                 // the discrepancy / filter-resolution image
  Pix proj;                // K3's packing resolution
  float diff_threshold, scale, rratio, cratio;
  int reverse;
  int n_kf;                // keyframes of this launch set
  int k_sel;               // list entries a keyframe
  int cap;                 // slots a block
  int n_scan;              // points a scan (K2 forward)
  int n_blocks;
  int cluster;             // cluster variant: CTAs a keyframe
  int band_rows;           // cluster variant: rows of the image a CTA holds
  int band_rows_p;         // cluster variant: rows of K3's packed image a CTA holds
};

namespace {

constexpr int kThreads = 256;
constexpr float kValidDiffUb = 200.0f;     // projection.VALID_DIFF_UB
constexpr int kSentinel = 0x7fffffff;      // projection._PACKED_SENTINEL
// torch.clamp(x, 0, float(2**27 - 1)) on float32 casts the bound to
// float32 first: 2^27 - 1 rounds to 2^27
constexpr float kPackedMaxQ = static_cast<float>((1 << 27) - 1);

// projection._fma: float32 a*b + c from float64, rounded once to float32
// after a float64 product (exact) and a float64 sum.
__device__ __forceinline__ float fma64(float a, double b, double c) {
  return __double2float_rn(__dadd_rn(__dmul_rn(static_cast<double>(a), b), c));
}

// projection.transform on one point: row i is
// fma(z, R[i,2], fma(y, R[i,1], x*R[i,0])) + t[i]; T is a row-major 4x4.
__device__ __forceinline__ void transform(const float* __restrict__ T, float px, float py,
                                          float pz, float& x, float& y, float& z) {
  float o[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float r0 = __ldg(T + 4 * i), r1 = __ldg(T + 4 * i + 1), r2 = __ldg(T + 4 * i + 2);
    const float inner = fma64(py, static_cast<double>(r1),
                              static_cast<double>(__fmul_rn(px, r0)));
    o[i] = __fadd_rn(fma64(pz, static_cast<double>(r2), static_cast<double>(inner)),
                     __ldg(T + 4 * i + 3));
  }
  x = o[0];
  y = o[1];
  z = o[2];
}

// Range, azimuth and elevation in degrees (offset by half the FOV).
__device__ __forceinline__ void angles(float x, float y, float z, const SweepArgs& a,
                                       float& rng, float& az, float& el) {
  const float xx_yy = fma64(x, static_cast<double>(x), static_cast<double>(__fmul_rn(y, y)));
  const float rxy = __fsqrt_rn(xx_yy);
  rng = __fsqrt_rn(fma64(z, static_cast<double>(z), static_cast<double>(xx_yy)));
  const float t_az = __double2float_rn(atan2(static_cast<double>(y), static_cast<double>(x)));
  const float t_el = __double2float_rn(atan2(static_cast<double>(z), static_cast<double>(rxy)));
  az = fma64(t_az, a.rad2deg, a.half_h);
  el = fma64(t_el, a.rad2deg, a.half_v);
}

// row = round(nrow * fma(-el, 1/vfov, 1)), col = round(az * (ncol/hfov)),
// both clamped to the image.
__device__ __forceinline__ int pixel(float az, float el, const Pix& p, int& row, int& col) {
  float r = rintf(__fmul_rn(p.nrow_f, fma64(-el, p.recip_v, 1.0)));
  float c = rintf(__fmul_rn(az, p.col_scale));
  r = fminf(fmaxf(r, 0.0f), static_cast<float>(p.nrow - 1));
  c = fminf(fmaxf(c, 0.0f), static_cast<float>(p.ncol - 1));
  row = static_cast<int>(r);
  col = static_cast<int>(c);
  return row * p.ncol + col;
}

// projection._pack_points for one valid point: the quantized range and the
// filter-resolution pixel's offset from the base of its proj pixel.  The
// int64 sum is cut to int32 as Tensor.int() cuts it.
__device__ __forceinline__ int pack(float rng, int row_p, int col_p, int row_s, int col_s,
                                    const SweepArgs& a) {
  const int base_r = static_cast<int>(rintf(__fmul_rn(static_cast<float>(row_p), a.rratio)));
  const int base_c = static_cast<int>(rintf(__fmul_rn(static_cast<float>(col_p), a.cratio)));
  const int dr = min(max(row_s - base_r + 1, 0), 2);
  const int dc = min(max(col_s - base_c + 1, 0), 2);
  const float qf = fminf(fmaxf(rintf(__fmul_rn(rng, a.scale)), 0.0f), kPackedMaxQ);
  const long long q = static_cast<long long>(qf);
  return static_cast<int>(q * 16 + dr * 4 + dc);
}

// Scatter-min of a float32 (never NaN, never -0.0 here).
__device__ __forceinline__ void atomic_min_f32(float* addr, float v) {
  if (v >= 0.0f) {
    atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

// The (keyframe, list entry) of this CTA: the block's first flat slot, or
// -1 for a padding entry (or an index outside the map).
__device__ __forceinline__ long long block_base(const int* __restrict__ sel,
                                                const uint8_t* __restrict__ sel_valid,
                                                const SweepArgs& a) {
  const long long e = static_cast<long long>(blockIdx.y) * a.k_sel + blockIdx.x;
  const int b = sel[e];
  if (!sel_valid[e] || b < 0 || b >= a.n_blocks) return -1;
  return static_cast<long long>(b) * a.cap;
}

__device__ __forceinline__ bool live(const uint8_t* __restrict__ bmask,
                                     const uint8_t* __restrict__ extra, long long idx) {
  return bmask[idx] && (extra == nullptr || extra[idx]);
}

// K2 (a): each keyframe's scan ranges into its own image (range_image).
__global__ void __launch_bounds__(kThreads)
k2_scan_min(const float* __restrict__ scans, const uint8_t* __restrict__ smask,
            float* __restrict__ scan_img, SweepArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n_scan) return;
  const long long p = static_cast<long long>(blockIdx.y) * a.n_scan + i;
  if (!smask[p]) return;
  float rng, az, el;
  angles(scans[3 * p], scans[3 * p + 1], scans[3 * p + 2], a, rng, az, el);
  int row, col;
  const int pix = pixel(az, el, a.img, row, col);
  atomic_min_f32(scan_img + static_cast<long long>(blockIdx.y) * a.img.nrow * a.img.ncol + pix,
                 rng);
}

// K2 (b): every live slot of a keyframe's blocks, in that keyframe's frame,
// scatter-min into its map image.
__global__ void __launch_bounds__(kThreads)
k2_map_min(const float* __restrict__ bxyz, const uint8_t* __restrict__ bmask,
           const uint8_t* __restrict__ extra, const int* __restrict__ sel,
           const uint8_t* __restrict__ sel_valid, const float* __restrict__ tinv,
           float* __restrict__ map_img, SweepArgs a) {
  const long long base = block_base(sel, sel_valid, a);
  if (base < 0) return;
  const float* T = tinv + 16 * blockIdx.y;
  float* img = map_img + static_cast<long long>(blockIdx.y) * a.img.nrow * a.img.ncol;
  for (int s = threadIdx.x; s < a.cap; s += kThreads) {
    const long long idx = base + s;
    if (!live(bmask, extra, idx)) continue;
    float x, y, z, rng, az, el;
    transform(T, bxyz[3 * idx], bxyz[3 * idx + 1], bxyz[3 * idx + 2], x, y, z);
    angles(x, y, z, a, rng, az, el);
    int row, col;
    atomic_min_f32(img + pixel(az, el, a.img, row, col), rng);
  }
}

// K2 (c): a live slot is dynamic iff it wins its pixel and the pixel's
// diff lies in (thres, VALID_DIFF_UB): the decoded form of
// discrepancy_vs_image's packed gather, mask & (rng <= m) & flag & (m > 0).
__global__ void __launch_bounds__(kThreads)
k2_flag(const float* __restrict__ bxyz, const uint8_t* __restrict__ bmask,
        const uint8_t* __restrict__ extra, const int* __restrict__ sel,
        const uint8_t* __restrict__ sel_valid, const float* __restrict__ tinv,
        const float* __restrict__ map_img, const float* __restrict__ scan_img,
        uint8_t* __restrict__ out, SweepArgs a) {
  const long long base = block_base(sel, sel_valid, a);
  if (base < 0) return;
  const float* T = tinv + 16 * blockIdx.y;
  const long long off = static_cast<long long>(blockIdx.y) * a.img.nrow * a.img.ncol;
  for (int s = threadIdx.x; s < a.cap; s += kThreads) {
    const long long idx = base + s;
    if (!live(bmask, extra, idx)) continue;
    float x, y, z, rng, az, el;
    transform(T, bxyz[3 * idx], bxyz[3 * idx + 1], bxyz[3 * idx + 2], x, y, z);
    angles(x, y, z, a, rng, az, el);
    int row, col;
    const long long pix = off + pixel(az, el, a.img, row, col);
    const float m = map_img[pix];
    const float sc = scan_img[pix];
    const float diff = a.reverse ? __fsub_rn(m, sc) : __fsub_rn(sc, m);
    if (rng <= m && m > 0.0f && diff > a.diff_threshold && diff < kValidDiffUb) out[idx] = 1;
  }
}

// K3 (1) and (2): the packed value of a live slot; scatter-min it into
// the proj-resolution image (win == false), or flag the slot if it equals
// its pixel's minimum (win == true).
template <bool kWin>
__global__ void __launch_bounds__(kThreads)
k3_packed(const float* __restrict__ bxyz, const uint8_t* __restrict__ bmask,
          const uint8_t* __restrict__ extra, const int* __restrict__ sel,
          const uint8_t* __restrict__ sel_valid, const float* __restrict__ tinv,
          int* __restrict__ img_p, uint8_t* __restrict__ out, SweepArgs a) {
  const long long base = block_base(sel, sel_valid, a);
  if (base < 0) return;
  const float* T = tinv + 16 * blockIdx.y;
  int* img = img_p + static_cast<long long>(blockIdx.y) * a.proj.nrow * a.proj.ncol;
  for (int s = threadIdx.x; s < a.cap; s += kThreads) {
    const long long idx = base + s;
    if (!live(bmask, extra, idx)) continue;
    float x, y, z, rng, az, el;
    transform(T, bxyz[3 * idx], bxyz[3 * idx + 1], bxyz[3 * idx + 2], x, y, z);
    angles(x, y, z, a, rng, az, el);
    int row_p, col_p, row_s, col_s;
    const int pix_p = pixel(az, el, a.proj, row_p, col_p);
    pixel(az, el, a.img, row_s, col_s);
    const int packed = pack(rng, row_p, col_p, row_s, col_s, a);
    if (kWin) {
      if (packed == img[pix_p]) out[idx] = 1;
    } else {
      atomicMin(img + pix_p, packed);
    }
  }
}

// K3 (3): decode each occupied proj pixel's winner into the
// filter-resolution image (_decode_winner_image; floor division and
// Python's modulo are the shifts and masks of the int32 bits).
__global__ void __launch_bounds__(kThreads)
k3_decode(const int* __restrict__ img_p, float* __restrict__ img_s, SweepArgs a) {
  const int n_pix_p = a.proj.nrow * a.proj.ncol;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n_pix_p) return;
  const int v = img_p[static_cast<long long>(blockIdx.y) * n_pix_p + p];
  if (v == kSentinel) return;
  const int prow = p / a.proj.ncol, pcol = p % a.proj.ncol;
  const int base_r = static_cast<int>(rintf(__fmul_rn(static_cast<float>(prow), a.rratio)));
  const int base_c = static_cast<int>(rintf(__fmul_rn(static_cast<float>(pcol), a.cratio)));
  const int wrow = min(max(base_r + ((v >> 2) & 3) - 1, 0), a.img.nrow - 1);
  const int wcol = min(max(base_c + (v & 3) - 1, 0), a.img.ncol - 1);
  const float wrng = __fdiv_rn(static_cast<float>(v >> 4), a.scale);
  atomic_min_f32(img_s + static_cast<long long>(blockIdx.y) * a.img.nrow * a.img.ncol +
                     wrow * a.img.ncol + wcol,
                 wrng);
}

// ---- the cluster variant --------------------------------------------------

namespace cg = cooperative_groups;

constexpr int kClusterThreads = 1024;       // one CTA an SM (~56 registers a thread)
constexpr int kMaxCluster = 8;             // the portable cluster size
constexpr int kMaxSmem = 232448;           // dynamic shared memory a CTA (sm_90)
constexpr float kNoPoint = 10000.0f;       // projection.NO_POINT

// A float32 (not NaN) as an int that orders as the float does: the bits,
// with a negative value's magnitude bits flipped.  Its own inverse.
__device__ __forceinline__ int key_of(float v) {
  const int b = __float_as_int(v);
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float value_of(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

// The owner CTA's slot of pixel (row, col) of an image held in row bands
// of `rows` rows, `band` this CTA's band of it.
__device__ __forceinline__ int* owner_slot(cg::cluster_group& cl, int* band, int rows,
                                           int ncol, int row, int col) {
  const int owner = row / rows;
  return cl.map_shared_rank(band + (row - owner * rows) * ncol + col, owner);
}



// Every slot of this CTA's share of its keyframe's list: entries rank,
// rank + cs, ... and their slots as one flat range.  f(idx) gets the flat
// slot, or -1 (past the end, a padding entry, an index outside the map).
template <typename F>
__device__ __forceinline__ void for_list_slots(const int* __restrict__ sel,
                                               const uint8_t* __restrict__ sel_valid,
                                               const SweepArgs& a, int rank, int cs, F f) {
  const int n_e = (a.k_sel - rank + cs - 1) / cs;
  const int total = n_e * a.cap;     // < n_blocks * cap < 2^31 (the wrapper's check)
  const long long row0 = static_cast<long long>(blockIdx.y) * a.k_sel + rank;
  for (int t0 = 0; t0 < total; t0 += blockDim.x) {
    const int t = t0 + threadIdx.x;
    long long idx = -1;
    if (t < total) {
      const int j = t / a.cap;
      const int s = t - j * a.cap;
      const long long e = row0 + static_cast<long long>(j) * cs;
      const int b = sel[e];
      if (sel_valid[e] && b >= 0 && b < a.n_blocks) idx = static_cast<long long>(b) * a.cap + s;
    }
    f(idx);
  }
}

// K2, one cluster a keyframe (blockIdx.y).  Forward (scan_img == null):
// the scan and map images in shared memory; otherwise the map image, and
// the given scan images are read from device memory.
__global__ void __launch_bounds__(kClusterThreads, 1)
k2_cluster(const float* __restrict__ bxyz, const uint8_t* __restrict__ bmask,
           const uint8_t* __restrict__ extra, const int* __restrict__ sel,
           const uint8_t* __restrict__ sel_valid, const float* __restrict__ tinv,
           const float* __restrict__ scans, const uint8_t* __restrict__ smask,
           const float* __restrict__ scan_img, uint8_t* __restrict__ out, SweepArgs a) {
  cg::cluster_group cl = cg::this_cluster();
  const int cs = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  extern __shared__ int smem[];
  const int rows = a.band_rows, ncol = a.img.ncol;
  const int band = rows * ncol;
  const bool fwd = scan_img == nullptr;
  int* map_b = smem;
  int* scan_b = smem + band;
  const int no_key = key_of(kNoPoint);
  for (int i = threadIdx.x; i < band * (fwd ? 2 : 1); i += blockDim.x) smem[i] = no_key;
  cl.sync();   // every band set before any CTA's atomics reach it

  const float* T = tinv + 16 * blockIdx.y;
  if (fwd) {   // (a) the keyframe's scan ranges
    const long long p0 = static_cast<long long>(blockIdx.y) * a.n_scan;
    for (int i = rank * blockDim.x + threadIdx.x; i < a.n_scan; i += cs * blockDim.x) {
      const long long p = p0 + i;
      if (!smask[p]) continue;
      float rng, az, el;
      angles(scans[3 * p], scans[3 * p + 1], scans[3 * p + 2], a, rng, az, el);
      int row, col;
      pixel(az, el, a.img, row, col);
      atomicMin(owner_slot(cl, scan_b, rows, ncol, row, col), key_of(rng));
    }
  }
  // (b) the live slots of the keyframe's blocks, in its frame
  for_list_slots(sel, sel_valid, a, rank, cs, [&](long long idx) {
    if (idx < 0 || !live(bmask, extra, idx)) return;
    float x, y, z, rng, az, el;
    transform(T, bxyz[3 * idx], bxyz[3 * idx + 1], bxyz[3 * idx + 2], x, y, z);
    angles(x, y, z, a, rng, az, el);
    int row, col;
    pixel(az, el, a.img, row, col);
    atomicMin(owner_slot(cl, map_b, rows, ncol, row, col), key_of(rng));
  });
  cl.sync();

  // (c) a live slot is dynamic iff it wins its pixel and the pixel's diff
  // lies in (thres, VALID_DIFF_UB)
  const long long img0 = static_cast<long long>(blockIdx.y) * a.img.nrow * ncol;
  for_list_slots(sel, sel_valid, a, rank, cs, [&](long long idx) {
    if (idx < 0 || !live(bmask, extra, idx)) return;
    float x, y, z, rng, az, el;
    transform(T, bxyz[3 * idx], bxyz[3 * idx + 1], bxyz[3 * idx + 2], x, y, z);
    angles(x, y, z, a, rng, az, el);
    int row, col;
    pixel(az, el, a.img, row, col);
    const float m = value_of(*owner_slot(cl, map_b, rows, ncol, row, col));
    const float sc = fwd ? value_of(*owner_slot(cl, scan_b, rows, ncol, row, col))
                         : scan_img[img0 + row * ncol + col];
    const float diff = a.reverse ? __fsub_rn(m, sc) : __fsub_rn(sc, m);
    if (rng <= m && m > 0.0f && diff > a.diff_threshold && diff < kValidDiffUb) out[idx] = 1;
  });
  cl.sync();   // no CTA leaves while another may still read its bands
}

// K3, one cluster a keyframe: the packed image at the proj resolution in
// shared memory.  The filter-resolution image of the winners is the output
// img_s, which the kernel writes whole: each CTA fills its row band with
// the key of NO_POINT, the decode scatter-mins keys into it by global
// atomics (a pixel takes ~1.4 proj pixels: little contention), and each CTA
// turns its band's keys back into floats at the end.
__global__ void __launch_bounds__(kClusterThreads, 1)
k3_cluster(const float* __restrict__ bxyz, const uint8_t* __restrict__ bmask,
           const uint8_t* __restrict__ extra, const int* __restrict__ sel,
           const uint8_t* __restrict__ sel_valid, const float* __restrict__ tinv,
           float* __restrict__ img_s, uint8_t* __restrict__ out, SweepArgs a) {
  cg::cluster_group cl = cg::this_cluster();
  const int cs = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  extern __shared__ int smem[];
  const int rows_p = a.band_rows_p, ncol_p = a.proj.ncol;
  const int ncol_s = a.img.ncol;
  const int band_p = rows_p * ncol_p;
  int* pk_b = smem;
  int* dec = reinterpret_cast<int*>(img_s) + static_cast<long long>(blockIdx.y) * a.img.nrow *
                                                 ncol_s;
  const int row0 = rank * a.band_rows;
  const int band_s = max(min(a.band_rows, a.img.nrow - row0), 0) * ncol_s;
  int* dec_b = dec + static_cast<long long>(row0) * ncol_s;
  const int no_key = key_of(kNoPoint);
  for (int i = threadIdx.x; i < band_p; i += blockDim.x) pk_b[i] = kSentinel;
  for (int i = threadIdx.x; i < band_s; i += blockDim.x) dec_b[i] = no_key;
  cl.sync();   // every band set before any CTA's atomics reach it

  const float* T = tinv + 16 * blockIdx.y;
  // the packed value of a live slot and its proj pixel
  auto packed_of = [&](long long idx, int& row_p, int& col_p) {
    float x, y, z, rng, az, el;
    transform(T, bxyz[3 * idx], bxyz[3 * idx + 1], bxyz[3 * idx + 2], x, y, z);
    angles(x, y, z, a, rng, az, el);
    int row_s, col_s;
    pixel(az, el, a.proj, row_p, col_p);
    pixel(az, el, a.img, row_s, col_s);
    return pack(rng, row_p, col_p, row_s, col_s, a);
  };
  // (1) packed scatter-min
  for_list_slots(sel, sel_valid, a, rank, cs, [&](long long idx) {
    if (idx < 0 || !live(bmask, extra, idx)) return;
    int row_p, col_p;
    const int packed = packed_of(idx, row_p, col_p);
    atomicMin(owner_slot(cl, pk_b, rows_p, ncol_p, row_p, col_p), packed);
  });
  cl.sync();

  // (2) a live slot wins iff its packed value is its pixel's minimum
  for_list_slots(sel, sel_valid, a, rank, cs, [&](long long idx) {
    if (idx < 0 || !live(bmask, extra, idx)) return;
    int row_p, col_p;
    const int packed = packed_of(idx, row_p, col_p);
    if (packed == *owner_slot(cl, pk_b, rows_p, ncol_p, row_p, col_p)) out[idx] = 1;
  });
  // (3) each occupied proj pixel of this CTA's band: its winner into the
  // filter-resolution image (_decode_winner_image; floor division and
  // Python's modulo are the shifts and masks of the int32 bits)
  for (int i = threadIdx.x; i < band_p; i += blockDim.x) {
    const int v = pk_b[i];
    const int prow = rank * rows_p + i / ncol_p, pcol = i % ncol_p;
    if (v == kSentinel || prow >= a.proj.nrow) continue;
    const int base_r = static_cast<int>(rintf(__fmul_rn(static_cast<float>(prow), a.rratio)));
    const int base_c = static_cast<int>(rintf(__fmul_rn(static_cast<float>(pcol), a.cratio)));
    const int wrow = min(max(base_r + ((v >> 2) & 3) - 1, 0), a.img.nrow - 1);
    const int wcol = min(max(base_c + (v & 3) - 1, 0), ncol_s - 1);
    const float wrng = __fdiv_rn(static_cast<float>(v >> 4), a.scale);
    atomicMin(dec + wrow * ncol_s + wcol, key_of(wrng));
  }
  cl.sync();   // every decode in; no CTA leaves while another reads its band

  // (4) this CTA's band of the filter-resolution image: keys to the
  // floats' bits (the key map is its own inverse)
  for (int i = threadIdx.x; i < band_s; i += blockDim.x) {
    const int k = dec_b[i];
    dec_b[i] = k ^ ((k >> 31) & 0x7fffffff);
  }
}

// The cluster variant's launch configuration: a cluster of `cluster` CTAs
// a keyframe (grid: cluster x n_kf), `smem` bytes of dynamic shared memory
// (the kernel's limit raised to it); `fits`, the clusters the card holds
// at once (0: it cannot place one).
template <typename... Params>
cudaError_t cluster_config(void (*kernel)(Params...), int cluster, int smem, int n_kf,
                           cudaStream_t s, cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                           int& fits) {
  if (const cudaError_t rc = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) {
    return rc;
  }
  cfg = {};
  cfg.gridDim = dim3(cluster, n_kf);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  fits = 0;
  return cudaOccupancyMaxActiveClusters(&fits, reinterpret_cast<const void*>(kernel), &cfg);
}

// The cluster variant's launch, refused before launch where the card
// cannot place one cluster.
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), int cluster, int smem, const SweepArgs& a,
                   cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int fits = 0;
  if (const cudaError_t rc = cluster_config(kernel, cluster, smem, a.n_kf, s, cfg, attr, fits)) {
    return static_cast<int>(rc);
  }
  if (fits < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, args...)) {
    return static_cast<int>(rc);
  }
  return static_cast<int>(cudaGetLastError());
}

// A cluster plan's bands: `cluster` CTAs of `rows` rows each cover nrow.
bool valid_bands(int cluster, int rows, int nrow) {
  return cluster >= 1 && cluster <= kMaxCluster && rows >= 1 &&
         static_cast<long long>(rows) * cluster >= nrow;
}

// The list passes' grid: a CTA a (list entry, keyframe).
bool valid_lists(const SweepArgs& a) {
  return a.n_kf >= 1 && a.n_kf <= 65535 && a.k_sel >= 1 && a.cap >= 1 && a.n_blocks >= 1 &&
         a.img.nrow >= 1 && a.img.ncol >= 1;
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" int ltm_sweep_args_size() { return static_cast<int>(sizeof(SweepArgs)); }

extern "C" int ltm_sweep_threads() { return kThreads; }

// K2 over n_kf keyframes, the global variant.  bxyz (n_blocks, cap, 3) f32, bmask and extra
// (n_blocks*cap) bytes (extra may be null), sel (n_kf, k_sel) i32 and
// sel_valid bytes, tinv (n_kf, 4, 4) f32.  With scans (n_kf, n_scan, 3)
// and smask, pass (a) first fills scan_img; without, scan_img holds the
// given images.  scan_img and map_img are (n_kf, n_pix) f32, filled with
// NO_POINT by the caller where they are scattered into.  out (n_blocks*cap)
// bytes, OR-ed into.  Returns a cudaError_t.
extern "C" int ltm_sweep_discrepancy_global(const float* bxyz, const uint8_t* bmask,
                                     const uint8_t* extra, const int* sel,
                                     const uint8_t* sel_valid, const float* tinv,
                                     const float* scans, const uint8_t* smask, float* scan_img,
                                     float* map_img, uint8_t* out, const SweepArgs* args,
                                     void* stream) {
  const SweepArgs a = *args;
  if (!valid_lists(a) || (scans != nullptr && a.n_scan < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 lists(a.k_sel, a.n_kf);
  if (scans != nullptr) {
    k2_scan_min<<<dim3((a.n_scan + kThreads - 1) / kThreads, a.n_kf), kThreads, 0, s>>>(
        scans, smask, scan_img, a);
    if (const int rc = last_error()) return rc;
  }
  k2_map_min<<<lists, kThreads, 0, s>>>(bxyz, bmask, extra, sel, sel_valid, tinv, map_img, a);
  if (const int rc = last_error()) return rc;
  k2_flag<<<lists, kThreads, 0, s>>>(bxyz, bmask, extra, sel, sel_valid, tinv, map_img,
                                     scan_img, out, a);
  return last_error();
}

// K3 over n_kf keyframes, the global variant: img_p (n_kf, n_pix_p) i32 filled with the
// sentinel and img_s (n_kf, n_pix) f32 filled with NO_POINT by the caller;
// out as for K2.  Returns a cudaError_t.
extern "C" int ltm_sweep_winners_global(const float* bxyz, const uint8_t* bmask, const uint8_t* extra,
                                 const int* sel, const uint8_t* sel_valid, const float* tinv,
                                 int* img_p, float* img_s, uint8_t* out, const SweepArgs* args,
                                 void* stream) {
  const SweepArgs a = *args;
  if (!valid_lists(a) || a.proj.nrow < 1 || a.proj.ncol < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 lists(a.k_sel, a.n_kf);
  k3_packed<false><<<lists, kThreads, 0, s>>>(bxyz, bmask, extra, sel, sel_valid, tinv, img_p,
                                              out, a);
  if (const int rc = last_error()) return rc;
  k3_packed<true><<<lists, kThreads, 0, s>>>(bxyz, bmask, extra, sel, sel_valid, tinv, img_p,
                                             out, a);
  if (const int rc = last_error()) return rc;
  const int n_pix_p = a.proj.nrow * a.proj.ncol;
  k3_decode<<<dim3((n_pix_p + kThreads - 1) / kThreads, a.n_kf), kThreads, 0, s>>>(img_p, img_s,
                                                                                   a);
  return last_error();
}

// The clusters of `cluster` CTAs with `smem` bytes of shared memory each
// that the card holds at once, for K2 (kernel 0) or K3 (kernel 1), into
// *fits.  Returns a cudaError_t.
extern "C" int ltm_sweep_cluster_occupancy(int kernel, int cluster, int smem, int* fits) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const cudaError_t rc =
      kernel == 0 ? cluster_config(k2_cluster, cluster, smem, cluster, nullptr, cfg, attr, *fits)
                  : cluster_config(k3_cluster, cluster, smem, cluster, nullptr, cfg, attr, *fits);
  return static_cast<int>(rc);
}

extern "C" int ltm_sweep_max_smem() { return kMaxSmem; }

// K2 over n_kf keyframes, the cluster variant: a cluster of args->cluster
// CTAs a keyframe, each holding args->band_rows rows of the image (two
// images forward).  Inputs as for the global variant; scan_img null on
// forward sweeps (then scans and smask, or n_scan 0 for empty scans), else
// the given (n_kf, n_pix) images.  No image is written.  Returns a
// cudaError_t.
extern "C" int ltm_sweep_discrepancy_cluster(const float* bxyz, const uint8_t* bmask,
                                             const uint8_t* extra, const int* sel,
                                             const uint8_t* sel_valid, const float* tinv,
                                             const float* scans, const uint8_t* smask,
                                             const float* scan_img, uint8_t* out,
                                             const SweepArgs* args, void* stream) {
  const SweepArgs a = *args;
  const bool fwd = scan_img == nullptr;
  const long long smem = 4LL * a.band_rows * a.img.ncol * (fwd ? 2 : 1);
  if (!valid_lists(a) || !valid_bands(a.cluster, a.band_rows, a.img.nrow) || smem > kMaxSmem ||
      (fwd && a.n_scan > 0 && scans == nullptr) || a.n_scan < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_cluster(k2_cluster, a.cluster, static_cast<int>(smem), a,
                        static_cast<cudaStream_t>(stream), bxyz, bmask, extra, sel, sel_valid,
                        tinv, scans, smask, scan_img, out, a);
}

// K3 over n_kf keyframes, the cluster variant: a cluster of args->cluster
// CTAs a keyframe, each holding args->band_rows_p rows of the packed image
// and writing args->band_rows rows of img_s (n_kf, n_pix) f32, every pixel;
// out as for K2.  Returns a cudaError_t.
extern "C" int ltm_sweep_winners_cluster(const float* bxyz, const uint8_t* bmask,
                                         const uint8_t* extra, const int* sel,
                                         const uint8_t* sel_valid, const float* tinv,
                                         float* img_s, uint8_t* out, const SweepArgs* args,
                                         void* stream) {
  const SweepArgs a = *args;
  const long long smem = 4LL * a.band_rows_p * a.proj.ncol;
  if (!valid_lists(a) || a.proj.nrow < 1 || a.proj.ncol < 1 ||
      !valid_bands(a.cluster, a.band_rows, a.img.nrow) ||
      !valid_bands(a.cluster, a.band_rows_p, a.proj.nrow) || smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_cluster(k3_cluster, a.cluster, static_cast<int>(smem), a,
                        static_cast<cudaStream_t>(stream), bxyz, bmask, extra, sel, sel_valid,
                        tinv, img_s, out, a);
}

// The pixel rule alone, for the card's checks: n points (n, 3) f32 through
// tinv (4, 4) f32, then their pixel id and range at the image resolution,
// their proj pixel id and their packed value (every point valid).
__global__ void __launch_bounds__(kThreads)
pixel_rule(const float* __restrict__ xyz, int n, const float* __restrict__ tinv,
           long long* __restrict__ pix, float* __restrict__ rng_out, int* __restrict__ packed,
           long long* __restrict__ pix_p, SweepArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float x, y, z, rng, az, el;
  transform(tinv, xyz[3LL * i], xyz[3LL * i + 1], xyz[3LL * i + 2], x, y, z);
  angles(x, y, z, a, rng, az, el);
  int row_s, col_s, row_p, col_p;
  pix[i] = pixel(az, el, a.img, row_s, col_s);
  pix_p[i] = pixel(az, el, a.proj, row_p, col_p);
  rng_out[i] = rng;
  packed[i] = pack(rng, row_p, col_p, row_s, col_s, a);
}

extern "C" int ltm_sweep_pixel_rule(const float* xyz, int n, const float* tinv, long long* pix,
                                    float* rng, int* packed, long long* pix_p,
                                    const SweepArgs* args, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  pixel_rule<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xyz, n, tinv, pix, rng, packed, pix_p, *args);
  return last_error();
}

extern "C" const char* ltm_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
