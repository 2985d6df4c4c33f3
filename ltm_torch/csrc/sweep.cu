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
// The wrapper (ltm_torch/kernels/sweep.py) picks every keyframe's blocks at
// once and hands this file (keyframe, selected block) lists; each C entry
// launches a sweep's passes for up to 65 535 keyframes, with no host sync.
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
// What bounds it: FP64 operations.  Each projected point takes two float64
// atan2 and ~16 float64 multiplies and adds (the pose, the sums of
// squares, the angles): at the H100's 34 TFLOP/s of FP64 (non-tensor)
// that outweighs its 13 bytes at 3.35 TB/s several times over.  The
// images (K x 112 500 floats at the filter resolution) stay in L2/HBM.
//
// Design, simple first:
//   * One CTA a (keyframe, selected block), one thread a slot; a CTA whose
//     list entry is padding exits at once.  Images of all keyframes of a
//     launch live side by side at k * n_pix, so one launch covers them.
//   * Scatter-min by atomics: atomicMin on the int bits of a float32
//     range (ordered like the floats for ranges >= 0; atomicMax on the
//     unsigned bits keeps a negative value ordered too), atomicMin on
//     K3's packed int32.  min does not depend on the order.
//   * The gather pass projects each point again instead of keeping its
//     pixel and range: FP64 work against 8 bytes a point of traffic.
//   * A flagged slot is set to 1 (a benign byte race, OR semantics).

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

// The list passes' grid: a CTA a (list entry, keyframe).
bool valid_lists(const SweepArgs& a) {
  return a.n_kf >= 1 && a.n_kf <= 65535 && a.k_sel >= 1 && a.cap >= 1 && a.n_blocks >= 1 &&
         a.img.nrow >= 1 && a.img.ncol >= 1;
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" int ltm_sweep_args_size() { return static_cast<int>(sizeof(SweepArgs)); }

extern "C" int ltm_sweep_threads() { return kThreads; }

// K2 over n_kf keyframes.  bxyz (n_blocks, cap, 3) f32, bmask and extra
// (n_blocks*cap) bytes (extra may be null), sel (n_kf, k_sel) i32 and
// sel_valid bytes, tinv (n_kf, 4, 4) f32.  With scans (n_kf, n_scan, 3)
// and smask, pass (a) first fills scan_img; without, scan_img holds the
// given images.  scan_img and map_img are (n_kf, n_pix) f32, filled with
// NO_POINT by the caller where they are scattered into.  out (n_blocks*cap)
// bytes, OR-ed into.  Returns a cudaError_t.
extern "C" int ltm_sweep_discrepancy(const float* bxyz, const uint8_t* bmask,
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

// K3 over n_kf keyframes: img_p (n_kf, n_pix_p) i32 filled with the
// sentinel and img_s (n_kf, n_pix) f32 filled with NO_POINT by the caller;
// out as for K2.  Returns a cudaError_t.
extern "C" int ltm_sweep_winners(const float* bxyz, const uint8_t* bmask, const uint8_t* extra,
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
