"""Range-image projection and visibility-discrepancy operations
(port of ``ltm.kernels.projection``).

LT-removert projects map points into each keyframe's spherical range image
with a scatter-min and asks, per point, whether it owns its pixel and how
its range compares with the keyframe's scan:

  * ``range_image``      — scatter-min of point ranges into the pixel grid;
  * ``winner_mask``      — a point owns its pixel iff its range equals the
    pixel minimum;
  * ``discrepancy_mask`` — the Removert rule: pixel diff = scan − map (or
    reversed for ND checks); a winning map point is dynamic iff
    ``thres < diff < VALID_DIFF_UB``.

Bit-faithfulness to ``ltm``: the pixel rule is kept op for op (atan2,
degrees, round-half-even, clip), including the fused multiply-adds that XLA
forms when it compiles ``ltm``'s code under ``jit`` on the CPU (``_fma``).
``torch.sqrt`` on the CPU is not correctly rounded, so the CPU path takes
its square roots in float64 (exact after rounding back); CUDA's ``sqrtf``
is IEEE.  A division by a
Python scalar is written as a division by a 0-d tensor on the operand's
device, because PyTorch's CUDA division by a host scalar multiplies by the
reciprocal instead.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = [
    "apply_pose",
    "rimg_shape",
    "spherical_project",
    "range_image",
    "winner_mask",
    "packed_winner_image",
    "fused_visibility_images",
    "discrepancy_mask",
    "discrepancy_vs_image",
    "sweep_discrepancy",
    "sweep_discrepancy_vs_images",
]

NO_POINT = 10000.0        # kFlagNoPOINT (ltremovert/include/removert/utility.h:93)
VALID_DIFF_UB = 200.0     # kValidDiffUpperBound (utility.h:94)
_PACKED_SENTINEL = torch.iinfo(torch.int32).max
_RAD2DEG = 57.295780181884766  # float32(180/pi), as jnp.degrees multiplies


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on either device."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a·b + c`` with one rounding, as a fused multiply-add: the
    product is exact in float64, so the float64 sum rounded to float32 is
    the FMA result (up to a double rounding, on about 2^-29 of inputs)."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b + c).float()


def sumsq3(v: torch.Tensor) -> torch.Tensor:
    """float32 ``Σ v_i²`` over a last axis of 3, summed the way XLA's CPU
    reduction of ``jnp.sum(v * v, axis=-1)`` does: ``acc = fma(v_i, v_i,
    acc)`` from ``acc = v_0²``."""
    x, y, z = v.unbind(-1)
    return _fma(z, z, _fma(y, y, x * x))


def _div(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` as a true IEEE division on either device."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def _recip(s: float) -> np.float32:
    """The float32 reciprocal of float32 ``s``: what XLA multiplies by where
    ``ltm`` divides by a compile-time constant under ``jit``."""
    return np.float32(1.0) / np.float32(s)


def transform(xyz: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``R·p + t`` per point in float32 (``R``/``t`` broadcast over the
    points' leading axes), as XLA computes ``ltm``'s HIGHEST-precision
    (N,3)x(3,3) product plus offset under ``jit`` on the CPU:
    ``fma(z, r2, fma(y, r1, x·r0)) + t`` per row."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    return torch.stack(
        [_fma(z, R[..., i, 2], _fma(y, R[..., i, 1], x * R[..., i, 0])) + t[..., i]
         for i in range(3)], -1)


def apply_pose(xyz: torch.Tensor, Tinv: torch.Tensor) -> torch.Tensor:
    """Global -> lidar-frame point transform (see :func:`transform`)."""
    return transform(xyz, Tinv[:3, :3], Tinv[:3, 3])


def rimg_shape(fov: Tuple[float, float], alpha: float) -> Tuple[int, int]:
    """Image rows/cols for a FOV at resolution multiplier alpha
    (reference ``resetRimgSize``, ``ltremovert/src/utility.cpp:222-236``)."""
    vfov, hfov = fov
    return int(round(vfov * alpha)), int(round(hfov * alpha))


def _pix_rowcol(xyz: torch.Tensor, fov, shape):
    """(row, col, range) of the reference pixel rule
    (``ltremovert/src/Removerter.cpp:137-138``): row/col = round() of the
    normalized elevation/azimuth, clamped to the image."""
    vfov, hfov = float(fov[0]), float(fov[1])
    nrow, ncol = shape
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    # the FMAs LLVM forms when XLA compiles ltm's expressions under jit:
    # x*x + y*y -> fma(x, x, y*y); (...) + z*z -> fma(z, z, ...);
    # degrees(a) + c -> fma(a, 180/pi, c)
    xx_yy = _fma(x, x, y * y)
    rxy = _sqrt(xx_yy)
    rng = _sqrt(_fma(z, z, xx_yy))
    az = _fma(torch.atan2(y, x), _RAD2DEG, hfov / 2.0)
    el = _fma(torch.atan2(z, rxy), _RAD2DEG, vfov / 2.0)
    # XLA turns a division by a constant into a product with its float32
    # reciprocal and folds constant factors: nrow·(1 − el/vfov) ->
    # nrow·fma(−el, 1/vfov, 1); ncol·(az/hfov) -> az·(ncol·(1/hfov))
    row = torch.round(nrow * _fma(-el, float(_recip(vfov)), 1.0))
    col = torch.round(az * float(np.float32(ncol) * _recip(hfov)))
    row = torch.clamp(row, 0, nrow - 1).long()
    col = torch.clamp(col, 0, ncol - 1).long()
    return row, col, rng


def spherical_project(xyz: torch.Tensor, fov, shape):
    """Points -> (pixel linear index int64, range)."""
    row, col, rng = _pix_rowcol(xyz, fov, shape)
    return row * shape[1] + col, rng


def _project_min(xyz: torch.Tensor, mask: torch.Tensor, fov, shape):
    """(pixel ids, ranges, scatter-min image) — the shared projection core."""
    pix, rng = spherical_project(xyz, fov, shape)
    rng_masked = torch.where(mask, rng, torch.inf)
    img = torch.full((shape[0] * shape[1],), NO_POINT, dtype=xyz.dtype, device=xyz.device)
    img.scatter_reduce_(0, pix, rng_masked, "amin")
    return pix, rng, img


def range_image(xyz: torch.Tensor, mask: torch.Tensor, fov, shape) -> torch.Tensor:
    """Scatter-min range image, flattened (nrow*ncol,). Empty pixels = NO_POINT."""
    return _project_min(xyz, mask, fov, shape)[2]


def winner_mask(xyz: torch.Tensor, mask: torch.Tensor, fov, shape):
    """Mask of points that own their pixel in the scatter-min image
    (the reference's ptidx image, ``utility.cpp:104,137``).
    Returns ``(win, pix, rng, img)``."""
    pix, rng, img = _project_min(xyz, mask, fov, shape)
    return mask & (rng <= img[pix]), pix, rng, img


def _pack_points(xyz_local: torch.Tensor, mask: torch.Tensor, fov,
                 proj_shape: Tuple[int, int], shape: Tuple[int, int],
                 scale: float):
    """(packed int32 per point, proj-shape pixel id per point):
    ``round(range·scale)·16 + (Δrow+1)·4 + (Δcol+1)`` where Δrow/Δcol
    locate the point's ``shape`` pixel relative to a base derived from its
    ``proj_shape`` pixel."""
    nrow_p, ncol_p = proj_shape
    nrow_s, ncol_s = shape
    if nrow_s > nrow_p or ncol_s > ncol_p:
        raise ValueError(f"shape {shape} must be no finer than proj_shape {proj_shape}")
    rratio = nrow_s / nrow_p       # rounded to float32 by the multiply
    cratio = ncol_s / ncol_p

    row_p, col_p, rng = _pix_rowcol(xyz_local, fov, proj_shape)
    row_s, col_s, _ = _pix_rowcol(xyz_local, fov, shape)
    base_r = torch.round(row_p.float() * rratio).long()
    base_c = torch.round(col_p.float() * cratio).long()
    dr = torch.clamp(row_s - base_r + 1, 0, 2)
    dc = torch.clamp(col_s - base_c + 1, 0, 2)
    q = torch.clamp(torch.round(rng * scale), 0, float(2 ** 27 - 1)).long()
    packed = torch.where(mask, q * 16 + dr * 4 + dc, _PACKED_SENTINEL).int()
    return packed, row_p * ncol_p + col_p


def _decode_winner_image(img_p: torch.Tensor, proj_shape: Tuple[int, int],
                         shape: Tuple[int, int], scale: float) -> torch.Tensor:
    """Dense decode of a packed proj-resolution winner image into the
    filter-resolution range image."""
    nrow_p, ncol_p = proj_shape
    nrow_s, ncol_s = shape
    rratio = nrow_s / nrow_p
    cratio = ncol_s / ncol_p
    pidx = torch.arange(nrow_p * ncol_p, device=img_p.device)
    prow = pidx // ncol_p
    pcol = pidx % ncol_p
    wbase_r = torch.round(prow.float() * rratio).long()
    wbase_c = torch.round(pcol.float() * cratio).long()
    valid = img_p != _PACKED_SENTINEL
    img = img_p.long()
    wq = img // 16
    wdr = (img // 4) % 4
    wdc = img % 4
    wrow = torch.clamp(wbase_r + wdr - 1, 0, nrow_s - 1)
    wcol = torch.clamp(wbase_c + wdc - 1, 0, ncol_s - 1)
    wpix = wrow * ncol_s + wcol
    wrng = torch.where(valid, _div(wq.float(), scale), torch.inf)
    img_s = torch.full((nrow_s * ncol_s,), NO_POINT, dtype=torch.float32, device=img_p.device)
    return img_s.scatter_reduce_(0, wpix, wrng, "amin")


def packed_winner_image(xyz_local: torch.Tensor, mask: torch.Tensor, fov,
                        proj_shape: Tuple[int, int], shape: Tuple[int, int],
                        scale: float):
    """Winner mask at ``proj_shape`` + range image at ``shape`` of the
    winners, from ONE int32 scatter-min over the points (see
    ``ltm.kernels.projection.packed_winner_image`` for the packing).
    Returns ``(win_mask, img_shape_flat)``."""
    packed, pix_p = _pack_points(xyz_local, mask, fov, proj_shape, shape, scale)
    img_p = torch.full((proj_shape[0] * proj_shape[1],), _PACKED_SENTINEL,
                       dtype=torch.int32, device=xyz_local.device)
    img_p.scatter_reduce_(0, pix_p, packed, "amin")
    win = mask & (packed == img_p[pix_p])
    return win, _decode_winner_image(img_p, proj_shape, shape, scale)


def fused_visibility_images(source_xyz, source_mask, pose_inv, fov, shape,
                            proj_shape, scale):
    """(visible-from-any-keyframe union mask, (K, nrow*ncol) winner images)
    of a whole map, one packed winner pass per keyframe."""
    union = torch.zeros(source_xyz.shape[:-1], dtype=torch.bool, device=source_xyz.device)
    imgs = []
    for Tinv in pose_inv:
        local = apply_pose(source_xyz, Tinv)
        win, img = packed_winner_image(local, source_mask, fov, proj_shape, shape, scale)
        union |= win
        imgs.append(img)
    return union, torch.stack(imgs)


def discrepancy_vs_image(map_xyz_local, map_mask, scan_img, fov, shape,
                         diff_threshold: float = 0.1, reverse: bool = False):
    """Per-map-point dynamic mask against a precomputed scan range image."""
    pix, rng, map_img = _project_min(map_xyz_local, map_mask, fov, shape)
    diff_img = (map_img - scan_img) if reverse else (scan_img - map_img)
    flag_img = (diff_img > diff_threshold) & (diff_img < VALID_DIFF_UB)
    # pack (min range, flag) so the per-point pass is a single gather
    packed = torch.where(flag_img, map_img, -map_img)
    g = packed[pix]
    return map_mask & (rng <= torch.abs(g)) & (g > 0)


def discrepancy_mask(map_xyz_local, map_mask, scan_xyz, scan_mask, fov, shape,
                     diff_threshold: float = 0.1, reverse: bool = False):
    """Per-map-point dynamic mask for one keyframe (both clouds in lidar
    frame).  ``reverse=False``: diff = scan − map (self-removert / PD,
    ``Removerter.cpp:572,459``); ``reverse=True``: diff = map − scan (ND,
    ``Removerter.cpp:516``)."""
    scan_img = range_image(scan_xyz, scan_mask, fov, shape)
    return discrepancy_vs_image(map_xyz_local, map_mask, scan_img, fov, shape,
                                diff_threshold, reverse)


def sweep_discrepancy(map_xyz_global, map_mask, scans_xyz, scans_mask, pose_inv,
                      fov, shape, diff_threshold: float = 0.1, reverse: bool = False):
    """OR over keyframes of :func:`discrepancy_mask` (the map-side removal
    loop, ``Removerter.cpp:542-593``)."""
    out = torch.zeros(map_xyz_global.shape[:-1], dtype=torch.bool, device=map_xyz_global.device)
    for scan_xyz, scan_mask, Tinv in zip(scans_xyz, scans_mask, pose_inv):
        local = apply_pose(map_xyz_global, Tinv)
        out |= discrepancy_mask(local, map_mask, scan_xyz, scan_mask, fov, shape,
                                diff_threshold, reverse)
    return out


def sweep_discrepancy_vs_images(target_xyz, target_mask, scan_imgs, pose_inv, fov,
                                shape, diff_threshold: float = 0.1, reverse: bool = False):
    """OR over keyframes of :func:`discrepancy_vs_image`."""
    out = torch.zeros(target_xyz.shape[:-1], dtype=torch.bool, device=target_xyz.device)
    for img, Tinv in zip(scan_imgs, pose_inv):
        local = apply_pose(target_xyz, Tinv)
        out |= discrepancy_vs_image(local, target_mask, img, fov, shape,
                                    diff_threshold, reverse)
    return out
