"""LT-removert's block visibility sweeps for all keyframes at once: the
wrappers of the hand-written CUDA kernels ``ltm_torch/csrc/sweep.cu``,
their launch counts, and the plain mirror of the kernels' passes.

* K2, :func:`discrepancy_sweep` (replacing the ``lax.scan`` that XLA
  compiles from ``ltm/kernels/blocks.py:222 block_sweep_discrepancy``,
  ``:330 block_sweep_discrepancy_vs_images`` and ``:375 ..._presel``):
  (a) each keyframe's scan ranges scatter-min into its own image (forward
  sweeps only), (b) the keyframe's selected map points, in its frame,
  scatter-min into its map image, (c) a map point is dynamic iff it wins
  its pixel and the pixel's diff lies in (thres, ``VALID_DIFF_UB``).
* K3, :func:`winner_sweep` (``ltm/kernels/blocks.py:537
  block_fused_visibility_images``): the packed int32 scatter-min at the
  projection resolution, the winner test, and the decode of every pixel's
  winner into the filter-resolution image.

The keyframes' images lie side by side, keyframe k's at offset
``k·n_pix``, so each pass is one launch (one scatter for the mirror) over
every (keyframe, selected block, slot); keyframes run in chunks of
:data:`MAX_KEYFRAMES`.  CUDA tensors launch the kernels or raise; CPU
tensors take the mirror, which the CPU tests hold bit for bit to the
per-keyframe loops of ``ltm_torch.kernels.blocks`` (the plain versions,
``*_plain``).  The four ``block_*`` functions here are those of
``blocks.py`` run through the kernels, with every keyframe's blocks chosen
at once (:func:`select_blocks`).  The module builds and imports nothing
when it is imported.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ltm_torch.kernels.projection import (
    _PACKED_SENTINEL,
    _RAD2DEG,
    NO_POINT,
    VALID_DIFF_UB,
    _div,
    _pack_points,
    _recip,
    _sqrt,
    spherical_project,
    sumsq3,
    transform,
)

__all__ = ["MAX_KEYFRAMES", "select_blocks", "discrepancy_sweep", "winner_sweep",
           "block_sweep_discrepancy", "block_sweep_discrepancy_vs_images",
           "block_sweep_discrepancy_vs_images_presel", "block_fused_visibility_images",
           "pixel_rule"]

MAX_KEYFRAMES = 64   # keyframes a launch set (their images: 2 x 64 x 112 500 f32 for K2)


def select_blocks(bm, origins: torch.Tensor, max_range: float, k_blocks: int, valid=None):
    """(sel (K, k_blocks) int64, sel_valid (K, k_blocks) bool): every
    keyframe's ``blocks._select_blocks`` at once.  The distances are the
    per-keyframe call's, element for element; one batched ``topk`` keeps
    the ``k_blocks`` nearest in-range blocks.  The selected set is the
    per-keyframe one whenever ``k_blocks`` covers every in-range block (the
    pipeline sizes it so); the order does not matter to a min or an OR."""
    valid = bm.block_valid if valid is None else valid
    if not 0 < k_blocks <= bm.centers.shape[0]:
        raise ValueError(f"k_blocks must lie in [1, {bm.centers.shape[0]}], got {k_blocks}")
    d = _sqrt(sumsq3(bm.centers[None] - origins[:, None])) - bm.radius
    d = torch.where(valid & (d <= max_range), d, torch.inf)
    vals, idx = torch.topk(d, k_blocks, dim=1, largest=False)
    return idx, torch.isfinite(vals)


# ---- checks ---------------------------------------------------------------

def _check(bm, extra, sel, sel_valid, pose_inv):
    """Raise on what the kernels do not take: types, shapes, devices."""
    dev = bm.xyz.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the sweeps run on cuda or cpu, not {dev}")
    nb, cap = bm.mask.shape
    K = pose_inv.shape[0]
    if bm.xyz.dtype != torch.float32 or bm.xyz.shape != (nb, cap, 3):
        raise ValueError("the sweeps take a float32 (n_blocks, cap, 3) block map")
    if bm.mask.dtype != torch.bool:
        raise ValueError("the block mask must be bool")
    if nb * cap >= 2**31:
        raise ValueError(f"the sweeps take fewer than 2^31 slots, got {nb} x {cap}")
    if extra is not None and (extra.dtype != torch.bool or extra.numel() != nb * cap):
        raise ValueError("extra must be a bool mask, one entry a slot")
    if pose_inv.dtype != torch.float32 or pose_inv.shape != (K, 4, 4):
        raise ValueError("pose_inv must be float32 (K, 4, 4)")
    if sel.dtype not in (torch.int32, torch.int64) or sel.dim() != 2 or sel.shape[0] != K:
        raise ValueError("sel must be an integer (K, k) block list")
    if sel_valid.dtype != torch.bool or sel_valid.shape != sel.shape:
        raise ValueError("sel_valid must be bool, the shape of sel")
    for t in (bm.mask, extra, sel, sel_valid, pose_inv):
        if t is not None and t.device != dev:
            raise ValueError("every input of a sweep must lie on the block map's device")
    return dev


# ---- the plain mirror of the kernels' passes ---------------------------------

def _local_points(bm, extra, sel, sel_valid, pose_inv):
    """(local xyz (K, k·cap, 3), live mask (K, k·cap), flat slot (K, k·cap)):
    every keyframe's selected slots in its own frame."""
    K, k = sel.shape
    cap = bm.mask.shape[1]
    m = bm.mask[sel] & sel_valid[..., None]
    if extra is not None:
        m = m & extra.reshape(bm.mask.shape)[sel]
    local = transform(bm.xyz[sel].reshape(K, k * cap, 3), pose_inv[:, None, :3, :3],
                      pose_inv[:, None, :3, 3])
    slots = sel[..., None] * cap + torch.arange(cap, device=sel.device)
    return local, m.reshape(K, -1), slots.reshape(K, -1)


def _stacked_min(pix, vals, n_pix: int, fill):
    """(images (K·n_pix,), offset pixel ids): one scatter-min of every
    keyframe's values into its own image at offset ``k·n_pix``."""
    K = pix.shape[0]
    off = pix + n_pix * torch.arange(K, device=pix.device)[:, None]
    img = torch.full((K * n_pix,), fill, dtype=vals.dtype, device=pix.device)
    img.scatter_reduce_(0, off.reshape(-1), vals.reshape(-1), "amin")
    return img, off


def _discrepancy_plain(bm, extra, sel, sel_valid, pose_inv, scans, scan_imgs, fov, shape,
                       diff_threshold, reverse, out):
    n_pix = shape[0] * shape[1]
    if scans is not None:                                   # (a)
        spix, srng = spherical_project(scans[0], fov, shape)
        scan_imgs = _stacked_min(spix, torch.where(scans[1], srng, torch.inf), n_pix,
                                 NO_POINT)[0]
    local, m, slots = _local_points(bm, extra, sel, sel_valid, pose_inv)
    pix, rng = spherical_project(local, fov, shape)
    map_imgs, off = _stacked_min(pix, torch.where(m, rng, torch.inf), n_pix, NO_POINT)  # (b)
    scan_imgs = scan_imgs.reshape(-1)
    diff = (map_imgs - scan_imgs) if reverse else (scan_imgs - map_imgs)
    flag = (diff > diff_threshold) & (diff < VALID_DIFF_UB)
    g = map_imgs[off]                                       # (c)
    dyn = m & (rng <= g) & flag[off] & (g > 0)
    out[slots[dyn]] = True


def _decode_stacked(img_p, proj_shape, shape, scale):
    """``projection._decode_winner_image`` of (K, n_pix_p) packed images
    into (K, n_pix) filter-resolution images, one scatter-min."""
    nrow_p, ncol_p = proj_shape
    nrow_s, ncol_s = shape
    pidx = torch.arange(nrow_p * ncol_p, device=img_p.device)
    wbase_r = torch.round((pidx // ncol_p).float() * (nrow_s / nrow_p)).long()
    wbase_c = torch.round((pidx % ncol_p).float() * (ncol_s / ncol_p)).long()
    img = img_p.long()
    wrow = torch.clamp(wbase_r + (img // 4) % 4 - 1, 0, nrow_s - 1)
    wcol = torch.clamp(wbase_c + img % 4 - 1, 0, ncol_s - 1)
    wrng = torch.where(img_p != _PACKED_SENTINEL, _div((img // 16).float(), scale), torch.inf)
    return _stacked_min(wrow * ncol_s + wcol, wrng, nrow_s * ncol_s, NO_POINT)[0]


def _winners_plain(bm, extra, sel, sel_valid, pose_inv, fov, shape, proj_shape, scale, out,
                   img_s):
    local, m, slots = _local_points(bm, extra, sel, sel_valid, pose_inv)
    packed, pix_p = _pack_points(local, m, fov, proj_shape, shape, scale)
    img_p, off = _stacked_min(pix_p, packed, proj_shape[0] * proj_shape[1],
                              _PACKED_SENTINEL)              # (1)
    win = m & (packed == img_p[off])                         # (2)
    out[slots[win]] = True
    img_s.copy_(_decode_stacked(img_p.reshape(sel.shape[0], -1), proj_shape, shape,
                                scale).reshape(img_s.shape))  # (3)


# ---- the kernels -------------------------------------------------------------

class _Pix(ctypes.Structure):
    """One resolution's pixel rule constants (``Pix`` in sweep.cu)."""

    _fields_ = [("recip_v", ctypes.c_double), ("nrow_f", ctypes.c_float),
                ("col_scale", ctypes.c_float), ("nrow", ctypes.c_int), ("ncol", ctypes.c_int)]


class _Args(ctypes.Structure):
    """A launch set's scalars (``SweepArgs`` in sweep.cu, checked on load)."""

    _fields_ = [("half_v", ctypes.c_double), ("half_h", ctypes.c_double),
                ("rad2deg", ctypes.c_double), ("img", _Pix), ("proj", _Pix),
                ("diff_threshold", ctypes.c_float), ("scale", ctypes.c_float),
                ("rratio", ctypes.c_float), ("cratio", ctypes.c_float),
                ("reverse", ctypes.c_int), ("n_kf", ctypes.c_int), ("k_sel", ctypes.c_int),
                ("cap", ctypes.c_int), ("n_scan", ctypes.c_int), ("n_blocks", ctypes.c_int)]


def _pix(fov, shape) -> _Pix:
    """The constants of ``projection._pix_rowcol`` at ``shape``, as the plain
    version rounds them (ctypes rounds a Python float to float32 as
    PyTorch casts a scalar)."""
    vfov, hfov = float(fov[0]), float(fov[1])
    nrow, ncol = shape
    return _Pix(float(_recip(vfov)), float(nrow), float(np.float32(ncol) * _recip(hfov)),
                nrow, ncol)


def _args(fov, shape, proj_shape=None, **kw) -> _Args:
    vfov, hfov = float(fov[0]), float(fov[1])
    a = _Args(half_v=vfov / 2.0, half_h=hfov / 2.0, rad2deg=_RAD2DEG, img=_pix(fov, shape),
              **kw)
    if proj_shape is not None:
        a.proj = _pix(fov, proj_shape)
        a.rratio = shape[0] / proj_shape[0]
        a.cratio = shape[1] / proj_shape[1]
    return a


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _raise_on(rc, what):
    if rc != 0:
        raise RuntimeError(f"sweep {what} launch failed: "
                           f"{_lib().ltm_sweep_error_string(rc).decode()} ({rc})")


def _ptr(x):
    return None if x is None else x.data_ptr()


def _lists(bm, extra, sel, sel_valid, pose_inv):
    """The kernels' view of a launch set's inputs: contiguous, int32 lists."""
    return (bm.xyz.contiguous(), bm.mask.contiguous(),
            None if extra is None else extra.contiguous(),
            sel.to(torch.int32).contiguous(), sel_valid.contiguous(), pose_inv.contiguous())


def _discrepancy_cuda(bm, extra, sel, sel_valid, pose_inv, scans, scan_imgs, fov, shape,
                      diff_threshold, reverse, out):
    K, k = sel.shape
    n_pix = shape[0] * shape[1]
    xyz, mask, extra, sel, sel_valid, pose_inv = _lists(bm, extra, sel, sel_valid, pose_inv)
    dev = xyz.device
    sx = sm = None
    n_scan = 0
    if scans is None:
        scan_imgs = scan_imgs.contiguous()
    else:                       # pass (a) fills the images (empty scans leave them NO_POINT)
        scan_imgs = torch.full((K, n_pix), NO_POINT, dtype=torch.float32, device=dev)
        n_scan = scans[0].shape[1]
        if n_scan:
            sx, sm = scans[0].contiguous(), scans[1].contiguous()
    map_imgs = torch.full((K, n_pix), NO_POINT, dtype=torch.float32, device=dev)
    a = _args(fov, shape, diff_threshold=diff_threshold, reverse=int(reverse), n_kf=K,
              k_sel=k, cap=mask.shape[1], n_scan=n_scan, n_blocks=mask.shape[0])
    with torch.cuda.device(dev):
        rc = _lib().ltm_sweep_discrepancy(xyz.data_ptr(), mask.data_ptr(), _ptr(extra),
                                          sel.data_ptr(), sel_valid.data_ptr(),
                                          pose_inv.data_ptr(), _ptr(sx), _ptr(sm),
                                          scan_imgs.data_ptr(), map_imgs.data_ptr(),
                                          out.data_ptr(), ctypes.byref(a), _stream())
    _raise_on(rc, "discrepancy")
    discrepancy_sweep.launches += 1


def _winners_cuda(bm, extra, sel, sel_valid, pose_inv, fov, shape, proj_shape, scale, out,
                  img_s):
    K, k = sel.shape
    xyz, mask, extra, sel, sel_valid, pose_inv = _lists(bm, extra, sel, sel_valid, pose_inv)
    img_p = torch.full((K, proj_shape[0] * proj_shape[1]), _PACKED_SENTINEL, dtype=torch.int32,
                       device=xyz.device)
    a = _args(fov, shape, proj_shape, scale=scale, n_kf=K, k_sel=k, cap=mask.shape[1],
              n_blocks=mask.shape[0])
    with torch.cuda.device(xyz.device):
        rc = _lib().ltm_sweep_winners(xyz.data_ptr(), mask.data_ptr(), _ptr(extra),
                                      sel.data_ptr(), sel_valid.data_ptr(), pose_inv.data_ptr(),
                                      img_p.data_ptr(), img_s.data_ptr(), out.data_ptr(),
                                      ctypes.byref(a), _stream())
    _raise_on(rc, "winners")
    winner_sweep.launches += 1


# ---- the wrappers ------------------------------------------------------------

def _chunks(K: int):
    return [(k0, min(K, k0 + MAX_KEYFRAMES)) for k0 in range(0, K, MAX_KEYFRAMES)]


def discrepancy_sweep(bm, extra, sel, sel_valid, pose_inv, fov, shape,
                      diff_threshold: float = 0.1, reverse: bool = False, scans=None,
                      scan_imgs=None) -> torch.Tensor:
    """K2: the (n_blocks, cap) OR over keyframes of the dynamic mask of
    each keyframe's listed blocks (``sel``/``sel_valid``, (K, k); padding
    entries invalid), restricted to ``extra`` (flat bool or None), against
    its scan image: ``scan_imgs`` (K, n_pix), or made from ``scans`` =
    (scans_xyz (K, S, 3), scans_mask (K, S)).  CUDA tensors launch K2 once
    a chunk of keyframes (``discrepancy_sweep.launches``); CPU tensors take
    the plain mirror."""
    dev = _check(bm, extra, sel, sel_valid, pose_inv)
    K = sel.shape[0]
    n_pix = shape[0] * shape[1]
    if (scans is None) == (scan_imgs is None):
        raise ValueError("give either the scans or their images")
    if scans is not None:
        sx, sm = scans
        if (sx.dtype != torch.float32 or sx.dim() != 3 or sx.shape[::2] != (K, 3)
                or sm.dtype != torch.bool or sm.shape != sx.shape[:2]
                or sx.device != dev or sm.device != dev):
            raise ValueError("scans must be float32 (K, S, 3) with a bool (K, S) mask")
    elif (scan_imgs.dtype != torch.float32 or scan_imgs.shape != (K, n_pix)
          or scan_imgs.device != dev):
        raise ValueError(f"scan_imgs must be float32 (K, {n_pix}) on {dev}")
    out = torch.zeros_like(bm.mask)
    if K == 0 or sel.shape[1] == 0:
        return out
    run = _discrepancy_cuda if dev.type == "cuda" else _discrepancy_plain
    flat = out.reshape(-1)
    for k0, k1 in _chunks(K):
        part = None if scans is None else (scans[0][k0:k1], scans[1][k0:k1])
        run(bm, extra, sel[k0:k1], sel_valid[k0:k1], pose_inv[k0:k1], part,
            None if scan_imgs is None else scan_imgs[k0:k1], fov, shape, diff_threshold,
            reverse, flat)
    return out


discrepancy_sweep.launches = 0   # launch sets of K2 (one a chunk of keyframes)


def winner_sweep(bm, extra, sel, sel_valid, pose_inv, fov, shape, proj_shape, scale: float):
    """K3: ((n_blocks, cap) OR over keyframes of the winner mask at
    ``proj_shape``, (K, n_pix) filter-resolution images of the winners)
    from one packed scatter-min a keyframe over its listed blocks.  CUDA
    tensors launch K3 once a chunk of keyframes
    (``winner_sweep.launches``); CPU tensors take the plain mirror."""
    dev = _check(bm, extra, sel, sel_valid, pose_inv)
    if shape[0] > proj_shape[0] or shape[1] > proj_shape[1]:
        raise ValueError(f"shape {shape} must be no finer than proj_shape {proj_shape}")
    K = sel.shape[0]
    out = torch.zeros_like(bm.mask)
    imgs = torch.full((K, shape[0] * shape[1]), NO_POINT, dtype=torch.float32, device=dev)
    if K == 0 or sel.shape[1] == 0:
        return out, imgs
    run = _winners_cuda if dev.type == "cuda" else _winners_plain
    flat = out.reshape(-1)
    for k0, k1 in _chunks(K):
        run(bm, extra, sel[k0:k1], sel_valid[k0:k1], pose_inv[k0:k1], fov, shape, proj_shape,
            scale, flat, imgs[k0:k1])
    return out, imgs


winner_sweep.launches = 0        # launch sets of K3 (one a chunk of keyframes)


# ---- blocks.py's sweeps through the kernels ----------------------------------

def block_sweep_discrepancy(bm, scans_xyz, scans_mask, pose_inv, poses, fov, shape,
                            k_blocks: int, max_range: float = 200.0,
                            diff_threshold: float = 0.1, reverse: bool = False):
    """``blocks.block_sweep_discrepancy`` through K2."""
    sel, val = select_blocks(bm, poses[:, :3, 3], max_range, k_blocks)
    return discrepancy_sweep(bm, None, sel, val, pose_inv, fov, shape, diff_threshold, reverse,
                             scans=(scans_xyz, scans_mask)).reshape(-1)


def block_sweep_discrepancy_vs_images(target_bm, target_extra, scan_imgs, pose_inv, poses, fov,
                                      shape, k_blocks: int, max_range: float = 200.0,
                                      diff_threshold: float = 0.1, reverse: bool = False):
    """``blocks.block_sweep_discrepancy_vs_images`` through K2: only blocks
    that hold a target point are selected."""
    occupied = target_bm.block_valid & torch.any(
        target_bm.mask & target_extra.reshape(target_bm.mask.shape), dim=1)
    sel, val = select_blocks(target_bm, poses[:, :3, 3], max_range, k_blocks, valid=occupied)
    return discrepancy_sweep(target_bm, target_extra, sel, val, pose_inv, fov, shape,
                             diff_threshold, reverse, scan_imgs=scan_imgs).reshape(-1)


def block_sweep_discrepancy_vs_images_presel(target_bm, target_extra, scan_imgs, pose_inv,
                                             sel_idx, sel_valid, fov, shape,
                                             diff_threshold: float = 0.1,
                                             reverse: bool = False):
    """``blocks.block_sweep_discrepancy_vs_images_presel`` through K2, on
    the given (K, k_sel) lists."""
    return discrepancy_sweep(target_bm, target_extra, sel_idx, sel_valid, pose_inv, fov, shape,
                             diff_threshold, reverse, scan_imgs=scan_imgs).reshape(-1)


def block_fused_visibility_images(source_bm, source_extra, pose_inv, poses, fov, shape,
                                  proj_shape, k_blocks: int, max_range: float, scale: float):
    """``blocks.block_fused_visibility_images`` through K3."""
    sel, val = select_blocks(source_bm, poses[:, :3, 3], max_range, k_blocks)
    win, imgs = winner_sweep(source_bm, source_extra, sel, val, pose_inv, fov, shape,
                             proj_shape, scale)
    return win.reshape(-1), imgs


def pixel_rule(xyz, pose_inv, fov, shape, proj_shape, scale: float):
    """The kernels' pixel rule alone on the card (a check, not a sweep):
    (pixel id at ``shape`` int64, range, packed value int32, pixel id at
    ``proj_shape`` int64) of every point of (N, 3) ``xyz`` through one
    (4, 4) ``pose_inv``, all points valid.  Its plain version is
    ``projection.spherical_project`` and ``projection._pack_points`` on
    ``projection.apply_pose``."""
    if not xyz.is_cuda or xyz.dtype != torch.float32 or xyz.dim() != 2 or xyz.shape[1] != 3:
        raise ValueError("pixel_rule takes float32 (N, 3) points on the card")
    if pose_inv.shape != (4, 4) or pose_inv.dtype != torch.float32 or pose_inv.device != xyz.device:
        raise ValueError("pixel_rule takes one float32 (4, 4) pose on the points' device")
    n = xyz.shape[0]
    if not 0 < n < 2**31:
        raise ValueError(f"pixel_rule takes 1 to 2^31 - 1 points, got {n}")
    xyz, pose_inv = xyz.contiguous(), pose_inv.contiguous()
    pix = torch.empty((n,), dtype=torch.int64, device=xyz.device)
    pix_p = torch.empty_like(pix)
    rng = torch.empty((n,), dtype=torch.float32, device=xyz.device)
    packed = torch.empty((n,), dtype=torch.int32, device=xyz.device)
    a = _args(fov, shape, proj_shape, scale=scale)
    with torch.cuda.device(xyz.device):
        rc = _lib().ltm_sweep_pixel_rule(xyz.data_ptr(), n, pose_inv.data_ptr(), pix.data_ptr(),
                                         rng.data_ptr(), packed.data_ptr(), pix_p.data_ptr(),
                                         ctypes.byref(a), _stream())
    _raise_on(rc, "pixel rule")
    return pix, rng, packed, pix_p


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from ltm_torch.kernels._build import load_kernel

    lib = load_kernel("sweep")
    p, i = ctypes.c_void_p, ctypes.c_int   # pointers as c_void_p: no 32-bit cut
    args = ctypes.POINTER(_Args)
    lib.ltm_sweep_args_size.restype = i
    lib.ltm_sweep_discrepancy.argtypes = [p] * 11 + [args, p]
    lib.ltm_sweep_discrepancy.restype = i
    lib.ltm_sweep_winners.argtypes = [p] * 9 + [args, p]
    lib.ltm_sweep_winners.restype = i
    lib.ltm_sweep_pixel_rule.argtypes = [p, i, p, p, p, p, p, args, p]
    lib.ltm_sweep_pixel_rule.restype = i
    lib.ltm_sweep_error_string.argtypes = [i]
    lib.ltm_sweep_error_string.restype = ctypes.c_char_p
    if lib.ltm_sweep_args_size() != ctypes.sizeof(_Args):
        raise RuntimeError(f"csrc/sweep.cu's SweepArgs has {lib.ltm_sweep_args_size()} bytes; "
                           f"the wrapper's _Args {ctypes.sizeof(_Args)}")
    return lib
