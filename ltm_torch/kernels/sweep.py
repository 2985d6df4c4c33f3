"""LT-removert's block visibility sweeps for all keyframes at once: the
wrappers of the hand-written CUDA kernels ``ltm_torch/csrc/sweep.cu`` and
their launch counts.

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

Each runs as one of two variants, chosen by the images' size before
launch (:func:`_cluster_plan`): the cluster variant (the default: one
kernel a launch set, a thread-block cluster a keyframe whose shared memory
holds the keyframe's images in row bands) or, for images larger than a
cluster can hold, the global variant (a kernel a pass, the images in
device memory).  Keyframes run in chunks of :data:`MAX_KEYFRAMES`, one
launch set a chunk.  The wrappers take CUDA tensors and launch a kernel or
raise: the CPU route and the card's reference are the per-keyframe loops
of ``ltm_torch.kernels.blocks`` (``*_plain``), which also chooses the
route.  The module builds and imports nothing when it is imported.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ltm_torch.kernels.projection import _RAD2DEG, NO_POINT, _PACKED_SENTINEL, _recip, _sqrt, sumsq3

__all__ = ["MAX_KEYFRAMES", "select_blocks", "discrepancy_sweep", "winner_sweep", "pixel_rule"]

MAX_KEYFRAMES = 64   # keyframes a launch set
_CLUSTERS = (4, 8)   # CTAs a keyframe's cluster
_SMEM_BYTES = 232_448   # dynamic shared memory a CTA may use (sm_90; kMaxSmem in sweep.cu)
_SMEM_HALF = 115_712   # half an SM's shared memory (228 KB, 1 KB a CTA reserved)


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


def _cluster_plan(images):
    """The cluster variant's layout of a keyframe's shared-memory images,
    ``[(nrow, ncol), ...]`` of 4-byte pixels, each cut into row bands, one
    band a CTA: (CTAs a cluster, rows a band of each image, shared-memory
    bytes a CTA), with the fewest CTAs of :data:`_CLUSTERS` whose bands
    take at most :data:`_SMEM_HALF`, else the fewest that fit
    :data:`_SMEM_BYTES` (a large image spreads its keyframe's work over
    more SMs); None where no cluster holds them (the global variant)."""
    for budget in (_SMEM_HALF, _SMEM_BYTES):
        for cs in _CLUSTERS:
            rows = tuple(-(-nrow // cs) for nrow, _ in images)
            smem = 4 * sum(r * ncol for r, (_, ncol) in zip(rows, images))
            if smem <= budget:
                return cs, rows, smem
    return None


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
                ("cap", ctypes.c_int), ("n_scan", ctypes.c_int), ("n_blocks", ctypes.c_int),
                ("cluster", ctypes.c_int), ("band_rows", ctypes.c_int),
                ("band_rows_p", ctypes.c_int)]


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


def _discrepancy_launch(bm, extra, sel, sel_valid, pose_inv, scans, scan_imgs, fov, shape,
                        diff_threshold, reverse, out):
    """One launch set of K2: the cluster variant where a cluster holds the
    images (forward sweeps hold two), else the global variant."""
    K, k = sel.shape
    n_pix = shape[0] * shape[1]
    xyz, mask, extra, sel, sel_valid, pose_inv = _lists(bm, extra, sel, sel_valid, pose_inv)
    dev = xyz.device
    sx = sm = None
    n_scan = 0 if scans is None else scans[0].shape[1]
    if n_scan:
        sx, sm = scans[0].contiguous(), scans[1].contiguous()
    if scans is None:
        scan_imgs = scan_imgs.contiguous()
    a = _args(fov, shape, diff_threshold=diff_threshold, reverse=int(reverse), n_kf=K,
              k_sel=k, cap=mask.shape[1], n_scan=n_scan, n_blocks=mask.shape[0])
    plan = _cluster_plan([shape] * (1 if scans is None else 2))
    lists = (xyz.data_ptr(), mask.data_ptr(), _ptr(extra), sel.data_ptr(), sel_valid.data_ptr(),
             pose_inv.data_ptr(), _ptr(sx), _ptr(sm))
    with torch.cuda.device(dev):
        if plan is not None:
            a.cluster, (a.band_rows, *_), _ = plan
            rc = _lib().ltm_sweep_discrepancy_cluster(*lists, _ptr(scan_imgs), out.data_ptr(),
                                                      ctypes.byref(a), _stream())
            _raise_on(rc, "discrepancy")
            discrepancy_sweep.launches += 1
            return
        if scans is not None:   # pass (a) fills the images (empty scans leave them NO_POINT)
            scan_imgs = torch.full((K, n_pix), NO_POINT, dtype=torch.float32, device=dev)
        map_imgs = torch.full((K, n_pix), NO_POINT, dtype=torch.float32, device=dev)
        rc = _lib().ltm_sweep_discrepancy_global(*lists, scan_imgs.data_ptr(),
                                                 map_imgs.data_ptr(), out.data_ptr(),
                                                 ctypes.byref(a), _stream())
    _raise_on(rc, "discrepancy (global)")
    discrepancy_sweep.global_launches += 1


def _winners_launch(bm, extra, sel, sel_valid, pose_inv, fov, shape, proj_shape, scale, out,
                    img_s):
    """One launch set of K3, the cluster variant where a cluster holds the
    packed image (the kernel writes the filter-resolution image whole in
    ``img_s``), else the global variant."""
    K, k = sel.shape
    xyz, mask, extra, sel, sel_valid, pose_inv = _lists(bm, extra, sel, sel_valid, pose_inv)
    a = _args(fov, shape, proj_shape, scale=scale, n_kf=K, k_sel=k, cap=mask.shape[1],
              n_blocks=mask.shape[0])
    plan = _cluster_plan([proj_shape])
    lists = (xyz.data_ptr(), mask.data_ptr(), _ptr(extra), sel.data_ptr(), sel_valid.data_ptr(),
             pose_inv.data_ptr())
    with torch.cuda.device(xyz.device):
        if plan is not None:
            a.cluster, (a.band_rows_p,), _ = plan
            a.band_rows = -(-shape[0] // a.cluster)
            rc = _lib().ltm_sweep_winners_cluster(*lists, img_s.data_ptr(), out.data_ptr(),
                                                  ctypes.byref(a), _stream())
            _raise_on(rc, "winners")
            winner_sweep.launches += 1
            return
        img_p = torch.full((K, proj_shape[0] * proj_shape[1]), _PACKED_SENTINEL,
                           dtype=torch.int32, device=xyz.device)
        img_s.fill_(NO_POINT)
        rc = _lib().ltm_sweep_winners_global(*lists, img_p.data_ptr(), img_s.data_ptr(),
                                             out.data_ptr(), ctypes.byref(a), _stream())
    _raise_on(rc, "winners (global)")
    winner_sweep.global_launches += 1


# ---- the wrappers ------------------------------------------------------------

def _chunks(K: int):
    return [(k0, min(K, k0 + MAX_KEYFRAMES)) for k0 in range(0, K, MAX_KEYFRAMES)]


def _on_card(dev):
    if dev.type != "cuda":
        raise RuntimeError(f"the sweep kernels take CUDA tensors, not {dev}: the CPU route is "
                           "ltm_torch.kernels.blocks' *_plain loops")


def discrepancy_sweep(bm, extra, sel, sel_valid, pose_inv, fov, shape,
                      diff_threshold: float = 0.1, reverse: bool = False, scans=None,
                      scan_imgs=None) -> torch.Tensor:
    """K2: the (n_blocks, cap) OR over keyframes of the dynamic mask of
    each keyframe's listed blocks (``sel``/``sel_valid``, (K, k); padding
    entries invalid), restricted to ``extra`` (flat bool or None), against
    its scan image: ``scan_imgs`` (K, n_pix), or made from ``scans`` =
    (scans_xyz (K, S, 3), scans_mask (K, S)).  One launch set a chunk of
    keyframes (``discrepancy_sweep.launches``, the cluster variant;
    ``.global_launches``, the global variant).  CUDA tensors only."""
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
    _on_card(dev)
    out = torch.zeros_like(bm.mask)
    if K == 0 or sel.shape[1] == 0:
        return out
    flat = out.reshape(-1)
    for k0, k1 in _chunks(K):
        part = None if scans is None else (scans[0][k0:k1], scans[1][k0:k1])
        _discrepancy_launch(bm, extra, sel[k0:k1], sel_valid[k0:k1], pose_inv[k0:k1], part,
                            None if scan_imgs is None else scan_imgs[k0:k1], fov, shape,
                            diff_threshold, reverse, flat)
    return out


discrepancy_sweep.launches = 0          # K2 launch sets, the cluster variant
discrepancy_sweep.global_launches = 0   # K2 launch sets, the global variant


def winner_sweep(bm, extra, sel, sel_valid, pose_inv, fov, shape, proj_shape, scale: float):
    """K3: ((n_blocks, cap) OR over keyframes of the winner mask at
    ``proj_shape``, (K, n_pix) filter-resolution images of the winners)
    from one packed scatter-min a keyframe over its listed blocks.  One
    launch set a chunk of keyframes (``winner_sweep.launches``, the cluster
    variant; ``.global_launches``, the global variant).  CUDA tensors
    only."""
    dev = _check(bm, extra, sel, sel_valid, pose_inv)
    if shape[0] > proj_shape[0] or shape[1] > proj_shape[1]:
        raise ValueError(f"shape {shape} must be no finer than proj_shape {proj_shape}")
    _on_card(dev)
    K = sel.shape[0]
    out = torch.zeros_like(bm.mask)
    imgs = torch.empty((K, shape[0] * shape[1]), dtype=torch.float32, device=dev)
    if K == 0 or sel.shape[1] == 0:
        return out, imgs.fill_(NO_POINT)
    flat = out.reshape(-1)
    for k0, k1 in _chunks(K):
        _winners_launch(bm, extra, sel[k0:k1], sel_valid[k0:k1], pose_inv[k0:k1], fov, shape,
                        proj_shape, scale, flat, imgs[k0:k1])
    return out, imgs


winner_sweep.launches = 0          # K3 launch sets, the cluster variant
winner_sweep.global_launches = 0   # K3 launch sets, the global variant


def cluster_occupancy(kernel: str, cluster: int, smem: int) -> int:
    """The clusters of ``cluster`` CTAs with ``smem`` bytes of shared
    memory each that the card holds at once, for ``kernel`` "k2" or "k3"
    (``cudaOccupancyMaxActiveClusters``; a launch set of more keyframes
    runs in waves)."""
    fits = ctypes.c_int(0)
    _raise_on(_lib().ltm_sweep_cluster_occupancy(("k2", "k3").index(kernel), cluster, smem,
                                                 ctypes.byref(fits)), "occupancy query")
    return fits.value


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
    lib.ltm_sweep_discrepancy_global.argtypes = [p] * 11 + [args, p]
    lib.ltm_sweep_discrepancy_global.restype = i
    lib.ltm_sweep_winners_global.argtypes = [p] * 9 + [args, p]
    lib.ltm_sweep_winners_global.restype = i
    lib.ltm_sweep_discrepancy_cluster.argtypes = [p] * 10 + [args, p]
    lib.ltm_sweep_discrepancy_cluster.restype = i
    lib.ltm_sweep_winners_cluster.argtypes = [p] * 8 + [args, p]
    lib.ltm_sweep_winners_cluster.restype = i
    lib.ltm_sweep_pixel_rule.argtypes = [p, i, p, p, p, p, p, args, p]
    lib.ltm_sweep_pixel_rule.restype = i
    lib.ltm_sweep_error_string.argtypes = [i]
    lib.ltm_sweep_error_string.restype = ctypes.c_char_p
    lib.ltm_sweep_max_smem.restype = i
    lib.ltm_sweep_cluster_occupancy.argtypes = [i, i, i, p]
    lib.ltm_sweep_cluster_occupancy.restype = i
    if lib.ltm_sweep_args_size() != ctypes.sizeof(_Args):
        raise RuntimeError(f"csrc/sweep.cu's SweepArgs has {lib.ltm_sweep_args_size()} bytes; "
                           f"the wrapper's _Args {ctypes.sizeof(_Args)}")
    if lib.ltm_sweep_max_smem() != _SMEM_BYTES:
        raise RuntimeError(f"csrc/sweep.cu's kMaxSmem is {lib.ltm_sweep_max_smem()}; the "
                           f"wrapper's _SMEM_BYTES {_SMEM_BYTES}")
    return lib
