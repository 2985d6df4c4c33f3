"""Block-structured global maps: the locality layer of the visibility sweeps
(port of ``ltm.kernels.blocks``).

The map is laid out once as fixed-size spatial blocks (points grouped
contiguously by coarse voxel + sub-cell Morton order).  Per keyframe only
the blocks that intersect an exact range bound are gathered, projected and
scattered back — the whole-map sweep's result, bit for bit, whenever the
bound is sound (see ``ltm.kernels.blocks`` for the exactness argument and
``ltm_torch.removert.pipeline`` for the per-sweep bounds).
``required_k_blocks_np`` sizes the block budget so no in-range block is
ever truncated.

The four sweeps of the default path (``block_sweep_discrepancy``,
``block_sweep_discrepancy_vs_images``, ``..._presel`` and
``block_fused_visibility_images``) choose their route here, once: on CUDA
tensors the hand-written kernels K2 and K3 (``ltm_torch.kernels.sweep``,
every keyframe's blocks chosen at once by ``sweep.select_blocks``), on CPU
tensors their plain versions, one loop iteration a keyframe
(``*_plain``), which are also the card's reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ltm_torch.kernels import sweep
from ltm_torch.kernels.occlusion import block_rect_and_rmin, build_range_pyramid, footprint_max
from ltm_torch.kernels.projection import (
    _PACKED_SENTINEL,
    _decode_winner_image,
    _div,
    _pack_points,
    _sqrt,
    apply_pose,
    sumsq3,
    discrepancy_mask,
    discrepancy_vs_image,
    packed_winner_image,
    range_image,
    winner_mask,
)

__all__ = ["BlockMap", "build_block_map", "build_block_map_with_slots",
           "required_k_blocks", "required_k_blocks_np", "block_sweep_discrepancy",
           "block_sweep_discrepancy_projected", "block_projected_scan_images",
           "block_sweep_visibility",
           "block_sweep_discrepancy_vs_images", "block_fused_visibility_images",
           "block_sweep_discrepancy_vs_images_presel",
           "block_fused_phase_a", "block_fused_phase_b", "block_sweep_discrepancy_plain",
           "block_sweep_discrepancy_vs_images_plain", "block_fused_visibility_images_plain",
           "block_sweep_discrepancy_vs_images_presel_plain"]


class BlockMap(NamedTuple):
    """Blocked global map (all tensors fixed-shape)."""

    xyz: torch.Tensor          # (n_blocks, block_capacity, 3)
    mask: torch.Tensor         # (n_blocks, block_capacity)
    centers: torch.Tensor      # (n_blocks, 3) — mean of member points
    radius: torch.Tensor       # (n_blocks,) — max member distance from center
    block_valid: torch.Tensor  # (n_blocks,)
    bmin: torch.Tensor         # (n_blocks, 3) — member AABB
    bmax: torch.Tensor

    @property
    def num_blocks(self) -> int:
        return self.xyz.shape[0]

    @property
    def block_capacity(self) -> int:
        return self.xyz.shape[1]

    def flat_xyz(self) -> torch.Tensor:
        return self.xyz.reshape(-1, 3)

    def flat_mask(self) -> torch.Tensor:
        return self.mask.reshape(-1)


def _norm3(v: torch.Tensor) -> torch.Tensor:
    return _sqrt(sumsq3(v))


def build_block_map_with_slots(xyz: torch.Tensor, mask: torch.Tensor, cell_size: float,
                               n_blocks: int, block_capacity: int):
    """Group points into spatially compact, fully packed blocks.  Returns
    ``(BlockMap, overflow_count, slots)`` — ``overflow_count > 0`` means
    capacity was insufficient and points were dropped; ``slots`` maps each
    input index to its flat position in the blocked layout
    (``n_blocks*block_capacity`` for dropped / invalid points)."""
    n = xyz.shape[0]
    dev = xyz.device
    coords = torch.floor(_div(xyz, cell_size)).int()
    # secondary key: Morton code of the 8x8x8 sub-cell position, so the
    # blocks a cell spills into are spatially compact runs
    sub_scale = torch.full((), 8.0, dtype=xyz.dtype, device=dev) / torch.full(
        (), cell_size, dtype=xyz.dtype, device=dev)
    sub = torch.clamp(torch.floor(xyz * sub_scale).int() - coords * 8, 0, 7)

    def _spread3(v):  # 3 bits -> every 3rd bit
        return (v & 1) | ((v & 2) << 2) | ((v & 4) << 4)

    morton = (_spread3(sub[:, 0]) << 2) | (_spread3(sub[:, 1]) << 1) | _spread3(sub[:, 2])
    # sort by (invalid, cx, cy, cz, morton): ltm lexsorts two int32 keys; one
    # stable sort on the int64 key (hi << 31) | lo gives the same order.
    # Cell coords rebase to the valid minimum and clamp at 15/16 bits.
    cmin = torch.where(mask[:, None], coords, 2**30).amin(0)
    cr = torch.clamp(coords - cmin, 0, (1 << 16) - 1).long()
    key_hi = (torch.where(mask, 0, 1 << 30)
              | (torch.clamp(cr[:, 0], max=(1 << 15) - 1) << 15)
              | torch.clamp(cr[:, 1], max=(1 << 15) - 1))
    key_lo = (cr[:, 2] << 9) | morton.long()
    order = torch.sort((key_hi << 31) | key_lo, stable=True).indices
    ms = mask[order]
    xs = xyz[order]

    # dense packing: valid points stream into fully packed capacity-sized
    # runs of the sorted order (exactness downstream uses only the blocks'
    # measured centers/radius/AABB, never the cell grid)
    msi = ms.long()
    rank = torch.cumsum(msi, 0) - msi
    block_id = rank // block_capacity
    slot = rank % block_capacity
    in_cap = block_id < n_blocks
    valid = ms & in_cap
    overflow = int((ms & ~in_cap).sum())

    n_flat = n_blocks * block_capacity
    flat_idx = torch.where(valid, block_id * block_capacity + slot, n_flat)
    # one spare row absorbs every dropped / invalid point, then is cut off
    out_xyz = torch.zeros((n_flat + 1, 3), dtype=xyz.dtype, device=dev)
    out_xyz[flat_idx] = xs
    out_mask = torch.zeros((n_flat + 1,), dtype=torch.bool, device=dev)
    out_mask[flat_idx] = valid
    bxyz = out_xyz[:-1].reshape(n_blocks, block_capacity, 3)
    bmask = out_mask[:-1].reshape(n_blocks, block_capacity)

    cnt = bmask.sum(1)
    centers = torch.where(bmask[..., None], bxyz, 0.0).sum(1) / torch.clamp(cnt, min=1)[:, None]
    d = _norm3(bxyz - centers[:, None, :])
    radius = torch.where(bmask, d, 0.0).amax(1)
    big = 3e38
    bmin = torch.where(bmask[..., None], bxyz, big).amin(1)
    bmax = torch.where(bmask[..., None], bxyz, -big).amax(1)
    block_valid = cnt > 0
    bmin = torch.where(block_valid[:, None], bmin, 0.0)
    bmax = torch.where(block_valid[:, None], bmax, 0.0)
    bm = BlockMap(bxyz, bmask, centers, radius, block_valid, bmin, bmax)
    slots = torch.empty((n,), dtype=torch.long, device=dev)
    slots[order] = flat_idx
    return bm, overflow, slots


def build_block_map(xyz, mask, cell_size: float, n_blocks: int, block_capacity: int):
    """(BlockMap, overflow_count) — see ``build_block_map_with_slots``."""
    bm, overflow, _ = build_block_map_with_slots(xyz, mask, cell_size, n_blocks, block_capacity)
    return bm, overflow


def required_k_blocks_np(centers: np.ndarray, radius: np.ndarray,
                         valid: np.ndarray, origins: np.ndarray,
                         max_range: float, round_to: int = 128) -> int:
    """Smallest exact ``k_blocks`` for a set of viewpoints (host NumPy): the
    max over origins of the number of valid blocks whose bounding ball
    intersects the ``max_range`` ball, rounded up to ``round_to`` and
    clamped to the number of blocks."""
    origins = np.asarray(origins).reshape(-1, 3)
    d = np.linalg.norm(centers[None] - origins[:, None], axis=-1) - radius[None]
    need = int(((d <= max_range) & valid[None]).sum(axis=1).max(initial=0))
    need = ((need + round_to - 1) // round_to) * round_to
    return int(min(max(need, round_to), centers.shape[0]))


def required_k_blocks(bm: BlockMap, origins: np.ndarray, max_range: float,
                      round_to: int = 128) -> int:
    """:func:`required_k_blocks_np` on a block map's (host-fetched)
    centers, radii and validity."""
    return required_k_blocks_np(bm.centers.cpu().numpy(), bm.radius.cpu().numpy(),
                                bm.block_valid.cpu().numpy(), origins, max_range, round_to)


def _select_blocks(bm: BlockMap, origin: torch.Tensor, max_range: float, k_blocks: int):
    """Indices of the k nearest blocks that intersect the range ball, and
    which of them are real.  ``topk``'s tie order is unspecified, but only
    the selected set matters: ``k_blocks`` covers every in-range block."""
    d = _norm3(bm.centers - origin) - bm.radius
    d = torch.where(bm.block_valid & (d <= max_range), d, torch.inf)
    vals, idx = torch.topk(d, k_blocks, largest=False)
    return idx, torch.isfinite(vals)


def _plain(bm: BlockMap) -> bool:
    """The one choice of a sweep's route: CPU tensors take its plain
    version, any other its kernel (``sweep`` raises on a device other than
    CUDA)."""
    return bm.xyz.device.type == "cpu"


def block_sweep_discrepancy(bm: BlockMap, scans_xyz, scans_mask, pose_inv, poses,
                            fov, shape, k_blocks: int, max_range: float = 200.0,
                            diff_threshold: float = 0.1, reverse: bool = False):
    """Block-local ``sweep_discrepancy``; returns the flat
    (n_blocks*block_capacity,) dynamic mask over the blocked layout.  K2 on
    CUDA tensors, :func:`block_sweep_discrepancy_plain` on CPU tensors."""
    if _plain(bm):
        return block_sweep_discrepancy_plain(bm, scans_xyz, scans_mask, pose_inv, poses, fov,
                                             shape, k_blocks, max_range, diff_threshold, reverse)
    sel, val = sweep.select_blocks(bm, poses[:, :3, 3], max_range, k_blocks)
    return sweep.discrepancy_sweep(bm, None, sel, val, pose_inv, fov, shape, diff_threshold,
                                   reverse, scans=(scans_xyz, scans_mask)).reshape(-1)


def block_sweep_discrepancy_plain(bm: BlockMap, scans_xyz, scans_mask, pose_inv, poses,
                                  fov, shape, k_blocks: int, max_range: float = 200.0,
                                  diff_threshold: float = 0.1, reverse: bool = False):
    """The plain version of :func:`block_sweep_discrepancy`, on either
    device: one ``discrepancy_mask`` a keyframe over its selected blocks."""
    out = torch.zeros_like(bm.mask)
    for scan_xyz, scan_mask, Tinv, T in zip(scans_xyz, scans_mask, pose_inv, poses):
        sel, sel_valid = _select_blocks(bm, T[:3, 3], max_range, k_blocks)
        work_xyz = bm.xyz[sel].reshape(-1, 3)
        work_mask = (bm.mask[sel] & sel_valid[:, None]).reshape(-1)
        local = apply_pose(work_xyz, Tinv)
        dyn = discrepancy_mask(local, work_mask, scan_xyz, scan_mask, fov, shape,
                               diff_threshold, reverse)
        out[sel] |= dyn.reshape(k_blocks, bm.block_capacity)
    return out.reshape(-1)


def _selected(bm: BlockMap, extra, sel, sel_valid):
    """(global xyz (k·cap, 3), mask (k·cap,)) of the selected blocks' slots,
    restricted to ``extra`` ((n_blocks, cap) or None)."""
    mask = bm.mask[sel] & sel_valid[:, None]
    if extra is not None:
        mask = mask & extra[sel]
    return bm.xyz[sel].reshape(-1, 3), mask.reshape(-1)


def block_sweep_discrepancy_projected(target_bm: BlockMap, target_extra, source_bm: BlockMap,
                                      source_extra, pose_inv, poses, fov, shape, proj_shape,
                                      k_blocks: int, max_range: float = 200.0,
                                      diff_threshold: float = 0.1, reverse: bool = False):
    """Block-local ``sweep_discrepancy_projected`` (the ND/PD strong-weak
    core): per keyframe the target's and the source's in-range blocks; the
    source's winners at ``proj_shape`` form the projected scan."""
    cap = target_bm.block_capacity
    t_extra = target_extra.reshape(target_bm.num_blocks, cap)
    s_extra = source_extra.reshape(source_bm.num_blocks, source_bm.block_capacity)
    out = torch.zeros_like(target_bm.mask)
    for Tinv, T in zip(pose_inv, poses):
        tsel, tval = _select_blocks(target_bm, T[:3, 3], max_range, k_blocks)
        ssel, sval = _select_blocks(source_bm, T[:3, 3], max_range, k_blocks)
        t_xyz, t_mask = _selected(target_bm, t_extra, tsel, tval)
        s_xyz, s_mask = _selected(source_bm, s_extra, ssel, sval)
        t_local = apply_pose(t_xyz, Tinv)
        s_local = apply_pose(s_xyz, Tinv)
        swin = winner_mask(s_local, s_mask, fov, proj_shape)[0]
        dyn = discrepancy_mask(t_local, t_mask, s_local, swin, fov, shape, diff_threshold, reverse)
        out[tsel] |= dyn.reshape(k_blocks, cap)
    return out.reshape(-1)


def block_projected_scan_images(source_bm: BlockMap, source_extra, pose_inv, poses, fov, shape,
                                proj_shape, k_blocks: int, max_range: float = 200.0):
    """Block-local ``projected_scan_images``: (K, nrow*ncol) images of the
    projected scans, with the block selection of
    :func:`block_sweep_discrepancy_projected`."""
    s_extra = source_extra.reshape(source_bm.num_blocks, source_bm.block_capacity)
    imgs = [source_bm.xyz.new_empty((0, shape[0] * shape[1]))]
    for Tinv, T in zip(pose_inv, poses):
        s_xyz, s_mask = _selected(source_bm, s_extra,
                                  *_select_blocks(source_bm, T[:3, 3], max_range, k_blocks))
        s_local = apply_pose(s_xyz, Tinv)
        swin = winner_mask(s_local, s_mask, fov, proj_shape)[0]
        imgs.append(range_image(s_local, swin, fov, shape)[None])
    return torch.cat(imgs)


def block_sweep_visibility(bm: BlockMap, extra_mask, pose_inv, poses, fov, shape, k_blocks: int,
                           max_range: float = 200.0):
    """Block-local ``sweep_visibility`` over the subset ``extra_mask``."""
    cap = bm.block_capacity
    emask = extra_mask.reshape(bm.num_blocks, cap)
    out = torch.zeros_like(bm.mask)
    for Tinv, T in zip(pose_inv, poses):
        sel, sel_valid = _select_blocks(bm, T[:3, 3], max_range, k_blocks)
        xyz, mask = _selected(bm, emask, sel, sel_valid)
        win = winner_mask(apply_pose(xyz, Tinv), mask, fov, shape)[0]
        out[sel] |= win.reshape(k_blocks, cap)
    return out.reshape(-1)


def block_sweep_discrepancy_vs_images(target_bm: BlockMap, target_extra, scan_imgs,
                                      pose_inv, poses, fov, shape, k_blocks: int,
                                      max_range: float = 200.0,
                                      diff_threshold: float = 0.1, reverse: bool = False):
    """Target-side strong-weak filter sweep against precomputed source
    images.  Selection restricts to blocks CONTAINING target (delta) points
    — exact, since an empty block contributes nothing.  K2 on CUDA tensors,
    :func:`block_sweep_discrepancy_vs_images_plain` on CPU tensors."""
    if _plain(target_bm):
        return block_sweep_discrepancy_vs_images_plain(target_bm, target_extra, scan_imgs,
                                                       pose_inv, poses, fov, shape, k_blocks,
                                                       max_range, diff_threshold, reverse)
    occupied = target_bm.block_valid & torch.any(
        target_bm.mask & target_extra.reshape(target_bm.mask.shape), dim=1)
    sel, val = sweep.select_blocks(target_bm, poses[:, :3, 3], max_range, k_blocks,
                                   valid=occupied)
    return sweep.discrepancy_sweep(target_bm, target_extra, sel, val, pose_inv, fov, shape,
                                   diff_threshold, reverse, scan_imgs=scan_imgs).reshape(-1)


def block_sweep_discrepancy_vs_images_plain(target_bm: BlockMap, target_extra, scan_imgs,
                                            pose_inv, poses, fov, shape, k_blocks: int,
                                            max_range: float = 200.0,
                                            diff_threshold: float = 0.1,
                                            reverse: bool = False):
    """The plain version of :func:`block_sweep_discrepancy_vs_images`, one
    ``discrepancy_vs_image`` a keyframe."""
    t_extra = target_extra.reshape(target_bm.num_blocks, target_bm.block_capacity)
    occupied = target_bm.block_valid & torch.any(target_bm.mask & t_extra, dim=1)
    sel_bm = target_bm._replace(block_valid=occupied)
    out = torch.zeros_like(target_bm.mask)
    for Tinv, T, img in zip(pose_inv, poses, scan_imgs):
        tsel, tval = _select_blocks(sel_bm, T[:3, 3], max_range, k_blocks)
        t_xyz = target_bm.xyz[tsel].reshape(-1, 3)
        t_mask = (target_bm.mask[tsel] & t_extra[tsel] & tval[:, None]).reshape(-1)
        t_local = apply_pose(t_xyz, Tinv)
        dyn = discrepancy_vs_image(t_local, t_mask, img, fov, shape, diff_threshold, reverse)
        out[tsel] |= dyn.reshape(k_blocks, target_bm.block_capacity)
    return out.reshape(-1)


def block_fused_visibility_images(source_bm: BlockMap, source_extra, pose_inv, poses,
                                  fov, shape, proj_shape, k_blocks: int,
                                  max_range: float, scale: float):
    """Block-local fused winner pass: per keyframe ONE packed scatter-min
    yields both the winner (visibility) mask and the filter-resolution
    winner image.  Returns ``(win_union_flat, (K, nrow*ncol) images)``.
    K3 on CUDA tensors, :func:`block_fused_visibility_images_plain` on CPU
    tensors."""
    if _plain(source_bm):
        return block_fused_visibility_images_plain(source_bm, source_extra, pose_inv, poses, fov,
                                                   shape, proj_shape, k_blocks, max_range, scale)
    sel, val = sweep.select_blocks(source_bm, poses[:, :3, 3], max_range, k_blocks)
    win, imgs = sweep.winner_sweep(source_bm, source_extra, sel, val, pose_inv, fov, shape,
                                   proj_shape, scale)
    return win.reshape(-1), imgs


def block_fused_visibility_images_plain(source_bm: BlockMap, source_extra, pose_inv, poses,
                                        fov, shape, proj_shape, k_blocks: int,
                                        max_range: float, scale: float):
    """The plain version of :func:`block_fused_visibility_images`, one
    ``packed_winner_image`` a keyframe (K = 0 gives (0, nrow*ncol) images)."""
    s_extra = source_extra.reshape(source_bm.num_blocks, source_bm.block_capacity)
    out = torch.zeros_like(source_bm.mask)
    imgs = [source_bm.xyz.new_empty((0, shape[0] * shape[1]))]
    for Tinv, T in zip(pose_inv, poses):
        sel, sel_valid = _select_blocks(source_bm, T[:3, 3], max_range, k_blocks)
        work_xyz = source_bm.xyz[sel].reshape(-1, 3)
        work_mask = (source_bm.mask[sel] & s_extra[sel] & sel_valid[:, None]).reshape(-1)
        local = apply_pose(work_xyz, Tinv)
        win, img = packed_winner_image(local, work_mask, fov, proj_shape, shape, scale)
        out[sel] |= win.reshape(k_blocks, source_bm.block_capacity)
        imgs.append(img[None])
    return out.reshape(-1), torch.cat(imgs)


def _spare_row(mask: torch.Tensor) -> torch.Tensor:
    """A zero (n_blocks + 1, cap) OR target: the padding entries of a
    precomputed block list repeat block 0, so their (all-False) rows are
    sent to the spare last row instead, and no index repeats elsewhere."""
    return torch.zeros((mask.shape[0] + 1, mask.shape[1]), dtype=torch.bool, device=mask.device)


def block_sweep_discrepancy_vs_images_presel(target_bm: BlockMap, target_extra, scan_imgs,
                                             pose_inv, sel_idx, sel_valid, fov, shape,
                                             diff_threshold: float = 0.1,
                                             reverse: bool = False):
    """``block_sweep_discrepancy_vs_images`` with the per-keyframe block
    lists chosen outside (occlusion culling, ``ltm_torch.kernels.occlusion``)
    instead of the in-loop range-ball top-k: ``sel_idx``/``sel_valid`` are
    (K, k_sel).  Exactness is the caller's contract: every block that could
    flag a point for keyframe k is in ``sel_idx[k]``.  With images of the
    actual scans it is also the culled forward (high-dynamic) sweep.  K2 on
    CUDA tensors, :func:`block_sweep_discrepancy_vs_images_presel_plain` on
    CPU tensors."""
    if _plain(target_bm):
        return block_sweep_discrepancy_vs_images_presel_plain(
            target_bm, target_extra, scan_imgs, pose_inv, sel_idx, sel_valid, fov, shape,
            diff_threshold, reverse)
    return sweep.discrepancy_sweep(target_bm, target_extra, sel_idx, sel_valid, pose_inv, fov,
                                   shape, diff_threshold, reverse,
                                   scan_imgs=scan_imgs).reshape(-1)


def block_sweep_discrepancy_vs_images_presel_plain(target_bm: BlockMap, target_extra,
                                                   scan_imgs, pose_inv, sel_idx, sel_valid,
                                                   fov, shape, diff_threshold: float = 0.1,
                                                   reverse: bool = False):
    """The plain version of
    :func:`block_sweep_discrepancy_vs_images_presel`, one
    ``discrepancy_vs_image`` a keyframe."""
    nb, cap = target_bm.num_blocks, target_bm.block_capacity
    t_extra = target_extra.reshape(nb, cap)
    out = _spare_row(target_bm.mask)
    for Tinv, img, tsel, tval in zip(pose_inv, scan_imgs, sel_idx, sel_valid):
        t_xyz = target_bm.xyz[tsel].reshape(-1, 3)
        t_mask = (target_bm.mask[tsel] & t_extra[tsel] & tval[:, None]).reshape(-1)
        t_local = apply_pose(t_xyz, Tinv)
        dyn = discrepancy_vs_image(t_local, t_mask, img, fov, shape, diff_threshold, reverse)
        out[torch.where(tval, tsel, nb)] |= dyn.reshape(-1, cap)
    return out[:nb].reshape(-1)


def block_fused_phase_a(source_bm: BlockMap, source_extra, pose_inv, poses, fov, shape,
                        proj_shape, k_near: int, r_near: float, scale: float):
    """Phase A of the occlusion-culled fused winner pass: per keyframe,
    scatter only the blocks within ``r_near`` into the packed
    proj-resolution image, then test every other occupied block's footprint
    against that provisional image.  Returns ``(sel_a (K, k_near),
    sel_a_valid, packed_imgs (K, n_pix_p), survive (K, n_blocks))``:
    survivors are the far blocks that might still win a pixel; culled ones
    can neither win nor displace a pixel minimum.  ``k_near`` must be
    ``required_k_blocks_np``-sized for ``r_near``."""
    cap = source_bm.block_capacity
    s_extra = source_extra.reshape(source_bm.num_blocks, cap)
    occupied = source_bm.block_valid & torch.any(source_bm.mask & s_extra, dim=1)
    n_pix_p = proj_shape[0] * proj_shape[1]
    r_near_t = torch.tensor(r_near, dtype=torch.float32, device=source_bm.xyz.device)
    slack = torch.tensor(2.0 / scale, dtype=torch.float32, device=source_bm.xyz.device)
    sels, vals, imgs, survs = [], [], [], []
    if pose_inv.shape[0] == 0:     # ltm's empty scan: (0, k_near), (0, n_pix_p), (0, n_blocks)
        dev = source_bm.xyz.device
        return (torch.zeros((0, k_near), dtype=torch.long, device=dev),
                torch.zeros((0, k_near), dtype=torch.bool, device=dev),
                torch.zeros((0, n_pix_p), dtype=torch.int32, device=dev),
                torch.zeros((0, source_bm.num_blocks), dtype=torch.bool, device=dev))
    for Tinv, T in zip(pose_inv, poses):
        origin = T[:3, 3]
        sel, sel_valid = _select_blocks(source_bm, origin, r_near, k_near)
        work_xyz = source_bm.xyz[sel].reshape(-1, 3)
        work_mask = (source_bm.mask[sel] & s_extra[sel] & sel_valid[:, None]).reshape(-1)
        local = apply_pose(work_xyz, Tinv)
        packed, pix_p = _pack_points(local, work_mask, fov, proj_shape, shape, scale)
        img_p = torch.full((n_pix_p,), _PACKED_SENTINEL, dtype=torch.int32, device=local.device)
        img_p.scatter_reduce_(0, pix_p, packed, "amin")
        # provisional effective-range image: empty pixels are +inf (any point
        # would win there), else the winner's decoded range
        eff = torch.where(img_p == _PACKED_SENTINEL, torch.inf, _div((img_p // 16).float(), scale))
        pyr = build_range_pyramid(eff, proj_shape)
        r0, r1, c0, width, r_min = block_rect_and_rmin(source_bm.bmin, source_bm.bmax, Tinv,
                                                       fov, proj_shape)
        fmax = footprint_max(pyr, r0, r1, c0, width, proj_shape)
        near = (_norm3(source_bm.centers - origin) - source_bm.radius) <= r_near_t
        # 2/scale guards the fixed-point rounding of the decoded pixel range
        survs.append(occupied & ~near & (r_min <= fmax + slack))
        sels.append(sel)
        vals.append(sel_valid)
        imgs.append(img_p)
    return torch.stack(sels), torch.stack(vals), torch.stack(imgs), torch.stack(survs)


def block_fused_phase_b(source_bm: BlockMap, source_extra, pose_inv, packed_imgs, sel_b,
                        sel_b_valid, sel_ab, sel_ab_valid, fov, shape, proj_shape,
                        scale: float):
    """Phase B: scatter the surviving far blocks into phase A's provisional
    packed images, then winner-test every processed block (near and
    survivors) against the final image and decode the filter-resolution
    winner images.  Returns ``(win_union_flat, (K, nrow*ncol) images)``,
    bit-identical to ``block_fused_visibility_images`` over the full range
    bound."""
    nb, cap = source_bm.num_blocks, source_bm.block_capacity
    s_extra = source_extra.reshape(nb, cap)
    out = _spare_row(source_bm.mask)
    imgs = [source_bm.xyz.new_empty((0, shape[0] * shape[1]))]   # K = 0 gives (0, n_pix)
    for Tinv, img_p, bsel, bval, absel, abval in zip(pose_inv, packed_imgs, sel_b, sel_b_valid,
                                                     sel_ab, sel_ab_valid):
        # far survivors: one more packed scatter-min into the provisional image
        b_xyz = source_bm.xyz[bsel].reshape(-1, 3)
        b_mask = (source_bm.mask[bsel] & s_extra[bsel] & bval[:, None]).reshape(-1)
        b_packed, b_pix = _pack_points(apply_pose(b_xyz, Tinv), b_mask, fov, proj_shape,
                                       shape, scale)
        img_p = img_p.clone().scatter_reduce_(0, b_pix, b_packed, "amin")
        # winner test of every processed block against the final image
        a_xyz = source_bm.xyz[absel].reshape(-1, 3)
        a_mask = (source_bm.mask[absel] & s_extra[absel] & abval[:, None]).reshape(-1)
        a_packed, a_pix = _pack_points(apply_pose(a_xyz, Tinv), a_mask, fov, proj_shape,
                                       shape, scale)
        win = a_mask & (a_packed == img_p[a_pix])
        out[torch.where(abval, absel, nb)] |= win.reshape(-1, cap)
        imgs.append(_decode_winner_image(img_p, proj_shape, shape, scale)[None])
    return out[:nb].reshape(-1), torch.cat(imgs)
