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
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ltm_torch.kernels.projection import (
    _div,
    _sqrt,
    apply_pose,
    sumsq3,
    discrepancy_mask,
    discrepancy_vs_image,
    packed_winner_image,
)

__all__ = ["BlockMap", "build_block_map", "build_block_map_with_slots",
           "required_k_blocks_np", "block_sweep_discrepancy",
           "block_sweep_discrepancy_vs_images", "block_fused_visibility_images"]


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


def _select_blocks(bm: BlockMap, origin: torch.Tensor, max_range: float, k_blocks: int):
    """Indices of the k nearest blocks that intersect the range ball, and
    which of them are real.  ``topk``'s tie order is unspecified, but only
    the selected set matters: ``k_blocks`` covers every in-range block."""
    d = _norm3(bm.centers - origin) - bm.radius
    d = torch.where(bm.block_valid & (d <= max_range), d, torch.inf)
    vals, idx = torch.topk(d, k_blocks, largest=False)
    return idx, torch.isfinite(vals)


def block_sweep_discrepancy(bm: BlockMap, scans_xyz, scans_mask, pose_inv, poses,
                            fov, shape, k_blocks: int, max_range: float = 200.0,
                            diff_threshold: float = 0.1, reverse: bool = False):
    """Block-local ``sweep_discrepancy``; returns the flat
    (n_blocks*block_capacity,) dynamic mask over the blocked layout."""
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


def block_sweep_discrepancy_vs_images(target_bm: BlockMap, target_extra, scan_imgs,
                                      pose_inv, poses, fov, shape, k_blocks: int,
                                      max_range: float = 200.0,
                                      diff_threshold: float = 0.1, reverse: bool = False):
    """Target-side strong-weak filter sweep against precomputed source
    images.  Selection restricts to blocks CONTAINING target (delta) points
    — exact, since an empty block contributes nothing."""
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
    winner image.  Returns ``(win_union_flat, (K, nrow*ncol) images)``."""
    s_extra = source_extra.reshape(source_bm.num_blocks, source_bm.block_capacity)
    out = torch.zeros_like(source_bm.mask)
    imgs = []
    for Tinv, T in zip(pose_inv, poses):
        sel, sel_valid = _select_blocks(source_bm, T[:3, 3], max_range, k_blocks)
        work_xyz = source_bm.xyz[sel].reshape(-1, 3)
        work_mask = (source_bm.mask[sel] & s_extra[sel] & sel_valid[:, None]).reshape(-1)
        local = apply_pose(work_xyz, Tinv)
        win, img = packed_winner_image(local, work_mask, fov, proj_shape, shape, scale)
        out[sel] |= win.reshape(k_blocks, source_bm.block_capacity)
        imgs.append(img)
    return out.reshape(-1), torch.stack(imgs)
