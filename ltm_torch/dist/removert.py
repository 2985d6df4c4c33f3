"""Keyframe- and chunk-sharded LT-removert sweeps and kNN (port of
``ltm.dist.removert``).

These put the ``Removerter`` driver on a mesh of device slots
(``ltm_torch.dist.mesh``; the reference parallelizes the same loops with
OpenMP, ``ltremovert/src/Session.cpp:408,491``).  Each function shards one
embarrassingly parallel axis, keyframes for the sweeps and Morton chunks
for the kNN, runs the one-device function on each slot's shard and
combines with one collective: OR for the masks, concatenation for image
stacks and kNN rows.  Every result equals the one-device function's bit
for bit (the same per-keyframe and per-chunk work; OR and concatenation
are exact).

Padding to a multiple of ``mesh.size``: the block sweeps pad with FAR
poses (a viewpoint 1e9 m away, whose range-gated block selection is
empty, so a padded keyframe contributes nothing); the whole-map sweeps
with validity flags (a slot runs only its real keyframes; a padded
keyframe's image is ``NO_POINT``); the kNN with all-invalid chunks, whose
rows are 1e30 and whose overflow is 0, and which launch nothing.  Image
stacks stay on the device, concatenated on the caller's.
"""

from __future__ import annotations

import torch

from ltm_torch.dist.mesh import Mesh, concat, local_shards, pad_to_multiple, reduce_or
from ltm_torch.dist.sharding import kf_valid_shards
from ltm_torch.kernels import chunk_knn as ck
from ltm_torch.kernels.blocks import (
    BlockMap,
    block_fused_visibility_images,
    block_projected_scan_images,
    block_sweep_discrepancy,
    block_sweep_discrepancy_vs_images,
    block_sweep_visibility,
)
from ltm_torch.kernels.projection import (
    NO_POINT,
    fused_visibility_images,
    projected_scan_images,
    sweep_discrepancy_vs_images,
    sweep_visibility,
)

__all__ = [
    "block_sweep_discrepancy_sharded",
    "block_sweep_visibility_sharded",
    "block_projected_scan_images_sharded",
    "block_fused_visibility_images_sharded",
    "block_sweep_discrepancy_vs_images_sharded",
    "sweep_visibility_sharded",
    "projected_scan_images_sharded",
    "fused_visibility_images_sharded",
    "sweep_discrepancy_vs_images_sharded",
    "chunk_knn_sqdists_sharded",
]

_FAR = 1.0e9


def _pad_poses_far(pose_inv: torch.Tensor, poses: torch.Tensor, multiple: int):
    """Pad the keyframe pose stacks with a viewpoint 1e9 m away: every
    range-gated block selection then comes back empty for a padded
    keyframe."""
    pad = (-poses.shape[0]) % multiple
    if pad == 0:
        return pose_inv, poses
    far = torch.eye(4, dtype=poses.dtype, device=poses.device)
    far_inv = far.clone()
    far[:3, 3] = _FAR
    far_inv[:3, 3] = -_FAR
    return (torch.cat([pose_inv, far_inv.expand(pad, 4, 4)]),
            torch.cat([poses, far.expand(pad, 4, 4)]))


def _pad_kf_axis(t: torch.Tensor, multiple: int, fill=0) -> torch.Tensor:
    return pad_to_multiple(t, multiple, 0, fill)


def _bm_to(bm: BlockMap, device) -> BlockMap:
    return BlockMap(*(t.to(device) for t in bm))


def _block_shards(mesh: Mesh, pose_inv, poses):
    """(slot device, its shard of the far-padded (pose_inv, poses), start,
    stop) for this process's slots."""
    pinv, po = _pad_poses_far(pose_inv, poses, mesh.size)
    return [(d, pinv[a:b].to(d), po[a:b].to(d), a, b)
            for d, a, b in local_shards(mesh, pinv.shape[0])]


def block_sweep_discrepancy_sharded(mesh: Mesh, bm: BlockMap, scans_xyz, scans_mask, pose_inv,
                                    poses, fov, shape, k_blocks: int, max_range: float,
                                    diff_threshold: float = 0.1, reverse: bool = False):
    """Keyframe-sharded :func:`ltm_torch.kernels.blocks.block_sweep_discrepancy`."""
    sx = _pad_kf_axis(scans_xyz, mesh.size)
    sm = _pad_kf_axis(scans_mask, mesh.size, fill=False)
    parts = [block_sweep_discrepancy(_bm_to(bm, d), sx[a:b].to(d), sm[a:b].to(d), pi, po, fov,
                                     shape, k_blocks=k_blocks, max_range=max_range,
                                     diff_threshold=diff_threshold, reverse=reverse)
             for d, pi, po, a, b in _block_shards(mesh, pose_inv, poses)]
    return reduce_or(mesh, parts, bm.xyz.device)


def block_sweep_visibility_sharded(mesh: Mesh, bm: BlockMap, extra_mask, pose_inv, poses, fov,
                                   shape, k_blocks: int, max_range: float):
    """Keyframe-sharded :func:`ltm_torch.kernels.blocks.block_sweep_visibility`."""
    parts = [block_sweep_visibility(_bm_to(bm, d), extra_mask.to(d), pi, po, fov, shape,
                                    k_blocks=k_blocks, max_range=max_range)
             for d, pi, po, _, _ in _block_shards(mesh, pose_inv, poses)]
    return reduce_or(mesh, parts, bm.xyz.device)


def block_projected_scan_images_sharded(mesh: Mesh, source_bm: BlockMap, source_extra, pose_inv,
                                        poses, fov, shape, proj_shape, k_blocks: int,
                                        max_range: float):
    """Keyframe-sharded :func:`block_projected_scan_images`: the (K, n_pix)
    images, concatenated on the caller's device (padded keyframes' images
    cut off)."""
    parts = [block_projected_scan_images(_bm_to(source_bm, d), source_extra.to(d), pi, po, fov,
                                         shape, proj_shape, k_blocks=k_blocks,
                                         max_range=max_range)
             for d, pi, po, _, _ in _block_shards(mesh, pose_inv, poses)]
    return concat(mesh, parts, source_bm.xyz.device)[:poses.shape[0]]


def block_fused_visibility_images_sharded(mesh: Mesh, source_bm: BlockMap, source_extra,
                                          pose_inv, poses, fov, shape, proj_shape,
                                          k_blocks: int, max_range: float, scale: float):
    """Keyframe-sharded :func:`block_fused_visibility_images`: the OR of the
    winner unions and the (K, n_pix) images."""
    wins, imgs = zip(*[block_fused_visibility_images(
        _bm_to(source_bm, d), source_extra.to(d), pi, po, fov, shape, proj_shape,
        k_blocks=k_blocks, max_range=max_range, scale=scale)
        for d, pi, po, _, _ in _block_shards(mesh, pose_inv, poses)])
    dev = source_bm.xyz.device
    return reduce_or(mesh, wins, dev), concat(mesh, imgs, dev)[:poses.shape[0]]


def block_sweep_discrepancy_vs_images_sharded(mesh: Mesh, target_bm: BlockMap, target_extra,
                                              scan_imgs, pose_inv, poses, fov, shape,
                                              k_blocks: int, max_range: float,
                                              diff_threshold: float = 0.1,
                                              reverse: bool = False):
    """Keyframe-sharded :func:`block_sweep_discrepancy_vs_images` (padded
    keyframes carry far poses and ``NO_POINT`` images)."""
    imgs = _pad_kf_axis(scan_imgs, mesh.size, fill=NO_POINT)
    parts = [block_sweep_discrepancy_vs_images(
        _bm_to(target_bm, d), target_extra.to(d), imgs[a:b].to(d), pi, po, fov, shape,
        k_blocks=k_blocks, max_range=max_range, diff_threshold=diff_threshold, reverse=reverse)
        for d, pi, po, a, b in _block_shards(mesh, pose_inv, poses)]
    return reduce_or(mesh, parts, target_bm.xyz.device)


# ---- whole-map variants: padded keyframes carry validity flags, because a
# far or identity pose still projects the whole map somewhere ---------------

def sweep_visibility_sharded(mesh: Mesh, map_xyz, map_mask, pose_inv, fov, shape):
    """Keyframe-sharded :func:`ltm_torch.kernels.projection.sweep_visibility`."""
    dev = map_xyz.device
    parts = [sweep_visibility(map_xyz.to(d), map_mask.to(d), pose_inv[ks].to(d), fov, shape)
             for d, ks in kf_valid_shards(mesh, pose_inv.shape[0])]
    return reduce_or(mesh, parts, dev)


def _padded_images(imgs: torch.Tensor, rows: int) -> torch.Tensor:
    """A shard's image stack grown to ``rows`` with ``NO_POINT`` images (its
    padded keyframes), so every shard has the same shape."""
    return torch.cat([imgs, imgs.new_full((rows - imgs.shape[0], imgs.shape[1]), NO_POINT)])


def projected_scan_images_sharded(mesh: Mesh, source_xyz, source_mask, pose_inv, fov, shape,
                                  proj_shape):
    """Keyframe-sharded :func:`projected_scan_images` (padded keyframes'
    images cut off)."""
    dev, K = source_xyz.device, pose_inv.shape[0]
    shards = kf_valid_shards(mesh, K)
    per = -(-K // mesh.size)
    parts = [_padded_images(projected_scan_images(source_xyz.to(d), source_mask.to(d),
                                                  pose_inv[ks].to(d), fov, shape, proj_shape), per)
             for d, ks in shards]
    return concat(mesh, parts, dev)[:K]


def fused_visibility_images_sharded(mesh: Mesh, source_xyz, source_mask, pose_inv, fov, shape,
                                    proj_shape, scale: float):
    """Keyframe-sharded :func:`ltm_torch.kernels.projection.fused_visibility_images`."""
    dev, K = source_xyz.device, pose_inv.shape[0]
    per = -(-K // mesh.size)
    wins, imgs = zip(*[fused_visibility_images(source_xyz.to(d), source_mask.to(d),
                                               pose_inv[ks].to(d), fov, shape, proj_shape, scale)
                       for d, ks in kf_valid_shards(mesh, K)])
    return (reduce_or(mesh, wins, dev),
            concat(mesh, [_padded_images(img, per) for img in imgs], dev)[:K])


def sweep_discrepancy_vs_images_sharded(mesh: Mesh, target_xyz, target_mask, scan_imgs,
                                        pose_inv, fov, shape, diff_threshold: float = 0.1,
                                        reverse: bool = False):
    """Keyframe-sharded :func:`sweep_discrepancy_vs_images`."""
    dev = target_xyz.device
    parts = [sweep_discrepancy_vs_images(target_xyz.to(d), target_mask.to(d), scan_imgs[ks].to(d),
                                         pose_inv[ks].to(d), fov, shape, diff_threshold, reverse)
             for d, ks in kf_valid_shards(mesh, pose_inv.shape[0])]
    return reduce_or(mesh, parts, dev)


# ---- chunk-sharded kNN -------------------------------------------------------

def chunk_knn_sqdists_sharded(mesh: Mesh, query_xyz, query_mask, bm: BlockMap, target_extra,
                              clamp_radius: float, k: int = 2, chunk: int = 512,
                              k_blocks: int = 64, sort_cell: float = 25.0):
    """Chunk-sharded :func:`ltm_torch.kernels.chunk_knn.chunk_knn_sqdists`:
    the Morton sort and the block bounds run once, on the caller's device;
    the scan, the dominant cost, splits along the chunk axis, each slot
    scanning its chunk range (on the card one launch of K4's scan over the
    range, counted in ``chunk_knn_sqdists.launches``), with no collective
    beyond concatenation.  The rows, the per-chunk overflow and the order
    equal the one-device call's, so the driver's escalation and brute-force
    fallback are unchanged.  ``chunk_knn_sqdists.counts`` becomes the
    shards' counts combined: sums, and the most tests in a chunk the
    largest."""
    dev = query_xyz.device
    if query_xyz.shape[0] == 0:
        return ck.chunk_knn_sqdists(query_xyz, query_mask, bm, target_extra, clamp_radius, k=k,
                                    chunk=chunk, k_blocks=k_blocks, sort_cell=sort_cell)
    prep = ck.chunk_knn_prep(query_xyz, query_mask, bm, target_extra, chunk=chunk,
                             sort_cell=sort_cell)
    C = prep.n_chunks
    overs, rows, counts = [], [], []
    for d, c0, c1 in local_shards(mesh, C + (-C) % mesh.size):
        lo, hi = min(c0, C), min(c1, C)   # chunks past C are the padding
        ov, r = ck.chunk_knn_scan_range(prep.to(d), lo, hi, clamp_radius, k=k, k_blocks=k_blocks)
        if hi > lo and not prep.plain:
            counts.append(ck.chunk_knn_sqdists.counts.to(dev))
        n_pad = (c1 - c0) - (hi - lo)
        overs.append(torch.cat([ov, ov.new_zeros((n_pad,))]))
        rows.append(torch.cat([r, r.new_full((n_pad * chunk, k), ck._BIG)]))
    if counts:
        total = torch.stack(counts)
        ck.chunk_knn_sqdists.counts = torch.cat([total[:, :4].sum(0), total[:, 4:].amax(0)])
    sqdists = torch.empty((prep.n, k), dtype=torch.float32, device=dev)
    sqdists[prep.order.long()] = concat(mesh, rows, dev)[:prep.n]
    return ck.ChunkKnnResult(sqdists, concat(mesh, overs, dev)[:C], prep.order.int())
