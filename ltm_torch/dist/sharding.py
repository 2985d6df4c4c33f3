"""Sharded whole-map sweeps, the sharded brute kNN, Scan Context distance
and ICP farm (port of ``ltm.dist.sharding``).

Each function shards one embarrassingly parallel axis over the mesh's
slots and combines with one collective (``ltm_torch.dist.mesh``):

  * :func:`sweep_discrepancy_sharded`: keyframes split, map replicated,
    OR of the slots' masks;
  * :func:`sweep_discrepancy_map_sharded`: the map split, keyframes
    replicated; per keyframe each slot scatter-mins its map shard into a
    partial range image, one ``min`` collective merges them, and the
    winner and flag test runs on each shard;
  * :func:`knn_avg_sqdist_sharded`: queries split, targets replicated,
    concatenation (on the card each shard is one launch of the 2-NN kernel
    K1);
  * :func:`sc_distance_sharded`: Scan Context query rows split, targets
    replicated, concatenation;
  * :func:`icp_batch_sharded`: ICP lanes split, each slot's lanes with
    their own early exit, concatenation.

Padded keyframes carry validity flags (a slot runs only its real ones);
padded map points and queries are invalid; padded ICP lanes repeat the
last lane.  A row, query or lane does not depend on the others, so the
results are the one-device functions' on the same rows.  These mirror
the reference's OpenMP loops (``ltremovert/src/Session.cpp:408,491``,
``ltslam/src/LTslam.cpp:389,534``) at device scale.
"""

from __future__ import annotations

import torch

from ltm_torch.dist.mesh import Mesh, concat, local_shards, pad_to_multiple, reduce_min, reduce_or
from ltm_torch.kernels.knn import knn_avg_sqdist
from ltm_torch.kernels.projection import (
    VALID_DIFF_UB,
    _project_min,
    apply_pose,
    range_image,
    sweep_discrepancy,
)
from ltm_torch.register.icp import ICPResult, icp_batch
from ltm_torch.retrieval.scancontext import sc_distance_matrix

__all__ = ["sweep_discrepancy_sharded", "sweep_discrepancy_map_sharded",
           "knn_avg_sqdist_sharded", "sc_distance_sharded", "icp_batch_sharded",
           "kf_valid_shards"]


def kf_valid_shards(mesh: Mesh, K: int):
    """(slot device, slice of its real keyframes) for this process's slots,
    the keyframe axis padded to a multiple of ``mesh.size``: the padded
    keyframes, those past ``K``, are flagged invalid and never run."""
    return [(d, slice(a, max(a, min(b, K))))
            for d, a, b in local_shards(mesh, K + (-K) % mesh.size)]


def sweep_discrepancy_sharded(mesh: Mesh, map_xyz, map_mask, scans_xyz, scans_mask, pose_inv,
                              fov, shape, diff_threshold: float = 0.1, reverse: bool = False):
    """OR over keyframes of the visibility discrepancy, keyframes sharded:
    :func:`ltm_torch.kernels.projection.sweep_discrepancy` bit for bit."""
    dev = map_xyz.device
    parts = [sweep_discrepancy(map_xyz.to(d), map_mask.to(d), scans_xyz[ks].to(d),
                               scans_mask[ks].to(d), pose_inv[ks].to(d), fov, shape,
                               diff_threshold, reverse)
             for d, ks in kf_valid_shards(mesh, pose_inv.shape[0])]
    return reduce_or(mesh, parts, dev)


def sweep_discrepancy_map_sharded(mesh: Mesh, map_xyz, map_mask, scans_xyz, scans_mask,
                                  pose_inv, fov, shape, diff_threshold: float = 0.1,
                                  reverse: bool = False):
    """The visibility sweep with the MAP sharded (maps larger than one
    device's memory), keyframes replicated: per keyframe one ``min``
    collective of the shards' partial range images gives the global image,
    and each shard flags its own winners.  Equals
    :func:`~ltm_torch.kernels.projection.sweep_discrepancy` bit for bit:
    the minimum over shards of per-shard minima is the minimum."""
    dev, n = map_xyz.device, map_xyz.shape[0]
    mx = pad_to_multiple(map_xyz, mesh.size)
    mm = pad_to_multiple(map_mask, mesh.size, fill=False)
    shards = [(d, mx[a:b].to(d), mm[a:b].to(d)) for d, a, b in local_shards(mesh, mx.shape[0])]
    outs = [torch.zeros(m.shape, dtype=torch.bool, device=d) for d, _, m in shards]
    for s_xyz, s_mask, Tinv in zip(scans_xyz, scans_mask, pose_inv):
        scan_img = range_image(s_xyz, s_mask, fov, shape).to(mesh.lead)
        proj = [_project_min(apply_pose(x, Tinv.to(d)), m, fov, shape) for d, x, m in shards]
        map_img = reduce_min(mesh, [img for _, _, img in proj])
        diff_img = (map_img - scan_img) if reverse else (scan_img - map_img)
        flag_img = (diff_img > diff_threshold) & (diff_img < VALID_DIFF_UB)
        packed = torch.where(flag_img, map_img, -map_img)
        for out, (d, _, m), (pix, rng, _) in zip(outs, shards, proj):
            g = packed.to(d)[pix]
            out |= m & (rng <= torch.abs(g)) & (g > 0)
    return concat(mesh, outs, dev)[:n]


def knn_avg_sqdist_sharded(mesh: Mesh, query_xyz, query_mask, target_xyz, target_mask,
                           k: int = 2, tile: int = 8192):
    """Queries sharded, targets replicated:
    :func:`ltm_torch.kernels.knn.knn_avg_sqdist` bit for bit (a query's
    statistic does not depend on the others)."""
    dev, n = query_xyz.device, query_xyz.shape[0]
    qx = pad_to_multiple(query_xyz, mesh.size)
    qm = pad_to_multiple(query_mask, mesh.size, fill=False)
    parts = [knn_avg_sqdist(qx[a:b].to(d), qm[a:b].to(d), target_xyz.to(d), target_mask.to(d),
                            k=k, tile=tile)
             for d, a, b in local_shards(mesh, qx.shape[0])]
    return concat(mesh, parts, dev)[:n]


def sc_distance_sharded(mesh: Mesh, query_descs, target_descs, full_shift_search: bool = True,
                        search_ratio: float = 0.1):
    """All-pairs Scan Context distance with the query rows sharded and the
    targets replicated: :func:`~ltm_torch.retrieval.scancontext.sc_distance_matrix`'s
    ``(dist (Q, T), shift (Q, T))`` (``ltm``'s defaults)."""
    dev, q = query_descs.device, query_descs.shape[0]
    qd = pad_to_multiple(query_descs, mesh.size)
    parts = [sc_distance_matrix(qd[a:b].to(d), target_descs.to(d),
                                full_shift_search=full_shift_search, search_ratio=search_ratio)
             for d, a, b in local_shards(mesh, qd.shape[0])]
    return tuple(concat(mesh, list(field), dev)[:q] for field in zip(*parts))


def icp_batch_sharded(mesh: Mesh, src_xyz, src_mask, tgt_xyz, tgt_mask, init_transforms=None,
                      **kw) -> ICPResult:
    """A batch of ICP lanes sharded (the reference's OpenMP ICP farm,
    ``ltslam/src/LTslam.cpp:389``): each slot runs
    :func:`~ltm_torch.register.icp.icp_batch` on its lanes with its own
    early exit.  The lane axis pads to a multiple of ``mesh.size`` by
    repeating the last lane, as ``ltm`` does; all five ``ICPResult``
    fields come back by concatenation, cut to the batch."""
    dev, b = src_xyz.device, src_xyz.shape[0]
    if init_transforms is None:
        init_transforms = torch.eye(4, dtype=src_xyz.dtype, device=dev).expand(b, 4, 4)
    pad = (-b) % mesh.size

    def rep(t):
        return torch.cat([t, t[-1:].expand((pad,) + tuple(t.shape[1:]))]) if pad else t

    lanes = [rep(t) for t in (src_xyz, src_mask, tgt_xyz, tgt_mask, init_transforms)]
    parts = [icp_batch(*(t[a:e].to(d) for t in lanes), **kw)
             for d, a, e in local_shards(mesh, b + pad)]
    return ICPResult(*(concat(mesh, list(field), dev)[:b] for field in zip(*parts)))
