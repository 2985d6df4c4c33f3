"""Removert session state (port of ``ltm.removert.session``).

Each session keeps ONE padded global-map tensor plus boolean masks over it;
every partitioning step (static/dynamic, ND/PD, strong/weak) flips mask
bits and data never moves.  Host-side keyframe parsing (range/gap/ROI)
mirrors ``parseKeyframes``/``parseKeyframesInROI`` (``Session.cpp:138-263``).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ltm_torch.core.config import RemovertConfig
from ltm_torch.io import native
from ltm_torch.kernels.blocks import BlockMap, build_block_map
from ltm_torch.kernels.projection import sumsq3, transform
from ltm_torch.kernels.voxel import voxel_downsample_centroid
from ltm_torch.utils import get_logger

__all__ = ["RemovertInput", "RemovertSession", "parse_keyframe_indices", "parse_keyframes_in_roi"]

log = get_logger("ltm_torch.removert.session")


@dataclass
class RemovertInput:
    """Host-side raw session: local-frame scans + base poses (in memory;
    loading from scan directories comes with the CLI)."""

    scans: List[np.ndarray]          # each (M_i, >=3) float32, lidar frame
    poses: np.ndarray                # (N, 4, 4) float64
    names: Optional[List[str]] = None


def parse_keyframe_indices(num: int, start: int, end: int, gap: int) -> np.ndarray:
    """``parseKeyframes({start,end}, gap)`` (``Session.cpp:138-174``)."""
    idx = np.arange(num)
    idx = idx[(idx >= start) & (idx <= end)]
    return idx[::max(gap, 1)]


def parse_keyframes_in_roi(poses: np.ndarray, roi_poses: np.ndarray, thres: float, gap: int) -> np.ndarray:
    """``parseKeyframesInROI`` (``Session.cpp:230-263``): keep scans within
    ``thres`` meters of any ROI (central keyframe) pose, then gap-subsample."""
    p = poses[:, :3, 3]
    r = roi_poses[:, :3, 3]
    d = np.linalg.norm(p[:, None] - r[None], axis=-1).min(axis=1)
    idx = np.flatnonzero(d <= thres)
    return idx[::max(gap, 1)]


def _preclean(scan: np.ndarray, radius: float, z_band: float) -> np.ndarray:
    """``precleaningKeyframes`` (``Session.cpp:506-533``): drop ego-ring
    points with range < radius and |z| < z_band."""
    xyz = scan[:, :3]
    r = np.linalg.norm(xyz, axis=1)
    drop = (r < radius) & (np.abs(xyz[:, 2]) < z_band)
    return scan[~drop]


def _voxel_downsample_host(xyz: np.ndarray, voxel: float) -> np.ndarray:
    """Per-scan load-time voxel downsample (``loadKeyframes`` VoxelGrid,
    ``Session.cpp:283-289``).  Native C++ grid when available, NumPy fallback
    (first-point-per-voxel; centroid in the native path)."""
    if voxel <= 0:
        return xyz
    if native.available():
        out = native.voxel_downsample_native(np.ascontiguousarray(xyz[:, :3]), voxel)
        if out is not None:
            return out
    keys = np.floor(xyz[:, :3] / voxel).astype(np.int64)
    _, first = np.unique(keys, axis=0, return_index=True)
    return xyz[np.sort(first), :3]


def _merge_global(scans_xyz, scans_mask, poses, voxel, capacity):
    """Merge keyframes into the global frame + centroid downsample
    (``mergeScansWithinGlobalCoord`` + ``octreeDownsampling``,
    ``Session.cpp:186-202``, ``utility.cpp:204-219``)."""
    moved = transform(scans_xyz, poses[:, None, :3, :3], poses[:, None, :3, 3])
    return voxel_downsample_centroid(moved.reshape(-1, 3), scans_mask.reshape(-1), voxel, capacity)


@dataclass
class RemovertSession:
    """Device-resident session state."""

    sess_type: str                   # "Central" | "Query"
    num_keyframes: int
    keyframe_indices: np.ndarray     # into the original scan list
    names: List[str]
    poses: torch.Tensor              # (K_cap, 4, 4) f32 — effective (base∘lidar2base)
    poses_inv: torch.Tensor          # (K_cap, 4, 4)
    kf_valid: torch.Tensor           # (K_cap,)
    scans_xyz: torch.Tensor          # (K_cap, S, 3) lidar frame
    scans_mask: torch.Tensor         # (K_cap, S)

    map_xyz: torch.Tensor            # (N, 3) global frame
    map_mask: torch.Tensor           # (N,) valid map points
    masks: Dict[str, torch.Tensor] = field(default_factory=dict)  # named partitions
    bm: Optional[BlockMap] = None    # block layout of the same points (fast path)
    max_scan_range: float = 0.0      # max sensor range over all valid returns
                                     # (sets the exact forward-sweep bound)

    @classmethod
    def build(cls, inp: RemovertInput, cfg: RemovertConfig, sess_type: str,
              keyframe_indices: np.ndarray, device: torch.device) -> "RemovertSession":
        if cfg.device_scan_prep:
            raise NotImplementedError(
                "device_scan_prep is ported with the opt-in paths in a later slice; "
                "set device_scan_prep=False")
        kf = np.asarray(keyframe_indices)
        K = len(kf)
        # keyframe capacity: pow-2 bucket of the real count unless configured;
        # an explicit cap that is too small escalates with a warning
        k_auto = 1 << max(3, (max(K, 1) - 1).bit_length())
        if cfg.max_keyframes is None:
            k_cap = k_auto
        elif cfg.max_keyframes < K:
            log.warning("%s: max_keyframes=%d < %d parsed keyframes — "
                        "escalating capacity to %d (use keyframe_gap to subsample)",
                        sess_type, cfg.max_keyframes, K, k_auto)
            k_cap = k_auto
        else:
            k_cap = cfg.max_keyframes
        s_cap = cfg.scan_capacity

        lidar2base = np.asarray(cfg.extrinsic_lidar_to_base, np.float64).reshape(4, 4)
        poses = np.tile(np.eye(4, dtype=np.float32), (k_cap, 1, 1))
        names = []
        for out_i, scan_i in enumerate(kf):
            poses[out_i] = (inp.poses[scan_i] @ lidar2base).astype(np.float32)
            names.append(inp.names[scan_i] if inp.names else f"{scan_i:06d}.pcd")
        valid = np.zeros(k_cap, bool)
        valid[:K] = True

        # thread-pooled host prep (the native voxel grid releases the GIL),
        # then a transfer of the padded rows
        xyz = np.zeros((k_cap, s_cap, 3), np.float32)
        lens = np.zeros(k_cap, np.int64)
        n_trunc = np.zeros(k_cap, np.int64)

        def prep_one(out_i, scan_i):
            scan = _preclean(np.asarray(inp.scans[scan_i], np.float32),
                             cfg.preclean_radius, cfg.preclean_z_band)
            pts = _voxel_downsample_host(scan[:, :3], cfg.downsample_voxel_size).astype(np.float32)
            if len(pts) > s_cap:
                n_trunc[out_i] = len(pts) - s_cap
                sel = np.linspace(0, len(pts) - 1, s_cap).astype(np.int64)
                pts = pts[sel]
            xyz[out_i, : len(pts)] = pts
            lens[out_i] = len(pts)

        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
            list(ex.map(prep_one, range(K), kf))
        if n_trunc.any():
            log.warning("%s: %d/%d scans exceed scan_capacity=%d voxels — "
                        "uniformly subsampled (%d points dropped); raise "
                        "scan_capacity for full density", sess_type,
                        int((n_trunc > 0).sum()), K, s_cap, int(n_trunc.sum()))
        scans_xyz = torch.from_numpy(xyz).to(device)
        scans_mask = (torch.arange(s_cap)[None, :] < torch.from_numpy(lens)[:, None]).to(device)
        poses_t = torch.from_numpy(poses).to(device)
        poses_inv = torch.from_numpy(np.linalg.inv(poses.astype(np.float64)).astype(np.float32)).to(device)
        valid_t = torch.from_numpy(valid).to(device)
        # max sensor range over valid returns: the exact culling bound for
        # forward discrepancy sweeps is max_scan_range + diff_threshold
        r2 = sumsq3(scans_xyz)
        max_scan_range = float(np.sqrt(float(torch.where(scans_mask, r2, 0.0).max())))
        # map capacity: merge once at the configured/guessed capacity, then
        # re-merge at the pow-2 bucket of the TRUE voxel count when the guess
        # was wrong — auto mode both escalates (never drops voxels) and
        # shrinks (padded capacity costs every downstream stage)
        cap = cfg.map_capacity if cfg.map_capacity is not None else (1 << 20)
        v = cfg.downsample_voxel_size
        map_xyz, map_mask, n_real = _merge_global(scans_xyz, scans_mask, poses_t, v, cap)
        want = 1 << max(12, (max(n_real, 1) - 1).bit_length())
        if cfg.map_capacity is None:
            if want != cap:
                map_xyz, map_mask, _ = _merge_global(scans_xyz, scans_mask, poses_t, v, want)
        elif n_real > cap:
            log.warning("%s: %d voxels exceed map_capacity=%d — escalating to %d",
                        sess_type, n_real, cap, want)
            map_xyz, map_mask, _ = _merge_global(scans_xyz, scans_mask, poses_t, v, want)
        bm = None
        if cfg.use_block_map:
            # auto block budget: 1.25x slack over the perfectly packed count;
            # the doubling loop below absorbs sparse maps
            b_cap = cfg.block_capacity
            if cfg.n_blocks is not None:
                n_blocks = cfg.n_blocks
            else:
                need = max((n_real * 5 + 4 * b_cap - 1) // (4 * b_cap), 1)
                n_blocks = 1 << (need - 1).bit_length()
            for _attempt in range(6):
                bm, overflow = build_block_map(map_xyz, map_mask, cfg.block_cell_size, n_blocks, b_cap)
                if overflow == 0:
                    break
                log.warning("%s: block map overflow (%d pts) at n_blocks=%d — doubling",
                            sess_type, overflow, n_blocks)
                n_blocks *= 2
            else:
                raise ValueError(
                    f"{sess_type}: block map overflow persists at n_blocks={n_blocks}; "
                    f"raise block_capacity ({b_cap}) or block_cell_size ({cfg.block_cell_size})"
                )
            # the blocked flat layout becomes the canonical map layout so all
            # downstream masks index it directly
            map_xyz, map_mask = bm.flat_xyz(), bm.flat_mask()
        return cls(
            sess_type=sess_type,
            num_keyframes=K,
            keyframe_indices=kf,
            names=names,
            poses=poses_t,
            poses_inv=poses_inv,
            kf_valid=valid_t,
            scans_xyz=scans_xyz,
            scans_mask=scans_mask,
            map_xyz=map_xyz,
            map_mask=map_mask,
            bm=bm,
            max_scan_range=max_scan_range,
        )
