"""Device-resident session state for LT-SLAM (port of ``ltm.slam.session``).

Mirrors the reference ``Session`` (``ltslam/src/Session.cpp``): the loaded
pose graph, Scan Context descriptors, keyframe clouds, and ICP submap
assembly (``loopFindNearKeyframesLocalCoord/CentralCoord``,
``Session.cpp:91-142``).  All keyframe scans live in one padded
``(N, S, 3)`` tensor; a submap is a gather, a batched rigid transform and a
voxel dedupe.  As in ``ltm``, the "local coord" submap composes the
neighbours with their relative poses (the reference stacks them
untransformed, ``Session.cpp:130``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ltm_torch.core.config import LTSlamConfig
from ltm_torch.io.sessions import SessionData
from ltm_torch.kernels import polar_bin
from ltm_torch.kernels.projection import transform
from ltm_torch.kernels.voxel import voxel_downsample_representative_capped
from ltm_torch.utils import get_logger

log = get_logger("ltm_torch.slam.session")

__all__ = ["SlamSession", "assemble_submap", "auto_scan_capacity"]


def auto_scan_capacity(session_data) -> int:
    """Pow-2 bucket of the largest scan across sessions (min 512)."""
    s_max = max((len(s) for d in session_data for s in d.scans[: d.num_nodes]), default=1)
    return 1 << max(9, (max(s_max, 1) - 1).bit_length())


@dataclass
class SlamSession:
    """One session's state on the device."""

    name: str
    num_nodes: int                      # valid nodes
    poses_local: np.ndarray             # (N, 4, 4) float64 — current local estimates
    edges: tuple                        # host (from, to, rel)
    scans_xyz: torch.Tensor             # (N_cap, S, 3) float32
    scans_mask: torch.Tensor            # (N_cap, S)
    descriptors: torch.Tensor           # (N_cap, R, S_c) float32
    node_valid: torch.Tensor            # (N_cap,)
    is_base: bool
    # per-scan ICP pre-filter (submap_voxel_size representatives, compacted
    # to the row front), trimmed by the pipeline to a shared pow-2 bucket
    scans_icp_xyz: Optional[torch.Tensor] = None   # (N_cap, S_icp, 3)
    scans_icp_mask: Optional[torch.Tensor] = None  # (N_cap, S_icp)
    _max_icp_voxels: object = 0  # device scalar until first host access

    @classmethod
    def from_session_data(cls, data: SessionData, cfg: LTSlamConfig, is_base: bool,
                          n_cap: Optional[int] = None, s_cap: Optional[int] = None,
                          device="cpu") -> "SlamSession":
        dev = torch.device(device)
        n = data.num_nodes
        if n_cap is None:
            # auto pow-2 bucket; an explicit too-small cap escalates with a warning
            n_auto = 1 << max(3, (max(n, 1) - 1).bit_length())
            n_cap = cfg.max_nodes_per_session if cfg.max_nodes_per_session else n_auto
            if n > n_cap:
                log.warning("session %s: max_nodes_per_session=%d < %d nodes — "
                            "escalating capacity to %d", data.name, n_cap, n, n_auto)
                n_cap = n_auto
        if s_cap is None:
            s_cap = cfg.scan_capacity
        if s_cap is None:
            s_cap = auto_scan_capacity([data])

        xyz = np.zeros((n_cap, s_cap, 3), np.float32)
        msk = np.zeros((n_cap, s_cap), bool)
        n_trunc = 0
        for i, scan in enumerate(data.scans[:n]):
            pts = scan[:, :3]
            if len(pts) > s_cap:
                # deterministic stride subsample to capacity
                n_trunc += 1
                pts = pts[np.linspace(0, len(pts) - 1, s_cap).astype(np.int64)]
            xyz[i, : len(pts)] = pts
            msk[i, : len(pts)] = True
        if n_trunc:
            log.warning("session %s: %d/%d scans exceed scan_capacity=%d points — "
                        "stride-subsampled; raise scan_capacity for full density",
                        data.name, n_trunc, n, s_cap)
        scans_xyz = torch.from_numpy(xyz).to(dev)
        scans_mask = torch.from_numpy(msk).to(dev)

        sc = cfg.scan_context
        if data.descriptors is not None:
            d = np.zeros((n_cap, sc.num_ring, sc.num_sector), np.float32)
            d[:n] = data.descriptors[:n]
            descriptors = torch.from_numpy(d).to(dev)
        else:
            descriptors = polar_bin.make_descriptors(
                scans_xyz, scans_mask, num_ring=sc.num_ring, num_sector=sc.num_sector,
                max_radius=sc.max_radius, lidar_height=sc.lidar_height)

        valid = torch.arange(n_cap, device=dev) < n
        # ICP-resolution pre-filter of every scan in one batched pass: each
        # scan's representative set compacted to the row front (re-voxeling a
        # representative set on the same grid is idempotent, so the source
        # filter of a pair gives what filtering the raw scan would)
        icp_xyz, icp_mask, nvox = voxel_downsample_representative_capped(
            scans_xyz, scans_mask, cfg.icp.submap_voxel_size, s_cap)
        max_nvox = torch.max(torch.where(valid, nvox, 0))

        return cls(name=data.name, num_nodes=n, poses_local=data.poses.copy(), edges=data.edges,
                   scans_xyz=scans_xyz, scans_mask=scans_mask, descriptors=descriptors,
                   node_valid=valid, is_base=is_base, scans_icp_xyz=icp_xyz,
                   scans_icp_mask=icp_mask, _max_icp_voxels=max_nvox)

    @property
    def max_icp_voxels(self) -> int:
        """Largest per-scan ICP-voxel count (host read on first access)."""
        if not isinstance(self._max_icp_voxels, int):
            self._max_icp_voxels = int(self._max_icp_voxels)
        return self._max_icp_voxels

    def trim_icp_scans(self, row_cap: int) -> None:
        """Trim the compacted ICP-filtered scans to ``row_cap`` rows
        (lossless when ``row_cap >= max_icp_voxels``)."""
        self.scans_icp_xyz = self.scans_icp_xyz[:, :row_cap]
        self.scans_icp_mask = self.scans_icp_mask[:, :row_cap]


def assemble_submap(scans_xyz: torch.Tensor, scans_mask: torch.Tensor,
                    neighbor_idx: torch.Tensor, neighbor_valid: torch.Tensor,
                    rel_poses: torch.Tensor, voxel: float, out_capacity: int):
    """Gather ±K neighbour scans, compose them into the submap frame
    (``rel_poses``: submap_frame_from_neighbor), then one representative a
    voxel with a uniform density cap (``loopFindNearKeyframes*`` and the
    0.3 m ICP filter, ``ltslam/src/Session.cpp:18,109-114``)."""
    pts = scans_xyz[neighbor_idx]                          # (K, S, 3)
    msk = scans_mask[neighbor_idx] & neighbor_valid[:, None]
    # R·p + t with the FMA chain XLA compiles ltm's HIGHEST einsum to
    moved = transform(pts, rel_poses[:, None, :3, :3], rel_poses[:, None, :3, 3])
    out_xyz, out_mask, _ = voxel_downsample_representative_capped(
        moved.reshape(-1, 3), msk.reshape(-1), voxel, out_capacity)
    return out_xyz, out_mask
