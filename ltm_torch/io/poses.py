"""KITTI-style pose file I/O.

Each line: 12 floats (row-major 3x4 [R|t]) — the LT-SLAM trajectory output
format (``writePose3ToStream``, ``ltslam/src/utility.cpp:190-200``) and the
LT-removert pose input (``ltremovert/src/Session.cpp:101-114``, which appends
the homogeneous row).  The port's copy of ``ltm.io.poses``; reads go
through the native parser when the library is built.
"""

from __future__ import annotations

import numpy as np

from ltm_torch.io import native

__all__ = ["read_kitti_poses", "write_kitti_poses"]


def read_kitti_poses(path: str) -> np.ndarray:
    """-> (N, 4, 4) float64."""
    if native.available():
        out = native.read_poses_native(path)
        if out is not None:
            return out
    rows = np.loadtxt(path, dtype=np.float64, ndmin=2)
    if rows.size == 0:
        return np.zeros((0, 4, 4))
    if rows.shape[1] == 16:
        return rows.reshape(-1, 4, 4)
    if rows.shape[1] != 12:
        raise ValueError(f"pose file {path}: expected 12 or 16 cols, got {rows.shape[1]}")
    n = rows.shape[0]
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :4] = rows.reshape(n, 3, 4)
    return T


def write_kitti_poses(path: str, poses: np.ndarray) -> None:
    poses = np.asarray(poses)
    rows = poses[:, :3, :4].reshape(len(poses), 12)
    with open(path, "w") as f:
        for r in rows:
            f.write(" ".join(repr(float(v)) for v in r) + "\n")
