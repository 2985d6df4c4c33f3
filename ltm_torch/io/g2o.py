"""g2o pose-graph file I/O (the port's copy of ``ltm.io.g2o``; NumPy only).

Parses the subset of g2o the reference uses: ``VERTEX_SE3:QUAT`` and
``EDGE_SE3:QUAT`` lines with quaternion order x y z w (reference
``splitG2oFileLine``, ``ltslam/src/utility.cpp:137-176``).  Information
entries on edge lines are tolerated and ignored, like the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

__all__ = ["G2oGraph", "read_g2o", "write_g2o"]

VERTEX_TAG = "VERTEX_SE3:QUAT"
EDGE_TAG = "EDGE_SE3:QUAT"


def _quat_xyzw_to_mat(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    n = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _mat_to_quat_xyzw(R: np.ndarray) -> np.ndarray:
    """Branchful float64 host conversion (file I/O only)."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    q = np.array([x, y, z, w])
    return q if w >= 0 else -q


def _pose_from(trans, quat_xyzw) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = _quat_xyzw_to_mat(np.asarray(quat_xyzw, float))
    T[:3, 3] = trans
    return T


@dataclass
class G2oGraph:
    """Host-side pose graph: node ids/poses and edges (4x4 float64)."""

    node_ids: List[int] = field(default_factory=list)
    node_poses: List[np.ndarray] = field(default_factory=list)
    edge_from: List[int] = field(default_factory=list)
    edge_to: List[int] = field(default_factory=list)
    edge_rel: List[np.ndarray] = field(default_factory=list)

    @property
    def num_nodes(self) -> int:
        return len(self.node_ids)

    @property
    def num_edges(self) -> int:
        return len(self.edge_from)

    def poses_array(self) -> np.ndarray:
        return np.stack(self.node_poses) if self.node_poses else np.zeros((0, 4, 4))

    def edges_arrays(self):
        if not self.edge_from:
            return np.zeros((0,), np.int32), np.zeros((0,), np.int32), np.zeros((0, 4, 4))
        return (np.asarray(self.edge_from, np.int32), np.asarray(self.edge_to, np.int32),
                np.stack(self.edge_rel))


def read_g2o(path: str) -> G2oGraph:
    g = G2oGraph()
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == VERTEX_TAG:
                vals = [float(x) for x in parts[2:9]]
                g.node_ids.append(int(parts[1]))
                g.node_poses.append(_pose_from(vals[0:3], vals[3:7]))
            elif parts[0] == EDGE_TAG:
                vals = [float(x) for x in parts[3:10]]
                g.edge_from.append(int(parts[1]))
                g.edge_to.append(int(parts[2]))
                g.edge_rel.append(_pose_from(vals[0:3], vals[3:7]))
    return g


def write_g2o(path: str, graph: G2oGraph, with_information: bool = True) -> None:
    """Write nodes and edges, with an identity information block for g2o tools."""
    info = " ".join(str(v) for v in [1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0,
                                     1, 0, 0, 1, 0, 1])
    with open(path, "w") as f:
        for idx, T in zip(graph.node_ids, graph.node_poses):
            q = _mat_to_quat_xyzw(T[:3, :3])
            t = T[:3, 3]
            f.write(f"{VERTEX_TAG} {idx} {t[0]} {t[1]} {t[2]} {q[0]} {q[1]} {q[2]} {q[3]}\n")
        for i, j, T in zip(graph.edge_from, graph.edge_to, graph.edge_rel):
            q = _mat_to_quat_xyzw(T[:3, :3])
            t = T[:3, 3]
            line = f"{EDGE_TAG} {i} {j} {t[0]} {t[1]} {t[2]} {q[0]} {q[1]} {q[2]} {q[3]}"
            f.write(line + (" " + info if with_information else "") + "\n")
