"""Session directory protocol (the port's copy of ``ltm.io.sessions``).

A session directory holds (``README.md:70-77``, ``ltslam/src/Session.cpp``):
  * ``singlesession_posegraph.g2o``  — keyframe pose graph
  * ``SCDs/*.scd``                   — one Scan Context descriptor per keyframe
  * ``Scans/*.pcd``                  — one keyframe point cloud per keyframe

File names start with the integer keyframe index (the reference splits on
',' and stoi's the prefix, ``ltslam/src/Session.cpp:153-161``).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ltm_torch.io import g2o as g2o_io
from ltm_torch.io import pcd as pcd_io
from ltm_torch.io import scd as scd_io

__all__ = ["SessionData", "load_session_dir", "write_session_dir", "indexed_files"]

_IDX_RE = re.compile(r"^(\d+)")


def _file_index(name: str) -> int:
    """Leading-integer index of a scan/SCD filename (handles 'idx,stamp.ext')."""
    m = _IDX_RE.match(name.split(",")[0])
    if not m:
        raise ValueError(f"cannot parse keyframe index from {name!r}")
    return int(m.group(1))


def indexed_files(directory: str, suffix: str) -> List[str]:
    """Files in ``directory`` with ``suffix``, sorted by leading index."""
    names = [n for n in os.listdir(directory) if n.endswith(suffix)]
    names.sort(key=_file_index)
    return [os.path.join(directory, n) for n in names]


@dataclass
class SessionData:
    """Host-side loaded session."""

    name: str
    node_ids: np.ndarray                       # (N,) int32
    poses: np.ndarray                          # (N, 4, 4) float64, local frame
    edges: tuple                               # (from (E,), to (E,), rel (E,4,4))
    scans: List[np.ndarray] = field(default_factory=list)  # each (M_i, 4) xyzi f32
    descriptors: Optional[np.ndarray] = None   # (N, R, S) float32
    extras: Dict = field(default_factory=dict)

    @property
    def num_nodes(self) -> int:
        return len(self.node_ids)


def load_session_dir(path: str, name: Optional[str] = None, load_scans: bool = True,
                     load_scds: bool = True, max_nodes: Optional[int] = None) -> SessionData:
    graph = g2o_io.read_g2o(os.path.join(path, "singlesession_posegraph.g2o"))
    node_ids = np.asarray(graph.node_ids, np.int32)
    poses = graph.poses_array()
    order = np.argsort(node_ids)
    node_ids, poses = node_ids[order], poses[order]
    ef, et, er = graph.edges_arrays()
    if max_nodes is not None and len(node_ids) > max_nodes:
        node_ids, poses = node_ids[:max_nodes], poses[:max_nodes]
        # edges to truncated nodes go too: a stale index would address
        # another session's variables in the joint graph
        keep = (ef < max_nodes) & (et < max_nodes)
        ef, et, er = ef[keep], et[keep], er[keep]
    n = len(node_ids)

    scans: List[np.ndarray] = []
    if load_scans:
        scans = [pcd_io.read_pcd(p) for p in indexed_files(os.path.join(path, "Scans"), ".pcd")[:n]]

    descriptors = None
    scd_dir = os.path.join(path, "SCDs")
    if load_scds and os.path.isdir(scd_dir):
        descs = [scd_io.read_scd(p) for p in indexed_files(scd_dir, ".scd")[:n]]
        if descs:
            descriptors = np.stack(descs).astype(np.float32)

    return SessionData(name=name or os.path.basename(os.path.normpath(path)),
                       node_ids=node_ids, poses=poses, edges=(ef, et, er),
                       scans=scans, descriptors=descriptors)


def write_session_dir(path: str, session: SessionData) -> None:
    """Write a reference-protocol session directory."""
    os.makedirs(os.path.join(path, "Scans"), exist_ok=True)
    os.makedirs(os.path.join(path, "SCDs"), exist_ok=True)
    graph = g2o_io.G2oGraph(node_ids=list(map(int, session.node_ids)),
                            node_poses=[session.poses[i] for i in range(session.num_nodes)])
    ef, et, er = session.edges
    graph.edge_from = list(map(int, ef))
    graph.edge_to = list(map(int, et))
    graph.edge_rel = [er[i] for i in range(len(ef))]
    g2o_io.write_g2o(os.path.join(path, "singlesession_posegraph.g2o"), graph)
    for i, scan in enumerate(session.scans):
        pcd_io.write_pcd(os.path.join(path, "Scans", f"{i:06d}.pcd"), scan)
    if session.descriptors is not None:
        for i in range(session.descriptors.shape[0]):
            scd_io.write_scd(os.path.join(path, "SCDs", f"{i:06d}.scd"), session.descriptors[i])
