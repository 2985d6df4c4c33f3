"""Pose-graph checkpoint and resume (port of ``ltm.graph.checkpoint``).

The solver state checkpoints to one ``.npz``: every factor batch, the
variable estimates and optional metadata, under ``ltm``'s keys and dtypes
(float32 values, int32 indices, bool flags), so a file written by either
package loads in the other.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ltm_torch.graph.factors import GRAPH_FIELDS, GraphData, graph_from_arrays

__all__ = ["save_graph", "load_graph"]


def _host(t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.astype(np.int32) if np.issubdtype(a.dtype, np.integer) else a


def save_graph(path: str, g: GraphData, poses: Optional[torch.Tensor] = None,
               meta: Optional[dict] = None) -> None:
    arrays = {name: _host(getattr(g, name)) for name in GRAPH_FIELDS}
    if poses is not None:
        arrays["__estimates__"] = _host(poses)
    for k, v in (meta or {}).items():
        arrays[f"__meta_{k}__"] = np.asarray(v)
    np.savez_compressed(path, **arrays)


def load_graph(path: str, device="cpu"):
    """-> (GraphData on ``device``, estimates or None, meta dict)."""
    with np.load(path) as data:
        g = graph_from_arrays({k: data[k] for k in GRAPH_FIELDS}, device)
        est = (torch.from_numpy(data["__estimates__"].astype(np.float32)).to(device)
               if "__estimates__" in data.files else None)
        meta = {k[len("__meta_"):-2]: data[k] for k in data.files if k.startswith("__meta_")}
    return g, est, meta
