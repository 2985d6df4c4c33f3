"""Carry LT-SLAM's state across from ``ltm``: configuration, sessions and
pose graphs as plain Python / NumPy values (the counterpart of
``removert/convert.py``; this module imports nothing of ``ltm`` or ``jax``):

  * ``config_from_dict(dataclasses.asdict(ltm_cfg))`` -> port ``LTSlamConfig``;
  * ``session_from_data(d)`` -> port ``SessionData`` from any object with
    ``ltm``'s ``SessionData`` fields;
  * ``graph_to_arrays(g)`` -> a dict of NumPy arrays from either package's
    ``GraphData``; ``graph_from_arrays(d, device)`` builds the port's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np

from ltm_torch.core.config import ICPConfig, LTSlamConfig, ScanContextConfig, SolverConfig
from ltm_torch.graph.factors import GRAPH_FIELDS, graph_from_arrays
from ltm_torch.io.sessions import SessionData

__all__ = ["config_from_dict", "session_from_data", "graph_to_arrays", "graph_from_arrays"]

_SUB = {"scan_context": ScanContextConfig, "icp": ICPConfig, "solver": SolverConfig}


def _checked(cls, d: Dict[str, Any]):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"fields unknown to ltm_torch {cls.__name__}: {sorted(unknown)}")
    return {k: (tuple(v) if isinstance(v, list) else v) for k, v in d.items()}


def config_from_dict(d: Dict[str, Any]) -> LTSlamConfig:
    """Port ``LTSlamConfig`` from ``dataclasses.asdict`` of ``ltm``'s (or of
    the port's own).  Unknown keys raise: the two configs must not drift."""
    kw = _checked(LTSlamConfig, {k: v for k, v in d.items() if k not in _SUB})
    for k, cls in _SUB.items():
        if k in d:
            kw[k] = cls(**_checked(cls, d[k]))
    return LTSlamConfig(**kw)


def session_from_data(d) -> SessionData:
    """Port ``SessionData`` (NumPy copies) from a session object of either package."""
    ef, et, er = d.edges
    return SessionData(name=d.name, node_ids=np.array(d.node_ids), poses=np.array(d.poses),
                       edges=(np.array(ef), np.array(et), [np.array(r) for r in er]),
                       scans=[np.array(s) for s in d.scans],
                       descriptors=None if d.descriptors is None else np.array(d.descriptors),
                       extras=dict(d.extras))


def graph_to_arrays(g) -> Dict[str, np.ndarray]:
    """The ``GRAPH_FIELDS`` of a ``GraphData`` of either package as NumPy arrays
    (``np.asarray`` reads ``ltm``'s arrays without importing ``jax``)."""
    out = {}
    for k in GRAPH_FIELDS:
        v = getattr(g, k)
        out[k] = np.asarray(v.cpu() if hasattr(v, "cpu") else v)
    return out
