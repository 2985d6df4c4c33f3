"""Carry configuration and built sessions across from ``ltm``.

This system has no weights: its parameters are the config and the built
sessions.  Both cross the package boundary as plain Python / NumPy values,
so this module imports nothing of ``ltm`` (or ``jax``):

  * ``config_from_dict(dataclasses.asdict(ltm_cfg))`` -> port ``RemovertConfig``;
  * ``session_from_arrays(d, device)`` -> port ``RemovertSession`` from NumPy
    copies of a ``ltm`` ``RemovertSession``'s fields (see ``session_to_arrays``
    for the keys), so stage-level tests can feed one built session to both
    packages and separate a prep difference from a sweep difference;
  * ``session_to_arrays(sess)`` -> that dict, from any session object with
    the same fields (``np.asarray`` reads ``ltm``'s arrays without importing
    ``jax``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from ltm_torch.core.config import RemovertConfig
from ltm_torch.kernels.blocks import BlockMap
from ltm_torch.removert.session import RemovertSession

__all__ = ["config_from_dict", "session_from_arrays", "session_to_arrays"]

SESSION_ARRAY_FIELDS = ("poses", "poses_inv", "kf_valid", "scans_xyz", "scans_mask",
                        "map_xyz", "map_mask")


def config_from_dict(d: Dict[str, Any]) -> RemovertConfig:
    """Port ``RemovertConfig`` from ``dataclasses.asdict`` of ``ltm``'s (or
    of the port's own).  Unknown keys raise: the two configs must not drift."""
    names = {f.name for f in dataclasses.fields(RemovertConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"fields unknown to ltm_torch RemovertConfig: {sorted(unknown)}")
    return RemovertConfig(**{k: (list(v) if isinstance(v, list) else v) for k, v in d.items()})


def session_from_arrays(d: Dict[str, Any], device) -> RemovertSession:
    """Port ``RemovertSession`` from a dict of NumPy arrays and plain values:
    the layout of :func:`session_to_arrays`."""
    dev = torch.device(device)

    def t(a):
        return torch.from_numpy(np.array(a)).to(dev)   # a writable copy

    bm = None if d.get("bm") is None else BlockMap(**{k: t(d["bm"][k]) for k in BlockMap._fields})
    return RemovertSession(
        sess_type=d["sess_type"],
        num_keyframes=int(d["num_keyframes"]),
        keyframe_indices=np.asarray(d["keyframe_indices"]),
        names=list(d["names"]),
        masks={k: t(v) for k, v in d.get("masks", {}).items()},
        bm=bm,
        max_scan_range=float(d["max_scan_range"]),
        **{k: t(d[k]) for k in SESSION_ARRAY_FIELDS},
    )


def session_to_arrays(sess) -> Dict[str, Any]:
    """``sess_type``, ``num_keyframes``, ``keyframe_indices``, ``names``,
    ``max_scan_range``, the arrays of ``SESSION_ARRAY_FIELDS``, ``masks``
    ({name: array}) and ``bm`` (None or {BlockMap field: array}) of a
    session of either package, as NumPy arrays and plain values."""
    d = {k: np.asarray(getattr(sess, k)) for k in SESSION_ARRAY_FIELDS}
    d.update(sess_type=sess.sess_type, num_keyframes=int(sess.num_keyframes),
             keyframe_indices=np.asarray(sess.keyframe_indices), names=list(sess.names),
             max_scan_range=float(sess.max_scan_range),
             masks={k: np.asarray(v) for k, v in sess.masks.items()},
             bm=None if sess.bm is None else {k: np.asarray(getattr(sess.bm, k))
                                              for k in BlockMap._fields})
    return d
