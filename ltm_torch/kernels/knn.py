"""Brute-force k-nearest-neighbour statistics (port of ``ltm.kernels.knn``).

The reference runs PCL kd-tree ``nearestKSearch`` per point with k=2 and
compares the *average of squared L2 distances* against a threshold
(``ltremovert/src/Session.cpp:592-594``).  For k=2, the pipeline's case,
:func:`knn_avg_sqdist` goes through ``knn2_sqdists``: the hand-written CUDA
kernel for CUDA tensors, its plain version for CPU tensors.  Other k take
:func:`knn_sqdists`, the tiled matmul selection with an exact re-score.
"""

from __future__ import annotations

import torch

from ltm_torch.kernels.knn2 import knn2_sqdists
from ltm_torch.kernels.projection import sumsq3

__all__ = ["knn_sqdists", "knn_avg_sqdist", "chunked_knn_avg_sqdist"]

_BIG = 1e30


def _bbox_mid(xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Midpoint of the masked bounding box (0 where no valid points).
    Centring there bounds the ~|coord|²·eps cancellation error of the
    |q|²+|t|²-2q·t candidate search."""
    lo = torch.where(mask[:, None], xyz, torch.inf).amin(0)
    hi = torch.where(mask[:, None], xyz, -torch.inf).amax(0)
    return torch.where(torch.isfinite(lo), 0.5 * (lo + hi), 0.0)


def knn_sqdists(query_xyz, query_mask, target_xyz, target_mask, k: int = 2,
                tile: int = 8192, refine: int = 16):
    """Squared distances to the k nearest valid targets, (N, k) ascending.

    Selection runs on bbox-centred matmul distances (full float32: the TF32
    pins of ``ltm_torch.device``) with a top-max(k, refine) slack carried
    through the target tiles; the kept candidates are re-scored exactly as
    (q-t)² on the ORIGINAL coordinates and the k smallest returned.
    Invalid queries get 1e30 rows; fewer than k valid targets pads with 1e30.
    """
    n, m = query_xyz.shape[0], target_xyz.shape[0]
    dev = query_xyz.device
    if m == 0:
        return torch.full((n, k), _BIG, dtype=torch.float32, device=dev)
    k_run = max(k, min(refine, m))
    mid = _bbox_mid(target_xyz, target_mask)
    q_c = query_xyz - mid
    t_c = target_xyz - mid
    q2 = (q_c * q_c).sum(-1)
    best_d = torch.full((n, k_run), _BIG, dtype=torch.float32, device=dev)
    best_i = torch.zeros((n, k_run), dtype=torch.long, device=dev)
    for j0 in range(0, m, tile):
        txyz = t_c[j0:j0 + tile]
        t2 = (txyz * txyz).sum(-1)
        d2 = q2[:, None] + t2[None, :] - 2.0 * (q_c @ txyz.T)
        d2 = torch.where(target_mask[None, j0:j0 + tile], torch.clamp(d2, min=0.0), _BIG)
        ids = torch.arange(j0, j0 + txyz.shape[0], device=dev).expand(n, -1)
        merged = torch.cat([best_d, d2], 1)
        best_d, pos = torch.topk(merged, k_run, dim=1, largest=False)
        best_i = torch.gather(torch.cat([best_i, ids], 1), 1, pos)
    sel = target_xyz[best_i]                                 # (N, k_run, 3)
    d_exact = sumsq3(query_xyz[:, None, :] - sel)
    d_exact = torch.where(target_mask[best_i] & (best_d < _BIG), d_exact, _BIG)
    d_exact = torch.sort(d_exact, dim=-1).values[:, :k]
    return torch.where(query_mask[:, None], d_exact, _BIG)


def knn_avg_sqdist(query_xyz, query_mask, target_xyz, target_mask, k: int = 2,
                   tile: int = 8192):
    """Average of the k nearest squared distances (the Removert kNN
    statistic).

    k=2 goes to ``knn2_sqdists`` at any extent and any size.  ``ltm`` gates
    its Pallas kernel to extents ≤256 m and ≤2^21 targets because that
    kernel selects on the inexact matmul form and Mosaic's compile time
    grows with the target grid (``ltm/kernels/knn.py:128-146``); the CUDA
    kernel selects on the exact direct form and compiles once, so it needs
    neither gate."""
    if k == 2:
        d = knn2_sqdists(query_xyz, query_mask, target_xyz, target_mask)
    else:
        d = knn_sqdists(query_xyz, query_mask, target_xyz, target_mask, k=k, tile=tile)
    return d.mean(-1)


def chunked_knn_avg_sqdist(query_xyz, query_mask, target_xyz, target_mask,
                           k: int = 2, tile: int = 8192, query_chunk: int = 16384):
    """Map-scale kNN statistic.  On the card with k=2 this is ONE kernel
    launch over all queries; otherwise queries stream in ``query_chunk``
    chunks to bound the plain versions' memory."""
    if query_xyz.is_cuda and k == 2:
        return knn_avg_sqdist(query_xyz, query_mask, target_xyz, target_mask, k=k)
    return torch.cat([
        knn_avg_sqdist(query_xyz[i:i + query_chunk], query_mask[i:i + query_chunk],
                       target_xyz, target_mask, k=k, tile=tile)
        for i in range(0, max(query_xyz.shape[0], 1), query_chunk)
    ])
