"""Brute-force k-nearest-neighbour statistics (port of ``ltm.kernels.knn``).

The reference runs PCL kd-tree ``nearestKSearch`` per point with k=2 and
compares the *average of squared L2 distances* against a threshold
(``ltremovert/src/Session.cpp:592-594``).  For k=2, the pipeline's case,
:func:`knn_avg_sqdist` goes through ``knn2_sqdists``: the hand-written CUDA
kernel for CUDA tensors, its plain version for CPU tensors.  Other k take
:func:`knn_sqdists`, the tiled matmul selection with an exact re-score.
ICP's 1-NN, :func:`nn_sqdist_argmin`, selects in the hand-written CUDA
kernel K5b (``kernels/nn_argmin.py``) for CUDA tensors and in its plain
version, :func:`nn_sqdist_argmin_plain`, for CPU tensors.
"""

from __future__ import annotations

import torch

from ltm_torch.kernels.knn2 import knn2_sqdists
from ltm_torch.kernels.nn_argmin import nn_argmin_select
from ltm_torch.kernels.projection import sumsq3

__all__ = ["knn_sqdists", "knn_avg_sqdist", "chunked_knn_avg_sqdist", "nn_sqdist_argmin",
           "nn_sqdist_argmin_plain"]

_BIG = 1e30


def _bbox_mid(xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Midpoint of the masked bounding box (0 where no valid points).
    Centring there bounds the ~|coord|²·eps cancellation error of the
    |q|²+|t|²-2q·t candidate search."""
    lo = torch.where(mask[..., None], xyz, torch.inf).amin(-2)
    hi = torch.where(mask[..., None], xyz, -torch.inf).amax(-2)
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


def _nn_centred(query_xyz, target_xyz, target_mask):
    """The selection's inputs: both point sets centred on the target
    bounding box, the queries' and the targets' squared norms (1e30 at an
    invalid target)."""
    mid = _bbox_mid(target_xyz, target_mask)[..., None, :]
    q_c = query_xyz - mid
    t_c = target_xyz - mid
    q2 = torch.sum(q_c * q_c, -1)
    # an invalid target's |t|² is 1e30, so its distance is exactly 1e30 (the
    # query terms vanish below its ulp): ltm's where(mask, d2, 1e30) without a pass
    t2 = torch.where(target_mask, torch.sum(t_c * t_c, -1), _BIG)
    return q_c, q2, t_c, t2


def _nn_rescore(query_xyz, query_mask, target_xyz, best_d, best_i):
    """The picked pair re-scored exactly as ``(q − t)²`` on the original
    coordinates; 1e30 where nothing was picked and at invalid queries."""
    m = target_xyz.shape[-2]
    sel = torch.gather(target_xyz, -2, torch.clamp(best_i, max=m - 1)[..., None].expand(query_xyz.shape))
    diff = query_xyz - sel
    d_exact = torch.sum(diff * diff, -1)
    best_d = torch.where(best_d < _BIG, d_exact, _BIG)
    return torch.where(query_mask, best_d, _BIG), best_i


def nn_sqdist_argmin(query_xyz, query_mask, target_xyz, target_mask, tile: int = 8192):
    """Nearest valid target: ``(sq_dist (..., N), index (..., N))``, the ICP
    correspondence search.  Leading dimensions are ICP lanes (``ltm`` maps
    one lane with ``vmap``).

    Selection on bbox-centred matmul distances ``|q|² + |t|² − 2q·t``; the
    first index wins among equal minima; the pick is then re-scored exactly
    as ``(q − t)²`` on the original coordinates.  Invalid queries get 1e30.
    CPU tensors take :func:`nn_sqdist_argmin_plain`; CUDA tensors launch the
    hand-written kernel (``kernels/nn_argmin.py``, K5b: the centring, the
    selection and the re-score in its launches; ``tile`` does not change
    its result, and it holds no distance block), and any other device
    raises."""
    if query_xyz.device.type == "cpu":
        return nn_sqdist_argmin_plain(query_xyz, query_mask, target_xyz, target_mask, tile=tile)
    return nn_argmin_select(query_xyz, query_mask, target_xyz, target_mask)


def nn_sqdist_argmin_plain(query_xyz, query_mask, target_xyz, target_mask, tile: int = 8192):
    """The plain version of :func:`nn_sqdist_argmin`, on any device.

    Selection runs over target tiles with a running (min, argmin) — the
    first index wins among equal minima, within a tile (``min``) and across
    tiles (strict ``<``).  The ``(lanes, N, tile)`` distance block is its
    memory peak: two such blocks are live at a time."""
    n, m = query_xyz.shape[-2], target_xyz.shape[-2]
    dev = query_xyz.device
    q_c, q2, t_c, t2 = _nn_centred(query_xyz, target_xyz, target_mask)
    best_d = torch.full(query_xyz.shape[:-1], _BIG, dtype=torch.float32, device=dev)
    best_i = torch.zeros(query_xyz.shape[:-1], dtype=torch.long, device=dev)
    # on the CPU the distance block is cut to query chunks that stay in
    # cache (the per-element arithmetic is the same); the card takes it whole
    q_chunk = n if query_xyz.is_cuda else 256
    for j0 in range(0, m, tile):
        txyz_t = t_c[..., j0:j0 + tile, :].transpose(-1, -2).reshape(-1, 3, min(tile, m - j0))
        t2_j = t2[..., None, j0:j0 + tile]
        for i0 in range(0, n, q_chunk):
            qc = q_c[..., i0:i0 + q_chunk, :]
            # (|q|² + |t|²) − 2·q·t in one GEMM epilogue: 2·q·t is exact, so
            # the one rounding of the fused form is ltm's
            s2 = (q2[..., i0:i0 + q_chunk, None] + t2_j).reshape(-1, qc.shape[-2], txyz_t.shape[-1])
            d2 = torch.baddbmm(s2, qc.reshape(-1, qc.shape[-2], 3), txyz_t, alpha=-2.0).clamp_(min=0.0)
            tile_min, tile_arg = torch.min(d2, -1)
            del s2, d2
            tile_min = tile_min.reshape(qc.shape[:-1])
            tile_arg = tile_arg.reshape(qc.shape[:-1])
            cur_d, cur_i = best_d[..., i0:i0 + q_chunk], best_i[..., i0:i0 + q_chunk]
            take = tile_min < cur_d
            best_d[..., i0:i0 + q_chunk] = torch.where(take, tile_min, cur_d)
            best_i[..., i0:i0 + q_chunk] = torch.where(take, tile_arg + j0, cur_i)
    return _nn_rescore(query_xyz, query_mask, target_xyz, best_d, best_i)
