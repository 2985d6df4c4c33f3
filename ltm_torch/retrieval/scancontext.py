"""Scan Context retrieval: ring/sector keys + dense batched distance (port
of ``ltm.retrieval.scancontext``).

Reference pipeline (``ltslam/src/Scancontext.cpp``):
  * ring key  = row-wise means, queried for the top-3 candidates
    (``detectLoopClosureIDBetweenSession``, ``:263-324``);
  * sector key = column-wise means, used to pick a best circular shift, then
    the column-cosine distance on ±10% of shifts around it
    (``distanceBtnScanContext``, ``:116-148``);
  * distance  = 1 − mean over mutually non-empty columns of the column
    cosine similarity (``distDirectSC``, ``:69-90``).

``ltm`` streams the 60 column shifts through ``lax.scan`` with a running
(min, argmin); here all shifts of the target stack go through one batched
matmul and the running minimum becomes ``min`` over the shift axis, which
keeps the first shift among equal minima as the strict ``<`` update does.
``lax.top_k`` on ring-key distances returns the lowest index first among
ties; ``torch.topk`` promises no order, so candidates come from a stable
sort.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ltm_torch.core.config import ScanContextConfig

__all__ = ["ring_keys", "sector_keys", "sc_distance_matrix", "detect_loops_between_sessions",
           "detect_loops_intra_session", "config_kwargs"]

_BIG = 1e9


def ring_keys(descs: torch.Tensor) -> torch.Tensor:
    """(K, R, S) -> (K, R) row-wise means (``makeRingkeyFromScancontext``)."""
    return descs.mean(-1)


def sector_keys(descs: torch.Tensor) -> torch.Tensor:
    """(K, R, S) -> (K, S) column-wise means (``makeSectorkeyFromScancontext``)."""
    return descs.mean(-2)


def _normalized_columns(descs: torch.Tensor):
    """Unit-normalize descriptor columns; zero columns stay zero.
    Returns (normalized (K,R,S), nonzero-column indicator (K,S))."""
    norms = torch.sqrt(torch.sum(descs * descs, -2))           # (K, S)
    nonzero = norms > 0
    inv = torch.where(nonzero, 1.0 / torch.clamp(norms, min=1e-20), 0.0)
    return descs * inv[..., None, :], nonzero


def _all_rolls(x: torch.Tensor) -> torch.Tensor:
    """(T, ..., S) -> (S, T, ..., S): ``x`` rolled right by s along its last
    axis, for s = 0..S-1 (``jnp.roll(x, s, axis=-1)``)."""
    S = x.shape[-1]
    cols = (torch.arange(S, device=x.device)[None, :] - torch.arange(S, device=x.device)[:, None]) % S
    return x[..., cols].movedim(-2, 0)


def sc_distance_matrix(query_descs: torch.Tensor, target_descs: torch.Tensor,
                       full_shift_search: bool = False,
                       search_ratio: float = 0.1) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-pairs Scan Context distance + best shift: ``(dist (Q, T),
    shift (Q, T) int32)``.  ``shift`` is the number of columns the target
    must be rolled right to align with the query (yaw = shift·2π/S)."""
    S = query_descs.shape[-1]
    Q, T = query_descs.shape[0], target_descs.shape[0]
    qn, qnz = _normalized_columns(query_descs)
    tn, tnz = _normalized_columns(target_descs)
    qn_flat = qn.reshape(Q, -1)                                  # (Q, R*S)
    qnzf = qnz.to(qn.dtype)                                      # (Q, S)
    shifts = torch.arange(S, dtype=torch.int32, device=qn.device)

    tns = _all_rolls(tn).reshape(S, T, -1)                       # (S, T, R*S)
    tnzs = _all_rolls(tnz.to(qn.dtype))                          # (S, T, S)
    score = torch.matmul(qn_flat, tns.transpose(-1, -2))        # (S, Q, T)
    neff = torch.matmul(qnzf, tnzs.transpose(-1, -2))           # (S, Q, T)
    d = torch.where(neff > 0, 1.0 - score / torch.clamp(neff, min=1.0), _BIG)
    if not full_shift_search:
        # sector-key pre-alignment (fastAlignUsingVkey, Scancontext.cpp:93-113)
        vq = sector_keys(query_descs)                            # (Q, S)
        vt = sector_keys(target_descs)                           # (T, S)
        vq2 = torch.sum(vq * vq, -1)
        vt2 = torch.sum(vt * vt, -1)
        cross = torch.matmul(vq, _all_rolls(vt).transpose(-1, -2))   # (S, Q, T)
        vdists = vq2[:, None] + vt2[None, :] - 2.0 * cross
        best_vshift = torch.argmin(vdists, 0).to(torch.int32)    # (Q, T)
        radius = round(0.5 * search_ratio * S)
        delta = torch.abs(shifts[:, None, None] - best_vshift[None])
        circ = torch.minimum(delta, S - delta)
        d = torch.where(circ <= radius, d, _BIG)
    dist, shift = torch.min(d, 0)
    return dist, shift.to(torch.int32)


def _best_candidates(dist, shift, rd, allowed, query_mask, dist_threshold, num_candidates, S):
    """Ring-key top-k candidate gate + best-distance threshold."""
    rd = torch.where(allowed, rd, _BIG)
    k = min(num_candidates, rd.shape[1])
    cand_idx = torch.sort(rd, dim=1, stable=True).indices[:, :k]
    cand_mask = torch.zeros_like(rd, dtype=torch.bool)
    cand_mask.scatter_(1, cand_idx, True)
    cand_mask &= allowed
    masked = torch.where(cand_mask, dist, _BIG)
    best_t = torch.argmin(masked, 1)
    best_d = torch.gather(masked, 1, best_t[:, None])[:, 0]
    best_s = torch.gather(shift, 1, best_t[:, None])[:, 0]
    found = (best_d < dist_threshold) & query_mask
    loop_idx = torch.where(found, best_t.to(torch.int32), -1)
    yaw = best_s.to(torch.float32) * (2.0 * math.pi / S)
    return loop_idx, best_d, yaw


def _ring_sqdists(rq: torch.Tensor, rt: torch.Tensor) -> torch.Tensor:
    rq2 = torch.sum(rq * rq, -1)
    rt2 = torch.sum(rt * rt, -1)
    return rq2[:, None] + rt2[None, :] - 2.0 * (rq @ rt.T)


def detect_loops_between_sessions(query_descs, query_mask, target_descs, target_mask,
                                  dist_threshold: float = 0.3, num_candidates: int = 3,
                                  full_shift_search: bool = False, search_ratio: float = 0.1,
                                  mesh=None):
    """Batched ``detectLoopClosureIDBetweenSession`` over every source node:
    ``(loop_idx (Q,) int32 [-1 = no loop], dist (Q,), yaw_rad (Q,))``.
    With ``mesh`` the all-pairs distance, the dominant cost, shards its
    query rows (``ltm_torch.dist.sharding.sc_distance_sharded``); the
    candidate selection stays replicated."""
    if mesh is not None:
        from ltm_torch.dist.sharding import sc_distance_sharded

        dist, shift = sc_distance_sharded(mesh, query_descs, target_descs,
                                          full_shift_search=full_shift_search,
                                          search_ratio=search_ratio)
    else:
        dist, shift = sc_distance_matrix(query_descs, target_descs,
                                         full_shift_search=full_shift_search,
                                         search_ratio=search_ratio)
    rd = _ring_sqdists(ring_keys(query_descs), ring_keys(target_descs))
    allowed = target_mask[None, :].expand(rd.shape)
    return _best_candidates(dist, shift, rd, allowed, query_mask, dist_threshold,
                            num_candidates, query_descs.shape[-1])


def detect_loops_intra_session(descs, valid, dist_threshold: float = 0.3,
                               num_exclude_recent: int = 30, num_candidates: int = 3,
                               full_shift_search: bool = False, search_ratio: float = 0.1):
    """Batched within-session loop detection (``SCManager::detectLoopClosureID``,
    ``Scancontext.cpp:327-418``): every node queries the nodes at least
    ``num_exclude_recent`` older than itself."""
    K = descs.shape[0]
    dist, shift = sc_distance_matrix(descs, descs, full_shift_search=full_shift_search,
                                     search_ratio=search_ratio)
    rk = ring_keys(descs)
    rd = _ring_sqdists(rk, rk)
    q_idx = torch.arange(K, device=descs.device)
    allowed = (q_idx[None, :] <= q_idx[:, None] - num_exclude_recent) & valid[None, :]
    return _best_candidates(dist, shift, rd, allowed, valid, dist_threshold,
                            num_candidates, descs.shape[-1])


def config_kwargs(cfg: ScanContextConfig) -> dict:
    return dict(dist_threshold=cfg.dist_threshold, num_candidates=cfg.num_candidates,
                full_shift_search=cfg.full_shift_search, search_ratio=cfg.search_ratio)
