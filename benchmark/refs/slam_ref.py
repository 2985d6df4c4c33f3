"""Plain reference of LT-SLAM's outputs: Scan Context retrieval between two
sessions, and the ground truth of the survey for the loops' relative poses
and the aligned trajectories.

The retrieval is a frozen transcription of ``tests/ref_oracle_slam.py`` at
commit 15258b49d6b0 (written line against line from
``ltslam/src/Scancontext.cpp``: ``makeScancontext`` :151-195, ring and
sector keys :197-226, ``distDirectSC`` :69-90, ``fastAlignUsingVkey``
:93-113, ``distanceBtnScanContext`` :116-148,
``detectLoopClosureIDBetweenSession`` :263-324), recast from per-point
loops to tensor operations, in any float type.  The ground truth comes from
the benchmark's own generator.  Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def scan_contexts(scans: Sequence[np.ndarray], sc: dict, dtype=torch.float64) -> torch.Tensor:
    """(N, R, S) descriptors: per bin the highest z + lidar height, 0 where
    no point falls (``makeScancontext``)."""
    R, S, rmax, h = sc["num_ring"], sc["num_sector"], sc["max_radius"], sc["lidar_height"]
    lens = [len(s) for s in scans]
    pts = torch.from_numpy(np.concatenate([np.asarray(s)[:, :3] for s in scans])).to(dtype)
    sid = torch.repeat_interleave(torch.arange(len(scans)), torch.tensor(lens))
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2] + h
    r = torch.sqrt(x * x + y * y)
    theta = torch.rad2deg(torch.atan2(y, x))
    theta = torch.where(theta < 0, theta + 360.0, theta)
    ring = torch.clamp(torch.ceil(r / rmax * R), 1, R).long() - 1
    sector = torch.clamp(torch.ceil(theta / 360.0 * S), 1, S).long() - 1
    keep = r <= rmax
    flat = (sid * R * S + ring * S + sector)[keep]
    desc = torch.full((len(scans) * R * S,), -1000.0, dtype=dtype)
    desc.scatter_reduce_(0, flat, z[keep], "amax")
    desc = torch.where(desc == -1000.0, torch.zeros_like(desc), desc)
    return desc.reshape(len(scans), R, S)


def _direct_dist(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``distDirectSC`` over leading batch dims: (..., R, S) pairs."""
    nq, nt = torch.linalg.norm(q, dim=-2), torch.linalg.norm(t, dim=-2)
    eff = (nq > 0) & (nt > 0)
    sim = (q * t).sum(-2) / torch.where(eff, nq * nt, torch.ones_like(nq))
    n_eff = eff.sum(-1)
    mean = torch.where(eff, sim, torch.zeros_like(sim)).sum(-1) / n_eff.clamp(min=1)
    return torch.where(n_eff > 0, 1.0 - mean, torch.ones_like(mean))


def detect_loops(query_descs: torch.Tensor, target_descs: torch.Tensor, sc: dict) -> np.ndarray:
    """Loop target of each query node (-1: none): ring-key 3-NN candidates,
    sector-key pre-alignment, the column-cosine distance on ±10 % of the
    shifts around it, the best candidate under the threshold."""
    S = query_descs.shape[-1]
    rq, rt = query_descs.mean(-1), target_descs.mean(-1)
    d2 = ((rq[:, None, :] - rt[None, :, :]) ** 2).sum(-1)
    k = min(sc["num_candidates"], target_descs.shape[0])
    cand = torch.sort(d2, dim=1, stable=True).indices[:, :k]              # (Q, k)
    vq, vt = query_descs.mean(-2), target_descs.mean(-2)                  # sector keys
    shifts = torch.arange(S)
    vt_rolls = torch.stack([torch.roll(vt, int(s), dims=-1) for s in shifts], 1)  # (T, S, S)
    dv = torch.linalg.norm(vq[:, None, None, :] - vt_rolls[cand], dim=-1)  # (Q, k, S)
    v_shift = torch.argmin(dv, -1)                                        # first minimum
    radius = int(round(0.5 * sc["search_ratio"] * S))
    offs = torch.arange(-radius, radius + 1)
    space = torch.sort((v_shift[..., None] + offs) % S, dim=-1).values    # (Q, k, 2r+1)
    t_descs = target_descs[cand]                                          # (Q, k, R, S)
    cols = (torch.arange(S)[None, None, None, :] - space[..., None]) % S   # roll right by s
    rolled = torch.gather(t_descs[:, :, None].expand(-1, -1, space.shape[-1], -1, -1), -1,
                          cols[:, :, :, None, :].expand(-1, -1, -1, t_descs.shape[-2], -1))
    dist = _direct_dist(query_descs[:, None, None], rolled)               # (Q, k, 2r+1)
    best_over_shift = dist.min(-1).values                                 # first minimum
    best_c = torch.argmin(best_over_shift, -1)
    best_d = best_over_shift.gather(1, best_c[:, None])[:, 0]
    loop = torch.where(best_d < sc["dist_threshold"], cand.gather(1, best_c[:, None])[:, 0], -1)
    return loop.numpy()


def relative_truth(site_t: np.ndarray, site_s: np.ndarray, dtype=torch.float64) -> np.ndarray:
    """Ground truth of an anchored loop's measurement: the source node's
    pose in the target node's frame, inv(T_t) T_s, computed in ``dtype``."""
    a = torch.from_numpy(site_t).to(dtype)
    b = torch.from_numpy(site_s).to(dtype)
    R, t = a[..., :3, :3], a[..., :3, 3:]
    inv = torch.cat([torch.cat([R.transpose(-1, -2), -R.transpose(-1, -2) @ t], -1),
                     a.new_tensor([0, 0, 0, 1]).expand(a.shape[:-2] + (1, 4))], -2)
    return (inv @ b).double().numpy()


def ate_rmse(poses: Dict[str, np.ndarray], truth: Dict[str, np.ndarray]) -> float:
    """RMSE of the keyframe positions of every session against the truth."""
    err = np.concatenate([np.linalg.norm(poses[n][:, :3, 3] - truth[n][:, :3, 3], axis=1)
                          for n in truth])
    return float(np.sqrt(np.mean(err ** 2)))
