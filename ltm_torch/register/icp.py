"""Point-to-point ICP, batched over lanes (port of ``ltm.register.icp``).

Mirrors the observable semantics of PCL ``IterativeClosestPoint`` as the
reference uses it (``ltslam/src/LTslam.cpp:206-217``): nearest-neighbour
correspondences (``kernels.knn.nn_sqdist_argmin``), a weighted Umeyama
rigid update an iteration, the incremental-transform and MSE-change stops
of ``DefaultConvergenceCriteria``, and ``getFitnessScore()`` = mean
squared NN distance of the aligned source.

``ltm`` runs one pair per ``vmap`` lane inside a ``lax.while_loop`` whose
finished lanes are frozen by ``lax.cond``/select; here every tensor carries
the lane axis first and an iteration updates only the lanes still running
(``torch.where`` on the lane mask), so a lane's sequence of updates does not
depend on which other lanes share its batch.  The loop's stop test reads
the device once an iteration (``count_host_read("icp")``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ltm_torch.core import se3
from ltm_torch.kernels.knn import nn_sqdist_argmin
from ltm_torch.utils import count_host_read

__all__ = ["ICPResult", "icp_point_to_point", "icp_batch", "icp_batch_compacted", "fitness_score"]

CRIT_NONE = 0           # degenerate inputs — no iteration ran
CRIT_TRANSFORM_EPS = 1  # consecutive-transform change below epsilon
CRIT_ABS_MSE = 2        # |MSE_k - MSE_{k-1}| below euclidean_fitness_epsilon
CRIT_MAX_ITER = 3       # iteration budget exhausted


class ICPResult(NamedTuple):
    transform: torch.Tensor   # (..., 4, 4) target_from_source correction
    converged: torch.Tensor   # PCL hasConverged(): true on any criterion exit,
                              # false only for degenerate (empty) inputs
    fitness: torch.Tensor     # mean squared NN distance (PCL getFitnessScore)
    iterations: torch.Tensor
    criterion: torch.Tensor   # int32 CRIT_*


def _cross_rows(X: torch.Tensor, a: int, b: int) -> torch.Tensor:
    return torch.linalg.cross(X[..., a, :], X[..., b, :], dim=-1)


def _det3(X: torch.Tensor) -> torch.Tensor:
    return torch.sum(X[..., 0, :] * _cross_rows(X, 1, 2), -1)


def _opt_rotation(H: torch.Tensor) -> torch.Tensor:
    """Optimal rotation of the Umeyama problem from ``H = Σ w·src·dstᵀ``
    (..., 3, 3): the orthogonal polar factor of Hᵀ by Higham's
    determinant-scaled Newton iteration ``X ← (γX + (γX)^{-T})/2``,
    ``γ = |det X|^{-1/3}``, 9 steps.  The SVD route survives only as the
    fallback where ``det(X0) ≤ 1e-12`` (reflection or rank loss); it is
    computed only when some lane needs it (one host read)."""
    A = H.transpose(-1, -2)
    nf = torch.sqrt(torch.sum(A * A, (-2, -1)))
    X = A / torch.clamp(nf, min=1e-30)[..., None, None]
    det0 = _det3(X)
    for _ in range(9):
        det = _det3(X)
        safe = torch.where(torch.abs(det) > 1e-30, det, 1.0)
        cof = torch.stack([_cross_rows(X, 1, 2), _cross_rows(X, 2, 0), _cross_rows(X, 0, 1)], -2)
        XinvT = cof / safe[..., None, None]
        g = (torch.abs(safe) ** (-1.0 / 3.0))[..., None, None]
        X = 0.5 * (g * X + XinvT / g)
    need_svd = det0 <= 1e-12
    count_host_read("icp")
    if not bool(need_svd.any()):
        return X
    U, _, Vt = torch.linalg.svd(H)
    V = Vt.transpose(-1, -2)
    d = torch.sign(_det3(V @ U.transpose(-1, -2)))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1))
    R_svd = V @ D @ U.transpose(-1, -2)
    return torch.where(need_svd[..., None, None], R_svd, X)


# On the card a lane's sums must not depend on its batch: cuBLAS picks a
# batched GEMM's kernel by the batch count (a lane alone took a split-K
# kernel), and a reduction's launch shape, so its order, follows the number
# of outputs, so a lane summed its terms in another order alone than inside
# a batch of 8, and ICP's result depended on its batch.  There each lane's
# sum over its points and each lane's small matrix product is one call of
# one lane's shape.  On the CPU the batched calls already give each lane
# the bits of a lane alone.

def _lane_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.sum(x, dim)`` over each lane's points: ``x`` is (B, N) or
    (B, N, 3), lanes first; a call a lane on the card."""
    if not x.is_cuda:
        return torch.sum(x, dim)
    d = dim % x.dim() - 1
    return torch.stack([torch.sum(lane, d) for lane in x])


def _lane_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` a lane, lanes first (B, m, k) @ (B, k, n); one GEMM a lane
    on the card."""
    if not a.is_cuda:
        return torch.matmul(a, b)
    return torch.stack([torch.mm(x.contiguous(), y.contiguous()) for x, y in zip(a, b)])


def _cross_covariance(a: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``aᵀ d`` a lane, (B, 3, 3) from (B, N, 3) pairs."""
    return _lane_matmul(a.transpose(-1, -2), d)


def _umeyama_rigid(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted least-squares rigid transform dst ≈ R @ src + t, (..., 4, 4)."""
    wsum = torch.clamp(_lane_sum(w, -1), min=1e-12)[..., None]
    ws = w[..., None]
    cs = _lane_sum(src * ws, -2) / wsum
    cd = _lane_sum(dst * ws, -2) / wsum
    H = _cross_covariance((src - cs[..., None, :]) * ws, dst - cd[..., None, :])
    R = _opt_rotation(H)
    t = cd - _lane_matmul(R, cs[..., None])[..., 0]
    return se3.from_rot_trans(R, t)


def _transform_eps_hit(delta: torch.Tensor, transformation_epsilon) -> torch.Tensor:
    """PCL's transform test on the INCREMENTAL per-iteration transform:
    ``(trace(R) − 1)/2 ≥ 1 − eps`` and squared step translation ``≤ eps``."""
    cos_angle = 0.5 * (delta[..., 0, 0] + delta[..., 1, 1] + delta[..., 2, 2] - 1.0)
    trans_sqr = torch.sum(delta[..., :3, 3] ** 2, -1)
    return (cos_angle >= 1.0 - transformation_epsilon) & (trans_sqr <= transformation_epsilon)


class _Lanes(NamedTuple):
    """The carried state of a batch of ICP lanes."""

    T: torch.Tensor          # (B, 4, 4)
    done: torch.Tensor       # (B,) bool
    n_it: torch.Tensor       # (B,) int32
    prev_mse: torch.Tensor   # (B,)
    crit: torch.Tensor       # (B,) int32


def _iterate(src, sm, tgt, tm, st: _Lanes, it_cap: int, max_d2: float, trans_eps: float,
             fit_eps: float, iterations: int, tile: int) -> _Lanes:
    """Up to ``iterations`` ICP iterations from a carried state; a lane runs
    while it is not done and under ``it_cap`` (the body of ``ltm``'s
    ``_icp_segment``: the same update per lane, just resumable)."""
    for _ in range(iterations):
        run = ~st.done & (st.n_it < it_cap)
        count_host_read("icp")
        if not bool(run.any()):
            break
        moved = se3.transform_points(st.T, src)
        d2, idx = nn_sqdist_argmin(moved, sm, tgt, tm, tile=tile)
        w = (sm & (d2 <= max_d2)).to(src.dtype)
        dst = torch.gather(tgt, -2, idx[..., None].expand(idx.shape + (3,)))
        delta = _umeyama_rigid(moved, dst, w)
        T_new = _lane_matmul(delta, st.T)
        eps_hit = _transform_eps_hit(delta, trans_eps)
        mse = _lane_sum(w * d2, -1) / torch.clamp(_lane_sum(w, -1), min=1.0)
        mse_hit = torch.abs(mse - st.prev_mse) < fit_eps
        crit = torch.where(eps_hit, CRIT_TRANSFORM_EPS,
                           torch.where(mse_hit, CRIT_ABS_MSE, st.crit)).to(torch.int32)
        st = _Lanes(torch.where(run[:, None, None], T_new, st.T),
                    torch.where(run, eps_hit | mse_hit, st.done),
                    torch.where(run, st.n_it + 1, st.n_it),
                    torch.where(run, mse, st.prev_mse),
                    torch.where(run, crit, st.crit))
    return st


def _max_d2(max_correspondence_distance, update_trim_distance) -> float:
    trim = max_correspondence_distance if update_trim_distance is None else update_trim_distance
    return float(np.float32(min(max_correspondence_distance, trim)) ** 2)


def _start(src, sm, tgt, tm, init_transforms):
    B = src.shape[0]
    dev = src.device
    if init_transforms is None:
        init_transforms = se3.identity((B,), src.dtype, dev)
    has = sm.any(-1) & tm.any(-1)
    st = _Lanes(init_transforms.to(src.dtype).clone(), ~has,
                torch.zeros(B, dtype=torch.int32, device=dev),
                torch.full((B,), torch.inf, dtype=src.dtype, device=dev),
                torch.full((B,), CRIT_NONE, dtype=torch.int32, device=dev))
    return has, st


def fitness_score(src_xyz, src_mask, tgt_xyz, tgt_mask, T, tile: int = 4096):
    """PCL getFitnessScore: mean squared NN distance of the aligned source
    (leading dimensions are lanes)."""
    moved = se3.transform_points(T, src_xyz)
    d2, _ = nn_sqdist_argmin(moved, src_mask, tgt_xyz, tgt_mask, tile=tile)
    w = src_mask.to(src_xyz.dtype)
    return (_lane_sum(torch.where(src_mask, d2, 0.0), -1)
            / torch.clamp(_lane_sum(w, -1), min=1.0))


def icp_batch(src_xyz, src_mask, tgt_xyz, tgt_mask, init_transforms=None,
              max_correspondence_distance: float = 150.0, max_iterations: int = 100,
              transformation_epsilon: float = 1e-6, euclidean_fitness_epsilon: float = 1e-6,
              tile: int = 4096, update_trim_distance: Optional[float] = None,
              coarse_iterations: int = 0, coarse_stride: int = 4) -> ICPResult:
    """B independent ICPs, (B,N,3), (B,N), (B,M,3), (B,M): every lane runs
    until it stops or the batch is done (``ltm``'s vmapped
    ``icp_point_to_point``).

    ``coarse_iterations > 0`` first iterates against every
    ``coarse_stride``-th target point, then refines on the full target (the
    iteration count carries over; the stop state restarts)."""
    max_d2 = _max_d2(max_correspondence_distance, update_trim_distance)
    has, st = _start(src_xyz, src_mask, tgt_xyz, tgt_mask, init_transforms)
    if coarse_iterations > 0:
        st = _iterate(src_xyz, src_mask, tgt_xyz[:, ::coarse_stride], tgt_mask[:, ::coarse_stride],
                      st, coarse_iterations, max_d2, transformation_epsilon,
                      euclidean_fitness_epsilon, coarse_iterations, tile)
        st = _Lanes(st.T, ~has, st.n_it, torch.full_like(st.prev_mse, torch.inf),
                    torch.full_like(st.crit, CRIT_NONE))
    st = _iterate(src_xyz, src_mask, tgt_xyz, tgt_mask, st, max_iterations, max_d2,
                  transformation_epsilon, euclidean_fitness_epsilon, max_iterations, tile)
    fit = fitness_score(src_xyz, src_mask, tgt_xyz, tgt_mask, st.T, tile=tile)
    crit = torch.where(has & ~st.done, CRIT_MAX_ITER, st.crit).to(torch.int32)
    return ICPResult(st.T, has, fit, st.n_it, crit)


def icp_point_to_point(src_xyz, src_mask, tgt_xyz, tgt_mask, init_transform=None, **kw) -> ICPResult:
    """One pair: (N,3), (N,), (M,3), (M,) — :func:`icp_batch` on one lane."""
    init = None if init_transform is None else init_transform[None]
    res = icp_batch(src_xyz[None], src_mask[None], tgt_xyz[None], tgt_mask[None], init, **kw)
    return ICPResult(*(x[0] for x in res))


def icp_batch_compacted(src_xyz, src_mask, tgt_xyz, tgt_mask, init_transforms=None,
                        max_correspondence_distance: float = 150.0, max_iterations: int = 100,
                        transformation_epsilon: float = 1e-6,
                        euclidean_fitness_epsilon: float = 1e-6, tile: int = 4096,
                        update_trim_distance: Optional[float] = None, segment: int = 25,
                        width: int = 32, **_ignored) -> ICPResult:
    """B independent ICPs with lane compaction: rounds of ``segment``
    iterations over chunks of ``width`` unfinished lanes, repacked each round
    from one host read of ``done`` and the iteration counts.  Each lane's
    update sequence does not depend on batching, so the result equals
    :func:`icp_batch`'s.  Lanes with no source or no target point never
    run.  ``coarse_iterations`` is not supported here."""
    B = src_xyz.shape[0]
    dev = src_xyz.device
    max_d2 = _max_d2(max_correspondence_distance, update_trim_distance)
    has_t, st = _start(src_xyz, src_mask, tgt_xyz, tgt_mask, init_transforms)
    count_host_read("icp")
    has = has_t.cpu().numpy()
    active = np.flatnonzero(has)
    while active.size:
        for c0 in range(0, active.size, width):
            idx_np = active[c0:c0 + width]
            if idx_np.size < width:      # pad with the last lane: same result, written twice
                idx_np = np.concatenate([idx_np, np.repeat(idx_np[-1:], width - idx_np.size)])
            idx = torch.from_numpy(idx_np).to(dev)
            out = _iterate(src_xyz[idx], src_mask[idx], tgt_xyz[idx], tgt_mask[idx],
                           _Lanes(*(x[idx] for x in st)), max_iterations, max_d2,
                           transformation_epsilon, euclidean_fitness_epsilon, segment, tile)
            st = _Lanes(*(x.index_copy(0, idx, y) for x, y in zip(st, out)))
        count_host_read("icp")
        done_h = st.done.cpu().numpy()
        it_h = st.n_it.cpu().numpy()
        active = np.flatnonzero(has & ~done_h & (it_h < max_iterations))

    crit = torch.where(has_t & ~st.done, CRIT_MAX_ITER, st.crit).to(torch.int32)
    fits = []
    for c0 in range(0, B, width):
        sl = slice(c0, min(c0 + width, B))
        if not has[sl].any():          # all-empty chunk (lane-bucket padding): 0 by definition
            fits.append(torch.zeros(sl.stop - sl.start, dtype=src_xyz.dtype, device=dev))
            continue
        fits.append(fitness_score(src_xyz[sl], src_mask[sl], tgt_xyz[sl], tgt_mask[sl], st.T[sl],
                                  tile=tile))
    fit = torch.cat(fits) if fits else torch.zeros(0, dtype=src_xyz.dtype, device=dev)
    return ICPResult(st.T, has_t, fit, st.n_it, crit)
