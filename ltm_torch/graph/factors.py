"""Pose-graph factor batches (fixed shapes) and residual evaluation (port of
``ltm.graph.factors``).

Factor types mirror the reference graph (``ltslam/src/LTslam.cpp:565-622``
and ``ltslam/include/ltslam/BetweenFactorWithAnchoring.h:86-100``):

  * prior:    r = Local(measured, x_i)
  * between:  r = Local(measured, Between(x_i, x_j))
  * anchored: r = Local(measured, Between(a_i ∘ x_i, a_j ∘ x_j))

Residuals are whitened by per-factor ``inv_sigma`` 6-vectors (tangent order
[w, v]).  The reference's 1e-12-variance priors become gauge-fixed
variables (``fixed``); robust (Cauchy k=1) factors get IRLS weights.  Each
batch is padded to a capacity with a validity mask.  ``GraphData.host``
keeps NumPy copies of the index arrays, so the solver can lay out the
odometry chains without reading the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from ltm_torch.core import se3

__all__ = ["GraphData", "build_graph_data", "graph_from_arrays", "whitened_residuals",
           "robust_weights", "total_cost", "GRAPH_FIELDS"]

GRAPH_FIELDS = ("poses0", "fixed", "prior_idx", "prior_meas", "prior_inv_sigma", "prior_valid",
                "bet_i", "bet_j", "bet_meas", "bet_inv_sigma", "bet_robust", "bet_valid",
                "anc_i", "anc_j", "anc_ai", "anc_aj", "anc_meas", "anc_inv_sigma", "anc_valid")
_HOST_FIELDS = ("fixed", "bet_i", "bet_j", "bet_valid")


@dataclass(frozen=True)
class GraphData:
    """Padded pose-graph problem on one device."""

    poses0: torch.Tensor        # (V, 4, 4) initial values
    fixed: torch.Tensor         # (V,) gauge-fixed variables (delta pinned to 0)

    prior_idx: torch.Tensor     # (P,)
    prior_meas: torch.Tensor    # (P, 4, 4)
    prior_inv_sigma: torch.Tensor  # (P, 6)
    prior_valid: torch.Tensor   # (P,)

    bet_i: torch.Tensor         # (B,)
    bet_j: torch.Tensor
    bet_meas: torch.Tensor      # (B, 4, 4)
    bet_inv_sigma: torch.Tensor
    bet_robust: torch.Tensor    # (B,) bool — Cauchy robust loss
    bet_valid: torch.Tensor

    anc_i: torch.Tensor         # (A,) node in session 1
    anc_j: torch.Tensor         # (A,) node in session 2
    anc_ai: torch.Tensor        # (A,) anchor of session 1
    anc_aj: torch.Tensor        # (A,) anchor of session 2
    anc_meas: torch.Tensor      # (A, 4, 4)
    anc_inv_sigma: torch.Tensor
    anc_valid: torch.Tensor
    host: Dict[str, np.ndarray] = field(default_factory=dict, compare=False)

    @property
    def num_vars(self) -> int:
        return self.poses0.shape[0]


def graph_from_arrays(arrays: Dict[str, np.ndarray], device) -> GraphData:
    """GraphData from NumPy arrays keyed by ``GRAPH_FIELDS`` (float arrays
    cast to float32, index arrays to int64)."""
    dev = torch.device(device)

    def t(name):
        a = np.asarray(arrays[name])
        if a.dtype == np.bool_:
            return torch.from_numpy(a.copy()).to(dev)
        if np.issubdtype(a.dtype, np.integer):
            return torch.from_numpy(a.astype(np.int64)).to(dev)
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    host = {k: np.asarray(arrays[k]).copy() for k in _HOST_FIELDS}
    return GraphData(**{k: t(k) for k in GRAPH_FIELDS}, host=host)


def build_graph_data(poses0: np.ndarray, fixed: np.ndarray, priors=(), betweens=(),
                     anchored=(), prior_capacity: Optional[int] = None,
                     between_capacity: Optional[int] = None,
                     anchored_capacity: Optional[int] = None, dtype=np.float32,
                     device="cpu") -> GraphData:
    """Host-side assembly into padded device tensors.

    priors: (idx, T (4,4), sigmas (6,)); betweens: (i, j, T, sigmas, robust);
    anchored: (i, j, ai, aj, T, sigmas).  Measurements are cast to float32
    on the host, where ``ltm`` casts them."""

    def pad(items, cap):
        n = len(items)
        cap = cap if cap is not None else max(n, 1)
        if n > cap:
            raise ValueError(f"{n} factors exceed capacity {cap}")
        return cap

    def inv_sigma(sig):
        return 1.0 / np.sqrt(np.asarray(sig, np.float64))

    priors, betweens, anchored = list(priors), list(betweens), list(anchored)
    P = pad(priors, prior_capacity)
    B = pad(betweens, between_capacity)
    A = pad(anchored, anchored_capacity)
    a = {
        "poses0": np.asarray(poses0, dtype), "fixed": np.asarray(fixed, bool),
        "prior_idx": np.zeros(P, np.int32), "prior_meas": np.tile(np.eye(4, dtype=dtype), (P, 1, 1)),
        "prior_inv_sigma": np.ones((P, 6), dtype), "prior_valid": np.zeros(P, bool),
        "bet_i": np.zeros(B, np.int32), "bet_j": np.zeros(B, np.int32),
        "bet_meas": np.tile(np.eye(4, dtype=dtype), (B, 1, 1)),
        "bet_inv_sigma": np.ones((B, 6), dtype), "bet_robust": np.zeros(B, bool),
        "bet_valid": np.zeros(B, bool),
        "anc_i": np.zeros(A, np.int32), "anc_j": np.zeros(A, np.int32),
        "anc_ai": np.zeros(A, np.int32), "anc_aj": np.zeros(A, np.int32),
        "anc_meas": np.tile(np.eye(4, dtype=dtype), (A, 1, 1)),
        "anc_inv_sigma": np.ones((A, 6), dtype), "anc_valid": np.zeros(A, bool),
    }
    for k, (i, T, sig) in enumerate(priors):
        a["prior_idx"][k], a["prior_meas"][k] = i, T
        a["prior_inv_sigma"][k], a["prior_valid"][k] = inv_sigma(sig), True
    for k, (i, j, T, sig, robust) in enumerate(betweens):
        a["bet_i"][k], a["bet_j"][k], a["bet_meas"][k] = i, j, T
        a["bet_inv_sigma"][k], a["bet_robust"][k], a["bet_valid"][k] = inv_sigma(sig), robust, True
    for k, (i, j, ai, aj, T, sig) in enumerate(anchored):
        a["anc_i"][k], a["anc_j"][k], a["anc_ai"][k], a["anc_aj"][k] = i, j, ai, aj
        a["anc_meas"][k], a["anc_inv_sigma"][k], a["anc_valid"][k] = T, inv_sigma(sig), True
    return graph_from_arrays(a, device)


def whitened_residuals(poses: torch.Tensor, g: GraphData):
    """Whitened (not robust-weighted) residual blocks: (prior (P,6),
    between (B,6), anchored (A,6)); invalid factors are zeroed."""
    rp = se3.local(g.prior_meas, poses[g.prior_idx]) * g.prior_inv_sigma
    rp = torch.where(g.prior_valid[:, None], rp, 0.0)

    rb = se3.local(g.bet_meas, se3.between(poses[g.bet_i], poses[g.bet_j])) * g.bet_inv_sigma
    rb = torch.where(g.bet_valid[:, None], rb, 0.0)

    hi = se3.compose(poses[g.anc_ai], poses[g.anc_i])
    hj = se3.compose(poses[g.anc_aj], poses[g.anc_j])
    ra = se3.local(g.anc_meas, se3.between(hi, hj)) * g.anc_inv_sigma
    ra = torch.where(g.anc_valid[:, None], ra, 0.0)
    return rp, rb, ra


def robust_weights(rp, rb, ra, g: GraphData, cauchy_k: float = 1.0):
    """IRLS sqrt-weights w = 1/sqrt(1 + ||r||²/k²) for robust factors
    (gtsam mEstimator::Cauchy, reference ``LTslam.cpp:126-133``)."""
    k2 = cauchy_k * cauchy_k

    def w_of(r, active):
        w = 1.0 / torch.sqrt(1.0 + torch.sum(r * r, -1) / k2)
        return torch.where(active, w, 1.0)

    wb = w_of(rb, g.bet_robust & g.bet_valid)
    wa = w_of(ra, g.anc_valid)       # every inter-session loop is robust in the reference
    wp = torch.ones(rp.shape[0], dtype=rp.dtype, device=rp.device)
    return wp, wb, wa


def total_cost(rp, rb, ra, g: GraphData, cauchy_k: float = 1.0):
    """The robust objective LM accepts or rejects steps against: 0.5||r||²
    for Gaussian factors, the Cauchy ρ for robust ones."""
    k2 = cauchy_k * cauchy_k

    def block(r, robust_mask):
        e2 = torch.sum(r * r, -1)
        return torch.sum(torch.where(robust_mask, 0.5 * k2 * torch.log1p(e2 / k2), 0.5 * e2))

    cp = block(rp, torch.zeros(rp.shape[0], dtype=torch.bool, device=rp.device))
    return cp + block(rb, g.bet_robust & g.bet_valid) + block(ra, g.anc_valid)
