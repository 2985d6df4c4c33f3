"""Levenberg-Marquardt pose-graph solver (port of ``ltm.graph.solver``).

Replaces the reference's GTSAM iSAM2 (``ltslam/src/LTslam.cpp:136-142``,
``:157-184``) with a batch LM:

  * residuals and per-factor 6×6 Jacobian blocks from one vmapped autodiff
    pass (``torch.func.vmap(torch.func.jacfwd(...))``, weights folded in),
    shared by the gradient, the Gauss-Newton products and the
    preconditioner (``ltm``'s single-device, explicit-Jacobian path);
  * normal equations by preconditioned CG, whose stop test is one host read
    an iteration (``count_host_read("pcg")``; ``ltm`` keeps the loop on the
    device);
  * the block-tridiagonal (odometry-chain) preconditioner by block-Thomas
    sweeps, or block-Jacobi;
  * Cauchy robustness as IRLS, gauge handling by frozen variables.

The outer loop runs on the host, as in ``ltm``: one accept test (``done``)
and one cost read a step.

The block-Thomas sweeps keep ``ltm``'s op sequence per variable.  They
run over the independent chains of the graph side by side: a variable
whose subdiagonal block is zero by structure (a fixed variable, the one
after it, or one no adjacent between factor reaches) starts a chain, and
there the sequential recurrence restarts anyway (``C_i = D_i``,
``y_i = r_i``), so the batched sweep gives the sequential one's values
with one step per variable of the longest chain instead of one per
variable.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ltm_torch.core import se3
from ltm_torch.core.config import SolverConfig
from ltm_torch.graph.factors import GraphData, robust_weights, total_cost, whitened_residuals
from ltm_torch.utils import count_host_read

__all__ = ["solve", "marginal_covariance", "SolveInfo"]

# replay the PCG iteration as a CUDA graph on the card (False: every
# iteration eagerly, e.g. to time its parts one call at a time)
CUDA_GRAPHS = True


class SolveInfo(NamedTuple):
    cost_initial: torch.Tensor
    cost_final: torch.Tensor
    iterations: int
    cg_residual: torch.Tensor


def _free(delta: torch.Tensor, g: GraphData) -> torch.Tensor:
    return torch.where(g.fixed[:, None], 0.0, delta)


class FactorJacobians(NamedTuple):
    """Whitened, IRLS-weighted residual Jacobian blocks at δ=0 (validity and
    weights folded in: invalid factors are zero blocks)."""

    Jp: torch.Tensor      # (P, 6, 6) prior ∂r/∂δ_idx
    Jbi: torch.Tensor     # (B, 6, 6) between ∂r/∂δ_i
    Jbj: torch.Tensor     # (B, 6, 6) between ∂r/∂δ_j
    Jai: torch.Tensor     # (A, 6, 6) anchored ∂r/∂δ_i
    Jaj: torch.Tensor     # (A, 6, 6) anchored ∂r/∂δ_j
    Jaai: torch.Tensor    # (A, 6, 6) anchored ∂r/∂δ_anchor_i
    Jaaj: torch.Tensor    # (A, 6, 6) anchored ∂r/∂δ_anchor_j


def _r_prior(d, meas, x, isg):
    return se3.local(meas, se3.retract(x, d)) * isg


def _r_bet(di, dj, meas, xi, xj, isg):
    return se3.local(meas, se3.between(se3.retract(xi, di), se3.retract(xj, dj))) * isg


def _r_anc(di, dj, dai, daj, meas, xi, xj, xai, xaj, isg):
    hi = se3.compose(se3.retract(xai, dai), se3.retract(xi, di))
    hj = se3.compose(se3.retract(xaj, daj), se3.retract(xj, dj))
    return se3.local(meas, se3.between(hi, hj)) * isg


def _factor_jacobians(poses: torch.Tensor, g: GraphData, wb, wa) -> FactorJacobians:
    """Vmapped forward-mode Jacobians of every factor family (weights folded)."""
    z = torch.zeros((g.prior_idx.shape[0], 6), dtype=poses.dtype, device=poses.device)
    Jp = vmap(jacfwd(_r_prior))(z, g.prior_meas, poses[g.prior_idx], g.prior_inv_sigma)
    Jp = Jp * g.prior_valid[:, None, None]

    z = torch.zeros((g.bet_i.shape[0], 6), dtype=poses.dtype, device=poses.device)
    Jbi, Jbj = vmap(jacfwd(_r_bet, argnums=(0, 1)))(
        z, z, g.bet_meas, poses[g.bet_i], poses[g.bet_j], g.bet_inv_sigma)
    wfac = (wb * g.bet_valid)[:, None, None]

    z = torch.zeros((g.anc_i.shape[0], 6), dtype=poses.dtype, device=poses.device)
    Ja = vmap(jacfwd(_r_anc, argnums=(0, 1, 2, 3)))(
        z, z, z, z, g.anc_meas, poses[g.anc_i], poses[g.anc_j], poses[g.anc_ai],
        poses[g.anc_aj], g.anc_inv_sigma)
    wafac = (wa * g.anc_valid)[:, None, None]
    return FactorJacobians(Jp, Jbi * wfac, Jbj * wfac, *(J * wafac for J in Ja))


def _anc_pairs(jac: FactorJacobians, g: GraphData):
    return ((jac.Jai, g.anc_i), (jac.Jaj, g.anc_j), (jac.Jaai, g.anc_ai), (jac.Jaaj, g.anc_aj))


def _gram(J: torch.Tensor) -> torch.Tensor:
    """Σ_i J[f,i,j] J[f,i,k] -> (F, 6, 6) (``einsum("fij,fik->fjk")``)."""
    return torch.matmul(J.transpose(-1, -2), J)


def _precond_blocks(poses, g: GraphData, wb, wa, lam, tridiag: bool = False, jac=None):
    """``(D, L)``: ``D`` (V,6,6) = blockdiag(JᵀWJ) + lam·I and, when
    ``tridiag``, ``L[v] = H[v, v-1]`` from the between factors joining
    adjacent variables (the odometry chains).  Together the exact normal
    matrix of {priors, odometry, damping} plus the diagonal of every other
    factor — SPD, so the block-Thomas factorization needs no pivoting."""
    V = g.num_vars
    if jac is None:
        jac = _factor_jacobians(poses, g, wb, wa)
    blocks = torch.zeros((V, 6, 6), dtype=poses.dtype, device=poses.device)
    blocks.index_add_(0, g.prior_idx, _gram(jac.Jp))
    blocks.index_add_(0, g.bet_i, _gram(jac.Jbi))
    blocks.index_add_(0, g.bet_j, _gram(jac.Jbj))
    for J, idx in _anc_pairs(jac, g):
        blocks.index_add_(0, idx, _gram(J))

    L = None
    if tridiag:
        L = torch.zeros((V, 6, 6), dtype=poses.dtype, device=poses.device)
        fwd = (g.bet_j == g.bet_i + 1)[:, None, None]
        off_ji = torch.matmul(jac.Jbj.transpose(-1, -2), jac.Jbi)      # "frj,fri->fji"
        L.index_add_(0, g.bet_j, torch.where(fwd, off_ji, 0.0))
        rev = (g.bet_i == g.bet_j + 1)[:, None, None]
        off_ij = torch.matmul(jac.Jbi.transpose(-1, -2), jac.Jbj)
        L.index_add_(0, g.bet_i, torch.where(rev, off_ij, 0.0))

    eye = torch.eye(6, dtype=poses.dtype, device=poses.device)
    blocks = blocks + lam * eye
    blocks = torch.where(g.fixed[:, None, None], eye, blocks)      # fixed vars: identity rows
    if tridiag:
        cut = g.fixed | torch.roll(g.fixed, 1)
        L = torch.where(cut[:, None, None], 0.0, L)
        L[0] = 0.0
    return blocks, L


class _Chains(NamedTuple):
    """The independent odometry chains of a graph, laid out side by side:
    ``pos`` (n_chains, max_len) variable indices (``V`` past a chain's end)."""

    pos: torch.Tensor


def _chains(g: GraphData) -> _Chains:
    """Chains from the host copies of the graph's structure: a variable
    starts a chain where its subdiagonal block is structurally zero."""
    h = g.host
    V = g.num_vars
    fixed = h["fixed"].astype(bool)
    linked = np.zeros(V, bool)
    bi, bj, bv = h["bet_i"].astype(np.int64), h["bet_j"].astype(np.int64), h["bet_valid"].astype(bool)
    linked[bj[bv & (bj == bi + 1)]] = True
    linked[bi[bv & (bi == bj + 1)]] = True
    linked &= ~(fixed | np.roll(fixed, 1))
    linked[0] = False
    starts = np.flatnonzero(~linked)
    lengths = np.diff(np.append(starts, V))
    max_len = int(lengths.max())
    steps = np.arange(max_len)
    pos = starts[:, None] + steps[None, :]
    valid = steps[None, :] < lengths[:, None]
    pos = np.where(valid, pos, V)
    return _Chains(torch.from_numpy(pos).to(g.poses0.device))


def _tridiag_factor(D: torch.Tensor, L: torch.Tensor, ch: _Chains):
    """Block-Thomas factorization of the SPD block-tridiagonal (D, L):
    ``Cinv`` with ``C_0 = D_0``, ``C_i = D_i − L_i C_{i-1}⁻¹ L_iᵀ``, as
    ``(n_chains, max_len, 6, 6)`` chain-major blocks (identity past a
    chain's end), with the chain-major ``L``."""
    eye = torch.eye(6, dtype=D.dtype, device=D.device)
    Dc = torch.cat([D, eye[None]])[ch.pos]
    Lc = torch.cat([L, torch.zeros_like(eye)[None]])[ch.pos]
    prev = eye.expand(ch.pos.shape[0], 6, 6)
    out = []
    for i in range(ch.pos.shape[1]):
        L_i = Lc[:, i]
        C = Dc[:, i] - torch.matmul(L_i, torch.matmul(prev, L_i.transpose(-1, -2)))
        prev = torch.linalg.inv_ex(C).inverse
        out.append(prev)
    return torch.stack(out, 1), Lc


def _tridiag_apply(Cinv: torch.Tensor, Lc: torch.Tensor, ch: _Chains, r: torch.Tensor) -> torch.Tensor:
    """Solve M x = r (r: (..., V, 6)) from the factorization: forward
    elimination, then back substitution, over the chains side by side."""
    V = r.shape[-2]
    rc = torch.cat([r, torch.zeros_like(r[..., :1, :])], -2)[..., ch.pos, :]   # (..., n, len, 6)
    n_steps = ch.pos.shape[1]
    u = torch.zeros_like(rc[..., 0, :])
    ys = []
    for i in range(n_steps):
        y_i = rc[..., i, :] - torch.matmul(Lc[:, i], u[..., None])[..., 0]
        u = torch.matmul(Cinv[:, i], y_i[..., None])[..., 0]
        ys.append(y_i)
    x_next = torch.zeros_like(u)
    xs = [None] * n_steps
    for i in range(n_steps - 1, -1, -1):
        L_n = Lc[:, i + 1] if i + 1 < n_steps else torch.zeros_like(Lc[:, 0])
        x_next = torch.matmul(Cinv[:, i], (ys[i] - torch.matmul(L_n.transpose(-1, -2),
                                                                x_next[..., None])[..., 0])[..., None])[..., 0]
        xs[i] = x_next
    xc = torch.stack(xs, -2).flatten(-3, -2)                           # (..., n·len, 6)
    x = torch.zeros(r.shape[:-2] + (V + 1, 6), dtype=r.dtype, device=r.device)
    x.index_copy_(-2, ch.pos.reshape(-1), xc)      # pads (all zero) land on row V
    return x[..., :V, :]


def _fj(J: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-factor J @ v: (F,6,6), (..., F, 6) -> (..., F, 6)."""
    return torch.matmul(J, v[..., None])[..., 0]


def _ftj(J: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-factor Jᵀ @ y."""
    return torch.matmul(J.transpose(-1, -2), y[..., None])[..., 0]


def _grad_from_jacobians(jac: FactorJacobians, rp, rbw, raw, g: GraphData) -> torch.Tensor:
    """Jᵀ r from the factor Jacobians (weights already folded into both)."""
    grad = torch.zeros((g.num_vars, 6), dtype=rp.dtype, device=rp.device)
    grad.index_add_(0, g.prior_idx, _ftj(jac.Jp, rp))
    grad.index_add_(0, g.bet_i, _ftj(jac.Jbi, rbw))
    grad.index_add_(0, g.bet_j, _ftj(jac.Jbj, rbw))
    for J, idx in _anc_pairs(jac, g):
        grad.index_add_(0, idx, _ftj(J, raw))
    return grad


def _hvp_from_jacobians(jac: FactorJacobians, g: GraphData, lam):
    """v ↦ (JᵀWJ + λI) v per factor: y_f = J_f v_{vars(f)}, then the
    scatter-add of J_fᵀ y_f (v: (..., V, 6))."""

    def hvp(v):
        vf = _free(v, g)
        out = torch.zeros_like(v)
        yp = _fj(jac.Jp, vf[..., g.prior_idx, :])
        out.index_add_(-2, g.prior_idx, _ftj(jac.Jp, yp))
        yb = _fj(jac.Jbi, vf[..., g.bet_i, :]) + _fj(jac.Jbj, vf[..., g.bet_j, :])
        out.index_add_(-2, g.bet_i, _ftj(jac.Jbi, yb))
        out.index_add_(-2, g.bet_j, _ftj(jac.Jbj, yb))
        ya = torch.zeros(v.shape[:-2] + (jac.Jai.shape[0], 6), dtype=v.dtype, device=v.device)
        for J, idx in _anc_pairs(jac, g):
            ya = ya + _fj(J, vf[..., idx, :])
        for J, idx in _anc_pairs(jac, g):
            out.index_add_(-2, idx, _ftj(J, ya))
        return out + lam * v

    return hvp


def _pcg(hvp, b, apply_prec, g: GraphData, iters: int, tol: float):
    """Preconditioned CG on (..., V, 6) right-hand sides; fixed variables
    masked out.  Leading dimensions are independent lanes: a lane stops
    (its state frozen) once its relative residual is at most ``tol``, as
    ``ltm``'s while_loop does under ``vmap``; the loop ends when every lane
    has stopped or ``iters`` iterations ran, which the host learns from one
    read an iteration.

    On the card the iteration (``hvp``, the preconditioner's sweeps — some
    three thousand small launches on a 1 000-node graph — and the vector
    updates) is captured once as a CUDA graph after one eager iteration and
    replayed: the same ops on the same buffers, without the host's launch
    cost."""

    def apply_m(r):
        return _free(apply_prec(r), g)

    def dot(a, c):
        return torch.sum(a * c, (-2, -1))

    def step(st):
        """One iteration on the lanes still running; the next iteration's
        "any lane runs" flag."""
        x, r, p, rz, active, it = st
        run = active & (it < iters)
        Ap = _free(hvp(p), g)
        alpha = rz / torch.clamp(dot(p, Ap), min=1e-30)
        x1 = x + alpha[..., None, None] * p
        r1 = r - alpha[..., None, None] * Ap
        z1 = apply_m(r1)
        rz1 = dot(r1, z1)
        beta = rz1 / torch.clamp(rz, min=1e-30)
        p1 = z1 + beta[..., None, None] * p
        still = torch.sqrt(dot(r1, r1)) / b_norm > tol
        run3 = run[..., None, None]
        active = torch.where(run, still, active)
        it = it + run
        new = (torch.where(run3, x1, x), torch.where(run3, r1, r), torch.where(run3, p1, p),
               torch.where(run, rz1, rz), active, it)
        return new, (active & (it < iters)).any()

    r = _free(b, g)
    z = apply_m(r)
    b_norm = torch.sqrt(dot(r, r)) + 1e-30
    lanes = b.shape[:-2]
    st = (torch.zeros_like(b), r, z, dot(r, z), torch.ones(lanes, dtype=torch.bool, device=b.device),
          torch.zeros(lanes, dtype=torch.int64, device=b.device))
    count_host_read("pcg")
    more = iters > 0
    if b.is_cuda and more and CUDA_GRAPHS:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            st, more_t = step(st)                    # the first iteration warms up
            count_host_read("pcg")
            more = bool(more_t)
            if more:
                st = tuple(t.clone() for t in st)    # the graph's own buffers
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, stream=side):
                    new, more_t = step(st)
                    for buf, val in zip(st, new):
                        buf.copy_(val)
                while more:
                    graph.replay()
                    count_host_read("pcg")
                    more = bool(more_t)
        torch.cuda.current_stream().wait_stream(side)
    while more:
        st, more_t = step(st)
        count_host_read("pcg")
        more = bool(more_t)
    x, r = st[0], st[1]
    return x, torch.sqrt(dot(r, r)) / b_norm


def _cost(g: GraphData, poses, cauchy_k):
    rp, rb, ra = whitened_residuals(poses, g)
    return total_cost(rp, rb, ra, g, cauchy_k)


def _make_preconditioner(poses, g, wb, wa, lam, precond: str, jac, chains):
    if precond == "tridiag":
        D, L = _precond_blocks(poses, g, wb, wa, lam, tridiag=True, jac=jac)
        Cinv, Lc = _tridiag_factor(D, L, chains)
        return lambda r: _tridiag_apply(Cinv, Lc, chains, r)
    D, _ = _precond_blocks(poses, g, wb, wa, lam, jac=jac)
    minv = torch.linalg.inv_ex(D).inverse
    return lambda r: torch.matmul(minv, r[..., None])[..., 0]


def _lm_step(g: GraphData, poses, lam, cost, cfg: SolverConfig, chains):
    """One damped Gauss-Newton step (linearize → PCG → accept test).
    Returns (poses1, lam1, cost1, done, cg_res), all on the device."""
    rp, rb, ra = whitened_residuals(poses, g)
    _, wb, wa = robust_weights(rp, rb, ra, g, cfg.cauchy_k)
    jac = _factor_jacobians(poses, g, wb, wa)
    grad = _grad_from_jacobians(jac, rp, rb * wb[:, None], ra * wa[:, None], g)
    b = -_free(grad, g)
    hvp = _hvp_from_jacobians(jac, g, lam)
    apply_prec = _make_preconditioner(poses, g, wb, wa, lam, cfg.preconditioner, jac, chains)
    delta, res = _pcg(hvp, b, apply_prec, g, cfg.cg_iterations, cfg.cg_tol)

    cand = se3.retract(poses, _free(delta, g))
    new_cost = _cost(g, cand, cfg.cauchy_k)
    accept = new_cost < cost
    poses1 = torch.where(accept, cand, poses)
    lam1 = torch.clamp(torch.where(accept, lam * cfg.lambda_down, lam * cfg.lambda_up), 1e-9, 1e6)
    rel_impr = (cost - new_cost) / torch.clamp(cost, min=1e-20)
    done = (accept & (rel_impr < 1e-7)) | (~accept & (lam >= 1e6))
    cost1 = torch.where(accept, new_cost, cost)
    return poses1, lam1, cost1, done, res


def solve(g: GraphData, cfg: SolverConfig = SolverConfig()) -> Tuple[torch.Tensor, SolveInfo]:
    """Optimize; returns (poses (V,4,4), SolveInfo).  The LM loop runs on
    the host: it stops on ``done``, or after three steps in a row that do
    not improve the cost by a relative 1e-7 (``ltm``'s stall exit)."""
    poses = g.poses0
    chains = _chains(g) if cfg.preconditioner == "tridiag" else None
    lam = torch.full((), cfg.lambda_init, dtype=poses.dtype, device=poses.device)
    c0 = _cost(g, poses, cfg.cauchy_k)
    cost = c0
    res = torch.zeros((), dtype=poses.dtype, device=poses.device)
    count_host_read("lm")
    prev_cost = float(c0)
    stall = 0
    it = 0
    for it in range(1, cfg.max_outer_iterations + 1):
        poses, lam, cost, done, res = _lm_step(g, poses, lam, cost, cfg, chains)
        count_host_read("lm")
        if bool(done):
            break
        count_host_read("lm")
        c = float(cost)
        if (prev_cost - c) <= 1e-7 * max(prev_cost, 1e-20):
            stall += 1
            if stall >= 3:
                break
        else:
            stall = 0
        prev_cost = c
    return poses, SolveInfo(c0, cost, it, res)


def marginal_covariance(g: GraphData, poses: torch.Tensor, var_indices, cg_iterations: int = 200,
                        damping: float = 1e-6, cauchy_k: float = 1.0) -> torch.Tensor:
    """(M, 6, 6) marginal covariances Σ_v = (JᵀJ)⁻¹[v, v]: 6·M CG solves
    against unit right-hand sides as lanes of one batched PCG (reference
    ``isam->marginalCovariance``, ``LTslam.cpp:438-439``)."""
    var_indices = torch.as_tensor(var_indices, dtype=torch.long, device=poses.device)
    rp, rb, ra = whitened_residuals(poses, g)
    _, wb, wa = robust_weights(rp, rb, ra, g, cauchy_k)
    jac = _factor_jacobians(poses, g, wb, wa)
    lam = torch.full((), damping, dtype=poses.dtype, device=poses.device)
    hvp = _hvp_from_jacobians(jac, g, lam)
    apply_prec = _make_preconditioner(poses, g, wb, wa, lam, "tridiag", jac, _chains(g))
    M = var_indices.shape[0]
    e = torch.zeros((M, 6, g.num_vars, 6), dtype=poses.dtype, device=poses.device)
    k = torch.arange(6, device=poses.device)
    e[torch.arange(M, device=poses.device)[:, None], k[None, :], var_indices[:, None], k[None, :]] = 1.0
    x, _ = _pcg(hvp, e.reshape(M * 6, g.num_vars, 6), apply_prec, g, cg_iterations, 1e-8)
    x = x.reshape(M, 6, g.num_vars, 6)
    cols = x[torch.arange(M, device=poses.device), :, var_indices, :]   # (M, 6, 6) columns as rows
    return 0.5 * (cols + cols.transpose(-1, -2))
