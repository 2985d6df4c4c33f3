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

Every sum of factor contributions into variables (the gradient, the
preconditioner's blocks, the Gauss-Newton product) is one fixed-order
scatter-sum (``kernels.scatter``) over a plan built once a graph on the
host: priors, then the between factors' ``i`` and ``j`` ends, then the
anchored factors' four ends, each in factor order — ``index_add_``'s order
on the CPU, whose bits it keeps, and on the card a sum that repeats bit for
bit, where ``index_add_``'s atomics did not.  The Gauss-Newton product
takes that sum inside its own kernel on the card (K5c,
``kernels/gn_product.py``: the factors' ``J v``, then each variable's
``Jᵀ y`` in the plan's order), once a PCG iteration.

The block-Thomas sweeps keep ``ltm``'s op sequence per variable.  They
run over the independent chains of the graph side by side: a variable
whose subdiagonal block is zero by structure (a fixed variable, the one
after it, or one no adjacent between factor reaches) starts a chain, and
there the sequential recurrence restarts anyway (``C_i = D_i``,
``y_i = r_i``), so the batched sweep gives the sequential one's values
with one step per variable of the longest chain instead of one per
variable.  On CPU tensors the sweeps are the plain loops of
``kernels/tridiag.py`` (a batched torch op a step); on the card each
factor and each solve is one launch of ``csrc/tridiag.cu`` (K5a: a CTA a
chain; a CTA a chain and a group of lanes, one dependent 6×6 mat-vec a
step), the solve inside the PCG's CUDA graph.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ltm_torch.core import se3
from ltm_torch.core.config import SolverConfig
from ltm_torch.graph.factors import GraphData, robust_weights, total_cost, whitened_residuals
from ltm_torch.kernels.gn_product import GnPlan, gn_product, gn_product_plain, plan_gn_product
from ltm_torch.kernels.scatter import ScatterPlan, fixed_order_sum, plan_scatter
from ltm_torch.kernels.tridiag import (tridiag_apply, tridiag_apply_plain, tridiag_factor,
                                      tridiag_factor_plain)
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


def _weighted_residual_fn(poses: torch.Tensor, g: GraphData, wb, wa):
    """``f(delta)``: the flat whitened residual at ``retract(poses, delta)``
    with the IRLS weights ``wb``, ``wa`` held fixed (``ltm``'s
    ``_weighted_residual_fn``, the function whose ``jvp`` and ``vjp`` give
    the matrix-free Gauss-Newton products)."""

    def f(delta):
        rp, rb, ra = whitened_residuals(se3.retract(poses, _free(delta, g)), g)
        return torch.cat([rp.reshape(-1), (rb * wb[:, None]).reshape(-1),
                          (ra * wa[:, None]).reshape(-1)])

    return f


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


_FACTOR_ENDS = ("prior_idx", "bet_i", "bet_j", "anc_i", "anc_j", "anc_ai", "anc_aj")


class _Scatters(NamedTuple):
    """A graph's scatter plans: ``ends``, the contributions of every
    factor end in ``_FACTOR_ENDS`` order; ``chain``, the subdiagonal's
    (the between factors' ``j`` ends, then their ``i`` ends).  Invalid
    factors (zero Jacobian blocks, so zero contributions) and, in
    ``chain``, the between factors that join no adjacent pair (masked to
    zero) are left out.  ``product``: the Gauss-Newton product's plan
    (``ends`` with the end index arrays and the fixed variables)."""

    ends: ScatterPlan
    chain: ScatterPlan
    product: GnPlan


def _scatters(g: GraphData) -> _Scatters:
    """The plans of ``g``, from its host index copies, built on first use
    and kept on the graph."""
    plans = g.__dict__.get("_scatters")
    if plans is None:
        h, V, dev = g.host, g.num_vars, g.poses0.device
        valid = {"prior": h["prior_valid"], "bet": h["bet_valid"], "anc": h["anc_valid"]}
        keep = np.concatenate([valid[k.split("_")[0]] for k in _FACTOR_ENDS])
        bi, bj = h["bet_i"].astype(np.int64), h["bet_j"].astype(np.int64)
        chain_keep = np.concatenate([h["bet_valid"] & (bj == bi + 1),
                                     h["bet_valid"] & (bi == bj + 1)])
        ends = plan_scatter(np.concatenate([h[k] for k in _FACTOR_ENDS]), V, dev, keep)
        plans = _Scatters(
            ends, plan_scatter(np.concatenate([h["bet_j"], h["bet_i"]]), V, dev, chain_keep),
            plan_gn_product(ends, [h[k] for k in _FACTOR_ENDS], h["fixed"], dev))
        object.__setattr__(g, "_scatters", plans)
    return plans


def _ends(per_factor, jac: FactorJacobians):
    """``per_factor(J, k)`` of every factor end k, in ``_FACTOR_ENDS``
    order, concatenated along the factor axis (-2)."""
    js = (jac.Jp, jac.Jbi, jac.Jbj, jac.Jai, jac.Jaj, jac.Jaai, jac.Jaaj)
    return torch.cat([per_factor(J, k) for k, J in enumerate(js)], -2)


def _gram(J: torch.Tensor) -> torch.Tensor:
    """Σ_i J[f,i,j] J[f,i,k] -> (F, 6, 6) (``einsum("fij,fik->fjk")``)."""
    return torch.matmul(J.transpose(-1, -2), J)


def _precond_blocks(poses, g: GraphData, wb, wa, lam, tridiag: bool = False, jac=None):
    """``(D, L)``: ``D`` (V,6,6) = blockdiag(JᵀWJ) + lam·I and, when
    ``tridiag``, ``L[v] = H[v, v-1]`` from the between factors joining
    adjacent variables (the odometry chains).  Together the exact normal
    matrix of {priors, odometry, damping} plus the diagonal of every other
    factor — SPD, so the block-Thomas factorization needs no pivoting."""
    if jac is None:
        jac = _factor_jacobians(poses, g, wb, wa)
    return _precond_finish(*_precond_sums(poses, g, jac, tridiag), g, lam)


def _precond_sums(poses, g: GraphData, jac: FactorJacobians, tridiag: bool = False):
    """The factor sums of :func:`_precond_blocks` (blockdiag(JᵀWJ) and, when
    ``tridiag``, the subdiagonal), before damping, the fixed-variable
    identity and the chain cut: over a shard of the factors, the part that
    a sharded solve sums across the mesh before :func:`_precond_finish`
    (``ltm``'s ``psum`` in ``_precond_blocks``)."""
    V = g.num_vars
    plans = _scatters(g)
    grams = _ends(lambda J, _: _gram(J).reshape(-1, 36), jac)
    blocks = fixed_order_sum(grams, plans.ends).reshape(V, 6, 6)

    L = None
    if tridiag:
        fwd = (g.bet_j == g.bet_i + 1)[:, None, None]
        off_ji = torch.matmul(jac.Jbj.transpose(-1, -2), jac.Jbi)      # "frj,fri->fji"
        rev = (g.bet_i == g.bet_j + 1)[:, None, None]
        off_ij = torch.matmul(jac.Jbi.transpose(-1, -2), jac.Jbj)
        offs = torch.cat([torch.where(fwd, off_ji, 0.0), torch.where(rev, off_ij, 0.0)])
        L = fixed_order_sum(offs.reshape(-1, 36), plans.chain).reshape(V, 6, 6)
    return blocks, L


def _precond_finish(blocks, L, g: GraphData, lam):
    """``(D, L)`` of :func:`_precond_blocks` from the factor sums: damping,
    identity rows at fixed variables, the chain cut at them."""
    eye = torch.eye(6, dtype=blocks.dtype, device=blocks.device)
    blocks = blocks + lam * eye
    blocks = torch.where(g.fixed[:, None, None], eye, blocks)      # fixed vars: identity rows
    if L is not None:
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
    """Block-Thomas factorization of the SPD block-tridiagonal (D, L) over
    the chains ``ch``: ``(Cinv, Lc, P)``, chain-major (n_chains, max_len, 6,
    6) (``kernels/tridiag.py``).  CPU tensors take the plain loop, CUDA
    tensors launch the kernel (K5a); any other device raises."""
    if D.device.type == "cpu":
        return tridiag_factor_plain(D, L, ch.pos)
    if D.device.type == "cuda":
        return tridiag_factor(D, L, ch.pos)
    raise ValueError(f"_tridiag_factor runs on cuda or cpu, not {D.device}")


def _tridiag_apply(Cinv: torch.Tensor, Lc: torch.Tensor, P: torch.Tensor, ch: _Chains,
                   r: torch.Tensor) -> torch.Tensor:
    """Solve M x = r (r: (..., V, 6)) from the factorization, over the
    chains side by side (``kernels/tridiag.py``): the plain loop on CPU
    tensors (from ``Cinv`` and ``Lc``), the kernel (K5a, from ``Cinv`` and
    ``P``) on CUDA tensors; any other device raises."""
    if r.device.type == "cpu":
        return tridiag_apply_plain(Cinv, Lc, ch.pos, r)
    if r.device.type == "cuda":
        return tridiag_apply(Cinv, P, ch.pos, r)
    raise ValueError(f"_tridiag_apply runs on cuda or cpu, not {r.device}")


def _ftj(J: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-factor Jᵀ @ y."""
    return torch.matmul(J.transpose(-1, -2), y[..., None])[..., 0]


def _grad_from_jacobians(jac: FactorJacobians, rp, rbw, raw, g: GraphData) -> torch.Tensor:
    """Jᵀ r from the factor Jacobians (weights already folded into both)."""
    res = (rp, rbw, rbw, raw, raw, raw, raw)
    return fixed_order_sum(_ends(lambda J, k: _ftj(J, res[k]), jac), _scatters(g).ends)


def _hvp_from_jacobians(jac: FactorJacobians, g: GraphData, lam):
    """v ↦ (JᵀWJ + λI) v (v: (..., V, 6)), the Gauss-Newton product
    (``kernels/gn_product.py``): per factor y_f = Σ_ends J_e v_{idx_e}, then
    each variable's fixed-order sum of J_eᵀ y_f(e), plus λ v.  CPU tensors
    take the plain version, CUDA tensors launch the kernel (K5c), its
    scratch made at the first call for the lanes it is given (before the
    PCG captures its iteration); any other device raises."""
    plan = _scatters(g).product
    scratch = {}
    if jac.Jp.device.type == "cuda":
        jac = tuple(J.contiguous() for J in jac)

    def hvp(v):
        if v.device.type == "cpu":
            return gn_product_plain(jac, plan, v, lam)
        if v.device.type == "cuda":
            return gn_product(jac, plan, v, lam, scratch)
        raise ValueError(f"the Gauss-Newton product runs on cuda or cpu, not {v.device}")

    return hvp


def _pcg(hvp, b, apply_prec, g: GraphData, iters: int, tol: float, capture: bool = True,
         stats=None):
    """Preconditioned CG on (..., V, 6) right-hand sides; fixed variables
    masked out.  Leading dimensions are independent lanes: a lane stops
    (its state frozen) once its relative residual is at most ``tol``, as
    ``ltm``'s while_loop does under ``vmap``; the loop ends when every lane
    has stopped or ``iters`` iterations ran, which the host learns from one
    read an iteration.

    On the card the iteration (``hvp``, the preconditioner's solve — one
    kernel launch — and the vector updates) is captured once as a CUDA
    graph after one eager iteration and replayed: the same ops on the same buffers, without the host's launch
    cost.  ``capture=False`` runs every iteration eagerly (an ``hvp`` that
    copies between devices or runs a collective).  A ``stats`` dict gets
    ``"iterations"``, the iterations each lane ran (int64, on the device)."""

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
    if b.is_cuda and more and CUDA_GRAPHS and capture:
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
    if stats is not None:
        stats["iterations"] = st[5]
    return x, torch.sqrt(dot(r, r)) / b_norm


def _cost(g: GraphData, poses, cauchy_k):
    rp, rb, ra = whitened_residuals(poses, g)
    return total_cost(rp, rb, ra, g, cauchy_k)


def _make_preconditioner(poses, g, wb, wa, lam, precond: str, jac, chains):
    D, L = _precond_blocks(poses, g, wb, wa, lam, tridiag=precond == "tridiag", jac=jac)
    return _preconditioner(D, L, chains)


def _preconditioner(D, L, chains):
    """``apply(r) -> M⁻¹ r`` from the finished blocks: block-Thomas sweeps
    over the chains when there is a subdiagonal ``L``, block-Jacobi else."""
    if L is not None:
        Cinv, Lc, P = _tridiag_factor(D, L, chains)
        return lambda r: _tridiag_apply(Cinv, Lc, P, chains, r)
    minv = torch.linalg.inv_ex(D).inverse
    return lambda r: torch.matmul(minv, r[..., None])[..., 0]


def _accept(poses, cand, lam, cost, new_cost, cfg: SolverConfig):
    """The LM accept test and damping update of a step from ``poses`` to
    the candidate ``cand``: (poses1, lam1, cost1, done).  ``done``: an
    accepted step stopped improving, or the damping saturated while steps
    keep being rejected."""
    accept = new_cost < cost
    poses1 = torch.where(accept, cand, poses)
    lam1 = torch.clamp(torch.where(accept, lam * cfg.lambda_down, lam * cfg.lambda_up), 1e-9, 1e6)
    rel_impr = (cost - new_cost) / torch.clamp(cost, min=1e-20)
    done = (accept & (rel_impr < 1e-7)) | (~accept & (lam >= 1e6))
    cost1 = torch.where(accept, new_cost, cost)
    return poses1, lam1, cost1, done


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
    return (*_accept(poses, cand, lam, cost, _cost(g, cand, cfg.cauchy_k), cfg), res)


def _lm_loop(step, poses, c0, cfg: SolverConfig) -> Tuple[torch.Tensor, SolveInfo]:
    """The host LM loop over ``step(poses, lam, cost) -> (poses1, lam1,
    cost1, done, cg_res)`` from the initial cost ``c0``: it stops on
    ``done``, or after three steps in a row that do not improve the cost by
    a relative 1e-7 (``ltm``'s stall exit)."""
    lam = torch.full((), cfg.lambda_init, dtype=poses.dtype, device=poses.device)
    cost = c0
    res = torch.zeros((), dtype=poses.dtype, device=poses.device)
    count_host_read("lm")
    prev_cost = float(c0)
    stall = 0
    it = 0
    for it in range(1, cfg.max_outer_iterations + 1):
        poses, lam, cost, done, res = step(poses, lam, cost)
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


def solve(g: GraphData, cfg: SolverConfig = SolverConfig()) -> Tuple[torch.Tensor, SolveInfo]:
    """Optimize; returns (poses (V,4,4), SolveInfo).  The LM loop runs on
    the host (:func:`_lm_loop`)."""
    chains = _chains(g) if cfg.preconditioner == "tridiag" else None
    return _lm_loop(lambda poses, lam, cost: _lm_step(g, poses, lam, cost, cfg, chains),
                    g.poses0, _cost(g, g.poses0, cfg.cauchy_k), cfg)


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
