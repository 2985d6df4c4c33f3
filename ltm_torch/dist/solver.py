"""Distributed pose-graph LM over a mesh of device slots (port of
``ltm.dist.solver``).

The factor batches (priors, betweens, anchored betweens) shard along their
batch axes over the slots (:func:`pad_graph_for_mesh` pads them); poses
replicate.  Two modes (``SolverConfig.dist_mode``):

``"schur"`` (default), ``ltm``'s anchor-Schur pattern: each slot
linearizes its factor shard (whitened residuals, IRLS weights, the 6×6
Jacobian blocks and the weighted residuals), one wave of :func:`concat`
gathers that compact linearized system, and the replicated solve (the
chain preconditioner by block-Thomas, the gradient, PCG with
explicit-Jacobian products) runs once a process on the lead slot with no
collective inside the CG loop; the PCG keeps its CUDA-graph replay there.
Collectives an LM step: the gather wave and one :func:`reduce_sum` of the
candidate cost, whatever the CG iteration count.  The gathered system is
the one-device system plus trailing invalid factors (zero blocks), so the
step's ``delta`` is the one-device step's on the CPU; only the cost's sum
order differs.

``"allreduce"``, ``ltm``'s matrix-free path with ``psum``: each slot
forms the Gauss-Newton products of its shard from ``jvp`` and ``vjp`` of
the weighted residual function (``torch.func``); the gradient, every
product (one :func:`reduce_sum` a CG iteration) and the preconditioner's
factor sums are reduced over the mesh, and the costs too.  The PCG is
captured as a CUDA graph only where every slot is the same device and no
process group is up; otherwise (a product that copies between cards or
runs ``all_reduce``) every iteration runs eagerly.

Every host decision of the LM loop (``done``, the stall test) reads a
reduced cost that every process shares, so every process takes the same
steps and meets every collective.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import jvp, vjp

from ltm_torch.core import se3
from ltm_torch.core.config import SolverConfig
from ltm_torch.dist.mesh import Mesh, concat, local_shards, pad_to_multiple, reduce_sum
from ltm_torch.graph.factors import GraphData, robust_weights, whitened_residuals
from ltm_torch.graph.solver import (
    FactorJacobians,
    SolveInfo,
    _accept,
    _chains,
    _cost,
    _factor_jacobians,
    _free,
    _grad_from_jacobians,
    _hvp_from_jacobians,
    _lm_loop,
    _make_preconditioner,
    _pcg,
    _precond_finish,
    _precond_sums,
    _preconditioner,
    _weighted_residual_fn,
)

__all__ = ["pad_graph_for_mesh", "solve_sharded"]

_FACTOR_PREFIXES = ("prior_", "bet_", "anc_")
# the index and validity fields the schur step gathers with the Jacobians
_INDEX_FIELDS = ("prior_idx", "prior_valid", "bet_i", "bet_j", "bet_valid", "bet_robust",
                 "anc_i", "anc_j", "anc_ai", "anc_aj", "anc_valid")


def _family(name: str) -> Optional[str]:
    return next((p for p in _FACTOR_PREFIXES if name.startswith(p)), None)


def _tensor_fields():
    return [f.name for f in dataclasses.fields(GraphData) if f.name != "host"]


def pad_graph_for_mesh(g: GraphData, n_devices: int) -> GraphData:
    """Every factor batch padded to a multiple of ``n_devices``: padded
    factors are invalid, with index 0 and zero sigmas, and their
    measurements are the identity, so the SE(3) logs and their Jacobians
    stay finite (``NaN · 0`` is NaN).  The host copies pad alike."""
    updates = {}
    for name in _tensor_fields():
        t = getattr(g, name)
        pad = (-t.shape[0]) % n_devices
        if _family(name) is None or pad == 0:
            continue
        if name.endswith("_meas"):
            updates[name] = torch.cat([t, torch.eye(4, dtype=t.dtype, device=t.device)
                                       .expand(pad, 4, 4)])
        else:
            updates[name] = pad_to_multiple(t, n_devices)
    host = {k: (np.concatenate([v, np.zeros((-len(v)) % n_devices, v.dtype)])
                if _family(k) else v) for k, v in g.host.items()}
    return dataclasses.replace(g, **updates, host=host)


def _on(g: GraphData, device, rows: Optional[Dict[str, Tuple[int, int]]] = None) -> GraphData:
    """``g`` on ``device``; with ``rows`` ({family: (start, stop)}) only
    those rows of each factor batch and of their host copies (a slot's
    shard)."""
    def cut(name, t):
        fam = _family(name)
        return t if rows is None or fam is None else t[rows[fam][0]:rows[fam][1]]

    kw = {name: cut(name, getattr(g, name)).to(device) for name in _tensor_fields()}
    return GraphData(**kw, host={k: cut(k, v) for k, v in g.host.items()})


def _slot_graphs(gp: GraphData, mesh: Mesh):
    """(device, factor shard) of this process's slots; poses and ``fixed``
    replicate."""
    shards = {fam: local_shards(mesh, getattr(gp, fam + "valid").shape[0])
              for fam in _FACTOR_PREFIXES}
    return [(d, _on(gp, d, {fam: shards[fam][j][1:] for fam in _FACTOR_PREFIXES}))
            for j, d in enumerate(mesh.slots)]


def _mesh_cost(slots, mesh: Mesh, poses, cauchy_k):
    """The robust cost, each slot's shard on its device, summed over the mesh."""
    return reduce_sum(mesh, [_cost(gs, poses.to(d), cauchy_k) for d, gs in slots])


def _linearize(gs: GraphData, poses, cauchy_k):
    """A shard's whitened residuals and IRLS weights at ``poses``."""
    rp, rb, ra = whitened_residuals(poses, gs)
    _, wb, wa = robust_weights(rp, rb, ra, gs, cauchy_k)
    return rp, rb, ra, wb, wa


def _lm_step_schur(lead: GraphData, slots, mesh: Mesh, chains, cfg: SolverConfig,
                   poses, lam, cost):
    """One LM step, anchor-Schur style: the same damped Gauss-Newton step as
    ``graph.solver._lm_step`` (weights, JᵀWJ, preconditioner, accept test)
    with the linearization gathered once and the solve run locally.
    Returns (poses1, lam1, cost1, done, cg_res) on the lead slot."""
    parts = []
    for d, gs in slots:
        p = poses.to(d)
        rp, rb, ra, wb, wa = _linearize(gs, p, cfg.cauchy_k)
        jac = _factor_jacobians(p, gs, wb, wa)
        parts.append((*jac, rp, rb * wb[:, None], ra * wa[:, None],
                      *(getattr(gs, k) for k in _INDEX_FIELDS)))
    # the one collective wave: the compact linearized system, replicated
    full = [concat(mesh, list(col)) for col in zip(*parts)]
    jac = FactorJacobians(*full[:7])
    rp, rbw, raw = full[7:10]
    gf = dataclasses.replace(lead, **dict(zip(_INDEX_FIELDS, full[10:])))

    grad = _grad_from_jacobians(jac, rp, rbw, raw, gf)
    b = -_free(grad, gf)
    hvp = _hvp_from_jacobians(jac, gf, lam)
    apply_prec = _make_preconditioner(poses, gf, None, None, lam, cfg.preconditioner, jac, chains)
    delta, res = _pcg(hvp, b, apply_prec, gf, cfg.cg_iterations, cfg.cg_tol)

    cand = se3.retract(poses, _free(delta, gf))
    return (*_accept(poses, cand, lam, cost, _mesh_cost(slots, mesh, cand, cfg.cauchy_k), cfg),
            res)


def _gn_product(f, zero, v):
    """Jᵀ(J v) of ``f`` at ``zero``: a ``jvp`` and a ``vjp``."""
    _, jv = jvp(f, (zero,), (v,))
    _, vjp_fn = vjp(f, zero)
    return vjp_fn(jv)[0]


def _lm_step_allreduce(lead: GraphData, slots, mesh: Mesh, chains, cfg: SolverConfig,
                       capture: bool, poses, lam, cost):
    """One LM step with matrix-free products per shard, the gradient, the
    preconditioner's factor sums and every product summed over the mesh
    (``ltm``'s ``_lm_step_body`` with ``axis_name``)."""
    tridiag = cfg.preconditioner == "tridiag"
    grads, Ds, Ls, fns = [], [], [], []
    for d, gs in slots:
        p = poses.to(d)
        _, _, _, wb, wa = _linearize(gs, p, cfg.cauchy_k)
        f = _weighted_residual_fn(p, gs, wb, wa)
        zero = torch.zeros((gs.num_vars, 6), dtype=p.dtype, device=d)
        r0, vjp_fn = vjp(f, zero)
        grads.append(vjp_fn(r0)[0])
        D, L = _precond_sums(p, gs, _factor_jacobians(p, gs, wb, wa), tridiag)
        Ds.append(D)
        Ls.append(L)
        fns.append((d, f, zero))
    grad = reduce_sum(mesh, grads)
    b = -_free(grad, lead)
    D = reduce_sum(mesh, Ds)
    L = reduce_sum(mesh, Ls) if tridiag else None
    apply_prec = _preconditioner(*_precond_finish(D, L, lead, lam), chains)

    def hvp(v):
        vf = _free(v, lead)
        return reduce_sum(mesh, [_gn_product(f, zero, vf.to(d)) for d, f, zero in fns]) + lam * v

    delta, res = _pcg(hvp, b, apply_prec, lead, cfg.cg_iterations, cfg.cg_tol, capture=capture)
    cand = se3.retract(poses, _free(delta, lead))
    return (*_accept(poses, cand, lam, cost, _mesh_cost(slots, mesh, cand, cfg.cauchy_k), cfg),
            res)


def solve_sharded(g: GraphData, mesh: Mesh, cfg: SolverConfig = SolverConfig()
                  ) -> Tuple[torch.Tensor, SolveInfo]:
    """The LM solve with the factor batches sharded over ``mesh``
    (``cfg.dist_mode``: ``"schur"`` or ``"allreduce"``, module docstring);
    returns ``(poses (V,4,4), SolveInfo)`` on the lead slot, as
    ``graph.solver.solve`` does.  The host loop is ``solve``'s, with its
    ``done`` and three-step stall exits; the result agrees with the
    one-device solve up to the order of the reduced sums."""
    gp = pad_graph_for_mesh(g, mesh.size)
    lead = _on(gp, mesh.lead)
    slots = _slot_graphs(gp, mesh)
    chains = _chains(lead) if cfg.preconditioner == "tridiag" else None
    if cfg.dist_mode == "schur":
        step = partial(_lm_step_schur, lead, slots, mesh, chains, cfg)
    elif cfg.dist_mode == "allreduce":
        capture = mesh.group is None and len(set(mesh.slots)) == 1
        step = partial(_lm_step_allreduce, lead, slots, mesh, chains, cfg, capture)
    else:
        raise ValueError(f"unknown dist_mode {cfg.dist_mode!r} (schur, allreduce)")
    return _lm_loop(step, lead.poses0, _mesh_cost(slots, mesh, lead.poses0, cfg.cauchy_k), cfg)
