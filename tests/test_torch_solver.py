"""The port's pose-graph solver against ``ltm``'s and the SciPy f64 oracle of
``tests/test_solver_oracle.py``, on the CPU.

  * ``solve`` on the same ``GraphData`` (built by ``ltm``, carried across
    by ``slam/convert.py``): poses within 1e-4 of ``ltm``'s;
  * ``marginal_covariance``: within 1e-3 of the block's largest entry of
    ``ltm``'s;
  * the SciPy bounds: pose error < 1e-3 (quadratic graph), < 2e-3 and the
    robust cost within 1e-3 (anchored graph), marginals within 5% of the
    dense (JᵀJ)⁻¹;
  * the block-tridiagonal preconditioner (chains side by side) against a
    dense solve of the same block-tridiagonal matrix, and against
    ``ltm``'s sequential sweeps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import least_squares, minimize

from ltm.core.config import SolverConfig as JSolverConfig
from ltm.graph import build_graph_data as j_build
from ltm.graph import marginal_covariance as j_marginals
from ltm.graph import solve as j_solve
from ltm.graph import solver as jsolver
from ltm_torch.core.config import SolverConfig
from ltm_torch.graph import marginal_covariance, solve
from ltm_torch.graph import solver as tsolver
from ltm_torch.graph.factors import robust_weights, whitened_residuals
from ltm_torch.slam.convert import graph_from_arrays, graph_to_arrays

from test_solver_oracle import (N, _anchored_graph, _exp_se3, _oracle_cost, _oracle_residuals,
                                _pack_tangent, _pose_err, _quadratic_graph, _unpack)

torch.set_num_threads(1)


def graphs():
    gt, init, fixed, priors, betweens = _quadratic_graph()
    quad = (np.asarray(init, np.float32), fixed, dict(priors=priors, betweens=betweens))
    init, fixed, priors, betweens, anchored = _anchored_graph()
    anc = (np.asarray(init, np.float32), fixed,
           dict(priors=priors, betweens=betweens, anchored=anchored))
    return {"quadratic": quad, "anchored": anc}


@pytest.fixture(scope="module")
def solved():
    out = {}
    for name, (init, fixed, kw) in graphs().items():
        jg = j_build(init, fixed, **kw)
        tg = graph_from_arrays(graph_to_arrays(jg), "cpu")
        iters = 50 if name == "quadratic" else 60
        jp, _ = j_solve(jg, JSolverConfig(max_outer_iterations=iters))
        tp, info = solve(tg, SolverConfig(max_outer_iterations=iters))
        out[name] = (jg, tg, np.asarray(jp), tp, info)
    return out


@pytest.mark.parametrize("name", ["quadratic", "anchored"])
def test_solve_matches_ltm(solved, name):
    _, _, jp, tp, info = solved[name]
    np.testing.assert_allclose(tp.numpy(), jp, atol=1e-4)
    assert info.iterations >= 1


@pytest.mark.parametrize("name", ["quadratic", "anchored"])
def test_marginals_match_ltm(solved, name):
    jg, tg, jp, tp, _ = solved[name]
    var = np.flatnonzero(~np.asarray(jg.fixed))
    ref = np.asarray(j_marginals(jg, jnp.asarray(jp), jnp.asarray(var, jnp.int32),
                                 cg_iterations=400, damping=1e-8))
    got = marginal_covariance(tg, tp, var, cg_iterations=400, damping=1e-8).numpy()
    for m in range(len(var)):
        np.testing.assert_allclose(got[m], ref[m], atol=1e-3 * np.abs(ref[m]).max())


def test_solve_matches_scipy_lm(solved):
    gt, init, fixed, priors, betweens = _quadratic_graph()
    n_free = int((~fixed).sum())
    fun = lambda x: _oracle_residuals(x, init, fixed, priors, betweens)
    res = least_squares(fun, np.zeros(6 * n_free), method="lm", xtol=1e-14, ftol=1e-14)
    oracle = _unpack(res.x, init, fixed)
    poses = solved["quadratic"][3].numpy().astype(np.float64)
    assert _pose_err(poses, oracle) < 1e-3
    cost = 0.5 * np.sum(_oracle_residuals(np.zeros(0), list(poses), np.ones(N, bool), priors,
                                          betweens) ** 2)
    assert abs(cost - res.cost) / res.cost < 1e-4


def test_robust_anchored_matches_scipy_minimize(solved):
    init, fixed, priors, betweens, anchored = _anchored_graph()
    n_free = int((~np.asarray(fixed)).sum())
    fun = lambda x: _oracle_cost(x, init, fixed, priors, betweens, anchored)
    res = minimize(fun, np.zeros(6 * n_free), method="BFGS", options={"gtol": 1e-10, "maxiter": 2000})
    poses = solved["anchored"][3].numpy().astype(np.float64)
    cost = fun(_pack_tangent(poses, init, fixed))
    assert abs(cost - res.fun) / max(res.fun, 1e-9) < 1e-3
    assert _pose_err(poses, _unpack(res.x, init, fixed)) < 2e-3


def test_marginals_match_dense_inverse(solved):
    _, tg, _, tp, _ = solved["quadratic"]
    _, _, fixed, priors, betweens = _quadratic_graph()
    base = list(tp.numpy().astype(np.float64))
    free = [i for i in range(N) if not fixed[i]]
    fun = lambda x: _oracle_residuals(x, base, fixed, priors, betweens)
    eps = 1e-6
    J = np.stack([(fun(e) - fun(-e)) / (2 * eps) for e in np.eye(6 * len(free)) * eps], 1)
    Sigma = np.linalg.inv(J.T @ J)
    got = marginal_covariance(tg, tp, free, cg_iterations=400, damping=1e-8).numpy()
    for m in range(len(free)):
        blk = Sigma[6 * m:6 * m + 6, 6 * m:6 * m + 6]
        np.testing.assert_allclose(got[m], blk, atol=0.05 * np.abs(blk).max())


def _chain_graph(seed=7, n=30):
    """Two odometry chains with fixed heads, an isolated variable and loop
    factors: several chains of different lengths."""
    rng = np.random.default_rng(seed)
    V = 2 * n + 1
    poses = [_exp_se3(rng.normal(scale=0.3, size=6)) for _ in range(V)]
    fixed = np.zeros(V, bool)
    fixed[[0, n]] = True
    betweens = []
    for c0 in (0, n):
        for i in range(c0, c0 + n - 1):
            betweens.append((i, i + 1, np.linalg.inv(poses[i]) @ poses[i + 1]
                             @ _exp_se3(rng.normal(scale=0.01, size=6)), (1e-2,) * 6, False))
    betweens.append((3, n + 5, np.linalg.inv(poses[3]) @ poses[n + 5], (0.5,) * 6, True))
    betweens.append((9, 2, np.linalg.inv(poses[9]) @ poses[2], (0.5,) * 6, True))
    priors = [(2 * n, poses[2 * n], (1e-2,) * 6)]
    init = [p @ _exp_se3(rng.normal(scale=0.02, size=6)) for p in poses]
    return j_build(np.asarray(init, np.float32), fixed, priors=priors, betweens=betweens)


def test_tridiag_matches_dense_and_ltm():
    jg = _chain_graph()
    tg = graph_from_arrays(graph_to_arrays(jg), "cpu")
    poses = tg.poses0
    rp, rb, ra = whitened_residuals(poses, tg)
    _, wb, wa = robust_weights(rp, rb, ra, tg)
    lam = torch.tensor(1e-3)
    D, L = tsolver._precond_blocks(poses, tg, wb, wa, lam, tridiag=True)
    chains = tsolver._chains(tg)
    assert chains.pos.shape[0] > 2            # several chains, laid side by side
    Cinv, Lc = tsolver._tridiag_factor(D, L, chains)
    r = torch.from_numpy(np.random.default_rng(1).normal(size=(tg.num_vars, 6)).astype(np.float32))
    x = tsolver._tridiag_apply(Cinv, Lc, chains, r).numpy()

    V = tg.num_vars
    M = np.zeros((6 * V, 6 * V))
    Dn, Ln = D.numpy().astype(np.float64), L.numpy().astype(np.float64)
    for v in range(V):
        M[6 * v:6 * v + 6, 6 * v:6 * v + 6] = Dn[v]
        if v:
            M[6 * v:6 * v + 6, 6 * v - 6:6 * v] = Ln[v]
            M[6 * v - 6:6 * v, 6 * v:6 * v + 6] = Ln[v].T
    dense = np.linalg.solve(M, r.numpy().astype(np.float64).ravel()).reshape(V, 6)
    np.testing.assert_allclose(x, dense, rtol=1e-3, atol=1e-4 * np.abs(dense).max())

    # ltm's sequential block-Thomas sweeps on the same blocks
    Cj = jax.jit(jsolver._tridiag_factor)(D.numpy(), L.numpy())
    xj = np.asarray(jax.jit(jsolver._tridiag_apply)(Cj, L.numpy(), r.numpy()))
    np.testing.assert_allclose(x, xj, rtol=1e-4, atol=1e-5 * np.abs(xj).max())
    # a batch of right-hand sides (the marginals' lanes) solves lane by lane
    xb = tsolver._tridiag_apply(Cinv, Lc, chains, torch.stack([r, 2 * r])).numpy()
    np.testing.assert_allclose(xb[1], 2 * x, rtol=1e-6, atol=1e-6 * np.abs(x).max())


def test_jacobi_preconditioner_solves(solved):
    """``preconditioner="jacobi"`` reaches the tridiagonal solve's optimum."""
    _, tg, _, tp, _ = solved["anchored"]
    poses, _ = solve(tg, SolverConfig(max_outer_iterations=60, preconditioner="jacobi"))
    np.testing.assert_allclose(poses.numpy(), tp.numpy(), atol=1e-3)
