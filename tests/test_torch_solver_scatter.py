"""The pose-graph solver's fixed-order scatter-sums (``kernels/scatter.py``)
on the CPU.

  * ``fixed_order_sum`` (and its plain version) equals ``index_add_`` bit
    for bit on the solver fixtures' graphs and on a graph whose anchors
    have a degree in the hundreds: the plan's order is ``index_add_``'s on
    the CPU;
  * ``solve`` and ``marginal_covariance`` give, bit for bit, what the same
    functions give with their sums taken by ``index_add_`` (the solver's
    ``_precond_sums``, ``_grad_from_jacobians`` and
    ``_hvp_from_jacobians`` written with ``index_add_``, below);
  * the plan's layout (CSR lists, the rows by degree, the padded table)
    and its checks;
  * the kernel's schedule written out in Python (``_kernel_schedule_sum``:
    a warp a row in the plan's order, the row's list 32 entries at a time,
    ``32 // width`` contribution rows a load or passes of 32 elements,
    ``_STEPS`` loads before their adds) equals ``index_add_`` bit for bit
    at rows of 1 to 70 elements.

The kernel needs the card: ``chip_smoke.py`` holds it to the plain version
there, and holds a solve on the card to itself.
"""

import numpy as np
import pytest
import torch

from ltm_torch.core.config import SolverConfig
from ltm_torch.graph import marginal_covariance, solve
from ltm_torch.graph import solver as tsolver
from ltm_torch.graph.factors import build_graph_data
from ltm_torch.kernels.scatter import fixed_order_sum, fixed_order_sum_plain, plan_scatter
from ltm_torch.slam.convert import graph_from_arrays, graph_to_arrays

from test_solver_oracle import _exp_se3
from test_torch_solver import _chain_graph, graphs

torch.set_num_threads(1)


# ---- the solver's sums written with index_add_ -----------------------------------

def _anc_pairs(jac, g):
    return ((jac.Jai, g.anc_i), (jac.Jaj, g.anc_j), (jac.Jaai, g.anc_ai), (jac.Jaaj, g.anc_aj))


def _fj(J, v):
    """Per-factor J @ v: (F,6,6), (..., F, 6) -> (..., F, 6)."""
    return torch.matmul(J, v[..., None])[..., 0]


def _precond_sums_index_add(poses, g, jac, tridiag=False):
    V = g.num_vars
    blocks = torch.zeros((V, 6, 6), dtype=poses.dtype, device=poses.device)
    blocks.index_add_(0, g.prior_idx, tsolver._gram(jac.Jp))
    blocks.index_add_(0, g.bet_i, tsolver._gram(jac.Jbi))
    blocks.index_add_(0, g.bet_j, tsolver._gram(jac.Jbj))
    for J, idx in _anc_pairs(jac, g):
        blocks.index_add_(0, idx, tsolver._gram(J))
    L = None
    if tridiag:
        L = torch.zeros((V, 6, 6), dtype=poses.dtype, device=poses.device)
        fwd = (g.bet_j == g.bet_i + 1)[:, None, None]
        off_ji = torch.matmul(jac.Jbj.transpose(-1, -2), jac.Jbi)
        L.index_add_(0, g.bet_j, torch.where(fwd, off_ji, 0.0))
        rev = (g.bet_i == g.bet_j + 1)[:, None, None]
        off_ij = torch.matmul(jac.Jbi.transpose(-1, -2), jac.Jbj)
        L.index_add_(0, g.bet_i, torch.where(rev, off_ij, 0.0))
    return blocks, L


def _grad_index_add(jac, rp, rbw, raw, g):
    grad = torch.zeros((g.num_vars, 6), dtype=rp.dtype, device=rp.device)
    grad.index_add_(0, g.prior_idx, tsolver._ftj(jac.Jp, rp))
    grad.index_add_(0, g.bet_i, tsolver._ftj(jac.Jbi, rbw))
    grad.index_add_(0, g.bet_j, tsolver._ftj(jac.Jbj, rbw))
    for J, idx in _anc_pairs(jac, g):
        grad.index_add_(0, idx, tsolver._ftj(J, raw))
    return grad


def _hvp_index_add(jac, g, lam):
    def hvp(v):
        vf = tsolver._free(v, g)
        out = torch.zeros_like(v)
        yp = _fj(jac.Jp, vf[..., g.prior_idx, :])
        out.index_add_(-2, g.prior_idx, tsolver._ftj(jac.Jp, yp))
        yb = _fj(jac.Jbi, vf[..., g.bet_i, :]) + _fj(jac.Jbj, vf[..., g.bet_j, :])
        out.index_add_(-2, g.bet_i, tsolver._ftj(jac.Jbi, yb))
        out.index_add_(-2, g.bet_j, tsolver._ftj(jac.Jbj, yb))
        ya = torch.zeros(v.shape[:-2] + (jac.Jai.shape[0], 6), dtype=v.dtype, device=v.device)
        for J, idx in _anc_pairs(jac, g):
            ya = ya + _fj(J, vf[..., idx, :])
        for J, idx in _anc_pairs(jac, g):
            out.index_add_(-2, idx, tsolver._ftj(J, ya))
        return out + lam * v

    return hvp


@pytest.fixture
def index_add_sums(monkeypatch):
    """Within the test, the solver takes its sums by ``index_add_``."""
    def use():
        monkeypatch.setattr(tsolver, "_precond_sums", _precond_sums_index_add)
        monkeypatch.setattr(tsolver, "_grad_from_jacobians", _grad_index_add)
        monkeypatch.setattr(tsolver, "_hvp_from_jacobians", _hvp_index_add)
    return use


# ---- graphs ------------------------------------------------------------------------

def _high_degree_graph(seed=3, n=40, loops=300):
    """Two sessions of ``n`` nodes (odometry chains, the first node of each
    fixed by a prior) and their two anchors, joined by ``loops`` anchored
    factors: each anchor has a degree of ``loops``."""
    rng = np.random.default_rng(seed)
    V = 2 * n + 2
    poses = [_exp_se3(rng.normal(scale=0.3, size=6)) for _ in range(V)]
    fixed = np.zeros(V, bool)
    fixed[2 * n] = True                      # the first session's anchor
    priors = [(0, poses[0], (1e-2,) * 6), (n, poses[n], (1e-2,) * 6)]
    betweens = [(i, i + 1, np.linalg.inv(poses[i]) @ poses[i + 1], (1e-2,) * 6, False)
                for c0 in (0, n) for i in range(c0, c0 + n - 1)]
    anchored = []
    for _ in range(loops):
        i, j = int(rng.integers(0, n)), int(rng.integers(n, 2 * n))
        meas = _exp_se3(rng.normal(scale=0.05, size=6))
        anchored.append((i, j, 2 * n, 2 * n + 1, meas, (0.1,) * 6))
    init = [p @ _exp_se3(rng.normal(scale=0.02, size=6)) for p in poses]
    return build_graph_data(np.asarray(init, np.float32), fixed, priors=priors,
                            betweens=betweens, anchored=anchored, anchored_capacity=loops + 5)


def _graph(name):
    if name == "high_degree":
        return _high_degree_graph()
    if name == "chain":
        return graph_from_arrays(graph_to_arrays(_chain_graph()), "cpu")
    from ltm.graph import build_graph_data as j_build

    init, fixed, kw = graphs()[name]
    return graph_from_arrays(graph_to_arrays(j_build(init, fixed, **kw)), "cpu")


_GRAPHS = ["quadratic", "anchored", "chain", "high_degree"]


# ---- the sums -----------------------------------------------------------------------

def _zero_left_out(src, plan):
    """``src`` with the contributions the plan leaves out set to zero, as
    the solver's are (invalid factors' Jacobian blocks are zero)."""
    listed = torch.zeros(plan.n_src, dtype=torch.bool)
    listed[plan.cols.long()] = True
    return torch.where(listed[:, None], src, 0.0)


@pytest.mark.parametrize("name", _GRAPHS)
@pytest.mark.parametrize("lanes,width", [((), 36), ((), 6), ((3, 2), 6)])
def test_fixed_order_sum_equals_index_add(name, lanes, width):
    g = _graph(name)
    idx = torch.cat([getattr(g, k) for k in tsolver._FACTOR_ENDS])
    plan = tsolver._scatters(g).ends
    rng = np.random.default_rng(5)
    src = torch.from_numpy(rng.normal(size=lanes + (idx.shape[0], width)).astype(np.float32))
    src = _zero_left_out(src, plan)
    want = torch.zeros(lanes + (g.num_vars, width)).index_add_(-2, idx, src)
    assert torch.equal(fixed_order_sum(src, plan), want)
    assert torch.equal(fixed_order_sum_plain(src, plan), want)
    if name == "high_degree":
        assert plan.table.shape[1] >= 300
        assert plan.cols.shape[0] < idx.shape[0]        # the 5 invalid factors left out


def test_chain_plan_equals_index_add():
    g = _graph("chain")
    plan = tsolver._scatters(g).chain
    idx = torch.cat([g.bet_j, g.bet_i])
    src = _zero_left_out(torch.from_numpy(np.random.default_rng(9).normal(size=(idx.shape[0], 36))),
                         plan)
    want = torch.zeros((g.num_vars, 36), dtype=torch.float64).index_add_(0, idx, src)
    assert torch.equal(fixed_order_sum(src, plan), want)


@pytest.mark.parametrize("name", _GRAPHS)
def test_solve_unchanged(name, index_add_sums):
    g = _graph(name)
    cfg = SolverConfig(max_outer_iterations=30)
    got, info = solve(g, cfg)
    index_add_sums()
    want, info_want = solve(_graph(name), cfg)
    assert torch.equal(got, want)
    assert info.iterations == info_want.iterations
    assert torch.equal(info.cost_final, info_want.cost_final)


@pytest.mark.parametrize("name", ["anchored", "high_degree"])
def test_marginals_unchanged(name, index_add_sums):
    g = _graph(name)
    var = np.flatnonzero(~g.fixed.numpy())[:5]
    got = marginal_covariance(g, g.poses0, var, cg_iterations=60)
    index_add_sums()
    want = marginal_covariance(_graph(name), g.poses0, var, cg_iterations=60)
    assert torch.equal(got, want)


# ---- the plan -------------------------------------------------------------------------

def test_plan_layout():
    plan = plan_scatter(np.array([2, 0, 2, 2, 1, 0]), 4, "cpu")
    assert plan.rowptr.tolist() == [0, 2, 3, 6, 6]
    assert plan.cols.tolist() == [1, 5, 4, 0, 2, 3]
    assert plan.order.tolist() == [2, 0, 1, 3]          # by degree, highest first; ties by row
    assert plan.order.dtype == torch.int32
    assert plan.table.tolist() == [[1, 5, 6], [4, 6, 6], [0, 2, 3], [6, 6, 6]]
    assert plan.n_src == 6
    kept = plan_scatter(np.array([2, 0, 2, 2, 1, 0]), 4, "cpu",
                        keep=np.array([1, 0, 1, 0, 1, 1], bool))
    assert kept.rowptr.tolist() == [0, 1, 2, 4, 4]
    assert kept.cols.tolist() == [5, 4, 0, 2]
    assert kept.table.tolist() == [[5, 6], [4, 6], [0, 2], [6, 6]]
    assert kept.order.tolist() == [2, 0, 1, 3]
    src = torch.arange(12.0).reshape(6, 2)
    assert fixed_order_sum(src, kept).tolist() == [[10, 11], [8, 9], [4, 6], [0, 0]]
    empty = plan_scatter(np.zeros(0, np.int64), 3, "cpu")
    assert empty.table.shape == (3, 0) and empty.order.tolist() == [0, 1, 2]
    assert torch.equal(fixed_order_sum(torch.ones(2, 0, 4), empty), torch.zeros(2, 3, 4))


def test_plan_and_sum_checks():
    with pytest.raises(ValueError, match="indices"):
        plan_scatter(np.array([0, 4]), 4, "cpu")
    plan = plan_scatter(np.array([0, 1]), 2, "cpu")
    with pytest.raises(ValueError, match="src"):
        fixed_order_sum(torch.ones(3, 4), plan)
    with pytest.raises(ValueError, match="float32"):
        fixed_order_sum(torch.ones(2, 4, dtype=torch.int32), plan)
    with pytest.raises(ValueError):
        fixed_order_sum(torch.ones(2, 4, device="meta"), plan)


# ---- the kernel's schedule -------------------------------------------------------------

_STEPS = 8      # kSteps of csrc/scatter.cu: contribution loads in flight a thread


def _kernel_schedule_sum(src, plan):
    """``csrc/scatter.cu``'s schedule in Python: a warp a (lane, row), rows
    in ``plan.order``; the row's list read 32 entries at a time; a row of
    ``width`` ≤ 32 elements loaded ``32 // width`` contribution rows a warp
    load, a wider one in passes of 32 elements; ``_STEPS`` loads issued, then
    their adds in list order, each element from +0.0."""
    width = src.shape[-1]
    lanes = src.reshape((-1, plan.n_src, width))
    rowptr, cols = plan.rowptr.tolist(), plan.cols.tolist()
    out = torch.full((lanes.shape[0], len(rowptr) - 1, width), torch.nan, dtype=src.dtype)
    narrow = width <= 32
    per = 32 // width if narrow else 1
    passes = 1 if narrow else -(-width // 32)
    for v in plan.order.tolist():
        j0, j1 = rowptr[v], rowptr[v + 1]
        for p in range(passes):
            es = slice(0, width) if narrow else slice(32 * p, min(32 * p + 32, width))
            acc = torch.zeros_like(lanes[:, 0, es])
            for c0 in range(j0, j1, 32):
                n = min(32, j1 - c0)
                for s0 in range(0, n, _STEPS * per):
                    loads = {(g, k): lanes[:, cols[c0 + s0 + g * per + k], es]
                             for g in range(_STEPS) for k in range(per)
                             if s0 + g * per + k < n}
                    for g in range(_STEPS):
                        for q in range(per):
                            if s0 + g * per + q < n:
                                acc = acc + loads[(g, q)]
            out[:, v, es] = acc
    return out.reshape(src.shape[:-2] + out.shape[1:])


@pytest.mark.parametrize("name", ["anchored", "high_degree"])
@pytest.mark.parametrize("lanes,width,dtype", [((), 1, torch.float32), ((), 6, torch.float32),
                                               ((2,), 6, torch.float64),
                                               ((), 33, torch.float32),
                                               ((), 36, torch.float64),
                                               ((3,), 70, torch.float32)])
def test_kernel_schedule_equals_index_add(name, lanes, width, dtype):
    g = _graph(name)
    idx = torch.cat([getattr(g, k) for k in tsolver._FACTOR_ENDS])
    plan = tsolver._scatters(g).ends
    rng = np.random.default_rng(width)
    src = torch.from_numpy(rng.normal(size=lanes + (idx.shape[0], width))).to(dtype)
    src = _zero_left_out(src, plan)
    want = torch.zeros(lanes + (g.num_vars, width), dtype=dtype).index_add_(-2, idx, src)
    got = _kernel_schedule_sum(src, plan)
    assert torch.equal(got, want)
    degree = (plan.rowptr[1:] - plan.rowptr[:-1])[plan.order.long()]
    assert torch.all(degree[:-1] >= degree[1:])            # heavy rows start first
    assert sorted(plan.order.tolist()) == list(range(g.num_vars))
