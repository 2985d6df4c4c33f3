"""The solver's Gauss-Newton product (K5c, ``kernels/gn_product.py``) on the
CPU, on the quadratic and anchored graphs of ``tests/test_torch_solver.py``
(built by ``ltm``, carried across by ``slam/convert.py``), the
``high_degree`` graph of ``tests/test_torch_solver_scatter.py`` and the
random graphs of ``random_gn_case``, inputs from a NumPy seed:

  * ``gn_product_plain`` at 1, 3 and 12 lanes against ``ltm``'s jitted
    ``_hvp_from_jacobians`` under ``vmap``, within 1e-5 of each output
    entry's sum of absolute terms (the same product of |J|, |v| and |λ|
    in float64);
  * bit for bit against the route it replaced (``torch.matmul`` a factor
    end, the contributions concatenated, one fixed-order scatter-sum);
  * against a dense float64 ``(JᵀWJ + λI) v`` under the same rule;
  * a lane computed alone bit-equal to the same lane in a batch;
  * the kernel's schedule written out in Python (``_kernel_model``: below
    ``_WIDE`` lanes the factors' ``y`` in a lane-fastest (factors, 6, lanes)
    scratch and the rows launch of ``row_teams``, a CTA a (row, lane) for a
    row of more than ``_HEAVY`` ends and a warp for a lighter one, each
    chunk's products formed at once and added in list order onto sums
    carried across chunks; from ``_WIDE`` lanes a CTA a (row, 32 lanes)
    forming each end's ``y_f`` afresh from ``v`` transposed) bit-equal to
    the plain version at 1 to 40 lanes, in float32 and float64, on rows at
    the heavy threshold and one either side of it and on rows longer than
    two chunks, and its decoding of an end's position into its block and
    ``y`` row;
  * the rows launch (``row_teams``, ``team_chunks``) covering every (row,
    lane) once, heavy rows (the plan's ``n_heavy``) by a CTA, and every
    row's list once in order;
  * the plan's checks, the wrapper's refusal of CPU tensors, and the
    solver's product refusing a device that is neither.

The kernel itself needs the card: ``tests/test_torch_card.py`` (marker
``card``) and ``chip_smoke.py`` hold it to the plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltm.graph import solver as jsolver
from ltm_torch.graph import solver as tsolver
from ltm_torch.graph.factors import robust_weights, whitened_residuals
from ltm_torch.kernels.gn_product import (_HEAVY, _PER, _THREADS, _WIDE, gn_product,
                                          gn_product_plain, plan_gn_product, random_gn_case)
from ltm_torch.kernels.scatter import fixed_order_sum, plan_scatter
from ltm_torch.slam.convert import graph_from_arrays, graph_to_arrays

from test_torch_solver import graphs
from test_torch_solver_scatter import _anc_pairs, _fj, _high_degree_graph

torch.set_num_threads(1)

# random graphs of 40 variables: (P, B, A), the anchored factors' valid share
# and how many have coinciding anchors.  The two anchor rows take A - c and
# A + c ends: at the heavy threshold, one either side of it, and over two of
# a heavy row's chunks (``_THREADS * _PER`` ends).
_RANDOM = {"random": ((3, 45, 30), 0.9, 0), "random_coincide": ((3, 45, 30), 0.9, 4),
           "threshold": ((3, 45, _HEAVY), 1.0, 0), "threshold_pm1": ((3, 45, _HEAVY), 1.0, 1),
           "long_row": ((3, 45, 2 * _THREADS * _PER + 500), 1.0, 0)}


def row_teams(n_rows: int, n_heavy: int, lanes: int):
    """The narrow route's rows launch (``gn_rows``, below ``_WIDE`` lanes)
    as the kernel decodes it: for each CTA in launch order and each team in
    it, ``(rank, lane, threads)``: the row ``plan.ends.order[rank]``, its
    lane, and the team's threads (``_THREADS``: the CTA of a heavy row; 32:
    a warp of a light one).  Blocks ``[0, n_heavy * lanes)`` are the heavy
    rows' (lanes fastest); then ``_THREADS // 32`` warps a block, a warp a
    (light row, lane), lanes fastest; warps past the last row do nothing."""
    warps = _THREADS // 32
    heavy = n_heavy * lanes
    blocks = heavy + -(-(n_rows - n_heavy) * lanes // warps)
    for b in range(blocks):
        if b < heavy:
            yield b // lanes, b % lanes, _THREADS
            continue
        for w in range(warps):
            item = (b - heavy) * warps + w
            if n_heavy + item // lanes < n_rows:
                yield n_heavy + item // lanes, item % lanes, 32


def team_chunks(j0: int, j1: int, threads: int):
    """A team's chunks of the row list ``[j0, j1)``: ``threads * _PER``
    entries each, in list order (one empty chunk for a row of no ends);
    thread t takes entries t and t + threads of each."""
    step = threads * _PER
    return [(c, min(c + step, j1)) for c in range(j0, max(j1, j0 + 1), step)]


def _ltm_graph(name):
    from ltm.graph import build_graph_data as j_build

    init, fixed, kw = graphs()[name]
    return j_build(init, fixed, **kw)


def _case(name, lanes, seed=0, dtype=torch.float32):
    """(jac, plan, v, lam, ltm graph or None, port graph or None) of a named
    graph: its Jacobians at its initial poses, ``v`` from a NumPy seed."""
    rng = np.random.default_rng(seed)
    if name in _RANDOM:
        counts, valid, coincide = _RANDOM[name]
        jac, plan, v, lam = random_gn_case(rng, 40, counts, lanes, dtype,
                                           valid=(0.9, 0.9, valid), coincide=coincide)
        return jac, plan, v, lam, None, None
    jg = _ltm_graph(name) if name in ("quadratic", "anchored") else None
    g = graph_from_arrays(graph_to_arrays(jg), "cpu") if jg is not None else _high_degree_graph()
    rp, rb, ra = whitened_residuals(g.poses0, g)
    _, wb, wa = robust_weights(rp, rb, ra, g, 1.0)
    jac = tuple(tsolver._factor_jacobians(g.poses0, g, wb, wa))
    v = torch.from_numpy(rng.normal(size=lanes + (g.num_vars, 6)).astype(np.float32))
    lam = torch.tensor(1e-3, dtype=torch.float32)
    return jac, tsolver._scatters(g).product, v, lam, jg, g


def _abs_terms(jac, plan, v, lam):
    """Each output entry's sum of absolute terms: the product of |J|, |v|
    and |λ|, in float64."""
    return gn_product_plain(tuple(J.abs().double() for J in jac), plan, v.abs().double(),
                            lam.abs().double())


def _within(got, want, jac, plan, v, lam):
    bound = 1e-5 * _abs_terms(jac, plan, v, lam)
    err = (got.double() - torch.as_tensor(np.asarray(want)).double()).abs()
    assert torch.all(err <= bound), float((err - bound).max())


@pytest.mark.parametrize("name", ["quadratic", "anchored"])
@pytest.mark.parametrize("lanes", [1, 3, 12])
def test_plain_matches_ltm(name, lanes):
    jac, plan, v, lam, jg, _ = _case(name, (lanes,))
    jjac = jsolver.FactorJacobians(*(jnp.asarray(J.numpy()) for J in jac))
    prod = jax.jit(jax.vmap(lambda x: jsolver._hvp_from_jacobians(jjac, jg, float(lam))(x)))
    want = prod(jnp.asarray(v.numpy()))
    _within(gn_product_plain(jac, plan, v, lam), want, jac, plan, v, lam)


def _old_route(jac, plan, v, lam, g):
    """The product's CPU route before K5c: ``torch.matmul`` a factor end,
    the contributions concatenated, one fixed-order scatter-sum."""
    jac = tsolver.FactorJacobians(*jac)
    vf = tsolver._free(v, g)
    yp = _fj(jac.Jp, vf[..., g.prior_idx, :])
    yb = _fj(jac.Jbi, vf[..., g.bet_i, :]) + _fj(jac.Jbj, vf[..., g.bet_j, :])
    ya = torch.zeros(v.shape[:-2] + (jac.Jai.shape[0], 6))
    for J, idx in _anc_pairs(jac, g):
        ya = ya + _fj(J, vf[..., idx, :])
    ys = (yp, yb, yb, ya, ya, ya, ya)
    ends = torch.cat([tsolver._ftj(J, y) for J, y in zip(jac, ys)], -2)
    return fixed_order_sum(ends, plan.ends) + lam * v


@pytest.mark.parametrize("name", ["quadratic", "anchored", "high_degree"])
@pytest.mark.parametrize("lanes", [(), (3,), (12,)])
def test_plain_equals_old_route(name, lanes):
    jac, plan, v, lam, _, g = _case(name, lanes)
    got = gn_product_plain(jac, plan, v, lam)
    assert torch.equal(got, _old_route(jac, plan, v, lam, g))
    assert torch.equal(got, tsolver._hvp_from_jacobians(tsolver.FactorJacobians(*jac), g, lam)(v))


def _dense(jac, plan, v, lam):
    """``(JᵀWJ + λI) v`` in float64 from the dense Jacobian (a factor's six
    rows, its ends' blocks at their variables' columns), ``J v`` taken with
    the fixed variables' entries of ``v`` zeroed."""
    V = plan.fixed.shape[0]
    idx = [i.long().numpy() for i in plan.idx]
    fams = (((0,), idx[0].shape[0]), ((1, 2), idx[1].shape[0]), ((3, 4, 5, 6), idx[3].shape[0]))
    rows = []
    for ends, n in fams:
        Jd = np.zeros((n, 6, V, 6))
        for k in ends:
            for f in range(n):
                Jd[f, :, idx[k][f], :] += jac[k][f].double().numpy()
        rows.append(Jd.reshape(6 * n, 6 * V))
    Jd = np.concatenate(rows)
    x = v.double().reshape(-1, 6 * V).numpy()
    xf = np.where(np.repeat(plan.fixed.numpy().astype(bool), 6), 0.0, x)
    out = (Jd.T @ (Jd @ xf.T)).T + float(lam) * x
    return out.reshape(v.shape)


@pytest.mark.parametrize("name", ["quadratic", "anchored", "high_degree", "random_coincide"])
@pytest.mark.parametrize("lanes", [(), (3,)])
def test_plain_matches_dense_float64(name, lanes):
    jac, plan, v, lam, _, _ = _case(name, lanes)
    _within(gn_product_plain(jac, plan, v, lam), _dense(jac, plan, v, lam), jac, plan, v, lam)


@pytest.mark.parametrize("name", ["anchored", "high_degree", "random_coincide"])
def test_lane_alone_equals_batch(name):
    jac, plan, v, lam, _, _ = _case(name, (12,))
    batch = gn_product_plain(jac, plan, v, lam)
    for k in (0, 5, 11):
        assert torch.equal(gn_product_plain(jac, plan, v[k], lam), batch[k])


def _end_block(e, P, B, A):
    """``csrc/gn_product.cu::end_block``: end position ``e`` -> (its array,
    its factor in the array, its factor's row of ``y``)."""
    if e < P:
        return 0, e, e
    if e < P + 2 * B:
        r = e - P
        second = int(r >= B)
        return 1 + second, r - second * B, P + r - second * B
    r = e - P - 2 * B
    q = int(r >= A) + int(r >= 2 * A) + int(r >= 3 * A)
    return 3 + q, r - q * A, P + B + r - q * A


@pytest.mark.parametrize("counts", [(3, 5, 2), (0, 4, 3), (2, 0, 0), (0, 0, 5)])
def test_end_block_decodes_the_ends_order(counts):
    P, B, A = counts
    sizes = (P, B, B, A, A, A, A)
    want = [(k, f) for k, n in enumerate(sizes) for f in range(n)]
    yrow0 = (0, P, P, P + B, P + B, P + B, P + B)
    for e, (k, f) in enumerate(want):
        assert _end_block(e, P, B, A) == (k, f, yrow0[k] + f)


def _factor_y(jac, idx, ends, x, anchored):
    """``y_f`` of factors whose ends are the arrays ``ends`` and whose
    variables' entries are ``x`` (one (lanes, n, 6) a factor end): its
    ends' ``J x`` added in order, an anchored factor's from +0.0."""
    acc = None
    for k, xk in zip(ends, x):
        t = jac[k][:, :, 0] * xk[..., 0:1]
        for c in range(1, 6):
            t = t + jac[k][:, :, c] * xk[..., c:c + 1]
        acc = (torch.zeros_like(t) + t if anchored else t) if acc is None else acc + t
    return acc


def _kernel_model(jac, plan, v, lam):
    """``csrc/gn_product.cu``'s passes in Python.  Below ``_WIDE`` lanes:
    gn_factors, each factor's ``y`` for every lane into a (P + B + A, 6,
    lanes) scratch, its ends in order (an anchored factor's from +0.0);
    then gn_rows, each team of ``row_teams`` walking the ``team_chunks`` of
    its row: a chunk's products ``Σ_i J[i, j] y[i]`` are formed at once (the
    team's threads, kPer ends each) and written in list order, then added in
    list order onto the column sums, which carry across chunks.  From
    ``_WIDE`` lanes: ``v`` transposed by gn_transpose, then gn_rows_wide, a
    CTA a (row, 32 lanes) whose warps form a chunk's products at once, each
    end's ``y_f`` afresh from the transposed copy, added in list order (the
    lanes are independent and the sum's order is the list's, so the model
    takes every lane and end in turn).  Then ``+ λ v``."""
    V = plan.fixed.shape[0]
    lanes = v.reshape(-1, V, 6)
    L = lanes.shape[0]
    P, B, A = (plan.idx[k].shape[0] for k in (0, 1, 3))
    idx = [i.long() for i in plan.idx]
    fixed = plan.fixed.bool()
    rowptr, cols = plan.ends.rowptr.tolist(), plan.ends.cols.tolist()
    order = plan.ends.order.tolist()
    blocks = torch.cat(jac)                                      # by end position
    families = (((0,), 0), ((1, 2), P), ((3, 4, 5, 6), P + B))

    def mtv(J, yy):
        """``Σ_i J[i, j] y[i]`` in i order: (n, 6, 6), (..., n, 6)."""
        c = J[:, 0, :] * yy[..., 0:1]
        for i in range(1, 6):
            c = c + J[:, i, :] * yy[..., i:i + 1]
        return c

    out = torch.full_like(lanes, torch.nan)
    if L >= _WIDE:
        vt = lanes.permute(1, 2, 0).clone()                      # gn_transpose
        for row in order:
            acc = torch.zeros((L, 6), dtype=v.dtype)
            for e in cols[rowptr[row]:rowptr[row + 1]]:
                k, f, _ = _end_block(e, P, B, A)
                ends = next(fam for fam, _ in families if k in fam)
                x = [torch.where(fixed[idx[q][f]], 0.0, vt[idx[q][f]].T)[:, None]
                     for q in ends]
                yf = _factor_y([J[f:f + 1] for J in jac], range(7), ends, x, len(ends) == 4)
                acc = acc + mtv(jac[k][f:f + 1], yf)[:, 0]
            out[:, row] = acc + lam * vt[row].T
        return out.reshape(v.shape)
    vf = torch.where(fixed[:, None], 0.0, lanes)
    y = torch.full((P + B + A, 6, L), torch.nan, dtype=v.dtype)
    for ends, y0 in families:
        n = idx[ends[0]].shape[0]
        y[y0:y0 + n] = _factor_y(jac, range(7), ends, [vf[:, idx[k], :] for k in ends],
                                 len(ends) == 4).permute(1, 2, 0)
    yrow = torch.tensor([_end_block(e, P, B, A)[2] for e in range(blocks.shape[0])] or [0])
    for rank, lane, threads in row_teams(V, plan.n_heavy, L):
        row = order[rank]
        acc = torch.zeros(6, dtype=v.dtype)
        for c0, c1 in team_chunks(rowptr[row], rowptr[row + 1], threads):
            ends = torch.tensor(cols[c0:c1], dtype=torch.long)
            prod = mtv(blocks[ends], y[yrow[ends], :, lane])
            for m in range(c1 - c0):
                acc = acc + prod[m]
        out[lane, row] = acc + lam * lanes[lane, row]
    return out.reshape(v.shape)


_MODEL_NAMES = ["anchored", "high_degree", "random", "random_coincide", "threshold",
                "threshold_pm1", "long_row"]


@pytest.mark.parametrize("name", _MODEL_NAMES)
@pytest.mark.parametrize("lanes", [(), (2,), (3,), (4,), (7,), (12,), (16,), (40,),
                                   (_WIDE - 1,), (_WIDE,)])
def test_kernel_model_equals_plain(name, lanes):
    jac, plan, v, lam, _, _ = _case(name, lanes, seed=len(lanes) and lanes[0])
    assert torch.equal(_kernel_model(jac, plan, v, lam), gn_product_plain(jac, plan, v, lam))


@pytest.mark.parametrize("name", ["random_coincide", "threshold_pm1", "long_row"])
@pytest.mark.parametrize("lanes", [(), (5,), (16,), (_WIDE,)])
def test_kernel_model_equals_plain_float64(name, lanes):
    jac, plan, v, lam, _, _ = _case(name, lanes, seed=7, dtype=torch.float64)
    assert v.dtype == torch.float64
    assert torch.equal(_kernel_model(jac, plan, v, lam), gn_product_plain(jac, plan, v, lam))


def test_threshold_cases_rows():
    """The anchor rows of the named cases sit where their names say."""
    degrees = {}
    for name in ("threshold", "threshold_pm1", "long_row"):
        plan = _case(name, ())[1]
        deg = np.diff(plan.ends.rowptr.numpy())
        degrees[name] = (int(deg[37]), int(deg[38]))
    assert degrees["threshold"] == (_HEAVY, _HEAVY)
    assert degrees["threshold_pm1"] == (_HEAVY + 1, _HEAVY - 1)
    assert min(degrees["long_row"]) > 2 * _THREADS * _PER


@pytest.mark.parametrize("name", ["high_degree", "random", "threshold", "threshold_pm1",
                                  "long_row"])
@pytest.mark.parametrize("L", [1, 2, 5, 15, _WIDE - 1])
def test_rows_launch_covers_every_row_and_lane_once(name, L):
    plan = _case(name, ())[1]
    V = plan.fixed.shape[0]
    rowptr = plan.ends.rowptr.numpy()
    deg = np.diff(rowptr)
    order = plan.ends.order.numpy()
    n_heavy = plan.n_heavy
    assert n_heavy == int((deg > _HEAVY).sum())
    assert (deg[order[:n_heavy]] > _HEAVY).all() and (deg[order[n_heavy:]] <= _HEAVY).all()
    teams = list(row_teams(V, n_heavy, L))
    assert sorted((r, ln) for r, ln, _ in teams) == [(r, ln) for r in range(V) for ln in range(L)]
    for rank, _, threads in teams:
        row = order[rank]
        assert threads == (_THREADS if deg[row] > _HEAVY else 32)
        chunks = team_chunks(int(rowptr[row]), int(rowptr[row + 1]), threads)
        assert chunks[0][0] == rowptr[row] and chunks[-1][1] == rowptr[row + 1]
        assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
        assert all(0 < c1 - c0 <= threads * _PER for c0, c1 in chunks) or deg[row] == 0
        if threads == 32:
            assert len(chunks) == 1                      # a light row is one chunk
    if name == "long_row":
        assert max(len(team_chunks(int(rowptr[r]), int(rowptr[r + 1]), _THREADS))
                   for r in range(V)) >= 3


def test_random_case_layout():
    jac, plan, v, lam = random_gn_case(np.random.default_rng(3), 40, (3, 45, 30), (2,),
                                       coincide=4, dtype=torch.float64)
    deg = (plan.ends.rowptr[1:] - plan.ends.rowptr[:-1]).tolist()
    assert deg[39] == 0                                       # a row of degree 0
    assert plan.fixed.tolist()[0] == 1 and plan.fixed.tolist()[37] == 1
    assert (plan.idx[6][:4] == plan.idx[5][:4]).all()         # anchors that coincide
    assert deg[37] >= 30 and plan.ends.cols.shape[0] < plan.ends.n_src   # invalid left out
    left_out = np.setdiff1d(np.arange(plan.ends.n_src), plan.ends.cols.numpy())
    blocks = torch.cat(jac)
    assert torch.all(blocks[torch.from_numpy(left_out)] == 0)
    assert v.shape == (2, 40, 6) and v.dtype == lam.dtype == torch.float64


def test_checks_and_refusals():
    jac, plan, v, lam = random_gn_case(np.random.default_rng(4), 12, (1, 8, 3))
    with pytest.raises(RuntimeError, match="CUDA"):
        gn_product(jac, plan, v, lam, {})
    with pytest.raises(ValueError, match="v must be"):
        gn_product_plain(jac, plan, v[:5], lam)
    with pytest.raises(ValueError, match="block array"):
        gn_product_plain(jac[:6] + (jac[6][:2],), plan, v, lam)
    with pytest.raises(ValueError, match="float32 or float64"):
        gn_product_plain(tuple(J.half() for J in jac), plan, v.half(), lam)
    idx = [i.numpy() for i in plan.idx]
    with pytest.raises(ValueError, match="end arrays"):
        plan_gn_product(plan.ends, idx[:6] + [idx[6][:2]], plan.fixed.numpy(), "cpu")
    with pytest.raises(ValueError, match="scatter plan takes"):
        plan_gn_product(plan_scatter(np.zeros(3, np.int64), 12, "cpu"), idx,
                        plan.fixed.numpy(), "cpu")
    with pytest.raises(ValueError, match=r"lie in \[0, 12\)"):
        plan_gn_product(plan.ends, idx[:6] + [idx[6] + 12], plan.fixed.numpy(), "cpu")
    g = _high_degree_graph()
    jz = tsolver.FactorJacobians(*(torch.zeros(n, 6, 6) for n in
                                   (s.shape[0] for s in tsolver._scatters(g).product.idx)))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tsolver._hvp_from_jacobians(jz, g, torch.tensor(1.0))(torch.zeros(g.num_vars, 6,
                                                                          device="meta"))
