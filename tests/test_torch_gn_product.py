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
  * the kernel's schedule written out in Python (``_kernel_model``: the
    factors' ``y`` in a (factors, lanes, 6) scratch, a warp a (row, lane
    tile) in the plan's order, five (lane, end) slots, ``_STEPS`` ends
    loaded before their products, the slots' products added in list order)
    bit-equal to the plain version at 1 to 12 lanes, and its decoding of an
    end's position into its block and ``y`` row;
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
from ltm_torch.kernels.gn_product import (gn_product, gn_product_plain, plan_gn_product,
                                          random_gn_case)
from ltm_torch.kernels.scatter import fixed_order_sum, plan_scatter
from ltm_torch.slam.convert import graph_from_arrays, graph_to_arrays

from test_torch_solver import graphs
from test_torch_solver_scatter import _anc_pairs, _fj, _high_degree_graph

torch.set_num_threads(1)

_STEPS = 4     # kSteps of csrc/gn_product.cu: ends in flight a slot
_SLOTS = 5     # kSlots: (lane, end) slots of six threads a warp
_WIDE = 16     # kWide: lanes from which the rows take a thread a lane


def _ltm_graph(name):
    from ltm.graph import build_graph_data as j_build

    init, fixed, kw = graphs()[name]
    return j_build(init, fixed, **kw)


def _case(name, lanes, seed=0):
    """(jac, plan, v, lam, ltm graph or None, port graph or None) of a named
    graph: its Jacobians at its initial poses, ``v`` from a NumPy seed."""
    rng = np.random.default_rng(seed)
    if name.startswith("random"):
        jac, plan, v, lam = random_gn_case(rng, 40, (3, 45, 30), lanes,
                                           coincide=4 if name == "random_coincide" else 0)
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


def _kernel_model(jac, plan, v, lam):
    """``csrc/gn_product.cu``'s two passes in Python.  gn_factors: each
    factor's ``y`` for every lane into a (P + B + A, lanes, 6) scratch, its
    ends in order (an anchored factor's from +0.0).  gn_rows: rows in
    ``plan.ends.order``; below ``_WIDE`` lanes, lanes in tiles of
    ``min(5, lanes)``, each tile's lanes times ``5 // tile`` consecutive
    ends in the slots, from ``_WIDE`` on (gn_rows_wide) tiles of 32 lanes
    and one end a step; the row's list 32 entries at a time; ``_STEPS``
    slot loads, then each end's ``Σ_i J[i, j] y[i]`` and the slots'
    products added in list order from +0.0; then ``+ λ v``."""
    V = plan.fixed.shape[0]
    lanes = v.reshape(-1, V, 6)
    L = lanes.shape[0]
    P, B, A = (plan.idx[k].shape[0] for k in (0, 1, 3))
    idx = [i.long() for i in plan.idx]
    vf = torch.where(plan.fixed.bool()[:, None], 0.0, lanes)
    y = torch.full((P + B + A, L, 6), torch.nan, dtype=v.dtype)
    for fam, (ends, y0) in enumerate((((0,), 0), ((1, 2), P), ((3, 4, 5, 6), P + B))):
        n = idx[ends[0]].shape[0]
        acc = torch.zeros((L, n, 6), dtype=v.dtype)
        for e, k in enumerate(ends):
            x = vf[:, idx[k], :]
            t = jac[k][:, :, 0] * x[..., 0:1]
            for c in range(1, 6):
                t = t + jac[k][:, :, c] * x[..., c:c + 1]
            acc = t if e == 0 and fam != 2 else acc + t
        y[y0:y0 + n] = acc.transpose(0, 1)
    rowptr, cols = plan.ends.rowptr.tolist(), plan.ends.cols.tolist()
    tile = 32 if L >= _WIDE else min(_SLOTS, L)      # gn_rows_wide: one end a step
    group = 1 if L >= _WIDE else _SLOTS // tile
    out = torch.full_like(lanes, torch.nan)
    for row in plan.ends.order.tolist():
        j0, j1 = rowptr[row], rowptr[row + 1]
        for t0 in range(0, L, tile):
            ls = slice(t0, min(t0 + tile, L))
            acc = torch.zeros_like(lanes[ls, row])
            for c0 in range(j0, j1, 32):
                n = min(32, j1 - c0)
                for s0 in range(0, n, _STEPS * group):
                    prods = {}
                    for q in range(_STEPS):
                        for g in range(group):
                            m = s0 + q * group + g
                            if m < n:
                                k, f, yrow = _end_block(cols[c0 + m], P, B, A)
                                yy = y[yrow, ls]
                                c = jac[k][f][0, :] * yy[:, 0:1]
                                for i in range(1, 6):
                                    c = c + jac[k][f][i, :] * yy[:, i:i + 1]
                                prods[m] = c
                    for q in range(_STEPS):
                        for g in range(group):
                            if s0 + q * group + g < n:
                                acc = acc + prods[s0 + q * group + g]
            out[ls, row] = acc + lam * lanes[ls, row]
    return out.reshape(v.shape)


@pytest.mark.parametrize("name", ["anchored", "high_degree", "random", "random_coincide"])
@pytest.mark.parametrize("lanes", [(), (2,), (3,), (4,), (7,), (12,), (16,), (40,)])
def test_kernel_model_equals_plain(name, lanes):
    jac, plan, v, lam, _, _ = _case(name, lanes, seed=len(lanes) and lanes[0])
    assert torch.equal(_kernel_model(jac, plan, v, lam), gn_product_plain(jac, plan, v, lam))


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
