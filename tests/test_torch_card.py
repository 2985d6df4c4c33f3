"""Kernel tests that need a CUDA card (marker ``card``); each skips without
one.  This file imports neither ``jax`` nor ``ltm``: the card machine has
neither, so run it there without the suite's conftest (which configures
JAX) and without the CPU settings of ``pytest.ini``:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider -m card tests/test_torch_card.py -q

  * K5b (``csrc/nn_argmin.cu`` through ``knn.nn_sqdist_argmin``) against
    ``nn_sqdist_argmin_plain`` on the card: indices equal except at
    near-ties (both picks within 1e-5 m² of each other), distances
    bit-equal where the indices agree, a second launch bit-equal, a lane
    alone bit-equal to the same lane in its batch; duplicated targets (the
    lowest index), a lane without a valid target (index 0, 1e30), a target
    split (a nearest target on both sides of a split boundary);
  * the fixed-order scatter-sum (``csrc/scatter.cu``) bit-equal to
    ``fixed_order_sum_plain`` at rows of 1 to 70 elements, float32 and
    float64, with lanes and rows of high degree;
  * K5a, the solver's block-tridiagonal factor and solve
    (``csrc/tridiag.cu``), on random SPD systems with chain cuts and ragged
    chains (1 to 300 variables), float32 and float64, with no lane, 4 and
    120 lanes: no further from the float64 plain version (the inputs cast
    up) than twice the plain float32 route, or 1e-6, block by block (a
    6×6 block of ``Cinv`` or a row of x, its error over its own size:
    ``kernels.tridiag.card_rule``), the factor's ``Cinv`` and ``P``, and
    the solve (which reads ``Cinv`` and ``P``) against the plain solve on
    ``Cinv`` and ``Lc``; ``Lc`` bit-equal to the plain gather; a second
    launch bit-equal; a call captured in a CUDA graph equal to the eager
    call;
  * K5c, the solver's Gauss-Newton product (``csrc/gn_product.cu``), on
    random pose graphs (``random_gn_case``: invalid factors, fixed
    variables, a row of degree 0, anchored factors whose anchors coincide)
    at 1, 2, 3, 7 and 120 lanes, float32 and float64: bit-equal to
    ``gn_product_plain``, a second launch and a call captured in a CUDA
    graph bit-equal to the first.

``chip_smoke.py`` runs the same checks at the pipeline's shapes.
"""

import numpy as np
import pytest
import torch

from ltm_torch.kernels import nn_argmin
from ltm_torch.kernels.gn_product import gn_product, gn_product_plain, random_gn_case
from ltm_torch.kernels.knn import nn_sqdist_argmin, nn_sqdist_argmin_plain
from ltm_torch.kernels.scatter import fixed_order_sum, fixed_order_sum_plain, plan_scatter
from ltm_torch.kernels.tridiag import (card_rule, random_chain_system, tridiag_apply,
                                      tridiag_apply_plain, tridiag_factor, tridiag_factor_plain)

pytestmark = pytest.mark.card

NEAR_TIE = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cloud(rng, lanes, n, m, offset=0.0):
    t = (rng.uniform(-20, 20, (lanes, m, 3)) + offset).astype(np.float32)
    q = (t[:, rng.integers(0, m, n)] + rng.normal(scale=0.05, size=(lanes, n, 3))).astype(np.float32)
    return q, rng.uniform(size=(lanes, n)) > 0.1, t, rng.uniform(size=(lanes, m)) > 0.2


def _on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def _check_nn(args):
    """Kernel route against the plain version on the same card inputs."""
    d, i = nn_sqdist_argmin(*args, tile=4096)
    d2, i2 = nn_sqdist_argmin(*args, tile=4096)
    d_w, i_w = nn_sqdist_argmin_plain(*args, tile=4096)
    assert torch.equal(d, d2) and torch.equal(i, i2)
    apart = i != i_w
    assert torch.equal(d[~apart], d_w[~apart])
    if apart.any():
        q, _, t, tm = (x.cpu().numpy() for x in args)
        lane, row = (x.cpu().numpy() for x in apart.nonzero(as_tuple=True))
        picks = [x.cpu().numpy()[lane, row] for x in (i, i_w)]
        e = [((q[lane, row].astype(np.float64) - t[lane, p]) ** 2).sum(-1) for p in picks]
        assert np.all(tm[lane, picks[0]]) and np.all(np.abs(e[0] - e[1]) <= NEAR_TIE)
    return d, i, int(apart.sum())


@pytest.mark.parametrize("seed,lanes,n,m,offset", [(0, 3, 1800, 3000, 0.0),
                                                   (1, 32, 1024, 8192, 0.0),
                                                   (2, 2, 4096 + 17, 5000 + 3, 1000.0)])
def test_nn_kernel_matches_plain(dev, seed, lanes, n, m, offset):
    args = _on(dev, *_cloud(np.random.default_rng(seed), lanes, n, m, offset))
    launches = nn_argmin.nn_argmin_select.launches
    d, i, ties = _check_nn(args)
    assert nn_argmin.nn_argmin_select.launches == launches + 2
    assert ties <= max(3, lanes)
    for b in (0, lanes - 1):
        d1, i1 = nn_sqdist_argmin(*(x[b:b + 1] for x in args), tile=4096)
        assert torch.equal(d1[0], d[b]) and torch.equal(i1[0], i[b])


def test_nn_kernel_duplicates_empty_lane_and_split(dev):
    rng = np.random.default_rng(3)
    q, qm, t, tm = _cloud(rng, 3, 700, 2000)
    t[:, 1::2] = t[:, 0::2]                       # every target twice: the first wins
    tm[:] = True
    tm[2] = False                                 # a lane without a valid target
    d, i, _ = _check_nn(_on(dev, q, qm, t, tm))
    assert not torch.any(i[:2] % 2) and torch.all(i[2] == 0) and torch.all(d[2] == 1e30)
    # few queries: the plan splits the targets; the nearest twice across a boundary
    q, qm, t, tm = _cloud(rng, 2, 64, 200_000)
    tm[:] = True
    splits, chunk = nn_argmin._device_plan(dev, 2, 64, 200_000)
    assert splits > 1
    t[:, [chunk - 1, chunk]] = q[:, :1]
    merges = nn_argmin.nn_argmin_select.merges
    _, i, _ = _check_nn(_on(dev, q, qm, t, tm))
    assert torch.all(i[:, 0] == chunk - 1)
    assert nn_argmin.nn_argmin_select.merges == merges + 2


def _graph_plan(dev, rng):
    """A pose graph's shape: two chains, priors, two anchors of degree 300,
    padding entries at row 0 left out of the plan."""
    n = 200
    chain = np.concatenate([np.arange(0, n - 1), np.arange(n, 2 * n - 1)])
    ends = np.concatenate([[0, n], chain, chain + 1, rng.integers(0, 2 * n, 300),
                           np.full(300, 2 * n), np.full(300, 2 * n + 1), np.zeros(90, np.int64)])
    keep = np.ones(len(ends), bool)
    keep[-90:] = False
    return plan_scatter(ends, 2 * n + 2, dev, keep), len(ends)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lanes,width", [((), 1), ((), 6), ((4,), 6), ((), 33), ((2,), 36),
                                         ((), 70)])
def test_scatter_kernel_matches_plain(dev, dtype, lanes, width):
    rng = np.random.default_rng(width)
    plan, n_src = _graph_plan(dev, rng)
    src = torch.from_numpy(rng.normal(size=lanes + (n_src, width))).to(dev, dtype)
    launches = fixed_order_sum.launches
    got = fixed_order_sum(src, plan)
    assert fixed_order_sum.launches == launches + 1
    assert torch.equal(got, fixed_order_sum(src, plan))
    assert torch.equal(got, fixed_order_sum_plain(src, plan))


CHAIN_LENGTHS = (1, 300, 2, 1, 1, 57, 140, 1, 33)


def _captured(fn):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return tuple(t.clone() for t in out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lanes", [(), (4,), (120,)])
def test_tridiag_kernels_match_plain(dev, dtype, lanes):
    rng = np.random.default_rng(len(lanes) and lanes[0])
    D, L, pos = random_chain_system(rng, CHAIN_LENGTHS, dtype, dev)
    r = torch.from_numpy(rng.normal(size=lanes + (D.shape[0], 6))).to(dev, dtype)
    launches = tridiag_factor.launches, tridiag_apply.launches
    Cinv, Lc, P = tridiag_factor(D, L, pos)
    x = tridiag_apply(Cinv, P, pos, r)
    assert (tridiag_factor.launches, tridiag_apply.launches) == (launches[0] + 1, launches[1] + 1)
    assert x.shape == r.shape and Cinv.shape == pos.shape + (6, 6) and P.shape == Cinv.shape
    C2, L2, P2 = tridiag_factor(D, L, pos)
    assert torch.equal(C2, Cinv) and torch.equal(L2, Lc) and torch.equal(P2, P)
    assert torch.equal(tridiag_apply(Cinv, P, pos, r), x)
    Cg, Lg, Pg, xg = _captured(lambda: (*tridiag_factor(D, L, pos), tridiag_apply(Cinv, P, pos, r)))
    assert torch.equal(Cg, Cinv) and torch.equal(Lg, Lc) and torch.equal(Pg, P)
    assert torch.equal(xg, x)
    assert torch.equal(Lc, tridiag_factor_plain(D, L, pos)[1])
    card_rule(Cinv, lambda *a: tridiag_factor_plain(*a)[0], (D, L, pos), 2)   # raises past it
    card_rule(P, lambda *a: tridiag_factor_plain(*a)[2], (D, L, pos), 2)
    card_rule(x, tridiag_apply_plain, (Cinv, Lc, pos, r), 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lanes", [(), (2,), (3,), (7,), (120,)])
def test_gn_product_kernel_matches_plain(dev, dtype, lanes):
    rng = np.random.default_rng(len(lanes) and lanes[0])
    jac, plan, v, lam = random_gn_case(rng, 300, (3, 700, 200), lanes, dtype, dev, valid=0.8,
                                       coincide=7)
    scratch = {}
    before = gn_product.launches
    got = gn_product(jac, plan, v, lam, scratch)
    assert torch.equal(got, gn_product_plain(jac, plan, v, lam))
    assert torch.equal(gn_product(jac, plan, v, lam, scratch), got)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = gn_product(jac, plan, v, lam, scratch)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, got)
    assert gn_product.launches == before + 3
