"""``ltm_torch.graph.checkpoint`` (the mirror of tests/test_checkpoint.py):
a solved graph saved and loaded by the port resumes where it stopped, and
the ``.npz`` crosses both ways, written by ``ltm`` and loaded by the port,
written by the port and loaded by ``ltm``, with the same arrays, estimates
and metadata; a solve from the loaded graph equals one from the
original."""

import dataclasses

import numpy as np
import pytest
import torch

from ltm.graph import build_graph_data as j_build_graph_data
from ltm.graph import solve as j_solve
from ltm.graph.checkpoint import load_graph as j_load_graph
from ltm.graph.checkpoint import save_graph as j_save_graph
from ltm_torch.core import se3
from ltm_torch.graph import build_graph_data, solve
from ltm_torch.graph.checkpoint import load_graph, save_graph
from ltm_torch.graph.factors import GRAPH_FIELDS

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def chain():
    from tests.test_graph import make_chain

    n = 8
    _, odo, init = make_chain(n, noise=0.03)
    fixed = np.zeros(n, bool)
    fixed[0] = True
    betweens = [(i, i + 1, odo[i], (1e-4,) * 6, False) for i in range(n - 1)]
    return np.asarray(init, np.float32), fixed, betweens


def test_graph_checkpoint_roundtrip(chain, tmp_path):
    g = build_graph_data(*chain[:2], betweens=chain[2])
    poses, info = solve(g)
    p = str(tmp_path / "graph.npz")
    save_graph(p, g, poses=poses, meta={"iterations": int(info.iterations)})
    g2, est, meta = load_graph(p)
    for name in GRAPH_FIELDS:
        assert torch.equal(getattr(g2, name), getattr(g, name)), name
    assert torch.equal(est, poses)
    assert int(meta["iterations"]) == int(info.iterations)
    for k in ("fixed", "bet_i", "bet_j", "bet_valid"):
        np.testing.assert_array_equal(g2.host[k], g.host[k])
    # resuming from the checkpointed estimates converges at once
    poses2, info2 = solve(dataclasses.replace(g2, poses0=est))
    err = se3.log(se3.between(poses, poses2)).abs().max()
    assert float(err) < 1e-4
    assert float(info2.cost_final) <= float(info.cost_final) + 1e-5


def test_checkpoint_crosses_packages(chain, tmp_path):
    init, fixed, betweens = chain
    g_t = build_graph_data(init, fixed, betweens=betweens)
    g_j = j_build_graph_data(init, fixed, betweens=betweens)
    poses_t, _ = solve(g_t)

    # written by ltm, loaded by the port
    p_j = str(tmp_path / "ltm.npz")
    j_save_graph(p_j, g_j, poses=np.asarray(poses_t.numpy()), meta={"round": 3})
    g, est, meta = load_graph(p_j)
    for name in GRAPH_FIELDS:
        np.testing.assert_array_equal(getattr(g, name).numpy(), np.asarray(getattr(g_j, name)),
                                      err_msg=name)
    assert torch.equal(est, poses_t) and int(meta["round"]) == 3
    a, _ = solve(g)
    b, _ = solve(g_t)
    assert torch.equal(a, b)

    # written by the port, loaded by ltm: the same keys and dtypes as ltm's own
    p_t = str(tmp_path / "port.npz")
    save_graph(p_t, g_t, poses=poses_t, meta={"round": 3})
    with np.load(p_t) as mine, np.load(p_j) as theirs:
        assert sorted(mine.files) == sorted(theirs.files)
        for k in theirs.files:
            assert mine[k].dtype == theirs[k].dtype, k
            np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
    g2, est2, meta2 = j_load_graph(p_t)
    np.testing.assert_array_equal(np.asarray(est2), poses_t.numpy())
    p_a, _ = j_solve(g2)
    p_b, _ = j_solve(g_j)
    np.testing.assert_array_equal(np.asarray(p_a), np.asarray(p_b))
