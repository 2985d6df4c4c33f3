"""LT-SLAM's sharded functions in the port (``ltm_torch.dist.sharding``'s
Scan Context distance and ICP farm, ``ltm_torch.dist.solver``) on meshes
of CPU slots, against the port's one-device functions and against
``ltm``'s sharded functions on conftest's 8 virtual devices:

  * ``reduce_sum`` adds the slots' parts in slot order;
  * ``pad_graph_for_mesh`` pads as ``ltm``'s does, host copies too;
  * ``sc_distance_sharded`` and ``icp_batch_sharded`` to
    tests/test_dist.py's bounds (distance 1e-5 and equal shifts; transform
    1e-4, fitness rtol 1e-3 / atol 1e-4), and the sharded farm against the
    lane-compacted one the one-device pipeline runs, bit for bit;
  * ``solve_sharded`` in both ``dist_mode``s on tests/test_dist.py's
    12-node chain and two-session anchored graph, to ``ltm``'s mesh bounds
    (pose log < 1e-3, final cost rtol 0.05, anchor 1 recovered < 0.05);
  * a schur step's ``delta`` equals the one-device step's bit for bit;
  * collectives a step: the schur step's count does not grow with the CG
    iterations, the all-reduce step's grows by one an iteration.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltm.core.config import SolverConfig as JSolverConfig
from ltm.dist import icp_batch_sharded as j_icp_sharded
from ltm.dist import make_mesh as j_make_mesh
from ltm.dist import pad_graph_for_mesh as j_pad_graph
from ltm.dist import sc_distance_sharded as j_sc_sharded
from ltm.dist import solve_sharded as j_solve_sharded
from ltm.graph import build_graph_data as j_build
from ltm_torch.core import se3
from ltm_torch.core.config import SolverConfig
from ltm_torch.dist import make_mesh, pad_graph_for_mesh, solve_sharded
from ltm_torch.dist import mesh as tmesh
from ltm_torch.dist import solver as dsolver
from ltm_torch.dist.sharding import icp_batch_sharded, sc_distance_sharded
from ltm_torch.graph import solve
from ltm_torch.graph import solver as tsolver
from ltm_torch.register.icp import icp_batch, icp_batch_compacted
from ltm_torch.retrieval.scancontext import sc_distance_matrix
from ltm_torch.slam.convert import graph_from_arrays, graph_to_arrays

from test_dist import _two_session_anchored_graph
from test_graph import make_chain

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jmesh():
    devs = jax.devices()
    assert len(devs) == 8
    return j_make_mesh(devs)


def cpu_mesh(slots):
    return make_mesh(["cpu"] * slots)


def test_reduce_sum_over_uneven_slots(rng):
    parts = [torch.from_numpy(rng.normal(size=(4, 6)).astype(np.float32)) for _ in range(5)]
    for slots in (1, 3, 5):
        got = tmesh.reduce_sum(cpu_mesh(slots), parts[:slots])
        want = parts[0]
        for p in parts[1:slots]:
            want = want + p
        assert torch.equal(got, want)
    # one slot: the part itself, moved to the device; the sum writes no part
    kept = parts[0].clone()
    tmesh.reduce_sum(cpu_mesh(3), parts[:3])
    assert torch.equal(parts[0], kept)
    assert torch.equal(tmesh.reduce_sum(cpu_mesh(2), [torch.tensor(1.0), torch.tensor(2.5)],
                                        torch.device("cpu")), torch.tensor(3.5))


def _chain_graph():
    """tests/test_dist.py's 12-node chain with one robust loop (ltm's graph)."""
    n = 12
    gt, odo, init = make_chain(n, noise=0.04)
    fixed = np.zeros(n, bool)
    fixed[0] = True
    betweens = [(i, i + 1, odo[i], (1e-4,) * 6, False) for i in range(n - 1)]
    betweens.append((0, n - 1, np.linalg.inv(gt[0]) @ gt[n - 1], (1e-3,) * 6, True))
    return j_build(init, fixed, betweens=betweens), None


GRAPHS = {"chain": _chain_graph, "anchored": _two_session_anchored_graph}


@pytest.fixture(scope="module")
def graphs():
    """name -> (ltm GraphData, the port's, ground truth or None)."""
    out = {}
    for name, make in GRAPHS.items():
        jg, gt = make()
        out[name] = (jg, graph_from_arrays(graph_to_arrays(jg), "cpu"),
                     None if gt is None else torch.from_numpy(np.asarray(gt)))
    return out


@pytest.mark.parametrize("n", [3, 8])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_pad_graph_matches_ltm(graphs, name, n):
    jg, tg, _ = graphs[name]
    want = graph_to_arrays(j_pad_graph(jg, n))
    gp = pad_graph_for_mesh(tg, n)
    got = graph_to_arrays(gp)
    assert any(got[k].shape != v.shape for k, v in graph_to_arrays(tg).items())
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v.astype(got[k].dtype), err_msg=k)
    for k, v in gp.host.items():
        np.testing.assert_array_equal(v, got[k], err_msg=k)


def test_sc_distance_sharded(rng, jmesh):
    q = rng.uniform(0, 4, size=(13, 20, 60)).astype(np.float32)
    t = rng.uniform(0, 4, size=(9, 20, 60)).astype(np.float32)
    q[2, :, 7:19] = 0.0                         # empty columns
    ref_d, ref_s = j_sc_sharded(jmesh, jnp.asarray(q), jnp.asarray(t), full_shift_search=True)
    one_d, one_s = sc_distance_matrix(torch.from_numpy(q), torch.from_numpy(t),
                                      full_shift_search=True)
    for slots in (1, 3, 8):
        d, s = sc_distance_sharded(cpu_mesh(slots), torch.from_numpy(q), torch.from_numpy(t),
                                   full_shift_search=True)
        np.testing.assert_allclose(d.numpy(), np.asarray(ref_d), atol=1e-5)
        np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))
        assert torch.equal(d, one_d) and torch.equal(s, one_s)
    d, s = sc_distance_sharded(cpu_mesh(3), torch.from_numpy(q), torch.from_numpy(t),
                               full_shift_search=False)
    one_d, one_s = sc_distance_matrix(torch.from_numpy(q), torch.from_numpy(t))
    assert torch.equal(d, one_d) and torch.equal(s, one_s)


@pytest.fixture(scope="module")
def icp_lanes():
    """tests/test_dist.py's ICP batch with 5 lanes (B not a multiple of 3)."""
    rng = np.random.default_rng(0)
    B, NS, NT = 5, 256, 1024
    base = rng.normal(size=(NT, 3)).astype(np.float32) * np.array([10, 10, 2], np.float32)
    srcs = []
    for b in range(B):
        c, s = np.cos(0.05 * b), np.sin(0.05 * b)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        srcs.append(base[:NS] @ R.T + np.array([0.1 * b, -0.1, 0], np.float32))
    sm = np.ones((B, NS), bool)
    sm[3, 200:] = False
    return (np.stack(srcs), sm, np.stack([base] * B), np.ones((B, NT), bool))


ICP_KW = dict(max_iterations=30, tile=512)


def test_icp_batch_sharded(icp_lanes, jmesh):
    ref = j_icp_sharded(jmesh, *(jnp.asarray(a) for a in icp_lanes), **ICP_KW)
    args = [torch.from_numpy(a) for a in icp_lanes]
    one = icp_batch(*args, **ICP_KW)
    for slots in (1, 3):
        got = icp_batch_sharded(cpu_mesh(slots), *args, **ICP_KW)
        for want in (ref, one):
            np.testing.assert_allclose(got.transform.numpy(), np.asarray(want.transform), atol=1e-4)
            np.testing.assert_allclose(got.fitness.numpy(), np.asarray(want.fitness),
                                       rtol=1e-3, atol=1e-4)
        np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
        assert got.converged.dtype == torch.bool and bool(got.converged.all())
        for g, w in zip(got, one, strict=True):
            assert torch.equal(g, w)


def test_icp_sharded_farm_equals_compacted_farm(icp_lanes):
    """The mesh pipeline runs ``icp_batch`` per shard in chunks where the
    one-device pipeline runs the lane-compacted farm: the same bits."""
    args = [torch.from_numpy(a) for a in icp_lanes]
    kw = dict(ICP_KW, max_correspondence_distance=150.0)
    comp = icp_batch_compacted(*args, segment=4, width=2, **kw)
    got = icp_batch_sharded(cpu_mesh(3), *args, **kw)
    assert int(comp.iterations.max()) > 4          # lanes retire across segments
    for g, w in zip(got, comp, strict=True):
        assert torch.equal(g, w)


def _cfg(mode, **kw):
    return dataclasses.replace(SolverConfig(max_outer_iterations=8), dist_mode=mode, **kw)


# (graph, dist_mode, slots): tests/test_dist.py's three cases (chain in
# schur mode, the anchored graph in both) also against ltm's solve_sharded
SOLVES = [("chain", "schur", 3), ("chain", "schur", 8), ("chain", "allreduce", 3),
          ("anchored", "schur", 3), ("anchored", "schur", 8), ("anchored", "allreduce", 3)]
LTM_SOLVES = [("chain", "schur"), ("anchored", "schur"), ("anchored", "allreduce")]


@pytest.fixture(scope="module")
def solved(graphs, jmesh):
    """(name, mode) -> ltm's sharded poses and final cost on 8 devices."""
    out = {}
    for name, mode in LTM_SOLVES:
        cfg = dataclasses.replace(JSolverConfig(max_outer_iterations=8), dist_mode=mode)
        poses, info = j_solve_sharded(graphs[name][0], jmesh, cfg)
        out[name, mode] = (torch.from_numpy(np.asarray(poses)), float(info.cost_final))
    return out


def _pose_log_err(a, b):
    return float(se3.log(se3.between(a, b)).abs().max())


@pytest.mark.parametrize("name,mode,slots", SOLVES)
def test_solve_sharded_matches(graphs, solved, name, mode, slots):
    _, tg, gt = graphs[name]
    cfg = _cfg(mode)
    one, info_one = solve(tg, cfg)
    poses, info = solve_sharded(tg, cpu_mesh(slots), cfg)
    assert info.iterations >= 1
    refs = [(one, float(info_one.cost_final))]
    if (name, mode) in solved:
        refs.append(solved[name, mode])
    for want, want_cost in refs:
        assert _pose_log_err(want, poses) < 1e-3
        np.testing.assert_allclose(float(info.cost_final), want_cost, rtol=0.05, atol=1e-4)
    if gt is not None:         # anchor 1 recovered (it starts at the identity)
        assert _pose_log_err(poses[1], gt[1]) < 0.05


class _Recorder:
    """Wraps a function of a module, recording its results."""

    def __init__(self, monkeypatch, module, name):
        self.fn, self.out = getattr(module, name), []
        monkeypatch.setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        self.out.append(self.fn(*args, **kwargs))
        return self.out[-1]


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_schur_step_delta_equals_one_device(graphs, monkeypatch, name):
    """From the same state the schur step solves the one-device step's
    system (trailing invalid factors add +0.0): ``delta`` and the CG
    residual bit for bit; only the cost's sum order differs."""
    _, tg, _ = graphs[name]
    cfg = _cfg("schur")
    one_pcg = _Recorder(monkeypatch, tsolver, "_pcg")
    mesh_pcg = _Recorder(monkeypatch, dsolver, "_pcg")
    for slots in (3, 8):
        cfg1 = dataclasses.replace(cfg, max_outer_iterations=1)
        solve(tg, cfg1)
        solve_sharded(tg, cpu_mesh(slots), cfg1)
        (d1, r1), (d2, r2) = one_pcg.out[-1], mesh_pcg.out[-1]
        assert float(d1.abs().max()) > 0
        assert torch.equal(d1, d2) and torch.equal(r1, r2)


def _collectives_a_step(monkeypatch, tg, mode, cg_iterations):
    counts = {"concat": 0, "reduce_sum": 0}
    for fn in counts:
        inner = getattr(dsolver, fn)

        def counted(*args, _fn=fn, _inner=inner, **kwargs):
            counts[_fn] += 1
            return _inner(*args, **kwargs)
        monkeypatch.setattr(dsolver, fn, counted)
    hvps = _Recorder(monkeypatch, dsolver, "_gn_product")
    # cg_tol 0: CG runs every iteration it may
    solve_sharded(tg, cpu_mesh(3), _cfg(mode, max_outer_iterations=1, cg_iterations=cg_iterations,
                                        cg_tol=0.0))
    monkeypatch.undo()
    counts["reduce_sum"] -= 1                 # the initial cost
    return counts, len(hvps.out) // 3


def test_collectives_per_step(graphs, monkeypatch):
    """``ltm``'s test_schur_step_has_no_collectives_in_cg_loop, by count:
    the schur step's collectives do not depend on the CG iterations (21
    gathers, one cost sum); the all-reduce step adds one sum a CG
    iteration to its gradient, two preconditioner and cost sums."""
    _, tg, _ = graphs["anchored"]
    schur = [_collectives_a_step(monkeypatch, tg, "schur", it) for it in (2, 9)]
    assert schur[0] == schur[1] == ({"concat": 21, "reduce_sum": 1}, 0)
    for it in (2, 9):
        counts, cg = _collectives_a_step(monkeypatch, tg, "allreduce", it)
        assert cg == it and counts == {"concat": 0, "reduce_sum": 4 + it}
