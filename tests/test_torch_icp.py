"""ICP and its 1-NN of the port against ``ltm`` (under ``jit``), on the CPU.

  * ``nn_sqdist_argmin``: distances within 1e-6 relative; indices equal
    except at counted near-ties (both candidates within 1e-5 m² of the
    exact minimum);
  * the cases of ``tests/test_icp.py`` on the port;
  * transforms against ``ltm``'s within 1e-4 rad and 1e-3 m;
  * ``icp_batch_compacted`` bitwise equal to ``icp_batch`` in the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltm.core import se3 as jse3
from ltm.kernels.knn import nn_sqdist_argmin as j_nn
from ltm.register import icp as jicp
from ltm_torch.core import se3
from ltm_torch.kernels.knn import nn_sqdist_argmin
from ltm_torch.register import icp_batch, icp_batch_compacted, icp_point_to_point, fitness_score
from ltm_torch.register.icp import CRIT_ABS_MSE, CRIT_MAX_ITER, CRIT_TRANSFORM_EPS

from test_icp import structured_cloud

torch.set_num_threads(1)


def T_of(yaw, t):
    return se3.from_rpy(0.0, 0.0, yaw, t=t)


def pose_err(T_a, T_b):
    """(rotation rad, translation m) of T_a⁻¹ T_b."""
    d = se3.log(se3.between(torch.as_tensor(np.asarray(T_a), dtype=torch.float32),
                            torch.as_tensor(np.asarray(T_b), dtype=torch.float32)))
    return float(d[..., :3].abs().max()), float(d[..., 3:].abs().max())


def ones(n):
    return torch.ones(n, dtype=torch.bool)


@pytest.mark.parametrize("offset", [0.0, 400.0])
def test_nn_matches_ltm(rng, offset):
    """Three lanes at once against ltm's vmapped kernel, with masked queries
    and targets, at the origin and 400 m away."""
    t = (rng.uniform(-20, 20, (3, 3000, 3)) + offset).astype(np.float32)
    q = (t[:, :1800] + rng.normal(scale=0.05, size=(3, 1800, 3))).astype(np.float32)
    qm = rng.uniform(size=(3, 1800)) > 0.1
    tm = rng.uniform(size=(3, 3000)) > 0.2
    d_ref, i_ref = (np.asarray(x) for x in jax.jit(jax.vmap(
        lambda a, b, c, d: j_nn(a, b, c, d, tile=1024)))(q, qm, t, tm))
    d, i = nn_sqdist_argmin(*(torch.from_numpy(a) for a in (q, qm, t, tm)), tile=1024)
    d, i = d.numpy(), i.numpy()
    np.testing.assert_allclose(d, d_ref, rtol=1e-6)
    diff = (i != i_ref) & qm
    if diff.any():   # near-ties: both picks are within 1e-5 m² of the exact nearest
        lane, row = np.nonzero(diff)
        for idx in (i, i_ref):
            e = ((q[lane, row] - t[lane, idx[lane, row]]) ** 2).sum(-1)
            assert np.all(np.abs(e - d_ref[lane, row]) <= 1e-5)
    print(f"offset {offset}: {int(diff.sum())} near-tie index differences of {int(qm.sum())}")
    assert diff.sum() <= 3


def test_nn_invalid_rows_and_no_target(rng):
    q = torch.from_numpy(rng.normal(size=(50, 3)).astype(np.float32))
    qm = torch.from_numpy(rng.uniform(size=50) > 0.5)
    d, _ = nn_sqdist_argmin(q, qm, q, torch.zeros(50, dtype=torch.bool), tile=16)
    assert torch.all(d == 1e30)
    d, _ = nn_sqdist_argmin(q, qm, q, ones(50), tile=16)
    assert torch.all(d[~qm] == 1e30) and torch.all(d[qm] == 0)


def test_icp_recovers_known_transform(rng):
    src = structured_cloud(rng)
    T_gt = T_of(0.15, [0.8, -0.5, 0.1])
    tgt = se3.transform_points(T_gt, torch.from_numpy(src))
    n = len(src)
    res = icp_point_to_point(torch.from_numpy(src), ones(n), tgt, ones(n), max_iterations=60, tile=1024)
    r, t = pose_err(T_gt, res.transform)
    assert max(r, t) < 1e-3
    assert float(res.fitness) < 1e-4
    assert bool(res.converged)


def test_icp_fitness_on_mismatch(rng):
    src = structured_cloud(rng, 600)
    tgt = structured_cloud(np.random.default_rng(99), 600) + np.array([30, 0, 0], np.float32)
    res = icp_point_to_point(torch.from_numpy(src), ones(len(src)), torch.from_numpy(tgt),
                             ones(len(tgt)), max_iterations=25, tile=1024)
    assert float(res.fitness) > 0.5


def test_fitness_matches_oracle(rng):
    src = rng.normal(size=(100, 3)).astype(np.float32)
    tgt = rng.normal(size=(200, 3)).astype(np.float32)
    f = float(fitness_score(torch.from_numpy(src), ones(100), torch.from_numpy(tgt), ones(200),
                            torch.eye(4), tile=64))
    d2 = ((src[:, None] - tgt[None]) ** 2).sum(-1).min(1)
    np.testing.assert_allclose(f, d2.mean(), rtol=1e-4)


def test_icp_empty_target():
    src = torch.from_numpy(np.random.default_rng(0).normal(size=(50, 3)).astype(np.float32))
    res = icp_point_to_point(src, ones(50), src, torch.zeros(50, dtype=torch.bool),
                             max_iterations=5, tile=64)
    assert not bool(res.converged)
    assert int(res.iterations) == 0


def test_icp_coarse_to_fine(rng):
    src = structured_cloud(rng)
    T_gt = T_of(0.12, [0.7, -0.4, 0.1])
    tgt = se3.transform_points(T_gt, torch.from_numpy(src))
    n = len(src)
    res = icp_point_to_point(torch.from_numpy(src), ones(n), tgt, ones(n), max_iterations=40,
                             tile=1024, coarse_iterations=25, coarse_stride=4)
    r, t = pose_err(T_gt, res.transform)
    assert max(r, t) < 2e-3
    assert float(res.fitness) < 1e-3


def test_icp_converged_pcl_semantics_max_iter(rng):
    src = structured_cloud(rng, 800)
    tgt = (src + rng.normal(0, 0.05, src.shape)).astype(np.float32)
    res = icp_point_to_point(torch.from_numpy(src), ones(len(src)), torch.from_numpy(tgt),
                             ones(len(tgt)), max_iterations=2, transformation_epsilon=1e-30,
                             euclidean_fitness_epsilon=0.0, tile=1024)
    assert bool(res.converged)
    assert int(res.iterations) == 2
    assert int(res.criterion) == CRIT_MAX_ITER


def test_icp_abs_mse_criterion_stops_early(rng):
    src = structured_cloud(rng, 800)
    tgt = (src + rng.normal(0, 0.05, src.shape)).astype(np.float32)
    res = icp_point_to_point(torch.from_numpy(src), ones(len(src)), torch.from_numpy(tgt),
                             ones(len(tgt)), max_iterations=100, transformation_epsilon=1e-30,
                             euclidean_fitness_epsilon=1e-4, tile=1024)
    assert bool(res.converged)
    assert int(res.iterations) < 100
    assert int(res.criterion) == CRIT_ABS_MSE


def test_icp_transform_eps_fires_far_from_origin(rng):
    src = structured_cloud(rng) + np.array([450.0, -380.0, 12.0], np.float32)
    T_gt = T_of(0.1, [0.6, -0.3, 0.05])
    tgt = se3.transform_points(T_gt, torch.from_numpy(src))
    n = len(src)
    res = icp_point_to_point(torch.from_numpy(src), ones(n), tgt, ones(n), max_iterations=100,
                             tile=1024)
    assert bool(res.converged)
    assert int(res.iterations) < 50
    assert int(res.criterion) == CRIT_TRANSFORM_EPS
    r, t = pose_err(T_gt, res.transform)
    assert max(r, t) < 5e-3


@pytest.fixture(scope="module")
def lanes():
    """Five pairs of one structured cloud under growing transforms and noise."""
    rng = np.random.default_rng(5)
    src = structured_cloud(rng, 700)
    tgts = []
    for i in range(5):
        T = np.asarray(jse3.from_rpy(0, 0, 0.05 * (i + 1), t=[0.3 * i, -0.2, 0.0]))
        tgts.append((src @ T[:3, :3].T + T[:3, 3]
                     + rng.normal(0, 0.01 * (i + 1), src.shape)).astype(np.float32))
    return np.stack([src] * 5), np.stack(tgts), np.ones((5, len(src)), bool)


@pytest.mark.parametrize("trim", [None, 0.5])
def test_icp_batch_matches_ltm(lanes, trim):
    """Transforms within 1e-4 rad / 1e-3 m of ltm's; iterations within 2."""
    s, t, m = lanes
    kw = dict(max_iterations=60, tile=1024, update_trim_distance=trim)
    ref = jicp.icp_batch(jnp.asarray(s), jnp.asarray(m), jnp.asarray(t), jnp.asarray(m), **kw)
    got = icp_batch(*(torch.from_numpy(a) for a in (s, m, t, m)), **kw)
    for b in range(5):
        r, tr = pose_err(np.asarray(ref.transform[b]), got.transform[b])
        assert r < 1e-4 and tr < 1e-3, (b, r, tr)
    np.testing.assert_allclose(got.fitness.numpy(), np.asarray(ref.fitness), rtol=1e-3, atol=1e-6)
    assert np.abs(got.iterations.numpy() - np.asarray(ref.iterations)).max() <= 2
    assert got.converged.all()


def test_icp_batch_compacted_matches_batch(lanes):
    """Lane compaction is result-invariant in the port: transforms,
    iterations and criteria bitwise, fitness too; lane-bucket padding with
    empty lanes changes no real lane."""
    s, t, m = (torch.from_numpy(a) for a in lanes)
    ref = icp_batch(s, m, t, m, max_iterations=60, tile=1024)
    got = icp_batch_compacted(s, m, t, m, max_iterations=60, tile=1024, segment=13, width=2)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)
    pad = 16 - 5
    n = s.shape[1]
    s_p = torch.cat([s, s[:1].expand(pad, n, 3)])
    t_p = torch.cat([t, t[:1].expand(pad, n, 3)])
    m_p = torch.cat([m, torch.zeros(pad, n, dtype=torch.bool)])
    got_p = icp_batch_compacted(s_p, m_p, t_p, m_p, max_iterations=60, tile=1024, segment=13,
                                width=2)
    for a, b in zip(got, got_p):
        assert torch.equal(a, b[:5])
    assert not got_p.converged[5:].any()
    assert torch.all(got_p.iterations[5:] == 0)
