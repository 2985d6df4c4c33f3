"""Port ``Removerter.run`` vs ``ltm``'s on the small path-equivalence
fixture of tests/test_removert.py (4 kf x 6000 points), on the CPU: on the
brute-force kNN (these maps are below ``chunk_knn_min_targets``) and with
the chunked kNN forced on.

The two packages transform points in float32 in different orders
(``apply_pose`` and the global merge differ by an ulp on a few % of
points), so map coordinates can differ by an ulp and a boundary point can
change pixel or voxel.  Each of the 14 named sets is therefore compared as
a point set with a 1e-4 m matching tolerance, and its symmetric difference
must stay within max(2, 1e-4·|set|) points.
"""

import dataclasses

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from ltm.core.config import RemovertConfig
from ltm.io.synthetic import make_two_sessions
from ltm.removert import Removerter, RemovertInput
from ltm_torch.removert import Removerter as TRemoverter
from ltm_torch.removert import RemovertInput as TRemovertInput
from ltm_torch.removert.convert import config_from_dict
from ltm_torch.removert.pipeline import MASK_NAMES

torch.set_num_threads(1)


def set_difference(a: np.ndarray, b: np.ndarray, tol: float = 1e-4) -> int:
    """Points of either set with no point of the other within ``tol``."""
    if len(a) == 0 or len(b) == 0:
        return len(a) + len(b)
    da, _ = cKDTree(b).query(a, distance_upper_bound=tol)
    db, _ = cKDTree(a).query(b, distance_upper_bound=tol)
    return int(np.isinf(da).sum() + np.isinf(db).sum())


def _small_cfg():
    cfg = RemovertConfig()
    cfg.scan_capacity = 6144
    cfg.downsample_voxel_size = 0.1
    cfg.knn_avg_sqdist_threshold = 0.04
    cfg.save_high_dyn_maps = False
    return cfg


@pytest.fixture(scope="module")
def results():
    bundle = make_two_sessions(num_keyframes=4, num_cars=6, num_changed=2,
                               max_scan_points=6000, scan_range=70.0,
                               seed=11, point_noise=0.01)

    def inp(cls, syn):
        return cls(scans=[s for s in syn.data.scans], poses=syn.site_poses)

    cfg = _small_cfg()
    ref = Removerter(cfg).run(inp(RemovertInput, bundle["central"]),
                              inp(RemovertInput, bundle["query"]))
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    port = TRemoverter(tcfg, device="cpu").run(inp(TRemovertInput, bundle["central"]),
                                               inp(TRemovertInput, bundle["query"]))
    tcfg.use_block_map = False
    flat = TRemoverter(tcfg, device="cpu").run(inp(TRemovertInput, bundle["central"]),
                                               inp(TRemovertInput, bundle["query"]))
    return ref, port, flat


@pytest.mark.parametrize("name", MASK_NAMES)
def test_port_matches_ltm(results, name):
    ref, port, _ = results
    a, b = ref.points(name), port.points(name)
    diff = set_difference(a, b)
    print(f"{name}: ltm {len(a)} port {len(b)} symmetric difference {diff}")
    assert len(a) > 0
    assert diff <= max(2, 1e-4 * len(a)), (name, len(a), len(b), diff)


def test_port_block_path_matches_flat(results):
    """The block-map sweeps reproduce the whole-map sweeps exactly (same
    map layout-independent point sets), as in ltm's own test."""
    _, port, flat = results
    for name in MASK_NAMES:
        a, b = port.points(name), flat.points(name)
        assert len(a) == len(b), (name, len(a), len(b))
        np.testing.assert_array_equal(a[np.lexsort(a.T)], b[np.lexsort(b.T)], err_msg=name)


@pytest.fixture(scope="module")
def chunk_results():
    """``ltm`` and the port on ``small_bundle`` with the chunked kNN forced
    on every map (``chunk_knn_min_targets=0``)."""
    bundle = make_two_sessions(num_keyframes=4, num_cars=6, num_changed=2,
                               max_scan_points=6000, scan_range=70.0,
                               seed=11, point_noise=0.01)

    def inp(cls, syn):
        return cls(scans=[s for s in syn.data.scans], poses=syn.site_poses)

    cfg = _small_cfg()
    cfg.chunk_knn_min_targets = 0
    ref = Removerter(cfg).run(inp(RemovertInput, bundle["central"]),
                              inp(RemovertInput, bundle["query"]))
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    port = TRemoverter(tcfg, device="cpu").run(inp(TRemovertInput, bundle["central"]),
                                               inp(TRemovertInput, bundle["query"]))
    return ref, port


@pytest.mark.parametrize("name", MASK_NAMES)
def test_port_chunk_path_matches_ltm(chunk_results, name):
    ref, port = chunk_results
    a, b = ref.points(name), port.points(name)
    diff = set_difference(a, b)
    print(f"{name}: ltm {len(a)} port {len(b)} symmetric difference {diff}")
    assert len(a) > 0
    assert diff <= max(2, 1e-4 * len(a)), (name, len(a), len(b), diff)


def test_port_chunk_path_matches_brute_path(results, chunk_results):
    """The chunked kNN's clamped statistic makes the brute force's
    decisions: the port's two paths give identical sets."""
    _, brute, _ = results
    _, chunk = chunk_results
    for name in MASK_NAMES:
        a, b = brute.points(name), chunk.points(name)
        assert len(a) == len(b), (name, len(a), len(b))
        np.testing.assert_array_equal(a[np.lexsort(a.T)], b[np.lexsort(b.T)], err_msg=name)


def test_knn_stat_chunk_fallbacks_match_ltm(rng, monkeypatch):
    """``_knn_stat`` on the chunk path with a tiny block budget, so that
    overflowed chunks escalate to k_blocks x 8 and some still go brute
    force: the port makes ``ltm``'s decisions and re-resolves the same
    queries."""
    import jax.numpy as jnp
    import ltm.kernels.chunk_knn as jck

    t = rng.uniform(-12, 12, size=(2500, 3)).astype(np.float32)
    q = np.concatenate([(t[:2000] + rng.normal(scale=0.1, size=(2000, 3))).astype(np.float32),
                        rng.uniform(-12, 12, size=(1000, 3)).astype(np.float32)])
    qm = rng.uniform(size=3000) > 0.05
    tm = rng.uniform(size=2500) > 0.1
    cfg = RemovertConfig()
    cfg.chunk_knn_min_targets = 0
    cfg.chunk_knn_chunk = 256
    cfg.chunk_knn_block_cell = 6.0
    cfg.chunk_knn_k_blocks = 8
    cfg.chunk_knn_block_capacity = 32   # more blocks a chunk: some stay over at 64
    calls = []
    kernel = jck.chunk_knn_sqdists

    def recording(*args, **kwargs):
        calls.append(kernel(*args, **kwargs))
        return calls[-1]

    monkeypatch.setattr(jck, "chunk_knn_sqdists", recording)
    d_ref = np.asarray(Removerter(cfg)._knn_stat(*(jnp.asarray(a) for a in (q, qm, t, tm))))
    rm = TRemoverter(config_from_dict(dataclasses.asdict(cfg)), device="cpu")
    d = rm._knn_stat(*(torch.from_numpy(a) for a in (q, qm, t, tm))).numpy()
    for thr in (0.01, 0.04, 1.0):
        np.testing.assert_array_equal(d < thr, d_ref < thr)

    # ltm's re-resolved queries, from its two kernel calls as its finish step
    # reads them
    ch = cfg.chunk_knn_chunk
    assert len(calls) == 2
    pos = np.flatnonzero(np.repeat(np.asarray(calls[0].chunk_overflow) > 0, ch))
    escalated = np.asarray(calls[0].order)[pos[pos < len(q)]]
    pos2 = np.flatnonzero(np.repeat(np.asarray(calls[1].chunk_overflow) > 0, ch))
    brute = escalated[np.asarray(calls[1].order)[pos2[pos2 < escalated.size]]]
    assert escalated.size and brute.size
    (got,) = rm.chunk_knn_fallbacks
    np.testing.assert_array_equal(np.sort(got["escalated"]), np.sort(escalated))
    np.testing.assert_array_equal(np.sort(got["brute"]), np.sort(brute))
