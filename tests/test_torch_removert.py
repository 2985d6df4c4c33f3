"""Port ``Removerter.run`` vs ``ltm``'s on the small path-equivalence
fixture of tests/test_removert.py (4 kf x 6000 points), on the CPU.

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


def test_chunk_knn_at_map_scale_is_refused(results):
    """With use_chunk_knn on, a target map at or above chunk_knn_min_targets
    must raise, not switch paths."""
    _, port, _ = results
    cfg = config_from_dict(dataclasses.asdict(_small_cfg()))
    cfg.chunk_knn_min_targets = 1024
    rm = TRemoverter(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="chunk kNN"):
        rm._knn_stat(port.central.map_xyz, port.central.map_mask,
                     port.query.map_xyz, port.query.map_mask)
