"""The port's ``LTSlam`` on a mesh of 3 CPU slots (``mesh_devices=3``), in
both ``dist_mode``s, against its one-device run and ``ltm``'s, on the
port's copy of tests/test_dist_pipeline.py's ``slam_bundle`` and
``_slam_cfg`` (dense enough scans that ICP accepts real loops):

  * the mesh path runs: the SC distance, every ICP chunk and every solve
    go through the sharded functions, never the lane-compacted farm;
  * loops are inserted, and the accepted loop set is the one-device run's
    and ``ltm``'s;
  * the anchor and central poses agree to tests/test_dist_pipeline.py's
    bounds (rtol 1e-4, atol 5e-4).
"""

import dataclasses

import numpy as np
import pytest
import torch

from ltm.core.config import LTSlamConfig
from ltm.io.synthetic import make_two_sessions
from ltm.slam import LTSlam
from ltm_torch.dist import sharding as tds
from ltm_torch.slam import LTSlam as TLTSlam
from ltm_torch.slam import pipeline as tpipe
from ltm_torch.slam.convert import config_from_dict, session_from_data

torch.set_num_threads(1)

MODES = ("schur", "allreduce")


@pytest.fixture(scope="module")
def slam_bundle():
    return make_two_sessions(num_keyframes=4, num_cars=4, num_changed=2,
                             max_scan_points=6000, scan_range=70.0,
                             seed=0, point_noise=0.01)


def _slam_cfg():
    cfg = LTSlamConfig()
    cfg.max_nodes_per_session = 8
    cfg.scan_capacity = 8192
    cfg.icp.history_search_num = 2
    cfg.icp.source_capacity = 2048
    cfg.icp.target_capacity = 4096
    cfg.icp.max_iterations = 25
    cfg.num_sc_loops_upper_bound = 4
    cfg.loop_fitness_score_threshold = 0.7
    cfg.scan_context.dist_threshold = 1.5
    cfg.icp.update_trim_distance = 2.0
    return cfg


class _Calls:
    """Counts the calls of the pipeline's sharded and farm functions."""

    NAMES = ((tpipe, "solve_sharded"), (tpipe, "icp_batch_sharded"),
             (tpipe, "icp_batch_compacted"), (tds, "sc_distance_matrix"))

    def __init__(self):
        self.calls = {name: 0 for _, name in self.NAMES}
        self.saved = [(m, name, getattr(m, name)) for m, name in self.NAMES]
        for m, name, fn in self.saved:
            setattr(m, name, self._counted(name, fn))

    def _counted(self, name, fn):
        def counted(*args, **kwargs):
            self.calls[name] += 1
            return fn(*args, **kwargs)
        return counted

    def restore(self):
        for m, name, fn in self.saved:
            setattr(m, name, fn)


def _port_run(bundle, cfg):
    slam = TLTSlam(config_from_dict(dataclasses.asdict(cfg)), device="cpu")
    res = slam.run(session_from_data(bundle["central"].data),
                   session_from_data(bundle["query"].data))
    return slam, res


@pytest.fixture(scope="module")
def runs(slam_bundle):
    out = {"ltm": LTSlam(_slam_cfg()).run(slam_bundle["central"].data,
                                          slam_bundle["query"].data)}
    out["one"] = _port_run(slam_bundle, _slam_cfg())
    for mode in MODES:
        cfg = _slam_cfg()
        cfg.mesh_devices = 3
        cfg.solver.dist_mode = mode
        calls = _Calls()
        try:
            slam, res = _port_run(slam_bundle, cfg)
        finally:
            calls.restore()
        out[mode] = (slam, res, calls.calls)
    return out


def _loop_set(slam):
    return sorted((int(a[0]), int(a[1]), int(a[2]), int(a[3])) for a in slam.anchored)


@pytest.mark.parametrize("mode", MODES)
def test_mesh_path_runs_sharded(runs, mode):
    slam, _, calls = runs[mode]
    assert slam.mesh is not None and slam.mesh.size == 3
    assert calls["solve_sharded"] >= 2 and calls["icp_batch_sharded"] >= 1
    assert calls["icp_batch_compacted"] == 0
    assert calls["sc_distance_matrix"] == 3          # one a slot
    assert runs["one"][0].mesh is None


@pytest.mark.parametrize("mode", MODES)
def test_mesh_loops_match(runs, mode):
    slam, res, _ = runs[mode]
    one_slam, one = runs["one"]
    assert one.num_sc_loops > 0
    assert res.num_sc_loops == one.num_sc_loops == runs["ltm"].num_sc_loops
    assert _loop_set(slam) == _loop_set(one_slam)
    assert slam.icp_iterations == one_slam.icp_iterations


@pytest.mark.parametrize("ref", ["one", "ltm"])
@pytest.mark.parametrize("mode", MODES)
def test_mesh_poses_match(runs, mode, ref):
    _, res, _ = runs[mode]
    want = runs[ref][1] if ref == "one" else runs[ref]
    np.testing.assert_allclose(res.anchors["02"], want.anchors["02"], rtol=1e-4, atol=5e-4)
    for name in ("01", "02"):
        np.testing.assert_allclose(res.central_poses[name], want.central_poses[name],
                                   rtol=1e-4, atol=5e-4)
