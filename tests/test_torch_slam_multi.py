"""``LTSlam.run_multi`` of the port on three sessions, on the CPU:
``tests/test_slam_multi.py``'s fixture (``make_n_sessions(3, 16 keyframes,
10 cars, 3 500 points, seed 11)``) and configuration (RS upper bound 4).

  * tier-1, one run for the module: ``tests/test_slam_multi.py``'s bounds
    on the port (every anchor within 0.35 m, each session's ATE mean below
    0.25 m, at least 6 SC loops, the trajectory files).  The ICP capacities
    are halved (source 1 024, target 4 096 points, as
    ``tests/test_torch_slam_loops.py`` does): at one thread the fixture's
    ICPs at full capacity take ~190 s, at 16 keyframes or 10;
  * ``slow``: at the fixture's full capacities, the accepted SC and RS loop
    sets equal ``ltm``'s, with and without ``pairwise_session_loops`` (the
    loops between non-base sessions).  Poses are not compared: the RS pairs'
    ICP creeps (``tests/test_torch_slam_loops.py``).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from ltm_torch.core.config import LTSlamConfig
from ltm_torch.io.poses import read_kitti_poses
from ltm_torch.io.synthetic import make_n_sessions
from ltm_torch.slam import LTSlam

torch.set_num_threads(1)

FIXTURE = dict(n_sessions=3, num_keyframes=16, num_cars=10, max_scan_points=3500, seed=11)


def multi_cfg(cfg):
    """``tests/test_slam_multi.py``'s configuration on ``cfg``."""
    cfg.max_nodes_per_session = 16
    cfg.scan_capacity = 4096
    cfg.icp.history_search_num = 4
    cfg.icp.source_capacity = 2048
    cfg.icp.target_capacity = 8192
    cfg.icp.update_trim_distance = 2.0
    cfg.num_sc_loops_upper_bound = 8
    cfg.num_rs_loops_upper_bound = 4
    return cfg


@pytest.fixture(scope="module")
def bundle():
    return make_n_sessions(**FIXTURE)


@pytest.fixture(scope="module")
def result(bundle, tmp_path_factory):
    cfg = multi_cfg(LTSlamConfig())
    cfg.icp.source_capacity = 1024
    cfg.icp.target_capacity = 4096
    out = str(tmp_path_factory.mktemp("multi_out"))
    res = LTSlam(cfg, device="cpu").run_multi([s.data for s in bundle["sessions"]],
                                              save_directory=out)
    return res, out


def test_all_anchors_recovered(bundle, result):
    res, _ = result
    for i, syn in enumerate(bundle["sessions"]):
        err_t = np.linalg.norm(res.anchors[syn.data.name][:3, 3] - bundle["anchors"][i][:3, 3])
        assert err_t < 0.35, (i, err_t)


def test_all_sessions_ate(bundle, result):
    res, _ = result
    for syn in bundle["sessions"]:
        e = np.linalg.norm(res.central_poses[syn.data.name][:, :3, 3] - syn.site_poses[:, :3, 3],
                           axis=1)
        assert e.mean() < 0.25, (syn.data.name, e.mean())


def test_loops_exercised(result):
    res, _ = result
    assert res.num_sc_loops >= 6, res.diagnostics
    assert res.num_rs_loops >= 1, res.diagnostics


def test_trajectory_files(result):
    _, out = result
    for name in ("01", "02", "03"):
        p = os.path.join(out, f"{name}_central_aft_intersession_loops.txt")
        assert read_kitti_poses(p).shape[0] == 16


def _loop_sets(slam, res):
    """(SC loops, RS loops): ``slam.anchored`` takes every SC loop, then the
    RS loops, each as (node, node, anchor, anchor)."""
    loops = [tuple(int(x) for x in a[:4]) for a in slam.anchored]
    return sorted(loops[:res.num_sc_loops]), sorted(loops[res.num_sc_loops:])


@pytest.mark.slow
@pytest.mark.parametrize("pairwise", [False, True])
def test_loop_sets_match_ltm(pairwise):
    from ltm.core.config import LTSlamConfig as JLTSlamConfig
    from ltm.io.synthetic import make_n_sessions as j_make_n_sessions
    from ltm.slam import LTSlam as JLTSlam
    from ltm_torch.slam.convert import config_from_dict, session_from_data

    sessions = [s.data for s in j_make_n_sessions(**FIXTURE)["sessions"]]
    cfg = multi_cfg(JLTSlamConfig())
    cfg.pairwise_session_loops = pairwise
    ref_slam = JLTSlam(cfg)
    ref = ref_slam.run_multi(sessions)
    port_slam = LTSlam(config_from_dict(dataclasses.asdict(cfg)), device="cpu")
    port = port_slam.run_multi([session_from_data(s) for s in sessions])
    assert (port.num_sc_loops, port.num_rs_loops) == (ref.num_sc_loops, ref.num_rs_loops)
    assert port.num_rs_loops >= 1
    assert _loop_sets(port_slam, port) == _loop_sets(ref_slam, ref)
