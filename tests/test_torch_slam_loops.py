"""Loop closures of the port's LT-SLAM pipeline beyond the default run, on the
pipeline fixture (24 kf x 4 000 pts, seed 3) with the ICP capacities of
tests/test_torch_slam.py, on the CPU:

  * intra-session SC loops on an odometry-only query: the same loop edges as
    ``ltm``'s, measurements within 1e-3;
  * RS loops with information gain (``num_rs_loops_upper_bound=4``, ICP
    capacities halved again): the same accepted SC and RS loop sets as
    ``ltm``'s, and the ATE bounds of tests/test_slam_pipeline.py.  Poses are
    not compared here: the RS pairs' ICP creeps (the MSE-change stop fires
    after 6 to 27 iterations), so estimates that differ by 1e-4 m after the
    SC stage start ICPs that stop at other iterations, and RS measurements
    differ by centimetres in either package's own reruns of such inputs.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ltm.io.synthetic import make_two_sessions
from ltm.slam import LTSlam
from ltm_torch.slam import LTSlam as TLTSlam
from ltm_torch.slam.convert import config_from_dict, session_from_data

from test_torch_slam import loop_set, small_cfg

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def bundle():
    return make_two_sessions(num_keyframes=24, num_cars=10, num_changed=4,
                             max_scan_points=4000, seed=3)


def _strip_loops(data):
    ef, et, er = data.edges
    keep = [k for k in range(len(ef)) if abs(int(et[k]) - int(ef[k])) == 1]
    return dataclasses.replace(data, edges=(np.asarray([ef[k] for k in keep], np.int32),
                                            np.asarray([et[k] for k in keep], np.int32),
                                            [er[k] for k in keep]))


def test_intra_session_loops_match_ltm(bundle):
    """``_add_intra_session_loops`` on an odometry-only query: the same loop
    edges as ``ltm``'s, measurements within 1e-3."""
    cfg = small_cfg()
    cfg.use_intra_session_loops = True
    cfg.scan_context.num_exclude_recent = 8
    cfg.scan_context.dist_threshold = 0.45
    stripped = _strip_loops(bundle["query"].data)
    ref = LTSlam(cfg)
    ref._load_sessions([bundle["central"].data, stripped])
    port = TLTSlam(config_from_dict(dataclasses.asdict(cfg)), device="cpu")
    port._load_sessions([session_from_data(bundle["central"].data), session_from_data(stripped)])
    n_ref, n_port = ref._add_intra_session_loops(1), port._add_intra_session_loops(1)
    assert n_port == n_ref >= 1
    ef, et, er = port.sessions[1].edges
    rf, rt, rr = ref.sessions[1].edges
    np.testing.assert_array_equal(ef, rf)
    np.testing.assert_array_equal(et, rt)
    for a, b in zip(er[-n_ref:], rr[-n_ref:]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-3)


def test_rs_loops_match_ltm(bundle):
    cfg = small_cfg()
    cfg.icp.source_capacity = 512
    cfg.icp.target_capacity = 2048
    cfg.num_rs_loops_upper_bound = 4
    ref_slam = LTSlam(cfg)
    ref = ref_slam.run(bundle["central"].data, bundle["query"].data)
    port_slam = TLTSlam(config_from_dict(dataclasses.asdict(cfg)), device="cpu")
    port = port_slam.run(session_from_data(bundle["central"].data),
                         session_from_data(bundle["query"].data))
    assert port.num_rs_loops == ref.num_rs_loops >= 1
    assert loop_set(port_slam) == loop_set(ref_slam)
    for name, syn in (("01", bundle["central"]), ("02", bundle["query"])):
        e = np.linalg.norm(port.central_poses[name][:, :3, 3] - syn.site_poses[:, :3, 3], axis=1)
        assert e.mean() < 0.2 and e.max() < 0.5, (name, e.mean(), e.max())
