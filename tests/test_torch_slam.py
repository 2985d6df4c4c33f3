"""Port ``LTSlam.run`` against ``ltm``'s on the pipeline fixture of
tests/test_slam_pipeline.py (24 kf x 4 000 pts, seed 3), on the CPU.  Both
packages get the same configuration, with the ICP capacities shrunk alike
(source 1 024, target 4 096 points) to keep the two runs short.

Required: the same SC candidate pairs and accepted loop set as ``ltm``'s;
central poses within 0.01 m of ``ltm``'s; the ATE bounds of
tests/test_slam_pipeline.py (mean < 0.2 m, max < 0.5 m) and the anchor
within 0.3 m and 1.5°; the same trajectory files, poses within 0.01 m.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltm.core.config import LTSlamConfig
from ltm.io.poses import read_kitti_poses
from ltm.io.synthetic import make_two_sessions
from ltm.slam import LTSlam
from ltm.slam.pipeline import _anchored_jacobian_batch as j_jac
from ltm_torch.io.poses import read_kitti_poses as t_read_kitti_poses
from ltm_torch.slam import LTSlam as TLTSlam
from ltm_torch.slam.convert import config_from_dict, session_from_data
from ltm_torch.slam.pipeline import _anchored_jacobian_batch as t_jac

torch.set_num_threads(1)

POSE_TOL = 0.01   # m


def small_cfg():
    cfg = LTSlamConfig()
    cfg.max_nodes_per_session = 32
    cfg.scan_capacity = 6144
    cfg.icp.history_search_num = 5
    cfg.icp.source_capacity = 1024
    cfg.icp.target_capacity = 4096
    cfg.num_sc_loops_upper_bound = 12
    cfg.loop_fitness_score_threshold = 0.7
    cfg.icp.update_trim_distance = 2.0
    return cfg


@pytest.fixture(scope="module")
def bundle():
    return make_two_sessions(num_keyframes=24, num_cars=10, num_changed=4,
                             max_scan_points=4000, seed=3)


@pytest.fixture(scope="module")
def runs(bundle, tmp_path_factory):
    out = tmp_path_factory.mktemp("slam")
    cfg = small_cfg()
    ref_slam = LTSlam(cfg)
    ref = ref_slam.run(bundle["central"].data, bundle["query"].data,
                       save_directory=str(out / "ltm"))
    port_slam = TLTSlam(config_from_dict(dataclasses.asdict(cfg)), device="cpu")
    port = port_slam.run(session_from_data(bundle["central"].data),
                         session_from_data(bundle["query"].data),
                         save_directory=str(out / "port"))
    return ref_slam, ref, port_slam, port, out


def loop_set(slam):
    return sorted((int(a[0]), int(a[1]), int(a[2]), int(a[3])) for a in slam.anchored)


def test_sc_candidate_pairs_match(runs):
    ref_slam, _, port_slam, _, _ = runs
    ref_pairs, ref_miss, ref_yaw = ref_slam._detect_sc_loops(1)
    pairs, miss, yaw = port_slam._detect_sc_loops(1)
    assert len(pairs) >= 4
    assert pairs == ref_pairs and miss == ref_miss
    assert yaw == ref_yaw


def test_accepted_loop_set_matches(runs):
    ref_slam, ref, port_slam, port, _ = runs
    assert port.num_sc_loops == ref.num_sc_loops >= 4
    assert loop_set(port_slam) == loop_set(ref_slam)
    assert port.diagnostics == ref.diagnostics


@pytest.mark.parametrize("name", ["01", "02"])
def test_central_poses_match_ltm(runs, name):
    _, ref, _, port, _ = runs
    d = np.abs(port.central_poses[name] - ref.central_poses[name]).max()
    print(f"session {name}: max |port - ltm| {d:.2e}")
    assert d < POSE_TOL
    assert np.abs(port.anchors[name] - ref.anchors[name]).max() < POSE_TOL


@pytest.mark.parametrize("name", ["01", "02"])
def test_central_trajectory_ate(bundle, runs, name):
    _, _, _, port, _ = runs
    syn = bundle["central" if name == "01" else "query"]
    e = np.linalg.norm(port.central_poses[name][:, :3, 3] - syn.site_poses[:, :3, 3], axis=1)
    assert e.mean() < 0.2 and e.max() < 0.5, (e.mean(), e.max())


def test_anchor_recovered(bundle, runs):
    _, _, _, port, _ = runs
    est, gt = port.anchors["02"], bundle["anchor_query"]
    err_r = np.degrees(np.arccos(np.clip((np.trace(est[:3, :3].T @ gt[:3, :3]) - 1) / 2, -1, 1)))
    assert np.linalg.norm(est[:3, 3] - gt[:3, 3]) < 0.3
    assert err_r < 1.5


FILES = [f"{n}_{k}_{p}_intersession_loops.txt" for n in ("01", "02")
         for k in ("local", "central") for p in ("bfr", "aft")]


@pytest.mark.parametrize("fname", FILES)
def test_trajectory_files_match(runs, fname):
    *_, out = runs
    assert sorted(os.listdir(out / "port")) == sorted(os.listdir(out / "ltm")) == sorted(FILES)
    ref = read_kitti_poses(str(out / "ltm" / fname))
    got = t_read_kitti_poses(str(out / "port" / fname))
    assert got.shape == ref.shape == (24, 4, 4)
    assert np.abs(got - ref).max() < POSE_TOL


def test_anchored_jacobians_match_ltm(runs):
    """The RS info-gain Jacobians (``torch.func`` against ``jax.jacfwd``) at
    the solved poses, a batch of node pairs."""
    _, _, port_slam, _, _ = runs
    poses = port_slam._last_poses.numpy()
    t_vars = np.arange(3, 13)
    s_vars = np.arange(36, 46)
    args = (poses[t_vars], poses[s_vars], np.broadcast_to(poses[0], (10, 4, 4)),
            np.broadcast_to(poses[1], (10, 4, 4)))
    ref = j_jac(*(jnp.asarray(a) for a in args))
    got = t_jac(*(torch.from_numpy(np.array(a)) for a in args))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)


def test_equisample_and_yaw_inits():
    pairs = [(i, 2 * i) for i in range(37)]
    for upper in (0, 5, 12, 36, 100):
        assert TLTSlam._equisample(pairs, upper) == LTSlam._equisample(pairs, upper)
    yaws = {2 * i: 0.1 * i - 1.0 for i in range(37)}
    np.testing.assert_array_equal(TLTSlam._yaw_inits(pairs, yaws), LTSlam._yaw_inits(pairs, yaws))
