"""``python -m ltm_torch.cli.ltremovert`` on the CPU: argument handling, the
device-mesh contract, and an end-to-end run on small session directories
whose artifact tree must match ``ltm``'s (the same files, the same point
count in each)."""

import dataclasses
import os

import numpy as np
import pytest
import torch
import yaml

from ltm.core.config import RemovertConfig
from ltm.io.pcd import read_pcd as j_read_pcd
from ltm.io.pcd import write_pcd as j_write_pcd
from ltm.io.poses import write_kitti_poses
from ltm.io.synthetic import make_two_sessions
from ltm.removert import Removerter, RemovertInput
from ltm_torch.cli.ltremovert import main
from ltm_torch.io.pcd import read_pcd
from ltm_torch.removert import Removerter as TRemoverter
from ltm_torch.dist import mesh_from_config

torch.set_num_threads(1)


def _small_cfg():
    cfg = RemovertConfig()
    cfg.scan_capacity = 6144
    cfg.downsample_voxel_size = 0.1
    cfg.knn_avg_sqdist_threshold = 0.04
    cfg.save_range_image_pngs = True
    return cfg


def _write_session(root, syn):
    """A scan directory (names without zero padding, so the numeric sort
    matters) and a KITTI pose file."""
    scans = os.path.join(root, "scans")
    os.makedirs(scans)
    for i, scan in enumerate(syn.data.scans):
        j_write_pcd(os.path.join(scans, f"{i}.pcd"), np.asarray(scan))
    write_kitti_poses(os.path.join(root, "poses.txt"), syn.site_poses)
    return scans, os.path.join(root, "poses.txt")


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    bundle = make_two_sessions(num_keyframes=4, num_cars=6, num_changed=2,
                               max_scan_points=6000, scan_range=70.0,
                               seed=11, point_noise=0.01)
    c_scans, c_poses = _write_session(str(root / "central"), bundle["central"])
    q_scans, q_poses = _write_session(str(root / "query"), bundle["query"])
    config = str(root / "cfg.yaml")
    with open(config, "w") as f:
        yaml.safe_dump({k: v for k, v in dataclasses.asdict(_small_cfg()).items()
                        if k in ("scan_capacity", "downsample_voxel_size",
                                 "knn_avg_sqdist_threshold", "save_range_image_pngs")}, f)
    flags = ["--central-scans", c_scans, "--central-poses", c_poses,
             "--query-scans", q_scans, "--query-poses", q_poses]
    return root, config, flags


def _tree(out):
    """{relative path: point count} of an artifact directory."""
    files = {}
    for d, dirs, names in os.walk(out):
        dirs[:] = [x for x in dirs if x != ".stage_cache"]
        for n in names:
            path = os.path.join(d, n)
            files[os.path.relpath(path, out)] = len(j_read_pcd(path)) if n.endswith(".pcd") else -1
    return files


def test_missing_paths_exit_2_and_name_the_field(sessions, capsys):
    _, _, flags = sessions
    with pytest.raises(SystemExit) as e:
        main(flags[:2] + ["--device", "cpu"])
    assert e.value.code == 2
    assert "central_sess_pose_path required" in capsys.readouterr().err


def test_mesh_devices(sessions, tmp_path, monkeypatch):
    """``--mesh-devices`` reaches the driver: -1 (the default) is one CPU
    device, 2 a mesh of two CPU slots (the mesh run itself is
    tests/test_torch_removert_mesh.py's)."""
    cpu = torch.device("cpu")
    assert all(mesh_from_config(n, cpu) is None for n in (-1, None, 0, 1))
    _, config, flags = sessions
    seen = []

    class Stop(Exception):
        pass

    def run(self, *args, **kwargs):
        seen.append(None if self.mesh is None else self.mesh.size)
        raise Stop   # before the pipeline runs

    monkeypatch.setattr(TRemoverter, "run", run)
    for extra in ([], ["--mesh-devices", "2"]):
        with pytest.raises(Stop):
            main(flags + ["--config", config, "--out", str(tmp_path), "--device", "cpu"] + extra)
    assert seen == [None, 2]


def test_cli_artifact_tree_matches_ltm(sessions, monkeypatch):
    """The CLI (mesh devices -1 by default: one CPU device) writes ``ltm``'s
    tree, and each file holds as many points as ``ltm``'s; with
    ``--resume``, an unchanged second run is skipped."""
    root, config, flags = sessions
    c_scans, c_poses, q_scans, q_poses = flags[1::2]
    ltm_out, port_out = str(root / "ltm_out"), str(root / "port_out")
    Removerter(_small_cfg()).run(RemovertInput.from_dirs(c_scans, c_poses),
                                 RemovertInput.from_dirs(q_scans, q_poses),
                                 save_directory=ltm_out)
    args = flags + ["--config", config, "--out", port_out, "--device", "cpu", "--resume"]
    assert main(args) == 0
    ref, got = _tree(ltm_out), _tree(port_out)
    assert sorted(got) == sorted(ref)
    assert {"scans_updated/3.pcd", "central_sess_high_dyn.pcd", "rimg_diff_0002.png",
            "rimg_index.html"} <= set(got)
    diff = {k: (ref[k], got[k]) for k in ref if ref[k] != got[k]}
    assert not diff, diff
    assert read_pcd(os.path.join(port_out, "updated_map.pcd")).shape[0] > 0

    def rerun(*a, **k):
        raise AssertionError("--resume ran an unchanged stage again")

    monkeypatch.setattr(TRemoverter, "run", rerun)
    assert main(args) == 0
