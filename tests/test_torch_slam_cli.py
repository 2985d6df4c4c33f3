"""``python -m ltm_torch.cli.ltslam`` on the CPU, on session directories
written by ``ltm``'s ``write_session_dir`` (``tests/test_torch_ltmapper.py``
drives the full chain):

  * ``ltslam`` on the pipeline fixture (24 kf x 4 000 pts, the ICP
    capacities of tests/test_torch_slam.py from a YAML config): ``ltm``'s
    file names, poses within 0.01 m of ``ltm``'s run on the same sessions;
    ``--resume`` skips an unchanged second run;
  * argument errors and the device-mesh contract.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import yaml

from ltm.io.poses import read_kitti_poses
from ltm.io.sessions import write_session_dir
from ltm.io.synthetic import make_two_sessions
from ltm.slam import LTSlam
from ltm_torch.cli import ltslam
from ltm_torch.slam import LTSlam as TLTSlam

from test_torch_slam import FILES, small_cfg

torch.set_num_threads(1)


def write_config(path, cfg):
    with open(path, "w") as f:
        yaml.safe_dump({"ltslam": dataclasses.asdict(cfg)}, f)
    return str(path)


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    root = tmp_path_factory.mktemp("slam_cli")
    b = make_two_sessions(num_keyframes=24, num_cars=10, num_changed=4, max_scan_points=4000,
                          seed=3)
    for key in ("central", "query"):
        write_session_dir(str(root / "data" / b[key].data.name), b[key].data)
    return root, b, write_config(root / "ltslam.yaml", small_cfg())


def test_ltslam_cli_matches_ltm(sessions, monkeypatch):
    root, b, config = sessions
    ref_out, port_out = root / "ltm_out", root / "port_out"
    LTSlam(small_cfg()).run(b["central"].data, b["query"].data, save_directory=str(ref_out))
    args = ["--config", config, "--sessions-dir", str(root / "data"), "--out", str(port_out),
            "--device", "cpu", "--resume"]
    assert ltslam.main(args) == 0
    names = sorted(n for n in os.listdir(port_out) if not n.startswith("."))
    assert names == sorted(os.listdir(ref_out)) == sorted(FILES)
    for n in names:
        d = np.abs(read_kitti_poses(str(port_out / n)) - read_kitti_poses(str(ref_out / n))).max()
        assert d < 0.01, (n, d)

    def rerun(*a, **k):
        raise AssertionError("--resume ran an unchanged stage again")

    monkeypatch.setattr(TLTSlam, "run", rerun)
    assert ltslam.main(args) == 0


def test_ltslam_cli_errors(sessions, tmp_path, capsys):
    root, _, config = sessions
    with pytest.raises(SystemExit) as e:
        ltslam.main(["--device", "cpu"])
    assert e.value.code == 2
    assert "sessions_dir required" in capsys.readouterr().err
    with pytest.raises(NotImplementedError, match="mesh_devices"):
        ltslam.main(["--config", config, "--sessions-dir", str(root / "data"), "--out",
                     str(tmp_path), "--device", "cpu", "--mesh-devices", "2"])
