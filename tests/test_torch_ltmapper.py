"""``python -m ltm_torch.cli.ltmapper`` on the CPU: the full chain on session
directories written by ``ltm``'s ``write_session_dir`` (16 kf x 1 500 pts,
the ICP capacities of tests/test_torch_slam.py, 0.2 m removert voxels).
``ltslam/`` holds the eight trajectory files, SC loops were accepted, and
``removert/`` equals the tree of the port's ``Removerter.run`` on those
central poses: the same files, the same point count in each.  ``--resume``
skips both stages of an unchanged second run."""

import os

import torch
import yaml

from ltm.io.sessions import write_session_dir
from ltm.io.synthetic import make_two_sessions
from ltm_torch.cli import ltmapper
from ltm_torch.core.config import RemovertConfig
from ltm_torch.io.pcd import read_pcd
from ltm_torch.removert import Removerter, RemovertInput
from ltm_torch.slam import LTSlam as TLTSlam

from test_torch_slam import FILES, small_cfg
from test_torch_slam_cli import write_config

torch.set_num_threads(1)


def _tree(d):
    return {os.path.relpath(os.path.join(a, n), d): len(read_pcd(os.path.join(a, n)))
            for a, _, names in os.walk(d) for n in names if n.endswith(".pcd")}


def test_ltmapper_cli(tmp_path, monkeypatch):
    b = make_two_sessions(num_keyframes=16, num_cars=6, num_changed=2, max_scan_points=1500,
                          seed=3)
    for key in ("central", "query"):
        write_session_dir(str(tmp_path / "data" / b[key].data.name), b[key].data)
    cfg = small_cfg()
    cfg.max_nodes_per_session = 16
    rm = RemovertConfig()
    rm.downsample_voxel_size = 0.2
    rm.save_high_dyn_maps = False
    rm_path = tmp_path / "removert.yaml"
    with open(rm_path, "w") as f:
        yaml.safe_dump({"downsample_voxel_size": 0.2, "save_high_dyn_maps": False}, f)
    out = tmp_path / "out"
    args = ["--sessions-dir", str(tmp_path / "data"), "--out", str(out),
            "--ltslam-config", write_config(tmp_path / "ltslam.yaml", cfg),
            "--removert-config", str(rm_path), "--device", "cpu", "--resume"]
    calls = []
    run = TLTSlam.run

    def recording(self, *a, **k):
        calls.append(run(self, *a, **k))
        return calls[-1]

    monkeypatch.setattr(TLTSlam, "run", recording)
    assert ltmapper.main(args) == 0
    assert calls[0].num_sc_loops >= 1
    assert sorted(os.listdir(out / "ltslam")) == sorted(FILES)
    lib = tmp_path / "lib"
    Removerter(rm, device="cpu").run(
        *(RemovertInput.from_dirs(str(tmp_path / "data" / n / "Scans"),
                                  str(out / "ltslam" / f"{n}_central_aft_intersession_loops.txt"))
          for n in ("01", "02")), save_directory=str(lib))
    cli, ref = _tree(out / "removert"), _tree(lib)
    assert "updated_map.pcd" in cli and cli["updated_map.pcd"] > 0
    assert cli == ref

    def rerun(*a, **k):
        raise AssertionError("--resume ran an unchanged stage again")

    monkeypatch.setattr(TLTSlam, "run", rerun)
    monkeypatch.setattr(Removerter, "run", rerun)
    assert ltmapper.main(args) == 0
