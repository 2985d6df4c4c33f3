"""ltm_torch.core.config is a field-for-field copy of ltm.core.config."""

import dataclasses

import pytest

import ltm.core.config as jc
import ltm_torch.core.config as tc
from ltm_torch.removert.convert import config_from_dict
from ltm_torch.slam.convert import config_from_dict as slam_config_from_dict

CLASSES = ["ScanContextConfig", "ICPConfig", "SolverConfig", "LTSlamConfig", "RemovertConfig"]


@pytest.mark.parametrize("name", CLASSES)
def test_fields_and_defaults_match(name):
    a, b = getattr(jc, name)(), getattr(tc, name)()
    fa = [f.name for f in dataclasses.fields(a)]
    fb = [f.name for f in dataclasses.fields(b)]
    assert fa == fb
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_config_from_dict_round_trips():
    cfg = jc.RemovertConfig()
    cfg.downsample_voxel_size = 0.1
    cfg.remove_resolution_list = [2.5, 2.0]
    cfg.use_chunk_knn = False
    port = config_from_dict(dataclasses.asdict(cfg))
    assert isinstance(port, tc.RemovertConfig)
    assert dataclasses.asdict(port) == dataclasses.asdict(cfg)
    assert config_from_dict(dataclasses.asdict(port)) == port
    with pytest.raises(ValueError):
        config_from_dict({"no_such_field": 1})


def test_yaml_round_trip(tmp_path):
    cfg = tc.RemovertConfig()
    cfg.keyframe_gap = 3
    path = str(tmp_path / "removert.yaml")
    tc.save_yaml(cfg, path)
    loaded = tc.load_yaml(path, kind="removert")
    # YAML has no tuples: tuple fields come back as lists, as in ltm
    as_lists = {k: list(v) if isinstance(v, tuple) else v
                for k, v in dataclasses.asdict(cfg).items()}
    assert dataclasses.asdict(loaded) == as_lists


def test_ltslam_yaml_keys_match_ltm(tmp_path):
    """``load_yaml(..., "ltslam")`` reads the same file into the same
    configuration in both packages: nested sections, a namespace key, and
    tuples as lists."""
    path = str(tmp_path / "params.yaml")
    with open(path, "w") as f:
        f.write("ltslam:\n  num_rs_loops_upper_bound: 10\n  loop_fitness_score_threshold: 0.5\n"
                "  odom_variances: [1.0e-3, 1.0e-3, 1.0e-3, 1.0e-2, 1.0e-2, 1.0e-2]\n"
                "  icp: {source_capacity: 2048, update_trim_distance: 2.0}\n"
                "  scan_context: {dist_threshold: 0.45}\n  solver: {cg_iterations: 50}\n")
    ref, got = jc.load_yaml(path, "ltslam"), tc.load_yaml(path, "ltslam")
    assert isinstance(got, tc.LTSlamConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.icp.source_capacity == 2048 and got.solver.cg_iterations == 50


def test_ltslam_config_from_dict_round_trips():
    cfg = jc.LTSlamConfig()
    cfg.icp.target_capacity = 8192
    cfg.scan_context.num_exclude_recent = 8
    cfg.robust_variances = (0.25,) * 6
    port = slam_config_from_dict(dataclasses.asdict(cfg))
    assert isinstance(port.icp, tc.ICPConfig) and isinstance(port.solver, tc.SolverConfig)
    assert dataclasses.asdict(port) == dataclasses.asdict(cfg)
    with pytest.raises(ValueError):
        slam_config_from_dict({"icp": {"no_such_field": 1}})
