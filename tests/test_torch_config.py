"""ltm_torch.core.config is a field-for-field copy of ltm.core.config."""

import dataclasses

import pytest

import ltm.core.config as jc
import ltm_torch.core.config as tc
from ltm_torch.removert.convert import config_from_dict

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
