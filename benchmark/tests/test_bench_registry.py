"""Cells, configurations, mixes and metrics are found by name among files;
names and units keep to the allowed characters."""

import copy
import json
import os
import shutil

from conftest import BENCH, ROOT
from harness import traffic
from harness.cell import find_cell, load_json, name_faults
from harness.window import Job, Window


def test_benchmark_names_and_units_are_allowed():
    assert name_faults(load_json(os.path.join(ROOT, "BENCHMARK.json"))) == []


def test_bad_names_and_units_are_found():
    bench = copy.deepcopy(load_json(os.path.join(ROOT, "BENCHMARK.json")))
    bench["end_to_end"][0]["unit"] = "keyframes per s"
    bench["per_layer"][0]["name"] = "prep/s"
    bench["workloads"][0]["traffic"] = "a b"
    assert len(name_faults(bench)) == 3


def test_every_cell_and_metric_has_its_files():
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    for w in bench["workloads"]:
        cell = find_cell(bench, w["name"])
        for m in cell.per_layer:
            assert hasattr(cell.metric_module(m["name"]), "read")
        for m in cell.end_to_end:
            if m["name"] != "setup_s":
                assert hasattr(cell.metric_module(m["name"]), "read_window")
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))


def test_a_cell_added_as_files_is_found_by_name(tmp_path):
    """A new configuration, scene, mix, metric and cell: new files and
    entries, no file of the harness edited."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cfg = load_json(os.path.join(BENCH, "configs", "ltremovert.parkinglot.json"))
    cfg["settings"]["downsample_voxel_size"] = 0.1
    cfg["keyframes_per_session"] = 24
    (bench_dir / "configs" / "ltremovert.coarse.json").write_text(json.dumps(cfg))
    (bench_dir / "scenes" / "square.py").write_text(
        "def sessions(mix, survey, seed):\n"
        "    return [{'side_m': mix['side_m'], 'keyframes': survey['keyframes_per_session'],\n"
        "             'seed': seed}]\n")
    (bench_dir / "traffic" / "square.json").write_text(json.dumps({"scene": "square", "side_m": 40}))
    (bench_dir / "metrics" / "removert.jobs_a_s.py").write_text(
        "def read_window(window):\n    return len(window.jobs) / window.seconds\n")
    bench["configs"].append({**bench["configs"][0], "name": "ltremovert.coarse",
                             "file": "benchmark/configs/ltremovert.coarse.json"})
    bench["workloads"].append({"name": "removert.square", "config": "ltremovert.coarse",
                               "traffic": "square", "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "removert.jobs_a_s", "unit": "jobs/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["removert.square"]})
    assert name_faults(bench) == []
    cell = find_cell(bench, "removert.square", bench_dir=str(bench_dir))
    assert cell.config["settings"]["downsample_voxel_size"] == 0.1
    assert cell.driver.__file__.startswith(str(bench_dir))
    assert traffic.sessions(cell, 7) == [{"side_m": 40, "keyframes": 24, "seed": 7}]
    names = [m["name"] for m in cell.end_to_end]
    assert names == ["setup_s", "removert.jobs_a_s"]
    w = Window(0.0, [Job(0.0, 2.0, 96), Job(2.0, 4.0, 96)])
    assert cell.metric_module("removert.jobs_a_s").read_window(w) == 0.5
    # the cells already there are found as before
    assert find_cell(bench, "slam.sc", bench_dir=str(bench_dir)).traffic["bundles"] == 2
