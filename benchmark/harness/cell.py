"""A cell, found by name: its entry in ``BENCHMARK.json``, its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<traffic>.json``)
and the mix's scene (``scenes/<scene>.py``), its driver
(``drivers/<driver>.py``, named by the configuration) and its metrics
(``metrics/<name>.py``).  Adding a cell, a configuration, a mix or a
metric adds files and entries; no file here names one."""

from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass
from types import ModuleType
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    driver: ModuleType
    end_to_end: List[dict]        # entries of BENCHMARK.json this cell reports
    per_layer: List[dict]
    bench_dir: str = BENCH_DIR

    def metric_module(self, name: str) -> ModuleType:
        return load_module(os.path.join(self.bench_dir, "metrics", name + ".py"))


def load_module(path: str) -> ModuleType:
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    name = "bench_" + re.sub(r"\W", "_", os.path.relpath(path, BENCH_DIR))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: dict, name: str, bench_dir: str = BENCH_DIR) -> Cell:
    """The cell ``name`` of the benchmark file's contents ``bench``."""
    hits = [w for w in bench["workloads"] if w["name"] == name]
    if len(hits) != 1:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    w = hits[0]
    config = load_json(os.path.join(bench_dir, "configs", w["config"] + ".json"))
    traffic = load_json(os.path.join(bench_dir, "traffic", w["traffic"] + ".json"))
    driver = load_module(os.path.join(bench_dir, "drivers", config["driver"] + ".py"))
    return Cell(name=name, workload=w, config=config, traffic=traffic, driver=driver,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
                bench_dir=bench_dir)


def name_faults(bench: dict) -> List[str]:
    """Names and units of ``bench`` that break the allowed characters."""
    bad = []
    names: Dict[str, str] = {}
    for m in bench["end_to_end"] + bench["per_layer"]:
        names[m["name"]] = "metric"
        if not UNIT.match(m["unit"]):
            bad.append(f"unit {m['unit']!r}")
    for group in ("workloads", "configs"):
        for e in bench[group]:
            names[e["name"]] = group
    for w in bench["workloads"]:
        names[w["config"]] = "config"
        names[w["traffic"]] = "traffic"
    for c in bench["configs"]:
        for k in c["reduced"]:
            names[k] = "reduced"
    bad += [f"name {n!r}" for n in names if not NAME.match(n)]
    return bad
