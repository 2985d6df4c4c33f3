"""Shared set-up of the benchmark's CPU tests: the benchmark's folder and the
repository's root on the import path, small cells of the real files."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def small_cell(name: str):
    """The cell ``name`` of ``BENCHMARK.json`` at a size the CPU holds:
    LT-removert at 2 x 8 keyframes x 6 000 points (scan_capacity 4 096),
    LT-SLAM at one bundle of 2 x 24 keyframes x 2 000 points (the ICP
    capacities of the port's own CPU tests)."""
    from harness.cell import find_cell, load_json

    cell = find_cell(load_json(os.path.join(ROOT, "BENCHMARK.json")), name)
    if cell.config["driver"] == "removert":
        cell.config.update(keyframes_per_session=8, scan_points=6000)
        cell.traffic["check_among"] = 2
        cell.config["settings"]["scan_capacity"] = 4096
    else:
        cell.config.update(keyframes_per_session=24, scan_points=2000)
        cell.traffic["bundles"] = 1
        cell.config["settings"]["icp"].update(source_capacity=1024, target_capacity=4096)
    return cell


@pytest.fixture
def cpu():
    import torch

    torch.set_num_threads(2)
    return torch.device("cpu")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
